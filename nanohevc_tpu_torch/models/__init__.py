"""Full-frame encoder pipelines."""
