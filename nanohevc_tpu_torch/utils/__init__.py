"""Observability and verification utilities."""

from nanohevc_tpu_torch.utils.tracing import Stopwatch, count, span, throughput_stats
from nanohevc_tpu_torch.utils.checks import sample_parity_check

__all__ = ["Stopwatch", "span", "count", "throughput_stats", "sample_parity_check"]
