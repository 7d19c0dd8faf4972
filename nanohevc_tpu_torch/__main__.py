"""`python -m nanohevc_tpu_torch` entry point."""

from nanohevc_tpu_torch.cli import main

main()
