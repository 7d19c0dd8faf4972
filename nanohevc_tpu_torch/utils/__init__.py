"""Observability and verification utilities."""

from nanohevc_tpu_torch.utils.tracing import Stopwatch, throughput_stats, trace_region
from nanohevc_tpu_torch.utils.checks import sample_parity_check

__all__ = ["Stopwatch", "trace_region", "throughput_stats", "sample_parity_check"]
