"""Observability utilities."""

from nanohevc_tpu_torch.utils.tracing import Stopwatch, throughput_stats, trace_region

__all__ = ["Stopwatch", "trace_region", "throughput_stats"]
