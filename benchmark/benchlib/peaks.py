"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at
its 700 W limit).  Work counts are held against these: integer
operations counted at the float32 rate make a bound optimistic, so a
share of it reads high rather than low."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_seconds(ops: float, nbytes: float) -> tuple:
    """(seconds, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
