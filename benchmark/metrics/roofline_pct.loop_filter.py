"""roofline_pct.loop_filter (%, device trace): the loop filters' least
time for the traced frames (`roofline/loop_filter.py`) over their device
time, summed over deblocking, the SAO estimate and the SAO application
by kernel name."""

KERNELS = ("deblock_kernel", "sao_estimate_kernel", "sao_apply_kernel")


def read(ctx):
    t = ctx.trace
    if t is None or not t.frames:
        return None
    spent = t.device_s(kinds=("kernel",), names=KERNELS)
    if spent <= 0:
        return None
    return 100.0 * ctx.roofline_s("loop_filter") * t.frames / spent
