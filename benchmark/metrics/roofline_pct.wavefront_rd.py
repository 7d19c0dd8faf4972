"""roofline_pct.wavefront_rd (%, device trace): the RD kernel's least
time for the traced frames (`roofline/wavefront_rd.py`) over its device
time, summed by kernel name."""

KERNELS = ("wavefront_rd_kernel",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.frames:
        return None
    spent = t.device_s(kinds=("kernel",), names=KERNELS)
    if spent <= 0:
        return None
    return 100.0 * ctx.roofline_s("wavefront_rd") * t.frames / spent
