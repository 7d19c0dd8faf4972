"""roofline_pct.wavefront (%, device trace): the wavefront kernel's least
time for the traced frames (`roofline/wavefront.py`) over its device
time, summed by kernel name (the name is not a part of the RD kernel's,
`wavefront_rd_kernel`)."""

KERNELS = ("wavefront_kernel",)


def read(ctx):
    t = ctx.trace
    if t is None or not t.frames:
        return None
    spent = t.device_s(kinds=("kernel",), names=KERNELS)
    if spent <= 0:
        return None
    return 100.0 * ctx.roofline_s("wavefront") * t.frames / spent
