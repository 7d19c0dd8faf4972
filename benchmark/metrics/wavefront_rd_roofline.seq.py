"""wavefront_rd_roofline.seq (%, device trace): the RD kernel's
share of its roofline in a sequence cell, read as
`roofline_pct.wavefront_rd` reads it in the frame cells: the least time
of one frame's three planes (`roofline/wavefront_rd.py`) times the
frames pushed in the traced window, over the kernel's device time in
the window.  A batch of 8 frames is 8 frames' work (the count's
per-batch price tables add under 0.1 %); the batch dispatched last may
run past the window's end, where its time is cut, an error of at most
one batch in the window's."""

from benchlib import spec


def read(ctx):
    return spec.load_module("metrics", "roofline_pct.wavefront_rd").read(ctx)
