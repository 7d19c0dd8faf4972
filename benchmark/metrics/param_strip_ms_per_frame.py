"""param_strip_ms_per_frame (ms, program span): host time of the
program's "seq.strip" span: the parameter sets dropped from each
frame's bitstream (its NALs split and the rest wrapped again), per
frame of the traced window; none where the program has no such span."""

from benchlib.program import span_ms_per_frame


def read(ctx):
    return span_ms_per_frame(ctx, "seq.strip")
