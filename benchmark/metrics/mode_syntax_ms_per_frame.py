"""mode_syntax_ms_per_frame (ms, program span): host time of the
program's "entropy.modes" span: each plane's intra-mode syntax, per
frame of the traced window; none where the program has no such span."""

from benchlib.program import span_ms_per_frame


def read(ctx):
    return span_ms_per_frame(ctx, "entropy.modes")
