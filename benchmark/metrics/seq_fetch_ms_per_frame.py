"""seq_fetch_ms_per_frame (ms, program span): host time of the
program's "seq.fetch" span: a drain's wait for its batch on the card,
the level prefixes' copies and the small outputs' conversion, per frame
of the traced window; none where the program has no such span."""

from benchlib.program import span_ms_per_frame


def read(ctx):
    return span_ms_per_frame(ctx, "seq.fetch")
