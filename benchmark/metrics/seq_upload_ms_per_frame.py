"""seq_upload_ms_per_frame (ms, program span): host time of the
program's "seq.upload" span: a sequence batch's planes stacked, pinned
and sent to the card, up to its first launch, per frame of the traced
window; none where the program has no such span."""

from benchlib.program import span_ms_per_frame


def read(ctx):
    return span_ms_per_frame(ctx, "seq.upload")
