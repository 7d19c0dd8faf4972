"""upload_ms_per_frame (ms, program span): host time of the program's
"frame.upload" span: each plane's int32 conversion and copy to the card,
per frame of the traced window; none where the program has no such
span."""

from benchlib.program import span_ms_per_frame


def read(ctx):
    return span_ms_per_frame(ctx, "frame.upload")
