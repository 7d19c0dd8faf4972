"""convert_ms_per_frame (ms, program span): host time of the program's
"frame.convert" span: each plane's outputs converted into the recon
frame and the bitstream writer's inputs, per frame of the traced window;
none where the program has no such span."""

from benchlib.program import span_ms_per_frame


def read(ctx):
    return span_ms_per_frame(ctx, "frame.convert")
