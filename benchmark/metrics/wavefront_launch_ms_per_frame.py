"""wavefront_launch_ms_per_frame (ms, program span): host time of the
program's "wavefront.launch" span: the wavefront kernel wrapper's checks,
tables and launch on the card's path, per frame of the traced window;
none where the program has no such span."""

from benchlib.program import span_ms_per_frame


def read(ctx):
    return span_ms_per_frame(ctx, "wavefront.launch")
