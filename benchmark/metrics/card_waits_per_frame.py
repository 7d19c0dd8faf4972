"""card_waits_per_frame (waits, program counter): the program's
"frame.waits" counter: the times the frame encoder's host waits for the
card's outputs, per frame of the traced window; none where the program
has no such count."""

from benchlib.program import count_per_frame


def read(ctx):
    return count_per_frame(ctx, "frame.waits")
