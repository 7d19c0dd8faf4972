"""h2d_bytes_per_frame (bytes, program counter): the program's
"frame.bytes_up" counter: the bytes of the planes sent to the card, per
frame of the traced window; none where the program has no such count."""

from benchlib.program import count_per_frame


def read(ctx):
    return count_per_frame(ctx, "frame.bytes_up")
