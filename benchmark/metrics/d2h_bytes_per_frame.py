"""d2h_bytes_per_frame (bytes, program counter): the program's
"frame.bytes_down" counter: the bytes of the planes' outputs brought
back to the host, per frame of the traced window; none where the program
has no such count."""

from benchlib.program import count_per_frame


def read(ctx):
    return count_per_frame(ctx, "frame.bytes_down")
