"""d2h_bytes_per_frame.seq (bytes, program counter): the program's
"frame.bytes_down" counter in a sequence cell: the bytes of the drained
batches' outputs brought back to the host (the level prefixes as
copied), per frame pushed in the traced window; none where the program
has no such count.  The frame cells' reader of the same counter,
`d2h_bytes_per_frame`, moves their frame latency; this one moves
`encode_fps`."""

from benchlib.program import count_per_frame


def read(ctx):
    return count_per_frame(ctx, "frame.bytes_down")
