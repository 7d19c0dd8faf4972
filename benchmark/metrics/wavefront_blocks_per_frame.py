"""wavefront_blocks_per_frame (blocks, program counter): the program's
"wavefront.blocks" counter: the blocks the wavefront kernel codes, over
each launch's padded geometry, per frame of the traced window; none
where the program has no such count."""

from benchlib.program import count_per_frame


def read(ctx):
    return count_per_frame(ctx, "wavefront.blocks")
