"""encode_fps (frames/s, host clock): frames completed in the window
over the window's wall time, from the first call to the last return."""


def read(ctx):
    w = ctx.window
    if w.wall_s <= 0:
        return None
    return (w.attempted - w.failed) / w.wall_s
