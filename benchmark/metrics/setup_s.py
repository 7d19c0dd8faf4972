"""setup_s (s, host clock): process start to the first timed call:
imports, kernel and runtime builds or loads, the frames, the entry's
warm-up call."""


def read(ctx):
    return ctx.setup_s
