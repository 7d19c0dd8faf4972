"""entropy_ms_per_frame (ms, program span): host time of the span
around `runtime.bitstream.assemble_bitstream` (the bitstream writer
and its C++ coders), per frame of the traced window."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.frames:
        return None
    s = t.span_s("entropy")
    return s / t.frames * 1e3 if s > 0 else None
