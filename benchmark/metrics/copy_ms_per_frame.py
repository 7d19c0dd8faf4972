"""copy_ms_per_frame (ms, device trace): memcpy time on the card (the
planes' upload, the outputs' `.cpu()` copies), per frame call."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.frames:
        return None
    s = t.device_s(kinds=("memcpy",))
    return s / t.frames * 1e3 if s > 0 else None
