"""device_ms_per_frame.frame (ms, device trace): time in which a kernel,
copy or fill ran on the card, per frame call of the traced window."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.frames:
        return None
    busy = t.busy_s
    return busy / t.frames * 1e3 if busy > 0 else None
