"""launches_per_frame (launches, program counters): the kernel wrappers'
`.launches` counters over the window, per frame call."""


def read(ctx):
    calls = ctx.window.attempted
    if not calls or not ctx.counters:
        return None
    return sum(ctx.counters.values()) / calls
