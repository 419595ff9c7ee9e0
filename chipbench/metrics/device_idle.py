"""Share of the traced window in which no kernel, copy or memset ran on
the device, in %."""


def read(ctx):
    busy, window = ctx.trace.get("busy_s"), ctx.trace.get("window_s")
    if busy is None or not window:
        return None
    return 100.0 * (1.0 - busy / window)
