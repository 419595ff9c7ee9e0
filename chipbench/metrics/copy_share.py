"""Share of the traced window in which the card copies or sets memory
and runs no kernel, in %: device busy time less kernel time (one stream,
so nothing overlaps), over the window."""


def read(ctx):
    busy, kernel = ctx.trace.get("busy_s"), ctx.trace.get("kernel_s")
    window = ctx.trace.get("window_s")
    if busy is None or kernel is None or not window:
        return None
    return 100.0 * (busy - kernel) / window
