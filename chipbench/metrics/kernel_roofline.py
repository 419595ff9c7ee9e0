"""The yardstick's least time for the window's rows over the device
time of every kernel in the traced window (the run's profiled half),
in %."""


def read(ctx):
    kernel_s = ctx.trace.get("kernel_s")
    return 100.0 * ctx.trace_least_s / kernel_s if kernel_s else None
