"""The yardstick's least time for all the rows the window scored over
the window's seconds: the whole step's share of the H100's peak, in %
(in a traced run, over its first half, which runs without the profiler)."""

CARD_ONLY = True


def read(ctx):
    return 100.0 * ctx.least_s / ctx.seconds
