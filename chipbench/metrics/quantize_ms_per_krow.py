"""ms of the predictor's input transform per 1000 rows (harness clock
around ``transform_inputs``, wrapped in the first half of a traced run,
which runs without the profiler)."""


def read(ctx):
    if not ctx.quantize:
        return None
    seconds = sum(s for s, _ in ctx.quantize)
    rows = sum(n for _, n in ctx.quantize)
    return seconds * 1e3 / (rows / 1e3) if rows else None
