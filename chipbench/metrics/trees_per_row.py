"""Mean trees walked per row of a cascade, from the program's per-stage
exit counts (``last_exit_counts``) and the stage bounds."""


def read(ctx):
    if ctx.exit_counts is None or not ctx.stages:
        return None
    rows = ctx.exit_counts.sum()
    walked = sum(int(c) * s for c, s in zip(ctx.exit_counts, ctx.stages))
    return walked / rows if rows else None
