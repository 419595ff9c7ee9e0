"""Seconds of the set-up's ``core.compile_forest`` call (harness clock)."""


def read(ctx):
    return ctx.compile_s
