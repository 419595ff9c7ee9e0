"""Set-up seconds: process start to the start of the window (load,
build, compile, warm-up)."""


def read(ctx):
    return ctx.setup_s
