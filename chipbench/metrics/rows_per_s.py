"""Rows scored in the window per second of the window."""


def read(ctx):
    return ctx.rows / ctx.seconds
