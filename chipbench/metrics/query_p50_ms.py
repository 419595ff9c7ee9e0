"""Median latency of the window's calls (one query a call), from each
call's start to its return, in ms."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.latencies, 50)) * 1e3
