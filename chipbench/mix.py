"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a seed → the calls of a run.

One caller drives a closed loop: it sends its next call when the last
returned.  Keys of a mix:

* ``rows``: rows per call, a number or ``{"lognormal": {"median",
  "sigma", "min", "max"}}``.  A distribution gives the ``pool`` calls
  the sizes at its ``(i + 0.5) / pool`` quantiles, rounded and clipped,
  so every seed sends the same sizes, in another order;
* ``pool``: the number of distinct calls, each drawn afresh from the
  dataset; the caller goes round them in the seed's order;
* ``tiny`` (optional): the keys the CPU tests change, never read here.

Rows come from the seed alone; the seed is tagged, so a run's rows never
repeat the rows a model was trained or calibrated on."""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

STREAM_TAG = 0x7A4F


def call_sizes(rows, pool: int) -> np.ndarray:
    if isinstance(rows, (int, float)):
        return np.full(pool, int(rows), dtype=np.int64)
    if set(rows) != {"lognormal"}:
        raise ValueError(f"unknown row distribution {sorted(rows)}")
    p = rows["lognormal"]
    z = [NormalDist().inv_cdf((i + 0.5) / pool) for i in range(pool)]
    sizes = [round(math.exp(math.log(p["median"]) + p["sigma"] * v))
             for v in z]
    return np.clip(np.asarray(sizes, dtype=np.int64), p["min"], p["max"])


def calls(mix: dict, dataset, seed: int) -> list:
    """The pool of calls, in the order the caller sends them: a list of
    (rows, d) float32 arrays."""
    rng = np.random.default_rng([STREAM_TAG, int(seed) % 2 ** 64])
    sizes = rng.permutation(call_sizes(mix["rows"], mix["pool"]))
    X, _ = dataset.draw(int(sizes.sum()), rng)
    return np.split(X, np.cumsum(sizes)[:-1])
