"""The system under test, ``repro_torch``, driven as its users drive it —
the only module of the benchmark that imports the program.

From a model file the program gets its own ``Forest``, quantizes it
(``core.quantize_forest`` on the dataset's training rows) and compiles
it with ``core.compile_forest``: the configuration's engine and backend,
and for a cascade a fused ``CascadeSpec`` with the calibrated margin
gate.  The benchmark takes nothing else from the program but its
predictor's ``predict``, its exit counter (``last_exit_counts``) and its
kernel names in the trace."""
from __future__ import annotations

import time

import numpy as np
import torch


def build(model: dict, cfg: dict, calib_rows: np.ndarray, device):
    """(predictor, seconds of the ``compile_forest`` call)."""
    from repro_torch import core
    forest = core.Forest(
        n_trees=model["feature"].shape[0],
        n_leaves=model["leaf_value"].shape[1],
        n_classes=int(model["n_classes"]),
        n_features=int(model["n_features"]),
        feature=model["feature"], threshold=model["threshold"],
        left=model["left"], right=model["right"],
        leaf_lo=model["leaf_lo"], leaf_mid=model["leaf_mid"],
        leaf_hi=model["leaf_hi"], leaf_value=model["leaf_value"],
        n_nodes=model["n_nodes"], n_leaves_per_tree=model["n_leaves"],
        max_depth=int(model["max_depth"]))
    quant = cfg["quant"]
    qforest = core.quantize_forest(forest, calib_rows, core.QuantSpec(
        bits=quant["bits"], int_accum=quant["int_accum"]))
    cascade = None
    if "cascade" in cfg:
        from repro_torch.cascade import CascadeSpec, MarginGate
        cascade = CascadeSpec(
            stages=tuple(cfg["cascade"]["stages"]),
            policy=MarginGate(float(model["gate_threshold"])), fused=True)
    t0 = time.perf_counter()
    pred = core.compile_forest(qforest, engine=cfg["engine"],
                               backend=cfg["backend"], cascade=cascade,
                               device=device)
    return pred, time.perf_counter() - t0


def padded_rows(pred, n: int) -> int:
    """The rows a call of ``n`` rows runs at on the card: the program's
    ``ops.bucket_rows`` for a predictor with a row block, else ``n``."""
    block = getattr(pred, "block_b", None)
    if block is None:
        return n
    from repro_torch.kernels.ops import bucket_rows
    return bucket_rows(n, block)


def exit_counts(pred):
    """The program's per-stage exit counts of its last call, or None."""
    counts = getattr(pred, "last_exit_counts", None)
    return None if counts is None else np.asarray(counts, dtype=np.int64)


def time_transform(pred, spans: list) -> None:
    """Time the predictor's input transform on this instance: each call
    appends (seconds, rows) to ``spans`` under a ``chipbench.quantize``
    span of the trace.  Used in traced runs only."""
    inner = pred.transform_inputs

    def timed(X):
        with torch.profiler.record_function("chipbench.quantize"):
            t0 = time.perf_counter()
            out = inner(X)
            spans.append((time.perf_counter() - t0, len(X)))
        return out

    pred.transform_inputs = timed
