"""The yardstick: the least time an NVIDIA H100 needs for the work a
forest's inputs demand, whatever implements it.

Work is counted by the plain reference's own traversal, never by the
program: one compare for each internal node on each (row, tree) path,
one add per class for each (row, tree) walked — for a cascade only the
trees up to each row's exit.  Bytes: every input row read once as
float32, each internal node's feature id (int32) and threshold (at the
forest's precision) and each leaf (at the accumulator's) read once per
call for the trees the call reaches, every output written once as
float32.  A kernel that skips work cannot raise its own share.

Peaks: NVIDIA's H100 SXM5 datasheet, dense, at the 700 W power limit —
67 TFLOP/s outside the tensor cores (the 32-bit ALU rate that compares
and integer adds run at) and 3.35 TB/s of HBM3.  A card capped below
700 W (``nvidia-smi --query-gpu=power.limit``) runs slower under load;
shares are stated against these peaks all the same."""
from __future__ import annotations

OPS_PER_S = 67e12
BYTES_PER_S = 3.35e12
INPUT_BYTES = OUTPUT_BYTES = FEATURE_ID_BYTES = 4


def forest_bytes(internal_nodes: int, leaves: int, n_classes: int,
                 threshold_bytes: int, leaf_bytes: int) -> int:
    """Bytes of the trees a call reaches, each read once."""
    return internal_nodes * (FEATURE_ID_BYTES + threshold_bytes) + \
        leaves * n_classes * leaf_bytes


def call_work(rows: int, n_features: int, n_classes: int, compares: int,
              row_trees: int, model_bytes: int) -> tuple[int, int]:
    """(operations, bytes) of one call: ``compares`` on its rows' paths,
    ``row_trees`` (row, tree) pairs walked."""
    ops = compares + row_trees * n_classes
    nbytes = rows * n_features * INPUT_BYTES + model_bytes + \
        rows * n_classes * OUTPUT_BYTES
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    """The larger of the compute and the memory bound."""
    return max(ops / OPS_PER_S, nbytes / BYTES_PER_S)
