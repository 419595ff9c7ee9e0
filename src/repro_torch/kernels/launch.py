"""What every CUDA kernel wrapper shares: the limits of one block, the
row-tile layout of the forest kernels, operand checks, the choice between
the card and the plain version, and the ctypes launch on the current
stream."""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build

MAX_NODES = 256          # nodes per tree whose conditions fit 8 bit words
MAX_WORDS = 8            # leafidx words a thread keeps in registers (L <= 256)
MAX_CLASSES = 16         # class accumulators a thread keeps in registers
MAX_SHARED_BYTES = 232448          # 227 KB: the most a block may opt into

# The row-tile kernels (csrc/qs_forward.cu, and csrc/tile_common.cuh's
# qs_bitmm_forward.cu and gemm_forward.cu): a block is TILE_ROWS rows
# (lane = row) x TILE_WARPS warps (warp = tree slice); the x tile keeps
# X_STRIDE words per feature
TILE_ROWS, TILE_WARPS, X_STRIDE = 32, 8, 33
SM_SHARED_BYTES = 233472           # shared memory of one SM (228 KB)
BLOCK_RESERVED_BYTES = 1024        # of it reserved per resident block
MAX_THREADS_PER_SM = 2048
H100_SMS = 132
# The tree groups are sized for a batch of this many rows (ForestServer's
# largest bucket) whatever the batch, so a row's float sum keeps one order
GROUP_ROWS = 1024


def kernel_limits(name: str, n_nodes: int, n_classes: int,
                  n_words: int = 0) -> None:
    """Raise ``ValueError`` unless the kernel ``name`` takes trees of
    ``n_nodes`` nodes (or, with ``n_words``, that many leafidx words) and
    ``n_classes`` classes; the message names the torch backend, which
    takes any forest."""
    if n_words:
        ok, what = n_words <= MAX_WORDS, (
            f"at most {MAX_WORDS} leafidx words (L <= {32 * MAX_WORDS})")
        got = f"W={n_words}"
    else:
        ok, what = n_nodes <= MAX_NODES, (
            f"at most {MAX_NODES} nodes per tree (L <= {MAX_NODES + 1})")
        got = f"N={n_nodes}"
    if not ok or n_classes > MAX_CLASSES:
        raise ValueError(
            f"the {name} kernel takes {what} and at most {MAX_CLASSES} "
            f"classes; got {got}, C={n_classes}: compile with "
            'backend="torch" for this forest')


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def node_pad(n_nodes: int) -> int:
    """Nodes padded to whole k-steps of the int8 m16n8k32 product, at
    least one (``node_pad`` in csrc/tile_common.cuh)."""
    return max(32, round_up(n_nodes, 32))


def tile_tree_bytes(n_nodes: int, n_rows: int, n_words: int) -> int:
    """Bytes of one tree in the ring of ``qs_bitmm_forward`` and
    ``gemm_forward``: an 8-byte node record per padded node, ``n_rows``
    operand rows of ``node_pad`` + 16 bytes, and ``n_words`` int32 words
    rounded up to 8 (``tree_bytes`` in their sources)."""
    return (8 * node_pad(n_nodes) + n_rows * (node_pad(n_nodes) + 16)
            + 4 * round_up(n_words, 8))


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """How a row-tile kernel cuts its work: ``row_blocks`` x ``n_groups``
    blocks, each walking ``group_trees`` trees, ``chunk`` at a time through
    its shared-memory ring, in ``shared_bytes`` of shared memory."""
    route: str               # "smem_x" or "global_x"
    chunk: int
    group_trees: int
    n_groups: int
    row_blocks: int
    shared_bytes: int
    blocks_per_sm: int


def tile_shared_bytes(tree_bytes: int, n_classes: int, n_features: int,
                      chunk: int, smem_x: bool) -> int:
    """A block's shared bytes, as ``shared_bytes`` in the row-tile
    sources: the two-stage ring of ``chunk`` trees of ``tree_bytes`` each
    (reused for the 8 warps' partial sums), plus the feature-major x tile
    on the ``smem_x`` route."""
    ring = 2 * chunk * tree_bytes
    part = 4 * TILE_WARPS * TILE_ROWS * n_classes
    return max(ring, part) + (4 * X_STRIDE * n_features if smem_x else 0)


def tile_layout(B: int, d: int, T: int, C: int, tree_bytes: int,
                max_chunk: int, what: str,
                n_sm: int = H100_SMS) -> TileLayout:
    """The route, ring chunk and tree groups of a row-tile kernel for B
    rows of width d over T trees of ``tree_bytes`` each in the ring (C
    classes) on a card of ``n_sm`` SMs.

    x is staged in shared memory when 32 rows of it fit beside a ring of
    one tree.  The ring then takes as many trees as fit, up to
    ``max_chunk``.  The tree groups are as many as one wave of resident
    blocks can hold at ``GROUP_ROWS`` rows (blocks per SM from the shared
    bytes), rounded so every group but the last holds the same whole
    chunks.  Only ``row_blocks`` depends on B: a row's trees are summed in
    the same order in every batch, so float scores do not change with the
    batch a row lands in.  Raises if one tree (``what``) does not fit."""
    smem_x = tile_shared_bytes(tree_bytes, C, d, 1, True) <= MAX_SHARED_BYTES
    x_bytes = 4 * X_STRIDE * d if smem_x else 0
    chunk = max(1, min(max_chunk, T, (MAX_SHARED_BYTES - x_bytes)
                       // max(2 * tree_bytes, 1)))
    shared = tile_shared_bytes(tree_bytes, C, d, chunk, smem_x)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"{what} exceed the {MAX_SHARED_BYTES} bytes of "
                         "shared memory a block may hold")
    blocks_per_sm = max(1, min(MAX_THREADS_PER_SM // (TILE_ROWS * TILE_WARPS),
                               SM_SHARED_BYTES
                               // (shared + BLOCK_RESERVED_BYTES)))
    n_chunks = -(-T // chunk)
    groups = max(1, min(n_chunks,
                        blocks_per_sm * n_sm * TILE_ROWS // GROUP_ROWS))
    group_trees = max(1, -(-n_chunks // groups)) * chunk
    return TileLayout(route="smem_x" if smem_x else "global_x", chunk=chunk,
                      group_trees=group_trees,
                      n_groups=-(-T // group_trees),
                      row_blocks=-(-B // TILE_ROWS), shared_bytes=shared,
                      blocks_per_sm=blocks_per_sm)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_tensors(x: torch.Tensor, named: dict, dtypes: dict,
                  ndims: dict) -> None:
    """Raise unless every operand is a contiguous tensor of its dtype and
    rank on ``x``'s device."""
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name}: dtype {t.dtype}, expected "
                            f"{dtypes[name]}")
        if t.dim() != ndims[name]:
            raise ValueError(f"{name}: {t.dim()}-D, expected {ndims[name]}-D")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_out_dtype(out_dtype) -> None:
    if out_dtype not in (torch.float32, torch.int32):
        raise TypeError(f"out_dtype {out_dtype}: float32 or int32 only")


def on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


def library(name: str, fn: str, err_fn: str, n_ptrs: int, n_ints: int,
            n_doubles: int = 0) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` with its launch function ``fn`` typed
    as ``n_ptrs`` pointers, ``n_ints`` ints, ``n_doubles`` doubles and a
    stream, returning an int error code that ``err_fn`` turns into a
    message."""
    lib = build.load(name)
    launch_fn = getattr(lib, fn)
    if launch_fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        launch_fn.argtypes = ([p] * n_ptrs + [i] * n_ints
                              + [ctypes.c_double] * n_doubles + [p])
        launch_fn.restype = ctypes.c_int
        getattr(lib, err_fn).argtypes = [i]
        getattr(lib, err_fn).restype = ctypes.c_char_p
    return lib


def launch(fn, error_string, name: str, device: torch.device, *args) -> None:
    """Call a library's C launch function with ``args`` and ``device``'s
    current stream; raise with CUDA's message unless it returns 0."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + error_string(err).decode())
