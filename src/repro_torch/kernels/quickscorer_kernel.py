"""CUDA kernel: QuickScorer bitvector traversal, hand-written for Hopper.

``qs_forward`` replaces the Pallas TPU kernel of the same name
(``repro/kernels/quickscorer_kernel.py:130``).  For a CUDA tensor it
launches ``csrc/qs_forward.cu`` (built by ``kernels/build.py``) on the
current stream, or raises; for a CPU tensor it runs
``qs_forward_reference``, the same function in plain torch.  Nothing
falls back from one to the other.

``qs_forward.launches`` counts the kernel's launches, so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.quickscorer import qs_scores
from . import build

SOURCE = "src/repro_torch/kernels/csrc/qs_forward.cu"
REPLACES = "src/repro/kernels/quickscorer_kernel.py:130"
MAX_WORDS = 8            # leafidx words a thread keeps in registers (L <= 256)
MAX_CLASSES = 16         # class accumulators a thread keeps in registers
MAX_TREE_CHUNK = 16      # trees a block stages in shared memory
SHARED_BYTES = 48 * 1024


def tree_chunk(n_trees: int, n_nodes: int, n_words: int) -> int:
    """Trees per block: as many as fit the shared-memory budget (feat,
    thr, masks per node and init_idx per tree, 4 bytes each), at most
    ``MAX_TREE_CHUNK``."""
    per_tree = 4 * (n_nodes * (2 + n_words) + n_words)
    return max(1, min(MAX_TREE_CHUNK, n_trees, SHARED_BYTES // per_tree))


def qs_forward_reference(x, feat, thr, masks, init_idx, leaf_val, *,
                         out_dtype=torch.float32) -> torch.Tensor:
    """The plain torch version: ``eval_batch``'s arithmetic on the padded
    kernel arrays (padding nodes carry thresholds no input exceeds;
    padding trees have init_idx 0 and zero leaf rows), taken over tree
    chunks.  Raw leaf sums (B, C) in ``out_dtype``."""
    return qs_scores(x, feat, thr, masks, init_idx, leaf_val, out_dtype)


def _check(x, feat, thr, masks, init_idx, leaf_val, out_dtype):
    named = dict(x=x, feat=feat, thr=thr, masks=masks, init_idx=init_idx,
                 leaf_val=leaf_val)
    dtypes = dict(x=torch.float32, feat=torch.int32, thr=torch.float32,
                  masks=torch.int32, init_idx=torch.int32,
                  leaf_val=torch.float32)
    ndims = dict(x=2, feat=2, thr=2, masks=3, init_idx=2, leaf_val=3)
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
    T, N = feat.shape
    W = masks.shape[-1]
    L, C = leaf_val.shape[1:]
    if thr.shape != (T, N) or masks.shape[:2] != (T, N) or \
            init_idx.shape != (T, W) or leaf_val.shape[0] != T:
        raise ValueError(
            f"inconsistent shapes: feat {tuple(feat.shape)}, thr "
            f"{tuple(thr.shape)}, masks {tuple(masks.shape)}, init_idx "
            f"{tuple(init_idx.shape)}, leaf_val {tuple(leaf_val.shape)}")
    if L > 32 * W:
        raise ValueError(f"{L} leaves need more than {W} leafidx words")
    if out_dtype not in (torch.float32, torch.int32):
        raise TypeError(f"out_dtype {out_dtype}: float32 or int32 only")


def _lib() -> ctypes.CDLL:
    lib = build.load("qs_forward")
    if lib.qs_forward_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qs_forward_launch.argtypes = [p] * 8 + [i] * 9 + [p]
        lib.qs_forward_launch.restype = ctypes.c_int
        lib.qs_error_string.argtypes = [i]
        lib.qs_error_string.restype = ctypes.c_char_p
    return lib


def qs_forward(x, feat, thr, masks, init_idx, leaf_val, *,
               out_dtype=torch.float32) -> torch.Tensor:
    """Padded kernel arrays → raw leaf sums (B, C) in ``out_dtype``.

    x (B, d) f32; feat (T, N) i32; thr (T, N) f32; masks (T, N, W) and
    init_idx (T, W) int32 bit patterns of uint32 words; leaf_val
    (T, L, C) f32 (exact integers for int-accum forests, which use
    ``out_dtype=torch.int32``).  Every ``feat`` entry must be < d: the
    kernel gathers without a bounds check (``ops.cuda_qs_predictor``
    checks it on the host)."""
    _check(x, feat, thr, masks, init_idx, leaf_val, out_dtype)
    if x.device.type == "cpu":
        return qs_forward_reference(x, feat, thr, masks, init_idx, leaf_val,
                                    out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"qs_forward runs on cuda or cpu, not {x.device}")
    B, d = x.shape
    T, N = feat.shape
    W = masks.shape[-1]
    L, C = leaf_val.shape[1:]
    if W > MAX_WORDS or C > MAX_CLASSES:
        raise ValueError(f"the kernel takes at most {MAX_WORDS} leafidx "
                         f"words (L <= {32 * MAX_WORDS}) and {MAX_CLASSES} "
                         f"classes; got W={W}, C={C}")
    out = torch.empty((B, C), dtype=out_dtype, device=x.device)
    if B == 0:
        return out
    tc = tree_chunk(T, N, W)
    partial = torch.empty((-(-T // tc), B, C), dtype=out_dtype,
                          device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qs_forward_launch(
            x.data_ptr(), feat.data_ptr(), thr.data_ptr(), masks.data_ptr(),
            init_idx.data_ptr(), leaf_val.data_ptr(), partial.data_ptr(),
            out.data_ptr(), B, d, T, N, W, L, C, tc,
            int(out_dtype == torch.int32), stream)
    if err != 0:
        raise RuntimeError("qs_forward kernel launch failed: "
                           + lib.qs_error_string(err).decode())
    qs_forward.launches += 1
    return out


qs_forward.launches = 0
