"""What every CUDA kernel wrapper shares: the limits of one block, operand
checks, the choice between the card and the plain version, and the ctypes
launch on the current stream."""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_NODES = 256          # nodes per tree whose conditions fit 8 bit words
MAX_CLASSES = 16         # class accumulators a thread keeps in registers
MAX_TREE_CHUNK = 16      # trees a block stages in shared memory
SHARED_BYTES = 48 * 1024           # shared memory a block uses by default
MAX_SHARED_BYTES = 232448          # 227 KB: the most a block may opt into


def trees_per_block(n_trees: int, per_tree_bytes: int) -> int:
    """As many trees as fit ``SHARED_BYTES``, at least one and at most
    ``MAX_TREE_CHUNK``."""
    return max(1, min(MAX_TREE_CHUNK, n_trees,
                      SHARED_BYTES // max(per_tree_bytes, 1)))


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


def library(name: str, fn: str, err_fn: str, n_ptrs: int,
            n_ints: int) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` with its launch function ``fn`` typed
    as ``n_ptrs`` pointers, ``n_ints`` ints and a stream, returning an
    int error code that ``err_fn`` turns into a message."""
    lib = build.load(name)
    launch_fn = getattr(lib, fn)
    if launch_fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        launch_fn.argtypes = [p] * n_ptrs + [i] * n_ints + [p]
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
