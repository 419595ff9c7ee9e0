"""CUDA kernel: causal or non-causal GQA flash attention, hand-written for
Hopper.

``flash_forward`` replaces the Pallas TPU kernel of the same name
(``repro/kernels/flash_attention_kernel.py:86``): q (BH, Sq, hd) against
k/v (BK, Sk, hd) with BH = BK·n_rep and the heads of one batch element
contiguous, so query row ``bh`` reads kv row ``bh // n_rep``.  Scores are
scaled by hd^-½; the causal mask ``qpos >= kpos`` is top-left aligned
(also for Sq != Sk), with q's first row at position ``q_offset`` (0 in
the Pallas kernel; a rank of the sharded prefill passes its chunk's
offset, ``models/attention.attn_parallel``); the online-softmax state (m,
l, acc) is f32; the output is ``acc / max(l, 1e-30)`` in q's dtype (f32
or bf16).

For a CUDA tensor it launches ``csrc/flash_forward.cu`` (built by
``kernels/build.py``) on the current stream, or raises; for a CPU tensor
it runs ``flash_forward_reference``, the same function in plain torch.
Nothing falls back from one to the other.  Tile sizes are the kernel's
own: any Sq and Sk work, the ragged edge is masked in the kernel.

The source holds two kernels, chosen by dtype alone (``flash_route``):
bf16 goes to the tensor cores (``"wgmma"``: wgmma products, TMA copies;
P rounded to bf16 before the PV product, as SDPA does), f32 to the CUDA
cores (``"simt"``, whose f32 products hold the reference's 2e-5, which a
TF32 tensor-core product would not).  TMA cannot address rows under 16
bytes, so on the wgmma route a head width that is not a multiple of 8 (4)
is widened with zero columns first (``tma_head_dim``); the kernel's tile
then zero-fills up to its own width (16, 64 or 128).  Zero columns add
nothing to q.k and give output columns that are dropped.

The kernel has no backward pass (the Pallas kernel has none either), so
``flash_forward`` refuses, on either device, inputs that autograd would
differentiate: a result with no graph would silently drop the attention
path's share of the gradient.  Training runs ``backend="torch"``.

``.launches`` counts the kernel's launches and ``.launches_by_route``
splits them by route; ``.source`` and ``.replaces`` name the CUDA source
and the TPU kernel.
"""
from __future__ import annotations

import struct

import torch
import torch.nn.functional as F

from .launch import check_tensors, launch, library, on_card

NEG_INF = -1e30
HEAD_DIMS = (4, 8, 16, 64, 96, 128)    # instantiated in flash_forward.cu
MAX_HEAD_ROWS = 65535                   # BH rides on gridDim.y
PLAIN_BLOCK = 512                       # q and k chunk of the plain version


def flash_route(dtype: torch.dtype) -> str:
    """The kernel a dtype goes to: ``"wgmma"`` for bf16, ``"simt"`` for
    f32."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def tma_head_dim(hd: int) -> int:
    """The least width >= hd whose bf16 rows are a multiple of 16 bytes,
    as TMA needs: what the wrapper widens q, k and v to."""
    return -(-hd // 8) * 8


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            n_rep: int = 1,
                            q_offset: int = 0) -> torch.Tensor:
    """The plain torch version: the Pallas kernel's arithmetic (q·scale,
    k and v in f32, masked scores -1e30, f32 m/l/acc) as a chunked online
    softmax over ``PLAIN_BLOCK`` keys, so S = 32768 fits in memory.  Key
    chunks wholly above the causal diagonal (shifted by ``q_offset``) are
    not visited; the loop starts at key 0, which every query row sees."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    scale = hd ** -0.5
    out = torch.empty_like(q)
    # (BH, Sk, hd) views of k/v per query row: row bh reads kv bh // n_rep
    kf = k.float().repeat_interleave(n_rep, dim=0)
    vf = v.float().repeat_interleave(n_rep, dim=0)
    for q0 in range(0, Sq, PLAIN_BLOCK):
        q1 = min(q0 + PLAIN_BLOCK, Sq)
        qb = q[:, q0:q1].float() * scale
        m = torch.full((BH, q1 - q0), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((BH, q1 - q0, hd), dtype=torch.float32,
                          device=q.device)
        k_end = min(Sk, q_offset + q1) if causal else Sk
        for k0 in range(0, k_end, PLAIN_BLOCK):
            k1 = min(k0 + PLAIN_BLOCK, Sk)
            s = qb @ kf[:, k0:k1].transpose(1, 2)
            if causal:
                qpos = torch.arange(q_offset + q0, q_offset + q1,
                                    device=q.device)[:, None]
                kpos = torch.arange(k0, k1, device=q.device)[None, :]
                s = torch.where(qpos >= kpos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vf[:, k0:k1]
            m = m_new
        out[:, q0:q1] = (acc / torch.clamp(l, min=1e-30)[..., None]) \
            .to(q.dtype)
    return out


def _check(q, k, v, n_rep, causal, q_offset):
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {dt}, expected float32 or bfloat16")
    check_tensors(q, dict(q=q, k=k, v=v), dict(q=dt, k=dt, v=dt),
                  dict(q=3, k=3, v=3))
    BH, Sq, hd = q.shape
    BK, Sk, hdk = k.shape
    if v.shape != k.shape or hdk != hd:
        raise ValueError(f"inconsistent shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if n_rep < 1 or BH != BK * n_rep:
        raise ValueError(f"q has {BH} head rows, k/v {BK}: BH must be "
                         f"BK·n_rep with n_rep={n_rep}")
    if Sk < 1:
        raise ValueError("k/v hold no key")
    if q_offset < 0 or (causal and q_offset and q_offset + Sq > Sk):
        raise ValueError(f"q_offset {q_offset}: the {Sq} query rows must "
                         f"lie within the {Sk} keys (0 <= q_offset, "
                         f"q_offset + Sq <= Sk under the causal mask)")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, n_rep: int = 1,
                  q_offset: int = 0) -> torch.Tensor:
    """q (BH, Sq, hd); k/v (BK, Sk, hd) with BH = BK·n_rep (heads of one
    batch element contiguous), all contiguous and of one dtype, f32 or
    bf16.  Under ``causal`` q row i sees keys j <= i + ``q_offset``; a
    positive offset needs ``q_offset + Sq <= Sk`` (``ValueError``, before
    anything reaches the card); non-causal calls ignore it.  Returns (BH,
    Sq, hd) in q's dtype.  Raises under autograd (grad mode on and q, k or
    v requiring grad): there is no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_forward has no backward pass: train on "
                           "Model(backend=\"torch\"), the chunked flash "
                           "in torch")
    _check(q, k, v, n_rep, causal, q_offset)
    if not on_card(q, "flash_forward"):
        return flash_forward_reference(q, k, v, causal=causal, n_rep=n_rep,
                                       q_offset=q_offset)
    BH, Sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the kernel is built for "
                         f"{HEAD_DIMS}")
    if BH > MAX_HEAD_ROWS:
        raise ValueError(f"{BH} head rows: the kernel takes at most "
                         f"{MAX_HEAD_ROWS}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    if Sq == 0 or BH == 0:
        return torch.empty_like(q)
    # the scale as the f32 bit pattern of hd ** -0.5, as the plain version
    # rounds it
    scale_bits = struct.unpack("<i", struct.pack("<f", hd ** -0.5))[0]
    route = flash_route(q.dtype)
    hd_k = tma_head_dim(hd) if route == "wgmma" else hd
    if hd_k != hd:
        q, k, v = (F.pad(t, (0, hd_k - hd)) for t in (q, k, v))
    out = torch.empty_like(q)
    lib = library("flash_forward", "flash_forward_launch",
                  "flash_error_string", 4, 9)
    launch(lib.flash_forward_launch, lib.flash_error_string,
           "flash_forward", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), BH, Sq, k.shape[1], hd_k, n_rep,
           int(causal), q_offset if causal else 0, int(route == "wgmma"),
           scale_bits)
    flash_forward.launches += 1
    flash_forward.launches_by_route[route] += 1
    return out if hd_k == hd else out[..., :hd].contiguous()


flash_forward.launches = 0
flash_forward.launches_by_route = {"wgmma": 0, "simt": 0}
flash_forward.source = "src/repro_torch/kernels/csrc/flash_forward.cu"
flash_forward.replaces = "src/repro/kernels/flash_attention_kernel.py:86"


def _head_major(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) → contiguous (B·H, S, hd)."""
    B, S, H, hd = t.shape
    return t.transpose(1, 2).reshape(B * H, S, hd).contiguous()


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         q_offset: int = 0) -> torch.Tensor:
    """``flash_forward`` over q (B, Sq, H, hd) and k/v (B, Sk, K, hd) — the
    ``models/attention.py`` layout; H must be a multiple of K; q's first
    row at key position ``q_offset``."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    if H % K:
        raise ValueError(f"{H} query heads over {K} kv heads")
    out = flash_forward(_head_major(q), _head_major(k), _head_major(v),
                        causal=causal, n_rep=H // K, q_offset=q_offset)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)
