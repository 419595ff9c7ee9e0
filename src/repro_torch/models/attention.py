"""GQA attention — the dense path of ``repro.models.attention``: the chunked
flash prefill path and the KV-cache decode path.

Two engines, as in the reference's backend pairing: ``backend="torch"``
runs ``flash_attention``, the chunked online softmax of the reference's
XLA path ported to torch; ``backend="cuda"`` runs the hand-written kernel
(``kernels/flash_attention_kernel.flash_attention_bshd``), which on a CPU
tensor runs its plain version.  The reference's sharding constraints are
no-ops on one device and are left out.

Waiting for later slices (ROADMAP Queue A 12): the int8 KV cache
(``quantize_kv_token``, ``k_scale=``), ``cross_attn_decode`` and
``cross_memory_kv`` (encdec), each of which raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention_kernel import flash_attention_bshd
from .config import ArchConfig
from .layers import apply_rope

NEG_INF = -1e30
BACKENDS = ("torch", "cuda")


def waits(what: str):
    """Raise for a feature a later slice of the port brings."""
    raise NotImplementedError(f"{what} waits for a later slice of the port "
                              "(ROADMAP Queue A 12)")


def make_attn_params(mk, cfg: ArchConfig, cross: bool = False,
                     extra_axes: tuple = ()) -> dict:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    if cross:
        K = cfg.n_heads  # cross-attention: full MHA
    ea = tuple(extra_axes)
    pre = ("layers",) * len(ea)
    return {
        "wq": mk(ea + (D, H, hd), pre + ("embed", "heads", "head_dim")),
        "wk": mk(ea + (D, K, hd), pre + ("embed", "kv", "head_dim")),
        "wv": mk(ea + (D, K, hd), pre + ("embed", "kv", "head_dim")),
        "wo": mk(ea + (H, hd, D), pre + ("heads", "head_dim", "embed")),
    }


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, K, hd) → (B, S, K*n_rep, hd): head h reads kv head h // n_rep."""
    if n_rep == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, hd) \
        .reshape(b, s, kh * n_rep, hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_chunk: int = 1024,
                    k_chunk: int = 1024, n_rep: int = 1) -> torch.Tensor:
    """Memory-bounded softmax attention: a loop over KV chunks with running
    (max, sum, acc), as ``repro.models.attention.flash_attention``.
    q (B, Sq, H, hd), k/v (B, Sk, K, hd) with H = K·n_rep, the GQA repeat
    made per chunk.  Scores and accumulators are f32; probabilities pass
    through v's dtype before the PV product, as the reference's do.

    Chunks wholly above the causal diagonal are skipped: in the reference
    they add exp(-1e30 - m) = 0 with a correction of exactly 1, so the
    result is the same.  Unlike the reference, Sq and Sk need not divide
    by the chunks.  The causal mask is top-left aligned (the prefill's)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if K * n_rep != H:
        raise ValueError(f"{K} kv heads × n_rep {n_rep} != {H} heads")
    scale = hd ** -0.5
    q_chunk, k_chunk = min(q_chunk, Sq), min(k_chunk, Sk)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        q_blk = q[:, q0:q0 + q_chunk].float()
        qc = q_blk.shape[1]
        q_pos = torch.arange(q0, q0 + qc, device=q.device)
        m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, qc, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Sk, k_chunk):
            if causal and q0 + qc - 1 < k0:
                break                      # this chunk and all later: masked
            k_blk = _repeat_kv(k[:, k0:k0 + k_chunk], n_rep)
            v_blk = _repeat_kv(v[:, k0:k0 + k_chunk], n_rep)
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk.float()) * scale
            if causal:
                k_pos = torch.arange(k0, k0 + k_blk.shape[1], device=q.device)
                bias = torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                                   NEG_INF).to(torch.float32)
                s = s + bias
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v_blk.dtype).float(), v_blk.float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.transpose(1, 2))                   # (B, qc, H, hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def attn_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, causal: bool = True,
                 memory: Optional[torch.Tensor] = None,
                 q_chunk: int = 1024, backend: str = "torch",
                 kv_cache: Optional[tuple] = None) -> torch.Tensor:
    """Prefill attention over x (B, S, D).

    ``kv_cache``: optional (k_cache, v_cache) of shape (B, Smax, K, hd).
    The post-RoPE K and V are written into positions 0..S-1 in the
    cache's dtype, and attention reads them back in that dtype, as the
    reference's sequential prefill reads its cache (``attention.py:244-250``).
    """
    if memory is not None:
        waits("cross-attention (encdec)")
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        S = x.shape[1]
        k_cache[:, :S] = k
        v_cache[:, :S] = v
        k = k_cache[:, :S].to(q.dtype)
        v = v_cache[:, :S].to(q.dtype)
    if backend == "cuda":
        out = flash_attention_bshd(q, k, v, causal=causal)
    else:
        out = flash_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                              n_rep=cfg.n_heads // cfg.n_kv)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ----------------------------------------------------------------------- KV
def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  n_attn_layers: int, dtype=torch.bfloat16,
                  device="cpu") -> dict:
    K, hd = cfg.n_kv, cfg.head_dim
    shape = (n_attn_layers, batch, max_len, K, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def quantize_kv_token(x: torch.Tensor):
    waits("the int8 KV cache")


def attn_decode_step(p: dict, x: torch.Tensor, cfg: ArchConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     index: int, k_scale: torch.Tensor = None,
                     v_scale: torch.Tensor = None):
    """One-token GQA self-attention decode.  x (B, 1, D); k_cache/v_cache
    (B, Smax, K, hd) in the cache dtype; ``index`` the position of the new
    token.  Writes the new K and V into the caches in place (the reference
    returns new caches) and returns (out (B, 1, D), k_cache, v_cache).

    Scores and softmax are f32, the probabilities pass through x's dtype
    before the PV product, as in the reference.  Only positions
    0..index are read: the reference masks the rest to -1e30, whose
    weights are exactly 0."""
    if k_scale is not None or v_scale is not None:
        waits("the int8 KV cache")
    B = x.shape[0]
    K, hd = cfg.n_kv, cfg.head_dim
    R = cfg.n_heads // K
    pos = torch.full((B, 1), index, dtype=torch.int64, device=x.device)
    q = apply_rope(torch.einsum("bsd,dhk->bshk", x, p["wq"]), pos,
                   cfg.rope_theta)
    k_new = apply_rope(torch.einsum("bsd,dhk->bshk", x, p["wk"]), pos,
                       cfg.rope_theta)
    v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    k_cache[:, index:index + 1] = k_new
    v_cache[:, index:index + 1] = v_new

    qg = q.reshape(B, K, R, hd).float()                          # grouped q
    kc = k_cache[:, :index + 1].float()
    vc = v_cache[:, :index + 1].float()
    s = torch.einsum("bkrh,bskh->bkrs", qg, kc) * (hd ** -0.5)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bkrs,bskh->bkrh", w.float(), vc)
    out = out.reshape(B, 1, cfg.n_heads, hd).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), k_cache, v_cache


def cross_attn_decode(p: dict, x: torch.Tensor, cfg: ArchConfig,
                      mem_k: torch.Tensor, mem_v: torch.Tensor):
    waits("cross-attention decode (encdec)")


def cross_memory_kv(p: dict, memory: torch.Tensor, dtype=torch.bfloat16):
    waits("cross-attention memory K/V (encdec)")
