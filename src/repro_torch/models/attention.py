"""GQA attention — ``repro.models.attention``: self- and cross-attention
on the chunked flash prefill path, and the KV-cache decode path with a
bf16 or int8 cache.

Two engines, as in the reference's backend pairing: ``backend="torch"``
runs ``flash_attention``, the chunked online softmax of the reference's
XLA path ported to torch; ``backend="cuda"`` runs the hand-written kernel
(``kernels/flash_attention_kernel.flash_attention_bshd``), which on a CPU
tensor runs its plain version.

Under tensor parallelism (``attn_parallel``, a
``distributed.collectives.Parallel``) attention splits over the "model"
axis as the reference's ``_attn_shard_mode`` says: by heads when the head
count divides the axis (wq/wk/wv column-parallel, wo row-parallel, the
sequence gathered at the entry and reduce-scattered at the exit), else
by q positions (every weight whole, q from this rank's sequence chunk at
its absolute offset, K/V from the gathered sequence, no reduce).  With a
decode state the rank writes its shard of the KV cache as
``distributed.sharding.decode_state_specs`` places it: its kv heads when
they divide "model", else its head_dim slice, else all of it.  Both
modes run the model's backend: on ``backend="cuda"`` the "heads" mode
runs the kernel on the rank's heads, the "seq" mode on the rank's query
chunk with the kernel's ``q_offset`` at the chunk's position
(``MODE_CALLS`` counts the calls of each mode).
``attn_decode_parallel`` and ``cross_decode_parallel`` are the decode
steps on the rank's cache shard.

Cross-attention (the encdec family's decoder) reads K and V from the
encoder's output with no RoPE, no mask and full MHA (``make_attn_params(
cross=True)``); on ``backend="cuda"`` it is the same kernel, non-causal,
with Sq != Sk.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..distributed.collectives import all_reduce, all_reduce_max
from ..kernels.flash_attention_kernel import flash_attention_bshd
from .act_sharding import model_axis_size
from .config import ArchConfig
from .layers import apply_rope

NEG_INF = -1e30
BACKENDS = ("torch", "cuda")
# ``attn_parallel``'s calls by mode in this process ("heads": the rank's
# heads; "seq": the rank's q positions; both on the model's backend)
MODE_CALLS = {"heads": 0, "seq": 0}


def _attn_shard_mode(n_heads: int) -> str:
    """How attention splits over the "model" axis of the policy:
      "heads" — head parallelism (H % model == 0);
      "seq"   — sequence-parallel q when the head count does not divide
                (smollm 15H, starcoder2 24H on 16), K/V replicated;
      "none"  — no model axis."""
    ms = model_axis_size()
    if ms == 1:
        return "none"
    return "heads" if n_heads % ms == 0 else "seq"


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
                    k_chunk: int = 1024, n_rep: int = 1,
                    q_offset: int = 0) -> torch.Tensor:
    """Memory-bounded softmax attention: a loop over KV chunks with running
    (max, sum, acc), as ``repro.models.attention.flash_attention``.
    q (B, Sq, H, hd), k/v (B, Sk, K, hd) with H = K·n_rep, the GQA repeat
    made per chunk.  Scores and accumulators are f32; probabilities pass
    through v's dtype before the PV product, as the reference's do.

    Chunks wholly above the causal diagonal are skipped: in the reference
    they add exp(-1e30 - m) = 0 with a correction of exactly 1, so the
    result is the same.  Unlike the reference, Sq and Sk need not divide
    by the chunks.  The causal mask is top-left aligned (the prefill's),
    q's first row at position ``q_offset``."""
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
        q_pos = torch.arange(q_offset + q0, q_offset + q0 + qc,
                             device=q.device)
        m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, qc, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Sk, k_chunk):
            if causal and q_offset + q0 + qc - 1 < k0:
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


def _attend(q, k, v, causal: bool, q_chunk: int, backend: str,
            q_offset: int = 0):
    """q (B, Sq, H, hd) over k/v (B, Sk, K, hd) on ``backend``'s engine,
    q's first row at key position ``q_offset``."""
    if backend == "cuda":
        return flash_attention_bshd(q, k, v, causal=causal,
                                    q_offset=q_offset)
    return flash_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                           n_rep=q.shape[2] // k.shape[2], q_offset=q_offset)


def attn_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, causal: bool = True,
                 memory: Optional[torch.Tensor] = None,
                 q_chunk: int = 1024, backend: str = "torch",
                 kv_cache: Optional[tuple] = None,
                 kv_scales: Optional[tuple] = None) -> torch.Tensor:
    """Prefill attention over x (B, S, D).  ``memory`` (B, Sm, D) switches
    to cross-attention (``cross_attn_forward``).

    ``kv_cache``: optional (k_cache, v_cache) of shape (B, Smax, K, hd).
    The post-RoPE K and V are written into positions 0..S-1 in the
    cache's dtype, and attention reads them back in that dtype, as the
    reference's sequential prefill reads its cache (``attention.py:244-250``).
    With ``kv_scales`` (k_scale, v_scale) (B, Smax, K) the cache is int8:
    K and V are quantized per (batch, position, head) by
    ``quantize_kv_token``, values and scales written, and attention reads
    the dequantized k̂·scale in q's dtype.  The reference's decode steps
    apply the scales to the scores and the weights instead, rounding
    w·v_scale to bf16 (ROADMAP Queue C).
    """
    if memory is not None:
        k, v = cross_memory_kv(p, memory, x.dtype)
        return cross_attn_forward(p, x, cfg, k, v, q_chunk=q_chunk,
                                  backend=backend)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        k, v = _store_kv(k, v, kv_cache, kv_scales, q.dtype, 0)
    out = _attend(q, k, v, causal, q_chunk, backend)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def cross_attn_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                       mem_k: torch.Tensor, mem_v: torch.Tensor, *,
                       q_chunk: int = 1024,
                       backend: str = "torch") -> torch.Tensor:
    """Cross-attention of x (B, S, D) over the memory's K/V (B, Sm, H, hd):
    q without RoPE, every memory position visible, full MHA.  K and V are
    cast to x's dtype first (a bf16 decode state read by an f32 model), as
    ``cross_attn_decode``'s products promote them."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    out = _attend(q, mem_k.to(q.dtype), mem_v.to(q.dtype), False, q_chunk,
                  backend)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ------------------------------------------------------ tensor parallelism
def _kv_heads(k: torch.Tensor, h0: int, n_heads: int, n_rep: int,
              lo: int) -> torch.Tensor:
    """k (B, S, kv heads lo.., hd) → the kv heads that q heads h0..h0+n-1
    read, as ``_attend`` takes them: whole groups of ``n_rep``, one kv
    head for all, or else one per q head."""
    hi = (h0 + n_heads - 1) // n_rep + 1
    if (h0 % n_rep == 0 and n_heads % n_rep == 0) or hi - h0 // n_rep == 1:
        return k[:, :, h0 // n_rep - lo:hi - lo]
    idx = torch.arange(h0, h0 + n_heads, device=k.device) // n_rep - lo
    return k[:, :, idx]


def attn_parallel(p: dict, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, par, md: dict, *,
                  causal: bool = True, memory=None, mem_kv=None,
                  q_chunk: int = 1024, backend: str = "torch",
                  kv_cache: Optional[tuple] = None,
                  kv_scales: Optional[tuple] = None) -> torch.Tensor:
    """Self-attention (or cross-attention over the gathered encoder output
    ``memory`` (B, Sm, D), or over ``mem_kv``, a decode state's cross K/V
    as this rank holds them) of this rank's sequence chunk x (B, S/m, D),
    or of the whole sequence where ``par`` does not split it, → its chunk
    of the output (the whole output).  ``positions`` (B, S) are global;
    ``md`` each weight's "model" dim.  ``backend`` is both modes' engine
    (the "seq" mode's query chunk at its offset ``par.offset``).
    ``kv_cache`` and ``kv_scales``: this rank's shard of a decode state's
    caches, filled as ``attn_forward`` fills the whole ones
    (``_store_kv``)."""
    H, hd = cfg.n_heads, cfg.head_dim
    cross = memory is not None or mem_kv is not None
    K = H if cross else cfg.n_kv
    n_rep = H // K
    if H % par.m:                                   # "seq": q positions
        MODE_CALLS["seq"] += 1
        w = {k: par.want(v, md[k]) for k, v in p.items()
             if not (mem_kv is not None and k in ("wk", "wv"))}
        S = x.shape[1]
        off = par.offset(S)
        q = torch.einsum("bsd,dhk->bshk", x, w["wq"])
        if cross:
            k, v = (cross_memory_kv(w, memory, x.dtype) if mem_kv is None
                    else (t.to(q.dtype) for t in mem_kv))
            out = _attend(q, k, v, False, q_chunk, backend)
        else:
            xf = par.gather_seq(x)
            k = torch.einsum("bsd,dhk->bshk", xf, w["wk"])
            v = torch.einsum("bsd,dhk->bshk", xf, w["wv"])
            q = apply_rope(q, positions[:, off:off + S], cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            if kv_cache is not None:
                k, v = _store_kv(k, v, kv_cache, kv_scales, q.dtype, par.r)
            out = _attend(q, k, v, causal, q_chunk, backend, q_offset=off)
        return torch.einsum("bshk,hkd->bsd", out, w["wo"])
    MODE_CALLS["heads"] += 1
    Hl = H // par.m                                 # "heads"
    h0 = par.r * Hl
    wq, wo = par.want(p["wq"], md["wq"], 1), par.want(p["wo"], md["wo"], 0)
    lo = h0 // n_rep if K % par.m == 0 else 0
    xf = par.gather_seq(x)
    q = torch.einsum("bsd,dhk->bshk", xf, wq)
    if mem_kv is not None:
        # the state holds the rank's cross heads (K = H divides "model")
        k, v = (t.to(q.dtype) for t in mem_kv)
    else:
        wk, wv = (par.want(p[n], md[n], 1 if K % par.m == 0 else None)
                  for n in ("wk", "wv"))
        if memory is not None:
            k, v = cross_memory_kv({"wk": wk, "wv": wv}, memory, x.dtype)
        else:
            k = torch.einsum("bsd,dhk->bshk", xf, wk)
            v = torch.einsum("bsd,dhk->bshk", xf, wv)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            if kv_cache is not None:
                k, v = _store_kv(k, v, kv_cache, kv_scales, q.dtype, par.r)
    k, v = (_kv_heads(t, h0, Hl, n_rep, lo) for t in (k, v))
    out = _attend(q, k, v, causal and not cross, q_chunk, backend)
    return par.scatter_seq(torch.einsum("bshk,hkd->bsd", out, wo))


def _store_kv(k: torch.Tensor, v: torch.Tensor, kv_cache: tuple,
              kv_scales: Optional[tuple], dtype, r: int) -> tuple:
    """Write K and V (B, S, kv heads, hd), every head this rank computed,
    into positions 0..S-1 of its cache shards: the same heads, or its
    head_dim slice (``r``-th of the shard's width) of them; int8 values
    quantized over the whole head_dim, with their scales.  Returns (k, v)
    as attention reads them back: rounded to the cache's dtype (or
    dequantized), then in ``dtype``, as ``attn_forward`` reads its
    cache."""
    S, hd = k.shape[1], k.shape[-1]
    n = kv_cache[0].shape[-1]
    cols = slice(r * n, (r + 1) * n)
    read = []
    for i, t in enumerate((k, v)):
        cache = kv_cache[i]
        if kv_scales is None:
            cache[:, :S] = t[..., cols] if n < hd else t
            read.append(t.to(cache.dtype).to(dtype))
            continue
        vals, scale = quantize_kv_token(t)
        cache[:, :S] = vals[..., cols] if n < hd else vals
        kv_scales[i][:, :S] = scale
        read.append((vals.float() * scale[..., None]).to(dtype))
    return tuple(read)


# ----------------------------------------------------------------------- KV
def quantize_kv_token(x: torch.Tensor, group=None):
    """x (..., hd) → (int8 values, f32 scale (...)): per row, scale =
    max(amax, 1e-8) / 127 and round(x / scale) (half to even, as
    ``jnp.round``) clipped to ±127 — the reference's bits exactly.  With
    ``group`` x is this rank's slice of each row, and the amax is taken
    over the group's slices (``all_reduce_max``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    if group is not None:
        amax = all_reduce_max(amax, group)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def attn_decode_step(p: dict, x: torch.Tensor, cfg: ArchConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     index: int, k_scale: torch.Tensor = None,
                     v_scale: torch.Tensor = None, *, qkv: tuple = None,
                     group=None):
    """One-token GQA self-attention decode.  x (B, 1, D); k_cache/v_cache
    (B, Smax, K, hd) in the cache dtype; ``index`` the position of the new
    token.  Writes the new K and V into the caches in place (the reference
    returns new caches) and returns (out (B, 1, D), k_cache, v_cache).

    Scores and softmax are f32, the probabilities pass through x's dtype
    before the PV product, as in the reference.  Only positions
    0..index are read: the reference masks the rest to -1e30, whose
    weights are exactly 0.

    With ``k_scale``/``v_scale`` (B, Smax, K) f32 the caches are int8: the
    new K and V are quantized (``quantize_kv_token``) and their scales
    written in place too, the scores are q·k̂ (k̂ read as bf16) times
    k_scale, and the weights times v_scale are rounded to bf16 before the
    product with v̂ — in an f32 model as well, as the reference does.
    Returns (out, k_cache, v_cache, k_scale, v_scale).

    The head counts are the weights': a rank's heads of them on a mesh
    (``attn_decode_parallel``).  There a cache split over head_dim holds
    the rank's slice of every head: ``qkv`` is then the new token's q, K
    (RoPE applied) and V cut to that slice, ``p`` holds ``wo``'s matching
    rows, and ``group`` sums the f32 scores over the slices (and takes
    the int8 scales' amax over them); the output is the rank's share."""
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale go together")
    if qkv is None:
        pos = torch.full((x.shape[0], 1), index, dtype=torch.int64,
                         device=x.device)
        q, k_new = (apply_rope(torch.einsum("bsd,dhk->bshk", x, p[n]), pos,
                               cfg.rope_theta) for n in ("wq", "wk"))
        v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    else:
        q, k_new, v_new = qkv
    B, _, H, n = q.shape
    K = k_new.shape[2]
    new = slice(index, index + 1)
    if quant:
        (k_new, k_scale[:, new]), (v_new, v_scale[:, new]) = \
            quantize_kv_token(k_new, group), quantize_kv_token(v_new, group)
    k_cache[:, new] = k_new
    v_cache[:, new] = v_new

    seen = slice(0, index + 1)
    qg = q.reshape(B, K, H // K, n).float()                      # grouped q
    # the int8 values pass through bf16 (exactly) as the reference's do
    kc, vc = ((c[:, seen].to(torch.bfloat16) if quant else c[:, seen])
              .float() for c in (k_cache, v_cache))
    s = torch.einsum("bkrh,bskh->bkrs", qg, kc)
    if group is not None:
        s = all_reduce(s, group)
    s = s * (cfg.head_dim ** -0.5)
    if quant:
        s = s * k_scale[:, seen].transpose(1, 2)[:, :, None, :]
    w = torch.softmax(s, dim=-1)
    if quant:
        w = (w * v_scale[:, seen].transpose(1, 2)[:, :, None, :]) \
            .to(torch.bfloat16)
    else:
        w = w.to(x.dtype)
    out = torch.einsum("bkrs,bskh->bkrh", w.float(), vc)
    out = out.reshape(B, 1, H, n).to(x.dtype)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if quant:
        return out, k_cache, v_cache, k_scale, v_scale
    return out, k_cache, v_cache


def attn_decode_parallel(p: dict, x: torch.Tensor, cfg: ArchConfig,
                         k_cache: torch.Tensor, v_cache: torch.Tensor,
                         index: int, par, md: dict,
                         k_scale: torch.Tensor = None,
                         v_scale: torch.Tensor = None) -> torch.Tensor:
    """``attn_decode_step`` on a mesh: x (B, 1, D) whole on every "model"
    rank against this rank's cache shard, as ``decode_state_specs`` places
    it; the output (B, 1, D) whole on every rank.

      * kv heads over "model": the rank's q heads against its kv heads,
        the partial outputs all-reduced;
      * head_dim over "model": q and the new K whole (RoPE pairs dims
        across the halves of head_dim), then the rank's slice, V's slice
        from ``wv``'s columns; ``attn_decode_step`` over the slices with
        ``wo``'s matching rows, the partial outputs all-reduced;
      * neither divides: the state whole on every rank, every rank the
        whole step."""
    K, hd = cfg.n_kv, cfg.head_dim
    quant = {} if k_scale is None else dict(k_scale=k_scale, v_scale=v_scale)
    if k_cache.shape[-2] < K:                       # kv heads
        w = {n: par.want(t, md[n], 0 if n == "wo" else 1)
             for n, t in p.items()}
        out = attn_decode_step(w, x, cfg, k_cache, v_cache, index,
                               **quant)[0]
        return all_reduce(out, par.model)
    n = k_cache.shape[-1]
    if n == hd:                                     # replicated
        w = {k: par.want(t, md[k]) for k, t in p.items()}
        return attn_decode_step(w, x, cfg, k_cache, v_cache, index,
                                **quant)[0]
    cols = slice(par.r * n, (par.r + 1) * n)        # head_dim
    pos = torch.full((x.shape[0], 1), index, dtype=torch.int64,
                     device=x.device)

    def whole(name):
        # a projection whole over heads and head_dim: this rank's share by
        # the weight as stored, gathered along the activation's dim
        y = torch.einsum("bsd,dhk->bshk", x, p[name])
        y = par.want(y, None if md[name] is None else md[name] + 1)
        return apply_rope(y, pos, cfg.rope_theta)[..., cols]
    v_new = torch.einsum("bsd,dhk->bshk", x, par.want(p["wv"], md["wv"], 2))
    out = attn_decode_step({"wo": par.want(p["wo"], md["wo"], 1)}, x, cfg,
                           k_cache, v_cache, index, **quant,
                           qkv=(whole("wq"), whole("wk"), v_new),
                           group=par.model)[0]
    return all_reduce(out, par.model)


def cross_attn_decode(p: dict, x: torch.Tensor, cfg: ArchConfig,
                      mem_k: torch.Tensor, mem_v: torch.Tensor):
    """One-token cross-attention of x (B, 1, D) against the precomputed
    memory K/V (B, Sm, H, hd): q without RoPE, f32 scores over every
    memory position, the weights cast to x's dtype before the PV product.
    """
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    s = torch.einsum("bqhk,bshk->bhqs", q.float(), mem_k.float()) \
        * (cfg.head_dim ** -0.5)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhqs,bshk->bqhk", w.float(), mem_v.float()) \
        .to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def cross_decode_parallel(p: dict, x: torch.Tensor, cfg: ArchConfig,
                          mem_k: torch.Tensor, mem_v: torch.Tensor, par,
                          md: dict) -> torch.Tensor:
    """``cross_attn_decode`` on a mesh over the rank's cross K/V: its heads
    (then the partial outputs all-reduced), or all of them where the heads
    do not divide "model"."""
    if mem_k.shape[-2] < cfg.n_heads:
        w = {"wq": par.want(p["wq"], md["wq"], 1),
             "wo": par.want(p["wo"], md["wo"], 0)}
        return all_reduce(cross_attn_decode(w, x, cfg, mem_k, mem_v),
                          par.model)
    w = {n: par.want(p[n], md[n]) for n in ("wq", "wo")}
    return cross_attn_decode(w, x, cfg, mem_k, mem_v)


def cross_memory_kv(p: dict, memory: torch.Tensor, dtype=torch.bfloat16):
    """Cross-attention K/V (B, Sm, H, hd) in ``dtype`` from the encoder
    output (B, Sm, D), computed once.  The product is taken in the wider
    of the memory's and the weights' dtypes, as the reference's einsum
    promotes f32 master weights against a bf16 memory."""
    dt = torch.promote_types(memory.dtype, p["wk"].dtype)
    k, v = (torch.einsum("bsd,dhk->bshk", memory.to(dt), p[w].to(dt))
            .to(dtype) for w in ("wk", "wv"))
    return k, v
