"""Mamba2 SSD (state-space duality) block in plain torch — the port's
counterpart of ``repro.models.mamba``: the chunked parallel form for the
forward pass and prefill, the O(1) recurrent form for decode.

Recurrence (per head h, state N, head-dim P):
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t        h ∈ R^{P×N}
    y_t = C_t · h_t + D x_t

Chunked form (chunk Q), with the running log-decay
``cum_i = Σ_{k≤i} dt_k A`` inside a chunk:
    y_intra_i = Σ_{j≤i} exp(cum_i − cum_j) dt_j (C_i·B_j) x_j
    y_inter_i = exp(cum_i) (C_i · h_in)
    h_out     = exp(cum_Q) h_in + Σ_j exp(cum_Q − cum_j) dt_j B_j ⊗ x_j
All exponents are ≤ 0 (A < 0).  The reference threads the chunk states
with ``lax.scan`` and needs S to be a multiple of the chunk; here a Python
loop over the chunks takes a short last chunk, so a prompt of any length
prefills.  The reference's batch sharding constraints have no counterpart:
on a mesh each rank's activations are its batch shard already
(``models/act_sharding.py``).

``ssm_parallel`` is the form on a mesh whose "model" axis divides the SSD
heads: each rank runs its heads (its d_inner columns of in_z/in_x/conv_x/
norm, its in_dt columns and per-head constants) on the gathered sequence,
in_B/in_C whole, the gated norm's sum of squares all-reduced over
"model", and ``out`` row-parallel, reduce-scattered into its sequence
chunk.  With a decode state it also leaves the rank's shards of it, as
``distributed.sharding.decode_state_specs`` places them: ``ssm_h`` of
its heads, ``conv`` of its d_inner columns.  Where the heads do not
divide "model" every rank runs the whole block; the state's ``ssm_h`` is
then whole on each rank, but its ``conv`` window is still split over
d_inner wherever d_inner divides "model", so a rank keeps its columns of
a window it computed whole, and the decode step (``ssm_decode_parallel``)
gathers the window before the step and keeps its columns after.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed.collectives import (all_reduce, copy_to_group,
                                       reduce_from_group)
from .config import ArchConfig


def make_ssm_params(mk, cfg: ArchConfig, extra_axes: tuple = ()) -> dict:
    D = cfg.d_model
    di = cfg.d_inner
    H = cfg.ssm_heads
    N = cfg.ssm_state
    G = cfg.ssm_ngroups
    cw = cfg.conv_width
    ea = tuple(extra_axes)
    pre = ("layers",) * len(ea)
    return {
        "in_z": mk(ea + (D, di), pre + ("embed", "ssm_inner")),
        "in_x": mk(ea + (D, di), pre + ("embed", "ssm_inner")),
        "in_B": mk(ea + (D, G, N), pre + ("embed", "ssm_group", "ssm_state")),
        "in_C": mk(ea + (D, G, N), pre + ("embed", "ssm_group", "ssm_state")),
        "in_dt": mk(ea + (D, H), pre + ("embed", "ssm_heads")),
        "dt_bias": mk(ea + (H,), pre + ("ssm_heads",), init="zeros"),
        "A_log": mk(ea + (H,), pre + ("ssm_heads",), init="zeros"),
        "Dskip": mk(ea + (H,), pre + ("ssm_heads",), init="ones"),
        "conv_x": mk(ea + (cw, di), pre + ("conv", "ssm_inner"), init="zeros"),
        "out": mk(ea + (di, D), pre + ("ssm_inner", "embed")),
        "norm": mk(ea + (di,), pre + ("ssm_inner",), init="ones"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x (B, S, F), w (cw, F)."""
    cw = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + S, :] * w[i]
    return out


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, h0=None):
    """xh (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N) →
    (y (B,S,H,P) f32, h_final (B,H,P,N) f32).  Chunks of ``chunk``
    positions, the last one shorter when ``chunk`` does not divide S."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[-2:]
    rep = H // G
    f32 = torch.float32
    xh, dt, Bm, Cm = (t.to(f32) for t in (xh, dt, Bm, Cm))
    A = A.to(f32)
    h = xh.new_zeros((B, H, P, N)) if h0 is None else h0.to(f32)
    ys = []
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        Q = c1 - c0
        xq, dtq = xh[:, c0:c1], dt[:, c0:c1]
        Bh = Bm[:, c0:c1].repeat_interleave(rep, dim=2)        # (B,Q,H,N)
        Ch = Cm[:, c0:c1].repeat_interleave(rep, dim=2)
        dA = dtq * A[None, None, :]                            # ≤ 0
        cum = torch.cumsum(dA, dim=1)                          # (B,Q,H)
        iu = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))
        # masked before the exp: above the diagonal cum_i - cum_j > 0 can
        # overflow to inf, and where's gradient 0 times inf is NaN (the
        # reference's, which masks after, is NaN there; ROADMAP Queue C)
        Ldec = torch.exp(torch.where(iu[None, :, :, None],
                                     cum[:, :, None, :] - cum[:, None, :, :],
                                     float("-inf")))
        CB = torch.einsum("bihn,bjhn->bijh", Ch, Bh)
        y_intra = torch.einsum("bijh,bjh,bjhp->bihp", CB * Ldec, dtq, xq)
        y_inter = torch.einsum("bihn,bhpn->bihp",
                               Ch * torch.exp(cum)[..., None], h)
        st = torch.einsum("bjh,bjh,bjhn,bjhp->bhpn",
                          torch.exp(cum[:, -1:, :] - cum), dtq, Bh, xq)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + st
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def _gated_norm_out(p: dict, y: torch.Tensor, z: torch.Tensor,
                    dtype: torch.dtype, group=None,
                    d_inner: int = 0) -> torch.Tensor:
    """y (..., H*P) f32 → gate by silu(z), grouped RMSNorm (Mamba2 norms
    before the out-projection), out-projection, all as the reference.
    With a ``group`` y holds this rank's ``d_inner`` columns: the sum of
    squares is all-reduced over it (forward and backward: every rank
    normalises its columns by the total) before the mean."""
    y = y.to(dtype) * F.silu(z)
    if group is None:
        var = (y.float() * y.float()).mean(dim=-1, keepdim=True)
    else:
        ss = (y.float() * y.float()).sum(dim=-1, keepdim=True)
        var = copy_to_group(reduce_from_group(ss, group), group) / d_inner
    y = (y.float() * torch.rsqrt(var + 1e-5)).to(dtype) * p["norm"]
    return y @ p["out"]


def ssm_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                chunk: int = 128, state_dtype: Optional[torch.dtype] = None):
    """Full-sequence Mamba2 block.  x (B, S, D) → (B, S, D).

    With ``state_dtype`` it also returns what S decode steps leave in the
    decode state: (out, h_final (B,H,P,N) f32, conv (B, cw-1, di)), the
    last cw-1 rows of the pre-conv ``in_x`` projection, left-padded with
    zeros when S < cw-1, in ``state_dtype``."""
    B, S, D = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    z = torch.einsum("bsd,de->bse", x, p["in_z"])
    xs_in = torch.einsum("bsd,de->bse", x, p["in_x"])
    Bm = torch.einsum("bsd,dgn->bsgn", x, p["in_B"])
    Cm = torch.einsum("bsd,dgn->bsgn", x, p["in_C"])
    dt = F.softplus(torch.einsum("bsd,dh->bsh", x, p["in_dt"])
                    + p["dt_bias"])
    xs = F.silu(_causal_conv(xs_in, p["conv_x"]))
    A = -torch.exp(p["A_log"].float())

    y, h_final = ssd_chunked(xs.reshape(B, S, H, P), dt, A, Bm, Cm, chunk)
    y = y + xs.reshape(B, S, H, P).float() * p["Dskip"][None, None, :, None]
    out = _gated_norm_out(p, y.reshape(B, S, H * P), z, x.dtype)
    if state_dtype is None:
        return out
    conv = _conv_window(xs_in, cfg.conv_width - 1)
    return out, h_final, conv.to(state_dtype)


def _conv_window(xs_in: torch.Tensor, keep: int) -> torch.Tensor:
    """The last ``keep`` rows of the pre-conv projection (B, S, F), left-
    padded with zeros when S < keep: the decode state's ``conv``."""
    if not keep:
        return xs_in[:, :0]
    return F.pad(xs_in, (0, 0, max(keep - xs_in.shape[1], 0), 0))[:, -keep:]


def _keep_cols(t: torch.Tensor, width: int, r: int) -> torch.Tensor:
    """``t``, or its ``r``-th slice of ``width`` along the last dim."""
    return t if width == t.shape[-1] else t[..., r * width:(r + 1) * width]


def ssm_parallel(p: dict, x: torch.Tensor, cfg: ArchConfig, par, md: dict,
                 chunk: int = 128, state=None) -> torch.Tensor:
    """This rank's sequence chunk x (b, S/m, D) → its chunk of the block's
    output.  Heads split over "model" when it divides them; otherwise
    every rank runs the whole block (weights gathered) on the gathered
    sequence and keeps its chunk.  ``state``: this rank's (ssm_h, conv)
    shards of a decode state, into which it writes what S decode steps
    leave (``ssm_forward``'s ``state_dtype``)."""
    H, P, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_ngroups
    split = H % par.m == 0
    cols = {"in_z": 1, "in_x": 1, "in_dt": 1, "conv_x": 1, "out": 0,
            "norm": 0, "dt_bias": 0, "A_log": 0, "Dskip": 0}
    w = {n: par.want(v, md[n], cols.get(n) if split else None)
         for n, v in p.items()}
    xf = par.gather_seq(x)
    if not split:
        if state is None:
            return par.chunk(ssm_forward(w, xf, cfg, chunk=chunk), 1)
        out, h_final, conv = ssm_forward(w, xf, cfg, chunk=chunk,
                                         state_dtype=state[1].dtype)
        state[0].copy_(h_final)
        state[1].copy_(_keep_cols(conv, state[1].shape[-1], par.r))
        return par.chunk(out, 1)
    B, S, _ = xf.shape
    Hl = H // par.m
    h0 = par.r * Hl
    z = torch.einsum("bsd,de->bse", xf, w["in_z"])
    xs_in = torch.einsum("bsd,de->bse", xf, w["in_x"])
    xs = F.silu(_causal_conv(xs_in, w["conv_x"]))
    dt = F.softplus(torch.einsum("bsd,dh->bsh", xf, w["in_dt"])
                    + w["dt_bias"])
    BC = []
    for n in ("in_B", "in_C"):
        t = torch.einsum("bsd,dgn->bsgn", xf, w[n])
        gpp = H // G                       # heads a group
        lo, hi = h0 // gpp, (h0 + Hl - 1) // gpp + 1
        if not ((hi - lo) * gpp == Hl or hi - lo == 1):
            t, lo = t.repeat_interleave(gpp, dim=2), h0
            hi = h0 + Hl
        BC.append(t[:, :, lo:hi])
    A = -torch.exp(w["A_log"].float())
    y, h_final = ssd_chunked(xs.reshape(B, S, Hl, P), dt, A, *BC, chunk)
    y = y + xs.reshape(B, S, Hl, P).float() * w["Dskip"][None, None, :, None]
    out = _gated_norm_out(w, y.reshape(B, S, Hl * P), z, x.dtype,
                          par.model, cfg.d_inner)
    if state is not None:
        state[0].copy_(h_final)
        state[1].copy_(_conv_window(xs_in, cfg.conv_width - 1))
    return par.scatter_seq(out)


# --------------------------------------------------------------------- decode
def init_ssm_state(cfg: ArchConfig, batch: int, n_ssm_layers: int,
                   dtype=torch.float32, device="cpu") -> dict:
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    return {
        "h": torch.zeros((n_ssm_layers, batch, H, P, N), dtype=dtype,
                         device=device),
        "conv": torch.zeros((n_ssm_layers, batch, cfg.conv_width - 1,
                             cfg.d_inner), dtype=dtype, device=device),
    }


def ssm_decode_step(p: dict, x: torch.Tensor, cfg: ArchConfig,
                    h: torch.Tensor, conv_buf: torch.Tensor, h0: int = 0,
                    group=None):
    """One-token recurrent step.  x (B, 1, D); h (B,H,P,N);
    conv_buf (B, cw-1, di).  Returns (out (B,1,D), h', conv_buf'), new
    tensors.  The conv window is taken in the wider of the buffer's and
    x's dtypes, as the reference's concatenation promotes it, and so is
    the returned buffer.

    On a mesh (``ssm_decode_parallel``) ``p`` holds a rank's heads h0..:
    their d_inner columns and per-head constants (the head count is
    ``in_dt``'s), with in_B/in_C whole; the gated norm's sum of squares is
    summed over ``group`` and ``out`` is the rank's partial sum."""
    B = x.shape[0]
    H, P = p["in_dt"].shape[-1], cfg.ssm_headdim
    xt = x[:, 0]                                              # (B, D)
    z = xt @ p["in_z"]
    xs = xt @ p["in_x"]
    Bm = torch.einsum("bd,dgn->bgn", xt, p["in_B"])
    Cm = torch.einsum("bd,dgn->bgn", xt, p["in_C"])
    dt = F.softplus(xt @ p["in_dt"] + p["dt_bias"])           # (B, H)

    # causal conv over the ring buffer
    wdt = torch.promote_types(conv_buf.dtype, xs.dtype)
    win = torch.cat([conv_buf.to(wdt), xs[:, None, :].to(wdt)], dim=1)
    cdt = torch.promote_types(wdt, p["conv_x"].dtype)
    xs = F.silu(torch.einsum("bcf,cf->bf", win.to(cdt),
                             p["conv_x"].to(cdt)))
    conv_buf = win[:, 1:]

    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A[None, :])                           # (B, H) f32
    rep = cfg.ssm_heads // cfg.ssm_ngroups
    heads = slice(h0, h0 + H)
    Bh = Bm.repeat_interleave(rep, dim=1)[:, heads].float()   # (B, H, N)
    Chh = Cm.repeat_interleave(rep, dim=1)[:, heads].float()
    xh = xs.reshape(B, H, P).float()
    dtf = dt.float()
    h = h.float() * dA[:, :, None, None] \
        + torch.einsum("bh,bhn,bhp->bhpn", dtf, Bh, xh)
    y = torch.einsum("bhn,bhpn->bhp", Chh, h) \
        + xh * p["Dskip"][None, :, None]
    out = _gated_norm_out(p, y.reshape(B, H * P), z, x.dtype, group,
                          cfg.d_inner)
    return out[:, None, :], h, conv_buf


def ssm_decode_parallel(p: dict, x: torch.Tensor, cfg: ArchConfig,
                        h: torch.Tensor, conv_buf: torch.Tensor, par,
                        md: dict):
    """``ssm_decode_step`` on a mesh: x (B, 1, D) whole on every "model"
    rank, ``h`` and ``conv_buf`` this rank's state shards → (out (B, 1, D)
    whole, h', conv_buf' as shards).  The rank's heads when they divide
    "model" (the partial outputs all-reduced); otherwise the whole block on
    every rank, over the window gathered from the ranks' d_inner columns
    where ``conv`` splits them, its columns of the new window kept."""
    H = cfg.ssm_heads
    if H % par.m == 0:
        cols = {"in_z": 1, "in_x": 1, "in_dt": 1, "conv_x": 1, "out": 0,
                "norm": 0, "dt_bias": 0, "A_log": 0, "Dskip": 0}
        w = {n: par.want(v, md[n], cols.get(n)) for n, v in p.items()}
        out, h, conv_buf = ssm_decode_step(w, x, cfg, h, conv_buf,
                                           par.r * (H // par.m), par.model)
        return all_reduce(out, par.model), h, conv_buf
    w = {n: par.want(v, md[n]) for n, v in p.items()}
    width = conv_buf.shape[-1]
    if width < cfg.d_inner:
        conv_buf = par.want(conv_buf, 2)
    out, h, conv_buf = ssm_decode_step(w, x, cfg, h, conv_buf)
    return out, h, _keep_cols(conv_buf, width, par.r)
