"""Top-k Mixture-of-Experts in plain torch — the port's counterpart of
``repro.models.moe``.

Routing follows the reference's GShard semantics: tokens are taken in
groups of about ``group_size`` (a ragged tail past ``g * sg`` tokens gets a
zero output), the router's softmax is f32, the top-k gates are
renormalised, and each expert takes at most ``cap`` (token, choice) pairs
of a group in queue order: ``cap = int(k * sg / E * capacity_factor)`` for
a group of ``sg`` > 256 tokens, the whole group otherwise.  A dropped pair
gets combine weight 0.

The reference computes the dispatch as dense one-hot einsums over
(group, token, expert, slot).  Here each expert gathers the pairs it kept,
runs its MLP on them and scatters the gated outputs back: the same sums
(one-hot products select exactly), without the (sg, E, cap) tensors.  As
in the reference, whose f32 one-hot dispatch promotes the tokens, the
experts compute in f32 and the output is cast back to x's dtype.

``lossless=True`` routes every token of the batch as one group with room
for all: what the reference's sequential prefill computes, where each
decode step routes only B tokens (``LMServer``'s one-pass prefill).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ArchConfig

# groups up to this many tokens get a capacity of the whole group
# (decode steps route a handful of tokens and must not drop any)
LOSSLESS_GROUP = 256


def make_moe_params(mk, cfg: ArchConfig, extra_axes: tuple = ()) -> dict:
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    ea = tuple(extra_axes)
    pre = ("layers",) * len(ea)
    p = {"router": mk(ea + (D, E), pre + ("embed", "experts"))}
    if cfg.mlp == "swiglu":
        p["w_gate"] = mk(ea + (E, D, Fd), pre + ("experts", "embed", "ff"))
        p["w_up"] = mk(ea + (E, D, Fd), pre + ("experts", "embed", "ff"))
        p["w_down"] = mk(ea + (E, Fd, D), pre + ("experts", "ff", "embed"))
    else:
        p["w_up"] = mk(ea + (E, D, Fd), pre + ("experts", "embed", "ff"))
        p["w_down"] = mk(ea + (E, Fd, D), pre + ("experts", "ff", "embed"))
    return p


def route(probs: torch.Tensor, k: int, cap: int):
    """probs (g, sg, E) f32 → (gate_vals (g, sg, k) renormalised, gate_idx
    (g, sg, k), keep (g, sg, k) bool): each expert keeps the first ``cap``
    (token, choice) pairs of its queue, token-major then choice order."""
    E = probs.shape[-1]
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    g, sg = probs.shape[:2]
    onehot = F.one_hot(gate_idx, E).reshape(g, sg * k, E)
    pos = (torch.cumsum(onehot, dim=1) - onehot)           # queue position
    pos = (pos * onehot).sum(-1).reshape(g, sg, k)
    return gate_vals, gate_idx, pos < cap


def expert_mlp(p: dict, e: int, x: torch.Tensor, mlp: str) -> torch.Tensor:
    """Expert ``e``'s MLP on x (n, D) in f32."""
    x = x.float()
    if mlp == "swiglu":
        h = F.silu(x @ p["w_gate"][e].float()) * (x @ p["w_up"][e].float())
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_up"][e].float(), approximate="tanh")
    return h @ p["w_down"][e].float()


def moe_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                group_size: int = 1024, lossless: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (out (B, S, D), aux_loss ()).  Top-k routing with
    capacity (none with ``lossless``); aux = load-balancing loss."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n_tok = B * S
    tokens = x.reshape(n_tok, D)
    if lossless:
        g, sg = 1, n_tok
    else:
        g = max(1, n_tok // group_size) if n_tok >= group_size else 1
        sg = n_tok // g
    xt = tokens[: g * sg].reshape(g, sg, D)

    logits = torch.einsum("gsd,de->gse", xt, p["router"])
    probs = torch.softmax(logits.float(), dim=-1)
    if lossless or sg <= LOSSLESS_GROUP:
        cap = sg
    else:
        cap = max(1, int(k * sg / E * cfg.capacity_factor))
    gate_vals, gate_idx, keep = route(probs, k, cap)

    flat_x = xt.reshape(g * sg, D)
    flat_idx = gate_idx.reshape(g * sg, k)
    flat_w = (gate_vals * keep).reshape(g * sg, k)
    flat_keep = keep.reshape(g * sg, k)
    out = torch.zeros((g * sg, D), dtype=torch.float32, device=x.device)
    for e in range(E):
        tok, choice = torch.nonzero((flat_idx == e) & flat_keep,
                                    as_tuple=True)
        if tok.numel() == 0:
            continue
        y = expert_mlp(p, e, flat_x[tok], cfg.mlp)
        out.index_add_(0, tok, y * flat_w[tok, choice][:, None])
    if g * sg < n_tok:                                    # ragged tail
        out = torch.cat([out, out.new_zeros((n_tok - g * sg, D))], dim=0)
    out = out.reshape(B, S, D).to(x.dtype)

    # load-balance aux loss: E * Σ_e f_e · p_e
    f = F.one_hot(gate_idx, E).float().mean(dim=(1, 2))  # (g, E)
    pm = probs.mean(dim=1)                                # (g, E)
    aux = (E * (f * pm).sum(-1)).mean()
    return out, aux
