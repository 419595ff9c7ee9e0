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

``moe_parallel`` is the form on a mesh, in training and serving.  The
router's probabilities are gathered over the "model" axis (the router
splits on experts) and over the batch axes, so groups, capacity and the
aux loss are the one-device ones over the global batch; each rank then
runs its experts on its own rows, and a reduce-scatter sums the experts'
outputs into its sequence chunk.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.collectives import all_gather, scale_grad
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


def _groups(n_tok: int, group_size: int) -> tuple[int, int]:
    """(groups, tokens a group) of GShard's grouping of n_tok tokens."""
    g = max(1, n_tok // group_size) if n_tok >= group_size else 1
    return g, n_tok // g


def _capacity(cfg: ArchConfig, sg: int, lossless: bool = False) -> int:
    if lossless or sg <= LOSSLESS_GROUP:
        return sg
    return max(1, int(cfg.top_k * sg / cfg.n_experts * cfg.capacity_factor))


def _aux(probs: torch.Tensor, gate_idx: torch.Tensor, E: int):
    """Load-balance aux loss: E * Σ_e f_e · p_e, the mean over groups."""
    f = F.one_hot(gate_idx, E).float().mean(dim=(1, 2))  # (g, E)
    pm = probs.mean(dim=1)                                # (g, E)
    return (E * (f * pm).sum(-1)).mean()


def moe_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                group_size: int = 1024, lossless: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (out (B, S, D), aux_loss ()).  Top-k routing with
    capacity (none with ``lossless``); aux = load-balancing loss."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n_tok = B * S
    tokens = x.reshape(n_tok, D)
    g, sg = (1, n_tok) if lossless else _groups(n_tok, group_size)
    xt = tokens[: g * sg].reshape(g, sg, D)

    logits = torch.einsum("gsd,de->gse", xt, p["router"])
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx, keep = route(probs, k, _capacity(cfg, sg, lossless))

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
    return out, _aux(probs, gate_idx, E)


def moe_parallel(p: dict, x: torch.Tensor, cfg: ArchConfig, par, md: dict,
                 group_size: int = 1024, lossless: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's sequence chunk x (b, S/m, D) → (its chunk of the
    output, the aux loss).  The experts split over "model" when their
    count divides it; otherwise every rank runs them all on its rows (the
    weights gathered) and keeps its chunk.  Routing runs on the gathered
    global probabilities: every rank computes the same groups, capacity
    (none with ``lossless``, ``moe_forward``'s) and aux loss, whose
    gradient the gathers then sum m times over "model", so it is scaled by
    1/m (the batch axes' sum is the replicas' mean the trainer divides
    by)."""
    E, k = cfg.n_experts, cfg.top_k
    ep = E % par.m == 0
    xf = par.gather_seq(x)
    B, S, D = xf.shape
    n_loc = B * S
    flat_x = xf.reshape(n_loc, D)
    router = par.want(p["router"], md["router"], 1 if ep else None)
    logits = flat_x @ router
    if ep:
        logits = all_gather(logits, 1, par.model)
    probs = all_gather(torch.softmax(logits.float(), dim=-1), 0, par.batch)
    n_tok = probs.shape[0]
    g, sg = (1, n_tok) if lossless else _groups(n_tok, group_size)
    probs = probs[: g * sg].reshape(g, sg, E)
    gate_vals, gate_idx, keep = route(probs, k,
                                      _capacity(cfg, sg, lossless))
    t0 = par.batch_rank * n_loc
    own = slice(min(t0, g * sg), min(t0 + n_loc, g * sg))
    flat_idx = gate_idx.reshape(g * sg, k)[own]
    flat_keep = keep.reshape(g * sg, k)[own]
    flat_w = (gate_vals * keep).reshape(g * sg, k)[own]
    w = {n: par.want(v, md[n], 0 if ep else None) for n, v in p.items()
         if n != "router"}
    e0 = par.r * (E // par.m) if ep else 0
    out = torch.zeros((n_loc, D), dtype=torch.float32, device=x.device)
    # every expert runs, kept tokens or none: the backward's collectives
    # fire in autograd's order, which must be one order on every rank
    for e in range(w["w_up"].shape[0]):
        tok, choice = torch.nonzero((flat_idx == e0 + e) & flat_keep,
                                    as_tuple=True)
        y = expert_mlp(w, e, flat_x[tok], cfg.mlp)
        out.index_add_(0, tok, y * flat_w[tok, choice][:, None])
    out = out.reshape(B, S, D).to(x.dtype)
    out = par.scatter_seq(out) if ep else par.chunk(out, 1)
    return out, scale_grad(_aux(probs, gate_idx, E), 1.0 / par.m)
