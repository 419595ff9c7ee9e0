"""Model assembly — ``repro.models.model`` for all five families.

A model is a stack of *units*; a unit is the smallest repeating layer
group, one position per layer (``unit_layout``):

  dense/moe : 1 layer  (attention mixer + mlp|moe ffn)
  ssm       : 1 mamba block (no separate ffn, Mamba2 style)
  hybrid    : ``attn_period`` layers (jamba: mamba and attention mixers,
              alternating mlp and moe ffns)
  encdec    : decoder unit (self-attention + cross-attention + mlp); the
              encoder is a separate stack of (attention + mlp) units over
              precomputed frame embeddings (the speech frontend is a stub)

Params are nested dicts of tensors with the reference's tree: every block
leaf carries a leading ``n_units`` axis, so a reference param tree (as
numpy) carries across name for name (``models/convert.py``).  ``lax.scan``
over the units becomes a Python loop.

``Model(cfg, ..., backend="cuda", device=None)`` follows
``compile_forest``'s convention: ``device=None`` is the card and raises
without CUDA; on ``device="cpu"`` the ``cuda`` backend runs the kernel's
plain version.  ``backend="torch"`` is the reference's XLA engine (the
chunked flash in torch), ``backend="cuda"`` the hand-written flash kernel.
The SSD scan, the MoE dispatch and the decode steps' attention (bf16 or
int8 cache, cross-attention) are XLA code in the reference, outside any
Pallas kernel, and plain torch here on both backends.

``loss_fn`` is the training loss (next-token cross entropy in sequence
chunks plus the MoE load-balancing term), trained on ``backend="torch"``:
the kernel that ``backend="cuda"`` runs has no backward pass (nor has the
reference's Pallas kernel) and raises under autograd
(``kernels.flash_attention_kernel.flash_forward``).

``param_logical_specs`` is the reference's tree of logical axes, which
``distributed/sharding.py`` resolves onto a mesh; ``param_shapes`` the
same tree as meta tensors.

On a mesh the trainer sets ``parallel`` (``distributed.collectives.
Parallel``) and ``loss_fn`` runs on this rank's shards: each unit gathers
its params' "embed" shards over the data axes inside the (checkpointed)
unit function, so remat gathers them again in the backward pass; the
residual stream is this rank's sequence chunk (b, S/m, D), as the
reference's ``constrain(x, {0: "batch", 1: "model"})`` lays it out, and
each sub-block normalises its chunk, runs its tensor-parallel body
(``attention.attn_parallel``, ``mamba.ssm_parallel``,
``moe.moe_parallel``, ``layers.mlp_forward``) and returns its chunk of the
output.  The embedding and the loss are vocab-parallel.  A sequence that
does not split over "model" stays whole on every rank, as the
reference's ``constrain`` then leaves it (``Parallel.split``; the
encoder's stack by its own length, ``Parallel.encoder()``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.registry import resolve_device
from ..distributed.collectives import (all_reduce_max, reduce_from_group,
                                       scale_grad)
from ..distributed.sharding import P
from . import attention as attn
from . import mamba, moe
from .config import ArchConfig
from .layers import (MetaMaker, RealMaker, SpecMaker, make_embed_params,
                     make_mlp_params, mlp_forward, rmsnorm)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


@dataclass
class UnitPos:
    mixer: str              # "attn" | "ssm"
    ffn: Optional[str]      # "mlp" | "moe" | None
    cross: bool = False


def unit_layout(cfg: ArchConfig) -> list[UnitPos]:
    """Per-position descriptors of one unit (the reference's rules for
    every family, so the tree's shape is known for all ten configs)."""
    if cfg.family == "ssm":
        return [UnitPos("ssm", None)]
    if cfg.family == "hybrid":
        out = []
        for i in range(cfg.attn_period):
            mixer = "attn" if cfg.is_attn_layer(i) else "ssm"
            ffn = "moe" if cfg.is_moe_layer(i) else "mlp"
            out.append(UnitPos(mixer, ffn))
        return out
    ffn0 = "moe" if (cfg.n_experts and cfg.moe_period == 1) else None
    if cfg.family == "moe" and ffn0 is None:
        return [UnitPos("attn", "moe" if cfg.is_moe_layer(i) else "mlp")
                for i in range(cfg.moe_period)]
    return [UnitPos("attn", ffn0 or "mlp", cross=(cfg.family == "encdec"))]


ENC_LAYOUT = [UnitPos("attn", "mlp")]          # one encoder layer


def n_units(cfg: ArchConfig) -> int:
    lay = unit_layout(cfg)
    assert cfg.n_layers % len(lay) == 0, (cfg.name, cfg.n_layers, len(lay))
    return cfg.n_layers // len(lay)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} not in "
                         f"{FAMILIES}")


# --------------------------------------------------------------------------- #
# Parameter construction (shared by every maker of layers.py)
# --------------------------------------------------------------------------- #
def _make_unit_params(mk, cfg: ArchConfig, layout: list[UnitPos],
                      U: int) -> dict:
    blocks: dict[str, Any] = {}
    ea = (U,)
    for i, pos in enumerate(layout):
        p: dict[str, Any] = {
            "ln1": mk(ea + (cfg.d_model,), ("layers", "embed"), init="ones"),
        }
        if pos.mixer == "attn":
            p["attn"] = attn.make_attn_params(mk, cfg, extra_axes=ea)
        else:
            p["ssm"] = mamba.make_ssm_params(mk, cfg, extra_axes=ea)
        if pos.ffn:
            p["ln2"] = mk(ea + (cfg.d_model,), ("layers", "embed"),
                          init="ones")
        if pos.ffn == "mlp":
            p["mlp"] = make_mlp_params(mk, cfg.d_model, cfg.d_ff, cfg.mlp,
                                       extra_axes=ea)
        elif pos.ffn == "moe":
            p["moe"] = moe.make_moe_params(mk, cfg, extra_axes=ea)
        if pos.cross:
            p["ln_cross"] = mk(ea + (cfg.d_model,), ("layers", "embed"),
                               init="ones")
            p["cross"] = attn.make_attn_params(mk, cfg, cross=True,
                                               extra_axes=ea)
        blocks[f"pos{i}"] = p
    return blocks


def make_params(cfg: ArchConfig, mk) -> dict:
    _check_family(cfg)
    params = {
        "embed": make_embed_params(mk, cfg.vocab, cfg.d_model),
        "blocks": _make_unit_params(mk, cfg, unit_layout(cfg), n_units(cfg)),
    }
    if cfg.family == "encdec":
        params["enc_blocks"] = _make_unit_params(mk, cfg, ENC_LAYOUT,
                                                 cfg.enc_layers)
        params["enc_norm"] = mk((cfg.d_model,), ("embed",), init="ones")
    return params


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_flatten(tree, is_leaf=None) -> tuple[list, Any]:
    """(leaves, treedef) in ``jax.tree.flatten``'s order: a dict's keys
    sorted, depth first, so an int8 moment ``{"q", "scale"}`` gives q, then
    scale.  The treedef is the tree with ``None`` for every leaf; a dict
    for which ``is_leaf`` holds is one leaf."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        leaves, treedef = [], {}
        for k in sorted(tree):
            sub, treedef[k] = tree_flatten(tree[k], is_leaf)
            leaves += sub
        return leaves, treedef
    return [tree], None


def tree_unflatten(treedef, leaves):
    """The inverse of ``tree_flatten``: ``leaves`` in its order."""
    it = iter(leaves)

    def build(d):
        if isinstance(d, dict):
            return {k: build(d[k]) for k in sorted(d)}
        return next(it)
    out = build(treedef)
    if next(it, it) is not it:
        raise ValueError("more leaves than the treedef holds")
    return out


# --------------------------------------------------------------------------- #
# Model
# --------------------------------------------------------------------------- #
class Model:
    def __init__(self, cfg: ArchConfig, compute_dtype=torch.bfloat16,
                 q_chunk: int = 1024, ssd_chunk: int = 128,
                 loss_chunk: int = 1024, remat: bool = True, *,
                 backend: str = "cuda", device=None):
        _check_family(cfg)
        if backend not in attn.BACKENDS:
            raise ValueError(f"backend {backend!r} not in {attn.BACKENDS}")
        self.cfg = cfg
        self.layout = unit_layout(cfg)
        self.n_units = n_units(cfg)
        self.compute_dtype = compute_dtype
        self.q_chunk = q_chunk
        self.ssd_chunk = ssd_chunk
        self.loss_chunk = loss_chunk
        self.remat = remat
        self.backend = backend
        self.device = resolve_device(device)
        self.parallel = None

    # ------------------------------------------------------------- params
    def init_params(self, seed: int = 0, dtype=torch.float32) -> dict:
        return make_params(self.cfg, RealMaker(seed, dtype, self.device))

    def param_logical_specs(self) -> dict:
        """The params' tree with each leaf's logical-axis tuple."""
        return make_params(self.cfg, SpecMaker())

    def param_shapes(self, dtype=torch.float32) -> dict:
        """The params' tree as meta tensors: no memory, no draws."""
        return make_params(self.cfg, MetaMaker(dtype))

    def cast(self, params: dict) -> dict:
        """f32 master params → the compute dtype.  The reference casts at
        the entry of every call (``_cast``); here a caller casts once, at
        load (``LMServer`` does at construction), and the entry points
        pass params already in the compute dtype through untouched (the
        cast of such a leaf returns the leaf itself, no copy)."""
        dt = self.compute_dtype
        return tree_map(
            lambda a: a.to(dt) if a.dtype == torch.float32 else a, params)

    # ------------------------------------------------------------ forward
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings; on a mesh this rank's sequence chunk of them:
        with the vocab split over "model", a lookup of the rank's vocab
        rows (zero elsewhere) reduce-scattered along the sequence."""
        par = self.parallel
        if par is None:
            return params["embed"]["embedding"][tokens] \
                .to(self.compute_dtype)
        emb = self._leaf(params, "embed", "embedding")
        if self._model_dim("embed", "embedding") != 0:
            return emb[par.chunk(tokens, 1)]
        local = tokens - par.r * emb.shape[0]
        inside = (local >= 0) & (local < emb.shape[0])
        x = emb[local.clamp(0, emb.shape[0] - 1)] * inside[..., None]
        return par.scatter_seq(x.to(emb.dtype))

    def _spec(self, *path):
        s = self.parallel.specs
        for k in path:
            s = s[k]
        return s

    def _model_dim(self, *path):
        return self.parallel.model_dim(self._spec(*path))

    def _leaf(self, params: dict, *path) -> torch.Tensor:
        """A top-level param as this rank computes with it: gathered over
        the data axes and cast (``Parallel.take``) on a mesh."""
        t = params
        for k in path:
            t = t[k]
        if self.parallel is None:
            return t
        return self.parallel.take(t, self._spec(*path))

    @staticmethod
    def _unit(params: dict, u: int, stack: str = "blocks") -> dict:
        """Unit ``u``'s params: ``pos0``..``pos{k-1}``, one per layer."""
        return tree_map(lambda a: a[u], params[stack])

    def _apply_unit(self, up: dict, x: torch.Tensor,
                    positions: torch.Tensor, u: int,
                    state: Optional[dict], *, layout=None,
                    causal: bool = True,
                    memory: Optional[torch.Tensor] = None, md=None,
                    par=None) -> tuple[torch.Tensor, torch.Tensor]:
        """One unit over the whole sequence → (x, the summed MoE
        load-balancing loss of its layers).  With a decode ``state`` each
        attention layer writes its K and V into the cache (int8 with
        scales if the state holds ``k_scale``), each mamba layer its final
        SSD state and conv window, and every MoE layer routes all tokens
        without capacity: what S decode steps, each routing B tokens,
        leave and compute.  A cross sub-block attends over the state's
        ``cross_k``/``cross_v`` in the compute dtype, as the decode steps
        read them, or else over ``memory``, the encoder's output.  On a mesh
        (``par``, the stack's ``Parallel``) x is this rank's sequence chunk
        (the whole sequence where ``par`` does not split it) and ``md`` the
        tree of each weight's "model" dim; ``memory`` is then whole."""
        cfg = self.cfg
        tp = par if par is not None and par.m > 1 else None
        ai = si = 0
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, pos in enumerate(layout or self.layout):
            p = up[f"pos{i}"]
            mp = md[f"pos{i}"] if md is not None else {}
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            if tp is not None and pos.mixer == "attn":
                h = attn.attn_parallel(p["attn"], h, cfg, positions, tp,
                                       mp["attn"], causal=causal,
                                       q_chunk=self.q_chunk)
            elif tp is not None:
                h = mamba.ssm_parallel(p["ssm"], h, cfg, tp, mp["ssm"],
                                       chunk=self.ssd_chunk)
            elif pos.mixer == "attn":
                kv = scales = None
                if state is not None:
                    kv = (state["k"][u, ai], state["v"][u, ai])
                    if "k_scale" in state:
                        scales = (state["k_scale"][u, ai],
                                  state["v_scale"][u, ai])
                h = attn.attn_forward(p["attn"], h, cfg, positions,
                                      causal=causal, q_chunk=self.q_chunk,
                                      backend=self.backend, kv_cache=kv,
                                      kv_scales=scales)
                ai += 1
            elif state is None:
                h = mamba.ssm_forward(p["ssm"], h, cfg, chunk=self.ssd_chunk)
            else:
                h, state["ssm_h"][u, si], state["conv"][u, si] = \
                    mamba.ssm_forward(p["ssm"], h, cfg, chunk=self.ssd_chunk,
                                      state_dtype=state["conv"].dtype)
                si += 1
            x = x + h
            if pos.cross and tp is not None:
                h = rmsnorm(x, p["ln_cross"], cfg.norm_eps)
                x = x + attn.attn_parallel(p["cross"], h, cfg, positions,
                                           tp, mp["cross"], memory=memory,
                                           q_chunk=self.q_chunk)
            elif pos.cross:
                h = rmsnorm(x, p["ln_cross"], cfg.norm_eps)
                if memory is None:
                    mem_kv = state["cross_k"][u], state["cross_v"][u]
                else:
                    mem_kv = attn.cross_memory_kv(p["cross"], memory, h.dtype)
                x = x + attn.cross_attn_forward(p["cross"], h, cfg, *mem_kv,
                                                q_chunk=self.q_chunk,
                                                backend=self.backend)
            if pos.ffn:
                h = rmsnorm(x, p["ln2"], cfg.norm_eps)
                if pos.ffn == "moe" and par is not None:
                    h, a = moe.moe_parallel(p["moe"], h, cfg, par, mp["moe"])
                    aux = aux + a
                elif pos.ffn == "moe":
                    h, a = moe.moe_forward(p["moe"], h, cfg,
                                           lossless=state is not None)
                    aux = aux + a
                else:
                    h = mlp_forward(p["mlp"], h, cfg.mlp, tp, mp.get("mlp"))
                x = x + h
        return x, aux

    def _stack(self, params: dict, x: torch.Tensor, positions, *,
               stack: str = "blocks", layout=None, causal: bool = True,
               state: Optional[dict] = None, memory=None,
               remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """Every unit of ``stack`` over x → (x, the summed aux loss).  With
        ``remat`` each unit is recomputed in the backward pass and only its
        input kept (``jax.checkpoint`` around the reference's scanned
        unit)."""
        n = self.n_units if stack == "blocks" else self.cfg.enc_layers
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        par = self.parallel
        specs = md = None
        if par is not None:
            if stack == "enc_blocks":
                par = par.encoder()
            specs = tree_map(lambda s: P(*s[1:]), par.specs[stack])
            md = tree_map(par.model_dim, specs)
        for u in range(n):
            def unit(x, up, u=u):
                if par is not None:
                    up = par.take_tree(up, specs)
                return self._apply_unit(up, x, positions, u, state,
                                        layout=layout, causal=causal,
                                        memory=memory, md=md, par=par)
            up = self._unit(params, u, stack)
            x, a = (checkpoint(unit, x, up, use_reentrant=False) if remat
                    else unit(x, up))
            aux = aux + a
        return x, aux

    def _memory(self, params: dict, state: Optional[dict], enc_embeds,
                remat: bool = False):
        """The encoder output the trunk's cross sub-blocks attend over, or
        None where they read the decode state's cross K/V (or the family
        has none)."""
        if self.cfg.family != "encdec":
            return None
        if state is not None:
            if enc_embeds is not None:
                raise ValueError("the decode state already holds the "
                                 "encoder's cross K/V (init_decode_state("
                                 "params=, enc_embeds=)): pass no "
                                 "enc_embeds with it")
            return None
        if enc_embeds is None:
            raise ValueError(f"{self.cfg.name} (encdec) needs encoder "
                             f"embeddings: enc_embeds=")
        return self.encode(params, enc_embeds, remat)

    def trunk(self, params: dict, tokens, state: Optional[dict] = None, *,
              enc_embeds=None) -> torch.Tensor:
        """Embed + all blocks + final norm → hidden (B, S, D).  With a
        decode ``state``, the prefill: each attention layer writes its
        post-RoPE K and V into the cache at positions 0..S-1 and attends
        over them as stored (``attn_forward``'s ``kv_cache``), each mamba
        layer leaves its decode state, and the MoE layers route every
        token (``_apply_unit``).  An encdec model encodes ``enc_embeds``
        (B, S_enc, D) first; with a state its cross sub-blocks read the
        state's cross K/V instead, and nothing is encoded again."""
        return self._trunk(params, tokens, state, enc_embeds)[0]

    def _trunk(self, params: dict, tokens, state: Optional[dict] = None,
               enc_embeds=None, remat: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """``trunk`` → (hidden, the summed MoE aux loss of the decoder
        stack), each unit under ``remat`` if asked."""
        cfg = self.cfg
        if self.parallel is None:
            params = self.cast(params)
        memory = self._memory(params, state, enc_embeds, remat)
        if memory is not None and self.parallel is not None:
            memory = self.parallel.encoder().gather_seq(memory)
        tokens = self._tokens(tokens)
        x = self._embed(params, tokens)
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        x, aux = self._stack(params, x, positions, state=state,
                             memory=memory, remat=remat)
        return rmsnorm(x, self._leaf(params, "embed", "final_norm"),
                       cfg.norm_eps), aux

    def encode(self, params: dict, enc_embeds,
               remat: bool = False) -> torch.Tensor:
        """The encoder stack over frame embeddings (B, S_enc, D), cast to
        the compute dtype: positions 0..S_enc-1, non-causal self-attention
        with RoPE and GQA, then ``enc_norm``."""
        cfg = self.cfg
        if self.parallel is None:
            params = self.cast(params)
        x = torch.as_tensor(enc_embeds, device=self.device) \
            .to(self.compute_dtype)
        B, S, _ = x.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        if self.parallel is not None:
            x = self.parallel.encoder().chunk(x, 1)
        x, _ = self._stack(params, x, positions, stack="enc_blocks",
                           layout=ENC_LAYOUT, causal=False, remat=remat)
        return rmsnorm(x, self._leaf(params, "enc_norm"), cfg.norm_eps)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ params["embed"]["lm_head"].to(hidden.dtype)

    def forward(self, params: dict, tokens, enc_embeds=None) -> torch.Tensor:
        return self.logits(params, self.trunk(params, tokens,
                                              enc_embeds=enc_embeds))

    # --------------------------------------------------------------- loss
    def loss_fn(self, params: dict, tokens, enc_embeds=None) -> torch.Tensor:
        """Next-token cross entropy + 0.01 × the MoE load-balancing loss,
        as the reference's.  Position s predicts token s + 1; the last
        position is masked.  The logits are the compute dtype's product,
        then f32, taken over ``loss_chunk`` positions at a time so the
        (B, S, vocab) tensor is never whole; the sum over unmasked
        positions is divided by their count.  f32 master params are cast
        inside the call, so gradients reach them.  With ``remat`` each unit
        and each loss chunk is recomputed in the backward pass."""
        h, aux = self._trunk(params, tokens, enc_embeds=enc_embeds,
                             remat=self.remat)
        tokens = self._tokens(tokens)
        B, S = tokens.shape
        labels = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], dim=1)
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
        mask[:, -1] = 0.0
        ntok = torch.clamp(mask.sum(), min=1.0)
        head = self._leaf(params, "embed", "lm_head")
        chunk_loss = self._chunk_loss
        par = self.parallel
        tp = par is not None and par.m > 1
        if tp and self._model_dim("embed", "lm_head") == 1:
            h = par.gather_seq(h)
            chunk_loss = self._vocab_parallel_loss
        elif tp and par.split:
            # the head whole: each rank's own positions, summed over "model"
            labels, mask = par.chunk(labels, 1), par.chunk(mask, 1)
        S = h.shape[1]
        ck = min(self.loss_chunk, S)
        if S % ck:
            raise ValueError(f"sequence length {S} is not a multiple of "
                             f"loss_chunk {ck}")
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, S, ck):
            args = (h[:, c0:c0 + ck], labels[:, c0:c0 + ck],
                    mask[:, c0:c0 + ck], head)
            total = total + (checkpoint(chunk_loss, *args,
                                        use_reentrant=False)
                             if self.remat else chunk_loss(*args))
        if tp and chunk_loss is self._chunk_loss:
            # the head whole: the ranks' own positions summed, or, with
            # every position on every rank, each rank's loss whole and its
            # gradient (the head's and h's) a rank's share of the sum
            total = (reduce_from_group(total, par.model) if par.split
                     else scale_grad(total, 1.0 / par.m))
        return total / ntok + 0.01 * aux

    @staticmethod
    def _chunk_loss(hh, ll, mm, head):
        lg = (hh @ head.to(hh.dtype)).float()
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, ll[..., None])[..., 0]
        return ((lse - gold) * mm).sum()

    def _vocab_parallel_loss(self, hh, ll, mm, head):
        """``_chunk_loss`` with this rank's vocab columns of the head: the
        logsumexp from the ranks' max (no gradient) and their summed
        exponentials, the gold logit from the rank that holds it."""
        par = self.parallel
        lg = (hh @ head.to(hh.dtype)).float()
        mx = all_reduce_max(lg.detach().amax(dim=-1), par.model)
        se = torch.exp(lg - mx[..., None]).sum(dim=-1)
        lse = mx + torch.log(reduce_from_group(se, par.model))
        local = ll - par.r * lg.shape[-1]
        inside = (local >= 0) & (local < lg.shape[-1])
        gold = torch.gather(lg, -1, local.clamp(0, lg.shape[-1] - 1)
                            [..., None])[..., 0] * inside
        gold = reduce_from_group(gold, par.model)
        return ((lse - gold) * mm).sum()

    # ------------------------------------------------------------ prefill
    def prefill(self, params: dict, tokens, state: Optional[dict] = None,
                *, enc_embeds=None) -> torch.Tensor:
        """Forward trunk, return the last position's logits (B, vocab).
        With a decode ``state`` it also fills the caches (``trunk``) and
        sets ``state["index"] = S``: one trunk pass giving what the
        reference ``LMServer``'s S teacher-forced decode steps give.  An
        encdec model takes ``enc_embeds`` without a state; with one, the
        state's cross K/V."""
        h = self.trunk(params, tokens, state, enc_embeds=enc_embeds)
        if state is not None:
            state["index"] = h.shape[1]
        return self.logits(params, h[:, -1:, :])[:, 0]

    # ------------------------------------------------------------- decode
    def mixer_counts(self) -> tuple[int, int]:
        """(attention, mamba) layers per unit."""
        na = sum(1 for p in self.layout if p.mixer == "attn")
        return na, len(self.layout) - na

    def init_decode_state(self, batch: int, max_len: int,
                          params: Optional[dict] = None,
                          enc_embeds=None, dtype=torch.bfloat16,
                          kv_quant: bool = False) -> dict:
        """The reference's decode state: KV caches (U, na, B, max_len, K,
        hd) in ``dtype`` (bf16 by default, as the reference's), mamba
        states ``ssm_h`` (U, ns, B, H, P, N) f32 and ``conv`` (U, ns, B,
        cw-1, d_inner), and ``index`` 0, a host int.  ``conv`` is in the
        wider of ``dtype`` and the compute dtype: the reference's
        ``ssm_decode_step`` returns its window in that dtype (its
        concatenation promotes), so its state holds that from the first
        step on.

        ``kv_quant``: int8 KV caches with f32 scales ``k_scale``/``v_scale``
        (U, na, B, max_len, K), one per (position, kv head).  An encdec
        model needs ``params`` and ``enc_embeds``: it encodes them and
        holds each decoder unit's cross K/V, ``cross_k``/``cross_v`` (U, B,
        S_enc, H, hd) in ``dtype``, computed from ``params`` as given — f32
        masters, as the reference passes, or weights already cast."""
        cfg = self.cfg
        U = self.n_units
        na, ns = self.mixer_counts()
        dev = self.device
        state: dict[str, Any] = {"index": 0}
        if na:
            cache = attn.init_kv_cache(cfg, batch, max_len, U * na,
                                       torch.int8 if kv_quant else dtype,
                                       dev)
            for key in ("k", "v"):
                state[key] = cache[key].reshape(
                    (U, na) + cache[key].shape[1:])
            if kv_quant:
                for key in ("k_scale", "v_scale"):
                    state[key] = torch.zeros((U, na, batch, max_len,
                                              cfg.n_kv),
                                             dtype=torch.float32, device=dev)
        if ns:
            H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
            state["ssm_h"] = torch.zeros((U, ns, batch, H, P, N),
                                         dtype=torch.float32, device=dev)
            state["conv"] = torch.zeros(
                (U, ns, batch, cfg.conv_width - 1, cfg.d_inner),
                dtype=torch.promote_types(dtype, self.compute_dtype),
                device=dev)
        if cfg.family == "encdec":
            if params is None or enc_embeds is None:
                raise ValueError(f"{cfg.name} (encdec): init_decode_state "
                                 f"needs params= and enc_embeds=")
            memory = self.encode(params, enc_embeds)
            kv = [attn.cross_memory_kv(self._unit(params, u)["pos0"]["cross"],
                                       memory, dtype) for u in range(U)]
            state["cross_k"], state["cross_v"] = (
                torch.stack(t) for t in zip(*kv))
        return state

    def decode_step(self, params: dict, state: dict,
                    tokens) -> tuple[torch.Tensor, dict]:
        """tokens (B, 1) → (logits (B, vocab), state).  The caches (and
        int8 scales) and mamba states are updated in place and ``index``
        advanced; the returned dict is a new one over the same tensors."""
        cfg = self.cfg
        params = self.cast(params)
        x = self._embed(params, self._tokens(tokens))
        index = int(state["index"])
        quant = "k_scale" in state
        for u in range(self.n_units):
            up = self._unit(params, u)
            ai = si = 0
            for i, pos in enumerate(self.layout):
                p = up[f"pos{i}"]
                h = rmsnorm(x, p["ln1"], cfg.norm_eps)
                if pos.mixer == "attn":
                    scales = {}
                    if quant:
                        scales = dict(k_scale=state["k_scale"][u, ai],
                                      v_scale=state["v_scale"][u, ai])
                    h = attn.attn_decode_step(p["attn"], h, cfg,
                                              state["k"][u, ai],
                                              state["v"][u, ai], index,
                                              **scales)[0]
                    ai += 1
                else:
                    h, state["ssm_h"][u, si], state["conv"][u, si] = \
                        mamba.ssm_decode_step(p["ssm"], h, cfg,
                                              state["ssm_h"][u, si],
                                              state["conv"][u, si])
                    si += 1
                x = x + h
                if pos.cross:
                    h = rmsnorm(x, p["ln_cross"], cfg.norm_eps)
                    x = x + attn.cross_attn_decode(
                        p["cross"], h, cfg, state["cross_k"][u],
                        state["cross_v"][u])
                if pos.ffn:
                    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
                    if pos.ffn == "moe":
                        h, _ = moe.moe_forward(p["moe"], h, cfg)
                    else:
                        h = mlp_forward(p["mlp"], h, cfg.mlp)
                    x = x + h
        x = rmsnorm(x, params["embed"]["final_norm"], cfg.norm_eps)
        return self.logits(params, x)[:, 0], dict(state, index=index + 1)
