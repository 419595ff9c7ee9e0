"""Model assembly — the dense family of ``repro.models.model``.

A model is a stack of *units*; for the dense family a unit is one layer
(attention mixer + MLP).  Params are nested dicts of tensors with the
reference's tree: every block leaf carries a leading ``n_units`` axis, so
a reference param tree (as numpy) carries across name for name
(``models/convert.py``).  ``lax.scan`` over the units becomes a Python
loop.

``Model(cfg, ..., backend="cuda", device=None)`` follows
``compile_forest``'s convention: ``device=None`` is the card and raises
without CUDA; on ``device="cpu"`` the ``cuda`` backend runs the kernel's
plain version.  ``backend="torch"`` is the reference's XLA engine (the
chunked flash in torch), ``backend="cuda"`` the hand-written flash kernel.

Waiting for later slices (ROADMAP Queue A 12): the moe, ssm, hybrid and
encdec families (``NotImplementedError``), the int8 KV cache, ``loss_fn``
and training, and the logical sharding specs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..core.registry import resolve_device
from . import attention as attn
from .attention import waits
from .config import ArchConfig
from .layers import (RealMaker, make_embed_params, make_mlp_params,
                     mlp_forward, rmsnorm)

FAMILIES = ("dense",)          # the families this slice runs


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


def n_units(cfg: ArchConfig) -> int:
    lay = unit_layout(cfg)
    assert cfg.n_layers % len(lay) == 0, (cfg.name, cfg.n_layers, len(lay))
    return cfg.n_layers // len(lay)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        waits(f"the {cfg.family} family ({cfg.name})")


# --------------------------------------------------------------------------- #
# Parameter construction (shared by RealMaker and layers.ShapeMaker)
# --------------------------------------------------------------------------- #
def _make_unit_params(mk, cfg: ArchConfig, layout: list[UnitPos],
                      U: int) -> dict:
    blocks: dict[str, Any] = {}
    ea = (U,)
    for i, pos in enumerate(layout):
        if pos.mixer != "attn" or pos.ffn != "mlp" or pos.cross:
            waits(f"a {pos} unit")
        blocks[f"pos{i}"] = {
            "ln1": mk(ea + (cfg.d_model,), ("layers", "embed"), init="ones"),
            "attn": attn.make_attn_params(mk, cfg, extra_axes=ea),
            "ln2": mk(ea + (cfg.d_model,), ("layers", "embed"), init="ones"),
            "mlp": make_mlp_params(mk, cfg.d_model, cfg.d_ff, cfg.mlp,
                                   extra_axes=ea),
        }
    return blocks


def make_params(cfg: ArchConfig, mk) -> dict:
    _check_family(cfg)
    return {
        "embed": make_embed_params(mk, cfg.vocab, cfg.d_model),
        "blocks": _make_unit_params(mk, cfg, unit_layout(cfg), n_units(cfg)),
    }


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# --------------------------------------------------------------------------- #
# Model
# --------------------------------------------------------------------------- #
class Model:
    def __init__(self, cfg: ArchConfig, compute_dtype=torch.bfloat16,
                 q_chunk: int = 1024, *, backend: str = "cuda",
                 device=None):
        _check_family(cfg)
        if backend not in attn.BACKENDS:
            raise ValueError(f"backend {backend!r} not in {attn.BACKENDS}")
        self.cfg = cfg
        self.n_units = n_units(cfg)
        self.compute_dtype = compute_dtype
        self.q_chunk = q_chunk
        self.backend = backend
        self.device = resolve_device(device)

    # ------------------------------------------------------------- params
    def init_params(self, seed: int = 0, dtype=torch.float32) -> dict:
        return make_params(self.cfg, RealMaker(seed, dtype, self.device))

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
        return params["embed"]["embedding"][tokens].to(self.compute_dtype)

    @staticmethod
    def _unit(params: dict, u: int) -> dict:
        """Unit ``u``'s params: for the dense family one layer, ``pos0``."""
        return tree_map(lambda a: a[u], params["blocks"]["pos0"])

    def trunk(self, params: dict, tokens,
              state: Optional[dict] = None) -> torch.Tensor:
        """Embed + all blocks + final norm → hidden (B, S, D).  With a
        decode ``state``, each attention layer writes its post-RoPE K and
        V into the cache at positions 0..S-1 and attends over them as
        stored (``attn_forward``'s ``kv_cache``)."""
        cfg = self.cfg
        params = self.cast(params)
        tokens = self._tokens(tokens)
        x = self._embed(params, tokens)
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        for u in range(self.n_units):
            p = self._unit(params, u)
            kv = None if state is None else (state["k"][u, 0],
                                             state["v"][u, 0])
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            x = x + attn.attn_forward(p["attn"], h, cfg, positions,
                                      q_chunk=self.q_chunk,
                                      backend=self.backend, kv_cache=kv)
            h = rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp_forward(p["mlp"], h, cfg.mlp)
        return rmsnorm(x, params["embed"]["final_norm"], cfg.norm_eps)

    def logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ params["embed"]["lm_head"].to(hidden.dtype)

    def forward(self, params: dict, tokens) -> torch.Tensor:
        return self.logits(params, self.trunk(params, tokens))

    def loss_fn(self, params, tokens):
        waits("loss_fn (training)")

    # ------------------------------------------------------------ prefill
    def prefill(self, params: dict, tokens,
                state: Optional[dict] = None) -> torch.Tensor:
        """Forward trunk, return the last position's logits (B, vocab).
        With a decode ``state`` it also fills the KV cache at positions
        0..S-1 and sets ``state["index"] = S``: one trunk pass giving what
        the reference ``LMServer``'s S teacher-forced decode steps give."""
        h = self.trunk(params, tokens, state)
        if state is not None:
            state["index"] = h.shape[1]
        return self.logits(params, h[:, -1:, :])[:, 0]

    # ------------------------------------------------------------- decode
    def init_decode_state(self, batch: int, max_len: int,
                          params: Optional[dict] = None,
                          enc_embeds=None, dtype=torch.bfloat16,
                          kv_quant: bool = False) -> dict:
        """KV caches (U, 1, B, max_len, K, hd) — the reference's layout,
        one attention layer per dense unit — in ``dtype`` (bf16 by
        default, as the reference's) and ``index`` 0, a host int."""
        if kv_quant:
            waits("the int8 KV cache")
        cache = attn.init_kv_cache(self.cfg, batch, max_len, self.n_units,
                                   dtype, self.device)
        return {"index": 0, "k": cache["k"][:, None],
                "v": cache["v"][:, None]}

    def decode_step(self, params: dict, state: dict,
                    tokens) -> tuple[torch.Tensor, dict]:
        """tokens (B, 1) → (logits (B, vocab), state).  The caches are
        updated in place and ``index`` advanced; the returned dict is a
        new one over the same cache tensors."""
        cfg = self.cfg
        params = self.cast(params)
        x = self._embed(params, self._tokens(tokens))
        index = int(state["index"])
        for u in range(self.n_units):
            p = self._unit(params, u)
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            h, _, _ = attn.attn_decode_step(p["attn"], h, cfg,
                                            state["k"][u, 0],
                                            state["v"][u, 0], index)
            x = x + h
            h = rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp_forward(p["mlp"], h, cfg.mlp)
        x = rmsnorm(x, params["embed"]["final_norm"], cfg.norm_eps)
        return self.logits(params, x)[:, 0], dict(state, index=index + 1)
