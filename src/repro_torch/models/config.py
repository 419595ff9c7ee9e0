"""Architecture configuration for the assigned model zoo.

Plain Python, the same as ``repro.models.config``: the port keeps its own
copy so that it imports nothing of the reference package."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 → d_model // n_heads
    mlp: str = "swiglu"         # swiglu | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_period: int = 1         # every Nth layer is MoE (moe/hybrid families)
    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    conv_width: int = 4
    # --- hybrid (Jamba): 1 attention layer per `attn_period` layers ---
    attn_period: int = 0
    attn_offset: int = 4
    # --- enc-dec ---
    enc_layers: int = 0
    frontend_stub: Optional[str] = None   # "audio" | "vlm" (see DESIGN.md §4)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM/hybrid only)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def is_attn_layer(self, l: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return l % self.attn_period == self.attn_offset
        return True

    def is_moe_layer(self, l: int) -> bool:
        if self.n_experts == 0:
            return False
        return (l % self.moe_period) == self.moe_period - 1

    # ------------------------------------------------------------------ size
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, K, hd = self.n_heads, self.n_kv, self.head_dim
        attn = D * (H * hd) + 2 * D * (K * hd) + (H * hd) * D
        mlp = 3 * D * F if self.mlp == "swiglu" else 2 * D * F
        moe = self.n_experts * mlp + D * self.n_experts
        if self.family == "ssm":
            di, N, G = self.d_inner, self.ssm_state, self.ssm_ngroups
            ssm = D * (2 * di + 2 * G * N + self.ssm_heads) \
                + self.conv_width * (di + 2 * G * N) \
                + di * D + 2 * self.ssm_heads
        else:
            di, N, G = self.d_inner, max(self.ssm_state, 16), self.ssm_ngroups
            ssm = D * (2 * di + 2 * G * N + self.ssm_heads) \
                + self.conv_width * (di + 2 * G * N) + di * D

        total = 0
        n_dec = self.n_layers
        for l in range(n_dec):
            if self.family == "ssm" or (self.family == "hybrid"
                                        and not self.is_attn_layer(l)):
                total += ssm
            else:
                total += attn
            if self.family == "ssm":
                pass  # mamba block has no separate mlp
            elif self.is_moe_layer(l):
                total += moe
            else:
                total += mlp
            total += 2 * D
        if self.family == "encdec":
            for _ in range(self.enc_layers):
                total += attn + mlp + 2 * D          # encoder self + ff
            # decoder cross-attn is full MHA (K = H, models/attention.py)
            cross = 4 * D * (H * hd)
            total += n_dec * (cross + D)
        total += V * D * 2 + D                       # embed + head + norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        full_mlp = 3 * self.d_model * self.d_ff if self.mlp == "swiglu" \
            else 2 * self.d_model * self.d_ff
        dead = 0
        for l in range(self.n_layers):
            if self.is_moe_layer(l):
                dead += (self.n_experts - self.top_k) * full_mlp
        return self.param_count() - dead

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        n_layers = {"hybrid": max(self.attn_period, 2)}.get(self.family, 2)
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv=2,
            head_dim=16,
            d_ff=128,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.family in ("ssm", "hybrid") else self.ssm_headdim,
            enc_layers=2 if self.enc_layers else 0,
            attn_period=min(self.attn_period, 2) or 0,
            attn_offset=1 if self.family == "hybrid" else self.attn_offset,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason). long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("pure full-attention arch: 512k dense-KV decode is "
                       "quadratic with no sub-quadratic path (DESIGN.md §4)")
    return True, ""
