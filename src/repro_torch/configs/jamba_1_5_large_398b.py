"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7 interleave
(attn_period=8, attention at offset 4), MoE every other layer (16e top-2)
[arXiv:2403.19887; hf]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv=8, d_ff=24576,
    vocab=65536, head_dim=128, mlp="swiglu",
    n_experts=16, top_k=2, moe_period=2,
    attn_period=8, attn_offset=4,
    ssm_state=16, ssm_expand=2, ssm_headdim=64, ssm_ngroups=8,
)
