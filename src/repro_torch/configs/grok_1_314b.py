"""grok-1-314b [moe]: 8 experts top-2, every layer MoE
[hf:xai-org/grok-1; unverified]. 8 experts do not divide the 16-wide model
axis → expert weights fall back to tensor-parallel d_ff sharding."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv=8, d_ff=32768,
    vocab=131072, head_dim=128, mlp="swiglu",
    n_experts=8, top_k=2, moe_period=1,
)
