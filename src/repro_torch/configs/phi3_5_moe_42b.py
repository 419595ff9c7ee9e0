"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2, every layer MoE
[hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400,
    vocab=32064, head_dim=128, mlp="swiglu",
    n_experts=16, top_k=2, moe_period=1,
)
