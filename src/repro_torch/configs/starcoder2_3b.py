"""starcoder2-3b [dense]: GQA kv=2, RoPE, non-gated GELU MLP
[arXiv:2402.19173; hf]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv=2, d_ff=12288,
    vocab=49152, head_dim=128, mlp="gelu",
)
