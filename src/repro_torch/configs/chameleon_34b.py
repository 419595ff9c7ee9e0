"""chameleon-34b [vlm]: early-fusion, VQ image tokens live in the 65536
vocab → backbone consumes plain token ids; VQ tokenizer frontend is a stub
[arXiv:2405.09818; unverified]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv=8, d_ff=22016,
    vocab=65536, head_dim=128, mlp="swiglu", frontend_stub="vlm",
)
