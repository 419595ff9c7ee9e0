"""seamless-m4t-large-v2 [audio]: encoder-decoder; the speech frontend is a
STUB — input_specs() provides precomputed frame embeddings (B, S_enc, D)
[arXiv:2308.11596; hf]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=8192,
    vocab=256206, head_dim=64, mlp="gelu",
    enc_layers=24, frontend_stub="audio",
)
