"""command-r-plus-104b [dense]: GQA, no-bias, 256k vocab
[hf:CohereForAI/c4ai-command-r; unverified]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv=8, d_ff=33792,
    vocab=256000, head_dim=128, mlp="swiglu",
)
