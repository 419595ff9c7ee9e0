"""smollm-360m [dense]: llama-arch small [hf:HuggingFaceTB/SmolLM; hf].
15 heads / 5 kv heads do not divide the 16-wide model axis → sharding rules
fall back to head_dim sharding (distributed/sharding.py)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv=5, d_ff=2560,
    vocab=49152, head_dim=64, mlp="swiglu",
)
