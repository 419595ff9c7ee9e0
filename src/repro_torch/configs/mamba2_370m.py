"""mamba2-370m [ssm]: attention-free SSD (state-space duality), 48 blocks
[arXiv:2405.21060; unverified]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv=0, d_ff=0,
    vocab=50280, head_dim=64,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
)
