"""mamba2-130m — attention-free SSD state-space model [arXiv:2405.21060].

24L d_model=768, ssm_state=128, expand=2 (d_inner=1536, 24 heads of 64).
Constant-state decode -> runs the long_500k cell.
"""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=24, n_kv_heads=24,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
        tie_embeddings=True, subquadratic=True,
    )
