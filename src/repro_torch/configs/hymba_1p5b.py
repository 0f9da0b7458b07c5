"""hymba-1.5b — hybrid parallel attention+Mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
SWA everywhere except every-16th global layer (first/middle interleave of the
paper), 128 learnable meta tokens, parallel attn+SSM mixers averaged per layer.
Sub-quadratic -> runs the long_500k cell.
"""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab_size=32001,
        hybrid=True, meta_tokens=128,
        sliding_window=1024, global_layer_period=16,
        ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_groups=5,
        subquadratic=True,
    )
