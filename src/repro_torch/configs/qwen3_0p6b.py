"""qwen3-0.6b — dense GQA with per-head qk RMSNorm [hf:Qwen/Qwen3; hf].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, head_dim=128.
"""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, vocab_size=151936, qk_norm=True, rope_theta=1e6,
        tie_embeddings=True,
    )
