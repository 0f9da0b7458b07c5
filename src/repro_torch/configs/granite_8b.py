"""granite-8b — dense llama-arch code model [arXiv:2405.04324; hf].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152. Pure full attention:
long_500k cell skipped (quadratic-prefill family rule, DESIGN.md §4).
"""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=49152,
    )
