"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16, MHA) expert d_ff=1408 vocab=102400. (The real
model's layer 0 is dense; we use uniform MoE layers for scan-over-layers —
noted in DESIGN.md §4.) Full attention -> long_500k skipped.
"""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=102400,
        n_experts=64, moe_top_k=6, n_shared_experts=2, moe_d_ff=1408,
    )
