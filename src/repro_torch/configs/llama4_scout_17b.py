"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared, iRoPE chunked local
attention [hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048. 3 of 4 layers use
8k-chunked local attention, every 4th is global -> sub-quadratic prefill,
long_500k runs.
"""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        n_experts=16, moe_top_k=1, n_shared_experts=1, moe_d_ff=8192,
        attn_chunk=8192, global_layer_period=4,
        subquadratic=True,
    )
