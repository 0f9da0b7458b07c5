"""phi-3-vision-4.2b — phi3-mini backbone + CLIP stub frontend
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L d_model=3072 32H (kv=32, MHA) d_ff=8192 vocab=32064. The vision frontend
is a STUB per the assignment: input_specs() provides 144 precomputed patch
embeddings merged into the prefix positions.
"""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32064, num_patches=144,
    )
