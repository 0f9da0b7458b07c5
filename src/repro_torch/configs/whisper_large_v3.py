"""whisper-large-v3 — encoder-decoder audio backbone [arXiv:2212.04356].

32 encoder + 32 decoder layers, d_model=1280 20H (MHA) d_ff=5120 vocab=51866.
The conv/mel frontend is a STUB: input_specs() provides 1500 precomputed frame
embeddings; decoder shapes follow the assigned LM shapes.
"""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3", family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab_size=51866, act="gelu",
        encoder_layers=32, encoder_seq=1500,
    )
