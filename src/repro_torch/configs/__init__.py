"""Architecture registry: --arch <id> -> ArchConfig (+ reduced smoke variants).

Also defines the assigned input-shape sets (train_4k / prefill_32k /
decode_32k / long_500k) and the per-arch applicability rules from DESIGN.md §4.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..models.common import ArchConfig

from . import (deepseek_moe_16b, granite_8b, hymba_1p5b, llama4_scout_17b,
               mamba2_130m, minitron_4b, phi3_vision_4p2b, qwen2p5_3b,
               qwen3_0p6b, whisper_large_v3)

ARCHS = {
    "hymba-1.5b": hymba_1p5b.config,
    "granite-8b": granite_8b.config,
    "qwen2.5-3b": qwen2p5_3b.config,
    "qwen3-0.6b": qwen3_0p6b.config,
    "minitron-4b": minitron_4b.config,
    "phi-3-vision-4.2b": phi3_vision_4p2b.config,
    "mamba2-130m": mamba2_130m.config,
    "llama4-scout-17b-a16e": llama4_scout_17b.config,
    "deepseek-moe-16b": deepseek_moe_16b.config,
    "whisper-large-v3": whisper_large_v3.config,
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]()
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}"
                         ) from None


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention family: long_500k needs "
                       "sub-quadratic attention (DESIGN.md §4)")
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: small width/depth,
    few experts, tiny vocab — one forward/train step must run on 1 device."""
    cfg = get_arch(name)
    kw = dict(
        n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab_size=256,
        head_dim=16,
        n_kv_heads=min(cfg.kv_heads, 2) if cfg.n_kv_heads else 0,
        dtype="float32", remat="none",
    )
    if cfg.n_experts:
        kw.update(n_experts=4, moe_top_k=min(cfg.moe_top_k, 2),
                  n_shared_experts=min(cfg.n_shared_experts, 1), moe_d_ff=32)
    if cfg.ssm_state:
        kw.update(ssm_state=8, ssm_head_dim=8, ssm_groups=1, ssm_chunk=8,
                  ssm_expand=2)
    if cfg.meta_tokens:
        kw.update(meta_tokens=4)
    if cfg.sliding_window:
        kw.update(sliding_window=8, global_layer_period=2)
    if cfg.attn_chunk:
        kw.update(attn_chunk=8, global_layer_period=2)
    if cfg.is_encdec:
        kw.update(encoder_layers=2, encoder_seq=16)
    if cfg.num_patches:
        kw.update(num_patches=4)
    return cfg.replace(**kw)


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_arch", "smoke_config",
           "cell_applicable", "all_cells"]
