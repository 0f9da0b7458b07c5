"""Architecture config of the LM stack (a copy of ``repro/models/common.py``'s
:class:`ArchConfig`, field for field, with its accounting).

The logical-axis sharding rules of the reference (``DEFAULT_RULES``,
``logical_spec``, ``constrain``, ...) do not come over: they shard a
model, not the vector store (the port's sharded serving tier splits store
rows only), and the trainer runs the whole model on one card
(``launch/train.py``); a model-sharded launch is ROADMAP queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: int = 0             # 0 -> MHA
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # >0: SWA width for local layers
    attn_chunk: int = 0             # >0: chunked local attention (llama4 iRoPE)
    global_layer_period: int = 0    # every p-th layer is global (0 = all global)
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0               # routed-expert hidden dim (fine-grained MoE)
    capacity_factor: float = 1.25
    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    # hybrid (parallel attn + SSM heads per layer)
    hybrid: bool = False
    meta_tokens: int = 0            # hymba learnable prefix tokens
    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 0            # stub frontend sequence (whisper: 1500)
    # vlm stub
    num_patches: int = 0            # patch embeddings merged into prefix
    # misc
    act: str = "swiglu"             # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"             # none | dots | full
    attn_impl: str = "flash"        # flash | naive (naive: roofline compiles)
    subquadratic: bool = False      # eligible for long_500k
    scan_layers: bool = True
    loss_chunk: int = 0             # >0: chunked CE over seq (memory opt)
    moe_impl: str = "ep_shardmap"   # ep_shardmap | dense_tp
    sharding_preset: str = "tp_fsdp"  # tp_fsdp | fsdp_only | seq_par
    layer_group: int = 1            # >1: scan super-layers of this period

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.dtype]

    # ---------------------------------------------------------- layer mixing
    def layer_is_global(self, i: int) -> bool:
        """True when layer i uses global (full-context) attention."""
        if self.global_layer_period <= 0:
            return True
        # first layer + every p-th layer global (hymba/llama4-style interleave)
        return i % self.global_layer_period == 0

    def layer_windows(self) -> np.ndarray:
        """Per-layer local-attention window (0 = global)."""
        w = self.sliding_window or self.attn_chunk
        if w <= 0 or self.global_layer_period <= 0:
            return np.zeros(self.n_layers, dtype=np.int32)
        return np.asarray(
            [0 if self.layer_is_global(i) else w
             for i in range(self.n_layers)], dtype=np.int32)

    # ------------------------------------------------------------ accounting
    def param_count(self) -> int:
        """Total parameters (embedding included once if tied)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        H, KV, hd = self.n_heads, self.kv_heads, self.hd
        per_layer = 0
        if not self.attn_free:
            per_layer += D * H * hd + 2 * D * KV * hd + H * hd * D
            if self.qkv_bias:
                per_layer += (H + 2 * KV) * hd
            if self.qk_norm:
                per_layer += 2 * hd
        if self.family in ("ssm", "hybrid") or self.attn_free:
            d_in = self.ssm_expand * D
            n_h = d_in // self.ssm_head_dim
            conv_dim = d_in + 2 * self.ssm_groups * self.ssm_state
            per_layer += D * (2 * d_in + 2 * self.ssm_groups * self.ssm_state
                              + n_h)          # in_proj
            per_layer += conv_dim * self.ssm_conv + 3 * n_h + d_in * D + d_in
        if self.n_experts > 0:
            fe = self.moe_d_ff or F
            per_layer += D * self.n_experts                       # router
            per_layer += self.n_experts * 3 * D * fe              # routed
            per_layer += self.n_shared_experts * 3 * D * fe       # shared
        elif not self.attn_free:
            mults = 3 if self.act == "swiglu" else 2
            per_layer += mults * D * F
        per_layer += 2 * D                                        # norms
        total = L * per_layer + 2 * D                             # final norm
        total += V * D * (1 if self.tie_embeddings else 2)        # embed+head
        if self.is_encdec:
            enc_layer = (D * H * hd + 2 * D * KV * hd + H * hd * D
                         + (3 if self.act == "swiglu" else 2) * D * F + 2 * D)
            dec_cross = D * H * hd + 2 * D * KV * hd + H * hd * D + D
            total += self.encoder_layers * enc_layer + L * dec_cross
        if self.meta_tokens:
            total += self.meta_tokens * D
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        fe = self.moe_d_ff or self.d_ff
        skipped = (self.n_experts - self.moe_top_k) * 3 * self.d_model * fe
        return self.param_count() - self.n_layers * skipped
