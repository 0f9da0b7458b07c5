"""The LM stack the RAG server decodes with and the trainer trains: the ten
configs of the reference (dense, MoE, SSM, hybrid, encoder-decoder, VLM),
with the reference's parameter shapes and entry points, decode attention
through kernel 10, and ``loss_fn`` for training."""
from .common import ArchConfig
from .convert import from_reference, to_reference
from .layers import init_params
from .transformer import (DecoderLayer, Transformer, cache_schema,
                          decode_step, forward, forward_train,
                          logits_from_hidden, loss_fn, model_schema,
                          prefill)

__all__ = ["ArchConfig", "Transformer", "DecoderLayer", "model_schema",
           "init_params", "forward", "forward_train", "logits_from_hidden",
           "loss_fn", "prefill",
           "decode_step", "cache_schema", "from_reference", "to_reference"]
