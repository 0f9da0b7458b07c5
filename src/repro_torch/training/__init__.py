"""Training on one card (the port of ``repro/training``): the synthetic
corpus, AdamW, the train step and the checkpoint manager. Importing builds
nothing and touches no device."""
from .checkpoint import CheckpointManager
from .data import DataConfig, SyntheticLMData
from .optimizer import (OptConfig, adamw_update, global_norm, init_opt_state,
                        schedule)
from .train_step import int8_compress, make_train_step

__all__ = ["CheckpointManager", "DataConfig", "SyntheticLMData", "OptConfig",
           "adamw_update", "global_norm", "init_opt_state", "schedule",
           "int8_compress", "make_train_step"]
