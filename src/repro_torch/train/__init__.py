from .checkpoint import CheckpointManager
from .data import Prefetcher, SyntheticLMData
from .loop import (LoopConfig, StragglerWatchdog, TrainLoop,
                   make_initial_state)
from .optimizer import (OptConfig, adamw_update, init_opt_state, lr_at,
                        opt_state_shardings, zero1_spec)
from .step import TrainConfig, make_train_step

__all__ = [
    "CheckpointManager", "Prefetcher", "SyntheticLMData",
    "LoopConfig", "StragglerWatchdog", "TrainLoop", "make_initial_state",
    "OptConfig", "adamw_update", "init_opt_state", "lr_at",
    "opt_state_shardings", "zero1_spec",
    "TrainConfig", "make_train_step",
]
