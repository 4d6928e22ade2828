"""tpu3d_torch.parallel — the optimizer, its schedules and the train step
(one GPU; the device mesh is not ported yet)."""

from .train_state import (Optimizer, TrainState, bn_momentum_at_epoch,
                          create_train_state, make_lr_schedule,
                          make_momentum_schedule, make_train_step)

__all__ = ["Optimizer", "TrainState", "bn_momentum_at_epoch",
           "create_train_state", "make_lr_schedule", "make_momentum_schedule",
           "make_train_step"]
