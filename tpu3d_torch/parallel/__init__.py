"""tpu3d_torch.parallel — the data-parallel mesh on torch.distributed (one
process per GPU, tpu3d's global-batch semantics), the optimizer, its
schedules, the train step and the eval steps."""

from .mesh import (Mesh, init_distributed, make_mesh, psum, replicate,
                   shard_batch, use_mesh)
from .train_state import (Optimizer, TrainState, bn_momentum_at_epoch,
                          create_train_state, make_eval_loss_step,
                          make_eval_step, make_lr_schedule,
                          make_momentum_schedule, make_optimizer,
                          make_train_step)

__all__ = ["Mesh", "init_distributed", "make_mesh", "psum", "replicate",
           "shard_batch", "use_mesh",
           "Optimizer", "TrainState", "bn_momentum_at_epoch",
           "create_train_state", "make_eval_loss_step", "make_eval_step",
           "make_lr_schedule", "make_momentum_schedule", "make_optimizer",
           "make_train_step"]
