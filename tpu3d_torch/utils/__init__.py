"""tpu3d_torch.utils — logging, checkpoints in tpu3d's file format, and the
msgpack codec they are written in."""

from .checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    load_part_ckpt,
    save_checkpoint,
)
from .logging import create_logger, create_tb_writer

__all__ = ["latest_checkpoint", "load_checkpoint", "load_part_ckpt",
           "save_checkpoint", "create_logger", "create_tb_writer"]
