"""Run-dir logging + tensorboard (reference parity: train_rcnn.py:58-65).

The port's copy of ``tpu3d/utils/logging.py``, held equal to it by the
port's tests.
"""

from __future__ import annotations

import logging
import os


def create_logger(log_file: str | None = None, name: str = "tpu3d_torch"):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file is not None and not any(
            isinstance(h, logging.FileHandler)
            and h.baseFilename == os.path.abspath(log_file)
            for h in logger.handlers):
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def create_tb_writer(log_dir: str):
    """torch tensorboard SummaryWriter (replaces tensorboardX); None if absent."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(log_dir, exist_ok=True)
        return SummaryWriter(log_dir=log_dir)
    except Exception:
        return None
