"""Training modes of the port (counterpart of ``tpu3d/tools/train_rcnn.py``).

Only the mode toggles are ported so far. The CLI's training loop needs the
KITTI loader and checkpoints, which come with a later slice; the train step
itself is ``parallel.make_train_step``.
"""

from __future__ import annotations


def configure_mode(cfg, train_mode: str):
    """Set the stages ``train_mode`` trains on ``cfg``, in place (reference:
    train_rcnn.py:159-172): "rpn" the RPN alone, "rcnn" the RCNN on a fixed
    RPN, "joint" both, "rcnn_offline" the RCNN on saved proposals (which
    the port cannot run yet). Returns ``cfg``."""
    if train_mode == "rpn":
        cfg.RPN.ENABLED = True
        cfg.RCNN.ENABLED = False
    elif train_mode == "rcnn":
        cfg.RCNN.ENABLED = True
        cfg.RPN.ENABLED = True
        cfg.RPN.FIXED = True
    elif train_mode == "joint":
        cfg.RPN.ENABLED = cfg.RCNN.ENABLED = True
        cfg.RPN.FIXED = False
    elif train_mode == "rcnn_offline":
        cfg.RCNN.ENABLED = True
        cfg.RPN.ENABLED = False
    else:
        raise ValueError(train_mode)
    return cfg
