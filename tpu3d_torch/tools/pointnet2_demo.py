"""The PointNet++ foreground-segmentation harness: the port's copy of
``tpu3d/tools/pointnet2_demo.py``.

Trains a small Pointnet2MSG with a per-point segmentation head and
DiceLoss on KITTI-format scenes (or the synthetic generator's) and reports
the foreground IoU. It drives every PointNet++ primitive (FPS, ball query,
grouping, three-NN propagation) end to end with gradients, apart from the
detector, at its own widths: on the card the fused FPS+3NN kernel at SA_0-1,
FPS and three_nn at SA_2-3, nearest_k at each level and the interpolation's
forward and backward kernels at the four FP levels.

    python -m tpu3d_torch.tools.pointnet2_demo --synthetic --epochs 2 \\
        [--device cpu]

It runs on the card unless ``--device cpu`` is given; with no card and no
``--device cpu`` it raises. The flax model's weights carry over with
``weights.params_from_jax``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch import nn

from ..config import fresh_cfg
from ..datasets import (BatchLoader, KittiRCNNDataset, create_synthetic_kitti,
                        device_prefetch)
from ..device import resolve_device
from ..models.losses import dice_loss
from ..models.pointnet2 import Pointnet2MSG, SharedMLP
from ..utils.logging import create_logger

# the demo's backbone (tpu3d/tools/pointnet2_demo.py:38-50)
NPOINTS = (256, 64, 32, 16)
RADII = ((0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0))
NSAMPLES = ((16, 32),) * 4
SA_MLPS = (((8, 8), (8, 8)), ((8, 16), (8, 16)), ((16, 16), (16, 16)),
           ((16, 32), (16, 32)))
FP_MLPS = ((32, 32), (32, 32), (32, 32), (64, 64))
KEYS = ("pts_input", "rpn_cls_label")


class PointnetSeg(nn.Module):
    """The small MSG backbone and a pointwise segmentation head, under
    flax's module names (``backbone``, ``head``, ``out``)."""

    def __init__(self, npoints=NPOINTS, device=None):
        super().__init__()
        self.backbone = Pointnet2MSG(npoints, RADII, NSAMPLES, SA_MLPS,
                                     FP_MLPS, bn=True, device=device)
        self.head = SharedMLP(FP_MLPS[0][-1], (32,), bn=True, device=device)
        self.out = nn.Linear(32, 1, device=device)

    def forward(self, pts: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.9) -> torch.Tensor:
        """(B, N, 3) -> (B, N) logits."""
        _, feats = self.backbone(pts, train=train, bn_momentum=bn_momentum)
        h = self.head(feats, train=train, bn_momentum=bn_momentum)
        return self.out(h)[..., 0]


def make_train_step(model: PointnetSeg, opt: torch.optim.Optimizer):
    """-> train_step(pts, labels) -> the DiceLoss (0-dim tensor): the
    train-mode forward (BatchNorm from the batch, its running statistics
    updated at flax's default momentum 0.9), the backward and one Adam
    update."""
    def train_step(pts, labels):
        opt.zero_grad(set_to_none=True)
        loss = dice_loss(model(pts, train=True), labels)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step


@torch.no_grad()
def fg_iou(model: PointnetSeg, pts, labels) -> torch.Tensor:
    """The foreground IoU of the eval-mode prediction (sigmoid > 0.5)."""
    pred = torch.sigmoid(model(pts)) > 0.5
    fg = labels > 0
    inter = (pred & fg).sum()
    return inter / (pred | fg).sum().clamp(min=1)


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description="pointnet2 seg demo")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--output_dir", type=str,
                        default="output/pointnet2_demo")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--npoints", type=int, default=1024)
    parser.add_argument("--lr", type=float, default=0.002)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card, the default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = create_logger(os.path.join(args.output_dir, "log.txt"),
                           name="pointnet2_demo")

    if args.synthetic or args.data_root is None:
        args.data_root = os.path.join(args.output_dir, "synthetic_data")
        if not os.path.exists(os.path.join(args.data_root, "KITTI")):
            create_synthetic_kitti(args.data_root, n_frames=8,
                                   image_files=True)

    cfg = fresh_cfg()
    cfg.GT_AUG_ENABLED = False
    cfg.RPN.USE_INTENSITY = False
    cfg.RPN.NUM_POINTS = args.npoints
    train_set = KittiRCNNDataset(root_dir=args.data_root, npoints=args.npoints,
                                 split="train", mode="TRAIN", cfg=cfg,
                                 logger=logger)
    val_set = KittiRCNNDataset(root_dir=args.data_root, npoints=args.npoints,
                               split="val", mode="EVAL", cfg=cfg,
                               logger=logger)
    train_loader = BatchLoader(train_set, args.batch_size, shuffle=True,
                               drop_last=True)
    val_loader = BatchLoader(val_set, args.batch_size)

    torch.manual_seed(0)
    model = PointnetSeg(device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    train_step = make_train_step(model, opt)
    loss, ious = torch.zeros(()), []
    for epoch in range(args.epochs):
        train_loader.set_epoch(epoch)
        for batch in device_prefetch(train_loader, keys=KEYS, device=dev):
            loss = train_step(batch["pts_input"], batch["rpn_cls_label"])
        logger.info(f"epoch {epoch}: loss {float(loss):.4f}")
        ious = [float(fg_iou(model, b["pts_input"], b["rpn_cls_label"]))
                for b in device_prefetch(val_loader, keys=KEYS, device=dev)]
        logger.info(f"epoch {epoch}: val fg IoU {np.mean(ious):.4f}")
    return float(np.mean(ious))


if __name__ == "__main__":
    main()
