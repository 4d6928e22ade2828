"""Loss assembly for PointRCNN training (counterpart of
``tpu3d/models/train_functions.py``; reference:
lib/net/train_functions.py).

``model_loss`` gives (total loss, tb dict) from the model's output dict and
the batch's labels, with the same keys as tpu3d's; every reduction is
mask-based, so every shape is fixed. Under a data-parallel mesh
(``parallel.mesh.use_mesh``) every normalizer counts the global batch, and
the loss and each tb entry are this rank's share of the global one (its
rows' sums over the global counts; its own counts), which the train step
sums over the ranks.
"""

from __future__ import annotations

import torch

from ..ops.box_geometry import enlarge_box3d, points_in_boxes3d
from ..parallel.mesh import global_sum
from .losses import dice_loss, get_reg_loss, sigmoid_focal_loss


def generate_rpn_labels_device(pts_rect: torch.Tensor,
                               gt_boxes3d: torch.Tensor):
    """Per-point RPN labels from zero-padded gt boxes, on the points'
    device (tpu3d's ``generate_rpn_labels_device``; reference:
    lib/datasets/kitti_rcnn_dataset.py:384-414).

    The host loader's per-box loop, last write wins: for box k in index
    order it sets cls[in box k] = 1, then cls[in the box's 0.2 m extension
    but not in the box] = -1 and reg[in box k] = box k's targets, so the
    highest-index box that touches a point decides its labels.

    :param pts_rect: (..., N, 3) rect-frame points
    :param gt_boxes3d: (..., G, 7) gt boxes, zero rows for padding
    :return: cls_label (..., N) int32 in {-1, 0, 1}, reg_label (..., N, 7)
    """
    G = gt_boxes3d.shape[-2]
    gt_valid = (gt_boxes3d.abs().sum(dim=-1) > 0)[..., None, :]
    inside = points_in_boxes3d(pts_rect, gt_boxes3d) & gt_valid
    inside_ext = points_in_boxes3d(
        pts_rect, enlarge_box3d(gt_boxes3d, 0.2)) & gt_valid
    ids = torch.arange(G, device=pts_rect.device)
    last_touch = torch.where(inside | inside_ext, ids, -1).amax(dim=-1)
    pos_at_last = torch.gather(inside & inside_ext, -1,
                               last_touch.clamp(min=0)[..., None])[..., 0]
    cls_label = torch.where(last_touch >= 0,
                            torch.where(pos_at_last, 1, -1), 0).to(torch.int32)

    last_fg = torch.where(inside, ids, -1).amax(dim=-1)
    fg = last_fg >= 0
    box = torch.gather(gt_boxes3d, -2, last_fg.clamp(min=0)[..., None]
                       .expand(*last_fg.shape, 7))  # (..., N, 7)
    center3d = box[..., 0:3].clone()
    center3d[..., 1] = center3d[..., 1] - box[..., 3] / 2.0  # true center
    reg_label = torch.cat([center3d - pts_rect, box[..., 3:7]], dim=-1)
    reg_label = torch.where(fg[..., None], reg_label, 0.0)
    return cls_label, reg_label


def get_rpn_loss(cfg, rpn_cls, rpn_reg, rpn_cls_label, rpn_reg_label):
    """(B, N, 1) logits, (B, N, C) reg, (B, N) labels {-1, 0, 1}, (B, N, 7)
    reg targets -> (loss, tb dict). Reference: train_functions.py:55-120."""
    tb = {}
    cls_label_flat = rpn_cls_label.reshape(-1)
    cls_flat = rpn_cls.reshape(-1)
    fg_mask = cls_label_flat > 0

    if cfg.RPN.LOSS_CLS == "DiceLoss":
        rpn_loss_cls = dice_loss(cls_flat, cls_label_flat, ignore_target=-1)
    elif cfg.RPN.LOSS_CLS == "SigmoidFocalLoss":
        cls_target = fg_mask.to(cls_flat.dtype)
        pos = cls_target
        neg = (cls_label_flat == 0).to(cls_flat.dtype)
        cls_weights = (pos + neg) / torch.clamp(global_sum(torch.sum(pos)),
                                                min=1.0)
        per_entry = sigmoid_focal_loss(
            cls_flat, cls_target, cls_weights,
            gamma=cfg.RPN.FOCAL_GAMMA, alpha=cfg.RPN.FOCAL_ALPHA[0])
        tb["rpn_loss_cls_pos"] = torch.sum(per_entry * pos)
        tb["rpn_loss_cls_neg"] = torch.sum(per_entry * neg)
        rpn_loss_cls = torch.sum(per_entry)
    elif cfg.RPN.LOSS_CLS == "BinaryCrossEntropy":
        weight = torch.where(fg_mask, float(cfg.RPN.FG_WEIGHT), 1.0).to(
            cls_flat.dtype)
        target = fg_mask.to(cls_flat.dtype)
        probs = torch.sigmoid(cls_flat)
        eps = 1e-7
        bce = -(target * torch.log(torch.clamp(probs, min=eps))
                + (1 - target) * torch.log(torch.clamp(1 - probs, min=eps)))
        bce = bce * weight
        valid = (cls_label_flat >= 0).to(cls_flat.dtype)
        rpn_loss_cls = (torch.sum(bce * valid)
                        / torch.clamp(global_sum(torch.sum(valid)), min=1.0))
    else:
        raise NotImplementedError(cfg.RPN.LOSS_CLS)

    fg = fg_mask.to(rpn_reg.dtype)
    fg_sum = torch.sum(fg)
    loss_loc, loss_angle, loss_size, _ = get_reg_loss(
        rpn_reg.reshape(-1, rpn_reg.shape[-1]),
        rpn_reg_label.reshape(-1, 7), fg,
        loc_scope=cfg.RPN.LOC_SCOPE, loc_bin_size=cfg.RPN.LOC_BIN_SIZE,
        num_head_bin=cfg.RPN.NUM_HEAD_BIN, anchor_size=cfg.CLS_MEAN_SIZE[0],
        get_xz_fine=cfg.RPN.LOC_XZ_FINE, get_y_by_bin=False,
        get_ry_fine=False)
    loss_size = 3 * loss_size  # reference: train_functions.py:109
    rpn_loss_reg = torch.where(global_sum(fg_sum) > 0,
                               loss_loc + loss_angle + loss_size, 0.0)

    rpn_loss = (rpn_loss_cls * cfg.RPN.LOSS_WEIGHT[0]
                + rpn_loss_reg * cfg.RPN.LOSS_WEIGHT[1])
    tb.update({"rpn_loss_cls": rpn_loss_cls, "rpn_loss_reg": rpn_loss_reg,
               "rpn_loss": rpn_loss, "rpn_fg_sum": fg_sum,
               "rpn_loss_loc": loss_loc, "rpn_loss_angle": loss_angle,
               "rpn_loss_size": loss_size})
    return rpn_loss, tb


def get_rcnn_loss(cfg, ret_dict):
    """RCNN cls + canonical-frame bin regression loss from the proposal
    target layer's labels (reference: train_functions.py:122-213)."""
    tb = {}
    rcnn_cls = ret_dict["rcnn_cls"]
    rcnn_reg = ret_dict["rcnn_reg"]
    cls_label = ret_dict["cls_label"].to(rcnn_cls.dtype)
    reg_valid_mask = ret_dict["reg_valid_mask"]
    roi_boxes3d = ret_dict["roi_boxes3d"]
    gt_boxes3d_ct = ret_dict["gt_of_rois"]

    cls_label_flat = cls_label.reshape(-1)
    cls_flat = rcnn_cls.reshape(-1)
    if cfg.RCNN.LOSS_CLS == "SigmoidFocalLoss":
        cls_target = (cls_label_flat > 0).to(cls_flat.dtype)
        pos = cls_target
        neg = (cls_label_flat == 0).to(cls_flat.dtype)
        weights = (pos + neg) / torch.clamp(global_sum(torch.sum(pos)),
                                            min=1.0)
        per_entry = sigmoid_focal_loss(cls_flat, cls_target, weights,
                                       gamma=cfg.RCNN.FOCAL_GAMMA,
                                       alpha=cfg.RCNN.FOCAL_ALPHA[0])
        rcnn_loss_cls = torch.sum(per_entry)
    elif cfg.RCNN.LOSS_CLS == "BinaryCrossEntropy":
        probs = torch.sigmoid(cls_flat)
        eps = 1e-7
        target = torch.clamp(cls_label_flat, 0.0, 1.0)
        bce = -(target * torch.log(torch.clamp(probs, min=eps))
                + (1 - target) * torch.log(torch.clamp(1 - probs, min=eps)))
        valid = (cls_label_flat >= 0).to(cls_flat.dtype)
        rcnn_loss_cls = (torch.sum(bce * valid)
                         / torch.clamp(global_sum(torch.sum(valid)), min=1.0))
    else:
        raise NotImplementedError(cfg.RCNN.LOSS_CLS)

    fg = (reg_valid_mask > 0).to(rcnn_reg.dtype)
    fg_sum = torch.sum(fg)
    anchor = (roi_boxes3d[:, 3:6] if cfg.RCNN.SIZE_RES_ON_ROI
              else cfg.CLS_MEAN_SIZE[0])
    loss_loc, loss_angle, loss_size, _ = get_reg_loss(
        rcnn_reg.reshape(rcnn_reg.shape[0], -1),
        gt_boxes3d_ct.reshape(-1, 7), fg, loc_scope=cfg.RCNN.LOC_SCOPE,
        loc_bin_size=cfg.RCNN.LOC_BIN_SIZE,
        num_head_bin=cfg.RCNN.NUM_HEAD_BIN, anchor_size=anchor,
        get_xz_fine=True, get_y_by_bin=cfg.RCNN.LOC_Y_BY_BIN,
        loc_y_scope=cfg.RCNN.LOC_Y_SCOPE,
        loc_y_bin_size=cfg.RCNN.LOC_Y_BIN_SIZE, get_ry_fine=True)
    loss_size = 3 * loss_size
    rcnn_loss_reg = torch.where(global_sum(fg_sum) > 0,
                                loss_loc + loss_angle + loss_size, 0.0)

    rcnn_loss = rcnn_loss_cls + rcnn_loss_reg
    tb.update({"rcnn_loss_cls": rcnn_loss_cls,
               "rcnn_loss_reg": rcnn_loss_reg, "rcnn_loss": rcnn_loss,
               "rcnn_loss_loc": loss_loc, "rcnn_loss_angle": loss_angle,
               "rcnn_loss_size": loss_size,
               "rcnn_cls_fg": torch.sum(cls_label_flat > 0),
               "rcnn_cls_bg": torch.sum(cls_label_flat == 0),
               "rcnn_reg_fg": torch.sum(reg_valid_mask)})
    return rcnn_loss, tb


def model_loss(cfg, ret_dict, data):
    """Total loss of the trained stages (reference: train_functions.py
    model_fn): the RPN's unless it is fixed, plus the RCNN's when it is
    enabled. The RCNN's labels come from the proposal target layer on the
    device, or, in RCNN-offline mode, from the loader's batch
    (``cls_label``, ``reg_valid_mask``, ``roi_boxes3d``,
    ``gt_boxes3d_ct``, each (B, R, ...))."""
    tb = {}
    loss = 0.0
    if cfg.RPN.ENABLED and not cfg.RPN.FIXED:
        rpn_loss, tb_rpn = get_rpn_loss(
            cfg, ret_dict["rpn_cls"], ret_dict["rpn_reg"],
            data["rpn_cls_label"], data["rpn_reg_label"])
        loss = loss + rpn_loss
        tb.update(tb_rpn)
    if cfg.RCNN.ENABLED:
        if "cls_label" not in ret_dict:
            ret_dict = dict(ret_dict)
            ret_dict["cls_label"] = data["cls_label"].reshape(-1)
            ret_dict["reg_valid_mask"] = data["reg_valid_mask"].reshape(-1)
            ret_dict["roi_boxes3d"] = data["roi_boxes3d"].reshape(-1, 7)
            ret_dict["gt_of_rois"] = data["gt_boxes3d_ct"].reshape(-1, 7)
        rcnn_loss, tb_rcnn = get_rcnn_loss(cfg, ret_dict)
        loss = loss + rcnn_loss
        tb.update(tb_rcnn)
    tb["loss"] = loss
    return loss, tb
