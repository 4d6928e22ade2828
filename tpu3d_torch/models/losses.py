"""Loss functions: Dice / sigmoid-focal / weighted-BCE classification and
the bin-based box regression loss (counterpart of
``tpu3d/models/losses.py``; reference: lib/utils/loss_utils.py).

As in the JAX package, the reference's boolean indexing of foreground rows
becomes mask-weighted means over every row, so every shape is fixed. Under
a data-parallel mesh (``parallel.mesh.use_mesh``) every denominator counts
the global batch, and each loss is this rank's share of the global one:
its own rows' numerator over the global denominator.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import global_sum, share


def _select_bin(values: torch.Tensor, bin_idx: torch.Tensor) -> torch.Tensor:
    """values[i, bin_idx[i]] per row as a masked sum, as tpu3d picks it: a
    bin past the last column (an angle that rounds up to 2π) gives 0
    rather than an out-of-range index."""
    cols = torch.arange(values.shape[1], device=values.device)
    return torch.where(cols == bin_idx[:, None], values, 0.0).sum(dim=1)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor,
                 count: torch.Tensor) -> torch.Tensor:
    """Σ x·mask over ``count``, the (global) count of the mask, at least 1."""
    return torch.sum(x * mask) / count


def sigmoid_cross_entropy_with_logits(logits, labels):
    """TF-compatible elementwise sigmoid CE (reference: loss_utils.py:76-84)."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def dice_loss(logits, target, ignore_target=-1):
    """1 − soft IoU between sigmoid(logits) and {0,1} targets, ignoring rows
    labeled ignore_target (reference: loss_utils.py:7-21)."""
    probs = torch.sigmoid(logits.reshape(-1))
    target = target.reshape(-1).to(probs.dtype)
    mask = (target != ignore_target).to(probs.dtype)
    inter = global_sum(torch.sum(torch.minimum(probs, target) * mask))
    union = torch.clamp(
        global_sum(torch.sum(torch.maximum(probs, target) * mask)), min=1.0)
    return share(1.0 - inter / union)


def sigmoid_focal_loss(logits, target, weights, gamma=2.0, alpha=0.25):
    """Elementwise sigmoid focal CE × weights (reference:
    loss_utils.py:24-73)."""
    ce = sigmoid_cross_entropy_with_logits(logits, target)
    probs = torch.sigmoid(logits)
    p_t = target * probs + (1 - target) * (1 - probs)
    modulating = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    alpha_w = (target * alpha + (1 - target) * (1 - alpha)
               if alpha is not None else 1.0)
    return modulating * alpha_w * ce * weights


def smooth_l1(pred, target):
    """Elementwise huber with beta=1 (torch F.smooth_l1_loss default)."""
    diff = torch.abs(pred - target)
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def softmax_ce(logits, label_idx):
    """Per-row softmax cross entropy against integer labels."""
    return -_select_bin(F.log_softmax(logits, dim=-1), label_idx)


def _bin_of(shifted, bin_size):
    return torch.floor(shifted / bin_size).long()


def get_reg_loss(pred_reg, reg_label, fg_mask, loc_scope, loc_bin_size,
                 num_head_bin, anchor_size, get_xz_fine=True,
                 get_y_by_bin=False, loc_y_scope=0.5, loc_y_bin_size=0.25,
                 get_ry_fine=False):
    """Bin-based box regression loss over foreground rows.

    :param pred_reg: (N, C) raw head output (all rows; fg selected by mask)
    :param reg_label: (N, 7) [dx, dy, dz, h, w, l, ry]
    :param fg_mask: (N,) float/bool, the rows that contribute to the loss
    :param anchor_size: (3,) or (N, 3)
    :return: (loc_loss, angle_loss, size_loss, dict of scalar components),
        each a mean over the foreground rows (reference:
        lib/utils/loss_utils.py:87-233)
    """
    fg = fg_mask.to(pred_reg.dtype)
    fg_count = global_sum(torch.sum(fg))
    count = torch.clamp(fg_count, min=1.0)
    per_loc_bin_num = int(loc_scope / loc_bin_size) * 2
    loc_y_bin_num = int(loc_y_scope / loc_y_bin_size) * 2
    reg_loss_dict = {}

    # xz bin classification + residual
    x_offset, y_offset, z_offset = (reg_label[:, 0], reg_label[:, 1],
                                    reg_label[:, 2])
    x_shift = torch.clamp(x_offset + loc_scope, 0, loc_scope * 2 - 1e-3)
    z_shift = torch.clamp(z_offset + loc_scope, 0, loc_scope * 2 - 1e-3)
    x_bin = _bin_of(x_shift, loc_bin_size)
    z_bin = _bin_of(z_shift, loc_bin_size)

    loss_x_bin = _masked_mean(
        softmax_ce(pred_reg[:, 0:per_loc_bin_num], x_bin), fg, count)
    loss_z_bin = _masked_mean(
        softmax_ce(pred_reg[:, per_loc_bin_num: per_loc_bin_num * 2], z_bin),
        fg, count)
    reg_loss_dict["loss_x_bin"] = loss_x_bin
    reg_loss_dict["loss_z_bin"] = loss_z_bin
    loc_loss = loss_x_bin + loss_z_bin
    start = per_loc_bin_num * 2

    if get_xz_fine:
        x_res_label = (x_shift - (x_bin.to(x_shift.dtype) * loc_bin_size
                                  + loc_bin_size / 2)) / loc_bin_size
        z_res_label = (z_shift - (z_bin.to(z_shift.dtype) * loc_bin_size
                                  + loc_bin_size / 2)) / loc_bin_size
        x_res_pred = _select_bin(
            pred_reg[:, start: start + per_loc_bin_num], x_bin)
        z_res_pred = _select_bin(
            pred_reg[:, start + per_loc_bin_num: start + per_loc_bin_num * 2],
            z_bin)
        loss_x_res = _masked_mean(smooth_l1(x_res_pred, x_res_label), fg,
                                  count)
        loss_z_res = _masked_mean(smooth_l1(z_res_pred, z_res_label), fg,
                                  count)
        reg_loss_dict["loss_x_res"] = loss_x_res
        reg_loss_dict["loss_z_res"] = loss_z_res
        loc_loss = loc_loss + loss_x_res + loss_z_res
        start += per_loc_bin_num * 2

    # y localization
    if get_y_by_bin:
        y_shift = torch.clamp(y_offset + loc_y_scope, 0,
                              loc_y_scope * 2 - 1e-3)
        y_bin = _bin_of(y_shift, loc_y_bin_size)
        y_res_label = (y_shift - (y_bin.to(y_shift.dtype) * loc_y_bin_size
                                  + loc_y_bin_size / 2)) / loc_y_bin_size
        loss_y_bin = _masked_mean(
            softmax_ce(pred_reg[:, start: start + loc_y_bin_num], y_bin), fg,
            count)
        y_res_pred = _select_bin(
            pred_reg[:, start + loc_y_bin_num: start + loc_y_bin_num * 2],
            y_bin)
        loss_y_res = _masked_mean(smooth_l1(y_res_pred, y_res_label), fg,
                                  count)
        reg_loss_dict["loss_y_bin"] = loss_y_bin
        reg_loss_dict["loss_y_res"] = loss_y_res
        loc_loss = loc_loss + loss_y_bin + loss_y_res
        start += loc_y_bin_num * 2
    else:
        loss_y_offset = _masked_mean(smooth_l1(pred_reg[:, start], y_offset),
                                     fg, count)
        reg_loss_dict["loss_y_offset"] = loss_y_offset
        loc_loss = loc_loss + loss_y_offset
        start += 1

    # heading
    ry_label = reg_label[:, 6]
    if get_ry_fine:
        angle_per_class = (np.pi / 2) / num_head_bin
        ry_l = torch.remainder(ry_label, 2 * np.pi)
        opposite = (ry_l > np.pi * 0.5) & (ry_l < np.pi * 1.5)
        ry_l = torch.where(opposite, torch.remainder(ry_l + np.pi, 2 * np.pi),
                           ry_l)
        shift_angle = torch.remainder(ry_l + np.pi * 0.5, 2 * np.pi)
        shift_angle = torch.clamp(shift_angle - np.pi * 0.25, 1e-3,
                                  np.pi * 0.5 - 1e-3)
    else:
        angle_per_class = (2 * np.pi) / num_head_bin
        heading = torch.remainder(ry_label, 2 * np.pi)
        shift_angle = torch.remainder(heading + angle_per_class / 2,
                                      2 * np.pi)
    ry_bin = _bin_of(shift_angle, angle_per_class)
    ry_res_label = (shift_angle
                    - (ry_bin.to(shift_angle.dtype) * angle_per_class
                       + angle_per_class / 2)) / (angle_per_class / 2)

    loss_ry_bin = _masked_mean(
        softmax_ce(pred_reg[:, start: start + num_head_bin], ry_bin), fg,
        count)
    ry_res_pred = _select_bin(
        pred_reg[:, start + num_head_bin: start + num_head_bin * 2], ry_bin)
    loss_ry_res = _masked_mean(smooth_l1(ry_res_pred, ry_res_label), fg,
                               count)
    reg_loss_dict["loss_ry_bin"] = loss_ry_bin
    reg_loss_dict["loss_ry_res"] = loss_ry_res
    angle_loss = loss_ry_bin + loss_ry_res
    start += num_head_bin * 2

    # size residual (vs anchor), mean over fg rows × 3 dims
    anchor_size = torch.as_tensor(anchor_size, dtype=pred_reg.dtype,
                                  device=pred_reg.device)
    size_label = (reg_label[:, 3:6] - anchor_size) / anchor_size
    size_pred = pred_reg[:, start: start + 3]
    size_loss = (torch.sum(smooth_l1(size_pred, size_label) * fg[:, None])
                 / torch.clamp(fg_count * 3, min=1.0))

    reg_loss_dict["loss_loc"] = loc_loss
    reg_loss_dict["loss_angle"] = angle_loss
    reg_loss_dict["loss_size"] = size_loss
    return loc_loss, angle_loss, size_loss, reg_loss_dict
