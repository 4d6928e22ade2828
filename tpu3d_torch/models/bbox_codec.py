"""Bin-based 3D box decode (counterpart of ``tpu3d/models/bbox_codec.py``).

Regression layout (per row of pred_reg), identical to the reference:
  [x_bin | z_bin | (x_res | z_res if xz_fine) | y_offset (or y_bin|y_res) |
   ry_bin | ry_res | size_res(3)]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.box_geometry import rotate_points_along_y


def reg_channels(loc_scope, loc_bin_size, num_head_bin, get_xz_fine,
                 get_y_by_bin=False, loc_y_scope=0.5,
                 loc_y_bin_size=0.25) -> int:
    """Total regression channels for a head (reference: lib/net/rpn.py:31-38,
    rcnn_net.py:91-95)."""
    per_loc_bin_num = int(loc_scope / loc_bin_size) * 2
    loc_y_bin_num = int(loc_y_scope / loc_y_bin_size) * 2
    n = per_loc_bin_num * (4 if get_xz_fine else 2) + num_head_bin * 2 + 3
    n += loc_y_bin_num * 2 if get_y_by_bin else 1
    return n


def _select_bin(values: torch.Tensor, bin_idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(values, 1, bin_idx[:, None]).squeeze(1)


def decode_bbox_target(roi_box3d, pred_reg, loc_scope, loc_bin_size,
                       num_head_bin, anchor_size, get_xz_fine=True,
                       get_y_by_bin=False, loc_y_scope=0.5,
                       loc_y_bin_size=0.25, get_ry_fine=False):
    """Decode per-row bin predictions into boxes (N, 7) [x, y, z, h, w, l, ry].

    :param roi_box3d: (N, 3) point anchors or (N, 7) ROI boxes
    :param pred_reg: (N, C) raw head output
    Reference parity: lib/utils/bbox_transform.py:24-121.
    """
    anchor_size = torch.as_tensor(anchor_size, dtype=pred_reg.dtype,
                                  device=pred_reg.device)
    per_loc_bin_num = int(loc_scope / loc_bin_size) * 2
    loc_y_bin_num = int(loc_y_scope / loc_y_bin_size) * 2

    x_bin = torch.argmax(pred_reg[:, 0:per_loc_bin_num], dim=1)
    z_bin = torch.argmax(
        pred_reg[:, per_loc_bin_num: per_loc_bin_num * 2], dim=1)
    start = per_loc_bin_num * 2

    half = loc_bin_size / 2 - loc_scope
    pos_x = x_bin.to(pred_reg.dtype) * loc_bin_size + half
    pos_z = z_bin.to(pred_reg.dtype) * loc_bin_size + half

    if get_xz_fine:
        x_res = _select_bin(
            pred_reg[:, start: start + per_loc_bin_num], x_bin) * loc_bin_size
        z_res = _select_bin(
            pred_reg[:, start + per_loc_bin_num: start + per_loc_bin_num * 2],
            z_bin) * loc_bin_size
        pos_x = pos_x + x_res
        pos_z = pos_z + z_res
        start += per_loc_bin_num * 2

    if get_y_by_bin:
        y_bin = torch.argmax(pred_reg[:, start: start + loc_y_bin_num], dim=1)
        y_res = _select_bin(
            pred_reg[:, start + loc_y_bin_num: start + loc_y_bin_num * 2],
            y_bin) * loc_y_bin_size
        pos_y = (y_bin.to(pred_reg.dtype) * loc_y_bin_size
                 + loc_y_bin_size / 2 - loc_y_scope + y_res)
        pos_y = pos_y + roi_box3d[:, 1]
        start += loc_y_bin_num * 2
    else:
        pos_y = roi_box3d[:, 1] + pred_reg[:, start]
        start += 1

    ry_bin = torch.argmax(pred_reg[:, start: start + num_head_bin], dim=1)
    ry_res_norm = _select_bin(
        pred_reg[:, start + num_head_bin: start + num_head_bin * 2], ry_bin)
    if get_ry_fine:
        angle_per_class = (np.pi / 2) / num_head_bin
        ry = (ry_bin.to(pred_reg.dtype) * angle_per_class
              + angle_per_class / 2
              + ry_res_norm * (angle_per_class / 2) - np.pi / 4)
    else:
        angle_per_class = (2 * np.pi) / num_head_bin
        ry = torch.remainder(ry_bin.to(pred_reg.dtype) * angle_per_class
                             + ry_res_norm * (angle_per_class / 2), 2 * np.pi)
        ry = torch.where(ry > np.pi, ry - 2 * np.pi, ry)
    start += num_head_bin * 2

    size_res_norm = pred_reg[:, start: start + 3]
    hwl = size_res_norm * anchor_size + anchor_size

    shift_box = torch.cat(
        [pos_x[:, None], pos_y[:, None], pos_z[:, None], hwl, ry[:, None]],
        dim=1)
    if roi_box3d.shape[1] == 7:
        # un-rotate out of the ROI's canonical frame
        roi_ry = roi_box3d[:, 6]
        shift_box = rotate_points_along_y(shift_box, -roi_ry)
        shift_box[:, 6] += roi_ry
    shift_box[:, 0] += roi_box3d[:, 0]
    shift_box[:, 2] += roi_box3d[:, 2]
    return shift_box
