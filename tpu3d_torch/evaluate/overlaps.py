"""Pairwise overlap matrices for the AP evaluator (counterpart of
``tpu3d/evaluate/overlaps.py``).

metric 0 (image bbox): numpy on the host (tiny work).
metric 1 (rotated BEV) / metric 2 (3D): ``ops.rotated_overlap_bev`` in
float32 on an explicit device, one call per part of the eval run (the
reference's numba-CUDA rotate_iou_gpu_eval, evaluate/rotate_iou.py:294-329,
and the d3_box_overlap height-combine kernel, evaluate/eval2.py:136-169).
The JAX package pads each call to 256-row buckets to bound its recompiles;
PyTorch compiles nothing, so the port calls at the part's own shape.

Anno boxes arrive as [x, y, z, l, h, w, ry] rows (location + lhw dims + yaw).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.rotated_iou import rotated_overlap_bev


def image_box_overlap(boxes: np.ndarray, query_boxes: np.ndarray,
                      criterion: int = -1) -> np.ndarray:
    """Axis-aligned 2D overlap, (N, 4) × (K, 4) -> (N, K)
    (reference parity: evaluate/eval2.py:101-128; note intersection requires
    strictly positive width/height)."""
    boxes = np.asarray(boxes, dtype=np.float64)
    query_boxes = np.asarray(query_boxes, dtype=np.float64)
    N, K = boxes.shape[0], query_boxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K), dtype=np.float64)
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_n = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_k = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        ua = area_n + area_k - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_n, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_k, inter.shape)
    else:
        ua = np.ones_like(inter)
    return np.where(inter > 0, inter / ua, 0.0)


def rotated_overlap(boxes5_a: np.ndarray, boxes5_b: np.ndarray,
                    criterion: int, device) -> np.ndarray:
    """(N, 5) × (K, 5) [x, z, l, w, ry] -> (N, K) float64 host matrix of
    ``rotated_overlap_bev`` computed in float32 on ``device``."""
    n, k = len(boxes5_a), len(boxes5_b)
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=np.float64)
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(boxes5_a, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(boxes5_b, np.float32), device=dev)
    return rotated_overlap_bev(a, b, criterion=criterion).cpu().numpy() \
        .astype(np.float64)


def bev_box_overlap(boxes7: np.ndarray, qboxes7: np.ndarray,
                    criterion: int = -1, device=None) -> np.ndarray:
    """Rotated BEV overlap of [x,y,z,l,h,w,ry] boxes (eval2.py:131-133 parity)."""
    return rotated_overlap(boxes7[:, [0, 2, 3, 5, 6]],
                           qboxes7[:, [0, 2, 3, 5, 6]], criterion, device)


def d3_box_overlap_from_rinc(boxes7: np.ndarray, qboxes7: np.ndarray,
                             rinc: np.ndarray,
                             criterion: int = -1) -> np.ndarray:
    """Fuse a rotated-BEV intersection matrix with the camera-y extent overlap
    (exact semantics of eval2.py:136-163 d3_box_overlap_kernel: entries with
    rinc ≤ 0 pass through unchanged; box spans [y − h, y], dims are lhw)."""
    y_a, h_a = boxes7[:, 1], boxes7[:, 4]
    y_b, h_b = qboxes7[:, 1], qboxes7[:, 4]
    iw = (np.minimum(y_a[:, None], y_b[None, :])
          - np.maximum((y_a - h_a)[:, None], (y_b - h_b)[None, :]))
    vol_a = (boxes7[:, 3] * boxes7[:, 4] * boxes7[:, 5])[:, None]
    vol_b = (qboxes7[:, 3] * qboxes7[:, 4] * qboxes7[:, 5])[None, :]
    inc = iw * rinc
    if criterion == -1:
        ua = vol_a + vol_b - inc
    elif criterion == 0:
        ua = np.broadcast_to(vol_a, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(vol_b, inc.shape)
    else:
        ua = inc
    with np.errstate(invalid="ignore", divide="ignore"):
        fused = np.where(iw > 0, inc / ua, 0.0)
    return np.where(rinc > 0, fused, rinc)


def d3_box_overlap(boxes7: np.ndarray, qboxes7: np.ndarray,
                   criterion: int = -1, device=None) -> np.ndarray:
    """Full 3D overlap: rotated BEV intersection × camera-y extent overlap
    (eval2.py:136-169 parity)."""
    inter_bev = rotated_overlap(boxes7[:, [0, 2, 3, 5, 6]],
                                qboxes7[:, [0, 2, 3, 5, 6]], -2, device)
    if inter_bev.size == 0:
        return inter_bev
    return d3_box_overlap_from_rinc(boxes7, qboxes7, inter_bev, criterion)


def _anno_boxes7(anno: dict) -> np.ndarray:
    return np.concatenate(
        [anno["location"], anno["dimensions"], anno["rotation_y"][:, None]], axis=1)


def get_split_parts(num: int, num_part: int) -> list[int]:
    same, remain = num // num_part, num % num_part
    if same == 0:
        return [remain]
    return [same] * num_part + ([remain] if remain else [])


def calculate_iou_partly(dt_annos: list[dict], gt_annos: list[dict], metric: int,
                         num_parts: int = 50, device=None):
    """Per-image (num_dt, num_gt) overlap matrices, computed in concatenated parts
    (reference parity: evaluate/eval2.py:352-426 — note it also cross-computes
    between images inside a part; the same batching here, one device call
    per part).

    :return: (overlaps per image, parted overlaps, total_dt_num, total_gt_num)
    """
    assert len(gt_annos) == len(dt_annos)
    total_dt_num = np.array([len(a["name"]) for a in dt_annos])
    total_gt_num = np.array([len(a["name"]) for a in gt_annos])
    split_parts = get_split_parts(len(gt_annos), num_parts)

    parted = []
    idx = 0
    for num_part in split_parts:
        dts = dt_annos[idx: idx + num_part]
        gts = gt_annos[idx: idx + num_part]
        if metric == 0:
            dt_boxes = np.concatenate([a["bbox"] for a in dts], 0)
            gt_boxes = np.concatenate([a["bbox"] for a in gts], 0)
            part = image_box_overlap(dt_boxes, gt_boxes)
        elif metric == 1:
            dt_boxes = np.concatenate([_anno_boxes7(a) for a in dts], 0)
            gt_boxes = np.concatenate([_anno_boxes7(a) for a in gts], 0)
            part = bev_box_overlap(dt_boxes, gt_boxes, device=device)
        elif metric == 2:
            dt_boxes = np.concatenate([_anno_boxes7(a) for a in dts], 0)
            gt_boxes = np.concatenate([_anno_boxes7(a) for a in gts], 0)
            part = d3_box_overlap(dt_boxes, gt_boxes, device=device)
        else:
            raise ValueError(f"unknown metric {metric}")
        parted.append(part)
        idx += num_part

    overlaps = []
    idx = 0
    for j, num_part in enumerate(split_parts):
        dt_off, gt_off = 0, 0
        for i in range(num_part):
            nd, ng = total_dt_num[idx + i], total_gt_num[idx + i]
            overlaps.append(parted[j][dt_off: dt_off + nd, gt_off: gt_off + ng])
            dt_off += nd
            gt_off += ng
        idx += num_part
    return overlaps, parted, total_dt_num, total_gt_num
