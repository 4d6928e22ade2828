"""Vectorized 3D box geometry in rect camera coordinates. Pure numpy.

The port's copy of ``tpu3d/kitti/boxes.py``, held equal to it by the port's
tests.

Box convention throughout the framework: ``(N, 7) = [x, y, z, h, w, l, ry]`` where
(x, y, z) is the *bottom-face center* in rect camera coords (x right, y down,
z forward), and ry rotates around the camera y axis. Replaces the reference's
pointrcnn/lib/utils/kitti_utils.py (numpy+torch+scipy-Delaunay mix) with one
vectorized numpy module; the torch twins live in ``tpu3d_torch.ops``.
"""

from __future__ import annotations

import numpy as np


def rotate_points_along_y(pc: np.ndarray, angle) -> np.ndarray:
    """Rotate the (x, z) components of points by ``angle`` around the camera y axis.

    x' = cos·x − sin·z ; z' = sin·x + cos·z. NOTE: this is the *inverse* of the
    rotation used to place box corners (``corners_from_boxes3d``); i.e.
    ``rotate_points_along_y(pts − center, ry)`` maps world points into the canonical
    frame of a box with yaw ``ry``. Reference parity: lib/utils/kitti_utils.py:32-42
    (and the batched torch variants at :45-63, bbox_transform.py:5-21).

    :param pc: (..., 3 + C) points; only columns 0 and 2 are touched.
    :param angle: scalar or broadcastable (...,) radians.
    :return: new array (input is not mutated, unlike the reference).
    """
    pc = np.array(pc, copy=True)
    c, s = np.cos(angle), np.sin(angle)
    x = pc[..., 0].copy()
    z = pc[..., 2].copy()
    pc[..., 0] = c * x - s * z
    pc[..., 2] = s * x + c * z
    return pc


def corners_from_boxes3d(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) boxes -> (N, 8, 3) corners in rect camera coords.

    Corner order (reference parity: lib/utils/kitti_utils.py:66-101 and
    utils/object_3d.py:58-76): corners 0-3 are the bottom face (y = y_c), 4-7 the
    top face (y = y_c − h); in the box frame corner 0 is (+l/2, ·, +w/2),
    1 (+l/2, ·, −w/2), 2 (−l/2, ·, −w/2), 3 (−l/2, ·, +w/2).
    A corner at box-frame (x_c, z_c) lands at world
    (cos·x_c + sin·z_c, ·, −sin·x_c + cos·z_c) + center.
    """
    boxes3d = np.asarray(boxes3d, dtype=np.float32)
    h, w, l, ry = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5], boxes3d[:, 6]
    # (N, 8) template corners in the box frame
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1], dtype=np.float32)
    sz = np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float32)
    sy = np.array([0, 0, 0, 0, -1, -1, -1, -1], dtype=np.float32)
    xc = l[:, None] / 2.0 * sx[None, :]
    zc = w[:, None] / 2.0 * sz[None, :]
    yc = h[:, None] * sy[None, :]
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    x = c * xc + s * zc + boxes3d[:, 0:1]
    y = yc + boxes3d[:, 1:2]
    z = -s * xc + c * zc + boxes3d[:, 2:3]
    return np.stack([x, y, z], axis=2).astype(np.float32)


# reference-compatible alias
boxes3d_to_corners3d = corners_from_boxes3d


def boxes3d_to_bev(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 5) [x1, z1, x2, z2, ry] axis-span BEV representation
    (reference parity: lib/utils/kitti_utils.py:134-147)."""
    boxes3d = np.asarray(boxes3d)
    cu, cv = boxes3d[:, 0], boxes3d[:, 2]
    half_l, half_w = boxes3d[:, 5] / 2.0, boxes3d[:, 4] / 2.0
    return np.stack(
        [cu - half_l, cv - half_w, cu + half_l, cv + half_w, boxes3d[:, 6]], axis=1
    )


def enlarge_box3d(boxes3d: np.ndarray, extra_width: float) -> np.ndarray:
    """Grow each dimension by 2·extra_width and push the bottom face down by
    extra_width (reference: lib/utils/kitti_utils.py:150-160)."""
    large = np.array(boxes3d, copy=True)
    large[:, 3:6] += extra_width * 2
    large[:, 1] += extra_width
    return large


def points_in_boxes3d(pts: np.ndarray, boxes3d: np.ndarray) -> np.ndarray:
    """Analytic point-in-rotated-box test. (N, 3) pts × (M, 7) boxes -> (N, M) bool.

    Rotates each point into each box's canonical frame and bound-tests — the same
    math as the reference's CUDA `check_pt_in_box3d` (roipool3d_kernel.cu) and a
    replacement for its scipy-Delaunay `in_hull` (lib/utils/kitti_utils.py:163-177).
    """
    pts = np.asarray(pts, dtype=np.float32)
    boxes3d = np.asarray(boxes3d, dtype=np.float32)
    cx, cy, cz = boxes3d[:, 0], boxes3d[:, 1], boxes3d[:, 2]
    h, w, l, ry = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5], boxes3d[:, 6]
    # shift: (N, M, 3)
    dx = pts[:, None, 0] - cx[None, :]
    dy = pts[:, None, 1] - cy[None, :]
    dz = pts[:, None, 2] - cz[None, :]
    c, s = np.cos(ry)[None, :], np.sin(ry)[None, :]
    # canonical frame: inverse of corner placement
    local_x = c * dx - s * dz
    local_z = s * dx + c * dz
    in_x = np.abs(local_x) <= (l[None, :] / 2.0)
    in_z = np.abs(local_z) <= (w[None, :] / 2.0)
    # bottom-center convention: inside means y ∈ [y_c − h, y_c]
    in_y = (dy <= 0) & (dy >= -h[None, :])
    return in_x & in_y & in_z


def pts_in_boxes3d_mask(pts: np.ndarray, boxes3d: np.ndarray) -> np.ndarray:
    """(M, N) bool — transposed layout matching roipool3d_cuda's pts_in_boxes3d."""
    return points_in_boxes3d(pts, boxes3d).T


def dist_to_plane(plane, points: np.ndarray) -> np.ndarray:
    """Signed distance from plane (a,b,c,d) to (N, 3) points
    (reference: lib/utils/kitti_utils.py:15-29)."""
    a, b, c, d = plane
    points = np.asarray(points)
    return (a * points[:, 0] + b * points[:, 1] + c * points[:, 2] + d) / np.sqrt(
        a ** 2 + b ** 2 + c ** 2
    )


# ---------------------------------------------------------------------------
# The host 3D IoU: the port's copy of ``tpu3d/ops/rotated_iou.py``'s numpy
# oracle (``boxes_iou3d_numpy`` and the Sutherland-Hodgman clip it uses),
# kept here because that module loads jax. tpu3d takes a C build of the same
# clip where one builds; the port keeps the numpy path alone.
# ---------------------------------------------------------------------------

def _np_box_corners(box5):
    xc, zc, l, w, ry = box5
    local = np.array([[l / 2, w / 2], [l / 2, -w / 2], [-l / 2, -w / 2],
                      [-l / 2, w / 2]])
    c, s = np.cos(ry), np.sin(ry)
    x = c * local[:, 0] + s * local[:, 1] + xc
    z = -s * local[:, 0] + c * local[:, 1] + zc
    return np.stack([x, z], axis=1)


def _np_clip(poly: list, p1, p2) -> list:
    out = []
    n = len(poly)
    e = p2 - p1
    for i in range(n):
        cur, nxt = poly[i], poly[(i + 1) % n]
        side_c = e[0] * (cur[1] - p1[1]) - e[1] * (cur[0] - p1[0])
        side_n = e[0] * (nxt[1] - p1[1]) - e[1] * (nxt[0] - p1[0])
        if side_c <= 0:
            out.append(cur)
        if (side_c <= 0) != (side_n <= 0):
            t = side_c / (side_c - side_n)
            out.append(cur + t * (nxt - cur))
    return out


def _np_polygon_area(poly: list) -> float:
    if len(poly) < 3:
        return 0.0
    a = 0.0
    n = len(poly)
    for i in range(n):
        cur, nxt = poly[i], poly[(i + 1) % n]
        a += cur[0] * nxt[1] - nxt[0] * cur[1]
    return abs(a) / 2.0


def rotated_intersection_numpy(box_a5, box_b5) -> float:
    """Intersection area of two [xc, zc, l, w, ry] boxes (host oracle)."""
    ca = _np_box_corners(np.asarray(box_a5, dtype=np.float64))
    cb = _np_box_corners(np.asarray(box_b5, dtype=np.float64))
    poly = [ca[i] for i in range(4)]
    for k in range(4):
        if not poly:
            return 0.0
        poly = _np_clip(poly, cb[k], cb[(k + 1) % 4])
    return _np_polygon_area(poly)


def rotated_iou_bev_numpy(boxes_a5: np.ndarray, boxes_b5: np.ndarray,
                          criterion: int = -1) -> np.ndarray:
    """(N, 5) × (M, 5) -> (N, M) rotated BEV IoU/overlap on host
    (criterion -1: IoU, 0: over a's area, 1: over b's, -2: intersection)."""
    boxes_a5 = np.ascontiguousarray(boxes_a5, dtype=np.float64)
    boxes_b5 = np.ascontiguousarray(boxes_b5, dtype=np.float64)
    out = np.zeros((len(boxes_a5), len(boxes_b5)))
    for i in range(len(boxes_a5)):
        for j in range(len(boxes_b5)):
            inter = rotated_intersection_numpy(boxes_a5[i], boxes_b5[j])
            if criterion == -2:
                out[i, j] = inter
                continue
            area_a = boxes_a5[i, 2] * boxes_a5[i, 3]
            area_b = boxes_b5[j, 2] * boxes_b5[j, 3]
            if criterion == -1:
                out[i, j] = inter / max(area_a + area_b - inter, 1e-8)
            elif criterion == 0:
                out[i, j] = inter / max(area_a, 1e-8)
            elif criterion == 1:
                out[i, j] = inter / max(area_b, 1e-8)
    return out


def boxes_iou3d_numpy(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Host 3D IoU oracle, (N, 7) × (M, 7)."""
    boxes_a = np.asarray(boxes_a, dtype=np.float64)
    boxes_b = np.asarray(boxes_b, dtype=np.float64)
    bev_a = boxes_a[:, [0, 2, 5, 4, 6]]
    bev_b = boxes_b[:, [0, 2, 5, 4, 6]]
    inter_bev = rotated_iou_bev_numpy(bev_a, bev_b, criterion=-2)
    ymax = np.minimum(boxes_a[:, None, 1], boxes_b[None, :, 1])
    ymin = np.maximum(boxes_a[:, None, 1] - boxes_a[:, None, 3],
                      boxes_b[None, :, 1] - boxes_b[None, :, 3])
    h_overlap = np.clip(ymax - ymin, 0.0, None)
    inter3d = inter_bev * h_overlap
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter3d / np.maximum(vol_a + vol_b - inter3d, 1e-8)
