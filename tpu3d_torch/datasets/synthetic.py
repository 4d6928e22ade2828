"""Synthetic lidar scenes: uniform clutter with planted car clusters.

``plant_clusters`` is the port's own copy of ``__graft_entry__.plant_clusters``
(numpy only).
"""

from __future__ import annotations

import numpy as np

# (x, z, ry) of eight car-sized gt boxes spread over the 0-70 m depth range
GT_SITES = [(0, 20, 0.3), (-5, 35, -1.0), (10, 50, 0.8), (-15, 15, 0.0),
            (18, 30, 1.2), (-22, 55, -0.4), (5, 65, 2.0), (-10, 45, 0.5)]


def plant_clusters(pts, gt, rng, k=48):
    """Overwrite the first ``k`` points per gt box with points INSIDE it
    (KITTI box: (x, y, z) = bottom center, y down, ry about y). Uniform
    scenes have ~2 points per car volume; clusters give the detector real
    foreground structure, like lidar returns on a car."""
    out = np.array(pts)
    for b in range(pts.shape[0]):
        i = 0
        for box in gt[b][np.abs(gt[b]).sum(1) > 0]:
            x, y, z, h, w, l, ry = [float(v) for v in box]
            local = rng.uniform([-l / 2, -h, -w / 2], [l / 2, 0, w / 2],
                                size=(k, 3))
            c_, s_ = np.cos(ry), np.sin(ry)
            rot = np.stack([local[:, 0] * c_ + local[:, 2] * s_, local[:, 1],
                            -local[:, 0] * s_ + local[:, 2] * c_], 1)
            out[b, i:i + k] = rot + [x, y, z]
            i += k
    return out.astype(np.float32)


def random_scenes(batch: int, n_points: int, seed: int) -> np.ndarray:
    """(B, N, 3) f32 points: uniform over the KITTI front area, with a
    cluster planted in each of eight car-sized gt boxes (GT_SITES)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-30, -1, 0], [30, 3, 70],
                      size=(batch, n_points, 3)).astype(np.float32)
    gt = np.zeros((batch, len(GT_SITES), 7), np.float32)
    for j, (gx, gz, gry) in enumerate(GT_SITES):
        gt[:, j] = [gx, 1.6, gz, 1.5, 1.6, 3.9, gry]
    return plant_clusters(pts, gt, rng)
