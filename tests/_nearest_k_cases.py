"""Inputs for the nearest-k tests, numpy only, shared by the CPU tests
(``test_torch_nearest_k.py``) and the card tests
(``test_torch_kernels_cuda.py``).

``tie_cases`` are the adversarial clouds: depth differences |fl(cz - pz)|
at the radius and a few ulps either side, repeated points (equal d² under
different ids), depths at 0 and 70.4, N < k, N % 128 != 0, centers whose
depth window is empty, and a pooled ROI whose points are all one point.
``dense_cloud`` is the box in which every SA_0 center has more than k
points within its radius.
"""

import numpy as np


def scene_cloud(rng, b, n, box=((-30, -1, 0), (30, 3, 70))):
    return rng.uniform(*box, size=(b, n, 3)).astype(np.float32)


def dense_cloud(rng, b, n):
    """16384 points here give each center about 33 within 0.5 m."""
    return scene_cloud(rng, b, n, ((-4, -1, 0), (4, 3, 8)))


def _ulps(v, steps):
    """v and its float32 neighbours ``steps`` ulps either side."""
    out = [np.float32(v)]
    for direction in (np.inf, -np.inf):
        w = np.float32(v)
        for _ in range(steps):
            w = np.nextafter(w, np.float32(direction))
            out.append(w)
    return out


def _boundary(rng, r, depths):
    """Centers at ``depths``; per center, points straight ahead and behind
    whose depth difference rounds to r and to the ulps around it, on the
    axis (d² is the depth term alone) and just off it."""
    centers, pts = [], []
    for cz in np.float32(depths):
        cx, cy = rng.uniform(-5, 5, 2).astype(np.float32)
        centers.append((cx, cy, cz))
        for sign in (1, -1):
            for pz in _ulps(np.float32(cz) - np.float32(sign * r), 3):
                pts.append((cx, cy, pz))
                pts.append((cx + np.float32(1e-3), cy, pz))
    pts = np.asarray(pts, np.float32)
    filler = scene_cloud(rng, 1, 200 - len(pts) % 128)[0]
    return (np.asarray(centers, np.float32)[None],
            np.concatenate([pts, filler])[None])


def tie_cases(seed=0):
    """[(name, centers (B, M, 3), pts (B, N, 3), k, max_radius)], f32."""
    rng = np.random.default_rng(seed)
    cases = []
    for r in (0.5, 0.2, 4.0):
        c, p = _boundary(rng, r, (0.0, 0.3, 20.3, 45.7, 70.4))
        cases.append((f"radius {r} boundary", c, p, 32, r))
    # repeated points: a few distinct points, each under many ids
    base = scene_cloud(rng, 2, 37, ((-1, -1, 0), (1, 1, 2)))
    pts = base[:, np.arange(300) % 37]
    cases.append(("repeated points", pts[:, ::5].copy(), pts, 32, 0.8))
    # depths at the ends of the range, many points at exactly 0 and 70.4
    pts = scene_cloud(rng, 2, 500, ((-2, -1, 0), (2, 1, 70.4)))
    pts[:, :150, 2] = 0.0
    pts[:, 150:300, 2] = np.float32(70.4)
    cases.append(("depths 0 and 70.4", pts[:, ::7].copy(), pts, 32, 0.5))
    # fewer points than k, and a point count that is no multiple of 128
    pts = scene_cloud(rng, 2, 20, ((-1, -1, 0), (1, 1, 1)))
    cases.append(("N < k", pts[:, :9].copy(), pts, 32, 0.6))
    pts = scene_cloud(rng, 2, 300, ((-2, -1, 0), (2, 1, 4)))
    cases.append(("N % 128 != 0", pts[:, ::3].copy(), pts, 32, 0.7))
    # centers far beyond every point's depth, and at the edge of the range
    pts = scene_cloud(rng, 2, 256, ((-2, -1, 0), (2, 1, 4)))
    far = pts[:, :16].copy()
    far[:, :8, 2] = np.float32(90.0)
    far[:, 8:, 2] = np.float32(-3.0)
    cases.append(("empty windows", far, pts, 32, 0.5))
    # a pooled ROI of one point repeated (an empty ROI): every point a hit
    # at d² = 0, the first 64 ids win
    pts = np.broadcast_to(scene_cloud(rng, 3, 1, ((-2, -1, -2), (2, 1, 2))),
                          (3, 512, 3)).copy()
    cases.append(("one point repeated", pts[:, :128].copy(), pts, 64, 0.2))
    return [(name, np.ascontiguousarray(c), np.ascontiguousarray(p), k, r)
            for name, c, p, k, r in cases]
