"""Inputs for the 3-NN tests, numpy only, shared by the CPU tests
(``test_torch_three_nn.py``) and the card tests
(``test_torch_kernels_cuda.py``).

``three_nn_cases`` are (name, queries (B, M, 3), known (B, N, 3)), f32:
duplicated known points, equal depths, equal d² at different ids, queries
beyond either end of the known depths, N = 3, every known point at one
depth, queries on known points, 70 m coordinates 1 cm apart, and
planted-cluster and uniform scenes. ``scale`` multiplies the point counts
of the scenes (the card tests take them larger).
"""

import numpy as np

from tpu3d_torch.datasets import random_scenes


def _front(rng, b, n):
    """Points uniform over the KITTI front area."""
    return rng.uniform([-30, -1, 0], [30, 3, 70], size=(b, n, 3)).astype(
        np.float32)


def three_nn_cases(seed=0, scale=1):
    rng = np.random.default_rng(seed)
    cases = []
    q, k = _front(rng, 2, 600 * scale), _front(rng, 2, 256 * scale)
    cases.append(("uniform", q, k))
    scenes = random_scenes(2, 1024 * scale, seed)  # clusters first
    cases.append(("planted clusters", scenes, scenes[:, ::4].copy()))
    base = _front(rng, 2, 40)
    cases.append(("duplicated known", _front(rng, 2, 300),
                  base[:, rng.integers(0, 40, size=160)]))
    k = _front(rng, 2, 200)
    k[..., 2] = np.round(k[..., 2] / 5.0) * 5.0  # 15 depths
    cases.append(("equal depths", _front(rng, 2, 300), k))
    # a lattice of integers: d² exact, many queries equidistant from 2-8
    # known points of different ids
    g = np.stack(np.meshgrid(np.arange(6), np.arange(3), np.arange(6),
                             indexing="ij"), -1).reshape(-1, 3)
    k = g[rng.permutation(len(g))].astype(np.float32)[None]
    q = (rng.integers(0, 5, size=(1, 150, 3))
         + rng.choice([0.0, 0.5], size=(1, 150, 3))).astype(np.float32)
    cases.append(("equal d2", q, k))
    k = _front(rng, 1, 100)
    k[..., 2] = rng.uniform(30, 40, size=(1, 100))
    q = _front(rng, 1, 120)
    q[0, :60, 2] = rng.uniform(-20, 10, size=60)
    q[0, 60:, 2] = rng.uniform(60, 90, size=60)
    cases.append(("beyond the ends", q, k))
    cases.append(("N = 3", _front(rng, 2, 100), _front(rng, 2, 3)))
    k = _front(rng, 2, 90)
    k[..., 2] = np.float32(35.25)
    cases.append(("one depth", _front(rng, 2, 100), k))
    k = _front(rng, 2, 128)
    q = np.concatenate([k[:, ::2], _front(rng, 2, 40)], 1)
    cases.append(("on known points", q, k))
    # 70 m out, on a 1 cm grid: depth differences of a few ulps of 70
    g = np.stack(np.meshgrid(np.arange(8), np.arange(4), np.arange(8),
                             indexing="ij"), -1).reshape(-1, 3)
    k = (np.float32([5.0, 1.0, 70.0]) + 0.01 * g).astype(np.float32)
    q = (np.float32([5.0, 1.0, 70.0])
         + rng.uniform(-0.01, 0.09, size=(200, 3))).astype(np.float32)
    k = k[rng.permutation(len(k))]
    cases.append(("70 m, 1 cm apart", q[None], k[None]))
    return [(name, np.ascontiguousarray(q), np.ascontiguousarray(k))
            for name, q, k in cases]
