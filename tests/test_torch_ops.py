"""The port's ops against tpu3d's on the CPU, on the same numpy inputs.

On the CPU tpu3d takes its portable paths: FPS+3NN runs ``_fps_xla`` and
``three_nn``, ``nearest_k`` is exact through ``approx_min_k``, and
``three_interpolate`` gathers. The port runs each kernel's plain version.
The CUDA kernels themselves are held against those plain versions on the
card by ``tests/test_torch_kernels_cuda.py`` and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.models.bbox_codec import decode_bbox_target as jax_decode
from tpu3d.ops import furthest_point_sample_with_3nn as jax_fps3nn
from tpu3d.ops import three_interpolate as jax_three_interpolate
from tpu3d.ops.grouping import ball_query_from_nearest as jax_bq_from_nearest
from tpu3d.ops.grouping import nearest_k as jax_nearest_k
from tpu3d.ops.interpolate import interpolation_weights as jax_weights
from tpu3d.ops.nms import nms_blocked_sorted as jax_nms_blocked_sorted
from tpu3d.ops.nms import nms_numpy
from tpu3d_torch.models.bbox_codec import decode_bbox_target
from tpu3d_torch.ops import (ball_query_from_nearest,
                             furthest_point_sample_with_3nn,
                             interpolation_weights, nearest_k,
                             nms_blocked_sorted, three_interpolate)


def _cloud(rng, b, n):
    return rng.uniform([-30, -1, 0], [30, 3, 70], size=(b, n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("n,npoint", [(1024, 256), (4096, 1024), (256, 64)])
def test_fps3nn_matches_tpu3d(n, npoint):
    """Picks and nn_idx equal; nn_d2 within 1e-5 relative (tpu3d's CPU path
    squares three_nn's square-rooted distance)."""
    xyz = _cloud(np.random.default_rng(n), 2, n)
    j_idx, j_d2, j_nn = jax.device_get(jax_fps3nn(jnp.asarray(xyz), npoint))
    t_idx, t_d2, t_nn = furthest_point_sample_with_3nn(torch.from_numpy(xyz),
                                                       npoint)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_array_equal(t_nn.numpy(), j_nn)
    np.testing.assert_allclose(t_d2.numpy(), j_d2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,n,radii,nsamples", [
    (256, 1024, (0.5, 1.0), (16, 32)),
    (64, 256, (2.0, 4.0), (16, 32)),
    (1024, 4096, (0.1, 0.5), (16, 32)),
])
def test_ball_query_from_nearest_k_matches_tpu3d(m, n, radii, nsamples):
    """Group ids equal per radius; the port's search is bounded by the
    largest radius, tpu3d's CPU search is the plain exact one."""
    rng = np.random.default_rng(m + n)
    pts = rng.uniform([-4, -1, 0], [4, 3, 8], size=(2, n, 3)).astype(
        np.float32)
    centers = pts[:, rng.choice(n, m, replace=False)]
    k = max(nsamples)
    jd, ji = jax_nearest_k(jnp.asarray(centers), jnp.asarray(pts), k)
    td, ti = nearest_k(torch.from_numpy(centers), torch.from_numpy(pts), k,
                       max_radius=max(radii))
    for r, s in zip(radii, nsamples):
        j_grp = np.asarray(jax_bq_from_nearest(jd, ji, r, s, n))
        t_grp = ball_query_from_nearest(td, ti, r, s, n).numpy()
        np.testing.assert_array_equal(t_grp, j_grp)
        assert (t_grp > 0).any()


def test_nearest_k_unbounded_matches_tpu3d():
    """Without max_radius the search is the exact nearest k: d² within
    1e-6 relative and ids equal."""
    rng = np.random.default_rng(3)
    pts = _cloud(rng, 2, 512)
    centers = pts[:, :128]
    jd, ji = jax.device_get(jax_nearest_k(jnp.asarray(centers),
                                          jnp.asarray(pts), 32))
    td, ti = nearest_k(torch.from_numpy(centers), torch.from_numpy(pts), 32)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6)


@pytest.mark.parametrize("n,m,c", [(4096, 16384, 8), (64, 256, 1024),
                                   (1024, 4096, 13)])
def test_three_interpolate_matches_tpu3d(n, m, c):
    """Weights and interpolated features within 1e-5."""
    rng = np.random.default_rng(c)
    feats = rng.normal(size=(2, n, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(2, m, 3)).astype(np.int32)
    dist = rng.uniform(0.0, 3.0, size=(2, m, 3)).astype(np.float32)
    j_w = np.asarray(jax_weights(jnp.asarray(dist)))
    t_w = interpolation_weights(torch.from_numpy(dist)).numpy()
    np.testing.assert_allclose(t_w, j_w, rtol=1e-5, atol=1e-6)
    j_out = np.asarray(jax_three_interpolate(jnp.asarray(feats),
                                             jnp.asarray(idx),
                                             jnp.asarray(j_w)))
    t_out = three_interpolate(torch.from_numpy(feats), torch.from_numpy(idx),
                              torch.tensor(j_w)).numpy()
    np.testing.assert_allclose(t_out, j_out, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("roi_cols,xz_fine,ry_fine", [(3, True, False),
                                                      (3, False, False),
                                                      (7, True, True)])
def test_decode_bbox_target_matches_tpu3d(roi_cols, xz_fine, ry_fine):
    """Decoded boxes within 1e-5 (RPN point anchors and RCNN-style ROIs)."""
    rng = np.random.default_rng(roi_cols)
    n = 2048
    roi = rng.uniform(-30, 30, size=(n, roi_cols)).astype(np.float32)
    bins = 9 if ry_fine else 12
    scope = 1.5 if ry_fine else 3.0
    n_reg = int(scope / 0.5) * 2 * (4 if xz_fine else 2) + bins * 2 + 4
    reg = rng.normal(size=(n, n_reg)).astype(np.float32)
    anchor = np.array([1.52, 1.63, 3.88], np.float32)
    kw = dict(loc_scope=scope, loc_bin_size=0.5, num_head_bin=bins,
              get_xz_fine=xz_fine, get_ry_fine=ry_fine)
    j = np.asarray(jax_decode(jnp.asarray(roi), jnp.asarray(reg),
                              anchor_size=jnp.asarray(anchor), **kw))
    t = decode_bbox_target(torch.from_numpy(roi), torch.from_numpy(reg),
                           anchor_size=anchor, **kw).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,block", [(600, 64), (2000, 256), (37, 256)])
def test_nms_blocked_sorted_matches_nms_numpy(n, block):
    """The same keeps as tpu3d's host greedy oracle on identical boxes."""
    rng = np.random.default_rng(n)
    centers = rng.uniform(0, 20, size=(n // 4 + 1, 2))
    pick = rng.integers(0, len(centers), n)
    boxes = np.concatenate(
        [centers[pick] + rng.normal(scale=0.3, size=(n, 2)),
         rng.uniform(1.0, 4.0, size=(n, 2)), rng.uniform(-3, 3, size=(n, 1))],
        axis=1).astype(np.float32)
    scores = rng.normal(size=n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    expect = nms_numpy(boxes, scores, 0.3, valid=valid, rotated=False)
    order = np.argsort(-scores, kind="stable")
    pos, mask = nms_blocked_sorted(torch.from_numpy(boxes[order]),
                                   torch.from_numpy(valid[order]), 0.3,
                                   max_out=n, block=block)
    got = order[pos.numpy()[mask.numpy()]]
    np.testing.assert_array_equal(got, expect)
    assert len(expect) < valid.sum()  # some boxes were suppressed
    # a smaller budget keeps the same prefix
    pos, mask = nms_blocked_sorted(torch.from_numpy(boxes[order]),
                                   torch.from_numpy(valid[order]), 0.3,
                                   max_out=10, block=block)
    np.testing.assert_array_equal(order[pos.numpy()[mask.numpy()]],
                                  expect[:10])


def test_nms_rotated_is_not_ported_yet():
    """The blocked walk with the rotated IoU: the same keeps, padding and
    mask as tpu3d's f32 blocked walk on identical sorted boxes. (tpu3d's
    f64 host oracle keeps one box more here: one pair's IoU lies within
    1e-5 of the threshold, on the other side of it in f64.)"""
    rng = np.random.default_rng(5)
    n = 300
    centers = rng.uniform(0, 20, size=(n // 4 + 1, 2))
    boxes = np.concatenate(
        [centers[rng.integers(0, len(centers), n)]
         + rng.normal(scale=0.3, size=(n, 2)),
         rng.uniform(1.0, 4.0, size=(n, 2)), rng.uniform(-3, 3, size=(n, 1))],
        axis=1).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    pos, mask = nms_blocked_sorted(torch.from_numpy(boxes),
                                   torch.from_numpy(valid), 0.3, max_out=n,
                                   block=64, rotated=True)
    j_pos, j_mask = jax_nms_blocked_sorted(jnp.asarray(boxes),
                                           jnp.asarray(valid), 0.3, n,
                                           rotated=True, block=64)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    assert 0 < mask.sum() < valid.sum()
