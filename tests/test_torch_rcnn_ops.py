"""The port's RCNN-stage ops against tpu3d's on the CPU, on the same numpy
inputs.

On the CPU tpu3d takes its portable paths: FPS runs ``_fps_xla`` (its Pallas
kernel ``_fps_pallas`` is run here too, in interpret mode), the ball query
takes the "nearest" rule through ``approx_min_k``, ROI pooling its top_k
branch, and the fused SA op its Pallas kernel in interpret mode only when
asked. The port runs each kernel's plain version. Pooled rows are built as
the ROI pool builds them (wraparound duplicates, and all-equal rows for
empty ROIs), because exact ties decide the picks there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.config import fresh_cfg as jax_fresh_cfg
from tpu3d.models import decode_bbox_target as jax_decode
from tpu3d.models.proposal import proposal_layer as jax_proposal_layer
from tpu3d.ops.fused_sa import fused_gathered_mlp_pool as jax_fused
from tpu3d.ops.fused_sa import fused_mlp_pool_reference
from tpu3d.ops.grouping import ball_query as jax_ball_query
from tpu3d.ops.nms import nms_bev as jax_nms_bev
from tpu3d.ops.roipool import roipool3d as jax_roipool3d
from tpu3d.ops.roipool import roipool3d_numpy
from tpu3d.ops.rotated_iou import boxes_iou3d as jax_boxes_iou3d
from tpu3d.ops.rotated_iou import rotated_overlap_bev as jax_overlap
from tpu3d.ops.sampling import _fps_pallas, _fps_xla
from tpu3d_torch.config import fresh_cfg
from tpu3d_torch.models.bbox_codec import decode_bbox_target
from tpu3d_torch.models.proposal import proposal_layer
from tpu3d_torch.ops import (ball_query, boxes_iou3d, nms_bev, roipool3d,
                             rotated_overlap_bev)
from tpu3d_torch.ops.fused_sa import fused_gathered_mlp_pool_plain
from tpu3d_torch.ops.sampling import furthest_point_sample_plain


def _rot_y(pc, ry):
    c, s = np.cos(ry), np.sin(ry)
    out = pc.copy()
    out[..., 0] = c * pc[..., 0] - s * pc[..., 2]
    out[..., 2] = s * pc[..., 0] + c * pc[..., 2]
    return out


def _pooled_rows(rng, n):
    """(3, n, 3) f32 rows as the RCNN sees them: uniform points in a ROI's
    canonical frame; 70 distinct points repeated by wraparound to n; and n
    copies of one point (an empty ROI: -center, rotated)."""
    uniform = rng.uniform([-2.5, -2.0, -1.5], [2.5, 0.5, 1.5], size=(n, 3))
    hits = rng.uniform([-2.5, -2.0, -1.5], [2.5, 0.5, 1.5], size=(70, 3))
    wrapped = hits[np.arange(n) % 70]
    center = np.array([4.0, 1.6, 30.0])
    empty = np.broadcast_to(_rot_y(-center[None], 0.7), (n, 3))
    return np.stack([uniform, wrapped, empty]).astype(np.float32)


@pytest.mark.parametrize("n,npoint", [(512, 128), (128, 32)])
def test_fps_matches_tpu3d(n, npoint):
    """Picks equal to tpu3d's Pallas FPS (interpret mode) and to its XLA
    FPS, on uniform, wraparound-duplicate and all-equal rows."""
    xyz = _pooled_rows(np.random.default_rng(n), n)
    got = furthest_point_sample_plain(torch.from_numpy(xyz), npoint).numpy()
    pallas = np.asarray(_fps_pallas(jnp.asarray(xyz), npoint, interpret=True))
    xla = np.asarray(_fps_xla(jnp.asarray(xyz), npoint))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    assert (got[2] == 0).all()  # all-equal row: every pick ties to point 0


def test_ball_query_matches_tpu3d():
    """On uniform rows the ids are equal. On wraparound rows the ids may
    not be: tpu3d's CPU rule (``approx_min_k``) orders equal d² in no
    fixed order, while the port ties to the lower id, and every copy of a
    duplicated point has the same d². There the grouped coordinates,
    which is what the network reads, must be equal."""
    rng = np.random.default_rng(3)
    xyz = _pooled_rows(rng, 512)
    centers = xyz[:, :128:2].copy()
    for radius, nsample in ((0.2, 64), (0.4, 64), (1.5, 16)):
        got = ball_query(torch.from_numpy(centers), torch.from_numpy(xyz),
                         radius, nsample).numpy()
        ref = np.asarray(jax_ball_query(jnp.asarray(centers),
                                        jnp.asarray(xyz), radius, nsample,
                                        method="nearest"))
        np.testing.assert_array_equal(got[0], ref[0])
        grouped = np.take_along_axis(xyz[:, None], got[..., None], axis=2)
        ref_grouped = np.take_along_axis(xyz[:, None], ref[..., None], axis=2)
        np.testing.assert_array_equal(grouped, ref_grouped)
        assert (got[0] != got[0][..., :1]).any()  # real groups, not pads


@pytest.mark.parametrize("shape", [(2, 4, 16, 128, 128, 128),
                                   (2, 2, 16, 128, 128, 256)])
def test_fused_gathered_mlp_pool_plain_matches_tpu3d(shape):
    """Against tpu3d's f32 oracle (gather, minus center, unfused chain)
    within 1e-5 abs + 1e-5 rel; against tpu3d's Pallas kernel (interpret
    mode, which rounds to bf16 at each layer) on bf16-representable inputs
    within 0.1 abs, the grade tests/test_fused_sa.py holds it to."""
    B, M, S, C1, C2, C3 = shape
    N = 128
    rng = np.random.default_rng(9)
    bf16 = lambda a: np.array(jnp.asarray(a, jnp.float32).astype(
        jnp.bfloat16).astype(jnp.float32))
    pre = bf16(rng.normal(size=(B, N, C1)))
    idx = rng.integers(0, N, size=(B, M, S)).astype(np.int32)
    center = bf16(0.5 * rng.normal(size=(B, M, C1)))
    w1 = (rng.normal(size=(C1, C2)) / np.sqrt(C1)).astype(np.float32)
    w2 = (rng.normal(size=(C2, C3)) / np.sqrt(C2)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=C2)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=C3)).astype(np.float32)
    got = fused_gathered_mlp_pool_plain(
        *(torch.from_numpy(a) for a in (pre, idx, center, w1, b1, w2, b2))
    ).numpy()
    x0 = np.take_along_axis(pre, idx.reshape(B, M * S)[..., None], axis=1
                            ).reshape(B, M, S, C1) - center[:, :, None, :]
    ref = np.asarray(fused_mlp_pool_reference(
        jnp.asarray(x0), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        jnp.asarray(b2)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(jax_fused(
        jnp.asarray(pre, jnp.bfloat16), jnp.asarray(idx),
        jnp.asarray(center, jnp.bfloat16), jnp.asarray(w1), jnp.asarray(b1),
        jnp.asarray(w2), jnp.asarray(b2), train=False, interpret=True),
        np.float32)
    assert np.abs(got - pallas).max() < 0.1


def _scene_and_rois(rng):
    """Two scenes of 2048 points with 48 points planted in each of 4 car
    boxes, and 12 rois per scene: near the cars, loose in the clutter
    (fewer points than slots, so wraparound), and far outside (empty)."""
    pts = rng.uniform([-20, -1, 0], [20, 3, 40], size=(2, 2048, 3))
    rois = []
    for b in range(2):
        boxes = []
        for j, (x, z, ry) in enumerate([(0, 10, 0.3), (-8, 20, -1.0),
                                        (6, 30, 0.8), (12, 15, 2.0)]):
            local = rng.uniform([-1.9, -1.5, -0.8], [1.9, 0, 0.8],
                                size=(48, 3))
            pts[b, 48 * j:48 * (j + 1)] = _rot_y(local, -ry) + [x, 1.6, z]
            boxes.append([x + rng.normal(0, 0.3), 1.6, z + rng.normal(0, 0.3),
                          1.5, 1.6, 3.9, ry + rng.normal(0, 0.1)])
            boxes.append([x, 1.6, z, 1.5, 1.6, 3.9, ry])
        boxes += [[rng.uniform(-15, 15), 1.0, rng.uniform(5, 35), 1.5, 1.6,
                   3.9, rng.uniform(-3, 3)] for _ in range(2)]
        boxes += [[100.0, 1.6, 100.0, 1.5, 1.6, 3.9, 0.5]] * 2
        rois.append(boxes)
    return pts.astype(np.float32), np.asarray(rois, np.float32)


def test_roipool3d_matches_tpu3d():
    """Pooled point ids and empty flags equal to tpu3d's device op and its
    host oracle, pooled values within 1e-6. Feature 0 is each point's id,
    so the pooled ids are read off the features."""
    rng = np.random.default_rng(5)
    pts, rois = _scene_and_rois(rng)
    feats = np.concatenate([np.broadcast_to(np.arange(2048.0), (2, 2048))[
        ..., None], rng.normal(size=(2, 2048, 5))], -1).astype(np.float32)
    px, pf, empty = (t.numpy() for t in roipool3d(
        torch.from_numpy(pts), torch.from_numpy(feats), torch.from_numpy(rois),
        1.0, 64))
    jx, jf, jempty = (np.asarray(t) for t in jax_roipool3d(
        jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(rois), 1.0, 64,
        split=True))
    host, host_empty = roipool3d_numpy(pts, feats, rois, 1.0, 64)
    for ref_f, ref_e in ((jf, jempty), (host[..., 3:], host_empty)):
        np.testing.assert_array_equal(pf[..., 0], ref_f[..., 0])
        np.testing.assert_array_equal(empty, ref_e)
        np.testing.assert_allclose(pf, ref_f, rtol=0, atol=1e-6)
    np.testing.assert_allclose(px, jx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(px, host[..., :3], rtol=0, atol=1e-6)
    counts = np.array([[len(np.unique(r)) for r in s] for s in pf[..., 0]])
    assert empty.any() and (~empty).any()
    assert ((counts > 1) & (counts < 64)).any()  # wraparound rows
    assert (counts == 64).any()                  # rows holding more than K


def _boxes5(rng, n):
    """Clustered BEV boxes [xc, zc, l, w, ry], with exact duplicates."""
    centers = rng.uniform(0, 20, size=(n // 3 + 1, 2))
    pick = rng.integers(0, len(centers), n)
    b = np.concatenate([centers[pick] + rng.normal(scale=0.5, size=(n, 2)),
                        rng.uniform(1.0, 4.5, size=(n, 2)),
                        rng.uniform(-3.2, 3.2, size=(n, 1))], axis=1)
    b[1] = b[0]
    return b.astype(np.float32)


@pytest.mark.parametrize("criterion", [-2, -1, 0, 1])
def test_rotated_overlap_bev_matches_tpu3d(criterion):
    """All four criteria within 1e-5."""
    rng = np.random.default_rng(11)
    a, b = _boxes5(rng, 40), _boxes5(rng, 30)
    b[:5] = a[:5]
    got = rotated_overlap_bev(torch.from_numpy(a), torch.from_numpy(b),
                              criterion).numpy()
    ref = np.asarray(jax_overlap(jnp.asarray(a), jnp.asarray(b), criterion))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (ref > 0.1).sum() > 10


def test_boxes_iou3d_matches_tpu3d():
    """3D IoU within 1e-5."""
    rng = np.random.default_rng(12)
    bev = _boxes5(rng, 30)
    y = rng.uniform(1.0, 2.0, size=(30, 1))
    h = rng.uniform(1.2, 2.0, size=(30, 1))
    boxes = np.concatenate([bev[:, :1], y, bev[:, 1:2], h, bev[:, 3:4],
                            bev[:, 2:3], bev[:, 4:5]], 1).astype(np.float32)
    got = boxes_iou3d(torch.from_numpy(boxes), torch.from_numpy(boxes[::-1]
                                                                .copy()))
    ref = jax_boxes_iou3d(jnp.asarray(boxes), jnp.asarray(boxes[::-1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("rotated", [True, False])
@pytest.mark.parametrize("n,max_out", [(100, 100), (300, 40)])
def test_nms_bev_matches_tpu3d(rotated, n, max_out):
    """The same kept indices, padding and mask as tpu3d's nms_bev."""
    rng = np.random.default_rng(n + rotated)
    boxes = _boxes5(rng, n)
    scores = rng.normal(size=n).astype(np.float32)
    scores[3] = scores[4]  # a tie, broken by index in both
    valid = rng.uniform(size=n) > 0.2
    idx, mask = nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores),
                        0.1, max_out, valid=torch.from_numpy(valid),
                        rotated=rotated)
    j_idx, j_mask = jax_nms_bev(jnp.asarray(boxes), jnp.asarray(scores), 0.1,
                                max_out, valid=jnp.asarray(valid),
                                rotated=rotated)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert 0 < mask.sum() < valid.sum()


def test_decode_bbox_target_rcnn_matches_tpu3d():
    """The RCNN decode (LOC_SCOPE 1.5, NUM_HEAD_BIN 9, fine ry, y offset
    not by bin) on car-sized rois over the KITTI range, within 1e-5."""
    rng = np.random.default_rng(13)
    n = 1024
    rois = np.concatenate([rng.uniform([-30, 0.5, 2], [30, 2.5, 70],
                                       size=(n, 3)),
                           rng.uniform([1.3, 1.4, 3.2], [1.8, 1.9, 4.6],
                                       size=(n, 3)),
                           rng.uniform(-np.pi, np.pi, size=(n, 1))], 1)
    rois = rois.astype(np.float32)
    reg = rng.normal(size=(n, 46)).astype(np.float32)
    anchor = np.array([1.52563191462, 1.62856739989, 3.88311640418],
                      np.float32)
    kw = dict(loc_scope=1.5, loc_bin_size=0.5, num_head_bin=9,
              get_xz_fine=True, get_y_by_bin=False, get_ry_fine=True)
    got = decode_bbox_target(torch.from_numpy(rois), torch.from_numpy(reg),
                             anchor_size=anchor, **kw).numpy()
    ref = np.asarray(jax_decode(jnp.asarray(rois), jnp.asarray(reg),
                                anchor_size=jnp.asarray(anchor), **kw))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("distance_based", [True, False])
def test_proposal_layer_rotated_nms_matches_tpu3d(distance_based):
    """The proposal layer with the rotated NMS (``NMS_TYPE: rotate``, and
    score-based proposals, which always take it) on identical scores,
    regression and points: the same keeps and scores, rois within 1e-5."""
    rng = np.random.default_rng(17 + distance_based)
    b, n = 2, 1024
    cfgs = [jax_fresh_cfg(), fresh_cfg()]
    for c in cfgs:
        c.RPN.NMS_TYPE = "rotate"
        c.TEST.RPN_DISTANCE_BASED_PROPOSE = distance_based
        c.TEST.RPN_PRE_NMS_TOP_N, c.TEST.RPN_POST_NMS_TOP_N = 512, 64
    scores = rng.normal(size=(b, n)).astype(np.float32)
    reg = rng.normal(scale=0.5, size=(b, n, 76)).astype(np.float32)
    xyz = rng.uniform([-30, -1, 0], [30, 3, 70],
                      size=(b, n, 3)).astype(np.float32)
    jr = jax.device_get(jax.jit(lambda s, r, x: jax_proposal_layer(
        s, r, x, cfgs[0], "TEST"))(scores, reg, xyz))
    tr = [t.numpy() for t in proposal_layer(
        torch.from_numpy(scores), torch.from_numpy(reg),
        torch.from_numpy(xyz), cfgs[1], "TEST")]
    np.testing.assert_array_equal(tr[2], jr[2])
    np.testing.assert_array_equal(tr[1], jr[1])
    np.testing.assert_allclose(tr[0], jr[0], rtol=1e-5, atol=1e-5)
    assert tr[2].sum() > 0
