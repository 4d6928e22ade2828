"""The ops' remaining public functions and ``make_optimizer`` against
tpu3d's on the CPU, on the same seeded numpy inputs.

Indices and keep masks must be equal; floats agree within 1e-6 (absolute
and relative). The chains of the two ``*_reference`` functions run in
float64 on both sides, where f32 matmuls summed in another order by XLA
and by PyTorch would differ by more; the BatchNorm chain in training runs
in float32, as tpu3d's reference normalizes in float32 whatever its
input. The numpy oracles are copies, so their outputs are equal arrays.
``make_optimizer``'s parameters after three updates of seeded gradients
within 1e-6 relative plus 1e-6 of the largest
parameter, as ``test_torch_train.py`` holds the optimizer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from test_torch_rpn import _port_cfg
from test_torch_train import _x64
from tpu3d import ops as jops
from tpu3d.ops import fused_sa as jax_fused_sa
from tpu3d.parallel.train_state import make_optimizer as jax_make_optimizer
from tpu3d_torch import ops
from tpu3d_torch.parallel import make_optimizer

T = torch.from_numpy
TOL = dict(rtol=1e-6, atol=1e-6)


def _boxes(n, seed):
    """n BEV5 boxes in clusters (so that many overlap), their scores and a
    validity mask, f32."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 20, size=(n // 4 + 1, 2))
    boxes = np.concatenate(
        [centers[rng.integers(0, len(centers), n)]
         + rng.normal(scale=0.3, size=(n, 2)),
         rng.uniform(1.0, 4.0, size=(n, 2)), rng.uniform(-3, 3, size=(n, 1))],
        axis=1).astype(np.float32)
    return (boxes, rng.normal(size=n).astype(np.float32),
            rng.uniform(size=n) > 0.1)


@pytest.mark.parametrize("name", ["nms_rotated", "nms_normal"])
def test_nms_forms_match(name):
    """tpu3d's nms_rotated / nms_normal: equal indices and keep mask, at a
    budget that the keeps fill and at one they do not."""
    boxes, scores, valid = _boxes(200, 7)
    for max_out in (16, 200):
        idx, mask = getattr(ops, name)(T(boxes), T(scores), 0.3, max_out,
                                       T(valid))
        j_idx, j_mask = getattr(jops, name)(
            jnp.asarray(boxes), jnp.asarray(scores), 0.3, max_out,
            jnp.asarray(valid))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        assert 0 < int(mask.sum()) <= max_out
    assert int(mask.sum()) < valid.sum()  # some boxes suppressed


@pytest.mark.parametrize("rotated", [False, True])
def test_nms_streaming_sorted_matches(rotated):
    """tpu3d's streaming walk on score-sorted boxes: equal positions and
    mask, and the port's own blocked walk gives them too."""
    boxes, scores, valid = _boxes(120, 8)
    order = np.argsort(-scores, kind="stable")
    sb, sv = boxes[order], valid[order]
    for max_out in (10, 120):
        pos, mask = ops.nms_streaming_sorted(T(sb), T(sv), 0.3, max_out,
                                             rotated=rotated)
        j_pos, j_mask = jax.jit(
            lambda b, v: jops.nms_streaming_sorted(b, v, 0.3, max_out,
                                                   rotated=rotated))(
            jnp.asarray(sb), jnp.asarray(sv))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
        b_pos, b_mask = ops.nms_blocked_sorted(T(sb), T(sv), 0.3, max_out,
                                               rotated=rotated, block=32)
        np.testing.assert_array_equal(mask.numpy(), b_mask.numpy())
        np.testing.assert_array_equal(pos.numpy(), b_pos.numpy())


@pytest.mark.parametrize("rotated", [False, True])
def test_nms_numpy_matches(rotated):
    """The host oracle: the same kept indices as tpu3d's."""
    boxes, scores, valid = _boxes(150, 9)
    got = ops.nms_numpy(boxes, scores, 0.3, valid=valid, rotated=rotated)
    want = jops.nms_numpy(boxes, scores, 0.3, valid=valid, rotated=rotated)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < valid.sum()


def _clouds(seed, b=2, m=40, n=300):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, size=(b, m, 3)).astype(np.float32),
            rng.uniform(-2, 2, size=(b, n, 3)).astype(np.float32))


def test_ball_query_numpy_matches():
    """tpu3d's host ball query: equal ids, with some centers short of
    nsample hits (the fill) and one with none (zeros)."""
    centers, pts = _clouds(10)
    centers[0, 0] = 50.0  # no point within the radius
    got = ops.ball_query_numpy(centers, pts, 0.6, 16)
    want = jops.ball_query_numpy(centers, pts, 0.6, 16)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 0] == 0).all()
    assert (got[..., -1] == got[..., 0]).any()  # a filled row


def test_three_nn_numpy_and_nn_dist_match():
    """tpu3d's host 3-NN (equal ids and distances) and nn_dist_from_idx on
    its ids (within 1e-6), which also equals the oracle's distances."""
    unknown, known = _clouds(11)
    dist, idx = ops.three_nn_numpy(unknown, known)
    j_dist, j_idx = jops.three_nn_numpy(unknown, known)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(dist, j_dist)
    got = ops.nn_dist_from_idx(T(unknown), T(known), T(idx)).numpy()
    want = np.asarray(jops.nn_dist_from_idx(
        jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(idx)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, dist, rtol=1e-6, atol=1e-6)


def test_nn_dist_from_idx_is_differentiable():
    """Its gradient in the queries is the unit vector from each pick,
    summed over the three."""
    unknown, known = _clouds(12, m=8, n=30)
    _, idx = ops.three_nn_numpy(unknown, known)
    u = T(unknown.astype(np.float64)).requires_grad_()
    k = T(known.astype(np.float64))
    ops.nn_dist_from_idx(u, k, T(idx)).sum().backward()
    picked = known.astype(np.float64)[np.arange(2)[:, None, None], idx]
    diff = unknown.astype(np.float64)[:, :, None] - picked
    want = (diff / np.linalg.norm(diff, axis=-1, keepdims=True)).sum(2)
    np.testing.assert_allclose(u.grad.numpy(), want, rtol=1e-9, atol=1e-12)


def test_furthest_point_sample_numpy_matches():
    """tpu3d's host FPS: equal picks."""
    _, pts = _clouds(13, n=500)
    np.testing.assert_array_equal(
        ops.furthest_point_sample_numpy(pts, 64),
        jops.furthest_point_sample_numpy(pts, 64))


def test_bev_corners_match():
    """bev_corners_from_boxes3d and corners_from_boxes3d on (B, M, 7)
    boxes: within 1e-6 of tpu3d's."""
    rng = np.random.default_rng(14)
    boxes = np.concatenate([
        rng.uniform(-20, 20, size=(2, 9, 3)), rng.uniform(1, 4, size=(2, 9, 3)),
        rng.uniform(-3.2, 3.2, size=(2, 9, 1))], -1).astype(np.float32)
    for name, shape in (("bev_corners_from_boxes3d", (2, 9, 4, 2)),
                        ("corners_from_boxes3d", (2, 9, 8, 3))):
        got = getattr(ops, name)(T(boxes)).numpy()
        want = np.asarray(getattr(jops, name)(jnp.asarray(boxes)))
        assert got.shape == shape
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


def _slab(seed, bn):
    rng = np.random.default_rng(seed)
    c1, c2, c3 = 16, 24, 32
    x0 = rng.normal(size=(2, 5, 8, c1))
    w1 = rng.normal(scale=0.3, size=(c1, c2))
    w2 = rng.normal(scale=0.3, size=(c2, c3))
    if not bn:
        return x0, w1, rng.normal(size=c2), w2, rng.normal(size=c3)
    gammas = [rng.uniform(0.5, 1.5, size=c) for c in (c1, c2, c3)]
    betas = [rng.normal(scale=0.2, size=c) for c in (c1, c2, c3)]
    stats = [(rng.normal(scale=0.2, size=c), rng.uniform(0.5, 2.0, size=c))
             for c in (c1, c2, c3)]
    return x0, w1, w2, gammas, betas, stats


@pytest.mark.parametrize("pool", ["max", "first"])
def test_fused_mlp_pool_reference_matches(pool):
    """The no-BN chain's oracle: the pooled values within 1e-6 of tpu3d's,
    and under "first" the gradient of x0 on the first argmax alone, as
    tpu3d's routes it."""
    arrays = _slab(15, bn=False)
    with _x64():
        want, vjp = jax.vjp(lambda x: jax_fused_sa.fused_mlp_pool_reference(
            x, *[jnp.asarray(a) for a in arrays[1:]], pool=pool),
            jnp.asarray(arrays[0]))
        grad = np.random.default_rng(16).normal(size=want.shape)
        (want_dx,) = vjp(jnp.asarray(grad))
    x0 = T(arrays[0]).requires_grad_()
    got = ops.fused_mlp_pool_reference(x0, *[T(a) for a in arrays[1:]],
                                       pool=pool)
    got.backward(T(grad))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(x0.grad.numpy(), np.asarray(want_dx), **TOL)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_fused_bn_mlp_pool_reference_matches(mode):
    """The BatchNorm chain's oracle: in training the pooled values and the
    three layers' batch means and variances, at eval the pooled values
    under running statistics, within 1e-6 of tpu3d's."""
    x0, w1, w2, gammas, betas, stats = _slab(17, bn=True)
    if mode == "train":
        # tpu3d's reference normalizes in float32 whatever the input's
        # type, so both sides take float32 here
        x0, w1, w2 = (a.astype(np.float32) for a in (x0, w1, w2))
        gammas = [g.astype(np.float32) for g in gammas]
        betas = [b.astype(np.float32) for b in betas]
    with _x64():
        want = jax.device_get(jax_fused_sa.fused_bn_mlp_pool_reference(
            jnp.asarray(x0), jnp.asarray(w1), jnp.asarray(w2),
            [jnp.asarray(g) for g in gammas], [jnp.asarray(b) for b in betas],
            **({} if mode == "train" else {"stats": [
                (jnp.asarray(m), jnp.asarray(v)) for m, v in stats]})))
    got = ops.fused_bn_mlp_pool_reference(
        T(x0), T(w1), T(w2), [T(g) for g in gammas], [T(b) for b in betas],
        **({} if mode == "train" else {"stats": [
            (T(m), T(v)) for m, v in stats]}))
    if mode == "eval":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for ours, ref in zip(got[1], want[1]):
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("optimizer", ["adam_onecycle", "adam", "sgd"])
def test_make_optimizer_follows_optax(optimizer):
    """Three updates of the same seeded gradients through the port's
    make_optimizer (reading the schedules at counts 0, 1, 2) and tpu3d's
    optax chain: every parameter within 1e-6 relative plus 1e-6 of the
    largest, and moved; the first gradient above the clip norm, so the
    clip acts."""
    jcfg = _tiny_cfg(rcnn=True, points=1024)
    jcfg.TRAIN.OPTIMIZER = optimizer
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(18)
    shapes = {"a": (6, 5), "b": (5,), "c": (3, 4, 2)}
    start = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (40.0 if i == 0 else 0.5)).astype(
        np.float32) for k, s in shapes.items()} for i in range(3)]
    assert np.sqrt(sum((g ** 2).sum() for g in grads[0].values())) > \
        cfg.TRAIN.GRAD_NORM_CLIP

    params = {k: torch.nn.Parameter(T(v.copy())) for k, v in start.items()}
    opt = make_optimizer(cfg, 10, 2, params.values())
    for count, g in enumerate(grads):
        for k, p in params.items():
            p.grad = T(g[k].copy())
        opt.step(count)

    tx = jax_make_optimizer(jcfg, 10, 2)
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    state = tx.init(jparams)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    top = max(np.abs(np.asarray(v)).max() for v in jparams.values())
    for k, v in jparams.items():
        ours = params[k].detach().numpy()
        np.testing.assert_allclose(ours, np.asarray(v), rtol=1e-6,
                                   atol=1e-6 * top, err_msg=k)
        assert not np.array_equal(ours, start[k]), k
