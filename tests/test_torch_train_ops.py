"""The port's training pieces against tpu3d's on the CPU, one by one.

The same numpy inputs, made from a seed, go through tpu3d's function and
the port's. Tolerances, each with its reason:

- ``three_interpolate``'s backward: 1e-5 against ``jax.vjp`` of tpu3d's
  f32 gather path (f32 sums in another order); against the Pallas kernel
  in interpret mode, the bf16 grade of ``tests/test_ops.py`` (the kernel
  rounds features and rows to bf16).
- The fused gather-MLP-max-pool in training: out equal within 1e-5 and
  argmax equal to ``fused_mlp_pool_reference(pool="first")`` on inputs
  without ties; the six gradients within 1e-5 abs + 1e-5 rel of
  ``jax.grad`` of that f32 chain; against the Pallas kernels in interpret
  mode, the bf16 grade of ``tests/test_fused_sa.py``.
- Train-mode BatchNorm: within 1e-6 of the largest value (f32 sums in
  another order); the losses: 1e-6; the RPN labels equal, their targets
  within 1e-6.
- The proposal target layer: the core fed the uniforms of tpu3d's own key
  splits gives the same sampled ROI ids and boxes within 1e-5; the whole
  layer under a torch generator keeps the reference sampler's invariants.
- The optimizer: schedules within 1e-6 relative plus 1e-6 of the peak
  learning rate (tpu3d evaluates them in f32, where the cosine's tail
  loses digits, the port in f64); a 12-step trajectory within 1e-6
  relative plus 1e-6 of the tree's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_rpn import _port_cfg
from tpu3d.config import fresh_cfg as jax_fresh_cfg
from tpu3d.models import proposal_target as jax_pt
from tpu3d.models import train_functions as jax_tf
from tpu3d.models.pointnet2 import BatchNorm as JaxBatchNorm
from tpu3d.ops.fused_sa import (fused_gathered_mlp_pool as jax_fused,
                                fused_mlp_pool_reference)
from tpu3d.ops.interpolate import (_three_interpolate_pallas,
                                   three_interpolate as jax_interp)
from tpu3d.parallel import train_state as jax_ts
from tpu3d_torch.datasets import train_batch
from tpu3d_torch.models import proposal_target as pt
from tpu3d_torch.models import train_functions as tf
from tpu3d_torch.models.pointnet2 import BatchNorm
from tpu3d_torch.ops import fused_gathered_mlp_pool, three_interpolate
from tpu3d_torch.ops.fused_sa import fused_gathered_mlp_pool_train
from tpu3d_torch.ops.rotated_iou import boxes_iou3d
from tpu3d_torch.parallel import train_state as ts

T = torch.from_numpy


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------- kernels


def _interp_case(seed, B=2, N=256, M=264, C=128):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, M, 3)).astype(np.int32)
    w = rng.random((B, M, 3)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    g = rng.normal(size=(B, M, C)).astype(np.float32)
    return feats, idx, w, g


def _port_interp_grads(feats, idx, w, g):
    f, wt = T(feats).requires_grad_(), T(w).requires_grad_()
    out = three_interpolate(f, T(idx), wt)
    out.backward(T(g))
    return out.detach().numpy(), f.grad.numpy(), wt.grad.numpy()


def test_three_interpolate_backward_matches_f32_gather():
    """d_features and d_weight against jax.vjp of tpu3d's CPU gather path,
    within 1e-5."""
    feats, idx, w, g = _interp_case(0)
    out, df, dw = _port_interp_grads(feats, idx, w, g)
    jout, vjp = jax.vjp(lambda f, wt: jax_interp(f, jnp.asarray(idx), wt),
                        jnp.asarray(feats), jnp.asarray(w))
    jdf, jdw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out, _np(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(df, _np(jdf), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dw, _np(jdw), atol=1e-5, rtol=1e-5)


def test_three_interpolate_backward_matches_pallas_interpret():
    """Against jax.vjp of the Pallas kernel (interpret mode), at the bf16
    grade of tests/test_ops.py: max error under 0.1 (d_features) and 0.3
    (d_weight) of the largest value, mean under 5e-3."""
    feats, idx, w, g = _interp_case(1)
    _, df, dw = _port_interp_grads(feats, idx, w, g)
    _, vjp = jax.vjp(lambda f, wt: _three_interpolate_pallas(
        f, jnp.asarray(idx), wt, True), jnp.asarray(feats), jnp.asarray(w))
    jdf, jdw = vjp(jnp.asarray(g))
    for a, b, tol in ((df, jdf, 0.1), (dw, jdw, 0.3)):
        e = np.abs(a - _np(b)) / (np.abs(_np(b)).max() + 1e-3)
        assert e.max() < tol and e.mean() < 5e-3, (e.max(), e.mean())


def test_three_interpolate_skips_weight_gradient_unless_asked():
    """Constant weights (the FP levels') get no gradient, and the features
    still get theirs."""
    feats, idx, w, g = _interp_case(2, N=32, M=40, C=8)
    f = T(feats).requires_grad_()
    three_interpolate(f, T(idx), T(w)).backward(T(g))
    assert f.grad is not None and f.grad.abs().sum() > 0


def _fused_case(seed, shape, n=128, ties=False):
    B, M, S, C1, C2, C3 = shape
    rng = np.random.default_rng(seed)
    pre = rng.normal(size=(B, n, C1)).astype(np.float32)
    if ties:
        idx = rng.integers(0, n, size=(B, M, S)).astype(np.int32)
    else:  # distinct ids within each group: no two slots alike
        idx = np.stack([np.stack([rng.permutation(n)[:S] for _ in range(M)])
                        for _ in range(B)]).astype(np.int32)
    center = (0.5 * rng.normal(size=(B, M, C1))).astype(np.float32)
    w1 = (rng.normal(size=(C1, C2)) / np.sqrt(C1)).astype(np.float32)
    w2 = (rng.normal(size=(C2, C3)) / np.sqrt(C2)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=C2)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=C3)).astype(np.float32)
    g = rng.normal(size=(B, M, C3)).astype(np.float32)
    return (pre, idx, center, w1, b1, w2, b2), g


def _jax_ref_chain(idx):
    B, M, S = idx.shape

    def chain(pre, center, w1, b1, w2, b2):
        gath = jnp.take_along_axis(pre, jnp.asarray(idx).reshape(
            B, M * S)[..., None], axis=1).reshape(B, M, S, -1)
        return fused_mlp_pool_reference(gath - center[:, :, None, :], w1, b1,
                                        w2, b2, pool="first")

    return chain


def _port_fused_grads(args, g):
    pre, idx, center, w1, b1, w2, b2 = args
    leaves = [T(a).requires_grad_() for a in (pre, center, w1, b1, w2, b2)]
    out = fused_gathered_mlp_pool(leaves[0], T(idx), leaves[1], *leaves[2:])
    out.backward(T(g))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


FUSED_SHAPES = [(2, 4, 16, 128, 128, 128), (2, 2, 16, 128, 128, 256)]


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_train_forward_matches_first_argmax_reference(shape):
    """The training forward's out and first-argmax slot against
    fused_mlp_pool_reference(pool="first") on the gathered slab, f32, on
    groups of distinct points (no ties)."""
    args, _ = _fused_case(3, shape)
    out, arg, ppre = fused_gathered_mlp_pool_train(*(T(a) for a in args))
    pre, idx, center, w1, b1, w2, b2 = args
    jout = _jax_ref_chain(idx)(*(jnp.asarray(a) for a in
                                 (pre, center, w1, b1, w2, b2)))
    np.testing.assert_allclose(out.numpy(), _np(jout), atol=1e-5, rtol=1e-5)
    B, M, S = idx.shape
    gath = np.take_along_axis(pre, idx.reshape(B, M * S)[..., None],
                              axis=1).reshape(B, M, S, -1)
    a1 = np.maximum(np.maximum(gath - center[:, :, None], 0) @ w1 + b1, 0)
    x2 = a1 @ w2 + b2
    np.testing.assert_array_equal(arg.numpy(), np.argmax(np.maximum(x2, 0),
                                                         axis=2))
    np.testing.assert_allclose(
        ppre.numpy(), np.take_along_axis(x2, arg.numpy()[:, :, None].astype(
            np.int64), axis=2)[:, :, 0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_train_grads_match_reference_autodiff(shape):
    """All six gradients (d_pre, d_center, dW1, db1, dW2, db2) against
    jax.grad of the f32 reference chain with first-argmax pooling, within
    1e-5 abs + 1e-5 rel; ids repeat within groups here, so the pooled
    gradient must go to the first slot that reaches the max."""
    args, g = _fused_case(4, shape, ties=True)
    _, grads = _port_fused_grads(args, g)
    pre, idx, center, w1, b1, w2, b2 = args
    chain = _jax_ref_chain(idx)
    jgrads = jax.grad(lambda *a: jnp.sum(chain(*a) * jnp.asarray(g)),
                      argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (pre, center, w1, b1, w2, b2)))
    for name, a, b in zip(("d_pre", "d_center", "dW1", "db1", "dW2", "db2"),
                          grads, jgrads):
        np.testing.assert_allclose(a, _np(b), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def _bf16_exact_case(seed, shape, n=128):
    """Inputs whose whole forward chain is exact in bf16 (quarter-step
    points, sparse ±1 / ±0.5 weights, eighth-step biases), so that the
    Pallas kernel's bf16 rounding of x1 and x2 changes nothing and both
    sides pick the same first-argmax slots, exact ties included; only the
    backward's bf16 casts remain."""
    B, M, S, C1, C2, C3 = shape
    rng = np.random.default_rng(seed)

    def sparse(cin, cout, k, values):
        w = np.zeros((cin, cout), np.float32)
        for j in range(cout):
            w[rng.choice(cin, k, replace=False), j] = rng.choice(values, k)
        return w

    pre = (rng.integers(-8, 9, size=(B, n, C1)) / 4).astype(np.float32)
    idx = rng.integers(0, n, size=(B, M, S)).astype(np.int32)
    center = (rng.integers(-4, 5, size=(B, M, C1)) / 4).astype(np.float32)
    w1 = sparse(C1, C2, 4, [-1.0, -0.5, 0.5, 1.0])
    w2 = sparse(C2, C3, 2, [-1.0, 1.0])
    b1 = (rng.integers(-4, 5, size=C2) / 8).astype(np.float32)
    b2 = (rng.integers(-4, 5, size=C3) / 8).astype(np.float32)
    g = rng.normal(size=(B, M, C3)).astype(np.float32)
    return (pre, idx, center, w1, b1, w2, b2), g


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_train_matches_pallas_interpret(shape):
    """Out and the six gradients against tpu3d's fused_gathered_mlp_pool
    (train=True, interpret mode), at the bf16 grade of
    tests/test_fused_sa.py: out within 0.1, gradients' max error under
    0.08 and mean under 5e-3 of the largest value. On general inputs the
    kernel's bf16 rounding moves near-tied argmax slots, and with them
    whole gradient rows; the inputs here are exact in bf16 instead."""
    args, g = _bf16_exact_case(5, shape)
    out, grads = _port_fused_grads(args, g)
    pre, idx, center, w1, b1, w2, b2 = args

    def loss(pre, center, w1, b1, w2, b2):
        o = jax_fused(pre, jnp.asarray(idx), center, w1, b1, w2, b2,
                      train=True, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(g)), o

    (_, jout), jgrads = jax.value_and_grad(
        loss, argnums=tuple(range(6)), has_aux=True)(
        *(jnp.asarray(a) for a in (pre, center, w1, b1, w2, b2)))
    assert np.abs(out - _np(jout)).max() < 0.1
    for name, a, b in zip(("d_pre", "d_center", "dW1", "db1", "dW2", "db2"),
                          grads, jgrads):
        err = np.abs(a - _np(b)) / (np.abs(_np(b)).max() + 1e-3)
        assert err.max() < 0.08 and err.mean() < 5e-3, (name, err.max())


def test_fused_eval_unchanged_without_grad():
    """With no gradient wanted the eval form runs, and it equals the
    training form's output."""
    args, _ = _fused_case(6, FUSED_SHAPES[0])
    with torch.no_grad():
        ev = fused_gathered_mlp_pool(*(T(a) for a in args))
    tr = fused_gathered_mlp_pool_train(*(T(a) for a in args))[0]
    np.testing.assert_array_equal(ev.numpy(), tr.numpy())


# --------------------------------------------------------------- BatchNorm


def test_batchnorm_train_matches_flax():
    """Train-mode output and the updated running statistics (momentum 0.7,
    flax's convention, biased variance) against tpu3d's BatchNorm with
    mutable batch_stats, within 1e-6; eval mode after the update too."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 64, 16, 24)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 2, 24).astype(np.float32),
         "bias": rng.normal(size=24).astype(np.float32)}
    s = {"mean": rng.normal(size=24).astype(np.float32),
         "var": rng.uniform(0.5, 2, 24).astype(np.float32)}
    jy, mut = JaxBatchNorm().apply({"params": p, "batch_stats": s}, x,
                                   use_running_average=False, momentum=0.7,
                                   mutable=["batch_stats"])
    bn = BatchNorm(24)
    bn.load_state_dict({k: T(v) for k, v in {**p, **s}.items()})
    y = bn(T(x), True, 0.7)
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), rtol=1e-6,
                               atol=1e-6 * np.abs(_np(jy)).max())
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   _np(mut["batch_stats"][k]), atol=1e-6,
                                   rtol=1e-6)
    jev = JaxBatchNorm().apply({"params": p, "batch_stats":
                                mut["batch_stats"]}, x,
                               use_running_average=True)
    np.testing.assert_allclose(bn(T(x)).detach().numpy(), _np(jev),
                               rtol=1e-6, atol=1e-6 * np.abs(_np(jev)).max())


# ------------------------------------------------------------------ losses


def _loss_case(loss_cls):
    jcfg = jax_fresh_cfg()
    jcfg.RPN.LOSS_CLS = loss_cls
    jcfg.RCNN.ENABLED = True
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(8)
    batch = train_batch(2, 512, 8)
    n_reg = 76
    rpn_cls = rng.normal(size=(2, 512, 1)).astype(np.float32)
    rpn_reg = rng.normal(size=(2, 512, n_reg)).astype(np.float32)
    R = 40
    ret = {"rcnn_cls": rng.normal(size=(R, 1)).astype(np.float32),
           "rcnn_reg": rng.normal(size=(R, 46)).astype(np.float32),
           "cls_label": rng.integers(-1, 2, R).astype(np.int32),
           "reg_valid_mask": rng.integers(0, 2, R).astype(np.int32),
           "roi_boxes3d": rng.normal(size=(R, 7)).astype(np.float32),
           "gt_of_rois": (rng.normal(size=(R, 7)) * [0.5, 0.2, 0.5, 0.1,
                                                     0.1, 0.3, 1.0]
                          + [0, 0, 0, 1.5, 1.6, 3.9, 0]).astype(np.float32)}
    ret["gt_of_rois"][:, 6] = rng.uniform(-4, 4, R)
    return jcfg, cfg, batch, rpn_cls, rpn_reg, ret


def _assert_tb(tb, jtb):
    assert set(tb) == set(jtb)
    for k in jtb:
        np.testing.assert_allclose(np.asarray(tb[k].detach(), np.float64),
                                   np.asarray(jtb[k], np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_rpn_labels_match():
    """generate_rpn_labels_device on a batch of planted-cluster scenes with
    padded gt boxes: cls labels equal, reg labels within 1e-6."""
    batch = train_batch(3, 2048, 9)
    pts, gt = batch["pts_input"], batch["gt_boxes3d"]
    jcls, jreg = jax.vmap(jax_tf.generate_rpn_labels_device)(pts, gt)
    cls, reg = tf.generate_rpn_labels_device(T(pts), T(gt))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(jcls))
    np.testing.assert_allclose(reg.numpy(), _np(jreg), atol=1e-6, rtol=1e-6)
    assert (cls.numpy() == 1).sum() > 100 and (cls.numpy() == -1).any()


@pytest.mark.parametrize("loss_cls", ["SigmoidFocalLoss",
                                      "BinaryCrossEntropy", "DiceLoss"])
def test_rpn_loss_matches(loss_cls):
    """get_rpn_loss on identical inputs: every tb entry within 1e-6."""
    jcfg, cfg, batch, rpn_cls, rpn_reg, _ = _loss_case(loss_cls)
    cls, reg = jax.vmap(jax_tf.generate_rpn_labels_device)(
        batch["pts_input"], batch["gt_boxes3d"])
    _, jtb = jax_tf.get_rpn_loss(jcfg, rpn_cls, rpn_reg, cls, reg)
    _, tb = tf.get_rpn_loss(cfg, T(rpn_cls), T(rpn_reg),
                            T(np.asarray(cls)), T(_np(reg)))
    _assert_tb(tb, jtb)


def test_rcnn_and_model_loss_match():
    """get_rcnn_loss and the joint model_loss on identical inputs: every
    tb entry within 1e-6."""
    jcfg, cfg, batch, rpn_cls, rpn_reg, ret = _loss_case("SigmoidFocalLoss")
    _, jtb = jax_tf.get_rcnn_loss(jcfg, {k: jnp.asarray(v)
                                         for k, v in ret.items()})
    _, tb = tf.get_rcnn_loss(cfg, {k: T(v) for k, v in ret.items()})
    _assert_tb(tb, jtb)
    cls, reg = jax.vmap(jax_tf.generate_rpn_labels_device)(
        batch["pts_input"], batch["gt_boxes3d"])
    data = {"rpn_cls_label": np.asarray(cls), "rpn_reg_label": _np(reg)}
    out = dict(ret, rpn_cls=rpn_cls, rpn_reg=rpn_reg)
    jloss, jtb = jax_tf.model_loss(jcfg, {k: jnp.asarray(v)
                                          for k, v in out.items()}, data)
    loss, tb = tf.model_loss(cfg, {k: T(v) for k, v in out.items()},
                             {k: T(v) for k, v in data.items()})
    _assert_tb(tb, jtb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


# -------------------------------------------------------- proposal target


def _sampler_inputs(case, rng, m=48):
    ov = rng.uniform(0, 1, m).astype(np.float32)
    if case == "fg_only":
        ov = rng.uniform(0.6, 1, m).astype(np.float32)
    elif case == "no_fg":
        ov = rng.uniform(0, 0.5, m).astype(np.float32)
    elif case == "hard_only":
        ov = np.concatenate([rng.uniform(0.6, 1, 5),
                             rng.uniform(0.1, 0.4, m - 5)]).astype(np.float32)
    valid = rng.random(m) > 0.2
    return ov, valid


def _jax_sampler_uniforms(key, ov, valid, c):
    """The uniforms that make the port's sampler draw what tpu3d's
    _sample_roi_indices draws from ``key``: its own ranking uniforms, and
    each randint r over n as (r + 0.5) / n."""
    R = int(c.ROI_PER_IMAGE)
    fg_thresh = min(c.REG_FG_THRESH, c.CLS_FG_THRESH)
    n_fg = int(((ov >= fg_thresh) & valid).sum())
    n_easy = int(((ov < c.CLS_BG_THRESH_LO) & valid).sum())
    n_hard = int(((ov >= c.CLS_BG_THRESH_LO) & (ov < c.CLS_BG_THRESH)
                  & valid).sum())
    k_perm, k_fill, k_hard, k_easy = jax.random.split(key, 4)

    def as_u(k, n):
        n = max(n, 1)
        return ((np.asarray(jax.random.randint(k, (R,), 0, n)) + 0.5)
                / n).astype(np.float32)

    return (_np(jax.random.uniform(k_perm, (len(ov),))),
            as_u(k_fill, n_fg), as_u(k_hard, n_hard), as_u(k_easy, n_easy))


@pytest.mark.parametrize("case", ["mixed", "fg_only", "no_fg", "hard_only"])
def test_sample_roi_indices_match_on_mirrored_draws(case):
    """The sampler fed the uniforms of tpu3d's own key splits: the same
    sampled ROI ids and fg flags."""
    c = jax_fresh_cfg().RCNN
    for seed in range(3):
        ov, valid = _sampler_inputs(case, np.random.default_rng(seed))
        key = jax.random.PRNGKey(seed)
        jidx, jfg = jax_pt._sample_roi_indices(key, jnp.asarray(ov),
                                               jnp.asarray(valid), c)
        u = _jax_sampler_uniforms(key, ov, valid, c)
        idx, fg = pt.sample_roi_indices(T(ov), T(valid), c, *map(T, u))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(fg.numpy(), np.asarray(jfg))


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = rng.uniform(-10, 10, n)
    b[:, 1] = rng.uniform(0.8, 1.4, n)
    b[:, 2] = rng.uniform(10, 40, n)
    b[:, 3:6] = [1.5, 1.6, 3.9]
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _jitter_uniforms(key, m, t, method):
    """Each candidate's draws in tpu3d's _aug_rois_by_noise from ``key``:
    (keep (m, t), jitter, range or None, normal or None)."""
    keys = jax.random.split(key, m * t * 2).reshape(m * t, 2, 2)

    def one(k2):
        keep = jax.random.uniform(k2[0])
        if method == "multiple":
            k0, k1, k2_, k3 = jax.random.split(k2[1], 4)
            r = jax.random.randint(k0, (), 0, 5)
            u = jnp.concatenate([jax.random.uniform(k1, (3,)),
                                 jax.random.uniform(k2_, (3,)),
                                 jax.random.uniform(k3, (1,))])
            return keep, u, (r + 0.5) / 5.0, jnp.zeros(6)
        if method == "single":
            k1, k2_, k3 = jax.random.split(k2[1], 3)
            u = jnp.concatenate([jax.random.uniform(k1, (3,)),
                                 jax.random.uniform(k2_, (3,)),
                                 jax.random.uniform(k3, (1,))])
            return keep, u, jnp.zeros(()), jnp.zeros(6)
        k1, k2_ = jax.random.split(k2[1])
        return (keep, jax.random.uniform(k2_, (1,)), jnp.zeros(()),
                jax.random.normal(k1, (6,)))

    keep, u, rng_u, normal = (_np(a) for a in jax.vmap(one)(keys))
    shape = (m, t)
    return (keep.reshape(shape), u.reshape(*shape, -1),
            rng_u.reshape(shape) if method == "multiple" else None,
            normal.reshape(*shape, 6) if method == "normal" else None)


@pytest.mark.parametrize("method", ["multiple", "single", "normal"])
def test_jitter_matches_on_mirrored_draws(method):
    """The jitter (ROI_FG_AUG_TIMES candidates, the first above the IoU
    threshold) fed the draws of tpu3d's key splits: boxes and IoUs within
    1e-5."""
    rng = np.random.default_rng(10)
    m, t = 24, 10
    gts = _boxes(rng, m)
    rois = gts + (rng.normal(size=(m, 7)) * [0.4, 0.05, 0.4, 0.1, 0.1, 0.2,
                                              0.2]).astype(np.float32)
    iou_src = rng.uniform(0, 1, m).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jbox, jiou = jax_pt._aug_rois_by_noise(key, jnp.asarray(rois),
                                           jnp.asarray(gts),
                                           jnp.asarray(iou_src), 0.55, t,
                                           method)
    keep, u, rng_u, normal = _jitter_uniforms(key, m, t, method)
    box, iou = pt.aug_rois_by_noise(
        T(rois), T(gts), T(iou_src), 0.55, method, T(keep), T(u),
        None if rng_u is None else T(rng_u),
        None if normal is None else T(normal))
    np.testing.assert_allclose(box.numpy(), _np(jbox), atol=1e-5)
    np.testing.assert_allclose(iou.numpy(), _np(jiou), atol=1e-5)


def test_roi_augmentation_matches_on_mirrored_draws():
    """Rotation, scaling and flip fed tpu3d's uniforms: points, rois and
    gt boxes within 1e-5."""
    rng = np.random.default_rng(11)
    m, k = 16, 32
    rois, gts = _boxes(rng, m), _boxes(rng, m)
    pts = (rng.normal(size=(m, k, 3)) * 2 + rois[:, None, 0:3]).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    jp, jr, jg = jax_pt._roi_data_augmentation(
        key, jnp.asarray(pts), jnp.asarray(rois), jnp.asarray(gts), 18.0)
    k_rot, k_scale, k_flip = jax.random.split(key, 3)
    u = [_np(jax.random.uniform(kk, (m,))) for kk in (k_rot, k_scale,
                                                       k_flip)]
    p, r, g = pt.roi_data_augmentation(T(pts), T(rois), T(gts), 18.0,
                                       *map(T, u))
    for a, b in ((p, jp), (r, jr), (g, jg)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-5)


def test_canonicalize_targets_match():
    """canonicalize_rcnn_targets on identical inputs: points and boxes
    within 1e-6, labels and masks equal."""
    rng = np.random.default_rng(12)
    B, R, K = 2, 12, 16
    rois = np.stack([_boxes(rng, R) for _ in range(B)])
    gts = np.stack([_boxes(rng, R) for _ in range(B)])
    pts = rng.normal(size=(B, R, K, 3)).astype(np.float32) * 3
    iou = rng.uniform(0, 1, (B, R)).astype(np.float32)
    empty = rng.random((B, R)) > 0.8
    c = jax_fresh_cfg().RCNN
    jout = jax_pt.canonicalize_rcnn_targets(
        jnp.asarray(pts), jnp.asarray(rois), jnp.asarray(gts),
        jnp.asarray(iou), jnp.asarray(empty), c)
    out = pt.canonicalize_rcnn_targets(T(pts), T(rois), T(gts), T(iou),
                                       T(empty), c)
    for a, b in zip(out[:2], jout[:2]):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-6, rtol=1e-6)
    for a, b in zip(out[2:], jout[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _scene(seed, n_pts=256, n_rois=24, n_gt=3):
    """Proposals straddling the fg / hard-bg / easy-bg IoU bands around a
    few gt boxes, with points and features (as the reference-differential
    test makes them)."""
    rng = np.random.default_rng(seed)
    gts = _boxes(rng, n_gt)
    rois = np.zeros((n_rois, 7), np.float32)
    for i in range(n_rois):
        g = gts[i % n_gt].copy()
        mag = [0.1, 0.4, 0.9, 2.5, 6.0][i % 5]
        g[0] += rng.normal() * mag
        g[2] += rng.normal() * mag
        g[6] += rng.normal() * 0.1
        rois[i] = g
    pts = np.zeros((n_pts, 3), np.float32)
    for i in range(n_pts // 2):
        g = gts[i % n_gt]
        pts[i] = g[0:3] + rng.uniform(-0.5, 0.5, 3) * g[[5, 3, 4]] * 0.4
        pts[i, 1] -= g[3] * 0.5
    pts[n_pts // 2:] = rng.uniform([-20, -1, 0], [20, 3, 60],
                                   (n_pts - n_pts // 2, 3))
    feats = rng.normal(size=(n_pts, 4)).astype(np.float32)
    return rois, gts, pts, feats


def test_layer_keeps_reference_invariants():
    """The whole layer under a torch generator, jitter and augmentation
    off: fg count min(fg_per_image, |fg pool|), the fg block from the fg
    pool, the bg block split HARD_BG_RATIO between the hard and the easy
    pool, each sampled ROI's IoU carried over, labels by the thresholds."""
    jcfg = jax_fresh_cfg()
    jcfg.RCNN.ROI_FG_AUG_TIMES = 0
    cfg = _port_cfg(jcfg)
    c = cfg.RCNN
    gen = torch.Generator().manual_seed(0)
    for seed in range(3):
        rois, gts, pts, feats = _scene(100 + seed)
        out = pt.proposal_target_layer(
            gen, T(rois[None]), torch.ones(1, len(rois), dtype=torch.bool),
            T(gts[None]), T(pts[None]), T(feats[None]), cfg, aug_data=False)
        s_rois, s_iou = out["roi_boxes3d"].numpy(), out["gt_iou"].numpy()
        iou = boxes_iou3d(T(rois), T(gts)).numpy()
        max_ov = iou.max(axis=1)
        fg_thresh = min(c.REG_FG_THRESH, c.CLS_FG_THRESH)
        fg = np.nonzero(max_ov >= fg_thresh)[0]
        easy = np.nonzero(max_ov < c.CLS_BG_THRESH_LO)[0]
        hard = np.nonzero((max_ov >= c.CLS_BG_THRESH_LO)
                          & (max_ov < c.CLS_BG_THRESH))[0]
        R = c.ROI_PER_IMAGE
        fg_take = (min(int(np.round(c.FG_RATIO * R)), len(fg))
                   if len(easy) + len(hard) else R)
        d = np.linalg.norm(s_rois[:, None, :] - rois[None, :, :], axis=2)
        src = d.argmin(axis=1)
        assert d.min(axis=1).max() < 1e-5
        assert int((max_ov[src] >= fg_thresh).sum()) == fg_take
        assert set(src[:fg_take]) <= set(fg.tolist())
        if len(hard) and len(easy):
            hard_cnt = int((R - fg_take) * c.HARD_BG_RATIO)
            assert set(src[fg_take:fg_take + hard_cnt]) <= set(hard.tolist())
            assert set(src[fg_take + hard_cnt:]) <= set(easy.tolist())
        np.testing.assert_allclose(s_iou, max_ov[src], atol=1e-5)
        cls = out["cls_label"].numpy()
        np.testing.assert_array_equal(cls == 1, s_iou > c.CLS_FG_THRESH)
        assert out["sampled_pts"].shape == (R, c.NUM_POINTS, 3)


def test_layer_runs_with_jitter_and_augmentation():
    """default.yaml's layer (10 jitter candidates, augmentation on) on two
    scenes with padded gt: fixed shapes, finite values, labels in
    {-1, 0, 1}, reg targets only where the IoU passes REG_FG_THRESH."""
    cfg = _port_cfg(jax_fresh_cfg())
    c = cfg.RCNN
    scenes = [_scene(200 + s) for s in range(2)]
    rois = T(np.stack([s[0] for s in scenes]))
    gts = np.zeros((2, 5, 7), np.float32)
    gts[:, :3] = np.stack([s[1] for s in scenes])
    out = pt.proposal_target_layer(
        torch.Generator().manual_seed(1), rois,
        torch.ones(rois.shape[:2], dtype=torch.bool), T(gts),
        T(np.stack([s[2] for s in scenes])),
        T(np.stack([s[3] for s in scenes])), cfg)
    R = 2 * c.ROI_PER_IMAGE
    assert out["sampled_pts"].shape == (R, c.NUM_POINTS, 3)
    assert out["pts_feature"].shape == (R, c.NUM_POINTS, 4)
    for v in out.values():
        if v.is_floating_point():
            assert torch.isfinite(v).all()
    assert set(out["cls_label"].tolist()) <= {-1, 0, 1}
    reg = out["reg_valid_mask"].numpy() == 1
    assert (out["gt_iou"].numpy()[reg] > c.REG_FG_THRESH).all()
    assert reg.any() and (out["cls_label"].numpy() == 0).any()


# --------------------------------------------------------------- optimizer


def _opt_cfg(optimizer):
    jcfg = jax_fresh_cfg()
    jcfg.TRAIN.OPTIMIZER = optimizer
    jcfg.TRAIN.WEIGHT_DECAY = 0.001
    jcfg.TRAIN.LR = 0.01
    jcfg.TRAIN.DECAY_STEP_LIST = [1, 2]
    jcfg.TRAIN.WARMUP_EPOCH = 1
    return jcfg, _port_cfg(jcfg)


@pytest.mark.parametrize("optimizer", ["adam_onecycle", "adam", "sgd"])
@pytest.mark.parametrize("spe,epochs", [(4, 3), (1, 1), (2, 1), (7, 5)])
def test_schedules_match(optimizer, spe, epochs):
    """lr and b1 at steps 0..T+2 equal to tpu3d's within 1e-6 relative plus
    1e-6 of the peak, tiny step counts included."""
    jcfg, cfg = _opt_cfg(optimizer)
    jlr = jax_ts.make_lr_schedule(jcfg, spe, epochs)
    jmom = jax_ts.make_momentum_schedule(jcfg, spe, epochs)
    lr = ts.make_lr_schedule(cfg, spe, epochs)
    mom = ts.make_momentum_schedule(cfg, spe, epochs)
    for step in range(spe * epochs + 3):
        np.testing.assert_allclose(lr(step), float(jlr(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-6 * cfg.TRAIN.LR,
                                   err_msg=f"lr at {step}")
        np.testing.assert_allclose(mom(step), float(jmom(jnp.int32(step))),
                                   rtol=1e-6, err_msg=f"b1 at {step}")


@pytest.mark.parametrize("optimizer", ["adam_onecycle", "adam", "sgd"])
def test_optimizer_trajectory_matches(optimizer):
    """12 steps of clip + update on a small tree with fixed gradients (a
    third of them past the clip norm), against make_optimizer +
    optax.apply_updates: the parameters within 1e-6 relative plus 1e-6 of
    the tree's largest value after every step."""
    jcfg, cfg = _opt_cfg(optimizer)
    rng = np.random.default_rng(13)
    init = {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=5).astype(np.float32)}
    steps = 12
    grads = [{k: (rng.normal(size=v.shape) * (3.0 if i % 3 == 0 else 0.1)
                  ).astype(np.float32) for k, v in init.items()}
             for i in range(steps)]
    tx = jax_ts.make_optimizer(jcfg, 4, 3)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jparams)
    params = {k: torch.nn.Parameter(T(v.copy())) for k, v in init.items()}
    opt = ts.Optimizer(cfg, params.values(), 4, 3)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = T(g[k].copy())
        norm = opt.step(i)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        top = max(np.abs(_np(v)).max() for v in jparams.values())
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), _np(jparams[k]),
                                       rtol=1e-6, atol=1e-6 * top,
                                       err_msg=f"{k} after step {i}")


def test_bn_momentum_schedule_matches():
    """bn_momentum_at_epoch equal to tpu3d's over the decay steps."""
    jcfg = jax_fresh_cfg()
    jcfg.TRAIN.BN_DECAY_STEP_LIST = [2, 5, 9]
    cfg = _port_cfg(jcfg)
    for epoch in range(12):
        assert (ts.bn_momentum_at_epoch(cfg, epoch)
                == jax_ts.bn_momentum_at_epoch(jcfg, epoch))
