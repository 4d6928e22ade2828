"""The BatchNorm SA chain's training form in the port against tpu3d on the
CPU: ``fused_bn_mlp_pool`` with batch statistics (the plain version of
kernel 9's training form, and the kernels' own algorithm run through their
plain pieces), an RCNN level with BatchNorm in training, and default.yaml
with ``RCNN.USE_BN: true`` at cut depth through a joint and an rcnn-mode
train step.

Inputs are numpy arrays, weights carried over with ``params_from_jax``.
Tolerances, each with its reason:

- the op against tpu3d's f32 reference ``fused_bn_mlp_pool_reference``
  (``pool="first"``, the kernels' tie rule): the pooled output, the three
  means and variances and the gradients of all five inputs within 1e-5 of
  each one's largest value (f32 sums in another order in XLA and in
  PyTorch; the reference computes its statistics in f32 even on f64
  inputs, so x64 JAX is no tighter here: the f64 comparison is the RCNN's,
  below, through flax's BatchNorm). The kernels' algorithm (three statistics passes, the final
  pass, layer 2's reductions from the small tensors and three backward
  waves, each in its plain piece) is held to the same bounds; its
  statistics are summed in f64, so they differ from the reference's f32
  sums by the f32 rounding alone;
- against tpu3d's seven Pallas kernels in interpret mode, which round every
  layer's output to bf16: the bf16 grade of tests/test_fused_sa.py (pooled
  output within 0.1 absolute and 0.01 mean, statistics within its 2e-3 /
  2e-2), the port routed by the TPU kernels' own argmax (rounding to bf16
  ties or swaps near-equal maxima, which moves a channel's whole gradient
  to another slot), layer 2's gradients within the 0.05 of their largest
  value that tpu3d's own kernels meet against their reference, those behind
  layer 1 within 0.4 of it and 0.03 on average: the TPU kernels' bf16 x1
  (2^-8 relative) flips layer-1 ReLU masks near 0 and moves the layer-1 and
  layer-0 BatchNorm reductions, sums of many terms of both signs (measured
  at most 0.357, on dW1; without the routing dW2 alone is 0.62 off);
- an RCNN level in training on the CPU, before and after the route change
  (the SharedMLP with batch statistics, then the plain version of the
  fused op): output and running statistics equal to the bit (the same
  operations); the gradients within 1e-4 of each one's largest value (the
  SharedMLP's max splits a tie's gradient between equal slots, the fused
  op's goes to the first, so autograd sums the same contributions in
  another order, and BatchNorm's backward subtracts their means: measured
  2.8e-7 of 1.4e-2, 2e-5 of the largest value);
- the train steps, both packages on the same proposal targets (tpu3d's
  layer under a fixed key; each package's generator would draw its own
  ROIs): the loss terms within 1e-3 relative, the RCNN's running
  statistics after the step within 1e-3 of each one's largest value (XLA
  sums a batch statistic's 131072 f32 terms on the CPU with some 1e-5 of
  relative error, which the later layers amplify: measured at most 4.7e-4,
  on the heads' statistics, and 2.5e-4 on the loss); the RCNN's loss,
  gradients and running statistics on tpu3d's sampled targets in float64,
  within the float64 bounds of test_torch_train.py (1e-7 relative plus
  1e-9 of the largest gradient; the loss and statistics within 1e-9).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_rpn import _numpy_variables, _port_cfg
from test_torch_slab import _recording_routes, bn_config
from test_torch_train import _flat, _x64
from tpu3d.models import PointRCNN as JaxPointRCNN
from tpu3d.models import point_rcnn as jax_point_rcnn
from tpu3d.models.rcnn import RCNNNet as JaxRCNNNet
from tpu3d.models.train_functions import get_rcnn_loss
from tpu3d.ops import fused_sa as jax_fused_sa
from tpu3d.parallel.train_state import TrainState as JaxTrainState
from tpu3d.parallel.train_state import make_optimizer
from tpu3d.parallel.train_state import make_train_step as jax_make_train_step
from tpu3d_torch.datasets import train_batch
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.models import point_rcnn
from tpu3d_torch.models import pointnet2
from tpu3d_torch.models import train_functions as tf
from tpu3d_torch.models.pointnet2 import PointnetSAModule
from tpu3d_torch.ops import fused_bn_mlp_pool
from tpu3d_torch.ops.fused_sa import (fused_bn_mlp_pool_backward,
                                      fused_bn_mlp_pool_backward_plain,
                                      fused_bn_mlp_pool_train)
from tpu3d_torch.parallel import create_train_state, make_train_step
from tpu3d_torch.tools.train_rcnn import configure_mode
from tpu3d_torch.weights import params_from_jax, params_to_jax

T = torch.from_numpy
NAMES = ("d_x0", "d_w1", "d_w2", "d_gamma0", "d_gamma1", "d_gamma2",
         "d_beta0", "d_beta1", "d_beta2")

# (R, M, S, C1, C2, C3): tests/test_fused_sa.py's two shapes (S = 16), and
# default.yaml's RCNN SA_0 (128 -> 128 -> 128) and SA_1 (128 -> 256) at
# S = 64, small R and M
SHAPES = [(2, 4, 16, 128, 128, 128), (2, 2, 16, 128, 128, 256),
          (2, 8, 64, 128, 128, 128), (2, 4, 64, 128, 128, 256)]


def _case(shape, seed, dtype=np.float32):
    """x0 (whose groups repeat their first h slots, h random per group, as
    the ball query's pad repeats points, so that exact ties meet the
    first-argmax rule), w1, w2, gammas, betas and an output gradient."""
    R, M, S, C1, C2, C3 = shape
    rng = np.random.default_rng(seed)
    x0 = 0.5 + rng.normal(size=(R, M, S, C1))
    h = rng.integers(1, S + 1, size=(R, M))
    slots = np.arange(S)[None, None, :] % h[..., None]
    x0 = np.take_along_axis(x0, slots[..., None], axis=2)
    arrays = [x0, rng.normal(size=(C1, C2)) / np.sqrt(C1),
              rng.normal(size=(C2, C3)) / np.sqrt(C2)]
    arrays += [1.0 + 0.2 * rng.normal(size=c) for c in (C1, C2, C3)]
    arrays += [0.2 * rng.normal(size=c) for c in (C1, C2, C3)]
    arrays.append(rng.normal(size=(R, M, C3)))
    return [a.astype(dtype) for a in arrays]


def _jax_reference(arrays, pool="first"):
    """tpu3d's reference chain: (out, means, vars, the five inputs'
    gradients of sum(out·g))."""
    x0, w1, w2, g0, g1, g2, b0, b1, b2, g = (jnp.asarray(a) for a in arrays)

    def loss(x, a, b, gammas, betas):
        out, _ = jax_fused_sa.fused_bn_mlp_pool_reference(
            x, a, b, gammas, betas, pool=pool)
        return jnp.sum(out * g)

    out, (means, vars_) = jax.jit(lambda *a: jax_fused_sa.
                                  fused_bn_mlp_pool_reference(*a, pool=pool))(
        x0, w1, w2, (g0, g1, g2), (b0, b1, b2))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        x0, w1, w2, (g0, g1, g2), (b0, b1, b2))
    flat = [grads[0], grads[1], grads[2], *grads[3], *grads[4]]
    return jax.device_get((out, list(means), list(vars_), flat))


def _port(arrays):
    """The port's op in training: (out, means, vars, the five inputs'
    gradients by autograd)."""
    leaves = [T(a).requires_grad_() for a in arrays[:9]]
    out, (means, vars_) = fused_bn_mlp_pool(leaves[0], leaves[1], leaves[2],
                                            leaves[3:6], leaves[6:9])
    grads = torch.autograd.grad(out, leaves, T(arrays[9]))
    return (out.detach().numpy(), [m.numpy() for m in means],
            [v.numpy() for v in vars_], [t.numpy() for t in grads])


def _pieces(arrays):
    """The kernels' algorithm through its plain pieces (the training forward
    and backward that the CUDA path composes: x1 and x2 written by the
    statistics passes and read by the final pass and the waves): (out,
    means, vars, the five inputs' gradients)."""
    x0, w1, w2, *gb, g = (T(a) for a in arrays)
    out, arg, x2, means, vars_, saved = fused_bn_mlp_pool_train(
        x0, w1, w2, gb[:3], gb[3:])
    d_x0, dw1, dw2, dg, db = fused_bn_mlp_pool_backward(
        x0, w1, w2, gb[:3], gb[3:], means, vars_, out, arg, x2, saved, g)
    return (out.numpy(), [m.numpy() for m in means],
            [v.numpy() for v in vars_],
            [t.numpy() for t in (d_x0, dw1, dw2, *dg, *db)])


def _assert_close(ours, ref, tol):
    out, means, vars_, grads = ours
    rout, rmeans, rvars, rgrads = ref
    np.testing.assert_allclose(out, rout, rtol=0,
                               atol=tol * np.abs(rout).max())
    for k in range(3):
        for a, b, what in ((means[k], rmeans[k], "mean"),
                           (vars_[k], rvars[k], "var")):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=tol * np.abs(b).max(),
                                       err_msg=f"{what}{k}")
    for name, a, b in zip(NAMES, grads, rgrads):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=tol * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_train_op_matches_reference(shape):
    """The op in training and the kernels' algorithm (plain pieces) against
    tpu3d's f32 reference: output, statistics, five gradients within 1e-5
    of each one's largest value; the plain backward alone
    (``fused_bn_mlp_pool_backward_plain``) gives the op's gradients to the
    bit."""
    arrays = _case(shape, shape[2] + shape[5])
    ref = _jax_reference(arrays)
    ours = _port(arrays)
    _assert_close(ours, ref, 1e-5)
    _assert_close(_pieces(arrays), ref, 1e-5)
    x0, w1, w2, *gb, g = (T(a) for a in arrays)
    d_x0, dw1, dw2, dg, db = fused_bn_mlp_pool_backward_plain(
        x0, w1, w2, gb[:3], gb[3:], g)
    for a, b in zip((d_x0, dw1, dw2, *dg, *db), ours[3]):
        np.testing.assert_array_equal(a.numpy(), b)


def _bf16_exact(arrays):
    return [np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)
            for a in arrays]


def pallas_case(shape):
    """The port and tpu3d's seven Pallas kernels in interpret mode on one
    case whose inputs and weights bf16 holds exactly: (the output's
    absolute differences, the means' and the variances' largest, the share
    of argmax slots equal, the nine gradients' differences relative to each
    one's largest value, the port's backward routed by the TPU kernels'
    argmax and x2 there)."""
    arrays = _bf16_exact(_case(shape, shape[2] + shape[5] + 1))
    x0, w1, w2, g0, g1, g2, b0, b1, b2, g = (jnp.asarray(a) for a in arrays)
    R, M, S, C1 = shape[:4]
    gammas, betas = (g0, g1, g2), (b0, b1, b2)
    jout, jstats, res = jax.device_get(jax.jit(
        lambda x, a, b, gs, bs: jax_fused_sa._fused_train_fwd_impl(
            x.reshape(R, M * S, C1), (a, b), (gs, bs), S, 1e-5, True))(
                x0, w1, w2, gammas, betas))
    jarg, jx2 = np.asarray(res[6]), np.asarray(res[7])

    def loss(*a):
        out, _ = jax_fused_sa.fused_bn_mlp_pool(*a, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g)

    jgrads = jax.device_get(jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        x0, w1, w2, gammas, betas))
    jgrads = [jgrads[0], jgrads[1], jgrads[2], *jgrads[3], *jgrads[4]]

    t = [T(a) for a in arrays]
    out, arg, _, means, vars_, saved = fused_bn_mlp_pool_train(
        t[0], t[1], t[2], t[3:6], t[6:9])
    # the pooled value the TPU kernels routed: ReLU of its x2 there
    r2 = torch.rsqrt(vars_[2] + 1e-5)
    tout = torch.relu((T(jx2) - means[2]) * r2 * t[5] + t[8])
    grads = fused_bn_mlp_pool_backward(
        t[0], t[1], t[2], t[3:6], t[6:9], means, vars_, tout, T(jarg),
        T(jx2), saved, t[9])
    grads = [grads[0], grads[1], grads[2], *grads[3], *grads[4]]
    rel = [np.abs(a.numpy() - np.asarray(b, np.float32))
           / (np.abs(np.asarray(b, np.float32)).max() + 1e-3)
           for a, b in zip(grads, jgrads)]
    return (np.abs(out.numpy() - np.asarray(jout, np.float32)),
            max(np.abs(means[k].numpy() - jstats[0][k]).max()
                for k in range(3)),
            max((np.abs(vars_[k].numpy() - jstats[1][k])
                 / (2e-2 + 2e-2 * np.abs(jstats[1][k]))).max()
                for k in range(3)),
            (arg.numpy() == jarg).mean(), rel)


@pytest.mark.parametrize("shape", SHAPES[:2] + SHAPES[3:])
def test_train_op_matches_pallas_interpret(shape):
    """Against tpu3d's seven Pallas kernels in interpret mode, on inputs
    and weights that bf16 holds exactly, at the bf16 grade of
    tests/test_fused_sa.py: the pooled output (0.1 max, 0.01 mean), the
    statistics (2e-3 for the means, 2e-2 absolute plus relative for the
    variances), the argmax of at least 98% of the channels equal to the
    port's f32 one (the tie rule itself is held in f32 above); then the
    port's backward (its plain pieces) routed by the TPU kernels' argmax
    and x2 there: layer 2's gradients (dW2, dgamma2, dbeta2) within 0.05
    of their largest value; those behind layer 1 within 0.4 of it and 0.03
    on average (the bf16 rounding of x1 and x2 moves layer-1 ReLU masks and
    the BatchNorm reductions, sums of many terms of both signs)."""
    err, mean_err, var_err, same, rel = pallas_case(shape)
    assert err.max() < 0.1 and err.mean() < 0.01, (err.max(), err.mean())
    assert mean_err <= 2e-3 and var_err <= 1, (mean_err, var_err)
    assert same >= 0.98
    for name, r in zip(NAMES, rel):
        if name in ("d_w2", "d_gamma2", "d_beta2"):
            assert r.max() < 0.05, (name, r.max())
        else:
            assert r.max() < 0.4 and r.mean() < 0.03, (name, r.max(),
                                                       r.mean())


def test_sa_level_same_before_and_after_route_change(monkeypatch):
    """An RCNN level with BatchNorm in training on the CPU: the slab route
    (the fused op's plain version) against the SharedMLP with batch
    statistics, the CPU's route before the op had a training form: output
    and every running statistic equal to the bit, the parameters' and the
    features' gradients within 1e-4 of each largest value."""
    sa = PointnetSAModule(16, 0.8, 64, (128, 128, 256), 125, bn=True,
                          device="cpu")
    rng = np.random.default_rng(31)
    state = {k: T(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
             for k, v in sa.state_dict().items()}
    xyz = T(rng.uniform(-1.5, 1.5, size=(4, 64, 3)).astype(np.float32))
    feats = T(rng.normal(size=(4, 64, 125)).astype(np.float32))
    g = T(rng.normal(size=(4, 16, 256)).astype(np.float32))
    res = {}
    for route in ("slab", "plain"):
        sa.load_state_dict(state)
        sa.zero_grad()
        monkeypatch.setattr(pointnet2, "sa_route",
                            lambda *a, route=route: route)
        f = feats.clone().requires_grad_()
        out = sa(xyz, f, train=True, bn_momentum=0.8)[1]
        out.backward(g)
        res[route] = (out.detach(), dict(sa.state_dict()),
                      [f.grad] + [p.grad.clone() for p in sa.parameters()])
    out, stats, grads = res["slab"]
    rout, rstats, rgrads = res["plain"]
    assert torch.equal(out, rout)
    moved = 0
    for k, v in rstats.items():
        assert torch.equal(stats[k], v), k
        moved += not torch.equal(v, state[k])
    assert moved == 3 * 2  # each BatchNorm layer's mean and var
    for a, b in zip(grads, rgrads):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * b.abs().max().item())


# --------------------------------------------------------------------------
# default.yaml with RCNN.USE_BN: true, cut in depth, through train steps
# --------------------------------------------------------------------------


def _pinned_config():
    jcfg = bn_config()
    jcfg.RPN.DP_RATIO = 0.0
    jcfg.RCNN.DP_RATIO = 0.0
    return jcfg


def train_step_case(mode):
    """One train step of each package in ``mode`` ("joint" or "rcnn") on the
    same carried weights and batch (2 scenes of bn_config's 2048 points),
    both proposal target layers pinned to tpu3d's draw under a fixed key:
    (tpu3d's metrics, its RCNN running statistics after the step, the
    port's metrics, the port's, the fused ops the port's RCNN called, the
    batch statistics the fused op returned and the running statistics
    before the step, by level)."""
    jcfg = _pinned_config()
    cfg = configure_mode(_port_cfg(jcfg), mode)
    jcfg.RPN.FIXED = cfg.RPN.FIXED  # tpu3d's configure_mode sets its global
    batch = train_batch(2, jcfg.RPN.NUM_POINTS, seed=32)
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TRAIN")
    shapes = jax.eval_shape(lambda p: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, {"pts_input": p}, train=False),
        batch["pts_input"])
    params, stats = _numpy_variables(shapes, np.random.default_rng(32))

    real = jax_point_rcnn.proposal_target_layer
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_point_rcnn, "proposal_target_layer",
                  lambda key, *a, **k: real(jax.random.PRNGKey(5), *a, **k))
        out, _ = jax.jit(lambda v, b: jmodel.apply(
            v, b, train=True, bn_momentum=0.9, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1),
                  "target": jax.random.PRNGKey(2)}))(
            {"params": params, "batch_stats": stats},
            {"pts_input": batch["pts_input"],
             "gt_boxes3d": batch["gt_boxes3d"]})
        target = {k: np.asarray(out[k]) for k in (
            "sampled_pts", "pts_feature", "cls_label", "reg_valid_mask",
            "gt_of_rois", "gt_iou", "roi_boxes3d")}
        tx = make_optimizer(jcfg, 10, 2, params)
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats, opt_state=tx.init(params),
                               tx=tx)
        jstate, jtb = jax.device_get(jax.jit(jax_make_train_step(
            jcfg, jmodel))(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jax.random.PRNGKey(3),
                           0.9))

    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith("rcnn_net.")}
    state = create_train_state(cfg, model, steps_per_epoch=10,
                               total_epochs=2)
    returned = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(point_rcnn, "proposal_target_layer",
                  lambda *a, **k: {k: T(v) for k, v in target.items()})
        calls = _recording_routes(m)
        op = pointnet2.fused_bn_mlp_pool

        def recording(*args):
            res = op(*args)
            if args[5] is None:  # training: the batch statistics returned
                returned.append(res[1])
            return res

        m.setattr(pointnet2, "fused_bn_mlp_pool", recording)
        tb = make_train_step(cfg, model)(
            state, {k: T(v) for k, v in batch.items()},
            torch.Generator().manual_seed(0), 0.9)
    return (jtb, jstate.batch_stats["rcnn_net"], tb,
            params_to_jax(model.state_dict())[1]["rcnn_net"], calls,
            returned, before)


@pytest.mark.parametrize("mode", ["joint", "rcnn"])
def test_bn_train_step_matches(mode):
    """train_step_case: the RCNN's SA levels took the BatchNorm slab route;
    rpn_loss (joint) and rcnn_loss within 1e-3 relative of tpu3d's; every
    RCNN running statistic after the step within 1e-3 of its largest value;
    each RCNN SA level's running statistics equal to m·old + (1 −
    m)·(the batch statistics the op returned), to the bit."""
    jtb, jstats, tb, stats, calls, returned, before = train_step_case(mode)
    assert calls[:2] == ["fused_bn_mlp_pool", "fused_bn_mlp_pool"]
    keys = ["rcnn_loss"] + (["rpn_loss"] if mode == "joint" else [])
    for key in keys:
        np.testing.assert_allclose(float(tb[key]), float(jtb[key]),
                                   rtol=1e-3, err_msg=key)
    ours, ref = dict(_flat(stats)), dict(_flat(jstats))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=0,
                                   atol=1e-3 * np.abs(v).max(), err_msg=k)
    assert len(returned) == 2
    for level, (means, vars_) in enumerate(returned):
        for i in range(3):
            for leaf, batch_value in (("mean", means[i]), ("var", vars_[i])):
                key = f"sa_{level}/mlp_0/bn_{i}/{leaf}"
                old = before[f"rcnn_net.sa_{level}.mlp_0.bn_{i}.{leaf}"]
                want = 0.9 * old + (1 - 0.9) * batch_value
                np.testing.assert_array_equal(ours[key], want.numpy(), key)
                assert not torch.equal(want, old), key


def rcnn_f64_case():
    """The BatchNorm RCNN's loss, rcnn_net gradients and running statistics
    after one train-mode forward (momentum 0.9) on tpu3d's sampled targets,
    in float64 on both sides: (loss, tpu3d's, gradients and tpu3d's as
    flat dicts, statistics and tpu3d's as flat dicts, the fused ops the
    port's RCNN called)."""
    jcfg = _pinned_config()
    batch = train_batch(2, jcfg.RPN.NUM_POINTS, seed=33)
    rng = np.random.default_rng(33)
    N = jcfg.RPN.NUM_POINTS
    gt = batch["gt_boxes3d"]
    rois = np.repeat(gt[:, :8], 3, axis=1)
    rois = (rois + rng.normal(size=rois.shape) * [0.3, 0.05, 0.3, 0.05, 0.05,
                                                  0.1, 0.1]).astype(np.float32)
    feats = np.concatenate([
        (rng.random((2, N, 1)) > 0.5), rng.random((2, N, 1)),
        rng.normal(size=(2, N, 128))], -1).astype(np.float32)
    target = jax.device_get(jax.jit(lambda k: jax_point_rcnn.
                                    proposal_target_layer(
        k, jnp.asarray(rois), jnp.ones(rois.shape[:2], bool),
        jnp.asarray(gt), jnp.asarray(batch["pts_input"]),
        jnp.asarray(feats), jcfg))(jax.random.PRNGKey(6)))
    target = {k: np.asarray(v, np.float64) if np.asarray(v).dtype
              == np.float32 else np.asarray(v) for k, v in target.items()}
    jnet = JaxRCNNNet(cfg=jcfg)
    pts_input = np.concatenate([target["sampled_pts"],
                                target["pts_feature"]], -1)
    shapes = jax.eval_shape(lambda p: jnet.init(
        {"params": jax.random.PRNGKey(0)}, p, train=False),
        pts_input.astype(np.float32))
    params, stats = _numpy_variables(shapes, rng)
    params, stats = jax.tree_util.tree_map(
        lambda a: a.astype(np.float64), (params, stats))

    def loss_fn(p):
        out, mut = jnet.apply({"params": p, "batch_stats": stats}, pts_input,
                              train=True, bn_momentum=0.9,
                              mutable=["batch_stats"])
        return get_rcnn_loss(jcfg, dict(target, **out))[0], \
            mut["batch_stats"]

    with _x64():
        (jloss, jstats), jgrads = jax.device_get(jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params))

    cfg = _port_cfg(jcfg)
    model = PointRCNN(cfg, mode="TRAIN", device="cpu").double()
    full = model.state_dict()
    full.update({k: v.double() for k, v in params_from_jax(
        {"rcnn_net": params}, {"rcnn_net": stats}).items()})
    model.load_state_dict(full)
    with pytest.MonkeyPatch.context() as m:
        calls = _recording_routes(m)
        out = model.rcnn_net(T(target["sampled_pts"]),
                             T(target["pts_feature"]), True, 0.9)
    loss, _ = tf.get_rcnn_loss(cfg, dict(
        out, **{k: T(v) for k, v in target.items()}))
    loss.backward()
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()
                           if n.startswith("rcnn_net.")})[0]["rcnn_net"]
    _, port_stats = params_to_jax(model.state_dict())
    return (loss.item(), float(jloss), dict(_flat(grads)),
            dict(_flat(jgrads)), dict(_flat(port_stats["rcnn_net"])),
            dict(_flat(jstats)), calls)


def test_bn_rcnn_gradients_match_f64():
    """rcnn_f64_case: both SA levels took the BatchNorm slab route; the
    gradients within 1e-7 relative plus 1e-9 of the largest, the loss and
    the running statistics within 1e-9 relative."""
    loss, jloss, ours, ref, stats, jstats, calls = rcnn_f64_case()
    assert calls == ["fused_bn_mlp_pool", "fused_bn_mlp_pool"]
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    assert set(ours) == set(ref)
    scale = max(np.abs(b).max() for b in ref.values())
    for k, b in ref.items():
        np.testing.assert_allclose(ours[k], b, rtol=1e-7, atol=1e-9 * scale,
                                   err_msg=k)
    for k in range(2):
        for i in range(3):
            assert np.abs(ref[f"sa_{k}/mlp_0/bn_{i}/scale"]).max() > 0
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-9, atol=1e-12,
                                   err_msg=k)
