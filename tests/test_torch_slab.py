"""The slab form of the fused RCNN set abstraction in the port against tpu3d
on the CPU: the no-BN slab op (``fused_mlp_pool``, kernel 8's plain
versions), the BatchNorm chain at eval (``fused_bn_mlp_pool``, the plain
version of kernel 9's eval form), tpu3d's three-way route at the RCNN's SA
levels, the ball query's "first" rule, and the configs that reach them:
configs/quickstart.yaml and configs/smoke.yaml as shipped (the joint eval
forward, the RCNN's gradients and a joint train step), and default.yaml
with ``RCNN.USE_BN: true`` at cut depth.

Inputs are numpy arrays and numpy weights, carried over with
``params_from_jax``. Tolerances, each with its reason:

- the slab ops against tpu3d's f32 references ``fused_mlp_pool_reference``
  and ``fused_bn_mlp_pool_reference(stats=...)`` (the gradients with
  ``pool="first"``, the kernels' tie rule): the output and each of the
  five gradients within 1e-5 of its largest value (f32 sums in another
  order in XLA and in PyTorch);
- against tpu3d's Pallas kernels in interpret mode, which round to bf16 at
  their layer boundaries: the bf16 grade of tests/test_fused_sa.py, forward
  within 0.1 absolute (and 0.01 mean for the BatchNorm chain), each
  gradient within 0.08 (largest) and 5e-3 (mean) of its largest value, the
  port's layer-1 gradients taken under the TPU kernel's layer-1 ReLU mask at
  the few entries where its bf16 x1 has the other sign (the test's
  docstring says why);
- the gather and the slab route of one level: 1e-5 of the largest value;
- the configs: the RPN's outputs within the bounds of test_torch_double.py,
  the RCNN stage on tpu3d's rois within 1e-4 absolute and relative (but
  for ROIs whose one-rounding-apart coordinates move a discrete pick, at
  most one in 50), the RCNN's gradients on tpu3d's sampled targets in
  float64 within the float64 bound of test_torch_train.py;
- the ball query's ids: equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rpn import _numpy_variables, _port_cfg
from test_torch_train import _flat, _x64
from tpu3d.config import cfg_from_file as jax_cfg_from_file
from tpu3d.config import fresh_cfg as jax_fresh_cfg
from tpu3d.models import PointRCNN as JaxPointRCNN
from tpu3d.models import pointnet2 as jax_pointnet2
from tpu3d.models.point_rcnn import \
    rotate_points_along_y as jax_rotate_points_along_y
from tpu3d.models.proposal_target import \
    proposal_target_layer as jax_proposal_target
from tpu3d.models.rcnn import RCNNNet as JaxRCNNNet
from tpu3d.models.train_functions import get_rcnn_loss
from tpu3d.ops import fused_sa as jax_fused_sa
from tpu3d.ops.grouping import ball_query as jax_ball_query
from tpu3d.ops.roipool import roipool3d as jax_roipool3d
from tpu3d_torch.datasets import random_scenes, train_batch
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.models import pointnet2
from tpu3d_torch.models import train_functions as tf
from tpu3d_torch.models.pointnet2 import BatchNorm, PointnetSAModule
from tpu3d_torch.ops import (ball_query, fused_bn_mlp_pool,
                             fused_gather_supported, fused_mlp_pool,
                             fused_sa_supported, sa_route)
from tpu3d_torch.ops.fused_sa import (fused_mlp_pool_backward,
                                      fused_mlp_pool_train)
from tpu3d_torch.parallel import create_train_state, make_train_step
from tpu3d_torch.weights import (params_from_jax, params_to_jax,
                                 seeded_state_dict)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy
NAMES = ("d_x0", "d_w1", "d_b1", "d_w2", "d_b2")

# (R, M, S, C1, C2, C3): quickstart.yaml's RCNN SA_1 (S = 64, 128 -> 256)
# and smoke.yaml's (S = 16), at small R
SLAB_SHAPES = [(2, 16, 64, 128, 128, 256), (2, 16, 16, 128, 128, 256)]
# default.yaml's RCNN SA_0 (128 -> 128 -> 128) and SA_1 (128 -> 256) with
# BatchNorm, at small R and M
BN_SHAPES = [(2, 8, 64, 128, 128, 128), (2, 4, 64, 128, 128, 256)]


def _slab_case(shape, seed, repeat):
    """x0, weights and an output gradient. With ``repeat`` every group's
    slots repeat its first h (h random per group, as the wrap-filled pooled
    rows and the ball query's pad repeat points), so that exact ties meet
    the first-argmax rule."""
    R, M, S, C1, C2, C3 = shape
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(R, M, S, C1))
    if repeat:
        h = rng.integers(1, S + 1, size=(R, M))
        slots = np.arange(S)[None, None, :] % h[..., None]
        x0 = np.take_along_axis(x0, slots[..., None], axis=2)
    return [a.astype(np.float32) for a in (
        x0, rng.normal(size=(C1, C2)) / np.sqrt(C1),
        0.1 * rng.normal(size=C2), rng.normal(size=(C2, C3)) / np.sqrt(C2),
        0.1 * rng.normal(size=C3), rng.normal(size=(R, M, C3)))]


def _port_slab(x0, w1, b1, w2, b2, g):
    """The port's eval output, train output, and the five gradients by
    autograd of ``fused_mlp_pool``."""
    with torch.no_grad():
        evl = fused_mlp_pool(*(T(a) for a in (x0, w1, b1, w2, b2)))
    leaves = [T(a).requires_grad_() for a in (x0, w1, b1, w2, b2)]
    out = fused_mlp_pool(*leaves)
    grads = torch.autograd.grad(out, leaves, T(g))
    return evl.numpy(), out.detach().numpy(), [t.numpy() for t in grads]


def slab_reference_case(shape):
    """The port's slab op and tpu3d's f32 reference on one case: (port eval
    output, port train output, reference output, the port's five gradients
    by autograd, the reference's (pool="first"), the port's backward alone
    routed by its training forward's argmax and ppre)."""
    x0, w1, b1, w2, b2, g = _slab_case(shape, shape[2], repeat=True)
    evl, out, grads = _port_slab(x0, w1, b1, w2, b2, g)
    args = [jnp.asarray(a) for a in (x0, w1, b1, w2, b2)]
    ref = np.asarray(jax_fused_sa.fused_mlp_pool_reference(*args))

    def loss(*a):
        return jnp.sum(jax_fused_sa.fused_mlp_pool_reference(
            *a, pool="first") * g)

    jgrads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)
    tensors = [T(a) for a in (x0, w1, b1, w2, b2)]
    _, arg, ppre = fused_mlp_pool_train(*tensors)
    alone = fused_mlp_pool_backward(*tensors, T(g), arg, ppre)
    return (evl, out, ref, grads, [np.asarray(b) for b in jgrads],
            [a.numpy() for a in alone])


@pytest.mark.parametrize("shape", SLAB_SHAPES)
def test_slab_op_matches_reference(shape):
    """Eval and train forward and the five gradients against tpu3d's f32
    reference; the train output is the eval output exactly, and the
    backward alone (``fused_mlp_pool_backward``), routed by the training
    forward's argmax and ppre, gives autograd's."""
    evl, out, ref, grads, jgrads, alone = slab_reference_case(shape)
    np.testing.assert_allclose(evl, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(out, evl)
    for name, a, b, c in zip(NAMES, grads, jgrads, alone):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)
        np.testing.assert_array_equal(c, a, err_msg=name)


def _layer1_mask_shift(x0, w1, b1, w2, g, jarg, jppre):
    """What the port's d_x0, dW1 and db1 gain under the TPU kernel's layer-1
    ReLU mask in place of its own: the TPU kernel sums x1 = a0·W1 in f32,
    rounds it to bf16 and adds b1 in bf16 (``_chain_nobn``), so an x1 near 0
    can take the other sign; each such entry where the routed gradient
    reaches layer 1 moves that entry's whole d_x1. -> (the three shifts,
    the number of entries moved)."""
    a0 = np.maximum(x0, 0.0)
    x1 = jnp.einsum("rmsc,cd->rmsd", jnp.asarray(a0, jnp.bfloat16),
                    jnp.asarray(w1, jnp.bfloat16),
                    preferred_element_type=jnp.float32)
    tpu_x1 = np.asarray((x1.astype(jnp.bfloat16)
                         + jnp.asarray(b1, jnp.bfloat16)).astype(jnp.float32))
    port_x1 = a0 @ w1 + b1
    S = x0.shape[2]
    dval = np.where(jppre > 0, g, 0.0)
    d_x2 = (np.arange(S)[:, None] == jarg[:, :, None, :]) * dval[:, :, None]
    delta = ((tpu_x1 > 0).astype(np.float32) - (port_x1 > 0)) * (d_x2 @ w2.T)
    shifts = (np.where(x0 > 0, delta @ w1.T, 0.0),
              np.einsum("rmsc,rmsd->cd", a0, delta), delta.sum(axis=(0, 1, 2)))
    return shifts, int((delta != 0).sum())


def _bf16_exact(arrays):
    """The arrays rounded to values that bf16 holds exactly, in f32."""
    return [np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)
            for a in arrays]


def slab_pallas_case(shape):
    """The port's slab op and tpu3d's Pallas slab kernels in interpret mode
    on one case whose inputs and weights bf16 holds exactly: (port train
    output, TPU kernel's, port argmax, TPU kernel's, the port's five
    gradients routed by the TPU kernel's argmax and ppre, the TPU kernel's
    VJP, ``_layer1_mask_shift``'s shifts of d_x0, dW1 and db1, the number of
    layer-1 entries it moved, the number of layer-1 entries)."""
    x0, w1, b1, w2, b2, g = _bf16_exact(
        _slab_case(shape, shape[2] + 1, repeat=False))
    tensors = [T(a) for a in (x0, w1, b1, w2, b2)]
    out, arg, _ = fused_mlp_pool_train(*tensors)
    args = [jnp.asarray(a) for a in (x0, w1, b1, w2, b2)]
    R, M, S, C1 = x0.shape
    jout, jarg, jppre = jax.device_get(jax.jit(
        lambda x, *wb: jax_fused_sa._fused_nobn_fwd_impl(
            x.reshape(R, M * S, C1), (wb[0], wb[2]), (wb[1], wb[3]), S,
            True))(*args))

    def loss(*a):
        return jnp.sum(jax_fused_sa.fused_mlp_pool(
            *a, train=True, interpret=True).astype(jnp.float32) * g)

    jgrads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)
    grads = fused_mlp_pool_backward(*tensors, T(g), torch.tensor(jarg),
                                    torch.tensor(jppre))
    shifts, moved = _layer1_mask_shift(x0, w1, b1, w2, g, jarg, jppre)
    return (out.numpy(), np.asarray(jout, np.float32), arg.numpy(), jarg,
            [a.numpy() for a in grads],
            [np.asarray(b, np.float32) for b in jgrads], shifts, moved,
            R * M * S * w1.shape[1])


@pytest.mark.parametrize("shape", SLAB_SHAPES)
def test_slab_op_matches_pallas_interpret(shape):
    """Against tpu3d's slab kernels themselves in interpret mode, at the
    bf16 grade, on inputs and weights that bf16 holds exactly (the TPU
    kernel reads its weights in bf16): the training forward's output, then
    the five gradients of its VJP against the port's backward routed by
    the TPU kernel's own argmax and ppre. Rounding to bf16 ties or swaps
    near-equal maxima, which moves a channel's whole gradient to another
    slot; so the picks are held apart: at least 98% equal to the port's
    f32 picks (the tie rule itself is held in f32 above). The gradients
    behind layer 1's ReLU (d_x0, dW1, db1) also meet single mask entries
    that the TPU kernel's bf16 x1 holds at the other sign; one such entry
    moves a whole d_x1 value (up to 0.09 and 0.15 of the largest at these
    two shapes). Those entries, at most one in 1000 of layer 1's, are
    counted from the same inputs, and the port's three gradients are held
    under the TPU kernel's mask there (``_layer1_mask_shift``); every
    gradient then within the grade's 0.08 (largest) and 5e-3 (mean)."""
    out, jout, arg, jarg, grads, jgrads, shifts, moved, entries = \
        slab_pallas_case(shape)
    assert np.abs(out - jout).max() < 0.1
    assert (arg == jarg).mean() >= 0.98
    assert moved <= entries // 1000, (moved, entries)
    for name, a, b, shift in zip(NAMES, grads, jgrads, (*shifts, 0, 0)):
        err = np.abs(a + shift - b) / (np.abs(b).max() + 1e-3)
        assert err.max() < 0.08, (name, err.max())
        assert err.mean() < 5e-3, (name, err.mean())


def _bn_case(shape, seed):
    """x0, w1, w2 and three BatchNorm layers' (scale, bias, mean, var), the
    running statistics away from the identity."""
    R, M, S, C1, C2, C3 = shape
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(R, M, S, C1))
    bns = [(1.0 + 0.1 * rng.normal(size=c), 0.1 * rng.normal(size=c),
            0.3 * rng.normal(size=c), rng.uniform(0.5, 2.0, size=c))
           for c in (C1, C2, C3)]
    f32 = [a.astype(np.float32) for a in (
        x0, rng.normal(size=(C1, C2)) / np.sqrt(C1),
        rng.normal(size=(C2, C3)) / np.sqrt(C2))]
    return f32, [[a.astype(np.float32) for a in bn] for bn in bns]


def _port_bn(x0, w1, w2, bns):
    """The port's ``fused_bn_mlp_pool`` with each layer's (mul, add) folded
    by the port's ``BatchNorm``, as the model folds them."""
    affines = []
    for scale, bias, mean, var in bns:
        bn = BatchNorm(scale.shape[0])
        bn.load_state_dict({"scale": T(scale), "bias": T(bias),
                            "mean": T(mean), "var": T(var)})
        affines.append(bn.affine())
    with torch.no_grad():
        return fused_bn_mlp_pool(T(x0), T(w1), T(w2), affines).numpy()


def _jax_bn(fn, x0, w1, w2, bns, **kw):
    (g0, be0, m0, v0), (g1, be1, m1, v1), (g2, be2, m2, v2) = [
        [jnp.asarray(a) for a in bn] for bn in bns]
    return np.asarray(jax.jit(lambda x, a, b: fn(
        x, a, b, (g0, g1, g2), (be0, be1, be2),
        stats=((m0, v0), (m1, v1), (m2, v2)), **kw))(
            jnp.asarray(x0), jnp.asarray(w1), jnp.asarray(w2)), np.float32)


@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_slab_matches_reference(shape):
    """The BatchNorm chain at eval against tpu3d's f32 reference with the
    same running statistics, within 1e-5 of the largest value (tpu3d folds
    them as beta − mean·(gamma·r), the port as bias − mean·mul with the
    same mul: the same expression)."""
    (x0, w1, w2), bns = _bn_case(shape, shape[1])
    ref = _jax_bn(jax_fused_sa.fused_bn_mlp_pool_reference, x0, w1, w2, bns)
    out = _port_bn(x0, w1, w2, bns)
    assert out.shape == ref.shape == (shape[0], shape[1], shape[5])
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_slab_matches_pallas_interpret(shape):
    """Against tpu3d's ``_eval_chain_kernel`` in interpret mode, at the bf16
    grade of tests/test_fused_sa.py's eval test (max 0.1, mean 0.01), on
    inputs and weights that bf16 holds exactly."""
    (x0, w1, w2), bns = _bn_case(shape, shape[1] + 1)
    x0, w1, w2 = _bf16_exact((x0, w1, w2))
    ref = _jax_bn(jax_fused_sa.fused_bn_mlp_pool, x0, w1, w2, bns,
                  interpret=True)
    err = np.abs(_port_bn(x0, w1, w2, bns) - ref)
    assert err.max() < 0.1, err.max()
    assert err.mean() < 0.01, err.mean()


def _tpu3d_route(monkeypatch, rows, n, npoint, nsample, mlp, bn, c_in=128):
    """tpu3d's own dispatch in an RCNN SA level (canonical), traced as on a
    TPU with its sampling, grouping and fused kernels stubbed: "gather",
    "slab" or "plain"."""
    seen = []

    def pooled(*args, **kw):
        return jnp.zeros((rows, npoint, mlp[-1]), jnp.float32)

    def recording(route):
        def fn(*args, **kw):
            seen.append(route)
            return pooled()
        return fn

    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        for flag in ("TPU3D_DISABLE_FUSED_SA", "TPU3D_F32_EVAL",
                     "TPU3D_FORCE_FUSED_SA", "TPU3D_REF_BALL_QUERY"):
            m.delenv(flag, raising=False)
        m.setattr(jax_pointnet2, "fused_gathered_mlp_pool",
                  recording("gather"))
        m.setattr(jax_pointnet2, "fused_mlp_pool", recording("slab"))
        m.setattr(jax_pointnet2, "fused_bn_mlp_pool", recording("slab"))
        m.setattr(jax_pointnet2, "furthest_point_sample",
                  lambda x, k: jnp.zeros((x.shape[0], k), jnp.int32))
        m.setattr(jax_pointnet2, "gather_points",
                  lambda x, i: jnp.zeros((*i.shape, x.shape[-1]), x.dtype))
        m.setattr(jax_pointnet2, "ball_query",
                  lambda c, x, r, s, **kw: jnp.zeros((*c.shape[:2], s),
                                                     jnp.int32))
        m.setattr(jax_pointnet2, "group_points",
                  lambda x, i, **kw: jnp.zeros((*i.shape, x.shape[-1]),
                                               x.dtype))
        sa = jax_pointnet2.PointnetSAModule(
            npoint=npoint, radii=(0.8,), nsamples=(nsample,),
            mlps=(tuple(mlp),), bn=bn, query_chunk=None, canonical=True)
        jax.eval_shape(lambda x, f: sa.init(jax.random.PRNGKey(0), x, f),
                       jax.ShapeDtypeStruct((rows, n, 3), jnp.float32),
                       jax.ShapeDtypeStruct((rows, n, c_in), jnp.float32))
    assert len(seen) <= 1
    return seen[0] if seen else "plain"


@pytest.mark.parametrize("rows,n,npoint,nsample,mlp,bn,route", [
    (200, 512, 128, 64, (128, 128, 128), False, "gather"),  # default SA_0
    (200, 128, 32, 64, (128, 128, 256), False, "gather"),  # default SA_1
    (512, 256, 64, 64, (128, 128, 128), False, "gather"),  # quickstart SA_0
    (512, 64, 16, 64, (128, 128, 256), False, "slab"),  # quickstart SA_1
    (128, 128, 32, 16, (128, 128, 128), False, "gather"),  # smoke SA_0
    (128, 32, 16, 16, (128, 128, 256), False, "slab"),  # smoke SA_1
    (200, 512, 128, 64, (128, 128, 128), True, "slab"),  # BN default SA_0
    (200, 128, 32, 64, (128, 128, 256), True, "slab"),  # BN default SA_1
    (8, 2560, 64, 64, (128, 128, 256), False, "slab"),  # N > 2048
    (8, 4096, 32, 64, (128, 128, 256), False, "plain"),  # npoint·S <= N
    (8, 200, 32, 64, (128, 128, 256), False, "slab"),  # N % 128 != 0
    (8, 128, 32, 64, (128, 192, 256), False, "plain"),  # a width % 128
    (8, 128, 32, 64, (128, 192, 256), True, "plain"),  # the same, BN
    (8, 128, 32, 12, (128, 128, 256), False, "plain"),  # S % 8 != 0
    (8, 32, 4, 16, (128, 128, 256), False, "plain"),  # (M·S) % 128 != 0
    (8, 128, 32, 64, (128, 128), False, "plain"),  # two layers
])
def test_route_matches_tpu3d(monkeypatch, rows, n, npoint, nsample, mlp, bn,
                             route):
    """``sa_route`` against tpu3d's dispatch as on a TPU, at each RCNN level
    of the shipped configs, with BatchNorm, and at shapes that each
    condition rejects."""
    shape = (rows, npoint, nsample, mlp[0])
    assert fused_gather_supported(n) == (n % 128 == 0 and n <= 2048)
    assert fused_sa_supported(shape, mlp) == (
        route != "plain" or npoint * nsample <= n)
    assert sa_route(shape, mlp, n, bn) == route
    assert _tpu3d_route(monkeypatch, rows, n, npoint, nsample, mlp,
                        bn) == route


@pytest.mark.parametrize("n", [128, 256])
def test_gather_and_slab_routes_agree(monkeypatch, n):
    """One level (quickstart's SA_1 widths over a source table the gather
    form takes) through both fused routes: the output and the gradients of
    every parameter and of the input features within 1e-5 of each one's
    largest value."""
    torch.manual_seed(n)
    sa = PointnetSAModule(16, 0.8, 64, (128, 128, 256), 125, bn=False,
                          device="cpu")
    sa.load_state_dict(seeded_state_dict(sa, n))
    rng = np.random.default_rng(n)
    xyz = T(rng.uniform(-1.5, 1.5, size=(4, n, 3)).astype(np.float32))
    feats = rng.normal(size=(4, n, 125)).astype(np.float32)
    g = T(rng.normal(size=(4, 16, 256)).astype(np.float32))
    results = {}
    for route in ("gather", "slab"):
        monkeypatch.setattr(pointnet2, "sa_route",
                            lambda *a, route=route: route)
        f = T(feats).requires_grad_()
        sa.zero_grad()
        _, out = sa(xyz, f)
        out.backward(g)
        results[route] = [out.detach(), f.grad] + [
            p.grad.clone() for p in sa.parameters()]
    for a, b in zip(results["slab"], results["gather"]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item())


@pytest.mark.parametrize("train", [False, True])
def test_bn_level_slab_route_on_the_cpu(monkeypatch, train):
    """A level with BatchNorm on the CPU: at eval the slab route's plain
    version equals the SharedMLP's (within 1e-5 of the largest value), in
    training the SharedMLP runs with batch statistics and updates the
    running ones, as on the plain route."""
    sa = PointnetSAModule(16, 0.8, 64, (128, 128, 256), 125, bn=True,
                          device="cpu")
    sa.load_state_dict(seeded_state_dict(sa, 3))
    rng = np.random.default_rng(3)
    xyz = T(rng.uniform(-1.5, 1.5, size=(4, 64, 3)).astype(np.float32))
    feats = T(rng.normal(size=(4, 64, 125)).astype(np.float32))
    outs, stats = {}, {}
    for route in ("slab", "plain"):
        sa.load_state_dict(seeded_state_dict(sa, 3))
        monkeypatch.setattr(pointnet2, "sa_route",
                            lambda *a, route=route: route)
        with torch.no_grad():
            outs[route] = sa(xyz, feats, train=train)[1]
        stats[route] = sa.mlp_0.bn_2.mean.clone()
    torch.testing.assert_close(outs["slab"], outs["plain"], rtol=0,
                               atol=1e-5 * outs["plain"].abs().max().item())
    torch.testing.assert_close(stats["slab"], stats["plain"], rtol=0, atol=0)
    moved = not torch.equal(stats["plain"],
                            seeded_state_dict(sa, 3)["mlp_0.bn_2.mean"])
    assert moved == train


# --------------------------------------------------------------------------
# the ball query's "first" rule
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,M,N,radius,nsample,many", [
    (2, 64, 512, 0.6, 16, True),  # rows with more than nsample in radius
    (2, 32, 300, 0.25, 64, False),  # short rows only
    (1, 16, 40, 2.0, 64, False),  # N < nsample
])
def test_ball_query_first_matches_tpu3d(B, M, N, radius, nsample, many):
    """``ball_query(method="first")`` gives tpu3d's ids: the first nsample
    in-radius ids in index order, short rows padded with the first hit,
    rows without a hit all 0; "auto" is "nearest", as tpu3d takes it off
    the TPU."""
    rng = np.random.default_rng(N)
    pts = rng.uniform(-1, 1, size=(B, N, 3)).astype(np.float32)
    centers = np.concatenate([
        pts[:, :M // 2], rng.uniform(1.5, 2.5, size=(B, M - M // 2, 3))],
        1).astype(np.float32)
    hits = (((centers[:, :, None] - pts[:, None]) ** 2).sum(-1)
            < radius ** 2).sum(-1)
    first = ball_query(T(centers), T(pts), radius, nsample, method="first")
    ref = jax_ball_query(jnp.asarray(centers), jnp.asarray(pts), radius,
                         nsample, method="first")
    np.testing.assert_array_equal(first.numpy(), np.asarray(ref))
    assert (hits == 0).any()  # rows without a hit
    assert (hits > nsample).any() == many
    nearest = ball_query(T(centers), T(pts), radius, nsample,
                         method="nearest")
    assert torch.equal(ball_query(T(centers), T(pts), radius, nsample),
                       nearest)
    if many:  # the two rules pick other sets there
        full = T(hits > nsample)
        assert not torch.equal(first[full], nearest[full])


def test_ball_query_rejects_an_unknown_method():
    x = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="method"):
        ball_query(x, x, 0.5, 4, method="closest")


# --------------------------------------------------------------------------
# the two configs as shipped (quickstart at B=1 on the CPU)
# --------------------------------------------------------------------------

CONFIGS = {"smoke": 2, "quickstart": 1}  # name: scenes on the CPU


def _config(name):
    return jax_cfg_from_file(str(ROOT / "configs" / f"{name}.yaml"),
                             jax_fresh_cfg())


def _recording_routes(stack):
    """Record which fused op each RCNN SA level of the port calls."""
    calls = []
    for name in ("fused_gathered_mlp_pool", "fused_mlp_pool",
                 "fused_bn_mlp_pool"):
        fn = getattr(pointnet2, name)

        def recording(*args, fn=fn, name=name):
            calls.append(name)
            return fn(*args)

        stack.setattr(pointnet2, name, recording)
    return calls


def run_config_eval(jcfg, B, seed):
    """tpu3d's and the port's joint eval forward on one config, the same
    numpy weights and planted-cluster scenes: (flax params, flax
    statistics, the port's model, the carried-over state, tpu3d's outputs,
    the port's, the fused ops the port's RCNN called)."""
    pts = random_scenes(B, jcfg.RPN.NUM_POINTS, seed=seed)
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TEST")
    shapes = jax.eval_shape(lambda p: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, {"pts_input": p}, train=False), pts)
    params, stats = _numpy_variables(shapes, np.random.default_rng(seed))
    jout = jax.device_get(jax.jit(lambda v, p: jmodel.apply(
        v, {"pts_input": p}, train=False))(
            {"params": params, "batch_stats": stats}, pts))
    model = PointRCNN(_port_cfg(jcfg), mode="TEST", device="cpu")
    state = params_from_jax(params, stats)
    model.load_state_dict(state)
    with pytest.MonkeyPatch.context() as m:
        calls = _recording_routes(m)
        with torch.no_grad():
            out = model({"pts_input": T(pts)})
    return (params, stats, model, state, jout,
            {k: v.numpy() for k, v in out.items()}, calls)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def config_eval(request):
    return run_config_eval(_config(request.param), CONFIGS[request.param], 11)


def test_config_rpn_outputs_match(config_eval):
    """The RPN's heads and points within 1e-4 abs + 1e-4 rel, the backbone
    features within 1e-4 rel + 1e-5 of their largest value, the proposals'
    valid mask and the seg mask equal; SA_0 took the gather route and SA_1
    the slab route."""
    _, _, _, _, jout, out, calls = config_eval
    for key in ("backbone_xyz", "rpn_cls", "rpn_reg"):
        np.testing.assert_allclose(out[key], jout[key], **TOL, err_msg=key)
    ref = jout["backbone_features"]
    np.testing.assert_allclose(out["backbone_features"], ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(out["roi_valid"], jout["roi_valid"])
    np.testing.assert_array_equal(out["seg_result"], jout["seg_result"])
    assert out["roi_valid"].any()
    assert calls == ["fused_gathered_mlp_pool", "fused_mlp_pool"]


def _rcnn_stage_check(jcfg, params, stats, model, jout):
    """tpu3d's rois, backbone outputs and raw scores through the port's ROI
    pool and RCNN: the empty flags equal, the pooled points in each ROI's
    frame within 1e-6 absolute plus 1e-6 relative of tpu3d's; tpu3d's RCNN
    net fed the port's pooled points within 1e-4 abs + 1e-4 rel of the
    port's; -> the ROIs outside that bound against tpu3d's own forward."""
    args = [torch.tensor(a) for a in (
        jout["backbone_xyz"], jout["backbone_features"],
        jout["rpn_cls"][..., 0], jout["rois"])]
    with torch.no_grad():
        out = model.rcnn_stage(*args)
        xyz, rest, _, _ = model.pool_rois(*args)
    np.testing.assert_array_equal(out["pooled_empty_flag"].numpy(),
                                  jout["pooled_empty_flag"])
    assert (~jout["pooled_empty_flag"]).sum() > 4

    def canonical(pts, feats, rois):
        xyz = jax_roipool3d(pts, feats, rois,
                            float(jcfg.RCNN.POOL_EXTRA_WIDTH),
                            int(jcfg.RCNN.NUM_POINTS), split=True)[0]
        return jax_rotate_points_along_y(xyz - rois[:, :, None, 0:3],
                                         rois[..., 6][..., None])

    jxyz = jax.jit(canonical)(jout["backbone_xyz"], jout["backbone_features"],
                              jout["rois"])
    np.testing.assert_allclose(xyz.numpy(), np.asarray(jxyz).reshape(
        xyz.shape), rtol=1e-6, atol=1e-6)
    variables = {"params": params["rcnn_net"]}
    if "rcnn_net" in stats:
        variables["batch_stats"] = stats["rcnn_net"]
    same = jax.device_get(jax.jit(lambda v, x, r: JaxRCNNNet(cfg=jcfg).apply(
        v, (x, r), train=False))(variables, xyz.numpy(), rest.numpy()))
    off = np.zeros(xyz.shape[0], bool)
    for key in ("rcnn_cls", "rcnn_reg"):
        ours = out[key].numpy()
        np.testing.assert_allclose(ours, same[key], **TOL, err_msg=key)
        off |= ~np.isclose(ours, jout[key], **TOL).all(axis=1)
    return off


def test_config_rcnn_stage_matches(config_eval, request):
    """The RCNN stage on tpu3d's rois (``_rcnn_stage_check``); against
    tpu3d's own forward, at most one ROI in 50 lies outside 1e-4 abs + 1e-4
    rel: a coordinate one rounding apart can move an FPS pick or a
    ball-query hit at a near-tie, and no other difference is allowed."""
    params, stats, model, _, jout, _, _ = config_eval
    name = request.node.callspec.params["config_eval"]
    off = _rcnn_stage_check(_config(name), params, stats, model, jout)
    assert off.sum() <= max(1, off.size // 50), np.flatnonzero(off)


def config_rcnn_grad_case(name):
    """tpu3d's proposal target layer on rois jittered around the gt boxes,
    then the RCNN loss and every rcnn_net gradient on both sides in
    float64: (loss, gradients as a flax tree, tpu3d's loss, tpu3d's
    gradients, the fused ops the port's RCNN called)."""
    jcfg = _config(name)
    B, N = CONFIGS[name], jcfg.RPN.NUM_POINTS
    batch = train_batch(B, N, seed=12)
    pts, gt = batch["pts_input"], batch["gt_boxes3d"]
    rng = np.random.default_rng(12)
    rois = np.repeat(gt[:, :8], 6, axis=1)
    rois = (rois + rng.normal(size=rois.shape) * [0.3, 0.05, 0.3, 0.05, 0.05,
                                                  0.1, 0.1]).astype(np.float32)
    feats = np.concatenate([
        (rng.random((B, N, 1)) > 0.5), rng.random((B, N, 1)),
        rng.normal(size=(B, N, 128))], -1).astype(np.float32)
    target = jax.device_get(jax.jit(lambda k: jax_proposal_target(
        k, jnp.asarray(rois), jnp.ones(rois.shape[:2], bool),
        jnp.asarray(gt), jnp.asarray(pts), jnp.asarray(feats), jcfg))(
            jax.random.PRNGKey(5)))
    assert (np.asarray(target["reg_valid_mask"]) == 1).sum() >= 2
    target = {k: np.asarray(v, np.float64) if np.asarray(v).dtype
              == np.float32 else np.asarray(v) for k, v in target.items()}

    jnet = JaxRCNNNet(cfg=jcfg)
    pts_input = np.concatenate([target["sampled_pts"],
                                target["pts_feature"]], -1)
    shapes = jax.eval_shape(lambda p: jnet.init(
        {"params": jax.random.PRNGKey(0)}, p, train=False),
        pts_input.astype(np.float32))
    params, _ = _numpy_variables({"params": shapes["params"],
                                  "batch_stats": {}}, rng)
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float64), params)

    def loss_fn(p):
        out = jnet.apply({"params": p}, pts_input, train=True)
        return get_rcnn_loss(jcfg, dict(target, **out))[0]

    with _x64():
        jloss, jgrads = jax.device_get(jax.jit(jax.value_and_grad(loss_fn))(
            params))

    cfg = _port_cfg(jcfg)
    model = PointRCNN(cfg, mode="TRAIN", device="cpu").double()
    full = model.state_dict()
    full.update(params_from_jax({"rcnn_net": params}, {}))
    model.load_state_dict(full)
    with pytest.MonkeyPatch.context() as m:
        calls = _recording_routes(m)
        out = model.rcnn_net(T(target["sampled_pts"]),
                             T(target["pts_feature"]), train=True)
    loss, _ = tf.get_rcnn_loss(cfg, dict(
        out, **{k: T(v) for k, v in target.items()}))
    loss.backward()
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()
                           if n.startswith("rcnn_net.")})[0]["rcnn_net"]
    return loss.item(), grads, float(jloss), jgrads, calls


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_rcnn_gradients_match(name):
    """config_rcnn_grad_case, in float64 as test_torch_train.py holds the
    RPN's: each gradient within 1e-7 relative plus 1e-9 of the largest, the
    loss within 1e-9 relative. (In float32 the max-pools' near-ties, values
    a rounding apart, send a channel's gradient to another slot in the two
    packages.) The port's SA_0 ran the gather route and SA_1 the slab
    route under autograd."""
    loss, grads, jloss, jgrads, calls = config_rcnn_grad_case(name)
    assert calls == ["fused_gathered_mlp_pool", "fused_mlp_pool"]
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    ours, ref = dict(_flat(grads)), dict(_flat(jgrads))
    assert set(ours) == set(ref)
    scale = max(np.abs(b).max() for b in ref.values())
    for k, b in ref.items():
        np.testing.assert_allclose(ours[k], b, rtol=1e-7, atol=1e-9 * scale,
                                   err_msg=k)
    assert np.abs(ref["sa_1/mlp_0/dense_1/kernel"]).max() > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_train_step_runs(name):
    """One joint train step of the config as shipped on the CPU: finite
    loss and grad_norm, both losses present, the RCNN's SA_1 weights
    moved."""
    cfg = _port_cfg(_config(name))
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    model.load_state_dict(seeded_state_dict(model, 13))
    key = "rcnn_net.sa_1.mlp_0.dense_1.weight"
    before = model.state_dict()[key].clone()
    state = create_train_state(cfg, model, steps_per_epoch=10,
                               total_epochs=2)
    batch = {k: T(v) for k, v in train_batch(
        CONFIGS[name], cfg.RPN.NUM_POINTS, seed=13).items()}
    tb = make_train_step(cfg, model)(state, batch,
                                     torch.Generator().manual_seed(0), 0.9)
    assert torch.isfinite(tb["loss"]) and float(tb["grad_norm"]) > 0
    assert "rpn_loss" in tb and "rcnn_loss" in tb
    assert not torch.equal(before, model.state_dict()[key])


# --------------------------------------------------------------------------
# default.yaml with RCNN.USE_BN: true, cut in depth
# --------------------------------------------------------------------------


def bn_config():
    """configs/default.yaml with ``RCNN.USE_BN: true`` (set here: no file in
    configs/ sets it), cut in depth only: 2048 points, NPOINTS
    512/128/32/16, 128 RCNN points per ROI, 16 ROIs per scene."""
    jcfg = _config("default")
    jcfg.RCNN.USE_BN = True
    jcfg.RPN.NUM_POINTS = 2048
    jcfg.RPN.SA_CONFIG.NPOINTS = [512, 128, 32, 16]
    jcfg.RCNN.NUM_POINTS = 128
    jcfg.RCNN.ROI_PER_IMAGE = 16
    for mode in (jcfg.TRAIN, jcfg.TEST):
        mode.RPN_PRE_NMS_TOP_N = 1000
        mode.RPN_POST_NMS_TOP_N = 16
    return jcfg


@pytest.fixture(scope="module")
def bn_eval():
    jcfg = bn_config()
    return (jcfg, *run_config_eval(jcfg, 2, 14))


def test_bn_params_carry_over(bn_eval):
    """params_from_jax carries the whole tree of the BatchNorm RCNN: every
    key of the port's state_dict with its shape, nothing left over, among
    them each RCNN SA level's three BatchNorm scales, biases and running
    statistics (drawn away from 0 and 1); the RCNN's SA levels both took the
    BatchNorm slab route."""
    _, _, _, model, state, _, _, calls = bn_eval
    ours = model.state_dict()
    assert set(state) == set(ours)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(ours[k].shape), k
    for k in range(2):
        for i in range(3):
            for leaf in ("scale", "bias", "mean", "var"):
                key = f"rcnn_net.sa_{k}.mlp_0.bn_{i}.{leaf}"
                assert torch.equal(ours[key], state[key]), key
            mean = ours[f"rcnn_net.sa_{k}.mlp_0.bn_{i}.mean"]
            var = ours[f"rcnn_net.sa_{k}.mlp_0.bn_{i}.var"]
            assert mean.abs().min() > 0 and (var != 1).all()
    assert calls == ["fused_bn_mlp_pool", "fused_bn_mlp_pool"]


def test_bn_rcnn_stage_matches(bn_eval):
    """The BatchNorm RCNN on tpu3d's rois (``_rcnn_stage_check``, tpu3d's
    RCNN net given its running statistics): rcnn_cls / rcnn_reg within 1e-4
    abs + 1e-4 rel of tpu3d's own forward at every ROI."""
    jcfg, params, stats, model, _, jout, _, _ = bn_eval
    off = _rcnn_stage_check(jcfg, params, stats, model, jout)
    assert not off.any(), np.flatnonzero(off)
