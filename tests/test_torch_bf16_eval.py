"""The eval numerics contract (``tpu3d_torch/precision.py``) against tpu3d's
on the CPU: the bf16 forms of kernels 3, 5, 8 and 9, the hi/lo ROI pool,
the set-abstraction casts and ``BF16_INFERENCE`` through the networks, and
how the contract is resolved.

Inputs are seeded numpy arrays; weights are drawn with numpy for the flax
tree and carried over with ``params_from_jax``. Tolerances, each with its
reason:

- each bf16 plain version against tpu3d's Pallas kernel in interpret mode
  (or its one-hot twin, or its gather route on the CPU): within 1e-2
  absolute, the bf16 grade of tests/test_fused_sa.py, and equal to the bit
  in all but one value in a thousand: products of bf16 operands are exact
  in f32, so the two differ only where an f32 sum in another order rounds
  to the other bf16 neighbour (a tie, or a hair from one), and a later
  affine or bias add can turn that one step into two; the interpolation's
  gather route, whose output is f32, within 1e-6 (f32 sums in another
  order);
- the hi/lo ROI pool: equal (one gather of the same table);
- the RPN under the set-abstraction casts, against tpu3d with
  ``TPU3D_FORCE_FUSED_SA=1`` (its casts and fused kernels off the TPU): 1e-5
  of each output's largest value (the casts round f32 values whose sums
  differ in the last bit, so a few round the other way), and the port's f32
  path at least a hundred times further away, which shows the rounding
  points are tpu3d's;
- the RCNN stage on tpu3d's rois and backbone outputs under the same
  casts: 2e-3 (no BatchNorm) and 1e-2 (BatchNorm, whose folded affines
  scale a bf16 step of x1 or x2 by up to ~20) of the largest value, the f32
  path at least five (three with BatchNorm) times further;
- ``BF16_INFERENCE`` (bf16 Dense layers everywhere, on any device): the
  RCNN stage within 5e-3 of the largest value (about one bf16 step of the
  bf16 heads' outputs), the f32 path at least four times further; the RPN
  within 5e-2 of the largest value and the f32 path
  at least twice as far, because its scene-frame layer 0 runs in bf16 (as
  tpu3d's does at eval) and the per-center cancellation in bf16 turns each
  one-step rounding difference of a 70 m coordinate term into a large
  share of the small residual.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from test_torch_rpn import _numpy_variables, _port_cfg
from tpu3d.models import PointRCNN as JaxPointRCNN
from tpu3d.ops import fused_sa as jax_fused_sa
from tpu3d.ops import interpolate as jax_interpolate
from tpu3d.ops.roipool import roipool3d as jax_roipool3d
from tpu3d_torch import precision
from tpu3d_torch.config import fresh_cfg
from tpu3d_torch.datasets import random_scenes
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.ops import fused_sa, interpolate
from tpu3d_torch.ops.roipool import bf16_table, roipool3d_table
from tpu3d_torch.precision import F32, Precision
from tpu3d_torch.tools.eval_rcnn import make_infer_step
from tpu3d_torch.weights import params_from_jax

T = torch.from_numpy
SA_CASTS = Precision(sa_bf16=True)  # tpu3d's CPU under TPU3D_FORCE_FUSED_SA
BF16_DENSE = Precision(dense_dtype=torch.bfloat16, head_dtype=torch.bfloat16)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_close(got, want):
    """Within 1e-2 absolute, and equal in all but 1 value in 1000."""
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want)
    assert err.max() <= 1e-2, err.max()
    assert (err > 0).mean() <= 1e-3, (err > 0).mean()


# ---------------------------------------------------------------- resolve


def test_precision_resolves_from_the_device(monkeypatch):
    """The card takes tpu3d's accelerator contract, the CPU f32;
    TPU3D_F32_EVAL=1 returns the card to f32; BF16_INFERENCE adds bf16
    Dense compute on any device (the heads too); training on the CPU is
    f32 (its card contract: tests/test_torch_bf16_train.py). Resolved from
    a torch.device alone: no tensor is made on it."""
    monkeypatch.delenv("TPU3D_F32_EVAL", raising=False)
    cfg = fresh_cfg()
    accel = Precision(sa_bf16=True, fp_bf16=True, roi_bf16=True, accel=True)
    assert precision.resolve(torch.device("cuda"), cfg) == accel
    assert precision.resolve("cuda:0") == accel
    assert precision.resolve(torch.device("cpu"), cfg) == F32
    assert precision.resolve(torch.device("cpu"), cfg, train=True) == F32
    for value in ("0", "", "off", "False"):
        monkeypatch.setenv("TPU3D_F32_EVAL", value)
        assert precision.resolve(torch.device("cuda")) == accel
    monkeypatch.setenv("TPU3D_F32_EVAL", "1")
    assert precision.resolve(torch.device("cuda"), cfg) == F32
    cfg.BF16_INFERENCE = True
    assert precision.resolve(torch.device("cuda"), cfg) == BF16_DENSE
    assert precision.resolve(torch.device("cpu"), cfg) == BF16_DENSE
    monkeypatch.delenv("TPU3D_F32_EVAL")
    assert precision.resolve(torch.device("cuda"), cfg) == Precision(
        True, True, True, torch.bfloat16, torch.bfloat16, accel=True)
    assert F32.is_f32 and not accel.is_f32


def test_linear_is_flax_dense():
    """``precision.linear`` against flax's Dense: dtype None promotes a bf16
    input to f32 (equal to the f32 layer on the rounded input, 1e-6), dtype
    bf16 sums bf16 products in f32, rounds, and adds the bias in bf16
    (the bf16 grade of ``_bf16_close``)."""
    import flax.linen as nn

    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 48)).astype(np.float32)
    w = rng.normal(size=(48, 32)).astype(np.float32)
    b = rng.normal(size=32).astype(np.float32)
    variables = {"params": {"kernel": w, "bias": b}}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    for dtype, tdtype in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = nn.Dense(32, dtype=dtype).apply(variables, xb)
        got = precision.linear(T(x).to(torch.bfloat16), T(w.T.copy()), T(b),
                               tdtype)
        assert str(got.dtype).endswith(str(want.dtype)), (got.dtype,
                                                          want.dtype)
        if dtype is None:
            np.testing.assert_allclose(_f32(got.float()), _f32(want),
                                       rtol=1e-6, atol=1e-5)
        else:
            _bf16_close(got.float().numpy(), want)


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("route", ["onehot", "pallas", "gather"])
def test_three_interpolate_bf16_matches_tpu3d(route):
    """Kernel 3's bf16 form: its plain version against tpu3d's one-hot
    twin (N <= 1024), its Pallas kernel in interpret mode (a wide table), and
    its gather route (f32 weights, f32 out), at the bf16 grade."""
    rng = np.random.default_rng({"onehot": 1, "pallas": 2, "gather": 3}[route])
    B, N, M, C = {"onehot": (2, 256, 512, 64), "pallas": (2, 1152, 256, 128),
                  "gather": (2, 1152, 256, 24)}[route]
    f = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = np.stack([rng.choice(N, 3, replace=False)
                    for _ in range(B * M)]).reshape(B, M, 3).astype(np.int32)
    w = rng.random((B, M, 3)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    fb = jnp.asarray(f).astype(jnp.bfloat16)
    assert interpolate.rounds_weights(N, C, M) == (route != "gather")
    if route == "onehot":
        want = jax_interpolate._three_interpolate_onehot(fb, idx, w)
    elif route == "pallas":
        want = jax_interpolate._three_interpolate_pallas(fb, idx, w, True)
    else:  # tpu3d's CPU path: the gather route
        want = jax_interpolate.three_interpolate(fb, idx, w)
    got = interpolate.three_interpolate_bf16(T(f).to(torch.bfloat16), T(idx),
                                             T(w))
    assert got.dtype == (torch.float32 if route == "gather"
                         else torch.bfloat16)
    assert str(want.dtype) == str(got.dtype).split(".")[-1]
    if route == "gather":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    else:
        _bf16_close(got.float().numpy(), want)


# (R, M, S, C1, C2, C3): default.yaml's RCNN SA_0 (128 -> 128 -> 128) and
# SA_1 (128 -> 256), and smoke.yaml's S = 16, at small R and M
FUSED_SHAPES = [(2, 8, 64, 128, 128, 128), (2, 16, 16, 128, 128, 256)]


def _fused_case(shape, seed):
    R, M, S, C1, C2, C3 = shape
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(size=(C1, C2)) / np.sqrt(C1)).astype(np.float32)
    w2 = (rng.normal(size=(C2, C3)) / np.sqrt(C2)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=C2)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=C3)).astype(np.float32)
    return rng, w1, b1, w2, b2


@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=str)
def test_fused_gather_bf16_matches_pallas(shape):
    """Kernel 5's bf16 form (``_nobn2_eval_kernel``): random pre (not
    bf16-exact, rounded as tpu3d's caller rounds it) and an f32 center,
    against the Pallas kernel in interpret mode."""
    R, M, S, C1, _, _ = shape
    rng, w1, b1, w2, b2 = _fused_case(shape, 11)
    N = 128
    pre = rng.normal(size=(R, N, C1)).astype(np.float32)
    idx = rng.integers(0, N, size=(R, M, S)).astype(np.int32)
    center = (0.5 * rng.normal(size=(R, M, C1))).astype(np.float32)
    want = jax_fused_sa.fused_gathered_mlp_pool(
        jnp.asarray(pre).astype(jnp.bfloat16), idx, center, w1, b1, w2, b2,
        train=False, interpret=True)
    got = fused_sa.fused_gathered_mlp_pool_bf16(
        T(pre).to(torch.bfloat16), T(idx), T(center).to(torch.bfloat16),
        T(w1), T(b1), T(w2), T(b2))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    _bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=str)
def test_fused_slab_bf16_matches_pallas(shape):
    """Kernel 8's bf16 form (``_nobn_eval_kernel``) on a random bf16 slab,
    against the Pallas kernel in interpret mode."""
    R, M, S, C1, _, _ = shape
    rng, w1, b1, w2, b2 = _fused_case(shape, 12)
    x0 = rng.normal(size=(R, M, S, C1)).astype(np.float32)
    want = jax_fused_sa.fused_mlp_pool(
        jnp.asarray(x0).astype(jnp.bfloat16), w1, b1, w2, b2, train=False,
        interpret=True)
    got = fused_sa.fused_mlp_pool_bf16(T(x0).to(torch.bfloat16), T(w1),
                                       T(b1), T(w2), T(b2))
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=str)
def test_fused_bn_bf16_matches_pallas(shape):
    """Kernel 9's bf16 eval form (``_eval_chain_kernel``) with running
    statistics away from the identity, against the Pallas kernel in
    interpret mode."""
    R, M, S, C1, C2, C3 = shape
    rng, w1, _, w2, _ = _fused_case(shape, 13)
    x0 = rng.normal(size=(R, M, S, C1)).astype(np.float32)
    gammas = [rng.uniform(0.5, 1.5, c).astype(np.float32)
              for c in (C1, C2, C3)]
    betas = [(0.2 * rng.normal(size=c)).astype(np.float32)
             for c in (C1, C2, C3)]
    stats = [((0.2 * rng.normal(size=c)).astype(np.float32),
              rng.uniform(0.5, 2.0, c).astype(np.float32))
             for c in (C1, C2, C3)]
    want = jax_fused_sa.fused_bn_mlp_pool(
        jnp.asarray(x0).astype(jnp.bfloat16), w1, w2, tuple(gammas),
        tuple(betas), stats=tuple(stats), interpret=True)
    got = fused_sa.fused_bn_mlp_pool_bf16(
        T(x0).to(torch.bfloat16), T(w1), T(w2), [T(g) for g in gammas],
        [T(b) for b in betas], [(T(m), T(v)) for m, v in stats])
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(), want)


def test_roipool_hilo_table_matches_tpu3d():
    """The single bf16 gather of the hi/lo table: the port's table and
    pooled rows equal tpu3d's ``roipool3d(split="features")`` on the same
    table, and hi + lo gives the coordinates back within 1e-3 m of the f32
    pool's (tpu3d's own bound, point_rcnn.py:112-117)."""
    rng = np.random.default_rng(5)
    B, N, C, M, K = 2, 512, 6, 16, 32
    xyz = rng.uniform([-30, -1, 0], [30, 3, 70], size=(B, N, 3)).astype(
        np.float32)
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    centers = xyz[:, rng.integers(0, N, M)]
    rois = np.concatenate([centers, rng.uniform(2, 6, (B, M, 3)),
                           rng.uniform(-3, 3, (B, M, 1))], -1).astype(
                               np.float32)
    table = bf16_table(T(xyz), T(feats))
    hi = jnp.asarray(xyz).astype(jnp.bfloat16)
    lo = (jnp.asarray(xyz) - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    jtable = jnp.concatenate([hi, lo, jnp.asarray(feats).astype(
        jnp.bfloat16)], -1)
    np.testing.assert_array_equal(table.float().numpy(), _f32(jtable))
    _, jpooled, jempty = jax_roipool3d(xyz, jtable, rois, 1.0, K,
                                       split="features")
    pooled, empty = roipool3d_table(T(xyz), table, T(rois), 1.0, K)
    assert pooled.dtype == torch.bfloat16
    np.testing.assert_array_equal(empty.numpy(), np.asarray(jempty))
    assert (~empty).any()
    np.testing.assert_array_equal(pooled.float().numpy(), _f32(jpooled))
    f32_xyz, _, _ = jax_roipool3d(xyz, feats, rois, 1.0, K, split=True)
    back = pooled[..., 0:3].float() + pooled[..., 3:6].float()
    np.testing.assert_allclose(back.numpy(), np.asarray(f32_xyz), rtol=0,
                               atol=1e-3)


# ---------------------------------------------------------------- networks


def _run_tpu3d(bn: bool, bf16_inference: bool, force_fused: bool):
    """tpu3d's joint eval forward of ``_tiny_cfg`` on numpy weights, with
    TPU3D_FORCE_FUSED_SA set around it where asked, and the port's model on
    the same weights: (port model, scenes, tpu3d outputs)."""
    jcfg = _tiny_cfg(rcnn=True, points=1024)
    jcfg.RCNN.USE_BN = bn
    jcfg.BF16_INFERENCE = bf16_inference
    pts = random_scenes(2, 1024, seed=4)
    rng = np.random.default_rng(4)
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TEST")
    shapes = jax.eval_shape(lambda p: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, {"pts_input": p}, train=False), pts)
    params, stats = _numpy_variables(shapes, rng)
    with pytest.MonkeyPatch.context() as mp:
        if force_fused:
            mp.setenv("TPU3D_FORCE_FUSED_SA", "1")
        else:
            mp.delenv("TPU3D_FORCE_FUSED_SA", raising=False)
        jout = jax.device_get(jax.jit(lambda v, p: jmodel.apply(
            v, {"pts_input": p}, train=False))(
                {"params": params, "batch_stats": stats}, pts))
    model = PointRCNN(_port_cfg(jcfg), mode="TEST", device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    return model, pts, jout


@pytest.fixture(scope="module", params=[False, True], ids=["nobn", "bn"])
def sa_casts_pair(request):
    return _run_tpu3d(request.param, False, True)


@pytest.fixture(scope="module")
def bf16_dense_pair():
    return _run_tpu3d(False, True, False)


def _stage(model, jout, prec):
    """The port's RCNN stage on tpu3d's rois, backbone outputs and scores."""
    return model.rcnn_stage(*(torch.tensor(jout[k]) for k in (
        "backbone_xyz", "backbone_features")),
        torch.tensor(jout["rpn_cls"][..., 0]), torch.tensor(jout["rois"]),
        precision=prec)


def _held(got, f32, want, tol, margin):
    """got within ``tol`` of want's largest value, and the f32 path at least
    ``margin`` times further from want than got is."""
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)
    assert np.abs(f32 - want).max() >= margin * err, (
        np.abs(f32 - want).max(), err)


def test_rpn_sa_casts_match_tpu3d(sa_casts_pair):
    """The RPN under the set-abstraction casts (the pre-grouped levels'
    grouped pre-activations to bf16 after the cancellation) against tpu3d's
    forward with TPU3D_FORCE_FUSED_SA=1."""
    model, pts, jout = sa_casts_pair
    with torch.no_grad():
        got = model.rpn(T(pts), precision=SA_CASTS)
        f32 = model.rpn(T(pts))
    for key in ("backbone_features", "rpn_cls", "rpn_reg"):
        assert got[key].dtype == torch.float32
        _held(got[key].numpy(), f32[key].numpy(), jout[key], 1e-5, 100)


def test_rcnn_stage_sa_casts_match_tpu3d(sa_casts_pair):
    """The RCNN stage under the set-abstraction casts (the canonical levels'
    pre-activations to bf16 before the gather, the fused routes on the bf16
    forms: gather and slab without BatchNorm, the BatchNorm slab with it),
    fed tpu3d's pooled inputs, against tpu3d with TPU3D_FORCE_FUSED_SA=1."""
    model, _, jout = sa_casts_pair
    bn = model.cfg.RCNN.USE_BN
    with torch.no_grad():
        got, f32 = _stage(model, jout, SA_CASTS), _stage(model, jout, F32)
    for key in ("rcnn_cls", "rcnn_reg"):
        _held(got[key].numpy(), f32[key].numpy(), jout[key],
              1e-2 if bn else 2e-3, 3 if bn else 5)


def test_bf16_inference_matches_tpu3d(bf16_dense_pair):
    """``BF16_INFERENCE: True`` on the CPU in both packages (tpu3d's gate
    does not look at the backend): the RCNN stage on tpu3d's inputs and the
    RPN's outputs, the heads promoted to f32."""
    model, pts, jout = bf16_dense_pair
    assert precision.resolve("cpu", model.cfg) == BF16_DENSE
    with torch.no_grad():
        got, f32 = _stage(model, jout, BF16_DENSE), _stage(model, jout, F32)
        rpn = model.rpn(T(pts), precision=BF16_DENSE)
        rpn32 = model.rpn(T(pts))
    for key in ("rcnn_cls", "rcnn_reg"):
        assert got[key].dtype == torch.float32
        _held(got[key].numpy(), f32[key].numpy(), jout[key], 5e-3, 4)
    for key in ("backbone_features", "rpn_cls", "rpn_reg"):
        assert rpn[key].dtype == torch.float32
        _held(rpn[key].numpy(), rpn32[key].numpy(), jout[key], 5e-2, 2)


def test_accelerator_contract_runs_on_cpu(sa_casts_pair, monkeypatch):
    """The whole accelerator contract (the SA casts, the bf16 FP sources and
    the hi/lo ROI table) through ``make_infer_step`` on the CPU's plain
    versions: the same keys and shapes as the f32 step, finite, its RCNN
    logits near the f32 ones; and the step resolves f32 on the CPU when
    given no contract."""
    model, pts, _ = sa_casts_pair
    cfg = model.cfg
    accel = Precision(sa_bf16=True, fp_bf16=True, roi_bf16=True, accel=True)
    monkeypatch.delenv("TPU3D_F32_EVAL", raising=False)
    with torch.no_grad():
        got = make_infer_step(model, cfg, precision=accel)(T(pts))
        want = make_infer_step(model, cfg)(T(pts))
        plain = model({"pts_input": T(pts)})
    np.testing.assert_array_equal(want["raw_scores"].numpy(),
                                  plain["rcnn_cls"].reshape(
                                      want["raw_scores"].shape).numpy())
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == \
            want[k].dtype, k
        if got[k].is_floating_point():
            assert torch.isfinite(got[k]).all(), k
    assert not torch.equal(got["raw_scores"], want["raw_scores"])
