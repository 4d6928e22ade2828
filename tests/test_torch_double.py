"""configs/double.yaml's pieces of the port against tpu3d on the CPU: the
standalone three_nn (kernel 10's plain version), the split route of
FPS + 3-NN that SA_0 takes at 32768 points and 16 scenes, the route
predicate, and the double.yaml slice at cut depth.

Inputs are numpy clouds and numpy weights, carried over with
``params_from_jax``. Tolerances, each with its reason:

- three_nn: ids equal, distances within 1e-6 relative (tpu3d's CPU path
  sums d² in XLA's order and takes approx_min_k, exact on the CPU; ties of
  equal d² are held on duplicated points against the stable oracles only,
  since approx_min_k orders equal d² in no fixed way);
- the split route: picks and nn ids equal, nn_d2 within 1e-6 relative;
- the slice's eval outputs within 1e-4 absolute and relative (f32 sums in
  another order in XLA and in PyTorch, as the other slices), its RPN
  train-mode loss and gradients in float64 within 1e-7 relative plus 1e-9
  of the largest gradient, as test_torch_train.py holds them.
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
from tpu3d.models.train_functions import (generate_rpn_labels_device,
                                          model_loss)
from tpu3d.ops import interpolate as jax_interp
from tpu3d.ops import sampling as jax_sampling
from tpu3d_torch.datasets import random_scenes, train_batch
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.models import train_functions as tf
from tpu3d_torch.ops import fused_route, sampling, three_nn
from tpu3d_torch.weights import params_from_jax, params_to_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy


def _clouds(seed, B, M, N, scale=20.0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, M, 3)) * scale).astype(np.float32),
            (rng.normal(size=(B, N, 3)) * scale).astype(np.float32))


THREE_NN_SHAPES = [(2, 256, 100), (2, 200, 64), (1, 384, 1000),
                   (2, 130, 300), (1, 1000, 4096)]


@pytest.mark.parametrize("B,M,N", THREE_NN_SHAPES)
def test_three_nn_matches_tpu3d(B, M, N):
    """The port's three_nn against tpu3d's on the CPU (approx_min_k, exact
    there) and against three_nn_numpy: ids equal, distances within 1e-6
    relative."""
    u, k = _clouds(B * M + N, B, M, N)
    d2, idx = (t.numpy() for t in three_nn(T(u), T(k)))
    dist = np.sqrt(np.maximum(d2, 0.0))
    jd, ji = jax.device_get(jax_interp.three_nn(
        jnp.asarray(u), jnp.asarray(k), differentiable=False))
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_allclose(dist, jd, rtol=1e-6)
    nd, ni = jax_interp.three_nn_numpy(u, k)
    np.testing.assert_array_equal(idx, ni)
    np.testing.assert_allclose(dist, nd, rtol=1e-6)


@pytest.mark.parametrize("B,M,N", THREE_NN_SHAPES[:4])
def test_three_nn_matches_pallas_interpret(B, M, N):
    """Against the TPU kernel itself in interpret mode, which returns d²:
    ids equal, d² within 1e-6 relative."""
    u, k = _clouds(B + M + N, B, M, N)
    d2, idx = (t.numpy() for t in three_nn(T(u), T(k)))
    jd2, ji = jax.device_get(jax_interp._three_nn_pallas(
        jnp.asarray(u), jnp.asarray(k), interpret=True))
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_allclose(d2, jd2, rtol=1e-6)


def test_three_nn_ties_go_to_the_lowest_index():
    """Known points repeated (each distinct point three to five times), so
    most queries meet equal d²: ids equal to three_nn_numpy's stable sort
    and to the Pallas kernel's, which both tie to the lowest index."""
    rng = np.random.default_rng(5)
    u, base = _clouds(5, 2, 256, 40)
    k = base[:, rng.integers(0, 40, size=160)]
    idx = three_nn(T(u), T(k))[1].numpy()
    _, ni = jax_interp.three_nn_numpy(u, k)
    np.testing.assert_array_equal(idx, ni)
    ji = jax.device_get(jax_interp._three_nn_pallas(
        jnp.asarray(u), jnp.asarray(k), interpret=True)[1])
    np.testing.assert_array_equal(idx, ji)
    near = np.stack([k[b][idx[b]] for b in range(2)])  # (2, 256, 3, 3)
    assert (near[:, :, 0] == near[:, :, 1]).all(-1).any()  # real ties


@pytest.mark.parametrize("B,N,npoint", [(2, 1024, 256), (2, 300, 64),
                                        (1, 4096, 1024), (3, 200, 3)])
def test_split_route_matches_tpu3d(B, N, npoint):
    """The port's split route (FPS, gather, three_nn, nn_d2 = dist²) against
    tpu3d's furthest_point_sample_with_3nn on the CPU, which always takes
    it: picks and nn ids equal, nn_d2 within 1e-6 relative."""
    xyz = np.random.default_rng(N + npoint).uniform(
        [-30, -1, 0], [30, 3, 70], size=(B, N, 3)).astype(np.float32)
    got = [t.numpy() for t in sampling.fps_then_three_nn(T(xyz), npoint)]
    ref = jax.device_get(jax_sampling.furthest_point_sample_with_3nn(
        jnp.asarray(xyz), npoint))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, atol=1e-12)


def test_split_route_sqrt_is_correctly_rounded():
    """The split route's square root equals the float64 root rounded to
    float32 (the correctly rounded one, as numpy gives it) on values over
    many binades, subnormals and exact squares included, so nn_d2 has the
    same bits on the card and the CPU."""
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.uniform(0, 1e4, 1 << 18),
                        rng.uniform(0, 1e-36, 1 << 12),
                        10.0 ** rng.uniform(-30, 30, 1 << 16),
                        [0.0, 1.0, 4.0, 2.0, 3e38, 1e-45]]).astype(np.float32)
    ref = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(sampling._sqrt_rn(T(x)).numpy(), ref)


def _tpu3d_takes_fused(monkeypatch, B, N, npoint):
    """tpu3d's own dispatch in furthest_point_sample_with_3nn, traced as on
    a TPU with every kernel stubbed: True if it calls the fused kernel."""
    seen = []

    def fused(xyz, npoint):
        seen.append("fused")
        return (jnp.zeros((B, npoint), jnp.int32),
                jnp.zeros((B, N, 3), jnp.float32),
                jnp.zeros((B, N, 3), jnp.int32))

    def fps(xyz, npoint):
        seen.append("split")
        return jnp.zeros((B, npoint), jnp.int32)

    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        m.delenv("TPU3D_DISABLE_PALLAS", raising=False)
        m.setattr(jax_sampling, "_fps3nn_pallas", fused)
        m.setattr(jax_sampling, "furthest_point_sample", fps)
        m.setattr(jax_interp, "three_nn", lambda u, k, differentiable: (
            jnp.zeros(u.shape), jnp.zeros(u.shape, jnp.int32)))
        jax.eval_shape(lambda x: jax_sampling.furthest_point_sample_with_3nn
                       .__wrapped__(x, npoint),
                       jax.ShapeDtypeStruct((B, N, 3), jnp.float32))
    assert len(seen) == 1
    return seen[0] == "fused"


@pytest.mark.parametrize("B,N,npoint,fused", [
    (16, 32768, 4096, False),  # double.yaml train, SA_0
    (4, 32768, 4096, True),  # double.yaml eval, SA_0
    (16, 16384, 4096, True),  # default.yaml train, SA_0
    (16, 4096, 1024, True),
    (13, 32768, 4096, True), (14, 32768, 4096, False),  # the VMEM edge
    (2, 1024, 256, True), (2, 256, 64, True),
    (2, 128, 32, False), (2, 64, 16, False),  # N < 256
    (2, 300, 64, False), (2, 1000, 64, False),  # N % 128 != 0
    (2, 1024, 2, False),  # npoint < 3
])
def test_route_predicate_matches_tpu3d(monkeypatch, B, N, npoint, fused):
    """The port's fused_route against tpu3d's dispatch (as it runs on a
    TPU) at each shape."""
    assert fused_route(B, N, npoint) == fused
    assert _tpu3d_takes_fused(monkeypatch, B, N, npoint) == fused


def _double_cfg(rcnn=True):
    """configs/double.yaml as shipped, cut in depth only: 2048 points,
    NPOINTS 512/128/32/16, 128 RCNN points per ROI, 16 ROIs per scene."""
    jcfg = jax_cfg_from_file(str(ROOT / "configs" / "double.yaml"),
                             jax_fresh_cfg())
    assert jcfg.RPN.NUM_POINTS == 32768
    jcfg.RPN.NUM_POINTS = 2048
    jcfg.RPN.SA_CONFIG.NPOINTS = [512, 128, 32, 16]
    jcfg.RCNN.NUM_POINTS = 128
    jcfg.RCNN.ROI_PER_IMAGE = 16
    jcfg.RCNN.ENABLED = rcnn
    for mode in (jcfg.TRAIN, jcfg.TEST):
        mode.RPN_PRE_NMS_TOP_N = 1000
        mode.RPN_POST_NMS_TOP_N = 16
    return jcfg


def _split_at_sa0(stack):
    """Route SA_0 (2048 points) of the port through the split route, as a
    16-scene batch of 32768 points takes it; record the split calls."""
    calls = []
    route, split = sampling.fused_route, sampling.fps_then_three_nn

    def recording(xyz, npoint):
        calls.append(xyz.shape[1])
        return split(xyz, npoint)

    stack.setattr(sampling, "fused_route",
                  lambda B, N, npoint: N != 2048 and route(B, N, npoint))
    stack.setattr(sampling, "fps_then_three_nn", recording)
    return calls


@pytest.fixture(scope="module")
def double_eval():
    """tpu3d's and the port's joint eval forward on the cut double.yaml,
    the same numpy weights and scenes, the port's SA_0 on the split
    route."""
    jcfg = _double_cfg()
    pts = random_scenes(2, 2048, seed=8)
    rng = np.random.default_rng(8)
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TEST")
    shapes = jax.eval_shape(lambda p: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, {"pts_input": p}, train=False), pts)
    params, stats = _numpy_variables(shapes, rng)
    jout = jax.device_get(jax.jit(lambda v, p: jmodel.apply(
        v, {"pts_input": p}, train=False))(
            {"params": params, "batch_stats": stats}, pts))
    cfg = _port_cfg(jcfg)
    model = PointRCNN(cfg, mode="TEST", device="cpu")
    state = params_from_jax(params, stats)
    model.load_state_dict(state)
    with pytest.MonkeyPatch.context() as m:
        calls = _split_at_sa0(m)
        with torch.no_grad():
            out = model({"pts_input": T(pts)})
    return model, state, jout, {k: v.numpy() for k, v in out.items()}, calls


def test_double_params_carry_over(double_eval):
    """double.yaml's flax tree is default.yaml's: params_from_jax gives
    every key of the port's state_dict, with its shape."""
    model, state, _, _, calls = double_eval
    ours = model.state_dict()
    assert set(state) == set(ours)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(ours[k].shape), k
    assert calls == [2048, 128, 32]  # SA_0 split; N < 256 splits anyway


def test_double_rpn_outputs_match(double_eval):
    """The RPN's heads and points within 1e-4 abs + 1e-4 rel; the backbone
    features, which reach ~100 after eval BatchNorm with random statistics,
    within 1e-4 rel + 1e-5 of their largest value (a few of 0.5 M f32
    features sit 2-4e-4 off at values near 1, on every route); the
    proposals' valid mask and the seg mask equal."""
    _, _, jout, out, _ = double_eval
    for key in ("backbone_xyz", "rpn_cls", "rpn_reg"):
        np.testing.assert_allclose(out[key], jout[key], **TOL, err_msg=key)
    ref = jout["backbone_features"]
    np.testing.assert_allclose(out["backbone_features"], ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(out["roi_valid"], jout["roi_valid"])
    np.testing.assert_array_equal(out["seg_result"], jout["seg_result"])
    assert out["roi_valid"].any()


def test_double_rcnn_stage_matches(double_eval):
    """tpu3d's rois, backbone outputs and raw scores through the port's ROI
    pool and RCNN: rcnn_cls / rcnn_reg within 1e-4 abs + 1e-4 rel, the
    empty flags equal."""
    model, _, jout, _, _ = double_eval
    with torch.no_grad():
        out = model.rcnn_stage(*(torch.tensor(a) for a in (
            jout["backbone_xyz"], jout["backbone_features"],
            jout["rpn_cls"][..., 0], jout["rois"])))
    np.testing.assert_array_equal(out["pooled_empty_flag"].numpy(),
                                  jout["pooled_empty_flag"])
    for key in ("rcnn_cls", "rcnn_reg"):
        np.testing.assert_allclose(out[key].numpy(), jout[key], **TOL,
                                   err_msg=key)
    assert (~jout["pooled_empty_flag"]).sum() > 4


def double_rpn_train_case():
    """One train-mode RPN forward and backward of the RPN loss on the cut
    double.yaml, float64 on both sides, the port's SA_0 on the split route:
    (loss, gradients as a flax tree, tpu3d's loss, tpu3d's gradients)."""
    jcfg = _double_cfg(rcnn=False)
    jcfg.RPN.DP_RATIO = 0.0
    batch = train_batch(2, 2048, seed=9)
    pts = batch["pts_input"].astype(np.float64)
    gt = batch["gt_boxes3d"].astype(np.float64)
    with _x64():
        jmodel = JaxPointRCNN(cfg=jcfg, mode="TRAIN")
        shapes = jax.eval_shape(lambda p: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, {"pts_input": p},
            train=False), pts.astype(np.float32))
        params, stats = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64),
            _numpy_variables(shapes, np.random.default_rng(9)))
        cls_l, reg_l = jax.vmap(generate_rpn_labels_device)(pts, gt)
        labels = {"rpn_cls_label": cls_l, "rpn_reg_label": reg_l}

        def loss_fn(p):
            out, _ = jmodel.apply(
                {"params": p, "batch_stats": stats}, {"pts_input": pts},
                train=True, bn_momentum=0.9, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(1)})
            return model_loss(jcfg, out, labels)[0]

        jloss, jgrads = jax.device_get(jax.jit(jax.value_and_grad(loss_fn))(
            params))
        labels = jax.device_get(labels)

    cfg = _port_cfg(jcfg)
    model = PointRCNN(cfg, mode="TRAIN", device="cpu").double()
    model.load_state_dict({k: v.double() for k, v in
                           params_from_jax(params, stats).items()})
    with pytest.MonkeyPatch.context() as m:
        calls = _split_at_sa0(m)
        out = model({"pts_input": T(pts)}, train=True, bn_momentum=0.9)
    assert calls[0] == 2048
    loss, _ = tf.model_loss(cfg, out, {k: T(np.asarray(v))
                                       for k, v in labels.items()})
    loss.backward()
    grads, _ = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    return loss.item(), grads, float(jloss), jgrads


def test_double_rpn_train_gradients_match():
    """double_rpn_train_case: the loss within 1e-9 relative, every gradient
    within 1e-7 relative plus 1e-9 of the largest."""
    loss, grads, jloss, jgrads = double_rpn_train_case()
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    ours, ref = dict(_flat(grads)), dict(_flat(jgrads))
    assert set(ours) == set(ref)
    scale = max(np.abs(b).max() for b in ref.values())
    assert scale > 0
    for k, b in ref.items():
        np.testing.assert_allclose(ours[k], b, rtol=1e-7, atol=1e-9 * scale,
                                   err_msg=k)
