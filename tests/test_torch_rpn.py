"""The port's RPN-only eval slice against tpu3d's on the CPU.

Both packages run the same weights (drawn with numpy for the flax tree's
shapes, carried over with ``params_from_jax``) on the same numpy point
clouds. Tolerances: 1e-4
absolute and relative on the network outputs and proposals, for f32 matmuls
and BatchNorm whose sums run in another order in XLA and in PyTorch;
``roi_valid`` and the NMS keeps must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from tpu3d.models import PointRCNN as JaxPointRCNN
from tpu3d.models.proposal import proposal_layer as jax_proposal_layer
from tpu3d_torch.config import fresh_cfg
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.models.proposal import proposal_layer
from tpu3d_torch.tools.eval_rcnn import make_rpn_infer_step
from tpu3d_torch.weights import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)


def _port_cfg(jax_cfg):
    """The same settings in the port's own config tree."""
    c = fresh_cfg()

    def copy(src, dst):
        for k, v in src.items():
            if hasattr(v, "items"):
                copy(v, dst[k])
            else:
                dst[k] = v

    copy(jax_cfg, c)
    return c


def _numpy_variables(shapes, rng):
    """Weights for the flax tree ``shapes`` drawn with numpy, as flax's
    init draws them (He-normal kernels, std 0.001 on the reg head's output
    kernel), with biases, BatchNorm affines and running statistics away from
    the identity, so eval BN is really exercised."""
    def fill(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = fill(v, path + (k,))
                continue
            shape = v.shape
            if k == "kernel" and path[-2:] == ("reg_head", "out"):
                a = rng.normal(0.0, 0.001, shape)
            elif k == "kernel":
                a = rng.normal(0.0, np.sqrt(2.0 / shape[0]), shape)
            elif k in ("scale", "var"):
                a = rng.uniform(0.5, 2.0, shape)
            else:  # bias, mean
                a = rng.normal(0.0, 0.2, shape)
            out[k] = a.astype(np.float32)
        return out

    return fill(shapes["params"]), fill(shapes["batch_stats"])


def run_pair(points: int):
    """tpu3d's and the port's RPN-only eval on the same weights and cloud:
    (tpu3d cfg, port cfg, tpu3d outputs, port model outputs, port
    make_rpn_infer_step outputs)."""
    jcfg = _tiny_cfg(rcnn=False, points=points)
    jcfg.RCNN.ENABLED = False
    rng = np.random.default_rng(points)
    pts = rng.uniform([-30, -1, 0], [30, 3, 70],
                      size=(2, points, 3)).astype(np.float32)
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TEST")
    shapes = jax.eval_shape(lambda p: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, {"pts_input": p}, train=False), pts)
    params, stats = _numpy_variables(shapes, rng)
    jout = jax.device_get(jax.jit(lambda v, p: jmodel.apply(
        v, {"pts_input": p}, train=False))(
            {"params": params, "batch_stats": stats}, pts))

    cfg = _port_cfg(jcfg)
    model = PointRCNN(cfg, mode="TEST", device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    full = model({"pts_input": torch.from_numpy(pts)})
    step = make_rpn_infer_step(model, cfg)(torch.from_numpy(pts))
    tout = {k: v.numpy() for k, v in full.items()}
    return jcfg, cfg, jout, tout, step


@pytest.fixture(scope="module", params=[1024, 4096])
def slice_pair(request):
    return run_pair(request.param)


def test_backbone_and_heads_match(slice_pair):
    _, _, jout, tout, _ = slice_pair
    for key in ("backbone_xyz", "backbone_features", "rpn_cls", "rpn_reg"):
        np.testing.assert_allclose(tout[key], jout[key], **TOL, err_msg=key)


def test_infer_step_outputs(slice_pair):
    _, cfg, _, tout, step = slice_pair
    b, n = tout["rpn_cls"].shape[:2]
    m = cfg.TEST.RPN_POST_NMS_TOP_N
    shapes = {"rois": (b, m, 7), "roi_scores_raw": (b, m),
              "roi_valid": (b, m), "seg_result": (b, n),
              "rpn_scores_raw": (b, n), "backbone_xyz": (b, n, 3),
              "backbone_features": (b, n, cfg.RPN.FP_MLPS[0][-1])}
    assert {k: tuple(v.shape) for k, v in step.items()} == shapes
    np.testing.assert_array_equal(step["rpn_scores_raw"].numpy(),
                                  tout["rpn_cls"][..., 0])
    np.testing.assert_array_equal(step["rois"].numpy(), tout["rois"])


def test_proposals_match(slice_pair):
    """roi_valid and the seg mask straight from both models. The rois are
    ordered by score, and scores that differ by ~1e-6 between XLA and
    PyTorch can swap two neighbours of nearly equal score; so the rois are
    held to tpu3d's through the port's proposal layer fed tpu3d's scores
    with the port's own regression and backbone points."""
    jcfg, cfg, jout, tout, _ = slice_pair
    np.testing.assert_array_equal(tout["roi_valid"], jout["roi_valid"])
    assert tout["roi_valid"].any()
    np.testing.assert_array_equal(tout["seg_result"], jout["seg_result"])
    rois, scores, valid = (t.numpy() for t in proposal_layer(
        torch.tensor(jout["rpn_cls"][..., 0]),
        torch.from_numpy(tout["rpn_reg"]),
        torch.from_numpy(tout["backbone_xyz"]), cfg, "TEST"))
    np.testing.assert_array_equal(valid, jout["roi_valid"])
    np.testing.assert_allclose(rois, jout["rois"], **TOL)
    np.testing.assert_allclose(scores, jout["roi_scores_raw"], **TOL)


def test_proposal_layer_identical_inputs(slice_pair):
    """Identical rpn_cls / rpn_reg / xyz into both proposal layers: the same
    keeps, exactly."""
    jcfg, cfg, _, _, _ = slice_pair
    rng = np.random.default_rng(7)
    b, n = 2, cfg.RPN.NUM_POINTS
    scores = rng.normal(size=(b, n)).astype(np.float32)
    reg = rng.normal(scale=0.5, size=(b, n, 76)).astype(np.float32)
    xyz = rng.uniform([-30, -1, 0], [30, 3, 70],
                      size=(b, n, 3)).astype(np.float32)
    jr = jax.device_get(jax.jit(lambda s, r, x: jax_proposal_layer(
        s, r, x, jcfg, "TEST"))(scores, reg, xyz))
    tr = [t.numpy() for t in proposal_layer(
        torch.from_numpy(scores), torch.from_numpy(reg),
        torch.from_numpy(xyz), cfg, "TEST")]
    np.testing.assert_array_equal(tr[2], jr[2])
    np.testing.assert_array_equal(tr[1], jr[1])
    np.testing.assert_allclose(tr[0], jr[0], rtol=1e-5, atol=1e-5)
