"""The port's joint PointRCNN eval path (RPN, proposals, ROI pooling, RCNN
refinement, final rotated NMS) against tpu3d's on the CPU.

Both packages run the same weights (drawn with numpy for the flax tree's
shapes, carried over with ``params_from_jax``) on the same planted-cluster
scenes at ``_tiny_cfg(rcnn=True, points=1024)``. RPN scores differ by about
1e-6 between the packages, which can swap two proposals, so the RCNN stage
is held on identical inputs: tpu3d's rois, backbone points and features and
raw RPN scores go into the port's ``rcnn_stage``. Tolerances: 1e-4 absolute
and relative on ``rcnn_cls`` / ``rcnn_reg`` (f32 matmuls summed in another
order in XLA and in PyTorch), 1e-5 on the decoded final boxes and scores;
the empty-ROI flags and the final keep mask must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from test_torch_rpn import _numpy_variables, _port_cfg
from tpu3d.models import PointRCNN as JaxPointRCNN
from tpu3d.tools.eval_rcnn import rcnn_decode_and_nms as jax_decode_and_nms
from tpu3d_torch.datasets import random_scenes
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.tools.eval_rcnn import make_infer_step, rcnn_decode_and_nms
from tpu3d_torch.weights import params_from_jax, seeded_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)
INFER_KEYS = {"final_boxes", "final_scores", "final_mask", "pred_boxes3d",
              "norm_scores", "raw_scores", "rois", "roi_scores_raw",
              "roi_valid", "seg_result"}


def run_joint():
    """tpu3d's joint eval forward and decode tail, and the port's model on
    the same weights: (port cfg, port model, scenes, tpu3d forward outputs,
    tpu3d decode outputs, the carried-over state dict)."""
    jcfg = _tiny_cfg(rcnn=True, points=1024)
    pts = random_scenes(2, 1024, seed=4)
    rng = np.random.default_rng(4)
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TEST")
    shapes = jax.eval_shape(lambda p: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, {"pts_input": p}, train=False), pts)
    params, stats = _numpy_variables(shapes, rng)
    forward = jax.jit(lambda v, p: jmodel.apply(v, {"pts_input": p},
                                                train=False))
    # random weights leave every RCNN logit near -27; shift the cls output
    # bias so that the median logit is 0 and the score threshold and the
    # final NMS both have work to do
    cls_out = params["rcnn_net"]["cls_head"]["out"]
    cls_out["bias"] = cls_out["bias"] - np.median(jax.device_get(forward(
        {"params": params, "batch_stats": stats}, pts))["rcnn_cls"])
    variables = {"params": params, "batch_stats": stats}
    jout = jax.device_get(forward(variables, pts))
    b, m = jout["rois"].shape[:2]
    jdec = jax.device_get(jax.jit(lambda o: jax_decode_and_nms(
        jcfg, o["rois"], o["rcnn_cls"].reshape(b, m),
        o["rcnn_reg"].reshape(b, m, -1), o["roi_valid"]))(jout))

    cfg = _port_cfg(jcfg)
    model = PointRCNN(cfg, mode="TEST", device="cpu")
    state = params_from_jax(params, stats)
    model.load_state_dict(state)
    return cfg, model, pts, jout, jdec, state


@pytest.fixture(scope="module")
def joint_pair():
    return run_joint()


def test_params_from_jax_carries_the_joint_tree(joint_pair):
    """Every flax parameter and statistic of the joint model has a key in
    the port's state_dict of the same shape, and nothing is left over."""
    _, model, _, _, _, state = joint_pair
    ours = model.state_dict()
    assert set(state) == set(ours)
    assert any(k.startswith("rcnn_net.sa_0.mlp_0.dense_1") for k in state)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(ours[k].shape), k


def test_rcnn_stage_matches_on_identical_rois(joint_pair):
    """tpu3d's rois, backbone outputs and raw RPN scores through the port's
    ROI pooling and RCNN network: rcnn_cls / rcnn_reg within 1e-4 abs +
    1e-4 rel, empty-ROI flags and the seg mask equal."""
    _, model, _, jout, _, _ = joint_pair
    out = model.rcnn_stage(*(torch.tensor(a) for a in (
        jout["backbone_xyz"], jout["backbone_features"],
        jout["rpn_cls"][..., 0], jout["rois"])))
    np.testing.assert_array_equal(out["pooled_empty_flag"].numpy(),
                                  jout["pooled_empty_flag"])
    np.testing.assert_array_equal(out["seg_result"].numpy(),
                                  jout["seg_result"])
    for key in ("rcnn_cls", "rcnn_reg"):
        np.testing.assert_allclose(out[key].numpy(), jout[key], **TOL,
                                   err_msg=key)
    assert (~jout["pooled_empty_flag"]).sum() > 10  # real pooled groups


def test_decode_and_nms_matches(joint_pair):
    """tpu3d's rcnn_cls / rcnn_reg / rois through the port's decode, score
    threshold and rotated NMS: final_mask equal, final_boxes and
    final_scores within 1e-5."""
    cfg, _, _, jout, jdec, _ = joint_pair
    b, m = jout["rois"].shape[:2]
    got = rcnn_decode_and_nms(
        cfg, torch.tensor(jout["rois"]),
        torch.tensor(jout["rcnn_cls"].reshape(b, m)),
        torch.tensor(jout["rcnn_reg"].reshape(b, m, -1)),
        torch.tensor(jout["roi_valid"]))
    np.testing.assert_array_equal(got["final_mask"].numpy(),
                                  jdec["final_mask"])
    for key in ("final_boxes", "final_scores", "pred_boxes3d",
                "norm_scores"):
        np.testing.assert_allclose(got[key].numpy(), jdec[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    kept = int(jdec["final_mask"].sum())
    above = int(((jdec["norm_scores"] > cfg.RCNN.SCORE_THRESH)
                 & jout["roi_valid"]).sum())
    assert 0 < kept < above  # some boxes kept, some suppressed


def test_infer_step_runs_on_cpu(joint_pair):
    """The port's whole make_infer_step on the CPU: tpu3d's output keys,
    the expected shapes, finite values, and the final boxes drawn from the
    decoded ones."""
    cfg, model, pts, _, _, _ = joint_pair
    res = make_infer_step(model, cfg)(torch.from_numpy(pts))
    b, n = pts.shape[:2]
    m = cfg.TEST.RPN_POST_NMS_TOP_N
    shapes = {"final_boxes": (b, 100, 7), "final_scores": (b, 100),
              "final_mask": (b, 100), "pred_boxes3d": (b, m, 7),
              "norm_scores": (b, m), "raw_scores": (b, m),
              "rois": (b, m, 7), "roi_scores_raw": (b, m),
              "roi_valid": (b, m), "seg_result": (b, n)}
    assert set(res) == INFER_KEYS
    assert {k: tuple(v.shape) for k, v in res.items()} == shapes
    for key, v in res.items():
        if v.is_floating_point():
            assert torch.isfinite(v).all(), key
    assert res["final_mask"].any()
    for s in range(b):
        kept = res["final_boxes"][s][res["final_mask"][s]]
        assert all((res["pred_boxes3d"][s] == box).all(1).any()
                   for box in kept)


def test_seeded_weights_give_the_focal_prior_to_the_rpn_only(joint_pair):
    """The 1% foreground prior goes to the RPN's cls output bias alone; the
    RCNN's cls output bias starts at 0, as in tpu3d."""
    _, model, _, _, _, _ = joint_pair
    state = seeded_state_dict(model, 0)
    np.testing.assert_allclose(state["rpn.cls_head.out.bias"].numpy(),
                               -np.log(99.0), rtol=1e-6)
    assert (state["rcnn_net.cls_head.out.bias"] == 0).all()
