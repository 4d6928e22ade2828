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
from test_torch_train import _x64

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


# --------------------------------------------------------------------------
# RCNN.USE_INTENSITY in the joint path, with and without rpn_intensity
# --------------------------------------------------------------------------


def intensity_case(with_intensity):
    """tpu3d's joint model with ``RCNN.USE_INTENSITY``, initialised on
    inputs with or without ``rpn_intensity``, and the port's built for the
    same (``intensity_input``), on the same weights and planted-cluster
    batch (2 scenes, dropout 0).

    Eval: tpu3d's eval forward, and its RCNN stage on that forward's rois,
    backbone outputs and scores through tpu3d's own functions one by one
    (the extra features, ``roipool3d``, the canonical transform,
    ``RCNNNet``), as the port runs them: inside the jitted forward XLA
    fuses the canonical transform, whose coordinates then differ by up to
    ~1e-6 m and move a ball query's member in a few of these dense ROIs.

    Train: the port's ``make_train_step`` in float64, recording the point
    features its proposal target layer was handed, the targets it sampled
    and the gradients before the update; tpu3d's side in float64 as its
    joint forward cannot run (its NMS walk under x64), so in the two parts
    its step's loss adds: the RPN in train mode (the features, the extra
    channels, the RPN loss) and the RCNN's loss and gradients on the same
    targets. Float32 train-mode BatchNorm moves the RPN's features by up to
    3e-2 between the packages and flips seg-mask bits (test_torch_train.py
    runs the RPN in float64 for the same reason). -> both sides' results.
    """
    import copy

    import jax.numpy as jnp

    from tpu3d.models import point_rcnn as jax_point_rcnn
    from tpu3d.models.rcnn import RCNNNet as JaxRCNNNet
    from tpu3d.models.train_functions import (generate_rpn_labels_device,
                                              get_rcnn_loss, model_loss)
    from tpu3d.ops.box_geometry import rotate_points_along_y as jax_rotate
    from tpu3d.ops.roipool import roipool3d as jax_roipool3d
    from tpu3d_torch.datasets import train_batch
    from tpu3d_torch.models import point_rcnn
    from tpu3d_torch.parallel import create_train_state, make_train_step
    from tpu3d_torch.parallel import train_state
    from tpu3d_torch.weights import params_to_jax

    jcfg = _tiny_cfg(rcnn=True, points=1024)
    jcfg.RCNN.USE_INTENSITY = True
    jcfg.RPN.DP_RATIO = jcfg.RCNN.DP_RATIO = 0.0
    batch = train_batch(2, 1024, seed=41)
    rng = np.random.default_rng(41)
    inputs = {"pts_input": batch["pts_input"]}
    if with_intensity:
        inputs["rpn_intensity"] = rng.random((2, 1024)).astype(np.float32)
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TEST")
    shapes = jax.eval_shape(lambda i: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, i, train=False), inputs)
    params, stats = _numpy_variables(shapes, rng)
    jout = jax.device_get(jax.jit(lambda v, i: jmodel.apply(
        v, i, train=False))({"params": params, "batch_stats": stats},
                            inputs))
    rois = jnp.asarray(jout["rois"])
    xyz = jnp.asarray(jout["backbone_xyz"])
    extra, _ = jax_point_rcnn.rcnn_extra_features(
        jcfg, jnp.asarray(jout["rpn_cls"][..., 0]), xyz,
        inputs.get("rpn_intensity"))
    pooled, pooled_feats, _ = jax_roipool3d(
        xyz, jnp.concatenate([extra, jout["backbone_features"]], -1), rois,
        float(jcfg.RCNN.POOL_EXTRA_WIDTH), int(jcfg.RCNN.NUM_POINTS),
        split=True)
    pooled = jax_rotate(pooled - rois[:, :, None, 0:3],
                        rois[..., 6][..., None])
    jnet = JaxRCNNNet(cfg=jcfg)
    jstage = jax.device_get(jnet.apply(
        {"params": params["rcnn_net"]},
        (pooled.reshape(-1, *pooled.shape[2:]),
         pooled_feats.reshape(-1, *pooled_feats.shape[2:])), train=False))

    labels = jax.device_get(jax.vmap(generate_rpn_labels_device)(
        batch["pts_input"], batch["gt_boxes3d"]))
    wide = {k: v.astype(np.float64) for k, v in inputs.items()}
    rpn_cfg = copy.deepcopy(jcfg)
    rpn_cfg.RCNN.ENABLED = False
    p64, s64 = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                      (params, stats))
    with _x64():
        rout, _ = jax.device_get(jax.jit(lambda v, i: JaxPointRCNN(
            cfg=rpn_cfg, mode="TRAIN").apply(
                v, i, train=True, bn_momentum=0.9, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(1)}))(
            {"params": {"rpn": p64["rpn"]},
             "batch_stats": {"rpn": s64["rpn"]}}, wide))
        jrpn_loss = float(model_loss(rpn_cfg, rout, {
            "rpn_cls_label": labels[0],
            "rpn_reg_label": labels[1].astype(np.float64)})[0])
        jextra, _ = jax_point_rcnn.rcnn_extra_features(
            jcfg, rout["rpn_cls"][..., 0], rout["backbone_xyz"],
            wide.get("rpn_intensity"))
        want_feature = np.concatenate(
            [np.asarray(jextra), rout["backbone_features"]], -1)

    cfg = _port_cfg(jcfg)
    state = params_from_jax(params, stats)
    model = PointRCNN(cfg, mode="TEST", device="cpu",
                      intensity_input=with_intensity)
    ours = model.state_dict()
    shapes_equal = (set(state) == set(ours) and all(
        tuple(v.shape) == tuple(ours[k].shape) for k, v in state.items()))
    model.load_state_dict(state)
    stage = model.rcnn_stage(*(torch.tensor(a) for a in (
        jout["backbone_xyz"], jout["backbone_features"],
        jout["rpn_cls"][..., 0], jout["rois"])),
        rpn_intensity=(torch.tensor(inputs["rpn_intensity"])
                       if with_intensity else None))

    tmodel = PointRCNN(cfg, mode="TRAIN", device="cpu",
                       intensity_input=with_intensity).double()
    tmodel.load_state_dict({k: v.double() for k, v in state.items()})
    handed, targets, grads = [], [], {}
    real = point_rcnn.proposal_target_layer

    def recording(gen, rois, roi_valid, gt, xyz, pts_feature, c, aug_data):
        handed.append(pts_feature)
        targets.append(real(gen, rois, roi_valid, gt, xyz, pts_feature, c,
                            aug_data=aug_data))
        return targets[-1]

    def summing(ps, mesh):
        grads.update({n: p.grad.clone() for n, p in tmodel.named_parameters()
                      if n.startswith("rcnn_net.")})

    tstate = create_train_state(cfg, tmodel, steps_per_epoch=10,
                                total_epochs=2)
    full = dict(wide, gt_boxes3d=batch["gt_boxes3d"].astype(np.float64),
                rpn_cls_label=labels[0],
                rpn_reg_label=labels[1].astype(np.float64))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(point_rcnn, "proposal_target_layer", recording)
        m.setattr(train_state, "sum_gradients", summing)
        tb = make_train_step(cfg, tmodel)(
            tstate, {k: torch.tensor(np.asarray(v)) for k, v in
                     full.items()},
            torch.Generator().manual_seed(0), 0.9)

    # tpu3d's RCNN loss and gradients on the targets the port sampled
    target = {k: targets[0][k].numpy() for k in (
        "sampled_pts", "pts_feature", "cls_label", "reg_valid_mask",
        "gt_of_rois", "gt_iou", "roi_boxes3d")}
    with _x64():
        rcnn_in = np.concatenate([target["sampled_pts"],
                                  target["pts_feature"]], -1)

        def rcnn_loss(p):
            out = jnet.apply({"params": p}, rcnn_in, train=True)
            return get_rcnn_loss(jcfg, dict(target, **out))[0]

        jrcnn_loss, jgrads = jax.device_get(jax.jit(
            jax.value_and_grad(rcnn_loss))(p64["rcnn_net"]))
    return {"jout": jout, "jstage": jstage, "stage": stage,
            "shapes_equal": shapes_equal, "params": params, "tb": tb,
            "jrpn_loss": jrpn_loss, "jrcnn_loss": float(jrcnn_loss),
            "jgrads": jgrads, "want_feature": want_feature,
            "handed": handed,
            "grads": params_to_jax(grads)[0]["rcnn_net"]}


@pytest.fixture(scope="module", params=[True, False],
                ids=["with_intensity", "without_intensity"])
def intensity_pair(request):
    return request.param, intensity_case(request.param)


def test_intensity_tree_sized_as_tpu3d(intensity_pair):
    """The port's joint model with RCNN.USE_INTENSITY carries tpu3d's whole
    tree, each parameter of its shape: xyz_up takes 3 + 3 channels, and
    merge_down 128 + 128 with rpn_intensity and 128 + 127 without (tpu3d's
    split takes the first RPN feature into the xyz block)."""
    with_intensity, case = intensity_pair
    assert case["shapes_equal"]
    rcnn = case["params"]["rcnn_net"]
    assert rcnn["xyz_up"]["dense_0"]["kernel"].shape[0] == 6
    assert rcnn["merge_down"]["dense_0"]["kernel"].shape[0] == (
        256 if with_intensity else 255)


def test_intensity_eval_matches(intensity_pair):
    """tpu3d's rois, backbone outputs, raw RPN scores and intensity through
    the port's rcnn_stage: rcnn_cls / rcnn_reg within 1e-4 abs + 1e-4 rel
    of tpu3d's stage run one by one, the empty-ROI flags and the seg mask
    equal to its eval forward's."""
    _, case = intensity_pair
    jout, out = case["jout"], case["stage"]
    np.testing.assert_array_equal(out["pooled_empty_flag"].numpy(),
                                  jout["pooled_empty_flag"])
    np.testing.assert_array_equal(out["seg_result"].numpy(),
                                  jout["seg_result"])
    for key in ("rcnn_cls", "rcnn_reg"):
        np.testing.assert_allclose(out[key].numpy(), case["jstage"][key],
                                   **TOL, err_msg=key)
    assert (~jout["pooled_empty_flag"]).sum() > 10


def test_intensity_train_step_matches(intensity_pair):
    """One train step of each package on the same targets, in float64: the
    point features the port's proposal target layer was handed equal
    tpu3d's ([intensity?, seg mask, depth, RPN features]) within 1e-4;
    rpn_loss, rcnn_loss and the loss, their sum, within 1e-4 relative; every
    rcnn_net gradient within 1e-4 of its largest value plus 1e-4
    relative."""
    with_intensity, case = intensity_pair
    (handed,) = case["handed"]
    want = case["want_feature"]
    assert handed.shape[-1] == want.shape[-1] == (131 if with_intensity
                                                  else 130)
    np.testing.assert_allclose(handed.numpy(), want, **TOL)
    tb = case["tb"]
    np.testing.assert_allclose(float(tb["rpn_loss"]), case["jrpn_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(float(tb["rcnn_loss"]), case["jrcnn_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(float(tb["loss"]),
                               case["jrpn_loss"] + case["jrcnn_loss"],
                               rtol=1e-4)
    ours, ref = dict(_flat(case["grads"])), dict(_flat(case["jgrads"]))
    assert set(ours) == set(ref)
    for k, b in ref.items():
        np.testing.assert_allclose(ours[k], b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max() + 1e-12,
                                   err_msg=k)
    assert np.abs(ref["merge_down/dense_0/kernel"]).max() > 0


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)
