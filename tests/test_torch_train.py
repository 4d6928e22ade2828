"""The port's training step against tpu3d's on the CPU: whole-network
gradients, and one train_step in each training mode.

Both packages run the same weights (drawn with numpy for the flax tree's
shapes, carried over with ``params_from_jax``; the port's gradients go
back through ``params_to_jax``) on the same planted-cluster scenes at
``_tiny_cfg(rcnn=True, points=1024)``, with dropout at 0. Tolerances, each
with its reason:

- the RPN in train mode (batch-statistics BatchNorm), in float64 on both
  sides, as tpu3d's own RPN gradient test runs: every parameter's gradient
  of the RPN loss within 1e-7 relative plus 1e-9 of the network's largest
  gradient (some gradients are zero up to cancellation, a BatchNorm shift
  before the next BatchNorm), the loss within 1e-9 relative, and the
  updated running statistics within 1e-9;
- the RCNN, on targets that tpu3d's own proposal target layer sampled, in
  float32 (the RCNN has no BatchNorm; f32 matmuls sum in another order in
  XLA and in PyTorch): every ``rcnn_net`` parameter's gradient of the RCNN
  loss within 1e-4 of its largest gradient plus 1e-4 relative, the loss
  within 1e-5 relative.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from test_torch_rpn import _numpy_variables, _port_cfg
from tpu3d.models import PointRCNN as JaxPointRCNN
from tpu3d.models.proposal_target import \
    proposal_target_layer as jax_proposal_target
from tpu3d.models.rcnn import RCNNNet as JaxRCNNNet
from tpu3d.models.train_functions import (generate_rpn_labels_device,
                                          get_rcnn_loss, model_loss)
from tpu3d.parallel.train_state import make_optimizer
from tpu3d_torch.datasets import train_batch
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.models import train_functions as tf
from tpu3d_torch.parallel import create_train_state, make_train_step
from tpu3d_torch.tools.train_rcnn import configure_mode
from tpu3d_torch.weights import (params_from_jax, params_to_jax,
                                 seeded_state_dict)

T = torch.from_numpy


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _variables(jcfg, pts, seed):
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TRAIN")
    shapes = jax.eval_shape(lambda p: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, {"pts_input": p}, train=False),
        pts)
    return jmodel, _numpy_variables(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def rpn_case():
    """One train-mode RPN forward and backward of the RPN loss on both
    sides, in float64, with the same weights, scenes and labels."""
    jcfg = _tiny_cfg(rcnn=False, points=1024)
    jcfg.RCNN.ENABLED = False
    jcfg.RPN.DP_RATIO = 0.0
    batch = train_batch(2, 1024, seed=21)
    pts = batch["pts_input"].astype(np.float64)
    gt = batch["gt_boxes3d"].astype(np.float64)
    with _x64():
        jmodel, (params, stats) = _variables(jcfg, pts.astype(np.float32),
                                             21)
        params = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                        params)
        stats = jax.tree_util.tree_map(lambda a: a.astype(np.float64), stats)
        cls_l, reg_l = jax.vmap(generate_rpn_labels_device)(pts, gt)
        labels = {"rpn_cls_label": cls_l, "rpn_reg_label": reg_l}

        def loss_fn(p):
            out, mut = jmodel.apply(
                {"params": p, "batch_stats": stats}, {"pts_input": pts},
                train=True, bn_momentum=0.8, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(1)})
            return model_loss(jcfg, out, labels)[0], mut["batch_stats"]

        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        jloss, jstats, jgrads = jax.device_get((jloss, jstats, jgrads))
        labels = jax.device_get(labels)

    cfg = _port_cfg(jcfg)
    model = PointRCNN(cfg, mode="TRAIN", device="cpu").double()
    model.load_state_dict({k: v.double() for k, v in
                           params_from_jax(params, stats).items()})
    out = model({"pts_input": T(pts)}, train=True, bn_momentum=0.8)
    loss, _ = tf.model_loss(cfg, out, {k: T(np.asarray(v))
                                       for k, v in labels.items()})
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    ours_grads, _ = params_to_jax(grads)
    _, ours_stats = params_to_jax(model.state_dict())
    return (float(loss), ours_grads, ours_stats, float(jloss), jgrads,
            jstats, labels)


def test_rpn_labels_have_foreground(rpn_case):
    """The scenes give the RPN loss real foreground, ignore and background
    points to work on."""
    cls = np.asarray(rpn_case[6]["rpn_cls_label"])
    assert (cls == 1).sum() > 100 and (cls == -1).any() and (cls == 0).any()


def test_rpn_loss_and_gradients_match(rpn_case):
    """Every RPN parameter's gradient of the RPN loss in train mode, f64:
    within 1e-7 relative plus 1e-9 of the largest gradient; the loss within
    1e-9 relative."""
    loss, grads, _, jloss, jgrads, _, _ = rpn_case
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    ours = dict(_flat(grads))
    ref = dict(_flat(jgrads))
    assert set(ours) == set(ref)
    scale = max(np.abs(b).max() for b in ref.values())
    assert scale > 0
    for k, b in ref.items():
        np.testing.assert_allclose(ours[k], b, rtol=1e-7, atol=1e-9 * scale,
                                   err_msg=k)


def test_rpn_running_stats_match(rpn_case):
    """The running statistics after the train-mode forward (momentum 0.8,
    flax's convention, biased variance), f64: within 1e-9."""
    _, _, stats, _, _, jstats, _ = rpn_case
    ours = dict(_flat(stats))
    ref = dict(_flat(jstats))
    assert set(ours) == set(ref)
    for k, b in ref.items():
        np.testing.assert_allclose(ours[k], b, rtol=1e-9, atol=1e-9,
                                   err_msg=k)


@pytest.fixture(scope="module")
def rcnn_case():
    """tpu3d's proposal target layer on rois jittered around the gt boxes
    (so that some are foreground), then the RCNN loss and its gradients on
    both sides, f32."""
    jcfg = _tiny_cfg(rcnn=True, points=1024)
    batch = train_batch(2, 1024, seed=22)
    pts, gt = batch["pts_input"], batch["gt_boxes3d"]
    rng = np.random.default_rng(22)
    rois = np.repeat(gt[:, :8], 6, axis=1)
    rois = (rois + rng.normal(size=rois.shape) * [0.3, 0.05, 0.3, 0.05, 0.05,
                                                  0.1, 0.1]).astype(np.float32)
    feats = np.concatenate([
        (rng.random((2, 1024, 1)) > 0.5), rng.random((2, 1024, 1)),
        rng.normal(size=(2, 1024, 128))], -1).astype(np.float32)
    target = jax.device_get(jax.jit(lambda k: jax_proposal_target(
        k, jnp.asarray(rois), jnp.ones(rois.shape[:2], bool),
        jnp.asarray(gt), jnp.asarray(pts), jnp.asarray(feats), jcfg))(
            jax.random.PRNGKey(3)))

    jnet = JaxRCNNNet(cfg=jcfg)
    pts_input = np.concatenate([target["sampled_pts"],
                                target["pts_feature"]], -1)
    shapes = jax.eval_shape(lambda p: jnet.init(
        {"params": jax.random.PRNGKey(0)}, p, train=False), pts_input)
    params, _ = _numpy_variables({"params": shapes["params"],
                                  "batch_stats": {}}, rng)

    def loss_fn(p):
        out = jnet.apply({"params": p}, pts_input, train=True)
        return get_rcnn_loss(jcfg, dict(target, **out))[0]

    jloss, jgrads = jax.device_get(jax.jit(jax.value_and_grad(loss_fn))(
        params))

    cfg = _port_cfg(jcfg)
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    state = params_from_jax({"rcnn_net": params}, {})
    full = model.state_dict()
    full.update(state)
    model.load_state_dict(full)
    out = model.rcnn_net(T(target["sampled_pts"]), T(target["pts_feature"]),
                         train=True)
    loss, _ = tf.get_rcnn_loss(cfg, dict(
        out, **{k: T(np.asarray(v)) for k, v in target.items()}))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if n.startswith("rcnn_net.")}
    return float(loss), params_to_jax(grads)[0]["rcnn_net"], float(jloss), \
        jgrads, target


def test_rcnn_targets_have_foreground(rcnn_case):
    """tpu3d's sampled targets hold foreground rows with regression
    targets, background rows and pooled points."""
    target = rcnn_case[4]
    assert (np.asarray(target["reg_valid_mask"]) == 1).sum() >= 4
    assert (np.asarray(target["cls_label"]) == 0).any()


def test_rcnn_loss_and_gradients_match(rcnn_case):
    """Every rcnn_net parameter's gradient of the RCNN loss on tpu3d's
    sampled targets, f32: within 1e-4 of its largest gradient plus 1e-4
    relative; the loss within 1e-5 relative."""
    loss, grads, jloss, jgrads, _ = rcnn_case
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    ours = dict(_flat(grads))
    ref = dict(_flat(jgrads))
    assert set(ours) == set(ref)
    for k, b in ref.items():
        scale = np.abs(b).max()
        np.testing.assert_allclose(ours[k], b, rtol=1e-4,
                                   atol=1e-4 * scale + 1e-12, err_msg=k)
    assert np.abs(ref["sa_0/mlp_0/dense_1/kernel"]).max() > 0


def test_train_model_wants_the_card():
    """PointRCNN(mode="TRAIN") builds on cuda unless told otherwise: on a
    machine without a card it raises, and runs only with device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _port_cfg(_tiny_cfg(rcnn=True, points=1024))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PointRCNN(cfg, mode="TRAIN")


@pytest.mark.parametrize("mode", ["joint", "rpn", "rcnn"])
def test_train_step_runs_each_mode(mode):
    """Two train steps on the CPU with dropout on: finite loss and
    grad_norm; every trained parameter with a gradient changes, and so do
    the RPN's running statistics, except in rcnn mode, where the fixed RPN's
    statistics stay as they were and weight decay alone moves its non-zero
    parameters, as tpu3d's optimizer does."""
    cfg = configure_mode(_port_cfg(_tiny_cfg(rcnn=True, points=1024)), mode)
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    model.load_state_dict(seeded_state_dict(model, 23))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model, steps_per_epoch=10,
                               total_epochs=2)
    step = make_train_step(cfg, model)
    batch = {k: T(v) for k, v in train_batch(2, 1024, seed=23).items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        tb = step(state, batch, gen, 0.9)
    assert state.step == 2
    assert torch.isfinite(tb["loss"]) and torch.isfinite(tb["grad_norm"])
    assert float(tb["grad_norm"]) > 0
    after = model.state_dict()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for name, value in after.items():
        same = torch.equal(before[name], value)
        if name.startswith("rpn.") and mode == "rcnn":
            # weight decay alone moves the fixed RPN's non-zero parameters
            # (their gradients are zero); its statistics stay as loaded
            if name in grads:
                assert not grads[name].any(), name
                assert same != bool(before[name].any()), name
            else:
                assert same, name
        elif name.endswith((".mean", ".var")):
            assert not same, name
        elif grads.get(name) is not None and grads[name].abs().max() > 0:
            assert not same, name
    if mode != "rpn":
        assert "rcnn_loss" in tb and "cls_label" not in tb
    if mode != "rcnn":
        assert "rpn_loss" in tb


def fixed_rpn_case(optimizer, steps=3):
    """rcnn mode: ``steps`` train steps of the port, and tpu3d's
    make_optimizer chain fed zero gradients for the fixed RPN from the same
    weights (its global-norm clip scales a zero gradient to zero, so the
    RCNN's gradients do not enter): (the port's RPN parameters, tpu3d's,
    the loaded ones, whether the RPN's running statistics are unchanged),
    the parameters as numpy arrays by state_dict key."""
    jcfg = _tiny_cfg(rcnn=True, points=1024)
    jcfg.TRAIN.OPTIMIZER = optimizer
    cfg = configure_mode(_port_cfg(jcfg), "rcnn")
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    model.load_state_dict(seeded_state_dict(model, 24))
    loaded = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters() if n.startswith("rpn.")}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("rpn.") and k not in loaded}
    state = create_train_state(cfg, model, steps_per_epoch=10,
                               total_epochs=2)
    step = make_train_step(cfg, model)
    batch = {k: T(v) for k, v in train_batch(2, 1024, seed=24).items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        step(state, batch, gen, 0.9)

    tx = make_optimizer(jcfg, 10, 2)
    jparams = {k: jnp.asarray(v) for k, v in loaded.items()}
    opt_state = tx.init(jparams)
    zeros = {k: jnp.zeros_like(v) for k, v in jparams.items()}
    for _ in range(steps):
        updates, opt_state = tx.update(zeros, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    after = model.state_dict()
    return ({k: after[k].numpy() for k in loaded},
            {k: np.asarray(v) for k, v in jparams.items()}, loaded,
            all(torch.equal(after[k], v) for k, v in stats.items()))


@pytest.mark.parametrize("optimizer", ["adam_onecycle", "adam", "sgd"])
def test_fixed_rpn_follows_reference_optimizer(optimizer):
    """fixed_rpn_case: every RPN parameter within 1e-6 relative plus 1e-6
    of the largest of tpu3d's, most of them moved, and the RPN's running
    statistics exactly as loaded."""
    ours, ref, loaded, stats_kept = fixed_rpn_case(optimizer)
    top = max(np.abs(v).max() for v in ref.values())
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-6, atol=1e-6 * top,
                                   err_msg=k)
    moved = sum(not np.array_equal(ours[k], v) for k, v in loaded.items())
    assert moved > len(loaded) // 2
    assert stats_kept
