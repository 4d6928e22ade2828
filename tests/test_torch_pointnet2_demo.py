"""The PointNet++ segmentation demo against tpu3d's on the CPU.

The flax ``PointnetSeg`` and the port's take the same weights (drawn with
numpy for the flax tree's shapes, BatchNorm statistics away from the
identity, carried over with ``weights.params_from_jax``) and the same
scenes:

- eval-mode logits in float32, within 1e-4 of the largest logit;
- the train-mode DiceLoss, every parameter's gradient and the updated
  BatchNorm statistics in float64 (x64 JAX), and one Adam step after it
  (optax's ``adam`` against ``torch.optim.Adam``): the loss within 1e-9
  relative, gradients and statistics within 1e-7 relative plus 1e-9 of the
  largest value, parameters after the step within 1e-9 relative plus
  lr·1e-7 (Adam's first step is nearly lr·sign(g), so a gradient near its
  eps carries the gradients' 1e-7 into the step at most lr-fold).
  float64 because train-mode BatchNorm over small groups loses float32
  digits (docs/PARITY.md, finding 2), and the cloud is dense (a 0.25 m
  cube), so every group's slots hold points and no pad, whose choice
  differs between the packages' ball queries;
- ``main --device cpu`` for one epoch on the synthetic frames.
"""

import contextlib

import jax
import numpy as np
import optax
import pytest
import torch

from tpu3d.models.losses import dice_loss as jax_dice_loss
from tpu3d.tools.pointnet2_demo import PointnetSeg as JaxPointnetSeg
from tpu3d_torch.models.losses import dice_loss
from tpu3d_torch.tools import pointnet2_demo
from tpu3d_torch.tools.pointnet2_demo import PointnetSeg
from tpu3d_torch.weights import params_from_jax, params_to_jax

B, N = 2, 1024
LR = 0.002


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _scene(rng):
    """Points in a 0.25 m cube and labels: foreground inside a corner."""
    pts = rng.uniform(0.0, 0.25, size=(B, N, 3))
    labels = (pts[..., 0] < 0.12).astype(np.int32)
    labels[:, ::17] = -1  # ignored rows
    return pts, labels


def _variables(pts, seed):
    """The flax tree's shapes, filled from numpy at ``seed``."""
    model = JaxPointnetSeg()
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p,
                                                 train=False),
                            pts.astype(np.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0, np.sqrt(2.0 / leaf.shape[0]), leaf.shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, leaf.shape)
        if name == "mean":
            return rng.normal(0, 0.1, leaf.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape)
        return rng.normal(0, 0.05, leaf.shape)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return model, tree["params"], tree["batch_stats"]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _close(ours, ref, rel):
    a, b = dict(_flat(ours)), dict(_flat(ref))
    assert a.keys() == b.keys()
    top = max(np.abs(v).max() for v in b.values())
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=rel, atol=1e-9 * top,
                                   err_msg=k)


def _port(params, stats, dtype):
    model = PointnetSeg(device="cpu").to(dtype)
    model.load_state_dict({k: v.to(dtype) for k, v in
                           params_from_jax(params, stats).items()})
    return model


def test_eval_logits_match():
    """Eval mode (BatchNorm from the running statistics), float32."""
    pts, _ = _scene(np.random.default_rng(0))
    pts = pts.astype(np.float32)
    jmodel, params, stats = _variables(pts, 1)
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    stats = jax.tree_util.tree_map(lambda a: a.astype(np.float32), stats)
    ref = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                  pts, train=False))
    with torch.no_grad():
        ours = _port(params, stats, torch.float32)(torch.from_numpy(pts))
    assert ours.shape == (B, N)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module")
def train_case():
    """One train-mode step on both sides in float64: the loss, gradients,
    updated statistics and the parameters after one Adam step."""
    pts, labels = _scene(np.random.default_rng(2))
    with _x64():
        jmodel, params, stats = _variables(pts, 3)

        def loss_fn(p):
            logits, mut = jmodel.apply({"params": p, "batch_stats": stats},
                                       pts, train=True,
                                       mutable=["batch_stats"])
            return jax_dice_loss(logits, labels), mut["batch_stats"]

        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        tx = optax.adam(LR)
        updates, _ = tx.update(jgrads, tx.init(params), params)
        jparams = optax.apply_updates(params, updates)
        ref = jax.device_get((jloss, jgrads, jstats, jparams))

    model = _port(params, stats, torch.float64)
    opt = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
    loss = dice_loss(model(torch.from_numpy(pts), train=True),
                     torch.from_numpy(labels))
    loss.backward()
    loss = loss.detach()
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()})[0]
    opt.step()
    new_params, new_stats = params_to_jax(model.state_dict())
    return (loss.item(), grads, new_stats, new_params), ref


def test_train_loss_and_gradients_match(train_case):
    (loss, grads, _, _), (jloss, jgrads, _, _) = train_case
    assert 0.0 < jloss < 1.0
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    _close(grads, jgrads, 1e-7)


def test_train_batch_statistics_match(train_case):
    (_, _, stats, _), (_, _, jstats, _) = train_case
    _close(stats, jstats, 1e-7)


def test_adam_step_matches(train_case):
    (_, _, _, params), (_, _, _, jparams) = train_case
    a, b = dict(_flat(params)), dict(_flat(jparams))
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-9, atol=LR * 1e-7,
                                   err_msg=k)


def test_main_one_epoch_on_cpu(tmp_path):
    """The CLI on the CPU: one epoch on its 8 synthetic frames, a foreground
    IoU in [0, 1] and the epoch's loss in the log."""
    iou = pointnet2_demo.main(["--synthetic", "--epochs", "1", "--device",
                               "cpu", "--output_dir", str(tmp_path)])
    assert 0.0 <= iou <= 1.0
    log = (tmp_path / "log.txt").read_text()
    assert "epoch 0: loss" in log and "val fg IoU" in log
