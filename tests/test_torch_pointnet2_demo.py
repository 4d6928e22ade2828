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


def test_main_one_epoch_on_cpu(tmp_path, monkeypatch):
    """The CLI on the CPU: one epoch on its 8 synthetic frames, a foreground
    IoU in [0, 1] and the epoch's loss in the log; ``main`` resolves the
    training contract once for the train steps and the eval contract for
    the eval batches (``demo_precision``; stand-ins here that change no
    arithmetic on the CPU) and hands each to its forwards."""
    from tpu3d_torch.precision import F32, Precision

    want = {True: Precision(fixed_rpn=F32), False: Precision(first_f32=True)}
    seen = []
    make, iou = pointnet2_demo.make_train_step, pointnet2_demo.fg_iou
    monkeypatch.setattr(pointnet2_demo, "demo_precision",
                        lambda dev, train: want[train])
    monkeypatch.setattr(pointnet2_demo, "make_train_step",
                        lambda m, o, p: seen.append((True, p))
                        or make(m, o, p))
    monkeypatch.setattr(pointnet2_demo, "fg_iou", lambda m, x, y, p:
                        seen.append((False, p)) or iou(m, x, y, p))
    iou_ = pointnet2_demo.main(["--synthetic", "--epochs", "1", "--device",
                                "cpu", "--output_dir", str(tmp_path)])
    assert 0.0 <= iou_ <= 1.0
    log = (tmp_path / "log.txt").read_text()
    assert "epoch 0: loss" in log and "val fg IoU" in log
    assert {t for t, _ in seen} == {True, False}
    assert all(p == want[t] for t, p in seen), seen


# ------------------------------------------------- the demo's numerics contract


def test_demo_contract_resolves(monkeypatch):
    """The demo's contracts as tpu3d's demo model sets them
    (``Pointnet2MSG`` with ``train_bf16=True`` and ``dtype=None``): on the
    card, in training, the SA, FP and ROI casts and the bf16 backward
    routes (``TRAIN.BF16_ACTIVATIONS``) and f32 Dense layers (no
    ``TRAIN.BF16_MATMULS``); at eval the accelerator's casts, f32 under
    ``TPU3D_F32_EVAL``; on the CPU f32 both. From a device's name alone:
    nothing is allocated."""
    from tpu3d.models import pointnet2 as jp2
    from tpu3d_torch.precision import F32, Precision, resolve
    from tpu3d_torch.tools.pointnet2_demo import demo_precision

    fields = jp2.Pointnet2MSG.__dataclass_fields__
    assert fields["train_bf16"].default is True
    assert fields["dtype"].default is None
    monkeypatch.delenv("TPU3D_F32_EVAL", raising=False)
    casts = Precision(sa_bf16=True, fp_bf16=True, roi_bf16=True, accel=True)
    assert demo_precision("cuda", True) == Precision(
        sa_bf16=True, fp_bf16=True, roi_bf16=True, dense_dtype=None,
        head_dtype=None, first_f32=False, accel=True, fixed_rpn=casts)
    assert demo_precision("cuda", False) == casts
    assert demo_precision("cpu", True) == demo_precision("cpu", False) == F32
    monkeypatch.setenv("TPU3D_F32_EVAL", "1")
    assert demo_precision("cuda", False) == F32
    assert demo_precision("cuda", True).sa_bf16
    assert resolve("cuda") == F32


DEMO_N = 256


@pytest.fixture(scope="module")
def demo_bf16_case():
    """One train step of tpu3d's demo model under its accelerator contract
    on the CPU (``test_torch_bf16_train._tpu_training``, with pointnet2's
    own backend check seeing the TPU as well, for the FP casts): the
    DiceLoss, the logits and every parameter's gradient, in float32, at
    B=2 and 256 points in a 4 m cube (the demo's radii run from 0.1 to 4 m;
    in the 0.25 m cube above, train-mode BatchNorm over near-constant
    channels leaves even the two packages' f32 gradients 2.3 apart
    relative RMS in the worst tensor, against 4.5e-5 here); and the
    weights and scene."""
    from test_torch_bf16_train import _TPUBackend, _exact, _tpu_training
    from tpu3d.models import pointnet2 as jp2

    rng = np.random.default_rng(21)
    pts = rng.uniform(0.0, 4.0, size=(B, DEMO_N, 3)).astype(np.float32)
    labels = (pts[..., 0] < 2.0).astype(np.int32)
    labels[:, ::17] = -1
    jmodel, params, stats = _variables(pts, 22)
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    stats = jax.tree_util.tree_map(lambda a: a.astype(np.float32), stats)

    def loss_fn(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, pts,
                                 train=True, mutable=["batch_stats"])
        return jax_dice_loss(logits, labels), logits

    with _tpu_training(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp2, "jax", _TPUBackend())
        (jloss, jlogits), jgrads = jax.device_get(_exact(
            jax.value_and_grad(loss_fn, has_aux=True), params))
    return pts, labels, params, stats, float(jloss), jlogits, dict(
        _flat(jgrads))


def _demo_step(params, stats, pts, labels, prec):
    """The port's train-mode forward and backward under ``prec`` -> (loss,
    logits, gradients by flax name)."""
    model = _port(params, stats, torch.float32)
    logits = model(torch.from_numpy(pts), train=True, precision=prec)
    loss = dice_loss(logits, torch.from_numpy(labels))
    loss.backward()
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()})
    return loss.item(), logits.detach().numpy(), dict(_flat(grads[0]))


def _rms(got, want):
    return float(np.sqrt(np.mean((np.asarray(got, np.float64) - want) ** 2))
                 / max(np.sqrt(np.mean(np.asarray(want, np.float64) ** 2)),
                       1e-30))


def test_demo_train_step_matches_tpu3d_contract(demo_bf16_case):
    """One demo train step under the demo's training contract against
    tpu3d's demo model under its accelerator contract, same weights and
    scene, B=2 at 256 points. tpu3d's ops stay on the CPU, so the port runs
    the card's contract with ``accel`` off (tpu3d's CPU interpolation keeps
    the weights in f32). Bounds, no looser than the whole RPN's in
    test_torch_bf16_train.py (a bf16 rounding that the two packages' f32
    sums put on the other side of a tie moves one value by a bf16 step,
    and every later level's train-mode BatchNorm spreads it; measured
    3.6e-3 in the logits, 0.10 in the gradients on average, 0.29 in the
    worst): the loss within 1e-2 relative, the logits within 1e-2 RMS, the
    gradients within 0.25 RMS on average; and the port's f32 path further
    from tpu3d, at least 1.5 times in the logits and further on average
    over the gradients (2.3 times each, measured), so the rounding points
    are tpu3d's."""
    import dataclasses

    from tpu3d_torch.precision import F32
    from tpu3d_torch.tools.pointnet2_demo import demo_precision

    pts, labels, params, stats, jloss, jlogits, jgrads = demo_bf16_case
    prec = dataclasses.replace(demo_precision("cuda", True), accel=False)
    errs = {}
    for name, p in (("bf16", prec), ("f32", F32)):
        loss, logits, grads = _demo_step(params, stats, pts, labels, p)
        assert logits.shape == (B, DEMO_N) and set(grads) == set(jgrads)
        g = [_rms(grads[k], v) for k, v in jgrads.items()]
        errs[name] = (abs(loss - jloss) / abs(jloss), _rms(logits, jlogits),
                      float(np.mean(g)))
    (loss_e, out_e, g_mean), (_, out32, g_mean32) = errs["bf16"], errs["f32"]
    assert loss_e <= 1e-2 and out_e <= 1e-2 and g_mean <= 0.25, errs
    assert out32 >= 1.5 * out_e and g_mean32 > g_mean, errs
