"""The port's checkpoints against tpu3d's on the CPU: the msgpack codec, the
one-cycle schedules whose values a checkpoint carries, the round trip of
tpu3d's own files, the next update from a loaded state, the
optimizer-structure fallback, the partial load and the old-layout
migration.

The model is tpu3d's ``small_cfg(rcnn=True)`` (narrow widths, 512 points),
so a checkpoint is small. Both sides start from the same weights (numpy
draws for the flax tree's shapes) and take the same gradients (tpu3d's
training gradients on planted-cluster scenes; numpy draws where only the
file's structure matters). Everything a checkpoint holds is compared bit for bit (the files'
bytes); the one update from a loaded state within 1e-6 relative plus 1e-6
of the largest parameter, the tolerance of the port's optimizer tests
(``tests/test_torch_train_ops.py``: PyTorch's and optax's f32 arithmetic
round in other orders).
"""

import copy
import warnings

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_model import small_cfg
from test_torch_rpn import _numpy_variables, _port_cfg
from test_torch_train import _flat
from tpu3d.models import PointRCNN as JaxPointRCNN
from tpu3d.models.train_functions import (generate_rpn_labels_device,
                                          model_loss)
from tpu3d.parallel import train_state as jax_ts
from tpu3d.utils import checkpoint as jax_ckpt
from tpu3d_torch.datasets import train_batch
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.parallel import create_train_state
from tpu3d_torch.parallel import train_state as ts
from tpu3d_torch.utils import checkpoint as ckpt
from tpu3d_torch.utils import msgpack_io
from tpu3d_torch.weights import params_from_jax, params_to_jax

SPE, EPOCHS = 3, 2  # steps per epoch and epochs the schedules span


def _same_tree(a, b, path=""):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
        assert a.flags.writeable == b.flags.writeable, path
    else:
        assert a == b and type(a) is type(b), path


# ------------------------------------------------------------------ codec


def _codec_tree():
    rng = np.random.default_rng(1)
    return {
        "epoch": np.int32(7), "step": np.asarray(5, np.int32),
        "params": {f"layer_{i}": {"kernel": rng.normal(size=(i + 1, 3))
                                  .astype(np.float32),
                                  "bias": np.zeros(i, np.float32)}
                   for i in range(18)},  # map16
        "empty": {}, "scalars": {"f": np.float32(1.5), "i": np.int64(-3),
                                 "b": np.bool_(True)},
        "ints": {str(v): v for v in (0, 127, 128, 255, 256, 65535, 65536,
                                     2 ** 32, -1, -32, -33, -128, -129,
                                     -32769, -2 ** 31 - 1)},
        "bins": {"x" * 40: np.zeros(70, np.uint8),  # str8 key, bin8
                 "y": rng.normal(size=(300, 300)).astype(np.float32)},
        "dtypes": {d: np.arange(6, dtype=d).reshape(2, 3)
                   for d in ("int8", "uint16", "int32", "float64")},
    }


def test_codec_matches_flax():
    """encode gives flax.serialization.to_bytes's bytes for every kind of
    node a checkpoint holds (and the header sizes around them), and decode
    gives what msgpack_restore gives: the same keys in the same order, the
    same dtypes, shapes and bytes, read-only arrays, numpy scalars."""
    tree = _codec_tree()
    data = flax.serialization.to_bytes(copy.deepcopy(tree))
    assert msgpack_io.encode(tree) == data
    _same_tree(msgpack_io.decode(data),
               flax.serialization.msgpack_restore(data))


def test_codec_refuses_chunked_arrays():
    """An array above flax's chunk size would be split by flax; the codec
    refuses it instead of writing another format."""
    big = np.broadcast_to(np.float32(0), (msgpack_io.MAX_CHUNK_SIZE // 4 + 1,))
    with pytest.raises(AssertionError, match="chunked"):
        msgpack_io.encode({"x": big})


# -------------------------------------------------------------- schedules


@pytest.mark.parametrize("spe,epochs", [(3, 2), (1, 3), (37, 5), (116, 70)])
def test_onecycle_schedules_bit_equal(spe, epochs):
    """The port's one-cycle lr and b1 equal the float32 values of tpu3d's
    schedules, evaluated inside jit as its train step evaluates them, at
    every count of the run and two past its end."""
    jcfg = small_cfg()
    jcfg.TRAIN.OPTIMIZER = "adam_onecycle"
    cfg = _port_cfg(jcfg)
    counts = np.arange(spe * epochs + 2, dtype=np.int32)
    for port, ref in ((ts.make_lr_schedule, jax_ts.make_lr_schedule),
                      (ts.make_momentum_schedule,
                       jax_ts.make_momentum_schedule)):
        want = np.asarray(jax.jit(jax.vmap(ref(jcfg, spe, epochs)))(counts))
        sched = port(cfg, spe, epochs)
        got = np.array([sched(int(c)) for c in counts], np.float32)
        np.testing.assert_array_equal(got, want, err_msg=port.__name__)


# ------------------------------------------------------------ checkpoints


def _jax_setup(optimizer, weight_decay=0.001, seed=0):
    """tpu3d's TrainState at small_cfg(rcnn=True) with numpy weights, and
    the port's config."""
    jcfg = small_cfg(rcnn=True)
    jcfg.TRAIN.OPTIMIZER = optimizer
    jcfg.TRAIN.WEIGHT_DECAY = weight_decay
    pts = np.zeros((1, jcfg.RPN.NUM_POINTS, 3), np.float32)
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TRAIN")
    shapes = jax.eval_shape(lambda p: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, {"pts_input": p}, train=False),
        pts)
    params, stats = _numpy_variables(shapes, np.random.default_rng(seed))
    tx = jax_ts.make_optimizer(jcfg, SPE, EPOCHS)
    state = jax_ts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=stats, opt_state=tx.init(params),
                              tx=tx)
    return jcfg, _port_cfg(jcfg), state


def _grads(params, seed):
    """Gradients drawn with numpy; past the clip norm for odd seeds."""
    rng = np.random.default_rng(seed)
    scale = 3.0 if seed % 2 else 0.01
    return jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32),
        params)


@jax.jit
def _jax_update(state, grads, batch_stats=None):
    return state.apply_gradients(
        grads=grads, batch_stats=state.batch_stats if batch_stats is None
        else batch_stats)


def _port_model(cfg, optimizer_steps=(SPE, EPOCHS)):
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    return model, create_train_state(cfg, model, *optimizer_steps)


@pytest.fixture(scope="module")
def jax_training():
    """tpu3d's training gradient at small_cfg(rcnn=True), jitted once for
    every optimizer: the train-mode forward (dropout, the proposal target
    layer), the RPN labels made on the device from the gt boxes, model_loss
    and its gradient, with the updated BatchNorm statistics, as tpu3d's
    make_train_step computes them before its update; and a batch of two
    planted-cluster scenes."""
    jcfg = small_cfg(rcnn=True)
    jmodel = JaxPointRCNN(cfg=jcfg, mode="TRAIN")
    batch = train_batch(2, jcfg.RPN.NUM_POINTS, seed=9)

    @jax.jit
    def grad_fn(params, batch_stats, batch, rng):
        d_rng, t_rng = jax.random.split(rng)
        cls_l, reg_l = jax.vmap(generate_rpn_labels_device)(
            batch["pts_input"], batch["gt_boxes3d"])
        labels = dict(batch, rpn_cls_label=cls_l, rpn_reg_label=reg_l)

        def loss_fn(p):
            out, mutated = jmodel.apply(
                {"params": p, "batch_stats": batch_stats}, batch, train=True,
                bn_momentum=0.9, mutable=["batch_stats"],
                rngs={"dropout": d_rng, "target": t_rng})
            return model_loss(jcfg, out, labels)[0], mutated["batch_stats"]

        (_, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        return grads, new_stats

    return grad_fn, batch


def _train(state, grad_fn, batch, step):
    grads, stats = grad_fn(state.params, state.batch_stats, batch,
                           jax.random.PRNGKey(step))
    return _jax_update(state, grads, stats), grads


@pytest.mark.parametrize("optimizer,weight_decay", [
    ("adam_onecycle", 0.001), ("adam", 0.001), ("sgd", 0.001), ("adam", 0.0)])
def test_tpu3d_checkpoint_round_trip_and_next_update(tmp_path, jax_training,
                                                     optimizer,
                                                     weight_decay):
    """tpu3d trains two steps (its loss's gradients on a batch, the
    running statistics, the jitted update) and saves; the port loads the
    file (parameters, statistics, step, epoch and the optimizer's moments
    and counts), saves it again and gets the same bytes; then both take
    tpu3d's third gradient, and the port's parameters equal tpu3d's within
    1e-6 relative plus 1e-6 of the largest."""
    grad_fn, batch = jax_training
    jcfg, cfg, jstate = _jax_setup(optimizer, weight_decay)
    for step in (1, 2):
        jstate, _ = _train(jstate, grad_fn, batch, step)
    path = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jstate, 4)

    model, state = _port_model(cfg)
    state, epoch = ckpt.load_checkpoint(path, model, state)
    assert (epoch, state.step) == (4, 2)
    ours = ckpt.save_checkpoint(str(tmp_path / "port"), model, state, epoch)
    with open(path, "rb") as f, open(ours, "rb") as g:
        assert f.read() == g.read()

    jstate, grads = _train(jstate, grad_fn, batch, 3)
    torch_grads = params_from_jax(jax.device_get(grads), {})
    for name, p in model.named_parameters():
        p.grad = torch_grads[name].clone()
    state.apply_gradients()
    got = dict(_flat(params_to_jax(model.state_dict())[0]))
    want = dict(_flat(jax.device_get(jstate.params)))
    assert sorted(got) == sorted(want)
    top = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6 * top,
                                   err_msg=k)


def test_port_checkpoint_resumes_like_an_unbroken_optimizer(tmp_path):
    """The port saves after two updates and a fresh model and optimizer
    load the file: a third update gives the same parameters, bit for bit,
    as the optimizer that never stopped."""
    _, cfg, jstate = _jax_setup("adam_onecycle")
    grads = [params_from_jax(_grads(jstate.params, s), {}) for s in (1, 2, 3)]
    start = params_from_jax(jstate.params, jstate.batch_stats)

    def step(model, state, g):
        for name, p in model.named_parameters():
            p.grad = g[name].clone()
        state.apply_gradients()

    model, state = _port_model(cfg)
    model.load_state_dict(start)
    for g in grads[:2]:
        step(model, state, g)
    path = ckpt.save_checkpoint(str(tmp_path), model, state, 1)
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    step(model, state, grads[2])

    model2, state2 = _port_model(cfg)
    state2, _ = ckpt.load_checkpoint(path, model2, state2)
    step(model2, state2, grads[2])
    a, b = model.state_dict(), model2.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_structure_fallback_warns_and_restores_params(tmp_path):
    """A checkpoint whose optimizer state has another structure (tpu3d's
    legacy masked-decay chain, as tests/test_pipeline.py builds it) still
    restores params / batch_stats / step / epoch, with tpu3d's warning, and
    starts the port's optimizer state afresh: no moments, its count
    (``opt_count``) at 0 while the step stays 5. One update after it reads
    the learning rate and b1 at count 0 in both packages (tpu3d keeps its
    freshly initialized opt_state), and the parameters then agree within
    1e-6 relative plus 1e-6 of the largest."""
    _, cfg, jstate = _jax_setup("adam_onecycle")
    legacy_tx = optax.chain(optax.clip_by_global_norm(1.0),
                            optax.adamw(1e-3, mask=jax_ts._wd_mask(
                                jstate.params)))
    legacy = jstate.replace(tx=legacy_tx, step=jnp.asarray(5, jnp.int32),
                            opt_state=legacy_tx.init(jstate.params))
    path = jax_ckpt.save_checkpoint(str(tmp_path), legacy, epoch=3)

    model, state = _port_model(cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        restored, epoch = ckpt.load_checkpoint(path, model, state)
        jrestored, jepoch = jax_ckpt.load_checkpoint(path, jstate)
    assert (epoch, restored.step, restored.opt_count) == (3, 5, 0)
    assert (jepoch, int(jrestored.step)) == (3, 5)
    assert sum("optimizer-structure" in str(w.message)
               or "optimizer-state structure" in str(w.message)
               for w in caught) == 2
    assert not state.optimizer.opt.state
    want = params_from_jax(jstate.params, jstate.batch_stats)
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)

    grads = _grads(jstate.params, 1)
    jnext = _jax_update(jrestored, grads)
    hyper = jax.device_get(jnext.opt_state[1].hyperparams)
    torch_grads = params_from_jax(grads, {})
    for name, p in model.named_parameters():
        p.grad = torch_grads[name].clone()
    restored.apply_gradients()
    group = restored.optimizer.opt.param_groups[0]
    opt = restored.optimizer
    assert (restored.step, restored.opt_count) == (6, 1)
    assert int(jnext.step) == 6 and int(jnext.opt_state[1].count) == 1
    assert np.float32(group["lr"]) == hyper["learning_rate"] == opt.lr(0)
    assert np.float32(group["betas"][0]) == hyper["b1"] == opt.b1(0)
    assert opt.lr(0) != opt.lr(5)
    got = dict(_flat(params_to_jax(model.state_dict())[0]))
    want = dict(_flat(jax.device_get(jnext.params)))
    top = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6 * top,
                                   err_msg=k)


def test_partial_load_grafts_what_tpu3d_grafts(tmp_path):
    """load_part_ckpt of an RPN-only checkpoint into the joint model: the
    port's parameters and statistics afterwards equal tpu3d's grafted
    tree (the RPN from the file, the RCNN as it was)."""
    _, _, rpn_state = _jax_setup("adam_onecycle", seed=4)
    path = jax_ckpt.save_checkpoint(str(tmp_path), rpn_state.replace(
        params={"rpn": rpn_state.params["rpn"]},
        batch_stats={"rpn": rpn_state.batch_stats["rpn"]}), 1)
    _, cfg, jstate = _jax_setup("adam_onecycle", seed=5)
    merged = jax_ckpt.load_part_ckpt(path, jstate)

    model, state = _port_model(cfg)
    model.load_state_dict(params_from_jax(jstate.params, jstate.batch_stats))
    ckpt.load_part_ckpt(path, model, state)
    want = params_from_jax(merged.params, merged.batch_stats)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    changed = [k for k in want if not torch.equal(
        want[k], params_from_jax(jstate.params, jstate.batch_stats)[k])]
    assert changed and all(k.startswith("rpn.") for k in changed)


def test_migrate_pregroup_params_matches():
    """The old pre-grouped layout migrates as tpu3d migrates it (the tree
    of tests/test_model.py's migration test)."""
    old = {
        "sa_0": {
            "mlp_0_pre_bias": np.zeros(8),
            "mlp_0_pre_kernel": np.ones((7, 8)),
            "mlp_0_pre_bn": {"scale": np.ones(8), "bias": np.zeros(8)},
            "mlp_0_rest": {
                "dense_0": {"kernel": np.ones((8, 8))},
                "bn_0": {"scale": np.ones(8), "bias": np.zeros(8)},
            },
            "mlp_1": {"dense_0": {"kernel": np.ones((7, 16))}},
        },
        "mu": {"sa_0": {"mlp_0_pre_kernel": np.zeros((7, 8))}},
    }
    _same_tree(ckpt.migrate_pregroup_params(copy.deepcopy(old)),
               jax_ckpt.migrate_pregroup_params(copy.deepcopy(old)))
