"""The port's data-parallel mesh (``tpu3d_torch.parallel.mesh``) on the CPU:
worlds of 2, 3 and 4 gloo processes (``tests/_torch_dist_cases.py``)
against the port's one-process step at the global batch, and against
tpu3d's sharded step on the 8-virtual-device mesh of ``conftest.py``.

tpu3d jits the single-device program over a batch sharded on axis 0, so
its sharded step is the global batch's step; the port's must equal its own
one-process step at that batch. Tolerances, each with its reason:

- the train step in float64 (``_tiny_cfg``'s joint model, RPN BatchNorm,
  ``RPN.DP_RATIO`` 0.5, global B=4, the same seeded weights and step
  generators): the loss and every tb metric within 1e-9 relative, the
  running statistics within 1e-9 relative, the gradients (summed over the
  ranks, clipped) within 1e-9 relative plus 1e-9 of the largest (their
  sums run in another order; some are zero up to cancellation, a
  BatchNorm shift before the next BatchNorm), and the parameters within
  1e-9 relative plus lr·(that gradient bound)/ε: Adam divides a gradient
  by its own magnitude plus ε = 1e-8, so an update's error is at most
  lr/ε times its gradient's;
- against tpu3d, ``tests/test_torch_train.py``'s tolerances: on the RPN in
  float64 the loss within 1e-9 relative, the gradients within 1e-7
  relative plus 1e-9 of the largest; on the RCNN in float32 the loss
  within 1e-5 relative, the gradients within 1e-4 relative plus 1e-4 of
  each parameter's largest;
- kernel 9's training form (through its autograd Function, whose plain
  pieces the CPU runs in the kernels' sequence) in float64: within 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_dist_cases as cases
from __graft_entry__ import _tiny_cfg as jax_tiny_cfg
from test_torch_rpn import _numpy_variables, _port_cfg
from test_torch_train import _flat, _variables, _x64
from tpu3d.models.proposal_target import \
    proposal_target_layer as jax_proposal_target
from tpu3d.models.rcnn import RCNNNet as JaxRCNNNet
from tpu3d.models.train_functions import (generate_rpn_labels_device,
                                          get_rcnn_loss, model_loss)
from tpu3d.parallel import make_mesh as jax_make_mesh
from tpu3d_torch.datasets import BatchLoader, train_batch
from tpu3d_torch.device import resolve_device
from tpu3d_torch.entry import _tiny_cfg, spawn
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.parallel import (create_train_state, init_distributed,
                                  make_mesh, make_train_step, shard_batch)
from tpu3d_torch.tools.train_rcnn import step_generator
from tpu3d_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tpu3d_torch.weights import seeded_state_dict

EPS = 1e-8  # Adam's


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's processes compute on one thread each, the spawned
    ranks too (OMP_NUM_THREADS rides into them): several ranks and the
    test process share the host's cores with the other test workers, and
    torch's intra-op threads on a loaded host wait for each other far
    longer than they save."""
    n = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(n)


def _run(tmp_path, world, names, inputs):
    """Spawn ``world`` ranks running the named cases on ``inputs`` -> each
    rank's results."""
    torch.save(inputs, tmp_path / "inputs.pt")
    spawn(cases.run_cases, world, str(tmp_path / "inputs.pt"),
          str(tmp_path / "out"), names)
    return [torch.load(tmp_path / f"out.{r}", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def batch():
    return train_batch(cases.GLOBAL_BATCH, 1024, seed=23)


@pytest.fixture(scope="module")
def reference(batch):
    """The one-process steps at the global batch."""
    return {name: cases.train_steps(cases.step_cfg(name == "bn_step"), batch,
                                    steps=1)
            for name in ("step", "bn_step")}


def _fused_bn_inputs(bf16=False):
    """A slab, kernel 9's weights and an output gradient in float64; with
    ``bf16`` its bf16 form's: x0 and the gradient in bf16, the rest f32."""
    g = torch.Generator().manual_seed(5)
    R, M, S, c1, c2, c3 = 4, 2, 8, 16, 24, 32

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g, dtype=torch.float64) * scale

    weights = [r(c1, c2, scale=0.3), r(c2, c3, scale=0.3)]
    weights += [1 + r(c, scale=0.1) for c in (c1, c2, c3)]
    weights += [r(c, scale=0.1) for c in (c1, c2, c3)]
    x0, grad = r(R, M, S, c1), r(R, M, c3)
    if bf16:
        return {"x0": x0.to(torch.bfloat16),
                "weights": [w.float() for w in weights],
                "grad": grad.to(torch.bfloat16)}
    return {"x0": x0, "weights": weights, "grad": grad}


@pytest.fixture(scope="module")
def rpn_inputs():
    """tpu3d's weights (numpy, float64), two scenes and their labels, and
    tpu3d's loss, gradients and running statistics from its step over a
    2-device mesh, in float64."""
    jcfg = _tiny_cfg_rpn()
    b = train_batch(2, 1024, seed=21)
    pts = b["pts_input"].astype(np.float64)
    gt = b["gt_boxes3d"].astype(np.float64)
    mesh = jax_make_mesh(jax.devices()[:2])
    shard = NamedSharding(mesh, P("data"))
    with _x64():
        jmodel, (params, stats) = _variables(jcfg, pts.astype(np.float32),
                                             21)
        params = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                        params)
        stats = jax.tree_util.tree_map(lambda a: a.astype(np.float64), stats)
        cls_l, reg_l = jax.vmap(generate_rpn_labels_device)(pts, gt)
        labels = jax.device_get({"rpn_cls_label": cls_l,
                                 "rpn_reg_label": reg_l})

        def loss_fn(p, x, lab):
            out, mut = jmodel.apply(
                {"params": p, "batch_stats": stats}, {"pts_input": x},
                train=True, bn_momentum=0.8, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(1)})
            return model_loss(jcfg, out, lab)[0], mut["batch_stats"]

        (jloss, jstats), jgrads = jax.device_get(jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, jax.device_put(pts, shard),
                                    jax.device_put(labels, shard)))
    inputs = {"cfg": _port_cfg(jcfg), "params": jax.device_get(params),
              "stats": jax.device_get(stats), "pts": pts, "labels": labels}
    return inputs, (float(jloss), jgrads, jstats)


def _tiny_cfg_rpn():
    jcfg = jax_tiny_cfg(rcnn=False, points=1024)
    jcfg.RCNN.ENABLED = False
    jcfg.RPN.DP_RATIO = 0.0
    return jcfg


@pytest.fixture(scope="module")
def rcnn_inputs():
    """tpu3d's proposal target layer on rois jittered around the gt boxes of
    two scenes (``tests/test_torch_train.py``'s draws), tpu3d's RCNN
    weights, and its loss and gradients with the rows sharded over a
    2-device mesh, in float32."""
    jcfg = jax_tiny_cfg(rcnn=True, points=1024)
    b = train_batch(2, 1024, seed=22)
    pts, gt = b["pts_input"], b["gt_boxes3d"]
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
    mesh = jax_make_mesh(jax.devices()[:2])
    shard = NamedSharding(mesh, P("data"))

    def loss_fn(p, x, t):
        out = jnet.apply({"params": p}, x, train=True)
        return get_rcnn_loss(jcfg, dict(t, **out))[0]

    jloss, jgrads = jax.device_get(jax.jit(jax.value_and_grad(loss_fn))(
        params, jax.device_put(pts_input, shard),
        jax.device_put(target, shard)))
    inputs = {"cfg": _port_cfg(jcfg), "params": params,
              "target": {k: np.asarray(v) for k, v in target.items()}}
    return inputs, (float(jloss), jgrads)


@pytest.fixture(scope="module")
def reshard(tmp_path_factory, batch):
    """A checkpoint of one step written by one process, for the world-2
    ranks to restore."""
    base = tmp_path_factory.mktemp("reshard")
    cfg = cases.step_cfg()
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    model.load_state_dict(seeded_state_dict(model, 23))
    state = create_train_state(cfg, model, 10, 2)
    rows = shard_batch(make_mesh(), batch, "cpu")
    make_train_step(cfg, model)(state, rows, step_generator(1, 0, "cpu"), 0.9)
    return {"ckpt": save_checkpoint(str(base / "one"), model, state, 1),
            "out_dir": str(base / "two"), "batch": batch}


@pytest.fixture(scope="module")
def world2(tmp_path_factory, batch, rpn_inputs, rcnn_inputs, reshard):
    return _run(tmp_path_factory.mktemp("w2"), 2,
                ["step", "bn_step", "remat_step", "fused_bn", "fused_bn_bf16",
                 "rpn_grad", "rcnn_grad", "reshard"],
                {"batch": batch, "fused_bn": _fused_bn_inputs(),
                 "fused_bn_bf16": _fused_bn_inputs(bf16=True),
                 "rpn_grad": rpn_inputs[0], "rcnn_grad": rcnn_inputs[0],
                 "reshard": reshard})


@pytest.fixture(scope="module")
def world4(tmp_path_factory, batch):
    return _run(tmp_path_factory.mktemp("w4"), 4, ["step", "bn_step"],
                {"batch": batch, "steps": 1})


@pytest.fixture(scope="module")
def world3(tmp_path_factory, batch):
    return _run(tmp_path_factory.mktemp("w3"), 3, ["step"],
                {"batch": batch, "steps": 1})


def _close(got: dict, ref: dict, rtol, atol_of, what):
    assert set(got) == set(ref)
    for k, want in ref.items():
        if not want.is_floating_point():
            assert torch.equal(got[k], want), k
            continue
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=rtol,
                                   atol=atol_of(k), err_msg=f"{what} {k}")


def _equals_one_process(step, ref, lr):
    """One step of a rank against the one-process step (the module's
    tolerances)."""
    for k, v in ref["tb"].items():
        np.testing.assert_allclose(step["tb"][k], v, rtol=1e-9, atol=1e-12,
                                   err_msg=k)
    top = max(g.abs().max().item() for g in ref["grads"].values())
    _close(step["grads"], ref["grads"], 1e-9, lambda k: 1e-9 * top, "grad")
    stats = {k: v for k, v in ref["state"].items()
             if k.endswith((".mean", ".var"))}
    _close({k: step["state"][k] for k in stats}, stats, 1e-9, lambda k: 0.0,
           "running statistic")
    _close(step["state"], ref["state"], 1e-9,
           lambda k: lr * 1e-9 * top / EPS, "parameter")


LR0 = 0.002 / 10  # TRAIN.LR / DIV_FACTOR: the one-cycle rate at count 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["step", "bn_step"])
def test_step_equals_global_batch_step(world, name, world2, world4,
                                       reference):
    """Each rank's first step (its rows of the global batch of 4) equals
    the one-process step at B=4: metrics, gradients, running statistics
    and parameters; ``bn_step`` with RCNN.USE_BN, kernel 9's training form
    under the reduced sums."""
    results = {2: world2, 4: world4}[world]
    ref = reference[name][0]
    assert ref["tb"]["rpn_fg_sum"] > 0 and ref["tb"]["rcnn_reg_fg"] > 0
    for r in results:
        assert r[name]["ranks"] == tuple(range(world))
        _equals_one_process(r[name]["steps"][0], ref, LR0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["step", "bn_step"])
def test_parameters_bit_equal_across_ranks(world, name, world2, world4):
    """Every rank holds the same parameters and running statistics, to the
    bit: after two steps at a world of 2, after one at 4."""
    results = {2: world2, 4: world4}[world]
    last = results[0][name]["steps"][-1]
    for r in results[1:]:
        for k, v in r[name]["steps"][-1]["state"].items():
            assert torch.equal(v, last["state"][k]), k
    assert last["step"] == {2: 2, 4: 1}[world]


def test_remat_step_equals_the_step_on_two_ranks(world2, reference):
    """TRAIN.REMAT under a mesh of 2: the backbone's recomputation in the
    backward (its first BatchNorm runs twice) reruns its BatchNorm layers'
    all-reduces on both ranks in the same order, so each rank's first step
    equals its step without the key
    to the bit (metrics, gradients, running statistics, parameters) and
    the one-process step at B=4 as ``step`` does."""
    for r in world2:
        got, want = r["remat_step"]["steps"][0], r["step"]["steps"][0]
        assert r["remat_step"]["ranks"] == (0, 1)
        assert (got["bn_calls"], want["bn_calls"]) == (2, 1)
        assert got["tb"] == want["tb"]
        for part in ("grads", "state"):
            assert set(got[part]) == set(want[part])
            for k, v in want[part].items():
                assert torch.equal(got[part][k], v), (part, k)
        _equals_one_process(got, reference["step"][0], LR0)


def test_mesh_takes_a_prefix_as_tpu3d(world3, reference):
    """At a world of 3 and a batch of 4 the mesh is ranks 0 and 1, as
    tpu3d's make_mesh(batch_size=4) takes 2 of 3 devices; rank 2 sits the
    step out (it runs none of its collectives, or the others would wait on
    it) and the two ranks' step equals the one-process step."""
    assert jax_make_mesh(jax.devices()[:3], batch_size=4).devices.size == 2
    assert [r["step"]["ranks"] for r in world3] == [(0, 1)] * 3
    assert [r["step"]["index"] for r in world3] == [0, 1, None]
    assert world3[2]["step"].get("skipped")
    for r in world3[:2]:
        _equals_one_process(r["step"]["steps"][0], reference["step"][0], LR0)


def test_mesh_without_a_group():
    """Without an initialised process group the mesh is this process
    alone, without a group; a group cannot be passed."""
    mesh = make_mesh(batch_size=4)
    assert (mesh.ranks, mesh.group, mesh.index) == ((0,), None, 0)
    assert mesh.rows(4) == slice(0, 4)
    with pytest.raises(ValueError, match="not initialised"):
        make_mesh(group=object())


def test_fused_bn_training_form_reduces_over_the_mesh(world2):
    """Kernel 9's training form (forward statistics, the backward's packs)
    at 2 ranks of 2 slab rows each equals it on the 4 rows: outputs,
    statistics, d_x0 and the weights' gradients summed, in float64."""
    ref = cases.fused_bn_case(_fused_bn_inputs())
    out = torch.cat([r["fused_bn"]["out"] for r in world2])
    d_x0 = torch.cat([r["fused_bn"]["d_x0"] for r in world2])
    torch.testing.assert_close(out, ref["out"], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(d_x0, ref["d_x0"], rtol=1e-10, atol=1e-10)
    for r in world2:
        for a, b in zip(r["fused_bn"]["stats"], ref["stats"]):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
        for a, b in zip(r["fused_bn"]["d_weights"], ref["d_weights"]):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_fused_bn_bf16_training_form_reduces_over_the_mesh(world2):
    """Kernel 9's bf16 training form (its passes' plain pieces on bf16
    slabs) at 2 ranks of 2 slab rows each against it on the 4 rows: the
    bf16 outputs and d_x0 equal, the f32 statistics and the weights'
    gradients summed over the mesh within 1e-6 of each largest value (the
    f64 sums of two ranks added in another order)."""
    ref = cases.fused_bn_case(_fused_bn_inputs(bf16=True))
    out = torch.cat([r["fused_bn_bf16"]["out"] for r in world2])
    d_x0 = torch.cat([r["fused_bn_bf16"]["d_x0"] for r in world2])
    assert out.dtype == d_x0.dtype == torch.bfloat16
    assert torch.equal(out, ref["out"]) and torch.equal(d_x0, ref["d_x0"])
    for r in world2:
        got = r["fused_bn_bf16"]
        for a, b in zip(got["stats"] + got["d_weights"],
                        ref["stats"] + ref["d_weights"]):
            assert a.dtype == torch.float32
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-6 * b.abs().max().item())


def test_rpn_matches_tpu3d_on_two_devices(world2, rpn_inputs):
    """The RPN's loss, gradients and running statistics at 2 ranks of one
    scene each against tpu3d's on a 2-device mesh, float64."""
    jloss, jgrads, jstats = rpn_inputs[1]
    ref = dict(_flat(jgrads))
    scale = max(np.abs(v).max() for v in ref.values())
    for r in world2:
        got = r["rpn_grad"]
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-9)
        ours = dict(_flat(got["grads"]))
        assert set(ours) == set(ref)
        for k, b in ref.items():
            np.testing.assert_allclose(ours[k], b, rtol=1e-7,
                                       atol=1e-9 * scale, err_msg=k)
        for k, b in _flat(jstats):
            np.testing.assert_allclose(dict(_flat(got["stats"]))[k], b,
                                       rtol=1e-9, atol=1e-9, err_msg=k)


def test_rcnn_matches_tpu3d_on_two_devices(world2, rcnn_inputs):
    """The RCNN's loss and gradients at 2 ranks of tpu3d's sampled rows of
    one scene each against tpu3d's on a 2-device mesh, float32."""
    jloss, jgrads = rcnn_inputs[1]
    ref = dict(_flat(jgrads))
    for r in world2:
        got = r["rcnn_grad"]
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
        ours = dict(_flat(got["grads"]))
        assert set(ours) == set(ref)
        for k, b in ref.items():
            np.testing.assert_allclose(ours[k], b, rtol=1e-4,
                                       atol=1e-4 * np.abs(b).max() + 1e-12,
                                       err_msg=k)


def test_checkpoint_reshards_1_to_2_and_back(world2, reshard):
    """A checkpoint written at a world of 1 restores at 2, trains a step
    there and is saved by rank 0; restored at 1, its parameters equal
    every rank's to the bit, at step 2 and epoch 2."""
    got = [r["reshard"] for r in world2]
    assert got[0]["path"] == got[1]["path"] and got[0]["step"] == 2
    cfg = cases.step_cfg()
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    state = create_train_state(cfg, model, 10, 2)
    state, epoch = load_checkpoint(got[0]["path"], model, state)
    assert (epoch, state.step) == (2, 2)
    for r in got:
        for k, v in model.state_dict().items():
            assert torch.equal(v, r["state"][k]), k


def test_tiny_cfg_is_tpu3d_s():
    """The port's copy of ``__graft_entry__._tiny_cfg`` sets what tpu3d's
    sets, at both point budgets."""
    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if hasattr(v, "items"):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v).tolist()

    for points in (1024, 4096):
        for rcnn in (False, True):
            assert dict(leaves(_tiny_cfg(rcnn, points))) == dict(leaves(
                _port_cfg(jax_tiny_cfg(rcnn, points))))


class _Numbers:
    """A dataset of sample i = {"x": [i]}."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"x": np.array([i])}

    def collate_batch(self, samples):
        return {"x": np.stack([s["x"] for s in samples])}


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_shards_each_global_batch(drop_last):
    """Each rank's loader (shard (index, 2)) yields its half of every
    global batch of 4, in the one order of every rank, across epochs; the
    last short batch padded as without a shard."""
    whole = BatchLoader(_Numbers(), 4, shuffle=True, num_workers=1,
                        drop_last=drop_last, seed=3)
    halves = [BatchLoader(_Numbers(), 4, shuffle=True, num_workers=1,
                          drop_last=drop_last, seed=3, shard=(r, 2))
              for r in range(2)]
    for epoch in range(2):
        for loader in (whole, *halves):
            loader.set_epoch(epoch)
        got = [list(b) for b in zip(*halves)]
        want = list(whole)
        assert len(got) == len(want) == len(whole) == len(halves[0])
        for (a, b), w in zip(got, want):
            for k in ("x", "batch_valid"):
                np.testing.assert_array_equal(
                    np.concatenate([a[k], b[k]]), w[k])
    with pytest.raises(ValueError, match="does not split"):
        BatchLoader(_Numbers(), 4, shard=(0, 3))


def test_resolve_device_under_torchrun(monkeypatch):
    """With LOCAL_RANK set (torchrun), the CPU stays the CPU and a card is
    still asked for by default: without one it raises, naming device='cpu'
    as before."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


def test_lone_process_initialises_nothing(monkeypatch):
    """Outside torchrun (no WORLD_SIZE) and without a store, the CLIs'
    init_distributed starts no group and touches no card, even for the
    default ``cuda`` device without an index."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed(torch.device("cuda")) is False
    assert not torch.distributed.is_initialized()
