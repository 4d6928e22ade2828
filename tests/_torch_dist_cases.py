"""The ranks' side of the port's data-parallel tests: functions that a
spawned process runs (``tpu3d_torch.entry.spawn``), and the one-process
references they are held to. Imports nothing of JAX or tpu3d, so that a
rank starts with torch and the port alone.

A rank meets the others at a ``FileStore`` under the test's temporary
directory (no port, so concurrent test workers never collide), runs the
named cases on inputs the test saved with ``torch.save``, and saves its
results beside them, one file per rank.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from tpu3d_torch.entry import _tiny_cfg, detection_surgery
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.models.pointnet2 import BatchNorm
from tpu3d_torch.models.train_functions import get_rcnn_loss, model_loss
from tpu3d_torch.ops.fused_sa import _FusedBNMLPPool
from tpu3d_torch.parallel import (create_train_state, init_distributed,
                                  make_mesh, make_train_step, replicate,
                                  shard_batch, use_mesh)
from tpu3d_torch.parallel.mesh import reduce_metrics, sum_gradients
from tpu3d_torch.tools.train_rcnn import step_generator
from tpu3d_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tpu3d_torch.weights import params_from_jax, params_to_jax, \
    seeded_state_dict

GLOBAL_BATCH = 4


def step_cfg(use_bn: bool = False, remat: bool = False):
    """``_tiny_cfg``'s joint model with RPN BatchNorm, dropout 0.5 in the
    RPN heads and, with ``use_bn``, an RCNN with BatchNorm, whose SA_0 and
    SA_1 take kernel 9's slab route; with ``remat``, TRAIN.REMAT (the
    backbone recomputed in the backward)."""
    cfg = _tiny_cfg(rcnn=True, points=1024)
    cfg.RPN.DP_RATIO = 0.5
    cfg.RCNN.USE_BN = use_bn
    cfg.TRAIN.REMAT = remat
    return cfg


def train_steps(cfg, batch: dict, mesh=None, steps: int = 2,
                dtype=torch.float64) -> list[dict]:
    """``steps`` train steps of ``PointRCNN(cfg)`` in ``dtype`` on the CPU
    from seeded weights, on ``batch`` (the global batch, numpy), over
    ``mesh`` (this rank's rows) or alone; the generator of step i is
    ``step_generator(1, i)`` on every rank. -> per step: the state_dict,
    the summed and clipped gradients, the metrics as floats, the calls of
    the backbone's first BatchNorm (two under TRAIN.REMAT)."""
    model = PointRCNN(cfg, mode="TRAIN", device="cpu").to(dtype)
    model.load_state_dict({k: v.to(dtype) for k, v in
                           seeded_state_dict(model, 23).items()})
    calls = []
    next(m for m in model.rpn.backbone.modules() if isinstance(
        m, BatchNorm)).register_forward_hook(lambda *_: calls.append(1))
    state = create_train_state(cfg, model, 10, 2, mesh=mesh)
    step = make_train_step(cfg, model, mesh)
    rows = shard_batch(mesh or make_mesh(), batch, "cpu")
    rows = {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in rows.items()}
    out = []
    for i in range(steps):
        calls.clear()
        tb = step(state, rows, step_generator(1, i, "cpu"), 0.9)
        out.append({
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "tb": {k: float(v) for k, v in tb.items()}, "step": state.step,
            "bn_calls": len(calls)})
    return out


def fused_bn_case(inputs: dict, mesh=None) -> dict:
    """Kernel 9's training form through its autograd Function on the CPU
    (its plain pieces in the kernels' sequence: three statistics passes,
    the final reduction, two backward waves and the elementwise pass) on
    this rank's rows of the slab: the output rows, the statistics, the
    gradient of x0's rows, and the weights' gradients summed over the
    mesh."""
    x0 = inputs["x0"]
    rows = slice(None) if mesh is None else mesh.rows(len(x0))
    x0 = x0[rows].clone().requires_grad_()
    leaves = [t.clone().requires_grad_() for t in inputs["weights"]]
    with use_mesh(mesh):
        out, *stats = _FusedBNMLPPool.apply(x0, *leaves, 1e-5)
        (out * inputs["grad"][rows]).sum().backward()
    sum_gradients(leaves, mesh)
    return {"out": out.detach(), "stats": [s.clone() for s in stats],
            "d_x0": x0.grad, "d_weights": [t.grad for t in leaves]}


def rpn_grad_case(inputs: dict, mesh=None) -> dict:
    """The RPN's train-mode loss and gradients in float64 on tpu3d's
    weights (flax trees), this rank's scenes and labels: the global loss,
    the gradients summed over the mesh (flax trees) and the running
    statistics."""
    cfg = inputs["cfg"]
    model = PointRCNN(cfg, mode="TRAIN", device="cpu").double()
    model.load_state_dict({k: v.double() for k, v in params_from_jax(
        inputs["params"], inputs["stats"]).items()})
    pts = inputs["pts"]
    rows = slice(None) if mesh is None else mesh.rows(len(pts))
    labels = {k: torch.as_tensor(v[rows]) for k, v in inputs["labels"].items()}
    with use_mesh(mesh):
        out = model({"pts_input": torch.as_tensor(pts[rows])}, train=True,
                    bn_momentum=0.8)
        loss, _ = model_loss(cfg, out, labels)
        loss.backward()
    sum_gradients(model.parameters(), mesh)
    loss = reduce_metrics({"loss": loss.detach()}, mesh)["loss"]
    grads = {n: p.grad for n, p in model.named_parameters()}
    return {"loss": float(loss), "grads": params_to_jax(grads)[0],
            "stats": params_to_jax(model.state_dict())[1]}


def rcnn_grad_case(inputs: dict, mesh=None) -> dict:
    """The RCNN's loss and gradients in float32 on tpu3d's sampled targets
    (B·R rows, scene-major), this rank's rows of them."""
    cfg = inputs["cfg"]
    target = inputs["target"]
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    full = model.state_dict()
    full.update(params_from_jax({"rcnn_net": inputs["params"]}, {}))
    model.load_state_dict(full)
    n = len(target["sampled_pts"])
    rows = slice(None) if mesh is None else mesh.rows(n)
    t = {k: torch.as_tensor(np.asarray(v)[rows]) for k, v in target.items()}
    with use_mesh(mesh):
        out = model.rcnn_net(t["sampled_pts"], t["pts_feature"], train=True)
        loss, _ = get_rcnn_loss(cfg, dict(out, **t))
        loss.backward()
    net = list(model.rcnn_net.named_parameters())
    sum_gradients([p for _, p in net], mesh)
    loss = reduce_metrics({"loss": loss.detach()}, mesh)["loss"]
    return {"loss": float(loss),
            "grads": params_to_jax({n: p.grad for n, p in net})[0]}


def reshard_case(inputs: dict, mesh) -> dict:
    """A checkpoint written by one process restored on this mesh: loaded
    on every rank, one step on this rank's rows, saved by rank 0 ->
    this rank's state_dict and step after it."""
    cfg = step_cfg()
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    state = create_train_state(cfg, model, 10, 2, mesh=mesh)
    state, epoch = load_checkpoint(inputs["ckpt"], model, state)
    replicate(mesh, model)
    replicate(mesh, state)
    step = make_train_step(cfg, model, mesh)
    step(state, shard_batch(mesh, inputs["batch"], "cpu"),
         step_generator(1, state.step, "cpu"), 0.9)
    path = save_checkpoint(inputs["out_dir"], model, state, epoch + 1, mesh)
    return {"state": {k: v.clone() for k, v in model.state_dict().items()},
            "step": state.step, "path": path}


def _case(name: str, inputs: dict):
    mesh = make_mesh(batch_size=GLOBAL_BATCH)
    info = {"ranks": mesh.ranks, "index": mesh.index}
    if not mesh.member:  # sits the step out: runs nothing of it
        return dict(info, skipped=True)
    if name in ("step", "bn_step"):
        return dict(info, steps=train_steps(step_cfg(name == "bn_step"),
                                            inputs["batch"], mesh,
                                            inputs.get("steps", 2)))
    if name == "remat_step":
        return dict(info, steps=train_steps(step_cfg(remat=True),
                                            inputs["batch"], mesh, 1))
    if name in ("fused_bn", "fused_bn_bf16"):
        return fused_bn_case(inputs[name], mesh)
    if name == "rpn_grad":
        return rpn_grad_case(inputs["rpn_grad"], make_mesh(batch_size=2))
    if name == "rcnn_grad":
        return rcnn_grad_case(inputs["rcnn_grad"], make_mesh(batch_size=2))
    if name == "reshard":
        return reshard_case(inputs["reshard"], mesh)
    raise KeyError(name)


def run_cases(rank: int, world: int, store_path: str, in_path: str,
              out_path: str, cases) -> None:
    """A rank of the test's job: the named cases on the saved inputs, under
    gloo on the CPU -> ``{out_path}.{rank}``."""
    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), "gloo",
                     dist.FileStore(store_path, world), rank, world)
    try:
        inputs = torch.load(in_path, weights_only=False)
        results = {name: _case(name, inputs) for name in cases}
        torch.save(results, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def run_cli(rank: int, world: int, store_path: str, in_path: str,
            out_path: str) -> None:
    """A rank of a CLI run: ``main`` of each saved (module, argv), in order,
    -> its results on this rank, and whether this rank's logger writes."""
    import importlib

    torch.set_num_threads(2)
    init_distributed(torch.device("cpu"), "gloo",
                     dist.FileStore(store_path, world), rank, world)
    try:
        jobs = torch.load(in_path, weights_only=False)
        results = []
        for module, argv in jobs:
            for name in ("tpu3d_torch", "tpu3d_torch.quiet"):
                logging.getLogger(name).handlers.clear()
            mod = importlib.import_module(module)
            mod.create_tb_writer = lambda log_dir: None
            got = mod.main(argv)
            if hasattr(got, "state"):  # a TrainRun: what can be pickled
                got = {"losses": got.losses, "checkpoints": got.checkpoints,
                       "val": got.val}
            results.append((got, bool(logging.getLogger(
                "tpu3d_torch").handlers)))
        torch.save(results, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def surgery_state(model) -> dict:
    """Seeded weights with the classification biases raised, so that an
    eval finds boxes."""
    return detection_surgery(seeded_state_dict(model, 7))
