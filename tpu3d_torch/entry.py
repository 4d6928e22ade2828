"""Entry points of the port (counterpart of ``__graft_entry__.py``): a
compile-and-run check of the joint eval forward, and a dry run of tpu3d's
data-parallel mesh over several processes.

- ``entry()``: the joint PointRCNN eval forward at a reduced point budget
  (the default architecture, 1024 points) and example arguments;
- ``dryrun_multichip(n)``: ``n`` processes, one per GPU under NCCL, or
  under gloo when asked (``backend="gloo"``: on the CPU, or ``n`` ranks
  sharing the visible cards), each holding two scenes of the global batch:
  one data-parallel train step of the full train step (forward, proposal
  target layer, losses, gradients summed over the mesh, the clipped
  update) at the 4096-point mid shape, then the sharded eval of the
  pre-step weights with detection surgery on planted clusters, gathered to
  rank 0, with ``__graft_entry__.dryrun_multichip``'s assertions (finite
  loss, step 1, non-empty final boxes, recall at IoU 0.1 above 0).

    python -m tpu3d_torch.entry 2 --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

# eight roomy gt volumes per scene (x, z, ry), as tpu3d's dry run places
# them: anchor-size detections at bin-scattered positions reach IoU 0.1
GT_SITES = [(0, 20, 0.3), (-5, 35, -1.0), (10, 50, 0.8), (-15, 15, 0.0),
            (18, 30, 1.2), (-22, 55, -0.4), (5, 65, 2.0), (-10, 45, 0.5)]


def _tiny_cfg(rcnn=True, points=1024):
    """points=1024: quick compile-check shapes. points=4096: the mid shape
    the multi-process dry run takes (NPOINTS pyramid 1024/256/64/16, the
    default architecture scaled 4x down from default.yaml's 16384); the
    port's copy of ``__graft_entry__._tiny_cfg``."""
    from .config import fresh_cfg

    c = fresh_cfg()
    c.RPN.NUM_POINTS = points
    c.RPN.SA_CONFIG.NPOINTS = (
        [1024, 256, 64, 16] if points >= 4096 else [256, 64, 32, 16])
    c.RPN.USE_INTENSITY = False
    c.RPN.LOC_XZ_FINE = True
    c.RPN.LOSS_CLS = "SigmoidFocalLoss"
    pre, post = (1024, 128) if points >= 4096 else (256, 64)
    c.TRAIN.RPN_PRE_NMS_TOP_N = pre
    c.TRAIN.RPN_POST_NMS_TOP_N = post
    c.TEST.RPN_PRE_NMS_TOP_N = pre
    c.TEST.RPN_POST_NMS_TOP_N = post
    c.TRAIN.OPTIMIZER = "adam_onecycle"
    c.TRAIN.WEIGHT_DECAY = 0.001
    if rcnn:
        c.RCNN.ENABLED = True
        c.RCNN.ROI_SAMPLE_JIT = True
        c.RCNN.NUM_POINTS = 128
        c.RCNN.ROI_PER_IMAGE = 32 if points >= 4096 else 16
        c.RCNN.ROI_FG_AUG_TIMES = 3
        c.RCNN.SA_CONFIG.NPOINTS = [32, 16, -1]
        c.RCNN.SA_CONFIG.NSAMPLE = [16, 16, 16]
    return c


def detection_surgery(state: dict, rpn_bias=2.0, rcnn_bias=3.0) -> dict:
    """The two classification heads' output biases raised, in a copy of a
    ``state_dict``, so that boxes clear the RCNN score threshold with room
    (untouched weights score sigmoid(focal bias) = 0.01 everywhere and
    detect nothing): the sharded eval then compares real detections. The
    port's copy of ``__graft_entry__.detection_surgery``."""
    state = dict(state)
    for key, value in (("rpn.cls_head.out.bias", rpn_bias),
                       ("rcnn_net.cls_head.out.bias", rcnn_bias)):
        state[key] = torch.full_like(state[key], value)
    return state


def entry(device=None):
    """-> (fn, example_args): the joint eval forward of ``_tiny_cfg`` with
    seeded weights on ``device`` (the card by default), returning
    (rcnn_cls, rcnn_reg, rois)."""
    from .device import resolve_device
    from .models import PointRCNN
    from .weights import seeded_state_dict

    dev = resolve_device(device)
    cfg = _tiny_cfg(rcnn=True)
    model = PointRCNN(cfg, mode="TEST", device=dev)
    model.load_state_dict(seeded_state_dict(model, 0))
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(
        [-30, -1, 0], [30, 3, 70], size=(2, cfg.RPN.NUM_POINTS, 3)),
        dtype=torch.float32, device=dev)

    @torch.no_grad()
    def fn(pts_input):
        out = model({"pts_input": pts_input})
        return out["rcnn_cls"], out["rcnn_reg"], out["rois"]

    return fn, (pts,)


def _scenes(n_scenes: int, n_points: int):
    """The dry run's (points, gt boxes) as numpy: uniform scenes and the
    eight GT_SITES volumes in each."""
    rng = np.random.default_rng(0)
    pts = rng.uniform([-30, -1, 0], [30, 3, 70],
                      size=(n_scenes, n_points, 3)).astype(np.float32)
    gt = np.zeros((n_scenes, len(GT_SITES), 7), np.float32)
    for j, (gx, gz, gry) in enumerate(GT_SITES):
        gt[:, j] = [gx, 2.0, gz, 3.0, 2.5, 5.0, gry]
    return pts, gt


def rank_device(rank: int, backend: str | None, device: str) -> torch.device:
    """Rank ``rank``'s device: the CPU for ``device="cpu"``; under NCCL its
    own card; under gloo on cards, the cards shared round-robin."""
    if device == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if backend != "gloo" and rank >= n:
        raise RuntimeError(f"NCCL rank {rank} needs a card of its own; "
                           f"{n} visible")
    return torch.device("cuda", rank % n)


def _dryrun_rank(rank: int, world: int, store_path: str,
                 backend: str | None, device: str, result_path: str) -> None:
    from .datasets import plant_clusters
    from .models import PointRCNN
    from .parallel import (create_train_state, init_distributed, make_mesh,
                           make_train_step, shard_batch)
    from .tools.eval_rcnn import THRESH_LIST, _recall_counts, make_infer_step
    from .tools.train_rcnn import step_generator
    from .weights import seeded_state_dict

    dev = rank_device(rank, backend, device)
    init_distributed(dev, backend, torch.distributed.FileStore(
        store_path, world), rank, world)
    try:
        cfg = _tiny_cfg(rcnn=True, points=4096)  # mid shape (default / 4)
        B = 2 * world  # two scenes per process
        pts, gt = _scenes(B, cfg.RPN.NUM_POINTS)
        mesh = make_mesh(batch_size=B)
        model = PointRCNN(cfg, mode="TRAIN", device=dev)
        model.load_state_dict(seeded_state_dict(model, 0))
        # the pre-step weights, for the eval leg: one step on random labels
        # drives the cls logits down and swamps the surgery's bias
        init = {k: v.clone() for k, v in model.state_dict().items()}
        state = create_train_state(cfg, model, steps_per_epoch=10,
                                   total_epochs=2, mesh=mesh)
        step = make_train_step(cfg, model, mesh)
        # no RPN labels: the step makes them on the device from the gt
        # boxes of this rank's rows
        tb = step(state, shard_batch(mesh, {"pts_input": pts,
                                            "gt_boxes3d": gt}, dev),
                  step_generator(1, 0, dev), 0.9)
        loss = float(tb["loss"])
        assert np.isfinite(loss), f"non-finite loss {loss}"
        assert state.step == 1

        eval_model = PointRCNN(cfg, mode="TEST", device=dev)
        eval_model.load_state_dict(detection_surgery(init))
        eval_pts = plant_clusters(pts, gt, np.random.default_rng(3))
        infer = make_infer_step(eval_model, cfg)
        with torch.no_grad():
            out = infer(shard_batch(mesh, {"pts_input": eval_pts},
                                    dev)["pts_input"])
        host = {k: out[k].cpu().numpy()
                for k in ("final_boxes", "final_mask")}
        parts = [None] * mesh.size if mesh.index == 0 else None
        torch.distributed.gather_object(host, parts, dst=mesh.ranks[0],
                                        group=mesh.group)
        if mesh.index != 0:
            return
        boxes = np.concatenate([p["final_boxes"] for p in parts])
        mask = np.concatenate([p["final_mask"] for p in parts])
        assert boxes.shape[0] == B and np.isfinite(boxes).all()
        n_det, rec_total = 0, np.zeros(len(THRESH_LIST), np.int64)
        for k in range(B):
            rec, n_gt = _recall_counts(boxes[k][mask[k]], gt[k], dev)
            assert n_gt == len(GT_SITES)
            n_det += int(mask[k].sum())
            rec_total += rec
        assert n_det > 0, "sharded eval produced no detections"
        assert rec_total[0] > 0, (
            f"no recall hit at IoU 0.1 across {B} scenes ({n_det} "
            f"detections)")
        result = {"world": world, "backend": torch.distributed.get_backend(),
                  "loss": loss, "step": state.step, "scenes": B,
                  "detections": n_det, "recall_0.1": int(rec_total[0]),
                  "gt": len(GT_SITES) * B}
        with open(result_path, "w") as f:
            json.dump(result, f)
    finally:
        torch.distributed.destroy_process_group()


def spawn(fn, world: int, *args) -> None:
    """Run ``fn(rank, world, store_path, *args)`` in ``world`` spawned
    processes that meet at a ``FileStore`` in a fresh temporary directory
    (no port, so concurrent jobs never collide); a rank's exception is
    raised here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(fn, args=(world, os.path.join(tmp, "store"),
                                     *args),
                           nprocs=world, start_method="spawn", join=True)


def dryrun_multichip(n_devices: int, backend: str | None = None,
                     device: str = "cuda") -> dict:
    """One data-parallel train step and the sharded eval over ``n_devices``
    processes (see the module's docstring) -> rank 0's figures (loss, step,
    detections, recall hits at IoU 0.1). On cards the backend is NCCL, one
    card per process (fewer cards raise), unless ``backend="gloo"`` is
    given, which also runs several ranks on one card; ``device="cpu"`` runs
    them on the CPU under gloo. The kernels are built here, before the
    processes start, which then load them."""
    from .device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        if backend != "gloo" and torch.cuda.device_count() < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) under NCCL needs "
                f"{n_devices} cards; {torch.cuda.device_count()} visible")
        from .ops import _build

        _build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        result_path = os.path.join(tmp, "result.json")
        spawn(_dryrun_rank, n_devices, backend, dev.type, result_path)
        with open(result_path) as f:
            result = json.load(f)
    print(f"dryrun_multichip({n_devices}): train OK, loss="
          f"{result['loss']:.4f}, step={result['step']}")
    print(f"dryrun_multichip({n_devices}): eval OK, {result['detections']} "
          f"final detections across {result['scenes']} sharded scenes, "
          f"recall@0.1 {result['recall_0.1']}/{result['gt']}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="data-parallel dry run")
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.backend, args.device)


if __name__ == "__main__":
    main()
