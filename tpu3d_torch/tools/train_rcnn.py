"""Training CLI for PointRCNN on one GPU (rpn / rcnn / joint /
rcnn_offline modes; the counterpart of ``tpu3d/tools/train_rcnn.py``).

Reference parity: pointrcnn/tools/train_rcnn.py — same flags, modes
(rpn: RPN only; rcnn: joint with RPN fixed from a checkpoint; joint: both;
rcnn_offline: the RCNN alone, from the proposals and RPN features an RPN
eval run dumped, ``--rcnn_training_roi_dir`` / ``--rcnn_training_feature_dir``),
yaml config + --set overrides, run-dir layout with logs/tensorboard/checkpoints.
The loop: KITTI-format frames on disk -> ``KittiRCNNDataset`` ->
``BatchLoader`` -> ``device_prefetch`` onto the card -> the train step,
with the one-cycle schedules, the per-epoch BN momentum, checkpoints in
tpu3d's own format (``--ckpt`` resumes, ``--rpn_ckpt`` warm-starts) and the
``--train_with_eval`` validation pass.

    python -m tpu3d_torch.tools.train_rcnn --cfg_file configs/default.yaml \\
        --train_mode joint --data_root <root> [--synthetic] [--epochs N]

It runs on the card unless ``--device cpu`` is given (tpu3d's
``TPU3D_PLATFORM=cpu``); with no card and no ``--device cpu`` it raises.

Under ``torchrun`` (or in a process whose default process group is already
initialised) it trains over tpu3d's data-parallel mesh, one card per
process under NCCL: ``make_mesh(batch_size=...)`` takes the largest prefix
of the ranks whose count divides ``--batch_size``, each rank loads and
trains its rows of every global batch (``--batch_size`` is the global
batch, as tpu3d's), and the step is the global batch's; the validation pass
runs on a mesh of its own batch. Rank 0 alone logs and writes (the run
directory, tensorboard, checkpoints). A lone process runs as without
``torchrun``.

    torchrun --standalone --nproc_per_node 8 -m tpu3d_torch.tools.train_rcnn \
        --cfg_file configs/default.yaml --train_mode joint --batch_size 16 ...

Each step's randomness (dropout, the proposal target layer) comes from a
fresh ``torch.Generator`` seeded from (seed + 1, step), as tpu3d folds the
step into ``PRNGKey(seed + 1)``, and the loader's from (seed, epoch,
index): a run resumed from a checkpoint draws what an unbroken run draws.
"""

from __future__ import annotations

import argparse
import os
import shutil
import statistics
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import (cfg_from_file, cfg_from_list, fresh_cfg,
                      save_config_to_file)
from ..datasets import (BatchLoader, KittiRCNNDataset, create_synthetic_kitti,
                        device_prefetch)
from ..device import resolve_device
from ..models import PointRCNN
from ..parallel import (bn_momentum_at_epoch, create_train_state,
                        init_distributed, make_eval_loss_step, make_mesh,
                        make_train_step, replicate)
from ..parallel.mesh import lead
from ..utils.checkpoint import load_checkpoint, load_part_ckpt, save_checkpoint
from ..utils.logging import create_logger, create_tb_writer, null_logger
from ..weights import seeded_state_dict

# the batch arrays the train and eval-loss steps read (the RPN labels only
# while the RPN trains and --device_labels is off; the RCNN's labels and
# rois only in rcnn_offline mode)
BATCH_KEYS = ("pts_input", "gt_boxes3d", "rpn_cls_label", "rpn_reg_label",
              "cls_label", "reg_valid_mask", "gt_boxes3d_ct", "roi_boxes3d",
              "gt_iou", "roi_valid")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="train PointRCNN (gpu)")
    parser.add_argument("--cfg_file", type=str, default=None)
    parser.add_argument("--train_mode", type=str, default="rpn",
                        choices=["rpn", "rcnn", "joint", "rcnn_offline"])
    parser.add_argument("--rcnn_training_roi_dir", type=str, default=None,
                        help="saved RPN proposals (KITTI label files) for "
                             "rcnn_offline training")
    parser.add_argument("--rcnn_training_feature_dir", type=str, default=None,
                        help="dumped RPN backbone features for rcnn_offline "
                             "training")
    parser.add_argument("--train_with_eval", action="store_true",
                        help="evaluate loss/recall on the val split during "
                             "training (reference --train_with_eval/eval_epoch)")
    parser.add_argument("--eval_frequency", type=int, default=1,
                        help="epochs between in-training evals")
    parser.add_argument("--rcnn_eval_roi_dir", type=str, default=None,
                        help="saved proposals for the val split "
                             "(rcnn_offline + --train_with_eval)")
    parser.add_argument("--rcnn_eval_feature_dir", type=str, default=None,
                        help="dumped features for the val split "
                             "(rcnn_offline + --train_with_eval)")
    parser.add_argument("--data_root", type=str, default=None,
                        help="dataset root containing KITTI/ (default: "
                             "multi_data/<dataset>)")
    parser.add_argument("--dataset", type=str, default="kitti")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint to resume from")
    parser.add_argument("--rpn_ckpt", type=str, default=None,
                        help="RPN checkpoint for rcnn mode (partial load)")
    parser.add_argument("--gt_database", type=str, default=None)
    parser.add_argument("--ckpt_save_interval", type=int, default=5)
    parser.add_argument("--subsample", type=int, default=-1)
    parser.add_argument("--shuffle_subsample", type=str, default=None)
    parser.add_argument("--seed", type=int, default=19260817)
    parser.add_argument("--device_labels", action="store_true",
                        help="derive RPN cls/reg labels on the card inside "
                             "the train step (from gt_boxes3d) instead of "
                             "on host loader workers")
    parser.add_argument("--synthetic", action="store_true",
                        help="generate and train on a synthetic KITTI dataset")
    parser.add_argument("--profile", action="store_true",
                        help="capture a torch.profiler trace of steps 10-15 "
                             "into <output_dir>/profile (chrome trace)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where to train: cuda (default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=
                        argparse.REMAINDER, help="set extra config keys")
    return parser.parse_args(argv)


def configure_mode(cfg, train_mode: str):
    """Set the stages ``train_mode`` trains on ``cfg``, in place (reference:
    train_rcnn.py:159-172): "rpn" the RPN alone, "rcnn" the RCNN on a fixed
    RPN, "joint" both, "rcnn_offline" the RCNN on saved proposals and
    dumped RPN features. Returns ``cfg``."""
    if train_mode == "rpn":
        cfg.RPN.ENABLED = True
        cfg.RCNN.ENABLED = False
    elif train_mode == "rcnn":
        cfg.RCNN.ENABLED = True
        cfg.RPN.ENABLED = True
        cfg.RPN.FIXED = True
    elif train_mode == "joint":
        cfg.RPN.ENABLED = cfg.RCNN.ENABLED = True
        cfg.RPN.FIXED = False
    elif train_mode == "rcnn_offline":
        cfg.RCNN.ENABLED = True
        cfg.RPN.ENABLED = False
    else:
        raise ValueError(train_mode)
    return cfg


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step) alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, step])
                        .generate_state(1, np.uint64)[0]))
    return gen


@dataclass
class TrainRun:
    """What ``main`` leaves: the trained model and its state, each step's
    loss and wall time (ms, the wait for the loader's batch included; on
    the card each step ends in a synchronize), each validation batch's wall
    time, each epoch's validation metrics, and the checkpoints written."""
    model: torch.nn.Module
    state: object
    losses: list = field(default_factory=list)
    step_ms: list = field(default_factory=list)
    eval_ms: list = field(default_factory=list)
    val: list = field(default_factory=list)
    checkpoints: list = field(default_factory=list)


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    distributed = init_distributed(dev)
    writes = lead()
    cfg = fresh_cfg()
    if args.cfg_file:
        cfg_from_file(args.cfg_file, cfg)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs, cfg)
    configure_mode(cfg, args.train_mode)
    if args.train_mode == "rcnn_offline" and not (
            args.rcnn_training_roi_dir and args.rcnn_training_feature_dir):
        raise ValueError(
            "rcnn_offline needs --rcnn_training_roi_dir and "
            "--rcnn_training_feature_dir (dumped by eval_rcnn --eval_mode "
            "rpn --save_rpn_feature --save_result)")
    cfg.TAG = (os.path.splitext(os.path.basename(args.cfg_file))[0]
               if args.cfg_file else "default")

    root = args.output_dir or os.path.join("output", args.train_mode, cfg.TAG)
    ckpt_dir = os.path.join(root, "ckpt")
    log_file = os.path.join(root, "log_train.txt")
    logger = null_logger()
    if writes:
        os.makedirs(ckpt_dir, exist_ok=True)
        logger = create_logger(log_file)
        logger.info("**********************Start logging*******************"
                    "***")
        for key, val in vars(args).items():
            logger.info("{:16} {}".format(key, val))
        save_config_to_file(cfg, logger=logger)
        # source snapshot (reference: train_rcnn.py:192-196)
        backup_dir = os.path.join(root, "backup_files")
        os.makedirs(backup_dir, exist_ok=True)
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        shutil.make_archive(os.path.join(backup_dir, "tpu3d_torch_src"),
                            "zip", pkg_root)

    if args.synthetic:
        data_root = os.path.join(root, "synthetic_data")
        if writes and not os.path.exists(os.path.join(data_root, "KITTI")):
            create_synthetic_kitti(data_root, n_frames=32, image_files=True)
        args.data_root = data_root
    if distributed:  # rank 0's frames are on disk
        torch.distributed.barrier()
    data_root = args.data_root or os.path.join("multi_data", args.dataset)

    dataset = KittiRCNNDataset(
        root_dir=data_root, npoints=cfg.RPN.NUM_POINTS, split=cfg.TRAIN.SPLIT,
        mode="TRAIN", classes=cfg.CLASSES, cfg=cfg, logger=logger,
        gt_database_dir=args.gt_database, subsample=args.subsample,
        rcnn_training_roi_dir=args.rcnn_training_roi_dir,
        rcnn_training_feature_dir=args.rcnn_training_feature_dir,
        shuffle_subsample=args.shuffle_subsample, seed=args.seed,
        device_rpn_labels=args.device_labels)
    # the mesh: the largest prefix of the ranks whose count divides the
    # global batch (tpu3d: tools/train_rcnn.py:198); the other ranks sit
    # the training out
    mesh = make_mesh(batch_size=args.batch_size)
    loader = BatchLoader(dataset, args.batch_size, shuffle=True,
                         num_workers=args.workers, drop_last=True,
                         seed=args.seed,
                         shard=mesh.shard if mesh.member else None)
    steps_per_epoch = max(1, len(loader))
    logger.info(f"dataset: {len(dataset)} samples, {steps_per_epoch} steps/epoch")
    logger.info(f"mesh: {mesh.size} rank(s) of the job, "
                f"{args.batch_size // mesh.size} scenes each")

    val_loader = None
    if args.train_with_eval:
        # in-training validation (reference: train_rcnn.py:83-93 test_loader)
        val_dataset = KittiRCNNDataset(
            root_dir=data_root, npoints=cfg.RPN.NUM_POINTS,
            split=cfg.TRAIN.VAL_SPLIT, mode="EVAL", classes=cfg.CLASSES,
            cfg=cfg, logger=logger, seed=args.seed,
            rcnn_eval_roi_dir=args.rcnn_eval_roi_dir,
            rcnn_eval_feature_dir=args.rcnn_eval_feature_dir)
        val_batch = min(args.batch_size, len(val_dataset))
        # the validation pass's mesh, at its own batch (tpu3d :235-237)
        val_mesh = make_mesh(batch_size=val_batch)
        val_loader = BatchLoader(
            val_dataset, val_batch, shuffle=False, num_workers=args.workers,
            drop_last=True,
            shard=val_mesh.shard if val_mesh.member else None)
        logger.info(f"val dataset: {len(val_dataset)} samples")

    model = PointRCNN(cfg, mode="TRAIN", device=dev)
    model.load_state_dict(seeded_state_dict(model, args.seed))
    state = create_train_state(cfg, model, steps_per_epoch, args.epochs,
                               mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model parameters: {n_params / 1e6:.2f}M on {dev}")

    start_epoch = 0
    if args.ckpt:
        state, start_epoch = load_checkpoint(args.ckpt, model, state)
        logger.info(f"resumed from {args.ckpt} at epoch {start_epoch}")
    elif args.rpn_ckpt:
        state = load_part_ckpt(args.rpn_ckpt, model, state, logger=logger)
        logger.info(f"partial-loaded RPN weights from {args.rpn_ckpt}")

    train_step = make_train_step(cfg, model, mesh)
    eval_loss_step = (make_eval_loss_step(cfg, model, val_mesh)
                      if val_loader is not None else None)
    tb = create_tb_writer(os.path.join(root, "tensorboard")) if writes \
        else None
    run = TrainRun(model=model, state=state)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def eval_epoch(epoch):
        """Average val metrics over the loader (reference: eval_epoch,
        train_utils.py:140-168); each batch's metrics are the global
        batch's. Ranks outside the validation mesh skip it (-> None); its
        ranks that sat the training out take the trained weights from rank
        0 first."""
        if not val_mesh.member:
            return None
        if not mesh.member or val_mesh.ranks != mesh.ranks:
            replicate(val_mesh, model)
        sums, count = {}, 0
        t0 = time.perf_counter()
        for vbatch in device_prefetch(val_loader, size=2, keys=BATCH_KEYS,
                                      device=dev):
            metrics = eval_loss_step(state, vbatch)
            count += 1
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            t1 = time.perf_counter()
            run.eval_ms.append((t1 - t0) * 1e3)
            t0 = t1
        out = {k: v / max(count, 1) for k, v in sums.items()}
        if "gt_cnt" in sums and sums["gt_cnt"] > 0:
            out["recall"] = sums["recalled_cnt"] / sums["gt_cnt"]
        logger.info("epoch %d val: %s" % (epoch, " ".join(
            f"{k}={v:.4f}" for k, v in sorted(out.items()))))
        if tb:
            for k, v in out.items():
                tb.add_scalar(f"val/{k}", v, state.step)
        return out

    prof = None
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        bn_m = bn_momentum_at_epoch(cfg, epoch)
        epoch_ms = []
        t0 = time.perf_counter()
        # device_prefetch: a staging thread starts each batch's
        # host->device copy while the card runs the previous step; each
        # rank stages its own rows (tpu3d :263)
        for it, batch in enumerate(device_prefetch(
                loader if mesh.member else (), size=2, keys=BATCH_KEYS,
                device=dev)):
            gstep0 = state.step
            if args.profile and writes and gstep0 == 10:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if dev.type == "cuda" else [])])
                prof.__enter__()
            metrics = train_step(state, batch,
                                 step_generator(args.seed + 1, gstep0, dev),
                                 bn_m)
            loss = float(metrics["loss"])
            sync()
            if prof is not None and gstep0 == 15:
                prof.__exit__(None, None, None)
                os.makedirs(os.path.join(root, "profile"), exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(root, "profile", "trace.json"))
                prof = None
                logger.info("profiler trace written to %s" %
                            os.path.join(root, "profile"))
            t1 = time.perf_counter()
            epoch_ms.append((t1 - t0) * 1e3)
            t0 = t1
            run.losses.append(loss)
            if it % 10 == 0:
                logger.info(f"epoch {epoch} it {it}/{steps_per_epoch} "
                            f"loss {loss:.4f}")
                if tb:
                    for k, v in metrics.items():
                        tb.add_scalar(f"train/{k}", float(v), state.step)
        run.step_ms.extend(epoch_ms)
        if epoch_ms:
            logger.info(f"epoch {epoch}: {len(epoch_ms)} steps, median "
                        f"{statistics.median(epoch_ms):.1f} ms/step")
        if mesh.member and ((epoch + 1) % args.ckpt_save_interval == 0
                            or epoch == args.epochs - 1):
            path = save_checkpoint(ckpt_dir, model, state, epoch + 1, mesh)
            run.checkpoints.append(path)
            logger.info(f"checkpoint saved: {path}")
        if val_loader is not None and epoch % args.eval_frequency == 0:
            val = eval_epoch(epoch)
            if val is not None:
                run.val.append(val)
    if prof is not None:
        prof.__exit__(None, None, None)
    if tb:
        tb.close()
    loader.close()
    if val_loader is not None:
        val_loader.close()
    logger.info("**********************End training**********************")
    for h in list(logger.handlers):  # a later run in this process logs apart
        if getattr(h, "baseFilename", None) == os.path.abspath(log_file):
            logger.removeHandler(h)
            h.close()
    return run


if __name__ == "__main__":
    main()
