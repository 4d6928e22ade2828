"""Input-pipeline throughput: ``BatchLoader`` scenes/s by worker mode and
count (counterpart of ``tpu3d/tools/bench_loader.py``).

Measures (a) the raw per-sample build cost, one core, no pipeline, and (b)
``BatchLoader`` throughput for thread and process workers at several
worker counts, over the TRAIN-mode ``KittiRCNNDataset`` at default.yaml's
shapes (16384 points; GT augmentation off unless ``--gt_aug``, to isolate
the loader's mechanics). Host work only: it says how many scenes a second
the host can feed the card's train step.

    python -m tpu3d_torch.tools.bench_loader [--data_root DIR]
        [--scenes 64] [--batch_size 8] [--workers 1,2,4]
        [--modes thread,process] [--npoints 16384] [--gt_aug]

Without ``--data_root`` it writes 32 synthetic frames under
``build/loader_bench`` in the checkout once and reads them. Prints one
line per measurement, then one JSON line of them all (tpu3d's keys).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--scenes", type=int, default=64,
                    help="scenes per measurement")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--workers", default="1,2,4",
                    help="comma-separated worker counts")
    ap.add_argument("--npoints", type=int, default=16384)
    ap.add_argument("--gt_aug", action="store_true")
    ap.add_argument("--modes", default="thread,process")
    args = ap.parse_args(argv)

    from ..config import fresh_cfg
    from ..datasets import (BatchLoader, KittiRCNNDataset,
                            create_synthetic_kitti)

    root = args.data_root
    if root is None:
        root = str(ROOT / "build" / "loader_bench")
        if not os.path.exists(os.path.join(root, "KITTI")):
            create_synthetic_kitti(root, n_frames=32, image_files=True)

    cfg = fresh_cfg()
    cfg.RPN.NUM_POINTS = args.npoints
    cfg.GT_AUG_ENABLED = bool(args.gt_aug)
    dataset = KittiRCNNDataset(root_dir=root, npoints=args.npoints,
                               split="train", mode="TRAIN", cfg=cfg, seed=0)

    results = {}

    # raw serial build cost (one core, no pipeline)
    n_raw = min(args.scenes, len(dataset) * 2)
    for i in range(4):
        dataset[i % len(dataset)]  # warm caches
    t0 = time.perf_counter()
    for i in range(n_raw):
        dataset[i % len(dataset)]
    dt = time.perf_counter() - t0
    results["serial_scenes_per_sec"] = n_raw / dt
    results["serial_ms_per_scene"] = 1e3 * dt / n_raw
    print(f"serial: {n_raw / dt:.1f} scenes/s "
          f"({1e3 * dt / n_raw:.2f} ms/scene)")

    worker_counts = [int(w) for w in args.workers.split(",")]
    n_batches = max(1, args.scenes // args.batch_size)
    for mode in args.modes.split(","):
        for w in worker_counts:
            loader = BatchLoader(dataset, args.batch_size, shuffle=False,
                                 num_workers=w, drop_last=False,
                                 worker_mode=mode)
            it = iter(loader)
            next(it)  # warm-up batch (starts the pool's work)
            t0 = time.perf_counter()
            seen = 1
            for _ in range(n_batches):
                try:
                    next(it)
                    seen += 1
                except StopIteration:
                    it = iter(loader)
                    next(it)
                    seen += 1
            dt = time.perf_counter() - t0
            rate = (seen - 1) * args.batch_size / dt
            results[f"{mode}_w{w}_scenes_per_sec"] = rate
            print(f"{mode:8s} workers={w}: {rate:.1f} scenes/s")
            loader.close()

    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
