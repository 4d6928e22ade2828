"""Time the nearest-k search, the gather-form SA backward and FPS of one
checkout of the port on seeded inputs, to compare two checkouts on the same
card in turns.

    python3 tpu3d_torch/tools/compare_kernels.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``tpu3d_torch`` is imported (default:
this one; run the file as a script, not with ``-m``, so that no other
checkout's package is imported first). It needs only the public
signatures of ``nearest_k(centers, pts, k, max_radius)``,
``fused_gathered_mlp_pool_backward``, ``furthest_point_sample_with_3nn``
and ``furthest_point_sample``, and the models' entry points, so an older
checkout unpacked beside this one (``git archive``) can be timed by this
script. Shapes:

- nearest_k at the six levels of default.yaml's eval forward (B=2 scenes,
  200 pooled ROIs) and of its train-mode forward (B=16, 1024 sampled ROIs),
  each level's inputs recorded from a forward of the checkout's own model
  with seeded weights on the planted-cluster scenes (so both checkouts see
  the same inputs), with their sums over the six launches; double.yaml's
  SA_0 (B=4, 4096 centers of 32768 points); the dense case, the six eval
  shapes on the dense box (16384 points in 8 x 4 x 8 m; pooled ROIs of
  512 points in a 0.6 m cube), where every center has at least k points
  within its radius; and SA_0's candidates with their coordinates as the
  RPN groups them (the kernel's coordinates, or the ids and a gather);
- the backward at default.yaml's RCNN SA_0 and SA_1 of the train step
  (1024 rows; M = 128 / 32 centres of S = 64 slots; C3 = 128 / 256) under
  three routings of the pooled gradient: every channel live at a slot
  drawn uniformly over S ("full spread"), 2% of the channels live there
  ("sparse"), and every channel live at slot 0 ("one slot", the shape
  seeded weights give);
- FPS+3NN at default's and double's RPN levels, and the long-row FPS at
  (16, 32768) -> 4096.

Times are device times (``kernel_bench.cuda_ms``, beside this file: calls
run back to back on the card behind a spin that outlasts their queueing),
each with its "queued" and "call" ms.
Prints one line per case and a JSON line; needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import sys
from pathlib import Path


def load_bench():
    """``kernel_bench.py`` from beside this file: the clock and the seeded
    inputs, whichever checkout ``--root`` names."""
    path = Path(__file__).with_name("kernel_bench.py")
    spec = importlib.util.spec_from_file_location("kernel_bench", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LEVELS = ("RPN SA_0", "RPN SA_1", "RPN SA_2", "RPN SA_3", "RCNN SA_0",
          "RCNN SA_1")


def path_inputs(bench, cfg, B, train, seed=0):
    """The six nearest_k calls of one default.yaml forward at B scenes
    (eval, or train mode with the gt boxes): [(centers, pts, k, radius)]."""
    import torch

    from tpu3d_torch.datasets import random_scenes, train_batch
    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.weights import seeded_state_dict

    model = PointRCNN(cfg, mode="TRAIN" if train else "TEST", device="cuda")
    model.load_state_dict(seeded_state_dict(model, seed))
    N = cfg.RPN.NUM_POINTS
    with torch.no_grad(), bench.record_nearest_k() as calls:
        if train:
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in train_batch(B, N, seed).items()}
            gen = torch.Generator(device="cuda").manual_seed(seed)
            model(batch, train=True, bn_momentum=0.9, generator=gen)
        else:
            model({"pts_input": torch.from_numpy(
                random_scenes(B, N, seed)).cuda()})
    if len(calls) != len(LEVELS):
        raise RuntimeError(f"expected {len(LEVELS)} nearest_k calls, "
                           f"recorded {len(calls)}")
    return [(c, p, k, r) for c, p, k, r, _, _ in calls]


def sa0_grouping(nearest_k, group_points):
    """SA_0's candidates with their coordinates, as this checkout's RPN
    takes them: from the kernel, or the ids and a gather."""
    if "with_coords" in inspect.signature(nearest_k).parameters:
        return lambda c, p, k, r: nearest_k(c, p, k, max_radius=r,
                                            with_coords=True)

    def gathered(c, p, k, r):
        d2, idx = nearest_k(c, p, k, max_radius=r)
        return d2, idx, group_points(p, idx.clamp(max=p.shape[1] - 1))

    return gathered


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).parents[2]))
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.datasets import random_scenes
    from tpu3d_torch.ops import _build, group_points, nearest_k
    from tpu3d_torch.ops.fused_sa import fused_gathered_mlp_pool_backward
    from tpu3d_torch.ops.sampling import (furthest_point_sample,
                                          furthest_point_sample_with_3nn)

    _build.build_all()
    bench = load_bench()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"label": args.label, "root": args.root,
           "card": torch.cuda.get_device_name(0)}

    def record(key, fn, reps):
        ms = bench.cuda_ms(fn, reps)
        out[key] = ms
        out[f"{key} queued"] = ms.queued
        out[f"{key} call"] = ms.call
        out[f"{key} covered"] = ms.covered
        print(f"{args.label}: {key}: {ms:.4f} ms (queued {ms.queued:.4f}, "
              f"call {ms.call:.4f}"
              f"{'' if ms.covered else '; host-bound, not covered'})",
              flush=True)
        return ms

    cfg = cfg_from_file(str(Path(args.root) / "configs" / "default.yaml"),
                        fresh_cfg())
    dpts = torch.from_numpy(random_scenes(4, 32768, 0)).cuda()
    cases = {"eval": path_inputs(bench, cfg, 2, False),
             "train": path_inputs(bench, cfg, 16, True),
             "dense": bench.dense_inputs(g)}
    for path, calls in cases.items():
        total = 0.0
        for level, (c, p, k, r) in zip(LEVELS, calls):
            total += record(f"nearest_k {path} {level}",
                            lambda: nearest_k(c, p, k, max_radius=r), 10)
        out[f"nearest_k {path} sum"] = total
        print(f"{args.label}: nearest_k {path}, six launches: {total:.4f} "
              f"ms", flush=True)
    c, p, k, r = cases["eval"][0]
    sa0 = sa0_grouping(nearest_k, group_points)
    record("nearest_k eval RPN SA_0 with coordinates",
           lambda: sa0(c, p, k, r), 10)
    c = bench.fps_pyramid(dpts, (4096,))[1]
    record("nearest_k double RPN SA_0",
           lambda: nearest_k(c, dpts, 32, max_radius=0.5), 10)
    del cases, dpts
    torch.cuda.empty_cache()
    for level, (M, C3) in (("SA_0", (128, 128)), ("SA_1", (32, 256))):
        R, N, S = 1024, 512, 64

        def randn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale

        ins = (randn(R, N, 128),
               torch.randint(0, N, (R, M, S), generator=g, device="cuda",
                             dtype=torch.int32),
               randn(R, M, 128), randn(128, 128, scale=128 ** -0.5),
               randn(128, scale=0.1), randn(128, C3, scale=128 ** -0.5),
               randn(C3, scale=0.1))
        grad = randn(R, M, C3)
        spread = torch.randint(0, S, grad.shape, generator=g, device="cuda",
                               dtype=torch.int32)
        live = torch.ones_like(grad)
        sparse = torch.where(torch.rand(grad.shape, generator=g,
                                        device="cuda") < 0.02, 1.0, -1.0)
        for case, arg, ppre in (("full spread", spread, live),
                                ("sparse", spread, sparse),
                                ("one slot", torch.zeros_like(spread), live)):
            record(f"fused_sa_bwd {level} {case}",
                   lambda: fused_gathered_mlp_pool_backward(
                       *ins, grad, arg, ppre), 5)
        del ins
        torch.cuda.empty_cache()
    for B, N, npoint in ((2, 16384, 4096), (2, 4096, 1024), (16, 16384, 4096),
                         (4, 32768, 4096)):
        xyz = torch.rand(B, N, 3, generator=g, device="cuda") * 40.0
        record(f"fps3nn ({B}, {N}) -> {npoint}",
               lambda: furthest_point_sample_with_3nn(xyz, npoint), 5)
    xyz = torch.rand(16, 32768, 3, generator=g, device="cuda") * 40.0
    record("fps_long (16, 32768) -> 4096",
           lambda: furthest_point_sample(xyz, 4096), 3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
