"""Time the nearest-k search, the gather-form SA backward, FPS, the
interpolation's backward, the standalone 3-NN search and the fused SA
kernels of one checkout of the port on seeded inputs, to compare two
checkouts on the same card in turns.

    python3 tpu3d_torch/tools/compare_kernels.py [--root DIR] [--label NAME]
        [--only GROUP[,GROUP...]]

``--root`` is the checkout whose ``tpu3d_torch`` is imported (default:
this one; run the file as a script, not with ``-m``, so that no other
checkout's package is imported first). It needs only the public
signatures of ``nearest_k(centers, pts, k, max_radius)``,
``fused_gathered_mlp_pool_backward``, ``furthest_point_sample_with_3nn``,
``furthest_point_sample``, ``three_nn``, ``fused_route`` and the fused SA
ops, and the models' entry points, so an older
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
  (16, 32768) -> 4096;
- the short-row FPS (``fps.cu``) at every launch the four shipped configs
  give it: the RCNN's SA_0 and SA_1 on its pooled rows (eval: B scenes ×
  TEST post-NMS ROIs; train: B × ROI_PER_IMAGE), and the RPN levels of the
  split route that take it (quickstart's SA_3, smoke's SA_2-3), at default
  (eval B=2, train B=16), quickstart (8, 4) and smoke (2, 2), with the sums
  per forward or step; and 64 rows of 2048 points;
- the grouping gather's backward at each call of default.yaml's train
  step (B=16; the RPN's four MSG levels, each level's features and ids
  recorded from a train-mode forward of the checkout's own model):
  ``group_points_bwd`` (the fixed-order kernel, where the checkout has it)
  and ``torch.gather``'s backward (a ``scatter_add_``), with the sums;
- default.yaml's joint train step at B=16 (``train_step``: the checkout's
  own ``make_train_step`` on seeded weights and planted-cluster scenes;
  host clock around each step ending in a synchronize, median of 5 after
  one warm-up), the end-to-end figure a kernel change should move;
- ``three_interpolate_backward`` without d_weight (the train step's form)
  at default.yaml's four FP levels of the train step (B=16; the ids and
  weights of the checkout's own FPS+3NN on the training batch), with the
  sum over the four launches.

- the fused SA op's forward kernels at every RCNN level the shipped
  configs fuse (``fused_sa_fwd``: the gather form's eval and training
  forward at default.yaml's levels, eval B=2 and train B=16; the slab
  form's at quickstart's and smoke's SA_1; the BatchNorm slab eval kernel
  at default.yaml's levels with ``USE_BN``), on seeded inputs of those
  shapes;
- the slab form's backward (``fused_sa_slab_bwd``) at quickstart's and
  smoke's SA_1 of the train step, routed by the plain forward's argmax on
  seeded slabs whose groups repeat slots;
- the BatchNorm chain's training op (``fused_bn_mlp_pool`` with batch
  statistics, forward and backward under autograd: the seven training
  kernels) at default.yaml's SA_0 and SA_1 with ``USE_BN`` of the train
  step (B=16), and their sum;
- ``three_nn`` at every launch of the split route on the shipped configs
  (double.yaml's train SA_0, 16 x 32768 -> 4096; quickstart's SA_3, 64 ->
  16 at eval B=8 and train B=4; smoke's SA_2 and SA_3, 64 -> 32 and 32 ->
  16 at B=2), the queries a level's points and the known points its FPS
  picks, on planted-cluster scenes;
- the slab form's forward alone (``fused_sa_slab_fwd``: eval and
  training forward at quickstart's and smoke's SA_1, the slab rows of
  ``fused_sa_fwd``).

``--only`` takes any of ``nearest_k``, ``fused_sa_bwd``, ``fps3nn``,
``fps``, ``three_interpolate_bwd``, ``group_points_bwd``, ``train_step``, ``fused_sa_fwd``,
``fused_sa_slab_bwd``, ``fused_sa_bn_train``, ``three_nn`` and
``fused_sa_slab_fwd`` (default: all).

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


GROUPS = ("nearest_k", "fused_sa_bwd", "fps3nn", "fps",
          "three_interpolate_bwd", "group_points_bwd", "train_step", "fused_sa_fwd", "fused_sa_slab_bwd",
          "fused_sa_bn_train", "three_nn", "fused_sa_slab_fwd")


def rcnn_levels(root):
    """The RCNN SA levels the shipped configs fuse, at the shapes their
    paths give them: [(label, route, R, N, M, S, (C1, C2, C3))], route
    "gather" or "slab" (default.yaml's levels with USE_BN take the slab
    route, as "bn")."""
    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.ops import sa_route

    out = []
    for name, eval_b, train_b in (("default", 2, 16), ("quickstart", 8, 4),
                                  ("smoke", 2, 2)):
        cfg = cfg_from_file(str(Path(root) / "configs" / f"{name}.yaml"),
                            fresh_cfg())
        sa = cfg.RCNN.SA_CONFIG
        for mode, B, rois in (("eval", eval_b, cfg.TEST.RPN_POST_NMS_TOP_N),
                              ("train", train_b, cfg.RCNN.ROI_PER_IMAGE)):
            for bn in ((False, True) if name == "default" else (False,)):
                n, R = cfg.RCNN.NUM_POINTS, B * rois
                for k in range(2):
                    M, S, mlp = sa.NPOINTS[k], sa.NSAMPLE[k], sa.MLPS[k]
                    route = sa_route((R, M, S, mlp[0]), mlp, n, bn)
                    if route != "plain":
                        out.append((f"{name}{' USE_BN' if bn else ''} "
                                    f"{mode} B={B} RCNN SA_{k}",
                                    "bn" if bn else route, mode, R, n, M, S,
                                    tuple(mlp)))
                    n = M
    return out


def fps_row_launches(root):
    """Every launch the shipped configs give the short-row FPS, by path:
    {path: [(label, rows, N, npoint)]}, the RCNN's pooled rows and the RPN
    levels of the split route of up to 2048 points."""
    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.ops.sampling import fused_route

    out = {}
    for name, eval_b, train_b in (("default", 2, 16), ("quickstart", 8, 4),
                                  ("smoke", 2, 2)):
        cfg = cfg_from_file(str(Path(root) / "configs" / f"{name}.yaml"),
                            fresh_cfg())
        for mode, B, rois in (("eval", eval_b, cfg.TEST.RPN_POST_NMS_TOP_N),
                              ("train", train_b, cfg.RCNN.ROI_PER_IMAGE)):
            calls, n = [], cfg.RPN.NUM_POINTS
            for k, npoint in enumerate(cfg.RPN.SA_CONFIG.NPOINTS):
                if not fused_route(B, n, npoint) and n <= 2048:
                    calls.append((f"RPN SA_{k}", B, n, npoint))
                n = npoint
            n = cfg.RCNN.NUM_POINTS
            for k, npoint in enumerate(cfg.RCNN.SA_CONFIG.NPOINTS):
                if npoint is None or npoint < 0:
                    break
                calls.append((f"RCNN SA_{k}", B * rois, n, npoint))
                n = npoint
            out[f"{name} {mode} B={B}"] = calls
    return out


def split_three_nn_inputs(bench, root, seed=0):
    """three_nn's launches on the shipped configs' split route: [(label,
    queries, known)], each level's points and its FPS picks (the FPS
    pyramid of the checkout), at double.yaml's train batch and
    quickstart's and smoke's eval and train batches."""
    import torch

    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.datasets import random_scenes, train_batch
    from tpu3d_torch.ops import fused_route

    out = []
    for name, batches in (("double", (("train", 16),)),
                          ("quickstart", (("eval", 8), ("train", 4))),
                          ("smoke", (("eval", 2), ("train", 2)))):
        cfg = cfg_from_file(str(Path(root) / "configs" / f"{name}.yaml"),
                            fresh_cfg())
        n, npoints = cfg.RPN.NUM_POINTS, cfg.RPN.SA_CONFIG.NPOINTS
        for mode, B in batches:
            pts = (train_batch(B, n, seed)["pts_input"] if mode == "train"
                   else random_scenes(B, n, seed))
            levels = bench.fps_pyramid(torch.from_numpy(pts).cuda(),
                                       npoints)
            for k, npoint in enumerate(npoints):
                x = levels[k]
                if not fused_route(B, x.shape[1], npoint):
                    out.append((f"{name} {mode} B={B} RPN SA_{k} "
                                f"{x.shape[1]} -> {npoint}", x,
                                levels[k + 1]))
    return out


def interp_bwd_inputs(cfg, g):
    """The four FP levels of default.yaml's train step (B=16): [(level,
    (features, idx, weight, grad))], the ids and weights from the
    checkout's FPS+3NN on the training batch, features and gradients
    seeded."""
    import torch

    from tpu3d_torch.datasets import train_batch
    from tpu3d_torch.ops import interpolation_weights
    from tpu3d_torch.ops.sampling import (furthest_point_sample_with_3nn,
                                          gather_points)

    sa = cfg.RPN.SA_CONFIG
    pts = torch.from_numpy(
        train_batch(16, cfg.RPN.NUM_POINTS, 0)["pts_input"][..., :3]
    ).contiguous().cuda()
    levels, caches = [pts], []
    for npoint in sa.NPOINTS:
        idx, d2, nn_idx = furthest_point_sample_with_3nn(levels[-1], npoint)
        caches.append((d2, nn_idx))
        levels.append(gather_points(levels[-1], idx))
    n_fp = len(cfg.RPN.FP_MLPS)
    out = []
    for i in range(n_fp - 1, -1, -1):
        ch = (cfg.RPN.FP_MLPS[i + 1][-1] if i + 1 < n_fp
              else sum(m[-1] for m in sa.MLPS[i]))
        d2, nn_idx = caches[i]
        n, m = levels[i + 1].shape[1], levels[i].shape[1]
        w = interpolation_weights(torch.sqrt(d2.clamp(min=0.0)))
        feats = torch.randn(16, n, ch, generator=g, device="cuda")
        grad = torch.randn(16, m, ch, generator=g, device="cuda")
        out.append((f"FP_{i} N={n} M={m} C={ch}", (feats, nn_idx, w, grad)))
    return out


def group_points_calls(cfg, B=16, seed=0):
    """The grouping gather's calls of one default.yaml train-mode forward
    at B scenes: [(features (B, N, C), idx (B, M, S))]."""
    import torch

    from tpu3d_torch.datasets import train_batch
    from tpu3d_torch.models import PointRCNN, pointnet2
    from tpu3d_torch.weights import seeded_state_dict

    model = PointRCNN(cfg, mode="TRAIN", device="cuda")
    model.load_state_dict(seeded_state_dict(model, seed))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in train_batch(B, cfg.RPN.NUM_POINTS, seed).items()}
    calls, group_points = [], pointnet2.group_points

    def recorded(features, idx):
        calls.append((features.detach().clone(), idx.clone()))
        return group_points(features, idx)

    pointnet2.group_points = recorded
    try:
        with torch.no_grad():
            gen = torch.Generator(device="cuda").manual_seed(seed)
            model(batch, train=True, bn_momentum=0.9, generator=gen)
    finally:
        pointnet2.group_points = group_points
    return calls


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).parents[2]))
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--only", default=",".join(GROUPS),
                        help="comma-separated groups of " + ", ".join(GROUPS))
    args = parser.parse_args()
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        parser.error(f"--only takes groups of {GROUPS}")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.datasets import random_scenes
    from tpu3d_torch.ops import _build, group_points, nearest_k
    from tpu3d_torch.ops.fused_sa import fused_gathered_mlp_pool_backward
    from tpu3d_torch.ops.interpolate import three_interpolate_backward
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
    if "nearest_k" in only:
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
            print(f"{args.label}: nearest_k {path}, six launches: "
                  f"{total:.4f} ms", flush=True)
        c, p, k, r = cases["eval"][0]
        sa0 = sa0_grouping(nearest_k, group_points)
        record("nearest_k eval RPN SA_0 with coordinates",
               lambda: sa0(c, p, k, r), 10)
        c = bench.fps_pyramid(dpts, (4096,))[1]
        record("nearest_k double RPN SA_0",
               lambda: nearest_k(c, dpts, 32, max_radius=0.5), 10)
        del cases, dpts
        torch.cuda.empty_cache()
    for level, (M, C3) in ((("SA_0", (128, 128)), ("SA_1", (32, 256)))
                           if "fused_sa_bwd" in only else ()):
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
    if "fps3nn" in only:
        for B, N, npoint in ((2, 16384, 4096), (2, 4096, 1024),
                             (16, 16384, 4096), (4, 32768, 4096)):
            xyz = torch.rand(B, N, 3, generator=g, device="cuda") * 40.0
            record(f"fps3nn ({B}, {N}) -> {npoint}",
                   lambda: furthest_point_sample_with_3nn(xyz, npoint), 5)
        xyz = torch.rand(16, 32768, 3, generator=g, device="cuda") * 40.0
        record("fps_long (16, 32768) -> 4096",
               lambda: furthest_point_sample(xyz, 4096), 3)
    if "fps" in only:
        calls = fps_row_launches(args.root)
        calls["2048 points"] = [("rows", 64, 2048, 512)]
        for path, launches in calls.items():
            total = 0.0
            for label, R, N, npoint in launches:
                xyz = (torch.rand(R, N, 3, generator=g, device="cuda")
                       - 0.5) * 5.0
                total += record(f"fps {path} {label} ({R}, {N}) -> {npoint}",
                                lambda: furthest_point_sample(xyz, npoint),
                                10)
            out[f"fps {path} sum"] = total
            print(f"{args.label}: fps {path}, {len(launches)} launches: "
                  f"{total:.4f} ms", flush=True)
    if "three_interpolate_bwd" in only:
        total = 0.0
        for level, ins in interp_bwd_inputs(cfg, g):
            total += record(f"three_interpolate_bwd {level}",
                            lambda: three_interpolate_backward(*ins, False),
                            20)
        out["three_interpolate_bwd train sum"] = total
        print(f"{args.label}: three_interpolate_bwd, four launches: "
              f"{total:.4f} ms", flush=True)
    if "group_points_bwd" in only:
        from tpu3d_torch.ops import grouping

        fixed = getattr(grouping, "group_points_backward", None)
        totals = {"group_points_bwd": 0.0, "scatter_add": 0.0}
        for i, (feats, idx) in enumerate(group_points_calls(cfg)):
            B, N, C = feats.shape
            grad = torch.randn(*idx.shape, C, generator=g, device="cuda")
            flat = idx.reshape(B, -1).long()[..., None].expand(-1, -1, C)
            rows = grad.reshape(B, -1, C)
            shape = f"({B}, {N}, {C}) by {tuple(idx.shape)}"
            totals["scatter_add"] += record(
                f"torch.gather backward {i} {shape}",
                lambda: torch.zeros(B, N, C, device="cuda").scatter_add_(
                    1, flat, rows), 10)
            if fixed is not None:
                totals["group_points_bwd"] += record(
                    f"group_points_bwd {i} {shape}",
                    lambda: fixed(grad, idx, N), 10)
            del grad, flat, rows
        for k, v in totals.items():
            out[f"{k} train sum"] = v
        print(f"{args.label}: the grouping gather's backward per train step: "
              f"{totals}", flush=True)
        torch.cuda.empty_cache()
    if "train_step" in only:
        import statistics
        import time

        from tpu3d_torch.datasets import train_batch
        from tpu3d_torch.models import PointRCNN
        from tpu3d_torch.parallel import create_train_state, make_train_step
        from tpu3d_torch.weights import seeded_state_dict

        model = PointRCNN(cfg, mode="TRAIN", device="cuda")
        model.load_state_dict(seeded_state_dict(model, 0))
        state = create_train_state(cfg, model, steps_per_epoch=100,
                                   total_epochs=10)
        step = make_train_step(cfg, model)
        batch = {k: torch.from_numpy(v).cuda() for k, v in train_batch(
            16, cfg.RPN.NUM_POINTS, 0).items()}
        gen = torch.Generator(device="cuda").manual_seed(1)
        times = []
        for i in range(6):
            t0 = time.perf_counter()
            step(state, batch, gen, 0.9)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["train_step default B=16 ms"] = statistics.median(times[1:])
        out["train_step default B=16 step_ms"] = times[1:]
        print(f"{args.label}: default.yaml joint train step B=16: "
              f"{statistics.median(times[1:]):.1f} ms (host clock, median "
              f"of 5 after a warm-up: {[round(t, 1) for t in times[1:]]})",
              flush=True)
        del model, state, step, batch
        torch.cuda.empty_cache()
    if "three_nn" in only:
        from tpu3d_torch.ops import three_nn

        for label, x, known in split_three_nn_inputs(bench, args.root):
            record(f"three_nn {label}", lambda: three_nn(x, known), 10)
        torch.cuda.empty_cache()
    fused = [g for g in ("fused_sa_fwd", "fused_sa_slab_bwd",
                         "fused_sa_bn_train", "fused_sa_slab_fwd")
             if g in only]
    if fused:
        from tpu3d_torch.ops import (fused_bn_mlp_pool,
                                     fused_gathered_mlp_pool, fused_mlp_pool)
        from tpu3d_torch.ops import fused_sa as fs

        bn_total = 0.0
        for label, route, mode, R, N, M, S, (c1, c2, c3) in rcnn_levels(
                args.root):
            fg = torch.Generator(device="cuda").manual_seed(R + M + S + c3)

            def randn(*shape, scale=1.0):
                return torch.randn(*shape, generator=fg,
                                   device="cuda") * scale

            w1, w2 = randn(c1, c2, scale=c1 ** -0.5), randn(
                c2, c3, scale=c2 ** -0.5)
            b1, b2 = randn(c2, scale=0.1), randn(c3, scale=0.1)
            if route == "gather":
                if "fused_sa_fwd" not in only:
                    continue
                ins = (randn(R, N, c1),
                       torch.randint(0, N, (R, M, S), generator=fg,
                                     device="cuda", dtype=torch.int32),
                       randn(R, M, c1), w1, b1, w2, b2)
                with torch.no_grad():
                    name = ("fused_sa" if mode == "eval"
                            else "fused_sa_train")
                    fn = (fused_gathered_mlp_pool if mode == "eval"
                          else fs.fused_gathered_mlp_pool_train)
                    record(f"{name} {label}", lambda: fn(*ins), 10)
                del ins
                continue
            x0 = randn(R, M, S, c1)
            h = torch.randint(1, S + 1, (R, M, 1), generator=fg,
                              device="cuda")
            x0 = torch.gather(x0, 2, (torch.arange(S, device="cuda") % h)[
                ..., None].expand(-1, -1, -1, c1)).contiguous()
            if route == "bn":
                gammas = [1 + randn(c, scale=0.2) for c in (c1, c2, c3)]
                betas = [randn(c, scale=0.2) for c in (c1, c2, c3)]
                if mode == "eval" and "fused_sa_fwd" in only:
                    stats = [(randn(c, scale=0.3), 0.5 + torch.rand(
                        c, generator=fg, device="cuda")) for c in (c1, c2, c3)]
                    with torch.no_grad():
                        record(f"fused_sa_slab_bn {label}",
                               lambda: fused_bn_mlp_pool(x0, w1, w2, gammas,
                                                         betas, stats), 10)
                if mode == "train" and "fused_sa_bn_train" in only:
                    grad = randn(R, M, c3)
                    leaves = [t.requires_grad_() for t in
                              (x0, w1, w2, *gammas, *betas)]

                    def step():
                        o, _ = fused_bn_mlp_pool(
                            leaves[0], leaves[1], leaves[2], leaves[3:6],
                            leaves[6:9])
                        torch.autograd.grad(o, leaves, grad)

                    bn_total += record(f"fused_sa_bn_train {label} forward "
                                       f"and backward", step, 3)
                    del leaves, grad
                del x0
                torch.cuda.empty_cache()
                continue
            args_ = (x0, w1, b1, w2, b2)
            if only & {"fused_sa_fwd", "fused_sa_slab_fwd"}:
                with torch.no_grad():
                    if mode == "eval":
                        record(f"fused_sa_slab {label}",
                               lambda: fused_mlp_pool(*args_), 10)
                    else:
                        record(f"fused_sa_slab_train {label}",
                               lambda: fs.fused_mlp_pool_train(*args_), 10)
            if mode == "train" and "fused_sa_slab_bwd" in only:
                with torch.no_grad():
                    _, arg, ppre = fs.fused_mlp_pool_train_plain(*args_)
                grad = randn(R, M, c3)
                record(f"fused_sa_slab_bwd {label}",
                       lambda: fs.fused_mlp_pool_backward(*args_, grad, arg,
                                                          ppre), 10)
            del x0, args_
            torch.cuda.empty_cache()
        if "fused_sa_bn_train" in only:
            out["fused_sa_bn_train sum"] = bn_total
            print(f"{args.label}: fused_sa_bn_train, SA_0 + SA_1 forward "
                  f"and backward: {bn_total:.3f} ms", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
