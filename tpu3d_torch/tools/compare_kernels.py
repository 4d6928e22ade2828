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
  step (B=16), and their sum, the f32 form's stats0 alone beside it; then
  kernel 9's seven bf16 entries there,
  each on its own (``bn_bf16_calls``: the slab in bf16, driven as the
  training op drives it, on the plain pieces' statistics, x1, x2, argmax
  and d_y1), each call also split by launch (``kernel_bench.split_ms``),
  with each entry's sum over the two levels (its time a step);
- ``three_nn`` at every launch of the split route on the shipped configs
  (double.yaml's train SA_0, 16 x 32768 -> 4096; quickstart's SA_3, 64 ->
  16 at eval B=8 and train B=4; smoke's SA_2 and SA_3, 64 -> 32 and 32 ->
  16 at B=2), the queries a level's points and the known points its FPS
  picks, on planted-cluster scenes;
- the slab form's forward alone (``fused_sa_slab_fwd``: eval and
  training forward at quickstart's and smoke's SA_1, the slab rows of
  ``fused_sa_fwd``);
- kernel 6's bf16 training forward (``fused_sa_fwd_bf16``:
  ``fused_gathered_mlp_pool_bf16_train`` on bf16 pre-activations and
  centers) at default.yaml's RCNN SA_0 and SA_1 of the train step (B=16),
  with their sum per step;
- the grouping gather's bf16 backward (``group_points_bwd_bf16``) at the
  calls of default.yaml's train step that take it under the card's
  default training contract (``gp_route`` "gather_mxu_bwd": RPN SA_1's two
  gathers), on an f32 gradient laid out as the step hands it (the
  backward of the level's bf16 cast: contiguous f32), beside
  ``torch.gather``'s backward, with the sums.

- the bf16 backwards of kernels 6 (``fused_sa_bwd_bf16``:
  ``fused_gathered_mlp_pool_bf16_backward`` at default.yaml's RCNN SA_0
  and SA_1 of the train step, B=16) and 8 (``fused_sa_slab_bwd_bf16``:
  ``fused_mlp_pool_bf16_backward`` at quickstart's and smoke's SA_1 of
  the train step), on a bf16 gradient routed two ways (``BWD_ROUTINGS``:
  near the seeded step's reach, and full spread), each call also split by
  launch (``kernel_bench.split_ms``: device ms of each kernel and copy,
  and the host's read of the reached-row count);
- the bf16 eval forms of kernels 5, 8 and 9 (``fused_sa_eval_bf16``:
  ``fused_gathered_mlp_pool_bf16``, ``fused_mlp_pool_bf16`` and
  ``fused_bn_mlp_pool_bf16``, counted as ``fused_sa_bf16``,
  ``fused_sa_slab_bf16`` and ``fused_sa_slab_bn_bf16``) at every RCNN
  level of the eval paths of default.yaml (B=2; also with ``USE_BN``, on
  seeded running statistics with a quarter of the gammas negative),
  double.yaml (B=4), quickstart.yaml (B=8) and smoke.yaml (B=2), on seeded
  bf16 inputs of those shapes, each call also split by launch
  (``kernel_bench.split_ms``), with the sums per forward.

``--only`` takes any of ``nearest_k``, ``fused_sa_bwd``, ``fps3nn``,
``fps``, ``three_interpolate_bwd``, ``group_points_bwd``, ``train_step``, ``fused_sa_fwd``,
``fused_sa_slab_bwd``, ``fused_sa_bn_train``, ``three_nn``,
``fused_sa_slab_fwd``, ``fused_sa_fwd_bf16``, ``group_points_bwd_bf16``,
``fused_sa_bwd_bf16``, ``fused_sa_slab_bwd_bf16`` and
``fused_sa_eval_bf16`` (default: all).

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
          "fused_sa_bn_train", "three_nn", "fused_sa_slab_fwd",
          "fused_sa_fwd_bf16", "group_points_bwd_bf16", "fused_sa_bwd_bf16",
          "fused_sa_slab_bwd_bf16", "fused_sa_eval_bf16")
# (config, eval B, train B) of the paths rcnn_levels reads; the eval forms'
# group also reads double.yaml's
PATHS = (("default", 2, 16), ("quickstart", 8, 4), ("smoke", 2, 2))
EVAL_PATHS = (("default", 2, 16), ("double", 4, 16), ("quickstart", 8, 4),
              ("smoke", 2, 2))
# the routings of the bf16 backwards' inputs: "seeded", each group's live
# channels (3 in 4) on one of two slots drawn for the group, near the
# 1.7-2.0% of the slots that the seeded train step reaches; "full spread",
# every channel live at a slot drawn uniformly over S
BWD_ROUTINGS = ("seeded", "full spread")


def bn_bf16_calls(fs, x0, w1, w2, gammas, betas, gen, eps=1e-5):
    """Kernel 9's seven bf16 training entries on the bf16 slab x0, each
    driven as the training op drives it, on the plain pieces' statistics,
    x1, x2, argmax, d_y1 and d_y0 and the packs of their reductions (the
    same inputs in either checkout) -> [(entry, call)], in the step's
    order."""
    import torch

    n = x0.shape[0] * x0.shape[1] * x0.shape[2]
    layers, stats, slabs, calls = [], [], [x0], []
    for depth in range(3):
        args = ((x0,) if depth == 0 else
                (slabs[-1], layers[-1][0].contiguous(),
                 layers[-1][1].contiguous(), (w1, w2)[depth - 1]))
        calls.append((f"fused_sa_bn_stats{depth}_bf16",
                      lambda d=depth, a=args: fs.fused_sa_bn_stats(d, *a)))
        sums = fs.fused_sa_bn_stats_plain(depth, *args)
        if depth:
            sums, y = sums
            slabs.append(y)
        stats.append(fs._mean_var(sums, n, torch.float32))
        layers.append(fs._layer_pack(*stats[-1], gammas[depth], betas[depth],
                                     eps, n))
    x1, x2 = slabs[1:]
    m2, a2 = layers[2][0].contiguous(), layers[2][1].contiguous()
    calls.append(("fused_sa_bn_final_bf16",
                  lambda: fs.fused_sa_bn_final(x2, m2, a2)))
    out, arg, at = fs.fused_sa_bn_final_plain(x2, m2, a2)
    grad = torch.randn(out.shape, generator=gen, device=out.device)
    d_y2 = torch.where(out > 0, grad.to(torch.bfloat16).float(), 0.0)
    (mean2, var2), r2 = stats[2], layers[2][2]
    layers[2] = fs._layer_pack(
        mean2, var2, gammas[2], betas[2], eps, n, d_y2.sum(dim=(0, 1)),
        (d_y2 * (at * r2 - mean2 * r2)).sum(dim=(0, 1)))
    dval = (d_y2 * layers[2][0]).contiguous()
    pk2 = fs._pack(layers)
    calls.append(("fused_sa_bn_wave1_bf16",
                  lambda: fs.fused_sa_bn_wave1(x2, x1, pk2, w2, dval, arg)))
    sums, _, d_y1 = fs.fused_sa_bn_wave1_plain(x2, x1, pk2, w2, dval, arg)
    layers[1] = fs._layer_pack(*stats[1], gammas[1], betas[1], eps, n,
                               *sums.float())
    pk1 = fs._pack(layers)
    calls.append(("fused_sa_bn_wave2_bf16",
                  lambda: fs.fused_sa_bn_wave2(d_y1, x1, x0, pk1, w1)))
    sums, _, d_y0 = fs.fused_sa_bn_wave2_plain(d_y1, x1, x0, pk1, w1)
    layers[0] = fs._layer_pack(*stats[0], gammas[0], betas[0], eps, n,
                               *sums.float())
    pk0 = fs._pack(layers)
    calls.append(("fused_sa_bn_apply_bf16",
                  lambda: fs.fused_sa_bn_apply(d_y0, x0, pk0)))
    return calls


def bwd_bf16_inputs(route, R, N, M, S, widths, routing, seed):
    """Seeded inputs of a bf16 backward of kernel 6 (``route`` "gather":
    pre, idx, center) or 8 ("slab": x0), the weights, and a bf16 gradient
    with its argmax and ppre under ``routing`` -> (inputs, grad, argmax,
    ppre)."""
    import torch

    c1, c2, c3 = widths
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    lead = ((randn(R, N, c1).to(torch.bfloat16),
             torch.randint(0, N, (R, M, S), generator=g, device="cuda",
                           dtype=torch.int32),
             randn(R, M, c1, scale=0.5).to(torch.bfloat16))
            if route == "gather" else (randn(R, M, S, c1).to(torch.bfloat16),))
    ins = (*lead, randn(c1, c2, scale=c1 ** -0.5), randn(c2, scale=0.1),
           randn(c2, c3, scale=c2 ** -0.5), randn(c3, scale=0.1))
    grad = randn(R, M, c3).to(torch.bfloat16)
    if routing == "full spread":
        arg = torch.randint(0, S, grad.shape, generator=g, device="cuda",
                            dtype=torch.int32)
        ppre = torch.ones(grad.shape, device="cuda")
    else:
        two = torch.randint(0, S, (R, M, 2), generator=g, device="cuda",
                            dtype=torch.int32)
        pick = torch.randint(0, 2, grad.shape, generator=g, device="cuda")
        arg = torch.gather(two, 2, pick).contiguous()
        ppre = torch.where(torch.rand(grad.shape, generator=g, device="cuda")
                           < 0.75, 1.0, -1.0)
    return ins, grad, arg, ppre


def rcnn_levels(root, paths=PATHS):
    """The RCNN SA levels the shipped configs of ``paths`` fuse, at the
    shapes their paths give them: [(label, route, mode, R, N, M, S, (C1, C2,
    C3))], route "gather" or "slab" (default.yaml's levels with USE_BN take
    the slab route, as "bn")."""
    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.ops import sa_route

    out = []
    for name, eval_b, train_b in paths:
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
    if "group_points_bwd_bf16" in only:
        from tpu3d_torch.ops import grouping

        totals = {"group_points_bwd_bf16": 0.0, "scatter_add": 0.0}
        for i, (feats, idx) in enumerate(group_points_calls(cfg)):
            B, N, C = feats.shape
            _, M, S = idx.shape
            if grouping.gp_route(N, C, M * S, True, False,
                                 True) != "gather_mxu_bwd":
                continue
            grad = torch.randn(B, M, S, C, generator=g, device="cuda")
            flat = idx.reshape(B, -1).long()[..., None].expand(-1, -1, C)
            rows = grad.reshape(B, -1, C)
            shape = f"({B}, {N}, {C}) by {tuple(idx.shape)}"
            totals["scatter_add"] += record(
                f"torch.gather backward {i} {shape}",
                lambda: torch.zeros(B, N, C, device="cuda").scatter_add_(
                    1, flat, rows), 10)
            totals["group_points_bwd_bf16"] += record(
                f"group_points_bwd_bf16 {i} {shape}",
                lambda: grouping.group_points_backward_bf16(
                    grad, idx, N, torch.float32), 10)
            del grad, flat, rows
        for k, v in totals.items():
            out[f"{k} bf16 gathers sum"] = v
        print(f"{args.label}: the bf16 gathers' backward per train step: "
              f"{totals}", flush=True)
        torch.cuda.empty_cache()
    if "fused_sa_fwd_bf16" in only:
        from tpu3d_torch.ops import fused_sa as fs

        total = 0.0
        for label, route, mode, R, N, M, S, (c1, c2, c3) in rcnn_levels(
                args.root):
            if (route != "gather" or mode != "train"
                    or not label.startswith("default")):
                continue
            fg = torch.Generator(device="cuda").manual_seed(R + M + S + c3)

            def randn(*shape, scale=1.0):
                return torch.randn(*shape, generator=fg,
                                   device="cuda") * scale

            ins = (randn(R, N, c1).to(torch.bfloat16),
                   torch.randint(0, N, (R, M, S), generator=fg,
                                 device="cuda", dtype=torch.int32),
                   randn(R, M, c1, scale=0.5).to(torch.bfloat16),
                   randn(c1, c2, scale=c1 ** -0.5), randn(c2, scale=0.1),
                   randn(c2, c3, scale=c2 ** -0.5), randn(c3, scale=0.1))
            with torch.no_grad():
                total += record(
                    f"fused_sa_train_bf16 {label}",
                    lambda: fs.fused_gathered_mlp_pool_bf16_train(*ins), 10)
            del ins
            torch.cuda.empty_cache()
        out["fused_sa_train_bf16 train sum"] = total
        print(f"{args.label}: fused_sa_train_bf16, default train step's two "
              f"launches: {total:.3f} ms", flush=True)
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

        bn_total, bn_bf16, bn_f32_stats0 = 0.0, {}, 0.0
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
                    with torch.no_grad():  # the f32 form's stats0 alone
                        bn_f32_stats0 += record(
                            f"fused_sa_bn_stats0 {label}",
                            lambda: fs.fused_sa_bn_stats(0, x0), 5)
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
                    torch.cuda.empty_cache()
                    with torch.no_grad():
                        calls = bn_bf16_calls(
                            fs, x0.detach().to(torch.bfloat16), w1.detach(),
                            w2.detach(), [t.detach() for t in gammas],
                            [t.detach() for t in betas], fg)
                        for name, fn in calls:
                            key = f"{name} {label}"
                            ms = record(key, fn, 3)
                            split = bench.split_ms(fn)
                            out[f"{key} split"] = split
                            print(f"{args.label}: {key} split (ms, launches "
                                  f"per call): " + ", ".join(
                                      f"{k} {v[0]:.4f} x{v[1]:g}" for k, v in
                                      sorted(split.items(),
                                             key=lambda kv: -kv[1][0])),
                                  flush=True)
                            bn_bf16[name] = bn_bf16.get(name, 0.0) + ms
                    del calls
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
            out["fused_sa_bn_stats0 step sum"] = bn_f32_stats0
            print(f"{args.label}: fused_sa_bn_stats0 (f32), SA_0 + SA_1: "
                  f"{bn_f32_stats0:.4f} ms", flush=True)
            for name, ms in bn_bf16.items():
                out[f"{name} step sum"] = ms
            out["fused_sa_bn_train_bf16 step sum"] = sum(bn_bf16.values())
            print(f"{args.label}: kernel 9's bf16 entries, SA_0 + SA_1 (a "
                  f"step): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                         bn_bf16.items())
                  + f"; in all {sum(bn_bf16.values()):.3f} ms", flush=True)
    for group, form in (("fused_sa_bwd_bf16", "gather"),
                        ("fused_sa_slab_bwd_bf16", "slab")):
        if group not in only:
            continue
        from tpu3d_torch.ops import fused_sa as fs

        bwd = (fs.fused_gathered_mlp_pool_bf16_backward if form == "gather"
               else fs.fused_mlp_pool_bf16_backward)
        for label, route, mode, R, N, M, S, widths in rcnn_levels(args.root):
            if route != form or mode != "train" or (
                    form == "gather" and not label.startswith("default")):
                continue
            for routing in BWD_ROUTINGS:
                ins, grad, arg, ppre = bwd_bf16_inputs(
                    route, R, N, M, S, widths, routing, R + M + S)
                key = f"{group} {label} {routing}"
                record(key, lambda: bwd(*ins, grad, arg, ppre), 5)
                split = bench.split_ms(lambda: bwd(*ins, grad, arg, ppre))
                out[f"{key} split"] = split
                print(f"{args.label}: {key} split (ms, launches per call): "
                      + ", ".join(f"{k} {v[0]:.4f} x{v[1]:g}" for k, v in
                                  sorted(split.items(),
                                         key=lambda kv: -kv[1][0])),
                      flush=True)
                del ins, grad, arg, ppre
                torch.cuda.empty_cache()
    if "fused_sa_eval_bf16" in only:
        from tpu3d_torch.ops import fused_sa as fs

        sums = {}
        for label, route, mode, R, N, M, S, (c1, c2, c3) in rcnn_levels(
                args.root, EVAL_PATHS):
            if mode != "eval":
                continue
            fg = torch.Generator(device="cuda").manual_seed(R + M + S + c3)

            def randn(*shape, scale=1.0):
                return torch.randn(*shape, generator=fg,
                                   device="cuda") * scale

            weights = (randn(c1, c2, scale=c1 ** -0.5), randn(c2, scale=0.1),
                       randn(c2, c3, scale=c2 ** -0.5), randn(c3, scale=0.1))
            if route == "gather":
                name, fn = "fused_sa_bf16", fs.fused_gathered_mlp_pool_bf16
                ins = (randn(R, N, c1).to(torch.bfloat16),
                       torch.randint(0, N, (R, M, S), generator=fg,
                                     device="cuda", dtype=torch.int32),
                       randn(R, M, c1, scale=0.5).to(torch.bfloat16),
                       *weights)
            elif route == "slab":
                name, fn = "fused_sa_slab_bf16", fs.fused_mlp_pool_bf16
                ins = (randn(R, M, S, c1).to(torch.bfloat16), *weights)
            else:
                # kernel 9's form on running statistics, a quarter of each
                # layer's gammas negative (mul < 0: the pool takes the min)
                def bn_layer(c):
                    sign = torch.where(torch.rand(c, generator=fg,
                                                  device="cuda") < 0.25,
                                       -1.0, 1.0)
                    return ((0.5 + torch.rand(c, generator=fg,
                                              device="cuda")) * sign,
                            randn(c, scale=0.2),
                            (randn(c, scale=0.3), 0.5 + torch.rand(
                                c, generator=fg, device="cuda")))

                layers = [bn_layer(c) for c in (c1, c2, c3)]
                name, fn = "fused_sa_slab_bn_bf16", fs.fused_bn_mlp_pool_bf16
                ins = (randn(R, M, S, c1).to(torch.bfloat16), weights[0],
                       weights[2], [la[0] for la in layers],
                       [la[1] for la in layers], [la[2] for la in layers])
            key = f"{name} {label}"
            with torch.no_grad():
                ms = record(key, lambda: fn(*ins), 10)
                split = bench.split_ms(lambda: fn(*ins))
            out[f"{key} split"] = split
            print(f"{args.label}: {key} split (ms, launches per call): "
                  + ", ".join(f"{k} {v[0]:.4f} x{v[1]:g}" for k, v in
                              sorted(split.items(), key=lambda kv: -kv[1][0])),
                  flush=True)
            path = f"{name} {label.split(' RCNN')[0]}"
            sums[path] = sums.get(path, 0.0) + ms
            del ins
            torch.cuda.empty_cache()
        for path, ms in sums.items():
            out[f"{path} sum"] = ms
            print(f"{args.label}: {path}, per forward: {ms:.4f} ms",
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
