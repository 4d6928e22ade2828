"""Print the port's largest differences from tpu3d, per module, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

The same inputs as the parity tests (tests/test_torch_*.py), which assert
the bounds; this script reports the measured maxima, for PERF.md.
"""

import os
import sys

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from test_torch_rcnn import run_joint  # noqa: E402
from test_torch_rcnn_ops import (_boxes5, _pooled_rows,  # noqa: E402
                                 _scene_and_rois)
from test_torch_rpn import run_pair  # noqa: E402
import test_torch_double as td  # noqa: E402
import test_torch_bn_train as tb  # noqa: E402
import test_torch_slab as ts  # noqa: E402
import test_torch_train as tt  # noqa: E402
import test_torch_train_ops as to  # noqa: E402
from tpu3d.ops import furthest_point_sample_with_3nn as jax_fps3nn  # noqa
from tpu3d.ops import three_interpolate as jax_three_interpolate  # noqa
from tpu3d.ops.interpolate import three_nn as jax_three_nn  # noqa: E402
from tpu3d.ops.fused_sa import fused_gathered_mlp_pool as jax_fused  # noqa
from tpu3d.ops.fused_sa import fused_mlp_pool_reference  # noqa: E402
from tpu3d.ops import fused_sa as jax_fused_sa  # noqa: E402
from tpu3d.ops.grouping import nearest_k as jax_nearest_k  # noqa: E402
from tpu3d.ops.roipool import roipool3d as jax_roipool3d  # noqa: E402
from tpu3d.ops.rotated_iou import rotated_overlap_bev as jax_overlap  # noqa
from tpu3d.ops.sampling import _fps_pallas, _fps_xla  # noqa: E402
from tpu3d_torch.models.proposal import proposal_layer  # noqa: E402
from tpu3d_torch.ops import (furthest_point_sample_with_3nn,  # noqa: E402
                             nearest_k, roipool3d, rotated_overlap_bev,
                             three_interpolate, three_nn)
from tpu3d_torch.ops.fused_sa import fused_gathered_mlp_pool_plain  # noqa
from tpu3d_torch.ops.sampling import (  # noqa: E402
    fps_then_three_nn, furthest_point_sample_plain)
from tpu3d_torch.tools.eval_rcnn import rcnn_decode_and_nms  # noqa: E402


def rcnn_report():
    """The RCNN stage's modules and the joint path, on the inputs of
    tests/test_torch_rcnn_ops.py and tests/test_torch_rcnn.py."""
    for n, npoint in ((512, 128), (128, 32)):
        xyz = _pooled_rows(np.random.default_rng(n), n)
        got = furthest_point_sample_plain(torch.from_numpy(xyz), npoint)
        pal = np.asarray(_fps_pallas(jnp.asarray(xyz), npoint,
                                     interpret=True))
        xla = np.asarray(_fps_xla(jnp.asarray(xyz), npoint))
        print(f"fps ({n} pooled points) -> {npoint}: mismatches against "
              f"_fps_pallas {(got.numpy() != pal).sum()}, against _fps_xla "
              f"{(got.numpy() != xla).sum()}")

    rng = np.random.default_rng(9)
    B, M, S, N, C1, C2, C3 = 2, 4, 16, 128, 128, 128, 256
    bf16 = lambda a: np.array(jnp.asarray(a, jnp.float32).astype(
        jnp.bfloat16).astype(jnp.float32))
    pre = bf16(rng.normal(size=(B, N, C1)))
    idx = rng.integers(0, N, size=(B, M, S)).astype(np.int32)
    center = bf16(0.5 * rng.normal(size=(B, M, C1)))
    w1 = (rng.normal(size=(C1, C2)) / np.sqrt(C1)).astype(np.float32)
    w2 = (rng.normal(size=(C2, C3)) / np.sqrt(C2)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=C2)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=C3)).astype(np.float32)
    got = fused_gathered_mlp_pool_plain(*(torch.from_numpy(a) for a in (
        pre, idx, center, w1, b1, w2, b2))).numpy()
    x0 = np.take_along_axis(pre, idx.reshape(B, M * S)[..., None], axis=1
                            ).reshape(B, M, S, C1) - center[:, :, None, :]
    ref = np.asarray(fused_mlp_pool_reference(*(jnp.asarray(a) for a in (
        x0, w1, b1, w2, b2))))
    pal = np.asarray(jax_fused(
        jnp.asarray(pre, jnp.bfloat16), jnp.asarray(idx),
        jnp.asarray(center, jnp.bfloat16), jnp.asarray(w1), jnp.asarray(b1),
        jnp.asarray(w2), jnp.asarray(b2), train=False, interpret=True),
        np.float32)
    print(f"fused_gathered_mlp_pool_plain C {C1}->{C2}->{C3}: max abs "
          f"{np.abs(got - ref).max():.3e} against the f32 reference, "
          f"{np.abs(got - pal).max():.3e} against the bf16 Pallas kernel "
          f"(max |value| {np.abs(ref).max():.3e})")

    pts, rois = _scene_and_rois(np.random.default_rng(5))
    feats = np.concatenate([np.broadcast_to(np.arange(2048.0), (2, 2048))[
        ..., None], rng.normal(size=(2, 2048, 5))], -1).astype(np.float32)
    px, pf, empty = (t.numpy() for t in roipool3d(
        torch.from_numpy(pts), torch.from_numpy(feats),
        torch.from_numpy(rois), 1.0, 64))
    jx, jf, je = (np.asarray(t) for t in jax_roipool3d(
        jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(rois), 1.0, 64,
        split=True))
    print(f"roipool3d (2 x 2048 points, 12 rois, K 64): id mismatches "
          f"{(pf[..., 0] != jf[..., 0]).sum()}, empty mismatches "
          f"{(empty != je).sum()}, values max abs "
          f"{max(np.abs(px - jx).max(), np.abs(pf - jf).max()):.3e}")

    a, b = _boxes5(np.random.default_rng(11), 40), _boxes5(
        np.random.default_rng(12), 30)
    errs = [np.abs(rotated_overlap_bev(torch.from_numpy(a),
                                       torch.from_numpy(b), c).numpy()
                   - np.asarray(jax_overlap(jnp.asarray(a), jnp.asarray(b),
                                            c))).max()
            for c in (-2, -1, 0, 1)]
    print("rotated_overlap_bev criteria -2/-1/0/1: max abs "
          + " / ".join(f"{e:.3e}" for e in errs))

    cfg, model, _, jout, jdec, _ = run_joint()
    out = model.rcnn_stage(*(torch.tensor(a) for a in (
        jout["backbone_xyz"], jout["backbone_features"],
        jout["rpn_cls"][..., 0], jout["rois"])))
    for key in ("rcnn_cls", "rcnn_reg"):
        print(f"RCNN stage on tpu3d's rois, {key}: max abs "
              f"{np.abs(out[key].numpy() - jout[key]).max():.3e} (max "
              f"|value| {np.abs(jout[key]).max():.3e})")
    b, m = jout["rois"].shape[:2]
    got = rcnn_decode_and_nms(
        cfg, torch.tensor(jout["rois"]),
        torch.tensor(jout["rcnn_cls"].reshape(b, m)),
        torch.tensor(jout["rcnn_reg"].reshape(b, m, -1)),
        torch.tensor(jout["roi_valid"]))
    print(f"decode + rotated NMS on tpu3d's outputs: final_mask mismatches "
          f"{(got['final_mask'].numpy() != jdec['final_mask']).sum()} "
          f"({int(jdec['final_mask'].sum())} kept), final_boxes max abs "
          f"{np.abs(got['final_boxes'].numpy() - jdec['final_boxes']).max():.3e}"
          f", final_scores max abs "
          f"{np.abs(got['final_scores'].numpy() - jdec['final_scores']).max():.3e}")


def _tree_err(ours, ref):
    """(largest abs difference over the leaves, largest abs value)."""
    a, b = dict(tt._flat(ours)), dict(tt._flat(ref))
    return (max(np.abs(a[k] - v).max() for k, v in b.items()),
            max(np.abs(v).max() for v in b.values()))


def train_report():
    """The training pieces and the whole-network gradients, on the inputs
    of tests/test_torch_train_ops.py and tests/test_torch_train.py."""
    feats, idx, w, g = to._interp_case(0)
    _, df, dw = to._port_interp_grads(feats, idx, w, g)
    _, vjp = jax.vjp(lambda f, wt: jax_three_interpolate(
        f, jnp.asarray(idx), wt), jnp.asarray(feats), jnp.asarray(w))
    jdf, jdw = vjp(jnp.asarray(g))
    print(f"three_interpolate backward (256 x 128 -> 264): d_features max "
          f"abs {np.abs(df - np.asarray(jdf)).max():.3e}, d_weight "
          f"{np.abs(dw - np.asarray(jdw)).max():.3e}")

    for shape in to.FUSED_SHAPES:
        args, gr = to._fused_case(4, shape, ties=True)
        _, grads = to._port_fused_grads(args, gr)
        pre, idx, center, w1, b1, w2, b2 = args
        chain = to._jax_ref_chain(idx)
        jgrads = jax.grad(lambda *a: jnp.sum(chain(*a) * jnp.asarray(gr)),
                          argnums=tuple(range(6)))(
            *(jnp.asarray(a) for a in (pre, center, w1, b1, w2, b2)))
        errs = ", ".join(
            f"{n} {np.abs(a - np.asarray(b)).max():.2e} (of "
            f"{np.abs(np.asarray(b)).max():.2e})"
            for n, a, b in zip(("d_pre", "d_center", "dW1", "db1", "dW2",
                                "db2"), grads, jgrads))
        print(f"fused op training gradients {shape}: {errs}")

    case = tt.rpn_case.__wrapped__()
    loss, grads, stats, jloss, jgrads, jstats, _ = case
    err, top = _tree_err(grads, jgrads)
    serr, _ = _tree_err(stats, jstats)
    print(f"RPN train-mode gradients, f64 (_tiny_cfg 1024 points): loss "
          f"{abs(loss - jloss):.3e} (of {jloss:.3e}), gradients max abs "
          f"{err:.3e} (largest {top:.3e}), running stats {serr:.3e}")
    loss, grads, jloss, jgrads, _ = tt.rcnn_case.__wrapped__()
    err, top = _tree_err(grads, jgrads)
    print(f"RCNN gradients on tpu3d's sampled targets, f32: loss "
          f"{abs(loss - jloss):.3e} (of {jloss:.3e}), gradients max abs "
          f"{err:.3e} (largest {top:.3e})")


def double_report():
    """configs/double.yaml's pieces and the fixed-RPN decay, on the inputs
    of tests/test_torch_double.py and tests/test_torch_train.py."""
    ids, rel = 0, 0.0
    for B, M, N in td.THREE_NN_SHAPES:
        u, k = td._clouds(B * M + N, B, M, N)
        d2, idx = (a.numpy() for a in three_nn(torch.from_numpy(u),
                                                torch.from_numpy(k)))
        jd, ji = jax.device_get(jax_three_nn(jnp.asarray(u), jnp.asarray(k),
                                             differentiable=False))
        ids += int((idx != ji).sum())
        rel = max(rel, float((np.abs(np.sqrt(d2) - jd) / jd).max()))
    print(f"three_nn against tpu3d's ({len(td.THREE_NN_SHAPES)} shapes): id "
          f"mismatches {ids}, distance max rel {rel:.3e}")
    xyz = np.random.default_rng(5120).uniform(
        [-30, -1, 0], [30, 3, 70], size=(1, 4096, 3)).astype(np.float32)
    got = [a.numpy() for a in fps_then_three_nn(torch.from_numpy(xyz), 1024)]
    ref = jax.device_get(jax_fps3nn(jnp.asarray(xyz), 1024))
    rel = np.abs(got[1] - ref[1]) / np.maximum(ref[1], 1e-30)
    print(f"split route (1, 4096) -> 1024: pick mismatches "
          f"{(got[0] != ref[0]).sum()}, nn_idx mismatches "
          f"{(got[2] != ref[2]).sum()}, nn_d2 max rel {rel.max():.3e}")

    model, _, jout, out, calls = td.double_eval.__wrapped__()
    for key in ("backbone_features", "rpn_cls", "rpn_reg"):
        print(f"double.yaml cut to 2048 points (split calls at N={calls}), "
              f"{key}: max abs {np.abs(out[key] - jout[key]).max():.3e} "
              f"(max |value| {np.abs(jout[key]).max():.3e})")
    with torch.no_grad():
        st = model.rcnn_stage(*(torch.tensor(a) for a in (
            jout["backbone_xyz"], jout["backbone_features"],
            jout["rpn_cls"][..., 0], jout["rois"])))
    for key in ("rcnn_cls", "rcnn_reg"):
        print(f"double.yaml RCNN stage on tpu3d's rois, {key}: max abs "
              f"{np.abs(st[key].numpy() - jout[key]).max():.3e}")
    loss, grads, jloss, jgrads = td.double_rpn_train_case()
    err, top = _tree_err(grads, jgrads)
    print(f"double.yaml RPN train-mode gradients, f64: loss "
          f"{abs(loss - jloss):.3e} (of {jloss:.3e}), gradients max abs "
          f"{err:.3e} (largest {top:.3e})")
    for optimizer in ("adam_onecycle", "adam", "sgd"):
        ours, ref, _, kept = tt.fixed_rpn_case(optimizer)
        err = max(float(np.abs(ours[k] - v).max()) for k, v in ref.items())
        top = max(float(np.abs(v).max()) for v in ref.values())
        print(f"fixed RPN after 3 rcnn-mode steps, {optimizer}: max abs "
              f"{err:.3e} (largest {top:.3e}) against tpu3d's chain, "
              f"statistics kept {kept}")


def slab_report():
    """The slab form of the fused SA op, with and without BatchNorm, the
    quickstart.yaml and smoke.yaml slices and the BatchNorm RCNN, on the
    inputs of tests/test_torch_slab.py."""
    for shape in ts.SLAB_SHAPES:
        evl, out, ref, grads, jgrads, _ = ts.slab_reference_case(shape)
        errs = ", ".join(
            f"{n} {np.abs(a - b).max() / np.abs(b).max():.3e}"
            for n, a, b in zip(ts.NAMES, grads, jgrads))
        print(f"fused_mlp_pool {shape} against the f32 reference: out "
              f"{np.abs(evl - ref).max() / np.abs(ref).max():.3e} of the "
              f"largest; gradients, of each one's largest: {errs}")
        out, jout, arg, jarg, grads, jgrads, shifts, moved, entries = \
            ts.slab_pallas_case(shape)

        def rel(a, b):
            return np.abs(a - b) / (np.abs(b).max() + 1e-3)

        errs = ", ".join(
            f"{n} {rel(a, b).max():.3e} (under the TPU kernel's layer-1 "
            f"mask {rel(a + s, b).max():.3e}) / {rel(a + s, b).mean():.3e}"
            for n, a, b, s in zip(ts.NAMES, grads, jgrads, (*shifts, 0, 0)))
        print(f"fused_mlp_pool {shape} against the Pallas kernel "
              f"(interpret): out max abs {np.abs(out - jout).max():.3e}, "
              f"argmax equal {(arg == jarg).mean():.4f}; layer-1 mask "
              f"entries of the other sign {moved} of {entries}; gradients "
              f"max / mean rel: {errs}")
    for shape in ts.BN_SHAPES:
        (x0, w1, w2), bns = ts._bn_case(shape, shape[1])
        ref = ts._jax_bn(jax_fused_sa.fused_bn_mlp_pool_reference, x0, w1,
                         w2, bns)
        err = np.abs(ts._port_bn(x0, w1, w2, bns) - ref).max()
        (x0, w1, w2), bns = ts._bn_case(shape, shape[1] + 1)
        x0, w1, w2 = ts._bf16_exact((x0, w1, w2))
        tpu = np.abs(ts._port_bn(x0, w1, w2, bns) - ts._jax_bn(
            jax_fused_sa.fused_bn_mlp_pool, x0, w1, w2, bns, interpret=True))
        print(f"fused_bn_mlp_pool {shape}: against the f32 reference "
              f"{err / np.abs(ref).max():.3e} of the largest; against the "
              f"Pallas kernel (interpret) max {tpu.max():.3e}, mean "
              f"{tpu.mean():.3e}")
    for name in sorted(ts.CONFIGS):
        jcfg = ts._config(name)
        params, stats, model, _, jout, out, calls = ts.run_config_eval(
            jcfg, ts.CONFIGS[name], 11)
        for key in ("backbone_features", "rpn_cls", "rpn_reg"):
            print(f"{name}.yaml eval (B={ts.CONFIGS[name]}), {key}: max abs "
                  f"{np.abs(out[key] - jout[key]).max():.3e} (max |value| "
                  f"{np.abs(jout[key]).max():.3e})")
        with torch.no_grad():
            st = model.rcnn_stage(*(torch.tensor(a) for a in (
                jout["backbone_xyz"], jout["backbone_features"],
                jout["rpn_cls"][..., 0], jout["rois"])))
        for key in ("rcnn_cls", "rcnn_reg"):
            d = np.abs(st[key].numpy() - jout[key]).max(axis=1)
            print(f"{name}.yaml RCNN stage on tpu3d's rois, {key}: max abs "
                  f"{d.max():.3e}, second largest over ROIs "
                  f"{np.sort(d)[-2]:.3e} (max |value| "
                  f"{np.abs(jout[key]).max():.3e}); routes {calls}")
        loss, grads, jloss, jgrads, _ = ts.config_rcnn_grad_case(name)
        err, top = _tree_err(grads, jgrads)
        print(f"{name}.yaml RCNN gradients on tpu3d's targets, f64: loss "
              f"{abs(loss - jloss):.3e} (of {jloss:.3e}), gradients max abs "
              f"{err:.3e} (largest {top:.3e})")
    jcfg = ts.bn_config()
    _, _, model, _, jout, _, calls = ts.run_config_eval(jcfg, 2, 14)
    with torch.no_grad():
        st = model.rcnn_stage(*(torch.tensor(a) for a in (
            jout["backbone_xyz"], jout["backbone_features"],
            jout["rpn_cls"][..., 0], jout["rois"])))
    for key in ("rcnn_cls", "rcnn_reg"):
        print(f"default.yaml with USE_BN (cut), RCNN stage on tpu3d's rois, "
              f"{key}: max abs {np.abs(st[key].numpy() - jout[key]).max():.3e}"
              f" (max |value| {np.abs(jout[key]).max():.3e}); routes {calls}")


def bn_train_report():
    """The BatchNorm chain's training (tests/test_torch_bn_train.py)."""
    def rel(a, b):
        return max(np.abs(np.asarray(x) - np.asarray(y)).max()
                   / np.abs(np.asarray(y)).max() for x, y in zip(a, b))

    for shape in tb.SHAPES:
        arrays = tb._case(shape, shape[2] + shape[5])
        ref = tb._jax_reference(arrays)
        for name, ours in (("op", tb._port(arrays)),
                           ("pieces", tb._pieces(arrays))):
            print(f"fused_bn_mlp_pool training {shape}, {name} against the "
                  f"f32 reference: out {rel([ours[0]], [ref[0]]):.3e}, "
                  f"statistics {rel(ours[1] + ours[2], ref[1] + ref[2]):.3e}"
                  f", gradients {rel(ours[3], ref[3]):.3e} of each largest")
    for shape in tb.SHAPES[:2] + tb.SHAPES[3:]:
        err, mean_err, _, same, rels = tb.pallas_case(shape)
        print(f"fused_bn_mlp_pool training {shape} against the Pallas "
              f"kernels (interpret): out max {err.max():.3e} mean "
              f"{err.mean():.3e}, means {mean_err:.3e}, argmax equal "
              f"{same:.4f}; gradients max / mean rel: " + ", ".join(
                  f"{n} {r.max():.3e} / {r.mean():.3e}"
                  for n, r in zip(tb.NAMES, rels)))
    for mode in ("joint", "rcnn"):
        jtb, jstats, tbm, stats, _, _, _ = tb.train_step_case(mode)
        ours, ref = dict(tt._flat(stats)), dict(tt._flat(jstats))
        worst = max(np.abs(ours[k] - v).max() / np.abs(v).max()
                    for k, v in ref.items())
        losses = ", ".join(
            f"{k} {abs(float(tbm[k]) - float(jtb[k])) / abs(float(jtb[k])):.3e}"
            for k in ("rpn_loss", "rcnn_loss") if k in jtb)
        print(f"BatchNorm RCNN {mode} train step, cut default.yaml, against "
              f"tpu3d's on pinned targets: relative loss errors {losses}; "
              f"RCNN running statistics {worst:.3e} of each largest")
    loss, jloss, ours, ref, stats, jstats, _ = tb.rcnn_f64_case()
    top = max(np.abs(v).max() for v in ref.values())
    err = max(np.abs(ours[k] - v).max() for k, v in ref.items())
    serr = max((np.abs(stats[k] - v) / np.abs(v).max()).max()
               for k, v in jstats.items())
    print(f"BatchNorm RCNN gradients on tpu3d's targets, f64: loss "
          f"{abs(loss - jloss):.3e} (of {jloss:.3e}), gradients max abs "
          f"{err:.3e} (largest {top:.3e}), running statistics {serr:.3e} "
          f"of each largest")


def main():
    rng = np.random.default_rng(4096)
    xyz = rng.uniform([-30, -1, 0], [30, 3, 70], (2, 4096, 3)).astype(
        np.float32)
    j = jax.device_get(jax_fps3nn(jnp.asarray(xyz), 1024))
    t = [a.numpy() for a in furthest_point_sample_with_3nn(
        torch.from_numpy(xyz), 1024)]
    rel = np.abs(t[1] - j[1]) / np.maximum(np.abs(j[1]), 1e-30)
    print(f"fps3nn (2, 4096) -> 1024: pick mismatches {(t[0] != j[0]).sum()}, "
          f"nn_idx mismatches {(t[2] != j[2]).sum()}, nn_d2 max rel "
          f"{rel.max():.3e}")

    pts = rng.uniform([-4, -1, 0], [4, 3, 8], (2, 4096, 3)).astype(np.float32)
    centers = pts[:, rng.choice(4096, 1024, replace=False)]
    jd, ji = jax.device_get(jax_nearest_k(jnp.asarray(centers),
                                          jnp.asarray(pts), 32))
    td, ti = nearest_k(torch.from_numpy(centers), torch.from_numpy(pts), 32)
    print(f"nearest_k (1024 x 4096, k 32): id mismatches "
          f"{(ti.numpy() != ji).sum()}, d2 max abs "
          f"{np.abs(td.numpy() - jd).max():.3e}")

    feats = rng.normal(size=(2, 4096, 256)).astype(np.float32)
    idx = rng.integers(0, 4096, (2, 16384, 3)).astype(np.int32)
    w = rng.uniform(0, 1, (2, 16384, 3)).astype(np.float32)
    jo = np.asarray(jax_three_interpolate(jnp.asarray(feats),
                                          jnp.asarray(idx), jnp.asarray(w)))
    to = three_interpolate(torch.from_numpy(feats), torch.from_numpy(idx),
                           torch.from_numpy(w)).numpy()
    print(f"three_interpolate (4096 x 256 -> 16384): max abs "
          f"{np.abs(to - jo).max():.3e}")

    for points in (1024, 4096):
        _, cfg, jout, tout, _ = run_pair(points)
        for key in ("backbone_xyz", "backbone_features", "rpn_cls",
                    "rpn_reg"):
            err = np.abs(tout[key] - jout[key]).max()
            print(f"RPN {points} points, {key}: max abs {err:.3e} "
                  f"(max |value| {np.abs(jout[key]).max():.3e})")
        rois, scores, valid = (a.numpy() for a in proposal_layer(
            torch.tensor(jout["rpn_cls"][..., 0]),
            torch.from_numpy(tout["rpn_reg"]),
            torch.from_numpy(tout["backbone_xyz"]), cfg, "TEST"))
        print(f"RPN {points} points, rois (tpu3d scores): max abs "
              f"{np.abs(rois - jout['rois']).max():.3e}, roi_valid "
              f"mismatches {(tout['roi_valid'] != jout['roi_valid']).sum()}, "
              f"valid {int(jout['roi_valid'].sum())}/{valid.size}")
    rcnn_report()
    train_report()
    double_report()
    slab_report()
    bn_train_report()


if __name__ == "__main__":
    main()
