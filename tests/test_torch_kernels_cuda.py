"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. The file imports
nothing of JAX or tpu3d, so it runs where the card is:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from _nearest_k_cases import dense_cloud, tie_cases
from _three_nn_cases import three_nn_cases

from tpu3d_torch.models.pointnet2 import PointnetSAModule
from tpu3d_torch.ops import (furthest_point_sample,
                             furthest_point_sample_with_3nn,
                             fused_bn_mlp_pool, fused_gathered_mlp_pool,
                             fused_mlp_pool, nearest_k, three_interpolate,
                             three_nn, three_nn_plain)
from tpu3d_torch.ops import _build
from tpu3d_torch.ops import fused_sa as fs
from tpu3d_torch.ops.fused_sa import (
    bn_packs, fused_gathered_mlp_pool_backward,
    fused_gathered_mlp_pool_backward_plain,
    fused_gathered_mlp_pool_backward_routed_plain,
    fused_gathered_mlp_pool_plain,
    fused_gathered_mlp_pool_train, fused_gathered_mlp_pool_train_plain,
    fused_mlp_pool_backward, fused_mlp_pool_backward_plain,
    fused_mlp_pool_backward_routed_plain,
    fused_mlp_pool_train, fused_mlp_pool_train_plain,
    fused_sa_slab_plain, _bn_affine,
    _layer_pack, _pack)
from tpu3d_torch.ops.grouping import (_radius2, launch_nearest_k,
                                      nearest_k_plain)
from tpu3d_torch.ops.interpolate import (backward_workspace,
                                         launch_three_nn,
                                         three_interpolate_backward,
                                         three_interpolate_backward_plain,
                                         three_interpolate_plain)
from tpu3d_torch.ops.sampling import (furthest_point_sample_plain,
                                      furthest_point_sample_with_3nn_plain)
from tpu3d_torch.tools.kernel_bench import bn_eval_layers


def _cloud(rng, b, n):
    return rng.uniform([-30, -1, 0], [30, 3, 70], size=(b, n, 3)).astype(
        np.float32)


def _pooled_rows(rng, rows, n):
    """Rows as the ROI pool gives them: uniform, a few distinct points
    repeated by wraparound, and all-equal (empty ROI)."""
    xyz = rng.uniform(-2.5, 2.5, size=(rows, n, 3))
    hits = rng.integers(1, 80, size=rows)
    for r in range(0, rows, 3):
        xyz[r] = xyz[r, np.arange(n) % hits[r]]
    xyz[1::7] = xyz[1::7, :1]
    return xyz.astype(np.float32)


def _fused_inputs(r, c3, n=512, m=128, s=64, c1=128, c2=128, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    pre = randn(r, n, c1)
    idx = torch.randint(0, n, (r, m, s), generator=g, device="cuda",
                        dtype=torch.int32)
    return (pre, idx, randn(r, m, c1), randn(c1, c2, scale=c1 ** -0.5),
            randn(c2, scale=0.1), randn(c2, c3, scale=c2 ** -0.5),
            randn(c3, scale=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fps3nn", "nearest_k", "three_interpolate",
                                  "fps", "fused_sa", "three_interpolate_bwd",
                                  "fused_sa_train", "fused_sa_bwd"])
def test_kernels_match_plain_on_cuda(name):
    """Each CUDA kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(0)
    xyz = torch.from_numpy(_cloud(rng, 2, 4096)).cuda()
    if name == "fps3nn":
        got = furthest_point_sample_with_3nn(xyz, 1024)
        ref = furthest_point_sample_with_3nn_plain(xyz, 1024)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    elif name == "nearest_k":
        centers = xyz[:, :1024].contiguous()
        got = nearest_k(centers, xyz, 32, max_radius=2.0, with_coords=True)
        ref = nearest_k_plain(centers, xyz, 32, max_radius=2.0,
                              with_coords=True)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    elif name == "fps":
        for n, npoint in ((512, 128), (128, 32), (2048, 300)):
            rows = torch.from_numpy(_pooled_rows(rng, 64, n)).cuda()
            torch.testing.assert_close(
                furthest_point_sample(rows, npoint),
                furthest_point_sample_plain(rows, npoint), rtol=0, atol=0)
    elif name == "fused_sa_train":
        # out equal to the eval kernel's to the bit, the first-argmax slots
        # equal to the plain version's (random ids repeat within a group)
        for c3 in (128, 256):
            args = _fused_inputs(8, c3)
            out, arg, ppre = fused_gathered_mlp_pool_train(*args)
            torch.testing.assert_close(out, fused_gathered_mlp_pool(*args),
                                       rtol=0, atol=0)
            ref = fused_gathered_mlp_pool_train_plain(*args)
            tol = 1e-4 * ref[0].abs().max().item()
            torch.testing.assert_close(out, ref[0], rtol=0, atol=tol)
            agree = (arg == ref[1]).float().mean().item()
            assert agree > 0.999, agree  # near-ties may flip in f32
            torch.testing.assert_close(ppre, ref[2], rtol=0, atol=tol)
    elif name == "fused_sa_bwd":
        # the six gradients within 1e-4 of each one's largest value; the
        # plain version's own argmax routes the gradient in both
        for c3 in (128, 256):
            args = _fused_inputs(8, c3, seed=1)
            grad = torch.randn(8, 128, c3, device="cuda")
            _, arg, ppre = fused_gathered_mlp_pool_train_plain(*args)
            got = fused_gathered_mlp_pool_backward(*args, grad, arg, ppre)
            ref = fused_gathered_mlp_pool_backward_plain(*args, grad)
            for g_, r_ in zip(got, ref):
                tol = 1e-4 * r_.abs().max().item()
                torch.testing.assert_close(g_, r_, rtol=0, atol=tol)
    elif name == "three_interpolate_bwd":
        # the plain version's index_add_ adds with atomics on the card, in
        # another order: within 1e-5 of the largest value
        feats = torch.randn(2, 1024, 256, device="cuda")
        idx = torch.randint(0, 1024, (2, 4096, 3), device="cuda",
                            dtype=torch.int32)
        w = torch.rand(2, 4096, 3, device="cuda")
        grad = torch.randn(2, 4096, 256, device="cuda")
        got = three_interpolate_backward(feats, idx, w, grad)
        ref = three_interpolate_backward_plain(feats, idx, w, grad)
        for g_, r_ in zip(got, ref):
            tol = 1e-5 * r_.abs().max().item()
            torch.testing.assert_close(g_, r_, rtol=0, atol=tol)
    elif name == "fused_sa":
        # f32 sums in another order: within 1e-4 of the largest value
        for c3 in (128, 256):
            r, n, m, s, c1, c2 = 8, 512, 128, 64, 128, 128
            pre = torch.randn(r, n, c1, device="cuda")
            idx = torch.randint(0, n, (r, m, s), device="cuda",
                                dtype=torch.int32)
            center = torch.randn(r, m, c1, device="cuda")
            w1 = torch.randn(c1, c2, device="cuda") / c1 ** 0.5
            w2 = torch.randn(c2, c3, device="cuda") / c2 ** 0.5
            b1 = torch.randn(c2, device="cuda") * 0.1
            b2 = torch.randn(c3, device="cuda") * 0.1
            got = fused_gathered_mlp_pool(pre, idx, center, w1, b1, w2, b2)
            ref = fused_gathered_mlp_pool_plain(pre, idx, center, w1, b1, w2,
                                                b2)
            tol = 1e-4 * ref.abs().max().item()
            torch.testing.assert_close(got, ref, rtol=0, atol=tol)
    else:
        feats = torch.randn(2, 1024, 256, device="cuda")
        idx = torch.randint(0, 1024, (2, 4096, 3), device="cuda",
                            dtype=torch.int32)
        w = torch.rand(2, 4096, 3, device="cuda")
        torch.testing.assert_close(three_interpolate(feats, idx, w),
                                   three_interpolate_plain(feats, idx, w),
                                   rtol=1e-6, atol=1e-6)
    assert _build.LAUNCHES[name] > 0


# nearest_k at default.yaml's six levels (eval batch: 2 scenes, 200
# pooled ROIs), in the dense box, and on the adversarial tie cases
NK_LEVELS = ["RPN SA_0", "RPN SA_1", "RPN SA_2", "RPN SA_3", "RCNN SA_0",
             "RCNN SA_1", "dense RPN SA_0"]
NK_TIES = [c[0] for c in tie_cases()]


def _nk_level(name):
    """(centers, points, k, max_radius) of a level, on the card: the RPN's
    centers by FPS over the level below, the RCNN's over pooled rows."""
    rng = np.random.default_rng(7)
    if name.startswith("RCNN"):
        x = torch.from_numpy(_pooled_rows(rng, 200, 512)).cuda()
        sizes, radii, k = (128, 32), (0.2, 0.4), 64
    else:
        cloud = dense_cloud if name.startswith("dense") else _cloud
        x = torch.from_numpy(cloud(rng, 2, 16384)).cuda()
        sizes, radii, k = (4096, 1024, 256, 64), (0.5, 1.0, 2.0, 4.0), 32
    level = int(name[-1])
    for npoint in sizes[:level + 1]:
        y = x[torch.arange(x.shape[0], device="cuda")[:, None],
              furthest_point_sample(x, npoint).long()]
        if npoint != sizes[level]:
            x = y
    return y.contiguous(), x, k, radii[level]


@pytest.mark.cuda
@pytest.mark.parametrize("case", NK_LEVELS + NK_TIES)
def test_nearest_k_matches_plain_on_cuda(case):
    """nearest_k's d², ids and coordinates equal the plain version's
    (torch.equal) through its own route and through both forms:
    default.yaml's six levels, the dense box
    (every SA_0 center has more than k points within r) and the tie cases
    (radius boundaries to the ulp, repeated points, depths 0 and 70.4,
    N < k, N % 128 != 0, empty windows, one point repeated), these also at
    k = 1, 7, 50 and 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    if case in NK_TIES:
        _, c, p, k, r = tie_cases()[NK_TIES.index(case)]
        c, p = torch.from_numpy(c).cuda(), torch.from_numpy(p).cuda()
        ks = (k, 1, 7, 50, 128)
    else:
        c, p, k, r = _nk_level(case)
        ks = (k,)
    _build.reset_launches()
    for k in ks:
        ref = nearest_k_plain(c, p, k, r, with_coords=True)
        runs = [nearest_k(c, p, k, max_radius=r, with_coords=True)]
        runs += [launch_nearest_k(c, p, k, _radius2(r), windowed, True)
                 for windowed in (True, False)]
        for got in runs:
            for g, w in zip(got, ref):
                assert torch.equal(g, w), f"k={k}"
    assert _build.LAUNCHES["nearest_k"] == 3 * len(ks)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["three_nn", "fps_long", "fps3nn"])
def test_long_row_kernels_match_plain_on_cuda(name):
    """The kernels of configs/double.yaml's SA_0 (32768 points per scene)
    against their plain versions on the card, bit for bit: three_nn of
    every point to 4096 known points (also with repeated known points,
    whose ties go to the lowest index), the long-row FPS alone (also at
    sizes that one block or uneven cluster halves take), and FPS+3NN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(4)
    xyz = torch.from_numpy(_cloud(rng, 2, 32768)).cuda()
    _build.reset_launches()
    if name == "three_nn":
        known = xyz[:, ::8].contiguous()
        repeated = known[:, torch.arange(4096, device="cuda") % 1000]
        for k in (known, repeated.contiguous(), known[:, :5].contiguous()):
            got = three_nn(xyz, k)
            ref = three_nn_plain(xyz, k)
            for g, r in zip(got, ref):
                torch.testing.assert_close(g, r, rtol=0, atol=0)
    elif name == "fps_long":
        for n, npoint in ((32768, 4096), (30001, 1000), (5000, 700)):
            x = xyz[:, :n].contiguous()
            torch.testing.assert_close(furthest_point_sample(x, npoint),
                                       furthest_point_sample_plain(x, npoint),
                                       rtol=0, atol=0)
    else:
        got = furthest_point_sample_with_3nn(xyz, 4096)
        ref = furthest_point_sample_with_3nn_plain(xyz, 4096)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert _build.LAUNCHES[name] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("c3", [128, 256])
def test_fused_sa_bwd_full_spread_on_cuda(c3):
    """The gather form's backward when every channel is live at a slot
    drawn uniformly over S (nearly every slot reached, one group per tile),
    and when a few channels are live (many groups per tile), against the
    routed plain version: within 1e-4 of each gradient's largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    args = _fused_inputs(64, c3, seed=5)
    out, _, ppre = fused_gathered_mlp_pool_train(*args)
    g = torch.Generator(device="cuda").manual_seed(6)
    grad = torch.randn(out.shape, generator=g, device="cuda")
    arg = torch.randint(0, 64, out.shape, generator=g, device="cuda",
                        dtype=torch.int32)
    sparse = torch.where(torch.rand(out.shape, generator=g, device="cuda")
                         < 0.03, 1.0, -1.0)
    for live in (torch.ones_like(ppre), sparse):
        got = fused_gathered_mlp_pool_backward(*args, grad, arg, live)
        ref = fused_gathered_mlp_pool_backward_routed_plain(*args, grad, arg,
                                                            live)
        for a, b in zip(got, ref):
            assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_fps_cluster_sizes_on_cuda(k, monkeypatch):
    """The FPS pick loop on clusters of k CTAs (every size fps_geometry can
    choose; 16 where the card takes it), on clouds whose slices repeat each
    other's points (ties across CTA boundaries) and a uniform cloud, bit for
    bit against the plain version: the picks alone and FPS+3NN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpu3d_torch.ops import sampling

    n, npoint = 4096, 1024
    threads = 128 if k > 1 else 256
    geom = (k, threads,
            next(p for p in sampling.FPS_PPT if k * threads * p >= n))
    if not sampling.card_takes(geom):
        pytest.skip(f"this card takes no cluster of {k} CTAs")
    monkeypatch.setattr(sampling, "card_geometry", lambda B, N: geom)
    rng = np.random.default_rng(k)
    tied = (rng.integers(0, 24, size=(2, n, 3)) / 4).astype(np.float32)
    h = -(-n // k)
    for r in range(1, k):
        tied[:, r * h:(r + 1) * h] = tied[:, :min(h, n - r * h)]
    for cloud in (tied, _cloud(rng, 2, n)):
        xyz = torch.from_numpy(cloud).cuda()
        torch.testing.assert_close(
            furthest_point_sample(xyz, npoint),
            furthest_point_sample_plain(xyz, npoint), rtol=0, atol=0)
        got = furthest_point_sample_with_3nn(xyz, npoint)
        ref = furthest_point_sample_with_3nn_plain(xyz, npoint)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def _slab_inputs(r, m, s, c3, seed, c1=128, c2=128):
    """A grouped slab whose groups repeat their first h slots (h random per
    group, as pooled rows and the ball query's pad repeat points), weights
    and an output gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x0 = torch.randn(r, m, s, c1, generator=g, device="cuda")
    h = torch.randint(1, s + 1, (r, m, 1), generator=g, device="cuda")
    slots = torch.arange(s, device="cuda") % h
    x0 = torch.gather(x0, 2, slots[..., None].expand(-1, -1, -1, c1))
    return (x0.contiguous(),
            torch.randn(c1, c2, generator=g, device="cuda") / c1 ** 0.5,
            torch.randn(c2, generator=g, device="cuda") * 0.1,
            torch.randn(c2, c3, generator=g, device="cuda") / c2 ** 0.5,
            torch.randn(c3, generator=g, device="cuda") * 0.1,
            torch.randn(r, m, c3, generator=g, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_sa_slab", "fused_sa_slab_train",
                                  "fused_sa_slab_bwd", "fused_sa_slab_bn"])
def test_slab_kernels_match_plain_on_cuda(name):
    """The slab form of the fused SA op (quickstart.yaml's and smoke.yaml's
    RCNN SA_1, and an RCNN with BatchNorm at eval) against its plain
    versions on the card, at S 16/32/64 and C3 128/256: the eval output,
    without and with BatchNorm packs, within 1e-4 of its largest value; the
    training output equal to the eval kernel's to the bit, its first-argmax
    slots equal to the plain version's but at near-ties; the five gradients
    within 1e-4 of each one's largest value, routed by the plain version's
    argmax and ppre."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _build.reset_launches()
    for s, c3 in ((64, 256), (16, 128), (32, 256), (64, 128)):
        *args, grad = _slab_inputs(64, 16, s, c3, seed=s + c3)
        ref = fused_mlp_pool_train_plain(*args)
        tol = 1e-4 * ref[0].abs().max().item()
        if name == "fused_sa_slab":
            torch.testing.assert_close(fused_mlp_pool(*args), ref[0], rtol=0,
                                       atol=tol)
        elif name == "fused_sa_slab_train":
            out, arg, ppre = fused_mlp_pool_train(*args)
            torch.testing.assert_close(out, fused_mlp_pool(*args), rtol=0,
                                       atol=0)
            torch.testing.assert_close(out, ref[0], rtol=0, atol=tol)
            agree = (arg == ref[1]).float().mean().item()
            assert agree > 0.999, agree  # near-ties may flip in f32
            torch.testing.assert_close(ppre, ref[2], rtol=0, atol=tol)
        elif name == "fused_sa_slab_bwd":
            got = fused_mlp_pool_backward(*args, grad, ref[1], ref[2])
            want = fused_mlp_pool_backward_plain(*args, grad, ref[1], ref[2])
            for g_, r_ in zip(got, want):
                torch.testing.assert_close(
                    g_, r_, rtol=0, atol=1e-4 * r_.abs().max().item())
        else:
            x0, w1, _, w2, _ = args
            g = torch.Generator(device="cuda").manual_seed(s)
            gammas, betas, stats, affines = _bn_params(g, c3)
            want = fused_sa_slab_plain(x0, bn_packs(affines), w1, w2)
            torch.testing.assert_close(
                fused_bn_mlp_pool(x0, w1, w2, gammas, betas, stats), want,
                rtol=0, atol=1e-4 * want.abs().max().item())
    assert _build.LAUNCHES[name] > 0


def _bn_params(g, c3, c1=128, c2=128):
    """Three BatchNorm layers' gammas, betas and running (mean, var), away
    from 0 and 1, and their eval affines as the op folds them."""
    gammas, betas, stats = [], [], []
    for c in (c1, c2, c3):
        gammas.append(1 + 0.2 * torch.randn(c, generator=g, device="cuda"))
        betas.append(0.2 * torch.randn(c, generator=g, device="cuda"))
        stats.append((0.3 * torch.randn(c, generator=g, device="cuda"),
                      0.5 + torch.rand(c, generator=g, device="cuda")))
    affines = [_bn_affine(m, v, ga, be, 1e-5)[:2]
               for (m, v), ga, be in zip(stats, gammas, betas)]
    return gammas, betas, stats, affines


def _near(a, b, scale, tol=1e-4):
    torch.testing.assert_close(a, b, rtol=0, atol=tol * scale)


def _bf16_step(x):
    """The spacing of bf16 values at |x| (one step of a bf16 rounding)."""
    return torch.exp2(torch.floor(torch.log2(
        x.float().abs().clamp_min(1e-30))) - 7)


def _within_step(a, b, flips=1e-3):
    """a within one bf16 step of b everywhere, off at all in at most
    ``flips`` of the values."""
    d = (a.float() - b.float()).abs()
    assert (d <= _bf16_step(b)).all()
    assert (d > 0).float().mean().item() <= flips


def _slab_close(a, b):
    """A slab against the plain piece's: in bf16 within one bf16 step
    (``_within_step``), in f32 within 1e-4 of its largest value."""
    assert a.dtype == b.dtype
    if a.dtype == torch.bfloat16:
        _within_step(a, b)
    else:
        _near(a, b, b.abs().max().item())


def _tensors(x):
    """The tensors of a nest of tuples and lists, in order."""
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return [x]


def _twice(fn):
    """fn's result, after a second call that gave the same bits."""
    first, again = fn(), fn()
    assert all(torch.equal(a, b)
               for a, b in zip(_tensors(first), _tensors(again)))
    return first


def bn_pieces_check(name, x0, w1, w2, grad, gammas, betas, g,
                    repeat=False):
    """Kernel ``name`` of the BatchNorm chain's training form against its
    plain piece on the same inputs: the f32 form on an f32 x0, the bf16
    entries (``*_bf16``) on a bf16 x0; the plain pieces' own statistics,
    x1, x2, argmax and d_y1 (see test_bn_train_kernels_match_plain_on_cuda
    and test_bn_bf16_training_kernels_match_plain_on_cuda for the bounds).
    ``repeat``: the kernel runs twice, both calls equal to the bit."""
    run = _twice if repeat else (lambda fn: fn())
    R, M, S, _ = x0.shape
    n = R * M * S
    base = name.removesuffix("_bf16")
    # the waves' reductions and weight gradients: f32 sums of n products
    # in another order, of bf16 operands in the bf16 form
    red_tol = 1e-4 if x0.dtype == torch.float32 else 1e-3
    layers, stats, slabs = [], [], [x0]
    for depth in range(3):
        args = ((x0,) if depth == 0 else
                (slabs[-1], layers[-1][0].contiguous(),
                 layers[-1][1].contiguous(), (w1, w2)[depth - 1]))
        want = fs.fused_sa_bn_stats_plain(depth, *args)
        if base == f"fused_sa_bn_stats{depth}":
            got = run(lambda: fs.fused_sa_bn_stats(depth, *args))
            if depth:
                (got, y), (want, wy) = got, want
                _slab_close(y, wy)
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
            assert ((got[0] - want[0]).abs()
                    <= 1e-5 * (n * want[1]).sqrt()).all()
            return
        if depth:
            want, y = want
            slabs.append(y)
        stats.append(fs._mean_var(want, n, torch.float32))
        layers.append(_layer_pack(*stats[-1], gammas[depth], betas[depth],
                                  1e-5, n))
    x1, x2 = slabs[1:]
    m2, a2 = layers[2][0].contiguous(), layers[2][1].contiguous()
    out, arg, at = fs.fused_sa_bn_final_plain(x2, m2, a2)
    if base == "fused_sa_bn_final":
        for a, b in zip(run(lambda: fs.fused_sa_bn_final(x2, m2, a2)),
                        (out, arg, at)):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        return
    d_y2 = torch.where(out > 0, grad.float(), 0.0)
    (mean2, var2), r2 = stats[2], layers[2][2]
    layers[2] = _layer_pack(
        mean2, var2, gammas[2], betas[2], 1e-5, n, d_y2.sum(dim=(0, 1)),
        (d_y2 * (at * r2 - mean2 * r2)).sum(dim=(0, 1)))
    for layer, scale in ((1, 0.3), (0, 0.2)):  # nonzero ca, cb
        c = layers[layer].shape[1]
        layers[layer][5:] = scale * torch.randn(2, c, generator=g,
                                                device="cuda")
    pk = _pack(layers)
    dval = (d_y2 * layers[2][0]).contiguous()
    _, _, d_y1 = fs.fused_sa_bn_wave1_plain(x2, x1, pk, w2, dval, arg)
    if base == "fused_sa_bn_wave1":
        got = run(lambda: fs.fused_sa_bn_wave1(x2, x1, pk, w2, dval, arg))
        want = fs.fused_sa_bn_wave1_plain(x2, x1, pk, w2, dval, arg)
    elif base == "fused_sa_bn_wave2":
        got = run(lambda: fs.fused_sa_bn_wave2(d_y1, x1, x0, pk, w1))
        want = fs.fused_sa_bn_wave2_plain(d_y1, x1, x0, pk, w1)
    else:
        _, _, d_y0 = fs.fused_sa_bn_wave2_plain(d_y1, x1, x0, pk, w1)
        want = [fs.fused_sa_bn_apply_plain(d_y0, x0, pk)]
        got = [run(lambda: fs.fused_sa_bn_apply(d_y0.clone(), x0, pk))]
        assert got[0].dtype == x0.dtype and d_y0.dtype == torch.float32
    for a, b in zip(got, want):
        if a.dim() == 4:
            _slab_close(a, b)
        else:
            assert a.dtype == b.dtype
            _near(a, b, b.abs().max().item(), red_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_sa_bn_stats0", "fused_sa_bn_stats1",
                                  "fused_sa_bn_stats2", "fused_sa_bn_final",
                                  "fused_sa_bn_wave1", "fused_sa_bn_wave2",
                                  "fused_sa_bn_apply"])
def test_bn_train_kernels_match_plain_on_cuda(name):
    """The BatchNorm chain's seven training kernels against their plain
    pieces on the card, at S 16/32/64 and C3 128/256, on the same inputs
    (the plain pieces' own statistics, x1, x2, argmax and d_y1): each
    statistics pass's Σx² within 1e-5 of its value and
    Σx within 1e-5·√(n·Σx²) per channel (f32 layers summed in another
    order, the sums in f64), the slab it writes within 1e-4 of its largest
    value; the final pass equal to the bit (a reduction over the same
    stored x2, no arithmetic but the folded affine); each wave's two
    reductions, its weight gradient, its slab and d_x0 within 1e-4 of each
    one's largest value. Every pass reads the same stored x1 and x2, so no
    ReLU mask flips between passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _build.reset_launches()
    for s, c3 in ((64, 128), (16, 256), (32, 128), (64, 256)):
        x0, w1, _, w2, _, grad = _slab_inputs(64, 16, s, c3, seed=s + c3)
        g = torch.Generator(device="cuda").manual_seed(s + 1)
        gammas, betas, _, _ = _bn_params(g, c3)
        bn_pieces_check(name, x0, w1, w2, grad, gammas, betas, g)
    assert _build.LAUNCHES[name] > 0


# the widened shapes: S 8, 24 and 128 slots, widths 256, 384 and 512, as
# tests/test_torch_fused_sa_wide.py holds them against tpu3d on the CPU
WIDE = [(2, 16, 8, 256, 384, 512), (2, 16, 24, 384, 512, 256),
        (1, 2, 128, 512, 256, 384), (64, 4, 128, 256, 384, 256)]
WIDE_ENTRIES = ["fused_sa", "fused_sa_train", "fused_sa_bwd", "fused_sa_slab",
                "fused_sa_slab_train", "fused_sa_slab_bwd", "fused_sa_slab_bn",
                "fused_sa_bn_stats0", "fused_sa_bn_stats1",
                "fused_sa_bn_stats2", "fused_sa_bn_final",
                "fused_sa_bn_wave1", "fused_sa_bn_wave2", "fused_sa_bn_apply"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", WIDE_ENTRIES)
def test_fused_entries_wide_on_cuda(name):
    """Every fused entry at the widened shapes (and one with many groups
    of 128 slots) against its plain version on the card, with the bounds
    of the shipped shapes' tests above: outputs within 1e-4 of the largest
    value, the training forward's output equal to the eval kernel's,
    argmax equal but at near-ties (at most 1 in 1000), the backward's
    gradients within 1e-4 of each largest value both under the plain
    forward's own routing and with every channel live at a uniform slot
    (against the routed plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _build.reset_launches()
    for r, m, s, c1, c2, c3 in WIDE:
        seed = s + c1 + c3
        if name in ("fused_sa", "fused_sa_train", "fused_sa_bwd"):
            args = _fused_inputs(r, c3, n=128, m=m, s=s, c1=c1, c2=c2,
                                 seed=seed)
            ref = fused_gathered_mlp_pool_train_plain(*args)
            tol = 1e-4 * ref[0].abs().max().item()
            if name == "fused_sa":
                _near(fused_gathered_mlp_pool(*args), ref[0], tol, 1)
            elif name == "fused_sa_train":
                out, arg, ppre = fused_gathered_mlp_pool_train(*args)
                torch.testing.assert_close(
                    out, fused_gathered_mlp_pool(*args), rtol=0, atol=0)
                _near(out, ref[0], tol, 1)
                assert (arg != ref[1]).sum().item() <= arg.numel() // 1000
                _near(ppre, ref[2], tol, 1)
            else:
                grad = torch.randn(ref[0].shape, device="cuda")
                full = torch.randint(0, s, ref[1].shape, device="cuda",
                                     dtype=torch.int32)
                for arg, ppre, plain in (
                        (ref[1], ref[2], None),
                        (full, torch.ones_like(ref[2]), True)):
                    got = fused_gathered_mlp_pool_backward(*args, grad, arg,
                                                           ppre)
                    want = (fused_gathered_mlp_pool_backward_routed_plain(
                        *args, grad, arg, ppre) if plain else
                        fused_gathered_mlp_pool_backward_plain(*args, grad))
                    for a, b in zip(got, want):
                        _near(a, b, b.abs().max().item())
            continue
        *args, grad = _slab_inputs(r, m, s, c3, seed, c1=c1, c2=c2)
        if name.startswith("fused_sa_slab") and name != "fused_sa_slab_bn":
            ref = fused_mlp_pool_train_plain(*args)
            tol = 1e-4 * ref[0].abs().max().item()
            if name == "fused_sa_slab":
                _near(fused_mlp_pool(*args), ref[0], tol, 1)
            elif name == "fused_sa_slab_train":
                out, arg, ppre = fused_mlp_pool_train(*args)
                torch.testing.assert_close(out, fused_mlp_pool(*args),
                                           rtol=0, atol=0)
                _near(out, ref[0], tol, 1)
                assert (arg != ref[1]).sum().item() <= arg.numel() // 1000
                _near(ppre, ref[2], tol, 1)
            else:
                full = torch.randint(0, s, ref[1].shape, device="cuda",
                                     dtype=torch.int32)
                for arg, ppre in ((ref[1], ref[2]),
                                  (full, torch.ones_like(ref[2]))):
                    got = fused_mlp_pool_backward(*args, grad, arg, ppre)
                    want = fused_mlp_pool_backward_routed_plain(
                        *args, grad, arg, ppre)
                    for a, b in zip(got, want):
                        _near(a, b, b.abs().max().item())
            continue
        x0, w1, _, w2, _ = args
        g = torch.Generator(device="cuda").manual_seed(seed)
        gammas, betas, stats, affines = _bn_params(g, c3, c1, c2)
        if name == "fused_sa_slab_bn":
            want = fused_sa_slab_plain(x0, bn_packs(affines), w1, w2)
            _near(fused_bn_mlp_pool(x0, w1, w2, gammas, betas, stats), want,
                  want.abs().max().item())
        else:
            bn_pieces_check(name, x0, w1, w2, grad, gammas, betas, g)
    assert _build.LAUNCHES[name] > 0


@pytest.mark.cuda
def test_bn_chain_training_on_cuda():
    """An RCNN level with BatchNorm in training runs the chain's seven
    kernels, once each per forward and backward, and its output and every
    gradient meet the plain chain's within 1e-4 of each one's largest
    value; its running statistics take the momentum update with the batch
    statistics; a gradient through the eval form raises; at eval it
    launches the slab kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sa = PointnetSAModule(16, 0.8, 64, (128, 128, 256), 125, bn=True,
                          device="cuda")
    xyz = torch.rand(4, 64, 3, device="cuda")
    feats = torch.randn(4, 64, 125, device="cuda")
    cpu = PointnetSAModule(16, 0.8, 64, (128, 128, 256), 125, bn=True,
                           device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in sa.state_dict().items()})
    _build.reset_launches()
    out = sa(xyz, feats, train=True, bn_momentum=0.9)[1]
    out.backward(torch.ones_like(out))
    for name in ("fused_sa_bn_stats0", "fused_sa_bn_stats1",
                 "fused_sa_bn_stats2", "fused_sa_bn_final",
                 "fused_sa_bn_wave1", "fused_sa_bn_wave2",
                 "fused_sa_bn_apply"):
        assert _build.LAUNCHES[name] == 1, (name, _build.LAUNCHES[name])
    ref = cpu(xyz.cpu(), feats.cpu(), train=True, bn_momentum=0.9)[1]
    ref.backward(torch.ones_like(ref))
    _near(out.cpu(), ref, ref.abs().max().item())
    for (k, p), q in zip(sa.named_parameters(), cpu.parameters()):
        _near(p.grad.cpu(), q.grad, q.grad.abs().max().item())
    for k, v in cpu.state_dict().items():
        _near(sa.state_dict()[k].cpu(), v, v.abs().max().item(), 1e-5)
    with pytest.raises(NotImplementedError, match="no backward"):
        sa(xyz, feats)
    _build.reset_launches()
    with torch.no_grad():
        _, out = sa(xyz, feats)
    assert out.shape == (4, 16, 256)
    assert _build.LAUNCHES["fused_sa_slab_bn"] == 1


# the interpolation's backward at default.yaml's four FP levels of the
# train step (B=16: N sources, M rows, C), and the degenerate scene where
# every query takes the same three sources (lists of M, some rows with a
# repeated id)
INTERP_BWD = {"FP_0": (4096, 16384, 256), "FP_1": (1024, 4096, 512),
              "FP_2": (256, 1024, 512), "FP_3": (64, 256, 1024),
              "one triple": (4096, 16384, 256)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(INTERP_BWD))
def test_three_interpolate_bwd_fixed_order_on_cuda(case):
    """The gather form of the backward: two calls give the same bits; both
    equal the CPU plain version (index_add_, the same ascending order) bit
    for bit and the card's plain version within 1e-5 of the largest value;
    and the kernel writes every row itself: a buffer poisoned with NaN
    comes back equal to the wrapper's, so no zeroing pass is needed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    N, M, C = INTERP_BWD[case]
    B = 16
    g = torch.Generator(device="cuda").manual_seed(len(case))
    feats = torch.randn(B, N, C, generator=g, device="cuda")
    grad = torch.randn(B, M, C, generator=g, device="cuda")
    w = torch.rand(B, M, 3, generator=g, device="cuda")
    if case == "one triple":
        B = 2
        feats, grad, w = feats[:B], grad[:B].contiguous(), w[:B]
        idx = torch.tensor([5, 1, 2], dtype=torch.int32,
                           device="cuda").repeat(B, M, 1)
        idx[:, ::5, 1] = 5
    else:
        idx = torch.randint(0, N, (B, M, 3), generator=g, device="cuda",
                            dtype=torch.int32)
    _build.reset_launches()
    first = three_interpolate_backward(feats, idx, w, grad)
    second = three_interpolate_backward(feats, idx, w, grad)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    cpu = three_interpolate_backward_plain(feats.cpu(), idx.cpu(), w.cpu(),
                                           grad.cpu())
    assert torch.equal(first[0].cpu(), cpu[0])
    ref = three_interpolate_backward_plain(feats, idx, w, grad)
    for a, r in zip(first, ref):
        tol = 1e-5 * r.abs().max().item()
        torch.testing.assert_close(a, r, rtol=0, atol=tol)
    poisoned = torch.full((B, N, C), float("nan"), device="cuda")
    ws = torch.full((backward_workspace(B, N, M),), -1, dtype=torch.int32,
                    device="cuda")
    _build.launch("three_interpolate_bwd", feats.data_ptr(), idx.data_ptr(),
                  w.data_ptr(), grad.data_ptr(), B, N, M, C,
                  poisoned.data_ptr(), None, ws.data_ptr(), ws.numel())
    assert torch.equal(poisoned, first[0])
    assert _build.LAUNCHES["three_interpolate_bwd"] == 3


# every shape the short-row FPS takes in the five configurations (R rows,
# N points, npoint): the RCNN's SA_0 and SA_1 at default's (and double's
# and the BatchNorm RCNN's) eval and train, quickstart's and smoke's, the
# split route's RPN levels of quickstart and smoke, and 2048 points
FPS_ROWS = [(200, 512, 128), (200, 128, 32), (1024, 512, 128),
            (1024, 128, 32), (512, 256, 64), (512, 64, 16), (128, 256, 64),
            (128, 64, 16), (128, 128, 32), (128, 32, 16), (32, 128, 32),
            (32, 32, 16), (8, 64, 16), (2, 64, 32), (2, 32, 16),
            (64, 2048, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FPS_ROWS, ids=str)
def test_fps_rows_on_cuda(shape):
    """fps.cu's lane layouts at every row shape of the configs: the picks
    equal the plain version's bit for bit on pooled-looking rows (repeated
    points, all-equal rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    R, n, npoint = shape
    rows = torch.from_numpy(_pooled_rows(np.random.default_rng(n), R,
                                         n)).cuda()
    _build.reset_launches()
    torch.testing.assert_close(furthest_point_sample(rows, npoint),
                               furthest_point_sample_plain(rows, npoint),
                               rtol=0, atol=0)
    assert _build.LAUNCHES["fps"] == 1


THREE_NN_CASES = three_nn_cases(seed=1, scale=4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", THREE_NN_CASES + [4096, 8192],
                         ids=[c[0] for c in THREE_NN_CASES]
                         + ["double SA_0 (2 x 32768 -> 4096)",
                            "2 x 32768 -> 8192 (not staged)"])
def test_three_nn_forms_on_cuda(case):
    """Both forms of three_nn against three_nn_plain on the card, bit for
    bit (d² and ids): the windowed form and the brute form, on the CPU
    tests' adversarial cases (four times the points), at double.yaml's
    SA_0 on two scenes, and at 8192 known points, where the windowed form
    reads its scene from global memory (above csrc/three_nn.cu's
    kStageMax); one counted launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    if isinstance(case, int):
        xyz = torch.from_numpy(_cloud(np.random.default_rng(7), 2, 32768))
        u = xyz.cuda()
        k = xyz[:, ::32768 // case].contiguous().cuda()
    else:
        u, k = (torch.from_numpy(t).cuda() for t in case[1:])
    ref = three_nn_plain(u, k)
    _build.reset_launches()
    for windowed in (True, False):
        got = launch_three_nn(u, k, windowed)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert _build.LAUNCHES["three_nn"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("s", [16, 32, 64])
def test_slab_groups_on_cuda(s):
    """The slab form's forward at every groups-per-block G the kernel takes
    at S (1 and 4 at S 16; 1 and 2 at S 32; 1 at S 64), on 37 x 7 groups
    (a tail block at G 2 and 4), C3 128 and 256: the eval output within
    1e-4 of the plain version's largest value, the training output equal
    to the eval kernel's to the bit, its first-argmax slots equal to the
    plain version's but at near-ties, ppre within 1e-4; and every G's out,
    argmax and ppre equal to G = 1's to the bit (a G moves no sum). A G
    below 64 / S but above 1 is refused by the C entries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for c3 in (128, 256):
        *args, _ = _slab_inputs(37, 7, s, c3, seed=s + c3)
        x0, w1, b1, w2, b2 = args
        packs = fs.nobn_packs(x0.shape[-1], b1, b2)
        ref = fused_mlp_pool_train_plain(*args)
        tol = 1e-4 * ref[0].abs().max().item()
        first = None
        if s == 16:
            with pytest.raises(RuntimeError):
                fs._slab_forward("fused_sa_slab", x0, packs, w1, w2,
                                 groups=2)
        for G in sorted({1, 64 // s}):
            (out,) = fs._slab_forward("fused_sa_slab", x0, packs, w1, w2,
                                      groups=G)
            train = fs._slab_forward("fused_sa_slab_train", x0, packs, w1,
                                     w2, train=True, groups=G)
            torch.testing.assert_close(out, ref[0], rtol=0, atol=tol)
            torch.testing.assert_close(train[0], out, rtol=0, atol=0)
            agree = (train[1] == ref[1]).float().mean().item()
            assert agree > 0.999, (G, agree)  # near-ties may flip in f32
            torch.testing.assert_close(train[2], ref[2], rtol=0, atol=tol)
            if first is None:
                first = train
            for a, b in zip(train, first):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


# the grouping gather's shapes on the train step's paths: (B, N, M, S, C)
# at default.yaml's RPN SA_0 (two radii share one search, 32 slots), SA_1
# and SA_3, the RCNN's plain route, a row of repeated pads, and C not a
# multiple of 4 (the scalar form)
GROUP_BWD = {"RPN SA_0": (16, 16384, 4096, 32, 64),
             "RPN SA_1": (16, 4096, 1024, 32, 128),
             "RPN SA_3": (16, 256, 64, 32, 256),
             "RCNN plain": (64, 512, 128, 64, 128),
             "repeated pads": (4, 1024, 256, 64, 96),
             "odd width": (3, 200, 50, 16, 7)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GROUP_BWD))
def test_group_points_bwd_fixed_order_on_cuda(case):
    """The grouping gather's backward kernel: two calls give the same bits,
    both equal the CPU plain version (index_add_, ascending m·S + s) bit for
    bit, and autograd through group_points reaches the kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpu3d_torch.ops.grouping import (group_points,
                                          group_points_backward,
                                          group_points_backward_plain)
    B, N, M, S, C = GROUP_BWD[case]
    g = torch.Generator(device="cuda").manual_seed(len(case))
    idx = torch.randint(0, N, (B, M, S), generator=g, device="cuda",
                        dtype=torch.int32)
    if case == "repeated pads":  # short rows padded with their first hit
        idx[:, :, 3:] = idx[:, :, :1]
        idx[:, ::4] = 7
    grad = torch.randn(B, M, S, C, generator=g, device="cuda")
    _build.reset_launches()
    first = group_points_backward(grad, idx, N)
    second = group_points_backward(grad, idx, N)
    assert torch.equal(first, second)
    cpu = group_points_backward_plain(grad.cpu(), idx.cpu(), N)
    assert torch.equal(first.cpu(), cpu)
    feats = torch.randn(B, N, C, generator=g, device="cuda",
                        requires_grad=True)
    (d,) = torch.autograd.grad(group_points(feats, idx), feats, grad)
    assert torch.equal(d, first)
    assert _build.LAUNCHES["group_points_bwd"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("spread", ["seeded", "full"])
def test_fused_sa_bwd_fixed_order_on_cuda(spread):
    """The gather form's backward: two calls give the same bits in every
    output, and d_pre equals the CPU's fixed-order sum of the kernel's own
    reached rows (``reached_rows_sum``) bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    args = _fused_inputs(64, 128, seed=7)
    out, arg, ppre = fused_gathered_mlp_pool_train(*args)
    g = torch.Generator(device="cuda").manual_seed(8)
    grad = torch.randn(out.shape, generator=g, device="cuda")
    if spread == "full":
        arg = torch.randint(0, 64, out.shape, generator=g, device="cuda",
                            dtype=torch.int32)
        ppre = torch.ones_like(ppre)
    rows = []
    first = fused_gathered_mlp_pool_backward(*args, grad, arg, ppre,
                                             rows_out=rows)
    second = fused_gathered_mlp_pool_backward(*args, grad, arg, ppre)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    dval = torch.where(ppre > 0, grad, 0.0)
    want = fs.reached_rows_sum(tuple(args[0].shape), args[1].cpu(),
                               dval.cpu(), arg.cpu(), rows[0].cpu())
    assert torch.equal(first[0].cpu(), want)


# the bf16 eval forms (precision.py's accelerator contract): kernel 3 equal
# to its plain version to the bit (exact products, the same f32 sums in
# neighbour order), the fused forms within 2^-6 of the plain output's
# largest value (their f32 sums run in the tensor cores' order, so an x1 or
# x2 can round to the other bf16 neighbour: a step or two at the output).
# (R, M, S, C1, C2, C3): kernels 5 and 8 on the wgmma eval design
# (fused_sa.eval_bf16_design) at S 64 (default's SA_0 and SA_1), 16 (four
# groups a tile; R·M = 512, and 133, no multiple of 4), 24 (one padded
# tile), 32 (two groups a tile; R·M = 65, odd), 128 (two tiles a group), 8
# (one padded tile), C3 384 and 512 (two warpgroups a block); on the parent
# design at C2 256 and C1 256. Kernel 9's eval form takes the same designs
# at the same widths (eval_bf16_design(..., bn=True))
BF16_FUSED = [(64, 128, 64, 128, 128, 128), (64, 32, 64, 128, 128, 256),
              (16, 32, 16, 128, 128, 256), (7, 19, 16, 128, 128, 128),
              (9, 11, 24, 128, 128, 128), (5, 13, 32, 128, 128, 256),
              (12, 16, 128, 128, 128, 256), (5, 13, 8, 128, 128, 128),
              (6, 16, 32, 128, 128, 384), (4, 16, 64, 128, 128, 512),
              (8, 16, 24, 128, 256, 128),
              (8, 8, 128, 256, 128, 384)]


def _bf16_fused_inputs(shape, seed):
    R, M, S, C1, C2, C3 = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device="cuda") * scale

    return (randn(R, M, S, C1).to(torch.bfloat16),
            randn(C1, C2, scale=C1 ** -0.5), randn(C2, scale=0.1),
            randn(C2, C3, scale=C2 ** -0.5), randn(C3, scale=0.1), g)


@pytest.mark.cuda
@pytest.mark.parametrize("round_w", [True, False])
@pytest.mark.parametrize("c", [256, 20])
def test_three_interpolate_bf16_on_cuda(round_w, c):
    """Kernel 3's bf16 form (both outputs, vector and scalar lanes) equal
    to its plain version on the same card tensors, counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpu3d_torch.ops.interpolate import (three_interpolate_bf16,
                                             three_interpolate_bf16_plain)
    rng = np.random.default_rng(3)
    xyz = torch.from_numpy(_cloud(rng, 2, 4096)).cuda()
    _, d2, idx = furthest_point_sample_with_3nn(xyz, 1024)
    w = torch.rand(2, 4096, 3, device="cuda")
    w = w / w.sum(-1, keepdim=True)
    feats = torch.randn(2, 1024, c, device="cuda").to(torch.bfloat16)
    _build.reset_launches()
    got = three_interpolate_bf16(feats, idx, w, round_w)
    assert _build.BF16_LAUNCHES["three_interpolate_bf16"] == 1
    want = three_interpolate_bf16_plain(feats, idx, w, round_w)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_sa_bf16", "fused_sa_slab_bf16",
                                  "fused_sa_slab_bn_bf16"])
@pytest.mark.parametrize("shape", BF16_FUSED, ids=str)
def test_fused_bf16_forms_on_cuda(name, shape):
    """Each fused bf16 form against its plain version on the card at the
    shapes of ``BF16_FUSED``, within 2^-6 of the largest value; two calls
    equal to the bit, each counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    R, M, S, C1, C2, C3 = shape
    x0, w1, b1, w2, b2, g = _bf16_fused_inputs(shape, 21)
    _build.reset_launches()
    again = None
    if name == "fused_sa_bf16":
        N = 256
        pre = torch.randn(R, N, C1, generator=g, device="cuda").to(
            torch.bfloat16)
        idx = torch.randint(0, N, (R, M, S), generator=g, device="cuda",
                            dtype=torch.int32)
        center = (0.5 * torch.randn(R, M, C1, generator=g, device="cuda")).to(
            torch.bfloat16)
        args = (pre, idx, center, w1, b1, w2, b2)
        got = fs.fused_gathered_mlp_pool_bf16(*args)
        again = fs.fused_gathered_mlp_pool_bf16(*args)
        want = fs.fused_gathered_mlp_pool_bf16_plain(*args)
    elif name == "fused_sa_slab_bf16":
        got = fs.fused_mlp_pool_bf16(x0, w1, b1, w2, b2)
        again = fs.fused_mlp_pool_bf16(x0, w1, b1, w2, b2)
        want = fs.fused_mlp_pool_bf16_plain(x0, w1, b1, w2, b2)
    else:
        gammas = [torch.rand(c, generator=g, device="cuda") + 0.5
                  for c in (C1, C2, C3)]
        betas = [0.2 * torch.randn(c, generator=g, device="cuda")
                 for c in (C1, C2, C3)]
        stats = [(0.2 * torch.randn(c, generator=g, device="cuda"),
                  torch.rand(c, generator=g, device="cuda") + 0.5)
                 for c in (C1, C2, C3)]
        got = fs.fused_bn_mlp_pool_bf16(x0, w1, w2, gammas, betas, stats)
        again = fs.fused_bn_mlp_pool_bf16(x0, w1, w2, gammas, betas, stats)
        packs = bn_packs([_bn_affine(m, v, gm, bt, 1e-5)[:2] for (m, v), gm,
                          bt in zip(stats, gammas, betas)])
        want = fs.fused_sa_slab_bn_bf16_plain(x0, packs, w1, w2)
    torch.cuda.synchronize()
    assert _build.BF16_LAUNCHES[name] == 2
    assert torch.equal(got, again)
    assert got.dtype == torch.bfloat16 and got.shape == (R, M, C3)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -6 * want.float().abs().max().item(), err


# (R, M, S): the tiles the wgmma eval design pads, each with a short last
# tile: S 8 and 24 (one padded tile a group), 16 (four groups a tile, R·M
# = 133), 32 (two, R·M = 65), 40 and 100 (a padded second tile)
BF16_PADDED = [(5, 13, 8), (9, 11, 24), (7, 19, 16), (5, 13, 32),
               (4, 9, 40), (3, 7, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather", "slab"])
@pytest.mark.parametrize("shape", BF16_PADDED, ids=str)
def test_fused_bf16_eval_pads_on_cuda(form, shape):
    """Kernels 5 and 8's bf16 eval forms where the rows that pad a tile
    would win the max if they took part: a0 in [1, 2] with W1 <= 0 and b1
    = 1, so that a zero row of a0 (a pad's) gives the largest a1 (1 in
    every channel) and, through W2 >= 0, the largest x2 in every column,
    some twice the slots' largest. Within 2^-6 of the plain output's
    largest value, so no pad reaches the output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    R, M, S = shape
    C = 128
    g = torch.Generator(device="cuda").manual_seed(S)

    def rand(*s):
        return torch.rand(*s, generator=g, device="cuda")

    w1, b1 = -rand(C, C) / 192, torch.ones(C, device="cuda")
    w2, b2 = rand(C, C) * C ** -0.5, torch.zeros(C, device="cuda")
    _build.reset_launches()
    if form == "gather":
        N = 64
        args = (rand(R, N, C).to(torch.bfloat16) + 1,
                torch.randint(0, N, (R, M, S), generator=g, device="cuda",
                              dtype=torch.int32),
                torch.zeros(R, M, C, device="cuda").to(torch.bfloat16),
                w1, b1, w2, b2)
        got = fs.fused_gathered_mlp_pool_bf16(*args)
        want = fs.fused_gathered_mlp_pool_bf16_plain(*args)
        name = "fused_sa_bf16"
    else:
        args = ((rand(R, M, S, C) + 1).to(torch.bfloat16), w1, b1, w2, b2)
        got = fs.fused_mlp_pool_bf16(*args)
        want = fs.fused_mlp_pool_bf16_plain(*args)
        name = "fused_sa_slab_bf16"
    torch.cuda.synchronize()
    assert _build.BF16_LAUNCHES[name] == 1
    # a pad's row: a0 = 0, a1 = 1, each column's x2 its W2 column sum
    pad = w2.to(torch.bfloat16).float().sum(0)
    assert (want.float() / pad).max().item() < 0.6
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -6 * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [
    (128, 128, 128), (128, 128, 256), (128, 128, 384), (128, 128, 512),
    (128, 128, 640), (128, 256, 128), (256, 128, 128), (256, 384, 256),
    (64, 128, 128)], ids=str)
def test_fused_bf16_eval_design_entry_on_cuda(widths):
    """The C entries' own routing agrees with its mirrors: the eval forms'
    design (``tpu3d_fused_sa_bf16_design`` for kernels 5 and 8,
    ``tpu3d_fused_sa_slab_bn_bf16_design`` for kernel 9,
    ``fused_sa.eval_bf16_design``) at each width, and the groups a tile
    packs (``tpu3d_fused_sa_bf16_groups``, ``fused_sa.eval_groups_per_tile``)
    at every S from 1 to 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import ctypes

    lib = _build.library("fused_sa")
    for bn, design in ((False, lib.tpu3d_fused_sa_bf16_design),
                       (True, lib.tpu3d_fused_sa_slab_bn_bf16_design)):
        design.argtypes, design.restype = [ctypes.c_int] * 3, ctypes.c_int
        assert bool(design(*widths)) == (
            fs.eval_bf16_design(*widths, bn=bn) == "wgmma")
    groups = lib.tpu3d_fused_sa_bf16_groups
    groups.argtypes, groups.restype = [ctypes.c_int], ctypes.c_int
    assert [groups(s) for s in range(1, 257)] == [
        fs.eval_groups_per_tile(s) for s in range(1, 257)]


# kernel 9's bf16 eval form (R, M, S, C1, C2, C3): both shipped BatchNorm
# levels at S 64 (the wgmma eval design; R·M 3200 and 800 units, neither a
# multiple of the 396 warpgroups a round of 132 blocks runs), S 16 (four
# groups a tile, R·M = 133), 24 (a padded tile), 32 (two groups a tile,
# R·M = 65), 128 (two tiles a group and a running max); the widened
# BatchNorm RCNN's 256 -> 384 -> 256 at S 128 (the parent design)
BN_EVAL = [(25, 128, 64, 128, 128, 128), (25, 32, 64, 128, 128, 256),
           (7, 19, 16, 128, 128, 128), (9, 11, 24, 128, 128, 256),
           (5, 13, 32, 128, 128, 128), (6, 9, 128, 128, 128, 256),
           (4, 8, 128, 256, 384, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BN_EVAL, ids=str)
def test_bn_eval_bf16_on_its_design_on_cuda(shape):
    """Kernel 9's bf16 eval form (``fused_bn_mlp_pool_bf16``) on the design
    its C entry names (``tpu3d_fused_sa_slab_bn_bf16_design``, held to
    ``fused_sa.eval_bf16_design(..., bn=True)``: wgmma at 128 -> 128 -> C3,
    the parent at the widened widths) against its plain version within
    2^-6 of the plain output's largest value (phase 18's BF16_FORM_BOUND),
    with folded muls of every sign and zero at each layer (a negative mul2
    pools the min of x2), and two calls equal to the bit, each counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import ctypes

    R, M, S, C1, C2, C3 = shape
    fn = _build.library("fused_sa").tpu3d_fused_sa_slab_bn_bf16_design
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    design = "wgmma" if fn(C1, C2, C3) else "parent"
    assert design == fs.eval_bf16_design(C1, C2, C3, bn=True)
    assert design == ("parent" if C1 == 256 else "wgmma")
    x0, w1, _, w2, _, g = _bf16_fused_inputs(shape, 7 + S)
    gammas, betas, stats = bn_eval_layers(g, (C1, C2, C3))
    packs = bn_packs([_bn_affine(m, v, gm, bt, 1e-5)[:2] for (m, v), gm, bt
                      in zip(stats, gammas, betas)])
    mul2 = packs[2 * (C1 + C2):2 * (C1 + C2) + C3]
    assert (mul2 < 0).any() and (mul2 > 0).any() and (mul2 == 0).any()
    _build.reset_launches()
    got = fs.fused_bn_mlp_pool_bf16(x0, w1, w2, gammas, betas, stats)
    again = fs.fused_bn_mlp_pool_bf16(x0, w1, w2, gammas, betas, stats)
    want = fs.fused_sa_slab_bn_bf16_plain(x0, packs, w1, w2)
    torch.cuda.synchronize()
    assert _build.BF16_LAUNCHES["fused_sa_slab_bn_bf16"] == 2
    assert sum(_build.LAUNCHES.values()) == 0
    assert torch.equal(got, again)
    assert got.dtype == torch.bfloat16 and got.shape == (R, M, C3)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -6 * want.float().abs().max().item(), err


# stats0 (R, M, S, C): P = R·M·S rows of 1, 5 and 100 (below one block's
# 128), 33 621 (263 blocks, a short last one), 35 035 (two blocks an SM on
# 132 SMs, a short last block), 67 983; widths 128, 256 and 1024
STATS0 = [(1, 1, 1, 128), (1, 1, 5, 256), (1, 4, 25, 1024),
          (3, 7, 1601, 128), (5, 7, 1001, 256), (17, 31, 129, 128),
          (5, 7, 1001, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", STATS0, ids=str)
def test_bn_stats0_streaming_on_cuda(dtype, shape):
    """stats0 in both forms (``fused_sa_bn_stats0`` and ``_bf16``) at P with
    a tail and below one block's share, C 128 / 256 / 1024: Σx² within
    1e-5 relative of the plain piece and Σx within 1e-5·√(n·Σx²) per
    channel (phase 19 (f)'s bounds); two calls equal to the bit; the
    workspace from ``tpu3d_fused_sa_bn_workspace`` holds one partial per
    block of the launch (min(ceil(P / 128), 2 per SM)), every one written,
    and the sums are those partials added in block order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    R, M, S, C = shape
    P = R * M * S
    g = torch.Generator(device="cuda").manual_seed(P + C)
    x = (torch.randn(R, M, S, C, generator=g, device="cuda") * 2 + 0.5).to(
        getattr(torch, dtype))
    name = fs._entry("fused_sa_bn_stats0", x.dtype)
    _build.reset_launches()
    got = _twice(lambda: fs.fused_sa_bn_stats(0, x))
    want = fs.fused_sa_bn_stats_plain(0, x)
    assert (_build.LAUNCHES | _build.BF16_LAUNCHES)[name] == 2
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    assert ((got[0] - want[0]).abs() <= 1e-5 * (P * want[1]).sqrt()).all()
    ws = fs._bn_workspace(0, P, C, 0, x.device, torch.float64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = min(-(-P // 128), 2 * sms)
    assert ws.numel() == blocks * 2 * C
    ws.fill_(float("nan"))
    sums = torch.empty(2, C, dtype=torch.float64, device="cuda")
    _build.launch(name, x.data_ptr(), P, C, ws.data_ptr(), sums.data_ptr())
    torch.cuda.synchronize()
    parts = ws.view(blocks, 2, C)
    assert not parts.isnan().any()
    acc = torch.zeros(2, C, dtype=torch.float64, device="cuda")
    for b in range(blocks):
        acc = acc + parts[b]
    assert torch.equal(sums, acc) and torch.equal(sums, got)


# the bf16 training forms (precision.py's training contract). The gather's
# and the interpolation's backward: equal to the CPU plain version to the
# bit (exact products, the same f32 sums in ascending key order). Kernels 6
# and 8: the forward within 2^-6 of the plain output's largest value and
# its argmax on the same slot but where an x2 rounds to the other bf16
# neighbour (the tensor cores sum in another order); the backward, routed by
# the kernel's own argmax, within 2^-6 of each plain gradient's largest
# value (a d_x1 can round to the other bf16 neighbour); every output
# repeats to the bit


def _close(got, want, tol=2.0 ** -6):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= tol * scale, (err, scale)


def _close_norm(got, want, tol=2.0 ** -6):
    """Within tol of want in the L2 norm: where every slot of a level is
    reached, some x1 lie on a bf16 rounding boundary next to 0, and the
    two sides' f32 sums in other orders put them on either side of the
    ReLU; each such flip moves a whole d_a1 value through W1 into a row of
    d_x0 and a column of dW1, past 2^-6 of d_pre's largest value on the
    full-spread 64 x 128 x 64 case, which the norm counts at its
    weight."""
    err = torch.linalg.vector_norm((got.float() - want.float()).flatten())
    scale = torch.linalg.vector_norm(want.float().flatten())
    assert err.item() <= tol * scale.item(), (err.item(), scale.item())


# the bf16 form's cases beside GROUP_BWD's: the demo's narrowest rows and
# a row wider than a warp's 256 channels that is no multiple of 32
GROUP_BWD_BF16 = dict(GROUP_BWD, **{"narrow": (4, 1024, 256, 32, 16),
                                    "wide odd": (3, 300, 40, 16, 131)})


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["RPN SA_1", "RCNN plain", "repeated pads",
                                  "odd width", "narrow", "wide odd"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_form", ["f32", "bf16", "strided"])
def test_group_points_bwd_bf16_on_cuda(case, out, grad_form):
    """The gather's bf16 backward (tpu3d's gather_mxu_bwd and onehot_bf16
    routes): two calls equal, equal to the CPU plain version bit for bit, in
    f32 or bf16 out, with the gradient in f32, in bf16 or as a channel slice
    of wider f32 rows (the kernel reads each as it lies, rounding as it
    loads), and autograd through group_points reaches it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpu3d_torch.ops.grouping import (group_points,
                                          group_points_backward_bf16,
                                          group_points_backward_bf16_plain)
    B, N, M, S, C = GROUP_BWD_BF16[case]
    dtype = getattr(torch, out)
    g = torch.Generator(device="cuda").manual_seed(len(case))
    idx = torch.randint(0, N, (B, M, S), generator=g, device="cuda",
                        dtype=torch.int32)
    if case == "repeated pads":
        idx[:, :, 3:] = idx[:, :, :1]
        idx[:, ::4] = 7
    wide = torch.randn(B, M, S, C + 6, generator=g, device="cuda")
    grad = {"f32": wide[..., :C].contiguous(),
            "bf16": wide[..., :C].to(torch.bfloat16),
            "strided": wide[..., 3:C + 3]}[grad_form]
    assert grad.is_contiguous() == (grad_form != "strided")
    _build.reset_launches()
    first = group_points_backward_bf16(grad, idx, N, dtype)
    second = group_points_backward_bf16(grad, idx, N, dtype)
    assert first.dtype == dtype and torch.equal(first, second)
    cpu = group_points_backward_bf16_plain(grad.cpu(), idx.cpu(), N, dtype)
    assert torch.equal(first.cpu(), cpu)
    feats = torch.randn(B, N, C, generator=g, device="cuda").to(dtype)
    feats.requires_grad_()
    (d,) = torch.autograd.grad(group_points(feats, idx, bf16_bwd=True),
                               feats, grad.to(dtype))
    assert torch.equal(d, group_points_backward_bf16(grad.to(dtype), idx, N,
                                                     dtype))
    assert _build.BF16_LAUNCHES["group_points_bwd_bf16"] == 4
    assert _build.LAUNCHES["group_points_bwd"] == 0
    # (m, s) rows that lie s-major: no uniform row stride, so it raises
    swapped = wide.transpose(1, 2).contiguous().transpose(1, 2)[..., :C]
    with pytest.raises(ValueError, match="uniform stride"):
        group_points_backward_bf16(swapped, idx, N, dtype)


def _interp_bwd_inputs(case):
    """(feats, idx, w, grad) of an ``INTERP_BWD`` case, as the f32 form's
    test makes them."""
    N, M, C = INTERP_BWD[case]
    B = 16
    g = torch.Generator(device="cuda").manual_seed(len(case))
    feats = torch.randn(B, N, C, generator=g, device="cuda")
    grad = torch.randn(B, M, C, generator=g, device="cuda")
    w = torch.rand(B, M, 3, generator=g, device="cuda")
    if case == "one triple":
        B = 2
        feats, grad, w = feats[:B], grad[:B].contiguous(), w[:B]
        idx = torch.tensor([5, 1, 2], dtype=torch.int32,
                           device="cuda").repeat(B, M, 1)
        idx[:, ::5, 1] = 5
    else:
        idx = torch.randint(0, N, (B, M, 3), generator=g, device="cuda",
                            dtype=torch.int32)
    return feats, idx, w.contiguous(), grad


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(INTERP_BWD))
def test_three_interpolate_bwd_bf16_on_cuda(case):
    """Kernel 7's bf16 form at the FP levels: two calls equal, equal to the
    CPU plain version bit for bit, and the backward of
    ``three_interpolate_bf16`` through it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpu3d_torch.ops.interpolate import (
        three_interpolate_backward_bf16, three_interpolate_backward_bf16_plain,
        three_interpolate_bf16)
    feats, idx, w, grad = _interp_bwd_inputs(case)
    feats = feats.to(torch.bfloat16)
    N = feats.shape[1]
    _build.reset_launches()
    first = three_interpolate_backward_bf16(idx, w, grad, N)
    second = three_interpolate_backward_bf16(idx, w, grad, N)
    assert first.dtype == torch.bfloat16 and torch.equal(first, second)
    cpu = three_interpolate_backward_bf16_plain(idx.cpu(), w.cpu(),
                                                grad.cpu(), N)
    assert torch.equal(first.cpu(), cpu)
    f = feats.clone().requires_grad_()
    out = three_interpolate_bf16(f, idx, w)
    (d,) = torch.autograd.grad(out, f, grad.to(out.dtype))
    assert torch.equal(d, three_interpolate_backward_bf16(
        idx, w, grad.to(out.dtype), N))
    assert _build.BF16_LAUNCHES["three_interpolate_bwd_bf16"] == 4
    assert _build.LAUNCHES["three_interpolate_bwd"] == 0


# (R, M, S, N, C1, C2, C3): default's RCNN SA_0 and SA_1 cut in rows, S 8
# to 128, 128 -> 128 -> 384 (the wgmma design with two warpgroups a block;
# the backward's parent walk), 128 -> 256 -> 128 and the widened RCNN's
# 256 -> 384 -> 256 (the gather form's forward on the parent design there,
# fused_sa.train_bf16_design; both backwards on the parent walk,
# fused_sa.backward_bf16_design), R·M = 133 groups, no multiple of the
# wgmma design's 396 warpgroups, and 99 and 65 groups, fewer than the
# backward's 132 blocks
BF16_TRAIN = [(64, 128, 64, 512, 128, 128, 128),
              (64, 32, 64, 128, 128, 128, 256),
              (16, 32, 16, 128, 128, 128, 256),
              (8, 16, 24, 128, 128, 256, 128),
              (19, 7, 32, 128, 128, 128, 128),
              (12, 16, 128, 256, 128, 128, 256),
              (4, 16, 128, 128, 256, 384, 256),
              (7, 19, 64, 128, 128, 128, 256),
              (6, 16, 32, 128, 128, 128, 384),
              (9, 11, 24, 128, 128, 128, 128),
              (5, 13, 8, 64, 128, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather", "slab"])
@pytest.mark.parametrize("shape", BF16_TRAIN, ids=str)
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("routing", ["forward", "full spread"])
def test_fused_bf16_training_forms_on_cuda(form, shape, ties, routing):
    """Kernels 6 (gather) and 8 (slab) in their bf16 training forms: the
    forward against the plain training forward, the routed backward against
    the plain backward on the kernel's own argmax and ppre (``routing``
    "forward", within 2^-6 of each largest value) or with every channel
    live at a slot drawn uniformly over S ("full spread", within 2^-6 in the
    L2 norm, ``_close_norm``), each output equal across two calls, and equal to the
    bit when the same gradient values come in f32 or as a strided view of
    wider f32 rows (the kernels read it as it lies); and an autograd step
    through the public op launches each form once. ``ties``: each group's
    slots from 3 on repeat its first three (the ball query's pads), so
    equal maxima sit at several slots and the first-argmax rule decides;
    the gather form's forward design is the one ``train_bf16_design``
    names, either form's backward design the one
    ``backward_bf16_design`` names (the parent walk at 128 -> 256 -> 128
    and the widened RCNN's 256 -> 384 -> 256, S 24 on both designs, S 128
    two segments of a group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import ctypes

    R, M, S, N, C1, C2, C3 = shape
    x0, w1, b1, w2, b2, g = _bf16_fused_inputs((R, M, S, C1, C2, C3), 31)
    if ties:
        x0[:, :, 3:] = x0[:, :, torch.arange(3, S) % 3]
    bwd_design = _build.library(
        "fused_sa_bwd_bf16").tpu3d_fused_sa_bwd_bf16_design
    bwd_design.argtypes = [ctypes.c_int] * 3
    assert bool(bwd_design(C1, C2, C3)) == (
        fs.backward_bf16_design(C1, C2, C3) == "mma")
    if form == "gather":
        design = _build.library("fused_sa").tpu3d_fused_sa_train_bf16_wgmma
        design.argtypes = [ctypes.c_int] * 3
        assert bool(design(C1, C2, C3)) == (
            fs.train_bf16_design(C1, C2, C3) == "wgmma")
        pre = torch.randn(R, N, C1, generator=g, device="cuda").to(
            torch.bfloat16)
        idx = torch.randint(0, N, (R, M, S), generator=g, device="cuda",
                            dtype=torch.int32)
        if ties:
            idx[:, :, 3:] = idx[:, :, torch.arange(3, S) % 3]
        center = (0.5 * torch.randn(R, M, C1, generator=g,
                                    device="cuda")).to(torch.bfloat16)
        args = (pre, idx, center, w1, b1, w2, b2)
        train, train_plain = (fs.fused_gathered_mlp_pool_bf16_train,
                              fs.fused_gathered_mlp_pool_bf16_train_plain)
        bwd, bwd_plain = (fs.fused_gathered_mlp_pool_bf16_backward,
                          fs.fused_gathered_mlp_pool_bf16_backward_plain)
        op, names = fs.fused_gathered_mlp_pool_bf16, ("fused_sa_train_bf16",
                                                      "fused_sa_bwd_bf16")
    else:
        args = (x0, w1, b1, w2, b2)
        train, train_plain = (fs.fused_mlp_pool_bf16_train,
                              fs.fused_mlp_pool_bf16_train_plain)
        bwd, bwd_plain = (fs.fused_mlp_pool_bf16_backward,
                          fs.fused_mlp_pool_bf16_backward_plain)
        op, names = fs.fused_mlp_pool_bf16, ("fused_sa_slab_train_bf16",
                                             "fused_sa_slab_bwd_bf16")
    _build.reset_launches()
    out, arg, ppre = train(*args)
    again = train(*args)
    for a, b in zip((out, arg, ppre), again):
        assert torch.equal(a, b)
    with torch.no_grad():
        w_out, w_arg, _ = train_plain(*args)
    assert out.dtype == torch.bfloat16 and arg.dtype == torch.int32
    _close(out, w_out)
    assert (arg != w_arg).float().mean().item() <= 1e-2
    grad = torch.randn(out.shape, generator=g, device="cuda").to(
        torch.bfloat16)
    if routing == "full spread":
        arg = torch.randint(0, S, arg.shape, generator=g, device="cuda",
                            dtype=torch.int32)
        ppre = torch.ones_like(ppre)
    wide = torch.zeros(R, M, C3 + 24, device="cuda")
    wide[..., 16:16 + C3] = grad.float()
    first = bwd(*args, grad, arg, ppre)
    second = bwd(*args, grad, arg, ppre)
    as_f32 = bwd(*args, grad.float(), arg, ppre)
    strided = bwd(*args, wide[..., 16:16 + C3], arg, ppre)
    want = bwd_plain(*args, grad, arg, ppre)
    for a, b, c, d, e in zip(first, second, as_f32, strided, want):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
        assert a.dtype == e.dtype and a.shape == e.shape
        (_close if routing == "forward" else _close_norm)(a, e)
    assert _build.BF16_LAUNCHES[names[0]] == 2
    assert _build.BF16_LAUNCHES[names[1]] == 4
    leaves = [a.detach().clone().requires_grad_() if a.is_floating_point()
              else a for a in args]
    _build.reset_launches()
    op(*leaves).float().sum().backward()
    assert _build.BF16_LAUNCHES[names[0]] == 1
    assert _build.BF16_LAUNCHES[names[1]] == 1
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_sa_bf16", "fused_sa_slab_bf16",
                                  "fused_sa_slab_bn_bf16",
                                  "fused_sa_train_bf16",
                                  "fused_sa_slab_train_bf16"])
def test_bf16_forms_take_bf16_weights_on_cuda(name):
    """Each bf16 form that lays its weights out for the kernel (three eval
    forms, two training forwards) gives the same bits from contiguous bf16
    (Cin, Cout) weights as from their values in f32, at square widths
    128 -> 128 -> 128 where a weight read untransposed would raise
    nothing, and agrees with its plain version within 2^-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    shape = (16, 32, 64, 128, 128, 128)
    R, M, S, C1, C2, C3 = shape
    x0, w1, b1, w2, b2, g = _bf16_fused_inputs(shape, 43)
    w1, w2 = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    pre = torch.randn(R, 256, C1, generator=g, device="cuda").to(
        torch.bfloat16)
    idx = torch.randint(0, 256, (R, M, S), generator=g, device="cuda",
                        dtype=torch.int32)
    center = (0.5 * torch.randn(R, M, C1, generator=g, device="cuda")).to(
        torch.bfloat16)
    gammas, betas, stats = bn_eval_layers(g, (C1, C2, C3))
    packs = bn_packs([_bn_affine(m, v, gm, bt, 1e-5)[:2] for (m, v), gm, bt
                      in zip(stats, gammas, betas)])
    forms = {
        "fused_sa_bf16": (
            lambda a, b: fs.fused_gathered_mlp_pool_bf16(
                pre, idx, center, a, b1, b, b2),
            lambda a, b: fs.fused_gathered_mlp_pool_bf16_plain(
                pre, idx, center, a, b1, b, b2)),
        "fused_sa_slab_bf16": (
            lambda a, b: fs.fused_mlp_pool_bf16(x0, a, b1, b, b2),
            lambda a, b: fs.fused_mlp_pool_bf16_plain(x0, a, b1, b, b2)),
        "fused_sa_slab_bn_bf16": (
            lambda a, b: fs.fused_bn_mlp_pool_bf16(x0, a, b, gammas, betas,
                                                   stats),
            lambda a, b: fs.fused_sa_slab_bn_bf16_plain(x0, packs, a, b)),
        "fused_sa_train_bf16": (
            lambda a, b: fs.fused_gathered_mlp_pool_bf16_train(
                pre, idx, center, a, b1, b, b2)[0],
            lambda a, b: fs.fused_gathered_mlp_pool_bf16_train_plain(
                pre, idx, center, a, b1, b, b2)[0]),
        "fused_sa_slab_train_bf16": (
            lambda a, b: fs.fused_mlp_pool_bf16_train(x0, a, b1, b, b2)[0],
            lambda a, b: fs.fused_mlp_pool_bf16_train_plain(
                x0, a, b1, b, b2)[0]),
    }
    run, plain = forms[name]
    assert w1.is_contiguous() and w2.is_contiguous()
    _build.reset_launches()
    with torch.no_grad():
        got = run(w1, w2)
        from_f32 = run(w1.float(), w2.float())
        want = plain(w1.float(), w2.float())
    torch.cuda.synchronize()
    assert _build.BF16_LAUNCHES[name] == 2
    assert torch.equal(got, from_f32)
    assert got.dtype == torch.bfloat16 and got.shape == (R, M, C3)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -6 * want.float().abs().max().item(), err


BN_BF16_ENTRIES = [f"{name}_bf16" for name in (
    "fused_sa_bn_stats0", "fused_sa_bn_stats1", "fused_sa_bn_stats2",
    "fused_sa_bn_final", "fused_sa_bn_wave1", "fused_sa_bn_wave2",
    "fused_sa_bn_apply")]


@pytest.mark.cuda
@pytest.mark.parametrize("name", BN_BF16_ENTRIES)
def test_bn_bf16_training_kernels_match_plain_on_cuda(name):
    """Kernel 9's seven bf16 training entries against their plain pieces on
    the card, at S 16/32/64, C3 128/256 and C1 128/256, on the same inputs
    (x0 in bf16; the plain pieces' statistics, bf16 x1 and x2, argmax and
    d_y1): x1, x2 and d_x0 (bf16) within one bf16 step of the plain
    piece's, off at all in at most 1 value in 1000 (products of bf16 values
    are exact in f32, their f32 sums run in another order, and a sum at a
    rounding boundary takes the other neighbour); the statistics passes'
    sums as the f32 form's; the final pass equal to the bit; d_y1, d_y0
    (f32) within 1e-4 of their largest value, the waves' reductions and
    weight gradients within 1e-3 (f32 sums of many exact products in
    another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _build.reset_launches()
    for s, c1, c3 in ((64, 128, 128), (16, 128, 256), (32, 256, 128),
                      (64, 128, 256)):
        x0, w1, _, w2, _, grad = _slab_inputs(64, 16, s, c3, seed=s + c3,
                                              c1=c1)
        g = torch.Generator(device="cuda").manual_seed(s + 2)
        gammas, betas, _, _ = _bn_params(g, c3, c1=c1)
        bn_pieces_check(name, x0.to(torch.bfloat16), w1, w2,
                        grad.to(torch.bfloat16), gammas, betas, g)
    assert _build.BF16_LAUNCHES[name] > 0
    assert sum(_build.LAUNCHES.values()) == 0


# kernel 9's bf16 products by design (fs.bn_train_bf16_design), as
# (R, M, S, C1, C2, C3): both shipped BatchNorm levels at S 64 (the
# tensor-core design); both again at S 24 over 697 groups, 16 728 slots
# (261 tiles of 64 and a tail of 24); the widened RCNN's 256 -> 384 -> 256
# (the SIMT design)
BN_DESIGN_CASES = [(16, 16, 64, 128, 128, 128), (16, 8, 64, 128, 128, 256),
                   (41, 17, 24, 128, 128, 128), (41, 17, 24, 128, 128, 256),
                   (4, 4, 16, 256, 384, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(fs.BN_BF16_PRODUCTS))
@pytest.mark.parametrize("case", BN_DESIGN_CASES, ids=str)
def test_bn_bf16_products_on_their_designs_on_cuda(name, case):
    """Kernel 9's four bf16 products on the design bn_train_bf16_design
    names (the tensor-core design at both shipped BatchNorm levels, with a
    tail tile and without; the SIMT design at the widened RCNN's widths)
    against their plain pieces, to phase 19 (f)'s bounds
    (``bn_pieces_check``: bf16 slabs within one bf16 step, off at all in at
    most 1 value in 1000; f32 slabs within 1e-4 of their largest value;
    the reductions and weight gradients within 1e-3), each called twice
    with the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    R, M, S, c1, c2, c3 = case
    want = "simt" if c1 == 256 else "wgmma"
    assert fs.bn_train_bf16_design(c1, c2, c3)[name] == want
    x0, w1, _, w2, _, grad = _slab_inputs(R, M, S, c3, seed=R + S + c3,
                                          c1=c1, c2=c2)
    g = torch.Generator(device="cuda").manual_seed(S + 3)
    gammas, betas, _, _ = _bn_params(g, c3, c1=c1, c2=c2)
    _build.reset_launches()
    bn_pieces_check(name, x0.to(torch.bfloat16), w1, w2,
                    grad.to(torch.bfloat16), gammas, betas, g, repeat=True)
    assert _build.BF16_LAUNCHES[name] == 2
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [
    (128, 128, 128), (128, 128, 256), (128, 128, 384), (128, 128, 512),
    (128, 256, 128), (256, 128, 128), (256, 384, 256), (256, 256, 384),
    (1024, 1024, 1024)], ids=str)
def test_bn_bf16_design_entry_on_cuda(widths):
    """The C entry's design of kernel 9's bf16 products
    (``tpu3d_fused_sa_bn_bf16_design``: bit i set where product i runs the
    tensor-core design) agrees with ``fused_sa.bn_train_bf16_design``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built there")
    import ctypes

    fn = _build.library("fused_sa_bn").tpu3d_fused_sa_bn_bf16_design
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    mask = fn(*widths)
    got = {name: "wgmma" if mask >> i & 1 else "simt"
           for i, name in enumerate(fs.BN_BF16_PRODUCTS)}
    assert got == fs.bn_train_bf16_design(*widths)


@pytest.mark.cuda
def test_bn_bf16_training_op_on_cuda():
    """Kernel 9's bf16 training form through its autograd Function: each
    of the seven bf16 entries launches once, no f32 kernel; the output, the
    statistics and every gradient equal the passes composed directly to the
    bit, and a second call gives the same bits; against the repaired plain
    form under autograd, which folds each layer into x·mul + add as the
    kernels do: the output off in at most 1 value in 100 and beyond one
    bf16 step of each value's own in at most 1 in 1000 (an x2 that the two
    sides' f32 sums round to the other neighbour moves its pre-activation
    by mul times x2's step, many of the output's own steps near 0), the
    statistics within 1e-5 of each one's largest value (both sum in f64),
    the weight, gamma and beta gradients within 2^-6 of theirs (such an x2
    may move an argmax, and with it a channel's gradient)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    x0, w1, _, w2, _, grad = _slab_inputs(32, 16, 64, 256, seed=7)
    g = torch.Generator(device="cuda").manual_seed(8)
    gammas, betas, _, _ = _bn_params(g, 256)
    x0, grad = x0.to(torch.bfloat16), grad.to(torch.bfloat16)

    def run(op):
        leaves = [t.detach().clone().requires_grad_() for t in
                  (x0, w1, w2, *gammas, *betas)]
        out, (means, vars_) = op(leaves[0], leaves[1], leaves[2],
                                 leaves[3:6], leaves[6:9])
        return (out.detach(), *means, *vars_,
                *torch.autograd.grad(out, leaves, grad))

    _build.reset_launches()
    ours = run(fs.fused_bn_mlp_pool_bf16_train)
    assert {k: v for k, v in _build.BF16_LAUNCHES.items() if v} == {
        name: 1 for name in BN_BF16_ENTRIES}
    assert sum(_build.LAUNCHES.values()) == 0
    assert all(torch.equal(a, b) for a, b in
               zip(ours, run(fs.fused_bn_mlp_pool_bf16_train)))
    with torch.no_grad():
        o, arg, at, means, vars_, saved = fs.fused_bn_mlp_pool_train(
            x0, w1, w2, gammas, betas)
        d = fs.fused_bn_mlp_pool_backward(x0, w1, w2, gammas, betas, means,
                                          vars_, o, arg, at, saved, grad)
    direct = (o, *means, *vars_, d[0], d[1], d[2], *d[3], *d[4])
    assert all(torch.equal(a, b) for a, b in zip(ours, direct))
    assert ours[0].dtype == ours[7].dtype == torch.bfloat16
    want = run(fs.fused_bn_mlp_pool_bf16_train_plain)
    a, b = ours[0].float(), want[0].float()
    d = (a - b).abs()
    own = _bf16_step(torch.maximum(a.abs(), b.abs()))
    assert (d > own).float().mean().item() <= 1e-3
    assert (d > 0).float().mean().item() <= 1e-2
    for a, b in zip(ours[1:7], want[1:7]):
        _near(a, b, b.abs().max().item(), 1e-5)
    for a, b in zip(ours[8:], want[8:]):
        _near(a, b, b.abs().max().item(), 2.0 ** -6)
