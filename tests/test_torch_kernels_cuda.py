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


def bn_pieces_check(name, x0, w1, w2, grad, gammas, betas, g):
    """Kernel ``name`` of the BatchNorm chain's training form against its
    plain piece on the same inputs: the f32 form on an f32 x0, the bf16
    entries (``*_bf16``) on a bf16 x0; the plain pieces' own statistics,
    x1, x2, argmax and d_y1 (see test_bn_train_kernels_match_plain_on_cuda
    and test_bn_bf16_training_kernels_match_plain_on_cuda for the
    bounds)."""
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
            got = fs.fused_sa_bn_stats(depth, *args)
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
        for a, b in zip(fs.fused_sa_bn_final(x2, m2, a2), (out, arg, at)):
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
        got = fs.fused_sa_bn_wave1(x2, x1, pk, w2, dval, arg)
        want = fs.fused_sa_bn_wave1_plain(x2, x1, pk, w2, dval, arg)
    elif base == "fused_sa_bn_wave2":
        got = fs.fused_sa_bn_wave2(d_y1, x1, x0, pk, w1)
        want = fs.fused_sa_bn_wave2_plain(d_y1, x1, x0, pk, w1)
    else:
        _, _, d_y0 = fs.fused_sa_bn_wave2_plain(d_y1, x1, x0, pk, w1)
        want = [fs.fused_sa_bn_apply_plain(d_y0, x0, pk)]
        got = [fs.fused_sa_bn_apply(d_y0.clone(), x0, pk)]
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
# x2 can round to the other bf16 neighbour: a step or two at the output)
BF16_FUSED = [(64, 128, 64, 128, 128, 128), (64, 32, 64, 128, 128, 256),
              (16, 32, 16, 128, 128, 256), (8, 16, 24, 128, 256, 128),
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
    """Each fused bf16 form against its plain version on the card: S 64
    (default's SA_0 and SA_1), 16 (smoke), 24 (a masked chunk tail) and
    128 (two chunks), within 2^-6 of the largest value, counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    R, M, S, C1, C2, C3 = shape
    x0, w1, b1, w2, b2, g = _bf16_fused_inputs(shape, 21)
    _build.reset_launches()
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
        want = fs.fused_gathered_mlp_pool_bf16_plain(*args)
    elif name == "fused_sa_slab_bf16":
        got = fs.fused_mlp_pool_bf16(x0, w1, b1, w2, b2)
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
        packs = bn_packs([_bn_affine(m, v, gm, bt, 1e-5)[:2] for (m, v), gm,
                          bt in zip(stats, gammas, betas)])
        want = fs.fused_sa_slab_bn_bf16_plain(x0, packs, w1, w2)
    torch.cuda.synchronize()
    assert _build.BF16_LAUNCHES[name] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (R, M, C3)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -6 * want.float().abs().max().item(), err


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["RPN SA_1", "RCNN plain", "repeated pads",
                                  "odd width"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_group_points_bwd_bf16_on_cuda(case, out):
    """The gather's bf16 backward (tpu3d's gather_mxu_bwd and onehot_bf16
    routes): two calls equal, equal to the CPU plain version bit for bit, in
    f32 or bf16 out, and autograd through group_points reaches it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from tpu3d_torch.ops.grouping import (group_points,
                                          group_points_backward_bf16,
                                          group_points_backward_bf16_plain)
    B, N, M, S, C = GROUP_BWD[case]
    dtype = getattr(torch, out)
    g = torch.Generator(device="cuda").manual_seed(len(case))
    idx = torch.randint(0, N, (B, M, S), generator=g, device="cuda",
                        dtype=torch.int32)
    if case == "repeated pads":
        idx[:, :, 3:] = idx[:, :, :1]
        idx[:, ::4] = 7
    grad = torch.randn(B, M, S, C, generator=g, device="cuda")
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


BF16_TRAIN = [(64, 128, 64, 512, 128, 128, 128),
              (64, 32, 64, 128, 128, 128, 256),
              (16, 32, 16, 128, 128, 128, 256),
              (8, 16, 24, 128, 128, 256, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather", "slab"])
@pytest.mark.parametrize("shape", BF16_TRAIN, ids=str)
def test_fused_bf16_training_forms_on_cuda(form, shape):
    """Kernels 6 (gather) and 8 (slab) in their bf16 training forms: the
    forward against the plain training forward, the routed backward against
    the plain backward on the kernel's own argmax and ppre, each output
    equal across two calls; and an autograd step through the public op
    launches each form once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    R, M, S, N, C1, C2, C3 = shape
    x0, w1, b1, w2, b2, g = _bf16_fused_inputs((R, M, S, C1, C2, C3), 31)
    if form == "gather":
        pre = torch.randn(R, N, C1, generator=g, device="cuda").to(
            torch.bfloat16)
        idx = torch.randint(0, N, (R, M, S), generator=g, device="cuda",
                            dtype=torch.int32)
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
    first = bwd(*args, grad, arg, ppre)
    second = bwd(*args, grad, arg, ppre)
    want = bwd_plain(*args, grad, arg, ppre)
    for a, b, c in zip(first, second, want):
        assert torch.equal(a, b)
        assert a.dtype == c.dtype and a.shape == c.shape
        _close(a, c)
    assert _build.BF16_LAUNCHES[names[0]] == 2
    assert _build.BF16_LAUNCHES[names[1]] == 2
    leaves = [a.detach().clone().requires_grad_() if a.is_floating_point()
              else a for a in args]
    _build.reset_launches()
    op(*leaves).float().sum().backward()
    assert _build.BF16_LAUNCHES[names[0]] == 1
    assert _build.BF16_LAUNCHES[names[1]] == 1
    assert sum(_build.LAUNCHES.values()) == 0


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
