"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. The file imports
nothing of JAX or tpu3d, so it runs where the card is:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu3d_torch.models.pointnet2 import PointnetSAModule
from tpu3d_torch.ops import (furthest_point_sample,
                             furthest_point_sample_with_3nn,
                             fused_bn_mlp_pool, fused_gathered_mlp_pool,
                             fused_mlp_pool, nearest_k, three_interpolate,
                             three_nn, three_nn_plain)
from tpu3d_torch.ops import _build
from tpu3d_torch.ops.fused_sa import (
    bn_packs, fused_gathered_mlp_pool_backward,
    fused_gathered_mlp_pool_backward_plain, fused_gathered_mlp_pool_plain,
    fused_gathered_mlp_pool_train, fused_gathered_mlp_pool_train_plain,
    fused_mlp_pool_backward, fused_mlp_pool_backward_plain,
    fused_mlp_pool_train, fused_mlp_pool_train_plain, fused_sa_slab_plain)
from tpu3d_torch.ops.grouping import nearest_k_plain
from tpu3d_torch.ops.interpolate import (three_interpolate_backward,
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
        got = nearest_k(centers, xyz, 32, max_radius=2.0)
        ref = nearest_k_plain(centers, xyz, 32, max_radius=2.0)
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
        # atomics add in another order: within 1e-5 of the largest value
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


def _slab_inputs(r, m, s, c3, seed):
    """A grouped slab whose groups repeat their first h slots (h random per
    group, as pooled rows and the ball query's pad repeat points), weights
    and an output gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x0 = torch.randn(r, m, s, 128, generator=g, device="cuda")
    h = torch.randint(1, s + 1, (r, m, 1), generator=g, device="cuda")
    slots = torch.arange(s, device="cuda") % h
    x0 = torch.gather(x0, 2, slots[..., None].expand(-1, -1, -1, 128))
    return (x0.contiguous(),
            torch.randn(128, 128, generator=g, device="cuda") / 128 ** 0.5,
            torch.randn(128, generator=g, device="cuda") * 0.1,
            torch.randn(128, c3, generator=g, device="cuda") / 128 ** 0.5,
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
            affines = [(1 + 0.2 * torch.randn(c, generator=g, device="cuda"),
                        0.2 * torch.randn(c, generator=g, device="cuda"))
                       for c in (128, 128, c3)]
            want = fused_sa_slab_plain(x0, bn_packs(affines), w1, w2)
            torch.testing.assert_close(
                fused_bn_mlp_pool(x0, w1, w2, affines), want, rtol=0,
                atol=1e-4 * want.abs().max().item())
    assert _build.LAUNCHES[name] > 0


@pytest.mark.cuda
def test_bn_chain_training_raises_on_cuda():
    """The BatchNorm chain's training kernels are not ported: an RCNN level
    with BatchNorm in training, or a gradient through the eval kernel,
    raises on the card instead of running plain torch; at eval it launches
    the slab kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sa = PointnetSAModule(16, 0.8, 64, (128, 128, 256), 125, bn=True,
                          device="cuda")
    xyz = torch.rand(4, 64, 3, device="cuda")
    feats = torch.randn(4, 64, 125, device="cuda")
    with pytest.raises(NotImplementedError, match="kernel 9"):
        sa(xyz, feats, train=True)
    with pytest.raises(NotImplementedError, match="training kernels"):
        sa(xyz, feats)
    _build.reset_launches()
    with torch.no_grad():
        _, out = sa(xyz, feats)
    assert out.shape == (4, 16, 256)
    assert _build.LAUNCHES["fused_sa_slab_bn"] == 1
