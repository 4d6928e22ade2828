"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. The file imports
nothing of JAX or tpu3d, so it runs where the card is:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu3d_torch.ops import (furthest_point_sample,
                             furthest_point_sample_with_3nn,
                             fused_gathered_mlp_pool, nearest_k,
                             three_interpolate)
from tpu3d_torch.ops import _build
from tpu3d_torch.ops.fused_sa import (
    fused_gathered_mlp_pool_backward, fused_gathered_mlp_pool_backward_plain,
    fused_gathered_mlp_pool_plain, fused_gathered_mlp_pool_train,
    fused_gathered_mlp_pool_train_plain)
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
