"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. The file imports
nothing of JAX or tpu3d, so it runs where the card is:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu3d_torch.ops import (furthest_point_sample_with_3nn, nearest_k,
                             three_interpolate)
from tpu3d_torch.ops import _build
from tpu3d_torch.ops.grouping import nearest_k_plain
from tpu3d_torch.ops.interpolate import three_interpolate_plain
from tpu3d_torch.ops.sampling import furthest_point_sample_with_3nn_plain


def _cloud(rng, b, n):
    return rng.uniform([-30, -1, 0], [30, 3, 70], size=(b, n, 3)).astype(
        np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fps3nn", "nearest_k", "three_interpolate"])
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
    else:
        feats = torch.randn(2, 1024, 256, device="cuda")
        idx = torch.randint(0, 1024, (2, 4096, 3), device="cuda",
                            dtype=torch.int32)
        w = torch.rand(2, 4096, 3, device="cuda")
        torch.testing.assert_close(three_interpolate(feats, idx, w),
                                   three_interpolate_plain(feats, idx, w),
                                   rtol=1e-6, atol=1e-6)
    assert _build.LAUNCHES[name] > 0
