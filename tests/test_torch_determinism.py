"""The fixed-order sums that make the train step repeat to the bit, on the
CPU.

- ``group_points``' backward (its own autograd Function; on the card
  ``csrc/group_points_bwd.cu``) adds each point's slots in ascending
  (m·S + s) order, as ``torch.gather``'s backward does on the CPU: equal
  to it bit for bit, in float32 and float64, with repeated pads.
- The gather-form SA backward's routed plain version sums each point's
  reached rows in ascending (group·S + slot) order (``reached_rows_sum``,
  the backward kernel's order): its d_pre equals that sum of its own rows
  bit for bit, and the dense plain backward within 1e-6 of the largest
  value (float32 sums in another order).
- The probe (``tools/probe_determinism.py``) finds two smoke.yaml train
  steps on the CPU equal in every gradient, parameter, moment and
  statistic.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tpu3d_torch.ops.fused_sa import (
    _routed_core, fused_gathered_mlp_pool_backward_plain,
    fused_gathered_mlp_pool_backward_routed_plain,
    fused_gathered_mlp_pool_train_plain, reached_rows_sum, reached_slots)
from tpu3d_torch.ops.grouping import group_points, group_points_backward
from tpu3d_torch.tools import probe_determinism


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_group_points_backward_is_gathers(dtype):
    g = torch.Generator().manual_seed(1)
    B, N, M, S, C = 3, 64, 40, 16, 24
    idx = torch.randint(0, N, (B, M, S), generator=g, dtype=torch.int32)
    idx[:, :, 5:] = idx[:, :, :1]  # short groups padded with their first hit
    idx[:, ::3] = 7  # one point in many groups
    feats = torch.randn(B, N, C, generator=g, dtype=dtype,
                        requires_grad=True)
    grad = torch.randn(B, M, S, C, generator=g, dtype=dtype)
    out = group_points(feats, idx)
    (ours,) = torch.autograd.grad(out, feats, grad)
    flat = idx.reshape(B, M * S).long()[..., None].expand(-1, -1, C)
    ref_out = torch.gather(feats, 1, flat).reshape(B, M, S, C)
    (ref,) = torch.autograd.grad(ref_out, feats, grad)
    assert torch.equal(out, ref_out)
    assert torch.equal(ours, ref)
    assert torch.equal(group_points_backward(grad, idx, N), ref)
    with torch.no_grad():
        assert torch.equal(group_points(feats, idx), ref_out)


@pytest.mark.parametrize("routing", ["seeded", "repeated"])
def test_routed_backward_sums_in_key_order(routing):
    g = torch.Generator().manual_seed(2)
    R, N, M, S, C1, C2, C3 = 3, 96, 12, 16, 128, 128, 128
    idx = torch.randint(0, N if routing == "seeded" else 8, (R, M, S),
                        generator=g, dtype=torch.int32)
    pre = torch.randn(R, N, C1, generator=g)
    center = torch.randn(R, M, C1, generator=g)
    w1 = torch.randn(C1, C2, generator=g) * C1 ** -0.5
    b1 = torch.randn(C2, generator=g) * 0.1
    w2 = torch.randn(C2, C3, generator=g) * C2 ** -0.5
    b2 = torch.randn(C3, generator=g) * 0.1
    args = (pre, idx, center, w1, b1, w2, b2)
    _, arg, ppre = fused_gathered_mlp_pool_train_plain(*args)
    grad = torch.randn(R, M, C3, generator=g)
    routed = fused_gathered_mlp_pool_backward_routed_plain(*args, grad, arg,
                                                           ppre)
    dense = fused_gathered_mlp_pool_backward_plain(*args, grad)
    for a, b in zip(routed, dense):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()
    # the reached rows' d_x0 in the kernel's order, summed as it sums them
    dval = torch.where(ppre > 0, grad, 0.0)
    g_row, s_row = reached_slots(dval, arg, S).nonzero(as_tuple=True)
    point = idx.reshape(R * M, S)[g_row, s_row].long()
    x0 = pre[g_row // M, point] - center.reshape(R * M, C1)[g_row]
    rows = _routed_core(x0, g_row, s_row, w1, b1, w2, dval, arg, S)[0]
    assert torch.equal(reached_rows_sum(pre.shape, idx, dval, arg, rows),
                       routed[0])
    assert np.unique(point.numpy(), return_counts=True)[1].max() > 1


def test_probe_finds_the_cpu_step_repeats():
    cfg = Path(__file__).resolve().parents[1] / "configs" / "smoke.yaml"
    out = probe_determinism.main(["--cfg_file", str(cfg),
                                  "--batch", "2", "--device", "cpu"])
    assert out["tensors"]["grads"] > 100
    assert out["differ"] == {"grads": {}, "params": {}, "moments": {},
                             "buffers": {}}
    assert out["first_output_grads_differing"] == []
