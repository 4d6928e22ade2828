"""The slab form's packed forward launch on the CPU: the group count each
block takes (``ops/fused_sa.py::slab_groups_per_block``) and a plain
emulation of the packed tile's pooling, against the plain training form.

At S 16 and 32 a block of ``csrc/fused_sa.cu``'s shipped kernel takes G
consecutive (row, center) groups, G·S rows spread over 8 warps of TM = G·S
/ 8 rows, so that each warp's rows lie in one group. The emulation takes the
plain chain's layer-2 pre-activations of every slot and pools them as the
kernel does: each warp the max of ReLU over its rows and the first row that
reaches it, then each group over its own 8 / G warps, the lowest warp first
on a tie; a tail block's missing groups are computed on zero rows and
written nowhere. It must equal ``fused_mlp_pool_train_plain``'s pooled
output, first argmax and ppre bit for bit (tolerance 0: the max picks a
value, it sums nothing), at S 8, 16, 32 and 64, at every G the kernel takes
there and with group counts that leave a tail block. The CUDA kernels run
only on the card (``test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

from tpu3d_torch.ops import fused_sa as fs
from tpu3d_torch.ops.fused_sa import (SLAB_PACK_MIN_GROUPS, SLAB_ROWS,
                                      fused_mlp_pool_train_plain,
                                      shipped_shape, slab_groups_per_block)

WARPS = 8  # fused_sa.cu's kWarps


def c_entry_takes(G, R, S, C1, C2, C3):
    """The C entries' check of G (fused_sa.cu::dispatch): 1 anywhere; 64 /
    S on the shipped kernel's slab shapes with S 16 or 32."""
    return G == 1 or (S in (16, 32) and G * S == SLAB_ROWS
                      and shipped_shape(True, R, S, C1, C2, C3))


def kernel_groups(S):
    """Every G the kernel takes at S on the shipped widths."""
    return [G for G in (1, 2, 4) if c_entry_takes(G, 64, S, 128, 128, 256)]


def packed_pool(x2, G):
    """The packed tile's pooling of pre-activations x2 (groups, S, C3) with
    G groups per block -> (out, argmax, ppre), each (groups, C3)."""
    n, S, C3 = x2.shape
    blocks = math.ceil(n / G)
    pad = x2.new_zeros(blocks * G - n, S, C3)  # a tail block's zero groups
    rows = torch.cat([x2, pad]).view(blocks, WARPS, G * S // WARPS, C3)
    TM = rows.shape[2]
    act = torch.relu(rows)
    # each warp: the max over its rows (from 0, as ReLU output) and the
    # first row that reaches it, as a slot of the warp's group
    mx = act.amax(dim=2).clamp(min=0.0)
    first = torch.where(act == mx[:, :, None], torch.arange(TM)[:, None],
                        TM).amin(dim=2)
    slot = (torch.arange(WARPS) * TM % S)[:, None] + first
    pre = torch.gather(rows, 2, first[:, :, None]).squeeze(2)
    # each group over its own warps, the lowest warp on a tie
    wg = WARPS // G
    mx, slot, pre = (t.view(blocks, G, wg, C3) for t in (mx, slot, pre))
    out = mx.amax(dim=2)
    w = torch.where(mx == out[:, :, None], torch.arange(wg)[:, None],
                    wg).amin(dim=2)[:, :, None]
    argmax = torch.gather(slot, 2, w).squeeze(2)
    ppre = torch.gather(pre, 2, w).squeeze(2)
    return (t.reshape(blocks * G, C3)[:n] for t in (out, argmax, ppre))


def _slab(seed, R, M, S, C1=128, C2=128, C3=256, repeat=True):
    """Seeded slab and weights; with ``repeat`` most groups repeat a few
    distinct slots (as pooled ROIs with few points do), so tied maxima at
    several slots are common."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(R, M, S, C1)).astype(np.float32)
    if repeat:
        h = rng.integers(1, S + 1, size=(R, M))
        x0 = np.take_along_axis(x0, (np.arange(S) % h[..., None])[
            ..., None], axis=2)
    w1 = (rng.normal(size=(C1, C2)) / C1 ** 0.5).astype(np.float32)
    w2 = (rng.normal(size=(C2, C3)) / C2 ** 0.5).astype(np.float32)
    b1 = (0.1 * rng.normal(size=C2)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=C3)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(t))
            for t in (x0, w1, b1, w2, b2)]


@pytest.mark.parametrize("S", [8, 16, 32, 64])
@pytest.mark.parametrize("R,M", [(5, 7), (12, 16), (1, 3)])
def test_packed_pool_equals_plain_training_form(S, R, M):
    """The packed tile's pooling at every G the kernel takes at S (and G
    = 64 / S beside it: the rule is the same for any G dividing 8), on
    group counts 35, 192 and 3 (tail blocks at G 2 and 4 but for 192),
    equals the plain training form's out, first argmax and ppre to the
    bit, each slot in range."""
    x0, w1, b1, w2, b2 = _slab(S + R, R, M, S)
    out, arg, ppre = fused_mlp_pool_train_plain(x0, w1, b1, w2, b2)
    x2 = fs._nobn_slab_chain(x0, w1, b1, w2, b2).reshape(R * M, S, -1)
    for G in sorted({*kernel_groups(S), max(1, min(WARPS, SLAB_ROWS // S))}):
        got = [t.view(R, M, -1) for t in packed_pool(x2, G)]
        assert torch.equal(got[0], out), G
        assert torch.equal(got[1].int(), arg), G
        assert torch.equal(got[2], ppre), G
        assert int(got[1].min()) >= 0 and int(got[1].max()) < S


def test_ties_go_to_the_lowest_slot():
    """Groups whose slots are one row repeated: every slot ties, and the
    packed pooling gives slot 0, across warps and across groups."""
    x0, w1, b1, w2, b2 = _slab(0, 3, 5, 16, repeat=False)
    x0[:] = x0[:, :, :1]
    x2 = fs._nobn_slab_chain(x0, w1, b1, w2, b2).reshape(15, 16, -1)
    for G in (1, 2, 4):
        _, arg, _ = packed_pool(x2, G)
        assert int(arg.abs().sum()) == 0


@pytest.mark.parametrize("S", [8, 16, 24, 32, 64, 128])
def test_group_count_is_one_the_entries_take(S):
    """slab_groups_per_block over group counts 1 to 10^5 and the widths
    tpu3d fuses: a G the C entries take, 64 / S at S 16 and 32 on the
    shipped kernel from SLAB_PACK_MIN_GROUPS[S] groups on, else 1."""
    for C1, C2, C3 in ((128, 128, 256), (128, 128, 128), (256, 128, 256),
                       (384, 128, 256), (128, 256, 256), (128, 128, 384)):
        for R in (1, 2, 7, 31, 32, 128, 999, 6000):
            for M in (1, 16, 17):
                G = slab_groups_per_block(R, M, S, C1, C2, C3)
                assert c_entry_takes(G, R, S, C1, C2, C3)
                packs = (S in (16, 32)
                         and R * M >= SLAB_PACK_MIN_GROUPS[S]
                         and shipped_shape(True, R, S, C1, C2, C3))
                assert G == (SLAB_ROWS // S if packs else 1)


def test_group_counts_at_the_shipped_levels():
    """The slab levels the shipped configs launch: smoke.yaml's SA_1 (S 16;
    eval 2 x 64 ROIs x 16 centers = 2048 groups, train 2 x 16 x 16 = 512:
    4 each), quickstart.yaml's (S 64: always 1), an S 32 level of 4096
    groups (2), and the measured switch: 256 groups at S 16 and 384 at S
    32 one group per block (1), 384 at S 16 packed (4)."""
    assert slab_groups_per_block(128, 16, 16, 128, 128, 256) == 4
    assert slab_groups_per_block(32, 16, 16, 128, 128, 256) == 4
    assert slab_groups_per_block(8, 16, 16, 128, 128, 256) == 1
    for R in (512, 128):
        assert slab_groups_per_block(R, 16, 64, 128, 128, 256) == 1
    assert slab_groups_per_block(256, 16, 32, 128, 128, 256) == 2
    assert slab_groups_per_block(16, 16, 16, 128, 128, 256) == 1
    assert slab_groups_per_block(24, 16, 16, 128, 128, 256) == 4
    assert slab_groups_per_block(24, 16, 32, 128, 128, 256) == 1
