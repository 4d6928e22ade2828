"""The Python sides of two bf16 training kernels' Hopper designs, on the
CPU: which design kernel 6's bf16 training forward runs a level's widths
on (``fused_sa.train_bf16_design``, the C entry's ``takes`` mirrored), and
how the grouping gather's bf16 backward takes its gradient as autograd
hands it over (``grouping.grad_rows``; no cast or copy before the kernel).
The kernels themselves are held on the card by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from tpu3d_torch.config import cfg_from_file, fresh_cfg
from tpu3d_torch.ops import fused_sa, grouping
from tpu3d_torch.ops.fused_sa import kernels_take, sa_route, train_bf16_design

CONFIGS = ("default", "double", "quickstart", "smoke", "default_people")


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_gather_levels_take_the_wgmma_design(name):
    """Every RCNN level that a shipped config's train step fuses on the
    gather route (its widths 128 -> 128 -> 128 or 256) runs on the wgmma
    design."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    cfg = cfg_from_file(str(root / "configs" / f"{name}.yaml"), fresh_cfg())
    sa = cfg.RCNN.SA_CONFIG
    n, R = cfg.RCNN.NUM_POINTS, cfg.RCNN.ROI_PER_IMAGE
    gathered = 0
    for k, m in enumerate(sa.NPOINTS):
        if m == -1:
            break
        mlp = list(sa.MLPS[k])
        if sa_route((R, m, sa.NSAMPLE[k], mlp[0]), mlp, n,
                    cfg.RCNN.USE_BN) == "gather":
            gathered += 1
            assert train_bf16_design(*mlp) == "wgmma", (name, k, mlp)
        n = m
    assert gathered >= 1


@pytest.mark.parametrize("widths, design", [
    ((128, 128, 128), "wgmma"), ((128, 128, 256), "wgmma"),
    ((128, 128, 384), "wgmma"), ((128, 128, 512), "parent"),
    ((128, 256, 128), "parent"), ((256, 128, 128), "parent"),
    ((256, 384, 256), "parent"), ((256, 256, 384), "parent"),
    ((64, 128, 128), "parent")])
def test_train_bf16_design_by_width(widths, design):
    """The route is the shape: C1 = C2 = 128 (the products' depth the
    design is built for) and C3 up to 384 fit the wgmma design's shared
    memory (the layout's 1024-byte regions: W1, W2, per warpgroup a 64-row
    stage of C1, two center rows and a 64-row a1, the biases, the pooling
    state); the widened RCNN's widths and every other shape kernels_take
    admits keep the parent design."""
    assert train_bf16_design(*widths) == design
    if design == "wgmma":
        assert kernels_take(64, *widths, "gather", True)


def test_wgmma_design_smem():
    """The layout's bytes, of the 232448 a block may take: at RCNN SA_0
    (128 -> 128 -> 128) 174080 with three warpgroups, at SA_1 (-> 256)
    210944 with three; at C3 = 384 over with three and 209920 with two; at
    512 over with two."""
    smem = fused_sa.wgmma_smem
    assert smem(128, 128, 128, 3) == 174080
    assert smem(128, 128, 256, 3) == 210944 <= fused_sa.SMEM_MAX
    assert smem(128, 128, 384, 3) > fused_sa.SMEM_MAX
    assert smem(128, 128, 384, 2) == 209920 <= fused_sa.SMEM_MAX
    assert smem(128, 128, 512, 2) > fused_sa.SMEM_MAX


def test_grad_rows_reads_the_layout():
    """The row stride the bf16 backward's kernel reads: C for a contiguous
    gradient, the wider row's for a channel slice, any for dims of one;
    another layout raises."""
    g = torch.zeros(2, 3, 4, 10)
    assert grouping.grad_rows(g[..., :6].contiguous()) == 6
    assert grouping.grad_rows(g[..., 2:8]) == 10
    assert grouping.grad_rows(g[:1, :1, :1, 2:8]) == 6
    assert grouping.grad_rows(torch.zeros(2, 1, 1, 5)) == 5
    swapped = g.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="uniform stride"):
        grouping.grad_rows(swapped)
    with pytest.raises(ValueError, match="uniform stride"):
        grouping.grad_rows(g[..., ::2])


@pytest.mark.parametrize("form", ["f32", "bf16", "slice"])
def test_bf16_backward_takes_the_gradient_as_handed(monkeypatch, form):
    """Through autograd the bf16 backward is handed the gradient as it
    arrives (a channel slice of a concatenation's gradient stays a slice,
    bf16 stays bf16): no copy before the wrapper, which on the CPU gives
    the plain version's bits for it."""
    rng = np.random.default_rng(7)
    B, N, M, S, C = 2, 40, 6, 8, 5
    dtype = torch.bfloat16 if form == "bf16" else torch.float32
    feats = torch.from_numpy(rng.normal(size=(B, N, C)).astype(
        np.float32)).to(dtype).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, N, (B, M, S)).astype(np.int32))
    seen = []
    real = grouping.group_points_backward_bf16
    monkeypatch.setattr(grouping, "group_points_backward_bf16",
                        lambda g, *a: seen.append(g) or real(g, *a))
    out = grouping.group_points(feats, idx, bf16_bwd=True)
    if form == "slice":
        other = torch.ones(B, M, S, 3, requires_grad=True)
        out = torch.cat([other, out], -1)
    cot = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    (d,) = torch.autograd.grad(out, feats, cot.to(out.dtype))
    (g,) = seen
    assert g.dtype == dtype
    assert g.is_contiguous() == (form != "slice")
    if form == "slice":
        assert grouping.grad_rows(g) == C + 3
    want = grouping.group_points_backward_bf16_plain(
        cot.to(out.dtype)[..., -C:].contiguous(), idx, N, dtype)
    assert torch.equal(d, want)


# kernels 6 and 8's bf16 backward: the tensor-core design
# (csrc/fused_sa_bwd_mma.cuh) or the parent walk, by width
BWD_WIDTHS = [((128, 128, 128), "mma"), ((128, 128, 256), "mma"),
              ((128, 128, 384), "parent"), ((128, 128, 512), "parent"),
              ((128, 256, 128), "parent"), ((256, 128, 128), "parent"),
              ((256, 384, 256), "parent"), ((256, 256, 384), "parent")]


@pytest.mark.parametrize("widths, design", BWD_WIDTHS, ids=str)
def test_backward_bf16_design_by_width(widths, design):
    """The route is the shape: C1 = C2 = 128 (the products the design
    builds unrolled) and C3 128 or 256 (its layout in shared memory) take
    the tensor-core design; the widened RCNN's widths and every other
    shape kernels_take admits keep the parent walk, in both forms."""
    assert fused_sa.backward_bf16_design(*widths) == design
    for form in ("gather", "slab"):
        assert kernels_take(64, *widths, form, True)


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_fused_levels_take_the_mma_backward(name):
    """Every RCNN level that a shipped config's train step fuses, on the
    gather route (kernel 6) or the slab route (kernel 8), runs its bf16
    backward on the tensor-core design."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    cfg = cfg_from_file(str(root / "configs" / f"{name}.yaml"), fresh_cfg())
    sa = cfg.RCNN.SA_CONFIG
    n, R = cfg.RCNN.NUM_POINTS, cfg.RCNN.ROI_PER_IMAGE
    fused = 0
    for k, m in enumerate(sa.NPOINTS):
        if m == -1:
            break
        mlp = list(sa.MLPS[k])
        if sa_route((R, m, sa.NSAMPLE[k], mlp[0]), mlp, n,
                    cfg.RCNN.USE_BN) in ("gather", "slab"):
            fused += 1
            assert fused_sa.backward_bf16_design(*mlp) == "mma", (name, k)
        n = m
    assert fused >= 1


def test_mma_backward_smem():
    """The tensor-core design's layout, of the 232448 bytes a block may
    take (16 of them its own): at C3 = 128 229296 with dW2^T's f32 sums in
    shared memory; at 256 214960 with them in the block's workspace slice
    (346032 with them, over); at 384 over even without them."""
    smem = fused_sa.bwd_bf16_smem
    assert smem(128, True) == 229296
    assert smem(256, False) == 214960
    assert smem(128, True) + 16 <= fused_sa.SMEM_MAX
    assert smem(256, False) + 16 <= fused_sa.SMEM_MAX
    assert smem(256, True) == 346032 > fused_sa.SMEM_MAX
    assert smem(384, False) > fused_sa.SMEM_MAX


@pytest.mark.parametrize("form", ["gather", "slab"])
@pytest.mark.parametrize("handed", ["bf16", "slice"])
def test_bf16_fused_backward_takes_the_gradient_as_handed(monkeypatch, form,
                                                          handed):
    """Kernels 6 and 8's bf16 training Functions hand their backward the
    gradient as autograd delivers it: bf16, and a channel slice of a
    concatenation's gradient stays a slice (the kernels read it where it
    lies), no cast or copy before the wrapper; on the CPU the wrapper gives
    the plain version's bits for it."""
    rng = np.random.default_rng(11)
    R, N, M, S, C = 2, 40, 3, 8, 16

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32))

    weights = [arr(C, C, scale=C ** -0.5), arr(C, scale=0.1),
               arr(C, C, scale=C ** -0.5), arr(C, scale=0.1)]
    if form == "gather":
        lead = [arr(R, N, C).to(torch.bfloat16),
                torch.from_numpy(rng.integers(0, N, (R, M, S)).astype(
                    np.int32)),
                arr(R, M, C, scale=0.5).to(torch.bfloat16)]
        name, fn = ("fused_gathered_mlp_pool_bf16_backward",
                    fused_sa._FusedGatheredMLPPoolBF16)
        plain = fused_sa.fused_gathered_mlp_pool_bf16_backward_plain
        train = fused_sa.fused_gathered_mlp_pool_bf16_train_plain
    else:
        lead = [arr(R, M, S, C).to(torch.bfloat16)]
        name, fn = "fused_mlp_pool_bf16_backward", fused_sa._FusedMLPPoolBF16
        plain = fused_sa.fused_mlp_pool_bf16_backward_plain
        train = fused_sa.fused_mlp_pool_bf16_train_plain
    leaves = [t.requires_grad_() if t.is_floating_point() else t
              for t in lead + weights]
    seen = []
    real = getattr(fused_sa, name)
    monkeypatch.setattr(fused_sa, name,
                        lambda *a: seen.append(a[-3]) or real(*a))
    out = fn.apply(*leaves)
    if handed == "slice":
        out = torch.cat([torch.ones(R, M, 5, dtype=out.dtype,
                                    requires_grad=True), out], -1)
    cot = arr(*out.shape).to(out.dtype)
    diff = [t for t in leaves if t.requires_grad]
    got = torch.autograd.grad(out, diff, cot)
    (g,) = seen
    assert g.dtype == torch.bfloat16
    assert g.is_contiguous() == (handed == "bf16")
    with torch.no_grad():
        _, argmax, ppre = train(*lead, *weights)
    want = [t for t in plain(*lead, *weights, cot[..., -C:], argmax, ppre)
            if t is not None]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
