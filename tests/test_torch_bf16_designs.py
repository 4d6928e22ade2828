"""The Python sides of the bf16 kernels' Hopper designs, on the CPU: which
design kernel 6's bf16 training forward runs a level's widths on
(``fused_sa.train_bf16_design``, the C entry's ``takes`` mirrored), which
design the bf16 eval forms of kernels 5 and 8 and of kernel 9 run
(``fused_sa.eval_bf16_design``) and how that design packs short groups
into a tile and pools them (``fused_sa.eval_groups_per_tile``, its walk
emulated in numpy; under BatchNorm by layer 2's signs), and how
the grouping gather's bf16 backward takes its gradient as autograd hands it
over (``grouping.grad_rows``; no cast or copy before the kernel), and which
design each of kernel 9's bf16 products runs a BatchNorm level on
(``fused_sa.bn_train_bf16_design``, ``bn_wgmma_smem``) with the weight
operand it reads. The
kernels themselves are held on the card by ``test_torch_kernels_cuda.py``
and ``chip_smoke.py``."""

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


@pytest.mark.parametrize("widths, design", [
    ((128, 128, 128), "wgmma"), ((128, 128, 256), "wgmma"),
    ((128, 128, 384), "wgmma"), ((128, 128, 512), "wgmma"),
    ((128, 128, 640), "parent"), ((128, 256, 128), "parent"),
    ((256, 128, 128), "parent"), ((256, 384, 256), "parent"),
    ((256, 256, 384), "parent"), ((64, 128, 128), "parent")], ids=str)
def test_eval_bf16_design_by_width(widths, design):
    """Kernels 5 and 8's bf16 eval forms: C1 = C2 = 128 (the products'
    depth the design is built for, layer 1's columns one accumulator) and
    C3 up to 512 fit the wgmma eval design's shared memory; the widened
    RCNN's widths and every other shape kernels_take admits keep the
    parent design, in both forms."""
    assert fused_sa.eval_bf16_design(*widths) == design
    for form in ("gather", "slab"):
        assert kernels_take(64, *widths, form, False)
        assert fused_sa.bf16_kernels_take(64, *widths)


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_eval_levels_take_the_wgmma_design(name):
    """Every RCNN level that a shipped config's eval fuses without
    BatchNorm, on the gather route (kernel 5) or the slab route (kernel 8),
    runs its bf16 eval form on the wgmma design; quickstart and smoke fuse
    one level on each route."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    cfg = cfg_from_file(str(root / "configs" / f"{name}.yaml"), fresh_cfg())
    sa = cfg.RCNN.SA_CONFIG
    n, R = cfg.RCNN.NUM_POINTS, 2 * cfg.TEST.RPN_POST_NMS_TOP_N
    routes = []
    for k, m in enumerate(sa.NPOINTS):
        if m == -1:
            break
        mlp = list(sa.MLPS[k])
        route = sa_route((R, m, sa.NSAMPLE[k], mlp[0]), mlp, n,
                         cfg.RCNN.USE_BN)
        if route in ("gather", "slab"):
            routes.append(route)
            assert fused_sa.eval_bf16_design(*mlp) == "wgmma", (name, k)
        n = m
    want = (["gather", "slab"] if name in ("quickstart", "smoke")
            else ["gather", "gather"])
    assert routes == want


def test_eval_wgmma_design_smem():
    """The eval layout's bytes (a1 in registers), of the 232448 a block may
    take: at RCNN SA_0 (128 -> 128 -> 128) 128000 with three warpgroups, at
    SA_1 (-> 256) 164864 with three, at C3 = 384 201728 with three; at 512
    over with three and 214016 with two; at 640 over with two."""
    smem = fused_sa.eval_wgmma_smem
    assert smem(128, 128, 128, 3) == 128000
    assert smem(128, 128, 256, 3) == 164864
    assert smem(128, 128, 384, 3) == 201728 <= fused_sa.SMEM_MAX
    assert smem(128, 128, 512, 3) > fused_sa.SMEM_MAX
    assert smem(128, 128, 512, 2) == 214016 <= fused_sa.SMEM_MAX
    assert smem(128, 128, 640, 2) > fused_sa.SMEM_MAX


@pytest.mark.parametrize("widths, design", [
    ((128, 128, 128), "wgmma"), ((128, 128, 256), "wgmma"),
    ((128, 128, 384), "wgmma"), ((128, 128, 512), "wgmma"),
    ((128, 128, 640), "parent"), ((256, 384, 256), "parent"),
    ((128, 256, 128), "parent"), ((64, 128, 128), "parent")], ids=str)
def test_bn_eval_bf16_design_by_width(widths, design):
    """Kernel 9's bf16 eval form (``eval_bf16_design(..., bn=True)``): the
    same widths as kernels 5 and 8's take the wgmma eval design, both
    shipped BatchNorm levels (128 -> 128 -> 128 and -> 256) among them; the
    widened BatchNorm RCNN's 256 -> 384 -> 256 keeps the parent design,
    which the bf16 kernels take."""
    assert fused_sa.eval_bf16_design(*widths, bn=True) == design
    assert kernels_take(64, *widths, "bn", False)
    assert fused_sa.bf16_kernels_take(64, *widths)


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_bn_eval_levels_take_the_wgmma_design(name):
    """Every RCNN level a shipped config fuses at eval with RCNN.USE_BN set
    (the slab route with BatchNorm: kernel 9's eval form) runs its bf16
    form on the wgmma eval design."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    cfg = cfg_from_file(str(root / "configs" / f"{name}.yaml"), fresh_cfg())
    sa = cfg.RCNN.SA_CONFIG
    n, R = cfg.RCNN.NUM_POINTS, 2 * cfg.TEST.RPN_POST_NMS_TOP_N
    fused = 0
    for k, m in enumerate(sa.NPOINTS):
        if m == -1:
            break
        mlp = list(sa.MLPS[k])
        if sa_route((R, m, sa.NSAMPLE[k], mlp[0]), mlp, n, True) == "slab":
            fused += 1
            assert fused_sa.eval_bf16_design(*mlp, bn=True) == "wgmma", (
                name, k, mlp)
        n = m
    assert fused >= 1


def test_bn_eval_wgmma_design_smem():
    """Kernel 9's eval layout (no centers, no biases; the packs in f32,
    layer 2's column signs where b2 lies), of the 232448 bytes a block may
    take: 123904 at RCNN SA_0 (128 -> 128 -> 128) and 161792 at SA_1 (->
    256) with three warpgroups, 199680 at C3 = 384 with three; at 512 over
    with three and 215040 with two; at 640 over with two."""
    smem = fused_sa.eval_wgmma_smem
    assert smem(128, 128, 128, 3, bn=True) == 123904
    assert smem(128, 128, 256, 3, bn=True) == 161792
    assert smem(128, 128, 384, 3, bn=True) == 199680 <= fused_sa.SMEM_MAX
    assert smem(128, 128, 512, 3, bn=True) > fused_sa.SMEM_MAX
    assert smem(128, 128, 512, 2, bn=True) == 215040 <= fused_sa.SMEM_MAX
    assert smem(128, 128, 640, 2, bn=True) > fused_sa.SMEM_MAX


def _bn_out(x, mul, add):
    """Layer 2's output of bf16 values x (as f32) under the folded affine,
    as the plain version rounds it: bf16(ReLU(x·mul + add))."""
    return torch.relu(x * mul + add).to(torch.bfloat16).float()


@pytest.mark.parametrize("seed", range(6))
def test_bn_eval_pool_by_sign(seed):
    """The BatchNorm eval form's pooling rule: f(x) = bf16(ReLU(x·mul +
    add)) is monotone in x (non-decreasing where mul >= 0, non-increasing
    where mul < 0, constant at mul = 0), so the kernel's single reduction,
    the column max of bf16(v) with each column's sign flipped by mul's sign
    bit (exact in bf16), the flip undone and f applied once, equals the max
    over the slots of f(bf16(v)), on columns with ties (values drawn from
    few steps), mul of every sign including +0 and -0, and add of every
    sign."""
    rng = np.random.default_rng(seed)
    S, C = 64, 96
    steps = rng.integers(-6, 7, size=(S, C)) * rng.choice(
        [0.25, 1.0, 3.0], size=(1, C))
    v = torch.from_numpy(steps + rng.normal(scale=1e-3, size=(S, C)) * (
        rng.random((1, C)) < 0.5)).float().to(torch.bfloat16)
    mul = torch.from_numpy(rng.normal(size=C)).float()
    mul[::7], mul[3::11] = 0.0, -0.0
    add = torch.from_numpy(rng.normal(size=C)).float()
    add[::5] = 0.0
    want = _bn_out(v.float(), mul, add).amax(0)
    sign = ((torch.signbit(mul).to(torch.int32) << 15).to(torch.int16))
    flipped = (v.view(torch.int16) ^ sign).view(torch.bfloat16)
    pooled = (flipped.float().amax(0).to(torch.bfloat16).view(torch.int16)
              ^ sign).view(torch.bfloat16)
    got = _bn_out(pooled.float(), mul, add)
    assert torch.equal(got, want)
    # the rule is used: columns with mul < 0 pool the min of bf16(v)
    neg = mul < 0
    assert neg.any() and torch.equal(pooled[neg], v[:, neg].amin(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_bf16_weight_operand_is_the_transpose(dtype):
    """The bf16 kernels' weight operand (``fused_sa._w16``) of a contiguous
    (Cin, Cout) weight in any float dtype, square ones included (where a
    wrong layout would raise nothing), is Wᵀ rounded to bf16 in contiguous
    memory of its own, as the kernels read it through its data pointer."""
    rng = np.random.default_rng(5)
    for cin, cout in ((128, 128), (128, 256)):
        w = torch.from_numpy(rng.normal(size=(cin, cout)).astype(
            np.float32)).to(dtype)
        got = fused_sa._w16(w)
        assert got.dtype == torch.bfloat16 and got.shape == (cout, cin)
        assert got.is_contiguous() and got.data_ptr() != w.data_ptr()
        flat = got.flatten()
        assert torch.equal(flat, w.T.to(torch.bfloat16).flatten())
        assert torch.equal(flat.view(cout, cin), w.to(torch.bfloat16).T)


def _eval_pool_walk(a2, S):
    """The wgmma eval design's pool over ``a2`` (groups, S, C) >= 0 as its
    walk takes the slots: units of ``eval_groups_per_tile(S)`` groups, each
    in ceil(S / 64) tiles of 64 consecutive slot rows; rows past a tile's
    valid slots read as pads that would win (1e9) and are set to 0; each
    warp's 16 rows reduced to a column max (a warp's valid rows all of one
    group), the warps of a group combined, a group's tiles folded into a
    running max -> ((groups, C) out, how often each group was written)."""
    groups, _, C = a2.shape
    G = fused_sa.eval_groups_per_tile(S)
    W = 4 // G if G > 1 else 4
    tiles = -(-S // 64)
    flat = a2.reshape(groups * S, C)
    out = np.zeros((groups, C))
    writes = np.zeros(groups, dtype=int)
    for unit in range(-(-groups // G)):
        grp0 = unit * G
        held = min(G, groups - grp0)
        pool = None
        for tile in range(tiles):
            s0 = tile * 64
            valid = min(64, held * S - s0)
            row0 = grp0 * S + s0
            rows = np.full((64, C), 1e9)
            rows[:valid] = flat[row0:row0 + valid]
            rows[valid:] = 0.0
            warp_max = rows.reshape(4, 16, C).max(1)
            for w in range(4):
                owners = {(s0 + r) // S for r in range(16 * w, 16 * w + 16)
                          if r < valid}
                assert len(owners) <= 1
            for k in range(held):
                mx = warp_max[k * W:(k + 1) * W].max(0)
                pool = mx if tile == 0 else np.maximum(pool, mx)
                if tile == tiles - 1:
                    out[grp0 + k] = pool
                    writes[grp0 + k] += 1
    return out, writes


@pytest.mark.parametrize("S, G", [(16, 4), (24, 1), (32, 2), (64, 1),
                                  (128, 1), (8, 1), (100, 1)])
def test_eval_packing_rule(S, G):
    """The packing rule (``eval_groups_per_tile``: 4 groups a tile at S 16,
    2 at 32, else 1) and the walk it implies, emulated: at 133 groups (a
    short last tile at S 16 and 32), every group written once with the max
    over its S slots, no pad reaching the output."""
    assert fused_sa.eval_groups_per_tile(S) == G
    rng = np.random.default_rng(S)
    a2 = np.maximum(rng.normal(size=(133, S, 24)), 0.0)
    out, writes = _eval_pool_walk(a2, S)
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, a2.max(1))


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


# kernel 9's bf16 products: the tensor-core design (csrc/fused_sa_bn_wgmma.cuh)
# or the SIMT design, entry by entry, by width
BN_PRODUCTS = list(fused_sa.BN_BF16_PRODUCTS)
BN_WIDTHS = [
    ((128, 128, 128), "wgmma wgmma wgmma wgmma"),
    ((128, 128, 256), "wgmma wgmma wgmma wgmma"),
    ((256, 384, 256), "simt simt simt simt"),
    ((256, 256, 384), "simt simt simt simt"),
    ((128, 128, 384), "wgmma simt simt wgmma"),
    ((256, 128, 128), "simt wgmma wgmma simt"),
    ((128, 256, 128), "wgmma simt simt simt"),
    ((1024, 1024, 1024), "simt simt simt simt")]


@pytest.mark.parametrize("widths, designs", BN_WIDTHS, ids=str)
def test_bn_train_bf16_design_by_width(widths, designs):
    """Each product's own widths decide: a layer (stats1 C1 -> C2, stats2
    C2 -> C3) takes the tensor cores at depth 128 and width 128 or 256,
    wave 1 at C2 = 128 and C3 128 or 256, wave 2 at C1 = C2 = 128; the
    widened RCNN's widths and every other shape up to BN_MAX_WIDTH keep
    the SIMT design, which kernels_take admits."""
    got = fused_sa.bn_train_bf16_design(*widths)
    assert list(got) == BN_PRODUCTS
    assert " ".join(got.values()) == designs
    assert kernels_take(64, *widths, "bn", True)


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_bn_levels_take_the_wgmma_design(name):
    """Every RCNN level that a shipped config fuses with BatchNorm
    (RCNN.USE_BN on: kernel 9's training form at each fused level) runs
    all four of kernel 9's bf16 products on the tensor-core design."""
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
        if sa_route((R, m, sa.NSAMPLE[k], mlp[0]), mlp, n, True) != "plain":
            fused += 1
            assert set(fused_sa.bn_train_bf16_design(*mlp).values()) == {
                "wgmma"}, (name, k, mlp)
        n = m
    assert fused >= 1


def test_bn_wgmma_smem():
    """The tensor-core design's layout, of the 232448 bytes a block may
    take: a layer 95232 at width 128 (two blocks an SM) and 137216 at 256,
    wave 1 146432 at C3 = 128 and all 232448 at 256, wave 2 212992; wave 1
    at C3 = 384 and wave 2 at 256 over."""
    smem = fused_sa.bn_wgmma_smem
    assert smem("layer", 128, 128) == 95232
    assert 2 * smem("layer", 128, 128) <= 228 * 1024
    assert smem("layer", 128, 256) == 137216
    assert smem("wave1", 128, 128) == 146432
    assert smem("wave1", 256, 128) == 232448 == fused_sa.SMEM_MAX
    assert smem("wave2", 128, 128) == 212992
    assert smem("wave1", 384, 128) > fused_sa.SMEM_MAX
    assert smem("wave2", 256, 256) > fused_sa.SMEM_MAX


@pytest.mark.parametrize("design", ["wgmma", "simt"])
def test_bn_bf16_weight_operand(design):
    """The weight as kernel 9's bf16 products read it: cast to bf16 once
    (laid out contiguously from a transposed view) on the tensor-core
    design, f32 rounded to bf16 on the SIMT design; the same values."""
    w = torch.from_numpy(np.random.default_rng(3).normal(
        size=(16, 24)).astype(np.float32))
    got = fused_sa._operand(w.t(), torch.bfloat16, design)
    assert got.is_contiguous() and got.shape == (24, 16)
    assert got.dtype == (torch.bfloat16 if design == "wgmma"
                         else torch.float32)
    assert torch.equal(got.float(), w.t().to(torch.bfloat16).float())
    assert fused_sa._operand(w, torch.float32, design) is w
