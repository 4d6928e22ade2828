"""The routed backward of the fused SA op and FPS's partitioned argmax,
against tpu3d on the CPU, and the plans the two kernels follow.

The same numpy inputs, made from a seed, go through tpu3d's function and
the port's. Tolerances, each with its reason:

- The routed plain backward (``fused_gathered_mlp_pool_backward_routed_
  plain``, the backward kernel's arithmetic over the reached slots alone)
  against the dense plain backward (autograd of the whole chain): within
  1e-6 of each gradient's largest value (f32 sums in another order).
- Against tpu3d's VJP (``_fused_nobn2_bwd``, the Pallas kernel in interpret
  mode) given the same argmax: on inputs whose every value is exact in
  bf16 (quarter-step points, sparse ±1 / ±0.5 weights, eighth-step biases
  and output gradients), where the kernel's bf16 casts change nothing,
  within 1e-6 of each largest value; against jax.grad of tpu3d's f32
  reference chain with first-argmax pooling on general inputs, 1e-5 abs +
  1e-5 rel, as ``tests/test_torch_train_ops.py`` holds the op.
- FPS: picks equal, bit for bit.
"""

import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.ops.fused_sa import (_fused_nobn2_bwd, _fused_nobn2_fwd_impl,
                                fused_mlp_pool_reference)
from tpu3d.ops.sampling import furthest_point_sample as jax_fps
from tpu3d_torch.config import cfg_from_file, fresh_cfg
from tpu3d_torch.ops.fused_sa import (
    BWD_TILE, fused_gathered_mlp_pool_backward_plain,
    fused_gathered_mlp_pool_backward_routed_plain,
    fused_gathered_mlp_pool_train_plain, pack_tiles, reached_slots)
from tpu3d_torch.ops.sampling import (FPS_PPT_THREADS, fps_geometry,
                                      furthest_point_sample_plain,
                                      fused_route)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (routed_slots, the card run's count)

T = torch.from_numpy
GRADS = ("d_pre", "d_center", "dW1", "db1", "dW2", "db2")
WIDTHS = [(s, c3) for s in (16, 32, 64) for c3 in (128, 256)]
ROUTINGS = ("seeded", "full", "none", "repeated")


def _np(x):
    return np.asarray(x, np.float32)


def _case(seed, S, C3, routing, B=2, M=4, n=128, exact=True):
    """Inputs of the fused op and an output gradient. ``exact``: every
    value exact in bf16 (see the module note); else normal draws. Ids are
    distinct within each group except for the "repeated" routing."""
    rng = np.random.default_rng(seed)
    C1 = C2 = 128
    if routing == "repeated":
        idx = rng.integers(0, n // 8, size=(B, M, S))
    else:
        idx = np.stack([np.stack([rng.permutation(n)[:S] for _ in range(M)])
                        for _ in range(B)])
    idx = idx.astype(np.int32)
    if exact:
        def sparse(cin, cout, k, values):
            w = np.zeros((cin, cout), np.float32)
            for j in range(cout):
                w[rng.choice(cin, k, replace=False), j] = rng.choice(values, k)
            return w

        pre = (rng.integers(-8, 9, size=(B, n, C1)) / 4).astype(np.float32)
        center = (rng.integers(-4, 5, size=(B, M, C1)) / 4).astype(np.float32)
        w1 = sparse(C1, C2, 4, [-1.0, -0.5, 0.5, 1.0])
        w2 = sparse(C2, C3, 2, [-1.0, 1.0])
        b1 = (rng.integers(-4, 5, size=C2) / 8).astype(np.float32)
        b2 = (rng.integers(-4, 5, size=C3) / 8).astype(np.float32)
        g = (rng.integers(-8, 9, size=(B, M, C3)) / 8).astype(np.float32)
    else:
        pre = rng.normal(size=(B, n, C1)).astype(np.float32)
        center = (0.5 * rng.normal(size=(B, M, C1))).astype(np.float32)
        w1 = (rng.normal(size=(C1, C2)) / np.sqrt(C1)).astype(np.float32)
        w2 = (rng.normal(size=(C2, C3)) / np.sqrt(C2)).astype(np.float32)
        b1 = (0.1 * rng.normal(size=C2)).astype(np.float32)
        b2 = (0.1 * rng.normal(size=C3)).astype(np.float32)
        g = rng.normal(size=(B, M, C3)).astype(np.float32)
    return (pre, idx, center, w1, b1, w2, b2), g


def _tpu3d_routing(args, routing, seed):
    """tpu3d's training forward in interpret mode -> (argmax, ppre) under
    ``routing``: its own ("seeded", "repeated"); every channel live at a
    slot drawn uniformly ("full"); no channel live ("none")."""
    pre, idx, center, w1, b1, w2, b2 = args
    B, M, S = idx.shape
    _, arg, ppre = _fused_nobn2_fwd_impl(
        jnp.asarray(pre), jnp.asarray(idx.reshape(B, M * S)),
        jnp.asarray(center), tuple(jnp.asarray(a) for a in (w1, b1, w2, b2)),
        S, True)
    arg, ppre = np.array(arg), np.array(ppre, np.float32)
    if routing == "full":
        rng = np.random.default_rng(seed + 100)
        arg = rng.integers(0, S, size=arg.shape).astype(np.int32)
        ppre = np.ones_like(ppre)
    elif routing == "none":
        ppre = -np.abs(ppre) - 1.0
    return arg, ppre


def _close(got, want, rel, names=GRADS):
    for name, a, b in zip(names, got, want):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= rel * max(np.abs(b).max(), 1e-30) or err == 0.0, (
            name, err, np.abs(b).max())


@pytest.mark.parametrize("routing", ("seeded", "repeated"))
@pytest.mark.parametrize("S,C3", WIDTHS)
def test_routed_plain_matches_dense_plain(S, C3, routing):
    """With the plain training forward's argmax and ppre, the routed plain
    backward equals autograd of the whole chain (the dense plain backward),
    within 1e-6 of each largest value."""
    args, g = _case(1, S, C3, routing, exact=False)
    targs = [T(a) for a in args]
    _, arg, ppre = fused_gathered_mlp_pool_train_plain(*targs)
    got = fused_gathered_mlp_pool_backward_routed_plain(*targs, T(g), arg,
                                                        ppre)
    want = fused_gathered_mlp_pool_backward_plain(*targs, T(g))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("S,C3", WIDTHS)
def test_routed_plain_matches_tpu3d_vjp(S, C3, routing):
    """Against tpu3d's VJP of fused_gathered_mlp_pool(train=True) (its
    Pallas backward in interpret mode) given tpu3d's routing: its own
    forward's argmax, every channel live at a uniform slot, no live
    channel, and ids repeated within groups; inputs exact in bf16, within
    1e-6 of each largest value."""
    args, g = _case(2, S, C3, routing)
    arg, ppre = _tpu3d_routing(args, routing, 2)
    pre, idx, center, w1, b1, w2, b2 = args
    B, M, _ = idx.shape
    res = (jnp.asarray(pre), jnp.asarray(idx.reshape(B, M * S)),
           jnp.asarray(center), tuple(jnp.asarray(a) for a in
                                      (w1, b1, w2, b2)),
           jnp.asarray(arg), jnp.asarray(ppre))
    d_pre, _, d_center, (dw1, db1, dw2, db2) = _fused_nobn2_bwd(
        S, True, res, jnp.asarray(g))
    got = fused_gathered_mlp_pool_backward_routed_plain(
        *(T(a) for a in args), T(g), T(arg), T(ppre))
    _close(got, (d_pre, d_center, dw1, db1, dw2, db2), 1e-6)
    if routing == "none":
        assert all(not t.any() for t in got)


@pytest.mark.parametrize("S,C3", WIDTHS)
def test_routed_plain_matches_reference_grad(S, C3):
    """Given the first argmax of tpu3d's f32 reference chain, the routed
    plain backward equals jax.grad of fused_mlp_pool_reference(pool=
    "first") on the gathered slab (general inputs, repeated ids)."""
    args, g = _case(3, S, C3, "repeated", exact=False)
    pre, idx, center, w1, b1, w2, b2 = args
    B, M, _ = idx.shape

    def chain(pre, center, w1, b1, w2, b2):
        gath = jnp.take_along_axis(pre, jnp.asarray(idx).reshape(
            B, M * S)[..., None], axis=1).reshape(B, M, S, -1)
        return fused_mlp_pool_reference(gath - center[:, :, None, :], w1, b1,
                                        w2, b2, pool="first")

    jgrads = jax.grad(lambda *a: jnp.sum(chain(*a) * jnp.asarray(g)),
                      argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (pre, center, w1, b1, w2, b2)))
    # the reference's first argmax and its pre-ReLU value, from the slab
    gath = np.take_along_axis(pre, idx.reshape(B, M * S)[..., None],
                              axis=1).reshape(B, M, S, -1)
    a1 = np.maximum(np.maximum(gath - center[:, :, None], 0) @ w1 + b1, 0)
    x2 = a1 @ w2 + b2
    arg = np.argmax(np.maximum(x2, 0), axis=2).astype(np.int32)
    ppre = np.take_along_axis(x2, arg[:, :, None], axis=2)[:, :, 0]
    got = fused_gathered_mlp_pool_backward_routed_plain(
        *(T(a) for a in args), T(g), T(arg), T(ppre.astype(np.float32)))
    for name, a, b in zip(GRADS, got, jgrads):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


# ------------------------------------------------------- the reached set


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("S,C3", WIDTHS)
def test_reached_plan(S, C3, routing):
    """The kernel's plan, its Python twin: the reached-slot mask and its
    popcount give chip_smoke.routed_slots' count; the group-aligned tiles
    split no group, hold at most 64 rows, close only where the next group
    does not fit, and number at least ceil(reached / 64) and at most that
    plus the groups that did not fit; runs of a block restart the packing."""
    rng = np.random.default_rng(4)
    B, M = 3, 40
    grad = T(rng.normal(size=(B, M, C3)).astype(np.float32))
    arg = T(rng.integers(0, S, size=(B, M, C3)).astype(np.int32))
    if routing in ("seeded", "repeated"):  # a few live channels, clustered
        live = rng.random((B, M, C3)) < (0.02 if routing == "seeded" else 0.3)
        arg = torch.where(T(rng.random((B, M, C3)) < 0.8), 0, arg)
    else:
        live = np.full((B, M, C3), routing == "full")
    ppre = T(np.where(live, 1.0, -1.0).astype(np.float32))
    dval = torch.where(ppre > 0, grad, 0.0)
    reached = reached_slots(dval, arg, S)
    counts = reached.sum(dim=1)
    _, want = chip_smoke.routed_slots(arg, grad, ppre, S)
    assert int(counts.sum()) == want
    total = int(counts.sum())
    for per_block in (None, 7):
        tiles = pack_tiles(counts.tolist(), per_block)
        packed = [g for t in tiles for g in t]
        assert packed == [g for g in range(B * M) if counts[g] > 0]
        rows = [int(sum(counts[g] for g in t)) for t in tiles]
        assert all(0 < r <= BWD_TILE for r in rows)
        if per_block is None:
            misfits = 0
            for t, nxt in zip(tiles, tiles[1:]):
                assert sum(int(counts[g]) for g in t) + int(counts[nxt[0]]) \
                    > BWD_TILE
                misfits += 1
            lo = math.ceil(total / BWD_TILE)
            assert lo <= len(tiles) <= lo + misfits + (total == 0)
        else:  # no tile spans two blocks' runs
            assert all(len({g // per_block for g in t}) == 1 for t in tiles)


# ----------------------------------------------------------- FPS's argmax


def _partitioned_fps(xyz, npoint, k, threads, ppt):
    """The pick loop's arithmetic on the CPU at geometry (k, threads, ppt):
    point i lives in CTA i // H (H = ceil(N / k)), thread (i % H) % threads,
    warp thread // 32; each warp's partial is its largest running min, ties
    to the lower index, and the pick the largest partial, ties to the lower
    index. -> (B, npoint) int32 picks."""
    B, N, _ = xyz.shape
    H = math.ceil(N / k)
    assert k * threads * ppt >= N
    i = torch.arange(N)
    part = (i // H) * (threads // 32) + (i % H) % threads // 32
    n_parts = k * (threads // 32)
    idx = torch.zeros(B, npoint, dtype=torch.int32)
    mind = torch.full((B, N), float("inf"))
    last = torch.zeros(B, dtype=torch.long)
    rows = torch.arange(B)
    for j in range(1, npoint):
        d = xyz - xyz[rows, last][:, None, :]
        d2 = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
              + d[..., 2] * d[..., 2])
        mind = torch.minimum(mind, d2)
        best = torch.full((B, n_parts), -1.0).scatter_reduce(
            1, part.expand(B, N), mind, "amax")
        at = torch.where(mind == best[:, part], i, N)
        first = torch.full((B, n_parts), N).scatter_reduce(
            1, part.expand(B, N), at, "amin")
        top = best.amax(dim=1, keepdim=True)
        last = torch.where(best == top, first, N).amin(dim=1)
        idx[:, j] = last.to(torch.int32)
    return idx


def _tie_cloud(seed, B, N, k):
    """Clouds whose slices hold copies of each other's points (every CTA
    boundary sees ties), plus a run of one repeated point."""
    rng = np.random.default_rng(seed)
    xyz = (rng.integers(0, 20, size=(B, N, 3)) / 4).astype(np.float32)
    H = math.ceil(N / k)
    for r in range(1, k):
        lo, hi = r * H, min(N, (r + 1) * H)
        xyz[:, lo:hi] = xyz[:, :hi - lo]
    xyz[:, N // 3:N // 3 + 7] = xyz[:, 5:6]
    return xyz


@pytest.mark.parametrize("cloud", ("uniform", "ties"))
@pytest.mark.parametrize("k", (1, 2, 4, 8, 16))
def test_partitioned_argmax_gives_the_plain_picks(k, cloud):
    """The k-way partitioned argmax (per warp, then across the cluster,
    ties to the lower global index) picks what furthest_point_sample_plain
    and tpu3d's FPS pick, with clouds whose duplicated points force ties
    across slice boundaries."""
    B, N, npoint = 2, 512, 96
    threads = max(32, 32 * math.ceil(N / k / 4 / 32))
    if cloud == "uniform":
        rng = np.random.default_rng(k)
        xyz = rng.uniform(-10, 10, size=(B, N, 3)).astype(np.float32)
    else:
        xyz = _tie_cloud(k, B, N, k)
    got = _partitioned_fps(T(xyz), npoint, k, threads, 4)
    want = furthest_point_sample_plain(T(xyz), npoint)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ref = np.asarray(jax_fps(jnp.asarray(xyz), npoint))
    np.testing.assert_array_equal(got.numpy(), ref)


def _fps_launches():
    """Every (B, N, npoint) whose FPS the pick loop serves in the four
    shipped configs: the fused FPS+3NN levels and the long-row FPS."""
    shapes = set()
    for name, batches in (("default", (2, 16)), ("double", (4, 16)),
                          ("quickstart", (8, 4)), ("smoke", (2,))):
        cfg = cfg_from_file(str(ROOT / "configs" / f"{name}.yaml"),
                            fresh_cfg())
        for B in batches:
            n = cfg.RPN.NUM_POINTS
            for npoint in cfg.RPN.SA_CONFIG.NPOINTS:
                if fused_route(B, n, npoint) or n > 2048:
                    shapes.add((B, n, npoint))
                n = npoint
    return sorted(shapes)


def test_fps_geometry_on_the_configs_shapes():
    """fps_geometry on every shape the configs launch: the cluster covers
    the cloud, B·k within the 132 SMs, clusters of at most 16 (8 when the
    card takes no larger), whole warps within the PPT's compiled limit, and
    registers per thread (4 per point plus about 32) within what a CTA of
    that size leaves."""
    shapes = _fps_launches()
    assert (16, 32768, 4096) in shapes and (2, 16384, 4096) in shapes
    for B, N, npoint in shapes:
        assert N <= 32768 and npoint <= N
        for cap in (16, 8):
            k, threads, ppt = fps_geometry(B, N, max_cluster=cap)
            assert k in (1, 2, 4, 8, 16) and k <= cap, (B, N, k)
            assert B * k <= 132, (B, N, k)
            assert k * threads * ppt >= N, (B, N, k, threads, ppt)
            assert threads % 32 == 0 and threads <= FPS_PPT_THREADS[ppt]
            assert 4 * ppt + 32 <= min(255, 65536 // threads)
            # every CTA of the cluster holds at least one point
            assert (k - 1) * math.ceil(N / k) < N
