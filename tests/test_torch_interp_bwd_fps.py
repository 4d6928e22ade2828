"""The algorithms of two CUDA kernels on the CPU: the interpolation's
backward (``tpu3d_torch/csrc/three_interpolate_bwd.cu``) and the short-row
FPS (``tpu3d_torch/csrc/fps.cu``).

The kernels themselves run only on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``). Here their arithmetic runs in numpy, step for step:

- The backward: the inverse of the ids built as the kernel builds it
  (counts and offsets per slice of sources, the lists filled in an
  arbitrary order as shared-memory atomics leave them, here a seeded
  permutation, lists longer than the gather sorts put in order through a
  bitmap of the scene's keys), then the gather: each list sorted by the
  kernel's bitonic network, and per source +0.0 plus w·g[m] over it in
  ascending key m·3 + j, each product and sum rounded to f32. It must equal a sequential
  sum in ascending key order bit for bit, and the plain version on the CPU
  (``index_add_``, which adds in that order) bit for bit; and
  ``jax.vjp`` of tpu3d's f32 gather path within 1e-5 (f32 sums in another
  order), at scaled-down copies of default.yaml's four FP levels.
- FPS: the kernel's lane layout (point q·32W + t on thread t of the row's
  32W, q < PPL), the running min's bits as a signed key, each lane's tree
  over its PPL candidates, the warp argmax (largest key, then the lowest
  index holding it), and across the row's W warps the same again. Its picks
  must equal ``furthest_point_sample_plain``'s, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.ops.interpolate import three_interpolate as jax_interp
from tpu3d.ops.sampling import furthest_point_sample as jax_fps
from tpu3d_torch.ops.interpolate import (backward_workspace,
                                         three_interpolate_backward_plain)
from tpu3d_torch.ops.sampling import furthest_point_sample_plain

T = torch.from_numpy
MAX_PPL = 16   # fps.cu's kMaxPPL
INT_MAX = np.iinfo(np.int32).max

# ------------------------------------------------ the interpolation backward


SLICE = 1024     # three_interpolate_bwd.cu's kSlice: sources per build block
SORT_MAX = 128   # its kSortMax: longer lists are sorted by the build


def _bitonic(v):
    """The gather's bitonic network over 32·K keys (element r·32 + lane in
    register r of a lane: the partner of e at stage (k, j) is e ^ j, and e
    keeps the min when bit j and bit k of e agree), ascending."""
    v = np.asarray(v, np.int64).copy()
    e = np.arange(v.size)
    k = 2
    while k <= v.size:
        j = k >> 1
        while j > 0:
            o = v[e ^ j]
            keep_min = ((e & j) == 0) == ((e & k) == 0)
            v = np.where(keep_min, np.minimum(v, o), np.maximum(v, o))
            j >>= 1
        k <<= 1
    return v


def _bitmap_sort(keys, n_keys):
    """The build's long lists: each key's bit set in a bitmap of the
    scene's keys, read back word by word in ascending order."""
    words = np.zeros((n_keys + 31) // 32, np.uint32)
    for k in keys:
        words[k >> 5] |= np.uint32(1 << (int(k) & 31))
    return np.asarray([w * 32 + b for w, bits in enumerate(words)
                       for b in range(32) if (int(bits) >> b) & 1], np.int64)


def build_inverse(idx, N, slice_=SLICE, sort_max=SORT_MAX, seed=0):
    """The kernel's CSR build for (B, M, 3) ids: block (s, b) counts scene
    b's entries of its slice's sources and those below the slice, scans
    them into offsets and fills the lists through cursors in the order of
    its atomics (here a seeded permutation), then sorts the lists longer
    than sort_max through a bitmap. -> (off (B·N + 1), keys (B·3M))."""
    B, M, _ = idx.shape
    E = 3 * M
    rng = np.random.default_rng(seed)
    off = np.full(B * N + 1, -1, np.int64)
    keys = np.full(B * E, -1, np.int64)
    for b in range(B):
        flat = idx[b].reshape(-1).astype(np.int64)
        for lo in range(0, N, slice_):
            hi = min(N, lo + slice_)
            below = int((flat < lo).sum())
            counts = np.bincount(flat[(flat >= lo) & (flat < hi)] - lo,
                                 minlength=hi - lo)
            first = b * E + below + np.cumsum(counts) - counts
            off[b * N + lo:b * N + hi] = first
            cur = first.copy()
            for e in rng.permutation(E):
                if lo <= flat[e] < hi:
                    keys[cur[flat[e] - lo]] = e
                    cur[flat[e] - lo] += 1
            for t in np.nonzero(counts > sort_max)[0]:
                sl = slice(first[t], first[t] + counts[t])
                keys[sl] = _bitmap_sort(keys[sl], E)
    off[B * N] = B * E
    return off, keys


def gather_emulation(idx, w, g, N, sort_max=SORT_MAX, **build):
    """The kernel on the CPU: the build, then per source its list sorted by
    the bitonic network over 32, 64 or 128 keys (INT_MAX padding last) up
    to sort_max, as the build left it beyond, and +0.0 plus f32(w·g[m])
    over it in that order, each sum rounded."""
    B, M, _ = idx.shape
    C = g.shape[-1]
    off, keys = build_inverse(idx, N, sort_max=sort_max, **build)
    lists = []
    for s in range(B * N):
        lst = keys[off[s]:off[s + 1]]
        if 0 < lst.size <= sort_max:
            size = 32
            while size < lst.size:
                size *= 2
            pad = np.full(size, INT_MAX, np.int64)
            pad[:lst.size] = lst
            lst = _bitonic(pad)[:lst.size]
        lists.append(lst)
    acc = np.zeros((B * N, C), np.float32)
    for r in range(max(lst.size for lst in lists)):
        live = np.asarray([s for s in range(B * N) if lists[s].size > r])
        key = np.asarray([lists[s][r] for s in live])
        b = live // N
        m, j = key // 3, key % 3
        acc[live] = acc[live] + w[b, m, j][:, None] * g[b, m]
    return acc.reshape(B, N, C)


def sequential_sum(idx, w, g, N):
    """d_features as a sequential f32 sum in ascending (m·3 + j) per scene,
    from +0.0."""
    B, M, _ = idx.shape
    out = np.zeros((B, N, g.shape[-1]), np.float32)
    for b in range(B):
        for k in range(3 * M):
            m, j = divmod(k, 3)
            n = idx[b, m, j]
            out[b, n] = out[b, n] + w[b, m, j] * g[b, m]
    return out


# default.yaml's four FP levels (N sources, M rows, C) cut by 16 in N and M
# and by 8 in C
FP_LEVELS = {"FP_0": (256, 1024, 32), "FP_1": (64, 256, 64),
             "FP_2": (16, 64, 64), "FP_3": (4, 16, 128)}


def _nn_case(seed, B, N, M, C):
    """Ids and weights as the FP levels take them: each query's 3 nearest
    sources (tpu3d's order: ties to the lower index), inverse-distance
    weights; features and gradients normal."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-10, 10, size=(B, N, 3)).astype(np.float32)
    qry = rng.uniform(-10, 10, size=(B, M, 3)).astype(np.float32)
    d2 = ((qry[:, :, None] - src[:, None]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=-1, kind="stable")[..., :3].astype(np.int32)
    d = np.sqrt(np.take_along_axis(d2, idx, -1))
    w = 1.0 / (d + 1e-8)
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    g = rng.normal(size=(B, M, C)).astype(np.float32)
    return feats, idx, w, g


def _plain(feats, idx, w, g, need_weight=False):
    df, dw = three_interpolate_backward_plain(T(feats), T(idx), T(w), T(g),
                                              need_weight)
    return df.numpy(), None if dw is None else dw.numpy()


@pytest.mark.parametrize("level", list(FP_LEVELS))
@pytest.mark.parametrize("B", (2, 3))
def test_inverse_gather_is_the_sequential_sum(level, B):
    """The kernel's build and fixed-order gather equal the sequential sum in
    ascending key order, and the CPU plain version, bit for bit."""
    feats, idx, w, g = _nn_case(B, B, *FP_LEVELS[level])
    N = feats.shape[1]
    got = gather_emulation(idx, w, g, N)
    np.testing.assert_array_equal(got, sequential_sum(idx, w, g, N))
    np.testing.assert_array_equal(got, _plain(feats, idx, w, g)[0])


@pytest.mark.parametrize("level", list(FP_LEVELS))
def test_backward_matches_tpu3d_vjp(level):
    """d_features (the kernel's fixed-order sum) and d_weight (the plain
    version, the kernel's dot products) within 1e-5 of jax.vjp of tpu3d's
    f32 gather path."""
    feats, idx, w, g = _nn_case(7, 2, *FP_LEVELS[level])
    N = feats.shape[1]
    _, vjp = jax.vjp(lambda f, wt: jax_interp(f, jnp.asarray(idx), wt),
                     jnp.asarray(feats), jnp.asarray(w))
    jdf, jdw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(gather_emulation(idx, w, g, N),
                               np.asarray(jdf), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_plain(feats, idx, w, g, True)[1],
                               np.asarray(jdw), atol=1e-5, rtol=1e-5)


def _case_ids(case, rng, B, N, M):
    if case == "one triple":  # every query to the same three sources
        return np.broadcast_to(np.array([3, 1, 2], np.int32),
                               (B, M, 3)).copy()
    if case == "duplicates":  # ids repeated within a row
        idx = rng.integers(0, N, size=(B, M, 3)).astype(np.int32)
        idx[:, ::2, 1] = idx[:, ::2, 0]
        idx[:, ::3, 2] = idx[:, ::3, 0]
        return idx
    if case == "sparse":  # most sources receive nothing
        return rng.integers(0, max(1, N // 8), size=(B, M, 3)).astype(
            np.int32) * 8
    return rng.integers(0, N, size=(B, M, 3)).astype(np.int32)


@pytest.mark.parametrize("case", ("one triple", "duplicates", "sparse",
                                  "uniform"))
def test_inverse_gather_cases(case):
    """Every query to one triple (lists of M, far past the gather's sort:
    the build's bitmap), ids repeated within a row, sources with no
    contribution (zero rows), and the offsets of B > 1 scenes, also with
    the build's slice and the gather's sort limit cut so that the sources
    span several slices and more lists take the bitmap: each list holds
    its source's keys once, and the result equals the sequential sum and
    the CPU plain version bit for bit."""
    rng = np.random.default_rng(11)
    B, N, M, C = 3, 40, 120, 12
    idx = _case_ids(case, rng, B, N, M)
    w = rng.random((B, M, 3)).astype(np.float32)
    g = rng.normal(size=(B, M, C)).astype(np.float32)
    feats = np.zeros((B, N, C), np.float32)
    for build in ({}, {"slice_": 16, "sort_max": 8}):
        off, keys = build_inverse(idx, N, **build)
        assert np.array_equal(off[::N], 3 * M * np.arange(B + 1))
        assert np.all(np.diff(off) >= 0)
        for b in range(B):
            for n in range(N):
                lst = keys[off[b * N + n]:off[b * N + n + 1]]
                assert np.array_equal(np.sort(idx[b].reshape(-1)[lst]),
                                      np.full(lst.size, n))
                assert np.unique(lst).size == lst.size
                if lst.size > build.get("sort_max", SORT_MAX):
                    assert np.all(np.diff(lst) > 0)
        got = gather_emulation(idx, w, g, N, **build)
        np.testing.assert_array_equal(got, sequential_sum(idx, w, g, N))
        np.testing.assert_array_equal(got, _plain(feats, idx, w, g)[0])
    hit = np.zeros((B, N), bool)
    for b in range(B):
        hit[b, np.unique(idx[b])] = True
    assert np.all(got[~hit] == 0.0) and np.all(np.signbit(got[~hit]) == 0)
    if case == "one triple":
        assert np.diff(off).max() == M
    if case == "sparse":
        assert (~hit).sum() >= B * (N - N // 8)


@pytest.mark.parametrize("size", (32, 64, 128))
def test_bitonic_network(size):
    """The gather's network sorts any 32, 64 or 128 keys, INT_MAX padding
    last."""
    rng = np.random.default_rng(size)
    for L in (0, 1, 2, size // 2 + 1, size - 1, size):
        keys = np.full(size, INT_MAX, np.int64)
        keys[:L] = rng.choice(100_000, size=L, replace=False)
        np.testing.assert_array_equal(_bitonic(keys), np.sort(keys))


def test_backward_workspace_size():
    """The wrapper's workspace: offsets, then the lists' keys, as the C
    entry carves it."""
    B, N, M = 16, 4096, 16384
    assert backward_workspace(B, N, M) == (B * N + 1) + 3 * B * M


# ------------------------------------------------------------ short-row FPS


def _key(v):
    """The kernel's key: a float32's bits as a signed int."""
    return np.asarray(v, np.float32).view(np.int32)


def test_fps_key_order():
    """A missing point's key (-inf) orders below +0.0, +inf above every
    finite d², and keys of d² >= 0 order as the values; the old padding
    value -1.0 would order above every d² read as unsigned bits."""
    assert _key(-np.inf) < _key(0.0)
    assert _key(np.inf) > _key(np.finfo(np.float32).max)
    rng = np.random.default_rng(0)
    d2 = np.sort(np.concatenate([[0.0, np.inf, np.finfo(np.float32).tiny],
                                 rng.random(64) ** 8 * 1e6]).astype(
        np.float32))
    assert np.all(np.diff(_key(d2)) > 0)
    assert _key(-1.0).view(np.uint32) > _key(np.inf).view(np.uint32)


def row_geometry(N):
    """fps.cu's dispatch: W warps per row (the fewest with at most MAX_PPL
    points per lane), then the fewest points per lane, powers of 2."""
    w = 1
    while 32 * w * MAX_PPL < N:
        w *= 2
    ppl = 1
    while 32 * w * ppl < N:
        ppl *= 2
    return w, ppl


def fps_emulation(xyz, npoint, W, PPL):
    """The kernel's pick loop on W warps of PPL points per lane: ->
    (R, npoint) int32 picks."""
    R, N, _ = xyz.shape
    Tn = 32 * W
    assert Tn * PPL >= N
    i = np.arange(PPL)[:, None] * Tn + np.arange(Tn)[None, :]  # (PPL, T)
    live = i < N
    p = np.zeros((R, PPL, Tn, 3), np.float32)
    p[:, live] = xyz[:, i[live]]
    mind = np.where(live, np.float32(np.inf), np.float32(-np.inf))
    mind = np.broadcast_to(mind, (R, PPL, Tn)).copy()
    out = np.zeros((R, npoint), np.int32)
    last = np.zeros(R, np.int64)
    rows = np.arange(R)
    for j in range(1, npoint):
        lp = xyz[rows, last][:, None, None, :]
        d = p - lp
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        mind = np.minimum(mind, d2)
        key = _key(mind).copy()
        at = np.broadcast_to(np.arange(PPL)[None, :, None],
                             key.shape).copy()
        s = 1  # the lane's tree: the left operand holds the lower index
        while s < PPL:
            for q in range(0, PPL - s, 2 * s):
                take = key[:, q + s] > key[:, q]
                key[:, q] = np.where(take, key[:, q + s], key[:, q])
                at[:, q] = np.where(take, at[:, q + s], at[:, q])
            s <<= 1
        key0 = key[:, 0].reshape(R, W, 32)
        idx0 = (at[:, 0] * Tn + np.arange(Tn)).reshape(R, W, 32)
        top = key0.max(-1)  # __reduce_max_sync
        low = np.where(key0 == top[..., None], idx0, INT_MAX).min(-1)
        top2 = top.max(-1)  # across the row's warps
        last = np.where(top == top2[:, None], low, INT_MAX).min(-1)
        out[:, j] = last
    return out


def _rows(seed, R, N, kind):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-2.5, 2.5, size=(R, N, 3)).astype(np.float32)
    if kind == "ties":  # few distinct points, repeated: ties everywhere
        xyz = (np.round(xyz * 2) / 2)[:, np.arange(N) % 7]
        xyz[1::2] = xyz[1::2, ::-1]
    elif kind == "equal":  # an empty ROI: every point the same
        xyz[:] = xyz[:, :1]
    return np.ascontiguousarray(xyz)


# the RCNN's rows of the four configs (N, npoint), the split route's RPN
# levels, N not a multiple of 32, and the largest row fps.cu takes
FPS_SHAPES = [(512, 128), (128, 32), (256, 64), (64, 16), (32, 16),
              (100, 40), (600, 150), (2048, 160)]


@pytest.mark.parametrize("kind", ("uniform", "ties", "equal"))
@pytest.mark.parametrize("N,npoint", FPS_SHAPES)
def test_row_argmax_gives_the_plain_picks(N, npoint, kind):
    """The kernel's keyed argmax on its own geometry for N picks what
    furthest_point_sample_plain picks, bit for bit."""
    xyz = _rows(N, 6, N, kind)
    W, PPL = row_geometry(N)
    got = fps_emulation(xyz, npoint, W, PPL)
    want = furthest_point_sample_plain(T(xyz), npoint).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("W", (1, 2, 4, 8))
def test_row_argmax_on_any_warp_count(W):
    """The picks do not depend on how a row is spread over warps (the
    sweep's geometries), and equal tpu3d's."""
    N, npoint = 500, 120
    PPL = 1
    while 32 * W * PPL < N:
        PPL *= 2
    xyz = _rows(W, 4, N, "ties")
    got = fps_emulation(xyz, npoint, W, PPL)
    np.testing.assert_array_equal(
        got, furthest_point_sample_plain(T(xyz), npoint).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax_fps(jnp.asarray(xyz),
                                                          npoint)))


def test_row_geometry_covers_every_row():
    """W · 32 · PPL covers N with at most MAX_PPL points per lane, and a row
    of up to 2048 points takes at most four warps."""
    for N in range(1, 2049):
        W, PPL = row_geometry(N)
        assert 32 * W * PPL >= N and PPL <= MAX_PPL and W <= 4
        assert W == 1 or 32 * W * PPL < 2 * N
