"""The nearest-k search's algorithm on the CPU: the depth windows, a plain
emulation of the CUDA kernel (``tpu3d_torch/csrc/nearest_k.cu``), and the
ball query taken from it against tpu3d's.

The kernel itself runs only on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``). Here its algorithm runs in plain torch, step for step:
the warp's 33-ary window search over the depth-sorted points, the sweep
in rounds of 32 points, the ballot into a hit list of k + 32 entries, the
in-place compaction to the k first entries by (d², id) with the k-th as
threshold, and the final rank-by-count. It must equal ``nearest_k_plain``
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _nearest_k_cases import dense_cloud, scene_cloud, tie_cases
from tpu3d.ops.grouping import ball_query_from_nearest as jax_bq_from_nearest
from tpu3d.ops.grouping import nearest_k as jax_nearest_k
from tpu3d_torch.ops import ball_query_from_nearest, nearest_k
from tpu3d_torch.ops.grouping import (_radius2, depth_sort, depth_windows,
                                      launch_nearest_k, nearest_k_plain,
                                      nearest_k_route)
from tpu3d_torch.ops.interpolate import _d2

LANES = 32  # nearest_k.cu: a warp per center
SLACK = 32  # nearest_k.cu's kSlack: a list holds k + SLACK hits
CASES = tie_cases()
CASE_IDS = [c[0] for c in CASES]


def _before(da, ia, db, ib):
    """(da, ia) comes before (db, ib): d² first, then the id."""
    return (da < db) | ((da == db) & (ia < ib))


def _warp_windows(zs, cz, r2):
    """The kernel's two interleaved 33-ary searches for each center: the
    first position not "below" and the first "above". Checks on the way
    that each round's passing probes are a prefix of the lanes, which the
    search relies on."""
    B, N = zs.shape
    parts = LANES + 1
    lane = torch.arange(1, LANES + 1)
    cz = cz[..., None]
    preds = (lambda z: (z < cz) & ~((cz - z) * (cz - z) < r2),  # below
             lambda z: (z <= cz) | ((cz - z) * (cz - z) < r2))  # not above
    bounds = []
    for pred in preds:
        a = torch.zeros(cz.shape[:2], dtype=torch.long)
        b = torch.full_like(a, N)
        while (a < b).any():
            span = b - a
            q = a[..., None] + span[..., None] * lane // parts
            z = zs.gather(1, q.clamp(max=N - 1).flatten(1)).view(q.shape)
            yes = (a < b)[..., None] & pred(z)
            c = yes.sum(-1)
            assert torch.equal(yes, lane - 1 < c[..., None])
            na = torch.where(c > 0, a + span * c // parts + 1, a)
            nb = torch.where(c < LANES, a + span * (c + 1) // parts, b)
            a, b = torch.where(a < b, na, a), torch.where(a < b, nb, b)
        bounds.append(a)
    return bounds


def _compact(ld, li, n, k, thr_d, thr_i, rows):
    """The kernel's compaction of the lists ``rows``: the entry of rank
    k - 1 becomes the threshold; the entries at or before it stay, in
    their order."""
    d, i, cap = ld[rows], li[rows], ld.shape[1]
    valid = torch.arange(cap) < n[rows, None]
    rank = (_before(d[:, None, :], i[:, None, :], d[:, :, None],
                    i[:, :, None]) & valid[:, None, :]).sum(2)
    kth = (rank == k - 1) & valid
    assert torch.equal(kth.sum(1), torch.ones(len(rows), dtype=torch.long))
    kd, ki = d[kth], i[kth]
    keep = valid & ~_before(kd[:, None], ki[:, None], d, i)
    assert torch.equal(keep.sum(1), torch.full((len(rows),), k))
    perm = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    ld[rows] = d.gather(1, perm)
    li[rows] = i.gather(1, perm)
    n[rows] = k
    thr_d[rows], thr_i[rows] = kd, ki


def emulate_kernel(centers, pts, k, max_radius, windowed):
    """Plain emulation of the kernel, all centers in lockstep; with
    ``windowed`` its windowed form, else its brute form (rounds of 32
    points in id order: the tiles of 1024 hold whole rounds)."""
    B, M, _ = centers.shape
    N = pts.shape[1]
    r2 = torch.tensor(_radius2(max_radius), dtype=torch.float32)
    cap = k + SLACK
    if windowed:
        zs, order = depth_sort(pts)
        lo, hi = _warp_windows(zs, centers[..., 2], r2)
    else:
        order = torch.arange(N).expand(B, N)
        lo = torch.zeros(B, M, dtype=torch.long)
        hi = torch.full_like(lo, N)
    C = B * M
    scene = torch.arange(B).repeat_interleave(M)[:, None]
    c = centers.reshape(C, 1, 3)
    lo, hi = lo.reshape(C), hi.reshape(C)
    ld = torch.full((C, cap), torch.inf)
    li = torch.zeros(C, cap, dtype=torch.long)
    n = torch.zeros(C, dtype=torch.long)
    thr_d = torch.full((C,), torch.inf)
    thr_i = torch.full((C,), 2 ** 31 - 1)
    lane = torch.arange(LANES)
    for base in range(0, int((hi - lo).max().clamp(min=0)), LANES):
        s = lo[:, None] + base + lane
        inside = s < hi[:, None]
        ids = order[scene, s.clamp(max=N - 1)]
        d = _d2(c, pts[scene, ids])
        hit = inside & (d < r2)
        keep = hit & _before(d, ids, thr_d[:, None], thr_i[:, None])
        over = torch.nonzero(n + keep.sum(1) > cap).flatten()
        if len(over):
            _compact(ld, li, n, k, thr_d, thr_i, over)
            keep = hit & _before(d, ids, thr_d[:, None], thr_i[:, None])
        pos = n[:, None] + keep.cumsum(1) - keep.long()
        row = torch.arange(C)[:, None].expand_as(pos)
        ld[row[keep], pos[keep]] = d[keep]
        li[row[keep], pos[keep]] = ids[keep]
        n += keep.sum(1)
    valid = torch.arange(cap) < n[:, None]
    rank = (_before(ld[:, None, :], li[:, None, :], ld[:, :, None],
                    li[:, :, None]) & valid[:, None, :]).sum(2)
    sel = valid & (rank < k)
    out_d = torch.full((C, k), torch.inf)
    out_i = torch.full((C, k), N, dtype=torch.int32)
    row = torch.arange(C)[:, None].expand_as(rank)
    out_d[row[sel], rank[sel]] = ld[sel]
    out_i[row[sel], rank[sel]] = li[sel].to(torch.int32)
    return out_d.view(B, M, k), out_i.view(B, M, k)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_windows_hold_every_kept_point(case):
    """Every point that the brute plain version keeps lies in its center's
    window (the plain windows and the kernel's search give the same one);
    the window of a center beyond every point's depth is empty."""
    name, centers, pts, k, r = case
    c, p = _torch(centers, pts)
    zs, order = depth_sort(p)
    lo, hi = depth_windows(zs, c, r)
    r2 = torch.tensor(_radius2(r), dtype=torch.float32)
    w_lo, w_hi = _warp_windows(zs, c[..., 2], r2)
    assert torch.equal(w_lo, lo) and torch.equal(w_hi, hi)
    d2, idx = nearest_k_plain(c, p, p.shape[1], r)
    B, N = zs.shape
    where = torch.empty_like(order)  # sorted position of each id
    where.scatter_(1, order, torch.arange(N).expand(B, N))
    kept = idx < N
    pos = where.gather(1, idx.clamp(max=N - 1).long().flatten(1)).view(
        idx.shape)
    assert bool(((pos >= lo[..., None]) & (pos < hi[..., None]))[kept].all())
    if name == "empty windows":
        assert torch.equal(lo, hi) and not kept.any()
    else:
        assert kept.any()


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("k_of", ["case", 1, 7, 50, 128])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_emulated_kernel_equals_plain(case, k_of, windowed):
    """The kernel's algorithm gives the plain version's d² and ids to the
    bit, in both forms, at the case's k and at others: k = 1 (a compaction
    after every 33 hits, the threshold the nearest point), a k between
    rounds, and 128, a widened RCNN's NSAMPLE."""
    _, centers, pts, k, r = case
    k = k if k_of == "case" else k_of
    c, p = _torch(centers, pts)
    got = emulate_kernel(c, p, k, r, windowed)
    want = nearest_k_plain(c, p, k, r)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("windowed", [True, False])
def test_emulated_kernel_equals_plain_dense(windowed):
    """The dense box, cut to 2048 points, at SA_0's k and a radius of 1.5
    m: nearly every center has more than k points within it (about 110),
    so the lists compact."""
    p = torch.from_numpy(dense_cloud(np.random.default_rng(3), 2, 2048))
    c = p[:, ::16].contiguous()
    got = emulate_kernel(c, p, 32, 1.5, windowed)
    want = nearest_k_plain(c, p, 32, 1.5)
    assert float(((want[1] < 2048).sum(2) == 32).float().mean()) > 0.9
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# small copies of the six levels of default.yaml: (B, M, N, radii,
# nsamples, cloud box)
RPN_BOX = ((-8, -1, 0), (8, 3, 16))
ROI_BOX = ((-1, -0.5, -1), (1, 0.5, 1))
LEVELS = {
    "RPN SA_0": (2, 256, 1024, (0.1, 0.5), (16, 32), RPN_BOX),
    "RPN SA_1": (2, 128, 512, (0.5, 1.0), (16, 32), RPN_BOX),
    "RPN SA_2": (2, 64, 256, (1.0, 2.0), (16, 32), RPN_BOX),
    "RPN SA_3": (2, 16, 64, (2.0, 4.0), (16, 32), RPN_BOX),
    "RCNN SA_0": (8, 128, 512, (0.2,), (64,), ROI_BOX),
    "RCNN SA_1": (8, 32, 128, (0.4,), (64,), ROI_BOX),
}


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("level", list(LEVELS))
def test_ball_query_from_emulation_matches_tpu3d(level, windowed):
    """Each radius's group ids from the emulated kernel's candidates equal
    tpu3d's from its CPU nearest_k (exact through approx_min_k; no
    repeated points, whose equal d² it orders in no fixed way)."""
    B, M, N, radii, nsamples, box = LEVELS[level]
    rng = np.random.default_rng(M + N)
    pts = scene_cloud(rng, B, N, box)
    centers = pts[:, rng.choice(N, M, replace=False)]
    k = max(nsamples)
    jd, ji = jax_nearest_k(jnp.asarray(centers), jnp.asarray(pts), k)
    c, p = _torch(centers, pts)
    td, ti = emulate_kernel(c, p, k, max(radii), windowed)
    hits = 0
    for r, s in zip(radii, nsamples):
        j_grp = np.asarray(jax_bq_from_nearest(jd, ji, r, s, N))
        t_grp = ball_query_from_nearest(td, ti, r, s, N).numpy()
        np.testing.assert_array_equal(t_grp, j_grp)
        hits += int((td[..., :s] < r * r).sum())
    assert hits > B * M  # the levels have neighbours to group


@pytest.mark.parametrize("case", CASES[:4], ids=CASE_IDS[:4])
def test_nearest_k_coordinates(case):
    """With ``with_coords`` each slot's coordinates are its point's, 0 in
    the padded slots; d² and ids as without."""
    _, centers, pts, k, r = case
    c, p = _torch(centers, pts)
    d2, idx, xyz = nearest_k(c, p, k, max_radius=r, with_coords=True)
    want = nearest_k(c, p, k, max_radius=r)
    assert torch.equal(d2, want[0]) and torch.equal(idx, want[1])
    N = p.shape[1]
    hit = idx < N
    rows = torch.arange(p.shape[0])[:, None, None].expand_as(idx)
    assert torch.equal(xyz[hit], p[rows[hit], idx[hit].long()])
    assert not xyz[~hit].any()
    assert torch.equal(_d2(c[:, :, None], xyz)[hit], d2[hit])


def test_nearest_k_coordinates_carry_no_gradient():
    """The coordinates are copies with no gradient to the points, as the
    kernel's are on the card; d² and ids as without them."""
    _, centers, pts, k, r = CASES[3]
    c, p = _torch(centers, pts)
    p.requires_grad_()
    d2, idx, xyz = nearest_k(c, p, k, max_radius=r, with_coords=True)
    assert not xyz.requires_grad
    want = nearest_k(c, p.detach(), k, max_radius=r)
    assert torch.equal(d2, want[0]) and torch.equal(idx, want[1])


def test_nearest_k_route():
    """The windowed form at every level with 2^26 brute evaluations or
    more, with a finite radius: the RPN's SA_0 on every path, SA_1 and the
    RCNN's SA_0 at the train batch."""
    windowed = {  # (B, M, N): default eval and train, double, quickstart
        (2, 4096, 16384): True, (2, 1024, 4096): False,
        (2, 256, 1024): False, (2, 64, 256): False, (200, 128, 512): False,
        (200, 32, 128): False, (16, 4096, 16384): True,
        (16, 1024, 4096): True, (1024, 128, 512): True,
        (1024, 32, 128): False, (4, 4096, 32768): True,
        (16, 4096, 32768): True, (8, 1024, 4096): False}
    for (B, M, N), want in windowed.items():
        assert nearest_k_route(B, M, N, 0.25) == want, (B, M, N)
        assert not nearest_k_route(B, M, N, float("inf"))


def test_launch_takes_only_cuda_tensors():
    """The kernel's wrapper never falls back: CPU tensors raise."""
    p = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch_nearest_k(p, p, 4, 1.0, True)
