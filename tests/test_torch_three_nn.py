"""The 3-NN search's algorithm on the CPU: a plain emulation of both forms
of the CUDA kernel (``tpu3d_torch/csrc/three_nn.cu``) against
``three_nn_plain``, and the port against tpu3d.

The kernel itself runs only on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``). Here its windowed form runs in plain torch, step for
step, for every query of a scene at once: the depth sort of the known
points, each query's start position by the kernel's binary search, the
two-sided widening (the side with the smaller depth term first) with its
strict stop (a side ends at the first depth term above the third d², +inf
until three points are held), and the fold into a top-3 ranked by (d²,
id); its brute form sweeps the known points in id order through the
strict-< min/max network of the TPU kernel. Both must equal
``three_nn_plain`` bit for bit (d² rounded step by step in f32 on both
sides), so the route predicate cannot change the result. The cases (``_three_nn_cases.py``) are duplicated known points,
equal depths, equal d² at different ids, queries beyond either end of the
known depths, N = 3, every known point at one depth, queries on known
points, 70 m coordinates 1 cm apart, and planted-cluster and uniform
scenes.

Against tpu3d, on the same numpy inputs: ``three_nn_numpy`` (a stable
sort) and ``_three_nn_pallas`` in interpret mode, which both tie to the
lowest index, ids equal and d² within 1e-6 relative (XLA and numpy sum d²
in their own order); tpu3d's ``three_nn`` on the CPU (``approx_min_k``,
exact there but with no fixed order among equal d²) on the cases without
exact ties, ids equal and distances within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _three_nn_cases import three_nn_cases
from tpu3d.ops import interpolate as jax_interp
from tpu3d_torch.ops import three_nn
from tpu3d_torch.ops.interpolate import (THREE_NN_WINDOW_MIN_PAIRS, _d2,
                                         depth_sort, three_nn_plain,
                                         three_nn_route, three_nn_windows)

CASES = three_nn_cases()
CASE_IDS = [c[0] for c in CASES]
INT_MAX = 2 ** 31 - 1
# the cases without two known points at exactly one d² from a query, where
# tpu3d's approx_min_k path gives the one order
UNTIED = ("uniform", "planted clusters", "beyond the ends", "N = 3",
          "one depth", "on known points")


def _before(da, ia, db, ib):
    """(da, ia) comes before (db, ib): d² first, then the id."""
    return (da < db) | ((da == db) & (ia < ib))


def _depth2(uz, kz):
    dz = uz - kz
    return dz * dz


class _Top3:
    """Every query's 3 nearest so far, sorted by (d², id); empty slots
    (+inf, INT_MAX), as the kernel's registers."""

    def __init__(self, M):
        self.d = [torch.full((M,), torch.inf) for _ in range(3)]
        self.i = [torch.full((M,), INT_MAX, dtype=torch.int64)
                  for _ in range(3)]

    def fold(self, d, i, act):
        """The kernel's insertion where ``act``: (d, i) enters if it comes
        before the third, and shifts the slots behind it."""
        (d1, d2, d3), (i1, i2, i3) = self.d, self.i
        c3 = act & _before(d, i, d3, i3)
        c2, c1 = _before(d, i, d2, i2), _before(d, i, d1, i1)
        new = ((torch.where(c1, d, d1), torch.where(c1, i, i1)),
               (torch.where(c1, d1, torch.where(c2, d, d2)),
                torch.where(c1, i1, torch.where(c2, i, i2))),
               (torch.where(c2, d2, d), torch.where(c2, i2, i)))
        self.d = [torch.where(c3, nd, od) for (nd, _), od in zip(new, self.d)]
        self.i = [torch.where(c3, ni, oi) for (_, ni), oi in zip(new, self.i)]

    def out(self):
        return torch.stack(self.d, -1), torch.stack(self.i, -1).int()


def windowed_emulation(unknown, known):
    """The windowed form, step for step -> (d2, idx, evaluations): the d²
    evaluations the form made, per scene."""
    B, M, _ = unknown.shape
    N = known.shape[1]
    order = depth_sort(known)[1]
    out_d, out_i, evals = [], [], []
    for b in range(B):
        ks, ids, u = known[b][order[b]], order[b], unknown[b]
        uz = u[:, 2]
        # the first sorted position whose depth is not below the query's
        lo = torch.zeros(M, dtype=torch.int64)
        hi = torch.full((M,), N, dtype=torch.int64)
        while (lo < hi).any():
            live = lo < hi
            mid = (lo + hi) // 2
            below = ks[mid.clamp(max=N - 1), 2] < uz
            lo = torch.where(live & below, mid + 1, lo)
            hi = torch.where(live & ~below, mid, hi)
        dn, up = lo - 1, lo.clone()
        od, ou = dn >= 0, up < N
        td = _depth2(uz, ks[dn.clamp(min=0), 2])
        tu = _depth2(uz, ks[up.clamp(max=N - 1), 2])
        top, n = _Top3(M), 0
        while True:
            od = od & ~(td > top.d[2])
            ou = ou & ~(tu > top.d[2])
            act = od | ou
            if not act.any():
                break
            down = od & (~ou | (td <= tu))
            pos = torch.where(down, dn, up).clamp(0, N - 1)
            top.fold(_d2(u, ks[pos]), ids[pos], act)
            n += int(act.sum())
            nxt = torch.where(down, dn - 1, up + 1)
            inside = (nxt >= 0) & (nxt < N)
            tn = _depth2(uz, ks[nxt.clamp(0, N - 1), 2])
            mv_d, mv_u = act & down, act & ~down
            dn = torch.where(mv_d, nxt, dn)
            od = torch.where(mv_d, inside, od)
            td = torch.where(mv_d, tn, td)
            up = torch.where(mv_u, nxt, up)
            ou = torch.where(mv_u, inside, ou)
            tu = torch.where(mv_u, tn, tu)
        d, i = top.out()
        out_d.append(d)
        out_i.append(i)
        evals.append(n)
    return torch.stack(out_d), torch.stack(out_i), evals


def brute_emulation(unknown, known):
    """The brute form: every known point in id order through the kernel's
    strict-< min/max network (which, in id order, keeps the lower id on a
    tie)."""
    B, M, _ = unknown.shape
    out_d, out_i = [], []
    for b in range(B):
        d1 = d2 = d3 = torch.full((M,), torch.inf)
        i1 = i2 = i3 = torch.zeros(M, dtype=torch.int32)
        for j in range(known.shape[1]):
            m = _d2(unknown[b], known[b, j])
            pos = torch.full((M,), j, dtype=torch.int32)
            c1, c2, c3 = m < d1, m < d2, m < d3
            y1 = torch.maximum(d1, m)
            y2 = torch.maximum(d2, y1)
            d1, d2, d3 = (torch.minimum(d1, m), torch.minimum(d2, y1),
                          torch.minimum(d3, y2))
            i1, i2, i3 = (torch.where(c1, pos, i1),
                          torch.where(c2, torch.where(c1, i1, pos), i2),
                          torch.where(c3, torch.where(c2, i2, pos), i3))
        out_d.append(torch.stack([d1, d2, d3], -1))
        out_i.append(torch.stack([i1, i2, i3], -1))
    return torch.stack(out_d), torch.stack(out_i)


@pytest.mark.parametrize("windowed", [True, False], ids=["windowed", "brute"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_forms_equal_plain_bit_for_bit(case, windowed):
    """Each form's emulation gives three_nn_plain's d² and ids to the bit
    (tolerance 0): whichever form the route picks, the result is the
    same."""
    _, q, k = case
    u, kn = torch.from_numpy(q), torch.from_numpy(k)
    ref_d, ref_i = three_nn_plain(u, kn)
    if windowed:
        d, i, evals = windowed_emulation(u, kn)
        assert sum(evals) <= q.shape[0] * q.shape[1] * k.shape[1]
    else:
        d, i = brute_emulation(u, kn)
    assert torch.equal(i, ref_i)
    assert torch.equal(d, ref_d)


def test_windows_cut_the_pairs():
    """On the scenes the windowed form evaluates a fraction of the pairs:
    under a third at the uniform scene (256 known points over 70 m of
    depth) and the planted-cluster one; more known points cut more."""
    for name, q, k in three_nn_cases(seed=3):
        if name not in ("uniform", "planted clusters"):
            continue
        u, kn = torch.from_numpy(q), torch.from_numpy(k)
        evals = sum(windowed_emulation(u, kn)[2])
        pairs = q.shape[0] * q.shape[1] * k.shape[1]
        assert evals < pairs / 3, (name, evals / pairs)


def test_route_picks_the_windowed_form_by_pairs():
    """``three_nn_route``: the windowed form from THREE_NN_WINDOW_MIN_PAIRS
    pairs on, the brute form below; double.yaml's train SA_0 (16 x 32768
    x 4096) takes the windows, quickstart's SA_3 (64 -> 16) and smoke's
    SA_2-3 (64 -> 32, 32 -> 16) the brute sweep. On the CPU three_nn is the
    plain version at every shape."""
    assert three_nn_route(16, 32768, 4096)
    for shape in ((8, 64, 16), (4, 64, 16), (2, 64, 32), (2, 32, 16)):
        assert not three_nn_route(*shape)
    n = THREE_NN_WINDOW_MIN_PAIRS
    assert three_nn_route(1, n, 1) and not three_nn_route(1, n - 1, 1)
    _, q, k = CASES[0]
    u, kn = torch.from_numpy(q), torch.from_numpy(k)
    for got, ref in zip(three_nn(u, kn), three_nn_plain(u, kn)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_port_matches_tpu3d_oracles(case):
    """The port's three_nn against tpu3d's numpy oracle and its Pallas
    kernel in interpret mode, both tied to the lowest index: ids equal, d²
    within 1e-6 relative."""
    _, q, k = case
    d2, idx = (t.numpy() for t in three_nn(torch.from_numpy(q),
                                           torch.from_numpy(k)))
    nd, ni = jax_interp.three_nn_numpy(q, k)
    np.testing.assert_array_equal(idx, ni)
    np.testing.assert_allclose(np.sqrt(d2), nd, rtol=1e-6)
    jd2, ji = jax.device_get(jax_interp._three_nn_pallas(
        jnp.asarray(q), jnp.asarray(k), interpret=True))
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_allclose(d2, jd2, rtol=1e-6)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in UNTIED],
                         ids=lambda c: c[0])
def test_port_matches_tpu3d_three_nn(case):
    """Against tpu3d's three_nn on the CPU (approx_min_k): ids equal,
    distances (sqrt of d²) within 1e-6 relative."""
    _, q, k = case
    d2, idx = (t.numpy() for t in three_nn(torch.from_numpy(q),
                                           torch.from_numpy(k)))
    jd, ji = jax.device_get(jax_interp.three_nn(
        jnp.asarray(q), jnp.asarray(k), differentiable=False))
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_allclose(np.sqrt(np.maximum(d2, 0.0)), jd, rtol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_windows_hold_the_three_nearest(case):
    """``three_nn_windows`` (the bound's count of pairs in chip_smoke.py):
    each query's 3 nearest lie inside its run of depth-sorted positions,
    every point outside has a depth term above the third d², and the
    windowed emulation evaluates at least the run's points."""
    _, q, k = case
    u, kn = torch.from_numpy(q), torch.from_numpy(k)
    d2, idx = three_nn_plain(u, kn)
    zs, order = depth_sort(kn)
    lo, hi = three_nn_windows(zs, u, d2[..., 2])
    rank = torch.argsort(order, dim=1)  # each id's sorted position
    pos = torch.gather(rank, 1, idx.long().flatten(1)).view(idx.shape)
    assert bool(((pos >= lo[..., None]) & (pos < hi[..., None])).all())
    p = torch.arange(kn.shape[1])
    term = _depth2(u[..., 2:3], zs[:, None, :])
    outside = (p < lo[..., None]) | (p >= hi[..., None])
    assert bool((term[outside] > d2[..., 2:3].expand_as(term)[outside]).all())
    assert sum(windowed_emulation(u, kn)[2]) >= int((hi - lo).sum())
