"""The fused SA kernels at every shape tpu3d fuses, in the port against
tpu3d on the CPU: the kernels' shape predicate (``kernels_take``) against
tpu3d's ``fused_sa_supported``, the three fused forms (gather, slab,
BatchNorm slab) at S of 8, 24 and 128 slots and widths of 256, 384 and 512,
the slab form's routed backward (the plain version of its kernel's walk),
``sa_route`` and an RCNN at a widened configuration (SA_0 with 128 slots,
MLP widths 256 / 384).

Inputs are numpy arrays made from a seed. Tolerances, each with its
reason, are those of the tests of the shipped shapes, whose helpers run
here:

- against tpu3d's f32 references (``fused_mlp_pool_reference`` on the
  gathered or the given slab, ``fused_bn_mlp_pool_reference``): the output
  and every gradient within 1e-5 of each one's largest value, f32 sums in
  another order (tests/test_torch_train_ops.py, test_torch_slab.py,
  test_torch_bn_train.py); the BatchNorm chain both as the op and through
  the kernels' plain pieces (x1 and x2 written by the statistics passes,
  read by the final pass and the waves);
- against tpu3d's Pallas kernels in interpret mode, which round to bf16 at
  their layer boundaries: the bf16 grades those files state, on inputs
  that bf16 holds exactly;
- the routed slab plain version against the dense plain version: 1e-6 of
  each largest value (f32 sums in another order); against tpu3d's VJP
  (``_fused_nobn_bwd`` in interpret mode) given the same argmax, on inputs
  exact in bf16 whose products bf16 holds exactly too: 1e-6;
- the widened RCNN's loss and gradients in float64: the float64 bound of
  test_torch_train.py (1e-7 relative plus 1e-9 of the largest gradient).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bn_train import (_assert_close, _jax_reference, _pieces,
                                 pallas_case)
from test_torch_bn_train import _case as bn_case
from test_torch_bn_train import _port as bn_port
from test_torch_rpn import _numpy_variables, _port_cfg
from test_torch_slab import (_bn_case, _config, _jax_bn,
                             _port_bn, _recording_routes, _tpu3d_route,
                             slab_pallas_case, slab_reference_case)
from test_torch_train import _flat, _x64
from test_torch_train_ops import (_bf16_exact_case, _fused_case,
                                  _jax_ref_chain, _port_fused_grads)
from tpu3d.models.proposal_target import \
    proposal_target_layer as jax_proposal_target
from tpu3d.models.rcnn import RCNNNet as JaxRCNNNet
from tpu3d.models.train_functions import get_rcnn_loss
from tpu3d.ops import fused_sa as jax_fused_sa
from tpu3d_torch.datasets import train_batch
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.models import train_functions as tf
from tpu3d_torch.ops import sa_route
from tpu3d_torch.ops.fused_sa import (BN_MAX_WIDTH, backward_plan,
                                      block_runs,
                                      forward_rows_per_warp,
                                      fused_mlp_pool_backward_plain,
                                      fused_mlp_pool_backward_routed_plain,
                                      fused_mlp_pool_train_plain,
                                      kernels_take)
from tpu3d_torch.weights import params_from_jax, params_to_jax

T = torch.from_numpy
GRADS = ("d_pre", "d_center", "dW1", "db1", "dW2", "db2")
SLAB_GRADS = ("d_x0", "dW1", "db1", "dW2", "db2")
WIDTHS = range(128, 1025, 128)

# (R, M, S, C1, C2, C3): S 8, 24 and 128 slots, each with the widths 256,
# 384 and 512 in another order; M·S a multiple of max(S, 128), as tpu3d's
# fused_sa_supported asks, small R
WIDE = [(2, 16, 8, 256, 384, 512), (2, 16, 24, 384, 512, 256),
        (1, 2, 128, 512, 256, 384)]


def _id(shape):
    return "S{}-{}-{}-{}".format(*shape[2:])


# ------------------------------------------------------- the predicate


@pytest.mark.parametrize("form", ["gather", "slab", "bn"])
def test_kernels_take_every_shape_tpu3d_fuses(form):
    """For every (S, C1, C2, C3) that tpu3d's fused_sa_supported admits,
    S up to 256 and widths up to 1024 (any R; M = 128, which makes every
    S's M·S condition hold), the port's predicate accepts it for the
    form's eval kernel and its training kernels; so does the launch plan
    of each kernel it stands for."""
    taken = 0
    for S in range(8, 257, 8):
        for c1, c2, c3 in itertools.product(WIDTHS, repeat=3):
            mlp = (c1, c2, c3)
            if not jax_fused_sa.fused_sa_supported((4, 128, S, c1), mlp):
                continue
            assert kernels_take(S, c1, c2, c3, form, train=False), (S, mlp)
            assert kernels_take(S, c1, c2, c3, form, train=True), (S, mlp)
            assert forward_rows_per_warp(S, c1, c2, c3) >= 1
            if form != "bn":
                assert backward_plan(c1, c2, c3) is not None
            taken += 1
    assert taken == 32 * 8 ** 3


@pytest.mark.parametrize("S,c1,c2,c3,form,train", [
    (12, 128, 128, 128, "gather", False),  # S % 8 != 0
    (0, 128, 128, 128, "slab", False),     # no slot
    (64, 128, 192, 128, "slab", False),    # C2 % 128 != 0
    (64, 128, 128, 64, "gather", False),   # C3 % 128 != 0
    (64, 100, 128, 128, "gather", True),   # the backward: C1 % 128 != 0
    (64, 128, 128, BN_MAX_WIDTH + 128, "bn", True),  # past the chain's width
    (64, 8192, 128, 128, "slab", False),   # x0 and a1 overflow shared memory
])
def test_kernels_take_rejects(S, c1, c2, c3, form, train):
    """The shapes no kernel takes: the predicate says so, and tpu3d does
    not fuse the first four either."""
    assert not kernels_take(S, c1, c2, c3, form, train)


def test_forward_rows_keep_the_shipped_shapes():
    """The shipped shapes (S 16 / 64, C2 = 128, C3 128 / 256) keep the
    chunk rows of the kernels before (the whole group in one chunk), and
    the backward keeps its 64-row tiles with dW2 in shared memory, two
    tile buffers at C3 = 128 and one at 256."""
    assert forward_rows_per_warp(64, 128, 128, 256) == 8
    assert forward_rows_per_warp(16, 128, 128, 128) == 2
    assert forward_rows_per_warp(32, 128, 128, 128) == 4
    assert backward_plan(128, 128, 128) == (8, 2, True)
    assert backward_plan(128, 128, 256) == (8, 1, True)


@pytest.mark.parametrize("case", ["smoke", "spread", "empty", "one big"])
def test_block_runs_share_the_rows(case):
    """The backward's split of the groups among its blocks (``block_runs``,
    the kernel's cut by prefix sums): runs of whole groups, in order, that
    cover every group; each run but the last reaches its share of the
    rows, at least a tile; a few runs when the rows are few, none when no
    row is reached."""
    rng = np.random.default_rng(len(case))
    counts = {"smoke": rng.integers(0, 4, 512),     # ~1.3 rows a group
              "spread": rng.integers(40, 65, 4096),  # most slots reached
              "empty": np.zeros(100, int),
              "one big": np.r_[np.zeros(9, int), 64, np.zeros(9, int)]}[case]
    blocks = 528
    runs = block_runs(counts, blocks)
    total = int(counts.sum())
    target = max(64, -(-total // blocks))
    assert len(runs) == -(-total // target) <= blocks
    if not runs:
        assert total == 0
        return
    assert runs[0].start == 0 and runs[-1].stop == len(counts)
    for a, b in zip(runs, runs[1:]):
        assert a.stop == b.start
    cum = np.cumsum(counts)
    for k, run in enumerate(runs[:-1]):  # cut where the rows reach k·target
        assert cum[run.stop - 1] >= (k + 1) * target
        assert run.stop - 1 == 0 or cum[run.stop - 2] < (k + 1) * target
    if case == "smoke":
        assert len(runs) == -(-total // 64) < 30


# ------------------------------------------------------- the three forms


@pytest.mark.parametrize("shape", WIDE, ids=_id)
def test_gather_wide_matches_reference(shape):
    """The gather form's training forward and its six gradients against
    jax.grad of tpu3d's f32 reference chain on the gathered slab with
    first-argmax pooling (ids repeat within groups), within 1e-5 of each
    one's largest value."""
    args, g = _fused_case(41, shape, n=128, ties=True)
    out, grads = _port_fused_grads(args, g)
    pre, idx, center, w1, b1, w2, b2 = args
    chain = _jax_ref_chain(idx)
    jargs = [jnp.asarray(a) for a in (pre, center, w1, b1, w2, b2)]
    jout = np.asarray(chain(*jargs))
    jgrads = jax.grad(lambda *a: jnp.sum(chain(*a) * jnp.asarray(g)),
                      argnums=tuple(range(6)))(*jargs)
    np.testing.assert_allclose(out, jout, rtol=0,
                               atol=1e-5 * np.abs(jout).max())
    for name, a, b in zip(GRADS, grads, jgrads):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("shape", WIDE, ids=_id)
def test_gather_wide_matches_pallas_interpret(shape):
    """The gather form's output and six gradients against tpu3d's
    fused_gathered_mlp_pool (train=True, interpret mode) on inputs exact in
    bf16, at the bf16 grade of tests/test_torch_train_ops.py: out within
    0.1, each gradient's max error under 0.08 and mean under 5e-3 of its
    largest value."""
    args, g = _bf16_exact_case(42, shape)
    out, grads = _port_fused_grads(args, g)
    pre, idx, center, w1, b1, w2, b2 = args

    def loss(pre, center, w1, b1, w2, b2):
        o = jax_fused_sa.fused_gathered_mlp_pool(
            pre, jnp.asarray(idx), center, w1, b1, w2, b2, train=True,
            interpret=True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(g)), o

    (_, jout), jgrads = jax.value_and_grad(
        loss, argnums=tuple(range(6)), has_aux=True)(
        *(jnp.asarray(a) for a in (pre, center, w1, b1, w2, b2)))
    assert np.abs(out - np.asarray(jout, np.float32)).max() < 0.1
    for name, a, b in zip(GRADS, grads, jgrads):
        b = np.asarray(b, np.float32)
        err = np.abs(a - b) / (np.abs(b).max() + 1e-3)
        assert err.max() < 0.08 and err.mean() < 5e-3, (name, err.max())


@pytest.mark.parametrize("shape", WIDE, ids=_id)
def test_slab_wide_matches_reference(shape):
    """The slab form: eval and training forward and the five gradients
    against tpu3d's f32 reference within 1e-5 of each largest value; the
    training output equals the eval output; the backward alone, routed by
    the training forward's argmax and ppre, gives autograd's to the bit."""
    evl, out, ref, grads, jgrads, alone = slab_reference_case(shape)
    np.testing.assert_allclose(evl, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(out, evl)
    for name, a, b, c in zip(SLAB_GRADS, grads, jgrads, alone):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
        np.testing.assert_array_equal(c, a, err_msg=name)


@pytest.mark.parametrize("shape", WIDE, ids=_id)
def test_slab_wide_matches_pallas_interpret(shape):
    """The slab form against tpu3d's slab kernels in interpret mode, at
    the bf16 grade and with the layer-1 mask accounting of
    test_torch_slab.py's test_slab_op_matches_pallas_interpret."""
    out, jout, arg, jarg, grads, jgrads, shifts, moved, entries = \
        slab_pallas_case(shape)
    assert np.abs(out - jout).max() < 0.1
    assert (arg == jarg).mean() >= 0.98
    assert moved <= entries // 1000, (moved, entries)
    for name, a, b, shift in zip(SLAB_GRADS, grads, jgrads,
                                 (*shifts, 0, 0)):
        err = np.abs(a + shift - b) / (np.abs(b).max() + 1e-3)
        assert err.max() < 0.08, (name, err.max())
        assert err.mean() < 5e-3, (name, err.mean())


@pytest.mark.parametrize("shape", WIDE, ids=_id)
def test_bn_eval_wide_matches_reference(shape):
    """The BatchNorm chain at eval (the slab eval kernel's plain version on
    folded running statistics) against tpu3d's f32 reference, within 1e-5
    of the largest value."""
    (x0, w1, w2), bns = _bn_case(shape, shape[2] + 3)
    ref = _jax_bn(jax_fused_sa.fused_bn_mlp_pool_reference, x0, w1, w2, bns)
    out = _port_bn(x0, w1, w2, bns)
    assert out.shape == ref.shape == (shape[0], shape[1], shape[5])
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shape", WIDE, ids=_id)
def test_bn_train_wide_matches_reference(shape):
    """The BatchNorm chain in training, as the op and through the kernels'
    plain pieces (stats passes writing x1 and x2, the final reduction, the
    waves reading them), against tpu3d's f32 reference: output, means,
    variances and the nine gradients within 1e-5 of each largest value."""
    arrays = bn_case(shape, shape[2] + shape[5] + 7)
    ref = _jax_reference(arrays)
    _assert_close(bn_port(arrays), ref, 1e-5)
    _assert_close(_pieces(arrays), ref, 1e-5)


@pytest.mark.parametrize("shape", WIDE, ids=_id)
def test_bn_train_wide_matches_pallas_interpret(shape):
    """Against tpu3d's seven Pallas kernels in interpret mode (the port's
    backward routed by the TPU kernels' argmax), at the bf16 grade of
    test_torch_bn_train.py's test_train_op_matches_pallas_interpret for the
    output, the statistics and the argmax; every gradient at that test's
    grade for the gradients behind layer 1 (0.4 of the largest value, 0.03
    on average), layer 2's also within 5e-3 on average. At these widths the
    bf16 x2 moves layer 2's sums as the bf16 x1 moves layer 1's there: a
    near-zero pooled value flips its channel's whole d_y2, and tpu3d's own
    f32 reference is 0.25-0.40 of the largest dW2 away from its kernels at
    these three shapes (the port, routed alike, 0.006-0.17)."""
    err, mean_err, var_err, same, rel = pallas_case(shape)
    assert err.max() < 0.1 and err.mean() < 0.01, (err.max(), err.mean())
    assert mean_err <= 2e-3 and var_err <= 1, (mean_err, var_err)
    assert same >= 0.98
    names = ("d_x0", "d_w1", "d_w2", "d_gamma0", "d_gamma1", "d_gamma2",
             "d_beta0", "d_beta1", "d_beta2")
    for name, r in zip(names, rel):
        assert r.max() < 0.4 and r.mean() < 0.03, (name, r.max(), r.mean())
        if name in ("d_w2", "d_gamma2", "d_beta2"):
            assert r.mean() < 5e-3, (name, r.mean())


# ------------------------------------------- the slab form's routed walk


def _slab_inputs(shape, seed, exact):
    """x0, w1, b1, w2, b2 and an output gradient; ``exact``: quarter-step
    slab values, sparse ±1 / ±0.5 weights, eighth-step biases and output
    gradients, so that every product of the chain is exact in bf16 and
    f32."""
    R, M, S, C1, C2, C3 = shape
    rng = np.random.default_rng(seed)
    if not exact:
        return [a.astype(np.float32) for a in (
            rng.normal(size=(R, M, S, C1)),
            rng.normal(size=(C1, C2)) / np.sqrt(C1),
            0.1 * rng.normal(size=C2),
            rng.normal(size=(C2, C3)) / np.sqrt(C2),
            0.1 * rng.normal(size=C3), rng.normal(size=(R, M, C3)))]

    def sparse(cin, cout, k, values):
        w = np.zeros((cin, cout), np.float32)
        for j in range(cout):
            w[rng.choice(cin, k, replace=False), j] = rng.choice(values, k)
        return w

    return [(rng.integers(-8, 9, size=(R, M, S, C1)) / 4).astype(np.float32),
            sparse(C1, C2, 4, [-1.0, -0.5, 0.5, 1.0]),
            (rng.integers(-4, 5, size=C2) / 8).astype(np.float32),
            sparse(C2, C3, 2, [-1.0, 1.0]),
            (rng.integers(-4, 5, size=C3) / 8).astype(np.float32),
            (rng.integers(-8, 9, size=(R, M, C3)) / 8).astype(np.float32)]


def _routing(arg, ppre, routing, S, seed):
    """(argmax, ppre) under ``routing``: the forward's own ("seeded"), every
    channel live at a slot drawn uniformly ("full"), no live channel
    ("none")."""
    if routing == "full":
        rng = np.random.default_rng(seed)
        return (rng.integers(0, S, size=arg.shape).astype(np.int32),
                np.ones_like(ppre))
    if routing == "none":
        return arg, -np.abs(ppre) - 1.0
    return arg, ppre


def _close(got, want, rel, names=SLAB_GRADS):
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = np.abs(a - b).max()
        assert err <= rel * max(np.abs(b).max(), 1e-30) or err == 0.0, (
            name, err, np.abs(b).max())


SLAB_ROUTED = [(2, 8, 64, 128, 128, 256), (2, 8, 16, 128, 128, 128)] + WIDE


@pytest.mark.parametrize("shape", SLAB_ROUTED, ids=_id)
def test_slab_routed_plain_matches_dense_plain(shape):
    """With the plain training forward's argmax and ppre (groups that
    repeat slots, so exact ties meet the first-argmax rule), the routed
    slab plain version equals autograd of the whole chain
    (``fused_mlp_pool_backward_plain``) within 1e-6 of each largest value,
    every unreached slab row's gradient 0."""
    x0, w1, b1, w2, b2, g = _slab_inputs(shape, shape[2] + 5, exact=False)
    S = shape[2]
    x0 = x0[:, :, np.arange(S) % max(1, S // 2)]
    t = [T(np.ascontiguousarray(a)) for a in (x0, w1, b1, w2, b2)]
    _, arg, ppre = fused_mlp_pool_train_plain(*t)
    got = fused_mlp_pool_backward_routed_plain(*t, T(g), arg, ppre)
    want = fused_mlp_pool_backward_plain(*t, T(g), arg, ppre)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("routing", ["seeded", "full", "none"])
@pytest.mark.parametrize("shape", [(2, 8, 16, 128, 128, 256)] + WIDE[1:],
                         ids=_id)
def test_slab_routed_plain_matches_tpu3d_vjp(shape, routing):
    """Against tpu3d's VJP of the slab form (``_fused_nobn_bwd``, its
    Pallas backward in interpret mode) given tpu3d's routing: its own
    forward's argmax, every channel live at a uniform slot, and no live
    channel; inputs whose products bf16 holds exactly, within 1e-6 of each
    largest value."""
    x0, w1, b1, w2, b2, g = _slab_inputs(shape, shape[2] + 6, exact=True)
    R, M, S, C1 = x0.shape
    xf = jnp.asarray(x0.reshape(R, M * S, C1))
    ws = (jnp.asarray(w1), jnp.asarray(w2))
    bs = (jnp.asarray(b1), jnp.asarray(b2))
    _, arg, ppre = jax_fused_sa._fused_nobn_fwd_impl(xf, ws, bs, S, True)
    arg, ppre = _routing(np.array(arg), np.array(ppre, np.float32), routing,
                         S, shape[2])
    d_x0, (dw1, dw2), (db1, db2) = jax_fused_sa._fused_nobn_bwd(
        S, True, (xf, ws, bs, jnp.asarray(arg), jnp.asarray(ppre)),
        jnp.asarray(g))
    got = fused_mlp_pool_backward_routed_plain(
        *(T(a) for a in (x0, w1, b1, w2, b2)), T(g), T(arg), T(ppre))
    want = (np.asarray(d_x0).reshape(x0.shape), dw1, db1, dw2, db2)
    _close(got, want, 1e-6)
    if routing == "none":
        assert all(not t.any() for t in got)


# ------------------------------------------- the widened configuration


def widened_config(name="quickstart", nsample=128, npoint=None):
    """A config with the RCNN's SA_0 at ``nsample`` slots and its MLPs
    widened: SA_0 256 -> 384 -> 256, SA_1 256 -> 256 -> 384 (SA_2, the
    group-all level, keeps its widths), set in memory."""
    jcfg = _config(name)
    sa = jcfg.RCNN.SA_CONFIG
    sa.NSAMPLE = [nsample, *sa.NSAMPLE[1:]]
    sa.MLPS = [[256, 384, 256], [256, 256, 384], list(sa.MLPS[2])]
    if npoint is not None:
        sa.NPOINTS = [npoint, *sa.NPOINTS[1:]]
    return jcfg


@pytest.mark.parametrize("level,rows,n,npoint,nsample,mlp,c_in", [
    (0, 200, 512, 128, 128, (256, 384, 256), 128),  # default.yaml's SA_0
    (1, 200, 128, 32, 64, (256, 256, 384), 256),    # its SA_1
    (0, 512, 256, 64, 128, (256, 384, 256), 128),   # quickstart's SA_0
    (1, 512, 64, 16, 64, (256, 256, 384), 256),     # its SA_1
])
@pytest.mark.parametrize("bn", [False, True])
def test_route_at_widened_config(monkeypatch, level, rows, n, npoint,
                                 nsample, mlp, c_in, bn):
    """``sa_route`` against tpu3d's dispatch traced as on a TPU at the
    widened RCNN levels: fused everywhere, the gather form where tpu3d
    gathers (no BatchNorm, a source table it takes), else the slab form;
    and the kernels take each level."""
    shape = (rows, npoint, nsample, mlp[0])
    route = sa_route(shape, mlp, n, bn)
    assert route == _tpu3d_route(monkeypatch, rows, n, npoint, nsample, mlp,
                                 bn, c_in)
    assert route == ("slab" if bn or n % 128 else "gather")
    assert kernels_take(nsample, *mlp, "bn" if bn else route)


def widened_rcnn_grad_case():
    """The widened quickstart RCNN (SA_0 at 128 slots of 256 -> 384 -> 256
    over 32 centers; 8 ROIs per scene): tpu3d's proposal target layer on
    rois jittered around the gt boxes, then the RCNN loss and every
    rcnn_net gradient on both sides in float64 -> (loss, gradients as a
    flax tree, tpu3d's loss, tpu3d's gradients, the fused ops the port's
    RCNN called)."""
    jcfg = widened_config(npoint=32)
    jcfg.RCNN.ROI_PER_IMAGE = 8
    B, N = 1, jcfg.RPN.NUM_POINTS
    batch = train_batch(B, N, seed=52)
    pts, gt = batch["pts_input"], batch["gt_boxes3d"]
    rng = np.random.default_rng(52)
    rois = np.repeat(gt[:, :8], 6, axis=1)
    rois = (rois + rng.normal(size=rois.shape) * [0.3, 0.05, 0.3, 0.05, 0.05,
                                                  0.1, 0.1]).astype(np.float32)
    feats = np.concatenate([
        (rng.random((B, N, 1)) > 0.5), rng.random((B, N, 1)),
        rng.normal(size=(B, N, 128))], -1).astype(np.float32)
    target = jax.device_get(jax.jit(lambda k: jax_proposal_target(
        k, jnp.asarray(rois), jnp.ones(rois.shape[:2], bool),
        jnp.asarray(gt), jnp.asarray(pts), jnp.asarray(feats), jcfg))(
            jax.random.PRNGKey(5)))
    target = {k: np.asarray(v, np.float64) if np.asarray(v).dtype
              == np.float32 else np.asarray(v) for k, v in target.items()}

    jnet = JaxRCNNNet(cfg=jcfg)
    pts_input = np.concatenate([target["sampled_pts"],
                                target["pts_feature"]], -1)
    shapes = jax.eval_shape(lambda p: jnet.init(
        {"params": jax.random.PRNGKey(0)}, p, train=False),
        pts_input.astype(np.float32))
    params, _ = _numpy_variables({"params": shapes["params"],
                                  "batch_stats": {}}, rng)
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float64), params)

    def loss_fn(p):
        out = jnet.apply({"params": p}, pts_input, train=True)
        return get_rcnn_loss(jcfg, dict(target, **out))[0]

    with _x64():
        jloss, jgrads = jax.device_get(jax.jit(jax.value_and_grad(loss_fn))(
            params))

    cfg = _port_cfg(jcfg)
    model = PointRCNN(cfg, mode="TRAIN", device="cpu").double()
    full = model.state_dict()
    full.update(params_from_jax({"rcnn_net": params}, {}))
    model.load_state_dict(full)
    with pytest.MonkeyPatch.context() as m:
        calls = _recording_routes(m)
        out = model.rcnn_net(T(target["sampled_pts"]),
                             T(target["pts_feature"]), train=True)
    loss, _ = tf.get_rcnn_loss(cfg, dict(
        out, **{k: T(v) for k, v in target.items()}))
    loss.backward()
    grads = params_to_jax({n: p.grad for n, p in model.named_parameters()
                           if n.startswith("rcnn_net.")})[0]["rcnn_net"]
    return loss.item(), grads, float(jloss), jgrads, calls


def test_widened_rcnn_gradients_match():
    """The widened RCNN level in training on the CPU against tpu3d in
    float64: the loss within 1e-9 relative, each rcnn_net gradient within
    1e-7 relative plus 1e-9 of the largest (test_torch_train.py's float64
    bound); the port's SA_0 ran the gather route over 128 slots of 256 ->
    384 -> 256, its SA_1 the slab route of 256 -> 256 -> 384."""
    loss, grads, jloss, jgrads, calls = widened_rcnn_grad_case()
    assert calls == ["fused_gathered_mlp_pool", "fused_mlp_pool"]
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    ours, ref = dict(_flat(grads)), dict(_flat(jgrads))
    assert set(ours) == set(ref)
    scale = max(np.abs(b).max() for b in ref.values())
    for k, b in ref.items():
        np.testing.assert_allclose(ours[k], b, rtol=1e-7, atol=1e-9 * scale,
                                   err_msg=k)
    assert ours["sa_0/mlp_0/dense_2/kernel"].shape == (384, 256)
    assert np.abs(ref["sa_0/mlp_0/dense_1/kernel"]).max() > 0
