"""Fused two-layer MLP + max-pool over grouped points, the RCNN's set
abstraction, at eval and in training, in tpu3d's two fused forms.

Counterpart of ``tpu3d/ops/fused_sa.py::fused_gathered_mlp_pool`` (the
gather form: the group gather of per-point pre-activations runs inside the
kernel), ``fused_mlp_pool`` (the slab form: the caller builds the grouped
(R, M, S, C1) pre-activation in memory) and ``fused_bn_mlp_pool`` (the
slab form with BatchNorm: at eval its running statistics folded into one
per-channel affine per layer, in training with the batch's statistics).
``sa_route`` is tpu3d's choice among the two forms and the plain SharedMLP
(``models/pointnet2.py``).

Each no-BN op runs, for CUDA tensors, its eval kernel in ``csrc/fused_sa.cu``
when no gradient is needed, and otherwise a ``torch.autograd.Function``
whose forward is the training kernel of the same source (it also keeps
each pooled channel's first argmax slot and the pre-ReLU value there) and
whose backward is the routed kernel of ``csrc/fused_sa_bwd.cu`` (one kernel
for both forms). The BatchNorm op at eval is the slab eval kernel alone; in
training a ``torch.autograd.Function`` whose forward is three statistics
passes (the last two writing x1 and x2 to device memory) and a final
reduction over the stored x2, and whose backward is two waves and an
elementwise pass, each computing every product once from the stored slabs
(``csrc/fused_sa_bn.cu``), each pass a counted kernel. The kernels take
every shape tpu3d's ``fused_sa_supported`` admits (``kernels_take``). For
CPU tensors each runs its plain version, or the plain training form under
autograd. The max-pool's gradient goes to the first slot that reaches
the max, as tpu3d's kernels route it.

Two numeric forms, picked by the eval contract (``precision.py``), which
the model's entry points resolve and hand down. The f32 forms above
compute everything in f32 and are held to tpu3d's CPU path, which is f32
too: every CPU forward and training step, and the card under the f32
contracts (``TPU3D_F32_EVAL=1``; both ``TRAIN`` keys False). The bf16
forms (``fused_gathered_mlp_pool_bf16``, ``fused_mlp_pool_bf16``,
``fused_bn_mlp_pool_bf16``, entries in ``csrc/fused_sa_bf16.cuh``; the
first two on ``csrc/fused_sa_wgmma_eval.cuh``'s design at the widths
``eval_bf16_design`` names) compute
as tpu3d's TPU kernels do: bf16 operands with f32 sums, every layer
boundary rounded to bf16, a bf16 output; an eval on the card takes them by
default, and so does a train step, through the training forms of the two
forms without BatchNorm (kernels 6 and 8: the forward in
``csrc/fused_sa_bf16.cuh``, the routed backward in
``csrc/fused_sa_bwd_bf16.cu``) and the BatchNorm chain's
(``fused_bn_mlp_pool_bf16_train``, kernel 9's: the seven training passes
on bf16 slabs, the ``*_bf16`` entries of ``csrc/fused_sa_bn.cu``); the CPU
runs their plain versions when a test hands it that contract.

Kernel notes (in full in the sources): they replace
``tpu3d/ops/fused_sa.py::_nobn2_eval_kernel``, ``_nobn2_fwd_kernel`` and
``_nobn2_bwd_kernel`` (gather form), ``_nobn_eval_kernel``,
``_nobn_fwd_kernel``, ``_nobn_bwd_kernel`` and ``_eval_chain_kernel`` (slab
form), and the BatchNorm chain's training kernels ``_stats0_kernel``,
``_fwd_stats1_kernel``, ``_fwd_stats2_kernel``, ``_fwd_final_kernel``,
``_bwd_wave1_kernel``, ``_bwd_wave2_kernel`` and ``_bwd_apply_kernel``;
the bf16 forms ``_nobn2_eval_kernel``, ``_nobn_eval_kernel`` and
``_eval_chain_kernel`` in their own arithmetic (the first two at the
shipped widths on ``wgmma`` products from shared memory, the weights
resident, each 64-row tile's max reduced in registers and short groups
packed four or two to a tile; otherwise warp-level bf16 ``mma.sync``
products with f32 accumulators, a block of four warps per group, chunks of
up to 64 slots staged in shared memory).
The two Dense layers make them bound by operations; one block per (row,
center) loads its group into shared memory a chunk of slots at a time
(gathered, or read from the slab; the slab form at S 16 and 32 packs
``slab_groups_per_block`` groups into a block of 64 rows, so that each
staged weight slice serves 8 rows per warp), and the backward walks the
reached slots of many groups per block, summing the weight gradients in
registers, shared memory or the block's own workspace slice before one
reduction in block order, and the gather form adds each point's reached
rows into d_pre in ascending group·S + slot through an inverse of the ids
(``csr_inverse.cuh``), so every output repeats to the bit; the BatchNorm chain's products are register-tiled over flat tiles of
slots and sum their per-channel reductions in f64 per block.
The slab kernel takes each layer as a per-channel affine (mul, add) between
two Dense layers, a_l = ReLU(x_l·mul_l + add_l): mul = 1 and add = (0, b1,
b2) without BatchNorm, the folded running statistics with it.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
import itertools

import torch

from . import _build
from .grouping import group_points


def _chain(x0, w1, b1, w2, b2):
    """Layer 2's pre-activation x2 of a grouped (R, M, S, C1) chunk."""
    x1 = torch.relu(x0) @ w1 + b1
    return torch.relu(x1) @ w2 + b2


def _pool_plain(x0, w1, b1, w2, b2):
    """The chain on a grouped (R, M, S, C1) chunk -> (R, M, C3)."""
    return torch.relu(_chain(x0, w1, b1, w2, b2)).amax(dim=2)


def _first_max(x2):
    """The max over S of ReLU(x2), a grouped chunk's layer-2 pre-activation,
    differentiable by autograd -> (out, argmax i32, ppre), each (R, M, C3).

    The max over the S slots goes through the first slot that reaches it
    (``argmax``), picked explicitly and then gathered, so that autograd
    routes the pooled gradient to that one slot (``amax`` would split it
    among ties). ``ppre`` is the pre-ReLU value there."""
    S = x2.shape[2]
    a2 = torch.relu(x2)
    with torch.no_grad():
        top = a2.amax(dim=2, keepdim=True)
        slots = torch.arange(S, device=x2.device)[:, None]
        arg = torch.where(a2 == top, slots, S).amin(dim=2)
    sel = arg[:, :, None, :]
    return (torch.gather(a2, 2, sel)[:, :, 0], arg.to(torch.int32),
            torch.gather(x2.detach(), 2, sel)[:, :, 0])


def _pool_train_plain(x0, w1, b1, w2, b2):
    """The chain on a grouped chunk, differentiable by autograd, pooled by
    ``_first_max``."""
    return _first_max(_chain(x0, w1, b1, w2, b2))


def _row_chunks(R, M, S, width):
    """Row slices of an (R, M, S, ·) slab whose (rows, M, S, width)
    intermediates are near 64 MB."""
    chunk = max(1, (1 << 24) // (M * S * width))
    return [slice(r0, r0 + chunk) for r0 in range(0, R, chunk)]


def _chunked(fn, grouped, R, M, S, width):
    """``fn`` over row chunks of the grouped slab ``grouped(rows)``
    (``_row_chunks``; autograd keeps every chunk's intermediates), with its
    outputs concatenated over rows."""
    outs = [fn(grouped(rows)) for rows in _row_chunks(R, M, S, width)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _gather_form(pre, idx, center, w1, w2):
    R, M, S = idx.shape
    width = max(w1.shape[1], w2.shape[1])

    def grouped(rows):
        return group_points(pre[rows], idx[rows]) - center[rows][:, :, None, :]

    return grouped, R, M, S, width


def fused_gathered_mlp_pool_plain(pre, idx, center, w1, b1, w2, b2):
    """Plain PyTorch version of the eval kernel: the grouped slab made in
    full, a chunk of rows at a time."""
    return _chunked(lambda x0: _pool_plain(x0, w1, b1, w2, b2),
                    *_gather_form(pre, idx, center, w1, w2))


def fused_gathered_mlp_pool_train_plain(pre, idx, center, w1, b1, w2, b2):
    """Plain PyTorch version of the training kernel, differentiable by
    autograd -> (out (R, M, C3), argmax (R, M, C3) i32, ppre (R, M, C3)),
    the first argmax as ``_pool_train_plain`` takes it."""
    return _chunked(lambda x0: _pool_train_plain(x0, w1, b1, w2, b2),
                    *_gather_form(pre, idx, center, w1, w2))


def fused_gathered_mlp_pool_backward_plain(pre, idx, center, w1, b1, w2, b2,
                                           grad):
    """The gradients of ``fused_gathered_mlp_pool_train_plain`` for the
    output gradient ``grad``, by autograd -> (d_pre, d_center, dW1, db1,
    dW2, db2)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in
                  (pre, center, w1, b1, w2, b2)]
        out = fused_gathered_mlp_pool_train_plain(
            leaves[0], idx, leaves[1], *leaves[2:])[0]
        return torch.autograd.grad(out, leaves, grad)


# rows of the backward kernel's tiles of reached slots (csrc/fused_sa_bwd.cu)
BWD_TILE = 64


def reached_slots(dval: torch.Tensor, argmax: torch.Tensor,
                  S: int) -> torch.Tensor:
    """(R·M, S) bool: slot s of group g is reached when some channel has
    ``argmax[g, c] == s`` and ``dval[g, c] != 0``. Only reached slots get a
    non-zero d_x1, and so a dW1, db1, d_x0 and d_center term; the kernel
    builds the same S-bit mask per group."""
    G = dval.shape[0] * dval.shape[1]
    live = (dval != 0).reshape(G, -1)
    reached = torch.zeros(G, S, dtype=torch.bool, device=dval.device)
    rows = torch.arange(G, device=dval.device)[:, None].expand_as(live)
    reached[rows[live], argmax.reshape(G, -1).long()[live]] = True
    return reached


def pack_tiles(counts, per_block: int | None = None,
               tile: int = BWD_TILE) -> list[list[int]]:
    """The backward kernel's packing of groups into tiles: ``counts`` are
    the groups' reached-slot counts (at most ``tile`` each), taken in order
    in runs of ``per_block`` groups (a block's run, ``block_runs``; all of
    them by default);
    a group with no reached slot takes no row, and a group that does not fit
    the rows left in the tile starts the next one, so no group is split.
    -> the tiles, each a list of group indices."""
    counts = [int(c) for c in counts]
    per_block = per_block or max(len(counts), 1)
    tiles: list[list[int]] = []
    for b0 in range(0, len(counts), per_block):
        rows, cur = 0, []
        for g in range(b0, min(b0 + per_block, len(counts))):
            c = counts[g]
            if c == 0:
                continue
            if rows + c > tile:
                tiles.append(cur)
                rows, cur = 0, []
            cur.append(g)
            rows += c
        if cur:
            tiles.append(cur)
    return tiles


def block_runs(counts, blocks: int, tile: int = BWD_TILE) -> list[range]:
    """The backward kernel's split of the groups among its ``blocks``
    blocks: ``counts`` the groups' reached-slot counts; each block that
    takes part takes a contiguous run of whole groups, cut where the rows
    before it reach a multiple of target = max(``tile``, ⌈total / blocks⌉)
    rows, so that a small problem runs on a few blocks of whole tiles and
    the blocks past the rows take none. -> the runs of group indices, one
    per block that takes part."""
    counts = [int(c) for c in counts]
    total = sum(counts)
    target = max(tile, -(-total // blocks))
    active = -(-total // target)
    cum = list(itertools.accumulate(counts))

    def cut(k):  # the first group whose rows before it reach k·target
        at = k * target
        return 0 if at <= 0 else min(bisect.bisect_left(cum, at) + 1,
                                     len(counts))

    return [range(cut(k), cut(k + 1) if k + 1 < active else len(counts))
            for k in range(active)]


def _routed_core(x0, g_row, s_row, w1, b1, w2, dval, argmax, S):
    """The routed backward's arithmetic on the reached rows x0 (the
    pre-ReLU layer-0 input of each reached (group g_row, slot s_row), in the
    kernel's order) -> (d_x0 of those rows, dW1, db1, dW2ᵀ)."""
    G, C3 = dval.shape[0] * dval.shape[1], w2.shape[1]
    row_of = torch.full((G, S), -1, dtype=torch.long, device=x0.device)
    row_of[g_row, s_row] = torch.arange(g_row.numel(), device=x0.device)
    a0 = torch.relu(x0)
    x1 = a0 @ w1 + b1
    a1 = torch.relu(x1)
    # the live channels, each routed to its argmax row
    flat_dval = dval.reshape(G, C3)
    g_ch, c_ch = (flat_dval != 0).nonzero(as_tuple=True)
    r_ch = row_of[g_ch, argmax.reshape(G, C3)[g_ch, c_ch].long()]
    d_ch = flat_dval[g_ch, c_ch]
    d_a1 = torch.zeros_like(a1).index_add_(0, r_ch, d_ch[:, None] * w2.T[c_ch])
    dw2t = torch.zeros(C3, w2.shape[0], dtype=x0.dtype, device=x0.device)
    dw2t.index_add_(0, c_ch, a1[r_ch] * d_ch[:, None])
    d_x1 = torch.where(x1 > 0, d_a1, 0.0)
    d_x0 = torch.where(x0 > 0, d_x1 @ w1.T, 0.0)
    return d_x0, a0.T @ d_x1, d_x1.sum(dim=0), dw2t


def _ordered_sum(shape, batch, point, rows):
    """(R, N, C) zeros with each row of ``rows`` added at (batch, point), in
    the rows' order: ``index_add_`` over the flat rows, which on the CPU adds
    in source order, the order in which the backward kernel sums."""
    R, N, C = shape
    flat = torch.zeros(R * N, C, dtype=rows.dtype, device=rows.device)
    return flat.index_add_(0, batch * N + point, rows).view(R, N, C)


def reached_rows_sum(shape, idx, dval, argmax, rows):
    """The gather-form backward kernel's d_pre from its own reached rows'
    d_x0 (``fused_gathered_mlp_pool_backward``'s ``rows_out``), summed as
    the kernel sums them: each point's rows in ascending (group·S + slot)
    order. Run it on the CPU to hold the kernel's d_pre to the bit."""
    R, M, S = idx.shape
    reached = reached_slots(dval, argmax, S)
    g_row, s_row = reached.nonzero(as_tuple=True)
    point = idx.reshape(R * M, S)[g_row, s_row].long()
    return _ordered_sum(shape, g_row // M, point, rows)


def _routed_rows(pre, idx, center, w1, b1, w2, dval, argmax):
    """The routed backward of the gather form on a chunk of rows -> (d_pre,
    d_center, dW1, db1, dW2ᵀ) of the chunk."""
    R, M, S = idx.shape
    C1 = pre.shape[2]
    G = R * M
    reached = reached_slots(dval, argmax, S)
    # the reached rows in the kernel's order (group, then slot)
    g_row, s_row = reached.nonzero(as_tuple=True)
    batch = g_row // M
    point = idx.reshape(G, S)[g_row, s_row].long()
    x0 = pre[batch, point] - center.reshape(G, C1)[g_row]
    d_x0, dw1, db1, dw2t = _routed_core(x0, g_row, s_row, w1, b1, w2, dval,
                                        argmax, S)
    d_pre = _ordered_sum(pre.shape, batch, point, d_x0)
    d_center = torch.zeros(G, C1, dtype=pre.dtype, device=pre.device)
    d_center.index_add_(0, g_row, -d_x0)
    return d_pre, d_center.view(R, M, C1), dw1, db1, dw2t


@torch.no_grad()
def fused_gathered_mlp_pool_backward_routed_plain(pre, idx, center, w1, b1,
                                                  w2, b2, grad, argmax, ppre):
    """Plain PyTorch version of the backward kernel's arithmetic: the
    gradients for the output gradient ``grad``, routed by the training
    forward's ``argmax`` where its pre-ReLU value ``ppre`` is > 0, over the
    reached slots alone (``reached_slots``), a chunk of rows at a time ->
    (d_pre, d_center, dW1, db1, dW2, db2). Layer 1 is recomputed on the
    reached rows only; d_a1 and dW2 take each live channel's dval at its
    argmax row. With the plain training forward's argmax and ppre it equals
    ``fused_gathered_mlp_pool_backward_plain``."""
    R, M, S = idx.shape
    dval = torch.where(ppre > 0, grad, 0.0)
    d_pre, d_center = torch.empty_like(pre), torch.empty_like(center)
    dw1, db1 = torch.zeros_like(w1), torch.zeros_like(b1)
    dw2t = torch.zeros_like(w2.T)
    for rows in _row_chunks(R, M, S, max(w1.shape[1], w2.shape[1])):
        parts = _routed_rows(pre[rows], idx[rows], center[rows], w1, b1, w2,
                             dval[rows], argmax[rows])
        d_pre[rows], d_center[rows] = parts[0], parts[1]
        dw1 += parts[2]
        db1 += parts[3]
        dw2t += parts[4]
    return d_pre, d_center, dw1, db1, dw2t.T, dval.sum(dim=(0, 1))


def _check_tensors(*named):
    """Raise unless each (tensor, name, ndim) is an f32 CUDA tensor of that
    rank, contiguous and 16-byte aligned."""
    for t, name, ndim in named:
        _build.check_cuda_tensor(t, name, torch.float32, ndim)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


# Shapes the kernels take. These mirror the launch plans in csrc/: the
# forward's chunk rows (fused_sa.cu::rows_per_warp), the backward's tile
# (fused_sa_bwd.cu::plan_launch) and the BatchNorm chain's widths
# (fused_sa_bn.cu), all against the shared memory a block may use.
SMEM_MAX = 232448  # bytes of shared memory a block may use on sm_90
BN_MAX_WIDTH = 1024  # the widest layer of the BatchNorm chain's training form
_KC, _WARPS = 32, 8  # weight rows per staged slice; warps per block
# the backward's two tile plans, its scan of eight parts and its static part
# range
_PLAN_BYTES = 2 * 1424 + 12 * _WARPS + 16


def forward_rows_per_warp(S: int, C1: int, C2: int, C3: int) -> int:
    """The forward kernel's chunk rows per warp at (S, C1, C2, C3): 8
    (64-slot chunks) for S > 32, else the fewest that hold S, halved while
    the chunk's x0 and a1 overflow shared memory; 0 where even one row per
    warp does not fit."""
    tm = 8 if S > 32 else 4 if S > 16 else 2 if S > 8 else 1
    ct3 = 256 if C3 % 256 == 0 else 128
    while tm >= 1:
        floats = _WARPS * tm * (C1 + C2) + (_KC + _WARPS) * ct3
        if 4 * floats <= SMEM_MAX:
            return tm
        tm //= 2
    return 0


def shipped_shape(slab: bool, R: int, S: int, C1: int, C2: int,
                  C3: int) -> bool:
    """Whether a forward at (R, S, C1, C2, C3) takes the shipped shapes'
    kernel (fused_sa.cu::shipped_shape): S 16, 32 or 64, C1 up to 256, C2
    128 (or 256 in the gather form), C3 128 or 256, R up to 65535; else the
    wide kernel."""
    return (S in (16, 32, 64) and C1 <= 256 and C3 in (128, 256)
            and (C2 == 128 or (not slab and C2 == 256)) and R <= 65535)


SLAB_ROWS = 64  # rows of a block of the shipped kernel at most: 8 warps x 8
# the packed slab launch takes 64 / S groups per block from this many
# groups on, by S. Device times on an H100 at the shapes chip_smoke.py
# sweeps (PERF.md), eval and train forward: packed faster at each swept
# count at or above it; below it, one group per block faster at every swept
# count at S 16 (128, 256) and at S 32's 128, mixed at S 32's 384 (eval
# faster, train slower) and 7% slower at its 256
SLAB_PACK_MIN_GROUPS = {16: 384, 32: 512}


def slab_groups_per_block(R: int, M: int, S: int, C1: int, C2: int,
                          C3: int) -> int:
    """G, the (row, center) groups each block of the slab form's forward
    takes (its C entries check it): at the shipped shapes with S 16 or 32
    and at least ``SLAB_PACK_MIN_GROUPS[S]`` groups, as many as fill a
    block of ``SLAB_ROWS`` rows (4 at S 16, 2 at S 32); else 1."""
    if (S in SLAB_PACK_MIN_GROUPS and shipped_shape(True, R, S, C1, C2, C3)
            and R * M >= SLAB_PACK_MIN_GROUPS[S]):
        return SLAB_ROWS // S
    return 1


def _bwd_smem(tm, nbuf, c1, c2, c3, dw2_shared):
    T = 8 * tm
    da = max(T * max(c1, c2), T * 128 + _KC * 128 if c1 > 128 else _KC * 128)
    scratch = _KC * 128 + T * 64
    floats = nbuf * T * c1 + T * c2 + da
    if not (c2 == 128 and da >= scratch):
        floats += scratch
    if dw2_shared:
        floats += c3 * c2
    return _PLAN_BYTES + 4 * floats


def backward_plan(C1: int, C2: int, C3: int):
    """The backward kernel's (tile rows per warp, tile buffers, dW2 in
    shared memory) at these widths, or None where no tile fits."""
    for nbuf in (2, 1):
        if _bwd_smem(8, nbuf, C1, C2, C3, True) <= SMEM_MAX:
            return 8, nbuf, True
    for tm in (8, 4, 2, 1):
        for nbuf in (2, 1):
            if _bwd_smem(tm, nbuf, C1, C2, C3, False) <= SMEM_MAX:
                return tm, nbuf, False
    return None


def kernels_take(S: int, C1: int, C2: int, C3: int, form: str = "gather",
                 train: bool = True) -> bool:
    """Whether the CUDA kernels of a fused form take a level of S slots per
    group and widths C1 -> C2 -> C3: ``form`` "gather", "slab" or "bn" (the
    slab form with BatchNorm), ``train`` its training form (the backward's
    or the BatchNorm chain's kernels) beside the eval forward. Any R and M
    (R·M below 2^31). The forward takes S a positive multiple of 8, C1 a
    multiple of 4, C2 and C3 multiples of 128, while one row per warp of x0
    and a1 fits in shared memory (C1 + C2 up to 5888); the backward C1 a
    multiple of 128 too, while its smallest tile fits (C1 = C2 = C3 up to
    2176); the BatchNorm chain's training form every width a
    multiple of 128 up to ``BN_MAX_WIDTH``. Every shape tpu3d's
    ``fused_sa_supported`` admits with widths up to 1024 passes."""
    if (S < 8 or S % 8 or C1 < 4 or C1 % 4 or C2 < 128 or C2 % 128
            or C3 < 128 or C3 % 128 or not forward_rows_per_warp(S, C1, C2,
                                                                   C3)):
        return False
    if not train:
        return True
    if form == "bn":
        return all(c % 128 == 0 and c <= BN_MAX_WIDTH for c in (C1, C2, C3))
    return C1 % 128 == 0 and backward_plan(C1, C2, C3) is not None


def _check(pre, idx, center, w1, b1, w2, b2, train=False):
    """Raise unless the CUDA kernels take these tensors; -> (R, N, M, S, C1,
    C2, C3)."""
    _check_tensors((pre, "pre", 3), (center, "center", 3), (w1, "w1", 2),
                   (b1, "b1", 1), (w2, "w2", 2), (b2, "b2", 1))
    _build.check_cuda_tensor(idx, "idx", torch.int32, 3)
    R, N, C1 = pre.shape
    M, S = idx.shape[1], idx.shape[2]
    C2, C3 = w1.shape[1], w2.shape[1]
    if (idx.shape[0] != R or center.shape != (R, M, C1)
            or w1.shape[0] != C1 or b1.shape != (C2,)
            or w2.shape[0] != C2 or b2.shape != (C3,)):
        raise ValueError(
            f"fused_sa shapes disagree: pre {tuple(pre.shape)}, idx "
            f"{tuple(idx.shape)}, center {tuple(center.shape)}, w1 "
            f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"b2 {tuple(b2.shape)}")
    if not kernels_take(S, C1, C2, C3, "gather", train) or R * M >= 2 ** 31:
        raise ValueError(
            f"the fused_sa kernels do not take R={R}, M={M}, S={S}, C1={C1}, "
            f"C2={C2}, C3={C3} (kernels_take)")
    return R, N, M, S, C1, C2, C3


def _pooled(R, M, C3, device, train, dtype=torch.float32):
    """A forward kernel's outputs: out (R, M, C3) in ``dtype``, and for the
    training form also the argmax slot (i32) and ppre (f32)."""
    out = torch.empty(R, M, C3, dtype=dtype, device=device)
    if not train:
        return (out,)
    return (out, torch.empty(R, M, C3, dtype=torch.int32, device=device),
            torch.empty(R, M, C3, dtype=torch.float32, device=device))


def _gather_forward(kernel, pre, idx, center, w1, b1, w2, b2, train=False):
    """Launch a forward kernel of the gather form -> ``_pooled``'s
    outputs."""
    R, N, M, S, C1, C2, C3 = _check(pre, idx, center, w1, b1, w2, b2)
    outs = _pooled(R, M, C3, pre.device, train)
    _build.launch(kernel, pre.data_ptr(), idx.data_ptr(), center.data_ptr(),
                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  R, N, M, S, C1, C2, C3, *(t.data_ptr() for t in outs))
    return outs


def fused_gathered_mlp_pool_train(pre, idx, center, w1, b1, w2, b2):
    """The training forward alone -> (out, argmax, ppre) as
    ``fused_gathered_mlp_pool_train_plain`` gives them: the kernel for CUDA
    tensors, else the plain version."""
    if pre.device.type == "cpu":
        return fused_gathered_mlp_pool_train_plain(pre, idx, center, w1, b1,
                                                   w2, b2)
    return _gather_forward("fused_sa_train", pre, idx, center, w1, b1, w2, b2,
                           train=True)


def _bwd_blocks(groups: int, c1: int, c2: int, c3: int) -> int:
    """The backward kernel's block count for ``groups`` groups at these
    widths (about four per SM, fewer where their workspace slices would pass
    512 MiB)."""
    fn = _build.library("fused_sa_bwd").tpu3d_fused_sa_bwd_blocks
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(groups, c1, c2, c3)


def _bwd_scratch(groups: int, S: int, c1: int, c2: int, c3: int, device):
    """The backward's plan scratch (masks, prefix sums, counts: 24 bytes a
    (group, segment))."""
    fn = _build.library("fused_sa_bwd").tpu3d_fused_sa_bwd_scratch
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return torch.empty(fn(groups, S, c1, c2, c3), dtype=torch.uint8,
                       device=device)


def _bwd_inverse_ints(R: int, N: int, M: int, S: int) -> int:
    """Ints of the gather form's inverse of its ids (offsets, then keys)."""
    fn = _build.library("fused_sa_bwd").tpu3d_fused_sa_bwd_inverse
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(R, N, M, S)


def _launch_backward(kernel, head, dims, outs, w1, b1, w2, grad, argmax,
                     ppre, rows_out=None):
    """Launch the backward ``kernel`` of either form. ``head`` are the form's
    leading input tensors, ``dims`` its sizes (R, ..., M, S), ``outs`` the
    input gradients it writes; both forms then take W1, W1ᵀ, b1, W2ᵀ, dval,
    argmax, the widths, the block count, the workspace of the deterministic
    block-partials reduction and the plan's scratch. The gather form runs
    its plan first and reads the reached rows' count from it (one wait for
    the card), to size the buffer of the reached rows' d_x0, which it then
    adds into d_pre in a fixed order; ``rows_out``, a list, receives that
    buffer. -> (dW1, db1, dW2, db2)."""
    R, M, S = dims[0], dims[-2], dims[-1]
    C1, C2, C3 = w1.shape[0], w1.shape[1], w2.shape[1]
    for t, name in ((grad, "grad"), (ppre, "ppre")):
        _build.check_cuda_tensor(t, name, torch.float32, 3)
    _build.check_cuda_tensor(argmax, "argmax", torch.int32, 3)
    if grad.shape != (R, M, C3) or argmax.shape != grad.shape \
            or ppre.shape != grad.shape:
        raise ValueError(f"{kernel}'s gradient, argmax and ppre must be "
                         f"{(R, M, C3)}")
    dval = torch.where(ppre > 0, grad, 0.0)
    w1t = w1.t().contiguous()
    w2t = w2.t().contiguous()
    blocks = _bwd_blocks(R * M, C1, C2, C3)
    per = C1 * C2 + C3 * C2 + C2
    ws = torch.empty(blocks, per, dtype=torch.float32, device=grad.device)
    sums = torch.empty(per, dtype=torch.float32, device=grad.device)
    scratch = _bwd_scratch(R * M, S, C1, C2, C3, grad.device)
    tail = ()
    if kernel == "fused_sa_bwd":
        N = dims[1]
        _build.launch_part("fused_sa_bwd_plan", dval.data_ptr(),
                           argmax.data_ptr(), *dims, C1, C2, C3, blocks,
                           outs[1].data_ptr(), scratch.data_ptr())
        nparts = scratch.numel() // 24
        total = int(scratch[8 * nparts:16 * nparts].view(torch.int64)[-1])
        rows = torch.empty(total, C1, dtype=torch.float32, device=grad.device)
        inv = torch.empty(_bwd_inverse_ints(R, N, M, S), dtype=torch.int32,
                          device=grad.device)
        if rows_out is not None:
            rows_out.append(rows)
        tail = (rows.data_ptr(), inv.data_ptr(), inv.numel())
    _build.launch(kernel, *(t.data_ptr() for t in head), w1.data_ptr(),
                  w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
                  dval.data_ptr(), argmax.data_ptr(), *dims, C1, C2, C3,
                  blocks, *(t.data_ptr() for t in outs), ws.data_ptr(),
                  scratch.data_ptr(), sums.data_ptr(), *tail)
    return (sums[:C1 * C2].view(C1, C2), sums[C1 * C2 + C3 * C2:],
            sums[C1 * C2:C1 * C2 + C3 * C2].view(C3, C2).t(),
            dval.sum(dim=(0, 1)))


def fused_gathered_mlp_pool_backward(pre, idx, center, w1, b1, w2, b2, grad,
                                     argmax, ppre, rows_out=None):
    """The backward alone, from the output gradient and the training
    forward's argmax and ppre -> (d_pre, d_center, dW1, db1, dW2, db2). The
    routed kernel for CUDA tensors (at the shapes ``kernels_take`` admits;
    others raise; ``rows_out``, a list, receives its reached rows' d_x0,
    which d_pre sums in ascending (group·S + slot) order, as
    ``reached_rows_sum`` does), else the plain version by autograd."""
    if pre.device.type == "cpu":
        return fused_gathered_mlp_pool_backward_plain(pre, idx, center, w1,
                                                      b1, w2, b2, grad)
    R, N, M, S, C1, C2, C3 = _check(pre, idx, center, w1, b1, w2, b2,
                                    train=True)
    d_pre = torch.empty_like(pre)
    d_center = torch.empty_like(center)
    return (d_pre, d_center, *_launch_backward(
        "fused_sa_bwd", (pre, idx, center), (R, N, M, S),
        (d_pre, d_center), w1, b1, w2, grad, argmax, ppre, rows_out))


class _FusedGatheredMLPPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre, idx, center, w1, b1, w2, b2):
        _check(pre, idx, center, w1, b1, w2, b2, train=True)
        out, argmax, ppre = fused_gathered_mlp_pool_train(
            pre, idx, center, w1, b1, w2, b2)
        ctx.save_for_backward(pre, idx, center, w1, b1, w2, b2, argmax, ppre)
        return out

    @staticmethod
    def backward(ctx, grad):
        pre, idx, center, w1, b1, w2, b2, argmax, ppre = ctx.saved_tensors
        d_pre, d_center, dw1, db1, dw2, db2 = fused_gathered_mlp_pool_backward(
            pre, idx, center, w1, b1, w2, b2, grad.contiguous(), argmax, ppre)
        return d_pre, None, d_center, dw1, db1, dw2, db2


def _dispatch(args, plain, train_plain, function, launch):
    """A fused op on ``args``: for CPU tensors its plain version, or its
    plain training form when a gradient is needed; for CUDA tensors the
    ``torch.autograd.Function`` (training kernel and backward) when a
    gradient is needed, else the eval kernel through ``launch``."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    if args[0].device.type == "cpu":
        return train_plain(*args)[0] if grad else plain(*args)
    return function.apply(*args) if grad else launch(*args)[0]


def fused_gathered_mlp_pool(pre: torch.Tensor, idx: torch.Tensor,
                            center: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor) -> torch.Tensor:
    """pre (R, N, C1) per-point layer-0 pre-activations, idx (R, M, S) i32
    group ids into N, center (R, M, C1) per-center term, w1 (C1, C2), b1
    (C2,), w2 (C2, C3), b2 (C3,) -> (R, M, C3):
        max_s ReLU(ReLU(ReLU(pre[idx] - center) @ w1 + b1) @ w2 + b2).

    Differentiable in every input but idx, with the max-pool's gradient on
    the first slot that reaches the max. The CUDA kernels take f32 tensors
    at the shapes ``kernels_take`` admits (S a multiple of 8, C2 and C3
    multiples of 128, C1 a multiple of 4, of 128 for the backward; every
    shape tpu3d's ``fused_sa_supported`` admits), and ids in [0, N) (an id
    outside stops the kernel with a device fault). A CUDA tensor outside
    that raises.
    """
    return _dispatch((pre, idx, center, w1, b1, w2, b2),
                     fused_gathered_mlp_pool_plain,
                     fused_gathered_mlp_pool_train_plain,
                     _FusedGatheredMLPPool,
                     lambda *a: _gather_forward("fused_sa", *a))


def fused_gather_supported(n: int) -> bool:
    """Whether the gather form takes an n-point source table (tpu3d's
    ``fused_gather_supported``: its kernel keeps the table in VMEM)."""
    return n % 128 == 0 and n <= 2048


def fused_sa_supported(shape, mlp) -> bool:
    """Whether a fused form takes this (R, M, S, C1) grouped slab and
    3-layer MLP: tpu3d's ``fused_sa_supported``, its shape test alone."""
    if len(mlp) != 3:
        return False
    _, m, s, c1 = shape
    return (s % 8 == 0 and (m * s) % max(s, 128) == 0 and c1 % 128 == 0
            and c1 == mlp[0] and all(c % 128 == 0 for c in mlp))


def sa_route(shape, mlp, n: int, bn: bool) -> str:
    """tpu3d's route for an RCNN set-abstraction level of ``shape`` = (R, M,
    S, C1) grouped slots over ``n`` source points per row: "gather" (the
    gather form, ``fused_gathered_mlp_pool``), "slab" (the slab form,
    ``fused_mlp_pool`` or, with BatchNorm, ``fused_bn_mlp_pool``) or "plain"
    (the SharedMLP and a max).

    It copies ``tpu3d/models/pointnet2.py:300-302``, ``:336-339`` and
    ``:416-419``: a level fuses only where it pre-groups its first layer
    (M·S slots outnumber its n points) and ``fused_sa_supported`` holds; it
    then takes the gather form without BatchNorm when
    ``fused_gather_supported(n)`` holds, else the slab form. tpu3d fuses only
    on the TPU (its ``bf16_ok`` clause); the port takes the TPU's route on
    both devices, as ``sampling.fused_route`` does, and on the CPU each
    route's plain version computes the same function, so the choice moves no
    CPU result."""
    _, m, s, _ = shape
    if m * s <= n or not fused_sa_supported(shape, mlp):
        return "plain"
    return "gather" if not bn and fused_gather_supported(n) else "slab"


# --------------------------------------------------------------------------
# the slab form: x0 (R, M, S, C1), the grouped layer-0 pre-activation, and
# per layer a per-channel affine packed as [mul0 | add0 | mul1 | add1 |
# mul2 | add2]
# --------------------------------------------------------------------------


def nobn_packs(c1: int, b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The no-BN chain's packs: mul = 1, add = (0, b1, b2). Differentiable
    in b1 and b2."""
    ones = b1.new_ones(c1)
    return torch.cat([ones, torch.zeros_like(ones), torch.ones_like(b1), b1,
                      torch.ones_like(b2), b2])


def bn_packs(affines) -> torch.Tensor:
    """The BatchNorm chain's packs from its three layers' eval affines
    ((mul, add) each, as ``models.pointnet2.BatchNorm.affine`` folds the
    running statistics)."""
    return torch.cat([t for mul_add in affines for t in mul_add])


def _slab_chain(x0, packs, w1, w2):
    """The pre-ReLU x2·mul2 + add2 of a grouped (R, M, S, C1) chunk, where
    a_l = ReLU(x_l·mul_l + add_l) and x_{l+1} = a_l W_{l+1}."""
    c1, c2, c3 = x0.shape[-1], w1.shape[1], w2.shape[1]
    m0, a0, m1, a1, m2, a2 = packs.split([c1, c1, c2, c2, c3, c3])
    x1 = (torch.relu(x0 * m0 + a0) @ w1) * m1 + a1
    return (torch.relu(x1) @ w2) * m2 + a2


def _slab_form(x0, w1, w2):
    R, M, S, _ = x0.shape
    return (lambda rows: x0[rows]), R, M, S, max(w1.shape[1], w2.shape[1])


def fused_sa_slab_plain(x0, packs, w1, w2):
    """Plain PyTorch version of the slab eval kernel, a chunk of rows at a
    time: max over S of ReLU(x2·mul2 + add2)."""
    return _chunked(
        lambda x: torch.relu(_slab_chain(x, packs, w1, w2)).amax(dim=2),
        *_slab_form(x0, w1, w2))


def _nobn_slab_chain(x0, w1, b1, w2, b2):
    return _slab_chain(x0, nobn_packs(x0.shape[-1], b1, b2), w1, w2)


def fused_mlp_pool_plain(x0, w1, b1, w2, b2):
    """Plain PyTorch version of the no-BN slab eval kernel."""
    return fused_sa_slab_plain(x0, nobn_packs(x0.shape[-1], b1, b2), w1, w2)


def fused_mlp_pool_reference(x0, w1, b1, w2, b2, *, pool="max"):
    """tpu3d's oracle of the no-BN chain under its name: ReLU -> Dense ->
    ReLU -> Dense -> ReLU -> max over S on a (B, M, S, C1) slab, plain, on
    x0's device. ``pool`` picks the max-pool's gradient at ties: "max"
    splits it among the tied slots, "first" gives it to the first (the
    kernels' rule); the values are the same."""
    if pool == "first":
        return _pool_train_plain(x0, w1, b1, w2, b2)[0]
    return _pool_plain(x0, w1, b1, w2, b2)


def fused_mlp_pool_train_plain(x0, w1, b1, w2, b2):
    """Plain PyTorch version of the slab form's training kernel,
    differentiable by autograd -> (out, argmax i32, ppre), each
    (R, M, C3)."""
    def pool(x):
        return _first_max(_nobn_slab_chain(x, w1, b1, w2, b2))

    return _chunked(pool, *_slab_form(x0, w1, w2))


def fused_mlp_pool_backward_plain(x0, w1, b1, w2, b2, grad, argmax, ppre):
    """Plain PyTorch version of the slab form's backward kernel -> (d_x0,
    dW1, db1, dW2, db2) for the output gradient ``grad``, routed as the
    kernel routes it: each pooled channel's gradient goes to the training
    forward's slot ``argmax`` where its pre-ReLU value ``ppre`` is > 0.
    Autograd of the recomputed chain; with the plain training forward's
    argmax and ppre it equals autograd of ``fused_mlp_pool_train_plain``."""
    dval = torch.where(ppre > 0, grad, 0.0)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x0, w1, b1, w2, b2)]
        sel = torch.gather(_nobn_slab_chain(*leaves), 2,
                           argmax.long()[:, :, None, :])[:, :, 0]
        return torch.autograd.grad(sel, leaves, dval)


@torch.no_grad()
def fused_mlp_pool_backward_routed_plain(x0, w1, b1, w2, b2, grad, argmax,
                                         ppre):
    """Plain PyTorch version of the slab form's backward kernel, the routed
    walk: the gradients for ``grad``, routed by the training forward's
    ``argmax`` where ``ppre`` > 0, over the reached slots alone
    (``reached_slots``), a chunk of rows at a time -> (d_x0, dW1, db1, dW2,
    db2). Layer 1 is recomputed on the reached rows only; d_a1 and dW2 take
    each live channel's dval at its argmax row; every other slab row's
    gradient is 0. With the plain training forward's argmax and ppre it
    equals ``fused_mlp_pool_backward_plain``."""
    R, M, S, C1 = x0.shape
    dval = torch.where(ppre > 0, grad, 0.0)
    d_x0 = torch.zeros_like(x0)
    dw1, db1 = torch.zeros_like(w1), torch.zeros_like(b1)
    dw2t = torch.zeros_like(w2.T)
    for rows in _row_chunks(R, M, S, max(w1.shape[1], w2.shape[1])):
        x, dv, arg = x0[rows], dval[rows], argmax[rows]
        g_row, s_row = reached_slots(dv, arg, S).nonzero(as_tuple=True)
        flat = x.reshape(-1, S, C1)
        d_rows, *parts = _routed_core(flat[g_row, s_row], g_row, s_row, w1,
                                      b1, w2, dv, arg, S)
        d_flat = d_x0[rows].reshape(-1, S, C1)
        d_flat[g_row, s_row] = d_rows
        d_x0[rows] = d_flat.view(x.shape)
        dw1 += parts[0]
        db1 += parts[1]
        dw2t += parts[2]
    return d_x0, dw1, db1, dw2t.T, dval.sum(dim=(0, 1))


def _check_slab(x0, packs, w1, w2, train=False):
    """Raise unless the slab kernels take these tensors (``packs`` the
    forward's [mul | add] of each layer); -> (R, M, S, C1, C2, C3)."""
    _check_tensors((x0, "x0", 4), (packs, "packs", 1), (w1, "w1", 2),
                   (w2, "w2", 2))
    R, M, S, C1 = x0.shape
    C2, C3 = w1.shape[1], w2.shape[1]
    if (w1.shape[0] != C1 or w2.shape[0] != C2
            or packs.shape != (2 * (C1 + C2 + C3),)):
        raise ValueError(
            f"fused_sa_slab shapes disagree: x0 {tuple(x0.shape)}, w1 "
            f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, packs "
            f"{tuple(packs.shape)}")
    if not kernels_take(S, C1, C2, C3, "slab", train) or R * M >= 2 ** 31:
        raise ValueError(
            f"the fused_sa slab kernels do not take R={R}, M={M}, S={S}, "
            f"C1={C1}, C2={C2}, C3={C3} (kernels_take)")
    return R, M, S, C1, C2, C3


def _slab_forward(kernel, x0, packs, w1, w2, train=False, groups=None):
    """Launch a forward kernel of the slab form, with ``groups`` groups
    per block (default: ``slab_groups_per_block``) -> ``_pooled``'s
    outputs."""
    R, M, S, C1, C2, C3 = _check_slab(x0, packs, w1, w2)
    if groups is None:
        groups = slab_groups_per_block(R, M, S, C1, C2, C3)
    outs = _pooled(R, M, C3, x0.device, train)
    _build.launch(kernel, x0.data_ptr(), packs.data_ptr(), w1.data_ptr(),
                  w2.data_ptr(), R, M, S, C1, C2, C3, groups,
                  *(t.data_ptr() for t in outs))
    return outs


def fused_mlp_pool_train(x0, w1, b1, w2, b2):
    """The slab form's training forward alone -> (out, argmax, ppre) as
    ``fused_mlp_pool_train_plain`` gives them: the kernel for CUDA tensors,
    else the plain version."""
    if x0.device.type == "cpu":
        return fused_mlp_pool_train_plain(x0, w1, b1, w2, b2)
    return _slab_forward("fused_sa_slab_train", x0,
                         nobn_packs(x0.shape[-1], b1, b2), w1, w2,
                         train=True)


def fused_mlp_pool_backward(x0, w1, b1, w2, b2, grad, argmax, ppre):
    """The slab form's backward alone, from the output gradient and the
    training forward's argmax and ppre -> (d_x0, dW1, db1, dW2, db2): the
    routed kernel for CUDA tensors (the gather form's walk, reading the
    reached slots' slab rows; every other row's gradient 0), else the plain
    version."""
    if x0.device.type == "cpu":
        return fused_mlp_pool_backward_plain(x0, w1, b1, w2, b2, grad,
                                             argmax, ppre)
    _check_tensors((b1, "b1", 1), (b2, "b2", 1))
    R, M, S, *_ = _check_slab(x0, nobn_packs(x0.shape[-1], b1, b2), w1, w2,
                              train=True)
    d_x0 = torch.empty_like(x0)
    return (d_x0, *_launch_backward(
        "fused_sa_slab_bwd", (x0,), (R, M, S), (d_x0,), w1, b1, w2,
        grad, argmax, ppre))


class _FusedMLPPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, w1, b1, w2, b2):
        out, argmax, ppre = fused_mlp_pool_train(x0, w1, b1, w2, b2)
        ctx.save_for_backward(x0, w1, b1, w2, b2, argmax, ppre)
        return out

    @staticmethod
    def backward(ctx, grad):
        x0, w1, b1, w2, b2, argmax, ppre = ctx.saved_tensors
        return fused_mlp_pool_backward(x0, w1, b1, w2, b2, grad.contiguous(),
                                       argmax, ppre)


def fused_mlp_pool(x0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x0 (R, M, S, C1) the grouped layer-0 pre-activations, w1 (C1, C2),
    b1 (C2,), w2 (C2, C3), b2 (C3,) -> (R, M, C3):
        max_s ReLU(ReLU(ReLU(x0) @ w1 + b1) @ w2 + b2).

    The slab form of ``fused_gathered_mlp_pool``, for a level whose source
    table the gather form does not take. Differentiable in every input,
    with the max-pool's gradient on the first slot that reaches the max.
    The CUDA kernels read x0 in place as (R, M·S, C1), and take f32
    tensors at the shapes ``kernels_take`` admits (every shape tpu3d's
    ``fused_sa_supported`` admits); a CUDA tensor outside that raises.
    """
    return _dispatch((x0, w1, b1, w2, b2), fused_mlp_pool_plain,
                     fused_mlp_pool_train_plain, _FusedMLPPool,
                     lambda x0, w1, b1, w2, b2: _slab_forward(
                         "fused_sa_slab", x0, nobn_packs(x0.shape[-1], b1, b2),
                         w1, w2))


# --------------------------------------------------------------------------
# the BatchNorm chain: [BN -> ReLU -> Dense] x2 -> BN -> ReLU -> max over S,
# at eval with the running statistics folded into the slab kernel's packs,
# in training with the batch's statistics: three statistics passes (the
# last two writing x1 and x2) and a final reduction forward, two waves and
# an elementwise pass backward, every product once
# --------------------------------------------------------------------------

# the seven per-channel vectors of each layer in the training kernels' pack
MUL, ADD, R_INV, MU_R, SCALE, CA, CB = range(7)
STATS_KERNELS = ("fused_sa_bn_stats0", "fused_sa_bn_stats1",
                 "fused_sa_bn_stats2")


def _bn_affine(mean, var, gamma, beta, eps):
    """A BatchNorm layer's (mul, add, r = 1/√(var + ε)): tpu3d's
    ``_bn_consts``, in the order ``BatchNorm.affine`` folds them."""
    r = torch.rsqrt(var + eps)
    mul = r * gamma
    return mul, beta - mean * mul, r


def _layer_pack(mean, var, gamma, beta, eps, n, dbeta=None, dgamma=None):
    """One layer's (7, C) vectors of the training kernels' pack: mul, add,
    r, mean·r, s = gamma·r, and the backward's ca = s·Σd_y / n and cb =
    s·Σ(d_y·x̂) / n once its reductions are known (else 0)."""
    mul, add, r = _bn_affine(mean, var, gamma, beta, eps)
    if dbeta is None:
        ca = cb = torch.zeros_like(mul)
    else:
        ca, cb = mul * dbeta / n, mul * dgamma / n
    return torch.stack([mul, add, r, mean * r, mul, ca, cb])


def _pack(layers) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in layers]).contiguous()


def _unpack(pk, c1, c2, c3):
    return [t.view(7, -1) for t in pk.split([7 * c1, 7 * c2, 7 * c3])]


def _slots(x0, mesh):
    """The slots a statistic of the (R, M, S, C) slab x0 counts: this
    rank's, times the mesh's ranks (each holds as many)."""
    R, M, S, _ = x0.shape
    return R * M * S * (1 if mesh is None else mesh.size)


def _mean_var(sums, n, dtype):
    """Mean and biased variance E[x²] − mean² in ``dtype`` from the f64
    (Σx, Σx²) over n slots."""
    mean = sums[0] / n
    return mean.to(dtype), (sums[1] / n - mean * mean).to(dtype)


def _bn_train(x, gamma, beta, eps):
    """BatchNorm in training, as ``models.pointnet2.BatchNorm`` computes it
    (over the global batch under a data-parallel mesh) -> (y, mean, var)."""
    from ..parallel.mesh import batch_means  # the package imports ops

    axes = tuple(range(x.dim() - 1))
    mean, sq = batch_means((x, x * x), axes)
    var = sq - mean * mean
    return ((x - mean) * torch.rsqrt(var + eps)) * gamma + beta, mean, var


def _bn_chain_train(x0, w1, w2, gammas, betas, eps):
    """The BatchNorm chain with batch statistics up to layer 2's
    normalized output -> (y2, x2, means, vars), the statistics detached."""
    y0, m0, v0 = _bn_train(x0, gammas[0], betas[0], eps)
    x1 = torch.relu(y0) @ w1
    y1, m1, v1 = _bn_train(x1, gammas[1], betas[1], eps)
    x2 = torch.relu(y1) @ w2
    y2, m2, v2 = _bn_train(x2, gammas[2], betas[2], eps)
    return (y2, x2, tuple(m.detach() for m in (m0, m1, m2)),
            tuple(v.detach() for v in (v0, v1, v2)))


def fused_bn_mlp_pool_train_plain(x0, w1, w2, gammas, betas, eps=1e-5):
    """The BatchNorm chain in training, plain: tpu3d's
    ``fused_bn_mlp_pool_reference`` (batch statistics over every slot,
    biased variance) with the first-argmax pool, differentiable by autograd
    -> (out (R, M, C3), argmax i32, x2 at the argmax, means, vars), the
    three layers' statistics detached. Its operations are the SharedMLP's
    with batch statistics, one by one, so it gives that module's values and
    statistics to the bit."""
    y2, x2, means, vars_ = _bn_chain_train(x0, w1, w2, gammas, betas, eps)
    out, arg, _ = _first_max(y2)
    at = torch.gather(x2.detach(), 2, arg.long()[:, :, None, :])[:, :, 0]
    return out, arg, at, means, vars_


def fused_bn_mlp_pool_reference(x0, w1, w2, gammas, betas, *, stats=None,
                                eps=1e-5, pool="max"):
    """tpu3d's oracle of the BatchNorm chain under its name, from the plain
    versions above, on x0's device. ``stats`` None: training, -> (out,
    (means, vars)) over the batch's statistics; ``stats`` ((m0, v0), (m1,
    v1), (m2, v2)): eval with those, -> out. ``pool`` picks the max-pool's
    gradient at ties, as tpu3d's does: "max" splits it among the tied slots
    (``amax``), "first" gives it to the first (the kernels' rule); the
    values are the same."""
    if stats is not None:
        packs = bn_packs([_bn_affine(m, v, g, b, eps)[:2]
                          for (m, v), g, b in zip(stats, gammas, betas)])
        return torch.relu(_slab_chain(x0, packs, w1, w2)).amax(dim=2)
    if pool == "first":
        out, _, _, means, vars_ = fused_bn_mlp_pool_train_plain(
            x0, w1, w2, gammas, betas, eps)
        return out, (means, vars_)
    y2, _, means, vars_ = _bn_chain_train(x0, w1, w2, gammas, betas, eps)
    return torch.relu(y2).amax(dim=2), (means, vars_)


def fused_bn_mlp_pool_backward_plain(x0, w1, w2, gammas, betas, grad,
                                     eps=1e-5):
    """The gradients of ``fused_bn_mlp_pool_train_plain``'s output for
    ``grad``, by autograd -> (d_x0, dW1, dW2, dgammas, dbetas)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x0, w1, w2, *gammas, *betas)]
        out = fused_bn_mlp_pool_train_plain(
            leaves[0], leaves[1], leaves[2], leaves[3:6], leaves[6:9],
            eps)[0]
        g = torch.autograd.grad(out, leaves, grad)
    return g[0], g[1], g[2], tuple(g[3:6]), tuple(g[6:9])


def _widths(pk, *slabs):
    """(C1, C2, C3) of a pack whose last two layers are the slabs'
    widths."""
    c2, c3 = (t.shape[-1] for t in slabs)
    return pk.numel() // 7 - c2 - c3, c2, c3


def _wide(x):
    """A slab in its form's arithmetic: bf16 values read as f32, others as
    they are."""
    return x.float() if x.dtype == BF16 else x


def _stat_dtype(x):
    """The dtype of the statistics, gradients and reductions of the form
    whose slab is x: f32 for a bf16 slab, else the slab's."""
    return torch.promote_types(x.dtype, torch.float32)


def _rounding(x):
    """Where the form of the slab x rounds: kernel 9's bf16 form (bf16
    slabs) rounds each operand of a product and each layer's output to
    bf16, as tpu3d's kernels do (``_chain_to``, ``:234``, ``:261``,
    ``:278``, ``:297``); the f32 form rounds nothing."""
    return _r16 if x.dtype == BF16 else (lambda t: t)


def _sums(x, y=None):
    """(Σx, Σx·y) (2, C) in f64 over every slot of the f32 x (y = x by
    default), as the kernels sum them."""
    axes = tuple(range(x.dim() - 1))
    y = x if y is None else y
    return torch.stack([x.sum(dim=axes, dtype=torch.float64),
                        (x * y).sum(dim=axes, dtype=torch.float64)])


def _slab_rows(*slabs):
    """Row slices of (R, M, S, ·) slabs whose intermediates are near 64 MB
    (``_row_chunks``)."""
    R, M, S, _ = slabs[0].shape
    return _row_chunks(R, M, S, max(t.shape[-1] for t in slabs))


@torch.no_grad()
def fused_sa_bn_stats_plain(depth, x, mul=None, add=None, w=None):
    """Plain version of a statistics pass, a chunk of rows at a time. Depth
    0: (Σx, Σx²) (2, C) f64 of x = x0. Depth 1 / 2: the layer y = ReLU(x·mul
    + add) w on x = x0 or the stored x1 (mul and add of the layer before),
    in f32 -> ((Σy, Σy²) in f64, y), y the slab the kernel writes (x1 or
    x2). On a bf16 slab, the bf16 form: ReLU(x·mul + add) and w rounded to
    bf16, their product summed in f32 and rounded, y written in bf16 and
    summed as rounded."""
    if depth == 0:
        return sum(_sums(_wide(x[rows])) for rows in _slab_rows(x))
    rd = _rounding(x)
    w = rd(w)
    y = x.new_empty(*x.shape[:3], w.shape[1])
    sums = 0
    for rows in _slab_rows(x, y):
        v = rd(rd(torch.relu(_wide(x[rows]) * mul + add)) @ w)
        y[rows] = v
        sums = sums + _sums(v)
    return sums, y


@torch.no_grad()
def fused_sa_bn_final_plain(x2, mul, add):
    """Plain version of the final forward pass, a reduction over the stored
    x2 (R, M, S, C3) with layer 2's folded batch statistics -> (out, argmax
    i32, x2 at the argmax), each (R, M, C3). On a bf16 x2 the max and the
    first argmax are over ReLU(x2·mul + add) rounded to bf16 (tpu3d's
    ``_fwd_final_kernel``), out in bf16, x2 there in f32."""
    rd = _rounding(x2)

    def pool(x):
        xf = _wide(x)
        out, arg, _ = _first_max(rd(xf * mul + add))
        return (out.to(x2.dtype), arg,
                torch.gather(xf, 2, arg.long()[:, :, None, :])[:, :, 0])

    return _chunked(pool, lambda rows: x2[rows], *x2.shape[:3],
                    x2.shape[-1])


def _d_x2(x2, l2, dval, argmax):
    """d_x2 = [slot = argmax]·dval − c2a − c2b·x̂2 on every slot."""
    slots = torch.arange(x2.shape[2], device=x2.device)[:, None]
    sel = slots == argmax[:, :, None, :]
    return (torch.where(sel, dval[:, :, None, :], 0.0) - l2[CA]
            - l2[CB] * (x2 * l2[R_INV] - l2[MU_R]))


def _d_x1(d_y1, x1, l1):
    """d_x1 = s1·d_y1 − c1a − c1b·x̂1."""
    return l1[SCALE] * d_y1 - l1[CA] - l1[CB] * (x1 * l1[R_INV] - l1[MU_R])


def _masked(d, x, layer):
    """(d where y = x·mul + add > 0, else 0; x̂ = x·r − mean·r)."""
    return (torch.where(x * layer[MUL] + layer[ADD] > 0, d, 0.0),
            x * layer[R_INV] - layer[MU_R])


def _flat(t):
    return t.reshape(-1, t.shape[-1])


@torch.no_grad()
def fused_sa_bn_wave1_plain(x2, x1, pk, w2, dval, argmax):
    """Plain version of backward wave 1, tpu3d's ``_bwd_wave1_kernel``,
    from the stored x2 and x1, a chunk of rows at a time: d_x2 = [slot =
    argmax]·dval − c2a − c2b·x̂2, d_y1 = (d_x2 W2ᵀ)[y1 > 0] -> ((Σd_y1,
    Σd_y1·x̂1) (2, C2) f64, dW2 = a1ᵀ d_x2, d_y1 (R, M, S, C2)). On bf16
    slabs d_x2, W2 and a1 enter the products rounded to bf16; d_y1 and dW2
    stay f32."""
    rd = _rounding(x2)
    w2t = rd(w2).T
    _, l1, l2 = _unpack(pk, *_widths(pk, x1, x2))
    sd = _stat_dtype(x1)
    d_y1 = torch.empty(x1.shape, dtype=sd, device=x1.device)
    sums = 0
    dw2 = torch.zeros(x1.shape[-1], x2.shape[-1], dtype=sd, device=x1.device)
    for rows in _slab_rows(x1, x2):
        x1r = _wide(x1[rows])
        d_x2 = rd(_d_x2(_wide(x2[rows]), l2, dval[rows], argmax[rows]))
        d, xh1 = _masked(d_x2 @ w2t, x1r, l1)
        d_y1[rows] = d
        sums = sums + _sums(d, xh1)
        dw2 += _flat(rd(torch.relu(x1r * l1[MUL] + l1[ADD]))).T @ _flat(d_x2)
    return sums, dw2, d_y1


@torch.no_grad()
def fused_sa_bn_wave2_plain(d_y1, x1, x0, pk, w1):
    """Plain version of backward wave 2, tpu3d's ``_bwd_wave2_kernel``,
    from the stored d_y1, x1 and x0, a chunk of rows at a time: d_x1 =
    s1·d_y1 − c1a − c1b·x̂1, d_y0 = (d_x1 W1ᵀ)[y0 > 0] -> ((Σd_y0,
    Σd_y0·x̂0) (2, C1) f64, dW1 = a0ᵀ d_x1, d_y0 (R, M, S, C1)). On bf16
    slabs d_x1, W1 and a0 enter the products rounded to bf16; d_y0 and dW1
    stay f32."""
    rd = _rounding(x0)
    w1t = rd(w1).T
    c1, c2 = x0.shape[-1], x1.shape[-1]
    l0, l1, _ = _unpack(pk, c1, c2, pk.numel() // 7 - c1 - c2)
    sd = _stat_dtype(x0)
    d_y0 = torch.empty(x0.shape, dtype=sd, device=x0.device)
    sums, dw1 = 0, torch.zeros(c1, c2, dtype=sd, device=x0.device)
    for rows in _slab_rows(x0, x1):
        x0r = _wide(x0[rows])
        d_x1 = rd(_d_x1(d_y1[rows], _wide(x1[rows]), l1))
        d, xh0 = _masked(d_x1 @ w1t, x0r, l0)
        d_y0[rows] = d
        sums = sums + _sums(d, xh0)
        dw1 += _flat(rd(torch.relu(x0r * l0[MUL] + l0[ADD]))).T @ _flat(d_x1)
    return sums, dw1, d_y0


@torch.no_grad()
def fused_sa_bn_apply_plain(d_y0, x0, pk):
    """Plain version of the last backward pass, tpu3d's
    ``_bwd_apply_kernel``: d_x0 = s0·d_y0 − c0a − c0b·x̂0, in x0's dtype
    (rounded to bf16 once in the bf16 form)."""
    l0 = pk[:7 * x0.shape[-1]].view(7, -1)
    d_x0 = torch.empty_like(x0)
    for rows in _slab_rows(x0):
        d_x0[rows] = (l0[SCALE] * d_y0[rows] - l0[CA]
                      - l0[CB] * (_wide(x0[rows]) * l0[R_INV] - l0[MU_R]))
    return d_x0


def _check_bn(*slabs, grads=()):
    """Raise unless the training kernels take these (R, M, S, C) slabs, of
    one (R, M, S): ``slabs`` the chain's (x0, x1, x2), all f32 (the f32
    form) or all bf16 (the bf16 form), ``grads`` f32 gradient slabs (d_y1,
    d_y0); -> (R·M·S, S, the form's dtype)."""
    form = slabs[0].dtype
    if form not in (torch.float32, BF16):
        raise ValueError(f"the BatchNorm training kernels take f32 or bf16 "
                         f"slabs, got {form}")
    R, M, S, _ = slabs[0].shape
    for t, dtype in [(t, form) for t in slabs] + [(t, torch.float32)
                                                   for t in grads]:
        _build.check_cuda_tensor(t, "slab", dtype, 4)
        if t.data_ptr() % 16:
            raise ValueError("slab must be 16-byte aligned")
        c = t.shape[-1]
        if (t.shape[:3] != (R, M, S) or c % 128 or c > BN_MAX_WIDTH
                or R * M >= 2 ** 31):
            raise ValueError(
                f"the BatchNorm training kernels take (R, M, S, C) slabs of "
                f"one (R, M, S), C a multiple of 128 up to {BN_MAX_WIDTH}; "
                f"got {[tuple(t.shape) for t in slabs + tuple(grads)]}")
    return R * M * S, S, form


def _entry(name, form):
    """The counted entry of a training pass in the slabs' form: the f32
    kernel, or its bf16 form (``name``_bf16, in ``BF16_LAUNCHES``)."""
    return name + "_bf16" if form == BF16 else name


def _operand(w, form, design="simt"):
    """A weight as the form's products take it, contiguous: f32 in the f32
    form; in the bf16 form cast to bf16 once where the entry runs the
    tensor-core design (``bn_train_bf16_design``), else f32 rounded to bf16
    (the SIMT design's f32 slices)."""
    if form != BF16:
        return w.contiguous()
    if design == "wgmma":  # one pass: cast and lay out
        return w.to(BF16, memory_format=torch.contiguous_format)
    return _r16(w).contiguous()


def _bn_weight(w, name, form, kind, K, N):
    """The weight operand of a product of depth K and width N in the slabs'
    form (``_operand``), checked as the entry's design reads it: bf16 on
    the tensor-core design, else f32; contiguous, 16-byte aligned."""
    design = _bn_design(kind, K, N) if form == BF16 else "simt"
    w = _operand(w, form, design)
    _build.check_cuda_tensor(w, name, BF16 if design == "wgmma"
                             else torch.float32, 2)
    if w.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return w


def _bn_workspace(kind, P, C, N, device, dtype):
    """A kernel's workspace: kind 0 stats0's, 1 a row product's, 2 a
    weight gradient's (csrc/fused_sa_bn.cu::tpu3d_fused_sa_bn_workspace)."""
    fn = _build.library("fused_sa_bn").tpu3d_fused_sa_bn_workspace
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return torch.empty(fn(kind, P, C, N) // dtype.itemsize, dtype=dtype,
                       device=device)


def fused_sa_bn_stats(depth, x, mul=None, add=None, w=None):
    """A statistics pass of the chain's training forward, as
    ``fused_sa_bn_stats_plain`` computes it: the kernel counted as
    ``fused_sa_bn_stats{depth}`` (``_bf16`` on a bf16 slab) for CUDA
    tensors (depth 0 a reduction of x0; depth 1 and 2 the row product
    writing x1 or x2 beside its sums), else the plain version."""
    if x.device.type == "cpu":
        return fused_sa_bn_stats_plain(depth, x, mul, add, w)
    P, _, form = _check_bn(x)
    name = _entry(STATS_KERNELS[depth], form)
    dev, K = x.device, x.shape[-1]
    sums = torch.empty(2, K if depth == 0 else w.shape[1],
                       dtype=torch.float64, device=dev)
    if depth == 0:
        ws = _bn_workspace(0, P, K, 0, dev, torch.float64)
        _build.launch(name, x.data_ptr(), P, K, ws.data_ptr(),
                      sums.data_ptr())
        return sums
    N = w.shape[1]
    w = _bn_weight(w, "w", form, "layer", K, N)
    _check_tensors((mul, "mul", 1), (add, "add", 1))
    if mul.shape != (K,) or add.shape != (K,) or w.shape[0] != K:
        raise ValueError(f"stats{depth}: mul, add ({K},) and w ({K}, N) "
                         f"expected, got {tuple(mul.shape)}, "
                         f"{tuple(add.shape)}, {tuple(w.shape)}")
    y = x.new_empty(*x.shape[:3], N)
    ws = _bn_workspace(1, P, K, N, dev, torch.float64)
    _build.launch(name, x.data_ptr(), mul.data_ptr(), add.data_ptr(),
                  w.data_ptr(), P, K, N, y.data_ptr(), ws.data_ptr(),
                  sums.data_ptr())
    return sums, y


def fused_sa_bn_final(x2, mul, add):
    """The chain's final forward pass -> (out, argmax, x2 at the argmax):
    the reduction kernel over the stored x2 (``fused_sa_bn_final``, or its
    bf16 form on a bf16 x2, out in bf16) for CUDA tensors, else
    ``fused_sa_bn_final_plain``."""
    if x2.device.type == "cpu":
        return fused_sa_bn_final_plain(x2, mul, add)
    _, _, form = _check_bn(x2)
    _check_tensors((mul, "mul", 1), (add, "add", 1))
    R, M, S, C3 = x2.shape
    outs = _pooled(R, M, C3, x2.device, True, form)
    _build.launch(_entry("fused_sa_bn_final", form), x2.data_ptr(),
                  mul.data_ptr(), add.data_ptr(), R * M, S, C3,
                  *(t.data_ptr() for t in outs))
    return outs


def fused_sa_bn_wave1(x2, x1, pk, w2, dval, argmax):
    """Backward wave 1 (``fused_sa_bn_wave1``, or its bf16 form on bf16
    slabs: a row product and a weight-gradient product) for CUDA tensors,
    else ``fused_sa_bn_wave1_plain``; the same outputs."""
    if x2.device.type == "cpu":
        return fused_sa_bn_wave1_plain(x2, x1, pk, w2, dval, argmax)
    P, S, form = _check_bn(x2, x1)
    R, M, _, C3 = x2.shape
    C1, C2, _ = _widths(pk, x1, x2)
    w2t = _bn_weight(w2.t(), "w2", form, "wave1", C3, C2)
    _check_tensors((pk, "pk", 1), (dval, "dval", 3))
    _build.check_cuda_tensor(argmax, "argmax", torch.int32, 3)
    if (dval.shape != (R, M, C3) or argmax.shape != dval.shape
            or w2.shape != (C2, C3) or C1 % 128 or C1 > BN_MAX_WIDTH):
        raise ValueError(f"wave 1: dval and argmax {(R, M, C3)}, w2 "
                         f"{(C2, C3)} and a pack of 7 (C1 + {C2} + {C3}) "
                         f"expected")
    dev = x2.device
    d_y1 = torch.empty(x1.shape, device=dev)
    sums = torch.empty(2, C2, dtype=torch.float64, device=dev)
    dw2 = torch.empty(C2, C3, device=dev)
    wsr = _bn_workspace(1, P, C3, C2, dev, torch.float64)
    wsd = _bn_workspace(2, P, C2, C3, dev, torch.float32)
    _build.launch(_entry("fused_sa_bn_wave1", form), x2.data_ptr(),
                  x1.data_ptr(), pk.data_ptr(), w2t.data_ptr(),
                  dval.data_ptr(), argmax.data_ptr(), P, S, C1, C2, C3,
                  d_y1.data_ptr(), wsr.data_ptr(), sums.data_ptr(),
                  wsd.data_ptr(), dw2.data_ptr())
    return sums, dw2, d_y1


def fused_sa_bn_wave2(d_y1, x1, x0, pk, w1):
    """Backward wave 2 (``fused_sa_bn_wave2``, or its bf16 form on bf16
    slabs: a row product and a weight-gradient product) for CUDA tensors,
    else ``fused_sa_bn_wave2_plain``; the same outputs (d_y0 in a new f32
    slab, into which ``fused_sa_bn_apply`` writes the f32 form's d_x0)."""
    if x0.device.type == "cpu":
        return fused_sa_bn_wave2_plain(d_y1, x1, x0, pk, w1)
    P, _, form = _check_bn(x1, x0, grads=(d_y1,))
    C1, C2 = x0.shape[-1], x1.shape[-1]
    C3 = pk.numel() // 7 - C1 - C2
    w1t = _bn_weight(w1.t(), "w1", form, "wave2", C2, C1)
    _check_tensors((pk, "pk", 1))
    if w1.shape != (C1, C2) or d_y1.shape != x1.shape or C3 % 128 \
            or not 0 < C3 <= BN_MAX_WIDTH:
        raise ValueError(f"wave 2: w1 {(C1, C2)}, d_y1 like x1 and a pack "
                         f"of 7 ({C1} + {C2} + C3) expected")
    dev = x0.device
    d_y0 = torch.empty(x0.shape, device=dev)
    sums = torch.empty(2, C1, dtype=torch.float64, device=dev)
    dw1 = torch.empty(C1, C2, device=dev)
    wsr = _bn_workspace(1, P, C2, C1, dev, torch.float64)
    wsd = _bn_workspace(2, P, C1, C2, dev, torch.float32)
    _build.launch(_entry("fused_sa_bn_wave2", form), d_y1.data_ptr(),
                  x1.data_ptr(), x0.data_ptr(), pk.data_ptr(),
                  w1t.data_ptr(), P, C1, C2, C3, d_y0.data_ptr(),
                  wsr.data_ptr(), sums.data_ptr(), wsd.data_ptr(),
                  dw1.data_ptr())
    return sums, dw1, d_y0


def fused_sa_bn_apply(d_y0, x0, pk):
    """The last backward pass: d_x0 = s0·d_y0 − c0a − c0b·x̂0, by
    ``fused_sa_bn_apply`` for CUDA tensors, written in place of d_y0 (->
    d_y0's buffer); on a bf16 x0 by its bf16 form, into a new bf16 slab.
    Else ``fused_sa_bn_apply_plain``."""
    if x0.device.type == "cpu":
        return fused_sa_bn_apply_plain(d_y0, x0, pk)
    P, _, form = _check_bn(x0, grads=(d_y0,))
    C1 = x0.shape[-1]
    _check_tensors((pk, "pk", 1))
    if form == BF16:
        d_x0 = torch.empty_like(x0)
        _build.launch("fused_sa_bn_apply_bf16", d_y0.data_ptr(),
                      x0.data_ptr(), pk.data_ptr(), P, C1, d_x0.data_ptr())
        return d_x0
    _build.launch("fused_sa_bn_apply", d_y0.data_ptr(), x0.data_ptr(),
                  pk.data_ptr(), P, C1)
    return d_y0


def fused_bn_mlp_pool_train(x0, w1, w2, gammas, betas, eps=1e-5):
    """The chain's training forward, tpu3d's ``_fused_train_fwd_impl``:
    three statistics passes, each normalising the layer before it with the
    statistics of the pass before, the last two writing x1 = a0 W1 and x2
    = a1 W2, then the final reduction over x2 -> (out, argmax, x2 at the
    argmax, means, vars, (x1, x2)), x1 and x2 kept for the backward. Each
    pass is its kernel for CUDA tensors, its plain version for CPU
    tensors. A bf16 x0 takes the bf16 form: x1, x2 and out in bf16, the
    statistics f32."""
    from ..parallel.mesh import active, reduce_sum_

    mesh = active()
    n = _slots(x0, mesh)
    w1, w2 = w1.contiguous(), w2.contiguous()
    means, vars_, layers = [], [], []

    def fold(sums, depth):
        mean, var = _mean_var(reduce_sum_(sums, mesh), n, _stat_dtype(x0))
        means.append(mean)
        vars_.append(var)
        layers.append(_layer_pack(mean, var, gammas[depth], betas[depth],
                                  eps, n))
        return layers[-1][MUL].contiguous(), layers[-1][ADD].contiguous()

    mul, add = fold(fused_sa_bn_stats(0, x0), 0)
    sums, x1 = fused_sa_bn_stats(1, x0, mul, add, w1)
    mul, add = fold(sums, 1)
    sums, x2 = fused_sa_bn_stats(2, x1, mul, add, w2)
    mul, add = fold(sums, 2)
    out, argmax, at = fused_sa_bn_final(x2, mul, add)
    return out, argmax, at, tuple(means), tuple(vars_), (x1, x2)


def fused_bn_mlp_pool_backward(x0, w1, w2, gammas, betas, means, vars_, out,
                               argmax, at, saved, grad, eps=1e-5, mesh=None):
    """The chain's backward, tpu3d's ``_fused_train_bwd``, from the output
    gradient and the training forward's statistics, out, argmax, x2 at the
    argmax and its stored (x1, x2) -> (d_x0, dW1, dW2, dgammas, dbetas).
    Layer 2's reductions come from the small (R, M, C3) tensors (the pooled
    gradient reaches x2 at the argmax slots alone; ReLU passes it where the
    pooled output is > 0); then wave 1, wave 2 and the elementwise pass,
    each its kernel for CUDA tensors, its plain version for CPU tensors.
    Under a data-parallel mesh (``mesh``) each reduction the packs take is
    the global batch's; the gradients returned are this rank's own, which
    the train step sums with the others'. In the bf16 form (bf16 x0, x1, x2
    and out) d_x0 comes back in bf16, the rest f32: the gradients of the
    BatchNorm outputs stay f32, as tpu3d's VJP keeps them."""
    from ..parallel.mesh import reduce_sum_

    n = _slots(x0, mesh)
    sd = _stat_dtype(x0)
    x1, x2 = saved
    w1, w2 = w1.contiguous(), w2.contiguous()
    layers = [_layer_pack(m, v, g, b, eps, n)
              for m, v, g, b in zip(means, vars_, gammas, betas)]
    mul2, r2 = layers[2][MUL], layers[2][R_INV]
    d_y2 = torch.where(out > 0, grad.to(sd), 0.0)
    dbeta2 = d_y2.sum(dim=(0, 1))
    dgamma2 = (d_y2 * (at * r2 - means[2] * r2)).sum(dim=(0, 1))

    def pack(depth, dbeta, dgamma):
        """The packs with layer ``depth``'s reductions, the global batch's
        (this rank's (dbeta, dgamma) summed over the mesh)."""
        glob = reduce_sum_(torch.stack([dbeta, dgamma]), mesh).to(sd)
        layers[depth] = _layer_pack(means[depth], vars_[depth],
                                    gammas[depth], betas[depth], eps, n,
                                    glob[0], glob[1])
        return _pack(layers)

    dval = (d_y2 * mul2).contiguous()
    sums, dw2, d_y1 = fused_sa_bn_wave1(x2, x1, pack(2, dbeta2, dgamma2), w2,
                                        dval, argmax)
    dbeta1, dgamma1 = sums.to(sd)
    sums, dw1, d_y0 = fused_sa_bn_wave2(d_y1, x1, x0, pack(1, *sums), w1)
    del d_y1
    dbeta0, dgamma0 = sums.to(sd)
    d_x0 = fused_sa_bn_apply(d_y0, x0, pack(0, *sums))
    return (d_x0, dw1, dw2, (dgamma0, dgamma1, dgamma2),
            (dbeta0, dbeta1, dbeta2))


class _FusedBNMLPPool(torch.autograd.Function):
    """Kernel 9's training form through its seven passes: the f32 form on
    an f32 x0, the bf16 form on a bf16 x0."""

    @staticmethod
    def forward(ctx, x0, w1, w2, g0, g1, g2, b0, b1, b2, eps):
        gammas, betas = (g0, g1, g2), (b0, b1, b2)
        out, argmax, at, means, vars_, (x1, x2) = fused_bn_mlp_pool_train(
            x0, w1, w2, gammas, betas, eps)
        from ..parallel.mesh import active

        ctx.eps, ctx.mesh = eps, active()
        ctx.save_for_backward(x0, w1, w2, *gammas, *betas, *means, *vars_,
                              out, argmax, at, x1, x2)
        ctx.mark_non_differentiable(*means, *vars_)
        return (out, *means, *vars_)

    @staticmethod
    def backward(ctx, grad, *_):
        t = ctx.saved_tensors
        d_x0, dw1, dw2, dgammas, dbetas = fused_bn_mlp_pool_backward(
            t[0], t[1], t[2], t[3:6], t[6:9], t[9:12], t[12:15], t[15],
            t[16], t[17], (t[18], t[19]), grad.contiguous(), ctx.eps,
            ctx.mesh)
        return (d_x0, dw1, dw2, *dgammas, *dbetas, None)


def fused_bn_mlp_pool(x0: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                      gammas, betas, stats=None, eps: float = 1e-5):
    """[BN -> ReLU -> Dense] x2 -> BN -> ReLU -> max over S, tpu3d's
    ``fused_bn_mlp_pool``: x0 (R, M, S, C1) the grouped layer-0
    pre-activations (Dense without bias), w1 (C1, C2), w2 (C2, C3), gammas
    and betas the three BatchNorm layers' scales and biases.

    ``stats`` ((mean, var) x3), the running statistics: eval, -> pooled
    (R, M, C3); each layer's (mul, add) folded as ``BatchNorm.affine``
    folds them, for CUDA tensors the slab eval kernel (counted as
    ``fused_sa_slab_bn``), which has no backward (a CUDA call that needs a
    gradient raises). ``stats`` None: training with the batch's statistics
    (over every slot, biased variance) -> (pooled, ((mean0, mean1, mean2),
    (var0, var1, var2))), the statistics not differentiable (the caller
    folds them into the running ones); differentiable in x0, w1, w2, gammas
    and betas, the max-pool's gradient on the first slot that reaches the
    max. For CUDA tensors its seven kernels (``fused_bn_mlp_pool_train``,
    ``fused_bn_mlp_pool_backward``), which keep x1 and x2 (R, M, S, C2 and
    C3 f32 slabs) from the forward to the backward, at the shapes
    ``kernels_take(..., "bn")`` admits (S a multiple of 8, widths multiples
    of 128 up to ``BN_MAX_WIDTH``); a CUDA tensor outside them raises. For
    CPU tensors the plain version at either.
    """
    cpu = x0.device.type == "cpu"
    if stats is None:
        if cpu:
            out, _, _, means, vars_ = fused_bn_mlp_pool_train_plain(
                x0, w1, w2, gammas, betas, eps)
            return out, (means, vars_)
        out, *st = _FusedBNMLPPool.apply(x0, w1, w2, *gammas, *betas, eps)
        return out, (tuple(st[:3]), tuple(st[3:]))
    packs = bn_packs([_bn_affine(m, v, g, b, eps)[:2]
                      for (m, v), g, b in zip(stats, gammas, betas)])
    if cpu:
        return fused_sa_slab_plain(x0, packs, w1, w2)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x0, w1, w2, packs)):
        raise NotImplementedError(
            "fused_bn_mlp_pool with running statistics is the eval kernel "
            "alone and has no backward; train with stats=None")
    return _slab_forward("fused_sa_slab_bn", x0, packs.contiguous(),
                         w1.contiguous(), w2.contiguous())[0]


# --------------------------------------------------------------------------
# the bf16 eval forms, under the accelerator's numerics contract
# (precision.py): tpu3d's eval kernels in their own arithmetic, bf16
# operands with f32 sums, rounded to bf16 at every layer boundary; the
# entries in csrc/fused_sa_bf16.cuh (kernels 5 and 8 on
# csrc/fused_sa_wgmma_eval.cuh's design where eval_bf16_design says so)
# --------------------------------------------------------------------------

BF16 = torch.bfloat16


def _r16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, kept in f32."""
    return x.to(BF16).float()


def _bf16_acts_nobn(b1, b2):
    """The no-BN chain's layer activations (``_chain_nobn``): a0 = ReLU(x0),
    a_k = ReLU(bf16(bf16(x_k) + bf16(b_k)))."""
    return (torch.relu,
            lambda x: torch.relu(_r16(_r16(x) + _r16(b1))),
            lambda x: torch.relu(_r16(_r16(x) + _r16(b2))))


def _bf16_acts_bn(packs, c1, c2, c3):
    """The BatchNorm chain's layer activations (``_chain_to``):
    a_k = bf16(ReLU(bf16(x_k)·mul_k + add_k)), the affine in f32."""
    m0, a0, m1, a1, m2, a2 = packs.float().split([c1, c1, c2, c2, c3, c3])
    return tuple((lambda x, m=m, a=a: _r16(torch.relu(_r16(x) * m + a)))
                 for m, a in ((m0, a0), (m1, a1), (m2, a2)))


def _bf16_pool(x0, w1, w2, acts):
    """max over S of a2 for a grouped bf16 (R, M, S, C1) chunk: each product
    of bf16-rounded f32 values summed in f32 -> (R, M, C3) bf16."""
    a0 = acts[0](x0.float())
    a1 = acts[1](a0 @ _r16(w1))
    return acts[2](a1 @ _r16(w2)).amax(dim=2).to(BF16)


def _bf16_gather_form(pre, idx, center, w1, w2):
    """The gather form's grouped bf16 slab x0 = bf16(pre[idx] - center), a
    chunk of rows at a time (``_gather_x0``)."""
    R, M, S = idx.shape
    width = max(w1.shape[1], w2.shape[1])

    def grouped(rows):
        return group_points(pre[rows], idx[rows]) - center[rows][:, :, None]

    return grouped, R, M, S, width


def fused_gathered_mlp_pool_bf16_plain(pre, idx, center, w1, b1, w2, b2):
    """Plain PyTorch version of the gather form's bf16 eval kernel
    (``_nobn2_eval_kernel``): pre (R, N, C1) and center (R, M, C1) bf16."""
    acts = _bf16_acts_nobn(b1, b2)
    return _chunked(lambda x0: _bf16_pool(x0, w1, w2, acts),
                    *_bf16_gather_form(pre, idx, center, w1, w2))


def fused_mlp_pool_bf16_plain(x0, w1, b1, w2, b2):
    """Plain PyTorch version of the slab form's bf16 eval kernel
    (``_nobn_eval_kernel``): x0 (R, M, S, C1) bf16."""
    acts = _bf16_acts_nobn(b1, b2)
    return _chunked(lambda x: _bf16_pool(x, w1, w2, acts),
                    *_slab_form(x0, w1, w2))


def fused_sa_slab_bn_bf16_plain(x0, packs, w1, w2):
    """Plain PyTorch version of the BatchNorm slab's bf16 eval kernel
    (``_eval_chain_kernel``): x0 (R, M, S, C1) bf16, ``packs`` the three
    layers' folded (mul, add) in f32 (``bn_packs``)."""
    acts = _bf16_acts_bn(packs, x0.shape[-1], w1.shape[1], w2.shape[1])
    return _chunked(lambda x: _bf16_pool(x, w1, w2, acts),
                    *_slab_form(x0, w1, w2))


def bf16_kernels_take(S: int, C1: int, C2: int, C3: int) -> bool:
    """Whether the bf16 kernels take a level of S slots per group and widths
    C1 -> C2 -> C3: C1 a multiple of 16, C2 and C3 multiples of 128, and a
    chunk of 16 rows of a0 and a1 in bf16 with the running max (with its
    slot and x2 in training) in shared memory, the layout of
    ``csrc/fused_sa_bf16.cuh``'s design, which every entry runs at widths
    the wgmma designs do not take. Those take C1 = C2 = 128 with layouts of
    their own: the eval forms of kernels 5, 8 and 9 C3 up to 512
    (``eval_bf16_design``, ``eval_wgmma_smem``), kernel 6's training
    forward C3 up to 384 (``train_bf16_design``, ``wgmma_smem``); kernel
    8's training forward runs the parent design at every width.
    Every shape tpu3d's ``fused_sa_supported`` admits with C1 + C2 below
    some 7000 passes."""
    smem = 16 * (C1 + 8 + C2 + 8) * 2 + 12 * C3
    return (S >= 1 and C1 >= 16 and C1 % 16 == 0 and C2 >= 128
            and C2 % 128 == 0 and C3 >= 128 and C3 % 128 == 0
            and smem <= SMEM_MAX)


def _carve(n: int) -> int:
    return -(-n // 1024) * 1024


def wgmma_smem(C1: int, C2: int, C3: int, warpgroups: int) -> int:
    """Bytes of shared memory the wgmma design of kernel 6's bf16 training
    forward (``fused_sa_train_bf16``) asks for (``csrc/fused_sa_wgmma.cuh``'s
    layout, 1024-byte regions): the weights, per warpgroup a 64-row stage of
    a0, two center rows and a 64-row a1, the biases, the pooling state (max,
    argmax, ppre), and room to align them. The eval forms' wgmma design has
    a layout of its own (``eval_wgmma_smem``)."""
    return sum(_carve(n) for n in (
        2 * C1 * C2, 2 * C2 * C3, 2 * warpgroups * 64 * C1,
        2 * warpgroups * 64 * C2, 2 * warpgroups * 2 * C1, 2 * C2, 2 * C3,
        12 * warpgroups * C3)) + 1024


def train_bf16_design(C1: int, C2: int, C3: int) -> str:
    """The design kernel 6's bf16 training forward runs widths C1 -> C2 ->
    C3 on (any S): "wgmma" (``csrc/fused_sa_wgmma.cuh``: C1 = C2 = 128, C3
    a multiple of 128 whose layout fits with two warpgroups a block, three
    where they fit: C3 up to 384, three up to 256) or "parent"
    (``csrc/fused_sa_bf16.cuh``'s design, which takes the rest; the widened
    RCNN's 256 -> 384 -> 256).
    The C entry's ``tpu3d_fused_sa_train_bf16_wgmma`` decides the same."""
    fits = (C1 == C2 == 128 and C3 >= 128 and C3 % 128 == 0
            and wgmma_smem(C1, C2, C3, 2) <= SMEM_MAX)
    return "wgmma" if fits else "parent"


def eval_wgmma_smem(C1: int, C2: int, C3: int, warpgroups: int,
                    bn: bool = False) -> int:
    """Bytes of shared memory the wgmma design of the bf16 eval forms asks
    for (``csrc/fused_sa_wgmma_eval.cuh``'s layout, 1024-byte regions): the
    weights, per warpgroup a 64-row stage of a0, the biases, per warpgroup
    each warp's column maxima (bf16) and a group's running max, and room to
    align them (a1 stays in registers). Kernels 5 and 8 (``bn`` False) add
    two tiles' centers (four each) per warpgroup; kernel 9's form (``bn``)
    has no centers and no biases but the packs in f32, with layer 2's
    column signs where b2 lies."""
    return sum(_carve(n) for n in (
        2 * C1 * C2, 2 * C2 * C3, 2 * warpgroups * 64 * C1,
        0 if bn else 2 * warpgroups * 2 * 4 * C1, 0 if bn else 2 * C2,
        2 * C3, 2 * warpgroups * 4 * C3, 2 * warpgroups * C3,
        8 * (C1 + C2 + C3) if bn else 0)) + 1024


def eval_bf16_design(C1: int, C2: int, C3: int, bn: bool = False) -> str:
    """The design a bf16 eval form runs widths C1 -> C2 -> C3 on (any S):
    kernels 5 and 8's (``bn`` False) and kernel 9's (``bn``, the BatchNorm
    slab with its running statistics folded). "wgmma"
    (``csrc/fused_sa_wgmma_eval.cuh``: C1 = C2 = 128, C3 a multiple of 128
    whose layout (``eval_wgmma_smem``) fits with two warpgroups a block,
    three where they fit: C3 up to 512, three up to 384, in both forms;
    every level the shipped configs fuse at eval, with BatchNorm too) or
    "parent" (``csrc/fused_sa_bf16.cuh``'s design, which takes the rest: the
    widened RCNN's 256 -> 384 -> 256). The C entries
    ``tpu3d_fused_sa_bf16_design`` and ``tpu3d_fused_sa_slab_bn_bf16_design``
    decide the same."""
    fits = (C1 == C2 == 128 and C3 >= 128 and C3 % 128 == 0
            and eval_wgmma_smem(C1, C2, C3, 2, bn) <= SMEM_MAX)
    return "wgmma" if fits else "parent"


# kernel 9's bf16 products (csrc/fused_sa_bn.cu's *_bf16 entries), each on
# the tensor-core design of csrc/fused_sa_bn_wgmma.cuh or the SIMT design,
# by its own widths: its pass, the row product's depth K and width N
BN_BF16_PRODUCTS = {"fused_sa_bn_stats1_bf16": "layer",
                    "fused_sa_bn_stats2_bf16": "layer",
                    "fused_sa_bn_wave1_bf16": "wave1",
                    "fused_sa_bn_wave2_bf16": "wave2"}


def bn_wgmma_smem(kind: str, K: int, N: int) -> int:
    """Bytes of shared memory the tensor-core design of kernel 9's bf16
    products asks for (``csrc/fused_sa_bn_wgmma.cuh``'s layout, 1024-byte
    regions) for pass ``kind`` ("layer": stats1 or stats2; "wave1";
    "wave2") at the row product's depth K and width N: the bf16 weight,
    the A tile (64 x K) and a wave's ReLU(E) tile (64 x N), two stages of
    raw rows (A, x1 beside wave 2's f32 d_y1, a wave's E; each row padded
    by 16 bytes) and of wave 1's group rows (dval, argmax), the prologue's
    and E's per-channel vectors, a layer's row and column norms and each
    warp's chain sums, the warps' column sums, and room to align them."""
    wave = kind != "layer"
    a_bytes = 4 if kind == "wave2" else 2
    vectors = {"layer": 2, "wave1": 4, "wave2": 5}[kind]
    return sum(_carve(n) for n in (
        2 * K * N, 2 * 64 * K, 2 * 64 * N if wave else 0,
        2 * 64 * (a_bytes * K + 16),
        2 * 64 * (2 * K + 16) if kind == "wave2" else 0,
        2 * 64 * (2 * N + 16) if wave else 0,
        2 * 8 * K if kind == "wave1" else 0, 4 * K * vectors,
        16 * N if wave else 0, 0 if wave else 4 * (64 + N),
        0 if wave else 4 * (4 if N == 256 else 2) * 8 * 64, 32 * N)) + 1024


def _bn_design(kind: str, K: int, N: int) -> str:
    """The design of one bf16 product of kernel 9 at depth K and width N
    (``csrc/fused_sa_bn_wgmma.cuh``'s ``takes``): "wgmma" for a layer at K
    = 128 and N 128 or 256, wave 1 (K = C3, N = C2) at N = 128 and K 128 or
    256, wave 2 (K = C2, N = C1) at 128 and 128, where the layout fits;
    else "simt"."""
    shape = (K == 128 and N in (128, 256) if kind == "layer" else
             N == 128 and K in (128, 256) if kind == "wave1" else
             K == N == 128)
    fits = shape and bn_wgmma_smem(kind, K, N) <= SMEM_MAX
    return "wgmma" if fits else "simt"


def bn_train_bf16_design(C1: int, C2: int, C3: int) -> dict[str, str]:
    """The design each of kernel 9's bf16 products runs a BatchNorm level of
    widths C1 -> C2 -> C3 on (any S), by entry: "wgmma"
    (``csrc/fused_sa_bn_wgmma.cuh``: the tensor cores, the weight resident,
    a wave's two products from one read of its slabs) or "simt" (the
    f32 register tiles of ``csrc/fused_sa_bn.cu``). stats1 is the layer C1
    -> C2, stats2 C2 -> C3, wave 1 of depth C3 and width C2, wave 2 of depth
    C2 and width C1: both BatchNorm levels of the shipped configs (128 ->
    128 -> 128 and -> 256) take the tensor cores at all four, the widened
    RCNN's 256 -> 384 -> 256 the SIMT design at all four. stats0, final
    and apply are one pass each, at every width. The C entry
    ``tpu3d_fused_sa_bn_bf16_design`` decides the same."""
    shapes = {"fused_sa_bn_stats1_bf16": (C1, C2),
              "fused_sa_bn_stats2_bf16": (C2, C3),
              "fused_sa_bn_wave1_bf16": (C3, C2),
              "fused_sa_bn_wave2_bf16": (C2, C1)}
    return {name: _bn_design(kind, *shapes[name])
            for name, kind in BN_BF16_PRODUCTS.items()}


def eval_groups_per_tile(S: int) -> int:
    """Groups of S slots the wgmma eval design packs into one 64-row tile:
    64 / S where S is a multiple of 16 that divides 64 (4 at S 16, 2 at 32,
    1 at 64), so that a group's rows are whole warps' 16-row slices; else 1
    (a group pads one tile, or takes ceil(S / 64) tiles and a running max).
    The C entry ``tpu3d_fused_sa_bf16_groups`` gives the same."""
    return 64 // S if S % 16 == 0 and 64 % S == 0 else 1


def _check_bf16_kernel(x, name, ndim, S, C1, C2, C3, R, M):
    _build.check_cuda_tensor(x, name, BF16, ndim)
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if not bf16_kernels_take(S, C1, C2, C3) or R * M >= 2 ** 31:
        raise ValueError(
            f"the bf16 fused_sa kernels do not take R={R}, M={M}, S={S}, "
            f"C1={C1}, C2={C2}, C3={C3} (bf16_kernels_take)")


def _eval_only(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the bf16 form of kernel 9 with running statistics is an eval "
            "kernel and has no backward")


def _w16(w: torch.Tensor) -> torch.Tensor:
    """A (Cin, Cout) weight of any float dtype as the kernels read it:
    (Cout, Cin) bf16 in its own contiguous memory. A non-bf16 weight is
    cast and laid out in one pass; a bf16 one comes back from ``to`` as
    the transposed view itself, which ``contiguous`` lays out."""
    return w.detach().T.to(
        BF16, memory_format=torch.contiguous_format).contiguous()


def fused_gathered_mlp_pool_bf16(pre: torch.Tensor, idx: torch.Tensor,
                                 center: torch.Tensor, w1: torch.Tensor,
                                 b1: torch.Tensor, w2: torch.Tensor,
                                 b2: torch.Tensor) -> torch.Tensor:
    """The gather form's bf16 eval kernel (``_nobn2_eval_kernel``): pre
    (R, N, C1) and center (R, M, C1) bf16, idx (R, M, S) i32, w1 (C1, C2),
    b1, w2 (C2, C3), b2 (any float dtype; rounded to bf16) -> (R, M, C3)
    bf16: max_s a2 of x0 = bf16(pre[idx] - center) through the no-BN chain
    with bf16 layer boundaries. The eval kernel (counted as
    ``fused_sa_bf16``, on the design ``eval_bf16_design`` names) for CUDA
    tensors, the plain version for CPU tensors;
    where a gradient is needed, kernel 6's bf16 training form
    (``_FusedGatheredMLPPoolBF16``; on the CPU its plain version under
    autograd)."""
    args = (pre, idx, center, w1, b1, w2, b2)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    if pre.device.type == "cpu":
        return (fused_gathered_mlp_pool_bf16_train_plain(*args)[0] if grad
                else fused_gathered_mlp_pool_bf16_plain(*args))
    if grad:
        return _FusedGatheredMLPPoolBF16.apply(*args)
    R, N, C1 = pre.shape
    M, S = idx.shape[1], idx.shape[2]
    C2, C3 = w1.shape[1], w2.shape[1]
    _check_bf16_kernel(pre, "pre", 3, S, C1, C2, C3, R, M)
    _check_bf16_kernel(center, "center", 3, S, C1, C2, C3, R, M)
    _build.check_cuda_tensor(idx, "idx", torch.int32, 3)
    if (idx.shape[0] != R or center.shape != (R, M, C1)
            or w1.shape[0] != C1 or w2.shape[0] != C2
            or b1.shape != (C2,) or b2.shape != (C3,)):
        raise ValueError(
            f"fused_sa bf16 shapes disagree: pre {tuple(pre.shape)}, idx "
            f"{tuple(idx.shape)}, center {tuple(center.shape)}, w1 "
            f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    out = torch.empty(R, M, C3, dtype=BF16, device=pre.device)
    w1t, w2t = _w16(w1), _w16(w2)
    b1h, b2h = b1.detach().to(BF16).contiguous(), b2.detach().to(
        BF16).contiguous()
    _build.launch("fused_sa_bf16", pre.data_ptr(), idx.data_ptr(),
                  center.data_ptr(), w1t.data_ptr(), b1h.data_ptr(),
                  w2t.data_ptr(), b2h.data_ptr(), R, N, M, S, C1, C2, C3,
                  out.data_ptr())
    return out


def _slab_bf16_check(x0, w1, w2):
    R, M, S, C1 = x0.shape
    C2, C3 = w1.shape[1], w2.shape[1]
    _check_bf16_kernel(x0, "x0", 4, S, C1, C2, C3, R, M)
    if w1.shape[0] != C1 or w2.shape[0] != C2:
        raise ValueError(f"fused_sa bf16 slab shapes disagree: x0 "
                         f"{tuple(x0.shape)}, w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}")
    return R, M, S, C1, C2, C3


def fused_mlp_pool_bf16(x0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The slab form's bf16 eval kernel (``_nobn_eval_kernel``): x0 (R, M,
    S, C1) bf16 -> (R, M, C3) bf16, the no-BN chain with bf16 layer
    boundaries. The eval kernel (counted as ``fused_sa_slab_bf16``, on the
    design ``eval_bf16_design`` names) for CUDA tensors, the plain version
    for CPU tensors; where a gradient is
    needed, kernel 8's bf16 training form (``_FusedMLPPoolBF16``; on the
    CPU its plain version under autograd)."""
    args = (x0, w1, b1, w2, b2)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    if x0.device.type == "cpu":
        return (fused_mlp_pool_bf16_train_plain(*args)[0] if grad
                else fused_mlp_pool_bf16_plain(*args))
    if grad:
        return _FusedMLPPoolBF16.apply(*args)
    R, M, S, C1, C2, C3 = _slab_bf16_check(x0, w1, w2)
    if b1.shape != (C2,) or b2.shape != (C3,):
        raise ValueError(f"biases {tuple(b1.shape)}, {tuple(b2.shape)} for "
                         f"C2={C2}, C3={C3}")
    out = torch.empty(R, M, C3, dtype=BF16, device=x0.device)
    w1t, w2t = _w16(w1), _w16(w2)
    b1h, b2h = b1.detach().to(BF16).contiguous(), b2.detach().to(
        BF16).contiguous()
    _build.launch("fused_sa_slab_bf16", x0.data_ptr(), w1t.data_ptr(),
                  b1h.data_ptr(), w2t.data_ptr(), b2h.data_ptr(), R, M, S,
                  C1, C2, C3, out.data_ptr())
    return out


def fused_bn_mlp_pool_bf16(x0: torch.Tensor, w1: torch.Tensor,
                           w2: torch.Tensor, gammas, betas, stats,
                           eps: float = 1e-5) -> torch.Tensor:
    """The BatchNorm slab's bf16 eval kernel (``_eval_chain_kernel``): x0
    (R, M, S, C1) bf16, the running ``stats`` ((mean, var) x3) folded into
    one f32 (mul, add) per layer as ``fused_bn_mlp_pool`` folds them ->
    (R, M, C3) bf16. The kernel (counted as ``fused_sa_slab_bn_bf16``, on
    the design ``eval_bf16_design(..., bn=True)`` names) for CUDA tensors,
    the plain version for CPU tensors; no backward."""
    packs = bn_packs([_bn_affine(m, v, g, b, eps)[:2]
                      for (m, v), g, b in zip(stats, gammas, betas)])
    if x0.device.type == "cpu":
        return fused_sa_slab_bn_bf16_plain(x0, packs, w1, w2)
    _eval_only(x0, w1, w2, packs)
    R, M, S, C1, C2, C3 = _slab_bf16_check(x0, w1, w2)
    packs = packs.detach().float().contiguous()
    _check_tensors((packs, "packs", 1))
    if packs.shape != (2 * (C1 + C2 + C3),):
        raise ValueError(f"packs {tuple(packs.shape)} for widths "
                         f"{(C1, C2, C3)}")
    out = torch.empty(R, M, C3, dtype=BF16, device=x0.device)
    w1t, w2t = _w16(w1), _w16(w2)
    _build.launch("fused_sa_slab_bn_bf16", x0.data_ptr(), packs.data_ptr(),
                  w1t.data_ptr(), w2t.data_ptr(), R, M, S, C1, C2, C3,
                  out.data_ptr())
    return out


# --------------------------------------------------------------------------
# the bf16 training forms of kernels 6 (gather) and 8 (slab), under the
# accelerator's training contract (precision.py): tpu3d's _nobn2_fwd_kernel
# / _nobn2_bwd_kernel and _nobn_fwd_kernel / _nobn_bwd_kernel in their own
# arithmetic. Forward: the eval forms' chain, keeping each pooled channel's
# first argmax over the bf16 a2 and the pre-ReLU x2 there (ppre). Backward:
# dval = g where ppre > 0; d_x2 and d_x1 rounded to bf16 before each product
# (dW2 = a1ᵀ bf16(d_x2), d_a1 = bf16(d_x2) W2ᵀ, dW1 = a0ᵀ bf16(d_x1),
# d_a0 = bf16(d_x1) W1ᵀ), db1 the sum of the unrounded d_x1, db2 of dval;
# the gather form's d_pre = Σ bf16(d_x0) in f32, rounded to bf16, and
# d_center = bf16(-Σ_s d_x0); the slab form's d_x0 in bf16. The weight and
# bias gradients stay f32.
# --------------------------------------------------------------------------


def _fr(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (kept in f32) in the forward; the gradient passes
    through unrounded (a weight's bf16 copy, whose f32 gradient tpu3d's
    kernels return as they sum it)."""
    return x + (_r16(x) - x).detach()


class _RoundGrad(torch.autograd.Function):
    """The identity, whose gradient is rounded to bf16: the cotangent of a
    bf16 product, which tpu3d's kernels round before it enters the next
    products."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _r16(g)


def _bf16_train_chain(x0f, w1, b1, w2, b2):
    """The no-BN chain on a grouped chunk's f32 x0 (bf16 values), in the
    training kernels' arithmetic under autograd -> x2 (bf16 values in
    f32): x_k = bf16(bf16(a_{k-1}·bf16(W_k)) + bf16(b_k)), each product's
    gradient rounded to bf16 where the kernels round it."""
    a0 = torch.relu(x0f)
    x1 = _fr(_fr(_RoundGrad.apply(a0 @ _fr(w1))) + _fr(b1))
    return _fr(_fr(_RoundGrad.apply(torch.relu(x1) @ _fr(w2))) + _fr(b2))


def _bf16_train_pool(x0f, w1, b1, w2, b2):
    out, arg, ppre = _first_max(_bf16_train_chain(x0f, w1, b1, w2, b2))
    return out.to(BF16), arg, ppre


def _bf16_gather_x0(pre, idx, center):
    """The gather form's x0 = bf16(pre[idx] - center) in f32, pre and center
    bf16, under autograd: its gradient reaches pre through the bf16 form of
    the gather's backward (bf16(d_x0) summed in f32, bf16 out) and center
    as bf16(-Σ_s d_x0)."""
    return _fr(group_points(pre, idx).float() - center.float()[:, :, None])


def _bf16_gather_train_form(pre, idx, center, w1, w2):
    R, M, S = idx.shape
    width = max(w1.shape[1], w2.shape[1])
    return (lambda rows: _bf16_gather_x0(pre[rows], idx[rows], center[rows]),
            R, M, S, width)


def fused_gathered_mlp_pool_bf16_train_plain(pre, idx, center, w1, b1, w2,
                                             b2):
    """Plain PyTorch version of kernel 6's bf16 training forward
    (``_nobn2_fwd_kernel``), differentiable by autograd in tpu3d's
    backward arithmetic (``_nobn2_bwd_kernel``): pre (R, N, C1) and center
    (R, M, C1) bf16 -> (out (R, M, C3) bf16, argmax i32, ppre f32)."""
    return _chunked(lambda x0: _bf16_train_pool(x0, w1, b1, w2, b2),
                    *_bf16_gather_train_form(pre, idx, center, w1, w2))


def fused_mlp_pool_bf16_train_plain(x0, w1, b1, w2, b2):
    """Plain PyTorch version of kernel 8's bf16 training forward
    (``_nobn_fwd_kernel``), differentiable by autograd in tpu3d's backward
    arithmetic (``_nobn_bwd_kernel``; d_x0 rounded to bf16): x0
    (R, M, S, C1) bf16 -> (out bf16, argmax i32, ppre f32)."""
    return _chunked(lambda x: _bf16_train_pool(x.float(), w1, b1, w2, b2),
                    *_slab_form(x0, w1, w2))


def _bf16_routed_grads(leaves, x2_of, grad, argmax, ppre):
    """The gradients of the chain ``x2_of(leaves)`` routed as the kernels
    route them: each pooled channel's dval = grad where ppre > 0, at the
    training forward's ``argmax`` slot, by autograd of the plain chain."""
    dval = torch.where(ppre > 0, grad.float(), 0.0)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in leaves]
        sel = torch.gather(x2_of(*leaves), 2,
                           argmax.long()[:, :, None, :])[:, :, 0]
        return torch.autograd.grad(sel, leaves, dval)


def fused_gathered_mlp_pool_bf16_backward_plain(pre, idx, center, w1, b1, w2,
                                                b2, grad, argmax, ppre):
    """Plain PyTorch version of kernel 6's bf16 backward, routed by the
    training forward's ``argmax`` and ``ppre`` -> (d_pre bf16, d_center
    bf16, dW1, db1, dW2, db2)."""
    return _bf16_routed_grads(
        (pre, center, w1, b1, w2, b2),
        lambda p, c, *w: _bf16_train_chain(_bf16_gather_x0(p, idx, c), *w),
        grad, argmax, ppre)


def fused_mlp_pool_bf16_backward_plain(x0, w1, b1, w2, b2, grad, argmax,
                                       ppre):
    """Plain PyTorch version of kernel 8's bf16 backward, routed by the
    training forward's ``argmax`` and ``ppre`` -> (d_x0 bf16, dW1, db1, dW2,
    db2)."""
    return _bf16_routed_grads(
        (x0, w1, b1, w2, b2),
        lambda x, *w: _bf16_train_chain(x.float(), *w), grad, argmax, ppre)


def _b16(b: torch.Tensor) -> torch.Tensor:
    return b.detach().to(BF16).contiguous()


def _gather_bf16_check(pre, idx, center, w1, b1, w2, b2):
    R, N, C1 = pre.shape
    M, S = idx.shape[1], idx.shape[2]
    C2, C3 = w1.shape[1], w2.shape[1]
    _check_bf16_kernel(pre, "pre", 3, S, C1, C2, C3, R, M)
    _check_bf16_kernel(center, "center", 3, S, C1, C2, C3, R, M)
    _build.check_cuda_tensor(idx, "idx", torch.int32, 3)
    if (idx.shape[0] != R or center.shape != (R, M, C1)
            or w1.shape[0] != C1 or w2.shape[0] != C2
            or b1.shape != (C2,) or b2.shape != (C3,)):
        raise ValueError(
            f"fused_sa bf16 shapes disagree: pre {tuple(pre.shape)}, idx "
            f"{tuple(idx.shape)}, center {tuple(center.shape)}, w1 "
            f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    return R, N, M, S, C1, C2, C3


def fused_gathered_mlp_pool_bf16_train(pre, idx, center, w1, b1, w2, b2):
    """Kernel 6's bf16 training forward alone -> (out bf16, argmax, ppre):
    the kernel (counted as ``fused_sa_train_bf16``) for CUDA tensors, else
    the plain version."""
    if pre.device.type == "cpu":
        return fused_gathered_mlp_pool_bf16_train_plain(pre, idx, center, w1,
                                                        b1, w2, b2)
    R, N, M, S, C1, C2, C3 = _gather_bf16_check(pre, idx, center, w1, b1, w2,
                                                b2)
    outs = _pooled(R, M, C3, pre.device, True, BF16)
    w1t, w2t = _w16(w1), _w16(w2)
    b1h, b2h = _b16(b1), _b16(b2)
    _build.launch("fused_sa_train_bf16", pre.data_ptr(), idx.data_ptr(),
                  center.data_ptr(), w1t.data_ptr(), b1h.data_ptr(),
                  w2t.data_ptr(), b2h.data_ptr(), R, N, M, S, C1, C2, C3,
                  *(t.data_ptr() for t in outs))
    return outs


# the bf16 backward's two designs (csrc/fused_sa_bwd_bf16.cu): the
# tensor-core design's shared-memory layout, mirrored here
# (csrc/fused_sa_bwd_mma.cuh's Layout, 16-byte regions: W1^T and W2^T in
# bf16 rows of 136, two row stages, D, a1, dW2^T's f32 sums where they fit,
# two tile plans, a batch of 64 parts with their placement into tiles, a
# tile's d_center runs, the db1 reduction)
_BWD_LD = 136


def bwd_bf16_smem(C3: int, dw2_shared: bool) -> int:
    """Bytes of shared memory the tensor-core design of kernels 6 and 8's
    bf16 backward lays out at C1 = C2 = 128 and C3, with dW2^T's sums in
    shared memory or not (its block also holds 16 bytes of its own)."""
    regions = (2 * 128 * _BWD_LD, 2 * C3 * _BWD_LD, 4 * 128,
               2 * 2 * 64 * _BWD_LD, 2 * 64 * (C3 + 8), 2 * 64 * _BWD_LD,
               4 * C3 * 128 if dw2_shared else 0, 2 * 1424,
               8 * 64 + 4 * 4 * 64 + 2 * 64 + 3 * 4 * 65 + 4 + 4 * 64 * 64,
               4 * 64, 4 * 4 * 128)
    return sum(-(-n // 16) * 16 for n in regions)


def backward_bf16_design(C1: int, C2: int, C3: int) -> str:
    """The design kernels 6 and 8's bf16 backward run widths C1 -> C2 -> C3
    on (any S): "mma" (``csrc/fused_sa_bwd_mma.cuh``: C1 = C2 = 128, C3 a
    multiple of 128 whose layout fits, 128 and 256, every fused level of
    the shipped configs) or "parent" (the routed walk of
    ``csrc/fused_sa_bwd.cuh`` on bf16 rows, the rest: the widened RCNN's
    256 -> 384 -> 256). The C entry ``tpu3d_fused_sa_bwd_bf16_design``
    decides the same."""
    fits = (C1 == C2 == 128 and C3 >= 128 and C3 % 128 == 0
            and bwd_bf16_smem(C3, False) + 16 <= SMEM_MAX)
    return "mma" if fits else "parent"


def _bf16_entry(name: str, argtypes, restype):
    fn = getattr(_build.library("fused_sa_bwd_bf16"), name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_bf16_sizes(groups: int, S: int, c1: int, c2: int, c3: int):
    """(whether the tensor-core design runs, blocks, floats of a block's
    slice, the plan's parts, floats of the auxiliary buffer) of the bf16
    backward, from its library."""
    L, I = ctypes.c_longlong, ctypes.c_int
    return (bool(_bf16_entry("tpu3d_fused_sa_bwd_bf16_design", [I, I, I], I)(
                c1, c2, c3)),
            _bf16_entry("tpu3d_fused_sa_bwd_bf16_blocks", [L, I, I, I], I)(
                groups, c1, c2, c3),
            _bf16_entry("tpu3d_fused_sa_bwd_bf16_slice", [I, I, I], L)(
                c1, c2, c3),
            _bf16_entry("tpu3d_fused_sa_bwd_bf16_parts", [L, I, I, I, I], L)(
                groups, S, c1, c2, c3),
            _bf16_entry("tpu3d_fused_sa_bwd_bf16_aux", [L, I, I, I, I], L)(
                groups, S, c1, c2, c3))


def _as_lies(w, name, ndim):
    """A weight's pointer and strides as it lies (any strides; f32 CUDA)."""
    if w.device.type != "cuda" or w.dtype != torch.float32 or w.dim() != ndim:
        raise ValueError(f"{name} must be an f32 CUDA tensor of {ndim} dims, "
                         f"got {w.dtype} {tuple(w.shape)} on {w.device}")
    return (w.data_ptr(), *w.stride())


def _launch_backward_bf16(kernel, head, dims, outs, w1, b1, w2, grad, argmax,
                          ppre):
    """Launch kernel 6's or 8's bf16 backward (``kernel``
    "fused_sa_bwd_bf16" or "fused_sa_slab_bwd_bf16"; either design). It
    reads the gradient where and as it lies (bf16 or f32, any strides),
    ppre and argmax, and W1, W2 (f32, as they lie) and b1, and forms and
    rounds every operand itself: no pass runs before it. ``head`` are the
    form's bf16 leading tensors, ``dims`` (R, [N,] M, S), ``outs`` its bf16
    input gradients; the gather form runs its plan first and reads the
    reached rows' count (one wait for the card) to size the buffer of their
    d_x0. -> (dW1, db1, dW2, db2)."""
    R, M, S = dims[0], dims[-2], dims[-1]
    C1, C2, C3 = w1.shape[0], w1.shape[1], w2.shape[1]
    dev = grad.device
    _build.check_cuda_tensor(ppre, "ppre", torch.float32, 3)
    _build.check_cuda_tensor(argmax, "argmax", torch.int32, 3)
    if grad.device.type != "cuda" or grad.dtype not in (BF16, torch.float32):
        raise ValueError(f"{kernel}'s gradient must be a bf16 or f32 CUDA "
                         f"tensor, got {grad.dtype} on {grad.device}")
    if grad.shape != (R, M, C3) or argmax.shape != grad.shape \
            or ppre.shape != grad.shape or b1.shape != (C2,):
        raise ValueError(f"{kernel}'s gradient, argmax and ppre must be "
                         f"{(R, M, C3)}, b1 {(C2,)}")
    b1 = b1.detach().contiguous()
    _build.check_cuda_tensor(b1, "b1", torch.float32, 1)
    raw = (*_as_lies(w1.detach(), "w1", 2), b1.data_ptr(),
           *_as_lies(w2.detach(), "w2", 2), grad.data_ptr(),
           int(grad.dtype == BF16), *grad.stride(), ppre.data_ptr(),
           argmax.data_ptr())
    mma, blocks, slice_, parts, aux_n = _bwd_bf16_sizes(R * M, S, C1, C2,
                                                        C3)
    if parts == 0:
        raise ValueError(f"{kernel} does not take S={S}, C1={C1}, C2={C2}, "
                         f"C3={C3}")
    ws = torch.empty(blocks * slice_, dtype=torch.float32, device=dev)
    sums = torch.empty(slice_ + C3, dtype=torch.float32, device=dev)
    scratch = torch.empty(24 * parts, dtype=torch.uint8, device=dev)
    aux = torch.empty(aux_n, dtype=torch.float32, device=dev)
    if kernel == "fused_sa_bwd_bf16":
        N = dims[1]
        d32 = (None if mma and S <= BWD_TILE else
               torch.empty(R, M, C1, dtype=torch.float32, device=dev))
        _build.launch_part("fused_sa_bwd_bf16_plan", *raw, *dims, C1, C2, C3,
                           blocks, (outs[1] if d32 is None else d32)
                           .data_ptr(), scratch.data_ptr(), aux.data_ptr())
        total = int(scratch[8 * parts:16 * parts].view(torch.int64)[-1])
        rows = torch.empty(total, C1, dtype=BF16 if mma else torch.float32,
                           device=dev)
        inv = torch.empty(_bwd_inverse_ints(R, N, M, S), dtype=torch.int32,
                          device=dev)
        _build.launch(kernel, *(t.data_ptr() for t in head), *raw, *dims, C1,
                      C2, C3, blocks, *(t.data_ptr() for t in outs),
                      0 if d32 is None else d32.data_ptr(), ws.data_ptr(),
                      scratch.data_ptr(), aux.data_ptr(), sums.data_ptr(),
                      rows.data_ptr(), inv.data_ptr(), inv.numel())
    else:
        d32 = None if mma else torch.empty(outs[0].shape,
                                           dtype=torch.float32, device=dev)
        _build.launch(kernel, head[0].data_ptr(), *raw, *dims, C1, C2, C3,
                      blocks, outs[0].data_ptr(),
                      0 if d32 is None else d32.data_ptr(), ws.data_ptr(),
                      scratch.data_ptr(), aux.data_ptr(), sums.data_ptr())
    w1n, w2n = C1 * C2, C3 * C2
    return (sums[:w1n].view(C1, C2), sums[w1n + w2n:slice_],
            sums[w1n:w1n + w2n].view(C3, C2).t(), sums[slice_:])


def fused_gathered_mlp_pool_bf16_backward(pre, idx, center, w1, b1, w2, b2,
                                          grad, argmax, ppre):
    """Kernel 6's bf16 backward alone -> (d_pre bf16, d_center bf16, dW1,
    db1, dW2, db2): the routed kernel (counted as ``fused_sa_bwd_bf16``;
    ``backward_bf16_design`` names its design) for CUDA tensors, the
    gradient taken as it lies (bf16 or f32), else the plain version."""
    if pre.device.type == "cpu":
        return fused_gathered_mlp_pool_bf16_backward_plain(
            pre, idx, center, w1, b1, w2, b2, grad, argmax, ppre)
    R, N, M, S, C1, C2, C3 = _gather_bf16_check(pre, idx, center, w1, b1, w2,
                                                b2)
    if not kernels_take(S, C1, C2, C3, "gather", True):
        raise ValueError(f"the fused_sa backward does not take S={S}, "
                         f"C1={C1}, C2={C2}, C3={C3} (kernels_take)")
    d_pre = torch.empty(R, N, C1, dtype=BF16, device=pre.device)
    d_center = torch.empty(R, M, C1, dtype=BF16, device=pre.device)
    return (d_pre, d_center, *_launch_backward_bf16(
        "fused_sa_bwd_bf16", (pre, idx, center), (R, N, M, S),
        (d_pre, d_center), w1, b1, w2, grad, argmax, ppre))


class _FusedGatheredMLPPoolBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre, idx, center, w1, b1, w2, b2):
        out, argmax, ppre = fused_gathered_mlp_pool_bf16_train(
            pre, idx, center, w1, b1, w2, b2)
        ctx.save_for_backward(pre, idx, center, w1, b1, w2, b2, argmax, ppre)
        return out

    @staticmethod
    def backward(ctx, grad):
        pre, idx, center, w1, b1, w2, b2, argmax, ppre = ctx.saved_tensors
        d_pre, d_center, dw1, db1, dw2, db2 = \
            fused_gathered_mlp_pool_bf16_backward(
                pre, idx, center, w1, b1, w2, b2, grad, argmax, ppre)
        return d_pre, None, d_center, dw1, db1, dw2, db2


def fused_mlp_pool_bf16_train(x0, w1, b1, w2, b2):
    """Kernel 8's bf16 training forward alone -> (out bf16, argmax, ppre):
    the kernel (counted as ``fused_sa_slab_train_bf16``) for CUDA tensors,
    else the plain version."""
    if x0.device.type == "cpu":
        return fused_mlp_pool_bf16_train_plain(x0, w1, b1, w2, b2)
    R, M, S, C1, C2, C3 = _slab_bf16_check(x0, w1, w2)
    if b1.shape != (C2,) or b2.shape != (C3,):
        raise ValueError(f"biases {tuple(b1.shape)}, {tuple(b2.shape)} for "
                         f"C2={C2}, C3={C3}")
    outs = _pooled(R, M, C3, x0.device, True, BF16)
    w1t, w2t = _w16(w1), _w16(w2)
    b1h, b2h = _b16(b1), _b16(b2)  # alive until the launch is queued
    _build.launch("fused_sa_slab_train_bf16", x0.data_ptr(), w1t.data_ptr(),
                  b1h.data_ptr(), w2t.data_ptr(), b2h.data_ptr(), R, M, S,
                  C1, C2, C3, *(t.data_ptr() for t in outs))
    return outs


def fused_mlp_pool_bf16_backward(x0, w1, b1, w2, b2, grad, argmax, ppre):
    """Kernel 8's bf16 backward alone -> (d_x0 bf16, dW1, db1, dW2, db2):
    the routed kernel (counted as ``fused_sa_slab_bwd_bf16``;
    ``backward_bf16_design`` names its design) for CUDA tensors, the
    gradient taken as it lies (bf16 or f32), else the plain version."""
    if x0.device.type == "cpu":
        return fused_mlp_pool_bf16_backward_plain(x0, w1, b1, w2, b2, grad,
                                                  argmax, ppre)
    R, M, S, C1, C2, C3 = _slab_bf16_check(x0, w1, w2)
    if not kernels_take(S, C1, C2, C3, "slab", True):
        raise ValueError(f"the fused_sa backward does not take S={S}, "
                         f"C1={C1}, C2={C2}, C3={C3} (kernels_take)")
    d_x0 = torch.empty(R, M, S, C1, dtype=BF16, device=x0.device)
    return (d_x0, *_launch_backward_bf16(
        "fused_sa_slab_bwd_bf16", (x0,), (R, M, S), (d_x0,), w1, b1, w2,
        grad, argmax, ppre))


class _FusedMLPPoolBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, w1, b1, w2, b2):
        out, argmax, ppre = fused_mlp_pool_bf16_train(x0, w1, b1, w2, b2)
        ctx.save_for_backward(x0, w1, b1, w2, b2, argmax, ppre)
        return out

    @staticmethod
    def backward(ctx, grad):
        x0, w1, b1, w2, b2, argmax, ppre = ctx.saved_tensors
        return fused_mlp_pool_bf16_backward(x0, w1, b1, w2, b2, grad, argmax,
                                            ppre)


# kernel 9's bf16 training form: tpu3d's seven training kernels in their
# bf16 arithmetic (_chain_to rounds x1, x2 and each product's operands, the
# backward rounds d_x2 and d_x1 before their products and keeps the
# gradients of the BatchNorm outputs in f32); for CUDA tensors the f32
# form's passes on bf16 slabs (the *_bf16 entries of csrc/fused_sa_bn.cu)


def _bn_relu_bf16_train(x, gamma, beta, eps):
    """tpu3d's ``_fused_train`` layer on the f32 x (bf16 values): the batch
    statistics as the kernels take them (the f64 sums of x and x² over the
    global batch under a mesh, mean and E[x²] − mean² in f64, rounded to
    f32: ``_mean_var``), folded into y = x·mul + add (``_bn_affine``,
    tpu3d's ``_bn_consts``; a product and a sum, each rounded to f32), y
    rounded to bf16 in the forward alone (``_fr``: tpu3d's VJP keeps the
    gradient of a BatchNorm output in f32) -> (a, mean, var)."""
    from ..parallel.mesh import batch_means  # the package imports ops

    xd = x.double()
    mean, sq = batch_means((xd, xd * xd), tuple(range(x.dim() - 1)))
    mean, var = mean.float(), (sq - mean * mean).float()
    mul, add, _ = _bn_affine(mean, var, gamma, beta, eps)
    return torch.relu(_fr(x * mul + add)), mean, var


def bn_bf16_chain(x0, w1, w2, gammas, betas, eps=1e-5):
    """The chain of ``fused_bn_mlp_pool_bf16_train_plain`` up to layer 2's
    activation, under autograd -> (a2 (R, M, S, C3), bf16 values in f32,
    (means, vars)), the statistics detached."""
    a0, m0, v0 = _bn_relu_bf16_train(x0.float(), gammas[0], betas[0], eps)
    x1 = _fr(_RoundGrad.apply(a0 @ _fr(w1)))
    a1, m1, v1 = _bn_relu_bf16_train(x1, gammas[1], betas[1], eps)
    x2 = _fr(_RoundGrad.apply(a1 @ _fr(w2)))
    a2, m2, v2 = _bn_relu_bf16_train(x2, gammas[2], betas[2], eps)
    return a2, (tuple(m.detach() for m in (m0, m1, m2)),
                tuple(v.detach() for v in (v0, v1, v2)))


def fused_bn_mlp_pool_bf16_train_plain(x0, w1, w2, gammas, betas, eps=1e-5):
    """Plain PyTorch version of kernel 9's bf16 training form, the VJP of
    tpu3d's ``_fused_train``: its forward is ``_chain_to``'s on a bf16 slab
    (each layer's f32 batch statistics folded into x·mul + add, every
    pre-activation and activation rounded to bf16) with the first-argmax
    pool; under autograd the
    gradients of the BatchNorm outputs stay f32, only d_x2 and d_x1, the
    cotangents that enter a product, are rounded to bf16 (``_RoundGrad``),
    and d_x0 comes back in x0's bf16 -> (out (R, M, C3) bf16, (means,
    vars)), the statistics detached."""
    a2, stats = bn_bf16_chain(x0, w1, w2, gammas, betas, eps)
    return _first_max(a2)[0].to(BF16), stats


def fused_bn_mlp_pool_bf16_train(x0, w1, w2, gammas, betas, eps=1e-5):
    """Kernel 9's bf16 training form: x0 (R, M, S, C1) bf16, w1 (C1, C2),
    w2 (C2, C3), gammas and betas the three BatchNorm layers' (f32) ->
    (out (R, M, C3) bf16, (means, vars) f32), differentiable in x0 (d_x0 in
    bf16), the weights, gammas and betas; the statistics not. For CUDA
    tensors ``_FusedBNMLPPool`` on the bf16 slab: its seven passes' bf16
    entries (counted in ``BF16_LAUNCHES``), which keep x1 and x2 in bf16
    from the forward to the backward, at the shapes ``kernels_take(...,
    "bn")`` admits; a tensor off the CPU outside them raises. For CPU
    tensors the plain version under autograd."""
    if x0.device.type == "cpu":
        return fused_bn_mlp_pool_bf16_train_plain(x0, w1, w2, gammas, betas,
                                                  eps)
    R, M, S, C1 = x0.shape
    C2, C3 = w1.shape[1], w2.shape[1]
    if not kernels_take(S, C1, C2, C3, "bn") or R * M >= 2 ** 31:
        raise ValueError(
            f"kernel 9's bf16 training form does not take R={R}, M={M}, "
            f"S={S}, C1={C1}, C2={C2}, C3={C3} (kernels_take)")
    _build.check_cuda_tensor(x0, "x0", BF16, 4)
    out, *st = _FusedBNMLPPool.apply(x0, w1, w2, *gammas, *betas, eps)
    return out, (tuple(st[:3]), tuple(st[3:]))
