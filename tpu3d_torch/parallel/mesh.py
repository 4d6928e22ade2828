"""The data-parallel mesh on ``torch.distributed`` (counterpart of
``tpu3d/parallel/mesh.py``).

tpu3d shards the batch on axis 0 over a ``jax.sharding.Mesh`` and jits the
single-device program, so its sharded train step is the step of the
global batch: BatchNorm takes its statistics over every scene of it, the
loss normalizers count over all of it, and the parameters stay replicated.
The port runs one process per GPU, each holding its rows of the global
batch, and keeps those semantics:

- ``make_mesh`` names the ranks that take part (the largest prefix whose
  count divides the batch, as tpu3d's), ``shard_batch`` gives this rank's
  rows, ``replicate`` broadcasts a module's or a train state's tensors from
  the mesh's first rank;
- ``psum`` is the differentiable sum over the mesh (its backward sums the
  upstream gradients, which is what a statistic shared by every rank
  needs); ``batch_means``, ``global_sum``, ``share`` and ``draw_rows`` are
  the forms the model and the losses take of it. Each is the identity, and
  launches nothing, unless a mesh of more than one rank is active
  (``use_mesh``);
- ``sum_gradients`` sums the parameters' gradients over the mesh in one
  flat collective, before the optimizer clips them.

Without an initialised process group the mesh is this process alone, with
no group, and every path runs as it does without one. Nothing falls back:
a missing backend, too few cards or a failed collective raises.
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """The ranks of a data-parallel step: ``ranks`` (global ranks, in
    order), ``group`` (their process group; None for one process without
    one) and ``index``, this process's place in ``ranks`` (None when it sits
    the step out)."""
    ranks: tuple[int, ...]
    group: object | None
    index: int | None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        return self.index is not None

    @property
    def shard(self) -> tuple[int, int]:
        """(this rank's index, the count of shards): the loader's rows."""
        if self.index is None:
            raise ValueError("this rank sits the mesh out and holds no rows")
        return self.index, self.size

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        index, size = self.shard
        if n % size:
            raise ValueError(f"a batch of {n} does not split over {size} "
                             f"ranks")
        return slice(index * (n // size), (index + 1) * (n // size))


_GROUPS: dict[tuple[int, ...], object] = {}
_ACTIVE: Mesh | None = None


def make_mesh(batch_size: int | None = None, group=None) -> Mesh:
    """The mesh over ``group`` (the default group when None). When
    ``batch_size`` is given, the largest prefix of its ranks whose count
    divides it, as tpu3d's ``make_mesh`` takes a prefix of the devices; the
    other ranks sit the step out (``index`` None) and no collective of the
    mesh waits on them. Every rank of the job must call it with the same
    arguments, since a new subgroup is made by all of them. Without an
    initialised process group: this process alone, without a group, as also
    for a world of one when no ``group`` is passed."""
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a group was passed, but torch.distributed is "
                             "not initialised")
        return Mesh((0,), None, 0)
    base = group if group is not None else dist.group.WORLD
    ranks = tuple(dist.get_process_group_ranks(base))
    n = len(ranks)
    if batch_size is not None:
        while n > 1 and batch_size % n:
            n -= 1
    if n == len(ranks):
        sub = base
        if group is None and n == 1:
            sub = None
    else:
        key = ranks[:n]
        if key not in _GROUPS:
            _GROUPS[key] = dist.new_group(list(key))
        sub = _GROUPS[key]
    me = dist.get_rank()
    return Mesh(ranks[:n], sub, ranks[:n].index(me) if me in ranks[:n]
                else None)


def init_distributed(device: torch.device, backend: str | None = None,
                     store=None, rank: int | None = None,
                     world_size: int | None = None) -> bool:
    """Initialise the default process group, if it is not yet, for a
    process of a job: from the environment ``torchrun`` sets (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or from ``store``,
    ``rank`` and ``world_size``. The backend is NCCL for a card and gloo for
    the CPU unless ``backend`` names one (gloo on a card is asked for, never
    chosen). A CUDA device with an index becomes this process's current
    one. -> whether a group is (now) initialised. A lone process (no
    ``WORLD_SIZE``, no store) initialises nothing and sets no device."""
    if not dist.is_initialized() and store is None \
            and "WORLD_SIZE" not in os.environ:
        return False
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return True
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if store is not None:
        kwargs = {"store": store, "rank": rank, "world_size": world_size}
    dist.init_process_group(backend, **kwargs)
    return True


def lead() -> bool:
    """Whether this process writes and logs: rank 0 of the job, or a lone
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _needs_staging(t: torch.Tensor, group) -> bool:
    """NCCL takes CUDA tensors alone (Adam's ``step`` counts live on the
    host)."""
    return t.device.type != "cuda" and dist.get_backend(group) == "nccl"


def _broadcast(t: torch.Tensor, mesh: Mesh) -> None:
    src = mesh.ranks[0]
    if _needs_staging(t, mesh.group):
        tmp = t.cuda()
        dist.broadcast(tmp, src, group=mesh.group)
        t.copy_(tmp)
    else:
        dist.broadcast(t, src, group=mesh.group)


def shard_batch(mesh: Mesh, batch: dict, device=None) -> dict:
    """This rank's rows of a host batch (a dict of arrays or tensors, the
    batch on axis 0), as tensors on ``device`` (this process's card by
    default, the CPU for ``device="cpu"``)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        rows = mesh.rows(len(v))
        t = torch.as_tensor(np.asarray(v[rows])) if not torch.is_tensor(v) \
            else v[rows]
        out[k] = t.to(dev)
    return out


@torch.no_grad()
def replicate(mesh: Mesh, obj):
    """Broadcast from the mesh's first rank, in place: a module's parameters
    and buffers, or a ``TrainState``'s parameters, optimizer state and
    counts. Every rank must hold the same structure (checked: a mismatch
    raises on every rank). A no-op without a group. -> ``obj``."""
    if mesh.group is None or not mesh.member:
        return obj
    if isinstance(obj, torch.nn.Module):
        tensors = [*obj.parameters(), *obj.buffers()]
    else:  # a TrainState
        opt = obj.optimizer
        tensors = list(opt.params)
        for p in opt.params:
            st = opt.opt.state.get(p, {})
            tensors += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
        counts = torch.tensor([obj.step, obj.opt_count], dtype=torch.int64,
                              device=opt.params[0].device)
        tensors.append(counts)
    layout = [(tuple(t.shape), str(t.dtype)) for t in tensors]
    seen = [None] * mesh.size
    dist.all_gather_object(seen, layout, group=mesh.group)
    if any(s != layout for s in seen):
        raise RuntimeError("replicate: the ranks hold tensors of different "
                           "layouts")
    for t in tensors:
        _broadcast(t, mesh)
    if not isinstance(obj, torch.nn.Module):
        obj.step, obj.opt_count = (int(c) for c in counts.tolist())
    return obj


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make ``mesh`` the one that ``psum`` and its forms reduce over, for
    the duration (the train step's forward, loss and backward)."""
    global _ACTIVE
    old, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = old


def active() -> Mesh | None:
    """The mesh in use when it has more than one rank, else None."""
    if _ACTIVE is None or _ACTIVE.size == 1:
        return None
    if not _ACTIVE.member:
        raise RuntimeError("a rank outside the mesh ran its step")
    return _ACTIVE


class _Psum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the upstream gradient:
    every rank's output depends on every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _Psum.apply(grad, ctx.group), None


def psum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, differentiable (its backward
    is the sum of the upstream gradients); ``x`` itself without a mesh of
    more than one rank."""
    if mesh is None or mesh.size == 1:
        return x
    return _Psum.apply(x, mesh.group)


def reduce_sum_(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``psum`` in place, outside autograd (sums a kernel hands back)."""
    if mesh is not None and mesh.size > 1:
        dist.all_reduce(x, group=mesh.group)
    return x


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``psum`` over the active mesh: a count or sum of the whole global
    batch."""
    return psum(x, active())


def share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a quantity of the whole global batch (one that
    every rank computes alike), so that the shares sum to it."""
    mesh = active()
    return x if mesh is None else x / mesh.size


def batch_means(xs, dims) -> list[torch.Tensor]:
    """The means of each of ``xs`` over ``dims`` and over the active mesh's
    ranks (one collective for all of them), each rank holding as many
    rows; ``x.mean(dims)`` without one."""
    mesh = active()
    if mesh is None:
        return [x.mean(dim=dims) for x in xs]
    n = math.prod(xs[0].shape[d] for d in dims) * mesh.size
    sums = psum(torch.stack([x.sum(dim=dims) for x in xs]), mesh)
    return list((sums / n).unbind(0))


def draw_rows(draw, shape) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows of the global batch: the array
    of the global shape (rows times the mesh's size on axis 0), drawn the
    same way on every rank, and this rank's rows of it, so that what each
    rank keeps does not depend on the mesh's size."""
    mesh = active()
    if mesh is None:
        return draw(tuple(shape))
    n = shape[0]
    full = draw((n * mesh.size, *shape[1:]))
    return full[mesh.index * n:(mesh.index + 1) * n]


def sum_gradients(params, mesh: Mesh | None) -> None:
    """Sum the parameters' ``.grad`` over the mesh in one collective of one
    flat buffer (a parameter without a gradient counts as zeros); each
    ``.grad`` becomes a view of the summed buffer. A no-op without a
    group; with a group of one rank the sum is the identity, to the bit."""
    if mesh is None or mesh.group is None:
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()


def reduce_metrics(tb: dict, mesh: Mesh | None) -> dict:
    """The sum over the mesh of each tensor in ``tb`` (each rank's share of
    a metric of the global batch), in one collective, each back in its
    dtype; ``tb`` itself without a mesh of more than one rank."""
    if mesh is None or mesh.size == 1:
        return tb
    keys = [k for k, v in tb.items() if torch.is_tensor(v)]
    if not keys:
        return tb
    flat = torch.stack([tb[k].detach().to(torch.float64).reshape(())
                        for k in keys])
    dist.all_reduce(flat, group=mesh.group)
    return dict(tb, **{k: v.to(tb[k].dtype) for k, v in zip(keys, flat)})
