"""Checkpoint save / load / partial-load, in tpu3d's own file format.

The port's counterpart of ``tpu3d/utils/checkpoint.py``. A checkpoint is the
flax-msgpack file tpu3d writes, ``{epoch, step, params, batch_stats,
opt_state}`` (reference parity: tools/train_utils/train_utils.py:60-111),
read and written with the port's own codec (``utils/msgpack_io.py``):

- ``params`` / ``batch_stats`` are the model's ``state_dict`` through
  ``weights.params_to_jax`` / ``params_from_jax`` (Dense kernels
  transposed), keys sorted at every level as jax's tree functions leave
  them in tpu3d's file;
- ``step`` is ``TrainState.step``;
- ``opt_state`` is optax's state for tpu3d's optimizer, built from
  ``torch.optim``'s by the layout table below.

A tpu3d checkpoint loads into the port and saves back to the same bytes;
``load_part_ckpt`` grafts the parameter subtrees whose (path, shape) exist
in both (the reference's intersect-state-dict partial load, used to
warm-start the RCNN stage from an RPN checkpoint and for cross-domain
fine-tunes). ``tests/test_torch_checkpoint.py`` holds both against tpu3d.
"""

from __future__ import annotations

import functools
import os
import re
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..weights import params_from_jax, params_to_jax
from . import msgpack_io

# tpu3d's optimizer state as its checkpoint holds it, by TRAIN.OPTIMIZER
# (dumped from tpu3d.parallel.train_state.make_optimizer's init and update,
# optax 0.2.6). flax writes optax's chain tuple as {"0": ..., "1": ...} and
# each state namedtuple by its fields:
#   clip, decay  EmptyState {} (add_decayed_weights: only if WEIGHT_DECAY > 0)
#   adam         ScaleByAdamState {count, mu, nu}
#   sgd          TraceState {trace}
#   sched        ScaleByScheduleState {count}
#   inject       InjectStatefulHyperparamsState {count, hyperparams
#                {b1, b2, eps, eps_root, learning_rate, weight_decay},
#                hyperparams_states {b1: {count}, learning_rate: {count}},
#                inner_state}, over adamw's chain (adam, decay, scale {})
#
#   TRAIN.OPTIMIZER  chain                          moments at
#   adam_onecycle    (clip, inject)                 1/inner_state/0
#   adam             (clip, [decay], (adam, sched))  last/0
#   sgd              (clip, [decay], (sgd, sched))   last/0
#
# Every count is the number of updates the optimizer's state has taken
# (TrainState.opt_count; torch's Adam keeps it per parameter as "step"),
# and the hyperparameters are the schedules' values at the last update (at
# count 0 before any). Each moment maps to torch's per-parameter state:
TORCH_MOMENTS = {
    "adam_onecycle": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "sgd": {"trace": "momentum_buffer"},
}


_PRE_KERNEL = re.compile(r"^(mlp_\d+)_pre_kernel$")
_PRE_BIAS = re.compile(r"^(mlp_\d+)_pre_bias$")
_PRE_BN = re.compile(r"^(mlp_\d+)_pre_bn$")
_PRE_REST = re.compile(r"^(mlp_\d+)_rest$")
_LAYER = re.compile(r"^(dense|bn)_(\d+)$")


def migrate_pregroup_params(tree):
    """Rename the pre-round-3 pre-grouped SA parameter layout
    (``mlp_i_pre_kernel`` / ``mlp_i_pre_bn`` / ``mlp_i_rest``) into the
    unified ``mlp_i/dense_j`` + ``mlp_i/bn_j`` tree that both execution
    strategies now share. Applied recursively, so it also fixes the
    mirrored trees inside optimizer state. No-op on current checkpoints."""
    if not isinstance(tree, dict):
        return tree
    out = {}

    def _deep_merge(dst, sub):
        for k, v in sub.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                _deep_merge(dst[k], v)
            else:
                dst[k] = v

    def _merge(name, sub):
        _deep_merge(out.setdefault(name, {}), sub)

    for k, v in tree.items():
        m = _PRE_KERNEL.match(k)
        if m:
            _merge(m.group(1), {"dense_0": {"kernel": v}})
            continue
        m = _PRE_BIAS.match(k)
        if m:
            dst = out.setdefault(m.group(1), {}).setdefault("dense_0", {})
            dst["bias"] = v
            continue
        m = _PRE_BN.match(k)
        if m:
            _merge(m.group(1), {"bn_0": migrate_pregroup_params(v)})
            continue
        m = _PRE_REST.match(k)
        if m and isinstance(v, dict):
            shifted = {}
            for lk, lv in v.items():
                lm = _LAYER.match(lk)
                if lm:
                    shifted[f"{lm.group(1)}_{int(lm.group(2)) + 1}"] = \
                        migrate_pregroup_params(lv)
                else:
                    shifted[lk] = migrate_pregroup_params(lv)
            _merge(m.group(1), shifted)
            continue
        if isinstance(v, dict) and k in out:
            _merge(k, migrate_pregroup_params(v))
        else:
            out[k] = migrate_pregroup_params(v)
    return out


def _sorted(tree):
    """Dict keys in sorted order at every level, as jax's tree functions
    leave tpu3d's parameter trees."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _named_params(model: torch.nn.Module, state) -> list:
    """(name, parameter) for each parameter the optimizer updates, in its
    order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [(names[id(p)], p) for p in state.optimizer.params]


def _moments(model, state, count: int) -> dict:
    """torch's per-parameter state -> {mu, nu} or {trace} as flax trees
    (zeros before the first update, as optax's init)."""
    opt = state.optimizer
    out = {}
    for key, torch_key in TORCH_MOMENTS[opt.kind].items():
        tensors = {}
        for name, p in _named_params(model, state):
            st = opt.opt.state.get(p, {})
            if opt.kind != "sgd" and st:
                assert int(st["step"]) == count, (name, st["step"], count)
            value = st.get(torch_key)
            tensors[name] = torch.zeros_like(p) if value is None else value
        out[key] = _sorted(params_to_jax(tensors)[0])
    return out


def _moment_path(kind: str, weight_decay: float) -> tuple:
    if kind == "adam_onecycle":
        return ("1", "inner_state", "0")
    return (str(2 if weight_decay > 0 else 1), "0")


def _count_path(kind: str, weight_decay: float) -> tuple:
    """Where the optimizer's count sits: the injected hyperparameters'
    state, or the schedule's."""
    if kind == "adam_onecycle":
        return ("1", "count")
    return (str(2 if weight_decay > 0 else 1), "1", "count")


def opt_state_tree(model: torch.nn.Module, state) -> dict:
    """optax's state for tpu3d's optimizer, as flax writes it, from the
    port's ``TrainState`` (layout: the table above)."""
    opt = state.optimizer
    group = opt.opt.param_groups[0]
    wd = float(group["weight_decay"])
    count = np.asarray(state.opt_count, np.int32)
    moments = _moments(model, state, int(state.opt_count))
    if opt.kind == "adam_onecycle":
        last = max(int(state.opt_count) - 1, 0)
        f32 = functools.partial(np.asarray, dtype=np.float32)
        inject = {
            "count": count,
            "hyperparams": {"b1": f32(opt.b1(last)),
                            "b2": f32(group["betas"][1]),
                            "eps": f32(group["eps"]), "eps_root": f32(0.0),
                            "learning_rate": f32(opt.lr(last)),
                            "weight_decay": f32(wd)},
            "hyperparams_states": {"b1": {"count": count},
                                   "learning_rate": {"count": count}},
            "inner_state": {"0": {"count": count, **moments}, "1": {},
                            "2": {}},
        }
        return {"0": {}, "1": inject}
    first = {"count": count, **moments} if opt.kind == "adam" else moments
    chain = [{}] + ([{}] if wd > 0 else []) + [{"0": first,
                                                "1": {"count": count}}]
    return {str(i): s for i, s in enumerate(chain)}


def _load_opt_state(model: torch.nn.Module, state, tree: dict) -> None:
    """The inverse of ``opt_state_tree``: torch's optimizer state and
    ``state.opt_count`` from the checkpoint's."""
    opt = state.optimizer
    wd = float(opt.opt.param_groups[0]["weight_decay"])
    node = tree
    for key in _count_path(opt.kind, wd):
        node = node[key]
    state.opt_count = int(node)
    node = tree
    for key in _moment_path(opt.kind, wd):
        node = node[key]
    per_name = {key: params_from_jax(node[key], {})
                for key in TORCH_MOMENTS[opt.kind]}
    sd = opt.opt.state_dict()
    sd["state"] = {}
    for i, (name, p) in enumerate(_named_params(model, state)):
        st = {torch_key: per_name[key][name].to(p.dtype)
              for key, torch_key in TORCH_MOMENTS[opt.kind].items()}
        if opt.kind != "sgd":
            st["step"] = torch.tensor(float(state.opt_count),
                                      dtype=torch.float32)
        sd["state"][i] = st
    opt.opt.load_state_dict(sd)


def checkpoint_state(model: torch.nn.Module, state, epoch: int) -> dict:
    params, batch_stats = params_to_jax(model.state_dict())
    return {
        "epoch": np.int32(epoch),
        "step": np.asarray(state.step, np.int32),
        "params": _sorted(params),
        "batch_stats": _sorted(batch_stats),
        "opt_state": opt_state_tree(model, state),
    }


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module, state,
                    epoch: int, mesh=None) -> str:
    """Write ``checkpoint_epoch_{epoch}.msgpack`` under ``ckpt_dir`` ->
    its path. Over a data-parallel mesh (``parallel.Mesh`` with a group)
    the parameters are replicated: the mesh's first rank writes, and every
    rank of the mesh returns once the file is whole (a barrier)."""
    path = os.path.join(ckpt_dir, f"checkpoint_epoch_{epoch}.msgpack")
    group = None if mesh is None else mesh.group
    if group is None or mesh.index == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        payload = msgpack_io.encode(checkpoint_state(model, state, epoch))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    if group is not None:
        dist.barrier(group=group)
    return path


def _restore(template, raw, exact: bool, path: str = ""):
    """``raw`` at the template's paths, with the structure checks of
    flax's ``from_state_dict``: a dict's keys must all be in the
    checkpoint, a tuple's or namedtuple's (``exact``: ``opt_state`` above
    its parameter trees) must match it; leaves are taken as read."""
    if not isinstance(template, dict):
        return raw
    if not isinstance(raw, dict) or not set(template) <= set(raw) or (
            exact and set(template) != set(raw)):
        got = sorted(raw) if isinstance(raw, dict) else type(raw).__name__
        raise ValueError(f"checkpoint keys {got} do not match "
                         f"{sorted(template)} at {path or '/'}")
    return {k: _restore(v, raw[k], (exact or k == "opt_state")
                        and k not in ("mu", "nu", "trace"), f"{path}/{k}")
            for k, v in template.items()}


def _read(path: str) -> dict:
    with open(path, "rb") as f:
        return migrate_pregroup_params(msgpack_io.decode(f.read()))


def load_checkpoint(path: str, model: torch.nn.Module, state):
    """Full restore (params + optimizer + step) into ``model`` and
    ``state``, in place; returns (state, epoch). Each rank of a
    data-parallel mesh reads the file itself: a checkpoint holds no
    sharding, so one written at one world size restores at any other.

    When the checkpoint's optimizer-state STRUCTURE no longer matches the
    current optimizer (the optax chain changed between releases — e.g. the
    round-4 removal of the weight-decay mask), fall back to restoring
    params/batch_stats/step and start the optimizer's state afresh, its
    moments empty and its count (``state.opt_count``) at 0, as tpu3d keeps
    a freshly initialized ``opt_state``: evaluation and fine-tune warm
    starts keep working from old checkpoints, a resumed run restarts its
    Adam moments, and the next update reads the schedules at count 0 in
    both packages (reference load_checkpoint has the same weak spot — torch
    load_state_dict on a changed optimizer raises;
    train_utils.py:78-93)."""
    raw = _read(path)
    template = checkpoint_state(model, state, 0)
    try:
        restored = _restore(template, raw, False)
        opt_state = restored["opt_state"]
    except ValueError:
        template.pop("opt_state")
        restored = _restore(template, raw, False)
        opt_state = None
        warnings.warn(
            f"{path}: optimizer-state structure does not match the current "
            "optimizer; restored params/batch_stats/step and re-initialized "
            "the optimizer state")
    model.load_state_dict(params_from_jax(restored["params"],
                                          restored["batch_stats"]))
    if opt_state is not None:
        _load_opt_state(model, state, opt_state)
    else:
        state.optimizer.opt.state.clear()
        state.opt_count = 0
    state.step = int(restored["step"])
    return state, int(restored["epoch"])


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _unflatten_into(tree, flat):
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, {p[1:]: x for p, x in flat.items()
                                       if p and p[0] == k})
                for k, v in tree.items()}
    return flat.get((), tree)


def load_part_ckpt(path: str, model: torch.nn.Module, state, logger=None):
    """Graft matching (path, shape) params/batch_stats from a checkpoint
    into ``model`` (reference: train_utils.py:95-111 load_part_ckpt);
    returns ``state``."""
    raw = _read(path)
    updated = 0
    new_state = {}
    current_trees = dict(zip(("params", "batch_stats"),
                             params_to_jax(model.state_dict())))
    for field in ("params", "batch_stats"):
        current = current_trees[field]
        have = _flatten(raw.get(field, {}))
        cur_flat = _flatten(current)
        merged = {}
        for p, v in cur_flat.items():
            if p in have and np.shape(have[p]) == np.shape(v):
                merged[p] = np.asarray(have[p], dtype=np.asarray(v).dtype)
                updated += 1
            else:
                merged[p] = v
        new_state[field] = _unflatten_into(current, merged)
    if logger:
        logger.info(f"load_part_ckpt: grafted {updated} arrays from {path}")
    model.load_state_dict(params_from_jax(new_state["params"],
                                          new_state["batch_stats"]))
    return state


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_epoch = None, -1
    for fname in os.listdir(ckpt_dir):
        m = re.match(r"checkpoint_epoch_(\d+)\.msgpack$", fname)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(ckpt_dir, fname)
    return best
