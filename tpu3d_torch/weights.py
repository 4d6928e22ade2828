"""Weights for the port: carried over from or to the JAX package's flax
tree, or made from a seed.

The port's modules carry the flax module names, so a flax path maps to a
state_dict key by joining with dots: ``rpn/backbone/sa_0/mlp_1/dense_0/kernel``
becomes ``rpn.backbone.sa_0.mlp_1.dense_0.weight``. Dense kernels are
(in, out) in flax and (out, in) in ``nn.Linear``; BatchNorm keeps flax's
names (``scale``, ``bias``, and the ``mean`` / ``var`` buffers).
``tpu3d/tools/convert_torch_ckpt.py:113-163`` documents the flax naming
against the reference's own checkpoint names.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def params_from_jax(params, batch_stats) -> dict[str, torch.Tensor]:
    """Flax ``params`` and ``batch_stats`` trees (nested mappings of arrays)
    -> the port's ``state_dict``: of ``PointRCNN``, and of
    ``tools/pointnet2_demo.PointnetSeg`` (its ``backbone``, ``head`` and
    ``out`` under flax's names)."""
    out = {}
    for path, value in _flatten(params):
        if path[-1] == "kernel":
            path, value = path[:-1] + ("weight",), value.T
        out[".".join(path)] = torch.tensor(value)
    for path, value in _flatten(batch_stats):
        out[".".join(path)] = torch.tensor(value)
    return out


def params_to_jax(state_dict) -> tuple[dict, dict]:
    """The port's ``state_dict`` (or any mapping of its keys to tensors,
    such as the parameters' gradients) -> flax's ``params`` and
    ``batch_stats`` trees as nested dicts of numpy arrays: the inverse of
    ``params_from_jax``."""
    params, stats = {}, {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        value = value.detach().cpu().numpy()
        tree = stats if leaf in ("mean", "var") else params
        if leaf == "weight":
            leaf, value = "kernel", value.T
        for p in path:
            tree = tree.setdefault(p, {})
        tree[leaf] = value
    return params, stats


def seeded_state_dict(model: nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Random weights for ``model`` from numpy's generator at ``seed``, so a
    seed gives the same weights on every device: He-normal Dense kernels,
    zero biases, the heads' reference inits (std 0.001 on both reg output
    kernels; a foreground prior of 1% on the RPN cls output bias, for
    default.yaml's SigmoidFocalLoss, while the RCNN's starts at 0), and
    BatchNorm statistics drawn away from the identity."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith(".weight"):
            std = 0.001 if name.endswith("reg_head.out.weight") \
                else np.sqrt(2.0 / shape[1])
            v = rng.normal(0.0, std, shape)
        elif name == "rpn.cls_head.out.bias":
            v = np.full(shape, -np.log((1 - 0.01) / 0.01))
        elif name.endswith(".scale"):
            v = rng.uniform(0.8, 1.2, shape)
        elif name.endswith(".mean"):
            v = rng.normal(0.0, 0.1, shape)
        elif name.endswith(".var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif ".bn_" in name:  # BatchNorm shift
            v = rng.normal(0.0, 0.05, shape)
        else:  # Dense biases
            v = np.zeros(shape)
        out[name] = torch.as_tensor(v, dtype=t.dtype)
    return out
