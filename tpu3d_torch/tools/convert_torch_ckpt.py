"""Convert a reference PointRCNN torch checkpoint into the port's model and
a tpu3d checkpoint (counterpart of ``tpu3d/tools/convert_torch_ckpt.py``).

The reference distributes trained weights as torch files whose
``model_state`` dict follows the module naming of its
``lib/net/{point_rcnn,rpn,rcnn_net}.py`` and ``pointnet2_lib``'s
``pytorch_utils.py`` (Conv1d/Conv2d towers named ``layer{i}.conv`` /
``layer{i}.bn.bn``, heads as ``nn.Sequential`` with a Dropout spliced in at
index 1). This module keeps its own copy of tpu3d's name map
(``convert_state_dict``): the reference's names -> tpu3d's flax tree (torch
``(out, in, 1, 1)`` conv kernels become Dense ``(in, out)`` kernels; BN
``weight/bias/running_mean/running_var`` become ``scale/bias`` and the
``mean/var`` statistics). Composed with ``weights.params_from_jax`` it
gives the port's ``state_dict`` (``convert_to_state_dict``); written with
the port's msgpack codec it gives the tpu3d checkpoint tpu3d's converter
writes, byte for byte (``convert_file``), which ``eval_rcnn --ckpt`` and
``load_checkpoint`` of either package accept (without optimizer state:
``load_checkpoint``'s structure fallback starts one afresh).

The file is read with ``torch.load(weights_only=True)``, the default from
torch 2.6: the reference's container (``train_utils.py:60-76``,
``{"epoch", "it", "model_state", "optimizer_state"}``) holds tensors, ints,
floats, lists and dicts alone, which that loader admits, and nothing
executable is loaded. A bare state dict loads too.

    python -m tpu3d_torch.tools.convert_torch_ckpt checkpoint_epoch_70.pth \\
        --out ckpt/checkpoint_epoch_70.msgpack [--cfg_file configs/default.yaml]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..utils import msgpack_io
from ..utils.checkpoint import _sorted
from ..weights import params_from_jax


def _conv_kernel(t) -> np.ndarray:
    """torch conv weight (out, in) / (out, in, 1) / (out, in, 1, 1) ->
    Dense kernel (in, out), in the tensor's dtype."""
    a = np.asarray(t)
    return a.reshape(a.shape[0], a.shape[1]).T


def _put(tree: dict, path: str, value: np.ndarray):
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


class _Mapper:
    def __init__(self, sd: dict):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}
        self.used = set()
        self.params: dict = {}
        self.stats: dict = {}
        self.missing: list[str] = []

    def take(self, key: str):
        if key not in self.sd:
            self.missing.append(key)
            return None
        self.used.add(key)
        return self.sd[key]

    def conv(self, tkey: str, our: str, bias: bool):
        w = self.take(f"{tkey}.conv.weight")
        if w is not None:
            _put(self.params, f"{our}/kernel", _conv_kernel(w))
        if bias:
            b = self.take(f"{tkey}.conv.bias")
            if b is not None:
                _put(self.params, f"{our}/bias", np.asarray(b))

    def bn(self, tkey: str, our: str):
        for tname, oname, dest in (
                ("weight", "scale", self.params),
                ("bias", "bias", self.params),
                ("running_mean", "mean", self.stats),
                ("running_var", "var", self.stats)):
            v = self.take(f"{tkey}.bn.bn.{tname}")
            if v is not None:
                _put(dest, f"{our}/{oname}", np.asarray(v))

    def shared_mlp(self, tprefix: str, oprefix: str, n_layers: int,
                   use_bn: bool):
        """pt_utils.SharedMLP -> SharedMLP (dense_{i} + bn_{i})."""
        for i in range(n_layers):
            self.conv(f"{tprefix}.layer{i}", f"{oprefix}/dense_{i}",
                      bias=not use_bn)
            if use_bn:
                self.bn(f"{tprefix}.layer{i}", f"{oprefix}/bn_{i}")

    def head(self, tprefix: str, oprefix: str, n_fc: int, use_bn: bool,
             dp: bool):
        """Conv1d tower Sequential (Dropout spliced at index 1 when
        DP_RATIO >= 0; rpn.py:26-28, rcnn_net.py:52-54) -> HeadMLP
        (dense_{i} [+ bn_{i}] ... out)."""
        for i in range(n_fc):
            t = i if (i == 0 or not dp) else i + 1
            self.conv(f"{tprefix}.{t}", f"{oprefix}/dense_{i}",
                      bias=not use_bn)
            if use_bn:
                self.bn(f"{tprefix}.{t}", f"{oprefix}/bn_{i}")
        t_out = n_fc + (1 if dp else 0)
        self.conv(f"{tprefix}.{t_out}", f"{oprefix}/out", bias=True)


def convert_state_dict(sd: dict, cfg) -> tuple[dict, dict, list[str]]:
    """Reference model_state -> (params, batch_stats, missing_keys), tpu3d's
    flax trees as nested dicts of numpy arrays.

    Handles the full joint model; RPN-only or RCNN-only checkpoints leave
    the other subtree absent (load_part_ckpt grafts what exists). A key of
    the model that the cfg's layout does not consume is reported as
    ``UNCONSUMED:<key>`` beside the expected keys that are absent."""
    m = _Mapper(sd)
    r = cfg.RPN
    has_rpn = any(k.startswith("rpn.") for k in m.sd)
    if has_rpn:
        for k in range(len(r.SA_CONFIG.NPOINTS)):
            for j in range(len(r.SA_CONFIG.MLPS[k])):
                m.shared_mlp(f"rpn.backbone_net.SA_modules.{k}.mlps.{j}",
                             f"rpn/backbone/sa_{k}/mlp_{j}",
                             len(r.SA_CONFIG.MLPS[k][j]), r.USE_BN)
        for i in range(len(r.FP_MLPS)):
            m.shared_mlp(f"rpn.backbone_net.FP_modules.{i}.mlp",
                         f"rpn/backbone/fp_{i}/mlp",
                         len(r.FP_MLPS[i]), r.USE_BN)
        dp = r.DP_RATIO >= 0
        m.head("rpn.rpn_cls_layer", "rpn/cls_head", len(r.CLS_FC),
               r.USE_BN, dp)
        m.head("rpn.rpn_reg_layer", "rpn/reg_head", len(r.REG_FC),
               r.USE_BN, dp)

    c = cfg.RCNN
    has_rcnn = any(k.startswith("rcnn_net.") for k in m.sd)
    if has_rcnn:
        if c.USE_RPN_FEATURES:
            m.shared_mlp("rcnn_net.xyz_up_layer", "rcnn_net/xyz_up",
                         len(c.XYZ_UP_LAYER), c.USE_BN)
            m.shared_mlp("rcnn_net.merge_down_layer", "rcnn_net/merge_down",
                         1, c.USE_BN)
        for k in range(len(c.SA_CONFIG.NPOINTS)):
            m.shared_mlp(f"rcnn_net.SA_modules.{k}.mlps.0",
                         f"rcnn_net/sa_{k}/mlp_0",
                         len(c.SA_CONFIG.MLPS[k]), c.USE_BN)
        dp = c.DP_RATIO >= 0
        m.head("rcnn_net.cls_layer", "rcnn_net/cls_head", len(c.CLS_FC),
               c.USE_BN, dp)
        m.head("rcnn_net.reg_layer", "rcnn_net/reg_head", len(c.REG_FC),
               c.USE_BN, dp)
    unused = [k for k in m.sd
              if k not in m.used and not k.endswith("num_batches_tracked")
              and (k.startswith("rpn.") or k.startswith("rcnn_net."))]
    return m.params, m.stats, m.missing + [f"UNCONSUMED:{k}" for k in unused]


def load_reference(pth_path: str) -> tuple[dict, dict]:
    """A reference checkpoint file -> (its model_state as numpy arrays, the
    container: ``epoch`` and ``it`` where it holds them), read with
    ``weights_only=True``."""
    blob = torch.load(pth_path, map_location="cpu", weights_only=True)
    sd = blob.get("model_state", blob) if isinstance(blob, dict) else blob
    sd = {k: v.numpy() if torch.is_tensor(v) else v for k, v in sd.items()}
    return sd, blob if isinstance(blob, dict) else {}


def convert_to_state_dict(sd: dict, cfg) -> tuple[dict, list[str]]:
    """Reference model_state -> (the port's ``state_dict`` entries it
    gives, missing_keys): ``convert_state_dict`` composed with
    ``weights.params_from_jax``."""
    params, stats, missing = convert_state_dict(sd, cfg)
    return params_from_jax(params, stats), missing


def convert_file(pth_path: str, out_path: str, cfg, epoch: int | None = None):
    """The reference checkpoint at ``pth_path`` as a tpu3d checkpoint at
    ``out_path`` ({epoch, step, params, batch_stats}; ``step`` from the
    container's ``it``) -> (params, batch_stats, missing_keys)."""
    sd, blob = load_reference(pth_path)
    params, stats, missing = convert_state_dict(sd, cfg)
    if epoch is None:
        # the reference's checkpoint_state defaults epoch/it to None
        # (train_utils.py:60-70): None counts as 0
        epoch = blob.get("epoch") or 0
    it = blob.get("it") or 0
    payload = {
        "epoch": np.int32(int(epoch)),
        "step": np.asarray(int(it), dtype=np.int32),
        "params": params,
        "batch_stats": stats,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        # flax writes every map's keys sorted
        f.write(msgpack_io.encode(_sorted(payload)))
    return params, stats, missing


def main(argv=None):
    from ..config import cfg_from_file, fresh_cfg

    ap = argparse.ArgumentParser()
    ap.add_argument("pth")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cfg_file", default=None)
    ap.add_argument("--epoch", type=int, default=None)
    args = ap.parse_args(argv)
    cfg = fresh_cfg()
    if args.cfg_file:
        cfg_from_file(args.cfg_file, cfg)
    _, _, missing = convert_file(args.pth, args.out, cfg, args.epoch)
    if missing:
        print(f"WARNING: {len(missing)} expected reference keys absent "
              f"(first 5: {missing[:5]})")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
