"""The port's converter of the reference's ``.pth`` checkpoints
(``tpu3d_torch.tools.convert_torch_ckpt``) against tpu3d's.

No reference checkpoint is in the repo: the tests build one, a
reference-named ``model_state`` (the names of the reference's
``lib/net`` modules, conv kernels as (out, in, 1[, 1]), BatchNorm's
``running_*`` and ``num_batches_tracked``) of random values for the port
model's shapes, in the reference's container (``epoch``, ``it``,
``model_state``, ``optimizer_state``). Held: the port's converter gives
the parameters that tpu3d's ``convert_state_dict`` followed by
``weights.params_from_jax`` gives, every one of the model's entries, to
the bit; the tpu3d checkpoint it writes equals tpu3d's ``convert_file``
output byte for byte; and a file holding anything but tensors and plain
values is refused.
"""

import collections
import pickle
import re

import numpy as np
import pytest
import torch

from test_torch_rpn import _port_cfg
from tpu3d.config import fresh_cfg as jax_fresh_cfg
from tpu3d.tools import convert_torch_ckpt as jax_convert
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.tools import convert_torch_ckpt as convert
from tpu3d_torch.weights import params_from_jax


def _reference_name(key: str, cfg) -> str:
    """The reference's name of a port ``state_dict`` key (the inverse of
    ``convert_state_dict``'s map)."""
    leaf = {"weight": "conv.weight", "bias": None, "scale": "bn.bn.weight",
            "mean": "bn.bn.running_mean", "var": "bn.bn.running_var"}
    *path, layer, name = key.split(".")
    if name == "bias":
        name = "bn.bn.bias" if layer.startswith("bn_") else "conv.bias"
    else:
        name = leaf[name]
    prefix = ".".join(path)
    heads = {"rpn.cls_head": ("rpn.rpn_cls_layer", cfg.RPN),
             "rpn.reg_head": ("rpn.rpn_reg_layer", cfg.RPN),
             "rcnn_net.cls_head": ("rcnn_net.cls_layer", cfg.RCNN),
             "rcnn_net.reg_head": ("rcnn_net.reg_layer", cfg.RCNN)}
    if prefix in heads:
        ref, c = heads[prefix]
        dp = c.DP_RATIO >= 0
        n_fc = len(c.CLS_FC if "cls" in prefix else c.REG_FC)
        i = n_fc if layer == "out" else int(layer.split("_")[1])
        t = i if (i == 0 or not dp) else i + 1
        return f"{ref}.{t}.{name}"
    i = int(layer.split("_")[1])
    for pat, rep in ((r"^rpn\.backbone\.sa_(\d+)\.mlp_(\d+)$",
                      r"rpn.backbone_net.SA_modules.\1.mlps.\2"),
                     (r"^rpn\.backbone\.fp_(\d+)\.mlp$",
                      r"rpn.backbone_net.FP_modules.\1.mlp"),
                     (r"^rcnn_net\.sa_(\d+)\.mlp_0$",
                      r"rcnn_net.SA_modules.\1.mlps.0"),
                     (r"^rcnn_net\.(xyz_up|merge_down)$",
                      r"rcnn_net.\1_layer")):
        if re.match(pat, prefix):
            return f"{re.sub(pat, rep, prefix)}.layer{i}.{name}"
    raise KeyError(key)


def _reference_state(cfg, seed=0):
    """A reference-named model_state of random values for the port model of
    ``cfg``, in the reference's layouts, float32."""
    model = PointRCNN(cfg, mode="TEST", device="cpu")
    rng = np.random.default_rng(seed)
    sd = collections.OrderedDict()
    for key, t in model.state_dict().items():
        name = _reference_name(key, cfg)
        shape = tuple(t.shape)
        if name.endswith("conv.weight"):
            shape += (1,) if ("_layer." in name and "SA_" not in name
                              and "FP_" not in name and "xyz_up" not in name
                              and "merge_down" not in name) else (1, 1)
        value = rng.normal(0.0, 0.5, shape)
        if name.endswith("running_var"):
            value = np.abs(value) + 0.5
        sd[name] = torch.as_tensor(value, dtype=torch.float32)
        if name.endswith("running_var"):
            sd[name.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(7)
    return sd


CFGS = {"joint": {}, "rpn_only": {"RCNN.ENABLED": False},
        "rcnn_bn": {"RCNN.USE_BN": True}}


def _cfgs(name):
    jcfg = jax_fresh_cfg()
    jcfg.RCNN.ENABLED = True
    for k, v in CFGS[name].items():
        node = jcfg
        *path, leaf = k.split(".")
        for p in path:
            node = node[p]
        node[leaf] = v
    return jcfg, _port_cfg(jcfg)


@pytest.fixture(params=sorted(CFGS))
def case(request, tmp_path):
    jcfg, cfg = _cfgs(request.param)
    sd = _reference_state(cfg)
    path = tmp_path / "checkpoint_epoch_70.pth"
    torch.save({"epoch": 70, "it": 4321, "model_state": sd,
                "optimizer_state": {"state": {}, "param_groups": [
                    {"lr": 0.002, "betas": (0.95, 0.99), "params": [0, 1]}]}},
               path)
    return jcfg, cfg, sd, path


def test_converted_parameters_equal_tpu3d_s(case):
    """convert_to_state_dict gives every entry of the port model's
    state_dict, equal to tpu3d's convert_state_dict + params_from_jax, and
    the model loads it strictly; neither side reports a missing key."""
    jcfg, cfg, sd, _ = case
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    params, stats, missing = jax_convert.convert_state_dict(numpy_sd, jcfg)
    want = params_from_jax(params, stats)
    got, ours_missing = convert.convert_to_state_dict(numpy_sd, cfg)
    assert missing == ours_missing == []
    model = PointRCNN(cfg, mode="TEST", device="cpu")
    assert set(got) == set(want) == set(model.state_dict())
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    model.load_state_dict(got)


def test_converted_file_equals_tpu3d_s(case, tmp_path):
    """convert_file writes tpu3d's convert_file bytes (epoch and step from
    the container), through the CLI too."""
    jcfg, cfg, _, path = case
    convert.convert_file(str(path), str(tmp_path / "port.msgpack"), cfg)
    jax_convert.convert_file(str(path), str(tmp_path / "tpu3d.msgpack"),
                             jcfg)
    ours = (tmp_path / "port.msgpack").read_bytes()
    assert ours == (tmp_path / "tpu3d.msgpack").read_bytes()
    if cfg.RCNN.ENABLED and not cfg.RCNN.USE_BN:
        convert.main([str(path), "--out", str(tmp_path / "cli.msgpack")])
        assert (tmp_path / "cli.msgpack").read_bytes() == ours


def test_a_layout_mismatch_is_reported(tmp_path):
    """A checkpoint of another head depth than the cfg's: the unconsumed
    and absent keys are reported, as tpu3d reports them."""
    jcfg, cfg = _cfgs("joint")
    sd = {k: v.numpy() for k, v in _reference_state(cfg).items()}
    jcfg.RPN.CLS_FC = [128, 128]
    cfg.RPN.CLS_FC = [128, 128]
    _, _, missing = jax_convert.convert_state_dict(sd, jcfg)
    _, ours = convert.convert_to_state_dict(sd, cfg)
    assert ours == missing and any(k.startswith("UNCONSUMED") for k in ours)


class _Executable:
    def __reduce__(self):
        return (print, ("loaded",))


def test_executable_content_is_refused(tmp_path):
    """Only tensors and plain values load (weights_only=True): a pickled
    callable is refused."""
    path = tmp_path / "bad.pth"
    with open(path, "wb") as f:
        pickle.dump({"model_state": {}, "hook": _Executable()}, f)
    with pytest.raises(pickle.UnpicklingError):
        convert.load_reference(str(path))
