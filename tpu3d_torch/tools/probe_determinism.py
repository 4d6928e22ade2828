"""Whether the train step repeats to the bit, and where it does not.

Runs a config's joint train step twice, each time from the same seeded
weights on the same batch and generator, and compares every tensor the
step leaves: the gradients before the clip, the parameters after it, the
optimizer's moments and the BatchNorm statistics. Hooks on every module's
output record a bit checksum of its gradient, so a difference is traced to
the first module, in the order the backward reaches them, whose output
gradient differs: the source lies in the backward of what consumes that
output. With ``--deterministic`` one more step runs under
``torch.use_deterministic_algorithms(True, warn_only=True)``, which names
each torch op that has no deterministic form on the device. The flag is
set here, in the probe, and never by the library.

    python -m tpu3d_torch.tools.probe_determinism [--cfg_file F] [--batch B]
        [--device cuda|cpu] [--deterministic]

Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

import torch

from ..config import cfg_from_file, fresh_cfg
from ..datasets import train_batch
from ..models import PointRCNN
from ..parallel import create_train_state, make_train_step
from ..weights import seeded_state_dict

SEED = 0


def _bits(t: torch.Tensor) -> torch.Tensor:
    """An integer checksum of a float tensor's bits (on its device)."""
    t = t.detach().contiguous()
    if t.dtype == torch.float64:
        return t.view(torch.int64).sum()
    return t.float().view(torch.int32).to(torch.int64).sum()


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def run_step(cfg, batch, dev, weights):
    """One train step from ``weights`` -> (the gradients before the clip,
    the parameters, the optimizer's moments, the buffers, the output
    gradients' checksums in the order the backward reached them)."""
    model = PointRCNN(cfg, mode="TRAIN", device=dev)
    model.load_state_dict(weights)
    state = create_train_state(cfg, model, steps_per_epoch=100,
                               total_epochs=10)
    step = make_train_step(cfg, model)
    order, handles = [], []

    def on_output(name):
        def hook(_module, _inputs, output):
            for i, t in enumerate(_tensors(output)):
                if t.requires_grad and t.is_floating_point():
                    t.register_hook(lambda g, k=f"{name}[{i}]":
                                    order.append((k, _bits(g))))
        return hook

    for name, module in model.named_modules():
        if name:
            handles.append(module.register_forward_hook(on_output(name)))
    grads, apply = {}, state.apply_gradients

    def keep_grads():
        grads.update({n: p.grad.detach().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
        return apply()

    state.apply_gradients = keep_grads
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    step(state, batch, gen, 0.9)
    for h in handles:
        h.remove()
    opt = state.optimizer.opt
    names = {id(p): n for n, p in model.named_parameters()}
    moments = {f"{names[id(p)]}.{k}": v.detach().clone()
               for p, s in opt.state.items() for k, v in s.items()
               if torch.is_tensor(v) and v.is_floating_point()}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    buffers = {n: b.detach().clone() for n, b in model.named_buffers()
               if b.is_floating_point()}
    return grads, params, moments, buffers, [(k, int(v)) for k, v in order]


def compare(a: dict, b: dict) -> dict:
    """name -> the largest difference, for each tensor not equal to the
    bit."""
    return {k: (a[k].double() - b[k].double()).abs().max().item()
            for k in a if not torch.equal(a[k], b[k])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg_file", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "configs", "default.yaml"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args(argv)
    cfg = cfg_from_file(args.cfg_file, fresh_cfg())
    dev = torch.device(args.device)
    host = train_batch(args.batch, cfg.RPN.NUM_POINTS, SEED)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    weights = seeded_state_dict(PointRCNN(cfg, mode="TRAIN", device="cpu"),
                                SEED)
    first = run_step(cfg, batch, dev, weights)
    second = run_step(cfg, batch, dev, weights)
    kinds = ("grads", "params", "moments", "buffers")
    diffs = {kind: compare(x, y) for kind, x, y in zip(kinds, first, second)}
    out = {"tensors": {kind: len(x) for kind, x in zip(kinds, first)},
           "differ": diffs}
    # the first output gradients, in backward order, whose bits differ
    a, b = dict(first[4]), dict(second[4])
    out["first_output_grads_differing"] = [
        k for k, _ in first[4] if k in b and a[k] != b[k]][:8]
    for kind in kinds:
        print(f"{kind}: {len(diffs[kind])} of {out['tensors'][kind]} differ "
              f"between two steps" + (f", e.g. {sorted(diffs[kind])[:4]}"
                                       if diffs[kind] else ""))
    print("first output gradients to differ (backward order):",
          out["first_output_grads_differing"])
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run_step(cfg, batch, dev, weights)
        finally:
            torch.use_deterministic_algorithms(False)
        msgs = sorted({str(w.message).split("\n")[0] for w in caught
                       if "determinis" in str(w.message)})
        out["nondeterministic_ops"] = msgs
        print("torch ops without a deterministic form on this device:")
        for m in msgs:
            print("  ", m)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
