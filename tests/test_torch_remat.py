"""``TRAIN.REMAT`` on the CPU: the RPN's backbone recomputed in the
backward (tpu3d's ``nn.remat(Pointnet2MSG)``, ``tpu3d/models/rpn.py:84-88``)
through ``torch.utils.checkpoint``.

- The port's train step with the key against the same step without it, at
  ``_tiny_cfg(rcnn=True, points=1024)`` in joint mode from the same
  weights, batch and draws, under the f32 contract and under the card's
  bf16 training contract (the CPU runs the bf16 forms' plain versions when
  handed it): the loss, every gradient, every parameter after the update
  and every running statistic equal to the bit. The recomputation rounds
  where the first forward rounds and sums in the same order, so it gives
  the same bits; the running statistics equal the step's without the key,
  so they took one update, not two, though the backbone's BatchNorm layers
  ran twice.
- The port with the key against tpu3d with the key (``tests/test_model.py``'s
  remat check, on ``tests/test_torch_train.py``'s f64 RPN case): the same
  tolerances as that case's without the key.
"""

import copy

import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from test_torch_bf16_train import TPU_TRAIN
from test_torch_rpn import _port_cfg
from test_torch_train import (_flat, assert_rpn_gradients_match,
                              assert_rpn_running_stats_match, rpn_grads)
from tpu3d_torch.datasets import train_batch
from tpu3d_torch.models import PointRCNN
from tpu3d_torch.models.pointnet2 import BatchNorm
from tpu3d_torch.parallel import create_train_state, make_train_step
from tpu3d_torch.precision import F32
from tpu3d_torch.tools import roofline
from tpu3d_torch.weights import seeded_state_dict


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module computes on one thread: beside the suite's other workers,
    torch's intra-op threads on a loaded host wait for each other far longer
    than they save (``tests/test_torch_parallel.py``'s reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _step(cfg, precision, remat):
    """One joint train step of ``cfg`` with ``TRAIN.REMAT`` = ``remat`` ->
    (loss, {gradients, parameters and statistics after it}, the calls of
    the backbone's first BatchNorm, the initial statistics)."""
    cfg = copy.deepcopy(cfg)
    cfg.TRAIN.REMAT = remat
    model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    model.load_state_dict(seeded_state_dict(model, 23))
    assert model.rpn.remat == remat
    initial = {k: v.clone() for k, v in model.state_dict().items()
               if k.endswith((".mean", ".var"))}
    bn = next(m for m in model.rpn.backbone.modules()
              if isinstance(m, BatchNorm))
    calls = []
    bn.register_forward_hook(lambda *_: calls.append(1))
    state = create_train_state(cfg, model, steps_per_epoch=10,
                               total_epochs=2)
    step = make_train_step(cfg, model, precision=precision)
    batch = {k: torch.from_numpy(v)
             for k, v in train_batch(2, 1024, seed=23).items()}
    tb = step(state, batch, torch.Generator().manual_seed(0), 0.9)
    out = {f"grad:{n}": p.grad.clone() for n, p in model.named_parameters()
           if p.grad is not None}
    out.update({k: v.clone() for k, v in model.state_dict().items()})
    return tb["loss"], out, len(calls), initial


@pytest.mark.parametrize("contract", ["f32", "bf16"])
def test_remat_step_equals_the_step_without_it(contract):
    """The joint train step with ``TRAIN.REMAT`` equals the one without to
    the bit: loss, gradients, updated parameters, running statistics. The
    backbone's BatchNorm ran twice with the key (the recomputation) and
    once without, and its statistics moved once."""
    cfg = _port_cfg(_tiny_cfg(rcnn=True, points=1024))
    precision = F32 if contract == "f32" else TPU_TRAIN
    loss, plain, calls, initial = _step(cfg, precision, False)
    rloss, remat, rcalls, _ = _step(cfg, precision, True)
    assert (calls, rcalls) == (1, 2)
    assert torch.isfinite(loss) and torch.equal(loss, rloss)
    assert set(plain) == set(remat)
    unequal = [k for k in plain if not torch.equal(plain[k], remat[k])]
    assert not unequal, unequal
    moved = [k for k in initial if not torch.equal(initial[k], remat[k])]
    assert len(moved) == len(initial)


def test_remat_leaves_the_contract_and_the_flops():
    """The key changes neither the training contract (``precision.resolve``
    reads it nowhere) nor the roofline's analytic FLOPs, which count the
    model's products without the recomputation, as tpu3d's roofline
    does."""
    from tpu3d_torch import precision

    cfg = _port_cfg(_tiny_cfg(rcnn=True, points=1024))
    rcfg = copy.deepcopy(cfg)
    rcfg.TRAIN.REMAT = True
    for device in ("cuda", "cpu"):
        assert precision.resolve(device, rcfg, train=True) == \
            precision.resolve(device, cfg, train=True)
    assert roofline.program_flops(rcfg, "train", 2) == \
        roofline.program_flops(cfg, "train", 2)


def test_remat_rpn_matches_tpu3d_remat():
    """The port's RPN gradients and running statistics with the key against
    tpu3d's with its ``nn.remat`` backbone (``tests/test_torch_train.py``'s
    f64 RPN case, the key on both sides): within the tolerances of the case
    without the key (1e-7 relative plus 1e-9 of the largest gradient; the
    loss within 1e-9; the statistics within 1e-9)."""
    case = rpn_grads(remat=True)
    assert_rpn_gradients_match(case)
    assert_rpn_running_stats_match(case)
    assert all(np.isfinite(g).all() for g in dict(_flat(case[1])).values())
