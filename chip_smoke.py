#!/usr/bin/env python3
"""Drive tpu3d_torch's eval paths and its train step on one NVIDIA card
and check them.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code
and no result line:

1. the card's name and power limit, as nvidia-smi gives them;
2. build every CUDA kernel from tpu3d_torch/csrc (one nvcc per source, all
   at once) and print the build time and ptxas's registers and spills;
3. each kernel against its plain PyTorch version on the card, at the shapes
   its path gives it, with its time (device time: calls run back to back
   on the card behind a spin kernel that outlasts their queueing, per
   call; beside it the queued ms, calls enqueued back to back between one
   pair of CUDA events on an idle card, which reads the host's enqueue
   rate where that is slower, and the call ms,
   one call timed alone from an idle stream, which also counts the
   wrapper's host time), the plain version's time, the time of one library
   call that computes the same function where there is one, and the least
   time the card could take for the same work. The eval kernels take the
   eval paths' inputs (the RPN's levels, and the RCNN's pooled ROIs of the
   joint forward, at B=2), and again the train step's shapes (B=16, the
   1024 sampled ROIs) for the per-step figures; nearest_k takes the six
   calls recorded from the eval forward and from the train step's forward,
   the dense box's six levels (every center with at least k points within
   its radius) and double.yaml's SA_0 (B=4), each bit for bit (d², ids,
   coordinates) through its own form and through both forms, each timed
   (the sweep), its bound counting the evaluations of the form its route
   chooses (for the windowed form, those inside the depth windows of the
   run's data) and the brute form's beside it; FPS over the
   RCNN's pooled rows (fps.cu) beside its dependent-chain floor, a minimal
   pick (rows of 32 points, one warp argmax) times the level's picks; the
   training kernels the train step's (B=16: the interpolation's backward
   at the four FP levels, two calls equal to the bit and d_features equal
   to the CPU plain version's to the bit, the grouping gather's backward
   (group_points_bwd, no TPU kernel: the fixed-order repair of
   torch.gather's scatter-add) at the RPN's six gathers, two calls equal
   to the bit and equal to the CPU plain version's to the bit, beside
   torch.gather's backward, the fused SA op's training forward and
   backward on the 1024 rows the proposal target layer samples);
   configs/double.yaml's SA_0 at 32768 points: the train route's long-row
   FPS (fps_long) and standalone three_nn at B=16, the eval route's
   FPS+3NN at B=4, each bit for bit; three_nn at every level of the split
   route (double's SA_0, also on a tie case; quickstart's SA_3, smoke's
   SA_2-3, eval and train) and at the shapes that place its route, in
   both forms (windowed and brute), each bit for bit and timed, its bound
   counting the pairs of the form its route chooses (for the windowed
   form, those inside the depth windows of the run's data) and the brute
   form's beside it; the slab forward's packed launch at S 16, 32 and 64 at
   every groups-per-block G, on group counts that leave a tail block,
   against the plain version (the training output equal to the eval
   output, every G equal to G = 1), each G timed; the slab form of the
   fused SA op at
   the RCNN's SA_1: its eval kernel (fused_sa_slab) on the pooled ROIs of
   configs/quickstart.yaml's eval (B=8) and of configs/smoke.yaml's (B=2),
   its training forward and backward (fused_sa_slab_train,
   fused_sa_slab_bwd) on the rows that the train steps' proposal target
   layer samples (quickstart B=4, smoke B=2); the same eval kernel with
   BatchNorm packs (fused_sa_slab_bn) at the RCNN's SA_0 and SA_1 of
   default.yaml with RCNN.USE_BN true (eval, B=2); and that chain's seven
   training kernels (three statistics passes, the last two writing x1 and
   x2, the final reduction, two backward waves and the elementwise pass)
   at SA_0 and SA_1 of its train step (B=16), each against its plain
   piece, then the whole training op on 128 rows against autograd of its
   plain version; every fused entry at the widened shapes (S 8, 24 and
   128, widths 256, 384 and 512) against its plain version. The gather
   backward (fused_sa_bwd) runs
   twice per level: under the seeded routing (the plain forward's argmax;
   reached slots, tiles and TFLOP/s over the reached slots printed) and
   under full spread (every channel live at a slot drawn uniformly over S,
   against its routed plain version, the bound over every slot); under
   each, two calls give the same bits in every gradient and d_pre equals
   the CPU's fixed-order sum of the kernel's own reached rows (each
   point's rows in ascending group·S + slot) to the bit. FPS's
   pick loop at every level it serves on each path (default, double,
   quickstart and smoke, eval and train): the geometry (k CTAs per
   cluster, threads, points per thread) it chooses and its neighbours,
   each bit for bit, in us per pick; the 3-NN pass as FPS+3NN less the
   picks alone; and the dependent-chain floor, one point per thread;
4. both eval paths at configs/default.yaml's full width (B=2 scenes of
   16384 points, NPOINTS 4096/1024/256/64, TEST pre/post-NMS 9000/100),
   with seeded weights and planted-cluster scenes, each with every launch
   count set to 0 just before it and read just after: the RPN-only path
   (make_rpn_infer_step, RCNN off) must launch its three kernels, the joint
   path (make_infer_step, as shipped: 200 ROIs of 512 points, RCNN SA
   128/32/GroupAll, score threshold and rotated final NMS) all five; shapes,
   finite values, some valid rois and some final boxes; ms per batch. In
   this run of every path driven (phases 4, 5 and 7-11), each nearest_k
   call is recorded and its d², ids and coordinates held to the plain
   version on its inputs, bit for bit, and so is each fps call's picks;
5. the train step (make_train_step) at the same full width in joint mode,
   B=16 scenes with their gt boxes (TRAIN pre/post-NMS 9000/512, 64 ROIs
   of 512 points per scene, jitter and augmentation on): one warm-up step,
   then five timed, the counts set to 0 just before the first timed step
   and read just after, which must launch the seven kernels of the path;
   loss and grad_norm finite and every parameter changed; ms per step and
   peak device memory; then one step in rpn mode, checked the same way;
6. scene 0 through the plain path on the CPU: the RPN's FPS picks of every
   level must be equal and rpn_cls / rpn_reg close; then the RCNN stage,
   fed the card's rois, backbone outputs and scores: the pooled points, the
   refinement outputs and the final boxes must agree with the card's; then
   the training: the RCNN loss and rcnn_net gradients on the card's
   sampled targets of scene 0, and the RPN's train-mode loss and gradients
   of scene 0 with dropout 0, each against the CPU plain path (the RPN's
   against a noise floor taken over four nudges of the weights);
7. configs/double.yaml as shipped (32768 points per scene, the RPN's
   widths of default.yaml): the joint eval path at B=4, which must launch
   the five eval kernels (fps3nn once per RPN level, SA_0's through its
   long-row FPS) and neither three_nn nor fps_long; then the joint train
   step at B=16 (1 warm-up, 3 timed), whose SA_0 takes the split route and
   must launch three_nn and fps_long once per step beside the seven kernels
   of phase 5; then scene 0's SA_0 split route on the card against the CPU
   plain route, bit for bit;
8. configs/quickstart.yaml as shipped (4096 points, RCNN SA_1 on the slab
   route, RPN SA_3 on the split route): the joint eval path at B=8 (the
   eval CLI's default batch) and the joint train step at B=4 (the README
   quickstart's batch; 1 warm-up, 5 timed), each with its exact launch
   counts (QUICK_EVAL, QUICK_TRAIN); then scene 0 against the CPU plain
   path: the RCNN stage and the final boxes, and the RCNN's training
   gradients on the card's sampled targets;
9. configs/smoke.yaml as shipped: the joint eval path and the joint train
   step at B=2, with their exact launch counts (SMOKE_EVAL, SMOKE_TRAIN);
10. default.yaml with RCNN.USE_BN true, set in memory (no file in configs/
   sets it), seeded weights with BatchNorm statistics away from 0 and 1:
   the joint eval path at B=2, with its exact launch counts (BN_EVAL:
   fused_sa_slab_bn at SA_0 and SA_1, no fused_sa); then scene 0's RCNN
   stage and final boxes against the CPU plain path;
11. the same config in training: the joint train step at B=16 (1 warm-up,
   3 timed), with its exact launch counts (default's train step without
   the gather form's training pair, and each of the seven BatchNorm
   training kernels twice); ms per step and peak device memory; one more
   step, after which each RCNN SA level's running statistics must equal
   m·old + (1 − m)·(the batch statistics the op returned); then scene 0's
   RCNN loss and gradients against the CPU plain path, under a noise floor
   measured there;
12. the widened RCNN: default.yaml with the RCNN's SA_0 at NSAMPLE 128 and
   MLPs 256 -> 384 -> 256 and 256 -> 256 -> 384, set in memory, without
   and with BatchNorm: the joint eval path and a joint train step at B=2,
   each of whose fused kernels must launch once per RCNN level;
13. the training CLI from frames on disk (tools/train_rcnn.main, in
   process): 32 synthetic KITTI frames and their GT database written by
   the port, default.yaml in joint mode at B=16 with GT augmentation and
   --train_with_eval, 2 epochs of 2 steps (TRAIN.SPLIT trainval), a
   checkpoint each epoch; run twice unbroken, the two equal to the bit
   in every parameter, statistic, Adam moment and loss, then resumed from
   the epoch-1 checkpoint: its parameters, statistics, Adam moments and
   last-epoch losses equal to the unbroken runs' to the bit, its step and
   epoch equal, every loss finite; the first run's launches (every train-step
   kernel and the validation pass's fused_sa); the card-written checkpoint
   read back on the host to the same bytes; the CLI's ms/step fed by the
   loader, the loader's scenes/s alone, the validation pass's ms per batch
   and the checkpoint's size and write time; then one epoch over 160
   frames (10 steps), for the CLI's pace past an epoch's first step;
14. the eval CLI and the evaluator (tools/eval_rcnn.main and
   evaluate.evaluate, in process), on phase 13's 32 frames: the joint eval
   of default.yaml at B=8 from phase 13's card-written checkpoint with
   --save_result (TEST.SPLIT trainval: 4 batches), each batch launching
   fps3nn 4, nearest_k 6, three_interpolate 4, fps 2 and fused_sa 2 times
   and no other kernel, a label file per frame, finite recall; the
   evaluator on the card over those labels, --metric new and old and every
   output transformation, each report equal to a CPU evaluator run on the
   same files, the card's overlap matrices within 1e-5 of the same function
   on CPU tensors, the native and the Python matcher giving equal arrays;
   the RPN mode with --save_rpn_feature --save_result, then one epoch of
   rcnn_offline training from its dumps at B=16 (fps, nearest_k,
   fused_sa_train and fused_sa_bwd twice a step, nothing else), then
   rcnn_offline eval of that checkpoint (fps, nearest_k and fused_sa
   twice a batch, nothing else); the eval CLI's
   scenes/s, the evaluator's seconds and peak device memory, the dumps'
   bytes and seconds, the offline step's ms and eval scenes/s;
15. tpu3d's data-parallel mesh on torch.distributed, on the one card:
   (a) NCCL at a world of 1 (a FileStore in a temporary directory, its
   group passed, so the gradients' all-reduce runs): default.yaml's train
   step at B=16 through the mesh and the sharded prefetch, with the same
   launches as the step without a group on the same batch and generator;
   1 + DP_REPEATS steps without a group equal to the bit in every
   parameter, statistic and Adam moment; the all-reduce and broadcast
   leave the step's gradients, parameters and statistics as they are, to
   the bit; the step equals the step without a group to the bit on every
   tensor; its ms/step beside phase 5's; (b) dryrun_multichip
   under NCCL with more ranks than cards raises; dryrun_multichip(2) under
   gloo on the card (the kernels built by phase 2, loaded by the ranks);
   two gloo ranks on the card: default.yaml's step and the RCNN.USE_BN one
   (kernel 9's training form under the reduced sums) at a global B=16, 8 a
   rank, parameters and running statistics equal across the ranks to the
   bit; the summed gradients before the clip, the running statistics and
   the parameters after the step each within 10 times its own noise floor
   of the one-process step's (the largest change over NUDGES nudges of
   the weights, as phase 4's gradient floors, plus 1e-5 of the largest
   entry); the same launches per rank per step as one process;
   the sharded joint eval at B=8 (4 a rank) keeping the same final boxes
   as one process, within 1e-3; a checkpoint written at world 2 restored
   at 1 to the bit; ms/step at each world, the gradients' all-reduce, the
   peak memory per rank and the phase's seconds, beside the card's name
   and power limit (not scaling figures: the ranks share one card);
16. the paper's slice: the PointNet++ demo's main on the card
   (--synthetic, one epoch) under its numerics contracts (tpu3d's demo
   model: the SA and FP casts, f32 Dense layers; TPU3D_F32_EVAL unset
   around it), each train step
   launching PN_TRAIN and each eval batch PN_EVAL exactly (the bf16 forms
   where tpu3d's routes round, none of PN_F32_FORMS), losses and IoU
   finite; generate_aug_scene
   over phase 13's frames and GT database (aug_times 1), read back
   through the port's dataset (each pasted scene's label linked into
   label_2, where the dataset reads it) and loader into a batch on the
   card; statnorm_effect at 8 frames and 2 epochs on smoke.yaml, its CLIs
   in subprocesses on the card, A_scaledto_B's car means within 0.01 m of
   B's and three tables of finite APs; default_cyclist.yaml's class
   (CLASSES Cyclist, the cyclist-sized anchor) on quickstart.yaml, one
   joint train step at B=4 from multi-class frames on disk and one eval
   batch, each with quickstart's launches;
17. the last of tpu3d outside its bench: default.yaml with
   RCNN.USE_INTENSITY set in memory, one joint eval batch (B=2) and one
   train step (B=16) with and without rpn_intensity, each with phase 4's /
   phase 5's launches; configs/default_people.yaml as shipped, a train step
   (B=16) and an eval batch (B=2) from multi-class frames on disk read with
   CLASSES People, the same launches; tools/roofline on default.yaml (the
   analytic counts, FlopCounterMode's, mfu_pct from the phase's median eval
   batch at B=8 and train step at B=16); tools/probe_dispatch's four
   numbers; one default eval batch under torch.profiler, its Chrome trace
   read back by tools/parse_trace, each csrc kernel seen as often as its
   entry launched; tools/bench_loader over phase 13's frames, thread and
   process workers at 1, 2 and 4 (each beside the card's name and power
   limit);
18. the eval numerics contract (tpu3d_torch/precision.py). Phases 1-17 run
   under the f32 contract (TPU3D_F32_EVAL=1, set at the start and
   removed here), so each keeps its own bounds; this phase runs the
   card's default, tpu3d's accelerator contract: (b) the joint eval batch
   of default.yaml (B=2), double.yaml (B=4), quickstart.yaml (B=8),
   smoke.yaml (B=2) and default.yaml with RCNN.USE_BN (B=2) under it and
   under TPU3D_F32_EVAL=1, counts set to 0 before each run and read after:
   every f32 launch of three_interpolate / fused_sa / fused_sa_slab /
   fused_sa_slab_bn taken over one for one by its bf16 form and the f32
   form not launched; the RPN's logits and regressions within
   CONTRACT_BOUND of the f32 run's largest value, the RCNN stage fed the
   f32 run's backbone outputs and rois within it too, the detections
   summarised; (c) the same at default.yaml with BF16_INFERENCE: true
   (the RPN within DENSE_RPN_BOUND: its scene-frame layer 0 runs in bf16,
   as tpu3d's does); (a) each bf16 form against its plain version at the
   inputs that (b) recorded (kernel 3 at default's four FP levels, 5 at
   default's RCNN SA_0 and SA_1, 8 at quickstart's SA_1, 9 at the
   BatchNorm RCNN's SA_0 and SA_1, the kernels line's rows; and apart, each
   path in a report of its own, 5 at double's, quickstart's and smoke's
   SA_0 and SA_1 (double), 8 at smoke's SA_1, S = 16, four groups a tile):
   kernel 3 equal to the bit, 5, 8 and 9
   within BF16_FORM_BOUND of the plain output's largest value and twice
   equal to the bit, 9 also so at each of its calls on running
   statistics whose folded scales take every sign and zero (a negative
   mul2 pools the min) with contiguous bf16 weights, 5, 8 and 9 on the
   design their C entry names
   (tpu3d_fused_sa_bf16_design, and tpu3d_fused_sa_slab_bn_bf16_design for
   9, held to fused_sa.eval_bf16_design), the wgmma design at every call
   (and, from the configs, at every level the five shipped configs fuse at
   eval), each printed, each timed
   beside its plain version, its library chain in bf16 and its f32 form,
   its bound at the bf16 peak; (d) ms per batch of both contracts in
   turns (f32, default, default, f32) and their peak memory; (e) one eval-CLI run (joint, phase 13's checkpoint) under
   the default contract, its bf16 launches per batch and scenes/s;
19. the training numerics contract. Phases 1-18 train under the f32
   training contract (TRAIN.BF16_ACTIVATIONS and TRAIN.BF16_MATMULS False
   in every config the process makes, f32_training, and as --set
   overrides for the data-parallel ranks, dryrun_multichip's and the
   study's CLIs), so each keeps its own bounds; this phase runs the card's
   default, tpu3d's accelerator training contract: (b) one joint train
   step each of default.yaml (B=16), double.yaml (B=16), quickstart.yaml
   (B=4) and smoke.yaml (B=2) from the same weights, batch and draws under
   it and under the f32 contract, counts set to 0 before each step: every
   f32 launch of fused_sa_train / fused_sa_bwd / fused_sa_slab_train /
   fused_sa_slab_bwd / three_interpolate / three_interpolate_bwd taken
   over one for one by its bf16 form, group_points_bwd's launches split
   between its two forms as ops/grouping.py::gp_route says (bf16_gathers),
   the RPN loss within RPN_LOSS_BOUND and the loss within TRAIN_LOSS_BOUND
   of the f32 step's, the gradients' norms by module beside the f32
   step's; (c) two default.yaml steps under it from one state equal to the
   bit in every gradient, parameter, Adam moment and statistic; (d) ms per
   default step of both contracts in turns (f32, default, default, f32)
   and their peak memory; (f) the BatchNorm RCNN (default.yaml with
   RCNN.USE_BN, B=16) under it: a step against the f32 one from the same
   weights, batch and draws, each f32 launch of kernel 9's seven training
   passes taken over one for one by its bf16 form, the RPN loss and the
   loss within the bounds above, two steps from one state equal to the
   bit, ms per step in turns (f32, default, default, f32) and the peak
   memory of both; then kernel 9's bf16 form at that step's calls (RCNN
   SA_0 and SA_1): the design of each of its seven entries there, its
   four products on the tensor cores (fused_sa_bn_wgmma.cuh; the C
   entry's own predicate agreeing with fused_sa.bn_train_bf16_design),
   each entry against its plain piece on
   the same inputs, timed beside it (bounds at BN_SLAB_FLIP_BOUND), the
   whole op through its autograd Function on BN_CHECK_ROWS rows equal to
   its passes composed directly and against autograd of the repaired plain
   form, and the bf16 cuBLAS chain with batch-statistics BatchNorm under
   autograd; (g) default.yaml B=16 with and without TRAIN.REMAT under both
   contracts: loss, every gradient, parameter, statistic and Adam moment
   equal to the bit between the two, ms per step in turns and the peak
   memory of each; (a) each bf16 training form
   against its plain version at the inputs (b) recorded (kernel 6 at
   default's RCNN SA_0 and SA_1, kernel 7 at its four FP levels, the
   gather's bf16 backward at RPN SA_1's two gathers, kernel 8 at
   quickstart's and smoke's SA_1): kernels 6 and 8 forward within
   BF16_FORM_BOUND of the plain version's largest value, the routed
   backward under the FLIP_ROWS rule (hold_bwd_outputs: rows beyond that
   bound held to a float64 evaluation of the chain),
   the argmax off the plain one's at most ARGMAX_FLIP_BOUND of the
   channels, kernel 7 and the gather equal to their CPU plain versions to
   the bit, every output twice equal to the bit, each timed beside its
   plain version, its f32 form, the bf16 cuBLAS chain under autograd (the
   library's scatter for the gathers) and its bound at the bf16 peak;
   kernel 6's bf16 forward on the design train_bf16_design names (the C
   entry's own predicate agreeing), the wgmma design at every default
   call, and held the same way at double's, quickstart's and smoke's
   calls and, on the parent design, at the widened RCNN's widths; kernels
   6 and 8's bf16 backward also under full spread (every channel live at a
   slot drawn uniformly over S, phase 3's draw), timed beside its f32
   form, its outputs seeded and there held under the FLIP_ROWS rule
   (hold_bwd_outputs), each call split by launch (kernel_bench.split_ms)
   with
   its launch count, on the design backward_bf16_design names (the C
   entry's own predicate agreeing; the tensor-core design at every
   recorded call), and kernel 6's held on the parent walk at the widened
   RCNN's widths, seeded and under full spread; the
   gather's bf16 backward with its gradient in the dtype and strides the
   step handed it, no copy or cast op (COPY_OPS) run between autograd's
   hand-over and the launch (gather_backward_ops), its bound counting g
   at that dtype; each with its sum over the step's calls;
   tools/roofline's mfu_pct of the default train step under it and of the
   eval batch (B=8) under the default eval contract; (e) one training-CLI
   epoch (joint, phase 13's frames) and one rcnn_offline epoch (phase 14's
   dumps) under it, their bf16 launches per step and ms per step;
20. one JSON line of the kernels (each row with its launches per rank per
   step at world 2, ``ddp_launches`` / ``ddp_bn_launches``, and per train
   step / eval batch of the demo, ``pn_train_launches`` /
   ``pn_eval_launches``; the bf16 forms' rows from phases 18 and 19), then
   the result line.

Every phase prints its seconds. Needs one CUDA card; the kernels have no
CPU mode. Imports nothing of JAX or of tpu3d.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0  # scenes, weights and interpolation features
BATCH = 2
TRAIN_BATCH = 16  # the training CLI's default --batch_size
DOUBLE_BATCH = 4  # configs/double.yaml's eval batch (BASELINE.md)
QUICK_EVAL_BATCH = 8  # the eval CLI's default --batch_size
QUICK_TRAIN_BATCH = 4  # the README quickstart's --batch_size
SMOKE_BATCH = 2
BN_BATCH = 2  # the default.yaml eval batch
DEVICE = "cuda"  # the card
BN_CHECK_ROWS = 128  # rows of the whole BatchNorm training op's check

# H100 SXM peaks from NVIDIA's data sheet, at the full 700 W: device memory
# rate and float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12  # dense, in the tensor cores

SOURCES = {  # kernel: (source, the TPU kernel it replaces)
    "fps3nn": ("tpu3d_torch/csrc/fps3nn.cu", "tpu3d/ops/sampling.py:176"),
    "nearest_k": ("tpu3d_torch/csrc/nearest_k.cu", "tpu3d/ops/grouping.py:80"),
    "three_interpolate": ("tpu3d_torch/csrc/three_interpolate.cu",
                          "tpu3d/ops/interpolate.py:262"),
    "fps": ("tpu3d_torch/csrc/fps.cu", "tpu3d/ops/sampling.py:73"),
    "fused_sa": ("tpu3d_torch/csrc/fused_sa.cu", "tpu3d/ops/fused_sa.py:771"),
    "three_interpolate_bwd": ("tpu3d_torch/csrc/three_interpolate_bwd.cu",
                              "tpu3d/ops/interpolate.py:276"),
    "fused_sa_train": ("tpu3d_torch/csrc/fused_sa.cu",
                       "tpu3d/ops/fused_sa.py:752"),
    "fused_sa_bwd": ("tpu3d_torch/csrc/fused_sa_bwd.cu",
                     "tpu3d/ops/fused_sa.py:782"),
    "three_nn": ("tpu3d_torch/csrc/three_nn.cu", "tpu3d/ops/interpolate.py:62"),
    "fps_long": ("tpu3d_torch/csrc/fps3nn.cu", "tpu3d/ops/sampling.py:73"),
    "fused_sa_slab": ("tpu3d_torch/csrc/fused_sa.cu",
                      "tpu3d/ops/fused_sa.py:594"),
    "fused_sa_slab_train": ("tpu3d_torch/csrc/fused_sa.cu",
                            "tpu3d/ops/fused_sa.py:575"),
    "fused_sa_slab_bwd": ("tpu3d_torch/csrc/fused_sa_bwd.cu",
                          "tpu3d/ops/fused_sa.py:604"),
    "fused_sa_slab_bn": ("tpu3d_torch/csrc/fused_sa.cu",
                         "tpu3d/ops/fused_sa.py:203"),
    "fused_sa_bn_stats0": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                           "tpu3d/ops/fused_sa.py:158"),
    "fused_sa_bn_stats1": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                           "tpu3d/ops/fused_sa.py:164"),
    "fused_sa_bn_stats2": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                           "tpu3d/ops/fused_sa.py:171"),
    "fused_sa_bn_final": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                          "tpu3d/ops/fused_sa.py:178"),
    "fused_sa_bn_wave1": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                          "tpu3d/ops/fused_sa.py:255"),
    "fused_sa_bn_wave2": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                          "tpu3d/ops/fused_sa.py:272"),
    "fused_sa_bn_apply": ("tpu3d_torch/csrc/fused_sa_bn.cu",
                          "tpu3d/ops/fused_sa.py:291"),
    # no TPU kernel: the fixed-order backward of the grouping gather, where
    # tpu3d's step takes XLA's VJP of its group_points
    "group_points_bwd": ("tpu3d_torch/csrc/group_points_bwd.cu",
                         "tpu3d/ops/grouping.py:481"),
}
# the BatchNorm chain's training kernels, in the order the step runs them
BN_TRAIN_KERNELS = ("fused_sa_bn_stats0", "fused_sa_bn_stats1",
                    "fused_sa_bn_stats2", "fused_sa_bn_final",
                    "fused_sa_bn_wave1", "fused_sa_bn_wave2",
                    "fused_sa_bn_apply")
# the kernels of each path whose launches are counted
EVAL_KERNELS = ("fps3nn", "nearest_k", "three_interpolate", "fps", "fused_sa")
TRAIN_KERNELS = ("fps3nn", "nearest_k", "three_interpolate",
                 "three_interpolate_bwd", "fps", "fused_sa_train",
                 "fused_sa_bwd", "group_points_bwd")
RPN_TRAIN_KERNELS = ("fps3nn", "nearest_k", "three_interpolate",
                     "three_interpolate_bwd", "group_points_bwd")
DOUBLE_TRAIN_KERNELS = TRAIN_KERNELS + ("three_nn", "fps_long")
# exact launches per forward or step of the new paths, every other count 0:
# quickstart's RPN SA_3 (64 points) and smoke's SA_2-3 take the split route
# (fps + three_nn), the RCNN's SA_0 (256 / 128 sources) the gather kernel,
# its SA_1 (64 / 32 sources) the slab kernel; with BatchNorm both RCNN
# levels take the slab kernel with BatchNorm packs. In training the
# grouping gather's backward runs at the RPN's SA_1-3 (one gather per
# radius of each level; SA_0 groups coordinates alone) and at each RCNN
# level on the slab route
QUICK_EVAL = {"fps3nn": 3, "three_nn": 1, "fps": 3, "nearest_k": 6,
              "three_interpolate": 4, "fused_sa": 1, "fused_sa_slab": 1}
QUICK_TRAIN = {"fps3nn": 3, "three_nn": 1, "fps": 3, "nearest_k": 6,
               "three_interpolate": 4, "three_interpolate_bwd": 4,
               "fused_sa_train": 1, "fused_sa_bwd": 1,
               "fused_sa_slab_train": 1, "fused_sa_slab_bwd": 1,
               "group_points_bwd": 7}
SMOKE_EVAL = dict(QUICK_EVAL, fps3nn=2, three_nn=2, fps=4)
SMOKE_TRAIN = dict(QUICK_TRAIN, fps3nn=2, three_nn=2, fps=4)
BN_EVAL = {"fps3nn": 4, "nearest_k": 6, "three_interpolate": 4, "fps": 2,
           "fused_sa_slab_bn": 2}
# the PointNet++ demo (tools/pointnet2_demo.py, 1024 points, B=4) under
# its numerics contracts (tpu3d's demo model, train_bf16=True and
# dtype=None: the SA and FP casts, f32 Dense layers): SA_0-1 on the fused
# FPS+3NN, SA_2-3 on the split route (64 and 32 points), a search per
# level, an interpolation per FP level on bf16 source features (kernel 3's
# bf16 form; its backward kernel 7's), the f32 launches of the same names
# none; per train step and per eval batch. The gathers' backward stays the
# exact f32 one at SA_1-3, as tpu3d's routes take it there (precise
# pre-grouped callers on at most 2048 points: _gp_route "onehot_exact")
PN_EVAL = {"fps3nn": 2, "fps": 2, "three_nn": 2, "nearest_k": 4,
           "three_interpolate_bf16": 4}
PN_TRAIN = dict(PN_EVAL, three_interpolate_bwd_bf16=4, group_points_bwd=6)
# the f32 kernels whose bf16 forms the demo's contract takes
PN_F32_FORMS = ("three_interpolate", "three_interpolate_bwd")
# the paths the new kernels are timed and labelled at
QUICK_PATH = {"eval": f"quickstart.yaml eval B={QUICK_EVAL_BATCH}",
              "train": f"quickstart.yaml train B={QUICK_TRAIN_BATCH}"}
SMOKE_PATH = {"eval": f"smoke.yaml eval B={SMOKE_BATCH}",
              "train": f"smoke.yaml train B={SMOKE_BATCH}"}
BN_PATH = f"default.yaml with RCNN.USE_BN eval B={BN_BATCH}"
BN_TRAIN_PATH = f"default.yaml with RCNN.USE_BN train B={TRAIN_BATCH}"
# the bf16 eval forms (phase 18): (source, the TPU kernel they compute as it
# rounds), and the f32 kernel each takes over under the accelerator contract
BF16_SOURCES = {
    "three_interpolate_bf16": ("tpu3d_torch/csrc/three_interpolate.cu",
                               "tpu3d/ops/interpolate.py:262"),
    "fused_sa_bf16": ("tpu3d_torch/csrc/fused_sa_wgmma_eval.cuh",
                      "tpu3d/ops/fused_sa.py:771"),
    "fused_sa_slab_bf16": ("tpu3d_torch/csrc/fused_sa_wgmma_eval.cuh",
                           "tpu3d/ops/fused_sa.py:594"),
    "fused_sa_slab_bn_bf16": ("tpu3d_torch/csrc/fused_sa_wgmma_eval.cuh",
                              "tpu3d/ops/fused_sa.py:203"),
}
BF16_OF = {"three_interpolate": "three_interpolate_bf16",
           "fused_sa": "fused_sa_bf16", "fused_sa_slab": "fused_sa_slab_bf16",
           "fused_sa_slab_bn": "fused_sa_slab_bn_bf16"}
# phase 18's bounds, stated before its first run: the fused bf16 forms
# against their plain versions (their f32 sums run in the tensor cores'
# order, so an x1 or x2 can round to the other bf16 neighbour: a step or
# two of the output), of the plain output's largest value; the default
# contract's RPN outputs and RCNN stage against the f32 run's, of the f32
# run's largest value (bf16 rounding at the SA, FP and ROI casts through
# the layers after them, up to ~3% at cut sizes on the CPU with BatchNorm,
# whose folded affines scale it); the RPN under BF16_INFERENCE, whose
# scene-frame layer 0 cancels in bf16
BF16_FORM_BOUND = 2.0 ** -6
CONTRACT_BOUND = 0.1
DENSE_RPN_BOUND = 0.25
# every other function of tpu3d that reaches pl.pallas_call, with its
# status: none, every one has its kernel
NOT_PORTED = []


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def cuda_ms(fn, reps: int):
    """Device ms per call of ``fn`` (calls run back to back on the card
    behind a spin that outlasts their queueing), with its ``queued`` and
    ``call`` ms: ``tpu3d_torch/tools/kernel_bench.py``'s clock, shared with
    ``tools/compare_kernels.py``."""
    from tpu3d_torch.tools.kernel_bench import cuda_ms as clock

    return clock(fn, reps)


def wall_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn`` ending in a synchronize."""
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Phases:
    """Seconds of each phase, printed as it ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, label: str) -> None:
        now = time.perf_counter()
        print(f"phase {label}: {now - self.t:.1f} s")
        self.t = now


def routed_slots(arg, grad, ppre, S):
    """The pooled gradients that reach the network, dval = grad where
    ppre > 0, and the slots of S they route to: -> (nnz, the non-zero dval;
    slots, the distinct (group, argmax slot) pairs of those channels, the
    only slots whose d_x1, and so dW1, db1 and d_x0, can be non-zero)."""
    import torch

    live = torch.where(ppre > 0, grad, 0.0) != 0
    R, M, _ = arg.shape
    groups = torch.arange(R * M, device=arg.device).view(R, M, 1)
    keys = (groups * S + arg.long())[live]
    return int(live.sum()), int(torch.unique(keys).numel())


def spread_draw(arg, ppre, S, gen):
    """Every pooled channel live at a slot drawn uniformly over S (phase 3's
    full spread): -> (argmax, ppre) in the shapes of ``arg`` and ``ppre``."""
    import torch

    return (torch.randint(0, S, arg.shape, generator=gen, device=arg.device,
                          dtype=torch.int32), torch.ones_like(ppre))


class Report:
    """Per kernel, summed over the launch shapes of one forward (eval
    kernels) or one train step (training kernels): worst error, kernel /
    plain / library ms, the kernel's queued and call ms (``cuda_ms``),
    bytes and operations (a routed search's: those of the form its route
    chooses), and any other count given (``brute_ops``: the operations of
    a routed search's brute form; ``chain_ms``: FPS's measured
    dependent-chain floor)."""

    def __init__(self, peak_ops: float = PEAK_F32_OPS_PER_S):
        self.rows = {}
        self.peak_ops = peak_ops  # the operations' peak of the bound

    def add(self, name, err, ms, plain_ms, lib_ms, n_bytes, n_ops, **counts):
        r = self.rows.setdefault(name, dict(err=0.0, ms=0.0, queued_ms=0.0,
                                            call_ms=0.0, plain_ms=0.0,
                                            lib_ms=0.0, bytes=0.0, ops=0.0))
        r["err"] = max(r["err"], err)
        r["ms"] += ms
        r["queued_ms"] += getattr(ms, "queued", ms)
        r["call_ms"] += getattr(ms, "call", ms)
        # a device figure that could not be separated from the host's time
        r["ms_host_bound"] = (r.get("ms_host_bound", False)
                              or not getattr(ms, "covered", True))
        r["plain_ms"] += plain_ms
        r["lib_ms"] = None if lib_ms is None else r["lib_ms"] + lib_ms
        r["bytes"] += n_bytes
        r["ops"] += n_ops
        for key, n in counts.items():
            r[key] = r.get(key, 0.0) + n

    def row(self, name):
        """The JSON fields of kernel ``name``: its times, error and
        bounds."""
        r = self.rows[name]
        b_ms, b_by = bound_ms(r["bytes"], r["ops"], self.peak_ops)
        out = {"max_abs_err": r["err"], "ms": r["ms"],
               "queued_ms": r["queued_ms"], "call_ms": r["call_ms"],
               "ms_host_bound": r["ms_host_bound"],
               "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": r["lib_ms"]}
        if "wgmma_calls" in r:  # kernel 6's bf16 training forward
            out["wgmma_calls"], out["parent_calls"] = (r["wgmma_calls"],
                                                       r["parent_calls"])
        if "mma_calls" in r:  # kernels 6 and 8's bf16 backward
            out["mma_calls"], out["parent_calls"] = (r["mma_calls"],
                                                     r["parent_calls"])
        if "full_ms" in r:  # a backward under full spread, at the same calls
            out["full_spread_ms"] = r["full_ms"]
            out["full_spread_f32_ms"] = r["full_f32_ms"]
            out["full_spread_bound_ms"] = r["full_bound_ms"]
            out["full_spread_reached_slots"] = r["full_reached"]
            out["full_spread_max_abs_err"] = r["full_err"]
        if "brute_ops" in r:  # a routed search: the brute form's bound
            out["brute_bound_ms"], out["brute_bound_by"] = bound_ms(
                r["bytes"], r["brute_ops"])
        if "chain_ms" in r:  # FPS: the measured dependent-chain floor
            out["chain_floor_ms"] = r["chain_ms"]
        if "f32_ms" in r:  # a bf16 form: its f32 form at the same inputs
            out["f32_ms"] = r["f32_ms"]
        if "lib_bwd_ms" in r:  # a backward: the library's backward alone
            out["library_backward_ms"] = r["lib_bwd_ms"]
            out["reached_slots"], out["slots"] = r["reached"], r["slots"]
        return out


def check_nearest_k(report, c, x, k, r, coords, label, sweep):
    """nearest_k, exact: d², ids and coordinates equal the plain version's in
    every slot, through the form the wrapper chooses and through both forms
    (each timed, into ``sweep``). Its time as
    the path calls it (with ``coords`` or not), the plain version's and
    cdist+topk's; its bound counts the evaluations of the form the route
    chooses: the windowed form's (inside the depth windows of these
    inputs) or the brute form's M·N, which is also kept as the brute
    bound."""
    import torch

    from tpu3d_torch.ops import nearest_k
    from tpu3d_torch.ops.grouping import (_radius2, depth_sort,
                                          depth_windows, launch_nearest_k,
                                          nearest_k_plain, nearest_k_route)

    b, m, n = c.shape[0], c.shape[1], x.shape[1]
    r2 = _radius2(r)
    got = nearest_k(c, x, k, max_radius=r, with_coords=True)
    ref = nearest_k_plain(c, x, k, max_radius=r, with_coords=True)
    torch.cuda.synchronize()
    for what, g, w in zip(("d²", "ids", "coordinates"), got, ref):
        check(torch.equal(g, w), f"nearest_k {what} differ at {label}")
    lo, hi = depth_windows(depth_sort(x)[0], c, r)
    window = int((hi - lo).sum())
    hits = int((ref[1] < n).sum())
    ms = cuda_ms(lambda: nearest_k(c, x, k, max_radius=r,
                                   with_coords=coords), 10)
    pms = cuda_ms(lambda: nearest_k_plain(c, x, k, max_radius=r,
                                          with_coords=coords), 3)
    lms = cuda_ms(lambda: torch.topk(torch.cdist(c, x), min(k, n), dim=2,
                                     largest=False), 3)
    sort_ms = cuda_ms(lambda: depth_sort(x), 10)  # the windowed form's
    times = {}
    for windowed in (True, False):
        form = "windowed" if windowed else "brute"
        g = launch_nearest_k(c, x, k, r2, windowed, True)
        check(all(torch.equal(a, w) for a, w in zip(g, ref)),
              f"nearest_k differs at {label}, {form}")
        times[form] = cuda_ms(
            lambda: launch_nearest_k(c, x, k, r2, windowed), 10)
    chosen = "windowed" if nearest_k_route(b, m, n, r2) else "brute"
    best = min(times, key=times.get)
    # per evaluation 3 sub, 3 mul, 2 add, radius compare; the bound counts
    # the evaluations of the form the route chooses
    nbytes = b * (m + n) * 12 + b * m * k * (20 if coords else 8)
    brute_ops = b * m * n * 9
    report.add("nearest_k", 0.0, ms, pms, lms, nbytes,
               window * 9 if chosen == "windowed" else brute_ops,
               brute_ops=brute_ops)
    sweep.append({"level": label, "B": b, "M": m, "N": n, "k": k, "r": r,
                  "coords": coords, "chosen": chosen, "ms": ms,
                  "queued_ms": ms.queued, "call_ms": ms.call,
                  "covered": ms.covered,
                  "plain_ms": pms, "library_ms": lms,
                  "sort_ms": sort_ms, "window_points": window / (b * m),
                  "hits": hits / (b * m),
                  "best": best, "sweep_ms": times})
    print(f"nearest_k {label} B={b} M={m} N={n} k={k} r={r}"
          f"{' with coordinates' if coords else ''}: {ms:.4f} ms (queued "
          f"{ms.queued:.4f}, call {ms.call:.4f}) {chosen}, best {best} "
          f"{times[best]:.4f}, depth "
          f"sort {sort_ms:.4f}; plain {pms:.3f} ms, cdist+topk {lms:.3f} ms; "
          f"d², ids and coordinates "
          f"equal at every form; {window / (b * m):.1f} points per window, "
          f"{hits / (b * m):.2f} hits per center")


NK_LEVELS = ("RPN SA_0", "RPN SA_1", "RPN SA_2", "RPN SA_3", "RCNN SA_0",
             "RCNN SA_1")


def nearest_k_kernels(report, calls, path, sweep):
    """Phase 3 for nearest_k at the six levels of one path: ``calls`` as
    ``record_nearest_k`` records them, or (centers, pts, k, radius)."""
    check(len(calls) == len(NK_LEVELS),
          f"{path}: {len(calls)} nearest_k calls, expected {len(NK_LEVELS)}")
    for level, call in zip(NK_LEVELS, calls):
        c, x, k, r = call[:4]
        coords = call[4] if len(call) > 4 else level == "RPN SA_0"
        check_nearest_k(report, c, x, k, r, coords, f"{path}, {level}",
                        sweep)


def audit_nearest_k(calls, launches, label):
    """Every nearest_k call of one run of a path (``record_nearest_k``)
    against the plain version on its inputs: d², ids and, where the path
    takes them, coordinates equal. One counted launch per call."""
    import torch

    from tpu3d_torch.ops.grouping import nearest_k_plain

    check(len(calls) == launches["nearest_k"],
          f"{label}: {len(calls)} nearest_k calls, "
          f"{launches['nearest_k']} launches")
    for i, (c, x, k, r, coords, out) in enumerate(calls):
        ref = nearest_k_plain(c, x, k, max_radius=r, with_coords=coords)
        for g, w in zip(out, ref):
            check(torch.equal(g, w), f"{label}: nearest_k call {i} (B="
                  f"{c.shape[0]} M={c.shape[1]} N={x.shape[1]}) differs "
                  f"from the plain version")
    print(f"{label}: its {len(calls)} nearest_k calls equal the plain "
          f"version's to the bit")


def audit_fps(calls, launches, label):
    """Every furthest_point_sample call of one run of a path
    (``record_fps``: the RCNN's SA levels and the split route's FPS)
    against the plain version on its inputs, the picks equal. One counted
    launch of fps or fps_long per call."""
    import torch

    from tpu3d_torch.ops.sampling import furthest_point_sample_plain

    check(len(calls) == launches["fps"] + launches["fps_long"],
          f"{label}: {len(calls)} fps calls, {launches['fps']} + "
          f"{launches['fps_long']} launches")
    for i, (xyz, npoint, out) in enumerate(calls):
        check(torch.equal(out, furthest_point_sample_plain(xyz, npoint)),
              f"{label}: fps call {i} (R={xyz.shape[0]} N={xyz.shape[1]} "
              f"npoint={npoint}) differs from the plain version")
    print(f"{label}: its {len(calls)} fps calls equal the plain version's "
          f"picks")


def rpn_kernels(report, cfg, pts, path, fps3nn=True):
    """Phase 3 for the RPN's kernels, at its four SA / FP levels: FPS+3NN
    (unless ``fps3nn`` is False) and the interpolation."""
    import torch

    from tpu3d_torch.ops import (furthest_point_sample_with_3nn,
                                 gather_points, interpolation_weights,
                                 three_interpolate)
    from tpu3d_torch.ops.interpolate import three_interpolate_plain
    from tpu3d_torch.ops.sampling import furthest_point_sample_with_3nn_plain

    sa = cfg.RPN.SA_CONFIG
    B = pts.shape[0]
    levels, caches = [pts], []
    for npoint in sa.NPOINTS:
        idx, d2, nn_idx = furthest_point_sample_with_3nn(levels[-1], npoint)
        caches.append((d2, nn_idx))
        levels.append(gather_points(levels[-1], idx))
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    # FPS + 3NN, exact: same picks, same neighbours, same d² bits
    for k, npoint in enumerate(sa.NPOINTS if fps3nn else ()):
        x = levels[k]
        n = x.shape[1]
        got = furthest_point_sample_with_3nn(x, npoint)
        ref = furthest_point_sample_with_3nn_plain(x, npoint)
        torch.cuda.synchronize()
        check(torch.equal(got[0], ref[0]), f"fps3nn picks differ at N={n}")
        check(torch.equal(got[2], ref[2]), f"fps3nn nn_idx differ at N={n}")
        err = (got[1] - ref[1]).abs().max().item()
        check(err == 0.0, f"fps3nn nn_d2 differ by {err} at N={n}")
        ms = cuda_ms(lambda: furthest_point_sample_with_3nn(x, npoint), 10)
        pms = cuda_ms(lambda: furthest_point_sample_with_3nn_plain(x, npoint),
                      2)
        # FPS: per (pick, point) 3 sub, 3 mul, 2 add, min, compare; 3-NN:
        # per (point, pick) 8 for d² and 8 for the insertion network
        ops = B * (npoint - 1) * n * 10 + B * n * npoint * 16
        nbytes = B * n * 12 + B * npoint * 4 + B * n * 24
        report.add("fps3nn", err, ms, pms, None, nbytes, ops)
        print(f"fps3nn {path} N={n} npoint={npoint}: {ms:.3f} ms, plain "
              f"{pms:.3f} ms, max_abs_err {err}")

    # three-point interpolation at FP_3 .. FP_0; the plain version sums in
    # the kernel's order, so they agree to the last bit (tolerance 1e-6)
    fp_known_c = [cfg.RPN.FP_MLPS[i + 1][-1] if i + 1 < len(cfg.RPN.FP_MLPS)
                  else sum(m[-1] for m in sa.MLPS[i])
                  for i in range(len(cfg.RPN.FP_MLPS))]
    for i in range(len(cfg.RPN.FP_MLPS) - 1, -1, -1):
        d2, nn_idx = caches[i]
        n, m, ch = levels[i + 1].shape[1], levels[i].shape[1], fp_known_c[i]
        feats = torch.randn(B, n, ch, generator=gen).to(pts.device)
        w = interpolation_weights(torch.sqrt(d2.clamp(min=0.0)))
        got = three_interpolate(feats, nn_idx, w)
        ref = three_interpolate_plain(feats, nn_idx, w)
        err = (got - ref).abs().max().item()
        check(err <= 1e-6, f"three_interpolate differs by {err} at M={m}")
        ms = cuda_ms(lambda: three_interpolate(feats, nn_idx, w), 20)
        pms = cuda_ms(lambda: three_interpolate_plain(feats, nn_idx, w), 5)

        def library():
            g = torch.gather(feats, 1, nn_idx.reshape(B, m * 3, 1).long()
                             .expand(-1, -1, ch)).reshape(B, m, 3, ch)
            return (g * w[..., None]).sum(2)

        lms = cuda_ms(library, 5)
        nbytes = B * n * ch * 4 + B * m * 3 * 8 + B * m * ch * 4
        report.add("three_interpolate", err, ms, pms, lms, nbytes,
                   B * m * ch * 5)
        print(f"three_interpolate {path} N={n} M={m} C={ch}: {ms:.3f} ms, "
              f"plain {pms:.3f} ms, gather+sum {lms:.3f} ms, max_abs_err "
              f"{err}")


def fps_minimal_pick(R, device):
    """us of one minimal pick of fps.cu on R rows: rows of 32 points (one
    per lane, one warp argmax per pick), timed at 32 picks and at 2, the
    difference over the 30 picks between (picks equal the plain
    version's)."""
    import torch

    from tpu3d_torch.ops import furthest_point_sample
    from tpu3d_torch.ops.sampling import furthest_point_sample_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    x = torch.rand(R, 32, 3, generator=gen, device=device) * 5.0
    check(torch.equal(furthest_point_sample(x, 32),
                      furthest_point_sample_plain(x, 32)),
          "fps picks differ at the minimal pick's rows")
    t32 = cuda_ms(lambda: furthest_point_sample(x, 32), 20)
    t2 = cuda_ms(lambda: furthest_point_sample(x, 2), 20)
    us = (t32 - t2) / 30 * 1e3
    print(f"fps minimal pick, {R} rows of 32 points: {t32:.4f} ms at 32 "
          f"picks, {t2:.4f} at 2, so {us:.4f} us per pick")
    return us


def rcnn_kernels(report, net, xyz, features, path):
    """Phase 3 for the RCNN's kernels on pooled ROIs (``xyz``): FPS at each
    single-scale level (SA_0 and SA_1; the GroupAll has no kernel), with
    its dependent-chain floor (the minimal pick, ``fps_minimal_pick``, on
    as many rows, times the level's picks), and, given the ``features``,
    the fused SA op there."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import (furthest_point_sample,
                                 fused_gathered_mlp_pool, gather_points,
                                 group_points)
    from tpu3d_torch.ops.fused_sa import fused_gathered_mlp_pool_plain
    from tpu3d_torch.ops.sampling import furthest_point_sample_plain

    R = xyz.shape[0]
    print(f"RCNN input, {path}: {R} ROIs of {xyz.shape[1]} points")
    pick_us = fps_minimal_pick(R, xyz.device)
    for k in range(net.n_sa):
        sa = getattr(net, f"sa_{k}")
        if sa.npoint is None:
            break
        n, npoint = xyz.shape[1], sa.npoint
        # FPS, exact: the same picks
        got = furthest_point_sample(xyz, npoint)
        ref = furthest_point_sample_plain(xyz, npoint)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"fps picks differ at RCNN SA_{k}")
        ms = cuda_ms(lambda: furthest_point_sample(xyz, npoint), 10)
        pms = cuda_ms(lambda: furthest_point_sample_plain(xyz, npoint), 2)
        ops = R * (npoint - 1) * n * 10
        nbytes = R * n * 12 + R * npoint * 4
        chain = pick_us * (npoint - 1) / 1e3
        report.add("fps", 0.0, ms, pms, None, nbytes, ops, chain_ms=chain)
        print(f"fps {path} RCNN SA_{k} R={R} N={n} npoint={npoint}: "
              f"{ms:.4f} ms ({ms / (npoint - 1) * 1e3:.3f} us per pick), "
              f"plain {pms:.3f} ms, chain floor {chain:.4f} ms, picks equal")
        if features is None:
            xyz = gather_points(xyz, got)
            continue

        # the fused gather + MLP + max-pool: f32 sums in another order,
        # tolerance 1e-4 of the largest value
        with torch.no_grad():
            new_xyz, pre, idx, center = sa.group_inputs(xyz, features)
            mlp = sa.mlp_0
            w1 = mlp.dense_1.weight.T.contiguous()
            w2 = mlp.dense_2.weight.T.contiguous()
            b1, b2 = mlp.dense_1.bias, mlp.dense_2.bias
            args = (pre, idx, center, w1, b1, w2, b2)
            got = fused_gathered_mlp_pool(*args)
            ref = fused_gathered_mlp_pool_plain(*args)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            check(err <= 1e-4 * scale,
                  f"fused_sa differs by {err} (max |value| {scale}) at "
                  f"RCNN SA_{k}")
            ms = cuda_ms(lambda: fused_gathered_mlp_pool(*args), 10)
            pms = cuda_ms(lambda: fused_gathered_mlp_pool_plain(*args), 3)

            def library():
                x = torch.relu(group_points(pre, idx) - center[:, :, None])
                x = torch.relu(F.linear(x, mlp.dense_1.weight, b1))
                return torch.relu(F.linear(x, mlp.dense_2.weight, b2)).amax(2)

            lms = cuda_ms(library, 3)
        M, S = idx.shape[1], idx.shape[2]
        c1, c2, c3 = w1.shape[0], w1.shape[1], w2.shape[1]
        # per slot: the two layers' multiply-adds, then sub + ReLU on C1,
        # bias + ReLU on C2, bias + ReLU + max on C3
        ops = R * M * S * (2 * (c1 * c2 + c2 * c3) + 2 * c1 + 2 * c2 + 3 * c3)
        nbytes = 4 * (pre.numel() + idx.numel() + center.numel() + w1.numel()
                      + w2.numel() + c2 + c3 + R * M * c3)
        report.add("fused_sa", err, ms, pms, lms, nbytes, ops)
        print(f"fused_sa RCNN SA_{k} R={R} N={n} M={M} S={S} "
              f"C={c1}->{c2}->{c3}: {ms:.3f} ms, plain {pms:.3f} ms, "
              f"group+linear+amax {lms:.3f} ms, max_abs_err {err:.3e} "
              f"(max |value| {scale:.3e}), "
              f"{ops / ms / 1e9:.1f} TFLOP/s")
        with torch.no_grad():
            features = got
        xyz = new_xyz


def double_kernels(report, extra, eval_pts, train_pts, npoint, sweep):
    """Phase 3 for configs/double.yaml's SA_0 (32768 points, ``npoint``
    picks), each bit for bit against its plain version: the split route's
    long-row FPS and three_nn at the train batch (three_nn also on a tie
    case: the picks repeated, so that most queries meet equal d² at
    several ids), and the fused route's FPS+3NN at the eval batch (kept
    apart in ``extra``: the fps3nn row of ``report`` is default.yaml's)."""
    import torch

    from tpu3d_torch.ops import (furthest_point_sample,
                                 furthest_point_sample_with_3nn, fused_route,
                                 gather_points)
    from tpu3d_torch.ops.sampling import (
        furthest_point_sample_plain, furthest_point_sample_with_3nn_plain)

    B, n = train_pts.shape[:2]
    check(not fused_route(B, n, npoint), "double train SA_0 should split")
    got = furthest_point_sample(train_pts, npoint)
    ref = furthest_point_sample_plain(train_pts, npoint)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"fps_long picks differ at N={n}")
    ms = cuda_ms(lambda: furthest_point_sample(train_pts, npoint), 5)
    pms = cuda_ms(lambda: furthest_point_sample_plain(train_pts, npoint), 1)
    report.add("fps_long", 0.0, ms, pms, None,
               B * n * 12 + B * npoint * 4, B * (npoint - 1) * n * 10)
    print(f"fps_long B={B} N={n} npoint={npoint}: {ms:.3f} ms "
          f"({ms / (npoint - 1) * 1e3:.2f} us per pick), plain {pms:.3f} ms,"
          f" picks equal")

    known = gather_points(train_pts, got)
    check_three_nn(report, train_pts, known,
                   f"double.yaml train B={B}, RPN SA_0", sweep)
    repeated = known[:, torch.arange(npoint, device=known.device)
                     % (npoint // 4)].contiguous()
    check_three_nn(None, train_pts, repeated, f"double.yaml train B={B}, "
                   f"RPN SA_0, tie case (each pick four times)", sweep)
    torch.cuda.empty_cache()

    b = eval_pts.shape[0]
    check(fused_route(b, n, npoint), "double eval SA_0 should be fused")
    got = furthest_point_sample_with_3nn(eval_pts, npoint)
    ref = furthest_point_sample_with_3nn_plain(eval_pts, npoint)
    torch.cuda.synchronize()
    for name, g, r in zip(("picks", "nn_d2", "nn_idx"), got, ref):
        check(torch.equal(g, r), f"fps3nn {name} differ at N={n}")
    ms = cuda_ms(lambda: furthest_point_sample_with_3nn(eval_pts, npoint), 5)
    pms = cuda_ms(lambda: furthest_point_sample_with_3nn_plain(eval_pts,
                                                               npoint), 1)
    extra.add("fps3nn", 0.0, ms, pms, None,
              b * n * 12 + b * npoint * 4 + b * n * 24,
              b * (npoint - 1) * n * 10 + b * n * npoint * 16)
    print(f"fps3nn B={b} N={n} npoint={npoint}: {ms:.3f} ms, plain "
          f"{pms:.3f} ms, picks, nn_d2 and nn_idx equal")


def check_three_nn(report, u, known, label, sweep):
    """three_nn, exact: d² and ids equal the plain version's through the
    form the wrapper chooses and through both forms (windowed, brute), each
    timed (into ``sweep``). Into ``report`` (unless None) its time as the
    path calls it, the plain version's and cdist+topk's; its bound counts
    the pairs of the form the route chooses: the windowed form's, the pairs
    inside each query's final depth window (``three_nn_windows``), or the
    brute form's M·N, which is also kept as the brute bound."""
    import torch

    from tpu3d_torch.ops import three_nn, three_nn_plain
    from tpu3d_torch.ops.interpolate import (depth_sort, launch_three_nn,
                                             three_nn_route,
                                             three_nn_windows)

    b, m, n = u.shape[0], u.shape[1], known.shape[1]
    ref = three_nn_plain(u, known)
    got = three_nn(u, known)
    torch.cuda.synchronize()
    check(torch.equal(got[1], ref[1]), f"three_nn ids differ at {label}")
    check(torch.equal(got[0], ref[0]), f"three_nn d² differ at {label}")
    lo, hi = three_nn_windows(depth_sort(known)[0], u, ref[0][..., 2])
    window = int((hi - lo).sum())
    times = {}
    for form, windowed in (("brute", False), ("windowed", True)):
        g = launch_three_nn(u, known, windowed)
        torch.cuda.synchronize()
        check(all(torch.equal(a, w) for a, w in zip(g, ref)),
              f"three_nn differs at {label}, {form}")
        times[form] = cuda_ms(lambda: launch_three_nn(u, known, windowed), 10)
    del got, ref, g
    ms = cuda_ms(lambda: three_nn(u, known), 10)
    pms = cuda_ms(lambda: three_nn_plain(u, known), 1)
    lms = cuda_ms(lambda: torch.topk(torch.cdist(u, known), 3, dim=2,
                                     largest=False), 2)
    sort_ms = cuda_ms(lambda: depth_sort(known), 10)  # the windowed form's
    torch.cuda.empty_cache()
    chosen = "windowed" if three_nn_route(b, m, n) else "brute"
    best = min(times, key=times.get)
    # per pair 3 sub, 3 mul, 2 add and a compare with the third nearest;
    # read both clouds, write d² and ids
    nbytes = b * (m + n) * 12 + b * m * 24
    brute_ops = b * m * n * 9
    ops = window * 9 if chosen == "windowed" else brute_ops
    if report is not None:
        report.add("three_nn", 0.0, ms, pms, lms, nbytes, ops,
                   brute_ops=brute_ops)
    sweep.append({"level": label, "B": b, "M": m, "N": n, "chosen": chosen,
                  "ms": ms, "queued_ms": ms.queued, "call_ms": ms.call,
                  "covered": ms.covered, "plain_ms": pms, "library_ms": lms,
                  "sort_ms": sort_ms, "window_points": window / (b * m),
                  "bound_ms": bound_ms(nbytes, ops)[0],
                  "brute_bound_ms": bound_ms(nbytes, brute_ops)[0],
                  "window_bound_ms": bound_ms(nbytes, window * 9)[0],
                  "best": best, "sweep_ms": times})
    print(f"three_nn {label} B={b} M={m} N={n}: {ms:.4f} ms (queued "
          f"{ms.queued:.4f}, call {ms.call:.4f}) {chosen}, best {best}; "
          + ", ".join(f"{f} {t:.4f}" for f, t in times.items())
          + f"; depth sort {sort_ms:.4f}; plain {pms:.3f} ms, cdist+topk "
          f"{lms:.3f} ms; d² and ids equal in both forms; "
          f"{window / (b * m):.1f} of {n} points per window; bound "
          f"{bound_ms(nbytes, ops)[0]:.6f} ms ({chosen})")


def split_three_nn(paths, reports, sweep):
    """Phase 3 for three_nn at the RPN levels of the split route on each
    path of ``paths`` ({label: (points, npoints)}), the known points the
    level's FPS picks (``check_three_nn``; into ``reports[label]`` where
    it has one); then at levels no shipped config reaches, planted-cluster
    scenes B x M -> N, where the route's threshold falls, and one of 8192
    known points, above what the windowed form stages in shared
    memory."""
    import torch

    from tpu3d_torch.datasets import train_batch
    from tpu3d_torch.ops import (furthest_point_sample, fused_route,
                                 gather_points)

    for label, (pts, npoints) in paths.items():
        for k, (x, npoint) in enumerate(fps_levels(pts, npoints)):
            B, N, _ = x.shape
            if fused_route(B, N, npoint):
                continue
            known = gather_points(x, furthest_point_sample(x, npoint))
            check_three_nn(reports.get(label), x, known,
                           f"{label}, RPN SA_{k}", sweep)
    for B, M, N in ((8, 1024, 256), (4, 4096, 1024), (8, 4096, 1024),
                    (16, 4096, 1024), (2, 16384, 4096), (1, 32768, 8192)):
        x = torch.from_numpy(train_batch(B, M, SEED)["pts_input"]).to(
            DEVICE)
        known = gather_points(x, furthest_point_sample(x, N))
        check_three_nn(None, x, known, f"planted scenes B={B} {M} -> {N}",
                       sweep)


def launch_picks(xyz, npoint, geometry):
    """The pick loop alone (the fps_long entry of csrc/fps3nn.cu) on
    ``geometry`` (k, threads, ppt), at any N: -> (B, npoint) picks."""
    import torch

    from tpu3d_torch.ops import _build

    B, N, _ = xyz.shape
    idx = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    _build.launch("fps_long", xyz.data_ptr(), B, N, npoint, *geometry,
                  idx.data_ptr())
    return idx


def fps_neighbours(N, geometry):
    """The chosen geometry and its neighbours: k and threads each halved,
    kept or doubled, with the fewest points per thread that cover N."""
    from tpu3d_torch.ops.sampling import FPS_PPT, FPS_PPT_THREADS, card_takes

    k, t, _ = geometry
    out = [geometry]
    for kk in (k // 2, k, 2 * k):
        for tt in (t // 2, t, 2 * t):
            if not 1 <= kk <= 16 or tt < 32:
                continue
            ppt = next((p for p in FPS_PPT if kk * tt * p >= N), None)
            if ppt is None or tt > FPS_PPT_THREADS[ppt]:
                continue
            g = (kk, tt, ppt)
            if g not in out and card_takes(g):
                out.append(g)
    return out


def fps_levels(pts, npoints):
    """The RPN's FPS levels of a batch: -> [(cloud, npoint)], each level's
    cloud the picks of the one before (either route of
    furthest_point_sample_with_3nn)."""
    from tpu3d_torch.ops import furthest_point_sample_with_3nn, gather_points

    levels, x = [], pts
    for npoint in npoints:
        levels.append((x, npoint))
        x = gather_points(x, furthest_point_sample_with_3nn(x, npoint)[0])
    return levels


def fps_pick_loop(paths):
    """Phase 3 for FPS's pick loop (csrc/fps3nn.cu) at every level it serves
    on each path of ``paths`` ({label: (points, npoints)}): the levels on
    the fused FPS+3NN route and the long-row FPS. Per level: the geometry
    card_geometry chooses, the picks alone on it (the fps_long entry) in us
    per pick, bit for bit against the plain picks, and, on the fused route,
    the 3-NN pass as the fused entry's time less the picks'; at the levels
    of 4096 points or more also the chosen geometry's neighbours (the
    sweep). Then the dependent-chain floor: default eval SA_0's cluster and
    CTA size with one point per thread (N = k · threads, every point
    picked), the cost of a pick's exchange alone. -> (levels, floor) for
    the JSON line."""
    import torch

    from tpu3d_torch.ops import furthest_point_sample_with_3nn, fused_route
    from tpu3d_torch.ops.sampling import (card_geometry,
                                          furthest_point_sample_plain)

    rows = []
    for label, (pts, npoints) in paths.items():
        for x, npoint in fps_levels(pts, npoints):
            B, N, _ = x.shape
            fused = fused_route(B, N, npoint)
            if not fused and N <= 2048:
                continue  # the split route's FPS is fps.cu
            ref = furthest_point_sample_plain(x, npoint)
            geom = card_geometry(B, N)
            sweep = []
            for g in (fps_neighbours(N, geom) if N >= 4096 else [geom]):
                got = launch_picks(x, npoint, g)
                torch.cuda.synchronize()
                check(torch.equal(got, ref), f"FPS picks differ at {label} "
                      f"N={N} on geometry {g}")
                ms = cuda_ms(lambda: launch_picks(x, npoint, g), 3)
                sweep.append({"geometry": list(g), "ms": ms,
                              "us_per_pick": ms / max(npoint - 1, 1) * 1e3})
            picks_ms = sweep[0]["ms"]
            row = {"path": label, "B": B, "N": N, "npoint": npoint,
                   "route": "fused" if fused else "split (fps_long)",
                   "geometry": list(geom), "picks_ms": picks_ms,
                   "us_per_pick": sweep[0]["us_per_pick"],
                   "sweep": sweep[1:]}
            if fused:
                f_ms = cuda_ms(
                    lambda: furthest_point_sample_with_3nn(x, npoint), 5)
                row.update(fused_ms=f_ms, three_nn_ms=f_ms - picks_ms)
            rows.append(row)
            best = min(sweep, key=lambda r: r["ms"])
            print(f"FPS pick loop {label} B={B} N={N} npoint={npoint}: "
                  f"(k, threads, ppt) = {geom}, picks {picks_ms:.3f} ms "
                  f"({row['us_per_pick']:.3f} us per pick)"
                  + (f", FPS+3NN {row['fused_ms']:.3f} ms, so 3-NN "
                     f"{row['three_nn_ms']:.3f} ms" if fused else "")
                  + f"; sweep: " + ", ".join(
                      f"{tuple(r['geometry'])} {r['us_per_pick']:.3f}"
                      for r in sweep) + f" us per pick (best "
                  f"{tuple(best['geometry'])}); picks equal")
    eval_pts, eval_npoints = next(iter(paths.values()))
    B, N, _ = eval_pts.shape
    k, threads, _ = card_geometry(B, N)
    n = k * threads
    gen = torch.Generator(device=eval_pts.device).manual_seed(SEED + 8)
    x = torch.rand(B, n, 3, generator=gen, device=eval_pts.device) * 40.0
    got = launch_picks(x, n, (k, threads, 1))
    torch.cuda.synchronize()
    check(torch.equal(got, furthest_point_sample_plain(x, n)),
          "FPS picks differ at the floor's geometry")
    ms = cuda_ms(lambda: launch_picks(x, n, (k, threads, 1)), 3)
    us = ms / (n - 1) * 1e3
    floor = {"geometry": [k, threads, 1], "B": B, "N": n, "npoint": n,
             "us_per_pick": us,
             "ms_at_npoint": us * (eval_npoints[0] - 1) / 1e3}
    print(f"FPS dependent-chain floor (measured): (k, threads, ppt) = "
          f"({k}, {threads}, 1), B={B}, {n} points all picked: {us:.3f} us "
          f"per pick, {floor['ms_at_npoint']:.3f} ms for "
          f"{eval_npoints[0] - 1} picks")
    return rows, floor


def compare_split_on_cpu(pts, npoint):
    """Scene 0 of the double train batch: the card's split route (run on
    the whole batch, as the train step does) against the CPU plain route,
    picks, nn ids and nn_d2 bit for bit."""
    import torch

    from tpu3d_torch.ops.sampling import fps_then_three_nn

    got = fps_then_three_nn(pts, npoint)
    t0 = time.perf_counter()
    ref = fps_then_three_nn(pts[:1].cpu(), npoint)
    cpu_s = time.perf_counter() - t0
    differ = {name: int((g[:1].cpu() != r).sum())
              for name, g, r in zip(("picks", "nn_d2", "nn_idx"), got, ref)}
    check(not any(differ.values()), f"double SA_0 split route differs "
          f"between the card and the CPU, entries: {differ}")
    print(f"double SA_0 split route, card (B={pts.shape[0]}) vs CPU plain on "
          f"scene 0: picks, nn_d2 and nn_idx equal; CPU {cpu_s:.1f} s")


def drive(infer, pts, expect_kernels, label):
    """One run of a path with every count set to 0 just before it and read
    just after, its nearest_k and fps calls recorded and held to the plain
    versions; then its ms per batch (host clock, median of 5)."""
    import torch

    from tpu3d_torch.ops import _build
    from tpu3d_torch.tools.kernel_bench import record_fps, record_nearest_k

    infer(pts)  # warm-up: allocator and library handles
    torch.cuda.synchronize()
    _build.reset_launches()
    with record_nearest_k() as nk_calls, record_fps() as fps_calls:
        out = infer(pts)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    audit_nearest_k(nk_calls, launches, label)
    audit_fps(fps_calls, launches, label)
    del nk_calls, fps_calls
    for name in expect_kernels:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {label} path")
    ms = wall_ms(lambda: infer(pts), 5)
    print(f"{label} path: {ms:.1f} ms/batch (host clock, median of 5; "
          f"{ms / pts.shape[0]:.1f} ms/scene), launches {launches}")
    return out, launches, ms


def check_outputs(out, expect):
    import torch

    for key, shape in expect.items():
        check(tuple(out[key].shape) == shape,
              f"{key} has shape {tuple(out[key].shape)}, expected {shape}")
        if out[key].is_floating_point():
            check(bool(torch.isfinite(out[key]).all()), f"{key} not finite")


def compare_rcnn_on_cpu(cfg, model, cpu_model, out):
    """Scene 0's RCNN stage on the CPU plain path, fed the card's rois,
    backbone outputs and raw scores, against the card's. A point on a
    box face can flip between the two devices' sin/cos; such ROIs are
    counted and left out of the comparison of the refinement outputs."""
    import torch

    from tpu3d_torch.tools.eval_rcnn import rcnn_decode_and_nms

    args = (out["backbone_xyz"][:1], out["backbone_features"][:1],
            out["rpn_scores_raw"][:1], out["rois"][:1])
    t0 = time.perf_counter()
    ref = cpu_model.rcnn_stage(*(a.cpu() for a in args))
    ref_pool = cpu_model.pool_rois(*(a.cpu() for a in args))
    cpu_s = time.perf_counter() - t0
    got = model.rcnn_stage(*args)
    got_pool = model.pool_rois(*args)
    check(torch.equal(got["pooled_empty_flag"].cpu(),
                      ref["pooled_empty_flag"]),
          "pooled empty flags differ between the card and the CPU")
    # pooled coordinates in each ROI's frame: the same points give the same
    # values up to the rounding of the canonical rotation
    pool_err = (got_pool[0].cpu() - ref_pool[0]).abs().amax(dim=(1, 2))
    same = pool_err <= 1e-4
    flips = int((~same).sum())
    print(f"RCNN stage, card vs CPU on scene 0: {flips} of {same.numel()} "
          f"ROIs pool another point set")
    check(flips <= max(1, same.numel() // 50),
          f"{flips} ROIs pool other points on the card than on the CPU")
    for key in ("rcnn_cls", "rcnn_reg"):
        a, b = got[key].cpu()[same], ref[key][same]
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        print(f"{key}: card vs CPU max abs err {err:.3e} (max |value| "
              f"{scale:.3e})")
        # f32 sums in another order on the two devices; tolerance 1e-4
        # relative to the largest value
        check(err <= 1e-4 * max(scale, 1.0), f"{key} differs by {err}")
    if flips == 0:
        # the decode, score threshold and rotated NMS of the card's
        # refinement outputs, on both devices
        m = args[3].shape[1]
        dec = [rcnn_decode_and_nms(cfg, args[3].to(dev),
                                   got["rcnn_cls"].reshape(1, m).to(dev),
                                   got["rcnn_reg"].reshape(1, m, -1).to(dev),
                                   out["roi_valid"][:1].to(dev))
               for dev in (DEVICE, "cpu")]
        check(torch.equal(dec[0]["final_mask"].cpu(), dec[1]["final_mask"]),
              "final NMS keeps differ between the card and the CPU")
        err = (dec[0]["final_boxes"].cpu() - dec[1]["final_boxes"]).abs()
        print(f"final NMS, card vs CPU on the card's outputs: keeps equal "
              f"({int(dec[1]['final_mask'].sum())}), final_boxes max abs err "
              f"{err.max().item():.3e}")
        check(err.max().item() <= 1e-4, "final boxes differ")
    print(f"CPU plain path: {cpu_s:.1f} s for scene 0's RCNN stage")


def interp_bwd_kernels(report, cfg, pts):
    """Phase 3 for the interpolation's backward, at the train step's four
    FP levels (B=16): two calls give the same bits; d_features equals the
    CPU plain version (index_add_, which adds in the kernel's ascending
    key order) bit for bit; d_features and d_weight are within 1e-5 of the
    largest value of the card's plain version (index_add_ with atomics, in
    another order); the time is that of the main path's form, which wants
    no d_weight."""
    import torch

    from tpu3d_torch.ops import (furthest_point_sample_with_3nn,
                                 gather_points, interpolation_weights)
    from tpu3d_torch.ops.interpolate import (three_interpolate_backward,
                                             three_interpolate_backward_plain)

    sa = cfg.RPN.SA_CONFIG
    B = pts.shape[0]
    levels, caches = [pts], []
    for npoint in sa.NPOINTS:
        idx, d2, nn_idx = furthest_point_sample_with_3nn(levels[-1], npoint)
        caches.append((d2, nn_idx))
        levels.append(gather_points(levels[-1], idx))
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    fp_known_c = [cfg.RPN.FP_MLPS[i + 1][-1] if i + 1 < len(cfg.RPN.FP_MLPS)
                  else sum(m[-1] for m in sa.MLPS[i])
                  for i in range(len(cfg.RPN.FP_MLPS))]
    for i in range(len(cfg.RPN.FP_MLPS) - 1, -1, -1):
        d2, nn_idx = caches[i]
        n, m, ch = levels[i + 1].shape[1], levels[i].shape[1], fp_known_c[i]
        feats = torch.randn(B, n, ch, generator=gen).to(pts.device)
        grad = torch.randn(B, m, ch, generator=gen).to(pts.device)
        w = interpolation_weights(torch.sqrt(d2.clamp(min=0.0)))
        args = (feats, nn_idx, w, grad)
        got = three_interpolate_backward(*args)
        again = three_interpolate_backward(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"three_interpolate_bwd differs between two calls at M={m}")
        del again
        cpu = three_interpolate_backward_plain(
            *(a.cpu() for a in args), need_weight=False)[0]
        check(torch.equal(got[0].cpu(), cpu), f"three_interpolate_bwd "
              f"d_features differs from the CPU plain version at M={m}")
        del cpu
        ref = three_interpolate_backward_plain(*args)
        err = 0.0
        for name, a, b in zip(("d_features", "d_weight"), got, ref):
            e = (a - b).abs().max().item()
            scale = b.abs().max().item()
            check(e <= 1e-5 * scale, f"three_interpolate_bwd {name} differs "
                  f"by {e} (max |value| {scale}) at M={m}")
            err = max(err, e)
        ms = cuda_ms(lambda: three_interpolate_backward(*args, False), 20)
        pms = cuda_ms(lambda: three_interpolate_backward_plain(*args, False),
                      5)
        rows = (nn_idx.long() + n * torch.arange(B, device=pts.device)
                [:, None, None]).reshape(-1)
        contrib = (w[..., None] * grad[:, :, None, :]).reshape(-1, ch)
        lms = cuda_ms(lambda: feats.new_zeros(B * n, ch).index_add_(
            0, rows, contrib), 5)
        # the main path's form: read g, idx and w, write d_features; a
        # multiply and an add per (row, neighbour, channel)
        nbytes = B * m * ch * 4 + B * m * 3 * 8 + B * n * ch * 4
        report.add("three_interpolate_bwd", err, ms, pms, lms, nbytes,
                   B * m * 3 * ch * 2)
        print(f"three_interpolate_bwd N={n} M={m} C={ch}: {ms:.4f} ms, "
              f"plain {pms:.3f} ms, index_add_ {lms:.3f} ms, max_abs_err "
              f"{err:.3e}; two calls equal, d_features equal to the CPU's")


def library_backward_ms(forward, grad):
    """Device ms of autograd's backward alone through ``forward``'s graph
    (the cuBLAS chain), the forward run once outside the timed window and
    its graph kept (``retain_graph``)."""
    import torch

    out = forward()
    inputs = _graph_leaves(out)
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, grad,
                                               retain_graph=True), 3)


def _graph_leaves(out):
    """The leaf tensors that require a gradient in ``out``'s graph."""
    seen, stack, leaves = set(), [out.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if hasattr(fn, "variable"):
            leaves.append(fn.variable)
        stack.extend(f for f, _ in fn.next_functions)
    return leaves


def bwd_ops(hit, nnz, c1, c2):
    """Operations of the gather backward: d_a1 and dW2 over the ``nnz``
    non-zero pooled gradients; layer 1's recompute, dW1, d_a0 and the ReLU
    masks over the ``hit`` slots they reach."""
    return 3 * 2 * hit * c1 * c2 + 2 * 2 * nnz * c2 + hit * (2 * c1 + 2 * c2)


def fused_train_kernels(report, full_spread, model, target):
    """Phase 3 for the fused SA op's training kernels, on the rows the
    train step's proposal target layer sampled, at RCNN SA_0 and SA_1.
    Forward: out equal to the eval kernel's to the bit, ppre within 1e-4
    of the largest value, argmax equal to the plain version's but at
    near-ties (f32 sums in another order may pick another slot whose value
    is the max within that tolerance; at most 1 in 1000). Backward: the six
    gradients within 1e-4 of each one's largest value, both routed by the
    plain version's argmax (the seeded routing); then the backward again
    under full spread (every channel live at a slot drawn uniformly over S)
    against its routed plain version, its time summed per step into
    ``full_spread``. Under both routings two calls give the same bits in
    every gradient, and d_pre equals the CPU's fixed-order sum of the
    kernel's own reached rows (``reached_rows_sum``: each point's rows in
    ascending group·S + slot) bit for bit."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import fused_gathered_mlp_pool
    from tpu3d_torch.ops.fused_sa import (
        BWD_TILE, _bwd_blocks, block_runs, fused_gathered_mlp_pool_backward,
        fused_gathered_mlp_pool_backward_plain,
        fused_gathered_mlp_pool_backward_routed_plain,
        fused_gathered_mlp_pool_train, fused_gathered_mlp_pool_train_plain,
        pack_tiles, reached_rows_sum, reached_slots)

    net = model.rcnn_net
    xyz, rest = target["sampled_pts"], target["pts_feature"]
    with torch.no_grad():
        features = net.point_features(xyz, rest)
    R = xyz.shape[0]
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    cuda_gen = torch.Generator(device=xyz.device).manual_seed(SEED + 7)
    for k in range(net.n_sa):
        sa = getattr(net, f"sa_{k}")
        if sa.npoint is None:
            break
        with torch.no_grad():
            new_xyz, pre, idx, center = sa.group_inputs(xyz, features)
            mlp = sa.mlp_0
            w1 = mlp.dense_1.weight.T.contiguous()
            w2 = mlp.dense_2.weight.T.contiguous()
            b1, b2 = mlp.dense_1.bias.detach(), mlp.dense_2.bias.detach()
            args = (pre, idx, center, w1, b1, w2, b2)
            out, arg, ppre = fused_gathered_mlp_pool_train(*args)
            evl = fused_gathered_mlp_pool(*args)
            torch.cuda.synchronize()
            check(torch.equal(out, evl), f"fused_sa_train out differs from "
                  f"the eval kernel's at RCNN SA_{k}")
            r_out, r_arg, r_ppre = fused_gathered_mlp_pool_train_plain(*args)
            scale = r_out.abs().max().item()
            err = (out - r_out).abs().max().item()
            check(err <= 1e-4 * scale, f"fused_sa_train out differs by {err}")
            perr = (ppre - r_ppre).abs().max().item()
            check(perr <= 1e-4 * max(scale, r_ppre.abs().max().item()),
                  f"fused_sa_train ppre differs by {perr}")
            flips = int((arg != r_arg).sum())
            check(flips <= arg.numel() // 1000,
                  f"fused_sa_train argmax differs in {flips} channels")
            ms = cuda_ms(lambda: fused_gathered_mlp_pool_train(*args), 5)
            pms = cuda_ms(lambda: fused_gathered_mlp_pool_train_plain(*args),
                          2)

        def library_forward():  # the cuBLAS chain, recording for autograd
            leaves = [t.detach().requires_grad_() for t in
                      (pre, center, mlp.dense_1.weight, b1,
                       mlp.dense_2.weight, b2)]
            x = torch.relu(torch_group(leaves[0], idx)
                           - leaves[1][:, :, None])
            x = torch.relu(F.linear(x, leaves[2], leaves[3]))
            return torch.relu(F.linear(x, leaves[4], leaves[5])).amax(2)

        lms = cuda_ms(library_forward, 2)
        M, S = idx.shape[1], idx.shape[2]
        c1, c2, c3 = w1.shape[0], w1.shape[1], w2.shape[1]
        ops = R * M * S * (2 * (c1 * c2 + c2 * c3) + 2 * c1 + 2 * c2
                           + 5 * c3)
        nbytes = 4 * (pre.numel() + idx.numel() + center.numel()
                      + w1.numel() + w2.numel() + c2 + c3 + 3 * R * M * c3)
        report.add("fused_sa_train", max(err, perr), ms, pms, lms, nbytes,
                   ops)
        print(f"fused_sa_train RCNN SA_{k} R={R} M={M} S={S} "
              f"C={c1}->{c2}->{c3}: {ms:.3f} ms, plain {pms:.3f} ms, cuBLAS "
              f"chain under autograd {lms:.3f} ms, out "
              f"equal to eval, max_abs_err {err:.3e} / ppre {perr:.3e} (max "
              f"|value| {scale:.3e}), argmax flips {flips} of "
              f"{arg.numel()}, {ops / ms / 1e9:.1f} TFLOP/s")

        # the backward, routed by the plain version's argmax on both sides
        grad = torch.randn(out.shape, generator=gen).to(out.device)
        got = fixed_order_backward(args, grad, r_arg, r_ppre,
                                   f"RCNN SA_{k}, seeded routing")
        ref = fused_gathered_mlp_pool_backward_plain(*args, grad)
        torch.cuda.synchronize()
        berr = 0.0
        for name, a, b in zip(("d_pre", "d_center", "dW1", "db1", "dW2",
                               "db2"), got, ref):
            e = (a - b).abs().max().item()
            sc = b.abs().max().item()
            print(f"  fused_sa_bwd SA_{k} {name}: max_abs_err {e:.3e} (max "
                  f"|value| {sc:.3e})")
            check(e <= 1e-4 * sc, f"fused_sa_bwd {name} differs by {e} at "
                  f"RCNN SA_{k}")
            berr = max(berr, e)
        del got, ref
        ms = cuda_ms(lambda: fused_gathered_mlp_pool_backward(
            *args, grad, r_arg, r_ppre), 5)
        pms = cuda_ms(lambda: fused_gathered_mlp_pool_backward_plain(
            *args, grad), 2)

        def library():
            leaves = [t.detach().requires_grad_() for t in
                      (pre, center, mlp.dense_1.weight, b1,
                       mlp.dense_2.weight, b2)]
            x = torch.relu(torch_group(leaves[0], idx)
                           - leaves[1][:, :, None])
            x = torch.relu(F.linear(x, leaves[2], leaves[3]))
            o = torch.relu(F.linear(x, leaves[4], leaves[5])).amax(2)
            torch.autograd.grad(o, leaves, grad)

        lms = cuda_ms(library, 2)
        lbms = library_backward_ms(library_forward, grad)
        nnz, hit = routed_slots(r_arg, grad, r_ppre, S)
        ops = bwd_ops(hit, nnz, c1, c2)
        nbytes = 4 * (2 * pre.numel() + idx.numel() + 2 * center.numel()
                      + w1.numel() + w2.numel() + c2 + 2 * R * M * c3
                      + w1.numel() + w2.numel() + c2 + c3)
        report.add("fused_sa_bwd", berr, ms, pms, lms, nbytes, ops,
                   lib_bwd_ms=lbms, reached=hit, slots=R * M * S)
        counts = reached_slots(torch.where(r_ppre > 0, grad, 0.0), r_arg,
                               S).sum(dim=1).tolist()
        runs = block_runs(counts, _bwd_blocks(R * M, c1, c2, c3))
        tiles = sum(len(pack_tiles([counts[g] for g in run]))
                    for run in runs)
        print(f"fused_sa_bwd RCNN SA_{k}, seeded routing: {ms:.3f} ms, plain "
              f"{pms:.3f} ms, autograd of the cuBLAS chain {lms:.3f} ms "
              f"(forward and backward; its backward alone {lbms:.3f} ms), "
              f"bound {bound_ms(nbytes, ops)[0]:.4f} "
              f"ms, {ops / ms / 1e9:.2f} TFLOP/s over the reached slots; "
              f"{nnz} non-zero pooled gradients reach {hit} of {R * M * S} "
              f"slots ({100 * hit / (R * M * S):.2f}%) in {tiles} tiles of "
              f"up to {BWD_TILE} rows on {len(runs)} blocks")

        # full spread: every channel live at a slot drawn uniformly over S,
        # on the same pre, idx and weights; against the routed plain
        # version, and the bound counts every slot
        full_arg, ones = spread_draw(r_arg, r_ppre, S, cuda_gen)
        got = fixed_order_backward(args, grad, full_arg, ones,
                                   f"RCNN SA_{k}, full spread")
        ref = fused_gathered_mlp_pool_backward_routed_plain(*args, grad,
                                                            full_arg, ones)
        torch.cuda.synchronize()
        ferr = 0.0
        for name, a, b in zip(("d_pre", "d_center", "dW1", "db1", "dW2",
                               "db2"), got, ref):
            e = (a - b).abs().max().item()
            sc = b.abs().max().item()
            check(e <= 1e-4 * sc, f"fused_sa_bwd {name} differs by {e} under "
                  f"full spread at RCNN SA_{k}")
            ferr = max(ferr, e / sc)
        del got, ref
        fms = cuda_ms(lambda: fused_gathered_mlp_pool_backward(
            *args, grad, full_arg, ones), 5)
        fnnz, fhit = routed_slots(full_arg, grad, ones, S)
        f_bound = bound_ms(nbytes, bwd_ops(R * M * S, fnnz, c1, c2))[0]
        full = full_spread.setdefault("fused_sa_bwd", dict(
            ms=0.0, bound_ms=0.0, reached=0, slots=0, max_rel_err=0.0))
        full["ms"] += fms
        full["bound_ms"] += f_bound
        full["reached"] += fhit
        full["slots"] += R * M * S
        full["max_rel_err"] = max(full["max_rel_err"], ferr)
        print(f"fused_sa_bwd RCNN SA_{k}, full spread: {fms:.3f} ms, bound "
              f"{f_bound:.3f} ms (every slot), "
              f"{bwd_ops(fhit, fnnz, c1, c2) / fms / 1e9:.2f} TFLOP/s over "
              f"the {fhit} reached of {R * M * S} slots; gradients within "
              f"{ferr:.2e} of each largest value of the routed plain version")
        del full_arg, ones
        # the train forward's output feeds the next level, as in the step
        with torch.no_grad():
            features = out
        xyz = new_xyz
        del args, pre, center, r_out, r_arg, r_ppre, grad
        torch.cuda.empty_cache()


def train_weights(model, seed):
    """Seeded weights for a model that trains: seeded_state_dict's, with
    the biases it leaves at 0 drawn small, so that weight decay moves every
    parameter even where the step's gradient is 0 (the RCNN's reg head when
    no sampled ROI is foreground)."""
    import numpy as np
    import torch

    from tpu3d_torch.weights import seeded_state_dict

    state = seeded_state_dict(model, seed)
    rng = np.random.default_rng(seed + 1)
    for name, v in state.items():
        if name.endswith(".bias") and not v.any():
            state[name] = torch.as_tensor(rng.normal(0.0, 0.01, v.shape),
                                          dtype=v.dtype)
    return state


def drive_train(cfg, model, batch, gen, expect_kernels, label, steps):
    """One warm-up step, then ``steps`` timed ones, the counts set to 0 just
    before the first timed step and read just after it, that step's
    nearest_k and fps calls recorded and held to the plain versions:
    launches per step, the metrics of the last step, ms per step (host
    clock, median)."""
    import contextlib

    import torch

    from tpu3d_torch.ops import _build
    from tpu3d_torch.parallel import create_train_state, make_train_step
    from tpu3d_torch.tools.kernel_bench import record_fps, record_nearest_k

    state = create_train_state(cfg, model, steps_per_epoch=100,
                               total_epochs=10)
    step = make_train_step(cfg, model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step(state, batch, gen, 0.9)
    torch.cuda.synchronize()
    times, launches = [], None
    for i in range(steps):
        if i == 0:
            _build.reset_launches()
        t0 = time.perf_counter()
        with (record_nearest_k() if i == 0
              else contextlib.nullcontext()) as calls, \
                (record_fps() if i == 0
                 else contextlib.nullcontext()) as fcalls:
            tb = step(state, batch, gen, 0.9)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = dict(_build.LAUNCHES)
            nk_calls, fps_calls = calls, fcalls
    audit_nearest_k(nk_calls, launches, label)
    audit_fps(fps_calls, launches, label)
    del nk_calls, fps_calls
    for name in expect_kernels:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {label} path")
    loss, gnorm = float(tb["loss"]), float(tb["grad_norm"])
    check(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0,
          f"{label}: loss {loss}, grad_norm {gnorm}")
    after = model.state_dict()
    params = dict(model.named_parameters())
    trained = {id(p) for p in state.optimizer.params}
    same = [k for k, p in params.items()
            if id(p) in trained and torch.equal(before[k], after[k])]
    check(not same, f"{label}: parameters unchanged: {same[:5]}")
    zero = [k for k, p in params.items()
            if id(p) in trained and p.grad is not None and not p.grad.any()]
    stats = [k for k in after if k.endswith((".mean", ".var"))]
    moved = sum(not torch.equal(before[k], after[k]) for k in stats)
    ms = statistics.median(times)
    print(f"{label}: {ms:.1f} ms/step (host clock, median of {steps}; "
          f"{ms / batch['pts_input'].shape[0]:.1f} ms/scene), loss {loss:.4f},"
          f" grad_norm {gnorm:.4f}, {len(trained)} parameters all changed "
          f"({len(zero)} with a zero gradient in the last step), running "
          f"statistics moved {moved}/{len(stats)}, launches per step "
          f"{launches}")
    return tb, launches, ms


def check_bn_running_stats(cfg, model, batch, gen):
    """One more train step of an RCNN with BatchNorm: each RCNN SA level's
    running statistics after it equal m·old + (1 − m)·(the batch statistics
    that fused_bn_mlp_pool returned in that step), to the bit, and moved."""
    import torch

    from tpu3d_torch.models import pointnet2
    from tpu3d_torch.parallel import create_train_state, make_train_step

    state = create_train_state(cfg, model, steps_per_epoch=100,
                               total_epochs=10)
    keys = [f"rcnn_net.sa_{k}.mlp_0.bn_{i}.{leaf}" for k in range(2)
            for i in range(3) for leaf in ("mean", "var")]
    before = {k: model.state_dict()[k].clone() for k in keys}
    returned, op = [], pointnet2.fused_bn_mlp_pool

    def recording(*args):
        res = op(*args)
        if args[5] is None:  # training: (pooled, (means, vars))
            returned.append(res[1])
        return res

    pointnet2.fused_bn_mlp_pool = recording
    try:
        make_train_step(cfg, model)(state, batch, gen, 0.9)
    finally:
        pointnet2.fused_bn_mlp_pool = op
    check(len(returned) == 2, f"fused_bn_mlp_pool trained {len(returned)} "
          f"levels, expected RCNN SA_0 and SA_1")
    after = model.state_dict()
    for k, (means, vars_) in enumerate(returned):
        for i in range(3):
            for leaf, value in (("mean", means[i]), ("var", vars_[i])):
                key = f"rcnn_net.sa_{k}.mlp_0.bn_{i}.{leaf}"
                want = 0.9 * before[key] + (1 - 0.9) * value
                check(torch.equal(after[key], want),
                      f"{key} is not the momentum update of the batch "
                      f"statistics")
                check(not torch.equal(after[key], before[key]),
                      f"{key} did not move")
    print(f"BatchNorm RCNN running statistics: the {len(keys)} of RCNN SA_0 "
          f"and SA_1 equal 0.9·old + 0.1·(the op's batch statistics) to the "
          f"bit, all moved")


NUDGES = 4  # independent nudges of the weights behind the RPN's noise floor


def compare_train_on_cpu(cfg, model, target, batch, rpn=True,
                         rcnn_floor=False):
    """Scene 0's training on the CPU plain path against the card's, with
    dropout 0 and the card model's weights.

    The RCNN loss and every rcnn_net gradient on the card's sampled targets
    of scene 0: the loss within 1e-5 relative, each gradient within 1e-3 of
    the largest (the fused kernels route a channel's gradient by an argmax
    that near-ties may move). The RPN's train-mode loss and gradients of
    scene 0: the loss within 1e-5 relative; the gradients against a noise
    floor, since the batch-statistics BatchNorm of SA_0 sees slabs padded
    with far points (a center without neighbours groups point 0), where
    E[x²] − mean² loses float32 digits on any device: the card's largest
    gradient error must be at most 10 times the change that perturbing
    every weight by about one float32 rounding makes on the CPU (plus
    1e-5 of the largest gradient), the largest change over ``NUDGES``
    independent perturbations, each printed, and the margin to that bound.
    (The weights are the card model's after its timed steps, and one
    perturbation's change swings with them.) The perturbation moves no FPS
    pick nor neighbour, which depend on the coordinates alone. ``rpn``
    False leaves out the RPN half. ``rcnn_floor`` holds the RCNN's loss and
    gradients to such a floor too, for an RCNN with batch-statistics
    BatchNorm: its gradient bound as the RPN's, its loss within 10 times
    the largest loss change over the perturbations plus 1e-6 relative."""
    import torch

    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.models.train_functions import (
        generate_rpn_labels_device, get_rcnn_loss, get_rpn_loss)

    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    rows = slice(0, int(cfg.RCNN.ROI_PER_IMAGE))
    sub = {k: v[rows] for k, v in target.items()}
    pts0 = batch["pts_input"][:1].cpu()
    labels = generate_rpn_labels_device(pts0, batch["gt_boxes3d"][:1].cpu())

    def rcnn_grads(m, dev, dtype):
        t = {k: v.to(dev) for k, v in sub.items()}
        out = m.rcnn_net(t["sampled_pts"], t["pts_feature"], train=True)
        return get_rcnn_loss(cfg, dict(out, **t))[0], m.rcnn_net

    def rpn_grads(m, dev, dtype):
        out = m.rpn(pts0.to(dev, dtype), True, 0.9)
        cls, reg = (t.to(dev) for t in labels)
        return get_rpn_loss(cfg, out["rpn_cls"], out["rpn_reg"], cls,
                            reg.to(dtype))[0], m.rpn

    def run(fn, dev, dtype, weights=state):
        m = PointRCNN(nodp, mode="TRAIN", device=dev).to(dtype)
        m.load_state_dict(weights)
        t0 = time.perf_counter()
        loss, net = fn(m, dev, dtype)
        loss.backward()
        grads = {n: p.grad.detach().cpu().double()
                 for n, p in net.named_parameters()}
        return float(loss.detach()), grads, time.perf_counter() - t0

    def worst(a, b):
        return max(((a[n] - g).abs().max().item(), n) for n, g in b.items())

    def nudged(i):
        gen = torch.Generator().manual_seed(SEED + 3 + i)
        return {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                if v.is_floating_point() else v for k, v in state.items()}

    nodp = copy.deepcopy(cfg)
    nodp.RPN.DP_RATIO = 0.0
    f32 = torch.float32
    loss, grads, _ = run(rcnn_grads, DEVICE, f32)
    ref_loss, ref, cpu_s = run(rcnn_grads, "cpu", f32)
    top = max(g.abs().max().item() for g in ref.values())
    err = worst(grads, ref)
    bound, loss_bound, floor_note = 1e-3 * top, 1e-5 * abs(ref_loss), ""
    if rcnn_floor:
        runs = [run(rcnn_grads, "cpu", f32, nudged(i)) for i in range(NUDGES)]
        floors = [worst(r[1], ref) for r in runs]
        floor = max(floors)
        loss_floor = max(abs(r[0] - ref_loss) for r in runs)
        bound = 10 * floor[0] + 1e-5 * top
        loss_bound = 10 * loss_floor + 1e-6 * abs(ref_loss)
        floor_note = (f"; noise floors of {NUDGES} nudges "
                      f"{', '.join(f'{f[0]:.3e}' for f in floors)} ({floor[1]})"
                      f", loss floor {loss_floor:.3e}; bounds {bound:.3e} "
                      f"(margin {bound / max(err[0], 1e-30):.1f}x) and "
                      f"{loss_bound:.3e}")
    print(f"RCNN train on scene 0, card vs CPU: loss {loss:.6f} vs "
          f"{ref_loss:.6f}; largest gradient error {err[0]:.3e} ({err[1]}) "
          f"of the largest gradient {top:.3e}; CPU {cpu_s:.1f} s{floor_note}")
    check(abs(loss - ref_loss) <= loss_bound, "RCNN train loss differs")
    check(err[0] <= bound, "RCNN gradients differ")
    if not rpn:
        return

    loss, grads, _ = run(rpn_grads, DEVICE, f32)
    ref_loss, ref, cpu_s = run(rpn_grads, "cpu", f32)
    floors = [worst(run(rpn_grads, "cpu", f32, nudged(i))[1], ref)
              for i in range(NUDGES)]
    top = max(g.abs().max().item() for g in ref.values())
    err, floor = worst(grads, ref), max(floors)
    bound = 10 * floor[0] + 1e-5 * top
    print(f"RPN train on scene 0, card vs CPU: loss {loss:.6f} vs "
          f"{ref_loss:.6f}; largest gradient error {err[0]:.3e} ({err[1]}); "
          f"noise floors of {NUDGES} nudges "
          f"{', '.join(f'{f[0]:.3e}' for f in floors)}, floor {floor[0]:.3e} "
          f"({floor[1]}); bound {bound:.3e}, margin {bound / max(err[0], 1e-30):.1f}x; "
          f"largest gradient {top:.3e}; CPU {cpu_s:.1f} s")
    check(abs(loss - ref_loss) <= 1e-5 * abs(ref_loss),
          "RPN train loss differs")
    check(err[0] <= bound, "RPN gradients differ")


def slab_levels(model, xyz, rest):
    """The RCNN levels of ``model`` that take the slab route, fed pooled
    points ``xyz`` / ``rest`` through the levels before them as the model
    runs them at eval: [(k, x0 (R, M, S, 128) the grouped slab, the level's
    SharedMLP)]."""
    import torch

    from tpu3d_torch.ops import group_points, sa_route

    net = model.rcnn_net
    levels = []
    with torch.no_grad():
        features = net.point_features(xyz, rest)
        for k in range(net.n_sa):
            sa = getattr(net, f"sa_{k}")
            if sa.npoint is None:
                break
            shape = (xyz.shape[0], sa.npoint, sa.nsample, sa.mlp[0])
            if sa_route(shape, sa.mlp, xyz.shape[1], sa.mlp_0.bn) == "slab":
                _, pre, idx, center = sa.group_inputs(xyz, features)
                levels.append((k, group_points(pre, idx)
                               - center[:, :, None, :], sa.mlp_0))
            xyz, features = sa(xyz, features)
    return levels


def dense_weights(mlp):
    """A SharedMLP's layers 1-2 as the fused ops take them: (w1 (C1, C2),
    b1, w2 (C2, C3), b2), the biases None with BatchNorm."""
    return (mlp.dense_1.weight.detach().T.contiguous(),
            None if mlp.bn else mlp.dense_1.bias.detach(),
            mlp.dense_2.weight.detach().T.contiguous(),
            None if mlp.bn else mlp.dense_2.bias.detach())


def slab_eval_kernel(x0, mlp, label):
    """The slab eval kernel at one level, without BatchNorm
    (fused_sa_slab) or with it (fused_sa_slab_bn, its packs folded from the
    level's running statistics), against its plain version: within 1e-4 of
    the largest value (f32 sums in another order). The library is the
    cuBLAS chain of the same layers on the same slab. -> (err, ms,
    plain_ms, library_ms, bytes, operations)."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import fused_bn_mlp_pool, fused_mlp_pool
    from tpu3d_torch.ops.fused_sa import (bn_packs, fused_sa_slab_plain,
                                          nobn_packs)

    w1, b1, w2, b2 = dense_weights(mlp)
    R, M, S, c1 = x0.shape
    c2, c3 = w1.shape[1], w2.shape[1]
    with torch.no_grad():
        if mlp.bn:
            name = "fused_sa_slab_bn"
            bns = [getattr(mlp, f"bn_{i}") for i in range(3)]
            packs = bn_packs([bn.affine() for bn in bns])

            def kernel():
                return fused_bn_mlp_pool(
                    x0, w1, w2, [bn.scale for bn in bns],
                    [bn.bias for bn in bns], [(bn.mean, bn.var) for bn in bns])
        else:
            name = "fused_sa_slab"
            packs = nobn_packs(c1, b1, b2)

            def kernel():
                return fused_mlp_pool(x0, w1, b1, w2, b2)
        m0, a0, m1, a1, m2, a2 = packs.split([c1, c1, c2, c2, c3, c3])
        got = kernel()
        ref = fused_sa_slab_plain(x0, packs, w1, w2)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        check(err <= 1e-4 * scale, f"{name} differs by {err} (max |value| "
              f"{scale}) at {label}")
        del got, ref
        ms = cuda_ms(kernel, 10)
        pms = cuda_ms(lambda: fused_sa_slab_plain(x0, packs, w1, w2), 3)

        def library():
            x = torch.relu(torch.addcmul(a0, x0, m0))
            x = torch.relu(torch.addcmul(a1, F.linear(x, mlp.dense_1.weight),
                                         m1))
            return torch.relu(torch.addcmul(
                a2, F.linear(x, mlp.dense_2.weight), m2)).amax(2)

        lms = cuda_ms(library, 3)
    slots = R * M * S
    # per slot: the two layers' multiply-adds, then on each layer's
    # channels the affine (multiply, add) and the ReLU, and the max on C3
    ops = slots * (2 * (c1 * c2 + c2 * c3) + 3 * (c1 + c2 + c3) + c3)
    nbytes = 4 * (x0.numel() + w1.numel() + w2.numel() + packs.numel()
                  + R * M * c3)
    print(f"{name} {label} R={R} M={M} S={S} C={c1}->{c2}->{c3}: "
          f"{ms:.3f} ms, bound {bound_ms(nbytes, ops)[0]:.3f} ms, plain "
          f"{pms:.3f} ms, cuBLAS chain {lms:.3f} ms, max_abs_err {err:.3e} "
          f"(max |value| {scale:.3e}), {ops / ms / 1e9:.1f} TFLOP/s")
    return name, (err, ms, pms, lms, nbytes, ops)


def slab_train_kernels(x0, mlp, label, gen):
    """The slab form's training forward and backward at one level, on the
    rows a train step's proposal target layer sampled, against their plain
    versions. Forward: out equal to the eval kernel's to the bit, ppre
    within 1e-4 of the largest value, argmax equal to the plain version's at
    every channel whose plain max has no near-tie (another slot's value
    within that tolerance but not equal to it). Backward: the five
    gradients within 1e-4 of each one's largest value, both routed by the
    plain version's argmax and ppre. The library is the cuBLAS chain under
    autograd (its forward, then its forward and backward). -> {kernel:
    (err, ms, plain_ms, library_ms, bytes, operations)}."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import fused_mlp_pool
    from tpu3d_torch.ops.fused_sa import (
        fused_mlp_pool_backward, fused_mlp_pool_backward_plain,
        fused_mlp_pool_backward_routed_plain, fused_mlp_pool_train,
        fused_mlp_pool_train_plain)

    w1, b1, w2, b2 = args = dense_weights(mlp)
    R, M, S, c1 = x0.shape
    c2, c3 = w1.shape[1], w2.shape[1]
    slots = R * M * S
    rows = {}

    def library_forward(leaves):
        x = torch.relu(leaves[0])
        x = torch.relu(F.linear(x, leaves[1], leaves[2]))
        return torch.relu(F.linear(x, leaves[3], leaves[4])).amax(2)

    weights = (x0, mlp.dense_1.weight.detach(), b1,
               mlp.dense_2.weight.detach(), b2)
    with torch.no_grad():
        out, arg, ppre = fused_mlp_pool_train(x0, *args)
        check(torch.equal(out, fused_mlp_pool(x0, *args)),
              f"fused_sa_slab_train out differs from the eval kernel's at "
              f"{label}")
        r_out, r_arg, r_ppre = fused_mlp_pool_train_plain(x0, *args)
        torch.cuda.synchronize()
        scale = r_out.abs().max().item()
        err = (out - r_out).abs().max().item()
        check(err <= 1e-4 * scale, f"fused_sa_slab_train out differs by {err}")
        perr = (ppre - r_ppre).abs().max().item()
        check(perr <= 1e-4 * max(scale, r_ppre.abs().max().item()),
              f"fused_sa_slab_train ppre differs by {perr}")
        a2 = torch.relu(torch.relu(torch.relu(x0) @ w1 + b1) @ w2 + b2)
        top = r_out[:, :, None, :]
        near = ((a2 >= top - 1e-4 * scale) & (a2 != top)).any(dim=2)
        del a2
        flips = arg != r_arg
        check(not bool((flips & ~near).any()),
              f"fused_sa_slab_train argmax differs in "
              f"{int((flips & ~near).sum())} channels without a near-tie")
        ms = cuda_ms(lambda: fused_mlp_pool_train(x0, *args), 10)
        pms = cuda_ms(lambda: fused_mlp_pool_train_plain(x0, *args), 3)
    lms = cuda_ms(lambda: library_forward(
        [t.detach().requires_grad_() for t in weights]), 3)
    ops = slots * (2 * (c1 * c2 + c2 * c3) + 3 * (c1 + c2 + c3) + 3 * c3)
    nbytes = 4 * (x0.numel() + w1.numel() + w2.numel() + 2 * (c1 + c2 + c3)
                  + 3 * R * M * c3)
    rows["fused_sa_slab_train"] = (max(err, perr), ms, pms, lms, nbytes, ops,
                                   {})
    print(f"fused_sa_slab_train {label} R={R} M={M} S={S} "
          f"C={c1}->{c2}->{c3}: {ms:.3f} ms, bound "
          f"{bound_ms(nbytes, ops)[0]:.3f} ms, plain {pms:.3f} ms, cuBLAS "
          f"chain under autograd {lms:.3f} ms, out equal to eval, "
          f"max_abs_err {err:.3e} / ppre {perr:.3e}, argmax flips "
          f"{int(flips.sum())} of {arg.numel()} (near-ties "
          f"{int(near.sum())}), {ops / ms / 1e9:.1f} TFLOP/s")

    grad = torch.randn(out.shape, generator=gen).to(out.device)
    got = fused_mlp_pool_backward(x0, *args, grad, r_arg, r_ppre)
    ref = fused_mlp_pool_backward_plain(x0, *args, grad, r_arg, r_ppre)
    torch.cuda.synchronize()
    berr = 0.0
    for name, a, b in zip(("d_x0", "dW1", "db1", "dW2", "db2"), got, ref):
        e = (a - b).abs().max().item()
        sc = b.abs().max().item()
        print(f"  fused_sa_slab_bwd {label} {name}: max_abs_err {e:.3e} (max "
              f"|value| {sc:.3e})")
        check(e <= 1e-4 * sc, f"fused_sa_slab_bwd {name} differs by {e} at "
              f"{label}")
        berr = max(berr, e)
    del got, ref
    ms = cuda_ms(lambda: fused_mlp_pool_backward(x0, *args, grad, r_arg,
                                                 r_ppre), 10)
    pms = cuda_ms(lambda: fused_mlp_pool_backward_plain(x0, *args, grad,
                                                        r_arg, r_ppre), 3)

    def library():
        leaves = [t.detach().requires_grad_() for t in weights]
        torch.autograd.grad(library_forward(leaves), leaves, grad)

    lms = cuda_ms(library, 3)
    lbms = library_backward_ms(
        lambda: library_forward([t.detach().requires_grad_()
                                 for t in weights]), grad)
    nnz, hit = routed_slots(r_arg, grad, r_ppre, S)
    # d_a1 and dW2 over the non-zero pooled gradients; layer 1's recompute,
    # dW1, d_a0 and the ReLU masks over the slots they reach
    ops = bwd_ops(hit, nnz, c1, c2)
    # read x0's reached rows, W1, b1, W2, dval and argmax; write d_x0 (every
    # row), dW1, db1 and dW2
    nbytes = 4 * (hit * c1 + x0.numel() + 2 * w1.numel() + 2 * w2.numel()
                  + 2 * c2 + 2 * R * M * c3)
    rows["fused_sa_slab_bwd"] = (berr, ms, pms, lms, nbytes, ops,
                                 dict(lib_bwd_ms=lbms, reached=hit,
                                      slots=slots))
    print(f"fused_sa_slab_bwd {label}: {ms:.3f} ms, bound "
          f"{bound_ms(nbytes, ops)[0]:.4f} ms, plain {pms:.3f} ms, "
          f"autograd of the cuBLAS chain {lms:.3f} ms (forward and "
          f"backward; its backward alone {lbms:.3f} ms), "
          f"{ops / ms / 1e9:.1f} TFLOP/s, {nnz} non-zero pooled "
          f"gradients routed to {hit} of {slots} slots "
          f"({100 * hit / slots:.2f}%)")
    # full spread: every channel live at a slot drawn uniformly over S,
    # against the routed plain version
    full_arg, ones = spread_draw(r_arg, r_ppre, S, torch.Generator(
        device=x0.device).manual_seed(SEED + 8))
    got = fused_mlp_pool_backward(x0, *args, grad, full_arg, ones)
    ref = fused_mlp_pool_backward_routed_plain(x0, *args, grad, full_arg,
                                               ones)
    torch.cuda.synchronize()
    for name, a, b in zip(("d_x0", "dW1", "db1", "dW2", "db2"), got, ref):
        e = (a - b).abs().max().item()
        sc = b.abs().max().item()
        check(e <= 1e-4 * sc, f"fused_sa_slab_bwd {name} differs by {e} "
              f"under full spread at {label}")
    fms = cuda_ms(lambda: fused_mlp_pool_backward(x0, *args, grad, full_arg,
                                                  ones), 5)
    print(f"fused_sa_slab_bwd {label}, full spread: {fms:.3f} ms, gradients "
          f"within 1e-4 of the routed plain version's largest values")
    return rows


# the packed slab launch: (label, R, M, S) of the shapes each groups-per-
# block G is timed at (C 128 -> 128 -> 256, RCNN SA_1's widths): smoke's SA_1
# (eval 2 x 64 ROIs, train 2 x 16), S 16 and 32 levels of as many groups,
# and of 384, 256 and 128 groups, around SLAB_PACK_MIN_GROUPS[S]
SLAB_GROUP_TIMES = [(f"{SMOKE_PATH['eval']}, RCNN SA_1", 128, 16, 16),
                    (f"{SMOKE_PATH['train']}, RCNN SA_1", 32, 16, 16),
                    ("S 16, 1024 groups", 64, 16, 16),
                    ("S 16, 384 groups", 24, 16, 16),
                    ("S 16, 256 groups", 16, 16, 16),
                    ("S 16, 128 groups", 8, 16, 16),
                    ("S 32, 2048 groups", 128, 16, 32),
                    ("S 32, 512 groups", 32, 16, 32),
                    ("S 32, 384 groups", 24, 16, 32),
                    ("S 32, 256 groups", 16, 16, 32),
                    ("S 32, 128 groups", 8, 16, 32)]


def slab_group_inputs(R, M, S, seed, c1=128, c2=128, c3=256):
    """A seeded slab whose groups repeat their first h slots (h random per
    group, as pooled ROIs with few points do, so ties at several slots are
    common), weights and the no-BN packs: (x0, w1, b1, w2, b2, packs)."""
    import torch

    from tpu3d_torch.ops.fused_sa import nobn_packs

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x0 = torch.randn(R, M, S, c1, generator=g, device=DEVICE)
    h = torch.randint(1, S + 1, (R, M, 1), generator=g, device=DEVICE)
    x0 = torch.gather(x0, 2, (torch.arange(S, device=DEVICE) % h)[
        ..., None].expand(-1, -1, -1, c1)).contiguous()
    w1 = torch.randn(c1, c2, generator=g, device=DEVICE) / c1 ** 0.5
    w2 = torch.randn(c2, c3, generator=g, device=DEVICE) / c2 ** 0.5
    b1 = torch.randn(c2, generator=g, device=DEVICE) * 0.1
    b2 = torch.randn(c3, generator=g, device=DEVICE) * 0.1
    return x0, w1, b1, w2, b2, nobn_packs(c1, b1, b2)


def slab_groups():
    """Phase 3 for the slab form's packed forward launch. At S 16, 32 and
    64 on seeded slabs of 37 x 7 groups (a tail block at G 2 and 4), C3
    128 and 256, every groups-per-block G the kernel takes (1, and 64 / S
    at S 16 and 32): the eval
    output within 1e-4 of the plain version's largest value, the training
    output equal to the eval kernel's to the bit, ppre within 1e-4, the
    first argmax equal to the plain version's at every channel without a
    near-tie, and each G's out, argmax and ppre equal to G = 1's to the
    bit. Then at SLAB_GROUP_TIMES every G timed, eval and train, beside the
    G that ``slab_groups_per_block`` chooses. -> the JSON rows."""
    import torch

    from tpu3d_torch.ops import fused_sa as fs

    def forward(args, G, train):
        x0, w1, _, w2, _, packs = args
        return fs._slab_forward(
            "fused_sa_slab_train" if train else "fused_sa_slab", x0, packs,
            w1, w2, train=train, groups=G)

    for S in (16, 32, 64):
        for c3 in (128, 256):
            args = slab_group_inputs(37, 7, S, S + c3, c3=c3)
            x0, w1, b1, w2, b2, _ = args
            with torch.no_grad():
                r_out, r_arg, r_ppre = fs.fused_mlp_pool_train_plain(
                    x0, w1, b1, w2, b2)
                a2 = torch.relu(fs._nobn_slab_chain(x0, w1, b1, w2, b2))
            scale = r_out.abs().max().item()
            top = r_out[:, :, None, :]
            near = ((a2 >= top - 1e-4 * scale) & (a2 != top)).any(dim=2)
            del a2
            first = None
            for G in sorted({1, 64 // S}):
                (out,) = forward(args, G, False)
                train = forward(args, G, True)
                torch.cuda.synchronize()
                at = f"S={S} C3={c3} G={G}"
                err = (out - r_out).abs().max().item()
                check(err <= 1e-4 * scale, f"fused_sa_slab differs by {err} "
                      f"at {at}")
                check(torch.equal(train[0], out), f"fused_sa_slab_train out "
                      f"differs from the eval kernel's at {at}")
                perr = (train[2] - r_ppre).abs().max().item()
                check(perr <= 1e-4 * max(scale, r_ppre.abs().max().item()),
                      f"fused_sa_slab_train ppre differs by {perr} at {at}")
                flips = (train[1] != r_arg) & ~near
                check(not bool(flips.any()), f"fused_sa_slab_train argmax "
                      f"differs in {int(flips.sum())} channels without a "
                      f"near-tie at {at}")
                first = first or train
                check(all(torch.equal(a, b) for a, b in zip(train, first)),
                      f"the slab forward at {at} differs from G = 1's")
            print(f"slab forward S={S} C3={c3}, 37 x 7 groups: every G "
                  f"within 1e-4 of the plain version, out equal to eval, "
                  f"argmax equal but at near-ties, all G equal to G = 1's")
    rows = []
    for label, R, M, S in SLAB_GROUP_TIMES:
        args = slab_group_inputs(R, M, S, R + S)
        c1, c2, c3 = 128, 128, 256
        chosen = fs.slab_groups_per_block(R, M, S, c1, c2, c3)
        times = {}
        with torch.no_grad():
            for G in sorted({1, 64 // S}):
                for train in (False, True):
                    times[f"{'train' if train else 'eval'} G={G}"] = cuda_ms(
                        lambda: forward(args, G, train), 20)
        slots = R * M * S
        ops = slots * (2 * (c1 * c2 + c2 * c3) + 3 * (c1 + c2 + c3) + c3)
        nbytes = 4 * (slots * c1 + c1 * c2 + c2 * c3 + R * M * c3)
        rows.append({"level": label, "R": R, "M": M, "S": S,
                     "groups": R * M, "chosen_G": chosen,
                     "eval_bound_ms": bound_ms(nbytes, ops)[0],
                     "sweep_ms": times})
        print(f"slab forward {label} R={R} M={M} S={S}: G={chosen} chosen; "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
              + f" ms; eval bound {bound_ms(nbytes, ops)[0]:.4f} ms")
        del args
    return rows


def routed_plain(leaves, arg, eps):
    """The BatchNorm chain in training, plain and differentiable by
    autograd, on leaves (x0, w1, w2, gammas, betas), its max-pool routed
    through the slots ``arg`` (R, M, C3) -> (out, means, vars)."""
    import torch

    from tpu3d_torch.ops import fused_sa as fs

    x, means, vars_ = leaves[0], [], []
    for i in range(3):
        y, mean, var = fs._bn_train(x, leaves[3 + i], leaves[6 + i], eps)
        means.append(mean.detach())
        vars_.append(var.detach())
        x = torch.relu(y) @ leaves[1 + i] if i < 2 else torch.relu(y)
    out = torch.gather(x, 2, arg.long()[:, :, None, :])[:, :, 0]
    return out, means, vars_


def slots_off(a, b, tol):
    """The number of slots (rows of the last axis) where a and b differ by
    more than tol in some channel."""
    return int(((a - b).abs() > tol).any(dim=-1).sum())


def bf16_steps(a, b):
    """|a − b| in bf16 steps of each value's own magnitude (the larger of
    the two sides'), elementwise, in f32."""
    import torch

    a, b = a.float(), b.float()
    top = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(top)) - 7)


def bn_pass_rows(report, where, x0, w1, w2, gammas, betas, eps, gen):
    """The seven passes of kernel 9's training form on the slab x0, in the
    form of its dtype (f32, or the bf16 entries ``*_bf16``), each driven
    as the training op drives it, held against its plain piece on the same
    inputs (the plain pieces' own statistics, x1, x2, argmax, d_y1 and d_y0
    and the packs of their statistics) and timed beside it. Each statistics
    pass's Σx² within 1e-5 relative and Σx within 1e-5·√(n·Σx²) per
    channel (the layers summed in another order, the sums in f64); the
    final pass, a reduction over the same stored x2 rounded as the plain
    piece rounds it, equal to the bit; each wave's two reductions and its
    weight gradient within 1e-3 of each one's largest value (f32 sums of n
    products in another order); the slabs the passes write: in f32 (x1, x2,
    d_y1, d_y0 and the f32 form's d_x0) within 1e-4 of their largest value,
    in bf16 (x1, x2 and the bf16 form's d_x0) within one bf16 step of each
    value and off at all in at most BN_SLAB_FLIP_BOUND of the values (exact
    products, f32 sums in another order: a sum at a rounding boundary takes
    the other neighbour). Every pass reads the same stored slabs on both
    sides and rounds its elementwise forms step by step as the plain pieces
    do, so no ReLU mask flips between the two. Library: torch.var_mean for
    the depth-0 statistics, none for the other passes."""
    import torch

    from tpu3d_torch.ops import fused_sa as fs

    form = x0.dtype
    es = x0.element_size()  # bytes of a slab value: 4, or 2 in bf16
    peak = PEAK_BF16_OPS_PER_S if form == torch.bfloat16 else \
        PEAK_F32_OPS_PER_S
    R, M, S, c1 = x0.shape
    c2, c3 = w1.shape[1], w2.shape[1]
    n = R * M * S
    widths = (c1, c2, c3)
    wbytes = 4 * (w1.numel() + w2.numel() + 7 * sum(widths))
    l1, l2 = 2 * c1 * c2, 2 * c2 * c3  # one slot's layer products

    def add(name, err, ms, pms, lms, nbytes, ops, what):
        name = fs._entry(name, form)
        b_ms, b_by = bound_ms(nbytes, ops, peak)
        report.add(name, err, ms, pms, lms, nbytes, ops)
        print(f"{name} {where} R={R} M={M} S={S} C={c1}->{c2}->{c3}: "
              f"{ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), plain "
              f"{pms:.3f} ms, library "
              f"{'none' if lms is None else f'{lms:.3f} ms'}, {what}, "
              f"{ops / ms / 1e9:.1f} TFLOP/s, "
              f"{nbytes / ms / 1e9:.1f} GB/s")

    def slab_ok(label, a, b):
        """Check the slab a against the plain piece's b -> (largest
        |a − b|, its note)."""
        check(a.dtype == b.dtype, f"{label}: {a.dtype}, plain {b.dtype}")
        d = (a.float() - b.float()).abs()
        e, sc = d.max().item(), b.float().abs().max().item()
        if a.dtype != torch.bfloat16:
            check(e <= 1e-4 * sc, f"{label} differs by {e} (max |value| "
                  f"{sc}) at {where}")
            return e, f"{e:.3e} of {sc:.3e}"
        steps = bf16_steps(a, b).max().item()
        off = (d > 0).float().mean().item()
        check(steps <= 1 and off <= BN_SLAB_FLIP_BOUND, f"{label} at "
              f"{where}: {steps} bf16 steps off, {off:.2e} of the values "
              f"off")
        return e, f"{e:.3e} of {sc:.3e}, off in {off:.2e} by one step"

    with torch.no_grad():
        layers, stats, slabs = [], [], [x0]
        for depth in range(3):
            name = fs.STATS_KERNELS[depth]
            args = ((x0,) if depth == 0 else
                    (slabs[-1], layers[-1][fs.MUL].contiguous(),
                     layers[-1][fs.ADD].contiguous(), (w1, w2)[depth - 1]))
            got = fs.fused_sa_bn_stats(depth, *args)
            want = fs.fused_sa_bn_stats_plain(depth, *args)
            yerr, note = 0.0, ""
            if depth:
                (got, y), (want, wy) = got, want
                yerr, note = slab_ok(f"{name} x{depth}", y, wy)
                note = f", x{depth} {note}"
                slabs.append(wy)
                del y
            q_err = ((got[1] - want[1]).abs() / want[1]).max().item()
            s_err = ((got[0] - want[0]).abs()
                     / (n * want[1]).sqrt()).max().item()
            check(q_err <= 1e-5 and s_err <= 1e-5,
                  f"{name} differs at {where}: Σx² by {q_err} relative, "
                  f"Σx by {s_err} of √(n·Σx²)")
            stats.append(fs._mean_var(want, n, torch.float32))
            err = max(yerr, *((a - b).abs().max().item() for a, b in zip(
                fs._mean_var(got, n, torch.float32), stats[-1])))
            layers.append(fs._layer_pack(*stats[-1], gammas[depth],
                                         betas[depth], eps, n))
            ms = cuda_ms(lambda: fs.fused_sa_bn_stats(depth, *args), 5)
            pms = cuda_ms(lambda: fs.fused_sa_bn_stats_plain(depth, *args),
                          2)
            lms = (cuda_ms(lambda: torch.var_mean(
                x0, dim=(0, 1, 2), correction=0), 3) if depth == 0
                else None)
            # per slot: depth 0 a sum and a sum of squares of C1 values;
            # depth 1 / 2 the affine and ReLU of the layer before, its
            # product, and the sums of the C_depth outputs; read the slab
            # before, write x_depth
            cin = widths[max(depth - 1, 0)]
            ops = n * ((0, l1, l2)[depth] + 3 * widths[depth]
                       + (3 * cin if depth else 0))
            nbytes = es * n * (cin + (widths[depth] if depth else 0))
            if depth == 0:  # the one read of x0: its rate beside the card's
                note += (f", the slab read at {nbytes / ms / 1e6:.1f} GB/s, "
                         f"{nbytes / ms * 1e3 / PEAK_BYTES_PER_S:.1%} of "
                         f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s")
            add(name, err, ms, pms, lms, nbytes + wbytes + 16 * widths[depth],
                ops, f"mean/var max_abs_err {err:.3e}, Σx² {q_err:.2e} "
                f"relative, Σx {s_err:.2e} of √(n·Σx²){note}")
            del got, want
        x1, x2 = slabs[1:]
        m2, a2 = (layers[2][fs.MUL].contiguous(),
                  layers[2][fs.ADD].contiguous())
        got = fs.fused_sa_bn_final(x2, m2, a2)
        out, arg, at = fs.fused_sa_bn_final_plain(x2, m2, a2)
        check(all(a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in zip(got, (out, arg, at))),
              f"{fs._entry('fused_sa_bn_final', form)} differs from its "
              f"plain piece at {where}")
        del got
        ms = cuda_ms(lambda: fs.fused_sa_bn_final(x2, m2, a2), 5)
        pms = cuda_ms(lambda: fs.fused_sa_bn_final_plain(x2, m2, a2), 2)
        add("fused_sa_bn_final", 0.0, ms, pms, None,
            es * n * c3 + 8 * c3 + (es + 8) * R * M * c3, n * (3 * c3 + 1),
            "out, argmax and x2 there equal to the plain piece's")

        grad = torch.randn(out.shape, generator=gen).to(out.device).to(form)
        d_y2 = torch.where(out > 0, grad.float(), 0.0)
        (mean2, var2), r2 = stats[2], layers[2][fs.R_INV]
        layers[2] = fs._layer_pack(
            mean2, var2, gammas[2], betas[2], eps, n, d_y2.sum(dim=(0, 1)),
            (d_y2 * (at * r2 - mean2 * r2)).sum(dim=(0, 1)))
        dval = (d_y2 * layers[2][fs.MUL]).contiguous()
        pk = fs._pack(layers)
        cases = []
        got = fs.fused_sa_bn_wave1(x2, x1, pk, w2, dval, arg)
        want = fs.fused_sa_bn_wave1_plain(x2, x1, pk, w2, dval, arg)
        cases.append(("fused_sa_bn_wave1", got, want, ("sums", "dW2", "d_y1"),
                      (lambda pk=pk: fs.fused_sa_bn_wave1(
                          x2, x1, pk, w2, dval, arg),
                       lambda pk=pk: fs.fused_sa_bn_wave1_plain(
                           x2, x1, pk, w2, dval, arg))))
        d_y1 = want[2]
        layers[1] = fs._layer_pack(*stats[1], gammas[1], betas[1], eps, n,
                                   *want[0].float())
        pk = fs._pack(layers)
        got = fs.fused_sa_bn_wave2(d_y1, x1, x0, pk, w1)
        want = fs.fused_sa_bn_wave2_plain(d_y1, x1, x0, pk, w1)
        cases.append(("fused_sa_bn_wave2", got, want, ("sums", "dW1", "d_y0"),
                      (lambda pk=pk: fs.fused_sa_bn_wave2(
                          d_y1, x1, x0, pk, w1),
                       lambda pk=pk: fs.fused_sa_bn_wave2_plain(
                           d_y1, x1, x0, pk, w1))))
        d_y0 = want[2]
        layers[0] = fs._layer_pack(*stats[0], gammas[0], betas[0], eps, n,
                                   *want[0].float())
        pk = fs._pack(layers)
        # the f32 form writes d_x0 in place of d_y0: it is checked on a
        # copy and timed on a scratch slab
        got = (fs.fused_sa_bn_apply(d_y0.clone(), x0, pk),)
        want = (fs.fused_sa_bn_apply_plain(d_y0, x0, pk),)
        scratch = torch.empty_like(d_y0)
        cases.append(("fused_sa_bn_apply", got, want, ("d_x0",), (
            lambda pk=pk: fs.fused_sa_bn_apply(scratch, x0, pk),
            lambda pk=pk: fs.fused_sa_bn_apply_plain(d_y0, x0, pk))))
        # per slot: wave 1 two products of layer 2 (d_y1 and dW2) and the
        # elementwise d_x2, mask, x̂1 and sums; wave 2 two of layer 1;
        # apply the elementwise d_x0. Each input slab read once (x0, x1,
        # x2 in the form's dtype, d_y1 and d_y0 in f32), each output slab
        # written once
        ops = {"fused_sa_bn_wave1": n * (2 * l2 + 6 * c3 + 8 * c2),
               "fused_sa_bn_wave2": n * (2 * l1 + 6 * c2 + 8 * c1),
               "fused_sa_bn_apply": n * 6 * c1}
        nbytes = {"fused_sa_bn_wave1": es * n * (c3 + c2) + 4 * n * c2
                  + 8 * R * M * c3 + 4 * c2 * c3 + 16 * c2,
                  "fused_sa_bn_wave2": (es + 4) * n * (c2 + c1)
                  + 4 * c1 * c2 + 16 * c1,
                  "fused_sa_bn_apply": (4 + 2 * es) * n * c1}
        for name, got, want, parts, (kernel, plain) in cases:
            errs, worst = [], 0.0
            for part, a, b in zip(parts, got, want):
                if a.dim() == 4:
                    e, note = slab_ok(f"{name} {part}", a, b)
                else:
                    check(a.dtype == b.dtype, f"{name} {part}: {a.dtype}, "
                          f"plain {b.dtype}")
                    e, sc = (a - b).abs().max().item(), b.abs().max().item()
                    check(e <= 1e-3 * sc, f"{name} {part} differs by {e} "
                          f"(max |value| {sc}) at {where}")
                    note = f"{e:.3e} of {sc:.3e}"
                errs.append(f"{part} {note}")
                worst = max(worst, e)
            ms = cuda_ms(kernel, 3)
            pms = cuda_ms(plain, 2)
            add(name, worst, ms, pms, None, nbytes[name] + wbytes, ops[name],
                "max_abs_err " + ", ".join(errs))
        del cases, got, want, scratch, d_y0, d_y1, slabs, x1, x2
        del out, arg, at, dval
        torch.cuda.empty_cache()


def bn_train_kernels(report, model, target, label):
    """Phase 3 for the BatchNorm chain's seven training kernels, at RCNN
    SA_0 and SA_1 of ``model`` (an RCNN with BatchNorm), on the slabs
    grouped from the rows a train step's proposal target layer sampled
    (each level's input from the levels before it at eval): each pass
    against its plain piece (``bn_pass_rows``). Then the whole op, forward
    and backward through the seven kernels, against autograd of its plain
    version in f64 (in f32, BatchNorm's backward cancels where a channel's
    mean outweighs its spread, differently in the kernels' x̂ form and in
    autograd of E[x²] − mean²; the plain f32 autograd's own error against
    it is printed), routed by the kernels' argmax (a near-tie may pick
    another slot in f32 sums of another order, which moves a whole
    channel's gradient), on the first ``BN_CHECK_ROWS`` rows (the plain
    chain under autograd keeps several slabs; the statistics are then those
    rows' on both sides): the output and the statistics within 1e-4 of
    each largest value, d_x0 beyond 1e-4 of its largest value in at most 1
    slot in 10^4, the other gradients within 1e-2 (an f32 x1 at y1 ≈ 0
    takes the other sign of the f64 one; one such layer-1 mask flip at a
    slot the pooled gradient reaches moves dW1 by some 0.5% of its largest
    value, and a 128-row sample holds a few); and through autograd equal to
    its passes composed directly, to the bit. Library, printed for the
    level: the cuBLAS chain with batch-statistics BatchNorm (F.batch_norm)
    under autograd, forward and backward. -> {level: that chain's ms}."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import fused_bn_mlp_pool
    from tpu3d_torch.ops import fused_sa as fs

    levels = slab_levels(model, target["sampled_pts"], target["pts_feature"])
    check([k for k, _, _ in levels] == [0, 1],
          f"{label}: the slab route at RCNN SA_{[k for k, _, _ in levels]}")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    eps = 1e-5
    library = {}
    for k, x0, mlp in levels:
        where = f"{label}, RCNN SA_{k}"
        R, M, S, c1 = x0.shape
        w1 = mlp.dense_1.weight.detach().T.contiguous()
        w2 = mlp.dense_2.weight.detach().T.contiguous()
        c3 = w2.shape[1]
        bns = [getattr(mlp, f"bn_{i}") for i in range(3)]
        gammas = [bn.scale.detach() for bn in bns]
        betas = [bn.bias.detach() for bn in bns]
        bn_pass_rows(report, where, x0, w1, w2, gammas, betas, eps, gen)

        # the whole op through its seven kernels, on the first
        # BN_CHECK_ROWS rows: against the training forward and backward
        # composed directly (the autograd Function's wiring, to the bit),
        # and against autograd of the plain chain routed by its argmax, in
        # f64
        sub = x0[:BN_CHECK_ROWS].contiguous()
        g = torch.randn(sub.shape[0], M, c3, generator=gen).to(sub.device)
        leaves = [t.detach().clone().requires_grad_() for t in
                  (sub, w1, w2, *gammas, *betas)]
        ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
        o, (ms_, vs_) = fused_bn_mlp_pool(leaves[0], leaves[1], leaves[2],
                                          leaves[3:6], leaves[6:9])
        grads = torch.autograd.grad(o, leaves, g)
        with torch.no_grad():
            d_o, d_arg, d_x2, d_ms, d_vs, saved = fs.fused_bn_mlp_pool_train(
                sub, w1, w2, gammas, betas)
            d_g = fs.fused_bn_mlp_pool_backward(
                sub, w1, w2, gammas, betas, d_ms, d_vs, d_o, d_arg, d_x2,
                saved, g)
            del saved
        ours = (o.detach(), *ms_, *vs_, *grads)
        direct = (d_o, *d_ms, *d_vs, d_g[0], d_g[1], d_g[2], *d_g[3],
                  *d_g[4])
        check(all(torch.equal(a, b) for a, b in zip(ours, direct)),
              f"fused_bn_mlp_pool through autograd differs from its forward "
              f"and backward composed directly at {where}")
        # the reference in f64: BatchNorm's backward in f32 cancels where a
        # channel's mean outweighs its spread, and the plain chain's f32
        # autograd (E[x²] − mean² differentiated term by term) cancels
        # otherwise than the kernels' x̂ form; its own error is printed
        ref64 = [t.detach().double().requires_grad_() for t in ref_leaves]
        r_o, r_ms, r_vs = routed_plain(ref64, d_arg, eps)
        r_grads = torch.autograd.grad(r_o, ref64, g.double())
        p_o, _, _ = routed_plain(ref_leaves, d_arg, eps)
        p_grads = torch.autograd.grad(p_o, ref_leaves, g)
        names = ("out", "mean0", "mean1", "mean2", "var0", "var1", "var2",
                 "d_x0", "d_w1", "d_w2", "d_gamma0", "d_gamma1", "d_gamma2",
                 "d_beta0", "d_beta1", "d_beta2")
        rows, plain = [], {}
        for part, a, b in zip(names[7:], p_grads, r_grads):
            plain[part] = ((a - b.float()).abs().max().item()
                           / b.abs().max().item())
        for part, a, b in zip(names, ours, (r_o.detach(), *r_ms, *r_vs,
                                            *r_grads)):
            b = b.float()
            sc = b.abs().max().item()
            rows.append((part, (a - b).abs().max().item() / sc,
                         slots_off(a, b, 1e-4 * sc) if part == "d_x0" else 0))
        print(f"fused_bn_mlp_pool forward and backward on the first "
              f"{BN_CHECK_ROWS} rows at {where}: through autograd equal to "
              f"its passes composed directly; against autograd of the plain "
              f"chain in f64, largest error / largest value (and the plain "
              f"chain's own f32 autograd): " + ", ".join(
                  f"{part} {rel:.2e}" + (f" ({plain[part]:.2e})"
                                         if part in plain else "")
                  + (f", {off} slots beyond 1e-4" if part == "d_x0" else "")
                  for part, rel, off in rows))
        for part, rel, off in rows:
            if part == "d_x0":
                check(off <= BN_CHECK_ROWS * M * S // 10000,
                      f"fused_bn_mlp_pool d_x0 differs in {off} slots on "
                      f"{BN_CHECK_ROWS} rows at {where}")
            else:
                tol = 1e-4 if part == "out" or part[:1] in "mv" else 1e-2
                check(rel <= tol, f"fused_bn_mlp_pool {part} differs by "
                      f"{rel:.3e} of its largest value on {BN_CHECK_ROWS} "
                      f"rows at {where}")
        del leaves, ref_leaves, o, grads, r_o, r_grads, sub, ours, direct, d_g
        del ref64, p_o, p_grads
        torch.cuda.empty_cache()

        def library_train():  # cuBLAS with batch-statistics BatchNorm
            ls = [t.detach().requires_grad_() for t in
                  (x0, mlp.dense_1.weight, mlp.dense_2.weight, *gammas,
                   *betas)]
            x = ls[0].view(-1, c1)
            for i, w in enumerate((ls[1], ls[2], None)):
                x = torch.relu(F.batch_norm(x, None, None, ls[3 + i],
                                            ls[6 + i], training=True,
                                            eps=eps))
                if w is not None:
                    x = F.linear(x, w)
            o = x.view(R, M, S, c3).amax(2)
            torch.autograd.grad(o, ls, grad_all)

        grad_all = torch.randn(R, M, c3, generator=gen).to(x0.device)
        library[k] = cuda_ms(library_train, 2)
        print(f"cuBLAS chain with batch-statistics BatchNorm under autograd, "
              f"forward and backward, at {where}: {library[k]:.3f} ms")
        torch.cuda.empty_cache()
    return library


# the widened shapes of the fused kernels: (R, M, S, C1, C2, C3) with S 8,
# 24 and 128 slots and widths 256, 384 and 512 (tests/test_torch_fused_sa_
# wide.py holds the same against tpu3d on the CPU), and one with many
# groups of 128 slots
WIDE_SHAPES = [(2, 16, 8, 256, 384, 512), (2, 16, 24, 384, 512, 256),
               (1, 2, 128, 512, 256, 384), (64, 4, 128, 256, 384, 256)]
# the widened configuration: default.yaml with the RCNN's SA_0 at 128 slots
# and its MLPs at widths 256 / 384, set in memory
WIDE_NSAMPLE0 = 128
WIDE_MLPS = [[256, 384, 256], [256, 256, 384]]
WIDE_BATCH = 2


def wide_kernels():
    """Every fused entry at WIDE_SHAPES against its plain version on the
    card: outputs within 1e-4 of their largest value, the training
    forwards' outputs equal to the eval kernels', argmax equal but at
    near-ties (at most 1 in 1000 channels); the two backwards' gradients
    within 1e-4 of each largest value under the plain forward's own routing
    and with every channel live at a uniform slot (against the routed plain
    versions); the BatchNorm chain's passes on the plain pieces' slabs, as
    bn_train_kernels holds them. -> {entry: the largest error relative to
    its largest value}."""
    import torch

    from tpu3d_torch.ops import (fused_bn_mlp_pool, fused_gathered_mlp_pool,
                                 fused_mlp_pool)
    from tpu3d_torch.ops import fused_sa as fs

    worst = {}

    def near(name, a, b, what):
        e = (a - b).abs().max().item()
        sc = b.abs().max().item()
        check(e <= 1e-4 * sc, f"{name} {what} differs by {e} (max |value| "
              f"{sc}) at the widened shape {shape}")
        worst[name] = max(worst.get(name, 0.0), e / max(sc, 1e-30))

    def flips(name, a, b):
        n = int((a != b).sum())
        check(n <= a.numel() // 1000, f"{name} argmax differs in {n} "
              f"channels at the widened shape {shape}")

    for shape in WIDE_SHAPES:
        R, M, S, c1, c2, c3 = shape
        g = torch.Generator(device=DEVICE).manual_seed(S + c1 + c3)

        def randn(*size, scale=1.0):
            return torch.randn(*size, generator=g, device=DEVICE) * scale

        w1, w2 = randn(c1, c2, scale=c1 ** -0.5), randn(c2, c3,
                                                        scale=c2 ** -0.5)
        b1, b2 = randn(c2, scale=0.1), randn(c3, scale=0.1)
        grad = randn(R, M, c3)
        full = torch.randint(0, S, (R, M, c3), generator=g, device=DEVICE,
                             dtype=torch.int32)
        ones = torch.ones(R, M, c3, device=DEVICE)
        with torch.no_grad():
            # the gather form over 128 source points per row
            pre = randn(R, 128, c1)
            idx = torch.randint(0, 128, (R, M, S), generator=g,
                                device=DEVICE, dtype=torch.int32)
            args = (pre, idx, randn(R, M, c1), w1, b1, w2, b2)
            ref = fs.fused_gathered_mlp_pool_train_plain(*args)
            near("fused_sa", fused_gathered_mlp_pool(*args), ref[0], "out")
            out, arg, ppre = fs.fused_gathered_mlp_pool_train(*args)
            check(torch.equal(out, fused_gathered_mlp_pool(*args)),
                  f"fused_sa_train out differs from the eval kernel's at "
                  f"{shape}")
            near("fused_sa_train", out, ref[0], "out")
            near("fused_sa_train", ppre, ref[2], "ppre")
            flips("fused_sa_train", arg, ref[1])
        got = fs.fused_gathered_mlp_pool_backward(*args, grad, ref[1], ref[2])
        want = fs.fused_gathered_mlp_pool_backward_plain(*args, grad)
        for part, a, b in zip(("d_pre", "d_center", "dW1", "db1", "dW2",
                               "db2"), got, want):
            near("fused_sa_bwd", a, b, part)
        got = fs.fused_gathered_mlp_pool_backward(*args, grad, full, ones)
        want = fs.fused_gathered_mlp_pool_backward_routed_plain(
            *args, grad, full, ones)
        for part, a, b in zip(("d_pre", "d_center", "dW1", "db1", "dW2",
                               "db2"), got, want):
            near("fused_sa_bwd", a, b, part + " (full spread)")
        del args, pre, got, want
        with torch.no_grad():
            # the slab form, whose groups repeat their first h slots
            x0 = randn(R, M, S, c1)
            h = torch.randint(1, S + 1, (R, M, 1), generator=g,
                              device=DEVICE)
            slots = torch.arange(S, device=DEVICE) % h
            x0 = torch.gather(x0, 2, slots[..., None].expand(
                -1, -1, -1, c1)).contiguous()
            ref = fs.fused_mlp_pool_train_plain(x0, w1, b1, w2, b2)
            near("fused_sa_slab", fused_mlp_pool(x0, w1, b1, w2, b2),
                 ref[0], "out")
            out, arg, ppre = fs.fused_mlp_pool_train(x0, w1, b1, w2, b2)
            check(torch.equal(out, fused_mlp_pool(x0, w1, b1, w2, b2)),
                  f"fused_sa_slab_train out differs from the eval kernel's "
                  f"at {shape}")
            near("fused_sa_slab_train", out, ref[0], "out")
            near("fused_sa_slab_train", ppre, ref[2], "ppre")
            flips("fused_sa_slab_train", arg, ref[1])
            for routing, (a_, p_) in (("seeded", ref[1:]),
                                      ("full spread", (full, ones))):
                got = fs.fused_mlp_pool_backward(x0, w1, b1, w2, b2, grad,
                                                 a_, p_)
                want = fs.fused_mlp_pool_backward_routed_plain(
                    x0, w1, b1, w2, b2, grad, a_, p_)
                for part, a, b in zip(("d_x0", "dW1", "db1", "dW2", "db2"),
                                      got, want):
                    near("fused_sa_slab_bwd", a, b, f"{part} ({routing})")
            # the BatchNorm chain: eval, then the seven training passes
            gammas = [1 + randn(c, scale=0.2) for c in (c1, c2, c3)]
            betas = [randn(c, scale=0.2) for c in (c1, c2, c3)]
            stats = [(randn(c, scale=0.3), 0.5 + torch.rand(
                c, generator=g, device=DEVICE)) for c in (c1, c2, c3)]
            packs = fs.bn_packs([fs._bn_affine(m, v, ga, be, 1e-5)[:2]
                                 for (m, v), ga, be in
                                 zip(stats, gammas, betas)])
            near("fused_sa_slab_bn", fused_bn_mlp_pool(
                x0, w1, w2, gammas, betas, stats),
                fs.fused_sa_slab_plain(x0, packs, w1, w2), "out")
            n = R * M * S
            out, arg, at, means, vars_ = fs.fused_bn_mlp_pool_train_plain(
                x0, w1, w2, gammas, betas)
            layers = [fs._layer_pack(m, v, ga, be, 1e-5, n) for m, v, ga, be
                      in zip(means, vars_, gammas, betas)]
            slabs = [x0]
            for depth in range(3):
                name = fs.STATS_KERNELS[depth]
                a = ((x0,) if depth == 0 else
                     (slabs[-1], layers[depth - 1][fs.MUL].contiguous(),
                      layers[depth - 1][fs.ADD].contiguous(),
                      (w1, w2)[depth - 1]))
                got = fs.fused_sa_bn_stats(depth, *a)
                want = fs.fused_sa_bn_stats_plain(depth, *a)
                if depth:
                    near(name, got[1], want[1], f"x{depth}")
                    slabs.append(want[1])
                    got, want = got[0], want[0]
                near(name, got[1], want[1], "Σx²")
                near(name, got[0], want[0], "Σx")
            x1, x2 = slabs[1], slabs[2]
            m2 = layers[2][fs.MUL].contiguous()
            a2 = layers[2][fs.ADD].contiguous()
            got = fs.fused_sa_bn_final(x2, m2, a2)
            want = fs.fused_sa_bn_final_plain(x2, m2, a2)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"fused_sa_bn_final differs from its plain piece at "
                  f"{shape}")
            worst["fused_sa_bn_final"] = 0.0
            d_y2 = torch.where(out > 0, grad, 0.0)
            r2 = layers[2][fs.R_INV]
            layers[2] = fs._layer_pack(
                means[2], vars_[2], gammas[2], betas[2], 1e-5, n,
                d_y2.sum(dim=(0, 1)),
                (d_y2 * (at * r2 - means[2] * r2)).sum(dim=(0, 1)))
            for layer in (1, 0):  # non-zero ca, cb
                layers[layer][5:] = randn(2, layers[layer].shape[1],
                                          scale=0.3)
            pk = fs._pack(layers)
            dval = (d_y2 * layers[2][fs.MUL]).contiguous()
            got = fs.fused_sa_bn_wave1(x2, x1, pk, w2, dval, arg)
            want = fs.fused_sa_bn_wave1_plain(x2, x1, pk, w2, dval, arg)
            for part, a, b in zip(("sums", "dW2", "d_y1"), got, want):
                near("fused_sa_bn_wave1", a, b, part)
            got = fs.fused_sa_bn_wave2(want[2], x1, x0, pk, w1)
            want = fs.fused_sa_bn_wave2_plain(want[2], x1, x0, pk, w1)
            for part, a, b in zip(("sums", "dW1", "d_y0"), got, want):
                near("fused_sa_bn_wave2", a, b, part)
            near("fused_sa_bn_apply",
                 fs.fused_sa_bn_apply(want[2].clone(), x0, pk),
                 fs.fused_sa_bn_apply_plain(want[2], x0, pk), "d_x0")
        del x0, slabs, x1, x2, got, want
        torch.cuda.empty_cache()
        print(f"widened shape R={R} M={M} S={S} C={c1}->{c2}->{c3}: every "
              f"fused entry within its bound of its plain version")
    return worst


def widened_config(cfg, bn):
    """default.yaml's config with the RCNN's SA_0 at WIDE_NSAMPLE0 slots
    and its first two MLPs at WIDE_MLPS, and RCNN.USE_BN = bn, in
    memory."""
    wcfg = copy.deepcopy(cfg)
    sa = wcfg.RCNN.SA_CONFIG
    sa.NSAMPLE = [WIDE_NSAMPLE0, *sa.NSAMPLE[1:]]
    sa.MLPS = [list(m) for m in WIDE_MLPS] + [list(sa.MLPS[2])]
    wcfg.RCNN.USE_BN = bn
    return wcfg


def widened_paths(cfg, pts, batch):
    """The widened configuration's joint eval path and joint train step at
    B=WIDE_BATCH, without and with BatchNorm: sa_route must fuse both RCNN
    SA levels (the gather route without BatchNorm, the slab route with it)
    and each path must launch the fused kernels of both levels, once per
    level: fused_sa at eval and fused_sa_train / fused_sa_bwd in the step
    without BatchNorm, fused_sa_slab_bn and the seven training entries with
    it. -> {label: (ms, launches, peak GiB)}."""
    import torch

    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.ops import sa_route
    from tpu3d_torch.tools.eval_rcnn import make_infer_step
    from tpu3d_torch.weights import seeded_state_dict

    runs = {}
    for bn in (False, True):
        wcfg = widened_config(cfg, bn)
        sa = wcfg.RCNN.SA_CONFIG
        rows = WIDE_BATCH * wcfg.TEST.RPN_POST_NMS_TOP_N
        n, routes = wcfg.RCNN.NUM_POINTS, []
        for k in range(2):
            routes.append(sa_route((rows, sa.NPOINTS[k], sa.NSAMPLE[k],
                                    sa.MLPS[k][0]), sa.MLPS[k], n, bn))
            n = sa.NPOINTS[k]
        want = "slab" if bn else "gather"
        check(routes == [want, want], f"the widened config with USE_BN {bn} "
              f"routes its RCNN SA levels {routes}, expected {want} at both")
        name = "BatchNorm " if bn else ""
        model = PointRCNN(wcfg, mode="TEST", device=DEVICE)
        model.load_state_dict(seeded_state_dict(model, SEED))
        fused = {"fused_sa_slab_bn": 2} if bn else {"fused_sa": 2}
        torch.cuda.reset_peak_memory_stats()
        out, launches, ms = drive(make_infer_step(model, wcfg),
                                  pts[:WIDE_BATCH], tuple(fused),
                                  f"widened {name}joint")
        for k, v in fused.items():
            check(launches[k] == v, f"widened {name}eval launched {k} "
                  f"{launches[k]} times, expected {v}")
        # the joint path's shapes and finite values; the RPN's rois are
        # default.yaml's, so some are valid; the random widened RCNN may
        # score every box under the threshold, so the final boxes are
        # counted, not required
        post = wcfg.TEST.RPN_POST_NMS_TOP_N
        check_outputs(out, {
            "final_boxes": (WIDE_BATCH, 100, 7),
            "final_scores": (WIDE_BATCH, 100),
            "pred_boxes3d": (WIDE_BATCH, post, 7),
            "rois": (WIDE_BATCH, post, 7), "roi_valid": (WIDE_BATCH, post)})
        check(int(out["roi_valid"].sum()) > 0, f"widened {name}eval: no "
              f"valid roi")
        n_final = int(out["final_mask"].sum())
        runs[f"widened {name}eval B={WIDE_BATCH}"] = (
            ms, launches, torch.cuda.max_memory_allocated() / 2**30)
        del model, out
        tmodel = PointRCNN(wcfg, mode="TRAIN", device=DEVICE)
        tmodel.load_state_dict(train_weights(tmodel, SEED))
        fused = ({k: 2 for k in BN_TRAIN_KERNELS} if bn
                 else {"fused_sa_train": 2, "fused_sa_bwd": 2})
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
        tb = {k: v[:WIDE_BATCH] for k, v in batch.items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, launches, ms = drive_train(wcfg, tmodel, tb, gen, tuple(fused),
                                      f"widened {name}joint train step", 2)
        for k, v in fused.items():
            check(launches[k] == v, f"widened {name}train step launched {k} "
                  f"{launches[k]} times, expected {v}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[f"widened {name}train B={WIDE_BATCH}"] = (ms, launches, peak)
        print(f"widened {name}config (RCNN SA_0 NSAMPLE {WIDE_NSAMPLE0}, "
              f"MLPs {WIDE_MLPS}): eval {runs[f'widened {name}eval B={WIDE_BATCH}'][0]:.1f} "
              f"ms/batch ({n_final} final boxes), train {ms:.1f} ms/step, "
              f"peak device memory {peak:.2f} GiB; routes {routes}, fused "
              f"launches as expected")
        del tmodel
        torch.cuda.empty_cache()
    return runs


def pooled_inputs(model, pts):
    """The RCNN's pooled ROIs (xyz, rest) of the joint eval forward."""
    import torch

    with torch.no_grad():
        out = model({"pts_input": pts})
        xyz, rest, _, _ = model.pool_rois(
            out["backbone_xyz"], out["backbone_features"],
            out["rpn_cls"][..., 0], out["rois"])
    return xyz, rest


def sampled_targets(model, batch, state, gen):
    """The targets the train step's RCNN sees, from one train-mode forward;
    the running statistics it moved are restored from ``state``."""
    import torch

    with torch.no_grad():
        out = model({"pts_input": batch["pts_input"],
                     "gt_boxes3d": batch["gt_boxes3d"]}, train=True,
                    bn_momentum=0.9, generator=gen)
    model.load_state_dict(state)
    return {k: out[k] for k in (
        "sampled_pts", "pts_feature", "cls_label", "reg_valid_mask",
        "gt_of_rois", "gt_iou", "roi_boxes3d")}


def check_joint_outputs(cfg, out, batch, label):
    """The joint eval path's outputs: shapes, finite values, some valid rois
    and some final boxes."""
    post, n = cfg.TEST.RPN_POST_NMS_TOP_N, cfg.RPN.NUM_POINTS
    check_outputs(out, {
        "final_boxes": (batch, 100, 7), "final_scores": (batch, 100),
        "final_mask": (batch, 100), "pred_boxes3d": (batch, post, 7),
        "norm_scores": (batch, post), "raw_scores": (batch, post),
        "rois": (batch, post, 7), "roi_scores_raw": (batch, post),
        "roi_valid": (batch, post), "seg_result": (batch, n)})
    n_valid = int(out["roi_valid"].sum())
    n_final = int(out["final_mask"].sum())
    check(n_valid > 0, f"{label} eval: no valid roi")
    check(n_final > 0, f"{label} eval: no final box")
    print(f"{label} joint path: B={batch} N={n} NPOINTS="
          f"{list(cfg.RPN.SA_CONFIG.NPOINTS)} pre/post NMS "
          f"{cfg.TEST.RPN_PRE_NMS_TOP_N}/{post}, RCNN {cfg.RCNN.NUM_POINTS} "
          f"points per ROI, NPOINTS {list(cfg.RCNN.SA_CONFIG.NPOINTS)}: "
          f"valid rois {n_valid}/{batch * post}, final boxes "
          f"{n_final}/{batch * 100}")


def check_launches(launches, expect, label):
    """Exact launch counts of one forward or step: ``expect``'s, and 0 for
    every other kernel."""
    for name, n in launches.items():
        check(n == expect.get(name, 0), f"{label}: {name} launched {n} "
              f"times, expected {expect.get(name, 0)}")


CLI_CFG = "default.yaml"
CLI_FRAMES = 32  # the training CLI's --synthetic dataset
CLI_EPOCHS = 2
CLI_LONG_FRAMES = 160  # one epoch of 10 steps: the pace past the first
# the CLI's train steps, and its --train_with_eval pass (fused_sa)
CLI_KERNELS = TRAIN_KERNELS + ("fused_sa",)


def torch_group(features, idx):
    """torch.gather's grouping, its backward the library's scatter-add:
    what the library chains are timed with."""
    import torch

    B, M, S = idx.shape
    flat = idx.reshape(B, M * S).long()[..., None]
    return torch.gather(features, 1, flat.expand(-1, -1, features.shape[-1])
                        ).reshape(B, M, S, features.shape[-1])


def fixed_order_backward(args, grad, arg, ppre, label):
    """The gather form's backward twice: the same bits in every gradient,
    and d_pre equal to the CPU's fixed-order sum of the kernel's reached
    rows bit for bit -> the first call's gradients."""
    import torch

    from tpu3d_torch.ops.fused_sa import (fused_gathered_mlp_pool_backward,
                                          reached_rows_sum)

    rows = []
    got = fused_gathered_mlp_pool_backward(*args, grad, arg, ppre,
                                           rows_out=rows)
    again = fused_gathered_mlp_pool_backward(*args, grad, arg, ppre)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"fused_sa_bwd differs between two calls at {label}")
    pre, idx = args[0], args[1]
    dval = torch.where(ppre > 0, grad, 0.0)
    want = reached_rows_sum(tuple(pre.shape), idx.cpu(), dval.cpu(),
                            arg.cpu(), rows[0].cpu())
    check(torch.equal(got[0].cpu(), want), f"fused_sa_bwd d_pre differs "
          f"from the CPU's fixed-order sum of its {rows[0].shape[0]} "
          f"reached rows at {label}")
    print(f"  fused_sa_bwd {label}: two calls equal; d_pre equal to the "
          f"CPU's fixed-order sum of the kernel's {rows[0].shape[0]} reached "
          f"rows, to the bit")
    return got


def group_bwd_kernels(report, model, batch):
    """Phase 3 for the grouping gather's backward (group_points_bwd), at
    each call of the train step (B=16; the RPN's SA_1-3, a gather per
    radius; features and ids recorded from a train-mode forward): two calls
    give the same bits and equal the CPU plain version (index_add_ in
    ascending m·S + s) bit for bit; its time beside the plain version on
    the card and torch.gather's backward (scatter_add_, the library op it
    replaces)."""
    import torch

    from tpu3d_torch.models import pointnet2
    from tpu3d_torch.ops.grouping import (group_points_backward,
                                          group_points_backward_plain)

    calls, group_points = [], pointnet2.group_points

    def recorded(features, idx):
        calls.append((tuple(features.shape), idx.clone()))
        return group_points(features, idx)

    pointnet2.group_points = recorded
    kept = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        with torch.no_grad():
            model(batch, train=True, bn_momentum=0.9,
                  generator=torch.Generator(device=DEVICE).manual_seed(
                      SEED + 16))
    finally:
        pointnet2.group_points = group_points
        model.load_state_dict(kept)  # the forward moved the statistics
    gen = torch.Generator(device="cpu").manual_seed(SEED + 16)
    for (B, N, C), idx in calls:
        M, S = idx.shape[1], idx.shape[2]
        grad = torch.randn(B, M, S, C, generator=gen).to(idx.device)
        got = group_points_backward(grad, idx, N)
        check(torch.equal(got, group_points_backward(grad, idx, N)),
              f"group_points_bwd differs between two calls at {idx.shape}")
        check(torch.equal(got.cpu(), group_points_backward_plain(
            grad.cpu(), idx.cpu(), N)), f"group_points_bwd differs from the "
              f"CPU plain version at {idx.shape}")
        ms = cuda_ms(lambda: group_points_backward(grad, idx, N), 10)
        pms = cuda_ms(lambda: group_points_backward_plain(grad, idx, N), 5)
        flat = idx.reshape(B, -1).long()[..., None].expand(-1, -1, C)
        rows = grad.reshape(B, -1, C)
        lms = cuda_ms(lambda: torch.zeros(B, N, C, device=DEVICE)
                      .scatter_add_(1, flat, rows), 5)
        # read the gradient rows and the ids once, write d_features once; an
        # add per gradient element
        nbytes = 4 * (grad.numel() + idx.numel() + B * N * C)
        report.add("group_points_bwd", 0.0, ms, pms, lms, nbytes,
                   grad.numel())
        print(f"group_points_bwd ({B}, {N}, {C}) by {tuple(idx.shape)}: "
              f"{ms:.4f} ms, plain {pms:.3f} ms, torch.gather's backward "
              f"{lms:.4f} ms, bound {bound_ms(nbytes, grad.numel())[0]:.4f} "
              f"ms; two calls equal, equal to the CPU's")
        del grad, flat, rows
    check(len(calls) == 6, f"the train step grouped {len(calls)} times, "
          f"expected 6 (RPN SA_1-3, two radii each)")


def _run_tensors(run):
    """A finished CLI run's parameters and statistics, and its Adam
    moments, on the host, by state_dict key; the run's model and optimizer
    are dropped so the card's memory goes back."""
    names = {id(p): n for n, p in run.model.named_parameters()}
    opt = run.state.optimizer
    out = {"params": {k: v.detach().cpu()
                      for k, v in run.model.state_dict().items()}}
    for key in ("exp_avg", "exp_avg_sq"):
        out[key] = {names[id(p)]: opt.opt.state[p][key].cpu()
                    for p in opt.params}
    run.model = run.state = None
    return out


def _unequal(a: dict, b: dict) -> list:
    """The keys whose tensors are not equal to the bit."""
    import torch

    return sorted(k for k in a if not torch.equal(a[k], b[k]))


def training_cli(card: str) -> tuple[dict, dict]:
    """Phase 13: the port's training CLI (tools/train_rcnn.main, in process)
    from frames on disk. 32 frames from create_synthetic_kitti and their GT
    database from generate_gt_database; configs/default.yaml in joint mode
    at B=16 with GT augmentation, TRAIN.SPLIT trainval (2 steps an epoch),
    --train_with_eval (the smallval split, B=2), 2 epochs with a checkpoint
    after each. Run twice unbroken, then resumed with --ckpt from the first run's epoch-1
    checkpoint for the last epoch. The two unbroken runs must be equal to
    the bit in every parameter, statistic and Adam moment and in every
    loss; the resumed run equal to them to the bit in its parameters,
    statistics, moments and the last epoch's losses, its step and epoch
    equal, every loss finite. The first run counts its launches (every kernel of
    CLI_KERNELS at least once). The card-written checkpoint must read back
    on the host through msgpack_io to the same bytes, and load into a CPU
    model that saves it again to the same bytes. Prints the CLI's ms/step
    fed by the loader, the loader's scenes/s alone, the validation pass's
    ms per batch and the checkpoint's size and write time, beside the card;
    then one epoch over CLI_LONG_FRAMES frames (no validation pass) for
    the pace past an epoch's first step, which waits for the loader's
    first batch. -> (the launches of the first run, the numbers for the
    JSON line)."""
    import shutil

    import torch

    from tpu3d_torch.config import cfg_from_file, cfg_from_list, fresh_cfg
    from tpu3d_torch.datasets import (BatchLoader, KittiRCNNDataset,
                                      create_synthetic_kitti)
    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.ops import _build
    from tpu3d_torch.parallel import create_train_state
    from tpu3d_torch.tools import generate_gt_database
    from tpu3d_torch.tools.train_rcnn import configure_mode
    from tpu3d_torch.tools.train_rcnn import main as train_main
    from tpu3d_torch.utils import msgpack_io
    from tpu3d_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    work = ROOT / "build" / "cli_smoke"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    data = str(work / "data")
    create_synthetic_kitti(data, n_frames=CLI_FRAMES, image_files=True)
    db = generate_gt_database.main(["--root", data, "--save_dir",
                                    str(work / "gt_database")])
    write_s = time.perf_counter() - t0
    sets = ["--set", "TRAIN.SPLIT", "trainval"]

    def run(out, *extra, data=data, db=db, epochs=CLI_EPOCHS):
        return train_main(
            ["--cfg_file", str(ROOT / "configs" / CLI_CFG),
             "--train_mode", "joint", "--batch_size", str(TRAIN_BATCH),
             "--epochs", str(epochs), "--data_root", data,
             "--gt_database", db, "--ckpt_save_interval", "1",
             "--output_dir", str(work / out), *extra, *sets])

    torch.cuda.empty_cache()
    _build.reset_launches()
    a = run("a", "--train_with_eval")
    launches = dict(_build.LAUNCHES)
    for name in CLI_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the training CLI")
    ckpt_path = a.checkpoints[-1]
    t1 = time.perf_counter()
    timed = save_checkpoint(str(work / "timed"), a.model, a.state, CLI_EPOCHS)
    ckpt_ms = (time.perf_counter() - t1) * 1e3
    ckpt_bytes = Path(ckpt_path).stat().st_size
    runs = {"a": a}
    runs["b"] = run("b", "--train_with_eval")
    runs["c"] = run("c", "--train_with_eval", "--ckpt", a.checkpoints[0])
    steps = {k: r.state.step for k, r in runs.items()}
    losses = {k: r.losses for k, r in runs.items()}
    step_ms = runs["a"].step_ms + runs["b"].step_ms
    eval_ms = runs["a"].eval_ms + runs["b"].eval_ms
    epochs = {k: int(msgpack_io.decode(Path(r.checkpoints[-1]).read_bytes())
                     ["epoch"]) for k, r in runs.items()}
    tensors = {k: _run_tensors(r) for k, r in runs.items()}
    del runs, a
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for v in losses.values() for x in v),
          f"a training CLI loss is not finite: {losses}")
    spe = CLI_FRAMES // TRAIN_BATCH  # trainval holds every frame
    check(len(losses["a"]) == spe * CLI_EPOCHS and len(losses["c"]) == spe,
          f"steps run: {({k: len(v) for k, v in losses.items()})}")
    check(steps["c"] == steps["a"] == steps["b"] == spe * CLI_EPOCHS
          and epochs["c"] == epochs["a"] == CLI_EPOCHS,
          f"steps {steps}, epochs {epochs}")
    resume = {}
    for key in ("params", "exp_avg", "exp_avg_sq"):
        unbroken = _unequal(tensors["a"][key], tensors["b"][key])
        resumed = _unequal(tensors["a"][key], tensors["c"][key])
        resume[key] = {"tensors": len(tensors["a"][key]),
                       "unbroken_runs_unequal": unbroken,
                       "resumed_unequal": resumed}
        check(not unbroken, f"two unbroken training-CLI runs differ in "
              f"{len(unbroken)} {key} tensors, e.g. {unbroken[:3]}")
        check(not resumed, f"the resumed run differs from the unbroken run "
              f"in {len(resumed)} {key} tensors, e.g. {resumed[:3]}")
    check(losses["a"] == losses["b"] and losses["c"] == losses["a"][spe:],
          f"the runs' losses differ: {losses}")

    # the card-written checkpoint, read back on the host
    raw = Path(ckpt_path).read_bytes()
    check(msgpack_io.encode(msgpack_io.decode(raw)) == raw,
          "the card-written checkpoint does not re-encode to its bytes")
    cfg = cfg_from_list(sets[1:], configure_mode(cfg_from_file(
        str(ROOT / "configs" / CLI_CFG), fresh_cfg()), "joint"))
    cpu_model = PointRCNN(cfg, mode="TRAIN", device="cpu")
    cpu_state = create_train_state(cfg, cpu_model, spe, CLI_EPOCHS)
    cpu_state, epoch = load_checkpoint(ckpt_path, cpu_model, cpu_state)
    again = save_checkpoint(str(work / "cpu"), cpu_model, cpu_state, epoch)
    check(Path(again).read_bytes() == raw and Path(timed).read_bytes() == raw,
          "the card-written checkpoint does not save back to its bytes")
    del cpu_model, cpu_state

    # the loader alone: the CLI's dataset and loader (4 thread workers)
    ds = KittiRCNNDataset(root_dir=data, npoints=cfg.RPN.NUM_POINTS,
                          split=cfg.TRAIN.SPLIT, mode="TRAIN", cfg=cfg,
                          gt_database_dir=db, seed=19260817)
    loader = BatchLoader(ds, TRAIN_BATCH, shuffle=True, num_workers=4,
                         drop_last=True, seed=19260817)
    t1 = time.perf_counter()
    scenes = 0
    for epoch in range(CLI_EPOCHS):
        loader.set_epoch(epoch)
        scenes += sum(len(b["batch_valid"]) for b in loader)
    scenes_per_s = scenes / (time.perf_counter() - t1)

    # the pace past an epoch's first step: one epoch of CLI_LONG_FRAMES
    long_data = str(work / "long")
    create_synthetic_kitti(long_data, n_frames=CLI_LONG_FRAMES, seed=1,
                           image_files=True)
    long_db = generate_gt_database.main(["--root", long_data, "--save_dir",
                                         str(work / "long_gt_database")])
    long_run = run("long", data=long_data, db=long_db, epochs=1)
    long_ms = long_run.step_ms
    del long_run
    torch.cuda.empty_cache()

    # an epoch's first step waits for the loader's first batch (each epoch
    # starts the loader anew); the others find theirs built
    first = [ms for i, ms in enumerate(step_ms) if i % spe == 0]
    rest = [ms for i, ms in enumerate(step_ms) if i % spe]
    out = {
        "path": f"tools/train_rcnn.main, {CLI_CFG} joint B={TRAIN_BATCH}"
                f", {CLI_FRAMES} frames from disk, TRAIN.SPLIT trainval, "
                "--train_with_eval", "card": card,
        "ms_per_step": statistics.median(step_ms), "step_ms": step_ms,
        "ms_per_step_first_of_epoch": statistics.median(first),
        "ms_per_step_rest": statistics.median(rest) if rest else None,
        "long_epoch": {"frames": CLI_LONG_FRAMES, "step_ms": long_ms,
                       "ms_per_step_past_first": statistics.median(
                           long_ms[1:])},
        "loader_scenes_per_s": scenes_per_s,
        "eval_ms_per_batch": statistics.median(eval_ms), "eval_ms": eval_ms,
        "ckpt_bytes": ckpt_bytes, "ckpt_write_ms": ckpt_ms,
        "frames_and_database_s": write_s, "resume": resume,
        "launches": {k: v for k, v in launches.items() if v}}
    print(f"training CLI from disk ({out['path']}; {card}): "
          f"{out['ms_per_step']:.1f} ms/step fed by the loader (host clock, "
          f"median of {len(step_ms)} steps of two runs, the first of each "
          f"run included: {[round(x, 1) for x in step_ms]}; an epoch's "
          f"first step {out['ms_per_step_first_of_epoch']:.1f}, the others "
          f"{out['ms_per_step_rest'] or 0:.1f}; one epoch of "
          f"{CLI_LONG_FRAMES} frames without the validation pass: "
          f"{out['long_epoch']['ms_per_step_past_first']:.1f} ms/step past "
          f"its first, {[round(x, 1) for x in long_ms]}); the loader "
          f"alone {scenes_per_s:.1f} scenes/s (4 thread workers, "
          f"{scenes} scenes); the validation pass "
          f"{out['eval_ms_per_batch']:.1f} ms per batch of 2; checkpoint "
          f"{ckpt_bytes} bytes written in {ckpt_ms:.1f} ms; frames and GT "
          f"database {write_s:.1f} s; launches of the first run "
          f"{out['launches']}")
    print(f"training CLI resume from the epoch-1 checkpoint: {resume}; "
          f"steps {steps}, epochs {epochs}, losses {losses}")
    return launches, out


EVAL_CLI_BATCH = 8  # the eval CLI's default --batch_size
OFFLINE_BATCH = 16  # the training CLI's default --batch_size
# launches per batch of the eval CLI's joint path on CLI_CFG, per step of
# rcnn_offline training, per batch of rcnn_offline eval: the RCNN's SA_0
# and SA_1 each sample with fps and group with nearest_k
EVAL_CLI = {"fps3nn": 4, "nearest_k": 6, "three_interpolate": 4, "fps": 2,
            "fused_sa": 2}
OFFLINE_TRAIN = {"fps": 2, "nearest_k": 2, "fused_sa_train": 2,
                 "fused_sa_bwd": 2}
OFFLINE_EVAL = {"fps": 2, "nearest_k": 2, "fused_sa": 2}
RPN_EVAL_KERNELS = ("fps3nn", "nearest_k", "three_interpolate")
# the evaluator's output transformations (evaluate.evaluate's keywords)
EVAL_TRANSFORMS = {
    "new": {}, "old": {"metric": "old"}, "score_thresh": {"score_thresh": 0.5},
    "toground": {"toground": True}, "rescale_pred": {"rescale_pred": 1.1},
    "align_size": {"align_size": True}, "align_front": {"align_front": True},
    "reverse_align": {"reverse_align": True},
    "dense_sample": {"dense_sample": True, "direct_save": True},
    "coco": {"coco": True}, "output_iou": {"output_iou": True},
    "range_check": {"range_check": True}}


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def eval_cli(card: str) -> tuple[dict, dict, dict]:
    """Phase 14: the eval CLI (tools/eval_rcnn.main) and the evaluator
    (evaluate.evaluate), in process, on phase 13's frames and its
    card-written checkpoint. Joint mode on CLI_CFG at EVAL_CLI_BATCH with
    --save_result over all CLI_FRAMES frames (TEST.SPLIT trainval), with
    EVAL_CLI's launches per batch exactly, a label file per frame and
    finite recall. The evaluator over those labels on the card with every
    transformation of EVAL_TRANSFORMS, each report (and AP dict) equal to
    the same call on the CPU, and the new and old metric over the rois the
    CLI wrote beside them (roi_result, dozens of boxes a frame); the card's
    rotated overlaps of those rois (metrics 1, 2) within 1e-5 of the CPU's;
    eval_class over them through the native matcher equal to the Python
    one (metrics 0-2, AOS on metric 0). RPN mode with
    --save_rpn_feature --save_result (the RPN kernels, neither fps nor
    fused_sa), one epoch of rcnn_offline training from its dumps at
    OFFLINE_BATCH (OFFLINE_TRAIN per step exactly), rcnn_offline eval of
    that checkpoint (OFFLINE_EVAL per batch exactly), finite losses and cls
    accuracies. -> (the joint eval's launches, the offline training's and
    eval's launches summed, the numbers for the JSON line)."""
    import shutil

    import numpy as np
    import torch

    from tpu3d_torch.evaluate import ap
    from tpu3d_torch.evaluate.evaluate import evaluate
    from tpu3d_torch.evaluate.overlaps import calculate_iou_partly
    from tpu3d_torch.kitti import annos
    from tpu3d_torch.ops import _build
    from tpu3d_torch.tools.eval_rcnn import main as eval_main
    from tpu3d_torch.tools.train_rcnn import main as train_main
    from tpu3d_torch.utils.checkpoint import latest_checkpoint

    work = ROOT / "build" / "cli_smoke"
    data = work / "data"
    ckpt = latest_checkpoint(str(work / "a" / "ckpt"))
    check(ckpt is not None, "phase 13 left no checkpoint")
    out = ROOT / "build" / "eval_smoke"
    shutil.rmtree(out, ignore_errors=True)
    cfg_file = str(ROOT / "configs" / CLI_CFG)
    sets = ["--set", "TEST.SPLIT", "trainval"]
    n_batches = -(-CLI_FRAMES // EVAL_CLI_BATCH)

    def cli(mode, *extra, batch=EVAL_CLI_BATCH):
        _build.reset_launches()
        t0 = time.perf_counter()
        res = eval_main(["--cfg_file", cfg_file, "--eval_mode", mode,
                         "--data_root", str(data), "--batch_size", str(batch),
                         "--output_dir", str(out / mode), "--device", DEVICE,
                         "--save_result", *extra, *sets])
        return res, time.perf_counter() - t0, dict(_build.LAUNCHES)

    # the joint eval
    joint, joint_s, joint_launches = cli("joint", "--ckpt", ckpt)
    check_launches(joint_launches, {k: v * n_batches
                                    for k, v in EVAL_CLI.items()},
                   f"eval CLI joint, {n_batches} batches")
    result = out / "joint" / "final_result" / "data"
    check(len(list(result.iterdir())) == CLI_FRAMES,
          f"eval CLI: {len(list(result.iterdir()))} label files for "
          f"{CLI_FRAMES} frames")
    check(all(math.isfinite(v) for key in ("recall", "roi_recall")
              for v in joint[key].values()), f"eval CLI recall {joint}")

    # the evaluator on the card over those labels (the final boxes, and the
    # rois before the RCNN, dozens a frame whatever the weights), against
    # the CPU
    label_path = data / "KITTI" / "object" / "training" / "label_2"
    split = data / "KITTI" / "ImageSets" / "trainval.txt"
    ids = [int(x) for x in split.read_text().split()]
    rois = out / "joint" / "roi_result" / "data"
    dt = annos.get_label_annos(str(rois), ids)
    gt = annos.get_label_annos(str(label_path), ids)
    n_dt = sum(len(a["name"]) for a in dt)
    overlap_diff = 0.0
    for metric in (1, 2):
        card_ov = calculate_iou_partly(dt, gt, metric, device=DEVICE)[0]
        cpu_ov = calculate_iou_partly(dt, gt, metric, device="cpu")[0]
        overlap_diff = max([overlap_diff] + [float(abs(a - b).max())
                                             for a, b in zip(card_ov, cpu_ov)
                                             if a.size])
    check(overlap_diff <= 1e-5, f"the card's overlaps differ from the CPU's "
          f"by {overlap_diff}")
    mo = np.array([[[0.7], [0.5], [0.5]], [[0.5], [0.25], [0.25]]])
    for metric in (0, 1, 2):
        kw = dict(compute_aos=metric == 0, device=DEVICE)
        native = ap.eval_class(gt, dt, [0], "kitti", list(range(6)), metric,
                               mo, "new", use_native=True, **kw)
        plain = ap.eval_class(gt, dt, [0], "kitti", list(range(6)), metric,
                              mo, "new", use_native=False, **kw)
        for key in ("precision", "recall", "orientation"):
            check(np.array_equal(native[key], plain[key]),
                  f"native and Python matchers differ: metric {metric} {key}")
    dims = np.concatenate([g["dimensions"] for g in gt])
    stats = {name: {"mean": float(dims[:, i].mean()),
                    "std": float(dims[:, i].std())}
             for i, name in enumerate(("length", "height", "width"))}
    (out / "stats").mkdir(parents=True)
    (out / "stats" / "label_stats_kitti.json").write_text(json.dumps(stats))
    reports, ev_s, ev_peak = {}, {}, {}
    runs = [(tag, kw, result) for tag, kw in EVAL_TRANSFORMS.items()] + [
        ("rois_new", {}, rois), ("rois_old", {"metric": "old"}, rois)]
    for tag, kw, labels in runs:
        got = {}
        for side, dev in (("card", DEVICE), ("cpu", "cpu")):
            run = out / "evaluator" / side / tag
            shutil.copytree(labels, run / "data")
            if side == "card":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
            got[side] = evaluate(
                str(run / "data"), label_path=str(label_path),
                label_split_file=str(split), current_class=0, device=dev,
                stats_dir=str(out / "stats"), **dict({"metric": "new"}, **kw))
            if side == "card":
                torch.cuda.synchronize()
                ev_s[tag] = time.perf_counter() - t0
                ev_peak[tag] = (torch.cuda.max_memory_allocated()
                                - base) / 2 ** 20
        check(got["card"][0] == got["cpu"][0],
              f"evaluator {tag}: the card's report differs from the CPU's")
        if got["cpu"][1] is not None:
            for key in ("Car_3d_moderate", "Car_bev_moderate",
                        "Car_image_moderate"):
                check(got["card"][1][key] == got["cpu"][1][key],
                      f"evaluator {tag}: {key} differs from the CPU's")
        reports[tag] = got["card"][0]
    check(all("3d   AP" in reports[k] for k in ("new", "old", "rois_new")),
          "the evaluator printed no AP table")

    # RPN mode with its dumps, rcnn_offline training and eval from them
    rpn, rpn_s, rpn_launches = cli("rpn", "--ckpt", ckpt,
                                   "--save_rpn_feature")
    for name, n in rpn_launches.items():
        check((n > 0) == (name in RPN_EVAL_KERNELS),
              f"eval CLI rpn: {name} launched {n} times")
    dumps = out / "rpn"
    feats = sorted((dumps / "features").iterdir())
    check(len(feats) == 5 * CLI_FRAMES, f"RPN dumps: {len(feats)} files")
    dump_bytes = sum(_dir_bytes(dumps / d) for d in
                     ("features", "seg_result", "detections"))
    dirs = ["--rcnn_training_roi_dir", str(dumps / "detections" / "data"),
            "--rcnn_training_feature_dir", str(dumps / "features")]
    _build.reset_launches()
    train = train_main(["--cfg_file", cfg_file, "--train_mode",
                        "rcnn_offline", "--batch_size", str(OFFLINE_BATCH),
                        "--epochs", "1", "--data_root", str(data),
                        "--output_dir", str(out / "offline_train"),
                        "--device", DEVICE, *dirs, "--set", "TRAIN.SPLIT",
                        "trainval"])
    train_launches = dict(_build.LAUNCHES)
    steps = len(train.losses)
    check(steps == CLI_FRAMES // OFFLINE_BATCH
          and all(math.isfinite(x) for x in train.losses),
          f"rcnn_offline training: losses {train.losses}")
    check_launches(train_launches, {k: v * steps
                                    for k, v in OFFLINE_TRAIN.items()},
                   f"rcnn_offline training, {steps} steps")
    offline, offline_s, offline_launches = cli(
        "rcnn_offline", "--ckpt", train.checkpoints[-1],
        "--rcnn_eval_roi_dir", dirs[1], "--rcnn_eval_feature_dir", dirs[3])
    check_launches(offline_launches, {k: v * n_batches
                                      for k, v in OFFLINE_EVAL.items()},
                   f"rcnn_offline eval, {n_batches} batches")
    check(all(math.isfinite(offline[k]) for k in
              ("rcnn_cls_acc", "rcnn_cls_acc_refined", "avg_detections")),
          f"rcnn_offline eval: {offline}")
    train_ms = train.step_ms
    del train
    torch.cuda.empty_cache()

    res = {
        "path": f"tools/eval_rcnn.main, {CLI_CFG} joint B={EVAL_CLI_BATCH}, "
                f"{CLI_FRAMES} frames from disk (TEST.SPLIT trainval), phase "
                "13's checkpoint", "card": card,
        "scenes_per_s": joint["scenes_per_sec"], "joint_call_s": joint_s,
        "recall": joint["recall"], "roi_recall": joint["roi_recall"],
        "avg_detections": joint["avg_detections"],
        "evaluator_s": ev_s, "evaluator_peak_mib": ev_peak,
        "evaluator_roi_boxes": n_dt,
        "overlaps_card_cpu_max_abs_diff": overlap_diff,
        "rpn_call_s": rpn_s, "rpn_dumps_bytes": dump_bytes,
        "rpn_seg_iou": rpn["rpn_iou"],
        "offline_step_ms": statistics.median(train_ms),
        "offline_step_ms_all": train_ms,
        "offline_eval_call_s": offline_s,
        "offline_eval_scenes_per_s": CLI_FRAMES / offline_s,
        "offline_cls_acc": offline["rcnn_cls_acc"],
        "offline_cls_acc_refined": offline["rcnn_cls_acc_refined"]}
    print(f"eval CLI ({res['path']}; {card}): {res['scenes_per_s']:.2f} "
          f"scenes/s after the first batch (the call {joint_s:.1f} s), "
          f"recall {joint['recall']}, roi recall {joint['roi_recall']}; the "
          f"evaluator on the card over the final boxes {ev_s['new']:.2f} s "
          f"(new), {ev_s['old']:.2f} s (old), peak {ev_peak['new']:.1f} MiB "
          f"above what was allocated before; over the {n_dt} rois "
          f"{ev_s['rois_new']:.2f} s, peak {ev_peak['rois_new']:.1f} MiB; "
          f"every transformation equal to the "
          f"CPU's (seconds {ev_s}); overlaps of the rois, card against CPU, "
          f"{overlap_diff:.3g}; RPN mode with dumps "
          f"{rpn_s:.1f} s, {dump_bytes} bytes; rcnn_offline training "
          f"{res['offline_step_ms']:.1f} ms/step fed by the loader "
          f"({[round(x, 1) for x in train_ms]}, B={OFFLINE_BATCH}); "
          f"rcnn_offline eval {res['offline_eval_scenes_per_s']:.2f} "
          f"scenes/s over the whole call ({offline_s:.1f} s), cls acc "
          f"{offline['rcnn_cls_acc']:.3f} / refined "
          f"{offline['rcnn_cls_acc_refined']:.3f}")
    print("evaluator report (new metric, the card):\n" + reports["new"]
          + "over the rois:\n" + reports["rois_new"])
    return joint_launches, {
        k: train_launches[k] + offline_launches[k] for k in train_launches}, res


DP_WORLD = 2  # gloo ranks sharing the one card
DP_EVAL_BATCH = 8  # the eval CLI's default --batch_size
DP_STEP_SEED = SEED + 15  # the data-parallel phase's step generator
DP_CFG = "default.yaml"
DP_REPEATS = 3  # more one-process steps, each held equal to the first


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dp_model(cfg, dev):
    """A default.yaml train model with ``train_weights``, its state and
    train step over ``mesh`` (None: one process)."""
    from tpu3d_torch.models import PointRCNN

    model = PointRCNN(cfg, mode="TRAIN", device=dev)
    model.load_state_dict(train_weights(model, SEED))
    return model


def _dp_step(cfg, model, batch, mesh=None):
    """One train step of ``model`` on ``batch`` (this rank's rows) over
    ``mesh``, from a fresh generator at DP_STEP_SEED -> (state, step fn,
    launches of the step, metrics, the gradients the step clipped: summed
    over the mesh, as they were before the clip, on the host by parameter
    name)."""
    import torch

    from tpu3d_torch.ops import _build
    from tpu3d_torch.parallel import create_train_state, make_train_step

    state = create_train_state(cfg, model, steps_per_epoch=100,
                               total_epochs=10, mesh=mesh)
    step = make_train_step(cfg, model, mesh)
    dev = batch["pts_input"].device
    gen = torch.Generator(device=dev).manual_seed(DP_STEP_SEED)
    grads, apply = {}, state.apply_gradients

    def keep_grads():  # the step calls it after the sum, and it clips
        grads.update({n: (torch.zeros_like(p) if p.grad is None else p.grad)
                      .detach().cpu().clone()
                      for n, p in model.named_parameters()})
        return apply()

    state.apply_gradients = keep_grads
    try:
        _build.reset_launches()
        tb = step(state, batch, gen, 0.9)
        _sync(dev)
    finally:
        del state.apply_gradients
    return (state, step, {k: v for k, v in _build.LAUNCHES.items() if v}, tb,
            grads)


def _timed_steps(step, state, batch, n=3) -> float:
    """ms per step (host clock, median of ``n``; each ends in a
    synchronize)."""
    import torch

    dev = batch["pts_input"].device
    gen = torch.Generator(device=dev).manual_seed(DP_STEP_SEED + 1)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(state, batch, gen, 0.9)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _host_state(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _dp_parts(model, grads) -> dict:
    """A step's result on the host, by kind: the summed gradients before
    the clip (``_dp_step``), the parameters after the step and the running
    statistics."""
    state, params = _host_state(model), dict(model.named_parameters())
    return {"grads": grads,
            "params": {k: v for k, v in state.items() if k in params},
            "stats": {k: v for k, v in state.items()
                      if k not in params and v.is_floating_point()}}


def _dp_rank(rank, world, store_path, out_dir, run):
    """A rank of phase 15(b), under gloo on card 0: the default.yaml train
    step and the RCNN.USE_BN one at a global B=16, the step's time, the
    gradient all-reduce's time and the peak memory, a checkpoint written at
    this world, and the sharded joint eval at B=8 -> out_dir/rank{r}.pt.
    ``run`` names the config, the batches and the device (the parent's
    DP_CFG, TRAIN_BATCH, DP_EVAL_BATCH and DEVICE)."""
    import torch
    import torch.distributed as dist

    from tpu3d_torch.config import cfg_from_file, cfg_from_list, fresh_cfg
    from tpu3d_torch.datasets import device_prefetch, random_scenes, \
        train_batch
    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.parallel import init_distributed, make_mesh, \
        shard_batch
    from tpu3d_torch.tools.eval_rcnn import _to_host, make_infer_step
    from tpu3d_torch.utils.checkpoint import save_checkpoint
    from tpu3d_torch.weights import seeded_state_dict

    dev = torch.device(run["device"])
    cuda = dev.type == "cuda"
    init_distributed(dev, "gloo", dist.FileStore(store_path, world), rank,
                     world)
    try:
        cfg = cfg_from_list(run["sets"], cfg_from_file(run["cfg"],
                                                       fresh_cfg()))
        bcfg = copy.deepcopy(cfg)
        bcfg.RCNN.USE_BN = True
        mesh = make_mesh(batch_size=run["batch"])
        host = train_batch(run["batch"], cfg.RPN.NUM_POINTS, SEED)
        rows = mesh.rows(run["batch"])
        # this rank's rows through the sharded prefetch
        batch = next(iter(device_prefetch([{k: v[rows] for k, v in
                                            host.items()}], device=dev)))
        out = {"rank": rank, "ranks": mesh.ranks}
        for name, c in (("default", cfg), ("bn", bcfg)):
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            model = _dp_model(c, dev)
            state, step, launches, tb, grads = _dp_step(c, model, batch,
                                                        mesh)
            out[name] = {"state": _host_state(model),
                         "parts": _dp_parts(model, grads),
                         "launches": launches, "loss": float(tb["loss"])}
            if name == "default":
                out[name]["ms"] = _timed_steps(step, state, batch)
                out[name]["peak_gib"] = (torch.cuda.max_memory_allocated()
                                         / 2 ** 30 if cuda else 0.0)
                n = sum(p.numel() for p in model.parameters())
                flat = torch.ones(n, device=dev)
                times = []
                for _ in range(5):
                    _sync(dev)
                    t0 = time.perf_counter()
                    dist.all_reduce(flat)
                    _sync(dev)
                    times.append((time.perf_counter() - t0) * 1e3)
                out["allreduce"] = {"floats": n,
                                    "ms": statistics.median(times)}
                out["ckpt"] = {"path": save_checkpoint(
                    str(Path(out_dir) / "ckpt"), model, state, 1, mesh),
                    "state": _host_state(model), "step": state.step}
            del model, state, step
            if cuda:
                torch.cuda.empty_cache()
        emodel = PointRCNN(cfg, mode="TEST", device=dev)
        emodel.load_state_dict(seeded_state_dict(emodel, SEED))
        emesh = make_mesh(batch_size=run["eval_batch"])
        pts = random_scenes(run["eval_batch"], cfg.RPN.NUM_POINTS, SEED)
        with torch.no_grad():
            got = make_infer_step(emodel, cfg)(shard_batch(
                emesh, {"pts_input": pts}, dev)["pts_input"])
        keys = ("final_boxes", "final_scores", "final_mask")
        got = _to_host({k: got[k] for k in keys}, {}, (), emesh)
        out["eval"] = got and got[0]
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _diffs(a: dict, b: dict) -> dict:
    """The largest difference of each tensor of ``b`` from ``a``'s."""
    return {k: (a[k].double() - b[k].double()).abs().max().item() for k in b}


def _dp_floor(cfg, batch, ref, dev) -> dict:
    """The one-process step's noise floors for each tensor of each kind of
    ``_dp_parts`` (``ref``, the one-process step's): the tensor's largest
    change after one step from weights nudged by about one float32
    rounding, over NUDGES nudges, as phase 4 takes the RPN's gradient noise
    floor -> {kind: ({name: floor}, the largest entry of the kind)}."""
    import torch

    floors = {kind: {k: 0.0 for k in ref[kind]} for kind in ref}
    for i in range(NUDGES):
        model = _dp_model(cfg, dev)
        gen = torch.Generator(device="cpu").manual_seed(SEED + 3 + i)
        with torch.no_grad():
            for t in model.state_dict().values():
                if t.is_floating_point():
                    t.mul_(1 + 1e-7 * torch.randn(t.shape, generator=gen)
                           .to(t.device))
        parts = _dp_parts(model, _dp_step(cfg, model, batch)[4])
        for kind, got in parts.items():
            for k, d in _diffs(got, ref[kind]).items():
                floors[kind][k] = max(floors[kind][k], d)
        del model
    return {kind: (f, max(v.abs().max().item() for v in ref[kind].values()))
            for kind, f in floors.items()}


def data_parallel(card: str, step5_ms: float, expect_launches: dict,
                  bn_expect: dict) -> dict:
    """Phase 15: tpu3d's data-parallel mesh on torch.distributed, on the
    one card. (a) NCCL at a world of 1 (a FileStore in a temporary
    directory): default.yaml's train step at B=16 through the mesh (its
    group passed, so the gradients' all-reduce runs) and the sharded
    prefetch against the step without a group on the same batch and
    generator (see the module's docstring, phase 15); (b) dryrun_multichip(2) under gloo,
    then two gloo ranks on the card: default.yaml's step and the
    RCNN.USE_BN one at a global B=16 (8 a rank), each rank's parameters
    and running statistics bit-equal across the ranks, and its summed
    gradients, running statistics and parameters each within its noise
    floor of the one-process step's, the sharded joint eval at B=8 (4 a rank)
    against the one-process eval, a checkpoint written at world 2 restored
    at 1; NCCL with more ranks than cards raises. -> the phase's figures."""
    import tempfile

    import torch
    import torch.distributed as dist

    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.datasets import device_prefetch, random_scenes, \
        train_batch
    from tpu3d_torch.entry import dryrun_multichip, spawn
    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.parallel import (create_train_state, init_distributed,
                                      make_mesh, replicate)
    from tpu3d_torch.parallel.mesh import sum_gradients
    from tpu3d_torch.tools.eval_rcnn import make_infer_step
    from tpu3d_torch.utils.checkpoint import load_checkpoint
    from tpu3d_torch.weights import seeded_state_dict

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(DEVICE)
    run = {"cfg": str(ROOT / "configs" / DP_CFG), "batch": TRAIN_BATCH,
           "eval_batch": DP_EVAL_BATCH, "device": str(dev),
           "sets": list(F32_TRAINING)}
    cfg = cfg_from_file(run["cfg"], fresh_cfg())
    bcfg = copy.deepcopy(cfg)
    bcfg.RCNN.USE_BN = True
    host = train_batch(TRAIN_BATCH, cfg.RPN.NUM_POINTS, SEED)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

    # (a) the one-process step, DP_REPEATS times more, each equal to the
    # first to the bit (every sum on the step's path runs in a fixed
    # order); then the same step over an NCCL world of 1
    runs = []
    for _ in range(1 + DP_REPEATS):
        model = _dp_model(cfg, dev)
        _, _, one_launches, _, grads = _dp_step(cfg, model, batch)
        if not runs:
            ref_parts = _dp_parts(model, grads)
        runs.append({**_host_state(model),
                     **{f"grad {k}": v for k, v in grads.items()}})
        del model
        check(one_launches == expect_launches,
              f"the one-process step launched {one_launches}, phase 5's "
              f"step {expect_launches}")
    ref = runs[0]
    for i, r in enumerate(runs[1:]):
        off = _unequal(ref, r)
        check(not off, f"one-process step {i + 2} differs from the first in "
              f"{len(off)} of {len(ref)} tensors, e.g. {off[:3]}")
    figures = {"card": card}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        init_distributed(dev, None, dist.FileStore(
            str(Path(tmp) / "store"), 1), 0, 1)
        try:
            backend = dist.get_backend()
            mesh = make_mesh(batch_size=TRAIN_BATCH, group=dist.group.WORLD)
            check(mesh.group is not None and mesh.size == 1,
                  f"a {backend} world of 1 with its group passed")
            rows = {k: v[mesh.rows(TRAIN_BATCH)] for k, v in host.items()}
            nbatch = next(iter(device_prefetch([rows], device=dev)))
            model = _dp_model(cfg, dev)
            state, step, launches, _, wgrads = _dp_step(cfg, model, nbatch,
                                                        mesh)
            got = {**_host_state(model),
                   **{f"grad {k}": v for k, v in wgrads.items()}}
            check(launches == one_launches,
                  f"{backend} world 1 launched {launches}, {one_launches} "
                  f"alone")
            # the collectives themselves: the gradients' all-reduce over the
            # group of one and the broadcast from rank 0 leave this step's
            # gradients, parameters and statistics as they are, to the bit
            params = state.optimizer.params
            grads = [p.grad.clone() for p in params]
            sum_gradients(params, mesh)
            replicate(mesh, model)
            check(all(torch.equal(p.grad, g) for p, g in zip(params, grads))
                  and all(torch.equal(v, got[k]) for k, v in
                          _host_state(model).items()),
                  f"the all-reduce or broadcast over a {backend} world of 1 "
                  "changed a tensor")
            off = _unequal(ref, got)
            check(not off, f"{backend} world 1: {len(off)} of {len(ref)} "
                  f"tensors differ from the step without a group, e.g. "
                  f"{off[:3]}")
            figures["nccl_world1_ms"] = _timed_steps(step, state, nbatch)
            figures["one_process_repeats"] = DP_REPEATS
            del model, state, step, grads
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"data-parallel (a), {card}: {1 + DP_REPEATS} steps without a "
          f"group equal to the bit in all {len(ref)} tensors; the {backend} "
          f"world-1 train step's gradient all-reduce and broadcast leave "
          f"every tensor as it is, to the bit; the step equals the step "
          f"without a group to the bit in all {len(ref)} tensors; the same "
          f"launches {one_launches}; {figures['nccl_world1_ms']:.1f} ms/step "
          f"(host clock, median of 3) beside phase 5's {step5_ms:.1f}")

    # (b) NCCL wants a card per rank; gloo runs two ranks on this one
    try:
        dryrun_multichip(torch.cuda.device_count() + 1)
        check(False, "dryrun_multichip under NCCL ran with too few cards")
    except RuntimeError as e:
        print(f"dryrun_multichip({torch.cuda.device_count() + 1}) under "
              f"NCCL on {torch.cuda.device_count()} card(s) raises: {e}")
    t0 = time.perf_counter()
    figures["dryrun"] = dryrun_multichip(DP_WORLD, backend="gloo",
                                         device=dev.type,
                                         cfg_list=F32_TRAINING)
    figures["dryrun"]["s"] = time.perf_counter() - t0
    bmodel = _dp_model(bcfg, dev)
    _, _, bn_one_launches, _, grads = _dp_step(bcfg, bmodel, batch)
    bref_parts = _dp_parts(bmodel, grads)
    del bmodel, grads
    check(bn_one_launches == bn_expect,
          f"the one-process BatchNorm step launched {bn_one_launches}, "
          f"phase 11's {bn_expect}")
    floors = {"default": _dp_floor(cfg, batch, ref_parts, dev),
              "bn": _dp_floor(bcfg, batch, bref_parts, dev)}
    emodel = PointRCNN(cfg, mode="TEST", device=dev)
    emodel.load_state_dict(seeded_state_dict(emodel, SEED))
    pts = torch.from_numpy(random_scenes(
        DP_EVAL_BATCH, cfg.RPN.NUM_POINTS, SEED)).to(dev)
    with torch.no_grad():
        eref = {k: v.cpu() for k, v in make_infer_step(emodel, cfg)(
            pts).items() if k.startswith("final_")}
    del emodel, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        spawn(_dp_rank, DP_WORLD, tmp, run)
        figures["ranks_s"] = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(DP_WORLD)]
        ckpt = ranks[0]["ckpt"]
        model = _dp_model(cfg, dev)
        state = create_train_state(cfg, model, 100, 10)
        state, epoch = load_checkpoint(ckpt["path"], model, state)
        restored = _host_state(model)
        del model, state
    check(epoch == 1 and all(torch.equal(restored[k], ckpt["state"][k])
                             for k in restored),
          "the checkpoint written at world 2 restores at 1 unequal")
    kinds = {"grads": "summed gradients before the clip",
             "stats": "running statistics", "params": "parameters"}
    for name, want, expect in (("default", ref_parts, one_launches),
                               ("bn", bref_parts, bn_one_launches)):
        first = ranks[0][name]["state"]
        for r in ranks[1:]:
            diff = [k for k in first if not torch.equal(r[name]["state"][k],
                                                        first[k])]
            check(not diff, f"{name}: rank {r['rank']} differs from rank 0 "
                  f"in {diff[:3]}")
        for r in ranks:
            check(r[name]["launches"] == expect,
                  f"{name} rank {r['rank']} launched "
                  f"{r[name]['launches']}, {expect} in one process")
        figures[name] = {"loss": ranks[0][name]["loss"]}
        notes = []
        for kind, label in kinds.items():
            floor, top = floors[name][kind]
            diffs = _diffs(ranks[0][name]["parts"][kind], want[kind])
            # each gradient and statistic against its own floor; the
            # parameters against the largest: Adam's first step is nearly a
            # sign step, so a near-zero gradient whose sign a rounding
            # flips moves its parameter by up to 2·lr, in any tensor
            if kind == "params":
                floor = dict.fromkeys(floor, max(floor.values()))
            bounds = {k: 10 * floor[k] + 1e-5 * top for k in diffs}
            where = max(diffs, key=lambda k: diffs[k] / bounds[k])
            err, bound = diffs[where], bounds[where]
            figures[name][kind] = {"err": err, "where": where,
                                   "floor": floor[where], "bound": bound,
                                   "largest": max(diffs.values())}
            notes.append(f"{label}: nearest its bound {where}, {err:.3e} "
                         f"off, floor {floor[where]:.3e}, bound "
                         f"{bound:.3e}, margin {bound / max(err, 1e-30):.1f}x"
                         f" (largest difference {max(diffs.values()):.3e})")
            check(err <= bound, f"{name}: the {DP_WORLD}-rank step's {label} "
                  f"are off the one-process step's by {err:.3e} > "
                  f"{bound:.3e} in {where}")
        print(f"data-parallel (b) {name}: {DP_WORLD} gloo ranks on {card}, "
              f"parameters and running statistics equal across the ranks; "
              f"differences from the one-process step at B={TRAIN_BATCH}, "
              f"each tensor against its noise floor over {NUDGES} nudges "
              f"(bound 10 floors plus 1e-5 of the kind's largest entry): "
              f"{'; '.join(notes)}; launches per rank per step {expect}")
    got = ranks[0]["eval"]
    check(ranks[1]["eval"] is None, "rank 1 kept the gathered eval")
    check(torch.equal(torch.as_tensor(got["final_mask"]), eref["final_mask"])
          and bool(eref["final_mask"].any()),
          "the sharded eval keeps other final boxes than one process")
    mask = eref["final_mask"]
    box_err = (torch.as_tensor(got["final_boxes"])[mask]
               - eref["final_boxes"][mask]).abs().max().item()
    score_err = (torch.as_tensor(got["final_scores"])[mask]
                 - eref["final_scores"][mask]).abs().max().item()
    print(f"data-parallel (b) sharded joint eval at B={DP_EVAL_BATCH} "
          f"({DP_EVAL_BATCH // DP_WORLD} a rank): the same {int(mask.sum())} "
          f"final boxes kept as one process; largest box difference "
          f"{box_err:.3e}, score {score_err:.3e} (tolerance 1e-3)")
    check(box_err <= 1e-3 and score_err <= 1e-3,
          "the sharded eval's final boxes differ from one process's")
    r0 = ranks[0]
    figures.update({
        "gloo_world2_ms": r0["default"]["ms"],
        "peak_gib_per_rank": [r["default"]["peak_gib"] for r in ranks],
        "allreduce": r0["allreduce"], "eval_box_err": box_err,
        "ddp_launches": r0["default"]["launches"],
        "ddp_bn_launches": r0["bn"]["launches"],
        "s": time.perf_counter() - t_phase})
    print(f"data-parallel figures, {card} (not scaling figures: the ranks "
          f"share one card): ms/step at world 1 ({backend}) "
          f"{figures['nccl_world1_ms']:.1f}, at world {DP_WORLD} (gloo, "
          f"{TRAIN_BATCH // DP_WORLD} scenes a rank) "
          f"{figures['gloo_world2_ms']:.1f}; the gradients' all-reduce "
          f"({r0['allreduce']['floats']} floats through host memory under "
          f"gloo) {r0['allreduce']['ms']:.1f} ms; peak memory per rank "
          f"{', '.join(f'{g:.2f}' for g in figures['peak_gib_per_rank'])} "
          f"GiB; dryrun_multichip({DP_WORLD}) {figures['dryrun']['s']:.1f} "
          f"s, the ranks' run {figures['ranks_s']:.1f} s; phase "
          f"{figures['s']:.1f} s")
    return figures

PN_FRAMES = 8  # the demo's --synthetic dataset
STUDY_FRAMES = 8  # statnorm_effect at a smoke scale
STUDY_EPOCHS = 2
CYCLIST_FRAMES = 16
CYCLIST_BATCH = 4  # the study's --batch_size


def _counting(fn, into):
    """``fn`` wrapped so that each call appends (the launches it made, the
    f32 kernels' and the bf16 forms', its result) to ``into``."""
    from tpu3d_torch.ops import _build

    def counts():
        return {**_build.LAUNCHES, **_build.BF16_LAUNCHES}

    def counted(*a, **k):
        before = counts()
        out = fn(*a, **k)
        into.append(({n: c - before[n] for n, c in counts().items()
                      if c != before[n]}, out))
        return out

    return counted


def paper_slice(card: str) -> dict:
    """Phase 16: the slice of the paper's experiment. (a) The PointNet++
    demo's main on the card (--synthetic, one epoch), the launches of each
    of its train steps and eval batches exactly PN_TRAIN / PN_EVAL, its
    losses and IoU finite; (b) generate_aug_scene over phase 13's frames
    and GT database (aug_times 1), its files read back through the port's
    dataset and loader (with each pasted scene's label linked into label_2,
    where tpu3d's dataset reads it) into a batch on the card; (c)
    statnorm_effect at a smoke scale (STUDY_FRAMES frames, STUDY_EPOCHS
    epochs, smoke.yaml), its CLIs in subprocesses on the card:
    A_scaledto_B's car means within 0.01 m of B's, three AP tables of
    finite values; (d) configs/default_cyclist.yaml's class (CLASSES
    Cyclist, the cyclist-sized anchor) on quickstart.yaml: one joint train
    step at B=4 on multi-class frames from disk and one eval batch. ->
    the phase's figures."""
    import pickle
    import shutil

    import torch

    from tpu3d_torch.config import cfg_from_file, cfg_from_list, fresh_cfg
    from tpu3d_torch.datasets import (BatchLoader, KittiRCNNDataset,
                                      create_synthetic_kitti, device_prefetch)
    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.ops import _build
    from tpu3d_torch.parallel import create_train_state, make_train_step
    from tpu3d_torch.studies import multiclass_cyclist
    from tpu3d_torch.studies import statnorm_effect
    from tpu3d_torch.tools import pointnet2_demo as pn
    from tpu3d_torch.tools.eval_rcnn import make_infer_step
    from tpu3d_torch.tools.generate_aug_scene import AugSceneGenerator
    from tpu3d_torch.tools.train_rcnn import BATCH_KEYS
    work = ROOT / "build" / "paper_slice"
    shutil.rmtree(work, ignore_errors=True)
    figures = {"card": card}

    # (a) the PointNet++ demo, each train step's and eval batch's launches
    steps, evals = [], []
    make, iou = pn.make_train_step, pn.fg_iou
    contracts = []

    def counted_step(model, opt, precision):
        contracts.append(precision)
        return _counting(make(model, opt, precision), steps)

    pn.make_train_step = counted_step
    pn.fg_iou = _counting(iou, evals)
    t0 = time.perf_counter()
    _build.reset_launches()
    try:
        # the demo's own contracts, as a user runs it: the eval batches
        # under the card's eval contract, not this phase's TPU3D_F32_EVAL
        with f32_eval(False):
            demo_iou = pn.main(["--synthetic", "--epochs", "1",
                                "--output_dir", str(work / "pointnet2_demo"),
                                "--device", DEVICE])
            want = pn.demo_precision(DEVICE, True)
            eval_contract = pn.demo_precision(DEVICE, False)
    finally:
        pn.make_train_step, pn.fg_iou = make, iou
    demo_s = time.perf_counter() - t0
    launches = _launched()
    check(steps and evals, f"the demo ran {len(steps)} train steps and "
          f"{len(evals)} eval batches")
    check(contracts == [want] and want.sa_bf16 and want.fp_bf16
          and want.dense_dtype is None, f"the demo trained under "
          f"{contracts}, its contract {want}")
    check(eval_contract.fp_bf16 and not any(
        launches.get(k) for k in PN_F32_FORMS), f"the demo under "
        f"{eval_contract} at eval launched the f32 forms of "
        f"{PN_F32_FORMS}: {launches}")
    for got, _ in steps:
        check(got == PN_TRAIN, f"a demo train step launched {got}, "
              f"expected {PN_TRAIN}")
    for got, _ in evals:
        check(got == PN_EVAL, f"a demo eval batch launched {got}, expected "
              f"{PN_EVAL}")
    losses = [float(loss) for _, loss in steps]
    check(all(math.isfinite(x) for x in losses) and math.isfinite(demo_iou)
          and 0.0 <= demo_iou <= 1.0, f"demo losses {losses}, IoU {demo_iou}")
    figures["pointnet2_demo"] = {
        "s": demo_s, "train_steps": len(steps), "eval_batches": len(evals),
        "losses": losses, "fg_iou": demo_iou, "launches": launches,
        "per_train_step": PN_TRAIN, "per_eval_batch": PN_EVAL,
        "train_contract": str(want), "eval_contract": str(eval_contract)}
    print(f"PointNet++ demo on the card ({PN_FRAMES} synthetic frames, one "
          f"epoch, B=4, 1024 points): {len(steps)} train steps, "
          f"{len(evals)} eval batches in {demo_s:.1f} s, losses {losses}, "
          f"foreground IoU {demo_iou:.4f}; launches per train step "
          f"{PN_TRAIN}, per eval batch {PN_EVAL}, in all {launches}")

    # (b) offline GT augmentation over phase 13's frames and database
    cli = ROOT / "build" / "cli_smoke"
    data = cli / "data"
    with open(next((cli / "gt_database").glob("*.pkl")), "rb") as f:
        db = pickle.load(f)
    t0 = time.perf_counter()
    save = work / "aug_scene"
    split_file = AugSceneGenerator(str(data), db, split="train").\
        generate_aug_scene(str(save), aug_times=1)
    aug_s = time.perf_counter() - t0
    ids = Path(split_file).read_text().split("\n")
    pasted = [i for i in ids if int(i) >= 400000]
    check(len(pasted) * 2 == len(ids), f"{len(ids)} ids in {split_file}, "
          f"{len(pasted)} of them augmented")
    # a root that reads them: the frames, aug_scene/training, the split
    # list, and label_2 holding every frame's label and each pasted scene's
    root = work / "aug_root" / "KITTI"
    training = root / "object" / "training"
    (training / "label_2").mkdir(parents=True)
    (root / "aug_scene").mkdir()
    (root / "ImageSets").mkdir()
    src = data / "KITTI" / "object" / "training"
    for sub in src.iterdir():
        if sub.name != "label_2":
            (training / sub.name).symlink_to(sub)
    for f in (src / "label_2").iterdir():
        (training / "label_2" / f.name).symlink_to(f)
    for i in pasted:
        (training / "label_2" / f"{i}.txt").symlink_to(
            save / "aug_label" / f"{i}.txt")
    (root / "aug_scene" / "training").symlink_to(save)
    (root / "ImageSets" / "train_aug.txt").symlink_to(split_file)
    cfg = cfg_from_file(str(ROOT / "configs" / CLI_CFG), fresh_cfg())
    cfg.GT_AUG_ENABLED = False
    ds = KittiRCNNDataset(root_dir=str(root.parent), npoints=cfg.RPN.NUM_POINTS,
                          split="train_aug", mode="TRAIN", cfg=cfg)
    check(sorted(ds.sample_id_list) == sorted(int(i) for i in ids),
          "the dataset does not list every augmented scene")
    more = sum(len(ds.get_label(int(i))) > len(ds.get_label(int(i) % 400000))
               for i in pasted)
    check(more > 0, "no augmented scene holds more objects than its frame")
    batch = next(iter(device_prefetch(BatchLoader(ds, TRAIN_BATCH,
                                                  drop_last=True),
                                      keys=BATCH_KEYS, device=DEVICE)))
    check(batch["pts_input"].shape == (TRAIN_BATCH, cfg.RPN.NUM_POINTS, 3)
          and bool(torch.isfinite(batch["pts_input"]).all())
          and batch["pts_input"].device.type == DEVICE,
          "the augmented batch on the card")
    figures["aug_scene"] = {"s": aug_s, "scenes": len(ids),
                            "augmented": len(pasted),
                            "with_more_objects": more}
    print(f"generate_aug_scene over phase 13's {len(ids) - len(pasted)} "
          f"train frames (aug_times 1): {len(pasted)} augmented scenes in "
          f"{aug_s:.1f} s, {more} of them with pasted objects; read back "
          f"through KittiRCNNDataset (their labels linked into label_2) and "
          f"BatchLoader into a batch of {TRAIN_BATCH} on the card")

    # (c) statnorm_effect at a smoke scale, its CLIs on the card
    t0 = time.perf_counter()
    summary = statnorm_effect.main([
        "--out", str(work / "statnorm_effect"), "--frames",
        str(STUDY_FRAMES), "--epochs", str(STUDY_EPOCHS), "--cfg",
        str(ROOT / "configs" / "smoke.yaml"), "--device", DEVICE,
        *(["--set", *F32_TRAINING] if F32_TRAINING else [])])
    study_s = time.perf_counter() - t0
    a2b, b = summary["stats"]["A_scaledto_B"], summary["stats"]["B"]
    off = {k: abs(a2b[k]["mean"] - b[k]["mean"]) for k in a2b}
    check(max(off.values()) <= 0.01, f"A_scaledto_B's car means off B's by "
          f"{off}")
    check(len(summary["results"]) == 3 and all(
        math.isfinite(v) for r in summary["results"].values()
        for v in r.values()), f"statnorm_effect tables {summary['results']}")
    figures["statnorm_effect_smoke"] = {"s": study_s, "mean_off_m": off,
                                        **summary}
    print(f"statnorm_effect at {STUDY_FRAMES} frames, {STUDY_EPOCHS} "
          f"epochs, smoke.yaml, on the card: {study_s:.1f} s; A_scaledto_B's "
          f"car means off B's by {off} m; tables {summary['results']}")

    # (d) default_cyclist.yaml's class on quickstart.yaml
    t0 = time.perf_counter()
    croot = str(work / "cyclist")
    create_synthetic_kitti(croot, n_frames=CYCLIST_FRAMES, seed=21,
                           image_files=True,
                           extra_classes=("Pedestrian", "Cyclist"))
    ccfg = cfg_from_list(multiclass_cyclist.overrides("Cyclist", True),
                         cfg_from_file(str(ROOT / "configs" /
                                           "quickstart.yaml"), fresh_cfg()))
    cds = KittiRCNNDataset(root_dir=croot, npoints=ccfg.RPN.NUM_POINTS,
                           split="train", mode="TRAIN", classes=ccfg.CLASSES,
                           cfg=ccfg)
    cbatch = next(iter(device_prefetch(BatchLoader(
        cds, CYCLIST_BATCH, shuffle=True, drop_last=True), keys=BATCH_KEYS,
        device=DEVICE)))
    check(bool((cbatch["gt_boxes3d"].abs().sum(-1) > 0).any()),
          "the Cyclist batch holds no cyclist")
    tmodel = PointRCNN(ccfg, mode="TRAIN", device=DEVICE)
    tmodel.load_state_dict(train_weights(tmodel, SEED))
    state = create_train_state(ccfg, tmodel, 1, 1)
    _build.reset_launches()
    tb = make_train_step(ccfg, tmodel)(
        state, cbatch, torch.Generator(device=DEVICE).manual_seed(SEED), 0.9)
    _sync(torch.device(DEVICE))
    train_l = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(train_l == QUICK_TRAIN, f"the Cyclist train step launched "
          f"{train_l}, quickstart's step {QUICK_TRAIN}")
    check(math.isfinite(float(tb["loss"])) and
          math.isfinite(float(tb["grad_norm"])), f"Cyclist step {tb}")
    emodel = PointRCNN(ccfg, mode="TEST", device=DEVICE)
    emodel.load_state_dict({k: v for k, v in tmodel.state_dict().items()})
    _build.reset_launches()
    with torch.no_grad():
        out = make_infer_step(emodel, ccfg)(cbatch["pts_input"])
    _sync(torch.device(DEVICE))
    eval_l = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(eval_l == QUICK_EVAL, f"the Cyclist eval batch launched {eval_l}, "
          f"quickstart's {QUICK_EVAL}")
    check(bool(torch.isfinite(out["final_boxes"]).all()),
          "the Cyclist eval batch's boxes")
    cyc_s = time.perf_counter() - t0
    figures["cyclist"] = {"s": cyc_s, "loss": float(tb["loss"]),
                          "rcnn_loss": float(tb["rcnn_loss"]),
                          "final_boxes": int(out["final_mask"].sum())}
    print(f"default_cyclist.yaml's class on quickstart.yaml (CLASSES "
          f"{ccfg.CLASSES}, CLS_MEAN_SIZE {ccfg.CLS_MEAN_SIZE}): a joint "
          f"train step at B={CYCLIST_BATCH} from disk, loss "
          f"{float(tb['loss']):.4f}, and an eval batch, "
          f"{figures['cyclist']['final_boxes']} final boxes, the "
          f"quickstart launches; {cyc_s:.1f} s")
    del tmodel, emodel, state
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return figures


PEOPLE_FRAMES = 32  # two batches of 16 train frames' worth
ROOFLINE_EVAL_BATCH = 8  # tpu3d's roofline / bench eval batch
# csrc kernels of one default eval batch, by counted entry: (the entry's
# __global__ functions, as the profiler names them)
TRACE_KERNELS = {"fps3nn": ("fps_cluster_kernel", "three_nn_to_picks_kernel"),
                 "nearest_k": ("nearest_k_kernel",),
                 "three_interpolate": ("three_interpolate_kernel",),
                 "fps": ("fps_rows_kernel",),
                 "fused_sa": ("fused_sa_kernel",)}
LOADER_WORKERS = "1,2,4"
LOADER_SCENES = 32


def last_modules(card: str, eval_expect: dict, train_expect: dict) -> dict:
    """Phase 17: the last of tpu3d outside its bench. (a) default.yaml with
    RCNN.USE_INTENSITY set in memory: one joint eval batch (B=2) and one
    train step (B=16), with and without rpn_intensity (two models, each
    sized as tpu3d's tree is for its inputs), each launching phase 4's /
    phase 5's kernels exactly, its outputs finite; (b)
    configs/default_people.yaml as shipped: one joint train step (B=16)
    and one eval batch (B=2) from multi-class frames on disk
    (Pedestrian, Cyclist) read through the port's dataset with CLASSES
    People, the same launches; (c) tools/roofline on default.yaml: the
    analytic counts, FlopCounterMode's count and mfu_pct from this phase's
    median eval batch (B=8) and train step (B=16); (d)
    tools/probe_dispatch's four numbers; (e) one default eval batch (B=2)
    under torch.profiler, its Chrome trace read back by tools/parse_trace:
    each csrc kernel of TRACE_KERNELS seen as often as its entry launched
    (fps3nn 4, nearest_k 6, three_interpolate 4, fps 2, fused_sa 2), and no
    other csrc kernel; (f) tools/bench_loader over phase 13's frames,
    thread and process workers at 1, 2 and 4. -> the phase's figures."""
    import shutil

    import numpy as np
    import torch

    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.datasets import (BatchLoader, KittiRCNNDataset,
                                      create_synthetic_kitti, device_prefetch,
                                      random_scenes, train_batch)
    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.parallel import create_train_state, make_train_step
    from tpu3d_torch.tools import (bench_loader, parse_trace,
                                   probe_dispatch, roofline)
    from tpu3d_torch.tools.eval_rcnn import make_infer_step
    from tpu3d_torch.tools.train_rcnn import BATCH_KEYS
    from tpu3d_torch.weights import seeded_state_dict

    def launched(fn):
        """``fn()``'s result and the launches it made."""
        calls = []
        _counting(fn, calls)()
        return calls[0][1], calls[0][0]

    dev = torch.device(DEVICE)
    work = ROOT / "build" / "last_modules"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    figures = {"card": card}
    default = ROOT / "configs" / "default.yaml"

    def finite(out, label):
        bad = [k for k, v in out.items() if torch.is_tensor(v)
               and v.is_floating_point() and not bool(torch.isfinite(v).all())]
        check(not bad, f"{label}: not finite: {bad}")

    def train_once(cfg, model, batch, label):
        state = create_train_state(cfg, model, 1, 1)
        step = make_train_step(cfg, model)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        tb, got = launched(lambda: step(state, batch, gen, 0.9))
        check(got == train_expect, f"{label} launched {got}, phase 5's "
              f"step {train_expect}")
        check(math.isfinite(float(tb["loss"])) and
              math.isfinite(float(tb["grad_norm"])), f"{label}: {tb}")
        return {k: float(v) for k, v in tb.items() if k in (
            "loss", "rpn_loss", "rcnn_loss", "grad_norm")}

    def eval_once(cfg, model, pts, label, intensity=None):
        infer = make_infer_step(model, cfg)
        with torch.no_grad():
            out, got = launched(lambda: infer(pts, intensity))
        check(got == eval_expect, f"{label} launched {got}, phase 4's "
              f"{eval_expect}")
        finite(out, label)
        check(bool(out["final_mask"].any()), f"{label}: no final box")
        return int(out["final_mask"].sum())

    # (a) RCNN.USE_INTENSITY in the joint path
    t0 = time.perf_counter()
    icfg = cfg_from_file(str(default), fresh_cfg())
    icfg.RCNN.USE_INTENSITY = True
    n = icfg.RPN.NUM_POINTS
    rng = np.random.default_rng(SEED + 17)
    pts = torch.from_numpy(random_scenes(BATCH, n, SEED)).to(dev)
    tb_np = train_batch(TRAIN_BATCH, n, SEED)
    intensity = {"eval": torch.from_numpy(rng.random(
        (BATCH, n), dtype=np.float32)).to(dev),
        "train": torch.from_numpy(rng.random(
            (TRAIN_BATCH, n), dtype=np.float32)).to(dev)}
    runs = {}
    for given in (True, False):
        tag = "with" if given else "without"
        model = PointRCNN(icfg, mode="TEST", device=dev,
                          intensity_input=given)
        state = seeded_state_dict(model, SEED)
        model.load_state_dict(state)
        width = model.rcnn_net.merge_down.dense_0.weight.shape[1]
        check(width == 128 + (128 if given else 127),
              f"merge_down reads {width} channels {tag} rpn_intensity")
        finals = eval_once(icfg, model, pts, f"USE_INTENSITY eval {tag} "
                           "rpn_intensity",
                           intensity["eval"] if given else None)
        del model
        tmodel = PointRCNN(icfg, mode="TRAIN", device=dev,
                           intensity_input=given)
        tmodel.load_state_dict(train_weights(tmodel, SEED))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in tb_np.items()}
        if given:
            batch["rpn_intensity"] = intensity["train"]
        runs[tag] = {"merge_down_in": width, "final_boxes": finals,
                     **train_once(icfg, tmodel, batch,
                                  f"USE_INTENSITY train step {tag} "
                                  "rpn_intensity")}
        del tmodel, batch
        torch.cuda.empty_cache()
    figures["use_intensity"] = {"s": time.perf_counter() - t0, **runs}
    print(f"default.yaml with RCNN.USE_INTENSITY: eval B={BATCH} and a "
          f"train step B={TRAIN_BATCH}, with and without rpn_intensity, "
          f"each with phase 4's / phase 5's launches: {runs}")

    # (b) configs/default_people.yaml from multi-class frames on disk
    t0 = time.perf_counter()
    pcfg = cfg_from_file(str(ROOT / "configs" / "default_people.yaml"),
                         fresh_cfg())
    check(pcfg.CLASSES == "People" and pcfg.RPN.NUM_POINTS == 16384,
          f"default_people.yaml: CLASSES {pcfg.CLASSES}, "
          f"{pcfg.RPN.NUM_POINTS} points")
    proot = str(work / "people")
    create_synthetic_kitti(proot, n_frames=PEOPLE_FRAMES, seed=SEED + 17,
                           image_files=True,
                           extra_classes=("Pedestrian", "Cyclist"))
    frames_s = time.perf_counter() - t0
    tds = KittiRCNNDataset(root_dir=proot, npoints=pcfg.RPN.NUM_POINTS,
                           split="train", mode="TRAIN",
                           classes=pcfg.CLASSES, cfg=pcfg)
    pbatch = next(iter(device_prefetch(BatchLoader(
        tds, TRAIN_BATCH, shuffle=True, drop_last=True), keys=BATCH_KEYS,
        device=DEVICE)))
    people = int((pbatch["gt_boxes3d"].abs().sum(-1) > 0).sum())
    check(people > 0, "the People batch holds no pedestrian or cyclist")
    tmodel = PointRCNN(pcfg, mode="TRAIN", device=dev)
    tmodel.load_state_dict(train_weights(tmodel, SEED))
    ptrain = train_once(pcfg, tmodel, pbatch, "default_people.yaml train "
                        "step")
    emodel = PointRCNN(pcfg, mode="TEST", device=dev)
    emodel.load_state_dict(tmodel.state_dict())
    del tmodel, pbatch
    eds = KittiRCNNDataset(root_dir=proot, npoints=pcfg.RPN.NUM_POINTS,
                           split="val", mode="EVAL", classes=pcfg.CLASSES,
                           cfg=pcfg)
    ebatch = next(iter(device_prefetch(BatchLoader(eds, BATCH),
                                       keys=("pts_input",), device=DEVICE)))
    pfinal = eval_once(pcfg, emodel, ebatch["pts_input"],
                       "default_people.yaml eval")
    del emodel, ebatch
    torch.cuda.empty_cache()
    figures["default_people"] = {
        "s": time.perf_counter() - t0, "frames_s": frames_s,
        "frames": PEOPLE_FRAMES, "gt_people_in_batch": people,
        "final_boxes": pfinal, **ptrain}
    print(f"configs/default_people.yaml (CLASSES People) from "
          f"{PEOPLE_FRAMES} multi-class frames on disk: a joint train step "
          f"at B={TRAIN_BATCH} ({people} pedestrians and cyclists), "
          f"{ptrain}, and an eval batch at B={BATCH}, {pfinal} final "
          f"boxes, default.yaml's launches; "
          f"{figures['default_people']['s']:.1f} s")

    # (c) the roofline on default.yaml from this phase's own times
    t0 = time.perf_counter()
    rcfg = roofline.default_cfg(str(default))
    model = PointRCNN(rcfg, mode="TEST", device=dev)
    model.load_state_dict(seeded_state_dict(model, SEED))
    infer = make_infer_step(model, rcfg)
    epts = torch.from_numpy(random_scenes(ROOFLINE_EVAL_BATCH, n,
                                          SEED)).to(dev)
    with torch.no_grad():
        infer(epts)
        eval_ms = wall_ms(lambda: infer(epts), 5)
    del model, infer, epts
    tmodel = PointRCNN(rcfg, mode="TRAIN", device=dev)
    tmodel.load_state_dict(seeded_state_dict(tmodel, SEED))
    tstate = create_train_state(rcfg, tmodel, 100, 200)
    step = make_train_step(rcfg, tmodel)
    tbatch = {k: torch.from_numpy(v).to(dev) for k, v in tb_np.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step(tstate, tbatch, gen, 0.9)
    train_ms = wall_ms(lambda: step(tstate, tbatch, gen, 0.9), 3)
    del tmodel, tstate, step, tbatch
    torch.cuda.empty_cache()
    rows = roofline.report(rcfg, eval_ms, train_ms, ROOFLINE_EVAL_BATCH,
                           TRAIN_BATCH, device=DEVICE)
    for row in rows[:2]:
        check(row["mfu_pct"] > 0 and row["counted_tflop_per_step"] > 0,
              f"roofline row {row}")
    figures["roofline"] = {"s": time.perf_counter() - t0, "rows": rows}
    for row in rows:
        print(f"roofline: {json.dumps(row)}")

    # (d) the dispatch probe
    figures["probe_dispatch"] = probe_dispatch.probe(1.5, 20, DEVICE)
    print(f"probe_dispatch: {json.dumps(figures['probe_dispatch'])}")

    # (e) one profiled default eval batch, its trace read back
    t0 = time.perf_counter()
    dcfg = cfg_from_file(str(default), fresh_cfg())
    model = PointRCNN(dcfg, mode="TEST", device=dev)
    model.load_state_dict(seeded_state_dict(model, SEED))
    infer = make_infer_step(model, dcfg)
    with torch.no_grad():
        infer(pts)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if DEVICE == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            _, batch_launches = launched(lambda: infer(pts))
            if DEVICE == "cuda":
                torch.cuda.synchronize()
    trace = work / "profile" / "trace.json"
    trace.parent.mkdir()
    prof.export_chrome_trace(str(trace))
    del model, infer, prof
    summary = parse_trace.main([str(trace.parent), "--top", "12"])
    check(summary is not None, "the profiler's trace holds no device event")
    check(set(batch_launches) == set(TRACE_KERNELS), f"the profiled batch "
          f"launched {batch_launches}")
    want = {fn: batch_launches[entry] for entry, fns in TRACE_KERNELS.items()
            if entry in batch_launches for fn in fns}
    check(summary["port_counts"] == want, f"the trace's csrc kernels "
          f"{summary['port_counts']}, the batch's launches "
          f"{batch_launches} give {want}")
    figures["trace"] = {"s": time.perf_counter() - t0,
                        "port_counts": summary["port_counts"],
                        "total_ms": summary["total_ms"],
                        "groups": summary["groups"]}

    # (f) the loader bench over phase 13's frames
    t0 = time.perf_counter()
    figures["bench_loader"] = bench_loader.main([
        "--data_root", str(ROOT / "build" / "cli_smoke" / "data"),
        "--scenes", str(LOADER_SCENES), "--workers", LOADER_WORKERS])
    figures["bench_loader"]["s"] = time.perf_counter() - t0
    return figures


@contextlib.contextmanager
def f32_eval(on: bool):
    """TPU3D_F32_EVAL=1 around a block (``on``), or unset around it; the
    variable's value before is restored after."""
    before = os.environ.get("TPU3D_F32_EVAL")
    if on:
        os.environ["TPU3D_F32_EVAL"] = "1"
    else:
        os.environ.pop("TPU3D_F32_EVAL", None)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("TPU3D_F32_EVAL", None)
        else:
            os.environ["TPU3D_F32_EVAL"] = before


@contextlib.contextmanager
def record_calls(names, keep=lambda attr, args: True):
    """The arguments, detached, of every call the models make to the
    functions ``names`` maps (by their names in models/pointnet2.py) to
    kernel names, by kernel, where ``keep(attr, args)``."""
    import torch

    from tpu3d_torch.models import pointnet2 as pn

    calls = {name: [] for name in names.values()}
    saved = {attr: getattr(pn, attr) for attr in names}

    def recording(attr):
        def fn(*args):
            if keep(attr, args):
                calls[names[attr]].append(tuple(
                    a.detach() if torch.is_tensor(a) else a for a in args))
            return saved[attr](*args)
        return fn

    for attr in names:
        setattr(pn, attr, recording(attr))
    try:
        yield calls
    finally:
        for attr, fn in saved.items():
            setattr(pn, attr, fn)


def record_bf16_calls():
    """The arguments of every bf16 form the models call, by kernel."""
    return record_calls({"three_interpolate_bf16": "three_interpolate_bf16",
                         "fused_gathered_mlp_pool_bf16": "fused_sa_bf16",
                         "fused_mlp_pool_bf16": "fused_sa_slab_bf16",
                         "fused_bn_mlp_pool_bf16": "fused_sa_slab_bn_bf16"})


def _launched():
    """Every nonzero count, the f32 kernels' and the bf16 forms'."""
    from tpu3d_torch.ops import _build

    return {k: v for counts in (_build.LAUNCHES, _build.BF16_LAUNCHES)
            for k, v in counts.items() if v}


def contract_run(model, cfg, pts, f32: bool, label: str, record=False):
    """One joint eval batch through ``make_infer_step`` under the f32
    contract (``f32``: TPU3D_F32_EVAL=1) or the card's default, counts set
    to 0 just before and read just after -> dict(out, raw (the model's own
    outputs under the same contract), launches, ms (host clock, median of
    5), peak GiB, precision, calls (the bf16 forms' arguments, where
    ``record``))."""
    import torch

    from tpu3d_torch.ops import _build
    from tpu3d_torch.precision import resolve
    from tpu3d_torch.tools.eval_rcnn import make_infer_step

    with f32_eval(f32):
        prec = resolve(pts.device, cfg)
        infer = make_infer_step(model, cfg)
        infer(pts)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        with (record_bf16_calls() if record
              else contextlib.nullcontext({})) as calls:
            out = infer(pts)
            torch.cuda.synchronize()
        launches = _launched()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = wall_ms(lambda: infer(pts), 5)
        with torch.no_grad():
            raw = model({"pts_input": pts}, precision=prec)
    print(f"{label}, {'f32' if f32 else 'default'} contract ({prec}): "
          f"{ms:.1f} ms/batch, peak {peak:.2f} GiB, launches {launches}")
    return dict(out=out, raw=raw, launches=launches, ms=ms, peak=peak,
                precision=prec, calls=calls)


def _group_d_x0(form, args, g, arg, ppre, r, m):
    """A group's d_x0 (S x C1) in float64 with the bf16 backward's rounding
    points (x0, W1, b1, W2, dval and d_x1 rounded to bf16, x1 =
    bf16(bf16(a0 W1) + bf16(b1))), ``form`` "gather" or "slab"."""
    import torch

    def r16(x):
        return x.to(torch.bfloat16).double()

    if form == "gather":
        pre, idx, center = args[:3]
        x0 = r16(pre[r, idx[r, m].long()].double() - center[r, m].double())
    else:
        x0 = args[0][r, m].double()
    w1, b1, w2 = (r16(t.detach().double()) for t in
                  (args[-4], args[-3], args[-2]))
    x1 = r16(r16(x0.clamp(min=0) @ w1) + b1)
    dval = torch.where(ppre[r, m] > 0, g[r, m].double(), 0.0)
    D = torch.zeros(x0.shape[0], w2.shape[1], dtype=torch.float64,
                    device=x0.device)
    D[arg[r, m].long(), torch.arange(w2.shape[1], device=x0.device)] = \
        r16(dval)
    d_x1 = (D @ w2.T) * (x1 > 0)
    return (r16(d_x1) @ w1.T) * (x0 > 0)


def hold_bwd_outputs(form, args, g, arg, ppre, got, want, label) -> tuple:
    """Kernels 6 ("gather") and 8 ("slab")'s bf16 backward outputs ``got``
    against the plain version's ``want`` under the FLIP_ROWS rule: each
    output within BF16_FORM_BOUND of want's largest value but for at most
    FLIP_ROWS rows of d_x0 (slab), d_pre or d_center (gather), each of
    those within that bound of the float64 chain (_group_d_x0), each
    printed -> (the largest error outside those rows, the rows the float64
    chain held)."""
    import torch

    err, held = 0.0, 0
    for k, (a, b) in enumerate(zip(got, want)):
        e, sc = _rel_err(a, b)
        check(a.dtype == b.dtype, f"{label}: backward output {k} is "
              f"{a.dtype}, its plain version's {b.dtype}")
        if e <= BF16_FORM_BOUND * sc:
            err = max(err, e)
            continue
        check(k < (2 if form == "gather" else 1), f"{label}: backward "
              f"output {k} differs from its plain version's by {e} "
              f"(largest {sc})")
        rows_err = (a.float() - b.float()).abs().amax(-1)
        bad = (rows_err > BF16_FORM_BOUND * sc).nonzero().tolist()
        check(len(bad) <= FLIP_ROWS, f"{label}: backward output {k} "
              f"differs from its plain version's by {e} (largest {sc}) in "
              f"{len(bad)} rows")
        for row in bad:
            if form == "slab":
                r, m, s = row
                ref = _group_d_x0(form, args, g, arg, ppre, r, m)[s]
            elif k == 1:  # d_center
                r, m = row
                ref = -_group_d_x0(form, args, g, arg, ppre, r, m).sum(0)
            else:  # d_pre: the point's keys, bf16(d_x0) each
                r, n = row
                idx = args[1]
                keys = (idx[r] == n).nonzero().tolist()
                ref = sum(_group_d_x0(form, args, g, arg, ppre, r, m)[s]
                          .to(torch.bfloat16).double() for m, s in keys)
            ref = ref.to(torch.bfloat16).float()
            d = (a[tuple(row)].float() - ref).abs().max().item()
            check(d <= BF16_FORM_BOUND * sc, f"{label}: backward output "
                  f"{k} row {row} is {d} off the float64 chain (largest "
                  f"{sc}; the plain version {rows_err[tuple(row)].item()} "
                  f"off)")
            print(f"{label}: backward output {k} row {row}: the plain "
                  f"version {rows_err[tuple(row)].item():.4g} off (largest "
                  f"{sc:.4g}), the kernel {d:.4g} off the float64 chain")
            held += 1
        rest = rows_err.clone()
        for row in bad:
            rest[tuple(row)] = 0.0
        err = max(err, rest.max().item())
    return err, held


def _rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, max |b|)."""
    return ((a.float() - b.float()).abs().max().item(),
            b.float().abs().max().item())


def detections_summary(a, b) -> dict:
    """How the final boxes of run ``a`` sit against run ``b``'s: counts,
    and the share of ``a``'s boxes with a box of ``b`` in the same scene
    whose center lies within 0.1 m."""
    import torch

    n_a, n_b = int(a["final_mask"].sum()), int(b["final_mask"].sum())
    near = 0
    for s in range(a["final_mask"].shape[0]):
        ca = a["final_boxes"][s][a["final_mask"][s]][:, :3]
        cb = b["final_boxes"][s][b["final_mask"][s]][:, :3]
        if len(ca) and len(cb):
            near += int((torch.cdist(ca, cb).amin(dim=1) <= 0.1).sum())
    return {"final_boxes": n_a, "f32_final_boxes": n_b,
            "share_within_0.1m": near / max(n_a, 1)}


def compare_contracts(model, bf, f32, label, rpn_bound) -> dict:
    """(b) / (c): the bf16 run's RPN outputs against the f32 run's, and the
    RCNN stage under the bf16 run's contract fed the f32 run's backbone
    outputs, raw scores and rois against the f32 run's RCNN outputs."""
    import torch

    figures = {}
    for key in ("rpn_cls", "rpn_reg"):
        err, scale = _rel_err(bf["raw"][key], f32["raw"][key])
        figures[key] = {"max_abs_err": err, "max_abs": scale}
        check(err <= rpn_bound * scale, f"{label}: {key} under the default "
              f"contract differs from the f32 run's by {err} (largest "
              f"{scale}, bound {rpn_bound} of it)")
    r = f32["raw"]
    with torch.no_grad():
        stage = model.rcnn_stage(r["backbone_xyz"], r["backbone_features"],
                                 r["rpn_cls"][..., 0], r["rois"],
                                 precision=bf["precision"])
    for key in ("rcnn_cls", "rcnn_reg"):
        err, scale = _rel_err(stage[key], r[key])
        figures[key] = {"max_abs_err": err, "max_abs": scale}
        check(err <= CONTRACT_BOUND * scale, f"{label}: the RCNN stage's "
              f"{key} on the f32 run's inputs differs by {err} (largest "
              f"{scale}, bound {CONTRACT_BOUND} of it)")
    figures["detections"] = detections_summary(bf["out"], f32["out"])
    print(f"{label}: default contract against f32: " + ", ".join(
        f"{k} {v['max_abs_err']:.3e} of {v['max_abs']:.3e}"
        for k, v in figures.items() if k != "detections")
        + f"; detections {figures['detections']}")
    return figures


def eval_bf16_design(c1, c2, c3, where, bn=False):
    """The design a bf16 eval entry runs widths c1 -> c2 -> c3 on, as its C
    entry decides it (kernels 5 and 8: ``tpu3d_fused_sa_bf16_design``;
    ``bn``, kernel 9: ``tpu3d_fused_sa_slab_bn_bf16_design``), held to
    ``fused_sa.eval_bf16_design``."""
    import ctypes

    from tpu3d_torch.ops import _build
    from tpu3d_torch.ops.fused_sa import eval_bf16_design as design

    lib = _build.library("fused_sa")
    fn = (lib.tpu3d_fused_sa_slab_bn_bf16_design if bn
          else lib.tpu3d_fused_sa_bf16_design)
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    got = "wgmma" if fn(c1, c2, c3) else "parent"
    check(got == design(c1, c2, c3, bn), f"{where}: the C entry and "
          f"eval_bf16_design disagree on {c1} -> {c2} -> {c3}"
          f"{' with BatchNorm' if bn else ''}")
    return got


def shipped_eval_designs() -> dict:
    """The eval forms' design at every RCNN level the five shipped configs
    fuse at eval (B=2), without BatchNorm as shipped and with RCNN.USE_BN
    set (kernel 9's form, route "bn"), from the C entries: each must be
    the wgmma design -> {config: [(level, route, design)]}."""
    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.ops.fused_sa import sa_route

    out = {}
    for name in ("default", "double", "quickstart", "smoke",
                 "default_people"):
        cfg = cfg_from_file(str(ROOT / "configs" / f"{name}.yaml"),
                            fresh_cfg())
        sa = cfg.RCNN.SA_CONFIG
        n, R = cfg.RCNN.NUM_POINTS, BATCH * cfg.TEST.RPN_POST_NMS_TOP_N
        rows = []
        for bn in dict.fromkeys((bool(cfg.RCNN.USE_BN), True)):
            n = cfg.RCNN.NUM_POINTS
            for k, m in enumerate(sa.NPOINTS):
                if m == -1:
                    break
                mlp = list(sa.MLPS[k])
                route = sa_route((R, m, sa.NSAMPLE[k], mlp[0]), mlp, n, bn)
                if route in ("gather", "slab"):
                    design = eval_bf16_design(*mlp, f"{name}.yaml SA_{k}",
                                              bn=bn)
                    check(design == "wgmma", f"{name}.yaml RCNN SA_{k} "
                          f"({mlp}{', USE_BN' if bn else ''}) runs the eval "
                          f"forms' parent design")
                    rows.append((f"RCNN SA_{k}", "bn" if bn else route,
                                 design))
                n = m
        check(rows, f"{name}.yaml fuses no RCNN level at eval")
        out[name] = rows
    print(f"the bf16 eval forms' design at the shipped configs' fused "
          f"levels: {out}")
    return out


def bf16_form_rows(report, calls, where):
    """(a): each recorded call of a bf16 form against its plain version,
    timed beside the plain version, its library chain in bf16 (cuBLAS for
    the products) and its f32 form on the same values; the fused forms
    twice equal to the bit, kernels 5, 8 and 9 on the design their C entry
    names (the wgmma design at every call of the shipped configs), at the
    path ``where``."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import fused_sa as fs
    from tpu3d_torch.ops import interpolate as ip
    from tpu3d_torch.ops.grouping import group_points

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    bf = torch.bfloat16
    for args in calls.get("three_interpolate_bf16", []):
        feats, idx, w, round_w = args
        got = ip.three_interpolate_bf16(*args)
        ref = ip.three_interpolate_bf16_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), "three_interpolate_bf16 differs from "
              "its plain version")
        B, N, C = feats.shape
        M = idx.shape[1]
        f32f = feats.float()
        flat = idx.reshape(B, M * 3).long()[..., None].expand(-1, -1, C)
        w16 = w.to(bf)[..., None]
        ms = cuda_ms(lambda: ip.three_interpolate_bf16(*args), 20)
        pms = cuda_ms(lambda: ip.three_interpolate_bf16_plain(*args), 5)
        lms = cuda_ms(lambda: (torch.gather(feats, 1, flat).view(
            B, M, 3, C) * w16).sum(2), 20)
        fms = cuda_ms(lambda: ip.three_interpolate_forward(f32f, idx, w), 20)
        nbytes = 2 * B * N * C + 24 * B * M + (2 if round_w else 4) * B * M * C
        report.add("three_interpolate_bf16", 0.0, ms, pms, lms, nbytes,
                   5 * B * M * C, f32_ms=fms)
        print(f"three_interpolate_bf16 B={B} N={N} M={M} C={C} "
              f"round_w={round_w}: {ms:.4f} ms (f32 form {fms:.4f}), plain "
              f"{pms:.3f}, gather+sum in bf16 {lms:.4f}; equal to the bit")

    def fused_row(name, got, again, ref, ms, pms, lms, fms, R, M, S, c1, c2,
                  c3, in_bytes):
        err, scale = _rel_err(got, ref)
        check(err <= BF16_FORM_BOUND * scale, f"{name} at {where} differs "
              f"from its plain version by {err} (largest {scale})")
        check(torch.equal(got, again), f"{name} at {where}: two calls "
              f"differ")
        design = eval_bf16_design(c1, c2, c3, f"{name} at {where}",
                                  bn=name == "fused_sa_slab_bn_bf16")
        check(design == "wgmma", f"{name} at {where} ({c1} -> {c2} -> "
              f"{c3}) ran the parent design")
        counts = {"wgmma_calls": 1.0, "parent_calls": 0.0}
        design = f" on the {design} design"
        ops = R * M * S * (2 * (c1 * c2 + c2 * c3) + 2 * c1 + 2 * c2 + 3 * c3)
        nbytes = in_bytes + 2 * (c1 * c2 + c2 * c3 + c2 + c3 + R * M * c3)
        report.add(name, err, ms, pms, lms, nbytes, ops, f32_ms=fms,
                   **counts)
        print(f"{name} at {where} R={R} M={M} S={S} C={c1}->{c2}->{c3}"
              f"{design}: {ms:.4f} ms (f32 form {fms:.4f}), plain {pms:.3f}, "
              f"bf16 cuBLAS chain {lms:.4f}, max_abs_err {err:.3e} of "
              f"{scale:.3e}, twice equal, {ops / ms / 1e9:.1f} TFLOP/s")

    with torch.no_grad():
        for args in calls.get("fused_sa_bf16", []):
            pre, idx, center, w1, b1, w2, b2 = args
            R, M, S = idx.shape
            c1, c2, c3 = w1.shape[0], w1.shape[1], w2.shape[1]
            got = fs.fused_gathered_mlp_pool_bf16(*args)
            ref = fs.fused_gathered_mlp_pool_bf16_plain(*args)
            w1t, w2t = w1.T.to(bf).contiguous(), w2.T.to(bf).contiguous()
            b1h, b2h = b1.to(bf), b2.to(bf)

            def library():
                x = torch.relu(group_points(pre, idx) - center[:, :, None])
                x = torch.relu(F.linear(x, w1t, b1h))
                return torch.relu(F.linear(x, w2t, b2h)).amax(2)

            f32a = (pre.float(), idx, center.float(), w1.contiguous(), b1,
                    w2.contiguous(), b2)
            fused_row(
                "fused_sa_bf16", got, fs.fused_gathered_mlp_pool_bf16(*args),
                ref,
                cuda_ms(lambda: fs.fused_gathered_mlp_pool_bf16(*args), 10),
                cuda_ms(lambda: fs.fused_gathered_mlp_pool_bf16_plain(*args),
                        3),
                cuda_ms(library, 5),
                cuda_ms(lambda: fs.fused_gathered_mlp_pool(*f32a), 10),
                R, M, S, c1, c2, c3,
                2 * (pre.numel() + center.numel()) + 4 * idx.numel())
        for args in calls.get("fused_sa_slab_bf16", []):
            x0, w1, b1, w2, b2 = args
            R, M, S, c1 = x0.shape
            c2, c3 = w1.shape[1], w2.shape[1]
            got = fs.fused_mlp_pool_bf16(*args)
            ref = fs.fused_mlp_pool_bf16_plain(*args)
            w1t, w2t = w1.T.to(bf).contiguous(), w2.T.to(bf).contiguous()
            b1h, b2h = b1.to(bf), b2.to(bf)

            def library():
                x = torch.relu(F.linear(torch.relu(x0), w1t, b1h))
                return torch.relu(F.linear(x, w2t, b2h)).amax(2)

            f32a = (x0.float(), w1.contiguous(), b1, w2.contiguous(), b2)
            fused_row(
                "fused_sa_slab_bf16", got, fs.fused_mlp_pool_bf16(*args), ref,
                cuda_ms(lambda: fs.fused_mlp_pool_bf16(*args), 10),
                cuda_ms(lambda: fs.fused_mlp_pool_bf16_plain(*args), 3),
                cuda_ms(library, 5),
                cuda_ms(lambda: fs.fused_mlp_pool(*f32a), 10),
                R, M, S, c1, c2, c3, 2 * x0.numel())
        for args in calls.get("fused_sa_slab_bn_bf16", []):
            x0, w1, w2, gammas, betas, stats, eps = args
            R, M, S, c1 = x0.shape
            c2, c3 = w1.shape[1], w2.shape[1]
            got = fs.fused_bn_mlp_pool_bf16(*args)
            packs = fs.bn_packs([fs._bn_affine(m, v, g, b, eps)[:2] for
                                 (m, v), g, b in zip(stats, gammas, betas)])
            ref = fs.fused_sa_slab_bn_bf16_plain(x0, packs, w1, w2)
            w1t, w2t = w1.T.to(bf).contiguous(), w2.T.to(bf).contiguous()
            pk = [t.to(bf) for t in packs.split([c1, c1, c2, c2, c3, c3])]

            def library():
                x = torch.relu(x0 * pk[0] + pk[1])
                x = torch.relu(F.linear(x, w1t) * pk[2] + pk[3])
                return torch.relu(F.linear(x, w2t) * pk[4] + pk[5]).amax(2)

            f32a = (x0.float(), w1.contiguous(), w2.contiguous(), gammas,
                    betas, stats, eps)
            fused_row(
                "fused_sa_slab_bn_bf16", got, fs.fused_bn_mlp_pool_bf16(*args),
                ref,
                cuda_ms(lambda: fs.fused_bn_mlp_pool_bf16(*args), 10),
                cuda_ms(lambda: fs.fused_sa_slab_bn_bf16_plain(
                    x0, packs, w1, w2), 3),
                cuda_ms(library, 5),
                cuda_ms(lambda: fs.fused_bn_mlp_pool(*f32a), 10),
                R, M, S, c1, c2, c3, 2 * x0.numel() + 8 * (c1 + c2 + c3))
            signed_bn_eval(x0, w1, w2, where)


def signed_bn_eval(x0, w1, w2, where):
    """Kernel 9's eval form at a path's shape on running statistics whose
    folded scales take every sign and zero at each layer (a negative mul2
    pools the min of x2; the seeded model's are all positive), its weights
    as contiguous bf16 (C1, C2) tensors: within BF16_FORM_BOUND of its
    plain version, twice equal to the bit."""
    import torch

    from tpu3d_torch.ops import fused_sa as fs
    from tpu3d_torch.tools.kernel_bench import bn_eval_layers

    R, M, S, c1 = x0.shape
    c2, c3 = w1.shape[1], w2.shape[1]
    g = torch.Generator(device=x0.device).manual_seed(R * M + c3)
    gammas, betas, stats = bn_eval_layers(g, (c1, c2, c3))
    packs = fs.bn_packs([fs._bn_affine(m, v, ga, be, 1e-5)[:2] for
                         (m, v), ga, be in zip(stats, gammas, betas)])
    mul2 = packs[2 * (c1 + c2):2 * (c1 + c2) + c3]
    check(bool((mul2 < 0).any() and (mul2 > 0).any() and (mul2 == 0).any()),
          f"{where}: the signed scales lack a sign")
    w1h, w2h = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    args = (x0, w1h, w2h, gammas, betas, stats)
    got = fs.fused_bn_mlp_pool_bf16(*args)
    again = fs.fused_bn_mlp_pool_bf16(*args)
    ref = fs.fused_sa_slab_bn_bf16_plain(x0, packs, w1h.float(), w2h.float())
    torch.cuda.synchronize()
    err, scale = _rel_err(got, ref)
    check(err <= BF16_FORM_BOUND * scale, f"fused_sa_slab_bn_bf16 at {where} "
          f"with scales of every sign differs from its plain version by "
          f"{err} (largest {scale})")
    check(torch.equal(got, again), f"fused_sa_slab_bn_bf16 at {where} with "
          f"scales of every sign: two calls differ")
    print(f"fused_sa_slab_bn_bf16 at {where} R={R} M={M} S={S} "
          f"C={c1}->{c2}->{c3}, folded scales of every sign "
          f"({int((mul2 < 0).sum())} of layer 2's {c3} negative, "
          f"{int((mul2 == 0).sum())} zero), bf16 weights: max_abs_err "
          f"{err:.3e} of {scale:.3e}, twice equal")


def eval_numerics(card: str) -> tuple[Report, dict, dict]:
    """Phase 18 (the module docstring says what it holds) -> (the bf16
    forms' report, their launches on the path each is labelled with, the
    numbers for the JSON line)."""
    import torch

    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.datasets import random_scenes
    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.ops import _build
    from tpu3d_torch.tools.eval_rcnn import main as eval_main
    from tpu3d_torch.tools.eval_rcnn import make_infer_step
    from tpu3d_torch.utils.checkpoint import latest_checkpoint
    from tpu3d_torch.weights import seeded_state_dict

    dev = torch.device(DEVICE)
    default = cfg_from_file(str(ROOT / "configs" / "default.yaml"),
                            fresh_cfg())
    bn = copy.deepcopy(default)
    bn.RCNN.USE_BN = True
    dense = copy.deepcopy(default)
    dense.BF16_INFERENCE = True
    # (label, cfg, batch, the bf16 forms whose calls the kernels line's row
    # takes from this path, those held and timed at this path apart)
    cases = [
        ("default.yaml eval B=2", default, BATCH,
         ("three_interpolate_bf16", "fused_sa_bf16"), ()),
        ("double.yaml eval B=4", cfg_from_file(
            str(ROOT / "configs" / "double.yaml"), fresh_cfg()),
         DOUBLE_BATCH, (), ("fused_sa_bf16",)),
        (QUICK_PATH["eval"], cfg_from_file(
            str(ROOT / "configs" / "quickstart.yaml"), fresh_cfg()),
         QUICK_EVAL_BATCH, ("fused_sa_slab_bf16",), ("fused_sa_bf16",)),
        (SMOKE_PATH["eval"], cfg_from_file(
            str(ROOT / "configs" / "smoke.yaml"), fresh_cfg()),
         SMOKE_BATCH, (), ("fused_sa_bf16", "fused_sa_slab_bf16")),
        (BN_PATH, bn, BN_BATCH, ("fused_sa_slab_bn_bf16",), ())]
    report = Report(peak_ops=PEAK_BF16_OPS_PER_S)
    launches, figures, calls = {}, {"card": card, "configs": {}}, {}
    figures["eval_bf16_designs"] = shipped_eval_designs()
    path_calls = {}  # label: {form: calls held at that path apart}
    for label, cfg, batch, keep, apart in cases:
        model = PointRCNN(cfg, mode="TEST", device=dev)
        model.load_state_dict(seeded_state_dict(model, SEED))
        pts = torch.from_numpy(random_scenes(batch, cfg.RPN.NUM_POINTS,
                                             SEED)).to(dev)
        f32 = contract_run(model, cfg, pts, True, label)
        bf = contract_run(model, cfg, pts, False, label,
                          record=bool(keep or apart))
        check_joint_outputs(cfg, bf["out"], batch, f"{label} (default "
                            f"contract)")
        # every f32 launch of a kernel with a bf16 form is the bf16 form's
        want = {BF16_OF.get(k, k): v for k, v in f32["launches"].items()}
        check(bf["launches"] == want, f"{label}: default contract launches "
              f"{bf['launches']}, expected {want}")
        check(any(k in bf["launches"] for k in BF16_SOURCES),
              f"{label}: no bf16 form launched")
        row = compare_contracts(model, bf, f32, label, CONTRACT_BOUND)
        # (d) the walls in turns: f32, default, then default, f32
        turns = {"f32": [f32["ms"]], "bf16": [bf["ms"]]}
        for on, key in ((False, "bf16"), (True, "f32")):
            with f32_eval(on):
                infer = make_infer_step(model, cfg)
                turns[key].append(wall_ms(lambda: infer(pts), 5))
        print(f"{label} ({card}): ms/batch in turns f32 {turns['f32'][0]:.1f}"
              f", default {turns['bf16'][0]:.1f}, default "
              f"{turns['bf16'][1]:.1f}, f32 {turns['f32'][1]:.1f}; peak "
              f"{bf['peak']:.2f} GiB (f32 {f32['peak']:.2f})")
        row.update({
            "launches": bf["launches"], "f32_launches": f32["launches"],
            "ms_turns": turns["bf16"], "f32_ms_turns": turns["f32"],
            "peak_gib": bf["peak"], "f32_peak_gib": f32["peak"],
            "precision": str(bf["precision"])})
        figures["configs"][label] = row
        for name in keep:
            calls[name] = bf["calls"][name]
            launches[name] = bf["launches"].get(name, 0)
        if apart:
            path_calls[label] = {name: bf["calls"][name] for name in apart}
        if cfg is default:
            f32_default = f32
            # (c) BF16_INFERENCE: true at default.yaml, under the default
            # contract against the f32 run, and under TPU3D_F32_EVAL=1
            # (bf16 Dense layers, no casts: the plain route, the
            # interpolation's bf16 form without rounded weights)
            dmodel = PointRCNN(dense, mode="TEST", device=dev)
            dmodel.load_state_dict(model.state_dict())
            dbf = contract_run(dmodel, dense, pts, False,
                               "default.yaml BF16_INFERENCE")
            check_joint_outputs(dense, dbf["out"], batch,
                                "default.yaml BF16_INFERENCE")
            check(dbf["launches"] == bf["launches"], f"BF16_INFERENCE "
                  f"launches {dbf['launches']}, expected {bf['launches']}")
            drow = compare_contracts(dmodel, dbf, f32_default,
                                     "default.yaml BF16_INFERENCE",
                                     DENSE_RPN_BOUND)
            dplain = contract_run(dmodel, dense, pts, True,
                                  "default.yaml BF16_INFERENCE")
            check(all(k not in dplain["launches"] for k in (
                "fused_sa", "fused_sa_bf16", "three_interpolate")),
                f"BF16_INFERENCE under TPU3D_F32_EVAL=1 launched "
                f"{dplain['launches']}")
            drow.update({"launches": dbf["launches"], "ms": dbf["ms"],
                         "peak_gib": dbf["peak"],
                         "f32_eval_launches": dplain["launches"],
                         "f32_eval_ms": dplain["ms"],
                         "f32_eval_peak_gib": dplain["peak"],
                         "precision": str(dbf["precision"])})
            figures["bf16_inference"] = drow
            del dmodel, dbf, dplain
        del model, f32, bf, pts
        torch.cuda.empty_cache()
    del f32_default

    # (a) each bf16 form at the recorded calls: the rows' paths, then
    # kernels 5 and 8 at the other paths' calls, each path's report apart
    bf16_form_rows(report, calls, "its row's path")
    del calls
    path_reports = {}
    for label, held in path_calls.items():
        path_reports[label] = Report(peak_ops=PEAK_BF16_OPS_PER_S)
        bf16_form_rows(path_reports[label], held, label)
    del path_calls
    torch.cuda.empty_cache()

    # (e) the eval CLI, joint, under the default contract on phase 13's
    # frames and checkpoint
    work = ROOT / "build" / "cli_smoke"
    ckpt = latest_checkpoint(str(work / "a" / "ckpt"))
    check(ckpt is not None, "phase 13 left no checkpoint")
    n_batches = -(-CLI_FRAMES // EVAL_CLI_BATCH)
    with f32_eval(False):
        _build.reset_launches()
        t0 = time.perf_counter()
        res = eval_main([
            "--cfg_file", str(ROOT / "configs" / CLI_CFG), "--eval_mode",
            "joint", "--data_root", str(work / "data"), "--batch_size",
            str(EVAL_CLI_BATCH), "--output_dir",
            str(ROOT / "build" / "eval_smoke" / "joint_bf16"), "--device",
            DEVICE, "--ckpt", ckpt, "--set", "TEST.SPLIT", "trainval"])
        call_s = time.perf_counter() - t0
    cli_launches = _launched()
    want = {BF16_OF.get(k, k): v * n_batches for k, v in EVAL_CLI.items()}
    check(cli_launches == want, f"eval CLI under the default contract "
          f"launched {cli_launches}, expected {want}")
    figures["eval_cli"] = {
        "path": f"{CLI_CFG} joint B={EVAL_CLI_BATCH}, {CLI_FRAMES} frames",
        "scenes_per_s": res["scenes_per_sec"], "call_s": call_s,
        "launches": cli_launches}
    print(f"eval CLI under the default contract ({card}): "
          f"{res['scenes_per_sec']:.2f} scenes/s after the first batch, "
          f"launches {cli_launches}")
    figures["bf16_at_paths"] = {
        label: {name: {"launches": figures["configs"][label][
            "launches"].get(name, 0), **rep.row(name)} for name in rep.rows}
        for label, rep in path_reports.items()}
    return report, launches, figures


# --------------------------------------------------------------------------
# phase 19: the training numerics contract
# --------------------------------------------------------------------------

# phases 1-18 train under the f32 training contract: both keys False in
# every config this process makes (f32_training) and, for the subprocesses
# that make their own (the data-parallel ranks, dryrun_multichip's, the
# study's CLIs), as --set overrides (F32_TRAINING while it holds)
F32_TRAIN_SETS = ["TRAIN.BF16_ACTIVATIONS", "False",
                  "TRAIN.BF16_MATMULS", "False"]
F32_TRAINING: list = []
# the f32 kernel each bf16 training form takes over under the card's
# default training contract, one launch for one
BF16_TRAIN_OF = {"fused_sa_train": "fused_sa_train_bf16",
                 "fused_sa_bwd": "fused_sa_bwd_bf16",
                 "fused_sa_slab_train": "fused_sa_slab_train_bf16",
                 "fused_sa_slab_bwd": "fused_sa_slab_bwd_bf16",
                 "three_interpolate": "three_interpolate_bf16",
                 "three_interpolate_bwd": "three_interpolate_bwd_bf16"}
TRAIN_FORMS = ("fused_sa_train_bf16", "fused_sa_bwd_bf16",
               "fused_sa_slab_train_bf16", "fused_sa_slab_bwd_bf16",
               "three_interpolate_bwd_bf16", "group_points_bwd_bf16")
# phase 19's rule for kernels 6 and 8's bf16 backward (hold_bwd_outputs):
# each output within BF16_FORM_BOUND of the plain version's largest value,
# but for at most FLIP_ROWS rows of d_x0, d_pre or d_center, each of which
# must then be within that bound of a float64 evaluation of the chain at
# the same rounding points. The two sides sum their f32 products in other
# orders, and where bf16(a0 W1) + bf16(b1) lies within a bf16 step of 0
# (the seeded biases are drawn at 0.01) one x1 can land on the other side
# of the ReLU; the flip moves a whole d_a1 value through W1 into that row
# (the default step's SA_1 has such a row of d_center, where the kernel
# equals the float64 chain and the plain version does not: each held row
# is printed)
FLIP_ROWS = 16
# phase 19's bounds, stated before its first run. Kernels 6 and 8 in their
# bf16 training forms against their plain versions: the forward and each
# gradient within BF16_FORM_BOUND of the plain one's largest value (their
# f32 sums run in another order, so an x1, x2 or d_x1 can round to the other
# bf16 neighbour: a step or two; the gradients' rows where such an x1
# crosses the ReLU under FLIP_ROWS below), the first argmax on another slot for at
# most ARGMAX_FLIP_BOUND of the pooled channels (where such a step makes or
# breaks a tie); kernel 7's and the gather's bf16 backward equal to their
# CPU plain versions to the bit (exact products, the same f32 sums in the
# same order). A train step under the card's default contract against the
# f32 one from the same weights, batch and draws: the RPN loss within
# RPN_LOSS_BOUND of the f32 step's and the whole loss within
# TRAIN_LOSS_BOUND (bf16 activations move the proposals a little, and with
# them the RCNN's sampled ROIs)
ARGMAX_FLIP_BOUND = 1e-2
RPN_LOSS_BOUND = 0.02
TRAIN_LOSS_BOUND = 0.1
TRAIN_NUMERICS_CONFIGS = (  # (label, config file, batch)
    ("default.yaml train B=16", "default.yaml", TRAIN_BATCH),
    ("double.yaml train B=16", "double.yaml", TRAIN_BATCH),
    (QUICK_PATH["train"], "quickstart.yaml", QUICK_TRAIN_BATCH),
    (SMOKE_PATH["train"], "smoke.yaml", SMOKE_BATCH))
# the path each bf16 training form is timed and labelled at (the slab
# forms also at smoke's, kept apart)
TRAIN_FORM_PATHS = {"fused_sa_train_bf16": "default.yaml train B=16",
                    "fused_sa_bwd_bf16": "default.yaml train B=16",
                    "three_interpolate_bwd_bf16": "default.yaml train B=16",
                    "group_points_bwd_bf16": "default.yaml train B=16",
                    "fused_sa_slab_train_bf16": QUICK_PATH["train"],
                    "fused_sa_slab_bwd_bf16": QUICK_PATH["train"]}
# kernel 9's training form on bf16 slabs, pass for pass: the seven f32
# passes' bf16 entries, in fused_sa_bn.cu beside them, timed and labelled at
# the BatchNorm RCNN's train step
BN_BF16_FORMS = tuple(f"{k}_bf16" for k in BN_TRAIN_KERNELS)
BF16_TRAIN_OF.update(zip(BN_TRAIN_KERNELS, BN_BF16_FORMS))
TRAIN_FORM_PATHS.update({k: BN_TRAIN_PATH for k in BN_BF16_FORMS})
# (f)'s bounds for kernel 9's bf16 form. Each entry against its plain
# piece on the same inputs (``bn_pass_rows``): its bf16 slabs (x1, x2,
# d_x0) within one bf16 step of each value and off at all in at most
# BN_SLAB_FLIP_BOUND of the values (exact products, f32 sums in another
# order: a sum at a rounding boundary takes the other neighbour), its f32
# slabs (d_y1, d_y0) within 1e-4 of the largest value and its reductions
# and weight gradients within 1e-3 (f32 sums of n exact products in
# another order), the statistics passes' sums as the f32 form's, the final
# pass equal to the bit. The whole op on BN_CHECK_ROWS rows against
# autograd of the repaired plain form, which folds each layer into x·mul +
# add as tpu3d's kernels and these do: the output off in at most
# ARGMAX_FLIP_BOUND of the values and beyond one bf16 step of each value's
# own in at most BN_SLAB_FLIP_BOUND (an x2 rounded to the other neighbour
# moves its pre-activation by mul times x2's step, which near 0 is many of
# the output's own steps), the argmax off in at most ARGMAX_FLIP_BOUND of
# the channels and d_x0 beyond BF16_FORM_BOUND of its largest value in at
# most that share of the slots (such an x2 may move an argmax, and with it
# a channel's gradient), the statistics within 1e-4 of each one's largest
# value (both sum in f64, but such an x2 moves layer 2's variance by its
# step times 2·|x2| over the slots: var2 1.05e-5 at SA_0), and the other
# gradients within BN_OP_GRAD_BOUND of theirs
BN_SLAB_FLIP_BOUND = 1e-3
BN_OP_GRAD_BOUND = 2.0 ** -6
# the bf16 training forms' sources and the TPU kernels they compute as they
# round (group_points_bwd_bf16: no TPU kernel, the fixed-order sum of
# tpu3d's gather_mxu_bwd / onehot_bf16 VJPs)
BF16_SOURCES.update({
    "fused_sa_train_bf16": ("tpu3d_torch/csrc/fused_sa_wgmma.cuh",
                            "tpu3d/ops/fused_sa.py:752"),
    "fused_sa_bwd_bf16": ("tpu3d_torch/csrc/fused_sa_bwd_bf16.cu",
                          "tpu3d/ops/fused_sa.py:782"),
    "fused_sa_slab_train_bf16": ("tpu3d_torch/csrc/fused_sa_bf16.cuh",
                                 "tpu3d/ops/fused_sa.py:575"),
    "fused_sa_slab_bwd_bf16": ("tpu3d_torch/csrc/fused_sa_bwd_bf16.cu",
                               "tpu3d/ops/fused_sa.py:604"),
    "three_interpolate_bwd_bf16": ("tpu3d_torch/csrc/three_interpolate_bwd.cu",
                                   "tpu3d/ops/interpolate.py:276"),
    "group_points_bwd_bf16": ("tpu3d_torch/csrc/group_points_bwd.cu",
                              "tpu3d/ops/grouping.py:559"),
    **{f"{k}_bf16": ("tpu3d_torch/csrc/fused_sa_bn.cu", SOURCES[k][1])
       for k in BN_TRAIN_KERNELS}})
# kernel 9's four bf16 products run the tensor-core design at the BatchNorm
# RCNN's levels (bn_train_bf16_design, required there by phase 19 (f))
BF16_SOURCES.update({
    f"{k}_bf16": ("tpu3d_torch/csrc/fused_sa_bn_wgmma.cuh", SOURCES[k][1])
    for k in ("fused_sa_bn_stats1", "fused_sa_bn_stats2", "fused_sa_bn_wave1",
              "fused_sa_bn_wave2")})


@contextlib.contextmanager
def f32_training():
    """The f32 training contract for every config this process makes:
    fresh_cfg's defaults and the global tree with both TRAIN keys False,
    and F32_TRAINING holding the same as --set overrides for subprocesses;
    all restored after."""
    from tpu3d_torch.config import config as cm

    default = cm._default_cfg

    def f32_default():
        c = default()
        c.TRAIN.BF16_ACTIVATIONS = c.TRAIN.BF16_MATMULS = False
        return c

    before = (cm.cfg.TRAIN.BF16_ACTIVATIONS, cm.cfg.TRAIN.BF16_MATMULS)
    cm._default_cfg = f32_default
    cm.cfg.TRAIN.BF16_ACTIVATIONS = cm.cfg.TRAIN.BF16_MATMULS = False
    F32_TRAINING[:] = F32_TRAIN_SETS
    try:
        yield
    finally:
        cm._default_cfg = default
        cm.cfg.TRAIN.BF16_ACTIVATIONS, cm.cfg.TRAIN.BF16_MATMULS = before
        F32_TRAINING[:] = []


# the aten ops a cast or a copy of a tensor reaches at the dispatcher:
# none may run between autograd's hand-over of a gather's gradient and the
# bf16 backward's launch
COPY_OPS = ("_to_copy", "clone", "copy_")


@contextlib.contextmanager
def gather_backward_ops(into):
    """Each bf16 gather backward of the block (``_GroupPoints.backward``
    with its bf16 form): the gradient's dtype, shape and strides as
    autograd hands it over, and the aten ops run from there to the
    kernel's launch (a dispatch mode over the backward), appended to
    ``into``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tpu3d_torch.ops import grouping

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    saved = grouping._GroupPoints.__dict__["backward"]
    real = saved.__func__

    def backward(ctx, grad):
        if not ctx.bf16:
            return real(ctx, grad)
        with Ops() as mode:
            out = real(ctx, grad)
        into.append({"dtype": grad.dtype, "shape": tuple(grad.shape),
                     "stride": grad.stride(), "ops": mode.ops})
        return out

    grouping._GroupPoints.backward = staticmethod(backward)
    try:
        yield into
    finally:
        grouping._GroupPoints.backward = saved


@contextlib.contextmanager
def record_train_calls():
    """The arguments of the calls a bf16 train step makes to the fused
    forms (kernel 9's under ``fused_sa_bn_train_bf16``), the interpolation
    and the gathers whose backward takes the bf16 form, by the training
    form they launch; and, under ``gather_bwd_grads``, what each bf16
    gather backward was handed (``gather_backward_ops``)."""
    import torch

    def keep(attr, args):
        return torch.is_grad_enabled() and (
            attr != "group_points" or (len(args) > 2 and args[2])
            or args[0].dtype == torch.bfloat16)

    with record_calls(
            {"fused_gathered_mlp_pool_bf16": "fused_sa_train_bf16",
             "fused_mlp_pool_bf16": "fused_sa_slab_train_bf16",
             "fused_bn_mlp_pool_bf16_train": "fused_sa_bn_train_bf16",
             "three_interpolate_bf16": "three_interpolate_bwd_bf16",
             "group_points": "group_points_bwd_bf16"}, keep) as calls:
        with gather_backward_ops(calls.setdefault("gather_bwd_grads", [])):
            yield calls


def _bf16_chain(x0, w1, b1, w2, b2):
    """The bf16 cuBLAS chain of a fused level on a grouped bf16 x0."""
    import torch
    import torch.nn.functional as F

    x = torch.relu(F.linear(torch.relu(x0), w1.T.to(torch.bfloat16),
                            b1.to(torch.bfloat16)))
    return torch.relu(F.linear(x, w2.T.to(torch.bfloat16),
                               b2.to(torch.bfloat16))).amax(2)


def split_line(split) -> str:
    """``kernel_bench.split_ms``'s split of a call, largest first, and its
    device launches."""
    launches = sum(n for k, (_, n) in split.items() if k != "host read")
    return (", ".join(f"{k} {ms:.4f} ms x{n:g}" for k, (ms, n) in sorted(
        split.items(), key=lambda kv: -kv[1][0])) + f"; {launches:g} device "
        f"launches a call")


def fused_train_form_rows(report, calls, gen):
    """(a) for kernels 6 and 8: each recorded call's training forward and
    routed backward against their plain versions, each twice equal to the
    bit, timed beside the plain versions, the f32 forms on the same values
    and the bf16 cuBLAS chain under autograd (its forward; its backward
    alone); the backward also under full spread (every channel live at a
    slot drawn uniformly over S), its design checked against the C entry
    and each call split by launch (``kernel_bench.split_ms``)."""
    import torch

    from tpu3d_torch.ops import fused_sa as fs
    from tpu3d_torch.ops.grouping import group_points
    from tpu3d_torch.tools.kernel_bench import split_ms

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    forms = {
        "fused_sa_train_bf16": (
            "fused_sa_bwd_bf16", fs.fused_gathered_mlp_pool_bf16_train,
            fs.fused_gathered_mlp_pool_bf16_train_plain,
            fs.fused_gathered_mlp_pool_bf16_backward,
            fs.fused_gathered_mlp_pool_bf16_backward_plain,
            fs.fused_gathered_mlp_pool_train,
            fs.fused_gathered_mlp_pool_backward),
        "fused_sa_slab_train_bf16": (
            "fused_sa_slab_bwd_bf16", fs.fused_mlp_pool_bf16_train,
            fs.fused_mlp_pool_bf16_train_plain,
            fs.fused_mlp_pool_bf16_backward,
            fs.fused_mlp_pool_bf16_backward_plain, fs.fused_mlp_pool_train,
            fs.fused_mlp_pool_backward)}
    fgen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    for fwd_name, (bwd_name, train, train_plain, bwd, bwd_plain, train32,
                   bwd32) in forms.items():
        step_ms = {"kernel": 0.0, "f32 form": 0.0, "bf16 cuBLAS chain": 0.0}
        bwd_step = {"kernel": 0.0, "f32 form": 0.0,
                    "the chain's backward": 0.0, "full spread": 0.0,
                    "f32 form at full spread": 0.0}
        for args in calls.get(fwd_name, []):
            gather = fwd_name == "fused_sa_train_bf16"
            w1, b1, w2, b2 = args[-4:]
            c1, c2, c3 = w1.shape[0], w1.shape[1], w2.shape[1]
            if gather:
                pre, idx, center = args[:3]
                R, M, S = idx.shape
                in_bytes = 2 * (pre.numel() + center.numel()) \
                    + 4 * idx.numel()
                f32a = (pre.float(), idx, center.float(),
                        *(a.contiguous() for a in args[3:]))

                def x0_of(p, c):
                    return group_points(p, idx) - c[:, :, None]
            else:
                R, M, S, _ = args[0].shape
                in_bytes = 2 * args[0].numel()
                f32a = (args[0].float(), *(a.contiguous() for a in args[1:]))

                def x0_of(x):
                    return x
            label = f"{fwd_name} R={R} M={M} S={S} C={c1}->{c2}->{c3}"
            out, arg, ppre = train(*args)
            again = train(*args)
            check(all(torch.equal(a, b) for a, b in
                      zip((out, arg, ppre), again)),
                  f"{label}: two training forwards differ")
            with torch.no_grad():
                p_out, p_arg, _ = train_plain(*args)
            err, scale = _rel_err(out, p_out)
            check(err <= BF16_FORM_BOUND * scale, f"{label}: the forward "
                  f"differs from its plain version by {err} (largest "
                  f"{scale})")
            flips = (arg != p_arg).float().mean().item()
            check(flips <= ARGMAX_FLIP_BOUND, f"{label}: {flips:.2%} of "
                  f"the argmax slots differ from the plain version's")
            g = torch.randn(out.shape, generator=gen).to(out.device).to(
                torch.bfloat16)
            first = bwd(*args, g, arg, ppre)
            second = bwd(*args, g, arg, ppre)
            check(all(torch.equal(a, b) for a, b in zip(first, second)),
                  f"{label}: two backward calls differ")
            want = bwd_plain(*args, g, arg, ppre)
            form = "gather" if gather else "slab"
            b_err, b_held = hold_bwd_outputs(form, args, g, arg, ppre,
                                             first, want, label)
            del again, second, want
            # the times
            leaves = [a.detach().clone().requires_grad_()
                      if a.is_floating_point() else a for a in args]

            def library():
                x0 = (x0_of(leaves[0], leaves[2]) if gather
                      else x0_of(leaves[0]))
                return _bf16_chain(x0, *leaves[-4:])

            ms = cuda_ms(lambda: train(*args), 10)
            with torch.no_grad():
                pms = cuda_ms(lambda: train_plain(*args), 2)
            lms = cuda_ms(library, 5)
            o32, a32, p32 = train32(*f32a)
            fms = cuda_ms(lambda: train32(*f32a), 10)
            bms = cuda_ms(lambda: bwd(*args, g, arg, ppre), 5)
            bpms = cuda_ms(lambda: bwd_plain(*args, g, arg, ppre), 2)
            blms = library_backward_ms(library, g)
            g32 = g.float()
            bfms = cuda_ms(lambda: bwd32(*f32a, g32, a32, p32), 5)
            del o32, leaves
            ops = 2 * R * M * S * (c1 * c2 + c2 * c3)
            wbytes = 2 * (c1 * c2 + c2 * c3 + c2 + c3)
            design = {}
            if gather:
                design = train_bf16_design(c1, c2, c3, label)
                design = {"wgmma_calls": int(design == "wgmma"),
                          "parent_calls": int(design == "parent")}
            report.add(fwd_name, err, ms, pms, lms,
                       in_bytes + wbytes + 10 * R * M * c3, ops, f32_ms=fms,
                       **design)
            for key, t in (("kernel", ms), ("f32 form", fms),
                           ("bf16 cuBLAS chain", lms)):
                step_ms[key] += t
            nnz, hit = routed_slots(arg, g.float(), ppre, S)
            b_bytes = (2 * in_bytes + 4 * (c1 * c2 + c2 * c3)
                       + 10 * R * M * c3)
            bdesign = bwd_bf16_design(c1, c2, c3, label)
            seeded_split = split_ms(lambda: bwd(*args, g, arg, ppre))
            # full spread, on the same inputs and gradient
            f_arg, f_ppre = spread_draw(arg, ppre, S, fgen)
            f_first = bwd(*args, g, f_arg, f_ppre)
            check(all(torch.equal(a, b) for a, b in zip(
                f_first, bwd(*args, g, f_arg, f_ppre))),
                  f"{label}: two backward calls differ under full spread")
            f_err, f_held = hold_bwd_outputs(
                form, args, g, f_arg, f_ppre, f_first,
                bwd_plain(*args, g, f_arg, f_ppre), f"{label} (full spread)")
            del f_first
            f_ms = cuda_ms(lambda: bwd(*args, g, f_arg, f_ppre), 3)
            f_f32 = cuda_ms(lambda: bwd32(*f32a, g32, f_arg, f_ppre), 3)
            full_split = split_ms(lambda: bwd(*args, g, f_arg, f_ppre))
            f_nnz, f_hit = routed_slots(f_arg, g.float(), f_ppre, S)
            f_bound = bound_ms(b_bytes, bwd_ops(f_hit, f_nnz, c1, c2),
                               PEAK_BF16_OPS_PER_S)[0]
            del f_arg, f_ppre
            report.add(bwd_name, b_err, bms, bpms, blms, b_bytes,
                       bwd_ops(hit, nnz, c1, c2), f32_ms=bfms,
                       lib_bwd_ms=blms, reached=hit, slots=R * M * S,
                       mma_calls=int(bdesign == "mma"),
                       parent_calls=int(bdesign == "parent"), full_ms=f_ms,
                       full_f32_ms=f_f32, full_bound_ms=f_bound,
                       full_reached=f_hit)
            r = report.rows[bwd_name]
            r["full_err"] = max(r.get("full_err", 0.0), f_err)
            for key, t in (("kernel", bms), ("f32 form", bfms),
                           ("the chain's backward", blms),
                           ("full spread", f_ms),
                           ("f32 form at full spread", f_f32)):
                bwd_step[key] += t
            print(f"{label}: backward ({bdesign} design) split, seeded: "
                  f"{split_line(seeded_split)}; full spread: "
                  f"{split_line(full_split)}")
            print(f"{label}: backward under full spread {f_ms:.3f} ms (f32 "
                  f"form {f_f32:.3f}), bound {f_bound:.4f} ms, {f_hit} of "
                  f"{R * M * S} slots reached, max_abs_err {f_err:.3e}; rows "
                  f"held to the float64 chain: {b_held} seeded, {f_held} "
                  f"under full spread; twice equal to the bit")
            print(f"{label}: forward {ms:.3f} ms (f32 form {fms:.3f}), plain "
                  f"{pms:.3f}, bf16 cuBLAS chain {lms:.3f}, max_abs_err "
                  f"{err:.3e} of {scale:.3e}, argmax off the plain one's at "
                  f"{flips:.3%} of the channels; backward {bms:.3f} ms (f32 "
                  f"form {bfms:.3f}), plain {bpms:.3f}, the chain's backward "
                  f"{blms:.3f}, max_abs_err {b_err:.3e}, {hit} of "
                  f"{R * M * S} slots reached; each twice equal to the bit")
        if calls.get(fwd_name):
            print(f"{fwd_name} over the {len(calls[fwd_name])} calls of the "
                  f"step: " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in step_ms.items()))
            print(f"{bwd_name} over the {len(calls[fwd_name])} calls of the "
                  f"step: " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in bwd_step.items()))


def train_bf16_design(c1, c2, c3, label):
    """The design kernel 6's bf16 training forward runs widths c1 -> c2 ->
    c3 on ("wgmma" or "parent"), checked against the C entry's own
    predicate."""
    import ctypes

    from tpu3d_torch.ops import _build
    from tpu3d_torch.ops.fused_sa import train_bf16_design as design

    fn = _build.library("fused_sa").tpu3d_fused_sa_train_bf16_wgmma
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    got = design(c1, c2, c3)
    check(bool(fn(c1, c2, c3)) == (got == "wgmma"), f"{label}: the C entry "
          f"and train_bf16_design disagree on {c1} -> {c2} -> {c3}")
    return got


def bn_bf16_designs(c1, c2, c3, label) -> dict:
    """The design each of kernel 9's seven bf16 entries runs a BatchNorm
    level of widths c1 -> c2 -> c3 on: the four products as
    ``bn_train_bf16_design`` names them ("wgmma" or "simt"), checked
    against the C entry's own predicate (``tpu3d_fused_sa_bn_bf16_design``,
    a bit a product), and stats0, final and apply, one pass each ("pass")
    -> {entry: design}."""
    import ctypes

    from tpu3d_torch.ops import _build
    from tpu3d_torch.ops.fused_sa import BN_BF16_PRODUCTS, \
        bn_train_bf16_design

    fn = _build.library("fused_sa_bn").tpu3d_fused_sa_bn_bf16_design
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    mask = fn(c1, c2, c3)
    got = bn_train_bf16_design(c1, c2, c3)
    entry = {name: "wgmma" if mask >> i & 1 else "simt"
             for i, name in enumerate(BN_BF16_PRODUCTS)}
    check(entry == got, f"{label}: the C entry and bn_train_bf16_design "
          f"disagree on {c1} -> {c2} -> {c3}: {entry}, {got}")
    return {name: got.get(name, "pass") for name in BN_BF16_FORMS}


def bwd_bf16_design(c1, c2, c3, label):
    """The design kernels 6 and 8's bf16 backward runs widths c1 -> c2 ->
    c3 on ("mma" or "parent"), checked against the C entry's own
    predicate."""
    import ctypes

    from tpu3d_torch.ops import _build
    from tpu3d_torch.ops.fused_sa import backward_bf16_design as design

    fn = _build.library("fused_sa_bwd_bf16").tpu3d_fused_sa_bwd_bf16_design
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    got = design(c1, c2, c3)
    check(bool(fn(c1, c2, c3)) == (got == "mma"), f"{label}: the C entry "
          f"and backward_bf16_design disagree on {c1} -> {c2} -> {c3}")
    return got


def hold_train_backward(calls, label, gen):
    """Kernel 6's bf16 backward at kernel 6's training calls ``calls``, on
    its own forward's argmax and ppre and a seeded bf16 gradient, and under
    full spread: two calls equal to the bit, the outputs held to the plain
    version under the FLIP_ROWS rule (hold_bwd_outputs) -> the designs it
    ran, by call."""
    import torch

    from tpu3d_torch.ops import fused_sa as fs

    designs = []
    fgen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    for args in calls:
        R, M, S = args[1].shape
        c1, c2, c3 = args[3].shape[0], args[3].shape[1], args[5].shape[1]
        where = f"{label}: fused_sa_bwd_bf16 R={R} M={M} S={S} " \
                f"C={c1}->{c2}->{c3}"
        designs.append(bwd_bf16_design(c1, c2, c3, where))
        out, arg, ppre = fs.fused_gathered_mlp_pool_bf16_train(*args)
        g = torch.randn(out.shape, generator=gen).to(out.device).to(
            torch.bfloat16)
        errs = {}
        for routing, (a, p) in (("seeded", (arg, ppre)), (
                "full spread", spread_draw(arg, ppre, S, fgen))):
            first = fs.fused_gathered_mlp_pool_bf16_backward(*args, g, a, p)
            again = fs.fused_gathered_mlp_pool_bf16_backward(*args, g, a, p)
            check(all(torch.equal(x, y) for x, y in zip(first, again)),
                  f"{where}: two calls differ")
            errs[routing] = hold_bwd_outputs(
                "gather", args, g, a, p, first,
                fs.fused_gathered_mlp_pool_bf16_backward_plain(*args, g, a,
                                                               p),
                f"{where} ({routing})")
        print(f"{where} ({designs[-1]} design): max_abs_err "
              f"{errs['seeded'][0]:.3e} ({errs['seeded'][1]} rows held to "
              f"the float64 chain), under full spread "
              f"{errs['full spread'][0]:.3e} ({errs['full spread'][1]}); "
              f"twice equal to the bit")
    return designs


def hold_train_forward(calls, label):
    """Kernel 6's bf16 training forward at a config's recorded calls: two
    calls equal to the bit, within BF16_FORM_BOUND of its plain version,
    the argmax on another slot in at most ARGMAX_FLIP_BOUND of the
    channels -> the designs it ran, by call."""
    import torch

    from tpu3d_torch.ops import fused_sa as fs

    designs = []
    for args in calls:
        R, M, S = args[1].shape
        c1, c2, c3 = args[3].shape[0], args[3].shape[1], args[5].shape[1]
        where = f"{label}: fused_sa_train_bf16 R={R} M={M} S={S} " \
                f"C={c1}->{c2}->{c3}"
        designs.append(train_bf16_design(c1, c2, c3, where))
        out = fs.fused_gathered_mlp_pool_bf16_train(*args)
        again = fs.fused_gathered_mlp_pool_bf16_train(*args)
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"{where}: two calls differ")
        with torch.no_grad():
            p_out, p_arg, _ = fs.fused_gathered_mlp_pool_bf16_train_plain(
                *args)
        err, scale = _rel_err(out[0], p_out)
        flips = (out[1] != p_arg).float().mean().item()
        check(err <= BF16_FORM_BOUND * scale and flips <= ARGMAX_FLIP_BOUND,
              f"{where}: {err} off its plain version (largest {scale}), "
              f"{flips:.2%} of the argmax slots moved")
        print(f"{where} ({designs[-1]} design): within {err:.3e} of the "
              f"plain version (largest {scale:.3e}), argmax moved at "
              f"{flips:.3%} of the channels; twice equal to the bit")
    return designs


def widened_train_calls(gen):
    """Kernel 6's bf16 training forward's arguments at the widened RCNN's
    SA_0 and SA_1 (``WIDE_NSAMPLE0``, ``WIDE_MLPS``; train B=2's 128 ROIs
    per scene, seeded): [(pre, idx, center, w1, b1, w2, b2)]."""
    import torch

    out, n, c0 = [], 512, WIDE_MLPS[0][0]
    for (m, s), mlp in zip(((128, WIDE_NSAMPLE0), (32, 64)), WIDE_MLPS):
        R, (c1, c2, c3) = 2 * 128, mlp
        check(c1 == c0, f"the widened RCNN's widths {WIDE_MLPS}")

        def randn(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen).to(DEVICE) * scale

        out.append((randn(R, n, c1).to(torch.bfloat16),
                    torch.randint(0, n, (R, m, s), generator=gen).to(
                        DEVICE, torch.int32),
                    randn(R, m, c1, scale=0.5).to(torch.bfloat16),
                    randn(c1, c2, scale=c1 ** -0.5), randn(c2, scale=0.1),
                    randn(c2, c3, scale=c2 ** -0.5), randn(c3, scale=0.1)))
        n, c0 = m, c3
    return out


def gather_train_form_rows(report, calls, gen):
    """(a) for kernel 7's bf16 form and the gather's bf16 backward: each
    recorded call's backward (on a seeded gradient) twice equal to the bit
    and equal to the CPU plain version's, timed beside the plain version,
    the f32 form and the library's scatter (index_add_ / torch.gather's
    backward)."""
    import torch

    from tpu3d_torch.ops import grouping as gp
    from tpu3d_torch.ops import interpolate as ip

    for feats, idx, w, round_w in calls.get("three_interpolate_bwd_bf16", []):
        B, N, C = feats.shape
        M = idx.shape[1]
        g = torch.randn(B, M, C, generator=gen).to(feats.device).to(
            torch.bfloat16 if round_w else torch.float32)
        got = ip.three_interpolate_backward_bf16(idx, w, g, N)
        check(torch.equal(got, ip.three_interpolate_backward_bf16(
            idx, w, g, N)), "three_interpolate_bwd_bf16: two calls differ")
        cpu = ip.three_interpolate_backward_bf16_plain(idx.cpu(), w.cpu(),
                                                       g.cpu(), N)
        check(torch.equal(got.cpu(), cpu), f"three_interpolate_bwd_bf16 "
              f"differs from its CPU plain version at N={N} M={M} C={C}")
        ms = cuda_ms(lambda: ip.three_interpolate_backward_bf16(idx, w, g, N),
                     20)
        pms = cuda_ms(lambda: ip.three_interpolate_backward_bf16_plain(
            idx, w, g, N), 5)
        f32f, g32 = feats.float(), g.float()
        fms = cuda_ms(lambda: ip.three_interpolate_backward(f32f, idx, w,
                                                            g32, False), 20)
        rows = (idx.long() + N * torch.arange(B, device=idx.device)
                [:, None, None]).reshape(-1)
        contrib = (w.to(torch.bfloat16)[..., None] * g.to(torch.bfloat16)
                   [:, :, None, :]).reshape(-1, C)
        lms = cuda_ms(lambda: contrib.new_zeros(B * N, C).index_add_(
            0, rows, contrib), 5)
        report.add("three_interpolate_bwd_bf16", 0.0, ms, pms, lms,
                   g.element_size() * B * M * C + 24 * B * M + 2 * B * N * C,
                   2 * B * M * 3 * C, f32_ms=fms)
        print(f"three_interpolate_bwd_bf16 N={N} M={M} C={C} (g "
              f"{g.dtype}): {ms:.4f} ms (f32 form {fms:.4f}), plain "
              f"{pms:.3f}, index_add_ in bf16 {lms:.4f}; twice equal, equal "
              f"to the CPU's")
    handed = {h["shape"]: h for h in calls.get("gather_bwd_grads", [])}
    step_ms = {"kernel": 0.0, "f32 form": 0.0, "torch.gather backward": 0.0}
    for feats, idx, *_ in calls.get("group_points_bwd_bf16", []):
        B, N, C = feats.shape
        _, M, S = idx.shape
        idx = idx.to(torch.int32).contiguous()
        # the gradient in the dtype and layout the step handed this
        # backward, and the ops the step ran before its launch
        h = handed.get((B, M, S, C))
        check(h is not None, f"group_points_bwd_bf16 N={N} M={M} S={S} "
              f"C={C}: no backward recorded at this shape")
        copies = [op for op in h["ops"] if op in COPY_OPS]
        check(not copies, f"group_points_bwd_bf16 N={N} M={M} S={S} C={C}: "
              f"the step copied or cast before the launch: {h['ops']}")
        g = torch.empty_strided(h["shape"], h["stride"], dtype=h["dtype"],
                                device=feats.device)
        g.copy_(torch.randn(B, M, S, C, generator=gen).to(h["dtype"]))
        got = gp.group_points_backward_bf16(g, idx, N, feats.dtype)
        check(torch.equal(got, gp.group_points_backward_bf16(
            g, idx, N, feats.dtype)), "group_points_bwd_bf16: two calls "
            "differ")
        cpu = gp.group_points_backward_bf16_plain(g.cpu(), idx.cpu(), N,
                                                  feats.dtype)
        check(torch.equal(got.cpu(), cpu), f"group_points_bwd_bf16 differs "
              f"from its CPU plain version at N={N} M={M} S={S} C={C}")
        ms = cuda_ms(lambda: gp.group_points_backward_bf16(g, idx, N,
                                                           feats.dtype), 20)
        pms = cuda_ms(lambda: gp.group_points_backward_bf16_plain(
            g, idx, N, feats.dtype), 5)
        g32 = g.float().contiguous()
        fms = cuda_ms(lambda: gp.group_points_backward(g32, idx, N), 20)
        leaf = feats.detach().to(g.dtype).requires_grad_()
        lms = library_backward_ms(lambda: torch_group(leaf, idx), g)
        report.add("group_points_bwd_bf16", 0.0, ms, pms, lms,
                   g.element_size() * g.numel() + 4 * idx.numel()
                   + feats.element_size() * B * N * C, g.numel(), f32_ms=fms)
        for key, t in (("kernel", ms), ("f32 form", fms),
                       ("torch.gather backward", lms)):
            step_ms[key] += t
        print(f"group_points_bwd_bf16 N={N} M={M} S={S} C={C} (g "
              f"{h['dtype']} of strides {h['stride']} as the step hands it, "
              f"ops before the launch {sorted(set(h['ops']))}; out "
              f"{feats.dtype}): {ms:.4f} ms (f32 form {fms:.4f}), plain "
              f"{pms:.3f}, torch.gather's backward {lms:.4f}; twice equal, "
              f"equal to the CPU's")
    if calls.get("group_points_bwd_bf16"):
        print("group_points_bwd_bf16 over the step's bf16 gathers: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in step_ms.items()))


def bf16_gathers(cfg) -> tuple[int, int]:
    """The grouping gathers of a train step of ``cfg`` and how many of them
    take the bf16 backward under the card's default training contract:
    the pre-grouped RPN levels' that gp_route sends to gather_mxu_bwd (wide
    tables), and the RCNN's levels on the slab route (bf16 pre-activations,
    tpu3d's onehot_bf16) -> (gathers, bf16 ones)."""
    from tpu3d_torch.ops.fused_sa import sa_route
    from tpu3d_torch.ops.grouping import gp_route

    sa = cfg.RPN.SA_CONFIG
    n = [cfg.RPN.NUM_POINTS] + list(sa.NPOINTS)
    feats = int(cfg.RPN.USE_INTENSITY)
    total = bf16 = 0
    for k, m in enumerate(sa.NPOINTS):
        for j, mlp in enumerate(sa.MLPS[k]):
            if feats:
                total += 1
                bf16 += gp_route(n[k], mlp[0], m * sa.NSAMPLE[k][j], True,
                                 False, True) == "gather_mxu_bwd"
        feats = sum(mlp[-1] for mlp in sa.MLPS[k])
    c = cfg.RCNN
    pts, rois = c.NUM_POINTS, c.ROI_PER_IMAGE
    for k, m in enumerate(c.SA_CONFIG.NPOINTS):
        if m == -1:
            break
        mlp = list(c.SA_CONFIG.MLPS[k])
        if sa_route((rois, m, c.SA_CONFIG.NSAMPLE[k], mlp[0]), mlp, pts,
                    c.USE_BN) == "slab":
            total += 1
            bf16 += 1
        pts = m
    return total, bf16


def _grad_norms(model, grad_norm: float, clip: float) -> dict:
    """The parameters' gradient norms before the step's clip, by top-level
    module and in all: the gradients left after the step, scaled back by
    the clip's factor (``grad_norm`` the step's norm before it)."""
    norms = {}
    for name, p in model.named_parameters():
        if p.grad is not None:
            key = ".".join(name.split(".")[:2])
            norms[key] = norms.get(key, 0.0) + float(p.grad.float().pow(
                2).sum())
    scale = max(1.0, grad_norm / clip)
    return {**{k: math.sqrt(v) * scale for k, v in norms.items()},
            "all": grad_norm}


def _one_step(cfg, model, weights, batch, record=False):
    """One train step from ``weights`` (``make_train_step``'s contract for
    the card and ``cfg``), counts set to 0 just before it and read just
    after -> (metrics, launches, gradient norms, calls, precision)."""
    import torch

    from tpu3d_torch.ops import _build
    from tpu3d_torch.parallel import create_train_state, make_train_step

    model.load_state_dict(weights)
    state = create_train_state(cfg, model, steps_per_epoch=100,
                               total_epochs=10)
    step = make_train_step(cfg, model)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.synchronize()
    _build.reset_launches()
    with (record_train_calls() if record
          else contextlib.nullcontext({})) as calls:
        tb = step(state, batch, gen, 0.9)
        torch.cuda.synchronize()
    tb = {k: float(v) for k, v in tb.items()}
    return (tb, _launched(), _grad_norms(model, tb["grad_norm"],
                                         float(cfg.TRAIN.GRAD_NORM_CLIP)),
            calls, step.precision)


def _snapshot_step(cfg, model, weights, batch):
    """One train step from ``weights`` with the step's generator seeded
    from SEED, counts set to 0 just before it and read just after ->
    (metrics, every gradient, parameter, statistic and Adam moment after
    it, launches)."""
    import torch

    from tpu3d_torch.ops import _build
    from tpu3d_torch.parallel import create_train_state, make_train_step

    dev = torch.device(DEVICE)
    model.load_state_dict(weights)
    state = create_train_state(cfg, model, 100, 10)
    step = make_train_step(cfg, model)
    torch.cuda.synchronize()
    _build.reset_launches()
    tb = step(state, batch, torch.Generator(device=dev).manual_seed(SEED),
              0.9)
    torch.cuda.synchronize()
    launches = _launched()
    snap = {**{f"grad:{n}": p.grad.clone() for n, p in
               model.named_parameters() if p.grad is not None},
            **{k: v.clone() for k, v in model.state_dict().items()},
            **{f"{key}:{i}": state.optimizer.opt.state[q][key].clone()
               for i, q in enumerate(state.optimizer.params)
               for key in ("exp_avg", "exp_avg_sq")}}
    return {k: float(v) for k, v in tb.items()}, snap, launches


def _turns(runs, batch, reps=3) -> tuple[dict, dict]:
    """ms per step (host clock, median of ``reps`` after a warm-up) of each
    (key, cfg, model, weights) in ``runs``, in that order, and the peak
    device memory of each key's timed steps (after the warm-up; the larger
    of a key's turns) -> ({key: [ms, ...]}, {key: GiB})."""
    import torch

    from tpu3d_torch.parallel import create_train_state, make_train_step

    turns, peaks = {}, {}
    for key, c, model, weights in runs:
        model.load_state_dict(weights)
        state = create_train_state(c, model, 100, 10)
        step = make_train_step(c, model)
        g = torch.Generator(device=DEVICE).manual_seed(SEED)
        step(state, batch, g, 0.9)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        turns.setdefault(key, []).append(
            wall_ms(lambda: step(state, batch, g, 0.9), reps))
        peaks[key] = max(peaks.get(key, 0.0),
                         torch.cuda.max_memory_allocated() / 2 ** 30)
    return turns, peaks


def bn_bf16_form_rows(report, calls, gen) -> dict:
    """Kernel 9's bf16 training form at the calls of the BatchNorm
    RCNN's train step (RCNN SA_0 and SA_1): the design of each of its seven
    entries there (``bn_bf16_designs``: the four products on the tensor
    cores, required), each entry against its plain piece
    (``bn_pass_rows``); then the whole op through its
    autograd Function on the first BN_CHECK_ROWS rows, equal to its passes
    composed directly and to a second call to the bit, and against autograd
    of the repaired plain form (``fused_bn_mlp_pool_bf16_train_plain``);
    then the bf16 cuBLAS chain with batch-statistics BatchNorm
    (F.batch_norm) under autograd, forward and backward (the bounds:
    BN_SLAB_FLIP_BOUND's comment) -> ({level: that chain's ms}, {level:
    {entry: design}})."""
    import torch
    import torch.nn.functional as F

    from tpu3d_torch.ops import fused_sa as fs

    bf16 = torch.bfloat16
    library, designs = {}, {}
    for k, args in enumerate(calls):
        x0, w1, w2 = (t.detach() for t in args[:3])
        gammas = [t.detach() for t in args[3]]
        betas = [t.detach() for t in args[4]]
        eps = args[5]
        R, M, S, c1 = x0.shape
        c2, c3 = w1.shape[1], w2.shape[1]
        where = f"{BN_TRAIN_PATH}, RCNN SA_{k}"
        check(x0.dtype == bf16, f"{where}: x0 is {x0.dtype}")
        # the design of each entry there: the four products on the tensor
        # cores at both levels
        designs[f"RCNN SA_{k}"] = got = bn_bf16_designs(c1, c2, c3, where)
        print(f"kernel 9's bf16 entries at {where} ({c1} -> {c2} -> {c3}): "
              + ", ".join(f"{name} {d}" for name, d in got.items()))
        check(all(got[f"{name}_bf16"] == "wgmma" for name in (
            "fused_sa_bn_stats1", "fused_sa_bn_stats2", "fused_sa_bn_wave1",
            "fused_sa_bn_wave2")), f"{where}: kernel 9's bf16 products ran "
              f"{got}, expected the tensor-core design")
        bn_pass_rows(report, where, x0, w1, w2, gammas, betas, eps, gen)

        # the whole op through its autograd Function on the first
        # BN_CHECK_ROWS rows: equal to a second call and to its passes
        # composed directly, to the bit; against the repaired plain form
        sub = x0[:BN_CHECK_ROWS].contiguous()
        g = torch.randn(sub.shape[0], M, c3, generator=gen).to(
            sub.device).to(bf16)

        def run(op):
            leaves = [t.detach().clone().requires_grad_() for t in
                      (sub, w1, w2, *gammas, *betas)]
            o, (ms_, vs_) = op(leaves[0], leaves[1], leaves[2], leaves[3:6],
                               leaves[6:9], eps)
            return (o.detach(), *ms_, *vs_,
                    *torch.autograd.grad(o, leaves, g))

        ours = run(fs.fused_bn_mlp_pool_bf16_train)
        check(all(torch.equal(a, b) for a, b in
                  zip(ours, run(fs.fused_bn_mlp_pool_bf16_train))),
              f"two calls of the bf16 training op differ at {where}")
        with torch.no_grad():
            d_o, d_arg, d_at, d_ms, d_vs, saved = fs.fused_bn_mlp_pool_train(
                sub, w1, w2, gammas, betas, eps)
            d_g = fs.fused_bn_mlp_pool_backward(
                sub, w1, w2, gammas, betas, d_ms, d_vs, d_o, d_arg, d_at,
                saved, g, eps)
            del saved
        direct = (d_o, *d_ms, *d_vs, d_g[0], d_g[1], d_g[2], *d_g[3],
                  *d_g[4])
        check(all(torch.equal(a, b) for a, b in zip(ours, direct)),
              f"the bf16 training op through autograd differs from its "
              f"passes composed directly at {where}")
        want = run(fs.fused_bn_mlp_pool_bf16_train_plain)
        with torch.no_grad():
            a2p, _ = fs.bn_bf16_chain(sub, w1, w2, gammas, betas, eps)
            p_arg = fs._first_max(a2p)[1]
            del a2p
        names = ("out", "mean0", "mean1", "mean2", "var0", "var1", "var2",
                 "d_x0", "d_w1", "d_w2", "d_gamma0", "d_gamma1", "d_gamma2",
                 "d_beta0", "d_beta1", "d_beta2")
        rel = {}
        for part, a, b in zip(names, ours, want):
            check(a.dtype == b.dtype, f"{part}: {a.dtype}, plain {b.dtype}")
            rel[part] = ((a.float() - b.float()).abs().max()
                         / b.float().abs().max()).item()
        # the output in bf16 steps of each value's own magnitude
        steps = bf16_steps(ours[0], want[0])
        beyond = (steps > 1).float().mean().item()
        off = (steps > 0).float().mean().item()
        steps = steps.max().item()
        flips = (d_arg != p_arg).float().mean().item()
        d = (ours[7].float() - want[7].float()).abs()
        slots = (d > BF16_FORM_BOUND * want[7].float().abs().max()).any(
            dim=-1).float().mean().item()
        print(f"kernel 9's bf16 training op on the first {BN_CHECK_ROWS} "
              f"rows at {where}: through autograd equal to a second call "
              f"and to its passes composed directly; against autograd of "
              f"the repaired plain form: out off in {off:.2e} of the "
              f"values, beyond one bf16 step of its own in {beyond:.2e}, "
              f"{steps:.2f} of its own steps at most; argmax off in "
              f"{flips:.2e} of the channels; d_x0 beyond {BF16_FORM_BOUND} "
              f"of its largest value in {slots:.2e} of the slots; largest "
              f"error / largest value " + ", ".join(
                  f"{p} {r:.2e}" for p, r in rel.items()))
        check(beyond <= BN_SLAB_FLIP_BOUND and off <= ARGMAX_FLIP_BOUND
              and flips <= ARGMAX_FLIP_BOUND and slots <= ARGMAX_FLIP_BOUND,
              f"the bf16 training op against the plain form at {where}: "
              f"out beyond one step in {beyond}, off in {off}, argmax "
              f"{flips}, d_x0 slots {slots}")
        for part, r in rel.items():
            if part[:1] in "mv":
                check(r <= 1e-4, f"{part} differs by {r:.3e} at {where}")
            elif part not in ("out", "d_x0"):
                check(r <= BN_OP_GRAD_BOUND, f"{part} differs by {r:.3e} of "
                      f"its largest value at {where}")
        del ours, direct, want, d_g, sub
        torch.cuda.empty_cache()

        def library_train():  # bf16 cuBLAS with batch-statistics BatchNorm
            ls = [t.detach().requires_grad_() for t in
                  (x0, w1, w2, *gammas, *betas)]
            x = ls[0].view(-1, c1)
            for i, w in enumerate((ls[1], ls[2], None)):
                x = torch.relu(F.batch_norm(x, None, None, ls[3 + i],
                                            ls[6 + i], training=True,
                                            eps=eps))
                if w is not None:
                    x = F.linear(x, w.T.to(bf16))
            o = x.view(R, M, S, c3).amax(2)
            torch.autograd.grad(o, ls, grad_all)

        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        grad_all = torch.randn(R, M, c3, generator=gen).to(x0.device).to(bf16)
        library[f"RCNN SA_{k}"] = cuda_ms(library_train, 2)
        print(f"bf16 cuBLAS chain with batch-statistics BatchNorm under "
              f"autograd, forward and backward, at {where}: "
              f"{library[f'RCNN SA_{k}']:.3f} ms")
        torch.cuda.empty_cache()
    return library, designs


def bn_rcnn_bf16(cfg, batch, card, report, gen) -> dict:
    """Phase 19 (f), the BatchNorm RCNN: default.yaml with
    RCNN.USE_BN at B=16, one joint train step under the card's default
    training contract and one under the f32 contract from the same weights,
    batch and draws (each f32 launch of kernel 9's training form taken over
    by its bf16 form one for one, the losses within RPN_LOSS_BOUND and
    TRAIN_LOSS_BOUND of the f32 step's); two default-contract steps from
    one state equal to the bit; ms/step in turns (f32, default, default,
    f32) and the peak memory of both; then kernel 9's bf16 form at the
    calls the step made (``bn_bf16_form_rows``) -> the figures."""
    import torch

    from tpu3d_torch.config import cfg_from_list
    from tpu3d_torch.models import PointRCNN

    dev = torch.device(DEVICE)
    bcfg = copy.deepcopy(cfg)
    bcfg.RCNN.USE_BN = True
    f32cfg = cfg_from_list(F32_TRAIN_SETS, copy.deepcopy(bcfg))
    model = PointRCNN(bcfg, mode="TRAIN", device=dev)
    weights = train_weights(model, SEED)
    f32 = _one_step(f32cfg, model, weights, batch)
    bf = _one_step(bcfg, model, weights, batch, record=True)
    # the recorded slabs, and copies of the weights they met (the steps
    # below update the live ones)
    calls = [(a[0], *(t.clone() for t in a[1:3]),
              [t.detach().clone() for t in a[3]],
              [t.detach().clone() for t in a[4]], a[5])
             for a in bf[3].get("fused_sa_bn_train_bf16", [])]
    label = BN_TRAIN_PATH
    check(all(f32[1].get(k) == 2 for k in BN_TRAIN_KERNELS),
          f"{label}: the f32 step launched {f32[1]}, expected each of "
          f"kernel 9's training passes twice")
    total, n_bf16 = bf16_gathers(bcfg)
    want = {BF16_TRAIN_OF.get(k, k): v for k, v in f32[1].items()
            if k != "group_points_bwd"}
    if total - n_bf16:
        want["group_points_bwd"] = total - n_bf16
    if n_bf16:
        want["group_points_bwd_bf16"] = n_bf16
    check(bf[1] == want, f"{label}: the default contract's step launched "
          f"{bf[1]}, expected {want}")
    for key, bound in (("rpn_loss", RPN_LOSS_BOUND),
                       ("loss", TRAIN_LOSS_BOUND)):
        a, b = bf[0][key], f32[0][key]
        check(math.isfinite(a) and abs(a - b) <= bound * abs(b),
              f"{label}: {key} {a} under the default contract, {b} under "
              f"f32 (bound {bound} of it)")
    check(len(calls) == 2, f"{label}: {len(calls)} calls of kernel 9's bf16 "
          f"training form recorded, expected RCNN SA_0 and SA_1")
    row = {"launches": bf[1], "f32_launches": f32[1],
           "loss": bf[0]["loss"], "f32_loss": f32[0]["loss"],
           "rpn_loss": bf[0]["rpn_loss"], "f32_rpn_loss": f32[0]["rpn_loss"],
           "rcnn_loss": bf[0]["rcnn_loss"],
           "f32_rcnn_loss": f32[0]["rcnn_loss"],
           "grad_norms": bf[2], "f32_grad_norms": f32[2],
           "precision": str(bf[4])}
    print(f"{label} ({card}): default contract loss {bf[0]['loss']:.5f} (rpn "
          f"{bf[0]['rpn_loss']:.5f}, rcnn {bf[0]['rcnn_loss']:.5f}), f32 "
          f"{f32[0]['loss']:.5f} (rpn {f32[0]['rpn_loss']:.5f}, rcnn "
          f"{f32[0]['rcnn_loss']:.5f}); gradient norms {bf[2]} (f32 "
          f"{f32[2]}); launches {bf[1]} (f32 {f32[1]})")
    del f32, bf
    snaps = [_snapshot_step(bcfg, model, weights, batch)[1] for _ in range(2)]
    unequal = _unequal(*snaps)
    check(not unequal, f"{label}: two default-contract steps from one state "
          f"differ in {len(unequal)} tensors: {unequal[:4]}")
    row["repeat"] = {"tensors": len(snaps[0]), "unequal": unequal}
    print(f"{label}: two default-contract steps from one state equal to the "
          f"bit in all {len(snaps[0])} gradients, parameters, moments and "
          f"statistics")
    del snaps
    turns, peaks = _turns([(key, f32cfg if key == "f32" else bcfg, model,
                            weights) for key in ("f32", "bf16", "bf16",
                                                 "f32")], batch)
    row.update(ms_turns=turns["bf16"], f32_ms_turns=turns["f32"],
               peak_gib=peaks["bf16"], f32_peak_gib=peaks["f32"])
    print(f"{label} ({card}): ms/step in turns f32 {turns['f32'][0]:.1f}, "
          f"default {turns['bf16'][0]:.1f}, default {turns['bf16'][1]:.1f}, "
          f"f32 {turns['f32'][1]:.1f}; peak {peaks['bf16']:.2f} GiB (f32 "
          f"{peaks['f32']:.2f})")
    del model, weights
    torch.cuda.empty_cache()
    row["library_chain_ms"], row["bn_bf16_designs"] = bn_bf16_form_rows(
        report, calls, gen)
    return row


def remat_steps(cfg, f32cfg, model, weights, batch, card) -> dict:
    """Phase 19 (g): default.yaml at B=16 with and without TRAIN.REMAT
    under both training contracts, from the same weights, batch and draws:
    loss, every gradient, parameter, running statistic and Adam moment
    equal to the bit between the two; every kernel the step without the
    key launches, launched as often or more with it (the recomputed
    backbone); ms/step in turns (without, with, with, without) and the
    peak memory of each -> the figures."""
    import torch

    from tpu3d_torch.models import PointRCNN

    figures = {}
    for contract, c in (("default", cfg), ("f32", f32cfg)):
        rc = copy.deepcopy(c)
        rc.TRAIN.REMAT = True
        rmodel = PointRCNN(rc, mode="TRAIN", device=torch.device(DEVICE))
        check(rmodel.rpn.remat and not model.rpn.remat,
              "TRAIN.REMAT not read by the RPN")
        tb, plain, launches = _snapshot_step(c, model, weights, batch)
        rtb, remat, rlaunches = _snapshot_step(rc, rmodel, weights, batch)
        unequal = _unequal(plain, remat)
        check(not unequal and tb["loss"] == rtb["loss"],
              f"TRAIN.REMAT under the {contract} contract: loss {rtb['loss']}"
              f" against {tb['loss']}, {len(unequal)} tensors differ: "
              f"{unequal[:4]}")
        check(all(rlaunches.get(k, 0) >= v for k, v in launches.items()),
              f"TRAIN.REMAT under the {contract} contract launched "
              f"{rlaunches}, without it {launches}")
        del plain, remat
        turns, peaks = _turns([(key, rc if key == "remat" else c,
                                rmodel if key == "remat" else model, weights)
                               for key in ("plain", "remat", "remat",
                                           "plain")], batch)
        figures[contract] = {
            "loss": tb["loss"],
            "launches": launches, "remat_launches": rlaunches,
            "ms_turns": turns["plain"], "remat_ms_turns": turns["remat"],
            "peak_gib": peaks["plain"], "remat_peak_gib": peaks["remat"]}
        print(f"default.yaml train B={TRAIN_BATCH} with and without "
              f"TRAIN.REMAT under the {contract} training contract ({card}): "
              f"loss, gradients, parameters, statistics and moments equal to "
              f"the bit; ms/step in turns without {turns['plain'][0]:.1f}, "
              f"with {turns['remat'][0]:.1f}, with {turns['remat'][1]:.1f}, "
              f"without {turns['plain'][1]:.1f}; peak {peaks['plain']:.2f} "
              f"GiB without, {peaks['remat']:.2f} with; launches with "
              f"{rlaunches} (without {launches})")
        del rmodel
        torch.cuda.empty_cache()
    return figures


def train_numerics(card: str) -> tuple[Report, Report, dict]:
    """Phase 19 (the module docstring says what it holds) -> (the bf16
    training forms' report, the slab forms' at smoke.yaml's SA_1, the
    numbers for the JSON line)."""
    import torch

    from tpu3d_torch.config import cfg_from_file, cfg_from_list, fresh_cfg
    from tpu3d_torch.datasets import (create_synthetic_kitti, random_scenes,
                                      train_batch)
    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.ops import _build
    from tpu3d_torch.parallel import create_train_state, make_train_step
    from tpu3d_torch.tools import generate_gt_database, roofline
    from tpu3d_torch.tools.eval_rcnn import make_infer_step
    from tpu3d_torch.tools.train_rcnn import main as train_main
    from tpu3d_torch.weights import seeded_state_dict

    dev = torch.device(DEVICE)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 19)
    report = Report(peak_ops=PEAK_BF16_OPS_PER_S)
    smoke_report = Report(peak_ops=PEAK_BF16_OPS_PER_S)
    figures = {"card": card, "configs": {}}
    calls = {}  # by label, the recorded calls of the forms timed there
    keep = {"default.yaml train B=16": ("fused_sa_train_bf16",
                                        "three_interpolate_bwd_bf16",
                                        "group_points_bwd_bf16",
                                        "gather_bwd_grads"),
            QUICK_PATH["train"]: ("fused_sa_slab_train_bf16",),
            SMOKE_PATH["train"]: ("fused_sa_slab_train_bf16",)}
    designs = {}  # kernel 6's bf16 training forward, by config and call
    for label, name, batch_size in TRAIN_NUMERICS_CONFIGS:
        cfg = cfg_from_file(str(ROOT / "configs" / name), fresh_cfg())
        f32cfg = cfg_from_list(F32_TRAIN_SETS, copy.deepcopy(cfg))
        model = PointRCNN(cfg, mode="TRAIN", device=dev)
        weights = train_weights(model, SEED)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(
            batch_size, cfg.RPN.NUM_POINTS, SEED).items()}
        f32 = _one_step(f32cfg, model, weights, batch)
        bf = _one_step(cfg, model, weights, batch, True)
        check(bf[4].dense_dtype == torch.bfloat16 and bf[4].sa_bf16
              and f32[4].dense_dtype is None and not f32[4].sa_bf16,
              f"{label}: contracts {bf[4]} / {f32[4]}")
        # every f32 launch of a form with a bf16 training form is that
        # form's; the gathers split as the route predicate says
        total, n_bf16 = bf16_gathers(cfg)
        want = {BF16_TRAIN_OF.get(k, k): v for k, v in f32[1].items()
                if k != "group_points_bwd"}
        check(f32[1].get("group_points_bwd", 0) == total, f"{label}: the "
              f"f32 step gathered {f32[1].get('group_points_bwd')} times, "
              f"the config {total}")
        if total - n_bf16:
            want["group_points_bwd"] = total - n_bf16
        if n_bf16:
            want["group_points_bwd_bf16"] = n_bf16
        check(bf[1] == want, f"{label}: the default contract's step launched "
              f"{bf[1]}, expected {want}")
        for key, bound in (("rpn_loss", RPN_LOSS_BOUND),
                           ("loss", TRAIN_LOSS_BOUND)):
            a, b = bf[0][key], f32[0][key]
            check(math.isfinite(a) and abs(a - b) <= bound * abs(b),
                  f"{label}: {key} {a} under the default contract, {b} "
                  f"under f32 (bound {bound} of it)")
        row = {"launches": bf[1], "f32_launches": f32[1],
               "loss": bf[0]["loss"], "f32_loss": f32[0]["loss"],
               "rpn_loss": bf[0]["rpn_loss"],
               "f32_rpn_loss": f32[0]["rpn_loss"],
               "rcnn_loss": bf[0]["rcnn_loss"],
               "f32_rcnn_loss": f32[0]["rcnn_loss"],
               "grad_norms": bf[2], "f32_grad_norms": f32[2],
               "gathers": total, "bf16_gathers": n_bf16,
               "precision": str(bf[4])}
        print(f"{label} ({card}): default contract loss {bf[0]['loss']:.5f} "
              f"(rpn {bf[0]['rpn_loss']:.5f}, rcnn {bf[0]['rcnn_loss']:.5f}),"
              f" f32 {f32[0]['loss']:.5f} (rpn {f32[0]['rpn_loss']:.5f}, rcnn "
              f"{f32[0]['rcnn_loss']:.5f}); gradient norms {bf[2]} (f32 "
              f"{f32[2]}); launches {bf[1]} (f32 {f32[1]})")
        calls[label] = {k: bf[3][k] for k in keep.get(label, ())}
        # kernel 6's bf16 training forward at the config's own calls (the
        # default step's are also timed, in (a))
        designs[label] = (hold_train_forward(bf[3]["fused_sa_train_bf16"],
                                             label)
                          if "fused_sa_train_bf16" not in calls[label]
                          else [train_bf16_design(
                              a[3].shape[0], a[3].shape[1], a[5].shape[1],
                              label) for a in bf[3]["fused_sa_train_bf16"]])
        row["fused_sa_train_bf16_designs"] = designs[label]
        if label.startswith("default"):
            # (c) a second step from the same weights and draws, equal to
            # the first to the bit in every gradient, parameter, moment and
            # statistic
            snaps = [_snapshot_step(cfg, model, weights, batch)[1]
                     for _ in range(2)]
            unequal = _unequal(*snaps)
            check(not unequal, f"two default-contract steps from one state "
                  f"differ in {len(unequal)} tensors: {unequal[:4]}")
            row["repeat"] = {"tensors": len(snaps[0]), "unequal": unequal}
            print(f"{label}: two default-contract steps from one state equal "
                  f"to the bit in all {len(snaps[0])} gradients, parameters,"
                  f" moments and statistics")
            del snaps
            # (d) ms per step of both contracts in turns, with peak memory
            turns, peaks = _turns([(key, f32cfg if key == "f32" else cfg,
                                    model, weights) for key in
                                   ("f32", "bf16", "bf16", "f32")], batch)
            row.update(ms_turns=turns["bf16"], f32_ms_turns=turns["f32"],
                       peak_gib=peaks["bf16"], f32_peak_gib=peaks["f32"])
            print(f"{label} ({card}): ms/step in turns f32 "
                  f"{turns['f32'][0]:.1f}, default {turns['bf16'][0]:.1f}, "
                  f"default {turns['bf16'][1]:.1f}, f32 {turns['f32'][1]:.1f};"
                  f" peak {peaks['bf16']:.2f} GiB (f32 {peaks['f32']:.2f})")
            train_ms = statistics.median(turns["bf16"])
            # (f) the BatchNorm RCNN under the default training contract,
            # with kernel 9's bf16 form at its calls; (g) TRAIN.REMAT under
            # both contracts
            figures["configs"][BN_TRAIN_PATH] = bn_rcnn_bf16(
                cfg, batch, card, report, gen)
            figures["remat"] = remat_steps(cfg, f32cfg, model, weights,
                                           batch, card)
        figures["configs"][label] = row
        del model, weights, batch, f32, bf
        torch.cuda.empty_cache()

    # (a) each bf16 training form at the recorded calls
    for label, into in (("default.yaml train B=16", report),
                        (QUICK_PATH["train"], report),
                        (SMOKE_PATH["train"], smoke_report)):
        fused_train_form_rows(into, calls[label], gen)
        gather_train_form_rows(into, calls[label], gen)
    del calls
    # kernels 6 and 8's bf16 backward ran the tensor-core design at every
    # recorded call of the shipped configs
    for into in (report, smoke_report):
        for name in ("fused_sa_bwd_bf16", "fused_sa_slab_bwd_bf16"):
            if name in into.rows:
                r = into.rows[name]
                check(r["mma_calls"] > 0 and r["parent_calls"] == 0,
                      f"{name} ran the parent walk at {r['parent_calls']} "
                      f"of the shipped configs' calls")
    check(set(designs["default.yaml train B=16"]) == {"wgmma"},
          f"kernel 6's bf16 training forward ran the default step on "
          f"{designs['default.yaml train B=16']}")
    # the widened RCNN's levels (256 -> 384 -> 256 does not fit the wgmma
    # design's shared memory): the parent design, held the same way
    wide = widened_train_calls(gen)
    figures["widened_designs"] = hold_train_forward(
        wide, "the widened RCNN's SA_0 and SA_1")
    check(set(figures["widened_designs"]) == {"parent"},
          f"the widened RCNN ran {figures['widened_designs']}")
    # and kernel 6's bf16 backward there: the parent walk, held the same way
    figures["widened_bwd_designs"] = hold_train_backward(
        wide, "the widened RCNN's SA_0 and SA_1", gen)
    check(set(figures["widened_bwd_designs"]) == {"parent"},
          f"the widened RCNN's backward ran {figures['widened_bwd_designs']}")
    del wide
    figures["fused_sa_train_bf16_designs"] = designs
    torch.cuda.empty_cache()

    # the roofline's mfu_pct: the default train step under the default
    # training contract (d), and the eval batch (B=ROOFLINE_EVAL_BATCH)
    # under the default eval contract
    rcfg = roofline.default_cfg(str(ROOT / "configs" / "default.yaml"))
    emodel = PointRCNN(rcfg, mode="TEST", device=dev)
    emodel.load_state_dict(seeded_state_dict(emodel, SEED))
    epts = torch.from_numpy(random_scenes(
        ROOFLINE_EVAL_BATCH, rcfg.RPN.NUM_POINTS, SEED)).to(dev)
    infer = make_infer_step(emodel, rcfg)
    infer(epts)
    eval_ms = wall_ms(lambda: infer(epts), 5)
    rows = roofline.report(rcfg, eval_ms, train_ms, ROOFLINE_EVAL_BATCH,
                           TRAIN_BATCH, counted=False, device=DEVICE)
    figures["roofline"] = rows[:2]
    for r in rows[:2]:
        print(f"roofline {r['program']} under {r['precision']}: "
              f"{r['step_ms']:.1f} ms, {r['matmul_tflop_per_step']:.3f} TFLOP "
              f"({r['bf16_matmul_tflop_per_step']:.3f} in bf16), mfu_pct "
              f"{r['mfu_pct']} ({r['card']})")
    del emodel, epts
    torch.cuda.empty_cache()

    # (e) the training CLI (joint, phase 13's frames) and one rcnn_offline
    # epoch (phase 14's dumps) under the card's default training contract
    work = ROOT / "build" / "cli_smoke"
    data = work / "data"
    if not data.exists():  # phase 19 run alone
        create_synthetic_kitti(str(data), n_frames=CLI_FRAMES,
                               image_files=True)
        generate_gt_database.main(["--root", str(data), "--save_dir",
                                   str(work / "gt_database")])
    db = str(work / "gt_database" / "train_gt_database_3level_Car.pkl")
    _build.reset_launches()
    run = train_main([
        "--cfg_file", str(ROOT / "configs" / CLI_CFG), "--train_mode",
        "joint", "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
        "--data_root", str(data), "--gt_database", db,
        "--output_dir", str(ROOT / "build" / "cli_bf16"), "--device", DEVICE,
        "--set", "TRAIN.SPLIT", "trainval"])
    steps = len(run.losses)
    cli = {k: v for k, v in _launched().items()}
    check(steps == CLI_FRAMES // TRAIN_BATCH
          and all(math.isfinite(x) for x in run.losses),
          f"the training CLI under the default contract: {run.losses}")
    check(all(cli.get(k, 0) > 0 for k in ("fused_sa_train_bf16",
                                          "fused_sa_bwd_bf16",
                                          "three_interpolate_bwd_bf16"))
          and "fused_sa_train" not in cli, f"the training CLI under the "
          f"default contract launched {cli}")
    figures["training_cli"] = {
        "path": f"tools/train_rcnn.main, {CLI_CFG} joint B={TRAIN_BATCH}, "
                f"{CLI_FRAMES} frames, 1 epoch", "losses": run.losses,
        "step_ms": run.step_ms,
        "launches_per_step": {k: v / steps for k, v in cli.items()}}
    print(f"training CLI under the default contract ({card}): ms/step "
          f"{[round(x, 1) for x in run.step_ms]}, losses {run.losses}, "
          f"launches per step {figures['training_cli']['launches_per_step']}")
    del run
    dumps = ROOT / "build" / "eval_smoke" / "rpn"
    if (dumps / "features").exists():
        _build.reset_launches()
        off = train_main([
            "--cfg_file", str(ROOT / "configs" / CLI_CFG), "--train_mode",
            "rcnn_offline", "--batch_size", str(OFFLINE_BATCH), "--epochs",
            "1", "--data_root", str(data), "--output_dir",
            str(ROOT / "build" / "offline_bf16"), "--device", DEVICE,
            "--rcnn_training_roi_dir", str(dumps / "detections" / "data"),
            "--rcnn_training_feature_dir", str(dumps / "features"), "--set",
            "TRAIN.SPLIT", "trainval"])
        olaunch = _launched()
        check(all(math.isfinite(x) for x in off.losses)
              and olaunch.get("fused_sa_train_bf16", 0) > 0
              and "fused_sa_train" not in olaunch, f"rcnn_offline under the "
              f"default contract: losses {off.losses}, launches {olaunch}")
        figures["rcnn_offline"] = {"losses": off.losses,
                                   "step_ms": off.step_ms,
                                   "launches": olaunch}
        print(f"rcnn_offline under the default contract: ms/step "
              f"{[round(x, 1) for x in off.step_ms]}, losses {off.losses}, "
              f"launches {olaunch}")
        del off
    torch.cuda.empty_cache()
    return report, smoke_report, figures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # phases 1-18 train under the f32 training contract (both TRAIN keys
    # False) and phases 1-17 evaluate under the f32 eval contract, each
    # with its own bounds; phase 18 takes the card's default eval contract,
    # phase 19 its default training contract
    f32_train = contextlib.ExitStack()
    f32_train.enter_context(f32_training())
    f32_before = os.environ.get("TPU3D_F32_EVAL")
    os.environ["TPU3D_F32_EVAL"] = "1"
    from tpu3d_torch.config import cfg_from_file, fresh_cfg
    from tpu3d_torch.datasets import random_scenes, train_batch
    from tpu3d_torch.models import PointRCNN
    from tpu3d_torch.ops import _build
    from tpu3d_torch.ops import furthest_point_sample_with_3nn, gather_points
    from tpu3d_torch.tools.kernel_bench import (dense_inputs, fps_pyramid,
                                                record_nearest_k)
    from tpu3d_torch.tools.eval_rcnn import (make_infer_step,
                                             make_rpn_infer_step)

    phases = Phases()
    from tpu3d_torch.tools.train_rcnn import configure_mode
    from tpu3d_torch.weights import seeded_state_dict

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn tf32 {torch.backends.cudnn.allow_tf32}")
    phases.done("1 (card)")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(logs) or 'nothing (already built)'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties for" in line:  # the (mangled) kernel
                print(f"  ptxas {name}: {line.split(' for ')[-1][:72]}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    for name in (*_build.KERNELS, *_build.BF16_KERNELS):
        _build.kernel(name)
    phases.done("2 (build)")

    # configs/default.yaml as shipped runs the joint path; the RPN-only
    # path is the same model with RCNN off and the RPN's weights
    cfg = cfg_from_file(str(ROOT / "configs" / "default.yaml"), fresh_cfg())
    check(cfg.RCNN.ENABLED, "default.yaml should enable the RCNN stage")
    rpn_cfg = copy.deepcopy(cfg)
    rpn_cfg.RCNN.ENABLED = False
    B, N = BATCH, cfg.RPN.NUM_POINTS
    dev = torch.device(DEVICE)
    pts = torch.from_numpy(random_scenes(B, N, SEED)).to(dev)
    model = PointRCNN(cfg, mode="TEST", device=dev)
    state = seeded_state_dict(model, SEED)
    model.load_state_dict(state)
    rpn_model = PointRCNN(rpn_cfg, mode="TEST", device=dev)
    rpn_state = {k: v for k, v in state.items() if k.startswith("rpn.")}
    rpn_model.load_state_dict(rpn_state)

    # the train step: the same config in joint mode (as shipped), B=16
    # scenes with their gt boxes, on the model in TRAIN mode
    train_model = PointRCNN(cfg, mode="TRAIN", device=dev)
    train_state = train_weights(train_model, SEED)
    train_model.load_state_dict(train_state)
    tb_np = train_batch(TRAIN_BATCH, N, SEED)
    tbatch = {k: torch.from_numpy(v).to(dev) for k, v in tb_np.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the targets the step's RCNN sees and the step's nearest_k calls, for
    # phase 3; the eval forward's nearest_k calls and pooled ROIs
    with record_nearest_k() as train_nk:
        target = sampled_targets(train_model, tbatch, train_state, gen)
    with record_nearest_k() as eval_nk:
        eval_xyz, eval_rest = pooled_inputs(model, pts)

    # configs/double.yaml: default.yaml at 32768 points per scene, so the
    # same parameter tree and seeded weights; eval at B=4, train at B=16
    dcfg = cfg_from_file(str(ROOT / "configs" / "double.yaml"), fresh_cfg())
    DN = dcfg.RPN.NUM_POINTS
    check(DN == 32768 and dcfg.RCNN.ENABLED,
          "double.yaml should run 32768 points per scene, RCNN on")
    dpts = torch.from_numpy(random_scenes(DOUBLE_BATCH, DN, SEED)).to(dev)
    dtbatch = {k: torch.from_numpy(v).to(dev)
               for k, v in train_batch(TRAIN_BATCH, DN, SEED).items()}
    sa0 = dcfg.RPN.SA_CONFIG.NPOINTS[0]

    # configs/quickstart.yaml and configs/smoke.yaml as shipped, each with
    # its own seeded weights: eval and train batches, and the targets of
    # the train step's RCNN
    side = {}
    for name, eval_b, train_b in (
            ("quickstart", QUICK_EVAL_BATCH, QUICK_TRAIN_BATCH),
            ("smoke", SMOKE_BATCH, SMOKE_BATCH)):
        c = cfg_from_file(str(ROOT / "configs" / f"{name}.yaml"), fresh_cfg())
        m = PointRCNN(c, mode="TEST", device=dev)
        m.load_state_dict(seeded_state_dict(m, SEED))
        tm = PointRCNN(c, mode="TRAIN", device=dev)
        ts = train_weights(tm, SEED)
        tm.load_state_dict(ts)
        n = c.RPN.NUM_POINTS
        tb = {k: torch.from_numpy(v).to(dev)
              for k, v in train_batch(train_b, n, SEED).items()}
        side[name] = dict(
            cfg=c, model=m, train_model=tm, tbatch=tb,
            pts=torch.from_numpy(random_scenes(eval_b, n, SEED)).to(dev),
            target=sampled_targets(tm, tb, ts, gen))
    q, sm = side["quickstart"], side["smoke"]

    # default.yaml with RCNN.USE_BN true (no file in configs/ sets it): the
    # RCNN's BatchNorm parameters and statistics seeded away from 0 and 1,
    # eval on the default scenes
    bcfg = copy.deepcopy(cfg)
    bcfg.RCNN.USE_BN = True
    bmodel = PointRCNN(bcfg, mode="TEST", device=dev)
    bstate = seeded_state_dict(bmodel, SEED)
    bmodel.load_state_dict(bstate)
    check(any(".bn_" in k for k in bstate if k.startswith("rcnn_net.sa_0")),
          "the BatchNorm RCNN has no BatchNorm in its SA levels")
    # the same config in training, its own generator so that the draws of
    # the earlier phases stay as they were: the train step at B=16 on the
    # default batch, and the targets its RCNN sees, for phase 3
    btrain_model = PointRCNN(bcfg, mode="TRAIN", device=dev)
    btrain_state = train_weights(btrain_model, SEED)
    btrain_model.load_state_dict(btrain_state)
    btbatch = tbatch
    bgen = torch.Generator(device=dev).manual_seed(SEED + 6)
    btarget = sampled_targets(btrain_model, btbatch, btrain_state, bgen)
    phases.done("setup")

    # 3. each kernel against its plain version, at its path's shapes
    report, double_report = Report(), Report()
    train_report, dense_report = Report(), Report()
    rpn_kernels(report, cfg, pts, "default.yaml eval B=2")
    with torch.no_grad():
        eval_features = model.rcnn_net.point_features(eval_xyz, eval_rest)
    rcnn_kernels(report, model.rcnn_net, eval_xyz, eval_features,
                 "default.yaml eval B=2")
    del eval_xyz, eval_rest, eval_features
    # the train step's shapes of the eval kernels (B=16, 1024 ROIs)
    rpn_kernels(train_report, cfg, tbatch["pts_input"],
                "default.yaml train B=16", fps3nn=False)
    rcnn_kernels(train_report, train_model.rcnn_net, target["sampled_pts"],
                 None, "default.yaml train B=16")
    # nearest_k at the six levels of the eval forward and of the train
    # step, on the dense box, and at double.yaml's SA_0 (eval B=4)
    nk_sweep = []
    nearest_k_kernels(report, eval_nk, "default.yaml eval B=2", nk_sweep)
    nearest_k_kernels(train_report, train_nk, "default.yaml train B=16",
                      nk_sweep)
    nearest_k_kernels(dense_report, dense_inputs(
        torch.Generator(device=dev).manual_seed(SEED)), "dense box",
        nk_sweep)
    dsa = dcfg.RPN.SA_CONFIG
    check_nearest_k(double_report, fps_pyramid(dpts, (sa0,))[1], dpts,
                    max(dsa.NSAMPLE[0]), max(dsa.RADIUS[0]), True,
                    "double.yaml eval B=4, RPN SA_0", nk_sweep)
    del eval_nk, train_nk
    torch.cuda.empty_cache()
    interp_bwd_kernels(report, cfg, tbatch["pts_input"])
    group_bwd_kernels(report, train_model, tbatch)
    full_spread = {}
    fused_train_kernels(report, full_spread, train_model, target)
    torch.cuda.empty_cache()
    three_nn_sweep = []
    double_kernels(report, double_report, dpts,
                   dtbatch["pts_input"][..., :3].contiguous(), sa0,
                   three_nn_sweep)
    torch.cuda.empty_cache()
    # FPS's pick loop at every level it serves on each path: its launch
    # geometry and the sweep around it, the 3-NN pass, the latency floor
    fps_rows, fps_floor = fps_pick_loop({
        path: (p["pts_input"][..., :3].contiguous() if isinstance(p, dict)
               else p, c.RPN.SA_CONFIG.NPOINTS)
        for path, p, c in (
            ("default.yaml eval B=2", pts, cfg),
            ("default.yaml train B=16", tbatch, cfg),
            ("double.yaml eval B=4", dpts, dcfg),
            ("double.yaml train B=16", dtbatch, dcfg),
            (QUICK_PATH["eval"], q["pts"], q["cfg"]),
            (QUICK_PATH["train"], q["tbatch"], q["cfg"]),
            (SMOKE_PATH["eval"], sm["pts"], sm["cfg"]),
            (SMOKE_PATH["train"], sm["tbatch"], sm["cfg"]))})
    torch.cuda.empty_cache()
    # three_nn at the split route's levels of quickstart and smoke (their
    # eval paths' rows kept apart in quick_report and smoke_report), then
    # at the levels that place the route's threshold
    quick_report, smoke_report = Report(), Report()
    split_three_nn({
        path: (p["pts_input"][..., :3].contiguous() if isinstance(p, dict)
               else p, c["cfg"].RPN.SA_CONFIG.NPOINTS)
        for path, p, c in ((QUICK_PATH["eval"], q["pts"], q),
                           (QUICK_PATH["train"], q["tbatch"], q),
                           (SMOKE_PATH["eval"], sm["pts"], sm),
                           (SMOKE_PATH["train"], sm["tbatch"], sm))},
        {QUICK_PATH["eval"]: quick_report, SMOKE_PATH["eval"]: smoke_report},
        three_nn_sweep)
    # the slab forward's packed launch at S 16, 32 and 64
    slab_group_rows = slab_groups()
    torch.cuda.empty_cache()
    # the slab form: the eval kernel at RCNN SA_1 of quickstart.yaml's and
    # smoke.yaml's eval forward, the training kernels at RCNN SA_1 of their
    # train steps' sampled rows (smoke's kept apart in smoke_report), the
    # eval kernel with BatchNorm packs at RCNN SA_0 and SA_1 of the
    # BatchNorm RCNN's eval forward
    slab_gen = torch.Generator(device="cpu").manual_seed(SEED + 4)
    slab_cases = (
        (QUICK_PATH["eval"], q["model"], pooled_inputs(q["model"], q["pts"]),
         report, [1], False),
        (SMOKE_PATH["eval"], sm["model"], pooled_inputs(sm["model"],
                                                        sm["pts"]),
         smoke_report, [1], False),
        (QUICK_PATH["train"], q["train_model"],
         (q["target"]["sampled_pts"], q["target"]["pts_feature"]), report,
         [1], True),
        (SMOKE_PATH["train"], sm["train_model"],
         (sm["target"]["sampled_pts"], sm["target"]["pts_feature"]),
         smoke_report, [1], True),
        (BN_PATH, bmodel, pooled_inputs(bmodel, pts), report, [0, 1], False))
    for path, mdl, inputs, into, expect_levels, train in slab_cases:
        levels = slab_levels(mdl, *inputs)
        check([k for k, _, _ in levels] == expect_levels,
              f"{path}: the slab route at RCNN SA_"
              f"{[k for k, _, _ in levels]}, expected {expect_levels}")
        for k, x0, mlp in levels:
            label = f"{path}, RCNN SA_{k}"
            if train:
                for name, (*row, counts) in slab_train_kernels(
                        x0, mlp, label, slab_gen).items():
                    into.add(name, *row, **counts)
            else:
                name, row = slab_eval_kernel(x0, mlp, label)
                into.add(name, *row)
        del levels
        torch.cuda.empty_cache()
    # the BatchNorm chain's training kernels at RCNN SA_0 and SA_1 of the
    # BatchNorm RCNN's train step (B=16)
    bn_library = bn_train_kernels(report, btrain_model, btarget,
                                  BN_TRAIN_PATH)
    torch.cuda.empty_cache()
    # every fused entry at the widened shapes
    wide_worst = wide_kernels()
    torch.cuda.empty_cache()
    phases.done("3 (kernels against plain)")

    # 4. both paths at full width
    post = cfg.TEST.RPN_POST_NMS_TOP_N
    feat_c = cfg.RPN.FP_MLPS[0][-1]
    rpn_out, _, rpn_path_ms = drive(
        make_rpn_infer_step(rpn_model, rpn_cfg), pts,
        ("fps3nn", "nearest_k", "three_interpolate"), "RPN-only")
    check_outputs(rpn_out, {
        "rois": (B, post, 7), "roi_scores_raw": (B, post),
        "roi_valid": (B, post), "seg_result": (B, N),
        "rpn_scores_raw": (B, N), "backbone_xyz": (B, N, 3),
        "backbone_features": (B, N, feat_c)})

    torch.cuda.reset_peak_memory_stats()
    out, launches, path_ms = drive(make_infer_step(model, cfg), pts,
                                   EVAL_KERNELS, "joint")
    check_joint_outputs(cfg, out, B, "default")
    kernels_ms = sum(report.rows[k]["ms"] for k in EVAL_KERNELS)
    print(f"joint path {path_ms:.1f} ms/batch, RPN-only path "
          f"{rpn_path_ms:.1f} ms/batch; the five kernels {kernels_ms:.1f} ms "
          f"of device time per joint forward; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phases.done("4 (eval paths)")

    # 5. the train step at full width, joint mode, then rpn mode
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tb, train_launches, step_ms = drive_train(
        cfg, train_model, tbatch, gen, TRAIN_KERNELS, "joint train step", 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"joint train step: B={TRAIN_BATCH} N={N} TRAIN pre/post NMS "
          f"{cfg.TRAIN.RPN_PRE_NMS_TOP_N}/{cfg.TRAIN.RPN_POST_NMS_TOP_N}, "
          f"{cfg.RCNN.ROI_PER_IMAGE} ROIs of {cfg.RCNN.NUM_POINTS} points "
          f"per scene: {step_ms:.1f} ms/step, peak device memory "
          f"{peak:.2f} GiB; rpn_loss {float(tb['rpn_loss']):.4f}, rcnn_loss "
          f"{float(tb['rcnn_loss']):.4f}, sampled fg {int(tb['rcnn_cls_fg'])}"
          f" / bg {int(tb['rcnn_cls_bg'])}")
    rpn_train_cfg = configure_mode(copy.deepcopy(cfg), "rpn")
    rpn_train_model = PointRCNN(rpn_train_cfg, mode="TRAIN", device=dev)
    rpn_train_model.load_state_dict(
        {k: v for k, v in train_state.items() if k.startswith("rpn.")})
    drive_train(rpn_train_cfg, rpn_train_model, tbatch, gen,
                RPN_TRAIN_KERNELS, "rpn-mode train step", 1)
    del rpn_train_model
    torch.cuda.empty_cache()
    phases.done("5 (train steps)")

    # 6. scene 0 through the plain path on the CPU
    cpu_model = PointRCNN(cfg, mode="TEST", device="cpu")
    cpu_model.load_state_dict(state)
    x_cpu = pts[:1].cpu()
    mismatches, x_gpu = 0, pts[:1]
    for npoint in cfg.RPN.SA_CONFIG.NPOINTS:
        i_cpu = furthest_point_sample_with_3nn(x_cpu, npoint)[0]
        i_gpu = furthest_point_sample_with_3nn(x_gpu, npoint)[0]
        mismatches += int((i_cpu != i_gpu.cpu()).sum())
        x_cpu, x_gpu = gather_points(x_cpu, i_cpu), gather_points(x_gpu, i_gpu)
    print(f"FPS picks, CUDA kernel vs plain CPU path on scene 0: "
          f"{mismatches} mismatches")
    check(mismatches == 0, "FPS picks differ between the card and the CPU")
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = cpu_model.rpn(pts[:1].cpu())
    cpu_s = time.perf_counter() - t0
    with torch.no_grad():
        got = model.rpn(pts[:1])
    for key in ("rpn_cls", "rpn_reg", "backbone_features"):
        a, b = got[key].cpu(), ref[key]
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        print(f"{key}: card vs CPU max abs err {err:.3e} (max |value| "
              f"{scale:.3e})")
        # f32 sums in another order on the two devices; tolerance 1e-4
        # relative to the largest value
        check(err <= 1e-4 * max(scale, 1.0), f"{key} differs by {err}")
    print(f"CPU plain path: {cpu_s:.1f} s for scene 0's RPN")
    with torch.no_grad():
        joint = model({"pts_input": pts})
    joint["rpn_scores_raw"] = joint["rpn_cls"][..., 0]
    compare_rcnn_on_cpu(cfg, model, cpu_model, joint)
    compare_train_on_cpu(cfg, train_model, target, tbatch)
    del model, rpn_model, train_model, cpu_model, joint, target, tbatch
    torch.cuda.empty_cache()
    phases.done("6 (card against CPU)")

    # 7. configs/double.yaml: the joint eval path at B=4, the joint train
    # step at B=16, and scene 0's split route against the CPU
    dmodel = PointRCNN(dcfg, mode="TEST", device=dev)
    dmodel.load_state_dict(state)
    torch.cuda.reset_peak_memory_stats()
    dout, dlaunches, dpath_ms = drive(make_infer_step(dmodel, dcfg), dpts,
                                      EVAL_KERNELS, "double joint")
    n_levels = len(dcfg.RPN.SA_CONFIG.NPOINTS)
    check(dlaunches["fps3nn"] == n_levels,
          f"double eval launched fps3nn {dlaunches['fps3nn']} times, "
          f"expected once per RPN level ({n_levels})")
    check(dlaunches["three_nn"] == 0 and dlaunches["fps_long"] == 0,
          "double eval should take the fused route at every level")
    check_joint_outputs(dcfg, dout, DOUBLE_BATCH, "double")
    print(f"double joint path: {dpath_ms:.1f} ms/batch, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del dmodel, dout
    torch.cuda.empty_cache()

    dtrain_model = PointRCNN(dcfg, mode="TRAIN", device=dev)
    dtrain_model.load_state_dict(train_state)
    torch.cuda.reset_peak_memory_stats()
    dtb, dtrain_launches, dstep_ms = drive_train(
        dcfg, dtrain_model, dtbatch, gen, DOUBLE_TRAIN_KERNELS,
        "double joint train step", 3)
    dpeak = torch.cuda.max_memory_allocated() / 2**30
    check(dtrain_launches["three_nn"] == 1 and dtrain_launches["fps_long"] == 1,
          "the double train step should launch three_nn and fps_long once "
          "(SA_0's split route)")
    print(f"double joint train step: B={TRAIN_BATCH} N={DN}: {dstep_ms:.1f} "
          f"ms/step, peak device memory {dpeak:.2f} GiB; rpn_loss "
          f"{float(dtb['rpn_loss']):.4f}, rcnn_loss "
          f"{float(dtb['rcnn_loss']):.4f}")
    del dtrain_model
    torch.cuda.empty_cache()
    compare_split_on_cpu(dtbatch["pts_input"][..., :3].contiguous(), sa0)
    phases.done("7 (double.yaml)")

    # 8. configs/quickstart.yaml: the joint eval path at B=8 and the joint
    # train step at B=4, then scene 0 against the CPU plain path
    qcfg = q["cfg"]
    torch.cuda.reset_peak_memory_stats()
    qout, qlaunches, qpath_ms = drive(make_infer_step(q["model"], qcfg),
                                      q["pts"], tuple(QUICK_EVAL),
                                      "quickstart joint")
    check_launches(qlaunches, QUICK_EVAL, "quickstart eval")
    check_joint_outputs(qcfg, qout, QUICK_EVAL_BATCH, "quickstart")
    print(f"quickstart joint path: B={QUICK_EVAL_BATCH} {qpath_ms:.1f} "
          f"ms/batch, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    _, qtrain_launches, qstep_ms = drive_train(
        qcfg, q["train_model"], q["tbatch"], gen, tuple(QUICK_TRAIN),
        "quickstart joint train step", 5)
    check_launches(qtrain_launches, QUICK_TRAIN, "quickstart train step")
    print(f"quickstart joint train step: B={QUICK_TRAIN_BATCH} "
          f"{qstep_ms:.1f} ms/step, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    qcpu = PointRCNN(qcfg, mode="TEST", device="cpu")
    qcpu.load_state_dict({k: v.cpu() for k, v in
                          q["model"].state_dict().items()})
    with torch.no_grad():
        joint = q["model"]({"pts_input": q["pts"]})
    joint["rpn_scores_raw"] = joint["rpn_cls"][..., 0]
    compare_rcnn_on_cpu(qcfg, q["model"], qcpu, joint)
    compare_train_on_cpu(qcfg, q["train_model"], q["target"], q["tbatch"],
                         rpn=False)
    del qcpu, joint, qout, side, q
    torch.cuda.empty_cache()
    phases.done("8 (quickstart.yaml)")

    # 9. configs/smoke.yaml: the joint eval path and the joint train step,
    # both at B=2
    scfg = sm["cfg"]
    sout, slaunches, spath_ms = drive(make_infer_step(sm["model"], scfg),
                                      sm["pts"], tuple(SMOKE_EVAL),
                                      "smoke joint")
    check_launches(slaunches, SMOKE_EVAL, "smoke eval")
    check_joint_outputs(scfg, sout, SMOKE_BATCH, "smoke")
    _, strain_launches, sstep_ms = drive_train(
        scfg, sm["train_model"], sm["tbatch"], gen, tuple(SMOKE_TRAIN),
        "smoke joint train step", 3)
    check_launches(strain_launches, SMOKE_TRAIN, "smoke train step")
    print(f"smoke joint path: B={SMOKE_BATCH} {spath_ms:.1f} ms/batch; "
          f"joint train step: B={SMOKE_BATCH} {sstep_ms:.1f} ms/step")
    del sm, sout
    phases.done("9 (smoke.yaml)")

    # 10. default.yaml with RCNN.USE_BN true: the joint eval path at B=2,
    # then scene 0's RCNN stage and final boxes against the CPU plain path
    torch.cuda.reset_peak_memory_stats()
    bout, blaunches, bpath_ms = drive(make_infer_step(bmodel, bcfg), pts,
                                      tuple(BN_EVAL), "BatchNorm RCNN joint")
    check_launches(blaunches, BN_EVAL, "BatchNorm RCNN eval")
    check_joint_outputs(bcfg, bout, BN_BATCH, "BatchNorm RCNN")
    print(f"BatchNorm RCNN joint path: B={BN_BATCH} {bpath_ms:.1f} ms/batch, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    bcpu = PointRCNN(bcfg, mode="TEST", device="cpu")
    bcpu.load_state_dict(bstate)
    with torch.no_grad():
        joint = bmodel({"pts_input": pts})
    joint["rpn_scores_raw"] = joint["rpn_cls"][..., 0]
    compare_rcnn_on_cpu(bcfg, bmodel, bcpu, joint)
    del bmodel, bcpu, joint, bout
    torch.cuda.empty_cache()
    phases.done("10 (BatchNorm RCNN)")

    # 11. default.yaml with RCNN.USE_BN true in training: the joint train
    # step at B=16, whose RCNN SA levels run the BatchNorm chain's seven
    # training kernels in place of the gather form's training pair; its
    # running statistics; scene 0's RCNN training against the CPU
    bn_train = {k: v for k, v in train_launches.items()
                if v and k not in ("fused_sa_train", "fused_sa_bwd")}
    bn_train.update({k: 2 for k in BN_TRAIN_KERNELS})
    # the two slab levels group their slabs with the gather
    bn_train["group_points_bwd"] += 2
    torch.cuda.reset_peak_memory_stats()
    btb, btrain_launches, bstep_ms = drive_train(
        bcfg, btrain_model, btbatch, bgen, tuple(bn_train),
        "BatchNorm RCNN joint train step", 3)
    bpeak = torch.cuda.max_memory_allocated() / 2**30
    check_launches(btrain_launches, bn_train, "BatchNorm RCNN train step")
    print(f"BatchNorm RCNN joint train step: B={TRAIN_BATCH} N={N}: "
          f"{bstep_ms:.1f} ms/step, peak device memory {bpeak:.2f} GiB; "
          f"rpn_loss {float(btb['rpn_loss']):.4f}, rcnn_loss "
          f"{float(btb['rcnn_loss']):.4f}; launches as expected: "
          f"{bn_train}")
    check_bn_running_stats(bcfg, btrain_model, btbatch, bgen)
    compare_train_on_cpu(bcfg, btrain_model, btarget, btbatch, rpn=False,
                         rcnn_floor=True)
    del btrain_model, btarget, btbatch
    torch.cuda.empty_cache()
    phases.done("11 (BatchNorm RCNN training)")

    # 12. the widened configuration (RCNN SA_0 at 128 slots, MLPs 256 /
    # 384), without and with BatchNorm: eval and a train step at B=2
    wbatch = {k: torch.from_numpy(v).to(dev)
              for k, v in train_batch(WIDE_BATCH, N, SEED).items()}
    wide_runs = widened_paths(cfg, pts, wbatch)
    del wbatch
    torch.cuda.empty_cache()
    phases.done("12 (widened configuration)")

    # 13. the training CLI from frames on disk: two unbroken runs, one
    # resumed, the card-written checkpoint read back on the host
    cli_launches, cli = training_cli(smi[0])
    phases.done("13 (training CLI from disk)")

    # 14. the eval CLI in joint and rpn mode, the evaluator, rcnn_offline
    # training and eval from the RPN dumps
    ecli_launches, offline_launches, ecli = eval_cli(smi[0])
    phases.done("14 (eval CLI, evaluator, RCNN-offline)")

    # 15. tpu3d's data-parallel mesh: NCCL at a world of 1, then two gloo
    # ranks on the card
    dp = data_parallel(smi[0], step_ms, {k: v for k, v in
                                         train_launches.items() if v},
                       {k: v for k, v in btrain_launches.items() if v})
    phases.done("15 (data-parallel mesh)")

    # 16. the paper's slice: the PointNet++ demo, offline augmentation, the
    # statistical-normalization study at a smoke scale, the Cyclist class
    paper = paper_slice(smi[0])
    phases.done("16 (PointNet++ demo, aug scenes, statnorm study, Cyclist)")

    # 17. the last modules: RCNN.USE_INTENSITY, default_people.yaml, the
    # roofline, the dispatch probe, a profiled batch's trace, the loader
    last = last_modules(smi[0], {k: v for k, v in launches.items() if v},
                        {k: v for k, v in train_launches.items() if v})
    phases.done("17 (USE_INTENSITY, default_people, roofline, dispatch, "
                "trace, loader)")

    # 18. the eval numerics contract: the card's default against
    # TPU3D_F32_EVAL=1, the bf16 forms against their plain versions
    if f32_before is None:
        os.environ.pop("TPU3D_F32_EVAL")
    else:
        os.environ["TPU3D_F32_EVAL"] = f32_before
    torch.cuda.empty_cache()
    bf16_report, bf16_launches, numerics = eval_numerics(smi[0])
    phases.done("18 (eval numerics contract)")

    # 19. the training numerics contract: the bf16 training forms against
    # their plain versions, the four configs' train steps under the card's
    # default training contract against the f32 one, a repeated step, the
    # turns, the CLIs, the named errors
    f32_train.close()
    torch.cuda.empty_cache()
    train_report, train_smoke_report, train_figs = train_numerics(smi[0])
    phases.done("19 (training numerics contract)")

    # 20. kernels line and result line: launches from the path each kernel
    # was timed at (per forward or per train step), and on the other paths
    runs = {"default.yaml eval B=2": launches,
            "default.yaml train B=16": train_launches,
            "double.yaml eval B=4": dlaunches,
            "double.yaml train B=16": dtrain_launches,
            QUICK_PATH["eval"]: qlaunches, QUICK_PATH["train"]: qtrain_launches,
            SMOKE_PATH["eval"]: slaunches, SMOKE_PATH["train"]: strain_launches,
            BN_PATH: blaunches, BN_TRAIN_PATH: btrain_launches}
    kernels = []
    for name in report.rows:
        slab_mode = ("train" if name in ("fused_sa_slab_train",
                                         "fused_sa_slab_bwd") else "eval")
        path = ("double.yaml train B=16" if name in ("three_nn", "fps_long")
                else BN_PATH if name == "fused_sa_slab_bn"
                else BN_TRAIN_PATH if name in BN_TRAIN_KERNELS
                else QUICK_PATH[slab_mode] if name.startswith("fused_sa_slab")
                else "default.yaml eval B=2" if name in EVAL_KERNELS
                else "default.yaml train B=16")
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": runs[path][name],
            "path": path, "train_launches": train_launches[name],
            "double_eval_launches": dlaunches[name],
            "double_train_launches": dtrain_launches[name],
            "quickstart_eval_launches": qlaunches[name],
            "quickstart_train_launches": qtrain_launches[name],
            "smoke_eval_launches": slaunches[name],
            "smoke_train_launches": strain_launches[name],
            "bn_eval_launches": blaunches[name],
            "bn_train_launches": btrain_launches[name],
            "cli_launches": cli_launches[name],
            "eval_cli_launches": ecli_launches[name],
            "offline_launches": offline_launches[name],
            "ddp_launches": dp["ddp_launches"].get(name, 0),
            "ddp_bn_launches": dp["ddp_bn_launches"].get(name, 0),
            "pn_train_launches": PN_TRAIN.get(name, 0),
            "pn_eval_launches": PN_EVAL.get(name, 0),
            **report.row(name),
            "status": ("ported" if name != "group_points_bwd" else
                       "no TPU kernel: the fixed-order repair of "
                       "torch.gather's backward")}
        # the same kernel at another path's shapes: double.yaml's SA_0, the
        # smoke slab, the train step's shapes of the eval kernels, and the
        # dense box at the eval shapes (launches of the path it stands for)
        for extra, at, where, inputs in (
                (double_report, "at_32768", "double.yaml eval B=4", None),
                (quick_report, "at_quickstart", QUICK_PATH[slab_mode], None),
                (smoke_report, "at_smoke", SMOKE_PATH[slab_mode], None),
                (train_report, "at_train", "default.yaml train B=16", None),
                (dense_report, "at_dense", "default.yaml eval B=2",
                 "the dense box")):
            if name in extra.rows:
                row[at] = {"path": where, "launches": runs[where][name],
                           **extra.row(name)}
                if inputs:
                    row[at]["inputs"] = inputs
        kernels.append(row)
    # the bf16 forms: launches on the path of phase 18 each was timed at
    bf16_paths = {"three_interpolate_bf16": "default.yaml eval B=2",
                  "fused_sa_bf16": "default.yaml eval B=2",
                  "fused_sa_slab_bf16": QUICK_PATH["eval"],
                  "fused_sa_slab_bn_bf16": BN_PATH}
    for name in bf16_report.rows:
        kernels.append({
            "name": name, "route": "cuda", "source": BF16_SOURCES[name][0],
            "replaces": BF16_SOURCES[name][1],
            "launches": bf16_launches[name], "path": bf16_paths[name],
            "contract": "the card's default eval contract (bf16)",
            "launches_by_config": {
                label: row["launches"].get(name, 0)
                for label, row in numerics["configs"].items()},
            "pn_train_launches": PN_TRAIN.get(name, 0),
            "pn_eval_launches": PN_EVAL.get(name, 0),
            **bf16_report.row(name),
            "at_paths": {label: rows[name] for label, rows in
                         numerics["bf16_at_paths"].items() if name in rows},
            "status": "ported"})
    # the bf16 training forms: launches on the path of phase 19 each was
    # timed at, and their other configs' (the slab forms also timed at
    # smoke.yaml's)
    for name in train_report.rows:
        path = TRAIN_FORM_PATHS[name]
        by_config = {label: row["launches"].get(name, 0)
                     for label, row in train_figs["configs"].items()}
        row = {
            "name": name, "route": "cuda", "source": BF16_SOURCES[name][0],
            "replaces": BF16_SOURCES[name][1], "launches": by_config[path],
            "path": path,
            "contract": "the card's default training contract (bf16)",
            "launches_by_config": by_config,
            "cli_launches_per_step": train_figs["training_cli"][
                "launches_per_step"].get(name, 0),
            "pn_train_launches": PN_TRAIN.get(name, 0),
            **train_report.row(name),
            "status": ("ported" if name != "group_points_bwd_bf16" else
                       "no TPU kernel: the bf16 form of the fixed-order "
                       "gather backward (tpu3d's gather_mxu_bwd and "
                       "onehot_bf16 VJPs)")}
        if name in train_smoke_report.rows:
            row["at_smoke"] = {"path": SMOKE_PATH["train"],
                               "launches": by_config[SMOKE_PATH["train"]],
                               **train_smoke_report.row(name)}
        kernels.append(row)
    check(len(kernels) == len(SOURCES) + len(BF16_SOURCES),
          f"kernels timed: {len(kernels)}")
    print(json.dumps({"kernels": kernels, "not_ported": [
        {"replaces": rep, "status": st} for rep, st in NOT_PORTED],
        "fused_sa_bwd_full_spread": {
            "path": "default.yaml train B=16", "what": "every channel live "
            "at a slot drawn uniformly over S; bound over every slot",
            **full_spread["fused_sa_bwd"]},
        "fps_pick_loop": fps_rows, "fps_floor": fps_floor,
        "nearest_k_levels": nk_sweep,
        "three_nn_levels": three_nn_sweep,
        "slab_groups": slab_group_rows,
        "bn_train_chain_library_ms": {
            "path": BN_TRAIN_PATH, "what": "cuBLAS chain with "
            "batch-statistics BatchNorm under autograd, forward and backward",
            **{f"RCNN SA_{k}": ms for k, ms in bn_library.items()}},
        "bn_train_step": {"path": BN_TRAIN_PATH, "ms": bstep_ms,
                          "peak_gib": bpeak},
        "training_cli": cli, "eval_cli": ecli, "paper_slice": paper,
        "last_modules": last, "eval_numerics": numerics,
        "train_numerics": train_figs,
        "data_parallel": {k: v for k, v in dp.items() if not k.startswith(
            "ddp_")},
        "widened_shapes": {"shapes": WIDE_SHAPES,
                           "max_rel_err": wide_worst},
        "widened_config": {
            "rcnn_sa0_nsample": WIDE_NSAMPLE0, "rcnn_mlps": WIDE_MLPS,
            **{label: {"ms": ms, "peak_gib": peak, "launches": {
                k: v for k, v in launches.items() if k.startswith("fused")
                and v}} for label, (ms, launches, peak) in
               wide_runs.items()}}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
