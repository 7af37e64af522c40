#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full width with weights drawn from a seed:
serving the flagship W32/D4 UNet++ on 256x256x3 in bf16 (``make_server``
with dynamic batching answering 16 PNG requests from 4 client threads);
training it (the ``train`` verb's fold loop on a synthetic PNG folder,
batch 16, 2 epochs); training UNet3+ W32/D4 with deep supervision through
the same verb (``train_ds``); BASELINE config 3's fixed-batch train step
for UNet++ and UNet3+ (``config3_UNetPP``, ``config3_UNet3P``); config 2's
for UNet, UNetE and UNetP (``config2_UNet``, ``config2_UNetE``,
``config2_UNetP``); the ``test`` verb on the trained flagship fold
(``test``); config 4's, MultiResUNet and UNet with attention gates
(``config4_MultiResUNet``, ``config4_UNet_AG``), and the rest of the
MultiRes family's, MultiResUNet3+ and KSSNet (``MultiResUNet3P``,
``KSSNet``); the train, serve and test verbs on a MultiResUNet fold
with ``alpha = 1.67`` (``train_multires``); the flagship's train step
under each optimizer of the registry with the gradient clips, and a train
verb fold with FocalLoss, Nadam, the clips and the IoU and threshold
metrics (``registries``); the ``predict`` verb with every view on the
trained flagship fold (``predict``); the train verb with gradient
accumulation, ``conv_outs`` remat, an EMA shadow, the on-card augment and
exact resume (``train_options``), and with patchify and host augmentation
(``train_patchify``); and the 1D pipeline on BASELINE config 1 (a 1D UNet
W32/D3 on one-channel 1024-sample signals, float32): the ``train1d``,
``test1d`` and ``predict1d`` verbs and its fixed batch (``config1``,
``config1_bf16``, ``config1_ds``), and the other five 1D archs
(``1d_UNetE``, ``1d_UNetP``, ``1d_UNetPP``, ``1d_UNet3P_ds``,
``1d_MultiResUNet_ag``); and BASELINE config 5: its 1D models BCDUNet
(``lstm = 1``), SEDUNet, NABNet and IBAUNet (with gates) at config 1's
size in float32 and bfloat16 (``config5_<model>``,
``config5_<model>_bf16``, ``config5_BCDUNet_ds``) and through the 1D
verbs (``config5_verbs_BCDUNet``, ``config5_verbs_NABNet``), and its
W32/D4 UNet on EfficientNetB0 (bf16, batch 16, 256x256; no pool
kernel).  Phases, each printing lines:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
2. build: every kernel under csrc/ compiled from this checkout by nvcc
3. kernels: each kernel against its plain PyTorch version at every call
   each path makes (the pyramid storing every level, some levels or one
   level alone for a pool by 2**m; the pool backward with windows 2, 4,
   8, 16, 32 and 64) and at edge cases (bit-exact: max and its gradient
   routing are exact; bit patterns compared, NaN as NaN, on inputs with
   no -0.0), each line naming the kernel the launcher picked and
   reported (one launch of it), which must be ``pool_rows_kernel`` for
   every MultiRes encoder pool, ``pyramid_vec_kernel`` for every call
   of several channels storing level 5 or 6, ``pyramid_c1_kernel`` for
   every one-channel call (the deep-supervision targets, to level 7),
   ``pool_rows_kernel<V=16B>`` for every level 2-4 alone
   at a C of whole 16 bytes, ``pool_backward_rows_kernel`` for every
   backward by 4 to 16, ``pool_backward_block_kernel`` for every
   backward by 32 and ``pool_backward_wide_kernel`` for every backward by
   64 on a path, and the kernel named in ``FWD_ROUTES`` and ``BWD_ROUTES`` at
   the edge cases, with CUDA-event device times of the
   kernel (and the difference between its two turns), the plain version
   and the PyTorch library call that computes the same function (a
   yardstick the port never calls), and the bound: bytes moved at 3.35
   TB/s; beside each pooled UNet3+ skip to level 5 or less, the earlier
   design of the same call (one single-level launch per level); beside
   each call to level 6 or more, ``pyramid_kernel``, which such calls took
   before, forced on the same call (held to plain too); FWD_EXTRA's DS
   targets to level 6 timed as a path's; beside the DS targets' row, the
   floor: the same kernel's time on a (1, 2, 2, 1) mask; then the 1D
   kernels (csrc/pool1d.cu) the same way at every 1D call (config 1's
   shapes, float32, and bfloat16 for its fixed batch and as twins of the
   MultiRes and UNet3+ calls and of skip 0 to level 6; phases 33 and 35's,
   levels 1-6 and the backward by 32 and 64 among them) and edge cases,
   each naming its route (``pool1d_flat_kernel`` where 2**levels divides
   the length and the pointers start on 16 bytes, ``pool1d_kernel``
   elsewhere), the library yardstick ``F.max_pool1d`` and its backward;
   beside each DS mask's row, the floor: the same levels on (1, 2, 1) and
   the same kernel on the least mask it takes
4. serve: 16/16 answered 200 with a 256x256 mask; masks equal to
   ``label_from_pred`` of the same model run with the plain pool, away
   from the threshold; the pyramid kernel launched exactly 4 times (one
   per encoder level) per device batch; p50 latencies
5. reference: the same weights in float32 on the card (TF32 off) against
   the CPU on a small input, within 1e-4
6. train: finite losses; the pool backward kernel launched 4 times per
   train step and the pyramid 4 times per train step and validation
   batch; best.pt written and served; on one fixed batch the loss falls
   over 30 steps; p50 step time, img/s and peak memory, and the verb's
   own step time of its last epoch (loader included) beside it
7. train reference: one float32 train step on the card against the CPU,
   loss, gradients, running statistics and parameters within stated
   tolerances
8. train ds: phase 6 for UNet3+ with ``d_s = 1``: 8 pyramid launches per
   train step and validation batch (4 encoder pools, 3 decoder pyramids,
   one per pooled skip, 1 target pyramid) and 10 pool-backward launches
   per step (one per pooled tap)
9. config 3: 10 counted steps each of UNet++ (4 + 4 launches a step) and
   UNet3+ (7 + 10), finite ``out`` loss, p50 step, img/s, peak memory
10. ds reference: phase 7 for a W8/D3 UNet3+ with ``ds=1`` and its
    deep-supervision targets and loss weights
11. config 2: 10 counted steps each of UNet, UNetE and UNetP (W32/D4,
    transposed convs, no deep supervision, BCEDice, Adam 1e-4, batch 16):
    the loss falls, 4 + 4 launches a step, p50 step, img/s, peak memory
12. test: the ``test`` verb on phase 6's fold over 16 fresh PNGs in
    batches of 8: the checkpoint restored, every pixel counted, the
    confusion matrix equal to the plain-pool forward's away from the
    threshold, 4 pyramid launches per batch with and without two
    test-time views (stacked into the batch); the kernels' probabilities
    within 1e-3 of the plain pool's; img/s, decode included, and p50 of
    its ``predict`` call on a warm batch with and without the views
13. config 2 reference: phase 7 for W8/D3 UNet with ``ds=1`` (its
    low-resolution heads and the targets pyramid), UNetE without and UNetP
    with deep supervision
14. config 4: 10 counted steps each of MultiResUNet (alpha 1; its encoder
    pools 31, 63, 127 and 255 channels: the pyramid's row kernel, the
    backward one channel a thread) and UNet with ``ag=1``, as phase 11:
    the loss falls, 4 + 4
    launches a step, p50 step, img/s, peak memory
15. family: phase 14 for MultiResUNet3+ (7 + 10 launches a step, as
    UNet3+) and KSSNet (8 + 14: 4 encoder pools and one pyramid per
    encoder tap; 4 backward pools and one per level of each tap pyramid,
    4 + 3 + 2 + 1)
16. verbs: phase 6's train verb for one epoch on MultiResUNet with
    ``alpha = 1.67`` (4 + 4 launches a step), best.pt served, alpha read
    back from the fold's Train_Configs.ini, then the test verb on the fold
    over phase 12's PNGs (4 launches a batch, every pixel counted)
17. multires reference: phase 7 for W8/D3 MultiResUNet with ``ds=1``,
    UNet with ``ag=1`` and ``ds=1``, UNet++ with ``ag=1``, MultiResUNet3+
    and KSSNet
18. registries: 10 counted steps of the flagship under each of the 8
    optimizers with ``global_clipnorm``, ``clipnorm`` and ``clipvalue``
    each biting on the first gradient (printed): 4 + 4 launches a
    step, finite losses, p50 step; the p50 of each optimizer update (the
    clips included) and of the verb's 7 metric updates, with their shares
    of the step; the bucketize AUC counts equal to the broadcast counts
    on one card batch; a train verb fold (``class_number = 2``,
    FocalLoss, Nadam, the clips, MeanIoU, OneHotMeanIoU, AUC, Precision,
    Recall, BinaryAccuracy, tf.keras.metrics.TruePositives): every metric
    finite in history.json under the JAX key; and per optimizer 3 float32
    steps of a W8/D3 UNet++ with the clips on the card against the CPU,
    each from the CPU's weights and optimizer state (phase 7's
    tolerances), after one CPU step from a fresh state
19. predict: the ``predict`` verb through the command line (the GPU by
    default) on phase 6's fold over 64 fresh PNGs, ``--batch 8 --tta
    all`` at the plain forward's median probability as ``--threshold``:
    64 masks, equal to ``label_from_pred`` of the plain-pool forward with
    the same views away from the threshold, the kernels' probabilities
    within 1e-3 of it, 4 pyramid launches a device batch of 8 x 7 images;
    img/s and the p50 device batch with and without the views
20. the rest of training: the flagship's fixed batch of 16 under each
    remat mode and with 4 accumulation steps (launches a step: 4 + 4
    plain and under ``blocks``, 8 + 4 under ``dots``, ``conv_outs`` and
    ``full``, whose backward recomputes the forward with its pools, 16 +
    16 with 4 microbatches; p50 and peak memory), the peak memory of a
    batch of 64 plain, under ``full`` and ``blocks`` and with 4
    accumulation steps; float32 card-vs-CPU steps of a
    W8/D3 UNet++ on (4, 64, 64, 3) with 2 accumulation steps, each remat
    mode, and ``ema_decay`` 0.9 over 3 steps (the shadow within 2 lr of
    the CPU's and equal to the EMA rule on the card's parameters; the
    share of parameters beyond 1e-5 held at step 1 only); the on-card
    augmentation's p50 on the flagship batch and its share of the plain
    step, card against CPU on the same draws (images within 1e-5, masks
    equal, label values kept); the train verb with ``accumulation_steps
    = 4``, ``remat = conv_outs``, ``ema_decay = 0.999``,
    ``augment_device`` and ``exact_resume`` for 3 epochs, straight (32 +
    16 launches a step, 4 a validation batch), then in a fresh folder
    with a SIGTERM to this process in its second epoch (the sidecar
    records epoch 1) and the same INI again (it trains 2 epochs; the
    final weights and shadow within 2 lr a resumed step of the straight
    run's, cuDNN deterministic); ``test`` and ``predict`` on that fold,
    their masks equal to the plain-pool labels of best.pt with
    best_ema.pt over it away from the threshold; and the verb for one
    epoch with ``patchify`` (patches of 128, all of an image's in its
    batch) and, where OpenCV imports, ``augment`` (4 + 4 launches a step
    of 64 patches)
21. signal verbs: synthetic .pt sets (1024 train, 128 val, 128 test
    signals of 1024 samples) and config 1 through the command line:
    ``train1d`` for 2 epochs at batch 128 (3 + 3 launches a step, 3 a
    validation batch, the loss falls, its artifacts written), ``test1d``
    (the JAX verb's metric keys, the checkpoint restored, 3 launches a
    batch), ``predict1d`` (outputs within 1e-5 of best.pt's plain-pool
    forward, 3 launches a batch); config 1's fixed batch of 128 in
    float32 and bfloat16 (3 + 3 a step) and with ``d_s = 1`` (4 + 3: the
    targets' pyramid), 30 steps each, the loss falls, p50 step and peak
    memory beside the verb's own step
22. 1D archs: UNetE, UNetP, UNetPP (3 + 3 a step), UNet3+ with ``d_s =
    1`` (6 + 6) and MultiResUNet with ``a_g = 1`` (3 + 3, its pools at 31,
    62 and 124 channels) at config 1's size, float32, batch 128, 20
    counted steps each, the loss falls
23. 1D reference: phase 17's check on W8/D3 1D UNet3+ with ``d_s = 1``
    and MultiResUNet with ``a_g = 1`` on (2, 256, 1) signals,
    MeanAbsoluteError

24. config 5 in 1D: 10 counted fixed-batch steps of BCDUNet (``lstm =
    1, dense_loop = 2``), SEDUNet (``se_ratio = 8``), NABNet
    (``dense_loop = 2``) and IBAUNet (``a_g = 1``) at config 1's size in
    float32 and bfloat16 (3 + 3 launches a step: each pools its level
    outputs 32, 64 and 128 wide) and BCDUNet with ``d_s = 1`` (4 + 3),
    the loss must fall; phase 21's verbs on BCDUNet and NABNet; then
    phase 23's check on each at W8/D3 (and BCDUNet with ``d_s = 1``)
25. config 5 in 2D: the W32/D4 UNet on EfficientNetB0 (random weights,
    bf16, batch 16 at 256x256 of pixel-valued images), 10 counted steps
    with ``encoder_trainable`` 0 and 1, no pool launch (it downsamples by
    strided convolutions), the loss must fall, the backbone's running
    statistics unchanged with 0 and all moved with 1; cuDNN's depthwise
    convolutions of the step timed (CUDA events, L2 flushed); the
    ``train`` verb for one epoch (best.pt served), ``test`` and
    ``predict`` on phase 12's PNGs (0 launches, every pixel counted); a
    float32 card step of a W8/D3 model against the CPU's float32 and
    float64 steps (phase 17's check), the backbone's statistics
    calibrated on one batch, with ``encoder_trainable`` 0 and 1
26. the rest of the 1D zoo at config 1's size (``phase_zoo_1d``, W8/D3
    references with the bfloat16 control)
27. ConvLSTM fusion and the autoencoder bottleneck in 2D at the
    flagship's size (``phase_lstm_ae_2d``), W8/D3 references
28. the Self-ONN family and the FPN genre in 2D at the flagship's size
    on the images times SELF_2D_SCALE (``phase_self_2d``: SelfUNet,
    SelfUNetPP, SelfUNet3P with and without ``d_s``, SelfFPN, FPN, 20
    steps each, exact launches, the loss falls; SelfFPN and SelfUNet on
    EfficientNetB0; the verbs on SelfUNetPP), W8/D3 references
29. the 1D Self-ONN archs at config 1's size on the signals times
    SELF_1D_SCALE (``phase_self_1d``: SelfR2UNetPP, SelfUNetPP,
    SelfUNet3P with and without ``d_s``; the 1D verbs on SelfUNetPP),
    W8/D3 references
30. the last 1D special families at config 1's size
    (``phase_zoo_1d_specials``, ZOO_1D_SPECIALS: every TernausNet,
    AlbUNet, LinkNet, FPN, MLMRSNet, SAUNet and Dense-Inception name,
    SPECIALS_LONG_STEPS (20) counted steps with the loss falling, the others
    SPECIALS_SHORT_STEPS, exact launches; the SAUNet family with
    DropBlock at keep_prob 0.9 drawn on the card, its dropped share
    printed; the 1D verbs on SAUNet and on LinkNetPP with ``d_s = 1``),
    W8/D3 references of SPECIALS_LONG with the card's DropBlock draws
    replayed on the CPU
31. the dense-input family from scratch at the flagship's size
    (``phase_dense_2d``, DENSE_2D: UNet4P, UNet4PV2 and AHNet at D4,
    UNet4P, AHNet and KSSNet at D5, whose tap 1 is pooled by 32, 10
    counted steps each with the loss falling and exact launches; AHNet
    through ``train``, ``test`` and ``predict``), W8/D3 references and
    KSSNet W8/D5's
32. the backbones the port added (``phase_backbones_2d``: the W32/D4
    UNet on each of NEW_BACKBONES, trained, 5 steps, 10 for one a class,
    then that one frozen with its statistics calibrated; the gated
    projector families, UNet4P at D5 and ``a_e`` on ResNet50 with exact
    launches; UNet4PV2 on ResNet50 through ``train``), W8/D3 references
    of one backbone a class and of AHNet on ResNet50, the CPU steps on
    the card's ReLU and ReLU6 pieces
33. the 1D models that pool by 32 at config 1's size and width
    (``phase_deep_1d``, DEEP_1D: UNet3P, R2UNet3P, SelfUNet3P (on the
    signals times SELF_1D_SCALE, 20 steps), ConvMixerUNet3P and
    MLMRSNet_V2 at depth 6, UNet4P at depth 7, 10 counted steps each
    with the loss falling and exact launches, ``_deep_calls``; the 1D
    verbs on UNet3P at depth 5 with ``d_s = 1``, whose targets pool the
    mask by 2 .. 32), the W8/D6 UNet3P reference on the card's ReLU
    masks (RELATIVE_BAR, the bfloat16 control)
34. the 2D models that pool by 64 from scratch at the flagship's size
    (``phase_deep_2d``, DEEP_2D: KSSNet at depth 6 and UNet3P at depth 7
    with ``d_s = 1``, DEEP_LONG_STEPS counted steps with the loss falling;
    UNet4P, UNet4PV2 and AHNet at depth 6, MultiResUNet3P and SelfUNet3P
    at depth 7 on the images times SELF_2D_SCALE, DEEP_SHORT_STEPS with
    finite losses; exact launches, ``_deep_2d_fwd``; UNet3P D7 ``d_s = 1``
    through ``train``), W8 references at 128x128 of UNet4P D6 and UNet3P
    D7 ``d_s = 1`` (phase 31's check)
35. the 1D models that pool by 64 at config 1's size and width
    (``phase_deeper_1d``, DEEPER_1D: the five of phase 33 at depth 7,
    UNet4P at depth 8, DEEPER_STEPS counted steps each with finite losses
    and exact launches; the 1D verbs on UNet3P at depth 6 with ``d_s =
    1``, whose targets pool the mask by 2 .. 64), the W8/D7 UNet3P
    reference (phase 33's check)

Phase 16 runs after phase 12, on its PNGs; phases 18, 19 and 20 run
after phase 17, on phase 6's folders and fold and phase 12's PNGs, then
phases 21-35; the others run in their order.  Each phase's wall time is
printed when it ends.
The line before the last is one JSON object with a row for each CUDA
kernel (``name``, the name the launcher reports) and each path that runs
it, ``launches`` the launches its wrapper counted under that name in the
path's run (the run fails if a kernel of the path's calls was launched no
time, or if it launched a kernel none of them takes) (``path``:
``serve``, ``train``, ``train_ds``,
``config3_UNetPP``, ``config3_UNet3P``, ``config2_UNet``,
``config2_UNetE``, ``config2_UNetP``, ``test``, ``config4_MultiResUNet``,
``config4_UNet_AG``, ``MultiResUNet3P``, ``KSSNet``, ``train_multires``,
``registries``, ``predict``, ``train_options``, ``train_patchify``, the
paths of phases 27-28 (``lstm_*``, ``ae_UNet``, ``train_lstm``,
``self_*``, ``fpn_FPN``, ``train_self``), of phases 31-32
(``dense_*``, ``train_AHNet``, ``proj_*``, ``train_UNet4PV2_ResNet50``),
or a 1D path (phase 30's
``1d_special_*``, ``1d_verbs_*`` among them, phase 33's ``1d_deep_*``,
phase 35's ``1d_deeper_*``; phase 34's ``deep_*`` and
``train_UNet3P_D7_ds``)
with the rows of the ``pool1d_flat_kernel``, ``pool1d_kernel`` and
``pool1d_backward_kernel`` routes): the launches of that
path's run in phase 4, 6, 8, 9, 11, 12, 14, 15, 16, 18 (its 8 counted
runs and the verb's), 19, 20 (the straight verb run of
``train_options``, the patchify verb run), 21 (``config1``: the train1d
run; the fixed batches), 22 or 24 (the fixed batches; the train1d runs),
26-35 (the fixed batches; the verb runs), and the device times and
bound of the
calls that path makes per batch or step; the last is ``{"ok":
true, "device": {...}}``.  Any failure raises and the exit code is not 0.  Without CUDA it
exits 1 before printing any result.

    python3 chip_smoke.py --ds-mask

runs phases 1 and 2 and then only the DS targets' pyramid call, checked
and timed as in phase 3 (see ``phase_ds_mask``), and prints no result
line.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

import numpy as np

SEED = 0
BATCH = 8
SIZE = 256
N_REQUESTS = 16
N_CLIENTS = 4
THRESHOLD = 0.5
NEAR_THRESHOLD = 1e-2
#: phase 12: labels may differ from the plain-pool forward's only nearer
#: than this to the threshold
NEAR_TEST = 1e-3
REPS = 30
TRAIN_BATCH = 16
N_TRAIN = 128
N_VAL = 16
TRAIN_EPOCHS = 2
FIXED_STEPS = 30
DS_EPOCHS = 2
CONFIG3_STEPS = 10
CONFIG2_STEPS = 10
CONFIG4_STEPS = 10
N_TEST = 16
TEST_BATCH = 8
#: views of phase 12's second test run
TEST_TTA = "hflip,vflip"
#: phase 18: counted fixed-batch steps of the flagship per optimizer
REG_STEPS = 10
#: phase 18's train verb fold: its metrics, by the JAX package's names
REG_METRICS = ("MeanIoU", "OneHotMeanIoU", "AUC", "Precision", "Recall",
               "BinaryAccuracy", "tf.keras.metrics.TruePositives")
#: phase 18: card-against-CPU steps per optimizer
REG_REF_STEPS = 3
#: phase 19: fresh PNGs, the verb's --batch and its views (all 6 on a
#: square input: 7 images a picture in one forward)
N_PREDICT = 64
PREDICT_BATCH = 8
PREDICT_VIEWS = 6
#: phase 20: steps of each option at the fixed batch, the verb's epochs,
#: accumulation, the patchify verb's patch size, the peak-memory batch
OPT_STEPS = 12
OPT_EPOCHS = 3
OPT_ACCUM = 4
OPT_PATCH = 128
OPT_BIG_BATCH = 64
#: phase 20's remat modes: pyramid launches a flagship step (the recomputed
#: forward launches the encoder's 4 pools again; ``blocks`` recomputes
#: inside the blocks, between the pools)
REMAT_FWD = {"": 4, "dots": 8, "conv_outs": 8, "full": 8, "blocks": 4}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
#: bytes zeroed between two timed calls: enough to empty the 50 MB L2 and
#: to keep the card busy longer than the host takes to enqueue a call
#: (phase 3 prints both times; 128 MB did not outlast a pyramid call
#: with four outputs)
FLUSH_BYTES = 512 * 2 ** 20


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _events_ms(fn) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _call_ms(fn, flush) -> float:
    """Median CUDA-event time around one ``fn()`` call after an L2 flush:
    what a caller waits when the card is idle, host overhead included."""
    times = []
    for _ in range(REPS):
        flush.zero_()
        times.append(_events_ms(fn))
    return statistics.median(times)


def _device_ms(fn, flush, loops: int = 3, reps: int = REPS) -> float:
    """Device time of one ``fn()`` with a cold 50 MB L2: events around
    ``reps`` (flush, fn) pairs minus events around ``reps`` flushes alone,
    per call; median over ``loops``.  Zeroing FLUSH_BYTES keeps the card
    busy longer than the host takes to enqueue ``fn``, so host overhead
    drops out."""
    def pairs():
        for _ in range(reps):
            flush.zero_()
            fn()

    def flushes():
        for _ in range(reps):
            flush.zero_()

    return statistics.median(
        (_events_ms(pairs) - _events_ms(flushes)) / reps
        for _ in range(loops))


#: the plain version is timed over SLOW_REPS calls in one loop and one
#: turn: it is the kernel's oracle, not a yardstick of speed, and the pool
#: backward's walk over a window takes 1-6 ms at F = 4-8 and in 1D at F =
#: 16-64, 95 ms at F = 32 and 350 ms at F = 64 in 2D (timed in turns, the
#: plain versions took over a minute of the script)
SLOW_REPS = 3


def _timed_turns(fns: dict, flush, spreads: dict) -> dict:
    """``_in_turns`` of ``fns`` but the plain version, which is timed over
    SLOW_REPS calls."""
    fast = {k: f for k, f in fns.items() if k != "plain"}
    t = _in_turns(fast, flush, spreads)
    t["plain"] = _device_ms(fns["plain"], flush, loops=1, reps=SLOW_REPS)
    spreads["plain"] = float("nan")
    return t


def _host_ms(fn, reps: int = 20) -> float:
    """Host time to enqueue one ``fn()`` (no synchronize inside)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    return dt


def _built_on_card(build):
    """``build(generator)`` with every tensor it makes on the card and
    drawn from a generator there, seeded from SEED: drawing the largest
    models' parameters on the host (1.24 G for the 2D SelfUNet3P at depth
    7, 0.92 G for the 1D UNet4P at depth 8) took tens of seconds."""
    import torch

    with torch.device("cuda"):
        return build(torch.Generator(device="cuda").manual_seed(SEED))


def phase_device() -> None:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print("phase 1 device: nvidia-smi name, power.limit:", flush=True)
    print(line, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0 = {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)


def phase_build() -> None:
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        _build)

    so = _build.library_path()
    cached = os.path.exists(so)
    t0 = time.perf_counter()
    _build.load_library()
    dt = time.perf_counter() - t0
    print(f"phase 2 build: {os.path.relpath(so)} "
          f"({'already built' if cached else 'built by nvcc'}) "
          f"in {dt:.2f} s", flush=True)


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound_ms(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes`` (each input
    read once, each output written once) at the H100's 3.35 TB/s."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _in_turns(fns: dict, flush, spreads: "dict | None" = None) -> dict:
    """Device time of each of ``fns`` (name -> callable), measured in
    turns (order, reversed order) and averaged; ``spreads``, if given,
    receives each name's difference between its two turns."""
    t = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        t[name].append(_device_ms(fns[name], flush))
    if spreads is not None:
        spreads.update({name: max(v) - min(v) for name, v in t.items()})
    return {name: statistics.mean(v) for name, v in t.items()}


_BF16, _F32 = "bfloat16", "float32"
_ENC = [(TRAIN_BATCH, 256, 256, 32), (TRAIN_BATCH, 128, 128, 64),
        (TRAIN_BATCH, 64, 64, 128), (TRAIN_BATCH, 32, 32, 256)]
#: UNet3+ W32/D4's pooled decoder taps per forward: (NHWC shape, factor)
#: for decoder step j and tap k, factor 2**((D - j) - k - 1)
#: (tf_1d_2d_segmentation_end2endpipelines_tpu/models/decoders.py:353-356);
#: each has its own backward launch
_DEC_3P = [(_ENC[0], 8), (_ENC[1], 4), (_ENC[2], 2),
           (_ENC[0], 4), (_ENC[1], 2), (_ENC[0], 2)]


def _all(levels: int) -> tuple:
    return tuple(range(1, levels + 1))


_DS_MASK = (_F32, (TRAIN_BATCH, SIZE, SIZE, 1), 4, _all(4))

# pyramid calls per batch or step of each path: (dtype, NHWC shape,
# levels, wanted), ``wanted`` the levels stored: (levels,) for a pool by
# 2**levels (``maxpool_level``, the encoder's pools), every level for
# UNet3+'s pooled skips (``maxpool_levels``: skip k to levels 1..3-k, its
# taps, in one launch) and for the DS targets (``fused_maxpool_pyramid``)
_FWD_ENC_TRAIN = [(_BF16, s, 1, (1,)) for s in _ENC]
_FWD_ENC_8 = [(_BF16, (BATCH,) + s[1:], 1, (1,)) for s in _ENC]
_FWD_DEC_3P = [(_BF16, _ENC[k], 3 - k, _all(3 - k)) for k in range(3)]
#: MultiResBlock widths of the W32/D4 encoder's pooled levels: alpha 1 (the
#: branches truncate, tf_1d_2d_segmentation_end2endpipelines_tpu/ops/
#: blocks.py:748-749) and alpha 1.67 (phase 16); phases 14 and 16 check
#: them against the models
MRB_WIDTHS = {1.0: (31, 63, 127, 255), 1.67: (51, 105, 212, 426)}
_ENC_MRB = {a: [s[:3] + (c,) for s, c in zip(_ENC, widths)]
            for a, widths in MRB_WIDTHS.items()}
_FWD_ENC_MRB = {a: [(_BF16, s, 1, (1,)) for s in shapes]
                for a, shapes in _ENC_MRB.items()}
#: KSSNet W32/D4: encoder tap k (a ResPath, W * 2**k wide) pooled to levels
#: 1 .. 4 - k in one launch (its gated inputs to the deeper levels,
#: tf_1d_2d_segmentation_end2endpipelines_tpu/models/encoders.py:71-84)
_FWD_TAPS_KSS = [(_BF16, _ENC[k], 4 - k, _all(4 - k)) for k in range(4)]
CONFIG2 = ("UNet", "UNetE", "UNetP")
#: phases 14 and 15: path -> (decoder, ag)
CONFIG4 = {"config4_MultiResUNet": ("MultiResUNet", 0),
           "config4_UNet_AG": ("UNet", 1)}
FAMILY = {"MultiResUNet3P": ("MultiResUNet3P", 0), "KSSNet": ("KSSNet", 0)}
#: phase 20's verb run: microbatches of TRAIN_BATCH / OPT_ACCUM, each
#: forward run twice (conv_outs remat); its patchify run: OPT_PATCH patches,
#: (SIZE / OPT_PATCH)**2 an image
_ENC_MB = [(TRAIN_BATCH // OPT_ACCUM,) + s[1:] for s in _ENC]
_ENC_PATCH = [(TRAIN_BATCH * (SIZE // OPT_PATCH) ** 2, OPT_PATCH >> k,
               OPT_PATCH >> k, 32 << k) for k in range(4)]
FWD_PATHS = {
    "serve": _FWD_ENC_8,
    "train": _FWD_ENC_TRAIN,
    "train_ds": _FWD_ENC_TRAIN + _FWD_DEC_3P + [_DS_MASK],
    "config3_UNetPP": _FWD_ENC_TRAIN,
    "config3_UNet3P": _FWD_ENC_TRAIN + _FWD_DEC_3P,
    **{f"config2_{dec}": _FWD_ENC_TRAIN for dec in CONFIG2},
    # a padded batch of TEST_BATCH (== BATCH) images, as served
    "test": _FWD_ENC_8,
    "config4_MultiResUNet": _FWD_ENC_MRB[1.0],
    "config4_UNet_AG": _FWD_ENC_TRAIN,
    "MultiResUNet3P": _FWD_ENC_MRB[1.0] + _FWD_DEC_3P,
    "KSSNet": _FWD_ENC_MRB[1.0] + _FWD_TAPS_KSS,
    "train_multires": _FWD_ENC_MRB[1.67],
    "registries": _FWD_ENC_TRAIN,
    # a device batch of the predict verb: PREDICT_BATCH images and each of
    # their views in one forward
    "predict": [(_BF16, (PREDICT_BATCH * (1 + PREDICT_VIEWS),) + s[1:], 1,
                 (1,)) for s in _ENC],
    "train_options": [(_BF16, s, 1, (1,)) for s in _ENC_MB] * (2 * OPT_ACCUM),
    "train_patchify": [(_BF16, s, 1, (1,)) for s in _ENC_PATCH],
}
#: phase 27: ConvLSTM fusion and the autoencoder bottleneck in 2D at the
#: flagship's size: path -> (decoder, keyword arguments); UNet++ and UNet
#: pool as the flagship, KSSNet as phase 15's
LSTM_AE_2D = {"lstm_UNetPP_ag": ("UNetPP", dict(lstm=1, ag=1)),
              "lstm_KSSNet_ag": ("KSSNet", dict(lstm=1, ag=1)),
              "ae_UNet": ("UNet", dict(ae=1))}
FWD_PATHS.update({"lstm_UNetPP_ag": _FWD_ENC_TRAIN,
                  "lstm_KSSNet_ag": FWD_PATHS["KSSNet"],
                  "ae_UNet": _FWD_ENC_TRAIN, "train_lstm": _FWD_ENC_TRAIN})
#: phase 28: the Self-ONN family (q = 3) and the FPN genre in 2D at the
#: flagship's size: path -> (decoder, genre, keyword arguments).  Their
#: encoders pool their level outputs 32, 64, 128 and 256 wide, as the
#: flagship's; SelfUNet3P adds UNet3+'s skip pyramids, and with ``d_s =
#: 1`` the targets' pyramid (UNet3+ with DS's calls)
SELF_2D = {"self_SelfUNet": ("SelfUNet", "UNet", {}),
           "self_SelfUNetPP": ("SelfUNetPP", "UNet", {}),
           "self_SelfUNet3P": ("SelfUNet3P", "UNet", {}),
           "self_SelfUNet3P_ds": ("SelfUNet3P", "UNet", dict(ds=1)),
           "self_SelfFPN": ("SelfFPN", "FPN", {}),
           "fpn_FPN": ("FPN", "FPN", {})}
#: phase 28's images are multiplied by SELF_2D_SCALE (the verbs read the
#: PNGs with ``normalizing_factor_img = 255 / SELF_2D_SCALE``).  The
#: Self-ONN encoder and latent cube their inputs seven times at D4 with no
#: normalization between: on phase 11's images in [0, 1] JAX's float32
#: forward of SelfUNet (W32/D4, its initial weights) overflows, as the
#: port's losses do, while at 0.3 every Self model's forward is finite
#: (tests/test_torch_self_models.py checks JAX's at 1 and 0.3).  The scale
#: is chosen for the reference, not for the port.
SELF_2D_SCALE = 0.3
#: phase 28 on EfficientNetB0 (random weights, frozen: ``encoder_trainable
#: = 0``, the INI default), pixel-valued images times SELF_2D_SCALE: path
#: -> (decoder, genre); they pool nothing.  A frozen backbone keeps its
#: initial statistics, so its taps scale with the input; trained, its
#: BatchNorms bring them to O(1-10), SelfUNet's projectors and latent cube
#: them to 1e13 and the next Oper's cubes pass bfloat16's range (3.4e38)
#: at batch 16 from the seed's weights, even at 0.1 times the images
SELF_2D_B0 = {"self_SelfFPN_B0": ("SelfFPN", "FPN"),
              "self_SelfUNet_B0": ("SelfUNet", "UNet")}
FWD_PATHS.update({
    **{p: _FWD_ENC_TRAIN for p in ("self_SelfUNet", "self_SelfUNetPP",
                                   "self_SelfFPN", "fpn_FPN", "train_self")},
    "self_SelfUNet3P": FWD_PATHS["config3_UNet3P"],
    "self_SelfUNet3P_ds": FWD_PATHS["train_ds"]})
#: the MultiRes encoder pools' kernel (csrc/pyramid.cu): one level at a C
#: that is not a multiple of 16 bytes, rows starting on 16 bytes
POOL_ROWS = "pool_rows_kernel"
#: the pool backward's kernel for windows of 4 to 16 (csrc/
#: pool_backward.cu), 16 bytes of channels a thread
BWD_ROWS = "pool_backward_rows_kernel"
#: the single-level pools by 4, 8 and 16 at a C of whole 16 bytes: the
#: row kernel's 16-byte fold (csrc/pyramid.cu)
ROWS16 = "pool_rows_kernel<V=16B>"
#: the pool backward's kernel for windows of 32
BWD_BLOCK = "pool_backward_block_kernel"
#: ... and of 64
BWD_WIDE = "pool_backward_wide_kernel"
#: an offset channels_last view of the same shape: elements of storage
#: before the view's first (1: no row starts on 16 bytes; 8 bf16: all do)
_OFFSET_1 = (_BF16, (2, 8, 64, 31), 1, (1,))
_OFFSET_8 = (_BF16, (2, 8, 128, 31), 1, (1,))
OFFSETS = {_OFFSET_1: 1, _OFFSET_8: 8}
FWD_EDGES = [
    (_F32, (2, 37, 53, 3), 2, _all(2)),     # ragged edges, every level
    (_BF16, (2, 37, 53, 16), 1, (1,)),      # ragged, 16-byte vector
    (_BF16, (2, 16, 16, 3), 1, (1,)),       # C % 8 != 0, 16-byte rows
    (_BF16, (2, 37, 53, 16), 3, (3,)),      # ragged, level 3 alone
    (_F32, (2, 19, 23, 3), 2, (2,)),        # one channel a thread
    (_F32, (2, 33, 17, 4), 4, (4,)),        # ragged, 16-byte, level 4
    (_F32, (3, 37, 53, 1), 3, _all(3)),     # C=1: ragged, unaligned rows
    (_BF16, (2, 64, 64, 1), 4, _all(4)),    # C=1 bf16: 3 levels a thread
    (_BF16, (2, 37, 53, 16), 3, _all(3)),   # several levels, 16-byte
    (_BF16, (2, 37, 53, 16), 3, (1, 3)),    # levels 1 and 3 only
    (_BF16, (2, 37, 53, 3), 1, (1,)),       # odd C, rows not on 16 bytes
    (_BF16, (2, 37, 64, 51), 1, (1,)),      # odd C, ragged H, 16-byte rows
    (_BF16, (2, 4, 1024, 51), 1, (1,)),     # a row wider than one span
    (_F32, (2, 64, 64, 7), 1, (1,)),        # f32 odd C (the W8 references)
    _OFFSET_1, _OFFSET_8,
    (_BF16, (2, 70, 66, 16), 5, _all(5)),   # level 5, 16 lanes a
    (_BF16, (3, 129, 200, 24), 5, _all(5)),  # patch, ragged; several
    (_F32, (2, 33, 97, 12), 5, (1, 3, 5)),  # patches a warp, f32
    (_BF16, (2, 70, 66, 16), 5, (5,)),      # level 5 alone, ragged
    (_BF16, (2, 64, 256, 31), 5, (5,)),     # odd C, 16-byte rows
    (_BF16, (2, 64, 64, 31), 5, (5,)),      # odd C, 62-byte output rows
    (_BF16, (1, 16, 16, 2048), 4, (4,)),    # a pixel past its shared memory
]
#: pool_rows_kernel<V=16B>'s edge cases, drawn with ReLU plateaus (ties
#: everywhere)
FWD_PLATEAUS = [
    (_BF16, (3, 67, 45, 24), 2, (2,)),      # ragged, 3 vectors a pixel
    (_F32, (2, 70, 130, 20), 3, (3,)),      # f32: ragged, 5 a pixel
    (_BF16, (2, 50, 1000, 8), 2, (2,)),     # a row of several spans
    (_F32, (2, 37, 41, 64), 4, (4,)),       # f32, ragged, one span
    (_BF16, (1, 33, 40, 1024), 4, (4,)),    # one pixel a span
]
FWD_EDGES += FWD_PLATEAUS
#: level 6 (64 lanes a patch), the one-channel kernel at levels 6-7 and
#: what stays on pyramid_kernel; the plateau case is drawn with ReLU
#: plateaus, the offset views as OFFSETS says
_OFFSET_64_1 = (_BF16, (2, 64, 128, 16), 6, _all(6))
_OFFSET_64_8 = (_BF16, (2, 128, 64, 16), 6, (6,))
OFFSETS.update({_OFFSET_64_1: 1, _OFFSET_64_8: 8})
FWD_PLATEAUS_64 = [(_BF16, (2, 128, 192, 32), 6, _all(6))]
FWD_EDGES_64 = [
    (_BF16, (2, 70, 130, 16), 6, _all(6)),   # ragged, two groups a pair
    (_BF16, (3, 129, 200, 24), 6, _all(6)),  # three groups: a patch 64
    (_F32, (2, 65, 97, 12), 6, (1, 3, 6)),   # f32, some levels
    (_BF16, (2, 130, 66, 16), 6, (6,)),      # level 6 alone, ragged
    (_BF16, (2, 64, 256, 31), 6, (6,)),      # odd C: pyramid_kernel
    (_BF16, (2, 64, 256, 31), 6, _all(6)),   # odd C, every level
    (_F32, (3, 200, 301, 1), 7, _all(7)),    # C = 1, f32 level 7, ragged
    (_BF16, (2, 130, 257, 1), 6, _all(6)),   # C = 1, bf16 level 6
    (_F32, (2, 40, 50, 1), 7, _all(7)),      # C = 1, smaller than a band
    (_F32, (2, 256, 256, 1), 8, _all(8)),    # a chain's D8 targets
    _OFFSET_64_1, _OFFSET_64_8,
] + FWD_PLATEAUS_64
FWD_EDGES += FWD_EDGES_64
#: the kernel a call must reach, where phase 3 holds the launcher to it
FWD_ROUTES = {
    **{c: POOL_ROWS for cs in _FWD_ENC_MRB.values() for c in cs},
    (_BF16, (2, 37, 53, 3), 1, (1,)): "pyramid_kernel",
    (_BF16, (2, 37, 64, 51), 1, (1,)): POOL_ROWS,
    (_BF16, (2, 4, 1024, 51), 1, (1,)): POOL_ROWS,
    (_F32, (2, 64, 64, 7), 1, (1,)): POOL_ROWS,
    _OFFSET_1: "pyramid_kernel",
    _OFFSET_8: POOL_ROWS,
    (_BF16, (2, 70, 66, 16), 5, _all(5)): "pyramid_vec_kernel",
    (_BF16, (2, 70, 66, 16), 5, (5,)): "pyramid_vec_kernel",
    (_BF16, (2, 64, 256, 31), 5, (5,)): POOL_ROWS,
    (_BF16, (2, 64, 64, 31), 5, (5,)): "pyramid_kernel",
    (_BF16, (2, 37, 53, 16), 3, (3,)): ROWS16,
    (_F32, (2, 33, 17, 4), 4, (4,)): ROWS16,
    **{c: ROWS16 for c in FWD_PLATEAUS},
    (_BF16, (1, 16, 16, 2048), 4, (4,)): "pool_vec_kernel",
    **{c: "pyramid_vec_kernel" for c in FWD_EDGES_64 if c[1][-1] % 8 == 0},
    (_F32, (2, 65, 97, 12), 6, (1, 3, 6)): "pyramid_vec_kernel",
    (_BF16, (2, 64, 256, 31), 6, (6,)): "pyramid_kernel",
    (_BF16, (2, 64, 256, 31), 6, _all(6)): "pyramid_kernel",
    **{c: "pyramid_c1_kernel" for c in FWD_EDGES_64
       if c[1][-1] == 1 and c[2] <= 7},
    (_F32, (2, 256, 256, 1), 8, _all(8)): "pyramid_kernel",
    _OFFSET_64_1: "pyramid_kernel",
}
#: calls timed beside the paths' (on no path): the deep-supervision
#: targets pooled to level 6 (a full-scale decoder with ``d_s = 1`` at
#: depth 6), and level 6 alone at four times the paths' batch (at 16
#: images the call runs 2,048 warps, a quarter of the card's warp slots:
#: whether that holds its read rate back)
_LEVEL6_BATCH_64 = (_BF16, (4 * TRAIN_BATCH, SIZE, SIZE, 32), 6, (6,))
FWD_EXTRA = [(_F32, (TRAIN_BATCH, SIZE, SIZE, 1), 6, _all(6)),
             _LEVEL6_BATCH_64]
FWD_ROUTES[_LEVEL6_BATCH_64] = "pyramid_vec_kernel"
# pool-backward calls per step: (dtype, NHWC shape, factor)
_BWD_ENC = [(_BF16, s, 2) for s in _ENC]
_BWD_DEC_3P = [(_BF16, s, f) for s, f in _DEC_3P]
_BWD_ENC_MRB = {a: [(_BF16, s, 2) for s in shapes]
                for a, shapes in _ENC_MRB.items()}
# KSSNet: one backward launch per level of each tap pyramid
_BWD_TAPS_KSS = [(_BF16, _ENC[k], 1 << lvl) for k in range(4)
                 for lvl in range(1, 5 - k)]
BWD_PATHS = {
    "train": _BWD_ENC,
    "train_ds": _BWD_ENC + _BWD_DEC_3P,
    "config3_UNetPP": _BWD_ENC,
    "config3_UNet3P": _BWD_ENC + _BWD_DEC_3P,
    **{f"config2_{dec}": _BWD_ENC for dec in CONFIG2},
    "config4_MultiResUNet": _BWD_ENC_MRB[1.0],
    "config4_UNet_AG": _BWD_ENC,
    "MultiResUNet3P": _BWD_ENC_MRB[1.0] + _BWD_DEC_3P,
    "KSSNet": _BWD_ENC_MRB[1.0] + _BWD_TAPS_KSS,
    "train_multires": _BWD_ENC_MRB[1.67],
    "registries": _BWD_ENC,
    "train_options": [(_BF16, s, 2) for s in _ENC_MB] * OPT_ACCUM,
    "train_patchify": [(_BF16, s, 2) for s in _ENC_PATCH],
}
BWD_PATHS.update({"lstm_UNetPP_ag": _BWD_ENC,
                  "lstm_KSSNet_ag": BWD_PATHS["KSSNet"],
                  "ae_UNet": _BWD_ENC, "train_lstm": _BWD_ENC})
BWD_PATHS.update({
    **{p: _BWD_ENC for p in ("self_SelfUNet", "self_SelfUNetPP",
                             "self_SelfFPN", "fpn_FPN", "train_self")},
    "self_SelfUNet3P": BWD_PATHS["config3_UNet3P"],
    "self_SelfUNet3P_ds": BWD_PATHS["train_ds"]})
BWD_EDGES = [
    (_F32, (4, 64, 64, 32), 2),      # f32, vector path
    (_BF16, (2, 37, 53, 16), 2),     # ragged, vector path
    (_F32, (2, 37, 53, 3), 2),       # ragged, C % 4 != 0
    (_BF16, (2, 16, 16, 12), 2),     # C % 8 != 0
    (_BF16, (1, 1, 1, 8), 2),        # nothing pooled
    (_F32, (2, 19, 23, 3), 4),       # ragged, one channel a thread
    (_BF16, (2, 37, 53, 16), 8),     # ragged, vector path
    (_F32, (2, 33, 17, 4), 16),
    (_BF16, (1, 3, 3, 8), 4),        # nothing pooled
    (_BF16, (2, 32, 32, 32), 16),    # NaN first, last and twice a window
    (_BF16, (2, 70, 66, 16), 32),    # F = 32, ragged, 16 bytes
    (_F32, (2, 70, 66, 3), 32),      # one channel a thread
    (_BF16, (2, 64, 64, 32), 32),    # NaN first, last and twice a window
    (_F32, (2, 64, 96, 8), 32),      # f32: a chunk of 8 channels
    (_BF16, (1, 33, 65, 24), 32),    # 24 channels, 3 vectors, ragged
    (_BF16, (3, 100, 40, 64), 32),   # 2 chunks of 32 channels, ragged
    (_BF16, (2, 32, 32, 8), 32),     # one window, all -inf but a NaN
    (_BF16, (2, 130, 140, 16), 64),  # F = 64, ragged, 2 groups a chunk
    (_F32, (2, 70, 66, 3), 64),      # one channel a thread
    (_BF16, (2, 128, 128, 32), 64),  # NaNs; ties in two quarters
    (_F32, (2, 64, 128, 40), 64),    # f32: 10 groups in a chunk of 16
    (_BF16, (2, 128, 64, 256), 64),  # 2 chunks of 16 groups
    (_BF16, (1, 33, 40, 8), 64),     # smaller than a window: zeros
    (_BF16, (2, 64, 64, 8), 64),     # one window, all -inf but a NaN
    (_BF16, (2, 64, 128, 16), 64),   # offset views (BWD_OFFSETS)
    (_BF16, (2, 128, 64, 16), 64),
]
#: backward edge cases in a view of their storage: elements before x's and
#: g's first (8 bf16: 16 bytes, the vector path; 1: one channel a thread)
BWD_OFFSETS = {(_BF16, (2, 64, 128, 16), 64): 1,
               (_BF16, (2, 128, 64, 16), 64): 8}
#: values planted in an input (NHWC index -> value) besides its NaN: for
#: windows of 16, a NaN at window (0, 0)'s first element, at window (0,
#: 1)'s last, and twice in batch 1's window (0, 0), the second one
#: followed in its row by -5s, so that the row's walk ends below the rows
#: above it and only the NaN decides the choice; the same for windows of
#: 32, and a window of -inf with a NaN last (channel 0) or first (1), and
#: one of -1 with -0.0 before +0.0 (batch 1, channel 2: the walk keeps
#: the first of two equal values)
PLANTS = {(_BF16, (2, 32, 32, 32), 16): [
    ((0, 0, 0, 1), float("nan")), ((0, 15, 31, 2), float("nan")),
    ((1, 3, 4, 3), float("nan")), ((1, 9, 12, 3), float("nan")),
    ((1, 9, slice(13, 16), 3), -5.0)],
    (_BF16, (2, 64, 64, 32), 32): [
    ((0, 0, 0, 1), float("nan")), ((0, 31, 63, 2), float("nan")),
    ((1, 3, 4, 3), float("nan")), ((1, 20, 12, 3), float("nan")),
    ((1, 20, slice(13, 32), 3), -5.0)],
    (_BF16, (2, 32, 32, 8), 32): [
    ((0, slice(None), slice(None), slice(None)), float("-inf")),
    ((0, 31, 31, 0), float("nan")), ((0, 0, 0, 1), float("nan")),
    ((1, slice(None), slice(None), 2), -1.0), ((1, 5, 6, 2), -0.0),
    ((1, 5, 7, 2), 0.0)],
    # windows of 64 as of 32, and in batch 0's window (0, 1) channel 4 a
    # zero plateau with ones in two quarters: row 3's comes first in
    # row-major order, row 40's first in a fold of the quarters in order
    (_BF16, (2, 128, 128, 32), 64): [
    ((0, 0, 0, 1), float("nan")), ((0, 63, 63, 2), float("nan")),
    ((1, 3, 4, 3), float("nan")), ((1, 40, 12, 3), float("nan")),
    ((1, 40, slice(13, 64), 3), -5.0),
    ((0, slice(0, 64), slice(64, 128), 4), 0.0), ((0, 40, 64, 4), 1.0),
    ((0, 3, 114, 4), 1.0)],
    (_BF16, (2, 64, 64, 8), 64): [
    ((0, slice(None), slice(None), slice(None)), float("-inf")),
    ((0, 63, 63, 0), float("nan")), ((0, 0, 0, 1), float("nan")),
    ((1, slice(None), slice(None), 2), -1.0), ((1, 5, 6, 2), -0.0),
    ((1, 5, 7, 2), 0.0)]}
BWD_ROUTES = {
    **{c: BWD_ROWS for c in _BWD_DEC_3P + _BWD_TAPS_KSS if c[2] >= 4},
    (_BF16, (2, 32, 32, 32), 16): BWD_ROWS,
    (_BF16, (2, 37, 53, 16), 8): BWD_ROWS,
    **{c: BWD_BLOCK for c in BWD_EDGES if c[2] == 32},
    (_F32, (2, 70, 66, 3), 32): BWD_BLOCK + "<V=1>",
    **{c: BWD_WIDE for c in BWD_EDGES if c[2] == 64},
    (_F32, (2, 70, 66, 3), 64): BWD_WIDE + "<V=1>",
    (_BF16, (2, 64, 128, 16), 64): BWD_WIDE + "<V=1>",
}

# ---- the 1D pipeline (phases 21-23): BASELINE config 1 (BASELINE.md:28;
# the JAX package's benchmarks/zoo_bench.py:64-70), a 1D UNet of depth 3
# and width 32 on one-channel 1024-sample signals, Regression, linear head,
# MeanAbsoluteError, Adam, float32 (the [SIGNAL1D] defaults); batch 128
SIG_LEN = 1024
SIG_BATCH = 128
N_SIG_TRAIN, N_SIG_VAL, N_SIG_TEST = 1024, 128, 128
SIG_EPOCHS = 2
#: phase 22: counted fixed-batch steps of each of the other five archs
SIG_STEPS = 10
#: the JAX ``test_1d``'s metric keys (drivers_1d.py:336-350)
NILM_KEYS = ("DEOI", "EA", "JEOI", "MAE", "MSE", "PCC", "RMSE", "SAE",
             "restored_checkpoint")
# 1D calls are (dtype, (B, L, C) shape, levels, wanted) and (dtype, shape,
# factor): the encoder pools conv outputs 32, 64, 128 wide; the MultiRes
# encoder pools its blocks' outputs, 31 x 2**k (the branches truncate
# before the level's multiplier); UNet3+ pools skip 0 to levels 1-2 and
# skip 1 to level 1, one launch each; the DS targets are (B, L, 1) f32
_SIG_ENC = [(SIG_BATCH, SIG_LEN >> k, 32 << k) for k in range(3)]
_SIG_MRB = [(SIG_BATCH, SIG_LEN >> k, 31 << k) for k in range(3)]
_FWD1 = {dt: {"enc": [(dt, s, 1, (1,)) for s in _SIG_ENC],
              "mrb": [(dt, s, 1, (1,)) for s in _SIG_MRB],
              "dec3p": [(dt, _SIG_ENC[0], 2, _all(2)),
                        (dt, _SIG_ENC[1], 1, (1,))]}
         for dt in (_F32, _BF16)}
_SIG_DS_MASK = (_F32, (SIG_BATCH, SIG_LEN, 1), 3, _all(3))
_BWD1 = {dt: {"enc": [(dt, s, 2) for s in _SIG_ENC],
              "mrb": [(dt, s, 2) for s in _SIG_MRB],
              "dec3p": [(dt, _SIG_ENC[0], 4), (dt, _SIG_ENC[0], 2),
                        (dt, _SIG_ENC[1], 2)]}
         for dt in (_F32, _BF16)}
#: phase 22: path -> (arch, ds, ag)
SIG_ARCHS = {"1d_UNetE": ("UNetE", 0, 0), "1d_UNetP": ("UNetP", 0, 0),
             "1d_UNetPP": ("UNetPP", 0, 0), "1d_UNet3P_ds": ("UNet3P", 1, 0),
             "1d_MultiResUNet_ag": ("MultiResUNet", 0, 1)}
#: phase 24: BASELINE config 5's 1D models (zoo_bench.py:112-121) at
#: config 1's size, loss and optimizer; IBAUNet with its LSTM attention
#: gates.  path -> (model_name, keyword arguments).  Each pools its level
#: outputs 32, 64 and 128 wide, as config 1's encoder does
CONFIG5_1D = {"config5_BCDUNet": ("BCDUNet", dict(lstm=1, dense_loop=2)),
              "config5_SEDUNet": ("SEDUNet", dict(se_ratio=8)),
              "config5_NABNet": ("NABNet", dict(dense_loop=2)),
              "config5_IBAUNet": ("IBAUNet", dict(ag=1))}
#: phase 24's runs of the 1D verbs: path -> the CONFIG5_1D path
CONFIG5_VERBS = {"config5_verbs_BCDUNet": "config5_BCDUNet",
                 "config5_verbs_NABNet": "config5_NABNet"}
_CONFIG5_RUNS = [(p + sfx, dt) for p in CONFIG5_1D
                 for sfx, dt in (("", _F32), ("_bf16", _BF16))]
#: phase 26: the rest of the 1D zoo at config 1's size, SIG_STEPS counted steps
#: each in float32 (``_bf16``: bfloat16): path -> (arch, keyword
#: arguments).  The conv, recurrent, r2 and ConvMixer encoders pool their
#: level outputs 32, 64 and 128 wide (UNet4P's dense encoder too, one
#: launch a tap that its level-3 input reads again), ConvMixerMultiResUNet
#: its MultiRes blocks' 31, 62 and 124, MultiResUNet3P its ResPath taps
#: 64, 128 and 256; the UNet3+-type decoders add their skip pyramids
ZOO_1D = {
    "1d_UNet4P": ("UNet4P", {}), "1d_MultiResUNet3P": ("MultiResUNet3P", {}),
    "1d_RUNet": ("RUNet", {}), "1d_R2UNet": ("R2UNet", {}),
    "1d_R2UNetPP": ("R2UNetPP", {}), "1d_R2UNet3P": ("R2UNet3P", {}),
    "1d_ConvMixerUNet": ("ConvMixerUNet", {}),
    "1d_ConvMixerUNetE": ("ConvMixerUNetE", {}),
    "1d_ConvMixerUNetP": ("ConvMixerUNetP", {}),
    "1d_ConvMixerUNetPP": ("ConvMixerUNetPP", {}),
    "1d_ConvMixerUNet3P": ("ConvMixerUNet3P", {}),
    "1d_ConvMixerMultiResUNet": ("ConvMixerMultiResUNet", {}),
    "1d_R2UNet_bf16": ("R2UNet", {}),
    "1d_ConvMixerUNet_bf16": ("ConvMixerUNet", {}),
    "1d_MultiResUNet3P_bf16": ("MultiResUNet3P", {}),
    "1d_UNetPP_lstm": ("UNetPP", dict(lstm=1)),
    "1d_UNet_ae": ("UNet", dict(ae=1)),
    "1d_BCDUNet_ae": ("BCDUNet", dict(ae=1, lstm=1, dense_loop=2)),
    "1d_R2UNet3P_ds": ("R2UNet3P", dict(ds=1)),
}
#: phase 26's runs of the 1D verbs: path -> (arch, INI keys)
ZOO_1D_VERBS = {"1d_verbs_R2UNet_lstm": ("R2UNet", dict(lstm=1)),
                "1d_verbs_MultiResUNet3P": ("MultiResUNet3P", {})}
#: phase 29: config 1's signals are multiplied by SELF_1D_SCALE for the 1D
#: Self-ONN archs.  Each of their Opers stacks x, x**2 and x**3 and the 1D
#: tree puts no BatchNorm or tanh after it, so on config 1's signals
#: (amplitude up to ~5.5) the reference's own float32 forward overflows.
#: On this phase's 128 signals JAX's (W32/D3, its PRNGKey(0) weights) is
#: non-finite for SelfUNetPP and SelfUNet3P at 1, 0.3 and 0.1 and finite
#: at 0.03; SelfR2UNetPP's, whose encoder levels end in BatchNorm, so
#: that its bare decoder cubes normalized values whatever the signals'
#: scale, is non-finite at every scale down to 0.01 and finite at 0.001.
#: SELF_1D_SCALE is the largest of 1, 0.3, 0.1, 0.03, 0.01 and 0.001 at
#: which all three are finite (tests/test_torch_self_models.py holds the
#: port to JAX's overflow and checks this constant).  The scale is chosen
#: for the reference, not for the port.
SELF_1D_SCALE = 0.001
#: phase 29: the 1D Self-ONN archs at config 1's size, float32, 20
#: counted steps each: path -> (arch, keyword arguments).  Their encoders
#: pool their level outputs 32, 64 and 128 wide; SelfUNet3P adds UNet3+'s
#: skip pyramids (and with ``d_s = 1`` the targets')
SELF_1D = {"1d_self_SelfR2UNetPP": ("SelfR2UNetPP", {}),
           "1d_self_SelfUNetPP": ("SelfUNetPP", {}),
           "1d_self_SelfUNet3P": ("SelfUNet3P", {}),
           "1d_self_SelfUNet3P_ds": ("SelfUNet3P", dict(ds=1))}
#: phase 29's counted steps: at SIG_STEPS (10) SelfUNet3P's loss on the
#: scaled signals did not fall on an H100 (NVIDIA H100 80GB HBM3, 700 W),
#: at 20 it does
SELF_1D_STEPS = 20
#: phase 29's run of the 1D verbs: path -> (arch, INI keys)
SELF_1D_VERBS = {"1d_verbs_SelfUNetPP": ("SelfUNetPP", {})}
_SIG_MR3P = [(SIG_BATCH, SIG_LEN >> k, 64 << k) for k in range(3)]
for _dt in (_F32, _BF16):
    _FWD1[_dt]["mr3p"] = [(_dt, s, 1, (1,)) for s in _SIG_MR3P]
    _BWD1[_dt]["mr3p"] = [(_dt, s, 2) for s in _SIG_MR3P]


#: phase 30: the last 1D special families at config 1's size, float32,
#: batch 128: path -> (arch, keyword arguments).  TernausNet pools its
#: five stages (32, 64, 128, 256, 256 wide; its depth is fixed at 5),
#: AlbUNet only its stem (32 wide at 512 samples; the rest downsamples by
#: strided convolutions), MultiResLinkNet and SAMultiResUNet their
#: MultiRes blocks' 31, 62, 124, Dense_Inception_UNet its blocks' 1 + W,
#: 3 W and 44 W (the odd 33 takes the one-channel-a-thread route), the
#: rest their level outputs 32, 64, 128; MLMRSNet_V2 also pools its taps
#: to the deeper levels (by 2 and 4)
ZOO_1D_SPECIALS = {
    f"1d_special_{name}": (name, {}) for name in (
        "TernausNet11", "TernausNet13", "TernausNet16", "TernausNet19",
        "AlbUNet18", "AlbUNet34", "AlbUNet50", "AlbUNet101", "AlbUNet152",
        "LinkNet", "LinkNetE", "LinkNetP", "LinkNetPP", "MultiResLinkNet",
        "FPN", "MLMRSNet", "MLMRSNet_V2", "LDNet", "SAUNet",
        "SAMultiResUNet", "SelfSAUNet", "Dense_Inception_UNet")}
#: phase 30: the names that take SPECIALS_LONG_STEPS counted steps, the
#: loss falling, and have a W8/D3 reference; the others take
#: SPECIALS_SHORT_STEPS
SPECIALS_LONG = ("TernausNet16", "AlbUNet34", "LinkNetPP", "MultiResLinkNet",
                 "FPN", "MLMRSNet", "MLMRSNet_V2", "LDNet", "SAUNet",
                 "SAMultiResUNet", "SelfSAUNet", "Dense_Inception_UNet")
SPECIALS_LONG_STEPS = 20
SPECIALS_SHORT_STEPS = 5
#: phase 30's reference inputs: (2, 256, 1) signals, but Dense_Inception_
#: UNet's (2, 128, 1).  Its dense blocks give it 867,840 ReLU
#: pre-activations at 256 samples, 4-8 times the others', and on an H100
#: (NVIDIA H100 80GB HBM3, 700 W) 5 and 8 of them landed on the other side
#: of 0 from the card's, over MAX_RELU_FLIPS.  At 64 samples the flips
#: were 0 and 1, but its Upsampling blocks' BatchNorms, whose batch
#: variances reach ~290 at random init, then rounded their running
#: variances 2.6-3.6e-5 apart, over phase 7's 1e-5: the CPU's own float32
#: step is 2.2e-5 off its float64 one there, 4.8e-6 at 128 samples and
#: 6.4e-6 at 256
SPECIALS_REF_LEN = {"Dense_Inception_UNet": 128}
#: phase 30's runs of the 1D verbs: path -> (arch, INI keys); SAUNet with
#: DropBlock at the INI's keep_prob 0.9, LinkNetPP with full-length DS
#: targets (ds_type UNetPP: no targets' pyramid)
ZOO_1D_SPECIALS_VERBS = {
    "1d_verbs_SAUNet": ("SAUNet", {}),
    "1d_verbs_LinkNetPP_ds": ("LinkNetPP", dict(d_s=1, ds_type="UNetPP"))}
_SIG_TERNAUS = [(SIG_BATCH, SIG_LEN >> k, 32 << min(k, 3)) for k in range(5)]
_SIG_DIU = [(SIG_BATCH, SIG_LEN, 33), (SIG_BATCH, SIG_LEN >> 1, 96),
            (SIG_BATCH, SIG_LEN >> 2, 1408)]
_SIG_ALB = [(SIG_BATCH, SIG_LEN >> 1, 32)]
#: MLMRSNet_V2's other pools in call order: tap 1 by 2 into level 2, then
#: the decoder's: tap 0 by 4, tap 1 by 2, tap 0 by 2
_SIG_V2 = [(_SIG_ENC[1], 2), (_SIG_ENC[0], 4), (_SIG_ENC[1], 2),
           (_SIG_ENC[0], 2)]


def _special_calls(path: str, calls: dict) -> list:
    """The 1D calls a phase 30 path makes a step (``calls``: _FWD1 or
    _BWD1)."""
    arch = {**ZOO_1D_SPECIALS, **ZOO_1D_SPECIALS_VERBS}[path][0]
    dt = _F32
    fwd = calls is _FWD1

    def pools(shapes, factor=2):
        lvl = factor.bit_length() - 1
        return [(dt, s, lvl, (lvl,)) if fwd else (dt, s, factor)
                for s in shapes]

    if arch.startswith("TernausNet"):
        return pools(_SIG_TERNAUS)
    if arch.startswith("AlbUNet"):
        return pools(_SIG_ALB)
    if arch == "Dense_Inception_UNet":
        return pools(_SIG_DIU)
    if arch in ("MultiResLinkNet", "SAMultiResUNet"):
        return list(calls[dt]["mrb"])
    out = list(calls[dt]["enc"])
    if arch == "MLMRSNet_V2":
        # the encoder's own pool of tap 2 comes after tap 1's extra pool
        extra = [c for s, f in _SIG_V2 for c in pools([s], f)]
        out = out[:2] + extra[:1] + out[2:] + extra[1:]
    return out


def _zoo_calls(path: str, calls: dict) -> list:
    """The 1D calls a phase 26 or 29 path makes a step (``calls``: _FWD1
    or _BWD1): its encoder's pools, the UNet3+-type decoders' skip
    pyramids and, forward with ``ds``, the targets' pyramid."""
    arch, kw = {**ZOO_1D, **ZOO_1D_VERBS, **SELF_1D, **SELF_1D_VERBS}[path]
    dt = _BF16 if path.endswith("_bf16") else _F32
    enc = ("mr3p" if arch == "MultiResUNet3P" else
           "mrb" if arch == "ConvMixerMultiResUNet" else "enc")
    out = list(calls[dt][enc])
    if arch.endswith("UNet3P") and arch != "MultiResUNet3P":
        out += calls[dt]["dec3p"]
    if kw.get("ds") and calls is _FWD1:
        out.append(_SIG_DS_MASK)
    return out


#: phase 33: the 1D models that pool by 32 at config 1's size and width
#: (W32, 1024 samples, batch 128, float32): path -> (arch, depth).  The UNet3+-type archs at depth 6 pool
#: skip 0 to levels 1-5, MLMRSNet_V2 at depth 6 pools its tap 0 by 32,
#: UNet4P at depth 7 its tap 1 to levels 1-5 (``_deep_calls``)
DEEP_1D = {"1d_deep_UNet3P_D6": ("UNet3P", 6),
           "1d_deep_R2UNet3P_D6": ("R2UNet3P", 6),
           "1d_deep_SelfUNet3P_D6": ("SelfUNet3P", 6),
           "1d_deep_ConvMixerUNet3P_D6": ("ConvMixerUNet3P", 6),
           "1d_deep_MLMRSNet_V2_D6": ("MLMRSNet_V2", 6),
           "1d_deep_UNet4P_D7": ("UNet4P", 7)}
#: phase 33's run of the 1D verbs: path -> (arch, depth, INI keys);
#: ``d_s = 1`` at depth 5 pools the mask by 2 .. 32 for the targets
DEEP_1D_VERBS = {"1d_verbs_UNet3P_D5_ds": ("UNet3P", 5, dict(d_s=1))}
#: phase 33's counted steps (the loss must fall: the mean of the last 5
#: below the first 5's); SelfUNet3P takes SELF_1D_STEPS, as in phase 29
DEEP_STEPS = 10
#: the deep-supervision targets of config 1's signals pooled to level 5
_SIG_DS_MASK5 = (_F32, (SIG_BATCH, SIG_LEN, 1), 5, _all(5))
#: phase 35: the 1D models that pool by 64 at config 1's size and width:
#: path -> (arch, depth).  The UNet3+-type archs at depth 7 pool skip 0 to
#: levels 1-6, MLMRSNet_V2 at depth 7 its tap 0 by 64, UNet4P at depth 8
#: its tap 1 to levels 1-6 (``_deep_calls``)
DEEPER_1D = {"1d_deeper_UNet3P_D7": ("UNet3P", 7),
             "1d_deeper_R2UNet3P_D7": ("R2UNet3P", 7),
             "1d_deeper_SelfUNet3P_D7": ("SelfUNet3P", 7),
             "1d_deeper_ConvMixerUNet3P_D7": ("ConvMixerUNet3P", 7),
             "1d_deeper_MLMRSNet_V2_D7": ("MLMRSNet_V2", 7),
             "1d_deeper_UNet4P_D8": ("UNet4P", 8)}
#: phase 35's run of the 1D verbs: ``d_s = 1`` at depth 6 pools the mask by
#: 2 .. 64 for the targets
DEEPER_1D_VERBS = {"1d_verbs_UNet3P_D6_ds": ("UNet3P", 6, dict(d_s=1))}
#: phase 35's counted steps, each with a finite loss (not held to fall)
DEEPER_STEPS = 3
_SIG_DS_MASK6 = (_F32, (SIG_BATCH, SIG_LEN, 1), 6, _all(6))
_SIG_DS_MASKS = (_SIG_DS_MASK, _SIG_DS_MASK5, _SIG_DS_MASK6)


def _deep_calls(arch: str, depth: int, ds: int = 0, batch: int = SIG_BATCH,
                length: int = SIG_LEN, width: int = 32, dt: str = _F32
                ) -> tuple:
    """The 1D pyramid calls (dtype, (B, L, C), levels, wanted) and
    pool-backward calls (dtype, (B, L, C), factor) one train step of
    ``arch`` at ``depth`` makes, tap k being (batch, length >> k, width
    << k): the UNet3+-type archs pool every tap by 2 (one launch each) and
    skip k to levels 1 .. D - 1 - k (one launch a skip); UNet4P pools tap
    0 by 2 and tap k > 0 to levels 1 .. max(D - 1 - k, 1) (one launch a
    tap); MLMRSNet_V2 pools each tap alone, in its encoder (tap i by 2,
    taps 1 .. i - 2 into level i) and decoder (step j: taps k < D - j - 1
    by 2**(D - j - k - 1)); ``ds`` adds the targets' pyramid, the mask
    pooled to level D.  Every pooled level has one backward launch, the
    targets none.  tests/test_torch_chip_smoke_tables.py holds these to the
    calls the models make on the CPU."""
    def tap(k):
        return (batch, length >> k, width << k)

    if arch == "MLMRSNet_V2":
        pools = [(k, lvl) for i in range(depth)
                 for k, lvl in [(kk, i - kk) for kk in range(1, i)] + [(i, 1)]]
        pools += [(k, depth - j - k - 1) for j in range(depth)
                  for k in range(depth - j - 1)]
        fwd = [(dt, tap(k), lvl, (lvl,)) for k, lvl in pools]
    elif arch == "UNet4P":
        fwd = [(dt, tap(0), 1, (1,))] + [
            (dt, tap(k), max(depth - 1 - k, 1),
             _all(max(depth - 1 - k, 1))) for k in range(1, depth)]
    else:
        fwd = [(dt, tap(k), 1, (1,)) for k in range(depth)] + [
            (dt, tap(k), depth - 1 - k, _all(depth - 1 - k))
            for k in range(depth - 1)]
    bwd = [(c[0], c[1], 1 << lvl) for c in fwd for lvl in c[3]]
    if ds:
        fwd.append((_F32, (batch, length, 1), depth, _all(depth)))
    return fwd, bwd


FWD_PATHS_1D = {
    "config1": _FWD1[_F32]["enc"],
    "config1_bf16": _FWD1[_BF16]["enc"],
    "config1_ds": _FWD1[_F32]["enc"] + [_SIG_DS_MASK],
    **{p: _FWD1[_F32]["enc"] for p in ("1d_UNetE", "1d_UNetP", "1d_UNetPP")},
    "1d_UNet3P_ds": _FWD1[_F32]["enc"] + _FWD1[_F32]["dec3p"]
    + [_SIG_DS_MASK],
    "1d_MultiResUNet_ag": _FWD1[_F32]["mrb"],
    **{p: _FWD1[dt]["enc"] for p, dt in _CONFIG5_RUNS},
    "config5_BCDUNet_ds": _FWD1[_F32]["enc"] + [_SIG_DS_MASK],
    **{p: _FWD1[_F32]["enc"] for p in CONFIG5_VERBS},
    **{p: _zoo_calls(p, _FWD1) for p in {**ZOO_1D, **ZOO_1D_VERBS,
                                         **SELF_1D, **SELF_1D_VERBS}},
    **{p: _special_calls(p, _FWD1) for p in {**ZOO_1D_SPECIALS,
                                             **ZOO_1D_SPECIALS_VERBS}},
    **{p: _deep_calls(*spec[:2])[0] for p, spec in DEEP_1D.items()},
    **{p: _deep_calls(a, d, kw.get("d_s", 0))[0]
       for p, (a, d, kw) in {**DEEP_1D_VERBS, **DEEPER_1D_VERBS}.items()},
    **{p: _deep_calls(*spec)[0] for p, spec in DEEPER_1D.items()},
}
BWD_PATHS_1D = {
    "config1": _BWD1[_F32]["enc"],
    "config1_bf16": _BWD1[_BF16]["enc"],
    "config1_ds": _BWD1[_F32]["enc"],
    **{p: _BWD1[_F32]["enc"] for p in ("1d_UNetE", "1d_UNetP", "1d_UNetPP")},
    "1d_UNet3P_ds": _BWD1[_F32]["enc"] + _BWD1[_F32]["dec3p"],
    "1d_MultiResUNet_ag": _BWD1[_F32]["mrb"],
    **{p: _BWD1[dt]["enc"] for p, dt in _CONFIG5_RUNS},
    "config5_BCDUNet_ds": _BWD1[_F32]["enc"],
    **{p: _BWD1[_F32]["enc"] for p in CONFIG5_VERBS},
    **{p: _zoo_calls(p, _BWD1) for p in {**ZOO_1D, **ZOO_1D_VERBS,
                                         **SELF_1D, **SELF_1D_VERBS}},
    **{p: _special_calls(p, _BWD1) for p in {**ZOO_1D_SPECIALS,
                                             **ZOO_1D_SPECIALS_VERBS}},
    **{p: _deep_calls(*spec[:2])[1] for p, spec in DEEP_1D.items()},
    **{p: _deep_calls(a, d, kw.get("d_s", 0))[1]
       for p, (a, d, kw) in {**DEEP_1D_VERBS, **DEEPER_1D_VERBS}.items()},
    **{p: _deep_calls(*spec)[1] for p, spec in DEEPER_1D.items()},
}
#: phase 25: BASELINE config 5's 2D model (zoo_bench.py:123-130), a W32/D4
#: UNet on EfficientNetB0 (random weights: encoder_weights = none), bf16,
#: batch 16 at 256x256; it downsamples by strided convolutions, so it
#: launches no pool kernel
EFFNET = "EfficientNetB0"
EFFNET_STEPS = 10

# ---- phases 31-32: the dense-input family from scratch, every
# backbone, the gated tap projectors; W32, batch 16, 256x256, bf16
#: encoder tap k of a W32 model at 256x256: (16, 256 >> k, 256 >> k, 32 << k)
_TAP = [(TRAIN_BATCH, SIZE >> k, SIZE >> k, 32 << k) for k in range(7)]
#: a W32-wide tensor at tap k's grid (AHNet's ResPaths of the encoder taps)
_AT_W = [(TRAIN_BATCH, SIZE >> k, SIZE >> k, 32) for k in range(7)]


def _pyramids(taps: list, deepest: int) -> tuple:
    """UNet4P and UNet4PV2 (and the gated projectors): tap k pooled once
    to levels 1 .. deepest - k, each level with its own backward."""
    fwd = [(_BF16, s, deepest - k, _all(deepest - k))
           for k, s in enumerate(taps[:deepest])]
    bwd = [(_BF16, s, 1 << lvl) for k, s in enumerate(taps[:deepest])
           for lvl in range(1, deepest - k + 1)]
    return fwd, bwd


def _ahnet_encoder(depth: int, taps: list = _TAP, at_w: list = _AT_W
                   ) -> tuple:
    """AHNet's encoder: for each block i its fresh ResPath (W wide) on
    taps 0 .. i-1 pooled by 2**(i-k), then the chain's pool by 2 of tap
    i - 1, each a single level with its own backward."""
    fwd, bwd = [], []
    for i in range(1, depth + 1):
        for k in range(i):
            fwd.append((_BF16, at_w[k], i - k, (i - k,)))
            bwd.append((_BF16, at_w[k], 1 << (i - k)))
        fwd.append((_BF16, taps[i - 1], 1, (1,)))
        bwd.append((_BF16, taps[i - 1], 2))
    return fwd, bwd


def _ahnet_projectors(batch: int) -> tuple:
    """AHNet's tap projectors on a backbone (five levels) at ``batch``:
    level l's own ResPath, W * 2**(l-1) wide, on projected tap k < l,
    pooled by 2**(l-k)."""
    fwd, bwd = [], []
    for lvl in range(2, 6):
        for k in range(1, lvl):
            shape = (batch,) + _TAP[k - 1][1:3] + (32 << (lvl - 1),)
            fwd.append((_BF16, shape, lvl - k, (lvl - k,)))
            bwd.append((_BF16, shape, 1 << (lvl - k)))
    return fwd, bwd


#: the KSSNet W32/D5 encoder: its MultiRes chain pools (widths 31 .. 511)
#: and its ResPath taps' pyramids
_MRB_D5 = [s[:3] + (c,) for s, c in zip(_TAP, (31, 63, 127, 255, 511))]
_KSS_D5 = _pyramids(_TAP, 5)
#: phase 31: path -> (decoder, depth, (forward calls, backward calls))
DENSE_2D = {
    "dense_UNet4P": ("UNet4P", 4, _pyramids(_TAP, 4)),
    "dense_UNet4PV2": ("UNet4PV2", 4, (_pyramids(_TAP, 4)[0] + _FWD_DEC_3P,
                                       _pyramids(_TAP, 4)[1] + _BWD_DEC_3P)),
    "dense_AHNet": ("AHNet", 4, _ahnet_encoder(4)),
    "dense_UNet4P_D5": ("UNet4P", 5, _pyramids(_TAP, 5)),
    "dense_AHNet_D5": ("AHNet", 5, _ahnet_encoder(5)),
    "dense_KSSNet_D5": ("KSSNet", 5, (
        [(_BF16, s, 1, (1,)) for s in _MRB_D5] + _KSS_D5[0],
        [(_BF16, s, 2) for s in _MRB_D5] + _KSS_D5[1])),
}
DENSE_STEPS = 10
#: phase 31's references: W8/D3 float32 card vs CPU (pool launches a step)
DENSE_REF = {"UNet4P": (3, 6), "UNet4PV2": (5, 9), "AHNet": (9, 9)}
#: phase 32: the backbones the port added (every name but EfficientNet V1)
NEW_BACKBONES = tuple(
    n for n in ("ResNet50", "ResNet101", "ResNet152", "ResNet50V2",
                "ResNet101V2", "ResNet152V2", "VGG16", "VGG19", "DenseNet121",
                "DenseNet169", "DenseNet201", "CheXNet", "MobileNet",
                "MobileNetV2", "MobileNetV3Small", "MobileNetV3Large",
                "InceptionV3", "InceptionResNetV2", "EfficientNetV2B0",
                "EfficientNetV2B1", "EfficientNetV2B2", "EfficientNetV2B3",
                "EfficientNetV2S", "EfficientNetV2M", "EfficientNetV2L"))
#: one name a backbone class: 10 counted steps, then frozen
BACKBONE_CLASSES = ("ResNet50", "ResNet50V2", "VGG16", "DenseNet121",
                    "MobileNet", "MobileNetV2", "MobileNetV3Large",
                    "InceptionV3", "InceptionResNetV2", "EfficientNetV2S")
BACKBONE_STEPS = 3
#: phase 32's gated projector families on ResNet50, W32: path -> (decoder,
#: depth, (forward, backward calls)); MultiResUNet and the UNet with
#: ``a_e = 1`` pool nothing
_PROJ_PYR = _pyramids(_TAP, 4)
PROJECTORS_2D = {
    "proj_MultiResUNet": ("MultiResUNet", 4, ([], [])),
    "proj_MultiResUNet3P": ("MultiResUNet3P", 4, (_FWD_DEC_3P, _BWD_DEC_3P)),
    "proj_KSSNet": ("KSSNet", 4, _PROJ_PYR),
    "proj_UNet4P": ("UNet4P", 4, _PROJ_PYR),
    "proj_UNet4PV2": ("UNet4PV2", 4, (_PROJ_PYR[0] + _FWD_DEC_3P,
                                      _PROJ_PYR[1] + _BWD_DEC_3P)),
    "proj_AHNet": ("AHNet", 4, _ahnet_projectors(4)),
    "proj_UNet4P_D5": ("UNet4P", 5, _PROJ_PYR),
    "proj_UNet_ae": ("UNet", 4, ([], [])),
}
PROJ_BACKBONE = "ResNet50"
#: AHNet's projectors run ResPaths W * 16 = 512 wide at the input's full
#: resolution (the JAX graph's): at batch 16 the step ran out of the
#: card's 80 GB (an NVIDIA H100 80GB HBM3), so that path trains on
#: batch 4
PROJ_BATCH = {"proj_AHNet": 4}
for _table in (DENSE_2D, PROJECTORS_2D):
    for _path, (_, _, (_f, _b)) in _table.items():
        if _f or _b:
            FWD_PATHS[_path] = _f
            BWD_PATHS[_path] = _b
FWD_PATHS["train_AHNet"] = DENSE_2D["dense_AHNet"][2][0]
BWD_PATHS["train_AHNet"] = DENSE_2D["dense_AHNet"][2][1]
FWD_PATHS["train_UNet4PV2_ResNet50"] = FWD_PATHS["proj_UNet4PV2"]
BWD_PATHS["train_UNet4PV2_ResNet50"] = BWD_PATHS["proj_UNet4PV2"]


def _backward_of(fwd: list) -> list:
    """One backward launch for each level each pyramid call stores (the
    deep-supervision targets' pyramid, C = 1, has none)."""
    return [(c[0], c[1], 1 << lvl) for c in fwd if c[1][-1] > 1
            for lvl in c[3]]


def _full_scale(depth: int, taps: list) -> list:
    """A full-scale decoder's skip pyramids at ``depth``: tap k pooled to
    levels 1 .. depth - 1 - k, one launch a skip."""
    return [(_BF16, taps[k], depth - 1 - k, _all(depth - 1 - k))
            for k in range(depth - 1)]


def _chain_pools(depth: int, taps: list, multires: bool = False) -> list:
    """The encoder chain's pools by 2 of taps 0 .. depth - 1; ``multires``:
    of the MultiRes blocks, whose width truncates by their branches (31,
    63, .., 2047 for taps 32, 64, .., 2048 wide; ops/blocks.py
    multires_widths)."""
    def width(u):
        return sum(max(int(u * f), 1) for f in (0.167, 0.333, 0.5))

    return [(_BF16, s[:3] + ((width(s[3]),) if multires else s[3:]), 1,
             (1,)) for s in taps[:depth]]


def _deep_2d_fwd(path: str, batch: int = TRAIN_BATCH, size: int = SIZE,
                 width: int = 32) -> list:
    """The pyramid calls one train step of phase 34's ``path`` makes, its
    tap k being (batch, size >> k, size >> k, width << k).  KSSNet, UNet4P
    and UNet4PV2 at depth 6 pool tap 0 to levels 1-6, AHNet its tap 0
    ResPath by 64 alone, the full-scale decoders at depth 7 skip 0 to
    levels 1-6; UNet3P with ``d_s = 1`` adds the targets' pyramid to level
    7.  tests/test_torch_chip_smoke_tables.py holds these to the calls the
    models make on the CPU."""
    taps = [(batch, size >> k, size >> k, width << k) for k in range(7)]
    at_w = [(batch, size >> k, size >> k, width) for k in range(7)]
    return {
        "deep_KSSNet_D6": _chain_pools(6, taps, multires=True)
        + _pyramids(taps, 6)[0],
        "deep_UNet3P_D7_ds": _chain_pools(7, taps) + _full_scale(7, taps)
        + [(_F32, (batch, size, size, 1), 7, _all(7))],
        "deep_UNet4P_D6": _pyramids(taps, 6)[0],
        "deep_UNet4PV2_D6": _pyramids(taps, 6)[0] + _full_scale(6, taps),
        "deep_AHNet_D6": _ahnet_encoder(6, taps, at_w)[0],
        "deep_MultiResUNet3P_D7": _chain_pools(7, taps, multires=True)
        + _full_scale(7, taps),
        "deep_SelfUNet3P_D7": _chain_pools(7, taps) + _full_scale(7, taps),
    }[path]


#: phase 34: the 2D models that pool by 64, W32 from scratch at 256x256,
#: batch 16, bf16: path -> (decoder, depth, keyword arguments); their
#: calls are ``_deep_2d_fwd``'s, one backward a stored level
DEEP_2D = {
    "deep_KSSNet_D6": ("KSSNet", 6, {}),
    "deep_UNet3P_D7_ds": ("UNet3P", 7, dict(ds=1)),
    "deep_UNet4P_D6": ("UNet4P", 6, {}),
    "deep_UNet4PV2_D6": ("UNet4PV2", 6, {}),
    "deep_AHNet_D6": ("AHNet", 6, {}),
    "deep_MultiResUNet3P_D7": ("MultiResUNet3P", 7, {}),
    "deep_SelfUNet3P_D7": ("SelfUNet3P", 7, {})}
#: phase 34's paths that take DEEP_LONG_STEPS counted steps with the loss
#: falling; the others take DEEP_SHORT_STEPS on the images times
#: SELF_2D_SCALE, as phase 28, with finite losses
DEEP_2D_LONG = ("deep_KSSNet_D6", "deep_UNet3P_D7_ds")
DEEP_LONG_STEPS = 10
DEEP_SHORT_STEPS = 3
for _path in DEEP_2D:
    FWD_PATHS[_path] = _deep_2d_fwd(_path)
    BWD_PATHS[_path] = _backward_of(FWD_PATHS[_path])
#: phase 34's run of the train verb: UNet3P at depth 7 with ``d_s = 1``
FWD_PATHS["train_UNet3P_D7_ds"] = FWD_PATHS["deep_UNet3P_D7_ds"]
BWD_PATHS["train_UNet3P_D7_ds"] = BWD_PATHS["deep_UNet3P_D7_ds"]
#: phase 34's references: W8 float32 card vs CPU at REF_SIZE_64 (decoder,
#: depth, keyword arguments, pool launches a step): UNet4P at depth 6 (its
#: tap 0 to level 6, a pool backward by 64), UNet3P at depth 7 with
#: ``d_s = 1`` (its targets to level 7 on the one-channel kernel)
DEEP_2D_REF = (("UNet4P", 6, {}, (6, 21)), ("UNet3P", 7, dict(ds=1), (14, 28)))
REF_SIZE_64 = 128
#: every level-5 and level-6 call at a C of several channels takes the
#: 16-byte pyramid kernel, every one-channel call (the deep-supervision
#: targets, to level 7) the one-channel kernel, every level 2-4 alone at a
#: C of whole 16 bytes ROWS16; every pool backward by 4-16 the row kernel,
#: by 32 the block kernel, by 64 the wide kernel
FWD_ROUTES.update({c: "pyramid_vec_kernel" for cs in FWD_PATHS.values()
                   for c in cs if c[2] in (5, 6) and c[1][-1] > 1})
FWD_ROUTES.update({c: "pyramid_c1_kernel" for cs in FWD_PATHS.values()
                   for c in cs if c[1][-1] == 1})
FWD_ROUTES.update({
    c: ROWS16 for cs in FWD_PATHS.values() for c in cs
    if 2 <= c[2] <= 4 and c[3] == (c[2],)
    and c[1][-1] * (4 if c[0] == _F32 else 2) % 16 == 0})
BWD_ROUTES.update({c: {32: BWD_BLOCK, 64: BWD_WIDE}.get(c[2], BWD_ROWS)
                   for cs in BWD_PATHS.values() for c in cs if c[2] >= 4})
#: timed beside the paths' calls: the same calls in bf16, and skip 0 of
#: the UNet3+-type archs at depth 7 (levels 1-6) and its backward by 64
FWD1_TWINS = _FWD1[_BF16]["mrb"] + _FWD1[_BF16]["dec3p"] + [
    (_BF16, _SIG_ENC[0], 6, _all(6))]
BWD1_TWINS = _BWD1[_BF16]["mrb"] + _BWD1[_BF16]["dec3p"] + [
    (_BF16, _SIG_ENC[0], 64)]
FWD1_EDGES = [
    (_F32, (3, 1001, 8), 4, (1, 3)),   # ragged, 16-byte, levels 1 and 3
    (_BF16, (2, 77, 3), 3, _all(3)),   # ragged, one channel a thread
    (_F32, (3, 37, 5), 4, _all(4)),    # level 4 of a 37-sample signal: 2
    (_BF16, (2, 3, 16), 2, _all(2)),   # level 2 empty
    (_BF16, (2, 64, 24), 1, (1,)),     # offset: no row on 16 bytes
    (_F32, (2, 100, 33), 5, _all(5)),  # ragged, level 5
    (_BF16, (2, 70, 24), 5, (5,)),     # ragged, level 5 alone, 16-byte
    (_BF16, (7, 96, 31), 5, (2, 5)),   # staged: the last span cut short
    (_F32, (5, 64, 3), 4, (1, 4)),     # staged, 12-byte rows
    (_BF16, (3, 64, 1), 5, _all(5)),   # C = 1 bf16, one thread a signal
    (_BF16, (1, 6, 1), 1, (1,)),       # C = 1, 6 positions: staged
    (_F32, (2, 64, 1), 3, _all(3)),    # offset C = 1: one channel a thread
    (_BF16, (2, 64, 8), 2, _all(2)),   # offset 16 bytes: flat
    (_BF16, (2, 64, 2047), 5, (5,)),   # a span past shared memory
    (_F32, (3, 96, 12), 5, (1, 5)),    # 16-byte, 3 groups, lanes a row
    (_F32, (3, 200, 33), 6, _all(6)),  # level 6: ragged, odd C
    (_BF16, (2, 130, 24), 6, (6,)),    # ragged, level 6 alone, 16-byte
    (_BF16, (7, 128, 31), 6, (2, 6)),  # odd C past the staged fold's 48 KB
    (_F32, (3, 192, 12), 6, (1, 6)),   # 16-byte, 3 groups, 8 lanes a row
    (_F32, (5, 64, 3), 6, _all(6)),    # staged, 12-byte rows
    (_BF16, (3, 128, 1), 6, _all(6)),  # C = 1 bf16: 8 vectors a thread
    (_F32, (2, 63, 8), 6, _all(6)),    # shorter than a top row
    (_F32, (2, 128, 8), 6, (6,)),      # offset 16 bytes: flat
]
#: edge cases in a view of their storage: elements before its first
FWD1_OFFSETS = {(_BF16, (2, 64, 24), 1, (1,)): 1,
                (_F32, (2, 64, 1), 3, _all(3)): 2,
                (_BF16, (2, 64, 8), 2, _all(2)): 8,
                (_F32, (2, 128, 8), 6, (6,)): 4}
BWD1_EDGES = [
    (_F32, (3, 1001, 8), 4), (_BF16, (2, 77, 3), 8), (_F32, (2, 37, 16), 16),
    (_BF16, (1, 3, 8), 4),             # nothing pooled: zeros
    (_F32, (3, 100, 33), 32),          # F = 32: odd C, a ragged tail
    (_BF16, (2, 96, 1), 32),           # one channel
    (_F32, (2, 31, 8), 32),            # shorter than a window: zeros
    (_F32, (3, 200, 33), 64),          # F = 64: odd C, a ragged tail
    (_BF16, (2, 192, 1), 64),          # one channel
    (_F32, (2, 63, 8), 64),            # shorter than a window: zeros
    (_F32, (3, 130, 8), 64),           # a ragged tail past two windows
]
#: 1D backward edge cases drawn with values planted (signal, position,
#: channel) besides the plateaus and the NaN: in a window of 64, a NaN
#: first, last, and twice with -5s after the second; ties in the two
#: lanes' halves of a window (a 1 at 40 and at 10: 10 comes first)
PLANTS1 = {(_F32, (3, 130, 8), 64): [
    ((0, 0, 1), float("nan")), ((0, 63, 2), float("nan")),
    ((1, 3, 3), float("nan")), ((1, 40, 3), float("nan")),
    ((1, slice(41, 64), 3), -5.0),
    ((2, slice(0, 64), 4), 0.0), ((2, 40, 4), 1.0), ((2, 10, 4), 1.0),
    ((2, slice(0, 64), 5), float("-inf")), ((2, 63, 5), float("nan"))]}


def _route1d(case: tuple, backward: bool = False) -> str:
    """The kernel a 1D call on a fresh (16-byte aligned) tensor must take
    (csrc/pool1d.cu): forward, the flat kernel where 2**levels divides
    the length (16 bytes of channels in registers, a one-channel mask
    whose B * L positions the thread's max(2**levels, 16-byte vector)
    divides, else the staged fold; a span past shared memory takes
    ``pool1d_kernel``), else, as the backward, 16 bytes of channels a thread
    when C is a multiple of 16 bytes, else one channel a thread."""
    dtype, shape = case[0], case[1]
    size = 4 if dtype == _F32 else 2
    vec = shape[-1] * size % 16 == 0
    if backward:
        return f"pool1d_backward_kernel<V={'16B' if vec else '1'}>"
    b, n, c = shape
    f = 1 << case[2]
    if n % f == 0 and n >= 2:
        if vec:
            return "pool1d_flat_kernel<V=16B>"
        if c == 1 and b * n % max(f, 16 // size) == 0:
            return "pool1d_flat_kernel<C=1>"
        row = c * size  # the least span, rows * row a multiple of 16 B
        if 16 // (row & -row) * row * (2 * f - 1) <= 48 * 1024:
            return "pool1d_flat_kernel"
    return f"pool1d_kernel<V={'16B' if vec else '1'}>"


FWD1_ROUTES = {c: _route1d(c) for cs in FWD_PATHS_1D.values()
               for c in cs + FWD1_TWINS + FWD1_EDGES}
FWD1_ROUTES.update({c: "pool1d_kernel<V=1>" for c, k in FWD1_OFFSETS.items()
                    if k * (4 if c[0] == _F32 else 2) % 16})
BWD1_ROUTES = {c: _route1d(c, backward=True) for cs in BWD_PATHS_1D.values()
               for c in cs + BWD1_TWINS + BWD1_EDGES}
ALL_FWD_PATHS = {**FWD_PATHS, **FWD_PATHS_1D}
ALL_BWD_PATHS = {**BWD_PATHS, **BWD_PATHS_1D}


def _kernel_row(name: str, path: str, source: str, replaces: str,
                max_err: float, cases: list, measured: dict) -> dict:
    """The wrapper's calls for one path, per batch or step: under
    ``by_kernel``, for each CUDA kernel the launcher picked for them, their
    number and their device times and bound summed."""
    kernels = {}
    for c in cases:
        kernels.setdefault(measured[c]["route"], []).append(measured[c])
    return {"name": name, "path": path, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max_err,
            "by_kernel": {k: {"ms": sum(r["kernel"] for r in rs),
                              "plain_ms": sum(r["plain"] for r in rs),
                              "bound_ms": _bound_ms(sum(r["bytes"]
                                                        for r in rs)),
                              "bound_by": "bytes",
                              "library_ms": sum(r["library"] for r in rs)}
                          for k, rs in kernels.items()}}


def _kernel_rows(wrapper_rows: list, runs: dict) -> list:
    """The JSON line's rows: one per (path, CUDA kernel), ``launches`` the
    launches the wrappers counted under that kernel's name in the path's
    run (``runs[path]["kernels"]``).  Fails, naming every such path, if a
    kernel of the path was launched no time in its run, or if the run
    launched a kernel that phase 3 did not measure at the path's calls."""
    rows, named, faults = [], {}, []
    for w in wrapper_rows:
        counted = runs[w["path"]]["kernels"]
        named.setdefault(w["path"], set()).update(w["by_kernel"])
        for kernel, k in w["by_kernel"].items():
            n = counted.get(kernel, 0)
            if n == 0:
                faults.append(f"{w['path']}: {kernel} launched no time in "
                              f"the path's run (counted {dict(counted)})")
            rows.append({**w, **k, "name": kernel, "launches": n})
    for path, kernels in named.items():
        extra = set(+runs[path]["kernels"]) - kernels
        if extra:
            faults.append(f"{path}: its run launched {sorted(extra)}, which "
                          f"no call of the path measured takes")
    _check(not faults, "; ".join(faults))
    return rows


def _print_paths(what: str, paths: dict, measured: dict) -> None:
    for path, cases in paths.items():
        rows = [measured[c] for c in cases]
        print(f"phase 3 kernels: the {path} path's {len(cases)} {what} calls "
              f"per batch or step, device time: kernel "
              f"{sum(r['kernel'] for r in rows):.4f} ms, plain "
              f"{sum(r['plain'] for r in rows):.4f} ms, library "
              f"{sum(r['library'] for r in rows):.4f} ms, bound "
              f"{_bound_ms(sum(r['bytes'] for r in rows)):.4f} ms",
              flush=True)


def _case_input(dtype: str, shape: tuple, gen, plateaus: bool,
                offset: int = 0, plants: tuple = ()):
    """An NHWC input from ``gen`` (a generator on the card, which draws
    the large inputs faster than the host) with a NaN, as a
    (B, C, H, W) channels_last tensor on the card (a (B, L, C) ``shape``:
    the (B, C, 1, L) tensor of a 1D signal): ``plants`` (index, value) set
    too; ``offset`` elements of storage before it."""
    import torch

    x = torch.randn(shape, generator=gen, device="cuda")
    if plateaus:
        x = torch.where(x < 0.3, torch.zeros_like(x), x)  # ReLU plateaus
    x.view(-1)[x.numel() // 3] = float("nan")  # must propagate / route
    for idx, value in plants:
        x[idx] = value
    flat = torch.zeros(offset + x.numel(), dtype=getattr(torch, dtype),
                       device="cuda")
    flat[offset:] = x.reshape(-1).to(flat)
    if len(shape) == 3:
        return flat[offset:].view(shape).permute(0, 2, 1).unsqueeze(2)
    return flat[offset:].view(shape).permute(0, 3, 1, 2)


def _check_route(what: str, got: str, want: "str | None") -> None:
    _check(want is None or got == want,
           f"{what}: the launcher picked {got}, not {want}")


def _bits(t):
    """The bit patterns of ``t``, every NaN made one pattern (a kernel and
    the plain version may carry different NaN payloads)."""
    import torch

    t = torch.where(t.isnan(), torch.full_like(t, float("nan")), t)
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _reset_counts() -> None:
    """Set the 2D and 1D wrappers' launch counts to 0, every kernel's."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)

    pyramid.launches.reset()
    pool_backward.launches.reset()


def _kernel_counts() -> "collections.Counter":
    """The launches the 2D and 1D wrappers counted since their counters'
    last reset, by the name of the kernel the C launcher reported."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)

    return (collections.Counter(pyramid.launches.by_kernel)
            + collections.Counter(pool_backward.launches.by_kernel))


def _one_launch(what: str, counter, before: dict, kernel: str) -> None:
    """Check that ``counter`` counted one launch since ``before`` (its
    ``by_kernel`` then), of ``kernel``."""
    after = collections.Counter(counter.by_kernel)
    after.subtract(before)
    _check(+after == collections.Counter({kernel: 1}),
           f"{what}: launched {dict(+after)}, not one {kernel}")


def phase_kernels() -> dict:
    """maxpool_pyramid (every level, some levels or one level alone)
    against its plain version at every call each path makes and at edge
    cases; returns {path: JSON row}."""
    import torch
    import torch.nn.functional as F

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)

    on_path = list(dict.fromkeys(
        [c for cs in FWD_PATHS.values() for c in cs] + FWD_EXTRA))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    flush.zero_()
    small = flush[:128 * 2 ** 20]
    zero = {n: _events_ms(lambda: [b.zero_() for _ in range(REPS)]) / REPS
            for n, b in ((FLUSH_BYTES >> 20, flush), (128, small))}
    print(f"phase 3 timing: zeroing the {FLUSH_BYTES >> 20} MB flush takes "
          f"{zero[FLUSH_BYTES >> 20]:.4f} ms on the card, 128 MB "
          f"{zero[128]:.4f} ms; each kernel line gives the host's enqueue "
          f"time of that call", flush=True)
    max_err, measured = 0.0, {}
    for case in on_path + FWD_EDGES:
        dtype, shape, levels, wanted = case
        x = _case_input(dtype, shape, gen,
                        plateaus=case in FWD_PLATEAUS + FWD_PLATEAUS_64,
                        offset=OFFSETS.get(case, 0))
        fns = {"plain": lambda: pyramid.maxpool_pyramid_plain(x, levels,
                                                              wanted),
               "kernel": lambda: pyramid.maxpool_pyramid(x, levels, wanted),
               # the yardstick: PyTorch's own pool, one call per level
               "library": lambda: [F.max_pool2d(x, 1 << lvl)
                                   for lvl in wanted]}
        before = dict(pyramid.launches.by_kernel)
        got, want = fns["kernel"](), fns["plain"]()
        torch.cuda.synchronize()
        kernel = pyramid.route(x, levels, wanted)
        _one_launch(f"pyramid {shape} {wanted}", pyramid.launches, before,
                    kernel)
        for k, p in zip(got, want):
            _check(k.shape == p.shape and k.dtype == p.dtype,
                   f"pyramid {shape} {wanted}: {k.shape} vs {p.shape}")
            _check(torch.equal(k.isnan(), p.isnan()),
                   f"pyramid {shape} {wanted}: NaN positions differ")
            fin = ~p.isnan()
            err = float((k[fin].float() - p[fin].float()).abs().max()) \
                if bool(fin.any()) else 0.0
            _check(err == 0.0, f"pyramid {shape} {wanted}: max-abs {err}")
            _check(torch.equal(_bits(k), _bits(p)),
                   f"pyramid {shape} {wanted}: bit patterns differ")
            max_err = max(max_err, err)
        what = (f"maxpool_level {dtype} {tuple(shape)} L={levels} (pool by "
                f"{1 << levels})" if wanted == (levels,) else
                f"maxpool_pyramid {dtype} {tuple(shape)} levels "
                f"{list(wanted)}")
        if case in OFFSETS:
            what += f", view {OFFSETS[case]} element(s) into its storage"
        _check_route(what, kernel, FWD_ROUTES.get(case))
        what += f" [{kernel}]"
        if case not in on_path:
            print(f"phase 3 kernel {what}: equal to plain (max-abs 0, NaN "
                  f"kept)", flush=True)
            continue
        if len(wanted) > 1 and shape[-1] > 1 and levels <= 5:
            # the earlier design of the same call: one launch per level
            fns["per_level"] = lambda: [pyramid.maxpool_level(x, lvl)
                                        for lvl in wanted]
        if levels >= 6:
            # the kernel these calls took before this slice's kernels,
            # forced on the same input and held to plain too
            fns["earlier"] = lambda: pyramid._maxpool_pyramid_cuda(
                x, levels, list(wanted), force="pyramid_kernel")
            before = dict(pyramid.launches.by_kernel)
            early = fns["earlier"]()
            _one_launch(what, pyramid.launches, before, "pyramid_kernel")
            _check(all(torch.equal(_bits(k), _bits(p))
                       for k, p in zip(early, want)),
                   f"{what}: the forced pyramid_kernel differs from plain")
        spread = {}
        t = _timed_turns(fns, flush, spread)
        calls = {name: _call_ms(fns[name], flush)
                 for name in ("kernel", "plain")}
        host = _host_ms(fns["kernel"])
        nbytes = _bytes(x, *got)
        measured[case] = {**t, "bytes": nbytes, "route": kernel}
        lib = (f"{len(wanted)} F.max_pool2d call(s), one per level, "
               f"{t['library']:.4f} ms")
        if "per_level" in t:
            lib += (f"; {len(wanted)} single-level launches "
                    f"{t['per_level']:.4f} ms")
        if "earlier" in t:
            lib += (f"; pyramid_kernel forced on the call (equal to plain) "
                    f"{t['earlier']:.4f} ms (turns differ by "
                    f"{spread['earlier']:.4f})")
        print(f"phase 3 kernel {what}: equal to plain (max-abs 0, NaN "
              f"kept); device time kernel {t['kernel']:.4f} ms (turns "
              f"differ by {spread['kernel']:.4f}), plain "
              f"{t['plain']:.4f} ms, library {lib}, "
              f"bound {_bound_ms(nbytes):.4f} ms ({nbytes} B at 3.35 TB/s); "
              f"one call on an idle card kernel {calls['kernel']:.4f} ms, "
              f"plain {calls['plain']:.4f} ms (CUDA events, L2 flushed, "
              f"medians of {REPS}); host enqueue of the kernel call "
              f"{host:.4f} ms", flush=True)
        if case == _DS_MASK:
            # a launch of the same kernel with next to nothing to move:
            # what the card takes for any launch, measured the same way
            tiny = _case_input(dtype, (1, 2, 2, 1), gen, plateaus=False)
            floor = _in_turns({"floor": lambda: pyramid.maxpool_pyramid(
                tiny, levels)}, flush)["floor"]
            print(f"phase 3 kernel {what}: floor {floor:.4f} ms, the same "
                  f"kernel on a (1, 2, 2, 1) mask (device time as above); "
                  f"kernel {t['kernel']:.4f} ms", flush=True)
    _print_paths("pyramid", FWD_PATHS, measured)
    return {p: _kernel_row(
        "maxpool_pyramid", p,
        "tf_1d_2d_segmentation_end2endpipelines_torch/csrc/pyramid.cu",
        "tf_1d_2d_segmentation_end2endpipelines_tpu/ops/pallas/pyramid.py:49",
        max_err, cases, measured) for p, cases in FWD_PATHS.items()}


def phase_ds_mask() -> None:
    """The DS targets' pyramid call alone, checked and timed as phase 3
    does, with the port package beside this script.  Copied over the
    script of an unpacked older checkout (one whose ``maxpool_pyramid``
    takes ``(x, levels)``: all of them), ``--ds-mask`` times that commit's
    kernel with this flush, in the same chip call as this one's."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)

    dtype, shape, levels, _ = _DS_MASK
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    x = _case_input(dtype, shape, gen, plateaus=False)
    tiny = _case_input(dtype, (1, 2, 2, 1), gen, plateaus=False)
    got = pyramid.maxpool_pyramid(x, levels)
    for k, p in zip(got, pyramid.maxpool_pyramid_plain(x, levels)):
        _check(torch.equal(k.isnan(), p.isnan())
               and torch.equal(k.nan_to_num(), p.nan_to_num()),
               f"DS mask: kernel differs from plain at {tuple(p.shape)}")
    t = _in_turns({"kernel": lambda: pyramid.maxpool_pyramid(x, levels),
                   "floor": lambda: pyramid.maxpool_pyramid(tiny, levels)},
                  flush)
    nbytes = _bytes(x, *got)
    print(f"ds mask {dtype} {shape} L={levels}: equal to plain (NaN kept); "
          f"device time kernel {t['kernel']:.4f} ms, floor (the same call "
          f"on (1, 2, 2, 1)) {t['floor']:.4f} ms, bound "
          f"{_bound_ms(nbytes):.4f} ms; host enqueue "
          f"{_host_ms(lambda: pyramid.maxpool_pyramid(x, levels)):.4f} ms; "
          f"{FLUSH_BYTES >> 20} MB flush", flush=True)


def phase_pool_backward() -> dict:
    """maxpool_backward against its plain version, bit for bit, at every
    call each training path makes and at edge cases, with planted
    plateaus (post-ReLU zeros, so ties decide the routing) and a planted
    NaN; returns {path: JSON row}."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward)

    on_path = list(dict.fromkeys(c for cs in BWD_PATHS.values() for c in cs))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    max_err, measured = 0.0, {}
    for case in on_path + BWD_EDGES:
        dtype, shape, f = case
        x = _case_input(dtype, shape, gen, plateaus=True,
                        plants=PLANTS.get(case, ()),
                        offset=BWD_OFFSETS.get(case, 0))
        b, c, h, w = x.shape
        g = torch.randn((b, h // f, w // f, c), generator=gen,
                        device="cuda").to(x.dtype).permute(0, 3, 1, 2)
        before = dict(pool_backward.launches.by_kernel)
        got = pool_backward.maxpool_backward(x, g, f)
        want = pool_backward.maxpool_backward_plain(x, g, f)
        torch.cuda.synchronize()
        kernel = pool_backward.route(x, g, f)
        _one_launch(f"pool backward {shape} f={f}", pool_backward.launches,
                    before, kernel)
        _check(got.shape == want.shape and got.dtype == want.dtype and
               got.is_contiguous(memory_format=torch.channels_last),
               f"pool backward {shape} f={f}: {got.shape} {got.dtype}")
        err = float((got.float() - want.float()).abs().max())
        _check(torch.equal(_bits(got), _bits(want)),
               f"pool backward {shape} f={f}: max-abs {err}, or the bit "
               f"patterns differ")
        max_err = max(max_err, err)
        what = f"maxpool_backward {dtype} {tuple(shape)} f={f}"
        _check_route(what, kernel, BWD_ROUTES.get(case))
        what += f" [{kernel}]"
        if case in PLANTS:
            what += " (NaN first, last and twice in a window)"
        if case in BWD_OFFSETS:
            what += f", x a view {BWD_OFFSETS[case]} element(s) into its storage"
        if case not in on_path:
            print(f"phase 3 kernel {what}: equal to plain (max-abs 0)",
                  flush=True)
            continue
        _, idx = torch.nn.functional.max_pool2d(x, f, return_indices=True)
        fns = {
            "plain": lambda: pool_backward.maxpool_backward_plain(x, g, f),
            "kernel": lambda: pool_backward.maxpool_backward(x, g, f),
            # the yardstick, given the indices its forward saved
            "library": lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                g, x, [f, f], [f, f], [0, 0], [1, 1], False, idx),
        }
        spread = {}
        t = _timed_turns(fns, flush, spread)
        nbytes = _bytes(x, g, got)
        measured[case] = {**t, "bytes": nbytes, "route": kernel}
        print(f"phase 3 kernel {what}: equal to plain (max-abs 0, plateaus "
              f"and a NaN); device time kernel {t['kernel']:.4f} ms (turns "
              f"differ by {spread['kernel']:.4f}), plain "
              f"{t['plain']:.4f} ms, library max_pool2d_with_indices_"
              f"backward {t['library']:.4f} ms, bound "
              f"{_bound_ms(nbytes):.4f} ms ({nbytes} B at 3.35 TB/s) (CUDA "
              f"events, L2 flushed, medians of {REPS})", flush=True)
    _print_paths("pool-backward", BWD_PATHS, measured)
    return {p: _kernel_row(
        "maxpool_backward", p,
        "tf_1d_2d_segmentation_end2endpipelines_torch/csrc/pool_backward.cu",
        "tf_1d_2d_segmentation_end2endpipelines_tpu/ops/blocks.py:467",
        max_err, cases, measured) for p, cases in BWD_PATHS.items()}


def _png(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def phase_serve(tmp: str) -> dict:
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.eval import (
        label_from_pred)
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.serve import (
        _decode_request, make_server)
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TrainConfig)

    # the flagship, __graft_entry__.py:26-29, with weights from SEED (no
    # best.pt under the fold directory)
    cfg = TrainConfig(imlength=SIZE, imwidth=SIZE, num_channels=3,
                      encoder_mode="from_scratch", decoder_name="UNetPP",
                      model_width=32, model_depth=4, output_nums=1,
                      class_number=1, dense_loop=1,
                      final_activation="sigmoid", compute_dtype="bfloat16",
                      seed=SEED, save_dir=tmp)
    t0 = time.perf_counter()
    server = make_server(cfg, os.path.join(tmp, "Fold_1"), port=0,
                         max_batch=BATCH, threshold=THRESHOLD, device="cuda")
    setup_s = time.perf_counter() - t0
    predictor = server.predictor
    model = predictor.model
    _check(predictor.device.type == "cuda" and model.dtype == torch.bfloat16
           and server.batcher is not None, "server not on cuda/bf16/batched")
    print(f"phase 4 serve: W32/D4 UNet++ {SIZE}x{SIZE}x3 bf16, "
          f"{sum(p.numel() for p in model.parameters())} params, "
          f"max_batch {BATCH}, set up (warm-up included) in {setup_s:.2f} s",
          flush=True)

    device_batches = []
    forward = predictor.forward

    def counting_forward(x):
        device_batches.append(int(x.shape[0]))
        return forward(x)

    predictor.forward = counting_forward
    rng = np.random.default_rng(SEED)
    images = (rng.uniform(size=(N_REQUESTS, SIZE, SIZE, 3)) * 255).astype(
        np.uint8)
    bodies = [_png(im) for im in images]
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    replies: list = [None] * N_REQUESTS
    latencies: list = [None] * N_REQUESTS
    errors: list = []

    def client(c: int) -> None:
        for i in range(c, N_REQUESTS, N_CLIENTS):
            t = time.perf_counter()
            try:
                req = urllib.request.Request(url, data=bodies[i],
                                             method="POST")
                with urllib.request.urlopen(req, timeout=300) as resp:
                    replies[i] = (resp.status, resp.read())
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")
                return
            latencies[i] = time.perf_counter() - t

    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    try:
        _reset_counts()  # the main path's run starts here
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(N_CLIENTS)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=600)
        launches = pyramid.launches.value  # ... and ends here
        kernels = _kernel_counts()
        _check(not any(th.is_alive() for th in clients), "clients hung")
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        serving.join(timeout=60)
    del predictor.forward
    _check(not errors, f"requests failed: {errors}")

    from PIL import Image
    ok = [r for r in replies if r is not None and r[0] == 200]
    masks = np.stack([np.asarray(Image.open(io.BytesIO(r[1]))) for r in ok])
    _check(len(ok) == N_REQUESTS and masks.shape == (N_REQUESTS, SIZE, SIZE),
           f"{len(ok)}/{N_REQUESTS} answered 200, masks {masks.shape}")
    n_batches = len(device_batches)
    print(f"phase 4 serve: {len(ok)}/{N_REQUESTS} answered 200 with a "
          f"{SIZE}x{SIZE} mask from {N_CLIENTS} clients; {n_batches} device "
          f"batches of {sorted(set(device_batches))}", flush=True)
    _check(launches == 4 * n_batches and n_batches > 0,
           f"pyramid.launches.value {launches} != 4 x {n_batches} device batches")
    print(f"phase 4 serve: pyramid.launches.value = {launches} = 4 encoder pools "
          f"x {n_batches} device batches", flush=True)

    # the same model with the plain pool, on the card, on the same decode
    decoded = np.stack([_decode_request(b, (SIZE, SIZE), "rgb", 255.0)
                        for b in bodies])
    before = pyramid.launches.value
    with mock.patch.object(pyramid, "maxpool_pyramid",
                           pyramid.maxpool_pyramid_plain):
        probs = predictor(decoded)
    _check(pyramid.launches.value == before, "plain-pool run launched the kernel")
    _check(probs.shape == (N_REQUESTS, SIZE, SIZE, 1)
           and bool(np.isfinite(probs).all())
           and 0.0 <= float(probs.min()) and float(probs.max()) <= 1.0,
           f"plain-pool output {probs.shape} not finite sigmoid values")
    labels = label_from_pred(probs, cfg.class_number, THRESHOLD)
    near = np.abs(probs[..., 0] - THRESHOLD) < NEAR_THRESHOLD
    differ = (masks // 255) != labels
    _check(not bool((differ & ~near).any()),
           f"{int((differ & ~near).sum())} mask pixels differ from the "
           f"plain-pool forward away from the threshold")
    print(f"phase 4 serve: masks equal label_from_pred of the plain-pool "
          f"forward at all {int((~near).sum())} pixels farther than "
          f"{NEAR_THRESHOLD} from the threshold; {int(near.sum())} pixels "
          f"are nearer, {int(differ.sum())} of them differ; foreground "
          f"share {float(labels.mean()):.4f}", flush=True)

    x8 = torch.from_numpy(decoded[:BATCH]).cuda()
    fwd = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        predictor.forward(x8)
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t)
    print(f"phase 4 serve: p50 request latency "
          f"{statistics.median(latencies) * 1e3:.3f} ms over {N_REQUESTS} "
          f"requests; p50 forward of one padded batch of {BATCH} "
          f"{statistics.median(fwd) * 1e3:.3f} ms (host clock, "
          f"synchronized, {REPS} runs)", flush=True)
    return {"model": model, "launches": launches, "kernels": kernels}


def phase_reference(model) -> None:
    """The served weights in float32 on the card against the CPU on a
    small input: cuDNN convolutions (TF32 off) plus the kernel against
    PyTorch's CPU kernels plus the plain pool."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)

    ref = SegModel("UNetPP", 32, 4, in_channels=3, output_nums=1,
                   final_activation="sigmoid", dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    ref.eval()
    x = torch.from_numpy(np.random.default_rng(SEED + 1).uniform(
        size=(2, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        cpu = ref(x)["out"]
    ref.to("cuda")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = pyramid.launches.value
        with torch.inference_mode():
            gpu = ref(x.cuda())["out"].cpu()
        launched = pyramid.launches.value - before
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    err = float((gpu - cpu).abs().max())
    _check(launched == 4, f"float32 forward launched the kernel {launched}x")
    _check(bool(torch.isfinite(gpu).all()) and err <= 1e-4,
           f"float32 card vs CPU max-abs {err} > 1e-4")
    print(f"phase 5 reference: float32 forward on the card (kernel, cuDNN "
          f"without TF32) vs the CPU (plain pool), (2, 64, 64, 3): max-abs "
          f"{err:.3g} <= 1e-4", flush=True)


def _serve_one_png(cfg, fold_dir: str, requests: int = 1) -> int:
    """Status of ``requests`` PNG requests, one after another, to
    ``make_server`` over ``fold_dir`` (any but 200 raises)."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.serve import (
        make_server)

    server = make_server(cfg, fold_dir, port=0, max_batch=1, device="cuda")
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    try:
        for i in range(requests):
            img = (np.random.default_rng(SEED + i).uniform(
                size=(SIZE, SIZE, 3)) * 255).astype(np.uint8)
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/predict",
                data=_png(img), method="POST")
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    status = resp.status
                    resp.read()
            except urllib.error.HTTPError as e:
                raise AssertionError(f"serving best.pt answered {e.code}: "
                                     f"{e.read()[:2000]!r}") from e
            _check(status == 200, f"serving best.pt answered {status}")
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
    return status


def _write_image_folders(tmp: str) -> None:
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images, write_image_folder)

    t0 = time.perf_counter()
    for name, n, seed in (("Train", N_TRAIN, SEED), ("Val", N_VAL, SEED + 1)):
        write_image_folder(os.path.join(tmp, "Data", name),
                           *synthetic_images(n, SIZE, seed=seed))
    print(f"phase 6 train: {N_TRAIN} train and {N_VAL} val {SIZE}x{SIZE} "
          f"PNGs written in {time.perf_counter() - t0:.2f} s", flush=True)


def _train_config(tmp: str, results: str, **kw):
    """The flagship's training INI (__graft_entry__.py:26-29 and
    bench.py:60-84) on the synthetic folders, with ``kw`` replaced."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TrainConfig)

    base = dict(
        train_dir=os.path.join(tmp, "Data", "Train"),
        val_dir=os.path.join(tmp, "Data", "Val"), imlength=SIZE,
        imwidth=SIZE, num_channels=3, encoder_mode="from_scratch",
        decoder_name="UNetPP", model_width=32, model_depth=4, output_nums=1,
        class_number=1, dense_loop=1, final_activation="sigmoid",
        compute_dtype="bfloat16", loss_function="BCEDiceLoss",
        optimizer_function="Adam", metric_list=("BinaryAccuracy",),
        batch_size=TRAIN_BATCH, num_epochs=TRAIN_EPOCHS, seed=SEED,
        save_dir=os.path.join(tmp, results), load_weights=False)
    base.update(kw)
    return TrainConfig(**base)


def _run_train_verb(phase: str, cfg, path: str,
                    calls: "tuple | None" = None, requests: int = 1) -> dict:
    """The train verb's fold loop on the card, the counts set to 0 just
    before it and read just after: ``path``'s pyramid calls per train step
    and validation batch, and its pool-backward calls per train step
    (FWD_PATHS, BWD_PATHS; or ``calls``, forward and backward, for a path
    that is in neither).  Then best.pt is served ``requests`` PNGs."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)

    pyramid.launches.reset()  # the main path's run starts here
    pool_backward.launches.reset()
    pool_backward.g_copies.reset()
    t0 = time.perf_counter()
    hist = drivers.train(config=cfg, device="cuda")[1]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd, copies = (pyramid.launches.value, pool_backward.launches.value,
                        pool_backward.g_copies.value)  # ... and ends here
    kernels = _kernel_counts()
    steps = cfg.num_epochs * -(-N_TRAIN // cfg.batch_size)
    val_batches = cfg.num_epochs * -(-N_VAL // cfg.batch_size)
    n_fwd, n_bwd = calls or (len(FWD_PATHS[path]), len(BWD_PATHS[path]))
    losses = hist["loss"] + hist["val_loss"]
    _check(all(np.isfinite(losses)), f"non-finite losses {hist}")
    _check(bwd == n_bwd * steps,
           f"maxpool_backward launched {bwd}x, not {n_bwd} x {steps} steps")
    _check(fwd == n_fwd * (steps + val_batches),
           f"maxpool_pyramid launched {fwd}x, not {n_fwd} x ({steps} steps "
           f"+ {val_batches} val batches)")
    print(f"{phase}: drivers.train in {train_s:.2f} s; loss {hist['loss']}, "
          f"val_loss {hist['val_loss']}, steps/s {hist['steps_per_sec']}",
          flush=True)
    print(f"{phase}: maxpool_backward.launches = {bwd} = {n_bwd} x {steps} "
          f"steps; maxpool_pyramid.launches = {fwd} = {n_fwd} x ({steps} "
          f"steps + {val_batches} val batches); gradient layout copies "
          f"{copies}", flush=True)
    fold = os.path.join(cfg.save_dir, "Fold_1")
    _check(os.path.exists(os.path.join(fold, drivers.BEST_WEIGHTS)),
           "best.pt not written")
    status = _serve_one_png(cfg, fold, requests)
    print(f"{phase}: {drivers.BEST_WEIGHTS} written; make_server loaded it "
          f"and answered {requests} PNG request(s) with {status}",
          flush=True)
    return {"hist": hist, "pyramid": fwd, "backward": bwd,
            "kernels": kernels}


def _fixed_batch(phase: str, trainer, x, y, steps: int = FIXED_STEPS,
                 must_fall: bool = True, unit: str = "img") -> float:
    """``steps`` train steps on one batch already on the card (the targets
    built from the mask ``y`` at every step, as the verb does); prints the
    p50 step over all but the first 5 (all of them in a run of 5 or
    fewer, which ``_counted_steps`` warms up; host clock, synchronized), img/s
    and peak memory; returns the p50 in seconds.  With ``must_fall`` the
    mean loss of the last 5 steps must be below that of the first 5."""
    import torch

    prepare = trainer.prepare_targets or (lambda t: t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = trainer.train_step(x, prepare(y))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    first, last = (statistics.mean(step_losses[:5]),
                   statistics.mean(step_losses[-5:]))
    _check(all(np.isfinite(step_losses)), f"non-finite loss: {step_losses}")
    _check(last < first or not must_fall,
           f"fixed-batch loss did not fall: {step_losses}")
    timed = step_s[5:] if steps > 5 else step_s
    p50 = statistics.median(timed)
    b = x.shape[0]
    print(f"{phase}: {steps} steps on one batch of {b}: mean loss of the "
          f"first 5 {first:.5f}, of the last 5 {last:.5f}; p50 train step "
          f"{p50 * 1e3:.3f} ms over the last {len(timed)} (host clock, "
          f"synchronized), {b / p50:.1f} {unit}/s; max_memory_allocated "
          f"{peak} B ({peak / 2 ** 30:.3f} GiB)", flush=True)
    return p50


def _print_verb_rate(phase: str, hist: dict, p50: float) -> None:
    # the verb's own rate: its loader (PNG decode) and host-to-device
    # copies included, which the fixed batch leaves out
    verb_ms = 1e3 / hist["steps_per_sec"][-1]
    print(f"{phase}: the train verb's last epoch {verb_ms:.3f} ms a step "
          f"({hist['steps_per_sec'][-1]:.3f} steps/s, "
          f"{TRAIN_BATCH * hist['steps_per_sec'][-1]:.1f} img/s, "
          f"{-(-N_TRAIN // TRAIN_BATCH)} steps, loader and copies included), "
          f"{verb_ms / (p50 * 1e3):.3f}x the fixed batch's p50", flush=True)


def _trainer_for(cfg):
    """A fresh model from SEED and the Trainer the verb would build."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers

    model = drivers._build_model(
        cfg, generator=torch.Generator().manual_seed(SEED))
    return drivers._make_trainer(cfg, model, "cuda")


def phase_train(tmp: str) -> dict:
    """The train verb's fold loop on the flagship, then a fixed-batch loop
    that times the train step."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images)

    cfg = _train_config(tmp, "Results")
    print(f"phase 6 train: W32/D4 UNet++ bf16, BCEDice, Adam lr "
          f"{cfg.learning_rate}, batch {TRAIN_BATCH}, {TRAIN_EPOCHS} epochs",
          flush=True)
    run = _run_train_verb("phase 6 train", cfg, "train")
    trainer = _trainer_for(cfg)
    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 2)
    p50 = _fixed_batch("phase 6 train", trainer, trainer.to_device(x),
                       trainer.to_device(y))
    _print_verb_rate("phase 6 train", run["hist"], p50)
    return run


def phase_train_ds(tmp: str) -> dict:
    """Path (a) of the deep-supervision slice: the train verb on UNet3+
    W32/D4 with ``d_s = 1``, ds_type ``UNet`` (the targets from one
    pyramid launch per batch), on phase 6's folders; then a fixed batch."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images)

    cfg = _train_config(tmp, "ResultsDS", decoder_name="UNet3P", d_s=1,
                        ds_type="UNet", num_epochs=DS_EPOCHS)
    print(f"phase 8 train ds: W32/D4 UNet3+ bf16, d_s 1, ds_type UNet, "
          f"BCEDice on out and level1-4 (default_ds_weights(4)), Adam lr "
          f"{cfg.learning_rate}, batch {TRAIN_BATCH}, {DS_EPOCHS} epochs",
          flush=True)
    run = _run_train_verb("phase 8 train ds", cfg, "train_ds")
    trainer = _trainer_for(cfg)
    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 2)
    p50 = _fixed_batch("phase 8 train ds", trainer, trainer.to_device(x),
                       trainer.to_device(y))
    _print_verb_rate("phase 8 train ds", run["hist"], p50)
    return run


def _counted_steps(phase: str, path: str, trainer, x, targets, steps: int,
                   must_fall: bool, unit: str = "img",
                   calls: "tuple | None" = None) -> dict:
    """One step that picks cuDNN's algorithms, then ``steps`` counted
    fixed-batch steps (``_fixed_batch``), the counts set to 0 just before
    them and read just after: exactly ``path``'s pyramid and pool-backward
    calls (FWD_PATHS, BWD_PATHS) per step, or ``calls`` (forward,
    backward) for a path that is in neither."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)

    trainer.train_step(x, targets)  # the first step picks algorithms
    pyramid.launches.reset()  # the main path's run starts here
    pool_backward.launches.reset()
    pool_backward.g_copies.reset()
    p50 = _fixed_batch(f"{phase} {path}", trainer, x, targets, steps=steps,
                       must_fall=must_fall, unit=unit)
    fwd, bwd, copies = (pyramid.launches.value,
                        pool_backward.launches.value,
                        pool_backward.g_copies.value)  # ... and ends here
    kernels = _kernel_counts()
    n_fwd, n_bwd = calls or (len(ALL_FWD_PATHS[path]),
                             len(ALL_BWD_PATHS[path]))
    _check((fwd, bwd) == (n_fwd * steps, n_bwd * steps),
           f"{path}: launched pyramid {fwd}x, backward {bwd}x, not "
           f"{n_fwd} and {n_bwd} x {steps} steps")
    print(f"{phase} {path}: maxpool_pyramid.launches = {fwd} = {n_fwd} x "
          f"{steps} steps; maxpool_backward.launches = {bwd} = {n_bwd} x "
          f"{steps}; gradient layout copies {copies}; p50 "
          f"{p50 * 1e3:.3f} ms", flush=True)
    return {"pyramid": fwd, "backward": bwd, "kernels": kernels, "p50": p50}


def phase_config3() -> dict:
    """Path (b): BASELINE config 3's fixed-batch train step as the JAX
    package measures it (benchmarks/zoo_bench.py:83-99): W32/D4 UNet++ and
    UNet3+ with ``ds=1``, 4 classes, softmax, CategoricalCrossentropy on
    ``out`` only, default_ds_weights(4), Adam lr 1e-4, bf16, batch 16, on
    normal inputs and one-hot targets from SEED."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        Trainer, default_ds_weights)

    rng = np.random.default_rng(SEED + 6)
    x = rng.normal(size=(TRAIN_BATCH, SIZE, SIZE, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (TRAIN_BATCH, SIZE,
                                                        SIZE))]
    counts = {}
    for dec in ("UNetPP", "UNet3P"):
        path = f"config3_{dec}"
        model = SegModel(dec, 32, 4, output_nums=4, ds=1,
                         final_activation="softmax", dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(SEED))
        trainer = Trainer(model, loss="CategoricalCrossentropy",
                          optimizer="Adam", learning_rate=1e-4,
                          loss_weights=default_ds_weights(4), device="cuda")
        counts[path] = _counted_steps(
            "phase 9", path, trainer, trainer.to_device(x),
            {"out": trainer.to_device(y)}, CONFIG3_STEPS, must_fall=False)
        del model, trainer
        torch.cuda.empty_cache()
    return counts


def phase_config2() -> dict:
    """BASELINE config 2's fixed-batch train step (the JAX package's
    benchmarks/zoo_bench.py:73-80): W32/D4 UNet, UNetE and UNetP, binary,
    transposed-conv decoders, no deep supervision, sigmoid, BCEDice, Adam
    lr 1e-4, bf16, batch 16 of synthetic images and blob masks from a
    seed (a batch whose loss can fall in 10 steps)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer

    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 8)
    counts = {}
    for dec in CONFIG2:
        path = f"config2_{dec}"
        model = SegModel(dec, 32, 4, output_nums=1, ds=0,
                         final_activation="sigmoid", dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(SEED))
        print(f"phase 11 {path}: W32/D4 {dec} {SIZE}x{SIZE}x3 bf16, "
              f"{sum(p.numel() for p in model.parameters())} params, "
              f"BCEDice, Adam lr 1e-4, batch {TRAIN_BATCH}", flush=True)
        trainer = Trainer(model, loss="BCEDiceLoss", optimizer="Adam",
                          learning_rate=1e-4, device="cuda")
        counts[path] = _counted_steps(
            "phase 11", path, trainer, trainer.to_device(x),
            trainer.to_device(y), CONFIG2_STEPS, must_fall=True)
        del model, trainer
        torch.cuda.empty_cache()
    return counts


def _check_mrb_widths(model, alpha: float) -> None:
    """The encoder's pooled MultiResBlock widths are MRB_WIDTHS[alpha],
    the channels of the pool calls phase 3 timed for this path."""
    enc = model.ScratchEncoder_0
    widths = tuple(getattr(enc, f"MultiResBlock_{i}").out_features
                   for i in range(4))
    _check(widths == MRB_WIDTHS[alpha],
           f"MultiResBlock widths {widths} != {MRB_WIDTHS[alpha]}")


def _phase_steps(phase: str, paths: dict) -> dict:
    """10 counted fixed-batch steps (CONFIG4_STEPS) of each W32/D4 model of
    ``paths`` (path -> (decoder, ag)): binary, transposed convs, no deep
    supervision, sigmoid, BCEDice, Adam lr 1e-4, bf16, batch 16 of phase
    11's synthetic images and blob masks; the loss must fall."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer

    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 8)
    counts = {}
    for path, (dec, ag) in paths.items():
        model = SegModel(dec, 32, 4, output_nums=1, ds=0, ag=ag,
                         final_activation="sigmoid", dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(SEED))
        if dec != "UNet":
            _check_mrb_widths(model, 1.0)
        print(f"{phase} {path}: W32/D4 {dec}{' ag=1' if ag else ''} "
              f"{SIZE}x{SIZE}x3 bf16, "
              f"{sum(p.numel() for p in model.parameters())} params, "
              f"BCEDice, Adam lr 1e-4, batch {TRAIN_BATCH}", flush=True)
        trainer = Trainer(model, loss="BCEDiceLoss", optimizer="Adam",
                          learning_rate=1e-4, device="cuda")
        counts[path] = _counted_steps(
            phase, path, trainer, trainer.to_device(x), trainer.to_device(y),
            CONFIG4_STEPS, must_fall=True)
        del model, trainer
        torch.cuda.empty_cache()
    return counts


def phase_config4() -> dict:
    """BASELINE config 4's fixed-batch train step (the JAX package's
    benchmarks/zoo_bench.py:101-110): W32/D4 MultiResUNet (alpha 1) and
    UNet with attention gates, as phase 11 runs config 2."""
    return _phase_steps("phase 14", CONFIG4)


def phase_family() -> dict:
    """The rest of the MultiRes family, MultiResUNet3+ and KSSNet, as
    phase 14: its decoder pyramids (MultiResUNet3+'s pooled skips, as
    UNet3+'s) and KSSNet's encoder tap pyramids, one launch per tap."""
    return _phase_steps("phase 15", FAMILY)


def phase_multires_verbs(tmp: str) -> dict:
    """The train verb on phase 6's folders for one epoch with
    ``decoder_name = MultiResUNet`` and ``alpha = 1.67`` (branch widths 8,
    17, 26 at W = 32), best.pt served (``_run_train_verb``), then the test
    verb on its fold over phase 12's PNGs: alpha read back from the fold's
    Train_Configs.ini, best.pt restored into the rebuilt model, 4 pyramid
    launches a batch, every pixel counted."""
    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TestConfig, load_train_config)

    cfg = _train_config(tmp, "ResultsMR", decoder_name="MultiResUNet",
                        alpha=1.67, num_epochs=1)
    print(f"phase 16 verbs: W32/D4 MultiResUNet alpha {cfg.alpha} bf16, "
          f"BCEDice, Adam lr {cfg.learning_rate}, batch {TRAIN_BATCH}, 1 "
          f"epoch", flush=True)
    run = _run_train_verb("phase 16 verbs", cfg, "train_multires")
    saved = load_train_config(os.path.join(cfg.save_dir, "Train_Configs.ini"))
    _check(saved.alpha == 1.67 and saved.decoder_name == "MultiResUNet",
           f"Train_Configs.ini has alpha {saved.alpha}, decoder "
           f"{saved.decoder_name}")
    test = TestConfig(test_dir=os.path.join(tmp, "Data", "Test"),
                      imheight=SIZE, imwidth=SIZE, batch_size=TEST_BATCH,
                      threshold=THRESHOLD, save_dir=cfg.save_dir)
    model = drivers._restore_model(
        drivers._test_train_config(test), os.path.join(cfg.save_dir,
                                                       "Fold_1"),
        "evaluating", "cuda")
    _check_mrb_widths(model, 1.67)
    del model
    batches = -(-N_TEST // TEST_BATCH)
    _reset_counts()  # the main path's run starts here
    t0 = time.perf_counter()
    rep = drivers.test(config=test, device="cuda")[1]
    verb_s = time.perf_counter() - t0
    launches = pyramid.launches.value  # ... and ends here
    cm = rep["confusion_matrix"]
    _check(rep["checkpoint_restored"] is True, "best.pt not restored")
    _check(int(cm.sum()) == N_TEST * SIZE * SIZE,
           f"confusion matrix counts {int(cm.sum())} pixels")
    _check(launches == 4 * batches, f"test verb launched the pyramid "
           f"{launches}x, not 4 x {batches} batches")
    print(f"phase 16 verbs: Train_Configs.ini keeps alpha {saved.alpha}; "
          f"best.pt restored into the rebuilt model (encoder widths "
          f"{MRB_WIDTHS[1.67]}); drivers.test in {verb_s:.2f} s, "
          f"{rep['images_per_sec']:.1f} img/s, maxpool_pyramid.launches = "
          f"{launches} = 4 x {batches} batches, confusion matrix "
          f"{cm.astype(np.int64).tolist()} ({int(cm.sum())} pixels)",
          flush=True)
    return run


def phase_test_verb(tmp: str, train_cfg) -> dict:
    """The ``test`` verb on phase 6's trained fold (``train_cfg``'s
    save_dir) over N_TEST fresh PNGs in batches of TEST_BATCH, the counts
    set to 0 just before it and read just after, then the verb with
    TEST_TTA's views stacked into each batch; then its confusion matrix
    against the plain-pool forward's, and the p50 of ``Trainer.predict``
    on a warm batch with and without the views."""
    import torch
    from PIL import Image

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        SegmentationFolderDataset, synthetic_images, write_image_folder)
    from tf_1d_2d_segmentation_end2endpipelines_torch.eval import (
        confusion_matrix_update, init_confusion_matrix, label_from_pred)
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TestConfig)

    test_dir = os.path.join(tmp, "Data", "Test")
    write_image_folder(test_dir, *synthetic_images(N_TEST, SIZE,
                                                   seed=SEED + 7))
    cfg = TestConfig(test_dir=test_dir, imheight=SIZE, imwidth=SIZE,
                     batch_size=TEST_BATCH, threshold=THRESHOLD,
                     save_dir=train_cfg.save_dir)
    batches = -(-N_TEST // TEST_BATCH)
    runs = {}
    for views in ("", TEST_TTA):
        _reset_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        rep = drivers.test(config=dataclasses.replace(cfg, tta=views),
                           device="cuda")[1]
        verb_s = time.perf_counter() - t0
        launches = pyramid.launches.value  # ... and ends here
        kernels = _kernel_counts()
        cm = rep["confusion_matrix"]
        _check(rep["checkpoint_restored"] is True, "best.pt not restored")
        _check(int(cm.sum()) == N_TEST * SIZE * SIZE,
               f"confusion matrix counts {int(cm.sum())} pixels")
        _check(launches == 4 * batches,
               f"test verb (views {views!r}) launched the pyramid "
               f"{launches}x, not 4 x {batches} batches")
        print(f"phase 12 test (views {views or 'none'}): drivers.test in "
              f"{verb_s:.2f} s (model build and restore, reports included); "
              f"prediction loop {rep['images_per_sec']:.1f} img/s (decode, "
              f"predict, labels, mask PNGs; the first batch of each shape "
              f"included); maxpool_pyramid.launches = {launches} = 4 x "
              f"{batches} batches; overall accuracy "
              f"{rep['overall_accuracy']}%", flush=True)
        runs[views] = {"report": rep, "launches": launches,
                       "kernels": kernels, "masks": np.stack(
            [np.asarray(Image.open(os.path.join(
                cfg.save_dir, "test_results", "fold_1", "masks",
                f"pred_{i}.png"))) // 255 for i in range(N_TEST)])}

    # the same weights and decode with the plain pool on the card
    ds = SegmentationFolderDataset(test_dir, (SIZE, SIZE))
    x = np.stack([ds.load_pair(i)[0] for i in range(len(ds))])
    msk = np.stack([ds.load_pair(i)[1] for i in range(len(ds))])
    model = drivers._restore_model(
        drivers._test_train_config(cfg), os.path.join(cfg.save_dir,
                                                      "Fold_1"),
        "evaluating", "cuda")
    trainer = Trainer(model, device="cuda")
    before = pyramid.launches.value
    with mock.patch.object(pyramid, "maxpool_pyramid",
                           pyramid.maxpool_pyramid_plain):
        probs = np.concatenate([trainer.predict(x[i:i + TEST_BATCH])["out"]
                                for i in range(0, len(x), TEST_BATCH)])
    _check(pyramid.launches.value == before, "plain-pool run launched")
    labels = label_from_pred(probs, 1, THRESHOLD)
    cm_plain = confusion_matrix_update(
        init_confusion_matrix(2),
        (msk[..., 0] > THRESHOLD).astype(np.int32), labels)
    near = np.abs(probs[..., 0] - THRESHOLD) < NEAR_TEST
    differ = runs[""]["masks"] != labels
    cm = runs[""]["report"]["confusion_matrix"]
    off = float(np.abs(cm - cm_plain).sum())
    _check(not bool((differ & ~near).any()) and off <= 2 * int(differ.sum()),
           f"{int((differ & ~near).sum())} mask pixels differ from the "
           f"plain-pool forward's labels away from the threshold; confusion "
           f"matrix {cm.tolist()} vs {cm_plain.tolist()}")
    tta_differ = runs[TEST_TTA]["masks"] != labels
    # the kernels' forward against the plain pool's, probability for
    # probability (the pool is exact: the rest of the forward sees the
    # same tensors)
    kprobs = np.concatenate([trainer.predict(x[i:i + TEST_BATCH])["out"]
                             for i in range(0, len(x), TEST_BATCH)])
    err = float(np.abs(kprobs - probs).max())
    _check(err <= NEAR_TEST, f"test forward differs from the plain pool's "
           f"by {err}")
    print(f"phase 12 test: labels equal the plain-pool forward's at all "
          f"{int((~near).sum())} pixels farther than {NEAR_TEST} from the "
          f"threshold; {int(near.sum())} are nearer, {int(differ.sum())} of "
          f"them differ; confusion matrix {cm.astype(np.int64).tolist()}, "
          f"plain {cm_plain.tolist()}; probabilities in "
          f"[{float(probs.min()):.4g}, {float(probs.max()):.4g}], the "
          f"kernels' within {err:.3g} of the plain pool's (<= {NEAR_TEST}); "
          f"with views {TEST_TTA} {int(tta_differ.sum())} of "
          f"{tta_differ.size} labels differ from the plain forward's "
          f"without views", flush=True)
    # predict's own time on a warm batch shape (each verb run above makes
    # one call per batch, the first at a new shape)
    xb = x[:TEST_BATCH]
    for views in ((), tuple(TEST_TTA.split(","))):
        trainer.predict(xb, views)
        times = []
        for _ in range(REPS):
            t = time.perf_counter()
            trainer.predict(xb, views)  # returns host arrays: synchronized
            times.append(time.perf_counter() - t)
        print(f"phase 12 test: p50 predict of a batch of {TEST_BATCH}, views "
              f"{','.join(views) or 'none'} ({(1 + len(views)) * TEST_BATCH} "
              f"images in one forward): "
              f"{statistics.median(times) * 1e3:.3f} ms over {REPS} calls "
              f"after one warm-up (host clock, copies to and from the card "
              f"included)", flush=True)
    del model, trainer
    torch.cuda.empty_cache()
    return {"pyramid": runs[""]["launches"], "kernels": runs[""]["kernels"]}


#: phases 26-27: the bar of the card's float32 step against a CPU step
#: on its ReLU masks: gradients in units of the step's largest gradient,
#: outputs in units of the largest output.  Phase 7's absolute 1e-4 fails
#: the CPU's own float32 step against its float64 step on these nets;
#: the bfloat16 control of each model must miss this bar
#: (``_train_reference``; the readings in PERF.md section 6).
RELATIVE_BAR = 1e-3
#: phases 26-27: the most ReLU pre-activations of a step that a CPU step
#: may put on the other side of 0 from the card's (the runs show 0-2)
MAX_RELU_FLIPS = 4


def _largest_grad(model) -> float:
    return max(float(p.grad.abs().max()) for p in model.parameters())


def _reference_errors(ref, loss_r, gpu, loss_g, lr: float,
                      skip_zero_grads: bool = False,
                      relative_bar: "float | None" = None,
                      stats_relative: bool = False) -> dict:
    """How the card's step (``gpu``, ``loss_g``) differs from a CPU step
    (``ref``, ``loss_r``), and whether that is within phase 7's
    tolerances: loss 1e-5, gradients 1e-4, running statistics 1e-5, every
    parameter within 2 lr after Adam's first update (about lr * sign(g):
    a gradient that rounding puts on the other side of 0 moves its
    parameter by up to 2 lr), and at most 1e-3 of them beyond 1e-5.
    With ``skip_zero_grads`` (phase 17 only), a parameter whose gradient
    in the CPU step is 0 to within 1e-12 of the largest is held to 2 lr
    and left out of that share: in float64 these are the biases of
    convolutions that feed a training-mode BatchNorm, whose exact gradient
    is 0 (the batch mean takes the bias out again), and where the card's
    float32 step computes rounding, which Adam's first update scales up to
    about lr.  With ``relative_bar`` (phases 26-27) the gradients'
    largest distance is taken in units of the largest gradient of the CPU
    step, and held to that bar instead.  With ``stats_relative`` (phase
    32) each running statistic's distance is taken in units of its size
    where that is above 1, the CPU tests' bar for the backbones (a
    backbone's BatchNorms hold variances up to 1e2-1e4, which float32
    rounds by more than 1e-5)."""
    import torch

    gp = dict(gpu.named_parameters())
    gs = gpu.state_dict()
    per_param = {k: (p.detach() - gp[k].detach().cpu()).abs().flatten()
                 for k, p in ref.named_parameters()}
    diffs = torch.cat(list(per_param.values()))
    counted = {k: (p.grad.double().abs() > 1e-12 * max(
        float(p.grad.abs().max()), 1.0)).flatten() if skip_zero_grads
        else torch.ones_like(per_param[k], dtype=torch.bool)
        for k, p in ref.named_parameters()}
    live = torch.cat(list(counted.values()))
    e = {"loss": abs(float(loss_r) - float(loss_g)),
         "grads": max(float((p.grad - gp[k].grad.cpu()).abs().max())
                      for k, p in ref.named_parameters()) / (
             _largest_grad(ref) if relative_bar else 1.0),
         "stats": max((float((v - gs[k].cpu()).abs().max()) / (
                           max(float(v.abs().max()), 1.0)
                           if stats_relative else 1.0)
                       for k, v in ref.state_dict().items()
                       if "running" in k), default=0.0),
         "params": float(diffs.max()),
         "share": float((diffs[live] > 1e-5).float().mean()),
         "no_grad": int((~live).sum())}
    grads_bar = relative_bar or 1e-4
    e["ok"] = (e["loss"] <= 1e-5 and e["grads"] <= grads_bar
               and e["stats"] <= 1e-5 and e["params"] <= 2 * lr
               and e["share"] <= 1e-3)
    e["text"] = (
        f"loss {e['loss']:.3g} <= 1e-5, grads max-abs "
        f"{'(of the largest) ' if relative_bar else ''}{e['grads']:.3g} <= "
        f"{grads_bar:.3g}, running stats "
        f"{'(of their size) ' if stats_relative else ''}{e['stats']:.3g} "
        f"<= 1e-5, params "
        f"max-abs {e['params']:.3g} <= 2 lr with {e['share']:.3g} of them "
        f"beyond 1e-5 (<= 1e-3")
    e["text"] += (f"; {e['no_grad']} without a gradient left out)"
                  if skip_zero_grads else ")")
    if not e["ok"]:
        worst = sorted(per_param, key=lambda k: -int(
            (per_param[k][counted[k]] > 1e-5).sum()))
        e["text"] += "; the most of those beyond 1e-5 in " + "; ".join(
            f"{k} ({int((per_param[k][counted[k]] > 1e-5).sum())} of "
            f"{per_param[k].numel()})" for k in worst[:3])
    return e


@contextlib.contextmanager
def _relu_masks(masks: list, replay: bool, flips: "list | None" = None):
    """``torch.relu`` as the port's blocks call it (``torch.relu`` and the
    ``relu`` activation), recording each call's mask ``x > 0`` in
    ``masks`` or, with ``replay``, applying the recorded masks in call
    order instead of its own (every recorded mask used, the shapes
    equal); ``flips`` gets the count of elements whose own mask differs
    from the replayed one.  The backbones' ``relu6`` (MobileNet V1/V2 and,
    inside hard-swish and hard-sigmoid, V3) is recorded and replayed the
    same way, by its three pieces: 0 at x <= 0, x inside, 6 at x >= 6,
    so its kinks at 0 and 6 (hard-swish's at -3 and 3) cannot differ
    between the card's step and the CPU's either.  Its pieces are
    replayed, not counted in ``flips``: MAX_RELU_FLIPS was set on ReLU's
    kink at 0, and float32 rounds a value near 3 or 6 by more than one
    near 0."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models.backbones import (
        base, convnets)
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks

    real, real6 = torch.relu, base.relu6
    given = iter(masks)

    def take(x, kind):
        got = next(given, None)
        _check(got is not None and got[0] == kind
               and got[1].shape == x.shape, "the replayed ReLU calls differ")
        return got[1].to(x.device)

    def relu(x):
        if not replay:
            masks.append(("relu", (x > 0).detach().cpu()))
            return real(x)
        mask = take(x, "relu")
        if flips is not None:
            flips.append(int((mask != (x > 0)).sum()))
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))

    def relu6(x):
        piece = ((x > 0).to(torch.int8) + (x >= 6).to(torch.int8)).detach()
        if not replay:
            masks.append(("relu6", piece.cpu()))
            return real6(x)
        want = take(x, "relu6")
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.where(want == 0, zero,
                           torch.where(want == 2, zero + 6.0, x))

    with mock.patch.object(torch, "relu", relu), \
            mock.patch.dict(blocks._ACTIVATIONS, {"relu": relu}), \
            mock.patch.object(base, "relu6", relu6), \
            mock.patch.object(convnets, "relu6", relu6):
        yield
    _check(not replay or next(given, None) is None,
           "the replayed step made fewer ReLU calls")


def _train_forward(model, x, targets, loss, weights) -> tuple:
    """The outputs (float32) and loss of a train step's forward of a copy
    of ``model`` (training mode, BatchNorm on batch statistics, its own
    ReLU masks), without gradients or any change to ``model``."""
    import copy

    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        deep_supervision_loss)

    m = copy.deepcopy(model).train()
    with torch.no_grad():
        out = {k: v.float() for k, v in m(x).items()}
        t = targets if isinstance(targets, dict) else {"out": targets}
        return out, float(deep_supervision_loss(loss, out, t, weights))


def _train_reference(phase: str, what: str, cpu, targets, weights,
                     want_launches: tuple, cpu64=None,
                     shape: tuple = (2, 64, 64, 3), loss=None,
                     control=None, x_scale: float = 1.0,
                     stats_relative: bool = False) -> None:
    """One float32 train step of ``cpu`` on the card (the kernels, cuDNN
    without TF32, deterministic) against the same step on the CPU (the
    plain versions) from the same weights, batch and Adam state, within
    phase 7's tolerances (``_reference_errors``, every parameter counted).
    ``targets(y)`` builds the step's targets from the mask on its device.
    The input is uniform of ``shape`` times ``x_scale``, the mask of its
    shape with one channel; ``loss`` defaults to BCEDice.

    ``cpu64`` (phase 17 on) is the same model built with
    ``dtype=torch.float64``: parameters, loss and Adam stay float32 and
    every block computes in float64; the model code's float64 support
    (BatchNorm promotes to at least float32, ``_SLOPES`` has a float64
    slope) exists for this step alone.  A float32 step is defined only
    up to the side of a ReLU on which a pre-activation within float32
    rounding of zero lands, and the card and the CPU may land apart, or
    both apart from the float64 step; either side moves gradients by up
    to 1e-4 and, through Adam's first update, parameters with small
    gradients by up to 2 lr.  With ``cpu64`` the card's step passes when
    it is within the tolerances of either CPU step, parameters without a
    gradient left out of the share; both readings are printed.

    ``control`` (phases 26-27, with ``cpu64``) is the same model built
    with ``dtype=torch.bfloat16``.  Its presence selects the check of
    these phases, where one pre-activation that float32 rounding puts on
    the other side of 0 changes its element's gradient from g to 0, and
    at W8 on a batch of two one such element moved a recurrent net's
    weight gradients by 2.5% of their size (PERF.md section 6):
    - the forward and loss of the step, each device on its own ReLU
      masks, agree with either CPU step's: loss within 1e-5, outputs
      within RELATIVE_BAR of the largest output;
    - the CPU steps then run on the card's ReLU masks (``_relu_masks``),
      and at most MAX_RELU_FLIPS elements of each may differ in sign
      from the card's;
    - phase 7's tolerances hold but for the gradients, which are held to
      RELATIVE_BAR of the step's largest gradient (the CPU's own float32
      step's distance from its float64 step is printed beside them);
    - the same step of ``control`` on the card must miss that bar
      against both CPU steps, which shows that the bar tells a float32
      step from a bfloat16 one.

    ``stats_relative`` (phase 32) holds the running statistics to 1e-5
    of their size where that is above 1 (``_reference_errors``)."""
    import copy

    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        bce_dice_loss, make_optimizer, make_train_step)

    lr = 1e-3
    loss = loss or bce_dice_loss
    gpu = copy.deepcopy(cpu).cuda()
    refs = (cpu,) if cpu64 is None else (cpu, cpu64)
    rng = np.random.default_rng(SEED + 4)
    x = torch.from_numpy((rng.uniform(size=shape) * x_scale).astype(
        np.float32))
    y = torch.from_numpy((rng.uniform(size=shape[:-1] + (1,)) > 0.7).astype(
        np.float32))
    _replay_card_draws(gpu, x.cuda(), [cpu] + list(refs[1:]) + (
        [control] if control is not None else []))
    bar = RELATIVE_BAR if control is not None else None

    def step(model, xs, ys):
        return make_train_step(
            model, make_optimizer("Adam", model.parameters(), lr), loss,
            weights)(xs, targets(ys))[0]

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    masks: list = []
    flips: list = [[] for _ in refs]
    forward = []
    try:
        if control is not None:
            out_g, fwd_loss_g = _train_forward(gpu, x.cuda(),
                                               targets(y.cuda()), loss,
                                               weights)
        counts = (pyramid.launches.value, pool_backward.launches.value)
        with (_relu_masks(masks, replay=False) if control is not None
              else contextlib.nullcontext()):
            loss_g = step(gpu, x.cuda(), y.cuda())
            torch.cuda.synchronize()
        launched = (pyramid.launches.value - counts[0],
                    pool_backward.launches.value - counts[1])
        loss_c = []
        for ref, flipped in zip(refs, flips):
            if control is not None:
                out_c, fwd_loss_c = _train_forward(ref, x, targets(y), loss,
                                                   weights)
                forward.append((abs(fwd_loss_c - fwd_loss_g), max(
                    float((v - out_g[k].cpu()).abs().max())
                    for k, v in out_c.items()) / max(
                    float(v.abs().max()) for v in out_c.values())))
            with (_relu_masks(masks, replay=True, flips=flipped)
                  if control is not None else contextlib.nullcontext()):
                loss_c.append(step(ref, x, y))
        _check((pyramid.launches.value - counts[0],
                pool_backward.launches.value - counts[1]) == launched,
               "the CPU step launched a kernel")
        if control is not None:
            ctl = copy.deepcopy(control).cuda()
            loss_ctl = step(ctl, x.cuda(), y.cuda())
            torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    _check(launched == want_launches, f"the card's step launched {launched}")
    errs = [_reference_errors(ref, loss, gpu, loss_g, lr,
                              skip_zero_grads=cpu64 is not None,
                              relative_bar=bar, stats_relative=stats_relative)
            for ref, loss in zip(refs, loss_c)]
    names = ("float32", "float64")
    readings = [f"vs CPU (plain versions) in {name}"
                + (f" with the card's ReLU masks ({sum(f)} of "
                   f"{sum(m.numel() for _, m in masks)} pre-activations on "
                   f"the other side of a kink there, <= {MAX_RELU_FLIPS})"
                   if control is not None else "")
                + f": {e['text']}" + ("" if e["ok"] else " (not met)")
                for name, e, f in zip(names, errs, flips)]
    if control is not None:
        unmasked = "; ".join(
            f"in {name}: loss {dl:.3g} <= 1e-5, outputs (of the largest) "
            f"{dy:.3g} <= {bar:.3g}" for name, (dl, dy) in zip(names, forward))
        _check(any(dl <= 1e-5 and dy <= bar for dl, dy in forward),
               f"forward of a {what}, card vs CPU on their own ReLU masks: "
               + unmasked)
        readings.insert(0, "forward on each device's own ReLU masks vs CPU "
                        + unmasked)
        _check(max(sum(f) for f in flips) <= MAX_RELU_FLIPS,
               f"float32 train step of a {what}: more than {MAX_RELU_FLIPS}"
               f" pre-activations on the other side of 0 from the card's: "
               + "; ".join(readings))
        ctl_grads = [_reference_errors(ref, lc, ctl, loss_ctl, lr, True,
                                       bar)["grads"]
                     for ref, lc in zip(refs, loss_c)]
        _check(min(ctl_grads) > bar,
               f"the bfloat16 control step of a {what} met the gradients' "
               f"bar: {ctl_grads}")
        g64 = dict(cpu64.named_parameters())
        own = max(float((p.grad - g64[k].grad).abs().max())
                  for k, p in cpu.named_parameters()) / _largest_grad(cpu64)
        readings.append(
            f"the CPU's own float32 step's grads vs its float64 step (of the"
            f" largest) {own:.3g}; the bfloat16 control step's grads (of the"
            f" largest) " + ", ".join(f"{g:.3g}" for g in ctl_grads)
            + f" > {bar:.3g} vs the CPU steps (missed, as it must)")
    _check(any(e["ok"] for e in errs),
           f"float32 train step of a {what}, card vs CPU: "
           + "; ".join(readings))
    print(f"{phase}: float32 train step of a {what} on {shape}, card "
          f"(kernels {launched[0]}+{launched[1]} launches, cuDNN without "
          f"TF32, deterministic) " + "; ".join(readings), flush=True)


def _replay_card_draws(gpu, x, others: list) -> None:
    """For a model with DropBlock: one training forward of a copy of
    ``gpu`` on ``x`` draws every layer's seeds from the card's stream (a
    CUDA generator keyed by SEED and step 0); ``gpu`` and the ``others``
    (the CPU models, the control) then replay those draws, so the card's
    step and the CPU's steps drop the same blocks.  A model without a
    stochastic layer is left as it is."""
    import copy

    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops import (
        drawn_by_name, random_stream, replay, stream_generator)

    probe = copy.deepcopy(gpu).train()
    with torch.no_grad(), random_stream(stream_generator("cuda", SEED, 0)):
        probe(x)
    draws = drawn_by_name(probe)
    if not draws:
        return
    replay(gpu, draws)
    for model in others:
        replay(model, {k: v.cpu() for k, v in draws.items()})
    print(f"    the card's DropBlock draws replayed on the CPU: "
          f"{len(draws)} layers, {sum(int(d.sum()) for d in draws.values())}"
          f" seeds", flush=True)


def phase_train_reference() -> None:
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel

    cpu = SegModel("UNetPP", 8, 3, generator=torch.Generator().manual_seed(
        SEED + 3))
    _train_reference("phase 7 reference", "W8/D3 UNet++", cpu,
                     lambda y: y, None, (3, 3))


def phase_train_ds_reference() -> None:
    """Phase 7's check on a W8/D3 UNet3+ with ``ds=1``: BCEDice on every
    head, default_ds_weights(3), ds_type UNet targets (one pyramid launch
    on the card).  The heads have no activation, and where a raw head
    value lands near 0 the BCEDice gradient amplifies rounding without
    bound; the heads are scaled to give values near 0.5, where the
    comparison measures the kernels and not that amplification."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        default_ds_weights)

    cpu = SegModel("UNet3P", 8, 3, ds=1,
                   generator=torch.Generator().manual_seed(SEED + 5))
    with torch.no_grad():
        for k in (1, 2, 3):
            head = getattr(cpu.FullScaleDecoder_0, f"level{k}")
            head.weight.mul_(0.01)
            head.bias.fill_(0.5)
    # 3 encoder pools, 2 decoder pyramids (skip 0 to levels 1-2, skip 1 to
    # level 1) and 1 target pyramid; 3 + 3 backward pools
    _train_reference("phase 10 ds reference", "W8/D3 UNet3+ with ds=1", cpu,
                     lambda y: prepare_train_dict(y, 3, "UNet"),
                     default_ds_weights(3), (6, 6))


def _references(phase: str, cases: tuple, float64: bool = False) -> None:
    """Phase 7's check on W8/D3 models, weights from SEED + 9: ``cases``
    are (decoder, ag, ds_type or None without deep supervision, the
    launches a step on the card), BCEDice on every head weighted by
    default_ds_weights(3), the heads scaled as in phase 10.  ``float64``
    adds the float64 CPU step of ``_train_reference``."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        default_ds_weights)

    for dec, ag, ds_type, want in cases:
        ds = int(ds_type is not None)
        cpu = SegModel(dec, 8, 3, ds=ds, ag=ag,
                       generator=torch.Generator().manual_seed(SEED + 9))
        decoder = getattr(cpu, cpu._decoder_name)
        with torch.no_grad():
            for k in range(1, 4) if ds else ():
                head = getattr(decoder, f"level{k}")
                head.weight.mul_(0.01)
                head.bias.fill_(0.5)
        cpu64 = None
        if float64:
            cpu64 = SegModel(dec, 8, 3, ds=ds, ag=ag, dtype=torch.float64)
            cpu64.load_state_dict(cpu.state_dict())
        _train_reference(
            phase, f"W8/D3 {dec}" + (" with ag=1" if ag else "")
            + (f" with ds=1, ds_type {ds_type}" if ds else " without ds"),
            cpu, (lambda y, t=ds_type: prepare_train_dict(y, 3, t)) if ds
            else (lambda y: y), default_ds_weights(3) if ds else None, want,
            cpu64)


def phase_config2_reference() -> None:
    """Phase 7's check on W8/D3 models of config 2: UNet with ``ds=1`` and
    ds_type UNet (its heads at 1 / 2**k before each upsampling, its
    targets from one pyramid launch), UNetE without deep supervision (the
    pruned grid) and UNetP with ``ds=1`` and ds_type UNetPP (full-resolution
    heads and targets)."""
    # launches: 3 encoder pools (+1 target pyramid for ds_type UNet), 3
    # backward pools
    _references("phase 13 config 2 reference",
                (("UNet", 0, "UNet", (4, 3)), ("UNetE", 0, None, (3, 3)),
                 ("UNetP", 0, "UNetPP", (3, 3))))


def phase_multires_reference() -> None:
    """Phase 7's check on W8/D3 models of the MultiRes family and the
    gates: MultiResUNet with ``ds=1`` (ds_type UNet), UNet with ``ag=1``
    and ``ds=1``, UNet++ with ``ag=1`` (the gates on the dense terms),
    MultiResUNet3+ and KSSNet.  The only phase with the float64 CPU step:
    the gated UNet's float32 card step lands apart from the float32 CPU
    step on more than 1e-3 of its parameters, MultiResUNet's with ``ds=1``
    beyond 1e-4 of the float64 step's gradients, and each is within the
    tolerances of the other CPU step (ReLU pre-activations within float32
    rounding of 0, PERF.md section 6)."""
    # launches: 3 encoder pools (+1 target pyramid with ds); MultiResUNet3+
    # 2 decoder pyramids, KSSNet 3 tap pyramids; 3 backward pools,
    # MultiResUNet3+ + 2 + 1, KSSNet + 3 + 2 + 1
    _references("phase 17 multires reference",
                (("MultiResUNet", 0, "UNet", (4, 3)),
                 ("UNet", 1, "UNet", (4, 3)), ("UNetPP", 1, None, (3, 3)),
                 ("MultiResUNet3P", 0, None, (5, 6)),
                 ("KSSNet", 0, None, (6, 9))), float64=True)


def _clip_values(model, loss_fn, x, y) -> dict:
    """Clips that each bite on ``model``'s first gradient of ``loss_fn``
    on (x, y), in the order they apply: ``global_clipnorm`` half its
    global norm; ``clipnorm`` the median per-parameter norm of what that
    leaves; ``clipvalue`` the 99th percentile of the absolute elements of
    what both leave.  (One forward and backward, outside any count.)"""
    import torch

    model.train()
    model.zero_grad(set_to_none=True)
    loss_fn(y, model(x)["out"].float()).backward()
    grads = [0.5 * p.grad for p in model.parameters()]
    clips = {"global_clipnorm": float(torch.stack(
        [g.norm() for g in grads]).norm())}
    norms = torch.stack([g.norm() for g in grads])
    clips["clipnorm"] = float(norms.median())
    flat = torch.cat([(g * torch.clamp_max(clips["clipnorm"] / n, 1.0))
                      .flatten() for g, n in zip(grads, norms)]).abs()
    clips["clipvalue"] = float(torch.kthvalue(
        flat.float().cpu(), int(0.99 * flat.numel())).values)
    model.zero_grad(set_to_none=True)
    return clips


def _p50_ms(fn, reps: int = REPS) -> float:
    """Median host time of ``fn()`` up to a synchronize, after one call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def phase_registries(tmp: str) -> dict:
    """Phase 18: the flagship's train step under each of the 8 optimizers
    with the three gradient clips biting (REG_STEPS counted fixed-batch
    steps each, 4 + 4 launches a step, finite losses), the p50 of each
    optimizer update (clips included) and of the verb's metric updates
    with their shares of the step, the bucketize threshold counts against
    the broadcast on one card batch, one train verb fold (class_number 2,
    FocalLoss, Nadam, the clips, REG_METRICS), and a float32 card-against-
    CPU reference per optimizer with the clips on."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        OPTIMIZER_NAMES, clip_gradients, make_metric)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train.metrics import (
        _keras_thresholds, conf_counts, conf_counts_broadcast)

    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 2)
    base = _train_config(tmp, "ResultsReg")
    probe = _trainer_for(base)
    xd, yd = probe.to_device(x), probe.to_device(y)
    clips = _clip_values(probe.model, probe.loss_fn, xd, yd)
    del probe
    print(f"phase 18 registries: W32/D4 UNet++ bf16, BCEDice, lr "
          f"{base.learning_rate}, batch {TRAIN_BATCH}, clips that each bite "
          f"on the first gradient: global_clipnorm "
          f"{clips['global_clipnorm']:.6g} (half its global norm), clipnorm "
          f"{clips['clipnorm']:.6g} (the median parameter norm after it), "
          f"clipvalue {clips['clipvalue']:.6g} (the 99th percentile of the "
          f"absolute elements after both)", flush=True)
    counts = {"pyramid": 0, "backward": 0, "kernels": collections.Counter()}
    step_ms = {}
    for name in OPTIMIZER_NAMES:
        trainer = _trainer_for(_train_config(
            tmp, "ResultsReg", optimizer_function=name, **clips))
        run = _counted_steps(f"phase 18 {name}", "registries", trainer, xd,
                             yd, REG_STEPS, must_fall=False)
        for k in counts:
            counts[k] += run[k]
        step_ms[name] = run["p50"] * 1e3
        # the gradients of the last step are still on the parameters
        update = _p50_ms(trainer.optimizer.step)
        print(f"phase 18 {name}: p50 optimizer update (the clips "
              f"included) {update:.3f} ms, {update / step_ms[name]:.2%} of "
              f"its p50 step {step_ms[name]:.3f} ms (host clock, "
              f"synchronized, {REPS} updates)", flush=True)
        if name == "SGD":
            params = list(trainer.model.parameters())
            clip = _p50_ms(lambda: clip_gradients(params, **clips))
            print(f"phase 18 clips: p50 of the three clips alone "
                  f"(clip_gradients, {len(params)} parameters) {clip:.3f} "
                  f"ms, {clip / step_ms[name]:.2%} of SGD's p50 step",
                  flush=True)
        del trainer
        torch.cuda.empty_cache()

    # the verb's metrics on one batch of the flagship's outputs
    trainer = _trainer_for(_train_config(tmp, "ResultsReg"))
    with torch.inference_mode():
        out = trainer.model(xd)["out"].float()
        defs = [make_metric(n, num_classes=3) for n in REG_METRICS]
        states = [m.init(xd.device) for m in defs]
        upd = _p50_ms(lambda: [m.update(st, yd, out)
                               for m, st in zip(defs, states)])
        th = torch.tensor(_keras_thresholds(200), device=xd.device)
        got, want = conf_counts(yd, out, th), conf_counts_broadcast(yd, out,
                                                                    th)
    _check(all(torch.equal(got[k], want[k]) for k in want),
           "bucketize threshold counts differ from the broadcast counts")
    print(f"phase 18 metrics: p50 update of the {len(defs)} metrics "
          f"{', '.join(REG_METRICS)} on one batch of {TRAIN_BATCH} outputs "
          f"{upd:.3f} ms, {upd / step_ms['Nadam']:.2%} of Nadam's p50 step "
          f"(host clock, synchronized); the AUC's bucketize counts equal the "
          f"broadcast's at all 200 thresholds over {out.numel()} pixels "
          f"(tp at 0.5: {int(got['tp'][100])})", flush=True)
    del trainer, out
    torch.cuda.empty_cache()

    cfg = _train_config(tmp, "ResultsReg", class_number=2,
                        loss_function="FocalLoss", optimizer_function="Nadam",
                        metric_list=REG_METRICS, num_epochs=1, **clips)
    run = _run_train_verb("phase 18 registries verb", cfg, "registries")
    for k in counts:
        counts[k] += run[k]
    with open(os.path.join(cfg.save_dir, "Fold_1", "history.json")) as f:
        hist = json.load(f)
    for key in REG_METRICS + tuple(f"val_{m}" for m in REG_METRICS):
        _check(key in hist and all(np.isfinite(hist[key])),
               f"history.json: {key} missing or not finite: {hist.get(key)}")
    print("phase 18 registries verb: history.json "
          + ", ".join(f"{k} {hist[k][-1]:.6g}" for k in REG_METRICS
                      + tuple(f"val_{m}" for m in REG_METRICS)), flush=True)
    for name in OPTIMIZER_NAMES:
        _optimizer_reference(name)
    return counts


def _optimizer_reference(name: str) -> None:
    """Phase 18's float32 check of one optimizer with the clips biting
    (from the CPU model's first gradient): a W8/D3 UNet++ takes one CPU
    step from a fresh state; then, REG_REF_STEPS times, the CPU's weights
    and optimizer state go to the card and both take one step on the same
    batch, held to phase 7's tolerances (``_reference_errors``).  Each
    step starts from the CPU's state: float32 trajectories drift apart
    over unsynced steps wherever a ReLU pre-activation lies within
    rounding of zero (PERF.md section 6), which would hide the
    optimizer's own error."""
    import copy

    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        bce_dice_loss, make_optimizer, make_train_step)

    lr = 1e-3
    cpu = SegModel("UNetPP", 8, 3, generator=torch.Generator().manual_seed(
        SEED + 3))
    rng = np.random.default_rng(SEED + 4)
    x = torch.from_numpy(rng.uniform(size=(2, 64, 64, 3)).astype(np.float32))
    y = torch.from_numpy((rng.uniform(size=(2, 64, 64, 1)) > 0.7).astype(
        np.float32))
    clips = _clip_values(cpu, bce_dice_loss, x, y)
    opt_c = make_optimizer(name, cpu.parameters(), lr, **clips)
    step_c = make_train_step(cpu, opt_c, bce_dice_loss)
    step_c(x, y)
    gpu = copy.deepcopy(cpu).cuda()
    opt_g = make_optimizer(name, gpu.parameters(), lr, **clips)
    step_g = make_train_step(gpu, opt_g, bce_dice_loss)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    texts = []
    try:
        for i in range(REG_REF_STEPS):
            gpu.load_state_dict(cpu.state_dict())
            opt_g.load_state_dict(copy.deepcopy(opt_c.state_dict()))
            counts = (pyramid.launches.value, pool_backward.launches.value)
            loss_c, _ = step_c(x, y)
            _check((pyramid.launches.value, pool_backward.launches.value)
                   == counts, "the CPU step launched a kernel")
            loss_g, _ = step_g(x.cuda(), y.cuda())
            torch.cuda.synchronize()
            launched = (pyramid.launches.value - counts[0],
                        pool_backward.launches.value - counts[1])
            _check(launched == (3, 3),
                   f"{name}: the card's step launched {launched}")
            e = _reference_errors(cpu, loss_c, gpu, loss_g, lr)
            _check(e["ok"], f"float32 {name} step {i + 2} with clips, card "
                   f"vs CPU: {e['text']}")
            texts.append(f"step {i + 2}: {e['text']}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    print(f"phase 18 reference {name}: float32 steps 2-{REG_REF_STEPS + 1} "
          f"of a W8/D3 UNet++ with clips (global_clipnorm "
          f"{clips['global_clipnorm']:.4g}, clipnorm {clips['clipnorm']:.4g}, "
          f"clipvalue {clips['clipvalue']:.4g}), each from the CPU's weights "
          f"and optimizer state, card (kernels 3+3 launches a step) vs CPU: "
          + "; ".join(texts), flush=True)


def phase_predict(tmp: str, train_cfg) -> dict:
    """Phase 19: the ``predict`` verb through the command line (the GPU by
    default) on phase 6's trained fold (``train_cfg``'s save_dir) over
    N_PREDICT fresh PNGs with ``--batch PREDICT_BATCH --tta all``, the
    counts set to 0 just before it and read just after: a mask per PNG, 4
    pyramid launches a device batch of PREDICT_BATCH x (1 + 6 views) (the
    Predictor's warm-up is one), and the masks equal to ``label_from_pred``
    of the plain-pool forward with the same views away from the
    threshold.  The fold's probabilities crowd above 0.5 (phase 12), so
    the verb runs at ``--threshold`` the plain forward's median
    probability, where the masks split.  Then the kernels' probabilities
    against the plain pool's and the p50 device batch with and without
    the views."""
    import torch
    from PIL import Image

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import (
        main as cli)
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images, write_image_folder)
    from tf_1d_2d_segmentation_end2endpipelines_torch.data.generators import (
        load_image)
    from tf_1d_2d_segmentation_end2endpipelines_torch.eval import (
        label_from_pred, parse_tta)
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.serve import Predictor

    src = os.path.join(tmp, "Data", "Predict")
    write_image_folder(src, *synthetic_images(N_PREDICT, SIZE,
                                              seed=SEED + 10))
    images = os.path.join(src, "images")
    paths = sorted(os.path.join(images, f) for f in os.listdir(images))
    views = parse_tta("all")
    _check(len(views) == PREDICT_VIEWS, f"'all' names {views}")

    # the same weights, decode and views with the plain pool on the card
    model = drivers._restore_model(train_cfg, os.path.join(
        train_cfg.save_dir, "Fold_1"), "predicting with", "cuda")
    with_views = Predictor(model, (SIZE, SIZE, 3), max_batch=PREDICT_BATCH,
                           tta=views)
    x = np.stack([load_image(p, (SIZE, SIZE), "rgb", "lanczos", 255.0)
                  for p in paths])
    before = pyramid.launches.value
    with mock.patch.object(pyramid, "maxpool_pyramid",
                           pyramid.maxpool_pyramid_plain):
        probs = with_views(x)
    _check(pyramid.launches.value == before, "plain-pool run launched")
    _check(probs.shape == (N_PREDICT, SIZE, SIZE, 1)
           and bool(np.isfinite(probs).all()),
           f"plain-pool output {probs.shape} not finite")
    threshold = float(np.median(probs))

    out = os.path.join(tmp, "PredictMasks")
    ini = os.path.join(train_cfg.save_dir, "Train_Configs.ini")
    batches = -(-N_PREDICT // PREDICT_BATCH) + 1  # and the warm-up
    _reset_counts()  # the main path's run starts here
    t0 = time.perf_counter()
    cli(["predict", ini, "--input", images, "--out", out, "--batch",
         str(PREDICT_BATCH), "--tta", "all", "--threshold", repr(threshold)])
    verb_s = time.perf_counter() - t0
    launches = pyramid.launches.value  # ... and ends here
    kernels = _kernel_counts()
    want = [os.path.join(out, os.path.splitext(os.path.basename(p))[0]
                         + "_mask.png") for p in paths]
    _check(sorted(os.listdir(out)) == sorted(os.path.basename(w)
                                             for w in want)
           and len(want) == N_PREDICT, f"masks written: {os.listdir(out)}")
    _check(launches == 4 * batches,
           f"predict verb launched the pyramid {launches}x, not 4 x "
           f"{batches} device batches")
    print(f"phase 19 predict: the verb (--batch {PREDICT_BATCH} --tta all "
          f"--threshold {threshold:.6g}, the plain forward's median) wrote "
          f"{N_PREDICT} masks in {verb_s:.2f} s, {N_PREDICT / verb_s:.1f} "
          f"img/s (model build, restore, warm-up, decode and PNG writes "
          f"included); maxpool_pyramid.launches = {launches} = 4 x "
          f"{batches} device batches of {PREDICT_BATCH} x "
          f"{1 + PREDICT_VIEWS} images (the warm-up one of them)",
          flush=True)

    labels = label_from_pred(probs, 1, threshold)
    masks = np.stack([np.asarray(Image.open(w)) // 255 for w in want])
    near = np.abs(probs[..., 0] - threshold) < NEAR_THRESHOLD
    differ = masks != labels
    _check(not bool((differ & ~near).any()),
           f"{int((differ & ~near).sum())} mask pixels differ from the "
           f"plain-pool forward with the views away from the threshold")
    kprobs = with_views(x)
    err = float(np.abs(kprobs - probs).max())
    _check(err <= NEAR_TEST, f"predict forward differs from the plain "
           f"pool's by {err}")
    print(f"phase 19 predict: masks equal label_from_pred of the plain-pool "
          f"forward with the same views at all {int((~near).sum())} pixels "
          f"farther than {NEAR_THRESHOLD} from the threshold; "
          f"{int(near.sum())} are nearer, {int(differ.sum())} of them "
          f"differ; foreground share {float(labels.mean()):.4f}; "
          f"probabilities in [{float(probs.min()):.4g}, "
          f"{float(probs.max()):.4g}], the kernels' within {err:.3g} of the "
          f"plain pool's (<= {NEAR_TEST})", flush=True)
    x8 = torch.from_numpy(x[:PREDICT_BATCH]).cuda()
    no_views = Predictor(model, (SIZE, SIZE, 3), max_batch=PREDICT_BATCH)
    for what, pred in (("without views", no_views),
                       (f"with {PREDICT_VIEWS} views", with_views)):
        ms = _p50_ms(lambda: pred.forward(x8))
        print(f"phase 19 predict: p50 device batch of {PREDICT_BATCH} "
              f"{what} ({PREDICT_BATCH * (1 + len(pred.tta))} images in one "
              f"forward): {ms:.3f} ms (host clock, synchronized, {REPS} "
              f"runs)", flush=True)
    del model, with_views, no_views
    torch.cuda.empty_cache()
    return {"pyramid": launches, "kernels": kernels}


def _option_steps(label: str, cfg, want: tuple, x, y) -> dict:
    """Phase 20: OPT_STEPS counted fixed-batch flagship steps under the
    train step options of ``cfg`` (after one that picks cuDNN's
    algorithms), the counts set to 0 just before them and read just
    after: ``want`` (pyramid, backward) launches a step; p50 and peak
    memory (``_fixed_batch``)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)

    trainer = _trainer_for(cfg)
    trainer.train_step(x, y)
    torch.cuda.synchronize()
    pyramid.launches.reset()  # this option's run starts here
    pool_backward.launches.reset()
    p50 = _fixed_batch(f"phase 20 options {label}", trainer, x, y,
                       steps=OPT_STEPS)
    peak = torch.cuda.max_memory_allocated()
    got = (pyramid.launches.value, pool_backward.launches.value)  # ends
    _check(got == (want[0] * OPT_STEPS, want[1] * OPT_STEPS),
           f"{label}: launched pyramid {got[0]}x, backward {got[1]}x, not "
           f"{want[0]} and {want[1]} x {OPT_STEPS} steps")
    print(f"phase 20 options {label}: maxpool_pyramid.launches = {got[0]} "
          f"= {want[0]} x {OPT_STEPS} steps; maxpool_backward.launches = "
          f"{got[1]} = {want[1]} x {OPT_STEPS}; p50 {p50 * 1e3:.3f} ms, "
          f"peak {peak} B ({peak / 2 ** 30:.3f} GiB)", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return {"p50": p50, "peak": peak}


def _peak_bytes(cfg, batch: int) -> int:
    """Peak memory of 2 flagship steps on a batch of ``batch`` (after one
    that picks cuDNN's algorithms)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images)

    trainer = _trainer_for(cfg)
    x, y = (trainer.to_device(a) for a in synthetic_images(
        batch, SIZE, seed=SEED + 12))
    trainer.train_step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        loss, _ = trainer.train_step(x, y)
    _check(bool(torch.isfinite(loss)), f"batch {batch}: loss {loss}")
    peak = torch.cuda.max_memory_allocated()
    del trainer, x, y
    torch.cuda.empty_cache()
    return peak


def _options_reference(label: str, kw: dict, want: tuple,
                       block_remat: bool = False, steps: int = 1) -> None:
    """Phase 20's float32 check of one train step option: a W8/D3 UNet++
    on (4, 64, 64, 3); ``steps`` times the CPU's weights and shadow go to
    the card and both take one step (``make_train_step(**kw)``) with a
    fresh Adam.  Step 1 is held to phase 7's tolerances
    (``_reference_errors``); later steps to the same bounds on the loss,
    gradients, statistics and parameters (2 lr) but not to the share of
    parameters beyond 1e-5: once the weights have moved, ReLU
    pre-activations within rounding of zero land apart on the card and
    the CPU, and Adam's update turns the gradient's rounding into up to 2
    lr for parameters with gradients near 0 (0.19% and 0.91% of them
    beyond 1e-5 at steps 2 and 3 in the card runs of PERF.md).  The shadow
    is held to 2 lr of the CPU's, and the card's update of it to the EMA
    rule on its own parameters computed on the CPU, bit for bit."""
    import copy

    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        bce_dice_loss, make_optimizer, make_train_step)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train.state import (
        ema_shadow, ema_update)

    lr = 1e-3
    cpu = SegModel("UNetPP", 8, 3, generator=torch.Generator().manual_seed(
        SEED + 3), block_remat=block_remat)
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.default_rng(SEED + 4)
    x = torch.from_numpy(rng.uniform(size=(4, 64, 64, 3)).astype(np.float32))
    y = torch.from_numpy((rng.uniform(size=(4, 64, 64, 1)) > 0.7).astype(
        np.float32))
    ema = {m: ema_shadow(m) if kw.get("ema_decay") else None
           for m in (cpu, gpu)}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    texts = []
    try:
        for i in range(steps):
            gpu.load_state_dict(cpu.state_dict())
            if ema[cpu] is not None:
                for e_g, e_c in zip(ema[gpu], ema[cpu]):
                    e_g.copy_(e_c)
            step = {m: make_train_step(
                m, make_optimizer("Adam", m.parameters(), lr), bce_dice_loss,
                ema=ema[m], **kw) for m in (cpu, gpu)}
            counts = (pyramid.launches.value, pool_backward.launches.value)
            loss_c, _ = step[cpu](x, y)
            _check((pyramid.launches.value, pool_backward.launches.value)
                   == counts, "the CPU step launched a kernel")
            prev = ([e.cpu() for e in ema[gpu]] if ema[gpu] is not None
                    else None)
            loss_g, _ = step[gpu](x.cuda(), y.cuda())
            torch.cuda.synchronize()
            launched = (pyramid.launches.value - counts[0],
                        pool_backward.launches.value - counts[1])
            _check(launched == want, f"{label}: the card's step launched "
                   f"{launched}, not {want}")
            e = _reference_errors(cpu, loss_c, gpu, loss_g, lr)
            text = e["text"]
            ok = e["ok"] or (i > 0 and e["loss"] <= 1e-5
                             and e["grads"] <= 1e-4 and e["stats"] <= 1e-5
                             and e["params"] <= 2 * lr)
            if i > 0:
                text += " (share not held after step 1)"
            if prev is not None:
                gap = max(float((a - b.cpu()).abs().max())
                          for a, b in zip(ema[cpu], ema[gpu]))
                ema_update(prev, [p.detach().cpu()
                                  for p in gpu.parameters()], kw["ema_decay"])
                rule = all(torch.equal(a, b.cpu())
                           for a, b in zip(prev, ema[gpu]))
                ok = ok and gap <= 2 * lr and rule
                text += (f", shadow max-abs {gap:.3g} <= 2 lr and equal to "
                         f"the EMA rule on the card's parameters: {rule}")
            _check(ok, f"float32 {label} step {i + 1}, card vs CPU: {text}")
            texts.append(f"step {i + 1}: {text}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    print(f"phase 20 reference {label}: float32 W8/D3 UNet++ on (4, 64, 64, "
          f"3), card (kernels {want[0]}+{want[1]} launches a step, cuDNN "
          f"without TF32, deterministic) vs CPU, each step from the CPU's "
          f"weights and shadow with a fresh Adam: " + "; ".join(texts),
          flush=True)


def _augment_check(step_ms: float) -> None:
    """Phase 20's on-card augmentation: the p50 of one flagship image and
    mask batch and its share of the plain step; the card against the CPU
    on the same draws (images within 1e-5, masks equal, label values
    kept), the stream's batch-mode draws and per-sample draws with every
    warp and jitter coin up."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images)
    from tf_1d_2d_segmentation_end2endpipelines_torch.data.device_augment import (  # noqa: E501
        apply_augment, augment_stream_key, draw_params, make_device_augment)

    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 11)
    xg, yg = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    fn = make_device_augment()
    p50 = _p50_ms(lambda: fn(augment_stream_key(SEED, 0, 0), xg, yg))
    print(f"phase 20 augment: p50 of the on-card augmentation of a "
          f"({TRAIN_BATCH}, {SIZE}, {SIZE}, 3) image batch and its mask "
          f"batch {p50:.3f} ms (draws on the host included, host clock "
          f"synchronized), {100 * p50 / step_ms:.2f}% of the plain "
          f"flagship step's p50 {step_ms:.3f} ms", flush=True)
    labels = set(np.unique(y).tolist())
    for what, p in (
            ("stream (seed, 0, 0), batch warp", draw_params(
                augment_stream_key(SEED, 0, 0), TRAIN_BATCH)),
            ("per-sample warps, every coin up", draw_params(
                torch.Generator().manual_seed(SEED), TRAIN_BATCH,
                p_flip=0.5, p_warp=1.0, p_jitter=1.0, warp_mode="sample"))):
        gi, gm = apply_augment(xg, yg, p)
        ci, cm = apply_augment(torch.from_numpy(x), torch.from_numpy(y), p)
        err = float((gi.cpu() - ci).abs().max())
        same = bool(torch.equal(gm.cpu(), cm))
        kept = set(np.unique(gm.cpu().numpy()).tolist()) <= labels
        _check(err <= 1e-5 and same and kept,
               f"augment {what}: images max-abs {err}, masks equal {same}, "
               f"labels kept {kept}")
        print(f"phase 20 augment {what}: card vs CPU images max-abs "
              f"{err:.3g} <= 1e-5, masks equal, mask values within "
              f"{sorted(labels)}; {int(p['do_warp'].sum())} of "
              f"{TRAIN_BATCH} warped", flush=True)


def _options_config(tmp: str, results: str):
    return _train_config(tmp, results, num_epochs=OPT_EPOCHS,
                         accumulation_steps=OPT_ACCUM, remat="conv_outs",
                         ema_decay=0.999, augment_device=True,
                         exact_resume=True)


def _counted_verb(cfg, loader_call=None) -> tuple:
    """The train verb on the card, the counts set to 0 just before it and
    read just after; ``loader_call`` replaces ``PrefetchLoader.__call__``
    for the run.  Returns (history, pyramid, backward, launches by
    kernel, seconds)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)

    patch = (mock.patch.object(drivers.PrefetchLoader, "__call__",
                               loader_call) if loader_call is not None
             else contextlib.nullcontext())
    with patch:
        pyramid.launches.reset()  # the main path's run starts here
        pool_backward.launches.reset()
        t0 = time.perf_counter()
        hist = drivers.train(config=cfg, device="cuda")[1]
        torch.cuda.synchronize()
        counts = (pyramid.launches.value, pool_backward.launches.value,
                  _kernel_counts())
    return (hist, *counts, time.perf_counter() - t0)  # ... and ends here


def _state_gap(a: str, b: str) -> float:
    import torch

    sa = torch.load(a, map_location="cpu", weights_only=True)
    sb = torch.load(b, map_location="cpu", weights_only=True)
    gaps = [float((sa["model"][k].float() - sb["model"][k].float())
                  .abs().max()) for k in sa["model"]]
    gaps += [float((sa["ema"][k] - sb["ema"][k]).abs().max())
             for k in sa["ema"]]
    return max(gaps)


def _shadow_labels(cfg, x: np.ndarray, shadow: bool) -> tuple:
    """Probabilities and labels of the fold's best.pt with (or without)
    its EMA shadow loaded over the parameters by hand, plain pool on the
    card, in batches of TEST_BATCH."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.eval import (
        label_from_pred)
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer

    fold = os.path.join(cfg.save_dir, "Fold_1")
    model = drivers._build_model(cfg)
    model.load_state_dict(torch.load(os.path.join(fold, "best.pt"),
                                     weights_only=True))
    if shadow:
        with open(os.path.join(fold, "best.pt"), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        saved = torch.load(os.path.join(fold, "best_ema.pt"),
                           weights_only=True)
        _check(saved["weights_sha256"] == digest,
               "best_ema.pt was saved with other weights than best.pt")
        model.load_state_dict(saved["ema"], strict=False)
    trainer = Trainer(model, device="cuda")
    before = pyramid.launches.value
    with mock.patch.object(pyramid, "maxpool_pyramid",
                           pyramid.maxpool_pyramid_plain):
        probs = np.concatenate([trainer.predict(x[i:i + TEST_BATCH])["out"]
                                for i in range(0, len(x), TEST_BATCH)])
    _check(pyramid.launches.value == before, "plain-pool run launched")
    return probs, label_from_pred(probs, 1, THRESHOLD)


def _verbs_on_shadow(tmp: str, cfg) -> None:
    """Phase 20: the ``test`` and ``predict`` verbs on the fold ``cfg``
    trained with an EMA shadow, over phase 12's PNGs: their masks equal
    the labels of the plain-pool forward of best.pt with best_ema.pt over
    it, away from the threshold."""
    from PIL import Image

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        SegmentationFolderDataset)
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TestConfig)

    test_dir = os.path.join(tmp, "Data", "Test")
    ds = SegmentationFolderDataset(test_dir, (SIZE, SIZE))
    x = np.stack([ds.load_pair(i)[0] for i in range(len(ds))])
    probs, labels = _shadow_labels(cfg, x, shadow=True)
    _, raw = _shadow_labels(cfg, x, shadow=False)
    near = np.abs(probs[..., 0] - THRESHOLD) < NEAR_TEST
    tcfg = TestConfig(test_dir=test_dir, imheight=SIZE, imwidth=SIZE,
                      batch_size=TEST_BATCH, threshold=THRESHOLD,
                      save_dir=cfg.save_dir)
    rep = drivers.test(config=tcfg, device="cuda")[1]
    _check(rep["checkpoint_restored"] is True, "best.pt not restored")
    tested = np.stack([np.asarray(Image.open(os.path.join(
        cfg.save_dir, "test_results", "fold_1", "masks", f"pred_{i}.png")))
        // 255 for i in range(len(ds))])
    out = os.path.join(tmp, "PredictShadow")
    drivers.predict(os.path.join(cfg.save_dir, "Train_Configs.ini"),
                    input_path=os.path.join(test_dir, "images"),
                    out_dir=out, batch=TEST_BATCH, threshold=THRESHOLD,
                    device="cuda")
    predicted = np.stack([np.asarray(Image.open(os.path.join(
        out, os.path.splitext(os.path.basename(p))[0] + "_mask.png"))) // 255
        for p in ds.image_paths])
    for verb, masks in (("test", tested), ("predict", predicted)):
        differ = masks != labels
        _check(not bool((differ & ~near).any()),
               f"{verb} verb: {int((differ & ~near).sum())} mask pixels "
               f"differ from the shadow's plain-pool labels away from the "
               f"threshold")
        print(f"phase 20 verbs: the {verb} verb's {len(ds)} masks equal the "
              f"plain-pool labels of best.pt with best_ema.pt loaded over "
              f"it at all {int((~near).sum())} pixels farther than "
              f"{NEAR_TEST} from the threshold ({int(differ.sum())} of "
              f"{int(near.sum())} nearer ones differ); the raw weights' "
              f"labels differ from the shadow's at {int((raw != labels).sum())}"
              f" pixels", flush=True)


def phase_train_options(tmp: str) -> dict:
    """Phase 20: the rest of training on the flagship.  Fixed-batch steps
    under each remat mode and accumulation (launch counts, p50, peak
    memory), peak memory at batch 64 plain, under ``full`` and ``blocks``
    and with accumulation; float32
    card-vs-CPU steps for each option; the on-card augmentation; the train
    verb with accumulation, ``conv_outs`` remat, EMA, the on-card augment
    and exact resume, straight through and again with a SIGTERM in its
    second epoch and a resume; ``test`` and ``predict`` on the shadow;
    returns the verb run's counts (the ``train_options`` row)."""
    import signal

    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images)

    base = _train_config(tmp, "ResultsOpt")
    x, y = (torch.from_numpy(a).cuda() for a in synthetic_images(
        TRAIN_BATCH, SIZE, seed=SEED + 2))
    runs = {}
    for mode, fwd in REMAT_FWD.items():
        runs[mode or "none"] = _option_steps(
            f"remat {mode or 'none'}", dataclasses.replace(base, remat=mode),
            (fwd, 4), x, y)
    runs["accum"] = _option_steps(
        f"accumulation_steps {OPT_ACCUM}", dataclasses.replace(
            base, accumulation_steps=OPT_ACCUM),
        (4 * OPT_ACCUM, 4 * OPT_ACCUM), x, y)
    del x, y
    torch.cuda.empty_cache()
    big = {f"remat {mode or 'none'}": _peak_bytes(
        dataclasses.replace(base, remat=mode), OPT_BIG_BATCH)
        for mode in ("", "full", "blocks")}
    big[f"accumulation_steps {OPT_ACCUM}"] = _peak_bytes(
        dataclasses.replace(base, accumulation_steps=OPT_ACCUM),
        OPT_BIG_BATCH)
    print(f"phase 20 options: peak memory of a batch of {OPT_BIG_BATCH}: "
          + "; ".join(f"{k} {v} B ({v / 2 ** 30:.3f} GiB)"
                      for k, v in big.items()), flush=True)
    for label, kw, want, blocks, steps in (
            ("accumulation_steps 2", dict(accum_steps=2), (6, 6), False, 1),
            ("remat dots", dict(remat="dots"), (6, 3), False, 1),
            ("remat conv_outs", dict(remat="conv_outs"), (6, 3), False, 1),
            ("remat full", dict(remat="full"), (6, 3), False, 1),
            ("remat blocks", {}, (3, 3), True, 1),
            ("ema_decay 0.9", dict(ema_decay=0.9), (3, 3), False, 3)):
        _options_reference(label, kw, want, blocks, steps)
    _augment_check(runs["none"]["p50"] * 1e3)

    # the train verb: straight through, then SIGTERM in epoch 2 and resume
    steps = N_TRAIN // TRAIN_BATCH  # a partial batch is dropped
    val_batches = -(-N_VAL // TRAIN_BATCH)
    fwd_step, bwd_step = (len(FWD_PATHS["train_options"]),
                          len(BWD_PATHS["train_options"]))
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg_a = _options_config(tmp, "ResultsOptA")
        hist, fwd, bwd, kernels, secs = _counted_verb(cfg_a)
        _check(len(hist["loss"]) == OPT_EPOCHS
               and all(np.isfinite(hist["loss"] + hist["val_loss"])),
               f"non-finite or missing losses {hist}")
        _check((fwd, bwd) == (
            OPT_EPOCHS * (fwd_step * steps + 4 * val_batches),
            OPT_EPOCHS * bwd_step * steps),
            f"verb launched pyramid {fwd}x, backward {bwd}x")
        print(f"phase 20 verb: accumulation_steps {OPT_ACCUM}, remat "
              f"conv_outs, ema_decay 0.999, augment_device, exact_resume, "
              f"{OPT_EPOCHS} epochs in {secs:.2f} s; maxpool_pyramid."
              f"launches = {fwd} = {OPT_EPOCHS} x ({fwd_step} x {steps} "
              f"steps + 4 x {val_batches} val batches); maxpool_backward."
              f"launches = {bwd} = {OPT_EPOCHS} x {bwd_step} x {steps}; "
              f"loss {hist['loss']}, val_loss {hist['val_loss']}, steps/s "
              f"{hist['steps_per_sec']}", flush=True)
        counts = {"pyramid": fwd, "backward": bwd, "kernels": kernels}

        real = drivers.PrefetchLoader.__call__
        epochs_seen = {"n": 0}

        def preempting(loader):
            batches = real(loader)
            if not loader.shuffle:  # the validation loader
                return batches
            epochs_seen["n"] += 1
            epoch = epochs_seen["n"]

            def gen():
                for i, b in enumerate(batches):
                    if epoch == 2 and i == 3:
                        os.kill(os.getpid(), signal.SIGTERM)
                    yield b
            return gen()

        cfg_b = _options_config(tmp, "ResultsOptB")
        meta_path = os.path.join(cfg_b.save_dir, "Fold_1", "last.meta.json")
        hist_b, fwd_b, _, _, _ = _counted_verb(cfg_b, preempting)
        with open(meta_path) as f:
            meta = json.load(f)
        _check(meta["epoch"] == 1 and len(hist_b["loss"]) == 1,
               f"after the SIGTERM: meta epoch {meta['epoch']}, "
               f"{len(hist_b['loss'])} epochs in the history")
        hist_c, fwd_c, bwd_c, _, _ = _counted_verb(cfg_b)
        resumed = OPT_EPOCHS - 1
        _check((fwd_c, bwd_c) == (
            resumed * (fwd_step * steps + 4 * val_batches),
            resumed * bwd_step * steps) and len(hist_c["loss"]) == OPT_EPOCHS,
            f"the resumed run launched {fwd_c} + {bwd_c}, history "
            f"{len(hist_c['loss'])} epochs: not a resume at epoch 1")
        gap = _state_gap(
            os.path.join(cfg_a.save_dir, "Fold_1", "last.pt"),
            os.path.join(cfg_b.save_dir, "Fold_1", "last.pt"))
        _check(gap == 0, f"resumed weights or shadow differ from the "
               f"straight run's by {gap} (cuDNN deterministic: must be 0)")
        print(f"phase 20 verb: a SIGTERM to this process in epoch 2 (its "
              f"4th batch) stopped the run after {fwd_b} pyramid launches "
              f"with last.meta.json epoch {meta['epoch']}; the same INI again "
              f"resumed at epoch {meta['epoch']} (0-based) and trained "
              f"{resumed} epochs ({fwd_c} + {bwd_c} launches); its final "
              f"weights and shadow differ from the straight run's by "
              f"{gap:.3g} max-abs (must be 0: cuDNN deterministic); "
              f"val_loss "
              f"{hist_c['val_loss']} vs {hist['val_loss']}", flush=True)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    _verbs_on_shadow(tmp, cfg_b)
    return counts


def phase_train_patchify(tmp: str) -> dict:
    """Phase 20: the train verb with ``patchify`` (OPT_PATCH patches, every
    image's patches in its batch) and, where OpenCV imports, host
    ``augment``; 4 + 4 launches a step on the patch batches."""
    import importlib.util

    augment = importlib.util.find_spec("cv2") is not None
    why = "OpenCV imports" if augment else "no OpenCV on this host"
    print(f"phase 20 patchify: patches of {OPT_PATCH}, augment = "
          f"{int(augment)} ({why})", flush=True)
    cfg = _train_config(tmp, "ResultsPatch", num_epochs=1, patchify=True,
                        patch_width=OPT_PATCH, patch_height=OPT_PATCH,
                        augment=augment)
    run = _run_train_verb("phase 20 patchify", cfg, "train_patchify")
    return {"pyramid": run["pyramid"], "backward": run["backward"],
            "kernels": run["kernels"]}


def _max_err(got, want, what: str) -> float:
    """Bit-exact check of kernel outputs against plain ones (NaN
    positions kept); returns the max-abs error over the finite ones."""
    import torch

    err = 0.0
    for k, p in zip(got, want):
        _check(k.shape == p.shape and k.dtype == p.dtype and
               k.is_contiguous(memory_format=torch.channels_last),
               f"{what}: {k.shape} {k.dtype} vs {p.shape} {p.dtype}")
        _check(torch.equal(k.isnan(), p.isnan()),
               f"{what}: NaN positions differ")
        fin = ~p.isnan()
        e = float((k[fin].float() - p[fin].float()).abs().max()) \
            if bool(fin.any()) else 0.0
        _check(e == 0.0, f"{what}: max-abs {e}")
        err = max(err, e)
    return err


def phase_kernels_1d() -> tuple:
    """Phase 3 for the 1D kernels (csrc/pool1d.cu): the 1D pyramid and
    the 1D pool backward against their plain versions, bit for bit, at
    every call each 1D path makes (FWD_PATHS_1D, BWD_PATHS_1D: config 1's
    shapes in float32, and bfloat16 for the fixed batch), their bf16 twins
    and edge cases, with ReLU plateaus and a NaN (and PLANTS1's values);
    each line names the route (one launch of it) and, for the timed calls,
    the device time of the kernel, the plain version and the library call
    (``F.max_pool1d``, and the backward of
    ``F.max_pool1d(return_indices=True)``), and the bound.  Beside each
    one-channel (deep-supervision) row, the floor: the same
    levels on a (1, 2, 1) mask, and the same kernel on the least mask it
    takes.  Returns ({path: pyramid row}, {path: backward row})."""
    import torch
    import torch.nn.functional as F

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fwd_timed = list(dict.fromkeys(
        [c for cs in FWD_PATHS_1D.values() for c in cs] + FWD1_TWINS))
    bwd_timed = list(dict.fromkeys(
        [c for cs in BWD_PATHS_1D.values() for c in cs] + BWD1_TWINS))
    max_fwd, max_bwd, measured = 0.0, 0.0, {}
    for case in fwd_timed + FWD1_EDGES:
        dtype, shape, levels, wanted = case
        x = _case_input(dtype, shape, gen, plateaus=False,
                        offset=FWD1_OFFSETS.get(case, 0))
        what = (f"maxpool1d_pyramid {dtype} (B, L, C) {tuple(shape)} levels "
                f"{list(wanted)}")
        if case in FWD1_OFFSETS:
            what += f", view {FWD1_OFFSETS[case]} element(s) into its storage"
        kernel = pyramid.route1d(x, levels, wanted)
        _check_route(what, kernel, FWD1_ROUTES.get(case))
        before = dict(pyramid.launches.by_kernel)
        got = pyramid.maxpool1d_pyramid(x, levels, wanted)
        torch.cuda.synchronize()
        _one_launch(what, pyramid.launches, before, kernel)
        want = pyramid.maxpool1d_pyramid_plain(x, levels, wanted)
        max_fwd = max(max_fwd, _max_err(got, want, what))
        for k, p in zip(got, want):
            _check(torch.equal(_bits(k), _bits(p)),
                   f"{what}: bit patterns differ")
        fns = {"plain": lambda: pyramid.maxpool1d_pyramid_plain(x, levels,
                                                                wanted),
               "kernel": lambda: pyramid.maxpool1d_pyramid(x, levels,
                                                           wanted)}
        what += f" [{kernel}]"
        if case not in fwd_timed:
            print(f"phase 3 kernel {what}: equal to plain (max-abs 0, NaN "
                  "kept, bit patterns)", flush=True)
            continue
        x1 = x[:, :, 0]  # the (B, C, L) view F.max_pool1d takes
        fns["library"] = lambda: [F.max_pool1d(x1, 1 << lvl)
                                  for lvl in wanted]
        spread = {}
        t = _timed_turns(fns, flush, spread)
        nbytes = _bytes(x, *got)
        measured[case] = {**t, "bytes": nbytes, "route": kernel}
        line = (f"phase 3 kernel {what}: equal to plain (max-abs 0, NaN "
                f"kept, bit patterns); device time kernel {t['kernel']:.4f} "
                f"ms (turns differ by {spread['kernel']:.4f}), plain "
                f"{t['plain']:.4f} ms, library {len(wanted)} F.max_pool1d "
                f"call(s) {t['library']:.4f} ms, bound "
                f"{_bound_ms(nbytes):.4f} ms ({nbytes} B at 3.35 TB/s)")
        if shape[-1] == 1:
            # a launch with next to nothing to move: the same levels on
            # (1, 2, 1), and the same kernel on the least mask it takes
            least = (1, max(1 << levels, 16 // (4 if dtype == _F32 else 2)),
                     1)
            tiny = {n: _case_input(dtype, n, gen, plateaus=False)
                    for n in ((1, 2, 1), least)}
            floor = _in_turns({n: (lambda a=a: pyramid.maxpool1d_pyramid(
                a, levels)) for n, a in tiny.items()}, flush)
            line += (f"; floor (the same call on (1, 2, 1), "
                     f"{pyramid.route1d(tiny[(1, 2, 1)], levels)}) "
                     f"{floor[(1, 2, 1)]:.4f} ms, the same kernel on "
                     f"{least} {floor[least]:.4f} ms")
        print(line, flush=True)
    for case in bwd_timed + BWD1_EDGES:
        dtype, shape, f = case
        x = _case_input(dtype, shape, gen, plateaus=True,
                        plants=PLANTS1.get(case, ()))
        b, c, _, n = x.shape
        g = torch.randn((b, n // f, c), generator=gen, device="cuda").to(
            "cuda", x.dtype).permute(0, 2, 1).unsqueeze(2)
        what = f"maxpool1d_backward {dtype} (B, L, C) {tuple(shape)} f={f}"
        kernel = pool_backward.route1d(x, g, f)
        _check_route(what, kernel, BWD1_ROUTES.get(case))
        before = dict(pool_backward.launches.by_kernel)
        got = pool_backward.maxpool1d_backward(x, g, f)
        torch.cuda.synchronize()
        _one_launch(what, pool_backward.launches, before, kernel)
        want = pool_backward.maxpool1d_backward_plain(x, g, f)
        _check(torch.equal(_bits(got), _bits(want)),
               f"{what}: differs from plain")
        max_bwd = max(max_bwd, _max_err([got], [want], what))
        what += f" [{kernel}]"
        if case not in bwd_timed:
            print(f"phase 3 kernel {what}: equal to plain (max-abs 0, "
                  "plateaus and a NaN)", flush=True)
            continue
        x1, g1 = x[:, :, 0], g[:, :, 0]
        _, idx = F.max_pool1d(x1, f, return_indices=True)
        t = _timed_turns({
            "plain": lambda: pool_backward.maxpool1d_backward_plain(x, g, f),
            "kernel": lambda: pool_backward.maxpool1d_backward(x, g, f),
            # the backward of F.max_pool1d(return_indices=True), given the
            # indices its forward saved
            "library": lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                g1.unsqueeze(2), x1.unsqueeze(2), [1, f], [1, f], [0, 0],
                [1, 1], False, idx.unsqueeze(2))}, flush, {})
        nbytes = _bytes(x, g, got)
        measured[case] = {**t, "bytes": nbytes, "route": kernel}
        print(f"phase 3 kernel {what}: equal to plain (max-abs 0, plateaus "
              f"and a NaN); device time kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, library max_pool1d's backward "
              f"{t['library']:.4f} ms, bound {_bound_ms(nbytes):.4f} ms "
              f"({nbytes} B at 3.35 TB/s)", flush=True)
    _print_paths("1D pyramid", FWD_PATHS_1D, measured)
    _print_paths("1D pool-backward", BWD_PATHS_1D, measured)
    src = "tf_1d_2d_segmentation_end2endpipelines_torch/csrc/pool1d.cu"
    return ({p: _kernel_row(
        "maxpool1d_pyramid", p, src,
        "tf_1d_2d_segmentation_end2endpipelines_tpu/ops/pallas/pyramid.py:49",
        max_fwd, cases, measured) for p, cases in FWD_PATHS_1D.items()},
        {p: _kernel_row(
            "maxpool1d_backward", p, src,
            "tf_1d_2d_segmentation_end2endpipelines_tpu/ops/blocks.py:467",
            max_bwd, cases, measured) for p, cases in BWD_PATHS_1D.items()})


def _write_signal_sets(tmp: str, scale: float = 1.0) -> dict:
    """Synthetic .pt sets (``synthetic_signals``, seed SEED + 21): 1024
    train, 128 val and 128 test signals of 1024 samples, multiplied by
    ``scale``; returns their paths and the test arrays."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        save_pt, synthetic_signals)

    x, y = synthetic_signals(N_SIG_TRAIN + N_SIG_VAL + N_SIG_TEST, SIG_LEN,
                             seed=SEED + 21)
    x = x * np.float32(scale)
    cuts = {"train": (0, N_SIG_TRAIN),
            "val": (N_SIG_TRAIN, N_SIG_TRAIN + N_SIG_VAL),
            "test": (N_SIG_TRAIN + N_SIG_VAL, len(x))}
    out = {}
    for name, (a, b) in cuts.items():
        out[name] = os.path.join(
            tmp, f"{name}_signals{'' if scale == 1 else f'_x{scale}'}.pt")
        save_pt({"samples": x[a:b], "labels": y[a:b]}, out[name])
    out["x_test"], out["y_test"] = x[cuts["test"][0]:], y[cuts["test"][0]:]
    return out


def _signal_trainer(arch: str, dtype, ds: int = 0, ag: int = 0,
                    width: int = 32, depth: int = 3, generator=None, **kw):
    """Config 1's trainer for ``arch`` at width ``width`` and depth
    ``depth``, weights from SEED (or ``generator``): MeanAbsoluteError (on
    every head, default_ds_weights with ``ds``, the ds_type UNet targets
    built on the card), Adam lr 3e-4; ``kw`` goes to ``model_selector_1d``
    (``lstm``, ``dense_loop``, ``se_ratio``)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import (
        model_selector_1d)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        Trainer, default_ds_weights)

    model = model_selector_1d(
        arch, SIG_LEN, depth, 1, width, 3, ds=ds, ag=ag, dtype=dtype,
        generator=generator or torch.Generator().manual_seed(SEED), **kw)
    return Trainer(model, loss="MeanAbsoluteError", optimizer="Adam",
                   learning_rate=3e-4, device="cuda",
                   loss_weights=default_ds_weights(depth) if ds else None,
                   prepare_targets=(lambda m: prepare_train_dict(
                       m, depth, "UNet", spatial_rank=1)) if ds else None)


def _signal_verbs(phase: str, tmp: str, sets: dict, path: str,
                  model_name: str, **over) -> dict:
    """The 1D verbs through the command line (the card by default) on
    ``model_name`` at config 1's size (``over``: its other INI keys,
    ``model_depth`` among them): ``train1d`` on the synthetic sets for
    SIG_EPOCHS epochs (``path``'s calls a step and a validation batch; the
    loss falls; Signal_Configs.ini, best.pt and history.json written);
    ``test1d`` on the fold (the JAX verb's metric keys, the checkpoint
    restored, the model's calls a batch of 128, the deep-supervision
    targets' pyramid not among them); ``predict1d`` on the test signals,
    its outputs equal to the plain-pool forward of best.pt within 1e-5.
    Returns {"pyramid", "backward"} of the train1d run and ``verb_ms``,
    the verb's step in its last epoch."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers_1d
    from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import main
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        Signal1DConfig, save_signal_config)

    save_dir = os.path.join(tmp, f"Results_1D_{path}")
    cfg = Signal1DConfig(**{
        "train_set": sets["train"], "val_set": sets["val"],
        "test_set": sets["test"], "signal_length": SIG_LEN,
        "num_channel": 1, "model_name": model_name, "model_depth": 3,
        "model_width": 32, "kernel_size": 3, "batch_size": SIG_BATCH,
        "num_epochs": SIG_EPOCHS, "save_dir": save_dir,
        "load_weights": False, "seed": SEED, **over})
    ini = os.path.join(tmp, f"Signal_Configs_{path}.ini")
    save_signal_config(cfg, ini)
    print(f"{phase} signal verbs ({path}): W32/D{cfg.model_depth} "
          f"{model_name} "
          f"{over or ''} on ({SIG_LEN}, 1) signals, float32, "
          f"MeanAbsoluteError, Adam lr {cfg.learning_rate}, batch "
          f"{SIG_BATCH}, {SIG_EPOCHS} epochs of {N_SIG_TRAIN} signals, "
          f"{N_SIG_VAL} val", flush=True)

    def counted(argv):
        pyramid.launches.reset()  # the main path's run starts here
        pool_backward.launches.reset()
        t0 = time.perf_counter()
        main(argv)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, pyramid.launches.value,
                pool_backward.launches.value,
                _kernel_counts())  # ... and ends here

    train_s, fwd, bwd, kernels = counted(["train1d", ini])
    steps = SIG_EPOCHS * -(-N_SIG_TRAIN // SIG_BATCH)
    val = SIG_EPOCHS * -(-N_SIG_VAL // SIG_BATCH)
    n, n_bwd = len(FWD_PATHS_1D[path]), len(BWD_PATHS_1D[path])
    n_eval = len([c for c in FWD_PATHS_1D[path] if c not in _SIG_DS_MASKS])
    _check((fwd, bwd) == (n * (steps + val), n_bwd * steps),
           f"train1d launched {fwd} + {bwd}, not {n} x ({steps} steps + "
           f"{val} val batches) + {n_bwd} x {steps}")
    with open(os.path.join(save_dir, "history.json")) as f:
        hist = json.load(f)
    _check(all(np.isfinite(hist["loss"] + hist["val_loss"])),
           f"non-finite losses {hist}")
    _check(hist["loss"][-1] < hist["loss"][0], f"loss did not fall: {hist}")
    for name in ("Signal_Configs.ini", "best.pt", "history.json"):
        _check(os.path.exists(os.path.join(save_dir, name)),
               f"train1d did not write {name}")
    verb_ms = 1e3 / hist["steps_per_sec"][-1]
    print(f"{phase} train1d ({path}): {train_s:.2f} s; loss {hist['loss']}, "
          f"val_loss {hist['val_loss']}; maxpool1d_pyramid.launches = {fwd} "
          f"= {n} x ({steps} steps + {val} val batches), "
          f"maxpool1d_backward.launches = {bwd} = {n_bwd} x {steps}; the "
          f"verb's last epoch {verb_ms:.3f} ms a step "
          f"({SIG_BATCH * hist['steps_per_sec'][-1]:.1f} signals/s, copies "
          f"included)", flush=True)

    test_s, tfwd, tbwd, _ = counted(["test1d", ini])
    with open(os.path.join(save_dir, "test_metrics_1d.json")) as f:
        metrics = json.load(f)
    batches = -(-N_SIG_TEST // SIG_BATCH)
    _check(tuple(sorted(metrics)) == NILM_KEYS,
           f"test1d keys {sorted(metrics)} != the JAX verb's {NILM_KEYS}")
    _check(metrics["restored_checkpoint"] is True, "best.pt not restored")
    _check(all(np.isfinite(v) for k, v in metrics.items()
               if k != "restored_checkpoint"), f"test1d metrics {metrics}")
    _check((tfwd, tbwd) == (n_eval * batches, 0),
           f"test1d launched {tfwd} + {tbwd}, not {n_eval} x {batches} + 0")
    print(f"{phase} test1d ({path}): {test_s:.2f} s; {metrics}; "
          f"maxpool1d_pyramid.launches = {tfwd} = {n_eval} x {batches} "
          f"batch(es)", flush=True)

    npz = os.path.join(tmp, f"predictions_{path}.npz")
    pred_s, pfwd, _, _ = counted(["predict1d", ini, "--out", npz])
    got = np.load(npz)["output"]
    _check(got.shape == (N_SIG_TEST, SIG_LEN, 1)
           and pfwd == n_eval * batches,
           f"predict1d: {got.shape}, {pfwd} launches")
    model, _ = drivers_1d._restore_model_1d(cfg, "checking", "cuda")
    with mock.patch.object(pyramid, "maxpool1d_pyramid",
                           pyramid.maxpool1d_pyramid_plain):
        plain = Trainer(model, device="cuda").predict(sets["x_test"])["out"]
    err = float(np.abs(got - plain).max())
    _check(err <= 1e-5, f"predict1d vs the plain-pool forward: {err}")
    print(f"{phase} predict1d ({path}): {pred_s:.2f} s; {got.shape} outputs "
          f"within {err:.3g} (<= 1e-5) of best.pt's plain-pool forward; "
          f"maxpool1d_pyramid.launches = {pfwd}", flush=True)
    return {"pyramid": fwd, "backward": bwd, "kernels": kernels,
            "verb_ms": verb_ms}


def phase_signal_verbs(tmp: str) -> dict:
    """Phase 21: the 1D verbs on BASELINE config 1 (``_signal_verbs``: a
    W32/D3 UNet, 3 + 3 launches a step, 3 a validation batch and a test
    batch).  Then config 1's fixed batch of 128 in float32 and bfloat16
    (3 + 3 a step) and with ``d_s = 1`` (one more pyramid launch a step:
    the targets), p50 step and peak memory.  Returns {path: launches}."""
    import torch

    sets = _write_signal_sets(tmp)
    counts = {"config1": _signal_verbs("phase 21", tmp, sets, "config1",
                                       "UNet")}
    x, y = sets["x_test"], sets["y_test"]
    for path, dtype, ds in (("config1", torch.float32, 0),
                            ("config1_bf16", torch.bfloat16, 0),
                            ("config1_ds", torch.float32, 1)):
        trainer = _signal_trainer("UNet", dtype, ds=ds)
        run = _counted_steps("phase 21", path, trainer, trainer.to_device(x),
                             trainer.to_device(y), FIXED_STEPS,
                             must_fall=True, unit="signals")
        if path != "config1":  # config 1's row counts the verb's run
            counts[path] = run
        del trainer
        torch.cuda.empty_cache()
    return counts


def phase_signal_steps() -> dict:
    """Phase 22: the other five 1D archs at config 1's size (W32/D3,
    1024 samples, float32, batch 128 of phase 21's test signals): UNetE,
    UNetP, UNetPP (3 + 3 a step), UNet3+ with ``d_s = 1`` (6 + 6: 3
    encoder pools, one pyramid per pooled skip and the targets' pyramid;
    3 + 2 + 1 backward) and MultiResUNet with ``a_g = 1`` (3 + 3 at 31, 62
    and 124 channels); 10 counted steps each, the loss must fall."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_signals)

    x, y = synthetic_signals(SIG_BATCH, SIG_LEN, seed=SEED + 22)
    counts = {}
    for path, (arch, ds, ag) in SIG_ARCHS.items():
        trainer = _signal_trainer(arch, torch.float32, ds=ds, ag=ag)
        print(f"phase 22 {path}: W32/D3 {arch} ds={ds} ag={ag}, "
              f"{sum(p.numel() for p in trainer.model.parameters())} "
              f"params, float32, batch {SIG_BATCH}", flush=True)
        counts[path] = _counted_steps(
            "phase 22", path, trainer, trainer.to_device(x),
            trainer.to_device(y), SIG_STEPS, must_fall=True, unit="signals")
        del trainer
        torch.cuda.empty_cache()
    return counts


def phase_signal_reference() -> None:
    """Phase 23: phase 17's check on W8/D3 1D models on (2, 256, 1)
    signals, MeanAbsoluteError: UNet3+ with ``d_s = 1`` (6 + 6 launches)
    and MultiResUNet with ``a_g = 1`` (3 + 3), the card's float32 step
    against the CPU's float32 and float64 steps with phase 7's
    tolerances.  As in phase 17, the float64 step is needed: on an H100
    UNet3+'s float32 steps moved 0.5% of its parameters apart beyond 1e-5
    (PERF.md section 6), all of them biases of convolutions that feed a
    training-mode BatchNorm, whose exact gradient is 0 and whose rounding
    Adam's first update scales up to about lr."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import (
        model_selector_1d)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        default_ds_weights, get_loss)

    for arch, ds, ag, want in (("UNet3P", 1, 0, (6, 6)),
                               ("MultiResUNet", 0, 1, (3, 3))):
        cpu = model_selector_1d(arch, 256, 3, 1, 8, 3, ds=ds, ag=ag,
                                generator=torch.Generator().manual_seed(
                                    SEED + 23))
        cpu64 = model_selector_1d(arch, 256, 3, 1, 8, 3, ds=ds, ag=ag,
                                  dtype=torch.float64)
        cpu64.load_state_dict(cpu.state_dict())
        _train_reference(
            "phase 23 1D reference", f"W8/D3 1D {arch}"
            + (" with d_s=1" if ds else "") + (" with a_g=1" if ag else ""),
            cpu, (lambda y: prepare_train_dict(y, 3, "UNet", spatial_rank=1))
            if ds else (lambda y: y), default_ds_weights(3) if ds else None,
            want, cpu64, shape=(2, 256, 1),
            loss=get_loss("MeanAbsoluteError"))


def phase_config5_1d(tmp: str) -> dict:
    """Phase 24: BASELINE config 5's 1D models (CONFIG5_1D) at config 1's
    size (W32/D3, 1024 samples, batch 128 of phase 21's test signals,
    MeanAbsoluteError, Adam): 10 counted fixed-batch steps of each in
    float32 and in bfloat16 (3 + 3 launches a step: every special pools
    its level outputs 32, 64 and 128 wide), BCDUNet with ``d_s = 1`` (4 +
    3: the targets' pyramid), the loss must fall; then the 1D verbs on
    BCDUNet (``lstm = 1``) and NABNet (``_signal_verbs``).  Returns
    {path: launches}."""
    import torch

    sets = _write_signal_sets(tmp)
    x, y = sets["x_test"], sets["y_test"]
    runs = [(p + sfx, arch, dt, 0, kw) for p, (arch, kw) in CONFIG5_1D.items()
            for sfx, dt in (("", torch.float32), ("_bf16", torch.bfloat16))]
    runs.append(("config5_BCDUNet_ds", "BCDUNet", torch.float32, 1,
                 CONFIG5_1D["config5_BCDUNet"][1]))
    counts = {}
    for path, arch, dtype, ds, kw in runs:
        trainer = _signal_trainer(arch, dtype, ds=ds, **kw)
        print(f"phase 24 {path}: W32/D3 {arch} {kw} ds={ds}, "
              f"{sum(p.numel() for p in trainer.model.parameters())} "
              f"params, {str(dtype)[6:]}, batch {SIG_BATCH}", flush=True)
        counts[path] = _counted_steps(
            "phase 24", path, trainer, trainer.to_device(x),
            trainer.to_device(y), SIG_STEPS, must_fall=True, unit="signals")
        del trainer
        torch.cuda.empty_cache()
    for path, model_path in CONFIG5_VERBS.items():
        arch, kw = CONFIG5_1D[model_path]
        counts[path] = _signal_verbs("phase 24", tmp, sets, path, arch, **kw)
    return counts


def phase_config5_1d_reference() -> None:
    """Phase 24's reference: phase 23's check (the card's float32 step
    against the CPU's float32 and float64 steps, phase 7's tolerances) on
    each config 5 1D model at W8/D3 on (2, 256, 1) signals (3 + 3
    launches), and BCDUNet with ``d_s = 1`` (4 + 3)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import (
        model_selector_1d)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        default_ds_weights, get_loss)

    cases = [(arch, kw, 0) for arch, kw in CONFIG5_1D.values()]
    cases.append(("BCDUNet", CONFIG5_1D["config5_BCDUNet"][1], 1))
    for arch, kw, ds in cases:
        cpu = model_selector_1d(arch, 256, 3, 1, 8, 3, ds=ds,
                                generator=torch.Generator().manual_seed(
                                    SEED + 24), **kw)
        cpu64 = model_selector_1d(arch, 256, 3, 1, 8, 3, ds=ds,
                                  dtype=torch.float64, **kw)
        cpu64.load_state_dict(cpu.state_dict())
        _train_reference(
            "phase 24 1D reference", f"W8/D3 1D {arch} {kw}"
            + (" with d_s=1" if ds else ""), cpu,
            (lambda y: prepare_train_dict(y, 3, "UNet", spatial_rank=1))
            if ds else (lambda y: y), default_ds_weights(3) if ds else None,
            (3 + ds, 3), cpu64, shape=(2, 256, 1),
            loss=get_loss("MeanAbsoluteError"))


def _depthwise_ms(model, x) -> tuple:
    """cuDNN's depthwise convolutions in ``model``'s backbone at the
    shapes of a step on ``x`` (each conv's input caught in one forward):
    the device time of each forward (with its SAME padding) and of its
    backward (input and weight gradients), L2 flushed, summed.  Returns
    (forward ms, backward ms, convs)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops import SameConv

    convs = [m for m in getattr(model, model._encoder).modules()
             if isinstance(m, SameConv) and m.groups > 1]
    inputs = {}
    hooks = [m.register_forward_hook(
        lambda m, args, out: inputs.__setitem__(m, args[0].detach()))
        for m in convs]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fwd = bwd = 0.0
    for m in convs:
        xi = inputs[m].requires_grad_()
        y = m(xi)
        g = torch.randn_like(y)
        fwd += _device_ms(lambda: m(xi), flush)
        bwd += _device_ms(lambda: torch.autograd.grad(
            y, (xi, m.weight), g, retain_graph=True), flush)
    return fwd, bwd, len(convs)


def _backbone_stats(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith(f"{model._encoder}.") and "running" in k}


def phase_config5_2d(tmp: str) -> None:
    """Phase 25: BASELINE config 5's 2D model, the W32/D4 UNet on
    EfficientNetB0 (``encoder_weights = none``), bf16, batch 16 of phase
    11's synthetic images at 256x256 scaled to pixel values (the backbone
    divides by 255): 10 counted fixed-batch steps with ``encoder_trainable``
    0 and 1, each launching no pool kernel (0 + 0), the loss must fall,
    the backbone's running statistics unchanged with 0 and moved with 1;
    then the ``train`` verb for one epoch on phase 6's folders (0 + 0,
    best.pt served), ``test`` on phase 12's PNGs and ``predict`` on them
    (0 launches, every pixel counted, a mask per image)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TestConfig)

    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 8)
    x = x * 255.0
    for trainable in (0, 1):
        path = f"config5_EffNetB0_UNet_trainable{trainable}"
        model = SegModel("UNet", 32, 4, output_nums=1,
                         final_activation="sigmoid", dtype=torch.bfloat16,
                         train_mode="pretrained_encoder", backbone=EFFNET,
                         backbone_trainable=bool(trainable),
                         generator=torch.Generator().manual_seed(SEED))
        print(f"phase 25 {path}: W32/D4 UNet on {EFFNET} "
              f"{SIZE}x{SIZE}x3 bf16, encoder_trainable = {trainable}, "
              f"{sum(p.numel() for p in model.parameters())} params, "
              f"BCEDice, Adam lr 1e-4, batch {TRAIN_BATCH}", flush=True)
        trainer = Trainer(model, loss="BCEDiceLoss", optimizer="Adam",
                          learning_rate=1e-4, device="cuda")
        before = _backbone_stats(trainer.model)
        _counted_steps("phase 25", path, trainer, trainer.to_device(x),
                       trainer.to_device(y), EFFNET_STEPS, must_fall=True,
                       calls=(0, 0))
        after = _backbone_stats(trainer.model)
        moved = sum(not torch.equal(before[k], after[k]) for k in before)
        _check(moved == (len(before) if trainable else 0),
               f"{path}: {moved} of the backbone's {len(before)} running "
               f"statistics moved")
        print(f"phase 25 {path}: {moved} of the backbone's {len(before)} "
              f"running statistics moved in training (encoder_trainable = "
              f"{trainable})", flush=True)
        if trainable:
            fwd, bwd, n = _depthwise_ms(trainer.model, trainer.to_device(x))
            print(f"phase 25 {path}: cuDNN's {n} depthwise convolutions "
                  f"(channels_last bf16, batch {TRAIN_BATCH}), device time "
                  f"per step: forward {fwd:.4f} ms, backward {bwd:.4f} ms, "
                  f"{fwd + bwd:.4f} ms together", flush=True)
        del model, trainer
        torch.cuda.empty_cache()

    cfg = _train_config(tmp, "ResultsEffNet", decoder_name="UNet",
                        encoder_mode="pretrained_encoder",
                        encoder_name=EFFNET, encoder_weights="none",
                        encoder_trainable=False, normalizing_factor_img=1.0,
                        num_epochs=1)
    print(f"phase 25 verbs: W32/D4 UNet on {EFFNET} bf16, encoder_weights = "
          f"none, encoder_trainable = 0, pixel-valued inputs, BCEDice, "
          f"Adam lr {cfg.learning_rate}, batch {TRAIN_BATCH}, 1 epoch",
          flush=True)
    _run_train_verb("phase 25 verbs", cfg, "config5_EffNetB0_UNet",
                    calls=(0, 0))
    test = TestConfig(test_dir=os.path.join(tmp, "Data", "Test"),
                      imheight=SIZE, imwidth=SIZE, batch_size=TEST_BATCH,
                      threshold=THRESHOLD, normalizing_factor_img=1.0,
                      save_dir=cfg.save_dir)
    pyramid.launches.reset()  # the main path's run starts here
    pool_backward.launches.reset()
    t0 = time.perf_counter()
    rep = drivers.test(config=test, device="cuda")[1]
    masks = drivers.predict(cfg, input_path=os.path.join(test.test_dir,
                                                         "images"),
                            out_dir=os.path.join(tmp, "EffNetMasks"),
                            batch=TEST_BATCH, device="cuda")
    verbs_s = time.perf_counter() - t0
    launches = (pyramid.launches.value,
                pool_backward.launches.value)  # ... and ends here
    cm = rep["confusion_matrix"]
    _check(rep["checkpoint_restored"] is True, "best.pt not restored")
    _check(int(cm.sum()) == N_TEST * SIZE * SIZE,
           f"confusion matrix counts {int(cm.sum())} pixels")
    _check(len(masks) == N_TEST, f"predict wrote {len(masks)} masks")
    _check(launches == (0, 0), f"test and predict launched {launches}")
    print(f"phase 25 verbs: drivers.test and drivers.predict in "
          f"{verbs_s:.2f} s; test {rep['images_per_sec']:.1f} img/s, "
          f"confusion matrix {cm.astype(np.int64).tolist()} ({int(cm.sum())} "
          f"pixels); {len(masks)} masks; pool launches {launches}",
          flush=True)


def _calibrate_backbone(model, shape: tuple, x=None) -> None:
    """Set the running statistics of ``model``'s backbone to those of one
    uniform batch of ``shape`` (or of the NHWC batch ``x``, on the model's
    device), as a pretrained backbone's describe its inputs.  With its initial ones (mean 0, variance 1) a frozen
    backbone's BatchNorms do not normalize: its activations and gradients
    grow through its blocks (BatchNorm bias gradients near 60 at W8/D3),
    and float32 rounds them by more than phase 7's absolute bars (the
    CPU's own float32 step 1.4e-4 from its float64 step, an H100's
    2e-4)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops import BatchNorm

    bb = getattr(model, model._encoder)
    bns = [m for m in bb.modules() if isinstance(m, BatchNorm)]
    if x is None:
        x = torch.from_numpy(np.random.default_rng(SEED + 26).uniform(
            size=shape).astype(np.float32))
    for m in bns:
        m.momentum = 0.0  # the running statistics become the batch's
    torch.nn.Module.train(bb)  # past a frozen backbone's eval mode
    with torch.no_grad():
        bb(x.permute(0, 3, 1, 2).to(model.dtype).contiguous(
            memory_format=torch.channels_last))
    for m in bns:
        m.momentum = 0.99
    bb.train(False)


def phase_config5_2d_reference() -> None:
    """Phase 25's reference: phase 17's check (the card's float32 step
    against the CPU's float32 and float64 steps, phase 7's tolerances) on
    a W8/D3 UNet on EfficientNetB0 on (2, 64, 64, 3), no pool launches,
    with ``encoder_trainable`` 0 and 1, the backbone's statistics
    calibrated on one batch (``_calibrate_backbone``).  The inputs are
    uniform in [0, 1) as every reference phase's."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel

    for trainable in (0, 1):
        kw = dict(output_nums=1, train_mode="pretrained_encoder",
                  backbone=EFFNET, backbone_trainable=bool(trainable))
        cpu = SegModel("UNet", 8, 3, **kw,
                       generator=torch.Generator().manual_seed(SEED + 25))
        _calibrate_backbone(cpu, (2, 64, 64, 3))
        cpu64 = SegModel("UNet", 8, 3, **kw, dtype=torch.float64)
        cpu64.load_state_dict(cpu.state_dict())
        _train_reference("phase 25 reference", f"W8/D3 UNet on {EFFNET} "
                         f"with encoder_trainable = {trainable}", cpu,
                         lambda y: y, None, (0, 0), cpu64,
                         shape=(2, 64, 64, 3))


def phase_zoo_1d(tmp: str) -> dict:
    """Phase 26: the rest of the 1D zoo (ZOO_1D) at config 1's size
    (W32/D3, 1024 samples, batch 128 of phase 21's test signals,
    MeanAbsoluteError, Adam): 10 counted fixed-batch steps of each arch
    in float32, R2UNet, ConvMixerUNet and MultiResUNet3P in bfloat16,
    UNet++ with ``lstm = 1``, UNet and BCDUNet with ``ae = 1`` and
    R2UNet3P with ``d_s = 1``, the loss must fall, each path's exact
    launches a step (``_zoo_calls``); then the 1D verbs on R2UNet with
    ``lstm = 1`` and on MultiResUNet3P (``_signal_verbs``).  Returns
    {path: launches}."""
    import torch

    sets = _write_signal_sets(tmp)
    x, y = sets["x_test"], sets["y_test"]
    counts = {}
    for path, (arch, kw) in ZOO_1D.items():
        kw = dict(kw)
        ds = kw.pop("ds", 0)
        dtype = torch.bfloat16 if path.endswith("_bf16") else torch.float32
        trainer = _signal_trainer(arch, dtype, ds=ds, **kw)
        print(f"phase 26 {path}: W32/D3 {arch} {kw} ds={ds}, "
              f"{sum(p.numel() for p in trainer.model.parameters())} "
              f"params, {str(dtype)[6:]}, batch {SIG_BATCH}", flush=True)
        counts[path] = _counted_steps(
            "phase 26", path, trainer, trainer.to_device(x),
            trainer.to_device(y), SIG_STEPS, must_fall=True, unit="signals")
        del trainer
        torch.cuda.empty_cache()
    for path, (arch, over) in ZOO_1D_VERBS.items():
        counts[path] = _signal_verbs("phase 26", tmp, sets, path, arch, **over)
    return counts


def phase_zoo_1d_reference() -> None:
    """Phase 26's reference: phase 23's check (the card's float32 step
    against the CPU's float32 and float64 steps) with the bfloat16
    control of ``_train_reference`` (the unmasked forward, the CPU steps
    on the card's ReLU masks, the gradients held to RELATIVE_BAR of
    their size) on each float32 model of ZOO_1D at W8/D3 on (2, 256, 1)
    signals, its path's launches a step."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import (
        model_selector_1d)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        default_ds_weights, get_loss)

    for path, (arch, kw) in ZOO_1D.items():
        if path.endswith("_bf16"):
            continue
        kw = dict(kw)
        ds = kw.pop("ds", 0)
        cpu = model_selector_1d(arch, 256, 3, 1, 8, 3, ds=ds,
                                generator=torch.Generator().manual_seed(
                                    SEED + 26), **kw)
        cpu64 = model_selector_1d(arch, 256, 3, 1, 8, 3, ds=ds,
                                  dtype=torch.float64, **kw)
        cpu64.load_state_dict(cpu.state_dict())
        control = model_selector_1d(arch, 256, 3, 1, 8, 3, ds=ds,
                                    dtype=torch.bfloat16, **kw)
        control.load_state_dict(cpu.state_dict())
        _train_reference(
            "phase 26 1D reference", f"W8/D3 1D {arch} {kw}"
            + (" with d_s=1" if ds else ""), cpu,
            (lambda y: prepare_train_dict(y, 3, "UNet", spatial_rank=1))
            if ds else (lambda y: y), default_ds_weights(3) if ds else None,
            (len(FWD_PATHS_1D[path]), len(BWD_PATHS_1D[path])), cpu64,
            shape=(2, 256, 1), loss=get_loss("MeanAbsoluteError"),
            control=control)


def phase_lstm_ae_2d(tmp: str) -> dict:
    """Phase 27: ConvLSTM fusion and the autoencoder bottleneck in 2D at
    the flagship's size (LSTM_AE_2D: UNet++ and KSSNet with ``lstm = 1,
    a_g = 1``, UNet with ``ae = 1``: its bottleneck's two Dense layers
    hold 2 x 131072 x 1024 parameters), bf16, batch 16 of phase 11's
    images, 10 counted steps each (UNet++ and UNet 4 + 4 launches a step,
    KSSNet 8 + 14), the loss must fall, the peak memory printed; then the
    ``train`` verb for one epoch on phase 6's folders with UNet++ and
    ``lstm = 1`` (4 + 4 a step, best.pt served), ``test`` and ``predict``
    on phase 12's PNGs (4 launches a batch and predict's warm-up batch,
    every pixel counted, a mask per image).  Returns {path: launches}."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TestConfig)

    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 8)
    counts = {}
    for path, (dec, kw) in LSTM_AE_2D.items():
        model = SegModel(dec, 32, 4, output_nums=1,
                         final_activation="sigmoid", dtype=torch.bfloat16,
                         input_size=(SIZE, SIZE),
                         generator=torch.Generator().manual_seed(SEED),
                         **kw)
        print(f"phase 27 {path}: W32/D4 {dec} {kw} {SIZE}x{SIZE}x3 bf16, "
              f"{sum(p.numel() for p in model.parameters())} params, "
              f"BCEDice, Adam lr 1e-4, batch {TRAIN_BATCH}", flush=True)
        trainer = Trainer(model, loss="BCEDiceLoss", optimizer="Adam",
                          learning_rate=1e-4, device="cuda")
        counts[path] = _counted_steps(
            "phase 27", path, trainer, trainer.to_device(x),
            trainer.to_device(y), CONFIG4_STEPS, must_fall=True)
        del model, trainer
        torch.cuda.empty_cache()

    cfg = _train_config(tmp, "ResultsLSTM", lstm=1, num_epochs=1)
    print(f"phase 27 verbs: W32/D4 UNet++ lstm = 1 bf16, BCEDice, Adam lr "
          f"{cfg.learning_rate}, batch {TRAIN_BATCH}, 1 epoch", flush=True)
    counts["train_lstm"] = _run_train_verb("phase 27 verbs", cfg,
                                           "train_lstm")
    test = TestConfig(test_dir=os.path.join(tmp, "Data", "Test"),
                      imheight=SIZE, imwidth=SIZE, batch_size=TEST_BATCH,
                      threshold=THRESHOLD, save_dir=cfg.save_dir)
    batches = -(-N_TEST // TEST_BATCH)
    _reset_counts()  # the main path's run starts here
    t0 = time.perf_counter()
    rep = drivers.test(config=test, device="cuda")[1]
    tested = pyramid.launches.value
    masks = drivers.predict(cfg, input_path=os.path.join(test.test_dir,
                                                         "images"),
                            out_dir=os.path.join(tmp, "LSTMMasks"),
                            batch=TEST_BATCH, device="cuda")
    verbs_s = time.perf_counter() - t0
    predicted = pyramid.launches.value - tested  # ... and ends here
    cm = rep["confusion_matrix"]
    _check(rep["checkpoint_restored"] is True, "best.pt not restored")
    _check(int(cm.sum()) == N_TEST * SIZE * SIZE,
           f"confusion matrix counts {int(cm.sum())} pixels")
    _check(len(masks) == N_TEST, f"predict wrote {len(masks)} masks")
    _check((tested, predicted) == (4 * batches, 4 * (batches + 1)),
           f"test and predict launched {tested} and {predicted}, not 4 x "
           f"{batches} batches and 4 x ({batches} + a warm-up one)")
    print(f"phase 27 verbs: drivers.test and drivers.predict in "
          f"{verbs_s:.2f} s; test {rep['images_per_sec']:.1f} img/s, "
          f"confusion matrix {cm.astype(np.int64).tolist()} ({int(cm.sum())} "
          f"pixels); {len(masks)} masks; maxpool_pyramid.launches = "
          f"{tested} + {predicted} = 4 x {batches} batches + 4 x ({batches} "
          f"+ predict's warm-up one)", flush=True)
    return counts


def phase_lstm_ae_2d_reference() -> None:
    """Phase 27's reference: phase 17's check (the card's float32 step
    against the CPU's float32 and float64 steps, with the bfloat16
    control, as in phase 26) on each LSTM_AE_2D model at
    W8/D3 on (2, 64, 64, 3): UNet++ and UNet 3 + 3 launches, KSSNet 6 +
    9."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel

    for dec, kw in LSTM_AE_2D.values():
        cpu = SegModel(dec, 8, 3, input_size=(64, 64),
                       generator=torch.Generator().manual_seed(SEED + 27),
                       **kw)
        cpu64 = SegModel(dec, 8, 3, input_size=(64, 64),
                         dtype=torch.float64, **kw)
        cpu64.load_state_dict(cpu.state_dict())
        control = SegModel(dec, 8, 3, input_size=(64, 64),
                           dtype=torch.bfloat16, **kw)
        control.load_state_dict(cpu.state_dict())
        _train_reference("phase 27 reference", f"W8/D3 {dec} {kw}", cpu,
                         lambda y: y, None,
                         (6, 9) if dec == "KSSNet" else (3, 3), cpu64,
                         control=control)


def phase_self_2d(tmp: str) -> dict:
    """Phase 28: the Self-ONN family and the FPN genre in 2D at the
    flagship's size (SELF_2D: SelfUNet, SelfUNetPP, SelfUNet3P with and
    without ``d_s = 1``, SelfFPN and FPN; W32/D4, q = 3), bf16, batch 16
    of phase 11's images times SELF_2D_SCALE, 10 counted steps each (4 +
    4 launches a step; SelfUNet3P 7 + 10, with ``d_s = 1`` 8 + 10), the
    loss must fall, the peak memory printed; SelfFPN and SelfUNet on
    EfficientNetB0 (SELF_2D_B0, ``encoder_trainable = 0``), 0 + 0; then
    the ``train`` verb for one
    epoch on phase 6's folders with SelfUNetPP (4 + 4 a step, best.pt
    served 4 PNG requests), ``test`` and ``predict`` on phase 12's PNGs
    (4 launches a batch and predict's warm-up batch, every pixel counted,
    a mask per image), the PNGs read with ``normalizing_factor_img = 255
    / SELF_2D_SCALE``.  Returns {path: launches}."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict, synthetic_images)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        Trainer, default_ds_weights)
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TestConfig)

    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 8)
    counts = {}
    runs = [(p, dec, genre, kw) for p, (dec, genre, kw) in SELF_2D.items()]
    runs += [(p, dec, genre, dict(train_mode="pretrained_encoder",
                                  backbone=EFFNET))
             for p, (dec, genre) in SELF_2D_B0.items()]
    for path, dec, genre, kw in runs:
        kw = dict(kw)
        ds = kw.pop("ds", 0)
        b0 = path in SELF_2D_B0
        model = SegModel(dec, 32, 4, output_nums=1, ds=ds, genre=genre,
                         final_activation="sigmoid", dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(SEED), **kw)
        print(f"phase 28 {path}: W32/D4 {dec} genre {genre}"
              f"{' on ' + EFFNET if b0 else ''}{' d_s=1' if ds else ''} "
              f"q=3 {SIZE}x{SIZE}x3 bf16, "
              f"{sum(p.numel() for p in model.parameters())} params, "
              f"BCEDice, Adam lr 1e-4, batch {TRAIN_BATCH}", flush=True)
        trainer = Trainer(
            model, loss="BCEDiceLoss", optimizer="Adam", learning_rate=1e-4,
            device="cuda", loss_weights=default_ds_weights(4) if ds else None,
            prepare_targets=(lambda m: prepare_train_dict(m, 4, "UNet"))
            if ds else None)
        run = _counted_steps(
            "phase 28", path, trainer,
            trainer.to_device(x * np.float32(
                SELF_2D_SCALE * (255.0 if b0 else 1.0))),
            trainer.to_device(y),
            EFFNET_STEPS if b0 else CONFIG4_STEPS, must_fall=True,
            calls=(0, 0) if b0 else None)
        if not b0:
            counts[path] = run
        del model, trainer
        torch.cuda.empty_cache()

    factor = 255.0 / SELF_2D_SCALE
    cfg = _train_config(tmp, "ResultsSelf", decoder_name="SelfUNetPP",
                        num_epochs=1, normalizing_factor_img=factor)
    print(f"phase 28 verbs: W32/D4 SelfUNetPP q=3 bf16, BCEDice, Adam lr "
          f"{cfg.learning_rate}, batch {TRAIN_BATCH}, 1 epoch", flush=True)
    counts["train_self"] = _run_train_verb("phase 28 verbs", cfg,
                                           "train_self", requests=4)
    test = TestConfig(test_dir=os.path.join(tmp, "Data", "Test"),
                      imheight=SIZE, imwidth=SIZE, batch_size=TEST_BATCH,
                      threshold=THRESHOLD, save_dir=cfg.save_dir,
                      normalizing_factor_img=factor)
    batches = -(-N_TEST // TEST_BATCH)
    _reset_counts()  # the main path's run starts here
    t0 = time.perf_counter()
    rep = drivers.test(config=test, device="cuda")[1]
    tested = pyramid.launches.value
    masks = drivers.predict(cfg, input_path=os.path.join(test.test_dir,
                                                         "images"),
                            out_dir=os.path.join(tmp, "SelfMasks"),
                            batch=TEST_BATCH, device="cuda")
    verbs_s = time.perf_counter() - t0
    predicted = pyramid.launches.value - tested  # ... and ends here
    cm = rep["confusion_matrix"]
    _check(rep["checkpoint_restored"] is True, "best.pt not restored")
    _check(int(cm.sum()) == N_TEST * SIZE * SIZE,
           f"confusion matrix counts {int(cm.sum())} pixels")
    _check(len(masks) == N_TEST, f"predict wrote {len(masks)} masks")
    _check((tested, predicted) == (4 * batches, 4 * (batches + 1)),
           f"test and predict launched {tested} and {predicted}, not 4 x "
           f"{batches} batches and 4 x ({batches} + a warm-up one)")
    print(f"phase 28 verbs: drivers.test and drivers.predict in "
          f"{verbs_s:.2f} s; test {rep['images_per_sec']:.1f} img/s, "
          f"confusion matrix {cm.astype(np.int64).tolist()} ({int(cm.sum())} "
          f"pixels); {len(masks)} masks; maxpool_pyramid.launches = "
          f"{tested} + {predicted} = 4 x {batches} batches + 4 x ({batches} "
          f"+ predict's warm-up one)", flush=True)
    return counts


def phase_self_2d_reference() -> None:
    """Phase 28's reference: phase 26's check (the card's float32 step
    against the CPU's float32 and float64 steps, the bfloat16 control) on
    each SELF_2D model at W8/D3 on (2, 64, 64, 3) (uniform times
    SELF_2D_SCALE): 3 + 3 launches, SelfUNet3P 5 + 6 (6 + 6 with ``d_s =
    1``: the targets' pyramid).  With ``d_s = 1`` the heads (1-filter
    Opers of the decoder) are scaled to give values near 0.5, as phase
    10's: BCEDice clips a head's raw value to [1e-7, 1 - 1e-7], and a
    value that rounding moves across a clip edge gains or loses its whole
    gradient (the CPU's own float32 step was 3.3e-3 of the largest
    gradient off its float64 step with the heads as drawn)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops import Oper
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        default_ds_weights)

    for dec, genre, kw in SELF_2D.values():
        kw = dict(kw, genre=genre)
        ds = kw.get("ds", 0)
        cpu = SegModel(dec, 8, 3, generator=torch.Generator().manual_seed(
            SEED + 28), **kw)
        with torch.no_grad():
            for m in getattr(cpu, cpu._decoder_name).modules():
                if isinstance(m, Oper) and m.onn_conv.out_channels == 1:
                    m.onn_conv.weight.mul_(0.01)
                    m.onn_conv.bias.fill_(0.5)
        cpu64 = SegModel(dec, 8, 3, dtype=torch.float64, **kw)
        cpu64.load_state_dict(cpu.state_dict())
        control = SegModel(dec, 8, 3, dtype=torch.bfloat16, **kw)
        control.load_state_dict(cpu.state_dict())
        want = ((6 if ds else 5, 6) if dec == "SelfUNet3P" else (3, 3))
        _train_reference(
            "phase 28 reference", f"W8/D3 {dec} genre {genre}"
            + (" with d_s=1" if ds else ""), cpu,
            (lambda y: prepare_train_dict(y, 3, "UNet")) if ds
            else (lambda y: y), default_ds_weights(3) if ds else None,
            want, cpu64, control=control, x_scale=SELF_2D_SCALE)


def phase_self_1d(tmp: str) -> dict:
    """Phase 29: the 1D Self-ONN archs at config 1's size (SELF_1D:
    SelfR2UNetPP, SelfUNetPP, SelfUNet3P with and without ``d_s = 1``;
    W32/D3, q = 3, float32, batch 128) on config 1's signals times
    SELF_1D_SCALE, 20 counted steps each (3 + 3 launches a step;
    SelfUNet3P 5 + 6, with ``d_s = 1`` 6 + 6), the loss must fall; then
    the 1D verbs on SelfUNetPP (``_signal_verbs`` on the scaled sets).
    Returns {path: launches}."""
    import torch

    sets = _write_signal_sets(tmp, scale=SELF_1D_SCALE)
    x, y = sets["x_test"], sets["y_test"]
    counts = {}
    for path, (arch, kw) in SELF_1D.items():
        kw = dict(kw)
        ds = kw.pop("ds", 0)
        trainer = _signal_trainer(arch, torch.float32, ds=ds, **kw)
        print(f"phase 29 {path}: W32/D3 {arch} ds={ds} q=3, "
              f"{sum(p.numel() for p in trainer.model.parameters())} "
              f"params, float32, batch {SIG_BATCH}, signals times "
              f"{SELF_1D_SCALE}", flush=True)
        counts[path] = _counted_steps(
            "phase 29", path, trainer, trainer.to_device(x),
            trainer.to_device(y), SELF_1D_STEPS, must_fall=True,
            unit="signals")
        del trainer
        torch.cuda.empty_cache()
    for path, (arch, over) in SELF_1D_VERBS.items():
        counts[path] = _signal_verbs("phase 29", tmp, sets, path, arch, **over)
    return counts


def phase_self_1d_reference() -> None:
    """Phase 29's reference: phase 26's check on each SELF_1D model at
    W8/D3 on (2, 256, 1) signals (uniform times SELF_1D_SCALE),
    MeanAbsoluteError: 3 + 3 launches, SelfUNet3P 5 + 6 (6 + 6 with
    ``d_s = 1``)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import (
        model_selector_1d)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        default_ds_weights, get_loss)

    for path, (arch, kw) in SELF_1D.items():
        kw = dict(kw)
        ds = kw.pop("ds", 0)
        cpu = model_selector_1d(arch, 256, 3, 1, 8, 3, ds=ds,
                                generator=torch.Generator().manual_seed(
                                    SEED + 29), **kw)
        cpu64 = model_selector_1d(arch, 256, 3, 1, 8, 3, ds=ds,
                                  dtype=torch.float64, **kw)
        cpu64.load_state_dict(cpu.state_dict())
        control = model_selector_1d(arch, 256, 3, 1, 8, 3, ds=ds,
                                    dtype=torch.bfloat16, **kw)
        control.load_state_dict(cpu.state_dict())
        _train_reference(
            "phase 29 1D reference", f"W8/D3 1D {arch}"
            + (" with d_s=1" if ds else ""), cpu,
            (lambda y: prepare_train_dict(y, 3, "UNet", spatial_rank=1))
            if ds else (lambda y: y), default_ds_weights(3) if ds else None,
            (len(FWD_PATHS_1D[path]), len(BWD_PATHS_1D[path])), cpu64,
            shape=(2, 256, 1), loss=get_loss("MeanAbsoluteError"),
            control=control, x_scale=SELF_1D_SCALE)


def _dropped_share(model) -> str:
    """The share each DropBlock of ``model`` dropped in its last training
    forward, as text."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops import DropBlock

    shares = [1.0 - float(m.kept) for m in model.modules()
              if isinstance(m, DropBlock) and m.kept is not None]
    return (f"{len(shares)} DropBlocks dropped {min(shares):.4f}-"
            f"{max(shares):.4f} of their inputs (mean "
            f"{sum(shares) / len(shares):.4f}; keep_prob 0.9)")


def phase_zoo_1d_specials(tmp: str) -> dict:
    """Phase 30: the last 1D special families (ZOO_1D_SPECIALS) at config
    1's size (W32, D3 where the family takes a depth, 1024 samples, batch
    128 of phase 21's test signals, float32, MeanAbsoluteError, Adam):
    SPECIALS_LONG take SPECIALS_LONG_STEPS counted fixed-batch steps and
    their loss
    must fall, the others SPECIALS_SHORT_STEPS; each path's exact
    launches a step (``_special_calls``); the SAUNet family draws its
    DropBlocks (keep_prob 0.9) from the trainer's stream on the card,
    and the share they dropped is printed; then the 1D verbs on SAUNet
    and on LinkNetPP with ``d_s = 1`` (``_signal_verbs``).  Returns
    {path: launches}."""
    import torch

    sets = _write_signal_sets(tmp)
    x, y = sets["x_test"], sets["y_test"]
    counts = {}
    for path, (arch, kw) in ZOO_1D_SPECIALS.items():
        trainer = _signal_trainer(arch, torch.float32, **kw)
        long = arch in SPECIALS_LONG
        print(f"phase 30 {path}: W32/D3 {arch}, "
              f"{sum(p.numel() for p in trainer.model.parameters())} "
              f"params, float32, batch {SIG_BATCH}", flush=True)
        counts[path] = _counted_steps(
            "phase 30", path, trainer, trainer.to_device(x),
            trainer.to_device(y),
            SPECIALS_LONG_STEPS if long else SPECIALS_SHORT_STEPS,
            must_fall=long, unit="signals")
        if arch in ("SAUNet", "SAMultiResUNet", "SelfSAUNet"):
            print(f"phase 30 {path}: {_dropped_share(trainer.model)}",
                  flush=True)
        del trainer
        torch.cuda.empty_cache()
    for path, (arch, over) in ZOO_1D_SPECIALS_VERBS.items():
        counts[path] = _signal_verbs("phase 30", tmp, sets, path, arch, **over)
    return counts


def phase_zoo_1d_specials_reference() -> None:
    """Phase 30's reference: phase 26's check (the card's float32 step
    against the CPU's float32 and float64 steps on the card's ReLU masks,
    RELATIVE_BAR, the bfloat16 control) on each SPECIALS_LONG model at
    W8/D3 on (2, 256, 1) signals (SPECIALS_REF_LEN: Dense_Inception_UNet's
    are 128 long), its path's launches a step; the
    SAUNet family's DropBlocks drop the card's draws in every step
    (``_replay_card_draws``)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import (
        model_selector_1d)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import get_loss

    for arch in SPECIALS_LONG:
        path = f"1d_special_{arch}"
        n = SPECIALS_REF_LEN.get(arch, 256)
        cpu = model_selector_1d(arch, n, 3, 1, 8, 3,
                                generator=torch.Generator().manual_seed(
                                    SEED + 30))
        cpu64 = model_selector_1d(arch, n, 3, 1, 8, 3, dtype=torch.float64)
        cpu64.load_state_dict(cpu.state_dict())
        control = model_selector_1d(arch, n, 3, 1, 8, 3,
                                    dtype=torch.bfloat16)
        control.load_state_dict(cpu.state_dict())
        _train_reference(
            "phase 30 1D reference", f"W8/D3 1D {arch}", cpu, lambda y: y,
            None, (len(FWD_PATHS_1D[path]), len(BWD_PATHS_1D[path])), cpu64,
            shape=(2, n, 1), loss=get_loss("MeanAbsoluteError"),
            control=control)


def phase_deep_1d(tmp: str) -> dict:
    """Phase 33: the 1D models that pool by 32 (DEEP_1D: UNet3P,
    R2UNet3P, SelfUNet3P, ConvMixerUNet3P and MLMRSNet_V2 at depth 6,
    UNet4P at depth 7) at config 1's size and width (W32, 1024 samples,
    batch 128 of phase 21's test signals, float32, MeanAbsoluteError,
    Adam; built on the card, ``_built_on_card``), DEEP_STEPS counted
    fixed-batch steps each, the loss falling,
    exactly each path's launches a step (``_deep_calls``); SelfUNet3P on
    the signals times SELF_1D_SCALE for SELF_1D_STEPS, as phase 29.  Then the 1D verbs on
    UNet3P at depth 5 with ``d_s = 1`` (DEEP_1D_VERBS: its targets pool
    the mask by 2 .. 32).  Returns {path: launches}."""
    import torch

    sets = _write_signal_sets(tmp)
    x, y = sets["x_test"], sets["y_test"]
    counts = {}
    for path, (arch, depth) in DEEP_1D.items():
        self_onn = arch.startswith("Self")
        scale = SELF_1D_SCALE if self_onn else 1.0
        trainer = _built_on_card(lambda g: _signal_trainer(
            arch, torch.float32, depth=depth, generator=g))
        print(f"phase 33 {path}: W32/D{depth} {arch}, "
              f"{sum(p.numel() for p in trainer.model.parameters())} "
              f"params, float32, batch {SIG_BATCH}"
              + (f", signals times {scale}" if scale != 1.0 else ""),
              flush=True)
        xs = trainer.to_device(x * np.float32(scale))
        counts[path] = _counted_steps(
            "phase 33", path, trainer, xs, trainer.to_device(y),
            SELF_1D_STEPS if self_onn else DEEP_STEPS, must_fall=True,
            unit="signals")
        del trainer
        torch.cuda.empty_cache()
    for path, (arch, depth, over) in DEEP_1D_VERBS.items():
        counts[path] = _signal_verbs("phase 33", tmp, sets, path, arch,
                                     model_depth=depth, **over)
    return counts


def phase_deep_1d_reference() -> None:
    """Phase 33's reference: phase 26's check (the card's float32 step
    against the CPU's float32 and float64 steps on the card's ReLU masks,
    RELATIVE_BAR, the bfloat16 control) on UNet3P at W8/D6 on (2, 256, 1)
    signals, whose skip 0 is pooled by 2 .. 32: 11 + 21 launches."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import (
        model_selector_1d)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import get_loss

    path = "1d_deep_UNet3P_D6"
    arch, depth = DEEP_1D[path]
    cpu = model_selector_1d(arch, 256, depth, 1, 8, 3,
                            generator=torch.Generator().manual_seed(SEED + 33))
    cpu64 = model_selector_1d(arch, 256, depth, 1, 8, 3, dtype=torch.float64)
    cpu64.load_state_dict(cpu.state_dict())
    control = model_selector_1d(arch, 256, depth, 1, 8, 3,
                                dtype=torch.bfloat16)
    control.load_state_dict(cpu.state_dict())
    _train_reference(
        "phase 33 1D reference", f"W8/D{depth} 1D {arch}", cpu, lambda y: y,
        None, (len(FWD_PATHS_1D[path]), len(BWD_PATHS_1D[path])), cpu64,
        shape=(2, 256, 1), loss=get_loss("MeanAbsoluteError"),
        control=control)


def _model_steps(phase: str, path: str, model, x, y, steps: int,
                 what: str, must_fall: bool = True,
                 calls: "tuple | None" = None):
    """``steps`` counted fixed-batch steps of ``model`` (BCEDice, Adam lr
    1e-4, on the card) on the NHWC batch ``x`` and mask ``y``, exactly
    ``path``'s pool launches a step (or ``calls``); returns (the run,
    the trainer)."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer

    print(f"{phase} {path}: {what}, "
          f"{sum(p.numel() for p in model.parameters())} params, BCEDice, "
          f"Adam lr 1e-4, batch {x.shape[0]}", flush=True)
    trainer = Trainer(model, loss="BCEDiceLoss", optimizer="Adam",
                      learning_rate=1e-4, device="cuda")
    run = _counted_steps(phase, path, trainer, trainer.to_device(x),
                         trainer.to_device(y), steps, must_fall=must_fall,
                         calls=calls)
    return run, trainer


def _verbs_test_predict(phase: str, tmp: str, cfg, per_batch: int,
                        factor: float = 255.0) -> None:
    """``test`` and ``predict`` on phase 12's PNGs with the fold ``cfg``
    trained: best.pt restored, every pixel counted, a mask an image,
    ``per_batch`` pyramid launches a batch (predict's warm-up batch
    too)."""
    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TestConfig)

    test = TestConfig(test_dir=os.path.join(tmp, "Data", "Test"),
                      imheight=SIZE, imwidth=SIZE, batch_size=TEST_BATCH,
                      threshold=THRESHOLD, save_dir=cfg.save_dir,
                      normalizing_factor_img=factor)
    batches = -(-N_TEST // TEST_BATCH)
    _reset_counts()  # the main path's run starts here
    t0 = time.perf_counter()
    rep = drivers.test(config=test, device="cuda")[1]
    tested = pyramid.launches.value
    masks = drivers.predict(cfg, input_path=os.path.join(test.test_dir,
                                                         "images"),
                            out_dir=os.path.join(cfg.save_dir, "masks"),
                            batch=TEST_BATCH, device="cuda")
    verbs_s = time.perf_counter() - t0
    predicted = pyramid.launches.value - tested  # ... and ends here
    cm = rep["confusion_matrix"]
    _check(rep["checkpoint_restored"] is True, "best.pt not restored")
    _check(int(cm.sum()) == N_TEST * SIZE * SIZE,
           f"confusion matrix counts {int(cm.sum())} pixels")
    _check(len(masks) == N_TEST, f"predict wrote {len(masks)} masks")
    _check((tested, predicted) == (per_batch * batches,
                                   per_batch * (batches + 1)),
           f"test and predict launched {tested} and {predicted}, not "
           f"{per_batch} x {batches} batches and {per_batch} x ({batches} "
           f"+ a warm-up one)")
    print(f"{phase}: drivers.test and drivers.predict in {verbs_s:.2f} s; "
          f"test {rep['images_per_sec']:.1f} img/s, confusion matrix "
          f"{cm.astype(np.int64).tolist()} ({int(cm.sum())} pixels); "
          f"{len(masks)} masks; maxpool_pyramid.launches = {tested} + "
          f"{predicted} = {per_batch} x {batches} batches + {per_batch} x "
          f"({batches} + predict's warm-up one)", flush=True)


def phase_dense_2d(tmp: str) -> dict:
    """Phase 31: the dense-input family from scratch at the flagship's size
    (W32, 256x256, batch 16 of phase 11's images, bf16; the models built on
    the card, ``_built_on_card``): UNet4P, UNet4PV2
    and AHNet at D4, UNet4P, AHNet and KSSNet at D5 (the INI's default
    depth: tap 1 pooled by 32), DENSE_STEPS counted steps each with the
    loss falling and exactly DENSE_2D's pool launches a step (UNet4P D4 4
    + 10, UNet4PV2 7 + 16, AHNet 14 + 14; D5: 5 + 15, 20 + 20, 10 + 20),
    p50 and peak memory printed; then the ``train`` verb one epoch on
    phase 6's folders with AHNet at D4 (best.pt served), ``test`` and
    ``predict`` on phase 12's PNGs (14 launches a batch).  Returns {path:
    launches}."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel

    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 8)
    counts = {}
    for path, (dec, depth, _) in DENSE_2D.items():
        model = _built_on_card(lambda g: SegModel(
            dec, 32, depth, output_nums=1, final_activation="sigmoid",
            dtype=torch.bfloat16, generator=g))
        counts[path], trainer = _model_steps(
            "phase 31", path, model, x, y, DENSE_STEPS,
            f"W32/D{depth} {dec} {SIZE}x{SIZE}x3 bf16")
        del model, trainer
        torch.cuda.empty_cache()
    cfg = _train_config(tmp, "ResultsAHNet", decoder_name="AHNet",
                        num_epochs=1)
    print(f"phase 31 verbs: W32/D4 AHNet bf16, BCEDice, Adam lr "
          f"{cfg.learning_rate}, batch {TRAIN_BATCH}, 1 epoch", flush=True)
    counts["train_AHNet"] = _run_train_verb("phase 31 verbs", cfg,
                                            "train_AHNet")
    _verbs_test_predict("phase 31 verbs", tmp, cfg,
                        len(FWD_PATHS["train_AHNet"]))
    return counts


def phase_dense_2d_reference() -> None:
    """Phase 31's reference: phase 26's check (the card's float32 step
    against the CPU's float32 and float64 steps on the card's ReLU masks,
    gradients within RELATIVE_BAR, a bfloat16 control that must miss it)
    on W8/D3 UNet4P, UNet4PV2 and AHNet (DENSE_REF's launches) on (2, 64,
    64, 3); at depth 5 (tap 1 pooled by 32) on W8 UNet4P (5 + 15) and W2
    KSSNet (10 + 20) on (2, 128, 128, 3).  At 64 x 64 a depth-5 model's
    bottom is 2 x 2, whose training-mode BatchNorms normalize 8 values a
    channel: KSSNet's card and CPU float32 steps then stood 2.7e-3 of the
    largest gradient apart at W4, 0.19% of its parameters apart after
    Adam's first update at W8; at 128 x 128 W4 and W8 put 7-12 of their
    4.7-9.2 million ReLU pre-activations across 0 (MAX_RELU_FLIPS is 4),
    W2 passes (NVIDIA H100 80GB HBM3, 700 W)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel

    cases = [(dec, 8, 3, 64, want) for dec, want in DENSE_REF.items()]
    cases += [("UNet4P", 8, 5, 128, (5, 15)), ("KSSNet", 2, 5, 128, (10, 20))]
    for dec, width, depth, size, want in cases:
        cpu = SegModel(dec, width, depth,
                       generator=torch.Generator().manual_seed(SEED + 31))
        cpu64 = SegModel(dec, width, depth, dtype=torch.float64)
        cpu64.load_state_dict(cpu.state_dict())
        control = SegModel(dec, width, depth, dtype=torch.bfloat16)
        control.load_state_dict(cpu.state_dict())
        _train_reference("phase 31 reference", f"W{width}/D{depth} {dec}",
                         cpu, lambda y: y, None, want, cpu64,
                         shape=(2, size, size, 3), control=control)


def _backbone_model(dec: str, depth: int, name: str, trainable: bool,
                    width: int = 32, dtype=None, generator=None, **kw):
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel

    return SegModel(dec, width, depth, output_nums=1,
                    final_activation="sigmoid",
                    dtype=dtype or torch.bfloat16,
                    train_mode="pretrained_encoder", backbone=name,
                    backbone_trainable=trainable,
                    generator=generator or torch.Generator().manual_seed(SEED),
                    **kw)


def phase_backbones_2d(tmp: str) -> dict:
    """Phase 32: the backbones the port added, each under the W32/D4 UNet
    (``encoder_weights = none``, ``encoder_trainable = 1``; built on the
    card, ``_built_on_card``) on phase 11's
    images at pixel values (x 255), batch 16, bf16: BACKBONE_STEPS steps
    with finite losses (DENSE_STEPS for one name a class,
    BACKBONE_CLASSES) and no pool launch, an eval forward of the right
    shape; one name a class then frozen (``encoder_trainable = 0``, its
    statistics calibrated on the batch): 3 steps, the statistics stay.
    The gated projector families on ResNet50 at D4 (PROJECTORS_2D:
    MultiResUNet 0 + 0, MultiResUNet3+ 3 + 6, KSSNet and UNet4P 4 + 10,
    UNet4PV2 7 + 16, AHNet 10 + 10), UNet4P at D5 (the stride-32 tap its
    bottom, 4 + 10) and the UNet with ``a_e = 1``, BACKBONE_STEPS counted
    steps each (AHNet on batch 4: PROJ_BATCH); then UNet4PV2 on ResNet50
    through the ``train`` verb (7 + 16 a step, best.pt served).  Returns
    {path: launches}."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images)

    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 8)
    x = x * 255.0
    for name in NEW_BACKBONES:
        path = f"bb_{name}"
        steps = DENSE_STEPS if name in BACKBONE_CLASSES else BACKBONE_STEPS
        model = _built_on_card(
            lambda g: _backbone_model("UNet", 4, name, True, generator=g))
        _, trainer = _model_steps(
            "phase 32", path, model, x, y, steps,
            f"W32/D4 UNet on {name} {SIZE}x{SIZE}x3 (x 255) bf16",
            must_fall=False, calls=(0, 0))
        xd = trainer.to_device(x)
        with torch.no_grad():
            out = trainer.model.eval()(xd)["out"]
        _check(tuple(out.shape) == (TRAIN_BATCH, SIZE, SIZE, 1)
               and bool(out.isfinite().all()),
               f"{path}: eval forward {tuple(out.shape)}")
        if name in BACKBONE_CLASSES:
            tm = trainer.model
            bb = getattr(tm, tm._encoder)
            bb.trainable = False
            _calibrate_backbone(tm, None, x=xd)
            before = _backbone_stats(tm)
            losses = [float(trainer.train_step(xd, trainer.to_device(y))[0])
                      for _ in range(3)]
            after = _backbone_stats(tm)
            _check(all(torch.equal(before[k], after[k]) for k in before)
                   and all(np.isfinite(losses)) and not bb.training,
                   f"{path} frozen: statistics moved or losses {losses}")
            print(f"phase 32 {path}: frozen (encoder_trainable = 0, "
                  f"calibrated on the batch): 3 steps, losses {losses}, "
                  f"the backbone's {len(before)} running statistics "
                  f"unchanged", flush=True)
        del model, trainer, xd
        torch.cuda.empty_cache()

    counts = {}
    for path, (dec, depth, (fwd, bwd)) in PROJECTORS_2D.items():
        ae = path.endswith("_ae")
        b = PROJ_BATCH.get(path, TRAIN_BATCH)
        model = _built_on_card(lambda g: _backbone_model(
            dec, depth, PROJ_BACKBONE, True, ae=int(ae),
            input_size=(SIZE, SIZE), generator=g))
        run, trainer = _model_steps(
            "phase 32", path, model, x[:b], y[:b], BACKBONE_STEPS,
            f"W32/D{depth} {dec}{' a_e=1' if ae else ''} on {PROJ_BACKBONE}"
            f" {SIZE}x{SIZE}x3 (x 255) bf16", must_fall=False,
            calls=None if path in FWD_PATHS else (0, 0))
        if path in FWD_PATHS:
            counts[path] = run
        del model, trainer
        torch.cuda.empty_cache()

    cfg = _train_config(tmp, "ResultsUNet4PV2", decoder_name="UNet4PV2",
                        encoder_mode="pretrained_encoder",
                        encoder_name=PROJ_BACKBONE, encoder_weights="none",
                        encoder_trainable=True, normalizing_factor_img=1.0,
                        num_epochs=1)
    print(f"phase 32 verbs: W32/D4 UNet4PV2 on {PROJ_BACKBONE} bf16, "
          f"encoder_weights = none, encoder_trainable = 1, pixel-valued "
          f"inputs, BCEDice, Adam lr {cfg.learning_rate}, batch "
          f"{TRAIN_BATCH}, 1 epoch", flush=True)
    counts["train_UNet4PV2_ResNet50"] = _run_train_verb(
        "phase 32 verbs", cfg, "train_UNet4PV2_ResNet50")
    return counts


def phase_backbones_2d_reference() -> None:
    """Phase 32's reference: phase 26's check (the card's float32 step
    against the CPU's float32 and float64 steps on the card's ReLU and
    ReLU6 pieces, gradients within RELATIVE_BAR, a bfloat16 control that
    must miss it) on the W8/D3 UNet on one backbone a class
    (BACKBONE_CLASSES, trainable, pruned at tap 3) on (2, 64, 64, 3),
    uniform in [0, 1) or, for the backbones that rescale pixel values
    themselves, times 255 (MobileNetV3 by 1 / 127.5, EfficientNetV2 by
    1 / 255: on [0, 1) MobileNetV3's image is nearly constant after
    that, which left its card and CPU float32 steps 1.3e-3 of the
    largest gradient apart; on x 255 the others' first BatchNorms hold
    variances near 1e4; NVIDIA H100 80GB HBM3, 700 W), no pool launch;
    and on W8/D3 AHNet on ResNet50 (its four projectors' pools, 6 + 6).
    The running statistics are held to 1e-5 of their size where that is
    above 1 (``stats_relative``: MobileNetV3Large's were 3.8e-5 apart
    in absolute terms, its gradients 1.3e-6 of the largest)."""
    import torch

    cases = [("UNet", name, (0, 0)) for name in BACKBONE_CLASSES]
    cases.append(("AHNet", PROJ_BACKBONE, (6, 6)))
    for dec, name, want in cases:
        cpu = _backbone_model(dec, 3, name, True, width=8,
                              dtype=torch.float32)
        cpu64 = _backbone_model(dec, 3, name, True, width=8,
                                dtype=torch.float64)
        cpu64.load_state_dict(cpu.state_dict())
        control = _backbone_model(dec, 3, name, True, width=8)
        control.load_state_dict(cpu.state_dict())
        pixels = name.startswith(("MobileNetV3", "EfficientNet"))
        _train_reference("phase 32 reference", f"W8/D3 {dec} on {name}",
                         cpu, lambda y: y, None, want, cpu64,
                         control=control, x_scale=255.0 if pixels else 1.0,
                         stats_relative=True)


def phase_deep_2d(tmp: str) -> dict:
    """Phase 34: the 2D models that pool by 64 (DEEP_2D), W32 from scratch
    at the flagship's size (256x256, batch 16 of phase 11's images, bf16,
    BCEDice, Adam lr 1e-4): KSSNet at depth 6 and UNet3P at depth 7 with
    ``d_s = 1`` (its targets pooled to level 7 every step, the ds_type
    UNet heads weighted by default_ds_weights(7)), DEEP_LONG_STEPS counted
    steps each with the loss falling; UNet4P, UNet4PV2 and AHNet at depth
    6, MultiResUNet3P and SelfUNet3P at depth 7 on the images times
    SELF_2D_SCALE (the Self-ONN encoder overflows on [0, 1] images, phase
    28), DEEP_SHORT_STEPS counted steps each with finite losses; exactly
    each path's launches a step (``_deep_2d_fwd``), p50 and peak memory
    printed; the models built on the card (``_built_on_card``).  Then the
    ``train`` verb for one epoch on phase 6's folders with UNet3P at depth
    7 and ``d_s = 1`` (14 + 28 launches a step, 14 a validation batch),
    best.pt served.  Returns {path: launches}."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict, synthetic_images)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        Trainer, default_ds_weights)

    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 8)
    counts = {}
    for path, (dec, depth, kw) in DEEP_2D.items():
        ds = kw.get("ds", 0)
        long = path in DEEP_2D_LONG
        scale = 1.0 if long else SELF_2D_SCALE
        model = _built_on_card(lambda g: SegModel(
            dec, 32, depth, output_nums=1, ds=ds, final_activation="sigmoid",
            dtype=torch.bfloat16, generator=g))
        print(f"phase 34 {path}: W32/D{depth} {dec}{' d_s=1' if ds else ''}"
              f" {SIZE}x{SIZE}x3 bf16"
              + (f", images times {scale}" if scale != 1.0 else "")
              + f", {sum(p.numel() for p in model.parameters())} params, "
              f"BCEDice, Adam lr 1e-4, batch {TRAIN_BATCH}", flush=True)
        trainer = Trainer(
            model, loss="BCEDiceLoss", optimizer="Adam", learning_rate=1e-4,
            device="cuda",
            loss_weights=default_ds_weights(depth) if ds else None,
            prepare_targets=(lambda m, d=depth: prepare_train_dict(
                m, d, "UNet")) if ds else None)
        counts[path] = _counted_steps(
            "phase 34", path, trainer,
            trainer.to_device(x * np.float32(scale)), trainer.to_device(y),
            DEEP_LONG_STEPS if long else DEEP_SHORT_STEPS, must_fall=long)
        del model, trainer
        torch.cuda.empty_cache()
    cfg = _train_config(tmp, "ResultsUNet3PD7", decoder_name="UNet3P",
                        model_depth=7, d_s=1, ds_type="UNet", num_epochs=1)
    print(f"phase 34 verbs: W32/D7 UNet3P d_s 1, ds_type UNet, bf16, "
          f"BCEDice on out and level1-7, Adam lr {cfg.learning_rate}, batch "
          f"{TRAIN_BATCH}, 1 epoch", flush=True)
    counts["train_UNet3P_D7_ds"] = _run_train_verb(
        "phase 34 verbs", cfg, "train_UNet3P_D7_ds")
    return counts


def phase_deep_2d_reference() -> None:
    """Phase 34's reference: phase 31's check (the card's float32 step
    against the CPU's float32 and float64 steps on the card's ReLU masks,
    gradients within RELATIVE_BAR, a bfloat16 control that must miss it)
    at W8 on (2, REF_SIZE_64, REF_SIZE_64, 3), one model a new kernel
    family (DEEP_2D_REF): UNet4P at depth 6 (``pyramid_vec_kernel`` at
    level 6, ``pool_backward_wide_kernel``), UNet3P at depth 7 with ``d_s =
    1`` (``pyramid_c1_kernel`` at level 7; its heads scaled as in phase
    10)."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        default_ds_weights)

    for dec, depth, kw, want in DEEP_2D_REF:
        ds = kw.get("ds", 0)
        cpu = SegModel(dec, 8, depth, ds=ds,
                       generator=torch.Generator().manual_seed(SEED + 34))
        if ds:
            decoder = getattr(cpu, cpu._decoder_name)
            with torch.no_grad():
                for k in range(1, depth + 1):
                    head = getattr(decoder, f"level{k}")
                    head.weight.mul_(0.01)
                    head.bias.fill_(0.5)
        cpu64 = SegModel(dec, 8, depth, ds=ds, dtype=torch.float64)
        cpu64.load_state_dict(cpu.state_dict())
        control = SegModel(dec, 8, depth, ds=ds, dtype=torch.bfloat16)
        control.load_state_dict(cpu.state_dict())
        _train_reference(
            "phase 34 reference",
            f"W8/D{depth} {dec}" + (" with ds=1" if ds else ""), cpu,
            (lambda y, d=depth: prepare_train_dict(y, d, "UNet")) if ds
            else (lambda y: y), default_ds_weights(depth) if ds else None,
            want, cpu64, shape=(2, REF_SIZE_64, REF_SIZE_64, 3),
            control=control)


def phase_deeper_1d(tmp: str) -> dict:
    """Phase 35: the 1D models that pool by 64 (DEEPER_1D: UNet3P,
    R2UNet3P, SelfUNet3P (on the signals times SELF_1D_SCALE), ConvMixerUNet3P
    and MLMRSNet_V2 at depth 7, UNet4P at depth 8) at config 1's size and
    width (W32, 1024 samples, batch 128 of phase 21's test signals,
    float32, MeanAbsoluteError, Adam; built on the card), DEEPER_STEPS
    counted fixed-batch steps each with finite losses and exactly each
    path's launches a step (``_deep_calls``).  Then the 1D verbs on UNet3P at depth 6 with ``d_s =
    1`` (DEEPER_1D_VERBS: its targets pool the mask by 2 .. 64).  Returns
    {path: launches}."""
    import torch

    sets = _write_signal_sets(tmp)
    x, y = sets["x_test"], sets["y_test"]
    counts = {}
    for path, (arch, depth) in DEEPER_1D.items():
        scale = SELF_1D_SCALE if arch.startswith("Self") else 1.0
        trainer = _built_on_card(lambda g: _signal_trainer(
            arch, torch.float32, depth=depth, generator=g))
        print(f"phase 35 {path}: W32/D{depth} {arch}, "
              f"{sum(p.numel() for p in trainer.model.parameters())} "
              f"params, float32, batch {SIG_BATCH}"
              + (f", signals times {scale}" if scale != 1.0 else ""),
              flush=True)
        counts[path] = _counted_steps(
            "phase 35", path, trainer,
            trainer.to_device(x * np.float32(scale)), trainer.to_device(y),
            DEEPER_STEPS, must_fall=False, unit="signals")
        del trainer
        torch.cuda.empty_cache()
    for path, (arch, depth, over) in DEEPER_1D_VERBS.items():
        counts[path] = _signal_verbs("phase 35", tmp, sets, path, arch,
                                     model_depth=depth, **over)
    return counts


def phase_deeper_1d_reference() -> None:
    """Phase 35's reference: phase 33's check on UNet3P at W8/D7 on (2,
    256, 1) signals, whose skip 0 is pooled by 2 .. 64: 13 + 28
    launches."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import (
        model_selector_1d)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import get_loss

    path = "1d_deeper_UNet3P_D7"
    arch, depth = DEEPER_1D[path]
    cpu = model_selector_1d(arch, 256, depth, 1, 8, 3,
                            generator=torch.Generator().manual_seed(SEED + 35))
    cpu64 = model_selector_1d(arch, 256, depth, 1, 8, 3, dtype=torch.float64)
    cpu64.load_state_dict(cpu.state_dict())
    control = model_selector_1d(arch, 256, depth, 1, 8, 3,
                                dtype=torch.bfloat16)
    control.load_state_dict(cpu.state_dict())
    _train_reference(
        "phase 35 1D reference", f"W8/D{depth} 1D {arch}", cpu, lambda y: y,
        None, (len(FWD_PATHS_1D[path]), len(BWD_PATHS_1D[path])), cpu64,
        shape=(2, 256, 1), loss=get_loss("MeanAbsoluteError"),
        control=control)


def _time_phases() -> None:
    """Make every ``phase_*`` function print its wall time when it ends,
    and the script's so far."""
    import functools

    start = time.perf_counter()
    g = globals()
    for name in [n for n in g if n.startswith("phase_")]:
        def timed(*args, _fn=g[name], **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                now = time.perf_counter()
                print(f"wall {_fn.__name__}: {now - t0:.1f} s (the script "
                      f"at {now - start:.1f} s)", flush=True)
        g[name] = functools.wraps(g[name])(timed)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port does not run on "
              "the CPU here", file=sys.stderr)
        return 1
    if sys.argv[1:] not in ([], ["--ds-mask"]):
        print("usage: python3 chip_smoke.py [--ds-mask]", file=sys.stderr)
        return 2
    # fails here, before any phase, outside a checkout of the repo
    import tf_1d_2d_segmentation_end2endpipelines_torch  # noqa: F401
    _time_phases()
    phase_device()
    phase_build()
    if sys.argv[1:] == ["--ds-mask"]:
        phase_ds_mask()
        return 0
    pyr, bwd = phase_kernels(), phase_pool_backward()
    pyr1, bwd1 = phase_kernels_1d()
    pyr.update(pyr1)
    bwd.update(bwd1)
    with tempfile.TemporaryDirectory() as tmp:
        served = phase_serve(tmp)
    phase_reference(served["model"])
    with tempfile.TemporaryDirectory() as tmp:
        _write_image_folders(tmp)
        trained = {"train": phase_train(tmp)}
        phase_train_reference()
        trained["train_ds"] = phase_train_ds(tmp)
        tested = phase_test_verb(tmp, _train_config(tmp, "Results"))
        trained["train_multires"] = phase_multires_verbs(tmp)
        trained.update(phase_config3())
        phase_train_ds_reference()
        trained.update(phase_config2())
        phase_config2_reference()
        trained.update(phase_config4())
        trained.update(phase_family())
        phase_multires_reference()
        trained["registries"] = phase_registries(tmp)
        predicted = phase_predict(tmp, _train_config(tmp, "Results"))
        trained["train_options"] = phase_train_options(tmp)
        trained["train_patchify"] = phase_train_patchify(tmp)
        trained.update(phase_signal_verbs(tmp))
        trained.update(phase_signal_steps())
        phase_signal_reference()
        trained.update(phase_config5_1d(tmp))
        phase_config5_1d_reference()
        phase_config5_2d(tmp)
        phase_config5_2d_reference()
        trained.update(phase_zoo_1d(tmp))
        phase_zoo_1d_reference()
        trained.update(phase_lstm_ae_2d(tmp))
        phase_lstm_ae_2d_reference()
        trained.update(phase_self_2d(tmp))
        phase_self_2d_reference()
        trained.update(phase_self_1d(tmp))
        phase_self_1d_reference()
        trained.update(phase_zoo_1d_specials(tmp))
        phase_zoo_1d_specials_reference()
        trained.update(phase_dense_2d(tmp))
        phase_dense_2d_reference()
        trained.update(phase_backbones_2d(tmp))
        phase_backbones_2d_reference()
        trained.update(phase_deep_1d(tmp))
        phase_deep_1d_reference()
        trained.update(phase_deep_2d(tmp))
        phase_deep_2d_reference()
        trained.update(phase_deeper_1d(tmp))
        phase_deeper_1d_reference()
    runs = {"serve": served, "test": tested, "predict": predicted,
            **trained}
    rows = _kernel_rows(list(pyr.values()) + list(bwd.values()), runs)
    keys = ("name", "path", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
