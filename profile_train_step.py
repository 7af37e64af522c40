#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one NVIDIA GPU.

    python3 profile_train_step.py [--out DIR]
        [--model flagship|unet3p_ds|multiresunet|unet_ag|unet1d|nabnet|
                 effnet_unet|selfunet]

The flagship (W32/D4 UNet++, 256x256x3, bf16, BCEDiceLoss, Adam), or with
``--model unet3p_ds`` UNet3+ W32/D4 with deep supervision (its targets
built from the mask at every step, one pyramid launch, and
``default_ds_weights(4)``: the train verb's step with ``d_s = 1``), or with
``--model multiresunet`` config 4's MultiResUNet W32/D4 (alpha 1: odd
channel counts), or with ``--model unet_ag`` config 4's UNet W32/D4 with
attention gates, takes 10 train steps on one synthetic batch of 16, or
with ``--model unet1d`` BASELINE config 1 (the 1D UNet W32/D3 on
one-channel 1024-sample signals, float32, MeanAbsoluteError, Adam lr
3e-4) on a batch of 128 synthetic signals, or with ``--model nabnet``
BASELINE config 5's NABNet (W32/D3, ``dense_loop = 2``) the same way, or
with ``--model effnet_unet`` config 5's UNet W32/D4 on EfficientNetB0
(random weights, the backbone's BatchNorms training) on the batch of 16
scaled to pixel values, or with ``--model selfunet`` the Self-ONN
SelfUNet W32/D4 (q = 3) on the batch of 16 times SELF_2D_SCALE (the
scale of ``chip_smoke.py``'s phase 28, where the reference's forward is
finite), then 10 more under
``torch.profiler``.  Prints the card's name and power limit, the
host time per step with and without the profiler, the device time per
step by kernel (the profiler's CUDA rows), grouped into the layers of
PERF.md section 5, and the card's idle share of a step; for
``selfunet`` also the device time of the Self-ONN power stacks alone
(``ops.onn.power_stack``: the multiplies and the concatenation, forward,
and their backward), timed by CUDA events at the shapes and dtypes of
the step's Oper inputs.  The full table and a Chrome trace go to
``--out`` (default ``build/profile_train_step/``).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

WARMUP, STEPS, BATCH = 10, 10, 16  # warm-up steps, profiled steps, batch

GROUPS = (  # (layer, substrings of a device kernel's name), first match wins
    ("pool kernels (hand-written)", ("pool_vec", "pool_backward",
                                     "pyramid", "pool1d")),
    # cuDNN's direct kernels for depthwise convolutions (EfficientNet)
    ("depthwise convolutions (cuDNN)", ("2d_c1_k1", "wgrad2d_shmem",
                                        "grouped_direct")),
    ("bilinear upsample (UNet3+)", ("upsample",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "sm90_xmma", "wgrad", "dgrad",
                              "implicit_gemm", "cutlass", "gemm")),
    ("optimizer (Adam)", ("adam", "foreach", "multi_tensor")),
    ("concat", ("cat", "catarray")),
    ("reductions (BN statistics, loss sums)", ("reduce", "sum", "mean")),
)
OTHER = "elementwise (BN apply, bias, activations, casts, loss) and other"
#: --model -> (decoder or 1D arch, deep supervision, attention gates)
MODELS = {"flagship": ("UNetPP", 0, 0), "unet3p_ds": ("UNet3P", 1, 0),
          "multiresunet": ("MultiResUNet", 0, 0), "unet_ag": ("UNet", 0, 1),
          "unet1d": ("UNet", 0, 0), "nabnet": ("NABNet", 0, 0),
          "effnet_unet": ("UNet", 0, 0), "selfunet": ("SelfUNet", 0, 0)}
#: selfunet's images are multiplied by this (chip_smoke.py's SELF_2D_SCALE)
SELF_2D_SCALE = 0.3
#: config 1's batch of signals and their length
SIG_BATCH, SIG_LEN = 128, 1024


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return OTHER


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=tuple(MODELS), default="flagship")
    ap.add_argument("--out", default=os.path.join("build",
                                                  "profile_train_step"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict, synthetic_images, synthetic_signals)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import (
        SegModel, model_selector_1d)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        Trainer, default_ds_weights)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    decoder, ds, ag = MODELS[args.model]
    gen = torch.Generator().manual_seed(0)
    if args.model in ("unet1d", "nabnet"):
        batch, unit = SIG_BATCH, "signals"
        model = model_selector_1d(decoder, SIG_LEN, 3, 1, 32, 3,
                                  dense_loop=2, generator=gen)
        trainer = Trainer(model, loss="MeanAbsoluteError",
                          learning_rate=3e-4, device="cuda")
        x, y = synthetic_signals(batch, SIG_LEN, seed=0)
    else:
        batch, unit = BATCH, "img"
        effnet = args.model == "effnet_unet"
        model = SegModel(decoder, 32, 4, ds=ds, ag=ag, dtype=torch.bfloat16,
                         generator=gen,
                         train_mode=("pretrained_encoder" if effnet
                                     else "from_scratch"),
                         backbone="EfficientNetB0" if effnet else None,
                         backbone_trainable=effnet)
        trainer = Trainer(
            model, loss="BCEDiceLoss", learning_rate=2e-4,
            loss_weights=default_ds_weights(4) if ds else None,
            device="cuda",
            prepare_targets=(lambda y: prepare_train_dict(y, 4, "UNet"))
            if ds else None)
        x, y = synthetic_images(batch, 256, seed=0)
        if effnet:  # the backbone divides by 255
            x = x * 255.0
        if args.model == "selfunet":
            x = x * SELF_2D_SCALE
    prepare = trainer.prepare_targets or (lambda y: y)
    x, y = trainer.to_device(x), trainer.to_device(y)

    def steps(n: int) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            trainer.train_step(x, prepare(y))
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    steps(WARMUP)
    plain_ms = steps(STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = steps(STEPS)
    events = prof.key_averages()
    # the device's own rows, one per kernel name; a range that the host
    # annotates (Optimizer.step#Adam.step) also shows on the device's
    # timeline, over kernels that have rows of their own: left out
    host_keys = {e.key for e in events if "CUDA" not in str(e.device_type)}
    rows = []
    for e in events:
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and "CUDA" in str(e.device_type) \
                and e.key not in host_keys:
            rows.append((dev_us / STEPS / 1e3, e.count / STEPS,
                         e.key))
    if not rows:
        print("profile_train_step: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    # the profiler slows the host, not the kernels: the idle share of a
    # step is read against the step without it
    print(f"{args.model}, batch {batch}: host time per step {plain_ms:.3f} ms without "
          f"the profiler, {prof_ms:.3f} ms with it (mean of {STEPS} "
          f"steps after {WARMUP} warm-up); device busy {busy:.3f} ms "
          f"per step, idle share of a step without the profiler "
          f"{1 - busy / plain_ms:.3f}; {batch / plain_ms * 1e3:.1f} "
          f"{unit}/s", flush=True)
    groups = {}
    for ms, n, name in rows:
        g = groups.setdefault(_group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += n
    for label, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:8.3f} ms/step {ms / busy:6.1%}  {n:7.1f} launches  "
              f"{label}", flush=True)
    print("top device kernels (ms per step, launches per step, name):",
          flush=True)
    for ms, n, name in rows[:25]:
        print(f"  {ms:8.3f}  {n:6.1f}  {name[:110]}", flush=True)
    if args.model == "selfunet":
        fwd_ms, bwd_ms, n = _power_stack_ms(trainer, x, prepare(y))
        print(f"power stacks ({n} a step, forward / backward alone): "
              f"{fwd_ms:.3f} / {bwd_ms:.3f} ms per step, "
              f"{(fwd_ms + bwd_ms) / busy:.1%} of the device busy time",
              flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=200))
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    print(f"wrote {args.out}/key_averages.txt and trace.json", flush=True)
    return 0


def _power_stack_ms(trainer, x, y) -> tuple:
    """Device ms per step of the power stacks of the model's Oper and
    OperTranspose layers alone, forward and backward (CUDA events, the
    median of 5 loops of 10), each at the input shape, dtype and memory
    layout it takes in one train step; and how many there are."""
    import statistics

    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops import (
        Oper, OperTranspose, power_stack)

    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: seen.append((a[0].detach(), m.q)))
        for m in trainer.model.modules()
        if isinstance(m, (Oper, OperTranspose))]
    trainer.train_step(x, y)
    for h in hooks:
        h.remove()
    cases = []
    for t, q in seen:
        a = t.clone().requires_grad_()
        out = power_stack(a, q)
        cases.append((a, q, out, torch.randn_like(out)))

    def timed(fn) -> float:
        runs = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            for _ in range(10):
                fn()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / 10)
        return statistics.median(runs)

    def forward():
        for a, q, _, _ in cases:
            power_stack(a.detach(), q)

    def backward():
        for a, _, out, g in cases:
            torch.autograd.grad(out, a, g, retain_graph=True)

    return timed(forward), timed(backward), len(cases)


if __name__ == "__main__":
    sys.exit(main())
