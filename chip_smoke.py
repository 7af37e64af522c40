#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path once, at the flagship's full width: the
W32/D4 UNet++ on 256x256x3 in bf16 with weights drawn from a seed, behind
``make_server`` with dynamic batching, answering 16 PNG requests from 4
client threads.  Phases, each printing a line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
2. build: every kernel under csrc/ compiled from this checkout by nvcc
3. kernels: each kernel against its plain PyTorch version at the shapes
   the serving path gives it (bit-exact: max is exact), with CUDA-event
   times of both, as device time and as one call on an idle card
4. serve: 16/16 answered 200 with a 256x256 mask; masks equal to
   ``label_from_pred`` of the same model run with the plain pool, away
   from the threshold; the pyramid kernel launched exactly 4 times (one
   per encoder level) per device batch; p50 latencies
5. reference: the same weights in float32 on the card (TF32 off) against
   the CPU on a small input, within 1e-4

The line before the last is one JSON object describing each kernel; the
last is ``{"ok": true, "device": {...}}``.  Any failure raises and the
exit code is not 0.  Without CUDA it exits 1 before printing any result.
"""
from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
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
REPS = 30


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


def _device_ms(fn, flush, loops: int = 5) -> float:
    """Device time of one ``fn()`` with a cold 50 MB L2: events around REPS
    (flush, fn) pairs minus events around REPS flushes alone, per call;
    median over ``loops``.  Zeroing 128 MB keeps the card busy longer than
    the host takes to enqueue ``fn``, so host overhead drops out."""
    def pairs():
        for _ in range(REPS):
            flush.zero_()
            fn()

    def flushes():
        for _ in range(REPS):
            flush.zero_()

    return statistics.median(
        (_events_ms(pairs) - _events_ms(flushes)) / REPS
        for _ in range(loops))


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


def phase_kernels() -> dict:
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)

    cases = [  # (dtype, NHWC shape, levels, on the serving path)
        (torch.bfloat16, (BATCH, 256, 256, 32), 1, True),
        (torch.bfloat16, (BATCH, 128, 128, 64), 1, True),
        (torch.bfloat16, (BATCH, 64, 64, 128), 1, True),
        (torch.bfloat16, (BATCH, 32, 32, 256), 1, True),
        (torch.float32, (BATCH, 256, 256, 1), 4, False),  # DS mask pyramid
        (torch.float32, (2, 37, 53, 3), 2, False),         # ragged edges
        (torch.bfloat16, (2, 37, 53, 16), 1, False),       # ragged, vector
        (torch.bfloat16, (2, 16, 16, 3), 1, False),        # C % 8 != 0
    ]
    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    max_err = 0.0
    path_ms = path_plain_ms = 0.0
    for dtype, shape, levels, on_path in cases:
        x = torch.randn(shape, generator=gen)
        x.view(-1)[x.numel() // 3] = float("nan")  # must propagate
        x = x.to("cuda", dtype).permute(0, 3, 1, 2)  # channels_last view
        got = pyramid.maxpool_pyramid(x, levels)
        want = pyramid.maxpool_pyramid_plain(x, levels)
        torch.cuda.synchronize()
        for lvl, (k, p) in enumerate(zip(got, want), 1):
            _check(k.shape == p.shape and k.dtype == p.dtype,
                   f"pyramid {shape} L{lvl}: {k.shape} vs {p.shape}")
            _check(torch.equal(k.isnan(), p.isnan()),
                   f"pyramid {shape} L{lvl}: NaN positions differ")
            fin = ~p.isnan()
            err = float((k[fin].float() - p[fin].float()).abs().max()) \
                if bool(fin.any()) else 0.0
            _check(err == 0.0, f"pyramid {shape} L{lvl}: max-abs {err}")
            max_err = max(max_err, err)
        t = {"kernel": [], "plain": [], "kernel_call": [], "plain_call": []}
        fns = {"kernel": lambda: pyramid.maxpool_pyramid(x, levels),
               "plain": lambda: pyramid.maxpool_pyramid_plain(x, levels)}
        for name in ("plain", "kernel", "kernel", "plain"):  # in turns
            t[name].append(_device_ms(fns[name], flush))
            t[name + "_call"].append(_call_ms(fns[name], flush))
        ms, plain_ms = (statistics.mean(t[k]) for k in ("kernel", "plain"))
        if on_path:
            path_ms += ms
            path_plain_ms += plain_ms
        print(f"phase 3 kernel maxpool_pyramid {str(dtype)[6:]} "
              f"{tuple(shape)} L={levels}: equal to plain (max-abs 0, NaN "
              f"kept); device time kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; one call on an idle card kernel "
              f"{statistics.mean(t['kernel_call']):.4f} ms, plain "
              f"{statistics.mean(t['plain_call']):.4f} ms (CUDA events, "
              f"L2 flushed, medians of {REPS})", flush=True)
    print(f"phase 3 kernels: serving path's pools per batch of {BATCH}, "
          f"device time: kernel {path_ms:.4f} ms, plain "
          f"{path_plain_ms:.4f} ms", flush=True)
    return {"name": "maxpool_pyramid", "route": "cuda",
            "source": "tf_1d_2d_segmentation_end2endpipelines_torch/csrc/"
                      "pyramid.cu",
            "replaces": "tf_1d_2d_segmentation_end2endpipelines_tpu/ops/"
                        "pallas/pyramid.py:49",
            "max_abs_err": max_err, "ms": path_ms, "plain_ms": path_plain_ms}


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
        pyramid.reset_launches()  # the main path's run starts here
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(N_CLIENTS)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=600)
        launches = pyramid.launches  # ... and ends here
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
           f"pyramid.launches {launches} != 4 x {n_batches} device batches")
    print(f"phase 4 serve: pyramid.launches = {launches} = 4 encoder pools "
          f"x {n_batches} device batches", flush=True)

    # the same model with the plain pool, on the card, on the same decode
    decoded = np.stack([_decode_request(b, (SIZE, SIZE), "rgb", 255.0)
                        for b in bodies])
    before = pyramid.launches
    with mock.patch.object(pyramid, "maxpool_pyramid",
                           pyramid.maxpool_pyramid_plain):
        probs = predictor(decoded)
    _check(pyramid.launches == before, "plain-pool run launched the kernel")
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
    return {"model": model, "launches": launches}


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
        before = pyramid.launches
        with torch.inference_mode():
            gpu = ref(x.cuda())["out"].cpu()
        launched = pyramid.launches - before
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port does not run on "
              "the CPU here", file=sys.stderr)
        return 1
    # fails here, before any phase, outside a checkout of the repo
    import tf_1d_2d_segmentation_end2endpipelines_torch  # noqa: F401
    phase_device()
    phase_build()
    kernel = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        served = phase_serve(tmp)
    phase_reference(served["model"])
    kernel["launches"] = served["launches"]
    kernel = {k: kernel[k] for k in ("name", "route", "source", "replaces",
                                     "launches", "max_abs_err", "ms",
                                     "plain_ms")}
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
