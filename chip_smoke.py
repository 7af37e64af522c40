#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths at the flagship's full width, the W32/D4
UNet++ on 256x256x3 in bf16 with weights drawn from a seed: serving
(``make_server`` with dynamic batching answering 16 PNG requests from 4
client threads) and training (the ``train`` verb's fold loop on a
synthetic PNG folder, batch 16, 2 epochs).  Phases, each printing lines:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
2. build: every kernel under csrc/ compiled from this checkout by nvcc
3. kernels: each kernel against its plain PyTorch version at the shapes
   the serving and training paths give it and at edge cases (bit-exact:
   max and its gradient routing are exact), with CUDA-event device times
   of the kernel, the plain version and the PyTorch library call that
   computes the same function (a yardstick the port never calls), and
   the bound: bytes moved at 3.35 TB/s
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

The line before the last is one JSON object with a row for each kernel
and each path that runs it (``path``: ``serve`` or ``train``): the
launches of that path's run in phase 4 or 6, and the device times and
bound of the calls that path makes per batch or step; the last is ``{"ok": true, "device": {...}}``.  Any failure raises and the
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
REPS = 30
TRAIN_BATCH = 16
N_TRAIN = 128
N_VAL = 16
TRAIN_EPOCHS = 2
FIXED_STEPS = 30
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


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


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound_ms(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes`` (each input
    read once, each output written once) at the H100's 3.35 TB/s."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _in_turns(fns: dict, flush) -> dict:
    """Device time of each of ``fns`` (name -> callable), measured in
    turns (order, reversed order) and averaged."""
    t = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        t[name].append(_device_ms(fns[name], flush))
    return {name: statistics.mean(v) for name, v in t.items()}


def _path_row(name: str, path: str, source: str, replaces: str,
              max_err: float, times: dict, nbytes: int) -> dict:
    """The kernel's row of the JSON line for one path: device times and
    bound summed over the calls that path makes per batch or step."""
    return {"name": name, "path": path, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max_err,
            "ms": times["kernel"], "plain_ms": times["plain"],
            "bound_ms": _bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": times["library"]}


def phase_kernels() -> dict:
    """maxpool_pyramid against its plain version; returns its JSON rows,
    one per path (``serve``, ``train``)."""
    import torch
    import torch.nn.functional as F

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)

    cases = [  # (dtype, NHWC shape, levels, on which path)
        (torch.bfloat16, (BATCH, 256, 256, 32), 1, "serve"),
        (torch.bfloat16, (BATCH, 128, 128, 64), 1, "serve"),
        (torch.bfloat16, (BATCH, 64, 64, 128), 1, "serve"),
        (torch.bfloat16, (BATCH, 32, 32, 256), 1, "serve"),
        (torch.bfloat16, (TRAIN_BATCH, 256, 256, 32), 1, "train"),
        (torch.bfloat16, (TRAIN_BATCH, 128, 128, 64), 1, "train"),
        (torch.bfloat16, (TRAIN_BATCH, 64, 64, 128), 1, "train"),
        (torch.bfloat16, (TRAIN_BATCH, 32, 32, 256), 1, "train"),
        (torch.float32, (BATCH, 256, 256, 1), 4, None),  # DS mask pyramid
        (torch.float32, (2, 37, 53, 3), 2, None),         # ragged edges
        (torch.bfloat16, (2, 37, 53, 16), 1, None),       # ragged, vector
        (torch.bfloat16, (2, 16, 16, 3), 1, None),        # C % 8 != 0
    ]
    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    max_err = 0.0
    path = {p: {"kernel": 0.0, "plain": 0.0, "library": 0.0, "bytes": 0}
            for p in ("serve", "train")}
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
        fns = {"plain": lambda: pyramid.maxpool_pyramid_plain(x, levels),
               "kernel": lambda: pyramid.maxpool_pyramid(x, levels)}
        if levels == 1:  # the yardstick: PyTorch's own pool
            fns["library"] = lambda: F.max_pool2d(x, 2)
        t = _in_turns(fns, flush)
        calls = {name: _call_ms(fns[name], flush)
                 for name in ("kernel", "plain")}
        nbytes = _bytes(x, *got)
        lib = (f", library F.max_pool2d {t['library']:.4f} ms"
               if "library" in t else "")
        if on_path:
            for k in ("kernel", "plain", "library"):
                path[on_path][k] += t[k]
            path[on_path]["bytes"] += nbytes
        print(f"phase 3 kernel maxpool_pyramid {str(dtype)[6:]} "
              f"{tuple(shape)} L={levels}: equal to plain (max-abs 0, NaN "
              f"kept); device time kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms{lib}, bound {_bound_ms(nbytes):.4f} ms "
              f"({nbytes} B at 3.35 TB/s); one call on an idle card kernel "
              f"{calls['kernel']:.4f} ms, plain {calls['plain']:.4f} ms "
              f"(CUDA events, L2 flushed, medians of {REPS})", flush=True)
    for name, n in (("serve", BATCH), ("train", TRAIN_BATCH)):
        q = path[name]
        print(f"phase 3 kernels: the {name} path's four pools per batch of "
              f"{n}, device time: kernel {q['kernel']:.4f} ms, plain "
              f"{q['plain']:.4f} ms, library {q['library']:.4f} ms, bound "
              f"{_bound_ms(q['bytes']):.4f} ms", flush=True)
    return {p: _path_row(
        "maxpool_pyramid", p,
        "tf_1d_2d_segmentation_end2endpipelines_torch/csrc/pyramid.cu",
        "tf_1d_2d_segmentation_end2endpipelines_tpu/ops/pallas/pyramid.py:49",
        max_err, path[p], path[p]["bytes"]) for p in path}


def phase_pool_backward() -> dict:
    """maxpool2x2_backward against its plain version, bit for bit, at the
    train path's four pools and at edge cases, with planted plateaus
    (post-ReLU zeros, so ties decide the routing) and a planted NaN."""
    import torch
    import torch.nn.functional as F

    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward)

    cases = [  # (dtype, NHWC shape, on the train path)
        (torch.bfloat16, (TRAIN_BATCH, 256, 256, 32), True),
        (torch.bfloat16, (TRAIN_BATCH, 128, 128, 64), True),
        (torch.bfloat16, (TRAIN_BATCH, 64, 64, 128), True),
        (torch.bfloat16, (TRAIN_BATCH, 32, 32, 256), True),
        (torch.float32, (4, 64, 64, 32), False),    # f32, vector path
        (torch.bfloat16, (2, 37, 53, 16), False),   # ragged, vector path
        (torch.float32, (2, 37, 53, 3), False),     # ragged, C % 4 != 0
        (torch.bfloat16, (2, 16, 16, 12), False),   # C % 8 != 0
        (torch.bfloat16, (1, 1, 1, 8), False),      # nothing pooled
    ]
    gen = torch.Generator().manual_seed(SEED + 2)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    max_err = 0.0
    path = {"kernel": 0.0, "plain": 0.0, "library": 0.0}
    path_bytes = 0
    for dtype, shape, on_path in cases:
        x = torch.randn(shape, generator=gen)
        x = torch.where(x < 0.3, torch.zeros_like(x), x)  # ReLU plateaus
        x.view(-1)[x.numel() // 3] = float("nan")
        x = x.to("cuda", dtype).permute(0, 3, 1, 2)
        b, c, h, w = x.shape
        g = torch.randn((b, h // 2, w // 2, c), generator=gen).to(
            "cuda", dtype).permute(0, 3, 1, 2)
        before = pool_backward.launches.value
        got = pool_backward.maxpool2x2_backward(x, g)
        want = pool_backward.maxpool2x2_backward_plain(x, g)
        torch.cuda.synchronize()
        _check(pool_backward.launches.value == before + 1,
               f"pool backward {shape}: not one launch")
        _check(got.shape == want.shape and got.dtype == want.dtype and
               got.is_contiguous(memory_format=torch.channels_last),
               f"pool backward {shape}: {got.shape} {got.dtype}")
        err = float((got.float() - want.float()).abs().max())
        _check(torch.equal(got, want),
               f"pool backward {shape}: max-abs {err}")
        max_err = max(max_err, err)
        if not on_path:
            print(f"phase 3 kernel maxpool2x2_backward {str(dtype)[6:]} "
                  f"{tuple(shape)}: equal to plain (max-abs 0)", flush=True)
            continue
        _, idx = F.max_pool2d(x, 2, return_indices=True)
        fns = {
            "plain": lambda: pool_backward.maxpool2x2_backward_plain(x, g),
            "kernel": lambda: pool_backward.maxpool2x2_backward(x, g),
            # the yardstick, given the indices its forward saved
            "library": lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                g, x, [2, 2], [2, 2], [0, 0], [1, 1], False, idx),
        }
        t = _in_turns(fns, flush)
        nbytes = _bytes(x, g, got)
        for k in path:
            path[k] += t[k]
        path_bytes += nbytes
        print(f"phase 3 kernel maxpool2x2_backward {str(dtype)[6:]} "
              f"{tuple(shape)}: equal to plain (max-abs 0, plateaus and a "
              f"NaN); device time kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, library max_pool2d_with_indices_"
              f"backward {t['library']:.4f} ms, bound "
              f"{_bound_ms(nbytes):.4f} ms ({nbytes} B at 3.35 TB/s) (CUDA "
              f"events, L2 flushed, medians of {REPS})", flush=True)
    print(f"phase 3 kernels: the train path's four pool backwards per step "
          f"of {TRAIN_BATCH}, device time: kernel {path['kernel']:.4f} ms, "
          f"plain {path['plain']:.4f} ms, library {path['library']:.4f} ms, "
          f"bound {_bound_ms(path_bytes):.4f} ms", flush=True)
    return _path_row(
        "maxpool2x2_backward", "train",
        "tf_1d_2d_segmentation_end2endpipelines_torch/csrc/pool_backward.cu",
        "tf_1d_2d_segmentation_end2endpipelines_tpu/ops/blocks.py:467",
        max_err, path, path_bytes)


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
        pyramid.launches.reset()  # the main path's run starts here
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(N_CLIENTS)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=600)
        launches = pyramid.launches.value  # ... and ends here
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


def _serve_one_png(cfg, fold_dir: str) -> int:
    """Status of one PNG request to ``make_server`` over ``fold_dir``."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.serve import (
        make_server)

    server = make_server(cfg, fold_dir, port=0, max_batch=1, device="cuda")
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    try:
        img = (np.random.default_rng(SEED).uniform(size=(SIZE, SIZE, 3))
               * 255).astype(np.uint8)
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
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
    return status


def phase_train(tmp: str) -> dict:
    """The train verb's fold loop on the card, then a fixed-batch loop
    that times the train step."""
    import torch

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images, write_image_folder)
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TrainConfig)

    t0 = time.perf_counter()
    for name, n, seed in (("Train", N_TRAIN, SEED), ("Val", N_VAL, SEED + 1)):
        write_image_folder(os.path.join(tmp, "Data", name),
                           *synthetic_images(n, SIZE, seed=seed))
    # the flagship, __graft_entry__.py:26-29 and bench.py:60-84
    cfg = TrainConfig(
        train_dir=os.path.join(tmp, "Data", "Train"),
        val_dir=os.path.join(tmp, "Data", "Val"), imlength=SIZE,
        imwidth=SIZE, num_channels=3, encoder_mode="from_scratch",
        decoder_name="UNetPP", model_width=32, model_depth=4, output_nums=1,
        class_number=1, dense_loop=1, final_activation="sigmoid",
        compute_dtype="bfloat16", loss_function="BCEDiceLoss",
        optimizer_function="Adam", metric_list=("BinaryAccuracy",),
        batch_size=TRAIN_BATCH, num_epochs=TRAIN_EPOCHS, seed=SEED,
        save_dir=os.path.join(tmp, "Results"), load_weights=False)
    print(f"phase 6 train: {N_TRAIN} train and {N_VAL} val {SIZE}x{SIZE} "
          f"PNGs written in {time.perf_counter() - t0:.2f} s; W32/D4 UNet++ "
          f"bf16, BCEDice, Adam lr {cfg.learning_rate}, batch "
          f"{TRAIN_BATCH}, {TRAIN_EPOCHS} epochs", flush=True)

    pyramid.launches.reset()  # the main path's run starts here
    pool_backward.launches.reset()
    pool_backward.g_copies.reset()
    t0 = time.perf_counter()
    hist = drivers.train(config=cfg, device="cuda")[1]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd, copies = (pyramid.launches.value, pool_backward.launches.value,
                        pool_backward.g_copies.value)  # ... and ends here
    steps = TRAIN_EPOCHS * -(-N_TRAIN // TRAIN_BATCH)
    val_batches = TRAIN_EPOCHS * -(-N_VAL // TRAIN_BATCH)
    losses = hist["loss"] + hist["val_loss"]
    _check(all(np.isfinite(losses)), f"non-finite losses {hist}")
    _check(bwd == 4 * steps,
           f"maxpool2x2_backward launched {bwd}x, not 4 x {steps} steps")
    _check(fwd == 4 * steps + 4 * val_batches,
           f"maxpool_pyramid launched {fwd}x, not 4 x ({steps} steps + "
           f"{val_batches} val batches)")
    print(f"phase 6 train: drivers.train in {train_s:.2f} s; loss "
          f"{hist['loss']}, val_loss {hist['val_loss']}, steps/s "
          f"{hist['steps_per_sec']}", flush=True)
    print(f"phase 6 train: maxpool2x2_backward.launches = {bwd} = 4 x "
          f"{steps} steps; maxpool_pyramid.launches = {fwd} = 4 x {steps} "
          f"steps + 4 x {val_batches} val batches; gradient layout copies "
          f"{copies}", flush=True)
    fold = os.path.join(cfg.save_dir, "Fold_1")
    _check(os.path.exists(os.path.join(fold, drivers.BEST_WEIGHTS)),
           "best.pt not written")
    status = _serve_one_png(cfg, fold)
    _check(status == 200, f"serving best.pt answered {status}")
    print(f"phase 6 train: {drivers.BEST_WEIGHTS} written; make_server "
          f"loaded it and answered a PNG request with {status}", flush=True)

    # fixed batch: the loss must fall; the step's time and memory
    model = drivers._build_model(
        cfg, generator=torch.Generator().manual_seed(SEED))
    trainer = Trainer(model, loss=cfg.loss_function,
                      optimizer=cfg.optimizer_function,
                      learning_rate=cfg.learning_rate, device="cuda")
    x, y = synthetic_images(TRAIN_BATCH, SIZE, seed=SEED + 2)
    x, y = trainer.to_device(x), trainer.to_device(y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_losses, step_s = [], []
    for _ in range(FIXED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = trainer.train_step(x, y)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    first, last = (statistics.mean(step_losses[:5]),
                   statistics.mean(step_losses[-5:]))
    _check(all(np.isfinite(step_losses)) and last < first,
           f"fixed-batch loss did not fall: {step_losses}")
    p50 = statistics.median(step_s[5:])
    print(f"phase 6 train: {FIXED_STEPS} steps on one batch of "
          f"{TRAIN_BATCH}: mean loss of the first 5 {first:.5f}, of the "
          f"last 5 {last:.5f}; p50 train step {p50 * 1e3:.3f} ms over the "
          f"last {FIXED_STEPS - 5} (host clock, synchronized), "
          f"{TRAIN_BATCH / p50:.1f} img/s; max_memory_allocated "
          f"{peak} B ({peak / 2 ** 30:.3f} GiB)", flush=True)
    # the verb's own rate: its loader (PNG decode) and host-to-device
    # copies included, which the fixed batch leaves out
    verb_ms = 1e3 / hist["steps_per_sec"][-1]
    print(f"phase 6 train: the train verb's last epoch {verb_ms:.3f} ms a "
          f"step ({hist['steps_per_sec'][-1]:.3f} steps/s, "
          f"{TRAIN_BATCH * hist['steps_per_sec'][-1]:.1f} img/s, "
          f"{-(-N_TRAIN // TRAIN_BATCH)} steps, loader and copies "
          f"included), {verb_ms / (p50 * 1e3):.3f}x the fixed batch's p50",
          flush=True)
    return {"pyramid": fwd, "backward": bwd}


def phase_train_reference() -> None:
    """One float32 train step of a W8/D3 UNet++ on the card (the kernels,
    cuDNN without TF32, deterministic) against the same step on the CPU
    (the plain versions) from the same weights, batch and Adam state."""
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
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.default_rng(SEED + 4)
    x = torch.from_numpy(rng.uniform(size=(2, 64, 64, 3)).astype(np.float32))
    y = torch.from_numpy((rng.uniform(size=(2, 64, 64, 1)) > 0.7).astype(
        np.float32))
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        counts = (pyramid.launches.value, pool_backward.launches.value)
        loss_c, _ = make_train_step(
            cpu, make_optimizer("Adam", cpu.parameters(), lr),
            bce_dice_loss)(x, y)
        _check((pyramid.launches.value, pool_backward.launches.value) == counts,
               "the CPU step launched a kernel")
        loss_g, _ = make_train_step(
            gpu, make_optimizer("Adam", gpu.parameters(), lr),
            bce_dice_loss)(x.cuda(), y.cuda())
        torch.cuda.synchronize()
        launched = (pyramid.launches.value - counts[0],
                    pool_backward.launches.value - counts[1])
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    _check(launched == (3, 3), f"the card's step launched {launched}")
    gp = dict(gpu.named_parameters())
    grad_err = max(float((p.grad - gp[k].grad.cpu()).abs().max())
                   for k, p in cpu.named_parameters())
    gs = gpu.state_dict()
    stat_err = max(float((v - gs[k].cpu()).abs().max())
                   for k, v in cpu.state_dict().items() if "running" in k)
    diffs = torch.cat([(p.detach() - gp[k].detach().cpu()).abs().flatten()
                       for k, p in cpu.named_parameters()])
    loss_err = abs(float(loss_c) - float(loss_g))
    # Adam's first update is about lr * sign(g): a gradient that rounding
    # puts on the other side of 0 moves its parameter by up to 2 * lr
    _check(loss_err <= 1e-5 and grad_err <= 1e-4 and stat_err <= 1e-5
           and float(diffs.max()) <= 2 * lr
           and float((diffs > 1e-5).float().mean()) <= 1e-3,
           f"float32 train step card vs CPU: loss {loss_err}, grads "
           f"{grad_err}, stats {stat_err}, params max {float(diffs.max())}")
    print(f"phase 7 reference: float32 train step of a W8/D3 UNet++ on "
          f"(2, 64, 64, 3), card (kernels 3+3 launches, cuDNN without TF32, "
          f"deterministic) vs CPU (plain versions): loss {loss_err:.3g} <= "
          f"1e-5, grads max-abs {grad_err:.3g} <= 1e-4, running stats "
          f"{stat_err:.3g} <= 1e-5, params max-abs {float(diffs.max()):.3g} "
          f"<= 2 lr with {float((diffs > 1e-5).float().mean()):.3g} of them "
          f"beyond 1e-5 (<= 1e-3)", flush=True)


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
    pyr, bwd = phase_kernels(), phase_pool_backward()
    with tempfile.TemporaryDirectory() as tmp:
        served = phase_serve(tmp)
    phase_reference(served["model"])
    with tempfile.TemporaryDirectory() as tmp:
        trained = phase_train(tmp)
    phase_train_reference()
    pyr["serve"]["launches"] = served["launches"]
    pyr["train"]["launches"] = trained["pyramid"]
    bwd["launches"] = trained["backward"]
    rows = [pyr["serve"], pyr["train"], bwd]
    keys = ("name", "path", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
