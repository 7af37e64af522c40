"""Synthetic 1D and 2D segmentation data (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/data/synthetic.py: ``synthetic_signals`` :9,
``synthetic_images`` :31, ``batches`` :59), and a writer of 2D data as an
image folder the train verb reads."""
from __future__ import annotations

import os
import typing as tp

import numpy as np


def synthetic_signals(num: int, length: int = 1024, channels: int = 1,
                      seed: int = 0) -> tp.Tuple[np.ndarray, np.ndarray]:
    """1D binary segmentation: noisy sinusoids with random active windows
    (BASELINE config 1: 1024-sample signals).  Returns float32 (B, L, C)
    signals and (B, L, 1) masks, the JAX function's draws."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 8 * np.pi, length, dtype=np.float32)
    x = np.zeros((num, length, channels), np.float32)
    y = np.zeros((num, length, 1), np.float32)
    for i in range(num):
        base = np.sin(t * rng.uniform(0.5, 2.0)) * rng.uniform(0.5, 1.5)
        for _ in range(rng.integers(1, 4)):
            s = rng.integers(0, length - length // 8)
            e = s + rng.integers(length // 16, length // 8)
            base[s:e] += rng.uniform(2.0, 4.0)
            y[i, s:e, 0] = 1.0
        sig = base + rng.normal(0, 0.1, length)
        for c in range(channels):
            x[i, :, c] = sig
    return x, y


def batches(x: np.ndarray, y, batch_size: int, shuffle: bool = True,
            seed: int = 0, drop_remainder: bool = True):
    """Host batch iterator factory (a reusable callable, as the trainer
    takes).  Call ``e`` (from 0) shuffles with ``seed + e``, the JAX
    function's order; ``y`` may be an array or a dict of arrays.  The
    callable's ``set_epoch`` sets the counter, so exact resume replays the
    interrupted run's data order."""
    n = x.shape[0]
    state = {"epoch": 0}

    def it():
        e, state["epoch"] = state["epoch"], state["epoch"] + 1
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed + e).shuffle(idx)
        stop = n - (n % batch_size) if drop_remainder else n
        for s in range(0, stop, batch_size):
            sel = idx[s:s + batch_size]
            if isinstance(y, dict):
                yield x[sel], {k: v[sel] for k, v in y.items()}
            else:
                yield x[sel], y[sel]

    it.set_epoch = lambda epoch: state.__setitem__("epoch", int(epoch))
    return it


def synthetic_images(num: int, size: int = 256, channels: int = 3,
                     classes: int = 1, seed: int = 0
                     ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Random bright blobs on noise; the mask marks the blobs.
    ``classes == 1`` gives a binary mask; otherwise one-hot multiclass.
    Returns float32 NHWC images in [0, 1] and masks."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 0.1, (num, size, size, channels)).astype(np.float32)
    if classes == 1:
        y = np.zeros((num, size, size, 1), np.float32)
    else:
        y = np.zeros((num, size, size, classes), np.float32)
        y[..., 0] = 1.0
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(num):
        for _ in range(rng.integers(1, 5)):
            cy, cx = rng.integers(0, size, 2)
            r = rng.integers(size // 16, size // 6)
            blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
            cls = int(rng.integers(1, classes)) if classes > 1 else 0
            x[i][blob] += rng.uniform(0.4, 0.8)
            if classes == 1:
                y[i, :, :, 0][blob] = 1.0
            else:
                y[i, :, :, 0][blob] = 0.0
                y[i, :, :, cls][blob] = 1.0
    return np.clip(x, 0, 1), y


def write_image_folder(directory: str, images: np.ndarray,
                       masks: np.ndarray) -> None:
    """Write NHWC images in [0, 1] and binary masks (N, H, W, 1) as 8-bit
    PNGs under ``directory/images`` and ``directory/masks`` (the layout
    ``SegmentationFolderDataset`` reads), named ``00000.png`` on."""
    from PIL import Image

    for sub in ("images", "masks"):
        os.makedirs(os.path.join(directory, sub), exist_ok=True)
    for i, (img, msk) in enumerate(zip(images, masks)):
        name = f"{i:05d}.png"
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(
            os.path.join(directory, "images", name))
        Image.fromarray(np.round(msk[..., 0] * 255).astype(np.uint8)).save(
            os.path.join(directory, "masks", name))
