"""Synthetic 2D segmentation data
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/data/synthetic.py:31),
and a writer of such data as an image folder the train verb reads."""
from __future__ import annotations

import os
import typing as tp

import numpy as np


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
