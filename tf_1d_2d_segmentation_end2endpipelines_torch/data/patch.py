"""Square patches of an image and their reassembly, for the ``test``
verb's patchify mode (JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/
data/patch.py:16-78, its numpy path; the native OpenMP path there gives
the same arrays).

Patches start every ``step = int(patch * (1 - overlap_ratio))`` pixels and
lie wholly inside the image (the ``patchify`` package's grid, reference
utils/helper_functions.py:18-28); reassembly averages overlaps.
"""
from __future__ import annotations

import typing as tp

import numpy as np


def patch_grid(image_size: tp.Tuple[int, int], patch: int,
               overlap_ratio: float) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Top-left corners of the patches: (rows, columns)."""
    step = int(patch * (1 - overlap_ratio))
    if step <= 0:
        raise ValueError("overlap_ratio too large: step must be positive")
    ys = np.arange(0, image_size[0] - patch + 1, step)
    xs = np.arange(0, image_size[1] - patch + 1, step)
    return ys, xs


def create_patches(image: np.ndarray, patch_shape: tp.Tuple[int, int],
                   overlap_ratio: float) -> tp.Tuple[np.ndarray, int]:
    """Cut ``image`` (H, W[, C]) into square patches, row by row.
    Returns (patches (N, p, p[, C]), N)."""
    img = np.asarray(image)
    pw, ph = patch_shape[0], patch_shape[1]
    if pw != ph:
        raise ValueError("The patches are required to be squared shape")
    ys, xs = patch_grid(img.shape[:2], pw, overlap_ratio)
    n = len(ys) * len(xs)
    chan = img.shape[2:]
    out = np.empty((len(ys), len(xs), pw, ph, *chan), dtype=img.dtype)
    for i, y in enumerate(ys):
        for j, x in enumerate(xs):
            out[i, j] = img[y:y + pw, x:x + ph]
    return out.reshape((n, pw, ph, *chan)), n


def unpatchify(patches: np.ndarray, image_size: tp.Tuple[int, int],
               overlap_ratio: float) -> np.ndarray:
    """Reassemble ``create_patches``'s patches into an ``image_size``
    image, averaging where patches overlap (in float64, cast back to the
    patches' dtype); pixels no patch covers are 0."""
    pw = patches.shape[1]
    chan = patches.shape[3:]
    ys, xs = patch_grid(image_size, pw, overlap_ratio)
    acc = np.zeros((*image_size, *chan), dtype=np.float64)
    cnt = np.zeros((*image_size, *chan), dtype=np.float64)
    k = 0
    for y in ys:
        for x in xs:
            acc[y:y + pw, x:x + pw] += patches[k]
            cnt[y:y + pw, x:x + pw] += 1.0
            k += 1
    return (acc / np.maximum(cnt, 1.0)).astype(patches.dtype)
