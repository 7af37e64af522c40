""".pt tensor-file IO for the 1D pipeline (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/data/pt_io.py:16-90, a copy of its functions).

The reference's 1D notebook stores datasets as torch ``.pt`` containers
(1D_Segmentation.ipynb cells 22-24, 35).  Tensors come back as numpy,
channels-last float32 (B, L, C), as the JAX package loads them.
"""
from __future__ import annotations

import typing as tp

import numpy as np
import torch


def load_pt(path: str) -> tp.Any:
    """Load a .pt file into numpy (arrays / dicts / tuples of arrays)."""

    def to_np(obj):
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu().numpy()
        if isinstance(obj, dict):
            return {k: to_np(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(to_np(v) for v in obj)
        return obj

    return to_np(torch.load(path, map_location="cpu", weights_only=False))


def save_pt(obj: tp.Any, path: str) -> None:
    """Save numpy arrays (in dicts, lists or tuples) as torch tensors."""

    def to_t(o):
        if isinstance(o, np.ndarray):
            return torch.from_numpy(o)
        if isinstance(o, dict):
            return {k: to_t(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(to_t(v) for v in o)
        return o

    torch.save(to_t(obj), path)


def normalize_signal_array(a) -> np.ndarray:
    """The layout convention shared by every .pt reader: channels-last
    float32 (B, L, C) -- a trailing channel axis is added when missing,
    and channel-first (B, C, L) layouts with small C are moved to
    channels-last."""
    a = np.asarray(a, np.float32)
    if a.ndim == 2:
        a = a[..., None]
    elif a.ndim == 3 and a.shape[1] <= 16 < a.shape[2]:
        a = np.moveaxis(a, 1, 2)  # (B, C, L) -> (B, L, C)
    return a


def load_signal_dataset(path: str, x_key: str = "samples",
                        y_key: str = "labels"
                        ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Load an (X, Y) signal dataset from a .pt container: a dict (by
    key) or an (X, Y) tuple; both normalized by
    :func:`normalize_signal_array`."""
    obj = load_pt(path)
    if isinstance(obj, dict):
        x, y = obj[x_key], obj[y_key]
    elif isinstance(obj, (list, tuple)) and len(obj) == 2:
        x, y = obj
    else:
        raise ValueError(f"unrecognized .pt container structure in {path}")
    return normalize_signal_array(x), normalize_signal_array(y)


def load_signal_inputs(path: str, x_key: str = "samples") -> np.ndarray:
    """Load samples only (for unlabeled inference): a dict (by
    ``x_key``), an (X, ...) tuple, or a bare stacked array; normalized as
    :func:`load_signal_dataset` does."""
    obj = load_pt(path)
    if isinstance(obj, dict):
        x = obj[x_key]
    elif isinstance(obj, (list, tuple)) and obj:
        x = obj[0]
    else:
        x = obj
    return normalize_signal_array(x)
