"""Deep-supervision target pyramids (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/data/pyramid.py, ``prepare_train_dict`` :26).

- ds_type ``UNet``: level{i} target = the mask max-pooled by 2**i, all
  levels from one launch of the max-pool pyramid kernel on the card
  (``ops/kernels/pyramid.py``), after the mask's host-to-device copy.
  This pairs with heads at stride 2**i: UNet3+'s stride-2 heads.
- ds_type ``UNetPP``: level{i} target = the full-resolution mask (no
  kernel).  This pairs with full-resolution heads: UNet++'s.
"""
from __future__ import annotations

import typing as tp

import torch

from ..ops.kernels.pyramid import fused_maxpool_pyramid

DS_TYPES = ("UNet", "UNetPP")


def prepare_train_dict(mask: torch.Tensor, model_depth: int,
                       ds_type: str = "UNet") -> tp.Dict[str, torch.Tensor]:
    """``{'out', 'level1' .. 'levelD'}`` targets from a full-resolution 2D
    mask, (B, H, W) or NHWC (B, H, W, C); a (B, H, W) mask gains a channel
    axis.  Every target is NHWC, on the mask's device."""
    if ds_type not in DS_TYPES:
        raise ValueError(f"Unknown ds_type {ds_type!r}")
    if mask.dim() == 3:
        mask = mask[..., None]
    elif mask.dim() != 4:
        raise ValueError(f"mask rank {mask.dim()} unsupported (expected "
                         "(B, H, W[, C]))")
    targets = {"out": mask}
    if ds_type == "UNet":
        levels = fused_maxpool_pyramid(mask, model_depth)
    else:
        levels = [mask] * model_depth
    for i, level in enumerate(levels, 1):
        targets[f"level{i}"] = level
    return targets
