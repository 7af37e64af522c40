"""Deep-supervision target pyramids (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/data/pyramid.py, ``prepare_train_dict`` :26).

- ds_type ``UNet``: level{i} target = the mask max-pooled by 2**i, all
  levels from one launch of the max-pool pyramid kernel on the card
  (``ops/kernels/pyramid.py``), after the mask's host-to-device copy.
  This pairs with heads at stride 2**i: UNet3+'s stride-2 heads.
- ds_type ``UNetPP``: level{i} target = the full-resolution mask (no
  kernel).  This pairs with full-resolution heads: UNet++'s.

A 1D mask (``spatial_rank=1``, (B, L) or (B, L, C)) takes the 1D pyramid
(``maxpool1d_pyramid``, one launch for all levels).
"""
from __future__ import annotations

import typing as tp

import torch

from ..ops.kernels.pyramid import fused_maxpool_pyramid, maxpool1d_pyramid

DS_TYPES = ("UNet", "UNetPP")


def prepare_train_dict(mask: torch.Tensor, model_depth: int,
                       ds_type: str = "UNet",
                       spatial_rank: tp.Optional[int] = None
                       ) -> tp.Dict[str, torch.Tensor]:
    """``{'out', 'level1' .. 'levelD'}`` targets from a full-resolution
    mask: 2D, (B, H, W) or NHWC (B, H, W, C), or 1D, (B, L) or (B, L, C).
    A mask without a channel axis gains one.  ``spatial_rank`` (1 or 2)
    tells a 1D (B, L, C) mask from a 2D (B, H, W) one; left out, a rank-3
    mask is 1D when its last axis is 1 and 2D otherwise, as the JAX
    function infers it (data/pyramid.py:26-59).  Every target keeps the
    mask's layout (NHWC or NLC), on the mask's device."""
    if ds_type not in DS_TYPES:
        raise ValueError(f"Unknown ds_type {ds_type!r}")
    if mask.dim() == 2:
        spatial_rank, mask = 1, mask[..., None]
    elif mask.dim() == 3:
        if spatial_rank is None:
            spatial_rank = 1 if mask.shape[-1] == 1 else 2
        if spatial_rank == 2:
            mask = mask[..., None]
    elif mask.dim() == 4:
        spatial_rank = 2
    else:
        raise ValueError(f"mask rank {mask.dim()} unsupported (expected "
                         "(B, *spatial[, C]))")
    targets = {"out": mask}
    if ds_type == "UNetPP":
        levels = [mask] * model_depth
    elif spatial_rank == 2:
        levels = fused_maxpool_pyramid(mask, model_depth)
    else:
        # (B, L, C) -> the (B, C, 1, L) channels_last view, one launch
        pooled = maxpool1d_pyramid(
            mask.contiguous().permute(0, 2, 1).unsqueeze(2), model_depth)
        levels = [p[:, :, 0].permute(0, 2, 1) for p in pooled]
    for i, level in enumerate(levels, 1):
        targets[f"level{i}"] = level
    return targets
