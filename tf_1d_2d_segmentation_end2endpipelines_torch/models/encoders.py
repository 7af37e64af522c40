"""From-scratch encoder and latent layer of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/encoders.py).

Only the default families' branches are ported: the ConvBlock encoder
(encoders.py:103-107) and the DenseBlock latent (:136-137).
"""
from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops import ConvBlock, DenseBlock, downsample_pool

# families whose encoder or latent is a different branch in the JAX package
_OTHER_BRANCHES = ("MultiResUNet", "MultiResUNet3P", "KSSNet", "UNet4P",
                   "UNet4PV2", "AHNet")


def _check_family(decoder_name: str, what: str) -> None:
    if decoder_name in _OTHER_BRANCHES or decoder_name.startswith("Self"):
        raise NotImplementedError(
            f"{what} for {decoder_name!r} is not ported yet")


class ScratchEncoder(nn.Module):
    """``model_depth + 1`` levels of ConvBlock, each but the last followed
    by a 2x2 max pool.  Returns (taps, bottom) as the JAX module does.

    The JAX module also pools the deepest level; nothing reads that pool,
    so XLA drops it, and here it is not computed: D pools per forward."""

    def __init__(self, decoder_name: str, in_features: int, model_width: int,
                 model_depth: int, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        _check_family(decoder_name, "ScratchEncoder")
        self.depth = model_depth
        for i in range(model_depth + 1):
            cin = in_features if i == 0 else model_width * 2 ** (i - 1)
            self.add_module(f"ConvBlock_{i}", ConvBlock(
                cin, model_width * 2 ** i, 3, dtype=dtype,
                generator=generator))

    def forward(self, x: torch.Tensor
                ) -> tp.Tuple[tp.List[torch.Tensor], torch.Tensor]:
        taps: tp.List[torch.Tensor] = []
        conv = x
        for i in range(self.depth + 1):
            if i:
                x = downsample_pool(conv, 2, op="max")
            conv = getattr(self, f"ConvBlock_{i}")(x)
            taps.append(conv)
        return taps, conv


class LatentLayer(nn.Module):
    """Bottleneck of the UNet genre: a DenseBlock of width W * 2**D."""

    def __init__(self, decoder_name: str, model_width: int, model_depth: int,
                 dense_loop: int = 1, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        _check_family(decoder_name, "LatentLayer")
        feats = model_width * 2 ** model_depth
        self.DenseBlock_0 = DenseBlock(feats, feats, 3, num_layers=dense_loop,
                                       dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.DenseBlock_0(x)
