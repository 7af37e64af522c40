"""Encoders and latent layer of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/encoders.py).

Ported: the ConvBlock encoder (encoders.py:103-107), the MultiRes encoder
of MultiResUNet and MultiResUNet3+ (:59-70), KSSNet's (:71-84) and the
Self-ONN one (:97-101); the DenseBlock latent (:136-137), the
MultiResBlock latent (:130-132) and the OperationalDenseBlock latent
(:133-135); the pretrained backbone's tap projector (:140) on its default
branch (:194-197) and its Self-ONN branch (:193-195).
"""
from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops import (ConvBlock, DenseBlock, MultiResBlock, Oper,
                   OperationalDenseBlock, ResPath, concat, downsample_pool,
                   multires_features)
from ..ops.kernels import pyramid

#: families whose encoder and latent are MultiRes blocks
MULTIRES_FAMILIES = ("MultiResUNet", "MultiResUNet3P", "KSSNet")
# families whose encoder or latent is a branch not ported yet
_OTHER_BRANCHES = ("UNet4P", "UNet4PV2", "AHNet")


def _check_family(decoder_name: str, what: str) -> None:
    if decoder_name in _OTHER_BRANCHES:
        raise NotImplementedError(
            f"{what} for {decoder_name!r} is not ported yet")


class ScratchEncoder(nn.Module):
    """``model_depth + 1`` levels, each but the last followed by a 2x2 max
    pool.  Returns (taps, bottom) as the JAX module does.

    - The UNet genre: a ConvBlock of width W * 2**(i-1) at level i; the
      taps are the blocks' outputs.
    - MultiResUNet and MultiResUNet3+: ``MultiResBlock_<i-1>`` at level i;
      tap i (i <= D) is ``ResPath_<i-1>`` of length D - i + 1 over it,
      tap D + 1 the block's own output (its ResPath is dangling in the
      reference's graph and is not built).
    - The Self-ONN family (``Self*``): ``Oper_<i-1>`` of order ``q``
      (kernel 3, no BatchNorm or activation) at level i; the taps are
      its outputs, signed and unbounded, which the pools take as they
      come.
    - KSSNet: as the MultiRes encoder, and before block i the pool is
      concatenated, for k = 1 .. i-1, with the sigmoid of tap k max-pooled
      by 2**(i-k).  Each tap's pools come from one pyramid launch when the
      tap exists (``pyramid.maxpool_levels``: levels 1 .. D + 1 - k),
      whose gradient is that of the separate pools.

    The JAX module also pools the deepest level; nothing reads that pool,
    so XLA drops it, and here it is not computed: D encoder pools per
    forward.  ``out_features`` is the width of the deepest level's
    output (the bottleneck of the FPN genre, which has no latent)."""

    def __init__(self, decoder_name: str, in_features: int, model_width: int,
                 model_depth: int, alpha: float = 1.0, q: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        _check_family(decoder_name, "ScratchEncoder")
        self.depth = model_depth
        self.multires = decoder_name in MULTIRES_FAMILIES
        self.kssnet = decoder_name == "KSSNet"
        self.unit = ("Oper" if decoder_name.startswith("Self")
                     else "ConvBlock")
        W, D = model_width, model_depth
        cin = in_features
        for i in range(D + 1):
            width = W * 2 ** i
            if not self.multires:
                self.add_module(f"{self.unit}_{i}", Oper(
                    cin, width, 3, q=q, dtype=dtype, generator=generator)
                    if self.unit == "Oper" else ConvBlock(
                    cin, width, 3, dtype=dtype, generator=generator))
                cin = width
                continue
            if self.kssnet:  # the gated taps 1 .. i concatenated to the pool
                cin += sum(W * 2 ** k for k in range(i))
            block = MultiResBlock(cin, width, 3, alpha=alpha, dtype=dtype,
                                  generator=generator)
            self.add_module(f"MultiResBlock_{i}", block)
            cin = block.out_features
            if i < D:
                self.add_module(f"ResPath_{i}", ResPath(
                    cin, D - i, width, 3, dtype=dtype, generator=generator))
        self.out_features = cin

    def forward(self, x: torch.Tensor
                ) -> tp.Tuple[tp.List[torch.Tensor], torch.Tensor]:
        D = self.depth
        taps: tp.List[torch.Tensor] = []
        # KSSNet: tap_pools[k][l - 1] is tap k max-pooled by 2**l
        tap_pools: tp.List[tp.List[torch.Tensor]] = []
        conv = x
        for i in range(D + 1):
            if i:
                x = downsample_pool(conv, 2, op="max")
            if not self.multires:
                conv = getattr(self, f"{self.unit}_{i}")(x)
                taps.append(conv)
                continue
            if self.kssnet:
                x = concat(x, *[torch.sigmoid(tap_pools[k][i - k - 1])
                                for k in range(i)])
            conv = getattr(self, f"MultiResBlock_{i}")(x)
            if i == D:
                taps.append(conv)
                break
            taps.append(getattr(self, f"ResPath_{i}")(conv))
            if self.kssnet:
                tap_pools.append(pyramid.maxpool_levels(taps[i], D - i))
        return taps, conv


class PretrainedTapProjector(nn.Module):
    """A pretrained backbone's tap at ``level`` (1-based) projected to the
    decoder's width W * 2**(level - 1) (JAX ``PretrainedTapProjector``,
    encoders.py:140): on the default branch (:194-197), a bare conv
    (``ConvBlock_0`` without BatchNorm or activation), 3x3 at level 1 and
    1x1 deeper; on the Self-ONN branch (:193-195), ``Oper_0`` of order
    ``q`` with the same kernels.  The MultiRes, KSSNet and UNet4P/AHNet
    branches (:165-192) raise ``NotImplementedError``."""

    def __init__(self, decoder_name: str, level: int, in_features: int,
                 model_width: int, q: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        if decoder_name in MULTIRES_FAMILIES + _OTHER_BRANCHES:
            raise NotImplementedError(
                f"the pretrained-encoder tap projector for {decoder_name!r} "
                "is not ported yet (ported: the default branch, a bare "
                "conv a level, and the Self-ONN one)")
        feats = model_width * 2 ** (level - 1)
        kernel = 3 if level == 1 else 1
        if decoder_name.startswith("Self"):
            self._unit = "Oper_0"
            self.Oper_0 = Oper(in_features, feats, kernel, q=q, dtype=dtype,
                               generator=generator)
        else:
            self._unit = "ConvBlock_0"
            self.ConvBlock_0 = ConvBlock(
                in_features, feats, kernel, use_bn=False, activation=None,
                dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self._unit)(x)


class LatentLayer(nn.Module):
    """Bottleneck of width W * 2**D: a DenseBlock for the UNet genre, a
    ``MultiResBlock`` (its truncated width) for the MultiRes families, an
    ``OperationalDenseBlock`` of order ``q`` and ``dense_loop`` residual
    Opers for the Self-ONN family; ``out_features`` is its output's width.
    ``in_features`` (default: the from-scratch encoder's W * 2**D, or
    its MultiRes block's width) is a pretrained backbone's at depth 5."""

    def __init__(self, decoder_name: str, model_width: int, model_depth: int,
                 dense_loop: int = 1, alpha: float = 1.0, q: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 in_features: tp.Optional[int] = None):
        super().__init__()
        _check_family(decoder_name, "LatentLayer")
        feats = model_width * 2 ** model_depth
        if decoder_name in MULTIRES_FAMILIES:
            self.MultiResBlock_0 = MultiResBlock(
                in_features or multires_features(feats, alpha), feats, 3,
                alpha=alpha, dtype=dtype, generator=generator)
            self._block = "MultiResBlock_0"
            self.out_features = self.MultiResBlock_0.out_features
        elif decoder_name.startswith("Self"):
            self.OperationalDenseBlock_0 = OperationalDenseBlock(
                in_features or feats, feats, 3, num_layers=dense_loop, q=q,
                dtype=dtype, generator=generator)
            self._block = "OperationalDenseBlock_0"
            self.out_features = feats
        else:
            self.DenseBlock_0 = DenseBlock(in_features or feats, feats, 3,
                                           num_layers=dense_loop,
                                           dtype=dtype, generator=generator)
            self._block = "DenseBlock_0"
            self.out_features = feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self._block)(x)
