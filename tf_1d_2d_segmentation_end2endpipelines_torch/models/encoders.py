"""Encoders and latent layer of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/encoders.py).

Every branch of the JAX module: the ConvBlock encoder (encoders.py:
103-107), the MultiRes encoder of MultiResUNet and MultiResUNet3+
(:59-70), KSSNet's (:71-84), the dense-input one of UNet4P, UNet4PV2 and
AHNet (:85-96) and the Self-ONN one (:97-101); the DenseBlock latent
(:136-137), the MultiResBlock latent (:130-132) and the
OperationalDenseBlock latent (:133-135); the pretrained backbone's tap
projector (:140) on every branch: MultiRes (:165-167), KSSNet
(:168-180), the gated UNet4P/UNet4PV2/AHNet one (:181-192), Self-ONN
(:193-195) and the default (:196-199).
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
#: families whose encoder feeds each block the sigmoid-gated pools of every
#: earlier tap (ConvBlocks; AHNet's taps each through a fresh ResPath)
DENSE_INPUT_FAMILIES = ("UNet4P", "UNet4PV2", "AHNet")


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
    - UNet4P and UNet4PV2: ``ConvBlock_<i-1>`` at level i, as the UNet
      genre's, its input the pool concatenated with the sigmoid of every
      earlier tap k max-pooled by 2**(i-k).  The chain's pool of tap i - 1
      is its pool by 2, so each tap is pooled once, by one pyramid launch
      storing levels 1 .. D + 1 - k (D launches a forward, D (D + 1) / 2
      pool gradients).
    - AHNet: as UNet4P, each earlier tap k first through its own fresh
      ``ResPath(D - k, W)`` (``ResPath_<n>`` in call order), so each pool
      is one level of a different tensor, and the chain pools the blocks'
      own outputs (D (D + 1) / 2 + D launches a forward, as many
      gradients).  At depth 5 both pool tap 1 by 32.

    The JAX module also pools the deepest level; nothing reads that pool,
    so XLA drops it, and here it is not computed: D encoder pools per
    forward.  ``out_features`` is the width of the deepest level's
    output (the bottleneck of the FPN genre, which has no latent)."""

    def __init__(self, decoder_name: str, in_features: int, model_width: int,
                 model_depth: int, alpha: float = 1.0, q: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.depth = model_depth
        self.multires = decoder_name in MULTIRES_FAMILIES
        self.kssnet = decoder_name == "KSSNet"
        self.dense_input = decoder_name in DENSE_INPUT_FAMILIES
        self.ahnet = decoder_name == "AHNet"
        self.unit = ("Oper" if decoder_name.startswith("Self")
                     else "ConvBlock")
        W, D = model_width, model_depth
        cin = in_features
        n_paths = 0
        for i in range(D + 1):
            width = W * 2 ** i
            if self.dense_input:  # the gated taps 1 .. i after the pool
                for k in range(i):
                    if self.ahnet:
                        self.add_module(f"ResPath_{n_paths}", ResPath(
                            W * 2 ** k, D - k - 1, W, 3, dtype=dtype,
                            generator=generator))
                        n_paths += 1
                    cin += W if self.ahnet else W * 2 ** k
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
        if self.dense_input:
            return self._dense_input_forward(x)
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

    def _dense_input_forward(self, x: torch.Tensor
                             ) -> tp.Tuple[tp.List[torch.Tensor],
                                           torch.Tensor]:
        D = self.depth
        taps: tp.List[torch.Tensor] = []
        # UNet4P/UNet4PV2: tap_pools[k][l - 1] is tap k max-pooled by 2**l
        tap_pools: tp.List[tp.List[torch.Tensor]] = []
        n_paths = 0
        for i in range(D + 1):
            if i and self.ahnet:
                gated = []
                for k in range(i):
                    g = getattr(self, f"ResPath_{n_paths}")(taps[k])
                    n_paths += 1
                    gated.append(downsample_pool(g, 2 ** (i - k), op="max"))
                x = concat(downsample_pool(taps[i - 1], 2, op="max"),
                           *[torch.sigmoid(g) for g in gated])
            elif i:
                x = concat(tap_pools[i - 1][0],
                           *[torch.sigmoid(tap_pools[k][i - k - 1])
                             for k in range(i)])
            taps.append(getattr(self, f"ConvBlock_{i}")(x))
            if i < D and not self.ahnet:
                tap_pools.append(pyramid.maxpool_levels(taps[i], D - i))
        return taps, taps[-1]


class PretrainedTapProjector(nn.Module):
    """A pretrained backbone's tap at ``level`` (1-based) projected to the
    decoder's width feats = W * 2**(level - 1) (JAX
    ``PretrainedTapProjector``, encoders.py:140), by branch:

    - default (:196-199): a bare conv (``ConvBlock_0`` without BatchNorm
      or activation), 3x3 at level 1 and 1x1 deeper; Self-ONN
      (:193-195): ``Oper_0`` of order ``q`` with the same kernels;
    - MultiResUNet and MultiResUNet3+ (:165-167): ``MultiResBlock_0`` of
      width feats, then ``ResPath_0`` of length D - level + 1;
    - KSSNet (:168-180): at level 1 ``MultiResBlock_0`` and ``ResPath_0``
      of length D; deeper, ``ConvBlock_0`` (bare 1x1 to feats), the
      sigmoid of each earlier projected tap k max-pooled by 2**(level -
      k) concatenated to it, ``MultiResBlock_0`` and ``ResPath_0`` of
      length D - 1;
    - UNet4P and UNet4PV2 (:181-192): at level 1 a bare 3x3 ``ConvBlock_0``;
      deeper, the bare 1x1 ``ConvBlock_0``, the gated pools of the earlier
      taps as KSSNet's, and ``ConvBlock_1`` (3x3, BatchNorm, ReLU);
    - AHNet: as UNet4P, each earlier tap k first through its own
      ``ResPath_<k-1>`` of length D - k and width feats.

    ``forward(x, pools, prev)``: KSSNet and UNet4P take ``pools``, where
    ``pools[k - 1][m - 1]`` is projected tap k max-pooled by 2**m (its
    pyramid, one launch a tap, ``SegModel`` builds them); AHNet takes
    ``prev``, the projected taps themselves."""

    def __init__(self, decoder_name: str, level: int, in_features: int,
                 model_width: int, model_depth: int = 1, alpha: float = 1.0,
                 q: int = 3, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        W, D = model_width, model_depth
        feats = W * 2 ** (level - 1)
        kw = dict(dtype=dtype, generator=generator)
        self.level = level
        self.branch = ("multires" if decoder_name in ("MultiResUNet",
                                                       "MultiResUNet3P")
                       else "kssnet" if decoder_name == "KSSNet"
                       else "gated" if decoder_name in DENSE_INPUT_FAMILIES
                       else "self" if decoder_name.startswith("Self")
                       else "default")
        self.ahnet = decoder_name == "AHNet"
        kernel = 3 if level == 1 else 1
        if self.branch == "self":
            self.Oper_0 = Oper(in_features, feats, kernel, q=q, **kw)
        elif self.branch == "default" or (self.branch == "gated"
                                          and level == 1):
            self.ConvBlock_0 = ConvBlock(in_features, feats, kernel,
                                         use_bn=False, activation=None, **kw)
        elif self.branch == "multires" or level == 1:  # KSSNet's level 1
            self.MultiResBlock_0 = MultiResBlock(in_features, feats, 3,
                                                 alpha=alpha, **kw)
            length = D - level + 1 if self.branch == "multires" else D
            self.ResPath_0 = ResPath(self.MultiResBlock_0.out_features,
                                     length, feats, 3, **kw)
        else:  # KSSNet, UNet4P, UNet4PV2 and AHNet below level 1
            self.ConvBlock_0 = ConvBlock(in_features, feats, 1, use_bn=False,
                                         activation=None, **kw)
            cin = feats
            for k in range(1, level):
                if self.ahnet:
                    self.add_module(f"ResPath_{k - 1}", ResPath(
                        W * 2 ** (k - 1), D - k, feats, 3, **kw))
                    cin += feats
                else:
                    cin += W * 2 ** (k - 1)
            if self.branch == "kssnet":
                self.MultiResBlock_0 = MultiResBlock(cin, feats, 3,
                                                     alpha=alpha, **kw)
                self.ResPath_0 = ResPath(self.MultiResBlock_0.out_features,
                                         D - 1, feats, 3, **kw)
            else:
                self.ConvBlock_1 = ConvBlock(cin, feats, 3, **kw)
        self.out_features = feats

    def forward(self, x: torch.Tensor,
                pools: tp.Sequence[tp.Sequence[torch.Tensor]] = (),
                prev: tp.Sequence[torch.Tensor] = ()) -> torch.Tensor:
        lvl = self.level
        if self.branch == "self":
            return self.Oper_0(x)
        if self.branch == "default" or (self.branch == "gated" and lvl == 1):
            return self.ConvBlock_0(x)
        if self.branch == "multires" or lvl == 1:
            return self.ResPath_0(self.MultiResBlock_0(x))
        x = self.ConvBlock_0(x)
        gated = []
        for k in range(1, lvl):
            if self.ahnet:
                g = getattr(self, f"ResPath_{k - 1}")(prev[k - 1])
                g = downsample_pool(g, 2 ** (lvl - k), op="max")
            else:
                g = pools[k - 1][lvl - k - 1]
            gated.append(torch.sigmoid(g))
        x = concat(x, *gated)
        if self.branch == "kssnet":
            return self.ResPath_0(self.MultiResBlock_0(x))
        return self.ConvBlock_1(x)


class LatentLayer(nn.Module):
    """Bottleneck of width W * 2**D: a DenseBlock for the UNet genre, a
    ``MultiResBlock`` (its truncated width) for the MultiRes families, an
    ``OperationalDenseBlock`` of order ``q`` and ``dense_loop`` residual
    Opers for the Self-ONN family; ``out_features`` is its output's width.
    ``in_features`` (default: the from-scratch encoder's W * 2**D, or
    its MultiRes block's width) is a pretrained model's: its projected tap
    D, W * 2**D wide on every branch, or at depth 5 the backbone's top."""

    def __init__(self, decoder_name: str, model_width: int, model_depth: int,
                 dense_loop: int = 1, alpha: float = 1.0, q: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 in_features: tp.Optional[int] = None):
        super().__init__()
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
