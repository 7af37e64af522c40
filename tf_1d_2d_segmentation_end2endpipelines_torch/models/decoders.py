"""Decoders of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/decoders.py).

Ported, both with and without deep supervision: the UNet++ nested grid
(``GridDecoder(variant="PP")``, :223) with transposed-conv upsampling in
the 2D dialect and ConvBlock nodes, without attention gates or ConvLSTM
fusion; and the UNet3+ full-scale decoder (``FullScaleDecoder
(multires=False)``, :324) with ConvBlock nodes.

Every decoder takes ``skips`` = [conv1 .. convD, bottleneck] and returns
``(deconv, levels)``, ``levels`` being the deep-supervision heads in the
reference's order (level{D} first .. level1 last).
"""
from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops import ConvBlock, HeadConv, TransConv, concat, upsample
from ..ops.kernels import pyramid


class _DecoderBase(nn.Module):
    """Shared decoder machinery (JAX ``_DecoderBase``, decoders.py:55):
    ``_up`` is the 2D dialect's transposed conv, ``_resize`` its bilinear
    upsampling, ``_node_block`` one ConvBlock, ``_ds_head`` a 1x1 conv
    named ``level{k}``.  Subclasses create their submodules in flax call
    order, so the flax auto-names (``ConvBlock_<n>``) map one for one.
    ``out_features`` is the width of the ``deconv`` a decoder returns."""

    def __init__(self, model_width: int, model_depth: int, D_S: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model_width = model_width
        self.model_depth = model_depth
        self.D_S = D_S
        self.dtype = dtype

    def _up(self, in_features: int, features: int,
            generator: tp.Optional[torch.Generator]) -> TransConv:
        return TransConv(in_features, features, dtype=self.dtype,
                         generator=generator)

    @staticmethod
    def _resize(x: torch.Tensor, factor: int) -> torch.Tensor:
        return upsample(x, factor, method="bilinear")

    def _node_block(self, in_features: int, features: int,
                    generator: tp.Optional[torch.Generator]) -> ConvBlock:
        return ConvBlock(in_features, features, 3, dtype=self.dtype,
                         generator=generator)

    def _add_ds_head(self, in_features: int, level: int,
                     generator: tp.Optional[torch.Generator],
                     stride: int = 1) -> None:
        self.add_module(f"level{level}", HeadConv(
            in_features, 1, stride=stride, dtype=self.dtype,
            generator=generator))

    def _ds_head(self, x: torch.Tensor, level: int) -> torch.Tensor:
        return getattr(self, f"level{level}")(x)


class GridDecoder(_DecoderBase):
    """The UNet++ grid: node (j, i) upsamples node (j+1, i-1) (or the
    encoder tap at i == 1), concatenates it with nodes (j, 1..i-1) and the
    encoder tap j, and runs a ConvBlock (reference unet_variants.py:277).
    Deep-supervision heads, all at full resolution: level D on the first
    encoder tap, level D - i on node (0, i) for i < D."""

    def __init__(self, model_width: int, model_depth: int,
                 variant: str = "PP", D_S: int = 0, A_G: int = 0,
                 LSTM: int = 0, is_transconv: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(model_width, model_depth, D_S=D_S, dtype=dtype)
        if variant != "PP":
            raise NotImplementedError(
                f"GridDecoder variant {variant!r} is not ported yet")
        if A_G or LSTM or not is_transconv:
            raise NotImplementedError(
                "grid decoders with attention gates, ConvLSTM fusion or "
                "resize upsampling are not ported yet")
        W, D = model_width, model_depth
        self.out_features = W
        if D_S:
            self._add_ds_head(W, D, generator)
        n = 0
        for i in range(1, D + 1):
            for j in range(0, D - i + 1):
                width_j = W * 2 ** j
                self.add_module(f"TransConv_{n}", self._up(
                    2 * width_j, width_j, generator))
                self.add_module(f"ConvBlock_{n}", self._node_block(
                    (i + 1) * width_j, width_j, generator))
                n += 1
            if D_S and i < D:
                self._add_ds_head(W, D - i, generator)

    def forward(self, skips: tp.Sequence[torch.Tensor]
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        D = self.model_depth
        levels: tp.List[torch.Tensor] = []
        if self.D_S:
            levels.append(self._ds_head(skips[0], D))
        deconvs: tp.Dict[tp.Tuple[int, int], torch.Tensor] = {}
        n = 0
        for i in range(1, D + 1):
            for j in range(0, D - i + 1):
                src = skips[j + 1] if i == 1 else deconvs[(j + 1, i - 1)]
                up = getattr(self, f"TransConv_{n}")(src)
                dense = [deconvs[(j, k)] for k in range(1, i)]
                merged = concat(up, *dense, skips[j])
                deconvs[(j, i)] = getattr(self, f"ConvBlock_{n}")(merged)
                n += 1
            if self.D_S and i < D:
                levels.append(self._ds_head(deconvs[(0, i)], D - i))
        return deconvs[(0, D)], levels


class FullScaleDecoder(_DecoderBase):
    """The UNet3+ decoder (reference unet_variants.py:346-376).  Decoder
    step j (level D - j - 1) concatenates: a ConvBlock of the same-level
    encoder tap; ConvBlocks of every higher-resolution tap max-pooled by
    2**((D - j) - k - 1); the sigmoid of the previous node's ConvBlock,
    upsampled by 2; the sigmoids of every earlier node's ConvBlock,
    upsampled to this level; then a ConvBlock of width W * (D + 1).
    Deep-supervision heads are 1x1 convs with stride 2 (half resolution,
    the reference's quirk).  Attention gates, ConvLSTM fusion and the
    upsampling mode do not enter this decoder, in the JAX package too."""

    def __init__(self, model_width: int, model_depth: int, D_S: int = 0,
                 A_G: int = 0, LSTM: int = 0, is_transconv: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(model_width, model_depth, D_S=D_S, dtype=dtype)
        W, D = model_width, model_depth
        self.out_features = W * (D + 1)
        n = 0

        def node(in_features: int, features: int) -> None:
            nonlocal n
            self.add_module(f"ConvBlock_{n}", self._node_block(
                in_features, features, generator))
            n += 1

        for j in range(D):
            node(W * 2 ** (D - j - 1), W)              # same-level tap
            for k in range(0, D - j - 1):
                node(W * 2 ** k, W)                    # pooled taps
            node(W * 2 ** D if j == 0 else W * (D + 1), W)  # previous node
            for _ in range(j):
                node(W * (D + 1), W)                   # earlier nodes
            node(W * (D + 1), W * (D + 1))
            if D_S:
                self._add_ds_head(W * (D + 1), D - j, generator, stride=2)

    def forward(self, skips: tp.Sequence[torch.Tensor]
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        D = self.model_depth
        n = 0

        def node(x: torch.Tensor) -> torch.Tensor:
            nonlocal n
            n += 1
            return getattr(self, f"ConvBlock_{n - 1}")(x)

        levels: tp.List[torch.Tensor] = []
        deconv = skips[-1]
        deconvs: tp.List[torch.Tensor] = []
        # skip k's taps are its max pools by 2**((D - j) - k - 1), one per
        # later step j (JAX: downsample_pool per tap, tf_1d_2d_segmentation_
        # end2endpipelines_tpu/models/decoders.py:353-356); all of them come
        # from one pyramid launch, one read of the skip.  Max is exact, so
        # each tap equals that pool, forward and gradient.
        pooled = [pyramid.maxpool_levels(skips[k], D - 1 - k)
                  for k in range(D - 1)]
        for j in range(D):
            sc_all = node(skips[D - j - 1])
            for k in range(0, D - j - 1):
                sc = pooled[k][(D - j) - k - 2]  # level (D - j) - k - 1
                sc_all = concat(sc_all, node(sc))
            tot = concat(sc_all, torch.sigmoid(self._resize(node(deconv), 2)))
            for m in range(j):
                d = self._resize(node(deconvs[m]), 2 ** (j - m))
                tot = concat(tot, torch.sigmoid(d))
            deconv = node(tot)
            deconvs.append(deconv)
            if self.D_S:
                levels.append(self._ds_head(deconv, D - j))
        return deconv, levels


def build_decoder(decoder_name: str, **kw) -> nn.Module:
    if decoder_name == "UNetPP":
        return GridDecoder(variant="PP", **kw)
    if decoder_name == "UNet3P":
        return FullScaleDecoder(**kw)
    raise NotImplementedError(
        f"decoder {decoder_name!r} is not ported yet (ported: UNetPP, "
        "UNet3P)")
