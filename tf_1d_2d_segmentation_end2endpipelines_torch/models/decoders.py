"""Decoders of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/decoders.py).

Ported: the UNet++ nested grid (``GridDecoder(variant="PP")``, :223) with
transposed-conv upsampling in the 2D dialect and ConvBlock nodes, without
deep supervision, attention gates or ConvLSTM fusion.
"""
from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops import ConvBlock, TransConv, concat


class _DecoderBase(nn.Module):
    """Shared decoder machinery (JAX ``_DecoderBase``, decoders.py:55):
    ``_up`` is the 2D dialect's transposed conv, ``_node_block`` one
    ConvBlock.  Subclasses name them in call order, as flax does."""

    def __init__(self, model_width: int, model_depth: int, D_S: int = 0,
                 A_G: int = 0, LSTM: int = 0, is_transconv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if D_S or A_G or LSTM or not is_transconv:
            raise NotImplementedError(
                "decoders with deep supervision, attention gates, ConvLSTM "
                "fusion or resize upsampling are not ported yet")
        self.model_width = model_width
        self.model_depth = model_depth
        self.dtype = dtype

    def _up(self, in_features: int, features: int,
            generator: tp.Optional[torch.Generator]) -> TransConv:
        return TransConv(in_features, features, dtype=self.dtype,
                         generator=generator)

    def _node_block(self, in_features: int, features: int,
                    generator: tp.Optional[torch.Generator]) -> ConvBlock:
        return ConvBlock(in_features, features, 3, dtype=self.dtype,
                         generator=generator)


class GridDecoder(_DecoderBase):
    """The UNet++ grid: node (j, i) upsamples node (j+1, i-1) (or the
    encoder tap at i == 1), concatenates it with nodes (j, 1..i-1) and the
    encoder tap j, and runs a ConvBlock (reference unet_variants.py:277)."""

    def __init__(self, model_width: int, model_depth: int,
                 variant: str = "PP",
                 generator: tp.Optional[torch.Generator] = None, **kw):
        super().__init__(model_width, model_depth, **kw)
        if variant != "PP":
            raise NotImplementedError(
                f"GridDecoder variant {variant!r} is not ported yet")
        W, D = model_width, model_depth
        n = 0
        for i in range(1, D + 1):
            for j in range(0, D - i + 1):
                width_j = W * 2 ** j
                self.add_module(f"TransConv_{n}", self._up(
                    2 * width_j, width_j, generator))
                self.add_module(f"ConvBlock_{n}", self._node_block(
                    (i + 1) * width_j, width_j, generator))
                n += 1

    def forward(self, skips: tp.Sequence[torch.Tensor]
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        D = self.model_depth
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
        return deconvs[(0, D)], []


def build_decoder(decoder_name: str, **kw) -> nn.Module:
    if decoder_name == "UNetPP":
        return GridDecoder(variant="PP", **kw)
    raise NotImplementedError(
        f"decoder {decoder_name!r} is not ported yet (ported: UNetPP)")
