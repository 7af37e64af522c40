"""Decoders of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/decoders.py).

Ported, both with and without deep supervision, with ConvBlock nodes and
without attention gates or ConvLSTM fusion: the UNet chain
(``ChainDecoder(style="unet")``, :166), the UNetE, UNetP and UNet++ grids
(``GridDecoder`` variants ``E``, ``P`` and ``PP``, :223), each upsampling
by the 2D dialect's transposed conv or by bilinear resize
(``is_transconv``); and the UNet3+ full-scale decoder
(``FullScaleDecoder(multires=False)``, :324).

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
    ``_up`` upsamples by 2, by the 2D dialect's transposed conv
    (``TransConv_<n>``) or, with ``is_transconv`` off, by bilinear resize,
    which keeps the source's width; ``_resize`` is bilinear upsampling,
    ``_node_block`` one ConvBlock, ``_ds_head`` a 1x1 conv named
    ``level{k}``.  Subclasses create their submodules in flax call order,
    so the flax auto-names (``TransConv_<n>``, ``ConvBlock_<n>``) map one
    for one.  ``out_features`` is the width of the ``deconv`` a decoder
    returns."""

    def __init__(self, model_width: int, model_depth: int, D_S: int = 0,
                 is_transconv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model_width = model_width
        self.model_depth = model_depth
        self.D_S = D_S
        self.is_transconv = is_transconv
        self.dtype = dtype

    def _add_up(self, n: int, in_features: int, features: int,
                generator: tp.Optional[torch.Generator]) -> int:
        """Create node ``n``'s upsampling; returns the upsampled width."""
        if not self.is_transconv:
            return in_features
        self.add_module(f"TransConv_{n}", TransConv(
            in_features, features, dtype=self.dtype, generator=generator))
        return features

    def _up(self, x: torch.Tensor, n: int) -> torch.Tensor:
        if self.is_transconv:
            return getattr(self, f"TransConv_{n}")(x)
        return upsample(x, 2, method="bilinear")

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


class ChainDecoder(_DecoderBase):
    """The UNet chain (reference unet_variants.py:125-154): step j
    upsamples the previous step's output (the bottleneck at j == 0),
    concatenates it with encoder tap D - j - 1 and runs a ConvBlock of
    width W * 2**(D - j - 1).  Deep-supervision head level D - j is a 1x1
    conv on the step's input, before the upsampling, so level k sits at
    1 / 2**k of the input's resolution."""

    def __init__(self, model_width: int, model_depth: int,
                 style: str = "unet", D_S: int = 0, A_G: int = 0,
                 LSTM: int = 0, is_transconv: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(model_width, model_depth, D_S=D_S,
                         is_transconv=is_transconv, dtype=dtype)
        if style != "unet":
            raise NotImplementedError(
                f"ChainDecoder style {style!r} is not ported yet")
        if A_G or LSTM:
            raise NotImplementedError(
                "chain decoders with attention gates or ConvLSTM fusion "
                "are not ported yet")
        W, D = model_width, model_depth
        self.out_features = W
        for j in range(D):
            width_j = W * 2 ** (D - j - 1)
            if D_S:
                self._add_ds_head(2 * width_j, D - j, generator)
            up = self._add_up(j, 2 * width_j, width_j, generator)
            self.add_module(f"ConvBlock_{j}", self._node_block(
                up + width_j, width_j, generator))

    def forward(self, skips: tp.Sequence[torch.Tensor]
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        D = self.model_depth
        levels: tp.List[torch.Tensor] = []
        deconv = skips[-1]
        for j in range(D):
            if self.D_S:
                levels.append(self._ds_head(deconv, D - j))
            merged = concat(self._up(deconv, j), skips[D - j - 1])
            deconv = getattr(self, f"ConvBlock_{j}")(merged)
        return deconv, levels


class GridDecoder(_DecoderBase):
    """The (j, i) grids: node (j, i) upsamples node (j+1, i-1) (or the
    encoder tap j + 1 at i == 1), concatenates it with a skip and runs a
    ConvBlock of width W * 2**j.  The skip by ``variant`` (reference
    unet_variants.py):

    - ``PP`` (UNet++, :277): nodes (j, 1..i-1), then encoder tap j;
    - ``P`` (UNetP, :217): node (j, i-1) for i > 1, else encoder tap j;
    - ``E`` (UNetE, :157): encoder tap j.  Without deep supervision only
      the nodes with i + j == D are built: the others feed only the heads
      (the reference's Keras graph prunes them), and the flax auto-names
      count the built nodes only.

    Deep-supervision heads, all at full resolution: level D on the first
    encoder tap, level D - i on node (0, i) for i < D."""

    def __init__(self, model_width: int, model_depth: int,
                 variant: str = "PP", D_S: int = 0, A_G: int = 0,
                 LSTM: int = 0, is_transconv: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(model_width, model_depth, D_S=D_S,
                         is_transconv=is_transconv, dtype=dtype)
        if variant not in ("E", "P", "PP"):
            raise NotImplementedError(
                f"GridDecoder variant {variant!r} is not ported yet")
        if A_G or LSTM:
            raise NotImplementedError(
                "grid decoders with attention gates or ConvLSTM fusion "
                "are not ported yet")
        self.variant = variant
        W, D = model_width, model_depth
        self.out_features = W
        if D_S:
            self._add_ds_head(W, D, generator)
        for n, (i, j) in enumerate(self._nodes()):
            width_j = W * 2 ** j
            up = self._add_up(n, 2 * width_j, width_j, generator)
            dense = (i - 1) * width_j if variant == "PP" else 0
            self.add_module(f"ConvBlock_{n}", self._node_block(
                up + dense + width_j, width_j, generator))
            if D_S and j == 0 and i < D:
                self._add_ds_head(W, D - i, generator)

    def _nodes(self) -> tp.List[tp.Tuple[int, int]]:
        """The built nodes (i, j), in the reference's order."""
        D = self.model_depth
        return [(i, j) for i in range(1, D + 1) for j in range(D - i + 1)
                if self.variant != "E" or self.D_S or i + j == D]

    def forward(self, skips: tp.Sequence[torch.Tensor]
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        D = self.model_depth
        levels: tp.List[torch.Tensor] = []
        if self.D_S:
            levels.append(self._ds_head(skips[0], D))
        deconvs: tp.Dict[tp.Tuple[int, int], torch.Tensor] = {}
        for n, (i, j) in enumerate(self._nodes()):
            src = skips[j + 1] if i == 1 else deconvs[(j + 1, i - 1)]
            up = self._up(src, n)
            if self.variant == "PP":
                merged = concat(up, *[deconvs[(j, k)] for k in range(1, i)],
                                skips[j])
            elif self.variant == "P" and i > 1:
                merged = concat(up, deconvs[(j, i - 1)])
            else:
                merged = concat(up, skips[j])
            deconvs[(j, i)] = getattr(self, f"ConvBlock_{n}")(merged)
            if self.D_S and j == 0 and i < D:
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


_DECODERS: tp.Dict[str, tp.Callable[..., nn.Module]] = {
    "UNet": lambda **kw: ChainDecoder(style="unet", **kw),
    "UNetE": lambda **kw: GridDecoder(variant="E", **kw),
    "UNetP": lambda **kw: GridDecoder(variant="P", **kw),
    "UNetPP": lambda **kw: GridDecoder(variant="PP", **kw),
    "UNet3P": lambda **kw: FullScaleDecoder(**kw),
}


def build_decoder(decoder_name: str, **kw) -> nn.Module:
    """The decoder of ``decoder_name`` (JAX ``build_decoder``, :542)."""
    if decoder_name not in _DECODERS:
        raise NotImplementedError(
            f"decoder {decoder_name!r} is not ported yet (ported: "
            f"{', '.join(_DECODERS)})")
    return _DECODERS[decoder_name](**kw)
