"""Decoders of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/decoders.py).

Ported, both with and without deep supervision, each upsampling by the 2D
dialect's transposed conv or by bilinear resize (``is_transconv``), without
ConvLSTM fusion: the UNet, MultiResUNet and KSSNet chains
(``ChainDecoder`` styles ``unet``, ``multires`` and ``kssnet``, :166) and
the UNetE, UNetP and UNet++ grids (``GridDecoder`` variants ``E``, ``P``
and ``PP``, :223), each with or without attention gates (``A_G``); the
UNet3+ and MultiResUNet3+ full-scale decoders (``FullScaleDecoder``,
:324), which ignore ``A_G`` and ``LSTM`` as the JAX module does.

Every decoder takes ``skips`` = [conv1 .. convD, bottleneck] and returns
``(deconv, levels)``, ``levels`` being the deep-supervision heads in the
reference's order (level{D} first .. level1 last).

``dialect`` "1d" (JAX ``_DecoderBase``, decoders.py:55-158) builds the 1D
tree's decoders over (B, C, 1, L) signals: the 2-wide transposed conv
with BatchNorm and ReLU, nearest upsampling and resizing, nodes of
``conv_repeats`` ConvBlocks of kernel ``kernel``, MultiRes nodes whose
branch widths truncate before the level's multiplier, pools over the
length axis (``pyramid.maxpool1d_levels``).
"""
from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops import (AttentionGate, ConvBlock, HeadConv, MultiResBlock, ResPath,
                   TransConv, concat, multires_features, upsample)
from ..ops.kernels import pyramid


class _DecoderBase(nn.Module):
    """Shared decoder machinery (JAX ``_DecoderBase``, decoders.py:55):
    ``_up`` upsamples by 2, by the dialect's transposed conv
    (``TransConv_<n>``) or, with ``is_transconv`` off, by the dialect's
    resize (bilinear in 2D, nearest in 1D), which keeps the source's
    width; ``_resize`` is that resize; node ``n`` is ``conv_repeats``
    ConvBlocks (``ConvBlock_<n * conv_repeats + r>``) or, with
    ``multires``, one MultiResBlock (``MultiResBlock_<n>``) whose output is
    ``_node_features`` wide; ``_ds_head`` is a 1x1 conv named
    ``level{k}``.  Subclasses create their submodules in flax call order,
    so the flax auto-names map one for one.  The skips they take are the
    encoder's taps, W * 2**j wide, and the latent's output, as wide as a
    node of width W * 2**D.  ``out_features`` is the width of the
    ``deconv`` a decoder returns."""

    def __init__(self, model_width: int, model_depth: int, D_S: int = 0,
                 is_transconv: bool = True, multires: bool = False,
                 alpha: float = 1.0, dtype: torch.dtype = torch.float32,
                 kernel: int = 3, conv_repeats: int = 1,
                 dialect: str = "2d"):
        super().__init__()
        if dialect not in ("1d", "2d"):
            raise ValueError(f"unknown decoder dialect {dialect!r}")
        self.model_width = model_width
        self.model_depth = model_depth
        self.D_S = D_S
        self.is_transconv = is_transconv
        self.multires = multires
        self.alpha = alpha
        self.dtype = dtype
        self.kernel = kernel
        self.conv_repeats = conv_repeats
        self.dialect = dialect
        self.rank = 1 if dialect == "1d" else 2

    def _add_up(self, n: int, in_features: int, features: int,
                generator: tp.Optional[torch.Generator]) -> int:
        """Create node ``n``'s upsampling; returns the upsampled width."""
        if not self.is_transconv:
            return in_features
        self.add_module(f"TransConv_{n}", TransConv(
            in_features, features, dtype=self.dtype, generator=generator,
            dialect=self.dialect))
        return features

    def _up(self, x: torch.Tensor, n: int) -> torch.Tensor:
        if self.is_transconv:
            return getattr(self, f"TransConv_{n}")(x)
        return self._resize(x, 2)

    def _resize(self, x: torch.Tensor, factor: int) -> torch.Tensor:
        method = "nearest" if self.rank == 1 else "bilinear"
        return upsample(x, factor, method=method, rank=self.rank)

    def _multires_width(self, features: int) -> tp.Tuple[int, int]:
        """(width, multiplier) of a MultiRes node of width ``features``:
        the 2D tree passes the width, the 1D tree the base width and the
        level's multiplier (decoders.py:119-125)."""
        if self.rank == 1:
            return self.model_width, features // self.model_width
        return features, 1

    def _node_features(self, features: int) -> int:
        """The output width of a node of width ``features``."""
        if not self.multires:
            return features
        width, multiplier = self._multires_width(features)
        return multires_features(width, self.alpha, multiplier)

    def _node_modules(self, n: int) -> tp.List[str]:
        if self.multires:
            return [f"MultiResBlock_{n}"]
        return [f"ConvBlock_{n * self.conv_repeats + r}"
                for r in range(self.conv_repeats)]

    def _add_node(self, n: int, in_features: int, features: int,
                  generator: tp.Optional[torch.Generator]) -> int:
        """Create node ``n``; returns its output width."""
        kw = dict(dtype=self.dtype, generator=generator, rank=self.rank)
        if self.multires:
            width, multiplier = self._multires_width(features)
            block = MultiResBlock(in_features, width, self.kernel,
                                  alpha=self.alpha, multiplier=multiplier,
                                  **kw)
            self.add_module(f"MultiResBlock_{n}", block)
            return block.out_features
        for name in self._node_modules(n):
            self.add_module(name, ConvBlock(in_features, features,
                                            self.kernel, **kw))
            in_features = features
        return features

    def _run_node(self, n: int, x: torch.Tensor) -> torch.Tensor:
        for name in self._node_modules(n):
            x = getattr(self, name)(x)
        return x

    def _add_gate(self, n: int, skip_features: int, gate_features: int,
                  features: int, generator: tp.Optional[torch.Generator]
                  ) -> None:
        self.add_module(f"AttentionGate_{n}", AttentionGate(
            skip_features, gate_features, features, dtype=self.dtype,
            generator=generator, dialect=self.dialect))

    def _gate(self, n: int, skip: torch.Tensor, gate: torch.Tensor
              ) -> torch.Tensor:
        return getattr(self, f"AttentionGate_{n}")(skip, gate)

    def _add_ds_head(self, in_features: int, level: int,
                     generator: tp.Optional[torch.Generator],
                     stride: int = 1) -> None:
        self.add_module(f"level{level}", HeadConv(
            in_features, 1, stride=stride if self.rank == 2 else (1, stride),
            dtype=self.dtype, generator=generator))

    def _ds_head(self, x: torch.Tensor, level: int) -> torch.Tensor:
        return getattr(self, f"level{level}")(x)


class ChainDecoder(_DecoderBase):
    """The chains (reference unet_variants.py:125-154; MultiResUNet and
    KSSNet, decoders.py:166-222): step j upsamples the previous step's
    output (the bottleneck at j == 0) and concatenates it with encoder tap
    D - j - 1, which with ``A_G`` first passes ``AttentionGate_j``, gated
    by that previous output; ``kssnet`` then concatenates the sigmoids of
    the bottleneck and of every earlier step's output, resized to this
    level.  A node of width W * 2**(D - j - 1) follows: a ConvBlock
    (``unet``) or a MultiResBlock (``multires``, ``kssnet``).
    Deep-supervision head level D - j is a 1x1 conv on the step's input,
    before the upsampling, so level k sits at 1 / 2**k of the input's
    resolution."""

    STYLES = ("unet", "multires", "kssnet")

    def __init__(self, model_width: int, model_depth: int,
                 style: str = "unet", D_S: int = 0, A_G: int = 0,
                 LSTM: int = 0, is_transconv: bool = True,
                 alpha: float = 1.0, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 kernel: int = 3, conv_repeats: int = 1,
                 dialect: str = "2d"):
        if style not in self.STYLES:
            raise NotImplementedError(
                f"ChainDecoder style {style!r} is not ported yet")
        if LSTM:
            raise NotImplementedError(
                "chain decoders with ConvLSTM fusion are not ported yet")
        super().__init__(model_width, model_depth, D_S=D_S,
                         is_transconv=is_transconv,
                         multires=style != "unet", alpha=alpha, dtype=dtype,
                         kernel=kernel, conv_repeats=conv_repeats,
                         dialect=dialect)
        self.style = style
        self.A_G = A_G
        W, D = model_width, model_depth
        # widths of the bottleneck and of each step's output so far
        outs = [self._node_features(W * 2 ** D)]
        for j in range(D):
            width_j = W * 2 ** (D - j - 1)
            if A_G:
                self._add_gate(j, width_j, outs[-1], width_j, generator)
            if D_S:
                self._add_ds_head(outs[-1], D - j, generator)
            cin = self._add_up(j, outs[-1], width_j, generator) + width_j
            if style == "kssnet":
                cin += sum(outs)
            outs.append(self._add_node(j, cin, width_j, generator))
        self.out_features = outs[-1]

    def forward(self, skips: tp.Sequence[torch.Tensor]
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        D = self.model_depth
        levels: tp.List[torch.Tensor] = []
        outs = [skips[-1]]
        for j in range(D):
            deconv = outs[-1]
            skip = skips[D - j - 1]
            if self.A_G:
                skip = self._gate(j, skip, deconv)
            if self.D_S:
                levels.append(self._ds_head(deconv, D - j))
            merged = concat(self._up(deconv, j), skip)
            if self.style == "kssnet":
                merged = concat(merged, *[
                    torch.sigmoid(self._resize(o, 2 ** (j - m + 1)))
                    for m, o in enumerate(outs)])
            outs.append(self._run_node(j, merged))
        return outs[-1], levels


class GridDecoder(_DecoderBase):
    """The (j, i) grids: node (j, i) upsamples node (j+1, i-1) (or the
    encoder tap j + 1 at i == 1), concatenates it with its skips and runs a
    ConvBlock of width W * 2**j.  The skips by ``variant`` (reference
    unet_variants.py):

    - ``PP`` (UNet++, :277): nodes (j, 1..i-1), then encoder tap j;
    - ``P`` (UNetP, :217): node (j, i-1) for i > 1, else encoder tap j;
    - ``E`` (UNetE, :157): encoder tap j.  Without deep supervision only
      the nodes with i + j == D are built: the others feed only the heads
      (the reference's Keras graph prunes them), and the flax auto-names
      count the built nodes only.

    With ``A_G`` each skip first passes an ``AttentionGate_<g>`` gated by
    the node's source, numbered over the built nodes in the reference's
    order (for UNet++: (j, 1), .., (j, i-1), then the encoder tap).

    Deep-supervision heads, all at full resolution: level D on the first
    encoder tap, level D - i on node (0, i) for i < D."""

    def __init__(self, model_width: int, model_depth: int,
                 variant: str = "PP", D_S: int = 0, A_G: int = 0,
                 LSTM: int = 0, is_transconv: bool = True,
                 alpha: float = 1.0, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 kernel: int = 3, conv_repeats: int = 1,
                 dialect: str = "2d"):
        if variant not in ("E", "P", "PP"):
            raise NotImplementedError(
                f"GridDecoder variant {variant!r} is not ported yet")
        if LSTM:
            raise NotImplementedError(
                "grid decoders with ConvLSTM fusion are not ported yet")
        super().__init__(model_width, model_depth, D_S=D_S,
                         is_transconv=is_transconv, alpha=alpha, dtype=dtype,
                         kernel=kernel, conv_repeats=conv_repeats,
                         dialect=dialect)
        self.variant = variant
        self.A_G = A_G
        W, D = model_width, model_depth
        self.out_features = W
        #: node (i, j) -> the numbers of its skips' attention gates
        self._gates: tp.Dict[tp.Tuple[int, int], tp.List[int]] = {}
        if D_S:
            self._add_ds_head(W, D, generator)
        for n, (i, j) in enumerate(self._nodes()):
            width_j = W * 2 ** j
            n_skips = i if variant == "PP" else 1
            if A_G:
                first = sum(len(g) for g in self._gates.values())
                self._gates[(i, j)] = list(range(first, first + n_skips))
                for g in self._gates[(i, j)]:
                    self._add_gate(g, width_j, 2 * width_j, width_j,
                                   generator)
            up = self._add_up(n, 2 * width_j, width_j, generator)
            self._add_node(n, up + n_skips * width_j, width_j, generator)
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
            if self.variant == "PP":
                terms = [deconvs[(j, k)] for k in range(1, i)] + [skips[j]]
            elif self.variant == "P" and i > 1:
                terms = [deconvs[(j, i - 1)]]
            else:
                terms = [skips[j]]
            if self.A_G:
                terms = [self._gate(g, t, src)
                         for g, t in zip(self._gates[(i, j)], terms)]
            merged = concat(self._up(src, n), *terms)
            deconvs[(j, i)] = self._run_node(n, merged)
            if self.D_S and j == 0 and i < D:
                levels.append(self._ds_head(deconvs[(0, i)], D - i))
        return deconvs[(0, D)], levels


class FullScaleDecoder(_DecoderBase):
    """The UNet3+ and MultiResUNet3+ decoder (reference
    unet_variants.py:346-376 and :490-520).  Decoder step j (level
    D - j - 1) concatenates: a node of the same-level encoder tap; nodes of
    every higher-resolution tap max-pooled by 2**((D - j) - k - 1); the
    sigmoid of a node of the previous step's output, upsampled by 2; the
    sigmoids of every earlier step's output through a node (UNet3+) or
    through ``ResPath(j, W)`` (``multires``), upsampled to this level;
    then a node of width W * (D + 1) (UNet3+) or W * D (``multires``).
    Nodes are ConvBlocks, or MultiResBlocks with ``multires``; all but
    the last of a step are W wide.  Deep-supervision heads are 1x1 convs
    with stride 2 (half resolution, the reference's quirk).  Attention
    gates, ConvLSTM fusion and the upsampling mode do not enter this
    decoder, in the JAX package too."""

    def __init__(self, model_width: int, model_depth: int, D_S: int = 0,
                 A_G: int = 0, LSTM: int = 0, is_transconv: bool = True,
                 multires: bool = False, alpha: float = 1.0,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 kernel: int = 3, conv_repeats: int = 1,
                 dialect: str = "2d"):
        super().__init__(model_width, model_depth, D_S=D_S,
                         multires=multires, alpha=alpha, dtype=dtype,
                         kernel=kernel, conv_repeats=conv_repeats,
                         dialect=dialect)
        W, D = model_width, model_depth
        feat = W * D if multires else W * (D + 1)
        n = r = 0

        def node(in_features: int, features: int) -> int:
            nonlocal n
            n += 1
            return self._add_node(n - 1, in_features, features, generator)

        deconv = self._node_features(W * 2 ** D)  # the bottleneck's width
        for j in range(D):
            tot = node(W * 2 ** (D - j - 1), W)         # same-level tap
            for k in range(0, D - j - 1):
                tot += node(W * 2 ** k, W)              # pooled taps
            tot += node(deconv, W)                      # previous step
            for _ in range(j):                          # earlier steps
                if multires:
                    self.add_module(f"ResPath_{r}", ResPath(
                        deconv, j, W, kernel, dtype=dtype,
                        generator=generator, rank=self.rank))
                    r += 1
                    tot += W
                else:
                    tot += node(deconv, W)
            deconv = node(tot, feat)
            if D_S:
                self._add_ds_head(deconv, D - j, generator, stride=2)
        self.out_features = deconv

    def forward(self, skips: tp.Sequence[torch.Tensor]
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        D = self.model_depth
        n = r = 0

        def node(x: torch.Tensor) -> torch.Tensor:
            nonlocal n
            n += 1
            return self._run_node(n - 1, x)

        levels: tp.List[torch.Tensor] = []
        deconv = skips[-1]
        deconvs: tp.List[torch.Tensor] = []
        # skip k's taps are its max pools by 2**((D - j) - k - 1), one per
        # later step j (JAX: downsample_pool per tap, tf_1d_2d_segmentation_
        # end2endpipelines_tpu/models/decoders.py:353-356); all of them come
        # from one pyramid launch, one read of the skip.  Max is exact, so
        # each tap equals that pool, forward and gradient.
        levels_of = (pyramid.maxpool_levels if self.rank == 2
                     else pyramid.maxpool1d_levels)
        pooled = [levels_of(skips[k], D - 1 - k) for k in range(D - 1)]
        for j in range(D):
            sc_all = node(skips[D - j - 1])
            for k in range(0, D - j - 1):
                sc = pooled[k][(D - j) - k - 2]  # level (D - j) - k - 1
                sc_all = concat(sc_all, node(sc))
            tot = concat(sc_all, torch.sigmoid(self._resize(node(deconv), 2)))
            for m in range(j):
                if self.multires:
                    d = getattr(self, f"ResPath_{r}")(deconvs[m])
                    r += 1
                else:
                    d = node(deconvs[m])
                tot = concat(tot, torch.sigmoid(self._resize(d, 2 ** (j - m))))
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
    "UNet3P": lambda **kw: FullScaleDecoder(multires=False, **kw),
    "MultiResUNet": lambda **kw: ChainDecoder(style="multires", **kw),
    "MultiResUNet3P": lambda **kw: FullScaleDecoder(multires=True, **kw),
    "KSSNet": lambda **kw: ChainDecoder(style="kssnet", **kw),
}


def build_decoder(decoder_name: str, **kw) -> nn.Module:
    """The decoder of ``decoder_name`` (JAX ``build_decoder``, :542)."""
    if decoder_name not in _DECODERS:
        raise NotImplementedError(
            f"decoder {decoder_name!r} is not ported yet (ported: "
            f"{', '.join(_DECODERS)})")
    return _DECODERS[decoder_name](**kw)
