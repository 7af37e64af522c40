"""Decoders of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/decoders.py).

Ported, both with and without deep supervision, each upsampling by the 2D
dialect's transposed conv or by bilinear resize (``is_transconv``): the
UNet, MultiResUNet, KSSNet and FPN chains (``ChainDecoder`` styles
``unet``, ``multires``, ``kssnet`` and ``fpn``, :166) and the UNetE,
UNetP, UNet++, UNet4P and AHNet grids (``GridDecoder`` variants ``E``,
``P``, ``PP``, ``4P`` and ``AH``, :223), each with or without attention
gates (``A_G``) and ConvLSTM fusion (``LSTM``); the UNet3+, UNet4PV2 and
MultiResUNet3+ full-scale decoders (``FullScaleDecoder``, :324), which
ignore ``A_G`` and ``LSTM`` as the JAX module does; and the Self-ONN
decoders.  ``build_decoder`` has every name of the JAX
``DECODER_NAMES``.  Nodes of the ``conv``, ``multires``, ``recurrent``,
``r2``, ``convmixer`` and ``multires_mixer`` families (JAX
``_node_block``, :114) serve the 1D zoo's RUNet, R2UNet and ConvMixer
archs.

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

from ..ops import (AttentionGate, AutoNamed, BatchNorm, ConvBlock,
                   ConvLSTMFusion, ConvMixerBlock, HeadConv, MultiResBlock,
                   Oper, OperTranspose, RecurrentConvBlock, ResPath,
                   TransConv, concat, multires_features, upsample)
from ..ops.kernels import pyramid


#: node families (JAX ``_DecoderBase._node_block``, decoders.py:114-151)
NODES = ("conv", "multires", "multires_mixer", "recurrent", "r2",
         "convmixer")


class _DecoderBase(AutoNamed):
    """Shared decoder machinery (JAX ``_DecoderBase``, decoders.py:55):
    ``_up`` upsamples by 2, by the dialect's transposed conv
    (``TransConv_<n>``) or, with ``is_transconv`` off, by the dialect's
    resize (bilinear in 2D, nearest in 1D), which keeps the source's
    width; ``_resize`` is that resize; ``_ds_head`` is a 1x1 conv named
    ``level{k}``.

    A node of width ``features`` is, by ``node``: ``conv_repeats``
    chained ConvBlocks (``conv``), ConvMixerBlocks (``convmixer``) or
    RecurrentConvBlocks of ``t`` iterations (``recurrent``); ``r2``, a 1x1
    ConvBlock of its input added to a chain of ``conv_repeats``
    RecurrentConvBlocks (the ConvBlock created first); or one
    MultiResBlock (``multires``; ``multires_mixer`` with ConvMixer units)
    whose output is ``_node_features`` wide.  Submodules are registered
    under flax's auto-names (``AutoNamed``) in the order the JAX decoder
    creates them, so the flax paths map one for one.
    The skips a decoder takes are the encoder's taps, W * 2**j wide, and
    the bottleneck, ``bottom_features`` wide (default: a node of width W *
    2**D).  ``out_features`` is the width of the ``deconv`` a decoder
    returns."""

    def __init__(self, model_width: int, model_depth: int, D_S: int = 0,
                 is_transconv: bool = True, node: str = "conv",
                 alpha: float = 1.0, dtype: torch.dtype = torch.float32,
                 kernel: int = 3, conv_repeats: int = 1, t: int = 2,
                 dialect: str = "2d",
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        if dialect not in ("1d", "2d"):
            raise ValueError(f"unknown decoder dialect {dialect!r}")
        if node not in NODES:
            raise ValueError(f"unknown decoder node {node!r}")
        self.model_width = model_width
        self.model_depth = model_depth
        self.D_S = D_S
        self.is_transconv = is_transconv
        self.node = node
        self.multires = node in ("multires", "multires_mixer")
        self.alpha = alpha
        self.dtype = dtype
        self.kernel = kernel
        self.conv_repeats = conv_repeats
        self.t = t
        self.dialect = dialect
        self.rank = 1 if dialect == "1d" else 2
        self._generator = generator
        #: node n -> (its kind, its modules)
        self._nodes: tp.List[tp.Tuple[str, tp.List[nn.Module]]] = []

    def _kw(self) -> tp.Dict[str, tp.Any]:
        return dict(dtype=self.dtype, generator=self._generator,
                    rank=self.rank)

    def _add_up(self, n: int, in_features: int, features: int) -> int:
        """Create node ``n``'s upsampling; returns the upsampled width."""
        if not self.is_transconv:
            return in_features
        self.add_module(f"TransConv_{n}", TransConv(
            in_features, features, dtype=self.dtype,
            generator=self._generator, dialect=self.dialect))
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

    def _add_node(self, in_features: int, features: int) -> int:
        """Create the next node; returns its output width."""
        kw = self._kw()
        k = self.kernel
        if self.multires:
            width, multiplier = self._multires_width(features)
            block = MultiResBlock(in_features, width, k, alpha=self.alpha,
                                  multiplier=multiplier,
                                  mixer=self.node == "multires_mixer", **kw)
            self._nodes.append(("chain", [self._add(block)]))
            return block.out_features
        blocks = []
        if self.node == "r2":
            blocks.append(self._add(ConvBlock(in_features, features, 1,
                                              **kw)))
        cin = in_features
        for _ in range(self.conv_repeats):
            if self.node in ("recurrent", "r2"):
                block: nn.Module = RecurrentConvBlock(cin, features, k,
                                                      t=self.t, **kw)
            elif self.node == "convmixer":
                block = ConvMixerBlock(cin, features, k, **kw)
            else:
                block = ConvBlock(cin, features, k, **kw)
            blocks.append(self._add(block))
            cin = features
        self._nodes.append(("r2" if self.node == "r2" else "chain", blocks))
        return features

    def _run_node(self, n: int, x: torch.Tensor) -> torch.Tensor:
        kind, blocks = self._nodes[n]
        if kind == "r2":  # the 1x1 ConvBlock plus the recurrent chain
            raw = blocks[0](x)
            for block in blocks[1:]:
                x = block(x)
            return raw + x
        for block in blocks:
            x = block(x)
        return x

    def _add_gate(self, n: int, skip_features: int, gate_features: int,
                  features: int) -> None:
        self.add_module(f"AttentionGate_{n}", AttentionGate(
            skip_features, gate_features, features, dtype=self.dtype,
            generator=self._generator, dialect=self.dialect))

    def _gate(self, n: int, skip: torch.Tensor, gate: torch.Tensor
              ) -> torch.Tensor:
        return getattr(self, f"AttentionGate_{n}")(skip, gate)

    def _add_fusion(self, n: int, in_features: int, features: int) -> int:
        """Node ``n``'s ConvLSTM fusion (``ConvLSTMFusion_<n>``, kernel 3
        as JAX's); returns its width."""
        self.add_module(f"ConvLSTMFusion_{n}", ConvLSTMFusion(
            in_features, features, dtype=self.dtype,
            generator=self._generator, rank=self.rank))
        return features

    def _fuse(self, n: int, *tensors: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"ConvLSTMFusion_{n}")(*tensors)

    def _add_ds_head(self, in_features: int, level: int,
                     stride: int = 1) -> None:
        self.add_module(f"level{level}", HeadConv(
            in_features, 1, stride=stride if self.rank == 2 else (1, stride),
            dtype=self.dtype, generator=self._generator))

    def _ds_head(self, x: torch.Tensor, level: int) -> torch.Tensor:
        return getattr(self, f"level{level}")(x)

    def _fpn_pyramid(self, stages: tp.Sequence[torch.Tensor]) -> torch.Tensor:
        """FPN's concat pyramid of the decoder's stages (JAX decoders.py:
        213-219): the total so far resized by 2, then the next stage
        concatenated."""
        tot = stages[0]
        for stage in stages[1:]:
            tot = concat(self._resize(tot, 2), stage)
        return tot


def _check_sum(up: int, skip: int) -> None:
    """The FPN chains and the add-merge decoders (LinkNet) add the skip
    to the upsampled output."""
    if up != skip:
        raise ValueError(
            f"the FPN and LinkNet decoders add the skip ({skip} channels) to "
            f"the upsampled output ({up} channels): set is_transconv, whose "
            "transposed conv gives the skip's width (the JAX package fails "
            "on the shapes too)")


class ChainDecoder(_DecoderBase):
    """The chains (reference unet_variants.py:125-154; MultiResUNet and
    KSSNet, decoders.py:166-222): step j upsamples the previous step's
    output (the bottleneck at j == 0) and concatenates it with encoder tap
    D - j - 1, which with ``A_G`` first passes ``AttentionGate_j``, gated
    by that previous output; with ``LSTM`` the two are fused instead by
    ``ConvLSTMFusion_j`` (skip first) of width max(int(W * 2**(D-j-2)),
    1); ``kssnet`` then concatenates the sigmoids of the bottleneck and of
    every earlier step's output, resized to this level.  A node of width
    W * 2**(D - j - 1) follows (``style`` ``multires`` and ``kssnet``:
    MultiRes nodes; ``unet``: the ``node`` family).  Deep-supervision head
    level D - j is a 1x1 conv on the step's input, before the upsampling,
    so level k sits at 1 / 2**k of the input's resolution.

    ``fpn`` (FPN, JAX decoders.py:166-220): ConvBlock nodes, the skip
    added to the upsampled output instead of concatenated (``A_G`` and
    ``LSTM`` as ``unet``), and the output the concat pyramid of every
    step's output, each earlier total resized by 2 before the next
    step's output joins it (W * (2**D - 1) wide).  The sum needs the
    upsampled output as wide as the skip, which only the transposed conv
    gives: the JAX package fails on the shapes without it, the port
    raises ``ValueError`` when it builds.

    ``merge`` "add" (LinkNet, JAX decoders.py:87-96): the upsampled output
    plus the skip in place of their concat (``LSTM`` fuses them as
    before); the sum needs the transposed conv, as ``fpn``'s."""

    STYLES = ("unet", "multires", "kssnet", "fpn")

    def __init__(self, model_width: int, model_depth: int,
                 style: str = "unet", D_S: int = 0, A_G: int = 0,
                 LSTM: int = 0, is_transconv: bool = True,
                 alpha: float = 1.0, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 kernel: int = 3, conv_repeats: int = 1,
                 dialect: str = "2d", node: str = "conv", t: int = 2,
                 bottom_features: tp.Optional[int] = None,
                 merge: str = "concat"):
        if style not in self.STYLES:
            raise ValueError(f"unknown ChainDecoder style {style!r}")
        super().__init__(model_width, model_depth, D_S=D_S,
                         is_transconv=is_transconv,
                         node=("multires" if style in ("multires", "kssnet")
                               else node),
                         alpha=alpha, dtype=dtype, kernel=kernel,
                         conv_repeats=conv_repeats, t=t, dialect=dialect,
                         generator=generator)
        if merge not in ("concat", "add"):
            raise ValueError(f"unknown decoder merge {merge!r}")
        self.style = style
        self.merge = merge
        self.A_G = A_G
        self.LSTM = LSTM
        W, D = model_width, model_depth
        # widths of the bottleneck and of each step's output so far
        outs = [bottom_features or self._node_features(W * 2 ** D)]
        for j in range(D):
            width_j = W * 2 ** (D - j - 1)
            if A_G:
                self._add_gate(j, width_j, outs[-1], width_j)
            if D_S:
                self._add_ds_head(outs[-1], D - j)
            up = self._add_up(j, outs[-1], width_j)
            cin = up + width_j
            if LSTM:
                cin = self._add_fusion(j, cin, max(int(W * 2.0 ** (D - j - 2)),
                                                   1))
            elif style == "fpn" or merge == "add":
                _check_sum(up, width_j)
                cin = width_j
            if style == "kssnet":
                cin += sum(outs)
            outs.append(self._add_node(cin, width_j))
        self.out_features = sum(outs[1:]) if style == "fpn" else outs[-1]

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
            up = self._up(deconv, j)
            if self.LSTM:
                merged = self._fuse(j, skip, up)
            elif self.style == "fpn" or self.merge == "add":
                merged = up + skip
            else:
                merged = concat(up, skip)
            if self.style == "kssnet":
                merged = concat(merged, *[
                    torch.sigmoid(self._resize(o, 2 ** (j - m + 1)))
                    for m, o in enumerate(outs)])
            outs.append(self._run_node(j, merged))
        if self.style == "fpn":
            return self._fpn_pyramid(outs[1:]), levels
        return outs[-1], levels


class GridDecoder(_DecoderBase):
    """The (j, i) grids: node (j, i) upsamples node (j+1, i-1) (or the
    encoder tap j + 1 at i == 1), concatenates it with its skips and runs a
    node of width W * 2**j.  The skips by ``variant`` (reference
    unet_variants.py):

    - ``PP`` (UNet++, :277): nodes (j, 1..i-1), then encoder tap j;
    - ``4P`` (UNet4P, :379): as ``PP``, and the nodes on the diagonal i +
      j == D with 1 < i (but row D - 1) also concatenate the diagonal's
      earlier nodes (D - m, m), m in 1..i-2, resized to the row (2D: their
      sigmoids; the 1D dialect concatenates them ungated, decoders.py:
      300-318);
    - ``AH`` (AHNet, :523): as ``4P``, each of those diagonal nodes first
      through its own ``ResPath(j, W, kernel)`` (``ResPath_<r>``, numbered
      in the order the nodes and m run), then resized;
    - ``P`` (UNetP, :217): node (j, i-1) for i > 1, else encoder tap j;
    - ``E`` (UNetE, :157): encoder tap j.  Without deep supervision only
      the nodes with i + j == D are built: the others feed only the heads
      (the reference's Keras graph prunes them), and the flax auto-names
      count the built nodes only.

    With ``A_G`` each skip first passes an ``AttentionGate_<g>`` gated by
    the node's source, numbered over the built nodes in the reference's
    order (for UNet++: (j, 1), .., (j, i-1), then the encoder tap).  With
    ``LSTM`` ``ConvLSTMFusion_<n>`` of width max(int(W * 2**(j-1)), 1)
    fuses [encoder tap or P's skip, the upsampled source, nodes (j, 1..
    i-1)] in place of the concat (decoders.py:283-288).

    ``merge`` "add" (the LinkNet grids, JAX decoders.py:270, :291-297):
    node (j, i)'s dense terms (nodes (j, 1 .. i-1), gated with ``A_G``)
    are summed instead of concatenated, and the node takes ``skip + that
    sum + upsampled`` (``skip + upsampled`` without them); ``LSTM`` fuses
    [skip, upsampled, the sum].

    Deep-supervision heads, all at full resolution: level D on the first
    encoder tap, level D - i on node (0, i) for i < D."""

    def __init__(self, model_width: int, model_depth: int,
                 variant: str = "PP", D_S: int = 0, A_G: int = 0,
                 LSTM: int = 0, is_transconv: bool = True,
                 alpha: float = 1.0, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 kernel: int = 3, conv_repeats: int = 1,
                 dialect: str = "2d", node: str = "conv", t: int = 2,
                 bottom_features: tp.Optional[int] = None,
                 merge: str = "concat"):
        if variant not in ("E", "P", "PP", "4P", "AH"):
            raise ValueError(f"unknown GridDecoder variant {variant!r}")
        super().__init__(model_width, model_depth, D_S=D_S,
                         is_transconv=is_transconv, node=node, alpha=alpha,
                         dtype=dtype, kernel=kernel,
                         conv_repeats=conv_repeats, t=t, dialect=dialect,
                         generator=generator)
        if merge not in ("concat", "add"):
            raise ValueError(f"unknown decoder merge {merge!r}")
        self.variant = variant
        self.merge = merge
        self.A_G = A_G
        self.LSTM = LSTM
        W, D = model_width, model_depth
        dense = variant in ("PP", "4P", "AH")
        #: node (i, j) -> the numbers of its skips' attention gates
        self._gates: tp.Dict[tp.Tuple[int, int], tp.List[int]] = {}
        #: node (i, j) -> the diagonal nodes (D - m, m) it concatenates
        self._paths: tp.Dict[tp.Tuple[int, int], tp.List[int]] = {}
        #: AH: (i, j, m) -> the ResPath on diagonal node (D - m, m)
        self._path_blocks: tp.Dict[tp.Tuple[int, int, int], nn.Module] = {}
        width = {}  # node (j, i) -> its output width
        if D_S:
            self._add_ds_head(W, D)
        for n, (i, j) in enumerate(self._nodes_ij()):
            width_j = W * 2 ** j
            src = ((bottom_features or W * 2 ** D) if i == 1 and j == D - 1
                   else W * 2 ** (j + 1) if i == 1 else width[(j + 1, i - 1)])
            n_skips = i if dense else 1
            if A_G:
                first = sum(len(g) for g in self._gates.values())
                self._gates[(i, j)] = list(range(first, first + n_skips))
                for g in self._gates[(i, j)]:
                    self._add_gate(g, width_j, src, width_j)
            up = self._add_up(n, src, width_j)
            cin = up + n_skips * width_j
            if merge == "add":
                # skip, the sum of the dense terms (when there are any), the
                # upsampled output: fused side by side, else summed
                cin = (up + (2 if n_skips > 1 else 1) * width_j if LSTM
                       else width_j)
                if not LSTM:
                    _check_sum(up, width_j)
            if LSTM:
                cin = self._add_fusion(n, cin, max(int(W * 2.0 ** (j - 1)),
                                                   1))
            if variant in ("4P", "AH") and i > 1 and i + j == D and j != D - 1:
                self._paths[(i, j)] = list(range(1, i - 1))
                for m in self._paths[(i, j)]:
                    if variant == "AH":
                        path = self._add(ResPath(width[(D - m, m)], j, W,
                                                 kernel, **self._kw()))
                        self._path_blocks[(i, j, m)] = path
                        cin += W
                    else:
                        cin += width[(D - m, m)]
            width[(j, i)] = self._add_node(cin, width_j)
            if D_S and j == 0 and i < D:
                self._add_ds_head(width[(0, i)], D - i)
        self.out_features = width[(0, D)]

    def _nodes_ij(self) -> tp.List[tp.Tuple[int, int]]:
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
        for n, (i, j) in enumerate(self._nodes_ij()):
            src = skips[j + 1] if i == 1 else deconvs[(j + 1, i - 1)]
            if self.variant in ("PP", "4P", "AH"):
                terms = [deconvs[(j, k)] for k in range(1, i)] + [skips[j]]
            elif self.variant == "P" and i > 1:
                terms = [deconvs[(j, i - 1)]]
            else:
                terms = [skips[j]]
            if self.A_G:
                terms = [self._gate(g, t, src)
                         for g, t in zip(self._gates[(i, j)], terms)]
            up = self._up(src, n)
            if self.merge == "add" and len(terms) > 1:
                tot = terms[0]
                for t in terms[1:-1]:
                    tot = tot + t
                terms = [tot, terms[-1]]
            if self.LSTM:  # [skip, upsampled, (the dense total)]
                merged = self._fuse(n, terms[-1], up, *terms[:-1])
            elif self.merge == "add":
                merged = terms[-1] + up if len(terms) == 1 else (
                    terms[-1] + terms[0] + up)
            else:
                merged = concat(up, *terms)
            for m in self._paths.get((i, j), ()):
                path = deconvs[(D - m, m)]
                if self.variant == "AH":
                    path = self._path_blocks[(i, j, m)](path)
                path = self._resize(path, 2 ** (i - m))
                merged = concat(merged, torch.sigmoid(path)
                                if self.rank == 2 else path)
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
    Nodes are of the ``node`` family (``multires``: MultiResBlocks); all
    but the last of a step are W wide.  R2UNet3P's quirks are kept
    (decoders.py:346-376): with ``r2`` nodes the same-level tap takes a
    plain ConvBlock, and an earlier step's output a 1x1 ConvBlock plus
    one RecurrentConvBlock.  Deep-supervision heads are 1x1 convs with
    stride 2 (half resolution, the reference's quirk).  Attention gates,
    ConvLSTM fusion and the upsampling mode do not enter this decoder, in
    the JAX package too."""

    def __init__(self, model_width: int, model_depth: int, D_S: int = 0,
                 A_G: int = 0, LSTM: int = 0, is_transconv: bool = True,
                 multires: bool = False, alpha: float = 1.0,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 kernel: int = 3, conv_repeats: int = 1,
                 dialect: str = "2d", node: str = "conv", t: int = 2,
                 bottom_features: tp.Optional[int] = None):
        super().__init__(model_width, model_depth, D_S=D_S,
                         node="multires" if multires else node, alpha=alpha,
                         dtype=dtype, kernel=kernel,
                         conv_repeats=conv_repeats, t=t, dialect=dialect,
                         generator=generator)
        self.respaths = multires
        W, D = model_width, model_depth
        feat = W * D if multires else W * (D + 1)
        kw = self._kw()
        r2 = self.node == "r2"
        r = 0
        deconv = bottom_features or self._node_features(W * 2 ** D)
        for j in range(D):
            if r2:  # a plain ConvBlock on the same-level tap
                self._nodes.append(("chain", [self._add(ConvBlock(
                    W * 2 ** (D - j - 1), W, kernel, **kw))]))
                tot = W
            else:
                tot = self._add_node(W * 2 ** (D - j - 1), W)
            for k in range(0, D - j - 1):
                tot += self._add_node(W * 2 ** k, W)    # pooled taps
            tot += self._add_node(deconv, W)            # previous step
            for _ in range(j):                          # earlier steps
                if multires:
                    self.add_module(f"ResPath_{r}", ResPath(
                        deconv, j, W, kernel, **kw))
                    r += 1
                    tot += W
                elif r2:  # a 1x1 ConvBlock plus one recurrent block
                    self._nodes.append(("r2", [
                        self._add(ConvBlock(deconv, W, 1, **kw)),
                        self._add(RecurrentConvBlock(deconv, W, kernel,
                                                     t=t, **kw))]))
                    tot += W
                else:
                    tot += self._add_node(deconv, W)
            deconv = self._add_node(tot, feat)
            if D_S:
                self._add_ds_head(deconv, D - j, stride=2)
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
                if self.respaths:
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


class _SelfDecoderBase(_DecoderBase):
    """What the Self-ONN decoders share (JAX decoders.py:389-538): the
    order ``q`` of their ``Oper`` and ``OperTranspose`` layers, registered
    under flax's auto-names in creation order (``Oper_<n>``,
    ``OperTranspose_<n>``, ``BatchNorm_<n>``), and the arguments of the
    other decoders that they take and ignore, as the JAX modules do
    (``A_G``, ``LSTM``, ``alpha``)."""

    def __init__(self, model_width: int, model_depth: int, D_S: int = 0,
                 A_G: int = 0, LSTM: int = 0, is_transconv: bool = True,
                 alpha: float = 1.0, q: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 kernel: int = 3, dialect: str = "2d",
                 bottom_features: tp.Optional[int] = None):
        super().__init__(model_width, model_depth, D_S=D_S,
                         is_transconv=is_transconv, dtype=dtype,
                         kernel=kernel, dialect=dialect, generator=generator)
        self.q = q
        self.bottom = bottom_features or model_width * 2 ** model_depth

    def _oper(self, in_features: int, features: int,
              kernel: tp.Optional[int] = None, stride: int = 1) -> Oper:
        return self._add(Oper(in_features, features, kernel or self.kernel,
                              stride=stride, q=self.q, **self._kw()))

    def _oper_up(self, in_features: int, features: int
                 ) -> tp.Optional[OperTranspose]:
        """The transposed ``Oper`` by 2 with tanh, or None (resize)."""
        if not self.is_transconv:
            return None
        return self._add(OperTranspose(in_features, features, q=self.q,
                                       **self._kw()))

    def _upsample(self, up: tp.Optional[nn.Module], x: torch.Tensor
                  ) -> torch.Tensor:
        return up(x) if up is not None else self._resize(x, 2)

    def _bn(self, features: int) -> BatchNorm:
        return self._add(BatchNorm(features))


class SelfChainDecoder(_SelfDecoderBase):
    """The Self-ONN chains, SelfUNet (``style`` ``unet``, reference
    unet_variants.py:644-664) and SelfFPN (``fpn``, fpn_variants.py:
    172-199; JAX ``SelfChainDecoder``, decoders.py:389): step j upsamples
    the previous output by a tanh ``OperTranspose`` (or resizes it),
    concatenates encoder tap D - j - 1 (``fpn``: adds it), then an
    ``Oper`` of width W * 2**(D-j-1), BatchNorm and tanh.  ``fpn``
    returns the concat pyramid of the steps' outputs, as the FPN chain.
    Deep-supervision head level D - j is ``Oper(1, 1)`` on the step's
    input."""

    STYLES = ("unet", "fpn")

    def __init__(self, model_width: int, model_depth: int,
                 style: str = "unet", **kw):
        if style not in self.STYLES:
            raise ValueError(f"unknown SelfChainDecoder style {style!r}")
        super().__init__(model_width, model_depth, **kw)
        self.style = style
        W, D = model_width, model_depth
        cin = self.bottom
        self.steps: tp.List[tp.Dict[str, tp.Any]] = []
        for j in range(D):
            width_j = W * 2 ** (D - j - 1)
            step = {"head": self._oper(cin, 1, 1) if self.D_S else None,
                    "up": self._oper_up(cin, width_j)}
            up = width_j if step["up"] is not None else cin
            if style == "fpn":
                _check_sum(up, width_j)
            step["node"] = self._oper(width_j if style == "fpn"
                                      else up + width_j, width_j)
            step["bn"] = self._bn(width_j)
            self.steps.append(step)
            cin = width_j
        self.out_features = W * (2 ** D - 1) if style == "fpn" else W

    def forward(self, skips: tp.Sequence[torch.Tensor]
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        D = self.model_depth
        levels: tp.List[torch.Tensor] = []
        stages: tp.List[torch.Tensor] = []
        deconv = skips[-1]
        for j, step in enumerate(self.steps):
            skip = skips[D - j - 1]
            if step["head"] is not None:
                levels.append(step["head"](deconv))
            up = self._upsample(step["up"], deconv)
            merged = up + skip if self.style == "fpn" else concat(up, skip)
            deconv = torch.tanh(step["bn"](step["node"](merged)))
            stages.append(deconv)
        if self.style == "fpn":
            return self._fpn_pyramid(stages), levels
        return deconv, levels


class SelfGridDecoder(_SelfDecoderBase):
    """The Self-ONN nested grid (JAX ``SelfGridDecoder``, decoders.py:432;
    the 2D reference's SelfUNetPP, unet_variants.py:667-710): UNet++'s
    node order and skips (nodes (j, 1..i-1), then encoder tap j, after
    the upsampled source), each node ``node_reps`` chained ``Oper``s of
    width W * 2**j, then BatchNorm and tanh.  The 1D dialect (and
    ``bare``) leaves out BatchNorm and tanh and has plain 1x1 conv heads
    (flax ``Conv_<n>``); the 2D heads are ``Oper(1, 1)``, all at full
    resolution: level D on the first encoder tap, level D - i on node (0,
    i).  SelfUNetPP in 1D has two Opers a node, SelfR2UNetPP one."""

    def __init__(self, model_width: int, model_depth: int,
                 bare: bool = False, node_reps: int = 1, **kw):
        super().__init__(model_width, model_depth, **kw)
        W, D = model_width, model_depth
        self.plain = bare or self.dialect == "1d"
        #: level D's head, on the first encoder tap
        self.heads_D = [self._head(W)] if self.D_S else []
        self.nodes: tp.List[tp.Dict[str, tp.Any]] = []
        for i in range(1, D + 1):
            for j in range(D - i + 1):
                width_j = W * 2 ** j
                src = self.bottom if i == 1 and j == D - 1 else 2 * width_j
                node = {"ij": (i, j), "up": self._oper_up(src, width_j)}
                cin = (width_j if node["up"] is not None else src) + \
                    i * width_j
                node["opers"] = [self._oper(cin if r == 0 else width_j,
                                            width_j)
                                 for r in range(max(node_reps, 1))]
                node["bn"] = None if self.plain else self._bn(width_j)
                node["head"] = (self._head(width_j)
                                if self.D_S and j == 0 and i < D else None)
                self.nodes.append(node)
        self.out_features = W

    def _head(self, in_features: int) -> nn.Module:
        if self.dialect == "1d":
            return self._add(HeadConv(in_features, 1, dtype=self.dtype,
                                      generator=self._generator),
                             kind="Conv")
        return self._oper(in_features, 1, 1)

    def forward(self, skips: tp.Sequence[torch.Tensor]
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        D = self.model_depth
        levels: tp.List[torch.Tensor] = []
        for head in self.heads_D:
            levels.append(head(skips[0]))
        deconvs: tp.Dict[tp.Tuple[int, int], torch.Tensor] = {}
        for node in self.nodes:
            i, j = node["ij"]
            src = skips[j + 1] if i == 1 else deconvs[(j + 1, i - 1)]
            x = concat(self._upsample(node["up"], src),
                       *[deconvs[(j, k)] for k in range(1, i)], skips[j])
            for oper in node["opers"]:
                x = oper(x)
            if node["bn"] is not None:
                x = torch.tanh(node["bn"](x))
            deconvs[(j, i)] = x
            if node["head"] is not None:
                levels.append(node["head"](x))
        return deconvs[(0, D)], levels


class SelfFullScaleDecoder(_SelfDecoderBase):
    """The Self-ONN UNet3+ (JAX ``SelfFullScaleDecoder``, decoders.py:494;
    reference unet_variants.py:713-747).  Step j concatenates: an ``Oper``
    of the same-level encoder tap and of every higher-resolution tap
    max-pooled by 2**((D - j) - k - 1), each with BatchNorm and tanh in
    2D and bare in 1D; the gate of an ``Oper`` of the previous output
    upsampled by 2, and the gates of ``Oper``s of every earlier output
    upsampled to this level (gate: tanh in 2D, sigmoid in 1D); then an
    ``Oper`` of width W * (D + 1).  All Opers but that one are W wide.
    Each skip's pools come from one pyramid launch, as in
    ``FullScaleDecoder``.  Deep-supervision heads are ``Oper(1, 1)`` at
    stride 2 (half resolution, the reference's quirk)."""

    def __init__(self, model_width: int, model_depth: int, **kw):
        super().__init__(model_width, model_depth, **kw)
        W, D = model_width, model_depth
        feat = W * (D + 1)
        deconv = self.bottom
        self.steps: tp.List[tp.Dict[str, tp.Any]] = []
        for j in range(D):
            step = {"taps": [self._tap_oper(W * 2 ** (D - j - 1))]
                    + [self._tap_oper(W * 2 ** k) for k in range(D - j - 1)],
                    "prev": self._oper(deconv, W),
                    "earlier": [self._oper(feat, W) for _ in range(j)],
                    "node": self._oper(feat, feat)}
            step["head"] = self._oper(feat, 1, 1, stride=2) if self.D_S \
                else None
            self.steps.append(step)
            deconv = feat
        self.out_features = feat

    def _tap_oper(self, in_features: int
                  ) -> tp.Tuple[Oper, tp.Optional[BatchNorm]]:
        oper = self._oper(in_features, self.model_width)
        return oper, None if self.rank == 1 else self._bn(self.model_width)

    def forward(self, skips: tp.Sequence[torch.Tensor]
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        D = self.model_depth
        gate = torch.sigmoid if self.rank == 1 else torch.tanh
        levels_of = (pyramid.maxpool_levels if self.rank == 2
                     else pyramid.maxpool1d_levels)
        pooled = [levels_of(skips[k], D - 1 - k) for k in range(D - 1)]

        def tap(oper_bn, x):
            oper, bn = oper_bn
            x = oper(x)
            return x if bn is None else torch.tanh(bn(x))

        levels: tp.List[torch.Tensor] = []
        deconv = skips[-1]
        deconvs: tp.List[torch.Tensor] = []
        for j, step in enumerate(self.steps):
            parts = [tap(step["taps"][0], skips[D - j - 1])]
            for k in range(D - j - 1):
                parts.append(tap(step["taps"][k + 1],
                                 pooled[k][(D - j) - k - 2]))
            parts.append(gate(self._resize(step["prev"](deconv), 2)))
            for m, oper in enumerate(step["earlier"]):
                parts.append(gate(self._resize(oper(deconvs[m]),
                                               2 ** (j - m))))
            deconv = step["node"](concat(*parts))
            deconvs.append(deconv)
            if step["head"] is not None:
                levels.append(step["head"](deconv))
        return deconv, levels


_DECODERS: tp.Dict[str, tp.Callable[..., nn.Module]] = {
    "UNet": lambda **kw: ChainDecoder(style="unet", **kw),
    "UNetE": lambda **kw: GridDecoder(variant="E", **kw),
    "UNetP": lambda **kw: GridDecoder(variant="P", **kw),
    "UNetPP": lambda **kw: GridDecoder(variant="PP", **kw),
    "UNet3P": lambda **kw: FullScaleDecoder(multires=False, **kw),
    "UNet4P": lambda **kw: GridDecoder(variant="4P", **kw),
    "UNet4PV2": lambda **kw: FullScaleDecoder(multires=False, **kw),
    "AHNet": lambda **kw: GridDecoder(variant="AH", **kw),
    "MultiResUNet": lambda **kw: ChainDecoder(style="multires", **kw),
    "MultiResUNet3P": lambda **kw: FullScaleDecoder(multires=True, **kw),
    "KSSNet": lambda **kw: ChainDecoder(style="kssnet", **kw),
    "FPN": lambda **kw: ChainDecoder(style="fpn", **kw),
    "SelfUNet": lambda **kw: SelfChainDecoder(style="unet", **kw),
    "SelfUNetPP": lambda **kw: SelfGridDecoder(**kw),
    "SelfUNet3P": lambda **kw: SelfFullScaleDecoder(**kw),
    "SelfFPN": lambda **kw: SelfChainDecoder(style="fpn", **kw),
}


def build_decoder(decoder_name: str, q: int = 3, **kw) -> nn.Module:
    """The decoder of ``decoder_name`` (JAX ``build_decoder``, :542; an
    unknown name its ``ValueError``); the Self-ONN decoders take the order
    ``q``."""
    if decoder_name not in _DECODERS:
        raise ValueError(f"Unknown decoder: {decoder_name!r}")
    if decoder_name.startswith("Self"):
        kw["q"] = q
    return _DECODERS[decoder_name](**kw)
