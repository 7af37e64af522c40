"""The 1D special families of the port (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/models/specials_1d.py): ``BCDUNet`` (:154),
``SEDUNet`` (:199), ``IBAUNet`` (:252) and ``NABNet`` (:291), on their
blocks ``DenseConcatBlock`` (:37), ``RIBlock`` (:55) and
``AttentionLSTMGate`` (:79), and the base class ``_Special1DBase``
(:115: the upsampling, the head and the deep-supervision heads).

As ``SegModel1D`` (models/api_1d.py), a model takes a (B, L, C) batch
and keeps a (B, C, 1, L) channels_last signal inside; its blocks are
rank-1 blocks of ops/blocks.py.  Submodules carry flax's auto-names,
numbered by type in the order the flax module creates them
(``ConvBlock_<k>``, ``AttentionGate_<k>``, ``TransConv_<k>``, ...), and
the heads flax's explicit ones (``out``, ``level<k>``), so
utils/flax_to_torch.py maps every leaf.  Every encoder level is pooled
by 2 (D pools a forward, the 1D pyramid kernel on the card).
"""
from __future__ import annotations

import math
import typing as tp

import torch
from torch import nn

from ..ops import (AttentionGate, AutoNamed, BatchNorm, BiConvLSTM,
                   ConvBlock, ConvLSTMCell, ConvLSTMFusion,
                   FeatureExtractionBlock, HeadConv, SqueezeExcite,
                   TransConv, apply_activation, concat, downsample_pool,
                   pooled_size, upsample, zero_grads)

class DenseConcatBlock(nn.Module):
    """``num_layers`` times ``x = concat(x, ConvBlock(ConvBlock(x)))``
    (JAX :37): ``ConvBlock_<2l>`` and ``ConvBlock_<2l+1>`` at layer l."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 num_layers: int = 0, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        kw = dict(dtype=dtype, generator=generator, rank=1)
        cin = in_features
        for layer in range(num_layers):
            self.add_module(f"ConvBlock_{2 * layer}",
                            ConvBlock(cin, features, kernel, **kw))
            self.add_module(f"ConvBlock_{2 * layer + 1}",
                            ConvBlock(features, features, kernel, **kw))
            cin += features
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in range(self.num_layers):
            cb = getattr(self, f"ConvBlock_{2 * layer}")(x)
            x = concat(x, getattr(self, f"ConvBlock_{2 * layer + 1}")(cb))
        return x


def ri_widths(features: int) -> tp.Tuple[int, int, int, int]:
    """An ``RIBlock``'s 1x1 reduction and its three chained branches:
    ``int(f/2)``, ``ceil(f/6)``, ``floor(f/3)`` and ``int(f/2)``, each at
    least 1 (32 -> 6, 10, 16; 256 -> 43, 85, 128)."""
    f = features
    return (max(int(f / 2), 1), max(math.ceil(f / 6), 1),
            max(math.floor(f / 3), 1), max(int(f / 2), 1))


class RIBlock(nn.Module):
    """Redesigned-inception block (JAX :55): a 1x1 ConvBlock branch
    (``ConvBlock_0``), and a 1x1 reduction (``ConvBlock_1``) followed by
    three chained 3-wide ConvBlocks (``ConvBlock_2..4``) whose outputs,
    concatenated, are added to it; where the three do not sum to
    ``features`` (tiny widths) a bare 1x1 ``ConvBlock_5`` projects them
    first.  The branches' odd widths go to cuDNN; no pool reads them."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, rank=1)
        w0, w1, w2, w3 = ri_widths(features)
        self.ConvBlock_0 = ConvBlock(in_features, features, 1, **kw)
        self.ConvBlock_1 = ConvBlock(in_features, w0, 1, **kw)
        self.ConvBlock_2 = ConvBlock(w0, w1, 3, **kw)
        self.ConvBlock_3 = ConvBlock(w1, w2, 3, **kw)
        self.ConvBlock_4 = ConvBlock(w2, w3, 3, **kw)
        self.project = w1 + w2 + w3 != features
        if self.project:
            self.ConvBlock_5 = ConvBlock(w1 + w2 + w3, features, 1,
                                         use_bn=False, activation=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.ConvBlock_0(x)
        c1 = self.ConvBlock_2(self.ConvBlock_1(x))
        c2 = self.ConvBlock_3(c1)
        b3 = concat(c1, c2, self.ConvBlock_4(c2))
        if self.project:
            b3 = self.ConvBlock_5(b3)
        return b3 + b1


class AttentionLSTMGate(nn.Module):
    """Attention gate whose merge is one ConvLSTM step (JAX :79): the
    skip and the gate (the upsampled decoder tensor, at the skip's
    length) each through a 1x1 conv of stride 2 (``Conv_0``, ``Conv_1``:
    samples 0, 2, 4, ... by slicing, as ``HeadConv`` takes a stride) and
    a BatchNorm, one ``ConvLSTMCell_0`` over both, ``Conv_2`` to one
    channel, ``BatchNorm_2``, sigmoid(relu(.)), upsampled by nearest
    repeat plus ``TransConv_0`` (the 1D one, with its BatchNorm and
    ReLU), and the skip multiplied by that map."""

    def __init__(self, skip_features: int, gate_features: int,
                 features: int, lstm_features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        lstm = max(lstm_features, 1)
        self.Conv_0 = HeadConv(skip_features, features, stride=(1, 2), **kw)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = HeadConv(gate_features, features, stride=(1, 2), **kw)
        self.BatchNorm_1 = BatchNorm(features)
        self.ConvLSTMCell_0 = ConvLSTMCell(2 * features, lstm, rank=1, **kw)
        self.Conv_2 = HeadConv(lstm, 1, **kw)
        self.BatchNorm_2 = BatchNorm(1)
        self.TransConv_0 = TransConv(1, 1, dialect="1d", **kw)

    def forward(self, skip: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        a = self.BatchNorm_0(self.Conv_0(skip))
        b = self.BatchNorm_1(self.Conv_1(gate))
        c = self.Conv_2(self.ConvLSTMCell_0(concat(a, b)))
        c = torch.sigmoid(torch.relu(self.BatchNorm_2(c)))
        r = upsample(c, 2, method="nearest", rank=1) + self.TransConv_0(c)
        return skip * r


class _Special1DBase(AutoNamed):
    """What the four families share (JAX ``_Special1DBase``, :115): the
    constructor surface, the (B, L, C) <-> (B, C, 1, L) conversion, the
    encoder of two ConvBlocks a level (``_encoder``), the upsampling
    (``_up``: the 1D ``TransConv`` of width ``feats`` or a nearest
    repeat), the ``out`` head (softmax over the channels for
    ``Classification``) and the one-channel deep-supervision heads
    ``level<k>`` (``_ds``).

    ``forward`` returns ``{"out": (B, L, output_nums)}`` in ``dtype``,
    plus ``level<D>`` .. ``level1`` with ``ds == 1``.  ``ae = 1`` puts
    the autoencoder bottleneck (``FeatureExtractionBlock_0``, W wide,
    ``feature_number`` features) after the bottleneck's first block
    (``_bottleneck_ae``); ``length``, the signals' length, sizes it.
    ``init_kwargs`` keeps the constructor's arguments, so
    ``reinitialized`` draws a fresh model of the same architecture."""

    def __init__(self, model_width: int, model_depth: int,
                 kernel_size: int = 3, problem_type: str = "Regression",
                 output_nums: int = 1, ds: int = 0, ae: int = 0, ag: int = 0,
                 lstm: int = 0, dense_loop: int = 1, se_ratio: int = 16,
                 in_channels: int = 1, is_transconv: bool = True,
                 feature_number: int = 1024,
                 length: tp.Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.init_kwargs = {k: v for k, v in locals().items()
                            if k not in ("self", "generator", "__class__")}
        if ae and not length:
            raise ValueError("ae = 1 needs the signals' length: the "
                             "autoencoder bottleneck's Dense is sized by it")
        if model_depth < 1:
            raise ValueError("The depth of the model cannot be less than 1")
        self.model_depth = model_depth
        self.problem_type = problem_type
        self.output_nums = output_nums
        self.ds, self.ag, self.lstm, self.ae = ds, ag, lstm, ae
        self.feature_number, self.length = feature_number, length
        self.is_transconv = is_transconv
        self.dtype = dtype
        self._kw = dict(dtype=dtype, generator=generator)

    def reinitialized(self, generator: torch.Generator) -> "_Special1DBase":
        """A new model of this architecture with weights drawn from
        ``generator``."""
        return type(self)(**self.init_kwargs, generator=generator)

    def _conv_block(self, cin: int, features: int, kernel: int,
                    **kw) -> ConvBlock:
        return self._add(ConvBlock(cin, features, kernel, rank=1,
                                   **self._kw, **kw))

    def _encoder(self, cin: int, width: int, kernel: int) -> int:
        """D levels of two ConvBlocks (``self.enc``), each pooled; returns
        the last level's width."""
        self.enc = []
        for i in range(1, self.model_depth + 1):
            feats = width * 2 ** (i - 1)
            self.enc.append((self._conv_block(cin, feats, kernel),
                             self._conv_block(feats, feats, kernel)))
            cin = feats
        return cin

    def _bottleneck_ae(self, cin: int, width: int) -> tp.Tuple[
            tp.Tuple[nn.Module, ...], int]:
        """With ``ae = 1`` the autoencoder bottleneck on the pooled
        length of ``cin`` channels, ``width`` wide (JAX :174, :218, :269,
        :328): (the block,) and ``width``; else () and ``cin``."""
        if not self.ae:
            return (), cin
        return (self._add(FeatureExtractionBlock(
            cin, (1, pooled_size(self.length, self.model_depth)), width,
            self.feature_number, **self._kw)),), width

    def _dense_bottleneck(self, cin: int, width: int, kernel: int,
                          dense_loop: int) -> None:
        """``DenseConcatBlock_0`` of ``dense_loop - 1`` layers, the
        autoencoder bottleneck with ``ae``, then two ConvBlocks
        (``self.bottom``, run in order)."""
        feats = width * 2 ** self.model_depth
        dense = self._add(DenseConcatBlock(cin, feats, kernel,
                                           num_layers=dense_loop - 1,
                                           **self._kw))
        ae, cin = self._bottleneck_ae(dense.out_features, width)
        self.bottom = (dense, *ae, self._conv_block(cin, feats, kernel),
                       self._conv_block(feats, feats, kernel))

    def _bottom(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.bottom:
            x = block(x)
        return x

    def _up_module(self, cin: int, feats: int) -> tp.Optional[nn.Module]:
        if self.is_transconv:
            return self._add(TransConv(cin, feats, dialect="1d", **self._kw))
        return None

    @staticmethod
    def _up(module: tp.Optional[nn.Module], x: torch.Tensor) -> torch.Tensor:
        if module is not None:
            return module(x)
        return upsample(x, 2, method="nearest", rank=1)

    def _ds_head(self, cin: int, level: int) -> tp.Optional[HeadConv]:
        if self.ds != 1:
            return None
        head = HeadConv(cin, 1, **self._kw)
        self.add_module(f"level{level}", head)
        return head

    def _signal(self, x: torch.Tensor) -> torch.Tensor:
        # a fresh channels_last (B, C, 1, L) copy in the compute dtype
        x = x.permute(0, 2, 1).unsqueeze(2)
        return torch.empty(x.shape, dtype=self.dtype, device=x.device,
                           memory_format=torch.channels_last).copy_(x)

    def _encode(self, x: torch.Tensor
                ) -> tp.Tuple[tp.List[torch.Tensor], torch.Tensor]:
        taps, pool = [], x
        for cb1, cb2 in self.enc:
            conv = cb2(cb1(pool))
            pool = downsample_pool(conv, 2, op="max", rank=1)
            taps.append(conv)
        return taps, pool

    def _outputs(self, deconv: torch.Tensor,
                 levels: tp.Sequence[torch.Tensor]
                 ) -> tp.Dict[str, torch.Tensor]:
        out = self.out(deconv)
        if self.problem_type == "Classification":
            out = apply_activation(out, "softmax")
        outputs = {"out": out[:, :, 0].permute(0, 2, 1)}
        for idx, lvl in enumerate(levels):
            outputs[f"level{self.model_depth - idx}"] = (
                lvl[:, :, 0].permute(0, 2, 1))
        return outputs


class _ChainSpecial(_Special1DBase):
    """BCDUNet and SEDUNet (JAX :154, :199): the encoder, the dense
    bottleneck, and a chain decoder.  At each of its D nodes: with
    ``ag = 1`` the skip is gated by ``AttentionGate`` (1D dialect) with
    the node's input, the DS head reads that input, the input is
    upsampled (``_up``), SEDUNet's ``SqueezeExcite`` and a plain
    BatchNorm and ReLU follow, with ``lstm = 1`` ``ConvLSTMFusion``
    (skip, upsampled) of width ``max(W * 2**(D-j-2), 1)``, then two
    ConvBlocks (SEDUNet: a SqueezeExcite between them).  With ``lstm =
    0`` the decoder takes no skip (JAX :157-158, kept); a gate built
    with ``ag = 1`` then only advances its BatchNorms' statistics and
    gets zero gradients, as in JAX."""

    squeeze_excite = False

    def __init__(self, model_width: int, model_depth: int,
                 kernel_size: int = 3, dense_loop: int = 1,
                 se_ratio: int = 16, in_channels: int = 1, **kw):
        super().__init__(model_width, model_depth, kernel_size,
                         dense_loop=dense_loop, se_ratio=se_ratio,
                         in_channels=in_channels, **kw)
        W, D, k = model_width, model_depth, kernel_size
        cin = self._encoder(in_channels, W, k)
        self._dense_bottleneck(cin, W, k, dense_loop)
        cin = W * 2 ** D
        self.dec = []
        for j in range(D):
            feats = W * 2 ** (D - j - 1)
            node: tp.Dict[str, tp.Any] = {}
            if self.ag:
                node["ag"] = self._add(AttentionGate(
                    feats, cin, feats, dialect="1d", **self._kw))
            node["ds"] = self._ds_head(cin, D - j)
            node["up"] = self._up_module(cin, feats)
            cin = feats if self.is_transconv else cin
            if self.squeeze_excite:
                node["se"] = (self._add(SqueezeExcite(cin, se_ratio,
                                                      **self._kw)),)
                node["bn"] = self._add(BatchNorm(cin))
            if self.lstm:
                lstm = max(int(W * 2 ** (D - j - 2)), 1)
                node["lstm"] = self._add(ConvLSTMFusion(
                    feats + cin, lstm, rank=1, **self._kw))
                cin = lstm
            node["cb1"] = self._conv_block(cin, feats, k)
            if self.squeeze_excite:
                node["se"] += (self._add(SqueezeExcite(feats, se_ratio,
                                                       **self._kw)),)
            node["cb2"] = self._conv_block(feats, feats, k)
            self.dec.append(node)
            cin = feats
        self.out = HeadConv(cin, self.output_nums, **self._kw)

    def forward(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        D = self.model_depth
        taps, pool = self._encode(self._signal(x))
        deconv = self._bottom(pool)
        levels = []
        for j, node in enumerate(self.dec):
            skip = taps[D - j - 1]
            if self.ag:
                skip = node["ag"](skip, deconv)
            if node["ds"] is not None:
                levels.append(node["ds"](deconv))
            deconv = self._up(node["up"], deconv)
            if self.squeeze_excite:
                deconv = torch.relu(node["bn"](node["se"][0](deconv)))
            if self.lstm:
                deconv = node["lstm"](skip, deconv)
            elif self.ag:  # the gate's output is not read (JAX :157-158)
                deconv = zero_grads(deconv, *node["ag"].parameters())
            deconv = node["cb1"](deconv)
            if self.squeeze_excite:
                deconv = node["se"][1](deconv)
            deconv = node["cb2"](deconv)
        return self._outputs(deconv, levels)


class BCDUNet(_ChainSpecial):
    """Bi-directional ConvLSTM dense UNet (JAX ``BCDUNet``, :154)."""


class SEDUNet(_ChainSpecial):
    """SE-dense UNet (JAX ``SEDUNet``, :199): BCDUNet with a
    ``SqueezeExcite`` (``se_ratio``), a BatchNorm and a ReLU after each
    upsampling and a ``SqueezeExcite`` between the node's two
    ConvBlocks."""

    squeeze_excite = True


class IBAUNet(_Special1DBase):
    """Inception-block attention UNet (JAX ``IBAUNet``, :252): an
    ``RIBlock`` per encoder level, two in the bottleneck; at each decoder
    node the DS head reads the node's input, which is upsampled; with
    ``ag = 1`` the skip is gated by ``AttentionLSTMGate`` with the
    upsampled tensor; then [upsampled, skip] through an ``RIBlock``.
    ``kernel_size`` is not read: every RIBlock is 3 wide."""

    def __init__(self, model_width: int, model_depth: int,
                 kernel_size: int = 3, in_channels: int = 1, **kw):
        super().__init__(model_width, model_depth, kernel_size,
                         in_channels=in_channels, **kw)
        W, D = model_width, model_depth
        ri = dict(self._kw)
        cin = in_channels
        self.enc = []
        for i in range(1, D + 1):
            self.enc.append(self._add(RIBlock(cin, W * 2 ** (i - 1), **ri)))
            cin = W * 2 ** (i - 1)
        first = self._add(RIBlock(cin, W * 2 ** D, **ri))
        ae, cin = self._bottleneck_ae(W * 2 ** D, W)
        self.bottom = (first, *ae,
                       self._add(RIBlock(cin, W * 2 ** D, **ri)))
        cin = W * 2 ** D
        self.dec = []
        for j in range(D):
            feats = W * 2 ** (D - j - 1)
            node: tp.Dict[str, tp.Any] = {
                "ds": self._ds_head(cin, D - j),
                "up": self._up_module(cin, feats)}
            up = feats if self.is_transconv else cin
            if self.ag:
                node["ag"] = self._add(AttentionLSTMGate(
                    feats, up, feats, max(int(W * 2 ** (D - j - 2)), 1),
                    **self._kw))
            node["ri"] = self._add(RIBlock(up + feats, feats, **ri))
            self.dec.append(node)
            cin = feats
        self.out = HeadConv(cin, self.output_nums, **self._kw)

    def forward(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        D = self.model_depth
        taps, pool = [], self._signal(x)
        for block in self.enc:
            conv = block(pool)
            pool = downsample_pool(conv, 2, op="max", rank=1)
            taps.append(conv)
        deconv = self._bottom(pool)
        levels = []
        for j, node in enumerate(self.dec):
            if node["ds"] is not None:
                levels.append(node["ds"](deconv))
            deconv = self._up(node["up"], deconv)
            skip = taps[D - j - 1]
            if self.ag:
                skip = node["ag"](skip, deconv)
            deconv = node["ri"](concat(deconv, skip))
        return self._outputs(deconv, levels)


class NABNet(_Special1DBase):
    """Nested attention-guided BiConvLSTM network (JAX ``NABNet``, :291):
    the encoder and the dense bottleneck, then the UNet++ grid.  Node
    (j, i) (row j at width W * 2**j, column i) gates each of its row's
    earlier tensors (the encoder tap and nodes (j, 1 .. i-1)) by an
    ``AttentionGate`` (1D dialect) with the node below it (``src``: tap
    j + 1 in column 1, node (j + 1, i - 1) after), concatenates them
    (projected by a 1x1 ConvBlock to the row width when there are
    several), fuses that with ``src`` upsampled through ``BiConvLSTM``
    of width ``max(W * 2**j // 2, 1)`` and ends in two ConvBlocks.  DS
    heads: ``level<D>`` on tap 0, ``level<D-i>`` on node (0, i); all at
    full length.  ``ag`` and ``lstm`` are not read (every node is gated
    and fused); the upsampling must be the transposed conv, whose width
    the BiConvLSTM's shared input conv needs (a nearest repeat of
    ``src`` is twice as wide: the JAX module fails on it too)."""

    def __init__(self, model_width: int, model_depth: int,
                 kernel_size: int = 3, dense_loop: int = 1,
                 in_channels: int = 1, **kw):
        super().__init__(model_width, model_depth, kernel_size,
                         dense_loop=dense_loop, in_channels=in_channels,
                         **kw)
        if not self.is_transconv:
            raise ValueError(
                "NABNet needs is_transconv = 1: its BiConvLSTM shares one "
                "input conv between the row-width aggregate and the "
                "upsampled node below, which a nearest upsampling leaves "
                "twice as wide")
        W, D, k = model_width, model_depth, kernel_size
        cin = self._encoder(in_channels, W, k)
        self._dense_bottleneck(cin, W, k, dense_loop)
        self._ds_head(W, D)
        self.grid: tp.Dict[tp.Tuple[int, int], tp.Dict[str, tp.Any]] = {}
        for i in range(1, D + 1):
            for j in range(0, D - i + 1):
                width, below = W * 2 ** j, W * 2 ** (j + 1)
                node: tp.Dict[str, tp.Any] = {"gates": [self._add(
                    AttentionGate(width, below, width, dialect="1d",
                                  **self._kw)) for _ in range(i)]}
                node["proj"] = (self._conv_block(i * width, width, 1)
                                if i > 1 else None)
                node["up"] = self._up_module(below, width)
                node["lstm"] = self._add(BiConvLSTM(
                    width, max(width // 2, 1), k, rank=1, **self._kw))
                node["cb1"] = self._conv_block(2 * max(width // 2, 1),
                                               width, k)
                node["cb2"] = self._conv_block(width, width, k)
                node["ds"] = (self._ds_head(width, D - i)
                              if j == 0 and i < D else None)
                self.grid[(j, i)] = node
        self.out = HeadConv(W, self.output_nums, **self._kw)

    def forward(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        D = self.model_depth
        skips, pool = self._encode(self._signal(x))
        skips.append(self._bottom(pool))
        top = getattr(self, f"level{D}", None)
        levels = [top(skips[0])] if top is not None else []
        nodes: tp.Dict[tp.Tuple[int, int], torch.Tensor] = {}
        for (j, i), node in self.grid.items():
            src = skips[j + 1] if i == 1 else nodes[(j + 1, i - 1)]
            parts = [skips[j]] + [nodes[(j, c)] for c in range(1, i)]
            parts = [gate(p, src) for gate, p in zip(node["gates"], parts)]
            agg = concat(*parts) if len(parts) > 1 else parts[0]
            if node["proj"] is not None:
                agg = node["proj"](agg)
            fused = node["lstm"](agg, self._up(node["up"], src))
            nodes[(j, i)] = node["cb2"](node["cb1"](fused))
            if node["ds"] is not None:
                levels.append(node["ds"](nodes[(j, i)]))
        return self._outputs(nodes[(0, D)], levels)
