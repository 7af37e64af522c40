"""The last 1D families of the port, TernausNet, AlbUNet, LinkNet and the
1D FPN (JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/
extra_1d.py), and the base their models share with models/mlmrsnet.py,
models/saunet.py and models/dense_inception.py (``_Family1D``).

As ``SegModel1D`` (models/api_1d.py), a model takes a (B, L, C) batch
and keeps a (B, C, 1, L) channels_last signal inside; its blocks are
rank-1 blocks of ops/blocks.py, registered under flax's auto-names in the
order the flax module creates them, and its heads under flax's explicit
names (``out``, ``level<k>``), so utils/flax_to_torch.py maps every leaf.
Every max pool by 2**m is the 1D pyramid kernel on the card
(``downsample_pool``).

The LinkNet family is ``SegModel1D`` with add-merge decoders (its
LinkNet, LinkNetE/P/PP and MultiResLinkNet archs); this module holds its
facade.
"""
from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops import (AttentionGate, AutoNamed, ConvBlock, Dense, Dropout,
                   FeatureExtractionBlock, HeadConv, TransConv,
                   apply_activation, concat, downsample_pool, pooled_size,
                   upsample)


class _Family1D(AutoNamed):
    """What the families of this slice share: the constructor's keywords
    kept in ``init_kwargs`` (``reinitialized`` draws a fresh model of the
    same architecture), the (B, L, C) <-> (B, C, 1, L) conversion, rank-1
    blocks, the autoencoder bottleneck (``ae = 1``: ``length``, the
    signals' length, sizes it), the ``out`` head (softmax over the
    channels where ``softmax_head`` says) and the one-channel
    deep-supervision heads ``level<k>``."""

    def __init__(self, init_kwargs: tp.Dict[str, tp.Any],
                 problem_type: str = "Regression", output_nums: int = 1,
                 ds: int = 0, ae: int = 0,
                 length: tp.Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.init_kwargs = {k: v for k, v in init_kwargs.items()
                            if k not in ("self", "generator", "__class__")}
        if ae and not length:
            raise ValueError("ae = 1 needs the signals' length: the "
                             "autoencoder bottleneck's Dense is sized by it")
        self.problem_type = problem_type
        self.output_nums = output_nums
        self.softmax_head = problem_type == "Classification"
        self.ds, self.ae, self.length = ds, ae, length
        self.dtype = dtype
        self._kw = dict(dtype=dtype, generator=generator)
        self.levels: tp.List[str] = []  # the DS heads' names, in order

    def reinitialized(self, generator: torch.Generator) -> "_Family1D":
        """A new model of this architecture with weights drawn from
        ``generator``."""
        return type(self)(**self.init_kwargs, generator=generator)

    def _cb(self, cin: int, features: int, kernel: int, **kw) -> ConvBlock:
        return self._add(ConvBlock(cin, features, kernel, rank=1,
                                   **self._kw, **kw))

    def _tc(self, cin: int, features: int, kernel: int, strides: int,
            use_bn: bool = True, activation: tp.Optional[str] = "relu"
            ) -> TransConv:
        return self._add(TransConv(cin, features, rank=1, kernel=kernel,
                                   strides=strides, use_bn=use_bn,
                                   activation=activation, **self._kw))

    def _ae(self, cin: int, spatial: int, width: int,
            feature_number: int) -> tp.Optional[nn.Module]:
        """``FeatureExtractionBlock_0`` on a ``spatial``-long input of
        ``cin`` channels, ``width`` wide, with ``ae = 1``."""
        if not self.ae:
            return None
        return self._add(FeatureExtractionBlock(
            cin, (1, spatial), width, feature_number, **self._kw))

    def _ds_head(self, cin: int, level: int, stride: int = 1
                 ) -> tp.Optional[HeadConv]:
        """The DS head ``level<level>`` with ``ds = 1``, else None."""
        if self.ds != 1:
            return None
        head = HeadConv(cin, 1, stride=(1, stride), **self._kw)
        self.add_module(f"level{level}", head)
        self.levels.append(f"level{level}")
        return head

    def _head(self, cin: int) -> None:
        self.out = HeadConv(cin, self.output_nums, **self._kw)

    def _signal(self, x: torch.Tensor) -> torch.Tensor:
        # a fresh channels_last (B, C, 1, L) copy in the compute dtype
        x = x.permute(0, 2, 1).unsqueeze(2)
        return torch.empty(x.shape, dtype=self.dtype, device=x.device,
                           memory_format=torch.channels_last).copy_(x)

    def _outputs(self, deconv: torch.Tensor,
                 levels: tp.Sequence[torch.Tensor]
                 ) -> tp.Dict[str, torch.Tensor]:
        """``out`` from the ``out`` head on ``deconv``, then the DS heads'
        outputs in the order of ``self.levels``, as (B, L, C)."""
        out = self.out(deconv)
        if self.softmax_head:
            out = apply_activation(out, "softmax")
        outputs = {"out": out[:, :, 0].permute(0, 2, 1)}
        for name, lvl in zip(self.levels, levels):
            outputs[name] = lvl[:, :, 0].permute(0, 2, 1)
        return outputs


class TernausNetModel(_Family1D):
    """TernausNet (JAX ``TernausNetModel``, extra_1d.py:55): a depth-5
    VGG-style encoder of ``variant`` 11, 13, 16 or 19 (its stages' conv
    kernels ``_STAGES``, widths W times 1, 2, 4, 8, 8, each stage pooled
    by 2), two 3-wide ConvBlocks 8 W wide, then five decoder steps j: with
    ``ag`` the skip (stage 4 - j) gated by ``AttentionGate_j`` with the
    step's input, two ConvBlocks W * 2**(4 - j) wide **before** the
    upsampling (``TransConv_j``, k4 s2, BatchNorm and ReLU, or a nearest
    repeat), then [upsampled, skip] and, with ``ds``, the head
    ``level<4 - j>`` on it (level 4 at L / 16 .. level 0 at L); a last
    3-wide ConvBlock W wide and the ``out`` head.  ``ae = 1`` puts the
    bottleneck on the last pool.  The length must be a multiple of 32."""

    _STAGES = {
        11: [[3], [3], [3, 3], [3, 3], [3, 3]],
        13: [[3, 3], [3, 3], [3, 3], [3, 3], [3, 3]],
        16: [[3, 3], [3, 3], [3, 3, 1], [3, 3, 1], [3, 3, 1]],
        19: [[3, 3], [3, 3], [3, 3, 3, 3], [3, 3, 3, 3], [3, 3, 3, 3]],
    }
    _MULTS = [1, 2, 4, 8, 8]

    def __init__(self, variant: int, model_width: int,
                 problem_type: str = "Regression", output_nums: int = 1,
                 ds: int = 0, ae: int = 0, ag: int = 0,
                 feature_number: int = 1024, is_transconv: bool = True,
                 in_channels: int = 1, length: tp.Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(locals(), problem_type, output_nums, ds, ae, length,
                         dtype, generator)
        if variant not in self._STAGES:
            raise ValueError(f"unknown TernausNet variant {variant!r}")
        W = model_width
        self.model_depth = 5
        self.ag = ag
        cin = in_channels
        self.enc = []
        for stage, kernels in enumerate(self._STAGES[variant]):
            f = W * self._MULTS[stage]
            blocks = []
            for k in kernels:
                blocks.append(self._cb(cin, f, k))
                cin = f
            self.enc.append(blocks)
        taps = [W * m for m in self._MULTS]
        ae_block = self._ae(cin, pooled_size(length or 0, 5), W,
                            feature_number)
        self.bottom = [] if ae_block is None else [ae_block]
        cin = cin if ae_block is None else W
        self.bottom += [self._cb(cin, W * 8, 3), self._cb(W * 8, W * 8, 3)]
        cin = W * 8
        self.dec = []
        for j in range(5):
            f = W * 2 ** (4 - j)
            step: tp.Dict[str, tp.Any] = {"ag": None, "up": None}
            if ag:
                step["ag"] = self._add(AttentionGate(
                    taps[4 - j], cin, f, dialect="1d", **self._kw))
            step["cbs"] = (self._cb(cin, f, 3), self._cb(f, f, 3))
            if is_transconv:
                step["up"] = self._tc(f, f, 4, 2)
            cin = f + taps[4 - j]
            step["ds"] = self._ds_head(cin, 4 - j)
            self.dec.append(step)
        self._alias("last", self._cb(cin, W, 3))
        self._head(W)

    def forward(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        taps, pool = [], self._signal(x)
        for blocks in self.enc:
            conv = pool
            for block in blocks:
                conv = block(conv)
            pool = downsample_pool(conv, 2, op="max", rank=1)
            taps.append(conv)
        deconv = pool
        for block in self.bottom:
            deconv = block(deconv)
        levels = []
        for j, step in enumerate(self.dec):
            skip = taps[4 - j]
            if step["ag"] is not None:
                skip = step["ag"](skip, deconv)
            for block in step["cbs"]:
                deconv = block(deconv)
            up = (step["up"](deconv) if step["up"] is not None
                  else upsample(deconv, 2, method="nearest", rank=1))
            deconv = concat(up, skip)
            if step["ds"] is not None:
                levels.append(step["ds"](deconv))
        return self._outputs(self.last(deconv), levels)


class TernausNet:
    """Facade with the reference's constructor and method names (JAX
    extra_1d.py:125): TernausNet11, 13, 16 and 19.  ``generator`` draws
    the weights; ``length`` sizes the autoencoder bottleneck."""

    def __init__(self, length, num_channel, model_width, ds=0, ae=0, ag=0,
                 problem_type="Regression", output_nums=1,
                 feature_number=1024, is_transconv=True,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        self._kw = dict(model_width=model_width, problem_type=problem_type,
                        output_nums=output_nums, ds=ds, ae=ae, ag=ag,
                        feature_number=feature_number,
                        is_transconv=is_transconv, in_channels=num_channel,
                        length=length, dtype=dtype, generator=generator)

    def TernausNet11(self) -> TernausNetModel:
        return TernausNetModel(variant=11, **self._kw)

    def TernausNet13(self) -> TernausNetModel:
        return TernausNetModel(variant=13, **self._kw)

    def TernausNet16(self) -> TernausNetModel:
        return TernausNetModel(variant=16, **self._kw)

    def TernausNet19(self) -> TernausNetModel:
        return TernausNetModel(variant=19, **self._kw)


class ResidualGroup(AutoNamed):
    """``n_blocks`` residual units of width ``features`` (JAX
    ``_ResidualGroup``, extra_1d.py:149): two 3-wide ConvBlocks added to
    the input then ReLU, or with ``bottleneck`` a 1x1 ConvBlock 4 x
    ``features`` wide (the shortcut, created first), then 1x1, 3-wide and
    1x1 ConvBlocks (``features``, ``features``, 4 x ``features``) added to
    it then ReLU; with ``connector`` a stride-2 3-wide ConvBlock to twice
    the width and two 3-wide ones follow.  ``out_features`` is its
    output's width."""

    def __init__(self, in_features: int, features: int, n_blocks: int,
                 bottleneck: bool = False, connector: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        f = features
        kw = dict(dtype=dtype, generator=generator, rank=1)
        self.bottleneck = bottleneck
        self.units = []
        cin = in_features
        for _ in range(n_blocks):
            if bottleneck:
                self.units.append([self._add(ConvBlock(cin, 4 * f, 1, **kw)),
                                   self._add(ConvBlock(cin, f, 1, **kw)),
                                   self._add(ConvBlock(f, f, 3, **kw)),
                                   self._add(ConvBlock(f, 4 * f, 1, **kw))])
                cin = 4 * f
            else:
                self.units.append([self._add(ConvBlock(cin, f, 3, **kw)),
                                   self._add(ConvBlock(f, f, 3, **kw))])
                cin = f
        self.connector = []
        if connector:
            self.connector = [self._add(ConvBlock(cin, 2 * f, 3, stride=2,
                                                  **kw)),
                              self._add(ConvBlock(2 * f, 2 * f, 3, **kw)),
                              self._add(ConvBlock(2 * f, 2 * f, 3, **kw))]
            cin = 2 * f
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in self.units:
            if self.bottleneck:
                shortcut = unit[0](x)
                h = x
                for block in unit[1:]:
                    h = block(h)
                x = torch.relu(h + shortcut)
            else:
                x = torch.relu(unit[1](unit[0](x)) + x)
        for block in self.connector:
            x = block(x)
        return x


class AlbUNetModel(_Family1D):
    """AlbUNet (JAX ``AlbUNetModel``, extra_1d.py:178) of ``variant`` 18,
    34, 50, 101 or 152 (its groups' unit counts and bottleneck,
    ``_GROUPS``), ``num_filters`` F: the stem (a 7-wide stride-2
    ConvBlock, a max pool by 2), four ``ResidualGroup``s of width F, 2F,
    4F, 8F without connector, each a tap, a stride-2 3-wide ConvBlock to
    twice the width and two 3-wide ones between them (the reference's
    fixes that the JAX docstring names: one stride-2 conv a connector,
    the taps at each group's resolution); ``ae = 1`` replaces the last tap
    by the bottleneck.  Decoder units are a 1x1 ConvBlock, a
    ``TransConv`` (k4 s2, BatchNorm, ReLU) and a 1x1 ConvBlock: one on the
    last tap (8F), then for taps 3, 2, 1 the tap through a 1x1 ConvBlock
    (8F, 4F, 2F; gated with ``ag``), concatenated after the decoded
    tensor, and a unit to half that width.  Then a k3 s2 ``TransConv`` to
    F, 3-wide and 2-wide ConvBlocks, ``Dropout`` (``dropout_rate``), and
    the ``out`` head, a ``Dense`` on (B, L, C).  DS heads: ``level4`` on
    the last tap, ``level3..1`` on each concat, ``level0`` on the last
    decoded tensor (L / 32 .. L / 2: each half its UNet-type target's
    length, so JAX's loss cannot pair them).  The length must be a
    multiple of 32."""

    _GROUPS = {
        18: ([2, 1, 1, 1], False),
        34: ([3, 3, 5, 2], False),
        50: ([3, 3, 5, 2], True),
        101: ([3, 3, 22, 2], True),
        152: ([3, 7, 35, 2], True),
    }

    def __init__(self, variant: int, num_filters: int,
                 problem_type: str = "Regression", output_nums: int = 1,
                 ds: int = 0, ae: int = 0, ag: int = 0,
                 feature_number: int = 1024, dropout_rate: float = 0.0,
                 in_channels: int = 1, length: tp.Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(locals(), problem_type, output_nums, ds, ae, length,
                         dtype, generator)
        if variant not in self._GROUPS:
            raise ValueError(f"unknown AlbUNet variant {variant!r}")
        F = num_filters
        blocks, bneck = self._GROUPS[variant]
        self.model_depth = 4
        self.ag = ag
        self._alias("stem", self._cb(in_channels, F, 7, stride=2))
        feats = [F, F * 2, F * 4, F * 8]
        self.groups = []
        cin = F
        size = -(-(length or 0) // 2) // 2
        for g in range(4):
            group = self._add(ResidualGroup(cin, feats[g], blocks[g],
                                            bottleneck=bneck,
                                            connector=False, **self._kw),
                              "_ResidualGroup")
            taps_w = group.out_features
            conn = []
            if g < 3:
                conn = [self._cb(taps_w, feats[g] * 2, 3, stride=2),
                        self._cb(feats[g] * 2, feats[g] * 2, 3),
                        self._cb(feats[g] * 2, feats[g] * 2, 3)]
                size = -(-size // 2)
            self.groups.append((group, conn))
            cin = feats[g] * 2
        taps = [g.out_features for g, _ in self.groups]
        self._alias("bottom_ae", self._ae(taps[3], size, F,
                                                feature_number))
        x4 = F if self.bottom_ae is not None else taps[3]
        self._ds_head(x4, 4)
        self.units = [self._unit(x4, F * 8)]
        self.skips = []
        cin = F * 8
        for lvl, (tap, f) in enumerate([(taps[2], F * 8), (taps[1], F * 4),
                                        (taps[0], F * 2)]):
            skip: tp.Dict[str, tp.Any] = {"cb": self._cb(tap, f, 1),
                                          "ag": None}
            if ag:
                skip["ag"] = self._add(AttentionGate(f, cin, f, dialect="1d",
                                                     **self._kw))
            cin += f
            skip["ds"] = self._ds_head(cin, 3 - lvl)
            self.skips.append(skip)
            self.units.append(self._unit(cin, f // 2))
            cin = f // 2
        self.tail = [self._tc(cin, F, 3, 2), self._cb(F, F, 3),
                     self._cb(F, F, 2)]
        self._ds_head(cin, 0)
        self.dropout = Dropout(dropout_rate or 0.0)
        self.out = Dense(F, output_nums, **self._kw)

    def _unit(self, cin: int, f: int) -> tp.List[nn.Module]:
        return [self._cb(cin, f, 1), self._tc(f, f, 4, 2), self._cb(f, f, 1)]

    @staticmethod
    def _run(blocks: tp.Sequence[nn.Module], x: torch.Tensor) -> torch.Tensor:
        for block in blocks:
            x = block(x)
        return x

    def forward(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        h = downsample_pool(self.stem(self._signal(x)), 2, op="max", rank=1)
        taps = []
        for group, conn in self.groups:
            h = group(h)
            taps.append(h)
            h = self._run(conn, h)
        x4 = taps[3]
        if self.bottom_ae is not None:
            x4 = self.bottom_ae(x4)
        levels = []
        if self.ds == 1:
            levels.append(self.level4(x4))
        decode = self._run(self.units[0], x4)
        for skip, tap, unit in zip(self.skips, taps[2::-1], self.units[1:]):
            s = skip["cb"](tap)
            if skip["ag"] is not None:
                s = skip["ag"](s, decode)
            decode = concat(decode, s)
            if skip["ds"] is not None:
                levels.append(skip["ds"](decode))
            decode = self._run(unit, decode)
        out = self._run(self.tail, decode)
        if self.ds == 1:
            levels.append(self.level0(decode))
        y = self.out(self.dropout(out)[:, :, 0].permute(0, 2, 1))
        if self.softmax_head:
            y = torch.softmax(y, dim=-1)
        outputs = {"out": y}
        for name, lvl in zip(self.levels, levels):
            outputs[name] = lvl[:, :, 0].permute(0, 2, 1)
        return outputs


class AlbUNet:
    """Facade with the reference's constructor and method names (JAX
    extra_1d.py:271): AlbUNet18, 34, 50, 101 and 152."""

    _VARIANTS = (18, 34, 50, 101, 152)

    def __init__(self, length, num_channel, num_filters, ds=0, ae=0, ag=0,
                 problem_type="Regression", output_nums=1, pooling="avg",
                 feature_number=1024, dropout_rate=False,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        self._kw = dict(num_filters=num_filters, problem_type=problem_type,
                        output_nums=output_nums, ds=ds, ae=ae, ag=ag,
                        feature_number=feature_number,
                        dropout_rate=dropout_rate or 0.0,
                        in_channels=num_channel, length=length, dtype=dtype,
                        generator=generator)

    def __getattr__(self, name: str):
        if name.startswith("AlbUNet") and name[7:].isdigit() and \
                int(name[7:]) in self._VARIANTS:
            return lambda: AlbUNetModel(variant=int(name[7:]), **self._kw)
        raise AttributeError(name)


#: the LinkNet family's method names (JAX extra_1d.py:362)
LINKNET_NAMES = ("LinkNet", "LinkNetE", "LinkNetP", "LinkNetPP",
                 "MultiResLinkNet")


class LinkNet:
    """Facade with the reference's constructor and method names (JAX
    ``LinkNet``, extra_1d.py:362): LinkNet, LinkNetE, LinkNetP, LinkNetPP
    and MultiResLinkNet, each a ``SegModel1D`` whose decoder adds the skip
    to the upsampled tensor (``merge = "add"``)."""

    def __init__(self, length, model_depth, num_channel, model_width,
                 kernel_size, problem_type="Regression", output_nums=1,
                 ds=0, ae=0, ag=0, lstm=0, alpha=1.0, feature_number=1024,
                 is_transconv=True, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        self._kw = dict(model_width=model_width, model_depth=model_depth,
                        kernel_size=kernel_size, problem_type=problem_type,
                        output_nums=output_nums, ds=ds, ae=ae, ag=ag,
                        lstm=lstm, alpha=alpha, in_channels=num_channel,
                        feature_number=feature_number,
                        is_transconv=is_transconv, length=length,
                        dtype=dtype, generator=generator)

    def __getattr__(self, name: str):
        if name in LINKNET_NAMES:
            from .api_1d import SegModel1D

            return lambda: SegModel1D(arch=name, **self._kw)
        raise AttributeError(name)


class FPN1DModel(_Family1D):
    """The 1D FPN (JAX ``FPN1DModel``, extra_1d.py:386): D levels of two
    ConvBlocks, each pooled, and a one-channel lateral 1x1 conv
    (``Conv_<i>``) on each; ``ae = 1`` puts the bottleneck on the last
    pool, which the decoder starts from (no latent block).  Step j: with
    ``ag`` the lateral gated by ``AttentionGate_j``, the head
    ``level<D - j>`` on the step's input, the upsampling (``TransConv_j``,
    k2 s2, BatchNorm, ReLU, or a nearest repeat), the lateral added (it
    broadcasts over the channels: the reference's quirk), two ConvBlocks
    W * 2**(D - j - 1) wide.  The output is the concat pyramid of the
    steps' outputs, each total so far repeated by 2 before the next
    joins it."""

    def __init__(self, model_width: int, model_depth: int,
                 kernel_size: int = 3, problem_type: str = "Regression",
                 output_nums: int = 1, ds: int = 0, ae: int = 0, ag: int = 0,
                 feature_number: int = 1024, is_transconv: bool = True,
                 in_channels: int = 1, length: tp.Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(locals(), problem_type, output_nums, ds, ae, length,
                         dtype, generator)
        if model_depth < 1:
            raise ValueError("The depth of the model cannot be less than 1")
        D, W, k = model_depth, model_width, kernel_size
        self.model_depth = D
        self.ag = ag
        self.enc = []
        cin = in_channels
        for i in range(1, D + 1):
            f = W * 2 ** (i - 1)
            self.enc.append((self._cb(cin, f, k), self._cb(f, f, k),
                             self._add(HeadConv(f, 1, **self._kw), "Conv")))
            cin = f
        self._alias("bottom_ae", self._ae(
            cin, pooled_size(length or 0, D), W, feature_number))
        if self.bottom_ae is not None:
            cin = W
        self.dec = []
        widths = []
        for j in range(D):
            f = W * 2 ** (D - j - 1)
            step: tp.Dict[str, tp.Any] = {"ag": None, "up": None}
            if ag:
                step["ag"] = self._add(AttentionGate(1, cin, f, dialect="1d",
                                                     **self._kw))
            step["ds"] = self._ds_head(cin, D - j)
            if is_transconv:
                step["up"] = self._tc(cin, f, 2, 2)
                cin = f
            step["cbs"] = (self._cb(cin, f, k), self._cb(f, f, k))
            self.dec.append(step)
            cin = f
            widths.append(f)
        self._head(sum(widths))

    def forward(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        D = self.model_depth
        laterals, pool = [], self._signal(x)
        for cb1, cb2, lateral in self.enc:
            conv = cb2(cb1(pool))
            pool = downsample_pool(conv, 2, op="max", rank=1)
            laterals.append(lateral(conv))
        deconv = pool if self.bottom_ae is None else self.bottom_ae(pool)
        stages, levels = [], []
        for j, step in enumerate(self.dec):
            skip = laterals[D - j - 1]
            if step["ag"] is not None:
                skip = step["ag"](skip, deconv)
            if step["ds"] is not None:
                levels.append(step["ds"](deconv))
            up = (step["up"](deconv) if step["up"] is not None
                  else upsample(deconv, 2, method="nearest", rank=1))
            deconv = skip + up
            for block in step["cbs"]:
                deconv = block(deconv)
            stages.append(deconv)
        tot = stages[0]
        for stage in stages[1:]:
            tot = concat(upsample(tot, 2, method="nearest", rank=1), stage)
        return self._outputs(tot, levels)


class FPN:
    """Facade with the reference's constructor and method name (JAX
    extra_1d.py:448)."""

    def __init__(self, length, model_depth, num_channel, model_width,
                 kernel_size, problem_type="Regression", output_nums=1,
                 ds=0, ae=0, ag=0, feature_number=1024, is_transconv=True,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        self._kw = dict(model_width=model_width, model_depth=model_depth,
                        kernel_size=kernel_size, problem_type=problem_type,
                        output_nums=output_nums, ds=ds, ae=ae, ag=ag,
                        feature_number=feature_number,
                        is_transconv=is_transconv, in_channels=num_channel,
                        length=length, dtype=dtype, generator=generator)

    def FPN(self) -> FPN1DModel:
        return FPN1DModel(**self._kw)
