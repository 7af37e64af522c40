"""The SAUNet family of the port, SAUNet, SAMultiResUNet and SelfSAUNet
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/saunet.py), on
its regulated blocks ``ConvBlockRegulated`` (:38) and
``MultiResBlockRegulated`` (:57), with ``DropBlock`` and
``SpatialAttention`` (ops/stochastic.py, ops/blocks.py).

DropBlock draws in training mode only, from the train step's keyed stream
(ops/stochastic.py); the encoders' pools by 2 are the 1D pyramid kernel
on the card.
"""
from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops import (BatchNorm, DropBlock, MultiResBlock, Oper, OperTranspose,
                   ResPath, SameConv, SpatialAttention, TransConv, concat,
                   downsample_pool, multires_features, pooled_size, upsample)
from .extra_1d import _Family1D


class ConvBlockRegulated(nn.Module):
    """conv, DropBlock, BatchNorm, ReLU (JAX ``ConvBlockRegulated``,
    saunet.py:38): ``Conv_0`` a plain SAME conv (flax's default init,
    bias), ``BatchNorm_0``."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 block_size: int = 7, keep_prob: float = 0.9,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = SameConv(in_features, features, kernel, dtype=dtype,
                               generator=generator, rank=1)
        self.drop = DropBlock(block_size, keep_prob)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.drop(self.Conv_0(x))))


class MultiResBlockRegulated(MultiResBlock):
    """The 1D MultiRes block with a DropBlock on its branches' concat,
    before ``BatchNorm_0`` (JAX ``MultiResBlockRegulated``, saunet.py:57):
    widths as the 1D tree's (``multires_widths`` of the base width,
    truncated, then times ``multiplier``)."""

    def __init__(self, in_features: int, model_width: int,
                 multiplier: int = 1, kernel: int = 3, alpha: float = 1.0,
                 block_size: int = 7, keep_prob: float = 0.9,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(in_features, model_width, kernel, alpha=alpha,
                         dtype=dtype, generator=generator,
                         multiplier=multiplier, rank=1)
        self.drop = DropBlock(block_size, keep_prob)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut, b1, b2, b3 = (getattr(self, n) for n in self._units)
        c3 = b1(x)
        c5 = b2(c3)
        c7 = b3(c5)
        out = self.BatchNorm_0(self.drop(concat(c3, c5, c7)))
        return self.BatchNorm_1(torch.relu(shortcut(x) + out))


class SAUNetModel(_Family1D):
    """The SAUNet chains (JAX ``SAUNetModel``, saunet.py:88) of
    ``variant``:

    - ``SAUNet``: two ``ConvBlockRegulated`` a level and a decoder node;
    - ``SAMultiResUNet``: one ``MultiResBlockRegulated`` (its output
      pooled) and a ``ResPath`` of length D - i + 1, not regulated, as the
      level's tap;
    - ``SelfSAUNet``: one Self-ONN unit: ``Oper`` (order ``q``, no
      activation), DropBlock, ``BatchNorm``, tanh; the decoder upsamples
      by ``OperTranspose`` (k4 s2, tanh).

    D levels each pooled by 2, then the latent: a unit 2**D W wide,
    ``SpatialAttention`` (k7), another unit.  Step j: the head
    ``level<D - j>`` on its input, the upsampling (the 1D ``TransConv``
    k2 s2 with BatchNorm and ReLU, SelfSAUNet's OperTranspose, or a
    nearest repeat), [upsampled, tap D - j - 1], the node.  The ``out``
    head is linear for ``output_nums`` 1, softmax otherwise.  ``ae = 1``
    puts the bottleneck on the last pool.  Every DropBlock has
    ``block_size`` and ``keep_prob``."""

    def __init__(self, variant: str, model_width: int, model_depth: int,
                 kernel_size: int = 3, output_nums: int = 1, ds: int = 0,
                 ae: int = 0, alpha: float = 1.0, feature_number: int = 1024,
                 block_size: int = 7, keep_prob: float = 0.9,
                 is_transconv: bool = True, q: int = 3,
                 in_channels: int = 1, length: tp.Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(locals(), "Regression", output_nums, ds, ae, length,
                         dtype, generator)
        if variant not in ("SAUNet", "SAMultiResUNet", "SelfSAUNet"):
            raise ValueError(f"unknown SAUNet variant {variant!r}")
        if model_depth < 1:
            raise ValueError("The depth of the model cannot be less than 1")
        self.softmax_head = output_nums > 1
        self.variant = variant
        self.model_depth = model_depth
        self._args = dict(W=model_width, k=kernel_size, alpha=alpha,
                          block_size=block_size, keep_prob=keep_prob, q=q)
        D, W = model_depth, model_width
        reps = 2 if variant == "SAUNet" else 1
        self.enc = []
        cin = in_channels
        taps = []
        for i in range(1, D + 1):
            feats = W * 2 ** (i - 1)
            units = []
            for _ in range(reps):
                unit, cin = self._unit(cin, feats)
                units.append(unit)
            tap = None
            if variant == "SAMultiResUNet":
                tap = self._add(ResPath(cin, D - i + 1, feats, kernel_size,
                                        rank=1, **self._kw))
            taps.append(feats if tap is not None else cin)
            self.enc.append((units, tap))
        self._alias("bottom_ae", self._ae(
            cin, pooled_size(length or 0, D), W, feature_number))
        cin = cin if self.bottom_ae is None else W
        first, cin = self._unit(cin, W * 2 ** D)
        attention = self._add(SpatialAttention(7, rank=1, **self._kw))
        second, cin = self._unit(cin, W * 2 ** D)
        self.latent = (first, attention, second)
        self.dec = []
        for j in range(D):
            feats = W * 2 ** (D - j - 1)
            step: tp.Dict[str, tp.Any] = {"ds": self._ds_head(cin, D - j),
                                          "up": None}
            if is_transconv:
                if variant == "SelfSAUNet":
                    step["up"] = self._add(OperTranspose(
                        cin, feats, activation="tanh", q=q, rank=1,
                        **self._kw))
                else:
                    step["up"] = self._add(TransConv(cin, feats, dialect="1d",
                                                     **self._kw))
                cin = feats
            cin += taps[D - j - 1]
            units = []
            for _ in range(reps):
                unit, cin = self._unit(cin, feats)
                units.append(unit)
            step["units"] = units
            self.dec.append(step)
        self._head(cin)

    def _unit(self, cin: int, feats: int
              ) -> tp.Tuple[tp.Sequence[nn.Module], int]:
        """One regulated unit of width ``feats`` on ``cin`` channels: its
        modules (run in order, SelfSAUNet's ending in tanh) and its
        output's width."""
        a, kw = self._args, self._kw
        if self.variant == "SAMultiResUNet":
            m = feats // a["W"]
            return (self._add(MultiResBlockRegulated(
                cin, a["W"], m, a["k"], a["alpha"], a["block_size"],
                a["keep_prob"], **kw)),), multires_features(a["W"],
                                                            a["alpha"], m)
        if self.variant == "SelfSAUNet":
            return (self._add(Oper(cin, feats, a["k"], q=a["q"], rank=1,
                                   **kw)),
                    self._add(DropBlock(a["block_size"], a["keep_prob"])),
                    self._add(BatchNorm(feats)), torch.tanh), feats
        return (self._add(ConvBlockRegulated(
            cin, feats, a["k"], a["block_size"], a["keep_prob"], **kw)),
            ), feats

    @staticmethod
    def _run(units, x: torch.Tensor) -> torch.Tensor:
        for unit in units:
            for layer in unit:
                x = layer(x)
        return x

    def forward(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        D = self.model_depth
        taps, pool = [], self._signal(x)
        for units, tap in self.enc:
            conv = self._run(units, pool)
            pool = downsample_pool(conv, 2, op="max", rank=1)
            taps.append(tap(conv) if tap is not None else conv)
        if self.bottom_ae is not None:
            pool = self.bottom_ae(pool)
        first, attention, second = self.latent
        deconv = self._run([second], attention(self._run([first], pool)))
        levels = []
        for j, step in enumerate(self.dec):
            if step["ds"] is not None:
                levels.append(step["ds"](deconv))
            up = (step["up"](deconv) if step["up"] is not None
                  else upsample(deconv, 2, method="nearest", rank=1))
            deconv = self._run(step["units"], concat(up, taps[D - j - 1]))
        return self._outputs(deconv, levels)


class SAUNet:
    """Facade with the reference's constructor and method names (JAX
    saunet.py:189): SAUNet, SAMultiResUNet and SelfSAUNet; ``ds`` defaults
    to 1 as there (``model_selector_1d`` passes its own)."""

    def __init__(self, length, model_depth, num_channel, model_width,
                 kernel_size, output_nums=1, ds=1, ae=0, alpha=1,
                 feature_number=1024, block_size=7, keep_prob=0.9,
                 is_transconv=True, q=3, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        self._kw = dict(model_width=model_width, model_depth=model_depth,
                        kernel_size=kernel_size, output_nums=output_nums,
                        ds=ds, ae=ae, alpha=alpha,
                        feature_number=feature_number, block_size=block_size,
                        keep_prob=keep_prob, is_transconv=is_transconv, q=q,
                        in_channels=num_channel, length=length, dtype=dtype,
                        generator=generator)

    def SAUNet(self) -> SAUNetModel:
        return SAUNetModel(variant="SAUNet", **self._kw)

    def SAMultiResUNet(self) -> SAUNetModel:
        return SAUNetModel(variant="SAMultiResUNet", **self._kw)

    def SelfSAUNet(self) -> SAUNetModel:
        return SAUNetModel(variant="SelfSAUNet", **self._kw)
