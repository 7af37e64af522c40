"""The Dense-Inception UNet of the port (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/models/dense_inception.py), on its blocks
``InceptionResBlock`` (:37), ``DenseInceptionBlock`` (:61),
``DownsamplingBlock`` (:73) and ``UpsamplingBlock`` (:96).

A ``DownsamplingBlock``'s max pool by 2 is the 1D pyramid kernel on the
card; at level 1 it reads the first block's output, 1 + W channels for a
one-channel signal, which an odd count sends to the one-channel-a-thread
route of ``pool1d_kernel``.
"""
from __future__ import annotations

import typing as tp

import torch

from ..ops import (AttentionGate, AutoNamed, BatchNorm, ConvBlock, TransConv,
                   concat, downsample_pool, pooled_size, upsample)
from .extra_1d import _Family1D


class InceptionResBlock(AutoNamed):
    """Three inception branches ``features`` wide (a 1x1 ConvBlock; a bare
    1x1 conv then a 3-wide ConvBlock; a bare 1x1 conv then two 3-wide
    ConvBlocks), concatenated through a 1x1 ConvBlock, the input
    concatenated before it, ``BatchNorm_0`` and ReLU (JAX
    ``InceptionResBlock``, dense_inception.py:37): ``in_features +
    features`` wide."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        f = features
        kw = dict(dtype=dtype, generator=generator, rank=1)

        def conv(cin, k, bare=False):
            return self._add(ConvBlock(cin, f, k, use_bn=not bare,
                                       activation=None if bare else "relu",
                                       **kw))

        self.b1 = [conv(in_features, 1)]
        self.b2 = [conv(in_features, 1, bare=True), conv(f, 3)]
        self.b3 = [conv(in_features, 1, bare=True), conv(f, 3), conv(f, 3)]
        self._alias("branch", conv(3 * f, 1))
        self.out_features = in_features + f
        self.BatchNorm_0 = BatchNorm(self.out_features)

    @staticmethod
    def _run(blocks, x: torch.Tensor) -> torch.Tensor:
        for block in blocks:
            x = block(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branch = self.branch(concat(self._run(self.b1, x),
                                    self._run(self.b2, x),
                                    self._run(self.b3, x)))
        return torch.relu(self.BatchNorm_0(concat(x, branch)))


class DenseInceptionBlock(AutoNamed):
    """Three times ``x = [x, InceptionResBlock(x)]`` (JAX
    ``DenseInceptionBlock``, dense_inception.py:61): ``8 in_features + 7
    features`` wide."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.blocks = []
        cin = in_features
        for _ in range(3):
            block = self._add(InceptionResBlock(cin, features, dtype,
                                                generator))
            self.blocks.append(block)
            cin += block.out_features
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = concat(x, block(x))
        return x


class DownsamplingBlock(AutoNamed):
    """Halves the length (JAX ``DownsamplingBlock``, dense_inception.py:
    73): [the input max-pooled by 2, a bare 1x1 conv then a stride-2
    3-wide ConvBlock, a bare 1x1 then a bare 3-wide conv then a stride-2
    3-wide ConvBlock], a 1x1 ConvBlock, ``BatchNorm_0`` and ReLU,
    ``features`` wide.  The length must be even."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        f = features
        kw = dict(dtype=dtype, generator=generator, rank=1)
        bare = dict(use_bn=False, activation=None)
        self.a = [self._add(ConvBlock(in_features, f, 1, **bare, **kw)),
                  self._add(ConvBlock(f, f, 3, stride=2, **kw))]
        self.b = [self._add(ConvBlock(in_features, f, 1, **bare, **kw)),
                  self._add(ConvBlock(f, f, 3, **bare, **kw)),
                  self._add(ConvBlock(f, f, 3, stride=2, **kw))]
        self._alias("merge", self._add(ConvBlock(in_features + 2 * f, f,
                                                     1, **kw)))
        self.BatchNorm_0 = BatchNorm(f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pool = downsample_pool(x, 2, op="max", rank=1)
        a = InceptionResBlock._run(self.a, x)
        b = InceptionResBlock._run(self.b, x)
        return torch.relu(self.BatchNorm_0(self.merge(concat(pool, a, b))))


class UpsamplingBlock(AutoNamed):
    """Doubles the length (JAX ``UpsamplingBlock``, dense_inception.py:
    96): [the input repeated by 2, a k1 ``TransConv`` then a k3 s2 one, a
    k1, a k3 s1 and a k3 s2 one], a k1 ``TransConv``, ``BatchNorm_0`` and
    ReLU, ``features`` wide; the k1 convs bare, the others with BatchNorm
    and ReLU."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        f = features
        kw = dict(dtype=dtype, generator=generator, rank=1)

        def tc(cin, k, s, bare=False):
            return self._add(TransConv(cin, f, kernel=k, strides=s,
                                       use_bn=not bare,
                                       activation=None if bare else "relu",
                                       **kw))

        self.a = [tc(in_features, 1, 1, bare=True), tc(f, 3, 2)]
        self.b = [tc(in_features, 1, 1, bare=True), tc(f, 3, 1), tc(f, 3, 2)]
        self._alias("merge", tc(in_features + 2 * f, 1, 1))
        self.BatchNorm_0 = BatchNorm(f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = upsample(x, 2, method="nearest", rank=1)
        a = InceptionResBlock._run(self.a, x)
        b = InceptionResBlock._run(self.b, x)
        return torch.relu(self.BatchNorm_0(self.merge(concat(up, a, b))))


class DenseInceptionUNetModel(_Family1D):
    """The Dense-Inception UNet (JAX ``DenseInceptionUNetModel``,
    dense_inception.py:123): level i (width W * 2**(i-1)) an
    ``InceptionResBlock``, a ``DenseInceptionBlock`` at level D, its
    output the tap and a ``DownsamplingBlock`` the next input; the latent
    a DenseInceptionBlock 2**D W wide.  Step j (level D - j): with ``ag``
    the tap gated by ``AttentionGate_j`` with the step's input, the head
    ``level<D - j>`` on that input, an ``UpsamplingBlock``, [upsampled,
    tap], a DenseInceptionBlock at level D, else an InceptionResBlock.
    A last InceptionResBlock ``max(W // 2, 1)`` wide and the ``out`` head
    (softmax for ``Classification``).  ``ae = 1`` puts the bottleneck on
    the last DownsamplingBlock's output."""

    def __init__(self, model_width: int, model_depth: int,
                 kernel_size: int = 3, problem_type: str = "Regression",
                 output_nums: int = 1, ds: int = 0, ae: int = 0, ag: int = 0,
                 feature_number: int = 1024, in_channels: int = 1,
                 length: tp.Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(locals(), problem_type, output_nums, ds, ae, length,
                         dtype, generator)
        if model_depth < 1:
            raise ValueError("The depth of the model cannot be less than 1")
        D, W = model_depth, model_width
        self.model_depth = D
        self.enc = []
        taps = []
        cin = in_channels
        for i in range(1, D + 1):
            f = W * 2 ** (i - 1)
            kind = DenseInceptionBlock if i == D else InceptionResBlock
            block = self._add(kind(cin, f, **self._kw))
            taps.append(block.out_features)
            self.enc.append((block, self._add(DownsamplingBlock(
                block.out_features, f, **self._kw))))
            cin = f
        self._alias("bottom_ae", self._ae(
            cin, pooled_size(length or 0, D), W, feature_number))
        cin = cin if self.bottom_ae is None else W
        self._alias("latent", self._add(DenseInceptionBlock(
            cin, W * 2 ** D, **self._kw)))
        cin = self.latent.out_features
        self.dec = []
        for j in range(D):
            layer = D - j
            f = W * 2 ** (layer - 1)
            step: tp.Dict[str, tp.Any] = {"ag": None}
            if ag:
                step["ag"] = self._add(AttentionGate(
                    taps[layer - 1], cin, f, dialect="1d", **self._kw))
            step["ds"] = self._ds_head(cin, layer)
            step["up"] = self._add(UpsamplingBlock(cin, f, **self._kw))
            kind = DenseInceptionBlock if layer == D else InceptionResBlock
            step["node"] = self._add(kind(f + taps[layer - 1], f,
                                          **self._kw))
            cin = step["node"].out_features
            self.dec.append(step)
        self._alias("last", self._add(InceptionResBlock(
            cin, max(W // 2, 1), **self._kw)))
        self._head(self.last.out_features)

    def forward(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        D = self.model_depth
        taps, pool = [], self._signal(x)
        for block, down in self.enc:
            conv = block(pool)
            pool = down(conv)
            taps.append(conv)
        if self.bottom_ae is not None:
            pool = self.bottom_ae(pool)
        deconv, levels = self.latent(pool), []
        for j, step in enumerate(self.dec):
            skip = taps[D - j - 1]
            if step["ag"] is not None:
                skip = step["ag"](skip, deconv)
            if step["ds"] is not None:
                levels.append(step["ds"](deconv))
            deconv = step["node"](concat(step["up"](deconv), skip))
        return self._outputs(self.last(deconv), levels)


class Dense_Inception_UNet:
    """Facade with the reference's constructor and method name (JAX
    dense_inception.py:186)."""

    def __init__(self, length, model_depth, num_channel, model_width,
                 kernel_size, problem_type="Regression", output_nums=1,
                 ds=0, ae=0, ag=0, feature_number=1024,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        self._kw = dict(model_width=model_width, model_depth=model_depth,
                        kernel_size=kernel_size, problem_type=problem_type,
                        output_nums=output_nums, ds=ds, ae=ae, ag=ag,
                        feature_number=feature_number,
                        in_channels=num_channel, length=length, dtype=dtype,
                        generator=generator)

    def Dense_Inception_UNet(self) -> DenseInceptionUNetModel:
        return DenseInceptionUNetModel(**self._kw)
