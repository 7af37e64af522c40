"""The MLMRSNet family of the port, MLMRSNet, MLMRSNet_V2 and LDNet (JAX:
tf_1d_2d_segmentation_end2endpipelines_tpu/models/mlmrsnet.py), on its
multi-scale-pooling blocks ``MSPUnit`` (:47) and ``MRPBlock`` (:82).

``pool_same`` (:35) is a window-3 SAME pool at a stride, a
``reduce_window`` in JAX and not a Pallas kernel: it stays plain PyTorch.
The encoders' pools by 2**m (``downsample_pool``) are the 1D pyramid
kernel on the card.
"""
from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (AutoNamed, ConvBlock, HeadConv, TransConv, concat,
                   downsample_pool, pooled_size, same_pads, upsample)
from .extra_1d import _Family1D


def pool_same(x: torch.Tensor, stride: int, op: str) -> torch.Tensor:
    """A window-3 pool at ``stride`` along the length of a (B, C, 1, L)
    signal, SAME (JAX ``_pool_same``): ``ceil(L / stride)`` outputs, the
    padding split as ``same_pads`` splits it (0 before and 1 after at
    stride 2 on an even length).  ``max`` pads with -inf; ``avg`` sums the
    window and divides by the count of its valid (unpadded) elements."""
    lo, hi = same_pads(x.shape[3], 3, stride)
    if op == "max":
        return F.max_pool2d(F.pad(x, (lo, hi), value=float("-inf")), (1, 3),
                            (1, stride))
    total = F.avg_pool2d(F.pad(x, (lo, hi)), (1, 3), (1, stride),
                         divisor_override=1)
    ones = F.pad(torch.ones((1, 1, 1, x.shape[3]), dtype=x.dtype,
                            device=x.device), (lo, hi))
    count = F.avg_pool2d(ones, (1, 3), (1, stride), divisor_override=1)
    return total / count


class MSPUnit(AutoNamed):
    """Multi-scale pooling unit (JAX ``MSPUnit``, mlmrsnet.py:47): the
    input pooled at stride ``level`` (``pool_same``; ``mix``: the max plus
    the average through a plain 1x1 ``Conv_0`` of the input's width), a
    1x1 ConvBlock to ``width * multiplier``, [a k4 ``TransConv`` at
    stride ``level`` (BatchNorm, ReLU), a nearest repeat by ``level``] and
    a 1x1 ConvBlock without BatchNorm to ``width``."""

    def __init__(self, in_features: int, width: int, multiplier: int,
                 level: int, pooling_type: str = "mix",
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        wm = width * multiplier
        self.level = level
        self.pooling_type = pooling_type
        if pooling_type == "mix":
            self._add(HeadConv(in_features, in_features, **kw), "Conv")
        self.ConvBlock_0 = ConvBlock(in_features, wm, 1, rank=1, **kw)
        self.TransConv_0 = TransConv(wm, wm, rank=1, kernel=4, strides=level,
                                     use_bn=True, activation="relu", **kw)
        self.ConvBlock_1 = ConvBlock(2 * wm, width, 1, use_bn=False, rank=1,
                                     **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pooling_type == "mix":
            p = self.Conv_0(pool_same(x, self.level, "max")
                            + pool_same(x, self.level, "avg"))
        else:
            p = pool_same(x, self.level,
                          "avg" if self.pooling_type == "avg" else "max")
        p = self.ConvBlock_0(p)
        out = concat(self.TransConv_0(p),
                     upsample(p, self.level, method="nearest", rank=1))
        return self.ConvBlock_1(out)


class MRPBlock(AutoNamed):
    """Multi-resolution pooling block (JAX ``MRPBlock``, mlmrsnet.py:82):
    the input concatenated with ``cardinality`` ``MSPUnit``s of it at
    strides 1, 2, .., 2**(cardinality - 1), then 3-, 5- and 7-wide
    ConvBlocks without BatchNorm, concatenated, and a 1x1 ConvBlock, all
    ``width * multiplier`` wide."""

    def __init__(self, in_features: int, width: int, multiplier: int,
                 cardinality: int = 5, pooling_type: str = "mix",
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        f = width * multiplier
        self.units = [self._add(MSPUnit(in_features, width, multiplier,
                                        2 ** ii, pooling_type, **kw))
                      for ii in range(cardinality)]
        cin = in_features + cardinality * width
        self.convs = [self._add(ConvBlock(cin, f, k, use_bn=False, rank=1,
                                          **kw)) for k in (3, 5, 7)]
        self._alias("last", self._add(ConvBlock(3 * f, f, 1, rank=1,
                                                       **kw)))
        self.out_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = concat(x, *[unit(x) for unit in self.units])
        return self.last(concat(*[conv(acc) for conv in self.convs]))


class MLMRSNetModel(_Family1D):
    """The three MLMRSNet topologies (JAX ``MLMRSNetModel``, mlmrsnet.py:
    109), by ``topology``:

    - ``MLMRSNet``: D levels of an ``MRPBlock`` (multiplier 2**(i-1),
      ``cardinality``) each pooled by 2, the latent MRPBlock (2**D); step
      j: the head ``level<D - j>`` on its input, the k1 s2 ``TransConv``
      (BatchNorm, ReLU; the reference's 1-wide kernel) or a nearest
      repeat, [upsampled, tap D - j - 1], an MRPBlock (2**(D-j-1)).
    - ``MLMRSNet_V2``: level i's input also concatenates taps 1 .. i-1
      (tap 0 skipped: the reference's indexing) each pooled to it, its
      MRPBlock of cardinality D - i + 1, the latent of cardinality 1; step
      j concatenates tap D - j - 1, the earlier taps pooled to it, the
      sigmoid of the input repeated by 2 and of every earlier step's
      output repeated to this level, into an MRPBlock (multiplier D + 1,
      cardinality j + 1); heads ``level<D - j>`` of stride 2 on each
      step's output (half its length).
    - ``LDNet``: level i's MRPBlock of cardinality D - i + 1, the latent
      of cardinality 0 and multiplier 2**(D - 1) (the reference reuses
      its loop variable); the UNet++ grid of two-ConvBlock nodes
      (``kernel_size``), node (j, i) reading the k2 s2 ``TransConv`` of
      the node below or a nearest repeat, its row's earlier nodes and tap
      j, and on the diagonal i + j = D (but row D - 1) the diagonal's
      nodes (D - m, m), m in 1 .. i - 2, repeated to its row; heads
      ``level<D>`` on tap 0 and ``level<D - i>`` on node (0, i), all at
      full length.

    The ``out`` head is linear, softmax for ``Classification``; ``ae = 1``
    puts the bottleneck on the last pool."""

    def __init__(self, topology: str, model_width: int, model_depth: int,
                 kernel_size: int = 3, problem_type: str = "Regression",
                 output_nums: int = 1, ds: int = 0, ae: int = 0,
                 cardinality: int = 5, pooling_type: str = "avg",
                 feature_number: int = 1024, is_transconv: bool = True,
                 in_channels: int = 1, length: tp.Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(locals(), problem_type, output_nums, ds, ae, length,
                         dtype, generator)
        if topology not in ("MLMRSNet", "MLMRSNet_V2", "LDNet"):
            raise ValueError(f"Unknown MLMRSNet topology {topology!r}")
        if model_depth < 1:
            raise ValueError("The depth of the model cannot be less than 1")
        self.topology = topology
        self.model_depth = model_depth
        self.is_transconv = is_transconv
        self._pt = pooling_type
        build = {"MLMRSNet": self._build_v1, "MLMRSNet_V2": self._build_v2,
                 "LDNet": self._build_ld}[topology]
        self._head(build(model_width, model_depth, kernel_size, cardinality,
                         in_channels, feature_number))

    def _mrp(self, cin: int, multiplier: int, cardinality: int) -> MRPBlock:
        return self._add(MRPBlock(cin, self._width, multiplier, cardinality,
                                  self._pt, **self._kw))

    def _encoder_ae(self, cin: int, W: int, D: int,
                    feature_number: int) -> int:
        self._alias("bottom_ae", self._ae(
            cin, pooled_size(self.length or 0, D), W, feature_number))
        return cin if self.bottom_ae is None else W

    def _bottom(self, pool: torch.Tensor) -> torch.Tensor:
        return pool if self.bottom_ae is None else self.bottom_ae(pool)

    def _build_v1(self, W: int, D: int, k: int, card: int, cin: int,
                  feature_number: int) -> int:
        self._width = W
        self.enc = []
        for i in range(1, D + 1):
            self.enc.append(self._mrp(cin, 2 ** (i - 1), card))
            cin = W * 2 ** (i - 1)
        cin = self._encoder_ae(cin, W, D, feature_number)
        self._alias("latent", self._mrp(cin, 2 ** D, card))
        cin = W * 2 ** D
        self.dec = []
        for j in range(D):
            feats = W * 2 ** (D - j - 1)
            step: tp.Dict[str, tp.Any] = {"ds": self._ds_head(cin, D - j),
                                          "up": None}
            if self.is_transconv:
                step["up"] = self._add(TransConv(
                    cin, feats, rank=1, kernel=1, strides=2, use_bn=True,
                    activation="relu", **self._kw))
                cin = feats
            step["mrp"] = self._mrp(cin + feats, 2 ** (D - j - 1), card)
            cin = feats
            self.dec.append(step)
        return cin

    def _build_v2(self, W: int, D: int, k: int, card: int, cin: int,
                  feature_number: int) -> int:
        self._width = W
        self.enc = []
        for i in range(D):
            if i > 0:
                cin = W * 2 ** (i - 1) + sum(W * 2 ** kk
                                             for kk in range(1, i))
            self.enc.append(self._mrp(cin, 2 ** i, D - i + 1))
        cin = self._encoder_ae(W * 2 ** (D - 1), W, D, feature_number)
        self._alias("latent", self._mrp(cin, 2 ** D, 1))
        deconv, outs = W * 2 ** D, []
        self.dec = []
        for j in range(D):
            tot = sum(W * 2 ** kk for kk in range(0, D - j)) + deconv
            tot += sum(outs)
            mrp = self._mrp(tot, D + 1, j + 1)
            deconv = W * (D + 1)
            outs.append(deconv)
            self.dec.append({"mrp": mrp,
                             "ds": self._ds_head(deconv, D - j, stride=2)})
        return deconv

    def _build_ld(self, W: int, D: int, k: int, card: int, cin: int,
                  feature_number: int) -> int:
        self._width = W
        self.enc = []
        for i in range(1, D + 1):
            self.enc.append(self._mrp(cin, 2 ** (i - 1), D - i + 1))
            cin = W * 2 ** (i - 1)
        cin = self._encoder_ae(cin, W, D, feature_number)
        self._alias("latent", self._mrp(cin, 2 ** (D - 1), 0))
        skips = [W * 2 ** j for j in range(D)] + [W * 2 ** (D - 1)]
        self._ds_head(skips[0], D)
        width: tp.Dict[tp.Tuple[int, int], int] = {}
        self.grid: tp.Dict[tp.Tuple[int, int], tp.Dict[str, tp.Any]] = {}
        for i in range(1, D + 1):
            for j in range(0, D - i + 1):
                src = skips[j + 1] if i == 1 else width[(j + 1, i - 1)]
                feats = W * 2 ** j
                node: tp.Dict[str, tp.Any] = {"up": None, "paths": []}
                if self.is_transconv:
                    node["up"] = self._add(TransConv(
                        src, feats, rank=1, kernel=2, strides=2, use_bn=True,
                        activation="relu", **self._kw))
                    src = feats
                cin = src + skips[j] + sum(width[(j, kk)]
                                           for kk in range(1, i))
                if i > 1 and i + j == D and j != D - 1:
                    node["paths"] = list(range(1, i - 1))
                    cin += sum(width[(D - m, m)] for m in node["paths"])
                node["cbs"] = (self._add(ConvBlock(cin, feats, k, rank=1,
                                                   **self._kw)),
                               self._add(ConvBlock(feats, feats, k, rank=1,
                                                   **self._kw)))
                width[(j, i)] = feats
                node["ds"] = (self._ds_head(feats, D - i)
                              if j == 0 and i < D else None)
                self.grid[(j, i)] = node
        return width[(0, D)]

    def _encode(self, x: torch.Tensor
                ) -> tp.Tuple[tp.List[torch.Tensor], torch.Tensor]:
        taps, pool = [], x
        for mrp in self.enc:
            conv = mrp(pool)
            pool = downsample_pool(conv, 2, op="max", rank=1)
            taps.append(conv)
        return taps, self._bottom(pool)

    def _up(self, module: tp.Optional[nn.Module], x: torch.Tensor
            ) -> torch.Tensor:
        if module is not None:
            return module(x)
        return upsample(x, 2, method="nearest", rank=1)

    def forward(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        x = self._signal(x)
        fwd = {"MLMRSNet": self._forward_v1, "MLMRSNet_V2": self._forward_v2,
               "LDNet": self._forward_ld}[self.topology]
        return self._outputs(*fwd(x))

    def _forward_v1(self, x: torch.Tensor):
        D = self.model_depth
        taps, pool = self._encode(x)
        deconv, levels = self.latent(pool), []
        for j, step in enumerate(self.dec):
            if step["ds"] is not None:
                levels.append(step["ds"](deconv))
            deconv = step["mrp"](concat(self._up(step["up"], deconv),
                                        taps[D - j - 1]))
        return deconv, levels

    def _forward_v2(self, x: torch.Tensor):
        D = self.model_depth
        taps, pool = [], x
        for i, mrp in enumerate(self.enc):
            if i > 0:
                pool = concat(pool, *[
                    downsample_pool(taps[kk], 2 ** (i - kk), op="max", rank=1)
                    for kk in range(1, i)])
            conv = mrp(pool)
            taps.append(conv)
            pool = downsample_pool(conv, 2, op="max", rank=1)
        deconv, outs, levels = self.latent(self._bottom(pool)), [], []
        for j, step in enumerate(self.dec):
            tot = concat(taps[D - j - 1], *[
                downsample_pool(taps[kk], 2 ** ((D - j) - kk - 1), op="max",
                                rank=1) for kk in range(0, D - j - 1)],
                torch.sigmoid(upsample(deconv, 2, method="nearest", rank=1)),
                *[torch.sigmoid(upsample(outs[m], 2 ** (j - m),
                                         method="nearest", rank=1))
                  for m in range(j)])
            deconv = step["mrp"](tot)
            outs.append(deconv)
            if step["ds"] is not None:
                levels.append(step["ds"](deconv))
        return deconv, levels

    def _forward_ld(self, x: torch.Tensor):
        D = self.model_depth
        taps, pool = self._encode(x)
        skips = taps + [self.latent(pool)]
        levels = []
        if self.ds == 1:
            levels.append(getattr(self, f"level{D}")(skips[0]))
        nodes: tp.Dict[tp.Tuple[int, int], torch.Tensor] = {}
        for (j, i), node in self.grid.items():
            src = skips[j + 1] if i == 1 else nodes[(j + 1, i - 1)]
            merged = concat(self._up(node["up"], src),
                            *[nodes[(j, kk)] for kk in range(1, i)], skips[j],
                            *[upsample(nodes[(D - m, m)], 2 ** (i - m),
                                       method="nearest", rank=1)
                              for m in node["paths"]])
            out = merged
            for block in node["cbs"]:
                out = block(out)
            nodes[(j, i)] = out
            if node["ds"] is not None:
                levels.append(node["ds"](out))
        return nodes[(0, D)], levels


class MLMRSNet:
    """Facade with the reference's constructor and method names (JAX
    mlmrsnet.py:271): MLMRSNet, MLMRSNet_V2 and LDNet."""

    def __init__(self, length, model_depth, num_channel, model_width,
                 kernel_size, problem_type="Regression", output_nums=1,
                 ds=0, ae=0, cardinality=5, pooling_type="avg",
                 feature_number=1024, is_transconv=True,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        self._kw = dict(model_width=model_width, model_depth=model_depth,
                        kernel_size=kernel_size, problem_type=problem_type,
                        output_nums=output_nums, ds=ds, ae=ae,
                        cardinality=cardinality, pooling_type=pooling_type,
                        feature_number=feature_number,
                        is_transconv=is_transconv, in_channels=num_channel,
                        length=length, dtype=dtype, generator=generator)

    def MLMRSNet(self) -> MLMRSNetModel:
        return MLMRSNetModel(topology="MLMRSNet", **self._kw)

    def MLMRSNet_V2(self) -> MLMRSNetModel:
        return MLMRSNetModel(topology="MLMRSNet_V2", **self._kw)

    def LDNet(self) -> MLMRSNetModel:
        return MLMRSNetModel(topology="LDNet", **self._kw)
