"""EfficientNet V1 (B0-B7) backbone of the port (JAX: tf_1d_2d_
segmentation_end2endpipelines_tpu/models/backbones/efficientnet.py,
``EfficientNetBackbone`` :62, ``InputNorm`` :44).

keras.applications' structure: the input rescaled by 1/255 and
normalized by ``InputNorm_0`` (trained parameters ``mean`` and ``var``),
a 3x3 stride-2 stem, MBConv blocks (1x1 expand, depthwise kxk, squeeze-
and-excite as two 1x1 convs with bias, 1x1 project, the residual where
the stride is 1 and the widths agree), a 1x1 top.  Taps at strides 1 to
32: the input itself, the expand activations of blocks 2a, 3a, 4a and
6a (the first block of each strided stage) and the top activation.
``max_tap`` stops at the deepest tap the model reads, inside its block
as keras prunes the graph, so the parameters are flax's leaf for leaf.

Every conv is a ``SameConv`` without bias (flax ``SAME``: at stride 2
uneven, 0 before and 1 after for k = 3 on an even size, 1 and 2 for
k = 5), named ``Conv_<k>`` in creation order, every BatchNorm
``BatchNorm_<k>``, as flax's auto-names inside the one compact module.
Swish is ``F.silu``.
"""
from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import BatchNorm, SameConv, spatial_mean


def _round_filters(f: float, width: float, divisor: int = 8) -> int:
    f *= width
    new_f = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * f:
        new_f += divisor
    return int(new_f)


def _round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(depth * r))


class InputNorm(nn.Module):
    """keras's Rescaling(1/255) and Normalization: ``(x / 255 - mean) /
    sqrt(var + 1e-7)``, computed in at least float32 (the input divided
    by 255 in its own dtype first, as in JAX), the result in ``dtype``.  ``mean``
    and ``var`` are trained parameters, not running statistics; always 3
    of them, so a one-channel input broadcasts to three, as in JAX."""

    def __init__(self, channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        x = x / 255.0
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return ((x - self.mean.view(shape))
                / torch.sqrt(self.var.view(shape) + 1e-7)).to(self.dtype)


class EfficientNetBackbone(nn.Module):
    """EfficientNet V1 with compound ``width``/``depth`` scaling.
    ``forward`` takes a (B, C, H, W) channels_last batch and returns the
    taps 0 .. ``max_tap`` (``tap_features`` their widths; tap 0 is the
    input, ``in_channels`` wide).

    ``trainable`` False (the INI's ``encoder_trainable = 0``) keeps the
    backbone in eval mode whatever mode the model is switched to, as the
    JAX model calls it with ``train=False`` (segmodel.py:101): its
    BatchNorms normalize with their running statistics and never advance
    them.  Its parameters still take gradients and optimizer updates, as
    the JAX ``train`` verb freezes none of them."""

    # B0 base config: (kernel, repeats, cin, cout, expand, stride)
    _BASE = [(3, 1, 32, 16, 1, 1), (3, 2, 16, 24, 6, 2),
             (5, 2, 24, 40, 6, 2), (3, 3, 40, 80, 6, 2),
             (5, 3, 80, 112, 6, 1), (5, 4, 112, 192, 6, 2),
             (3, 1, 192, 320, 6, 1)]

    def __init__(self, width: float = 1.0, depth: float = 1.0,
                 max_tap: int = 5, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 trainable: bool = True):
        super().__init__()
        self.trainable = bool(trainable)
        self._kw = dict(dtype=dtype, generator=generator)
        self._counts = {"Conv": 0, "BatchNorm": 0}
        self.InputNorm_0 = InputNorm(dtype=dtype)
        stem = _round_filters(32, width)
        self.stem = (self._conv(3, stem, 3, 2), self._bn(stem))
        self.tap_features = [in_channels]
        self.blocks: tp.List[tp.Dict[str, tp.Any]] = []
        self.top = self._build(stem, width, depth, max_tap + 1)
        self.train()  # a frozen backbone starts in eval mode

    def _conv(self, cin: int, cout: int, k: int, stride: int = 1,
              groups: int = 1, bias: bool = False) -> SameConv:
        conv = SameConv(cin, cout, k, stride, groups, bias=bias, **self._kw)
        self.add_module(f"Conv_{self._counts['Conv']}", conv)
        self._counts["Conv"] += 1
        return conv

    def _bn(self, features: int) -> BatchNorm:
        bn = BatchNorm(features)
        self.add_module(f"BatchNorm_{self._counts['BatchNorm']}", bn)
        self._counts["BatchNorm"] += 1
        return bn

    def _build(self, cin: int, width: float, depth: float, n_need: int
               ) -> tp.Optional[tp.Tuple[SameConv, BatchNorm]]:
        """The blocks up to the last tap; the top conv and BatchNorm when
        tap 5 is needed, else None."""
        for (k, r, _, cout, expand, stride) in self._BASE:
            cout = _round_filters(cout, width)
            for b in range(_round_repeats(r, depth)):
                s = stride if b == 0 else 1
                is_tap = s == 2 and b == 0 and expand != 1
                tap_only = is_tap and len(self.tap_features) + 1 >= n_need
                self.blocks.append(self._mbconv(cin, k, cout, expand, s,
                                                is_tap, tap_only))
                if is_tap:
                    self.tap_features.append(cin * expand)
                    if tap_only:
                        return None
                cin = cout
        top = _round_filters(1280, width)
        self.tap_features.append(top)
        return self._conv(cin, top, 1), self._bn(top)

    def _mbconv(self, cin: int, k: int, cout: int, expand: int,
                stride: int, is_tap: bool, tap_only: bool
                ) -> tp.Dict[str, tp.Any]:
        c = cin * expand
        blk: tp.Dict[str, tp.Any] = {
            "tap": is_tap, "tap_only": tap_only,
            "expand": ((self._conv(cin, c, 1), self._bn(c))
                       if expand != 1 else None)}
        if tap_only:  # the block's tap ends the backbone
            return blk
        blk["dw"] = (self._conv(c, c, k, stride, groups=c), self._bn(c))
        # squeeze-excite at a quarter of the block's input width
        se = max(1, int(cin * 0.25))
        blk["se"] = (self._conv(c, se, 1, bias=True),
                     self._conv(se, c, 1, bias=True))
        blk["project"] = (self._conv(c, cout, 1), self._bn(cout))
        blk["residual"] = stride == 1 and cin == cout
        return blk

    def train(self, mode: bool = True) -> "EfficientNetBackbone":
        return super().train(mode and self.trainable)

    @staticmethod
    def _mbconv_forward(blk: tp.Dict[str, tp.Any], h: torch.Tensor):
        y, act = h, None
        if blk["expand"] is not None:
            conv, bn = blk["expand"]
            y = act = F.silu(bn(conv(y)))
        if blk["tap_only"]:
            return None, act
        conv, bn = blk["dw"]
        y = F.silu(bn(conv(y)))
        reduce, excite = blk["se"]
        s = spatial_mean(y, keepdim=True)
        y = y * torch.sigmoid(excite(F.silu(reduce(s))))
        conv, bn = blk["project"]
        y = bn(conv(y))
        if blk["residual"]:
            y = y + h
        return y, act

    def forward(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        taps = [x]
        h = self.InputNorm_0(x).contiguous(memory_format=torch.channels_last)
        conv, bn = self.stem
        h = F.silu(bn(conv(h)))
        for blk in self.blocks:
            h, act = self._mbconv_forward(blk, h)
            if blk["tap"]:
                taps.append(act)
        if self.top is not None:
            conv, bn = self.top
            taps.append(F.silu(bn(conv(h))))
        return taps
