"""EfficientNet V1 (B0-B7) and V2 (B0-B3, S, M, L) backbones of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/backbones/
efficientnet.py, ``EfficientNetBackbone`` :62, ``InputNorm`` :44,
``EfficientNetV2Backbone`` :138).

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
``BatchNorm_<k>``, as flax's auto-names inside the one compact module
(``base.GraphBackbone`` builds both versions from their graphs).  Swish
is ``F.silu``.

V2 (``base.GraphBackbone``): keras's weightless preprocessing (B0-B3:
x / 255 normalized by ImageNet's mean and deviation; S, M, L: x / 128 -
1, both in float32), a 3x3 stride-2 stem, fused MBConv stages (a kxk
expand conv, or the kxk conv alone at expansion 1) then MBConv stages
with squeeze-and-excite at a quarter of the block's input width, a 1x1
top to 1280.  Taps: stage 0's first block's activation, the expand
activations of blocks (1, 1), (3, 0) and (5, 0), the top.
"""
from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import spatial_mean
from .base import GraphBackbone


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


class EfficientNetBackbone(GraphBackbone):
    """EfficientNet V1 with compound ``width``/``depth`` scaling
    (``base.GraphBackbone``: taps 0 .. ``max_tap``, ``trainable``)."""

    # B0 base config: (kernel, repeats, cin, cout, expand, stride)
    _BASE = [(3, 1, 32, 16, 1, 1), (3, 2, 16, 24, 6, 2),
             (5, 2, 24, 40, 6, 2), (3, 3, 40, 80, 6, 2),
             (5, 3, 80, 112, 6, 1), (5, 4, 112, 192, 6, 2),
             (3, 1, 192, 320, 6, 1)]

    def __init__(self, width: float = 1.0, depth: float = 1.0, **kw):
        self.width, self.depth = width, depth
        super().__init__(**kw)

    def _mbconv(self, h: torch.Tensor, k: int, cout: int, expand: int,
                stride: int, tap_only: bool):
        cin = h.shape[1]
        y, act = h, None
        if expand != 1:
            y = act = F.silu(self.bn(self.conv(y, cin * expand, 1,
                                               bias=False)))
            if tap_only:  # the block's tap ends the backbone
                return None, act
        c = y.shape[1]
        y = F.silu(self.bn(self.conv(y, c, k, stride, groups=c, bias=False)))
        # squeeze-excite at a quarter of the block's input width
        s = spatial_mean(y, keepdim=True)
        s = F.silu(self.conv(s, max(1, int(cin * 0.25)), 1))
        y = y * torch.sigmoid(self.conv(s, c, 1))
        y = self.bn(self.conv(y, cout, 1, bias=False))
        if stride == 1 and cin == cout:
            y = y + h
        return y, act

    def graph(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        n_need = self.max_tap + 1
        taps = [x]
        norm = self._next("InputNorm", lambda: InputNorm(dtype=self.dtype))
        h = norm(x).contiguous(memory_format=torch.channels_last)
        h = F.silu(self.bn(self.conv(h, _round_filters(32, self.width), 3, 2,
                                     bias=False)))
        for (k, r, _, cout, expand, stride) in self._BASE:
            cout = _round_filters(cout, self.width)
            for b in range(_round_repeats(r, self.depth)):
                s = stride if b == 0 else 1
                is_tap = s == 2 and b == 0 and expand != 1
                tap_only = is_tap and len(taps) + 1 >= n_need
                h, act = self._mbconv(h, k, cout, expand, s, tap_only)
                if is_tap:
                    taps.append(act)
                    if tap_only:
                        return taps
        taps.append(F.silu(self.bn(self.conv(
            h, _round_filters(1280, self.width), 1, bias=False))))
        return taps


class EfficientNetV2Backbone(GraphBackbone):
    """EfficientNet V2 of ``size`` b0, b1, b2, b3, s, m or l."""

    #: (kernel, repeats, cout, expand, stride, fused, se ratio)
    _CFG = {
        "b0": [(3, 1, 16, 1, 1, True, 0), (3, 2, 32, 4, 2, True, 0),
               (3, 2, 48, 4, 2, True, 0), (3, 3, 96, 4, 2, False, .25),
               (3, 5, 112, 6, 1, False, .25), (3, 8, 192, 6, 2, False, .25)],
        "b1": [(3, 2, 16, 1, 1, True, 0), (3, 3, 32, 4, 2, True, 0),
               (3, 3, 48, 4, 2, True, 0), (3, 4, 96, 4, 2, False, .25),
               (3, 6, 112, 6, 1, False, .25), (3, 9, 192, 6, 2, False, .25)],
        "b2": [(3, 2, 16, 1, 1, True, 0), (3, 3, 32, 4, 2, True, 0),
               (3, 3, 56, 4, 2, True, 0), (3, 4, 104, 4, 2, False, .25),
               (3, 6, 120, 6, 1, False, .25),
               (3, 10, 208, 6, 2, False, .25)],
        "b3": [(3, 2, 16, 1, 1, True, 0), (3, 3, 40, 4, 2, True, 0),
               (3, 3, 56, 4, 2, True, 0), (3, 5, 112, 4, 2, False, .25),
               (3, 7, 136, 6, 1, False, .25),
               (3, 12, 232, 6, 2, False, .25)],
        "s": [(3, 2, 24, 1, 1, True, 0), (3, 4, 48, 4, 2, True, 0),
              (3, 4, 64, 4, 2, True, 0), (3, 6, 128, 4, 2, False, .25),
              (3, 9, 160, 6, 1, False, .25), (3, 15, 256, 6, 2, False, .25)],
        "m": [(3, 3, 24, 1, 1, True, 0), (3, 5, 48, 4, 2, True, 0),
              (3, 5, 80, 4, 2, True, 0), (3, 7, 160, 4, 2, False, .25),
              (3, 14, 176, 6, 1, False, .25),
              (3, 18, 304, 6, 2, False, .25), (3, 5, 512, 6, 1, False, .25)],
        "l": [(3, 4, 32, 1, 1, True, 0), (3, 7, 64, 4, 2, True, 0),
              (3, 7, 96, 4, 2, True, 0), (3, 10, 192, 4, 2, False, .25),
              (3, 19, 224, 6, 1, False, .25),
              (3, 25, 384, 6, 2, False, .25), (3, 7, 640, 6, 1, False, .25)],
    }
    #: keras.applications' stem filters per size
    _STEM = {"b0": 32, "b1": 32, "b2": 32, "b3": 40, "s": 24, "m": 24,
             "l": 32}
    #: (stage, block) whose expand activation is a tap
    _TAP_EXPAND = {(1, 1), (3, 0), (5, 0)}

    def __init__(self, size: str = "b0", **kw):
        if size not in self._CFG:
            raise ValueError(f"unknown EfficientNetV2 size {size!r}")
        self.size = size
        super().__init__(**kw)

    def _block(self, h: torch.Tensor, k: int, cout: int, expand: int,
               stride: int, fused: bool, se_ratio: float, tap_only: bool):
        cin = h.shape[1]
        y, expand_act = h, None
        if fused:
            if expand != 1:
                y = F.silu(self.bn(self.conv(y, cin * expand, k, stride,
                                             bias=False)))
                expand_act = y
                if tap_only:
                    return None, expand_act
                y = self.bn(self.conv(y, cout, 1, bias=False))
            else:
                y = F.silu(self.bn(self.conv(y, cout, k, stride, bias=False)))
                expand_act = y  # the pre-residual activation
                if tap_only:
                    return None, expand_act
        else:
            if expand != 1:
                y = F.silu(self.bn(self.conv(y, cin * expand, 1, bias=False)))
                expand_act = y
                if tap_only:
                    return None, expand_act
            c = y.shape[1]
            y = F.silu(self.bn(self.conv(y, c, k, stride, groups=c,
                                         bias=False)))
            if se_ratio:
                s = spatial_mean(y, keepdim=True)
                s = F.silu(self.conv(s, max(1, int(cin * se_ratio)), 1))
                y = y * torch.sigmoid(self.conv(s, c, 1))
            y = self.bn(self.conv(y, cout, 1, bias=False))
        if stride == 1 and cin == cout:
            y = y + h
        return y, expand_act

    def graph(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        taps = [x]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.size.startswith("b"):
            shape = (1, -1, 1, 1)
            mean = xf.new_tensor([0.485, 0.456, 0.406]).view(shape)
            std = xf.new_tensor([0.229, 0.224, 0.225]).view(shape)
            h = ((xf / 255.0 - mean) / std).to(self.dtype)
        else:
            h = (xf / 128.0 - 1.0).to(self.dtype)
        h = F.silu(self.bn(self.conv(h, self._STEM[self.size], 3, 2,
                                     bias=False)))
        n_need = self.max_tap + 1
        for stage, (k, reps, cout, expand, stride, fused, se) in enumerate(
                self._CFG[self.size]):
            for b in range(reps):
                is_tap = ((stage == 0 and b == 0)
                          or (stage, b) in self._TAP_EXPAND)
                tap_only = is_tap and len(taps) + 1 >= n_need
                h, expand_act = self._block(h, k, cout, expand,
                                            stride if b == 0 else 1, fused,
                                            se, tap_only)
                if stage == 0 and b == 0:
                    taps.append(expand_act if expand_act is not None else h)
                elif (stage, b) in self._TAP_EXPAND and \
                        expand_act is not None:
                    taps.append(expand_act)
                if tap_only and len(taps) >= n_need:
                    return taps
        taps.append(F.silu(self.bn(self.conv(h, 1280, 1, bias=False))))
        return taps
