"""The classic backbones of the port (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/models/backbones/convnets.py): ResNet v1 (:38) and
v2 (:94), VGG (:169), DenseNet (:197; CheXNet is DenseNet121's graph),
MobileNet v1 (:252), v2 (:301) and v3 small and large (:363).

Each ``graph`` is the JAX module's ``__call__`` line for line (``base``
builds the modules from it), so the taps, the ``max_tap`` pruning inside
a stage or a block and the parameters are flax's leaf for leaf.  ReLU is
``torch.relu`` (the JAX ``relu``'s output-residual VJP is ReLU's
gradient); ``relu6``, ``hard_swish`` and ``hard_sigmoid`` are
``base``'s.  BatchNorm epsilons: 1.001e-5 in ResNet and DenseNet, 1e-3
in the MobileNets; momentum 0.99.
"""
from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from ...ops import spatial_mean
from .base import GraphBackbone, hard_sigmoid, hard_swish, maxpool, relu6

#: keras.applications' ResNet and DenseNet BatchNorm epsilon
_EPS = 1.001e-5
_NEG_INF = float("-inf")


def _stem_pool(h: torch.Tensor) -> torch.Tensor:
    """keras's ZeroPadding(1) then a VALID 3x3 stride-2 max pool, padded
    with -inf (JAX convnets.py:68-71)."""
    return F.max_pool2d(F.pad(h, (1, 1, 1, 1), value=_NEG_INF), 3, 2)


class ResNetBackbone(GraphBackbone):
    """ResNet v1 with bottleneck blocks (taps: the input, the stem's ReLU,
    each stage's end)."""

    def __init__(self, blocks: tp.Sequence[int] = (3, 4, 6, 3), **kw):
        self.blocks = tuple(blocks)
        super().__init__(**kw)

    def graph(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        n_need = self.max_tap + 1
        taps = [x]
        h = self.conv(x, 64, 7, 2, padding=3)
        h = torch.relu(self.bn(h, _EPS))
        taps.append(h)
        if len(taps) >= n_need:
            return taps
        h = _stem_pool(h)
        feats = 64
        for stage, n_blocks in enumerate(self.blocks):
            if len(taps) >= n_need:
                break
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                shortcut = h
                if b == 0:
                    shortcut = self.bn(self.conv(h, feats * 4, 1, stride),
                                       _EPS)
                y = torch.relu(self.bn(self.conv(h, feats, 1, stride), _EPS))
                y = torch.relu(self.bn(self.conv(y, feats, 3), _EPS))
                y = self.bn(self.conv(y, feats * 4, 1), _EPS)
                h = torch.relu(y + shortcut)
            taps.append(h)
            feats *= 2
        return taps


class ResNetV2Backbone(GraphBackbone):
    """ResNet v2 (pre-activation): each stage's tap is the concat of its
    last block's first-conv activation and pre-activation, both at the
    stage's input stride; tap 5 the final post-activation."""

    def __init__(self, blocks: tp.Sequence[int] = (3, 4, 6, 3), **kw):
        self.blocks = tuple(blocks)
        super().__init__(**kw)

    def graph(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        n_need = self.max_tap + 1
        taps = [x]
        h = self.conv(x, 64, 7, 2, padding=3)
        taps.append(h)
        if len(taps) >= n_need:
            return taps
        h = _stem_pool(h)
        feats = 64
        for stage, n_blocks in enumerate(self.blocks):
            # this stage's tap completes the budget: the graph stops after
            # the last block's first conv
            final_stage = len(taps) + 1 >= n_need and self.max_tap < 5
            stage_pair = None
            for b in range(n_blocks):
                stride = 2 if (stage < len(self.blocks) - 1
                               and b == n_blocks - 1) else 1
                cut = final_stage and b == n_blocks - 1
                preact = torch.relu(self.bn(h, _EPS))
                shortcut = None
                if not cut:
                    if b == 0:
                        shortcut = self.conv(preact, feats * 4, 1)
                    elif stride > 1:
                        shortcut = maxpool(h, 1, stride)
                    else:
                        shortcut = h
                y = self.conv(preact, feats, 1, bias=False)
                y1 = torch.relu(self.bn(y, _EPS))
                stage_pair = (y1, preact)
                if cut:
                    break
                # keras v2 pads (1, 1) then VALID for the 3x3
                y = self.conv(y1, feats, 3, stride, bias=False, padding=1)
                y = torch.relu(self.bn(y, _EPS))
                y = self.conv(y, feats * 4, 1)
                h = y + shortcut
            y1, preact = stage_pair
            taps.append(torch.cat([y1, preact], dim=1))
            if len(taps) >= n_need and self.max_tap < 5:
                return taps
            feats *= 2
        taps.append(torch.relu(self.bn(h, _EPS)))
        # [in, s2, s4, s8, s16, s32 of the last stage, post-ReLU]: the
        # post-ReLU stands at 5
        return taps[:5] + [taps[6]]


class VGGBackbone(GraphBackbone):
    """VGG16/19 (taps: the last conv of blocks 2 .. 5 and block 5's
    pool)."""

    def __init__(self, convs: tp.Sequence[int] = (2, 2, 3, 3, 3), **kw):
        self.convs = tuple(convs)
        super().__init__(**kw)

    def graph(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        n_need = self.max_tap + 1
        taps = [x]
        h = x
        for stage, (n, w) in enumerate(zip(self.convs,
                                           (64, 128, 256, 512, 512))):
            if len(taps) >= n_need:
                return taps
            for _ in range(n):
                h = torch.relu(self.conv(h, w, 3))
            if stage >= 1:
                taps.append(h)
            h = maxpool(h, 2, 2)
        if len(taps) < n_need:
            taps.append(h)
        return taps


class DenseNetBackbone(GraphBackbone):
    """DenseNet (taps: the stem's ReLU, each transition's BN-ReLU before
    its 1x1 conv, the final ReLU); ``growth`` 32."""

    def __init__(self, blocks: tp.Sequence[int] = (6, 12, 24, 16),
                 growth: int = 32, **kw):
        self.blocks = tuple(blocks)
        self.growth = growth
        super().__init__(**kw)

    def graph(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        n_need = self.max_tap + 1
        taps = [x]
        h = self.conv(x, 64, 7, 2, bias=False, padding=3)
        h = torch.relu(self.bn(h, _EPS))
        taps.append(h)
        if len(taps) >= n_need:
            return taps
        h = _stem_pool(h)
        for stage, n_layers in enumerate(self.blocks):
            for _ in range(n_layers):
                y = torch.relu(self.bn(h, _EPS))
                y = self.conv(y, 4 * self.growth, 1, bias=False)
                y = torch.relu(self.bn(y, _EPS))
                y = self.conv(y, self.growth, 3, bias=False)
                h = torch.cat([h, y], dim=1)
            if stage < len(self.blocks) - 1:
                y = torch.relu(self.bn(h, _EPS))
                taps.append(y)
                if len(taps) >= n_need:
                    return taps
                y = self.conv(y, h.shape[1] // 2, 1, bias=False)
                h = F.avg_pool2d(y, 2, 2)
            else:
                taps.append(torch.relu(self.bn(h, _EPS)))
        return taps


class MobileNetBackbone(GraphBackbone):
    """MobileNet v1, depthwise-separable (taps at strides 2 .. 32);
    ``alpha`` scales the widths."""

    def __init__(self, alpha: float = 1.0, **kw):
        self.alpha = alpha
        super().__init__(**kw)

    def _sep(self, h: torch.Tensor, feats: int, stride: int) -> torch.Tensor:
        c = h.shape[1]
        h = self.conv(h, c, 3, stride, groups=c, bias=False)
        h = relu6(self.bn(h))
        h = self.conv(h, feats, 1, bias=False)
        return relu6(self.bn(h))

    def graph(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        a = self.alpha
        n_need = self.max_tap + 1
        taps = [x]
        h = relu6(self.bn(self.conv(x, int(32 * a), 3, 2, bias=False)))
        h = self._sep(h, int(64 * a), 1)
        taps.append(h)
        for feats, repeats in ((128, 1), (256, 1), (512, 5), (1024, 1)):
            if len(taps) >= n_need:
                return taps
            h = self._sep(h, int(feats * a), 2)
            for _ in range(repeats):
                h = self._sep(h, int(feats * a), 1)
            taps.append(h)
        return taps


class MobileNetV2Backbone(GraphBackbone):
    """MobileNet v2 inverted residuals (taps: the expand activation inside
    the first block of each strided group, then the final ReLU6);
    ``alpha`` scales the blocks' widths."""

    #: (expand, feats, repeats, stride)
    _CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    def __init__(self, alpha: float = 1.0, **kw):
        self.alpha = alpha
        super().__init__(**kw)

    def _inv(self, h: torch.Tensor, feats: int, stride: int, expand: int,
             tap_only: bool):
        cin = h.shape[1]
        y, expand_act = h, None
        if expand != 1:
            y = relu6(self.bn(self.conv(y, cin * expand, 1, bias=False)))
            expand_act = y
            if tap_only:
                return None, expand_act
        c = y.shape[1]
        y = relu6(self.bn(self.conv(y, c, 3, stride, groups=c, bias=False)))
        y = self.bn(self.conv(y, feats, 1, bias=False))
        if stride == 1 and cin == feats:
            y = y + h
        return y, expand_act

    def graph(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        n_need = self.max_tap + 1
        taps = [x]
        h = relu6(self.bn(self.conv(x, 32, 3, 2, bias=False)))
        for expand, feats, n, s in self._CFG:
            for b in range(n):
                is_tap = s == 2 and b == 0 and expand != 1
                tap_only = is_tap and len(taps) + 1 >= n_need
                h, expand_act = self._inv(h, int(feats * self.alpha),
                                          s if b == 0 else 1, expand,
                                          tap_only)
                if is_tap:
                    taps.append(expand_act)
                    if tap_only:
                        return taps
        taps.append(relu6(self.bn(self.conv(h, 1280, 1, bias=False))))
        return taps


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


class MobileNetV3Backbone(GraphBackbone):
    """MobileNet v3 ``size`` "small" or "large", keras's layer for layer:
    the internal rescaling x / 127.5 - 1, no expansion in block 0,
    squeeze-and-excite as two 1x1 convs with ``_depth(expand / 4)``
    filters and a hard-sigmoid gate, BatchNorm epsilon 1e-3.  Taps: the
    input of each stride-2 block and the final activation (the JAX
    package's documented intent; keras's own tap names are broken there)."""

    #: (kernel, expand, project, se, activation, stride) per keras config
    _LARGE = [(3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
              (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
              (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
              (3, 240, 80, False, "hs", 2), (3, 200, 80, False, "hs", 1),
              (3, 184, 80, False, "hs", 1), (3, 184, 80, False, "hs", 1),
              (3, 480, 112, True, "hs", 1), (3, 672, 112, True, "hs", 1),
              (5, 672, 160, True, "hs", 2), (5, 960, 160, True, "hs", 1),
              (5, 960, 160, True, "hs", 1)]
    _SMALL = [(3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
              (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hs", 2),
              (5, 240, 40, True, "hs", 1), (5, 240, 40, True, "hs", 1),
              (5, 120, 48, True, "hs", 1), (5, 144, 48, True, "hs", 1),
              (5, 288, 96, True, "hs", 2), (5, 576, 96, True, "hs", 1),
              (5, 576, 96, True, "hs", 1)]

    def __init__(self, size: str = "large", **kw):
        if size not in ("small", "large"):
            raise ValueError(f"unknown MobileNetV3 size {size!r}")
        self.size = size
        super().__init__(**kw)

    @staticmethod
    def _depth(v: float, divisor: int = 8) -> int:
        new_v = max(divisor, (int(v + divisor / 2) // divisor) * divisor)
        if new_v < 0.9 * v:
            new_v += divisor
        return new_v

    def _se(self, h: torch.Tensor, expand: int) -> torch.Tensor:
        s = spatial_mean(h, keepdim=True)
        s = torch.relu(self.conv(s, self._depth(expand * 0.25), 1))
        s = self.conv(s, expand, 1)
        return h * hard_sigmoid(s)

    def _block(self, h: torch.Tensor, block_id: int, k: int, exp: int,
               feats: int, se: bool, act: str, stride: int) -> torch.Tensor:
        fn = _relu if act == "relu" else hard_swish
        cin = h.shape[1]
        y = h
        if block_id > 0:  # keras skips the expansion on block 0
            y = fn(self.bn(self.conv(y, exp, 1, bias=False)))
        y = fn(self.bn(self.conv(y, exp, k, stride, groups=exp, bias=False)))
        if se:
            y = self._se(y, exp)
        y = self.bn(self.conv(y, feats, 1, bias=False))
        if stride == 1 and cin == feats:
            y = y + h
        return y

    def graph(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        cfg, last = ((self._LARGE, 960) if self.size == "large"
                     else (self._SMALL, 576))
        n_need = self.max_tap + 1
        taps = [x]
        h = x.to(self.dtype) / 127.5 - 1.0  # keras's internal Rescaling
        h = hard_swish(self.bn(self.conv(h, 16, 3, 2, bias=False)))
        for block_id, (k, exp, feats, se, act, s) in enumerate(cfg):
            if s == 2:
                taps.append(h)
                if len(taps) >= n_need:
                    return taps
            h = self._block(h, block_id, k, exp, feats, se, act, s)
        taps.append(hard_swish(self.bn(self.conv(h, last, 1, bias=False))))
        while len(taps) < 6:
            taps.append(taps[-1])
        return taps[:6]
