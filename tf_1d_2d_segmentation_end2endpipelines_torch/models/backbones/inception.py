"""Inception V3 and Inception-ResNet V2 backbones of the port (JAX:
tf_1d_2d_segmentation_end2endpipelines_tpu/models/backbones/inception.py,
``InceptionV3Backbone`` :50, ``InceptionResNetV2Backbone`` :144).

``pad`` "SAME" (the default, the JAX package's) puts every stage on the
power-of-two grid a UNet decoder needs; "VALID" is keras's own padding of
the stem and the reductions.  Every conv is bias-free and followed by a
BatchNorm without a scale (keras's ``scale=False``: no ``weight``),
epsilon 1e-3, and ReLU (``_cba``); the pools are XLA's ``SAME``
(``base.maxpool``, ``base.avgpool_same``).  Inception-ResNet V2 scales
its residual branches by 0.17, 0.1 and 0.2 (``Conv`` 1x1 with bias), its
last block8 by 1 with no activation.
"""
from __future__ import annotations

import typing as tp

import torch

from .base import GraphBackbone, avgpool_same, maxpool


class _Inception(GraphBackbone):
    def __init__(self, pad: str = "SAME", **kw):
        if pad not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {pad!r}")
        self.pad = pad
        super().__init__(**kw)

    def _cba(self, x: torch.Tensor, feats: int,
             k: tp.Union[int, tp.Tuple[int, int]], s: int = 1,
             valid: bool = False) -> torch.Tensor:
        """Conv, BatchNorm without scale, ReLU; ``valid``: ``pad``."""
        if isinstance(k, int):
            k = (k, k)
        x = self.conv(x, feats, k, s, bias=False,
                      padding=0 if valid and self.pad == "VALID" else None)
        return torch.relu(self.bn(x, use_scale=False))

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return maxpool(x, 3, 2, self.pad)

    def _stem(self, x: torch.Tensor, taps: list, n_need: int
              ) -> tp.Optional[torch.Tensor]:
        """Taps 1 and 2; None when they are the last wanted."""
        h = self._cba(x, 32, 3, 2, valid=True)
        h = self._cba(h, 32, 3, 1, valid=True)
        h = self._cba(h, 64, 3)
        taps.append(h)
        if len(taps) >= n_need:
            return None
        h = self._pool(h)
        h = self._cba(h, 80, 1, valid=True)
        h = self._cba(h, 192, 3, valid=True)
        taps.append(h)
        if len(taps) >= n_need:
            return None
        return self._pool(h)


class InceptionV3Backbone(_Inception):
    """Inception V3 (taps at strides 2 .. 32: the stem's two stages, the
    A blocks, the B blocks after reduction A, the C blocks after
    reduction B)."""

    def _block_a(self, x: torch.Tensor, pool_feats: int) -> torch.Tensor:
        b1 = self._cba(x, 64, 1)
        b2 = self._cba(self._cba(x, 48, 1), 64, 5)
        b3 = self._cba(self._cba(self._cba(x, 64, 1), 96, 3), 96, 3)
        b4 = self._cba(avgpool_same(x), pool_feats, 1)
        return torch.cat([b1, b2, b3, b4], dim=1)

    def _block_b(self, x: torch.Tensor, c7: int) -> torch.Tensor:
        b1 = self._cba(x, 192, 1)
        b2 = self._cba(self._cba(self._cba(x, c7, 1), c7, (1, 7)), 192,
                       (7, 1))
        b3 = x
        for k, f in [((1, 1), c7), ((7, 1), c7), ((1, 7), c7), ((7, 1), c7),
                     ((1, 7), 192)]:
            b3 = self._cba(b3, f, k)
        b4 = self._cba(avgpool_same(x), 192, 1)
        return torch.cat([b1, b2, b3, b4], dim=1)

    def _block_c(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self._cba(x, 320, 1)
        b2 = self._cba(x, 384, 1)
        b2 = torch.cat([self._cba(b2, 384, (1, 3)),
                        self._cba(b2, 384, (3, 1))], dim=1)
        b3 = self._cba(self._cba(x, 448, 1), 384, 3)
        b3 = torch.cat([self._cba(b3, 384, (1, 3)),
                        self._cba(b3, 384, (3, 1))], dim=1)
        b4 = self._cba(avgpool_same(x), 192, 1)
        return torch.cat([b1, b2, b3, b4], dim=1)

    def graph(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        n_need = self.max_tap + 1
        taps = [x]
        h = self._stem(x, taps, n_need)
        if h is None:
            return taps
        for pool_feats in (32, 64, 64):
            h = self._block_a(h, pool_feats)
        taps.append(h)
        if len(taps) >= n_need:
            return taps
        # reduction A
        b1 = self._cba(h, 384, 3, 2, valid=True)
        b2 = self._cba(self._cba(self._cba(h, 64, 1), 96, 3), 96, 3, 2,
                       valid=True)
        h = torch.cat([b1, b2, self._pool(h)], dim=1)
        for c7 in (128, 160, 160, 192):
            h = self._block_b(h, c7)
        taps.append(h)
        if len(taps) >= n_need:
            return taps
        # reduction B
        b1 = self._cba(self._cba(h, 192, 1), 320, 3, 2, valid=True)
        b2 = self._cba(self._cba(self._cba(h, 192, 1), 192, (1, 7)), 192,
                       (7, 1))
        b2 = self._cba(b2, 192, 3, 2, valid=True)
        h = torch.cat([b1, b2, self._pool(h)], dim=1)
        h = self._block_c(h)
        h = self._block_c(h)
        taps.append(h)
        return taps


class InceptionResNetV2Backbone(_Inception):
    """Inception-ResNet V2 (taps at strides 2 .. 32: the stem's two
    stages, the 10 block35s, the 20 block17s after reduction A, the
    block8s and the 1536-wide 1x1 after reduction B)."""

    def _residual(self, x: torch.Tensor, mix: tp.List[torch.Tensor],
                  scale: float, activate: bool = True) -> torch.Tensor:
        up = self.conv(torch.cat(mix, dim=1), x.shape[1], 1)
        out = x + scale * up
        return torch.relu(out) if activate else out

    def _block35(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self._cba(x, 32, 1)
        b2 = self._cba(self._cba(x, 32, 1), 32, 3)
        b3 = self._cba(self._cba(self._cba(x, 32, 1), 48, 3), 64, 3)
        return self._residual(x, [b1, b2, b3], 0.17)

    def _block17(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self._cba(x, 192, 1)
        b2 = self._cba(self._cba(self._cba(x, 128, 1), 160, (1, 7)), 192,
                       (7, 1))
        return self._residual(x, [b1, b2], 0.1)

    def _block8(self, x: torch.Tensor, scale: float,
                activate: bool) -> torch.Tensor:
        b1 = self._cba(x, 192, 1)
        b2 = self._cba(self._cba(self._cba(x, 192, 1), 224, (1, 3)), 256,
                       (3, 1))
        return self._residual(x, [b1, b2], scale, activate)

    def graph(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        n_need = self.max_tap + 1
        taps = [x]
        h = self._stem(x, taps, n_need)
        if h is None:
            return taps
        # the stem's mixed block
        b1 = self._cba(h, 96, 1)
        b2 = self._cba(self._cba(h, 48, 1), 64, 5)
        b3 = self._cba(self._cba(self._cba(h, 64, 1), 96, 3), 96, 3)
        b4 = self._cba(avgpool_same(h), 64, 1)
        h = torch.cat([b1, b2, b3, b4], dim=1)
        for _ in range(10):
            h = self._block35(h)
        taps.append(h)
        if len(taps) >= n_need:
            return taps
        # reduction A
        b1 = self._cba(h, 384, 3, 2, valid=True)
        b2 = self._cba(self._cba(self._cba(h, 256, 1), 256, 3), 384, 3, 2,
                       valid=True)
        h = torch.cat([b1, b2, self._pool(h)], dim=1)
        for _ in range(20):
            h = self._block17(h)
        taps.append(h)
        if len(taps) >= n_need:
            return taps
        # reduction B
        b1 = self._cba(self._cba(h, 256, 1), 384, 3, 2, valid=True)
        b2 = self._cba(self._cba(h, 256, 1), 288, 3, 2, valid=True)
        b3 = self._cba(self._cba(self._cba(h, 256, 1), 288, 3), 320, 3, 2,
                       valid=True)
        h = torch.cat([b1, b2, b3, self._pool(h)], dim=1)
        for i in range(10):
            # keras: 9 scaled block8s with ReLU, then one at scale 1, linear
            h = self._block8(h, 1.0 if i == 9 else 0.2, i < 9)
        h = self._cba(h, 1536, 1)
        taps.append(h)
        return taps
