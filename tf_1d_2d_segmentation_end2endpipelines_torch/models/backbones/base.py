"""The backbones' shared machinery: a graph written once, as the flax
module's ``__call__`` is, that both builds the modules and runs them.

``GraphBackbone.__init__`` runs ``graph`` once on a zero image of
``BUILD_SIZE`` pixels a side, in float32 and without gradients: each
``conv`` / ``bn`` call on that pass creates its module from the input's
width, registers it under flax's auto-name (``Conv_<k>``,
``BatchNorm_<k>`` in creation order, as inside one compact flax module)
and runs it, so the next call sees the true width.  Every later forward
runs the same ``graph`` and takes the modules in the same order.  The
parameters are therefore flax's leaf for leaf, in the order flax creates
them, with no second description of the architecture to keep in step.

The pools follow XLA's ``reduce_window`` (JAX ``convnets.py:33-35``,
``inception.py:37-47``): ``SAME`` pads as a convolution does, which at
stride 2 on an even size is 0 before and 1 after, not torch's symmetric
``padding``; so ``maxpool`` pads with -inf (``avgpool``'s count, with 0)
explicitly and pools ``VALID``.  ``maxpool``'s gradient is
``F.max_pool2d``'s: each window's gradient goes to the first maximum of
the window in row-major order (a later element replaces the kept one
only when it is greater), which is XLA's ``select_and_scatter`` with the
``ge`` select for finite values, and where windows overlap (3x3 at
stride 2) both add the windows' gradients.  These pools are not Pallas
kernels in the JAX package: PyTorch's own pool stands in for XLA's.
"""
from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import BatchNorm, SameConv, same_pads

#: the side of the zero image the modules are built on: every tap down to
#: stride 32 exists at 32
BUILD_SIZE = 32


def relu6(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.relu6``: min(max(x, 0), 6), whose gradient is 1 on (0, 6)
    and 0 elsewhere (``F.hardtanh``'s)."""
    return F.hardtanh(x, 0.0, 6.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """x * relu6(x + 3) / 6 (JAX ``convnets.py::_hswish``), composed as
    there, so its kinks at -3 and 3 are relu6's."""
    return x * relu6(x + 3.0) / 6.0


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) * (1 / 6) (JAX ``MobileNetV3Backbone._hsig``)."""
    return relu6(x + 3.0) * (1.0 / 6.0)


def _pool_pads(size: int, k: int, s: int, padding: str) -> tp.Tuple[int, int]:
    return same_pads(size, k, s) if padding == "SAME" else (0, 0)


def maxpool(x: torch.Tensor, k: int = 3, s: int = 2,
            padding: str = "SAME") -> torch.Tensor:
    """``reduce_window`` max over k x k at stride s, ``SAME`` or
    ``VALID``."""
    ph = _pool_pads(x.shape[2], k, s, padding)
    pw = _pool_pads(x.shape[3], k, s, padding)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def avgpool_same(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """``reduce_window`` sum over k x k at stride 1, ``SAME``, divided by
    the count of real cells in each window (JAX ``inception.py::
    _avgpool``): at stride 1 the pads are symmetric, where
    ``count_include_pad=False`` divides by that count.  The pool runs on
    NCHW memory and hands back channels_last: on a channels_last CUDA
    tensor PyTorch 2.11's ``avg_pool2d`` backward at stride 1 with
    padding returned gradients off by O(1) (its forward was exact; NCHW
    was exact both ways; measured on an NVIDIA H100 80GB HBM3)."""
    ph, pw = same_pads(x.shape[2], k, 1), same_pads(x.shape[3], k, 1)
    if ph[0] != ph[1] or pw[0] != pw[1]:
        raise ValueError(f"avgpool_same: uneven pads {ph}, {pw}")
    y = F.avg_pool2d(x.contiguous(), k, 1, (ph[0], pw[0]),
                     count_include_pad=False)
    return y.contiguous(memory_format=torch.channels_last)


class GraphBackbone(nn.Module):
    """A backbone whose ``graph(x)`` returns its taps 0 .. ``max_tap``
    (tap 0 the input; ``tap_features`` their widths).  ``trainable``
    False (the INI's ``encoder_trainable = 0``) keeps it in eval mode
    whatever mode the model is switched to, as the JAX model calls it
    with ``train=False`` (segmodel.py:101): its BatchNorms normalize with
    their running statistics and never advance them.  Its parameters
    still take gradients and optimizer updates.  ``forward`` takes a (B,
    C, H, W) channels_last batch."""

    def __init__(self, max_tap: int = 5, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 trainable: bool = True):
        super().__init__()
        self.max_tap = max_tap
        self.dtype = dtype
        self.trainable = bool(trainable)
        self._generator = generator
        self._counts: tp.Dict[str, int] = {}
        self._mods: tp.List[nn.Module] = []
        self._at: tp.Optional[int] = None  # None while building
        with torch.no_grad():
            x = torch.zeros(1, in_channels, BUILD_SIZE, BUILD_SIZE).contiguous(
                memory_format=torch.channels_last)
            self.tap_features = [int(t.shape[1]) for t in self.graph(x)]
        self._generator = None
        self._at = 0
        self.train()  # a frozen backbone starts in eval mode

    def graph(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        raise NotImplementedError

    def _next(self, kind: str, make: tp.Callable[[], nn.Module]
              ) -> nn.Module:
        if self._at is None:
            module = make()
            n = self._counts.get(kind, 0)
            self.add_module(f"{kind}_{n}", module)
            self._counts[kind] = n + 1
            self._mods.append(module)
            return module
        module = self._mods[self._at]
        self._at += 1
        return module

    def conv(self, x: torch.Tensor, feats: int,
             k: tp.Union[int, tp.Tuple[int, int]] = 1, s: int = 1,
             groups: int = 1, bias: bool = True,
             padding: tp.Optional[int] = None) -> torch.Tensor:
        """flax ``nn.Conv(feats, k, strides=s, padding="SAME",
        feature_group_count=groups, use_bias=bias)`` (lecun-normal
        kernel, zero bias), or ``padding`` p on every side."""
        conv = self._next("Conv", lambda: SameConv(
            int(x.shape[1]), feats, k, s, groups, bias=bias,
            dtype=self.dtype, generator=self._generator, padding=padding))
        return conv(x)

    def bn(self, x: torch.Tensor, eps: float = 1e-3,
           use_scale: bool = True) -> torch.Tensor:
        """flax ``nn.BatchNorm(momentum=0.99, epsilon=eps,
        use_scale=use_scale)``; passed over while the modules are built."""
        bn = self._next("BatchNorm", lambda: BatchNorm(
            int(x.shape[1]), epsilon=eps, use_scale=use_scale))
        return x if self._at is None else bn(x)

    def train(self, mode: bool = True) -> "GraphBackbone":
        return super().train(mode and self.trainable)

    def forward(self, x: torch.Tensor) -> tp.List[torch.Tensor]:
        self._at = 0
        return self.graph(x)
