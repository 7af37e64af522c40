"""Self-ONN operational layers of the port (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/ops/onn.py): ``Oper(x) = sum_{i=1..q} Conv_i(x**i)``
as one convolution over the channel stack ``[x, x**2, .., x**q]``.

The stack is computed as the JAX module computes it (``_power_stack``,
onn.py:28): by repeated multiplication in the input's dtype, each power
rounded to it before the next multiply, then concatenated on the
channels; only the convolution casts it to its ``dtype``.  The flax
kernel's input channels are in that order, so the converter maps it as
any kernel (utils/flax_to_torch.py).  The stack stays plain PyTorch, as
the JAX package leaves it to XLA.
"""
from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import AutoNamed, SameConv, apply_activation, concat, lecun_normal_


def power_stack(x: torch.Tensor, q: int) -> torch.Tensor:
    """``[x, x**2, .., x**q]`` on the channel axis, each power the previous
    one times ``x`` in ``x``'s dtype (JAX ``_power_stack``), channels_last:
    ``torch.cat`` takes the layout of its first input, and a one-channel
    signal's strides cannot say channels_last."""
    if q == 1:
        return x
    powers = [x]
    acc = x
    for _ in range(q - 1):
        acc = acc * x
        powers.append(acc)
    return concat(*powers).contiguous(memory_format=torch.channels_last)


class Oper(nn.Module):
    """Self-ONN convolution (JAX ``Oper``, onn.py:41): the power stack of
    the input, then ``onn_conv``, flax ``nn.Conv`` SAME at ``stride`` over
    ``q * in_features`` channels (lecun_normal, zero bias), then
    ``activation``.  A 1x1 kernel at a stride > 1 pads nothing and samples
    every stride-th position: the input is sliced, then convolved at
    stride 1, as ``HeadConv`` does (PyTorch's CPU build crashes in the
    weight gradient of some strided channels_last 1x1 convs).  ``rank`` 1
    convolves a (B, C, 1, L) signal with a (1, k) kernel.  The output is
    channels_last, which the pool kernels take (cuDNN may return a conv
    of a one-channel input, at q = 1, in the NCHW layout)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, activation: tp.Optional[str] = None,
                 q: int = 1, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 2):
        super().__init__()
        self.q = q
        self.activation = activation
        self.sample = stride if kernel == 1 else 1
        self.rank = rank
        self.onn_conv = SameConv(q * in_features, features, kernel,
                                 stride=1 if kernel == 1 else stride,
                                 dtype=dtype, generator=generator, rank=rank)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.sample
        if s != 1:
            x = x[:, :, :, ::s] if self.rank == 1 else x[:, :, ::s, ::s]
        y = self.onn_conv(power_stack(x, self.q))
        return apply_activation(
            y.contiguous(memory_format=torch.channels_last), self.activation)


class OperTranspose(nn.Module):
    """Self-ONN transposed convolution by 2 (JAX ``OperTranspose``,
    onn.py:68, as the decoders call it: kernel 4, stride 2, SAME, with
    ``transpose_kernel``): the power stack, then ``onn_trans_conv``, the
    2D dialect's transposed conv of ``TransConv`` (padding 1; at ``rank``
    1 a (1, 4) kernel along the length), bias, then ``activation``
    (tanh in the decoders).  Init as flax's ``ConvTranspose``:
    lecun_normal with fan-in kernel size x ``features``; zero bias."""

    def __init__(self, in_features: int, features: int,
                 activation: tp.Optional[str] = "tanh", q: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 2):
        super().__init__()
        self.q = q
        self.activation = activation
        self.dtype = dtype
        if rank == 1:
            self.onn_trans_conv = nn.ConvTranspose2d(
                q * in_features, features, (1, 4), stride=(1, 2),
                padding=(0, 1))
        else:
            self.onn_trans_conv = nn.ConvTranspose2d(
                q * in_features, features, 4, stride=2, padding=1)
        with torch.no_grad():
            lecun_normal_(self.onn_trans_conv.weight,
                          4 ** rank * features, generator)
            self.onn_trans_conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = self.onn_trans_conv
        x = F.conv_transpose2d(power_stack(x, self.q).to(self.dtype),
                               ct.weight.to(self.dtype), stride=ct.stride,
                               padding=ct.padding)
        x = x + ct.bias.to(self.dtype).view(1, -1, 1, 1)
        return apply_activation(x, self.activation)


class OperationalDenseBlock(AutoNamed):
    """The Self-ONN latent (JAX ``OperationalDenseBlock``, onn.py:97):
    ``Oper_0``, then ``num_layers`` times ``x = x + Oper_k(x)``, all
    ``features`` wide with kernel ``kernel``."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 num_layers: int = 1, q: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 2):
        super().__init__()
        kw = dict(q=q, dtype=dtype, generator=generator, rank=rank)
        self.opers = [self._add(Oper(in_features if k == 0 else features,
                                     features, kernel, **kw))
                      for k in range(num_layers + 1)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.opers[0](x)
        for oper in self.opers[1:]:
            x = x + oper(x)
        return x
