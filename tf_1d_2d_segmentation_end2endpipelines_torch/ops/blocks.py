"""Block library of the port: the blocks the UNet genre, the MultiRes
family, the attention gates, the 1D special families (squeeze-and-excite,
the ConvLSTM cells), the recurrent and ConvMixer blocks of the RUNet,
R2UNet and ConvMixer archs, the autoencoder bottleneck and the
EfficientNet backbone (``SameConv``) run, in 2D and in 1D, ported from
tf_1d_2d_segmentation_end2endpipelines_tpu/ops/blocks.py.

Layout: modules and block functions take and return (B, C, H, W) tensors
in ``torch.channels_last`` memory, i.e. the JAX package's NHWC buffers
seen through PyTorch's NCHW indexing.  A 1D signal is a (B, C, 1, L)
tensor in the same memory format, i.e. the JAX package's NLC buffer: a
block built with ``rank=1`` convolves it with (1, k) kernels (flax's 1D
``SAME`` padding, (k - 1) // 2 before and k // 2 after), pools and
upsamples its length axis alone.  Parameters stay float32; a block
built with ``dtype=torch.bfloat16`` casts its weights and activations to
bf16 in the same places the flax modules do, so converted weights give
the JAX outputs and, through autograd, the JAX gradients (BatchNorm in
training mode uses the batch statistics, as flax's does).

Submodules carry the flax auto-names (``Conv_0``, ``BatchNorm_0``,
``ConvTranspose_0``, ``ConvBlock_<k>``, ``TransConv_0``), so a flax
parameter path maps to a ``state_dict`` key by a plain table
(utils/flax_to_torch.py).
"""
from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from . import remat as _remat
from .kernels import pyramid

# Keras's LeakyReLU slope, which the reference keeps (blocks.py:77).
LEAKY_SLOPE = 0.3


# JAX multiplies by the slope rounded to the activation dtype (a weak
# python scalar), where F.leaky_relu would keep 0.3 in float32.  float64
# serves the CPU reference step of chip_smoke.py's phase 17 alone.
_SLOPES = {dt: float(torch.tensor(LEAKY_SLOPE, dtype=dt))
           for dt in (torch.float32, torch.bfloat16, torch.float64)}


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * _SLOPES[x.dtype])


def _softmax(x: torch.Tensor) -> torch.Tensor:
    # over the channels: the last axis of the JAX package's NHWC arrays
    return torch.softmax(x, dim=1)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # flax's ``nn.gelu`` by name: its default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The erf gelu (flax ``nn.gelu(approximate=False)``, Keras's gelu),
    which ``ConvMixerBlock`` applies."""
    return F.gelu(x, approximate="none")


_ACTIVATIONS: tp.Dict[str, tp.Optional[tp.Callable]] = {
    "relu": torch.relu,
    "leakyrelu": _leaky_relu,
    "leaky_relu": _leaky_relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "gelu": _gelu_tanh,
    "elu": F.elu,
    "selu": F.selu,
    "softmax": _softmax,
    "linear": None,
    "none": None,
}


def get_activation(name: tp.Optional[str]
                   ) -> tp.Optional[tp.Callable[[torch.Tensor], torch.Tensor]]:
    """Activation by the reference's name; None for linear/None."""
    if name is None:
        return None
    key = name.lower()
    if key not in _ACTIVATIONS:
        raise NotImplementedError(
            f"activation {name!r} is not ported yet (ported: "
            f"{sorted(_ACTIVATIONS)})")
    return _ACTIVATIONS[key]


def apply_activation(x: torch.Tensor, name: tp.Optional[str]) -> torch.Tensor:
    fn = get_activation(name)
    return x if fn is None else fn(x)


def he_uniform_(w: torch.Tensor, fan_in: int,
                generator: tp.Optional[torch.Generator]) -> torch.Tensor:
    """Keras/flax ``he_uniform``: U(-sqrt(6/fan_in), sqrt(6/fan_in))."""
    lim = math.sqrt(6.0 / fan_in)
    return nn.init.uniform_(w, -lim, lim, generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: tp.Optional[torch.Generator]) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at two standard
    deviations, rescaled so the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class AutoNamed(nn.Module):
    """A module that registers children under flax's auto-names: per-type
    counters in the order the flax module creates them (``<Type>_<k>``),
    so utils/flax_to_torch.py maps each leaf by its path."""

    def __init__(self):
        super().__init__()
        self._counts: tp.Dict[str, int] = {}

    def _add(self, module: nn.Module, kind: tp.Optional[str] = None
             ) -> nn.Module:
        """Register ``module`` under flax's next auto-name of its type, or
        of the flax type ``kind`` (a ``HeadConv`` is flax's ``Conv``)."""
        kind = kind or type(module).__name__
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        self.add_module(f"{kind}_{n}", module)
        return module

    def _alias(self, name: str, module: tp.Optional[nn.Module]
               ) -> tp.Optional[nn.Module]:
        """``self.<name>`` is ``module``, a child already registered under
        its flax name, without a second registration (which would give
        its parameters a second ``state_dict`` key)."""
        self.__dict__[name] = module
        return module


def pooled_size(size: int, depth: int) -> int:
    """An axis of ``size`` after ``depth`` max pools by 2 (VALID: each
    floors)."""
    for _ in range(depth):
        size //= 2
    return size


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` (JAX: ConvBlock's ``nn.BatchNorm``, blocks.py:224).

    Matches flax's order of operations: the input is promoted to at least
    float32, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, and only
    the result is cast back to the activation dtype.

    Eval mode normalizes with the running statistics.  Training mode
    normalizes with the batch's: the mean and the biased variance over
    N, H, W in that promoted dtype, the variance as ``E[x**2] - E[x]**2``
    clamped at 0 (flax's ``use_fast_variance``), and advances the running
    statistics with flax's ``momentum`` (the weight of the old value,
    0.99), biased variance included, once a forward: not again while the
    backward recomputes a checkpointed forward (``ops/remat.py``).
    ``F.batch_norm`` is not used: it would store the unbiased variance.
    ``use_scale`` False (flax ``use_scale=False``, the Inception
    backbones') has no ``weight``."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-3, use_scale: bool = True):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = (nn.Parameter(torch.ones(features)) if use_scale
                       else None)
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min(
                (xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            if not _remat.recomputing():
                self._advance(mean, var)
        else:  # in xf's dtype: float64 where a reference computes in it
            mean = self.running_mean.to(xf.dtype)
            var = self.running_var.to(xf.dtype)
        mul = torch.rsqrt(var + self.epsilon)
        if self.weight is not None:
            mul = mul * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)

    @torch.no_grad()
    def _advance(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)


class _Block(nn.Module):
    """A block that ``remat = blocks`` rematerializes (JAX ``remat_block``,
    blocks.py:33-73): with ``remat`` set, its forward in training mode with
    gradients runs under ``ops.remat.checkpoint`` with the ``conv_outs``
    policy.  ``remat`` is a plain attribute, so the ``state_dict`` keys
    are the plain block's (``SegModel(block_remat=True)`` sets it on the
    outermost blocks)."""

    remat = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return _remat.checkpoint(self._forward, x, policy="conv_outs")
        return self._forward(x)


def he_normal_(w: torch.Tensor, fan_in: int,
               generator: tp.Optional[torch.Generator]) -> torch.Tensor:
    """flax ``he_normal``: a normal truncated at two standard deviations,
    rescaled so the variance is 2/fan_in."""
    std = math.sqrt(2.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def same_pads(size: int, kernel: int, stride: int) -> tp.Tuple[int, int]:
    """flax's ``SAME`` padding of one spatial axis of ``size`` for a
    ``kernel`` at ``stride``: ``ceil(size / stride)`` outputs, the
    ``max((out - 1) * stride + kernel - size, 0)`` padded elements split
    with the smaller half before.  At stride 2 and an even size that is
    uneven: 0 before and 1 after for k = 3, 1 and 2 for k = 5."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv(nn.Conv2d):
    """flax ``nn.Conv`` with ``SAME`` padding at any stride: a square
    kernel (``rank`` 2; a (kh, kw) tuple for a rectangular one) or a (1,
    k) one over a 1D signal (``rank`` 1), ``groups`` (flax's
    ``feature_group_count``), bias optional.  The padding depends on the
    input's size (``same_pads``); where it is uneven (stride 2, or an
    even 1D kernel) the input is padded by ``F.pad`` before a conv that
    pads nothing.  ``padding`` p instead pads p on every side (flax's
    explicit ``[(p, p), (p, p)]``, keras's ZeroPadding then VALID).
    Casts input, kernel and bias to ``dtype`` and adds the bias after the
    convolution, as flax.
    Init: ``init`` is ``lecun_normal`` (flax's default), ``he_uniform``,
    ``he_normal`` or ``orthogonal``; zero bias."""

    def __init__(self, in_features: int, features: int,
                 kernel: tp.Union[int, tp.Tuple[int, int]],
                 stride: int = 1, groups: int = 1, bias: bool = True,
                 init: str = "lecun_normal",
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 2, padding: tp.Optional[int] = None):
        if isinstance(kernel, tuple):
            ks = kernel
        else:
            ks = (kernel, kernel) if rank == 2 else (1, kernel)
        st = (stride, stride) if rank == 2 else (1, stride)
        super().__init__(in_features, features, ks, stride=st, groups=groups,
                         bias=bias)
        self.dtype = dtype
        self.explicit = padding
        fan_in = in_features // groups * ks[0] * ks[1]
        with torch.no_grad():
            if init == "orthogonal":
                nn.init.orthogonal_(self.weight, generator=generator)
            elif init == "he_uniform":
                he_uniform_(self.weight, fan_in, generator)
            elif init == "he_normal":
                he_normal_(self.weight, fan_in, generator)
            else:
                lecun_normal_(self.weight, fan_in, generator)
            if bias:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        if self.explicit is not None:
            ph = pw = (self.explicit, self.explicit)
        else:
            ph = same_pads(x.shape[2], kh, sh)
            pw = same_pads(x.shape[3], kw, sw)
        x = x.to(self.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = (0, 0)
        y = F.conv2d(x, self.weight.to(self.dtype), None, self.stride,
                     padding, 1, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(1, -1, 1, 1)
        return y


class ConvBlock(_Block):
    """conv -> [BatchNorm] -> [activation] (JAX ``ConvBlock``, blocks.py:191).

    ``Conv_0`` is a ``SameConv``: SAME padding at ``stride`` (along the
    length at ``rank`` 1), with bias, a square kernel (``rank`` 2) or a
    (1, k) kernel over a 1D signal (``rank`` 1), of any k.  Kernel init
    he_uniform, zero bias."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 use_bn: bool = True, activation: tp.Optional[str] = "relu",
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 2, stride: int = 1):
        super().__init__()
        self.activation = activation
        self.Conv_0 = SameConv(in_features, features, kernel, stride=stride,
                               init="he_uniform", dtype=dtype,
                               generator=generator, rank=rank)
        self.BatchNorm_0 = BatchNorm(features) if use_bn else None

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return apply_activation(x, self.activation)


def transconv_pads(kernel: int, stride: int) -> tp.Tuple[int, int, int]:
    """``conv_transpose2d``'s ``padding`` and ``output_padding`` along an
    axis, and the trailing samples to crop, that give flax's ``SAME``
    ``ConvTranspose`` (lax's transpose padding: ``k + s - 2`` in all,
    ``pad_a = k - 1`` before when ``s > k - 1``, else ``ceil`` of half of
    it; ``pad_b`` the rest): ``padding = k - 1 - pad_a`` and
    ``output_padding = pad_b - pad_a``, or, where that is negative (k3/s2,
    k4/s1, k4/s3), 0 and that many samples cropped.  The output is ``s``
    times the input.  A positive ``output_padding`` comes with ``padding``
    0 (``s > k - 1``), and then its samples lie past every tap: zeros
    before the bias."""
    pad_len = kernel + stride - 2
    pad_a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    extra = pad_len - 2 * pad_a
    return kernel - 1 - pad_a, max(extra, 0), max(-extra, 0)


class TransConv(nn.Module):
    """Transposed conv (JAX ``TransConv``, blocks.py:346): flax's
    ``ConvTranspose`` SAME with ``transpose_kernel=True`` of any
    ``kernel`` and ``strides``, bias, then ``BatchNorm_0`` with
    ``use_bn`` and ``activation``.  flax stores the kernel as (kh, kw,
    C_out, C_in) ((k, C_out, C_in) in 1D); ``permute(3, 2, 0, 1)``
    (``permute(2, 1, 0)`` and a unit axis) gives ``conv_transpose2d``'s
    (C_in, C_out, kh, kw) weight, used with no flip and the padding of
    ``transconv_pads`` (pinned by tests/test_torch_blocks.py,
    tests/test_torch_blocks_1d.py and tests/test_torch_extra_blocks_1d.py
    for every (kernel, stride) the 1D families use).  ``rank`` 1 works
    along the length of a (B, C, 1, L) signal with a (1, k) kernel.

    ``dialect`` names the decoders' upsamplings by 2, the defaults of the
    other arguments:

    - "2d": k4 s2, no BN, LeakyReLU 0.3 (the 1D MultiResUNet3P's attention
      gates take it at ``rank`` 1: JAX builds them without the 1D
      dialect);
    - "1d" (the 1D tree's ``trans_conv1D``, decoders.py:99-108): k2 s2
      along L, ``BatchNorm_0`` and ReLU, always ``rank`` 1.

    Init as flax's ``ConvTranspose``: lecun_normal over that kernel shape,
    whose fan-in axis is C_out; zero bias."""

    _DIALECTS = {"2d": (4, 2, False, "leaky_relu"),
                 "1d": (2, 2, True, "relu")}
    _DEFAULT = object()

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 dialect: str = "2d", rank: int = 2,
                 kernel: tp.Optional[int] = None,
                 strides: tp.Optional[int] = None,
                 use_bn: tp.Optional[bool] = None,
                 activation: tp.Any = _DEFAULT):
        super().__init__()
        k, s, bn, act = self._DIALECTS[dialect]
        k = k if kernel is None else kernel
        s = s if strides is None else strides
        bn = bn if use_bn is None else use_bn
        self.activation = act if activation is self._DEFAULT else activation
        self.dtype = dtype
        self.rank = 1 if dialect == "1d" else rank
        # output_padding is appended as zeros (``forward``): PyTorch's CPU
        # build (oneDNN) corrupts its heap in the backward of some
        # channels_last transposed convs with an output_padding (k1/s2)
        pad, self.extra, self.crop = transconv_pads(k, s)
        if self.rank == 1:
            self.ConvTranspose_0 = nn.ConvTranspose2d(
                in_features, features, (1, k), stride=(1, s),
                padding=(0, pad))
        else:
            self.ConvTranspose_0 = nn.ConvTranspose2d(
                in_features, features, k, stride=s, padding=pad)
        if bn:
            self.BatchNorm_0 = BatchNorm(features)
        else:
            self.BatchNorm_0 = None
        with torch.no_grad():
            lecun_normal_(self.ConvTranspose_0.weight,
                          k ** self.rank * features, generator)
            self.ConvTranspose_0.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = self.ConvTranspose_0
        x = F.conv_transpose2d(x.to(self.dtype), ct.weight.to(self.dtype),
                               stride=ct.stride, padding=ct.padding)
        if self.extra:
            x = F.pad(x, (0, self.extra) if self.rank == 1
                      else (0, self.extra, 0, self.extra))
        elif self.crop:
            x = (x[:, :, :, :-self.crop] if self.rank == 1
                 else x[:, :, :-self.crop, :-self.crop])
        x = x + ct.bias.to(self.dtype).view(1, -1, 1, 1)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return apply_activation(x, self.activation)


class HeadConv(nn.Conv2d):
    """flax ``nn.Conv`` with a 1x1 kernel, bias and ``strides``: the model's
    ``out`` head and the decoders' deep-supervision heads (JAX
    ``_DecoderBase._ds_head``, decoders.py:153).  SAME padding of a 1x1
    kernel pads nothing, so a stride of 2 samples rows and columns 0, 2,
    4, ... (a (1, 2) stride the positions of a 1D signal): the forward
    takes those samples by slicing, then convolves with stride 1, the same
    conv; PyTorch's CPU build (oneDNN) crashes in the weight gradient of
    some strided channels_last 1x1 convs (UNet3+'s 1D heads).  Init as
    flax's: lecun_normal kernel, zero bias."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(in_features, features, 1, stride=stride)
        self.dtype = dtype
        with torch.no_grad():
            lecun_normal_(self.weight, in_features, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax casts input, kernel and bias to the compute dtype and adds
        # the bias after the convolution
        sh, sw = self.stride
        if (sh, sw) != (1, 1):
            x = x[:, :, ::sh, ::sw]
        x = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype))
        return x + self.bias.to(self.dtype).view(1, -1, 1, 1)


def upsample(x: torch.Tensor, factor: int = 2,
             method: str = "bilinear", rank: int = 2) -> torch.Tensor:
    """Upsampling by ``factor`` (JAX ``upsample``, blocks.py:389).

    ``bilinear``: half-pixel centers, ``jax.image.resize``: the same
    sample positions and weights as ``F.interpolate(align_corners=
    False)``, which keeps channels_last memory.  In float32 the two agree
    to rounding; in bf16 to one bf16 ulp (tests/test_torch_ds_blocks.py).
    At ``rank`` 1 the length axis alone is resized (linear).
    ``nearest``: every element repeated ``factor`` times along each
    spatial axis (``jnp.repeat``), the length axis alone at ``rank`` 1;
    for integer factors torch's nearest index ``floor(i / factor)`` is
    that repeat exactly."""
    scale = (1, factor) if rank == 1 else (factor, factor)
    if method == "nearest":
        return F.interpolate(x, scale_factor=scale, mode="nearest")
    if method != "bilinear":
        raise NotImplementedError(
            f"upsample method {method!r} is not ported yet (ported: "
            "bilinear, nearest)")
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


def downsample_pool(x: torch.Tensor, factor: int = 2,
                    op: str = "max", rank: int = 2) -> torch.Tensor:
    """Pool with window == stride == ``factor``, VALID (Keras semantics),
    over H and W (``rank`` 2) or over the length axis of a (B, C, 1, L)
    signal (``rank`` 1).

    Max pooling by ``2**m`` (m = 1..6, in both ranks) is level m of the
    max-pool pyramid,
    so it runs the pyramid kernel on a CUDA tensor (JAX:
    ``lax.reduce_window``), with XLA's first-max gradient
    (``pyramid.maxpool``, ``pyramid.maxpool1d``: the pool-backward kernels
    on a CUDA tensor)."""
    if op == "max":
        return (pyramid.maxpool(x, factor) if rank == 2
                else pyramid.maxpool1d(x, factor))
    if op == "avg":
        window = factor if rank == 2 else (1, factor)
        return F.avg_pool2d(x, window, window)
    raise ValueError(f"Unknown pool op {op!r}")


def concat(*tensors: torch.Tensor) -> torch.Tensor:
    """Channel-axis concat (reference ``Concat_Block``)."""
    return torch.cat(tensors, dim=1)


class DenseBlock(_Block):
    """One ConvBlock, then ``num_layers`` times ``x = x + ConvBlock(x)``
    (JAX ``DenseBlock``, blocks.py:516)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 num_layers: int = 1, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        for k in range(num_layers + 1):
            self.add_module(f"ConvBlock_{k}", ConvBlock(
                in_features if k == 0 else features, features, kernel,
                dtype=dtype, generator=generator))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvBlock_0(x)
        for k in range(1, self.num_layers + 1):
            x = x + getattr(self, f"ConvBlock_{k}")(x)
        return x


def multires_widths(model_width: int, alpha: float = 1.0,
                    multiplier: int = 1) -> tp.Tuple[int, int, int]:
    """The three branch widths of a ``MultiResBlock``:
    ``max(int(alpha * W * f), 1) * multiplier`` for f in 0.167, 0.333,
    0.5 (the reference truncates; the clamp lets tiny test widths build).
    The 2D tree passes the level's width with ``multiplier`` 1; the 1D
    tree the base width and the level's multiplier, so it truncates
    before multiplying (JAX blocks.py:732-750)."""
    w = alpha * model_width
    return (max(int(w * 0.167), 1) * multiplier,
            max(int(w * 0.333), 1) * multiplier,
            max(int(w * 0.5), 1) * multiplier)


def multires_features(model_width: int, alpha: float = 1.0,
                      multiplier: int = 1) -> int:
    """The output width of a ``MultiResBlock``: its three branches'
    (31 for W = 32 at alpha 1, 63 for 64, ...; 1D: 31 * multiplier at
    W = 32)."""
    return sum(multires_widths(model_width, alpha, multiplier))


class RecurrentConvBlock(_Block):
    """Recurrent conv block of RUNet and R2UNet (JAX
    ``RecurrentConvBlock``, blocks.py:923): ``t`` times ``x =
    concat(ConvBlock_<i>(x), inputs)``, then a last ConvBlock
    (``ConvBlock_<t>``), all ``features`` wide with kernel ``kernel``."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 t: int = 2, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 2):
        super().__init__()
        self.t = t
        kw = dict(dtype=dtype, generator=generator, rank=rank)
        for i in range(t + 1):
            cin = in_features if i == 0 else features + in_features
            self.add_module(f"ConvBlock_{i}",
                            ConvBlock(cin, features, kernel, **kw))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        for i in range(self.t):
            x = concat(getattr(self, f"ConvBlock_{i}")(x), inputs)
        return getattr(self, f"ConvBlock_{self.t}")(x)


class SelfRecurrentConvBlock(nn.Module):
    """Self-ONN recurrent conv block of SelfR2UNetPP (JAX
    ``SelfRecurrentConvBlock``, blocks.py:946): ``t`` times ``x =
    concat(Oper_<i>(x), inputs)`` (order ``q``), then ``ConvBlock_0``, all
    ``features`` wide with kernel ``kernel``."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 t: int = 2, q: int = 3, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 2):
        from .onn import Oper

        super().__init__()
        self.t = t
        kw = dict(dtype=dtype, generator=generator, rank=rank)
        for i in range(t):
            cin = in_features if i == 0 else features + in_features
            self.add_module(f"Oper_{i}", Oper(cin, features, kernel, q=q,
                                              **kw))
        self.ConvBlock_0 = ConvBlock(features + in_features if t else
                                     in_features, features, kernel, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        for i in range(self.t):
            x = concat(getattr(self, f"Oper_{i}")(x), inputs)
        return self.ConvBlock_0(x)


class ConvMixerBlock(_Block):
    """ConvMixer block (JAX ``ConvMixerBlock``, blocks.py:967): the
    depthwise conv ``dw`` (SAME, bias, lecun_normal, ``groups`` = C_in:
    the name tells the converter so even at C_in = 1), the exact gelu,
    ``BatchNorm_0``, the input added back, the 1x1 ``Conv_0`` to
    ``features``, the exact gelu and ``BatchNorm_1``."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 2):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, rank=rank)
        self.dw = SameConv(in_features, in_features, kernel,
                           groups=in_features, **kw)
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Conv_0 = SameConv(in_features, features, 1, **kw)
        self.BatchNorm_1 = BatchNorm(features)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        # cuDNN may hand back a depthwise conv's output, and a conv's of a
        # one-channel input (whose strides cannot say channels_last), in
        # the NCHW layout; the pools and the sums downstream read
        # channels_last
        dw = self.dw(x).contiguous(memory_format=torch.channels_last)
        x = self.BatchNorm_0(gelu_exact(dw)) + x
        y = self.Conv_0(x).contiguous(memory_format=torch.channels_last)
        return self.BatchNorm_1(gelu_exact(y))


class MultiResBlock(_Block):
    """MultiRes block (JAX ``MultiResBlock``, blocks.py:717, its unpacked
    branch :748-765): three chained ConvBlocks of ``multires_widths``
    channels (``ConvBlock_1..3``), concatenated, then ``BatchNorm_0``; the
    1x1 ConvBlock shortcut (``ConvBlock_0``, created first) is added in
    the activation dtype, then ReLU and ``BatchNorm_1``.  ``rank`` 1 with
    the level's ``multiplier`` is the 1D tree's block.  ``mixer``: the
    same block with ``ConvMixerBlock_0..3`` as its conv units (the
    ConvMixer archs' MultiResUNet)."""

    def __init__(self, in_features: int, model_width: int, kernel: int = 3,
                 alpha: float = 1.0, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 multiplier: int = 1, rank: int = 2, mixer: bool = False):
        super().__init__()
        f1, f2, f3 = multires_widths(model_width, alpha, multiplier)
        self.out_features = f1 + f2 + f3
        unit, kind = ((ConvMixerBlock, "ConvMixerBlock") if mixer
                      else (ConvBlock, "ConvBlock"))
        kw = dict(dtype=dtype, generator=generator, rank=rank)
        self._units = [f"{kind}_{i}" for i in range(4)]
        for name, (cin, cout, k) in zip(self._units, (
                (in_features, self.out_features, 1), (in_features, f1, kernel),
                (f1, f2, kernel), (f2, f3, kernel))):
            self.add_module(name, unit(cin, cout, k, **kw))
        self.BatchNorm_0 = BatchNorm(self.out_features)
        self.BatchNorm_1 = BatchNorm(self.out_features)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut, b1, b2, b3 = (getattr(self, n) for n in self._units)
        c3 = b1(x)
        c5 = b2(c3)
        c7 = b3(c5)
        out = self.BatchNorm_0(concat(c3, c5, c7))
        return self.BatchNorm_1(torch.relu(shortcut(x) + out))


class ResPath(_Block):
    """``max(length, 1)`` residual units (JAX ``ResPath``, blocks.py:794):
    unit i adds a 1x1 ConvBlock (``ConvBlock_<2i>``) and a kxk one
    (``ConvBlock_<2i+1>``) of the same input, then ReLU and
    ``BatchNorm_<i>``.  Every unit is ``model_width`` wide."""

    def __init__(self, in_features: int, length: int, model_width: int,
                 kernel: int = 3, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 2):
        super().__init__()
        self.length = max(length, 1)
        kw = dict(dtype=dtype, generator=generator, rank=rank)
        for i in range(self.length):
            cin = in_features if i == 0 else model_width
            self.add_module(f"ConvBlock_{2 * i}", ConvBlock(
                cin, model_width, 1, **kw))
            self.add_module(f"ConvBlock_{2 * i + 1}", ConvBlock(
                cin, model_width, kernel, **kw))
            self.add_module(f"BatchNorm_{i}", BatchNorm(model_width))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.length):
            shortcut = getattr(self, f"ConvBlock_{2 * i}")(x)
            main = getattr(self, f"ConvBlock_{2 * i + 1}")(x)
            x = getattr(self, f"BatchNorm_{i}")(torch.relu(shortcut + main))
        return x


#: the block classes ``remat = blocks`` checkpoints one by one (JAX: the
#: ``maybe_remat`` sites of models/encoders.py and models/decoders.py)
REMAT_BLOCKS = (ConvBlock, DenseBlock, MultiResBlock, ResPath)


def set_block_remat(module: nn.Module, enabled: bool) -> None:
    """Set ``remat`` on the outermost ``REMAT_BLOCKS`` under ``module``
    (the blocks inside them run within their checkpoint)."""
    for child in module.children():
        if isinstance(child, REMAT_BLOCKS):
            child.remat = enabled
        else:
            set_block_remat(child, enabled)


class AttentionGate(nn.Module):
    """Additive attention gate over a skip (JAX ``AttentionGate``,
    blocks.py:537): ``Conv_0`` (1x1, stride 2: rows and columns 0, 2, 4,
    .., ceil(H / 2) of them as flax's SAME) and ``BatchNorm_0`` on the
    skip,
    ``Conv_1`` and ``BatchNorm_1`` on the gating signal (at half the
    skip's resolution), ReLU of their sum, ``Conv_2`` to one channel,
    ``BatchNorm_2``, sigmoid; that map upsampled by 2 twice, bilinear and
    by ``TransConv_0``, and the skip multiplied by the sum of the two.
    ``dialect`` "1d" (blocks.py:574-577): the length axis strided and
    upsampled, by nearest repeat and by the 1D ``TransConv`` (its own
    BatchNorm and ReLU).  ``dialect`` "2d" at ``rank`` 1 (the 1D
    MultiResUNet3P's gates): the length axis strided and upsampled by
    linear resize and the (1, 4) ``TransConv``.

    The stride of ``Conv_0`` is taken by slicing the skip, which is the
    same conv: PyTorch's CPU build (oneDNN, torch 2.13) crashes in the
    weight gradient of a strided channels_last 1x1 conv.

    The output keeps the skip's channels and its channels_last layout:
    the one-channel map has the same memory in either layout and
    broadcasts over the channels with stride 0, so whichever strides cuDNN
    gives it, the product is laid out as the skip
    (tests/test_torch_multires_blocks.py)."""

    def __init__(self, skip_features: int, gate_features: int,
                 features: int, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 dialect: str = "2d", rank: tp.Optional[int] = None):
        super().__init__()
        self.dialect = dialect
        self.rank = rank or (1 if dialect == "1d" else 2)
        self.Conv_0 = HeadConv(skip_features, features, dtype=dtype,
                               generator=generator)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = HeadConv(gate_features, features, dtype=dtype,
                               generator=generator)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = HeadConv(features, 1, dtype=dtype, generator=generator)
        self.BatchNorm_2 = BatchNorm(1)
        self.TransConv_0 = TransConv(1, 1, dtype=dtype, generator=generator,
                                     dialect=dialect, rank=self.rank)

    def forward(self, skip: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        strided = (skip[:, :, :, ::2] if self.rank == 1
                   else skip[:, :, ::2, ::2])
        a = self.BatchNorm_0(self.Conv_0(strided))
        b = self.BatchNorm_1(self.Conv_1(gate))
        c = torch.sigmoid(self.BatchNorm_2(self.Conv_2(torch.relu(a + b))))
        method = "nearest" if self.dialect == "1d" else "bilinear"
        r = upsample(c, 2, method=method, rank=self.rank)
        return skip * (r + self.TransConv_0(c))


class Dense(nn.Linear):
    """flax ``nn.Dense``: input, kernel and bias cast to ``dtype``, the
    bias added after the product.  Init as flax's: lecun_normal kernel,
    zero bias.  flax's (in, out) kernel is this ``weight`` transposed
    (utils/flax_to_torch.py)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(in_features, features)
        self.dtype = dtype
        with torch.no_grad():
            lecun_normal_(self.weight, in_features, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.linear(x.to(self.dtype), self.weight.to(self.dtype))
                + self.bias.to(self.dtype))


class FeatureExtractionBlock(nn.Module):
    """The autoencoder bottleneck (JAX ``FeatureExtractionBlock``,
    blocks.py:492): the input flattened, ``features`` (a Dense to
    ``feature_number``), ``Dense_0`` back to ``prod(spatial) *
    model_width``, reshaped to the spatial grid with ``model_width``
    channels.  flax flattens NHWC (NLC) arrays, so the (B, C, H, W)
    channels_last input is flattened as (B, H, W, C) and the output
    rebuilt the same way: the converted Dense kernels then see the same
    vector order.  ``spatial`` is the input's (H, W) ((1, L) for a 1D
    signal): flax sizes the first Dense from the input at init, the port
    at construction."""

    def __init__(self, in_features: int, spatial: tp.Tuple[int, int],
                 model_width: int, feature_number: int,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.spatial = tuple(spatial)
        self.model_width = model_width
        size = self.spatial[0] * self.spatial[1]
        self.features = Dense(size * in_features, feature_number, dtype,
                              generator)
        self.Dense_0 = Dense(feature_number, size * model_width, dtype,
                             generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        if (h, w) != self.spatial:
            raise ValueError(
                f"FeatureExtractionBlock built for a {self.spatial} grid "
                f"got {(h, w)}: ae = 1 fixes the input size")
        y = self.Dense_0(self.features(x.permute(0, 2, 3, 1).reshape(b, -1)))
        y = y.view(b, h, w, self.model_width).permute(0, 3, 1, 2)
        return y.contiguous(memory_format=torch.channels_last)


class _ZeroGrads(torch.autograd.Function):
    """The identity on ``x`` whose backward also gives each parameter in
    ``params`` a zero gradient."""

    @staticmethod
    def forward(ctx, x, *params):
        ctx.likes = [(p.shape, p.dtype, p.device) for p in params]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=v)
                            for s, d, v in ctx.likes)


def zero_grads(x: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
    """``x``, with a zero gradient for ``params`` where the forward does
    not reach them.  optax updates every parameter of the tree, with a
    zero gradient where the loss does not depend on it (its count and its
    moments advance); the port's optimizers skip a parameter whose
    gradient is None, so such a parameter gets its zero explicitly."""
    return _ZeroGrads.apply(x, *params)


def spatial_mean(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The mean over H and W, accumulated in at least float32 and rounded
    to ``x``'s dtype, as ``jnp.mean`` computes a bf16 mean."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return xf.mean(dim=(2, 3), keepdim=keepdim).to(x.dtype)


class SqueezeExcite(nn.Module):
    """Squeeze-and-excite (JAX ``SqueezeExcite``, blocks.py:833): the
    mean over the spatial axes (accumulated in float32 and rounded to the
    activation dtype, as ``jnp.mean`` does in bf16), ``Dense_0`` to
    ``max(C // ratio, 1)`` with ReLU, ``Dense_1`` back to C with sigmoid,
    and the input scaled by it."""

    def __init__(self, features: int, ratio: int = 8,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        hidden = max(features // ratio, 1)
        self.Dense_0 = Dense(features, hidden, dtype, generator)
        self.Dense_1 = Dense(hidden, features, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = spatial_mean(x)
        s = torch.sigmoid(self.Dense_1(torch.relu(self.Dense_0(s))))
        return x * s[:, :, None, None]


class SpatialAttention(nn.Module):
    """CBAM's spatial gate (JAX ``SpatialAttention``, blocks.py:855): the
    mean over the channels (accumulated in at least float32 and rounded to
    ``x``'s dtype, as ``jnp.mean``) and the max over them, concatenated
    (mean first), ``Conv_0`` (k SAME, no bias, lecun_normal) to one
    channel, and ``x`` times its sigmoid.  The one-channel gate
    broadcasts over the channels, so the product keeps ``x``'s
    channels_last layout."""

    def __init__(self, kernel: int = 7, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 1):
        super().__init__()
        self.Conv_0 = SameConv(2, 1, kernel, bias=False, dtype=dtype,
                               generator=generator, rank=rank)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        avg = xf.mean(dim=1, keepdim=True).to(x.dtype)
        feat = concat(avg, x.amax(dim=1, keepdim=True))
        gate = self.Conv_0(feat.contiguous(memory_format=torch.channels_last))
        return x * torch.sigmoid(gate)


class ConvLSTMCell(nn.Module):
    """One ConvLSTM step from the zero state (JAX ``ConvLSTMCell``,
    blocks.py:1030): ``input_conv`` (SAME, he_normal, with bias) to 4 x
    ``features`` gates in Keras's order i, f, g, o; c = sigmoid(i) *
    tanh(g) (f meets the zero state) and the output sigmoid(o) * tanh(c).
    ``recurrent_kernel`` (orthogonal) is a parameter that the step from
    the zero state never applies, kept for the parameter count, the
    checkpoints and the converter; it gets a zero gradient
    (``zero_grads``), as optax gives it."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 1):
        super().__init__()
        self.input_conv = SameConv(in_features, 4 * features, kernel,
                                   init="he_normal", dtype=dtype,
                                   generator=generator, rank=rank)
        ks = (kernel, kernel) if rank == 2 else (1, kernel)
        self.recurrent_kernel = nn.Parameter(
            torch.empty((4 * features, features) + ks))
        with torch.no_grad():
            nn.init.orthogonal_(self.recurrent_kernel, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i, _, g, o = self.input_conv(x).chunk(4, dim=1)
        c = torch.sigmoid(i) * torch.tanh(g)
        return zero_grads(torch.sigmoid(o) * torch.tanh(c),
                          self.recurrent_kernel)


class ConvLSTMFusion(nn.Module):
    """The tensors concatenated on the channels, then one
    ``ConvLSTMCell_0`` (JAX ``ConvLSTMFusion``, blocks.py:1069)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 1):
        super().__init__()
        self.ConvLSTMCell_0 = ConvLSTMCell(in_features, features, kernel,
                                           dtype, generator, rank)

    def forward(self, *tensors: torch.Tensor) -> torch.Tensor:
        return self.ConvLSTMCell_0(concat(*tensors))


class BiConvLSTM(nn.Module):
    """Two ConvLSTM steps each way over the pair (a, b) (JAX
    ``BiConvLSTM``, blocks.py:1083), one ``input_conv`` (he_normal, with
    bias) and one ``recurrent_conv`` (orthogonal, no bias) shared by
    both directions: forward over (a, b), backward over (b, a), the
    first step of each from the zero state (no ``recurrent_conv``).
    Returns [h_fwd, h_bwd] on the channels (2 x ``features``)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 rank: int = 1):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, rank=rank)
        self.input_conv = SameConv(in_features, 4 * features, kernel,
                                   init="he_normal", **kw)
        self.recurrent_conv = SameConv(features, 4 * features, kernel,
                                       bias=False, init="orthogonal", **kw)

    def _step(self, x: torch.Tensor, h: tp.Optional[torch.Tensor] = None,
              c: tp.Optional[torch.Tensor] = None):
        gates = self.input_conv(x)
        if h is None:
            i, _, g, o = gates.chunk(4, dim=1)
            new_c = torch.tanh(g) * torch.sigmoid(i)
        else:
            i, f, g, o = (gates + self.recurrent_conv(h)).chunk(4, dim=1)
            new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(new_c), new_c

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        h_fwd, _ = self._step(b, *self._step(a))
        h_bwd, _ = self._step(a, *self._step(b))
        return concat(h_fwd, h_bwd)
