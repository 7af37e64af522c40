"""Max-pool pyramid: ``[maxpool(x, 2**l) for l in 1..levels]``.

Port of the Pallas TPU kernel ``_pyramid_tpu``
(tf_1d_2d_segmentation_end2endpipelines_tpu/ops/pallas/pyramid.py:49) to a
CUDA kernel written by hand for Hopper, ``csrc/pyramid.cu``; that file's
header says what bounds it and what its design does about it.

Window = stride = 2**l, VALID floor truncation: level l has ``H >> l`` rows
and ``W >> l`` columns, which is what the chain of 2x2 pools gives.  Any H,
W and channel count; float32 and bfloat16.

- :func:`maxpool_pyramid` is the wrapper.  On a CPU tensor it runs
  :func:`maxpool_pyramid_plain`; on a CUDA tensor it launches the kernel
  or raises.  Each launch adds one to :data:`launches` (its ``value``).
- :func:`maxpool_level` is level m alone: one launch that stores level
  m only (the kernel skips the stores of the levels below it).
- :func:`maxpool` is the pool by 2**m (m = 1..4) as a differentiable op:
  its forward is ``maxpool_level(x, m)``, its backward ``pool_backward.
  maxpool_backward`` with window 2**m (the CUDA kernel
  ``csrc/pool_backward.cu`` on a CUDA tensor), which routes each gradient
  to the first maximum of its window in row-major order, as XLA does.
- :func:`fused_maxpool_pyramid` is the JAX package's NHWC entry point.
"""
from __future__ import annotations

import ctypes
import typing as tp

import torch

from ._common import DTYPE_CODES, Counter
from .pool_backward import FACTORS, maxpool_backward

#: kernel launches so far in this process (never counts the plain version)
launches = Counter()


def _check_levels(x: torch.Tensor, levels: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected a 4-D (B, C, H, W) tensor, got shape "
                         f"{tuple(x.shape)}")
    if not 1 <= int(levels) <= 16:
        raise ValueError(f"levels must be in 1..16, got {levels}")


def maxpool_level_plain(x: torch.Tensor, level: int) -> torch.Tensor:
    """Plain version of :func:`maxpool_level`: ``amax`` over a reshaped
    NHWC view of the (B, C, H, W) input; the output is channels_last."""
    _check_levels(x, level)
    b, c, h, w = x.shape
    f = 1 << level
    hl, wl = h >> level, w >> level
    win = x.permute(0, 2, 3, 1)[:, :hl * f, :wl * f].reshape(b, hl, f, wl,
                                                             f, c)
    return win.amax(dim=(2, 4)).permute(0, 3, 1, 2)


def maxpool_pyramid_plain(x: torch.Tensor, levels: int
                          ) -> tp.List[torch.Tensor]:
    """Plain PyTorch version: ``amax`` over a reshaped NHWC view, one level
    at a time from the input.  ``x`` is (B, C, H, W); so are the outputs,
    in channels_last memory."""
    _check_levels(x, levels)
    return [maxpool_level_plain(x, lvl) for lvl in range(1, levels + 1)]


def _maxpool_pyramid_cuda(x: torch.Tensor, levels: int,
                          last_only: bool = False
                          ) -> tp.List[torch.Tensor]:
    from ._build import check, load_library

    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"maxpool_pyramid kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("maxpool_pyramid kernel needs a channels_last "
                         "contiguous tensor (NHWC memory)")
    b, c, h, w = x.shape
    wanted = [levels] if last_only else range(1, levels + 1)
    outs = [torch.empty((b, c, h >> l, w >> l), dtype=x.dtype,
                        device=x.device, memory_format=torch.channels_last)
            for l in wanted]
    if outs[0].numel() == 0:  # nothing to store: no launch
        return outs
    lib = load_library()
    ptrs = (ctypes.c_uint64 * levels)(*(0,) * (levels - len(outs)),
                                      *(o.data_ptr() for o in outs))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.tpuseg_maxpool_pyramid(
            x.data_ptr(), ctypes.addressof(ptrs), DTYPE_CODES[x.dtype],
            b, h, w, c, levels, stream)
    check(lib, code, "maxpool_pyramid")
    launches.add()
    return outs


def maxpool_pyramid(x: torch.Tensor, levels: int) -> tp.List[torch.Tensor]:
    """``[maxpool(x, 2**l) for l in 1..levels]`` of a (B, C, H, W) tensor.

    A CUDA tensor must be float32 or bfloat16 in channels_last memory; it
    goes through one launch of the CUDA kernel (one read of ``x``; for
    ``levels == 1`` the launcher picks the 16-byte-vector kernel when the
    channels allow, as it does for :func:`maxpool_level` up to level 4).
    A CPU tensor goes through
    :func:`maxpool_pyramid_plain`.  Outputs are channels_last."""
    _check_levels(x, levels)
    if x.device.type == "cuda":
        return _maxpool_pyramid_cuda(x, levels)
    if x.device.type == "cpu":
        return maxpool_pyramid_plain(x, levels)
    raise ValueError(f"maxpool_pyramid: unsupported device {x.device}")


def maxpool_level(x: torch.Tensor, level: int) -> torch.Tensor:
    """``maxpool(x, 2**level)`` of a (B, C, H, W) tensor: level ``level``
    of the pyramid alone.  A CUDA tensor goes through one launch that
    stores that level only; a CPU tensor through the plain version's
    ``amax`` (:func:`maxpool_level_plain`).  The output is channels_last."""
    _check_levels(x, level)
    if x.device.type == "cuda":
        return _maxpool_pyramid_cuda(x, level, last_only=True)[0]
    if x.device.type == "cpu":
        return maxpool_level_plain(x, level)
    raise ValueError(f"maxpool_level: unsupported device {x.device}")


class MaxPool(torch.autograd.Function):
    """The max pool by 2**level (window = stride, VALID floor truncation)
    of a (B, C, H, W) tensor, with the gradient of XLA's max pool."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, level: int) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.level = level
        return maxpool_level(x, level)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return maxpool_backward(x, g, 1 << ctx.level), None


def maxpool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Differentiable max pool by ``factor`` (2, 4, 8 or 16) of a (B, C,
    H, W) tensor (see :class:`MaxPool`)."""
    if factor not in FACTORS:
        raise NotImplementedError(
            f"max pool by {factor}: only {FACTORS} are ported")
    return MaxPool.apply(x, factor.bit_length() - 1)


def fused_maxpool_pyramid(mask: torch.Tensor, levels: int
                          ) -> tp.List[torch.Tensor]:
    """The JAX package's ``fused_maxpool_pyramid`` on NHWC tensors.

    ``mask``: (B, H, W) or (B, H, W, C).  Returns ``levels`` tensors of the
    input's rank, level 1 first.  Unlike the TPU kernel, H and W need not
    be divisible by 2**levels."""
    squeeze = mask.dim() == 3
    m = mask[..., None] if squeeze else mask
    outs = maxpool_pyramid(m.contiguous().permute(0, 3, 1, 2), levels)
    outs = [o.permute(0, 2, 3, 1) for o in outs]
    return [o[..., 0] for o in outs] if squeeze else outs
