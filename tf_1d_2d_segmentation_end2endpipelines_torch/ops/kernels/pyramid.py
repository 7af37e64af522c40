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
- :func:`maxpool2x2` is level 1 as a differentiable op: its forward is
  ``maxpool_pyramid(x, 1)``, its backward ``pool_backward.
  maxpool2x2_backward`` (the CUDA kernel ``csrc/pool_backward.cu`` on a
  CUDA tensor), which routes each gradient to the first maximum of its
  window as XLA does.
- :func:`fused_maxpool_pyramid` is the JAX package's NHWC entry point.
"""
from __future__ import annotations

import ctypes
import typing as tp

import torch

from ._common import DTYPE_CODES, Counter
from .pool_backward import maxpool2x2_backward

#: kernel launches so far in this process (never counts the plain version)
launches = Counter()


def _check_levels(x: torch.Tensor, levels: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected a 4-D (B, C, H, W) tensor, got shape "
                         f"{tuple(x.shape)}")
    if not 1 <= int(levels) <= 16:
        raise ValueError(f"levels must be in 1..16, got {levels}")


def maxpool_pyramid_plain(x: torch.Tensor, levels: int
                          ) -> tp.List[torch.Tensor]:
    """Plain PyTorch version: ``amax`` over a reshaped NHWC view, one level
    at a time from the input.  ``x`` is (B, C, H, W); so are the outputs,
    in channels_last memory."""
    _check_levels(x, levels)
    b, c, h, w = x.shape
    xn = x.permute(0, 2, 3, 1)  # NHWC view
    outs = []
    for lvl in range(1, levels + 1):
        f = 1 << lvl
        hl, wl = h >> lvl, w >> lvl
        win = xn[:, :hl * f, :wl * f].reshape(b, hl, f, wl, f, c)
        outs.append(win.amax(dim=(2, 4)).permute(0, 3, 1, 2))
    return outs


def _maxpool_pyramid_cuda(x: torch.Tensor, levels: int
                          ) -> tp.List[torch.Tensor]:
    from ._build import check, load_library

    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"maxpool_pyramid kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("maxpool_pyramid kernel needs a channels_last "
                         "contiguous tensor (NHWC memory)")
    lib = load_library()
    b, c, h, w = x.shape
    outs = [torch.empty((b, c, h >> l, w >> l), dtype=x.dtype,
                        device=x.device, memory_format=torch.channels_last)
            for l in range(1, levels + 1)]
    if outs[0].numel() == 0:  # nothing to pool: no launch
        return outs
    ptrs = (ctypes.c_uint64 * levels)(*(o.data_ptr() for o in outs))
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
    goes through one launch of the CUDA kernel (one read of ``x``; the
    launcher picks a 16-byte-vector kernel for ``levels == 1`` when the
    channels allow).  A CPU tensor goes through
    :func:`maxpool_pyramid_plain`.  Outputs are channels_last."""
    _check_levels(x, levels)
    if x.device.type == "cuda":
        return _maxpool_pyramid_cuda(x, levels)
    if x.device.type == "cpu":
        return maxpool_pyramid_plain(x, levels)
    raise ValueError(f"maxpool_pyramid: unsupported device {x.device}")


class MaxPool2x2(torch.autograd.Function):
    """The 2x2 max pool (window = stride = 2, VALID floor truncation) of a
    (B, C, H, W) tensor, with the gradient of XLA's max pool."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return maxpool_pyramid(x, 1)[0]

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return maxpool2x2_backward(x, g)


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """Differentiable level 1 of the pyramid (see :class:`MaxPool2x2`)."""
    return MaxPool2x2.apply(x)


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
