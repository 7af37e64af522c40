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
  ``wanted`` picks the levels it stores (the kernel skips the others'
  stores).
- :func:`maxpool_level` is level m alone: one launch that stores level
  m only.
- :func:`maxpool_levels` is the pools by 2, 4, .., 2**m of one tensor
  (or the ``wanted`` ones) as one differentiable op: its forward is one
  pyramid launch, its backward one ``pool_backward.maxpool_backward`` per
  level that received a gradient (the CUDA kernel ``csrc/
  pool_backward.cu`` on a CUDA tensor), which routes each gradient to the
  first maximum of its window in row-major order, as XLA does.
- :func:`maxpool` is the pool by 2**m (m = 1..6): ``maxpool_levels``
  storing level m only.
- :func:`fused_maxpool_pyramid` is the JAX package's NHWC entry point.
- :func:`route` names the kernel a CUDA call launches; each launch adds
  one to :data:`launches` under the name of the kernel that the C
  launcher reports it launched.

Rank 1 (1D signals, a (B, C, 1, L) channels_last tensor: (B, L, C)
memory, as the JAX package's NLC arrays): :func:`maxpool1d_pyramid`
(plain version :func:`maxpool1d_pyramid_plain`, :func:`route1d`) pools
the length axis by 2, 4, .., 2**levels (levels 1..6) in one read, VALID
floor truncation, through the CUDA kernels of ``csrc/pool1d.cu`` on a
CUDA tensor; :func:`maxpool1d_levels` and :func:`maxpool1d` are its
differentiable forms, as :func:`maxpool_levels` and :func:`maxpool` are
for rank 2 (the backward: ``pool_backward.maxpool1d_backward``).  They
count in the same :data:`launches`.
"""
from __future__ import annotations

import ctypes
import typing as tp

import torch

from ._common import DTYPE_CODES, Counter
from .pool_backward import (FACTORS, FACTORS_1D, maxpool1d_backward,
                            maxpool_backward)

#: kernel launches so far in this process (never counts the plain version)
launches = Counter()


def _check_levels(x: torch.Tensor, levels: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected a 4-D (B, C, H, W) tensor, got shape "
                         f"{tuple(x.shape)}")
    if not 1 <= int(levels) <= 16:
        raise ValueError(f"levels must be in 1..16, got {levels}")


def _wanted(levels: int, wanted: tp.Optional[tp.Sequence[int]]
            ) -> tp.List[int]:
    if wanted is None:
        return list(range(1, levels + 1))
    out = sorted(set(int(lvl) for lvl in wanted))
    if not out or out[0] < 1 or out[-1] > levels:
        raise ValueError(f"wanted levels {wanted} not a non-empty subset "
                         f"of 1..{levels}")
    return out


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


def maxpool_pyramid_plain(x: torch.Tensor, levels: int,
                          wanted: tp.Optional[tp.Sequence[int]] = None
                          ) -> tp.List[torch.Tensor]:
    """Plain PyTorch version: ``amax`` over a reshaped NHWC view, one level
    at a time from the input.  ``x`` is (B, C, H, W); so are the outputs,
    in channels_last memory."""
    _check_levels(x, levels)
    return [maxpool_level_plain(x, lvl) for lvl in _wanted(levels, wanted)]


def _cuda_args(x: torch.Tensor, levels: int, wanted: tp.List[int]):
    """The outputs and the C entry points' arguments for a CUDA call."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"maxpool_pyramid kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("maxpool_pyramid kernel needs a channels_last "
                         "contiguous tensor (NHWC memory)")
    b, c, h, w = x.shape
    outs = [torch.empty((b, c, h >> l, w >> l), dtype=x.dtype,
                        device=x.device, memory_format=torch.channels_last)
            for l in wanted]
    ptrs = (ctypes.c_uint64 * levels)()  # null for a level not wanted
    for lvl, o in zip(wanted, outs):
        ptrs[lvl - 1] = o.data_ptr()
    return outs, ptrs, (x.data_ptr(), ctypes.addressof(ptrs),
                        DTYPE_CODES[x.dtype], b, h, w, c, levels)


def _maxpool_pyramid_cuda(x: torch.Tensor, levels: int,
                          wanted: tp.List[int],
                          force: tp.Optional[str] = None
                          ) -> tp.List[torch.Tensor]:
    """The launch; ``force`` ("pyramid_kernel") takes that kernel in place
    of the launcher's choice, so that the card's checks time a call's
    kernel beside the one its calls took before."""
    from ._build import launch, load_library

    outs, ptrs, args = _cuda_args(x, levels, wanted)
    if outs[0].numel() == 0:  # nothing to store: no launch
        return outs
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launch(lib, "tpuseg_maxpool_pyramid",
               (*args, force.encode() if force else None), stream,
               "maxpool_pyramid", launches)
    return outs


def route(x: torch.Tensor, levels: int,
          wanted: tp.Optional[tp.Sequence[int]] = None) -> str:
    """The name of the kernel that :func:`maxpool_pyramid` launches for the
    same CUDA tensor and levels (csrc/pyramid.cu's launcher picks it from
    the shape, the levels stored and the pointers' alignment; "none" when
    there is nothing to store).  Launches nothing."""
    from ._build import load_library, route_name

    _check_levels(x, levels)
    if x.device.type != "cuda":
        raise ValueError(f"route: the kernels run on CUDA tensors, got "
                         f"{x.device}")
    wanted = _wanted(levels, wanted)
    outs, ptrs, args = _cuda_args(x, levels, wanted)
    if outs[0].numel() == 0:
        return "none"
    return route_name(load_library().tpuseg_maxpool_pyramid_route(*args),
                      "maxpool_pyramid")


def maxpool_pyramid(x: torch.Tensor, levels: int,
                    wanted: tp.Optional[tp.Sequence[int]] = None
                    ) -> tp.List[torch.Tensor]:
    """``[maxpool(x, 2**l) for l in wanted]`` of a (B, C, H, W) tensor,
    ``wanted`` a subset of 1..levels (default: all of them).

    A CUDA tensor must be float32 or bfloat16 in channels_last memory; it
    goes through one launch of the CUDA kernel (one read of ``x``; the
    launcher picks the kernel from C and the levels stored, csrc/
    pyramid.cu).  A CPU tensor goes through :func:`maxpool_pyramid_plain`.
    Outputs are channels_last."""
    _check_levels(x, levels)
    wanted = _wanted(levels, wanted)
    if x.device.type == "cuda":
        return _maxpool_pyramid_cuda(x, levels, wanted)
    if x.device.type == "cpu":
        return maxpool_pyramid_plain(x, levels, wanted)
    raise ValueError(f"maxpool_pyramid: unsupported device {x.device}")


def maxpool_level(x: torch.Tensor, level: int) -> torch.Tensor:
    """``maxpool(x, 2**level)`` of a (B, C, H, W) tensor: level ``level``
    of the pyramid alone.  A CUDA tensor goes through one launch that
    stores that level only; a CPU tensor through the plain version's
    ``amax`` (:func:`maxpool_level_plain`).  The output is channels_last."""
    return maxpool_pyramid(x, level, (level,))[0]


class MaxPoolLevels(torch.autograd.Function):
    """The max pools by 2**l, l in ``wanted`` (a subset of 1..levels), of
    a (B, C, H, W) tensor (``rank`` 2) or of the length axis of a (B, C,
    1, L) one (``rank`` 1) from one read of it, each with the gradient of
    XLA's max pool.

    A pool by 2**l routes each gradient over its whole window in row-major
    order, which is not l nested 2x2 pools, so the backward keeps one
    ``maxpool_backward`` (``maxpool1d_backward``) per level and sums them.
    A level whose output received no gradient launches nothing: with
    ``set_materialize_grads(False)`` its gradient arrives as None."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, levels: int,
                wanted: tp.Optional[tp.Sequence[int]], rank: int):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x)
        ctx.wanted = _wanted(levels, wanted)
        ctx.rank = rank
        pool = maxpool_pyramid if rank == 2 else maxpool1d_pyramid
        return tuple(pool(x, levels, ctx.wanted))

    @staticmethod
    def backward(ctx, *grads):
        (x,) = ctx.saved_tensors
        backward = maxpool_backward if ctx.rank == 2 else maxpool1d_backward
        dx = None
        # highest level first: the order in which jax.vjp of the separate
        # pools adds their cotangents (the transpose visits them last
        # to first)
        for level, g in reversed(list(zip(ctx.wanted, grads))):
            if g is None:
                continue
            d = backward(x, g, 1 << level)
            dx = d if dx is None else dx.add_(d)
        return dx, None, None, None


def maxpool_levels(x: torch.Tensor, levels: int,
                   wanted: tp.Optional[tp.Sequence[int]] = None
                   ) -> tp.List[torch.Tensor]:
    """``[maxpool(x, 2**l) for l in wanted]`` (default: l in 1..levels,
    levels 1..6) of a (B, C, H, W) tensor from one pyramid launch,
    differentiable (see :class:`MaxPoolLevels`).  A pool by 128 (level 7,
    a from-scratch dense-input encoder at depth 7 or more) raises
    ``NotImplementedError``."""
    if levels not in range(1, len(FACTORS) + 1):
        raise NotImplementedError(
            f"max pools to level {levels}: only pools by {FACTORS} are "
            "ported")
    return list(MaxPoolLevels.apply(x, levels, wanted, 2))


def maxpool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Differentiable max pool by ``factor`` (2, 4, .., 64) of a (B,
    C, H, W) tensor: :func:`maxpool_levels` storing level log2(factor) only
    (window = stride, VALID floor truncation; XLA's gradient)."""
    if factor not in FACTORS:
        raise NotImplementedError(
            f"max pool by {factor}: only {FACTORS} are ported")
    level = factor.bit_length() - 1
    return maxpool_levels(x, level, (level,))[0]


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


# ------------------------------------------------------------------ rank 1

def _check_1d(x: torch.Tensor, levels: int) -> None:
    if x.dim() != 4 or x.shape[2] != 1:
        raise ValueError(f"expected a (B, C, 1, L) tensor, got shape "
                         f"{tuple(x.shape)}")
    if levels not in range(1, len(FACTORS_1D) + 1):
        raise NotImplementedError(
            f"1D max pools to level {levels}: only pools by {FACTORS_1D} "
            "are ported")


def maxpool1d_level_plain(x: torch.Tensor, level: int) -> torch.Tensor:
    """Plain version of a 1D pool by 2**level: ``amax`` over a reshaped
    (B, L, C) view of the (B, C, 1, L) input; the output is channels_last."""
    _check_1d(x, level)
    b, c, _, n = x.shape
    f = 1 << level
    nl = n >> level
    win = x.permute(0, 2, 3, 1)[:, 0, :nl * f].reshape(b, nl, f, c)
    return win.amax(dim=2).unsqueeze(1).permute(0, 3, 1, 2)


def maxpool1d_pyramid_plain(x: torch.Tensor, levels: int,
                            wanted: tp.Optional[tp.Sequence[int]] = None
                            ) -> tp.List[torch.Tensor]:
    """Plain PyTorch version of :func:`maxpool1d_pyramid`: one ``amax`` a
    level, each from the input."""
    _check_1d(x, levels)
    return [maxpool1d_level_plain(x, lvl) for lvl in _wanted(levels, wanted)]


def _cuda_args_1d(x: torch.Tensor, levels: int, wanted: tp.List[int]):
    """The outputs and the C entry points' arguments for a CUDA call."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"maxpool1d_pyramid kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("maxpool1d_pyramid kernel needs a channels_last "
                         "contiguous tensor ((B, L, C) memory)")
    b, c, _, n = x.shape
    outs = [torch.empty((b, c, 1, n >> l), dtype=x.dtype, device=x.device,
                        memory_format=torch.channels_last) for l in wanted]
    ptrs = (ctypes.c_uint64 * levels)()  # null for a level not wanted
    for lvl, o in zip(wanted, outs):
        ptrs[lvl - 1] = o.data_ptr()
    return outs, ptrs, (x.data_ptr(), ctypes.addressof(ptrs),
                        DTYPE_CODES[x.dtype], b, n, c, levels)


def _maxpool1d_pyramid_cuda(x: torch.Tensor, levels: int,
                            wanted: tp.List[int]) -> tp.List[torch.Tensor]:
    from ._build import launch, load_library

    outs, ptrs, args = _cuda_args_1d(x, levels, wanted)
    if x.numel() == 0 or x.shape[3] < 2:  # nothing to pool: no launch
        return outs
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launch(lib, "tpuseg_maxpool1d_pyramid", args, stream,
               "maxpool1d_pyramid", launches)
    return outs


def route1d(x: torch.Tensor, levels: int,
            wanted: tp.Optional[tp.Sequence[int]] = None) -> str:
    """The name of the kernel that :func:`maxpool1d_pyramid` launches for
    the same CUDA tensor and levels: ``pool1d_flat_kernel`` where 2**levels
    divides the length and every pointer starts on 16 bytes, folding 16
    bytes of channels in registers (``<V=16B>``) or staged in shared
    memory element by element (any other C); otherwise ``pool1d_kernel``
    with 16 bytes of channels (``<V=16B>``) or one channel (``<V=1>``) a
    thread; "none" when there is nothing to pool.  Launches nothing."""
    from ._build import load_library, route_name

    _check_1d(x, levels)
    if x.device.type != "cuda":
        raise ValueError(f"route1d: the kernels run on CUDA tensors, got "
                         f"{x.device}")
    wanted = _wanted(levels, wanted)
    outs, ptrs, args = _cuda_args_1d(x, levels, wanted)
    return route_name(load_library().tpuseg_maxpool1d_pyramid_route(*args),
                      "maxpool1d_pyramid")


def maxpool1d_pyramid(x: torch.Tensor, levels: int,
                      wanted: tp.Optional[tp.Sequence[int]] = None
                      ) -> tp.List[torch.Tensor]:
    """``[maxpool1d(x, 2**l) for l in wanted]`` of a (B, C, 1, L) tensor,
    ``wanted`` a subset of 1..levels (levels 1..6; default: all).  A CUDA
    tensor must be float32 or bfloat16 in channels_last memory; it goes
    through one launch of a CUDA kernel (one read of ``x``; the launcher
    picks it, :func:`route1d`).  A CPU
    tensor goes through :func:`maxpool1d_pyramid_plain`.  Outputs are
    (B, C, 1, L >> l), channels_last."""
    _check_1d(x, levels)
    wanted = _wanted(levels, wanted)
    if x.device.type == "cuda":
        return _maxpool1d_pyramid_cuda(x, levels, wanted)
    if x.device.type == "cpu":
        return maxpool1d_pyramid_plain(x, levels, wanted)
    raise ValueError(f"maxpool1d_pyramid: unsupported device {x.device}")


def maxpool1d_levels(x: torch.Tensor, levels: int,
                     wanted: tp.Optional[tp.Sequence[int]] = None
                     ) -> tp.List[torch.Tensor]:
    """``[maxpool1d(x, 2**l) for l in wanted]`` (default: l in 1..levels,
    levels 1..6) of a (B, C, 1, L) tensor from one pyramid launch,
    differentiable (see :class:`MaxPoolLevels`).  A pool by 128 (level 7)
    raises ``NotImplementedError``."""
    _check_1d(x, levels)
    return list(MaxPoolLevels.apply(x, levels, wanted, 1))


def maxpool1d(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Differentiable max pool by ``factor`` (2, 4, .., 64) over the
    length axis of a (B, C, 1, L) tensor: :func:`maxpool1d_levels`
    storing level log2(factor) only (window = stride, VALID floor
    truncation; XLA's gradient)."""
    if factor not in FACTORS_1D:
        raise NotImplementedError(
            f"1D max pool by {factor}: only {FACTORS_1D} are ported")
    level = factor.bit_length() - 1
    return maxpool1d_levels(x, level, (level,))[0]
