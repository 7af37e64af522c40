"""Gradient of the max pool with window = stride = ``factor`` = 2**m,
m = 1..6 (VALID floor truncation), in both ranks: each output
gradient goes to one element of its window, chosen by XLA's
``select_and_scatter`` rule under the pool's VJP (the JAX package's
``downsample_pool``, ops/blocks.py; pinned there by
tests/test_pool_impl.py):

walk the whole window in row-major order keeping a selected element, and
move to the next element ``e`` whenever ``not (selected >= e)``.

For finite values that is the first maximum in row-major order, so a
plateau of tied values (the zeros after a ReLU) sends the whole gradient
to its first element, where ``amax``'s autograd would split it evenly.
A 4x4 window is not two nested 2x2 pools: with ones at (0, 2) and (1, 0)
the walk picks (0, 2), nested 2x2 walks (1, 0).  Rows and columns the
floor cuts off get a zero gradient.

The CUDA kernel is ``csrc/pool_backward.cu``; its header says what bounds
it and what its design does about it.

- :func:`maxpool_backward` is the wrapper.  On a CPU tensor it runs
  :func:`maxpool_backward_plain`; on a CUDA tensor it launches the kernel
  or raises.  Each launch adds one to :data:`launches`; each copy of ``g``
  into channels_last memory adds one to :data:`g_copies`.
- :func:`route` names the kernel a CUDA call launches; each launch adds
  one to :data:`launches` under the name of the kernel that the C
  launcher reports it launched.

Rank 1: :func:`maxpool1d_backward` (plain version
:func:`maxpool1d_backward_plain`, :func:`route1d`) is the same gradient
for a pool over the length axis of a 1D signal, a (B, C, 1, L)
channels_last tensor ((B, L, C) memory): the window is F consecutive
positions, walked in order, and the positions the floor cuts off get a
zero gradient.  Its CUDA kernel is in ``csrc/pool1d.cu``; it counts in
the same :data:`launches` and :data:`g_copies`.
"""
from __future__ import annotations

import torch

from ._common import DTYPE_CODES, Counter

#: kernel launches so far in this process (never counts the plain version)
launches = Counter()
#: copies of an upstream gradient into channels_last memory on the kernel
#: path (autograd may hand ``g`` in another layout)
g_copies = Counter()

#: the window sides the kernel takes (rank 2)
FACTORS = (2, 4, 8, 16, 32, 64)
#: the window sides the rank-1 kernel takes
FACTORS_1D = (2, 4, 8, 16, 32, 64)


def _check_shapes(x: torch.Tensor, g: torch.Tensor, factor: int) -> None:
    if factor not in FACTORS:
        raise ValueError(f"pool factor must be one of {FACTORS}, got "
                         f"{factor}")
    if x.dim() != 4:
        raise ValueError(f"expected a 4-D (B, C, H, W) input, got shape "
                         f"{tuple(x.shape)}")
    b, c, h, w = x.shape
    if tuple(g.shape) != (b, c, h // factor, w // factor):
        raise ValueError(f"gradient shape {tuple(g.shape)} does not match "
                         f"the pool by {factor} of {tuple(x.shape)}")
    if g.dtype != x.dtype:
        raise TypeError(f"gradient dtype {g.dtype} != input dtype {x.dtype}")


def maxpool_backward_plain(x: torch.Tensor, g: torch.Tensor, factor: int
                           ) -> torch.Tensor:
    """Plain PyTorch version.  ``x`` is the pool's (B, C, H, W) input,
    ``g`` the gradient of its (B, C, H // factor, W // factor) output;
    returns dx like ``x``, in channels_last memory."""
    _check_shapes(x, g, factor)
    f, n = factor, factor * factor
    b, c, h, w = x.shape
    hf, wf = h // f, w // f
    xn = x.permute(0, 2, 3, 1)[:, :hf * f, :wf * f]  # NHWC view
    # (b, hf, wf, f*f, c): the window's elements in row-major order
    win = xn.reshape(b, hf, f, wf, f, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, hf, wf, n, c)
    sel_val = win[:, :, :, 0]
    sel = torch.zeros_like(sel_val, dtype=torch.int16)
    for j in range(1, n):
        take = ~(sel_val >= win[:, :, :, j])
        sel_val = torch.where(take, win[:, :, :, j], sel_val)
        sel = torch.where(take, torch.full_like(sel, j), sel)
    gn = g.permute(0, 2, 3, 1)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    parts = torch.stack([torch.where(sel == j, gn, zero) for j in range(n)],
                        dim=3)
    dx = torch.zeros((b, h, w, c), dtype=x.dtype, device=x.device)
    dx[:, :hf * f, :wf * f] = parts.reshape(b, hf, wf, f, f, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, hf * f, wf * f, c)
    return dx.permute(0, 3, 1, 2)


def _check_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Check a CUDA call's tensors; returns ``g`` in channels_last memory
    (copied, and counted, if it was not)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"maxpool_backward kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("maxpool_backward kernel needs a channels_last "
                         "contiguous input (NHWC memory)")
    if g.device != x.device:
        raise ValueError(f"gradient on {g.device}, input on {x.device}")
    if not g.is_contiguous(memory_format=torch.channels_last):
        g = g.contiguous(memory_format=torch.channels_last)
        g_copies.add()
    return g


def _args(x: torch.Tensor, g: torch.Tensor, dx: torch.Tensor, factor: int
          ) -> tuple:
    b, c, h, w = x.shape
    return (x.data_ptr(), g.data_ptr(), dx.data_ptr(), DTYPE_CODES[x.dtype],
            b, h, w, c, factor)


def _maxpool_backward_cuda(x: torch.Tensor, g: torch.Tensor, factor: int
                           ) -> torch.Tensor:
    from ._build import launch, load_library

    g = _check_cuda(x, g)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    if dx.numel() == 0:  # nothing to route: no launch
        return dx
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launch(lib, "tpuseg_maxpool_backward", _args(x, g, dx, factor),
               stream, "maxpool_backward", launches)
    return dx


def route(x: torch.Tensor, g: torch.Tensor, factor: int) -> str:
    """The name of the kernel that :func:`maxpool_backward` launches for
    the same CUDA tensors and factor: ``pool_backward_kernel`` (F = 2),
    ``pool_backward_rows_kernel`` (F = 4 .. 16),
    ``pool_backward_block_kernel`` (F = 32) or
    ``pool_backward_wide_kernel`` (F = 64), with ``<V=1>`` where it takes
    one channel a thread; "none" for an empty ``x``.  Launches nothing and
    counts no copy (a ``g`` the wrapper would copy is judged as its
    copy, which is aligned)."""
    from ._build import load_library, route_name

    _check_shapes(x, g, factor)
    if x.device.type != "cuda":
        raise ValueError(f"route: the kernels run on CUDA tensors, got "
                         f"{x.device}")
    if not g.is_contiguous(memory_format=torch.channels_last):
        g = g.contiguous(memory_format=torch.channels_last)
    _check_cuda(x, g)
    if x.numel() == 0:
        return "none"
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    return route_name(load_library().tpuseg_maxpool_backward_route(
        *_args(x, g, dx, factor)), "maxpool_backward")


def maxpool_backward(x: torch.Tensor, g: torch.Tensor, factor: int
                     ) -> torch.Tensor:
    """dx of the max pool by ``factor`` (2, 4, .., 64) of ``x`` (B, C,
    H, W) for the output gradient ``g``.  On a CUDA tensor ``x`` must be
    float32 or bfloat16 in channels_last memory, and ``g`` of the same
    dtype (copied into channels_last if it is not); one launch of the
    kernel.  A CPU tensor goes through :func:`maxpool_backward_plain`.  dx
    is channels_last."""
    _check_shapes(x, g, factor)
    if x.device.type == "cuda":
        return _maxpool_backward_cuda(x, g, factor)
    if x.device.type == "cpu":
        return maxpool_backward_plain(x, g, factor)
    raise ValueError(f"maxpool_backward: unsupported device {x.device}")


# ------------------------------------------------------------------ rank 1

def _check_shapes_1d(x: torch.Tensor, g: torch.Tensor, factor: int) -> None:
    if factor not in FACTORS_1D:
        raise ValueError(f"pool factor must be one of {FACTORS_1D}, got "
                         f"{factor}")
    if x.dim() != 4 or x.shape[2] != 1:
        raise ValueError(f"expected a (B, C, 1, L) input, got shape "
                         f"{tuple(x.shape)}")
    b, c, _, n = x.shape
    if tuple(g.shape) != (b, c, 1, n // factor):
        raise ValueError(f"gradient shape {tuple(g.shape)} does not match "
                         f"the pool by {factor} of {tuple(x.shape)}")
    if g.dtype != x.dtype:
        raise TypeError(f"gradient dtype {g.dtype} != input dtype {x.dtype}")


def maxpool1d_backward_plain(x: torch.Tensor, g: torch.Tensor, factor: int
                             ) -> torch.Tensor:
    """Plain PyTorch version of :func:`maxpool1d_backward`.  ``x`` is the
    pool's (B, C, 1, L) input, ``g`` the gradient of its (B, C, 1,
    L // factor) output; returns dx like ``x``, in channels_last memory."""
    _check_shapes_1d(x, g, factor)
    f = factor
    b, c, _, n = x.shape
    nf = n // f
    win = x.permute(0, 2, 3, 1)[:, 0, :nf * f].reshape(b, nf, f, c)
    sel_val = win[:, :, 0]
    sel = torch.zeros_like(sel_val, dtype=torch.int16)
    for j in range(1, f):
        take = ~(sel_val >= win[:, :, j])
        sel_val = torch.where(take, win[:, :, j], sel_val)
        sel = torch.where(take, torch.full_like(sel, j), sel)
    gn = g.permute(0, 2, 3, 1)[:, 0]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    parts = torch.stack([torch.where(sel == j, gn, zero) for j in range(f)],
                        dim=2)
    dx = torch.zeros((b, n, c), dtype=x.dtype, device=x.device)
    dx[:, :nf * f] = parts.reshape(b, nf * f, c)
    return dx.unsqueeze(1).permute(0, 3, 1, 2)


def _args_1d(x: torch.Tensor, g: torch.Tensor, dx: torch.Tensor,
             factor: int) -> tuple:
    b, c, _, n = x.shape
    return (x.data_ptr(), g.data_ptr(), dx.data_ptr(), DTYPE_CODES[x.dtype],
            b, n, c, factor)


def _maxpool1d_backward_cuda(x: torch.Tensor, g: torch.Tensor, factor: int
                             ) -> torch.Tensor:
    from ._build import launch, load_library

    g = _check_cuda(x, g)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    if dx.numel() == 0:  # nothing to route: no launch
        return dx
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launch(lib, "tpuseg_maxpool1d_backward",
               _args_1d(x, g, dx, factor), stream, "maxpool1d_backward",
               launches)
    return dx


def route1d(x: torch.Tensor, g: torch.Tensor, factor: int) -> str:
    """The name of the kernel that :func:`maxpool1d_backward` launches for
    the same CUDA tensors and factor: ``pool1d_backward_kernel`` with
    16 bytes (``<V=16B>``) or one channel (``<V=1>``) a thread (two
    threads a window at F = 64); "none" for an empty ``x``.  Launches
    nothing and counts no copy."""
    from ._build import load_library, route_name

    _check_shapes_1d(x, g, factor)
    if x.device.type != "cuda":
        raise ValueError(f"route1d: the kernels run on CUDA tensors, got "
                         f"{x.device}")
    if not g.is_contiguous(memory_format=torch.channels_last):
        g = g.contiguous(memory_format=torch.channels_last)
    _check_cuda(x, g)
    if x.numel() == 0:
        return "none"
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    return route_name(load_library().tpuseg_maxpool1d_backward_route(
        *_args_1d(x, g, dx, factor)), "maxpool1d_backward")


def maxpool1d_backward(x: torch.Tensor, g: torch.Tensor, factor: int
                       ) -> torch.Tensor:
    """dx of the max pool by ``factor`` (2, 4, .., 64) over the length
    axis of ``x`` (B, C, 1, L) for the output gradient ``g``.  On a CUDA
    tensor ``x`` must be float32 or bfloat16 in channels_last memory, and
    ``g`` of the same dtype (copied into channels_last if it is not); one
    launch of the kernel.  A CPU tensor goes through
    :func:`maxpool1d_backward_plain`.  dx is channels_last."""
    _check_shapes_1d(x, g, factor)
    if x.device.type == "cuda":
        return _maxpool1d_backward_cuda(x, g, factor)
    if x.device.type == "cpu":
        return maxpool1d_backward_plain(x, g, factor)
    raise ValueError(f"maxpool1d_backward: unsupported device {x.device}")
