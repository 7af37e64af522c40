"""The port's max-pool pyramid against the JAX package: the plain PyTorch
version must equal the Pallas TPU kernel (run in interpret mode, as no TPU
is here) and the reduce_window chain exactly, since max is exact.  The
CUDA kernel itself is held against the plain version on the card, in
tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.ops import blocks as jblocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu.ops.pallas.pyramid import (  # noqa: E402
    _pyramid_tpu, fused_maxpool_pyramid as jax_pyramid)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pyramid)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dtype_name, seed, nan=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if nan:  # XLA's max and torch.amax both propagate NaN
        x.reshape(-1)[x.size // 3] = np.nan
    jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("shape", [(2, 32, 32), (1, 16, 64),
                                   (2, 32, 32, 1)])
def test_plain_pyramid_equals_pallas_kernel(shape, levels, dtype_name):
    """Plain pyramid == ``_pyramid_tpu(interpret=True)`` ==
    ``fused_maxpool_pyramid`` (reduce_window chain), bit for bit."""
    jx, tx = _inputs(shape, dtype_name, seed=levels, nan=levels == 2)
    mask = jx[..., 0] if jx.ndim == 4 else jx
    want = _pyramid_tpu(mask, levels, interpret=True)
    chain = jax_pyramid(jx, levels)
    got = pyramid.fused_maxpool_pyramid(tx, levels)
    assert len(got) == len(want) == len(chain) == levels
    for g, w, c in zip(got, want, chain):
        assert g.dtype == tx.dtype and tuple(g.shape) == tuple(c.shape)
        np.testing.assert_array_equal(_np(g[..., 0] if g.dim() == 4 else g),
                                      _np(w))
        np.testing.assert_array_equal(_np(g), _np(c))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,levels", [((2, 37, 53, 3), 2),
                                          ((1, 7, 9, 5), 3),
                                          ((3, 13, 6, 1), 2)])
def test_plain_pyramid_odd_sizes_equal_reduce_window_chain(shape, levels,
                                                           dtype_name):
    """VALID floor truncation at sizes not divisible by 2**levels, any
    channel count (the TPU kernel refuses them; the JAX chain of 2x2
    pools is the reference)."""
    jx, tx = _inputs(shape, dtype_name, seed=7)
    for g in pyramid.fused_maxpool_pyramid(tx, levels):
        jx = jblocks.downsample_pool(jx, 2, op="max")
        assert tuple(g.shape) == tuple(jx.shape)
        np.testing.assert_array_equal(_np(g), _np(jx))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("shape", [(2, 37, 53, 3), (1, 8, 8, 16),
                                   (2, 9, 5, 2)])
def test_downsample_pool_matches_jax(shape, factor, dtype_name):
    """The port's ``downsample_pool`` (NCHW channels_last) equals the JAX
    ``ops/blocks.py::downsample_pool`` (NHWC), max and avg."""
    jx, tx = _inputs(shape, dtype_name, seed=factor)
    tx = tx.permute(0, 3, 1, 2)
    assert tx.is_contiguous(memory_format=torch.channels_last)
    got = blocks.downsample_pool(tx, factor, op="max").permute(0, 2, 3, 1)
    want = jblocks.downsample_pool(jx, factor, op="max")
    np.testing.assert_array_equal(_np(got), _np(want))
    if dtype_name == "float32":  # sums round differently in bf16
        got = blocks.downsample_pool(tx, factor, op="avg").permute(0, 2, 3, 1)
        want = jblocks.downsample_pool(jx, factor, op="avg")
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)


def test_cpu_wrapper_uses_plain_version_and_counts_no_launch():
    x = torch.randn(2, 4, 8, 8).contiguous(memory_format=torch.channels_last)
    before = pyramid.launches.value
    got = pyramid.maxpool_pyramid(x, 2)
    want = pyramid.maxpool_pyramid_plain(x, 2)
    assert pyramid.launches.value == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert g.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("bad", ["levels0", "levels17", "rank3",
                                 "pool_by_3"])
def test_wrapper_rejects_bad_arguments(bad):
    x = torch.zeros(1, 1, 8, 8)
    with pytest.raises((ValueError, NotImplementedError)):
        if bad == "levels0":
            pyramid.maxpool_pyramid(x, 0)
        elif bad == "levels17":
            pyramid.maxpool_pyramid(x, 17)
        elif bad == "rank3":
            pyramid.maxpool_pyramid(x[0], 1)
        else:
            blocks.downsample_pool(x, 3)
