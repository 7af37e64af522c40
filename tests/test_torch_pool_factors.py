"""The port's max pool by 2**m (``pyramid.maxpool``: forward one pyramid
launch of level m, backward ``pool_backward.maxpool_backward`` with window
2**m) against ``jax.vjp`` of the JAX package's ``downsample_pool``
(lax.reduce_window; XLA's select_and_scatter walks the whole window in
row-major order).  Exact: the forward is a max and the gradient a routing
of the upstream values, so both sides agree bit for bit, on inputs full
of ties, ragged edges and NaN windows."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.ops.blocks import (  # noqa: E402
    downsample_pool as jax_pool)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pool_backward, pyramid)

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_pool_and_grad(x, g, factor, jdt):
    y, vjp = jax.vjp(lambda t: jax_pool(t, factor, op="max"),
                     jnp.asarray(x, jdt))
    (dx,) = vjp(jnp.asarray(g, jdt))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)))


def _port_pool_and_grad(x, g, factor, tdt):
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).detach()
    xt.requires_grad_()
    y = blocks.downsample_pool(xt, factor, op="max")
    y.backward(torch.from_numpy(g).to(tdt).permute(0, 3, 1, 2))
    return (y.detach().float().permute(0, 2, 3, 1).numpy(),
            xt.grad.float().permute(0, 2, 3, 1).numpy())


def _input(shape, seed, kind):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "relu":      # post-ReLU: plateaus of exact zeros
        x = np.maximum(x, 0.0)
    elif kind == "coarse":  # few distinct values: ties among nonzeros too
        x = np.round(x * 2.0) / 2.0
    elif kind == "bf16dup":  # distinct in f32, duplicates once in bf16
        x = (1.0 + rng.integers(0, 3, size=shape) * 2.0 ** -7
             + rng.uniform(0, 2.0 ** -10, size=shape)).astype(np.float32)
    elif kind == "nan":     # plateaus with NaNs planted in some windows
        x = np.maximum(x, 0.0)
        x.reshape(-1)[rng.choice(x.size, max(x.size // 40, 1),
                                 replace=False)] = np.nan
    return x


def _check(x, factor, dtype):
    jdt, tdt = _DTYPES[dtype]
    b, h, w, c = x.shape
    g = np.random.default_rng(1).normal(
        size=(b, h // factor, w // factor, c)).astype(np.float32)
    y_j, dx_j = _jax_pool_and_grad(x, g, factor, jdt)
    y_t, dx_t = _port_pool_and_grad(x, g, factor, tdt)
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(dx_t, dx_j)
    return dx_t


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("kind", ["relu", "coarse", "bf16dup", "nan"])
@pytest.mark.parametrize("factor,shape", [
    (2, (2, 9, 7, 3)),
    (4, (2, 19, 23, 3)),     # ragged: the floor cuts 3 rows, 3 columns
    (4, (1, 16, 16, 8)),
    (8, (2, 16, 19, 2)),
    (16, (1, 33, 17, 2)),
])
def test_pool_by_factor_equals_jax_vjp(dtype, kind, factor, shape):
    dx = _check(_input(shape, factor, kind), factor, dtype)
    h, w = shape[1:3]
    assert not dx[:, (h // factor) * factor:].any()  # rows cut off
    assert not dx[:, :, (w // factor) * factor:].any()  # columns cut off


def test_4x4_tie_routes_to_the_first_element_in_row_major_order():
    """Zeros with ones at (0, 2) and (1, 0): the whole-window walk picks
    (0, 2); two nested 2x2 pools would pick (1, 0).  All zeros: (0, 0)."""
    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, 0, 2, 0] = x[0, 1, 0, 0] = 1.0
    dx = _check(x, 4, "float32")
    assert np.argwhere(dx[0, :, :, 0]).tolist() == [[0, 2]]
    nested = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    pyramid.maxpool(pyramid.maxpool(nested, 2), 2).sum().backward()
    assert nested.grad[0, 0, 1, 0] == 1.0  # what chaining would do
    dx = _check(np.zeros((1, 4, 4, 1), np.float32), 4, "float32")
    assert np.argwhere(dx[0, :, :, 0]).tolist() == [[0, 0]]


@pytest.mark.parametrize("where", [(0, 0), (0, 3), (2, 1), (3, 3)])
def test_nan_in_a_4x4_window_routes_as_xla(where):
    x = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1) % 5
    x[0, where[0], where[1], 0] = np.nan
    _check(x, 4, "float32")


def test_plain_backward_refuses_bad_arguments():
    x = torch.randn(1, 2, 8, 8)
    g = torch.randn(1, 2, 2, 2)
    dx = pool_backward.maxpool_backward(x, g, 4)
    # each window's gradient lands on exactly one element
    assert torch.equal(dx.reshape(1, 2, 2, 4, 2, 4).sum(dim=(3, 5)), g)
    with pytest.raises(ValueError):
        pool_backward.maxpool_backward(x, g, 3)
    with pytest.raises(ValueError):
        pool_backward.maxpool_backward(x, g, 2)  # g is not 4x4-pooled
    with pytest.raises(NotImplementedError):
        pyramid.maxpool(x, 128)  # pools by 64 are ported; by 128 are not


def test_gradcheck_by_4_on_tie_free_input():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.permutation(2 * 3 * 9 * 10).reshape(2, 3, 9, 10)
                         .astype(np.float64) / 10.0).requires_grad_()
    assert torch.autograd.gradcheck(lambda t: pyramid.maxpool(t, 4), (x,))


def test_maxpool_level_equals_the_pyramid_level_and_launches_nothing():
    """On the CPU, level m alone equals level m of the plain pyramid and
    no kernel is counted."""
    x = torch.randn(2, 3, 21, 18).contiguous(memory_format=torch.channels_last)
    before = (pyramid.launches.value, pool_backward.launches.value)
    for level in (1, 2, 3, 4):
        got = pyramid.maxpool_level(x, level)
        assert torch.equal(got, pyramid.maxpool_pyramid_plain(x, level)[-1])
        assert got.is_contiguous(memory_format=torch.channels_last)
    xg = x.clone().requires_grad_()
    pyramid.maxpool(xg, 8).sum().backward()
    assert (pyramid.launches.value, pool_backward.launches.value) == before
