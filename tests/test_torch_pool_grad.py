"""The port's 2x2 max pool gradient (``pyramid.maxpool(x, 2)``, backward
``pool_backward.maxpool_backward``) against ``jax.vjp`` of the JAX
package's ``downsample_pool`` (lax.reduce_window; XLA's select_and_scatter
routes each gradient to the first maximum of its window).  Exact: the
gradient is a routing of the upstream values, so both sides must agree
bit for bit, on inputs full of ties."""
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


def _jax_pool_and_grad(x, g, jdt):
    y, vjp = jax.vjp(lambda t: jax_pool(t, 2, op="max"), jnp.asarray(x, jdt))
    (dx,) = vjp(jnp.asarray(g, jdt))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)))


def _port_pool_and_grad(x, g, tdt):
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).detach()
    xt.requires_grad_()
    y = blocks.downsample_pool(xt, 2, op="max")
    y.backward(torch.from_numpy(g).to(tdt).permute(0, 3, 1, 2))
    return (y.detach().float().permute(0, 2, 3, 1).numpy(),
            xt.grad.float().permute(0, 2, 3, 1).numpy())


def _plateau_input(shape, seed, kind):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "relu":      # post-ReLU: plateaus of exact zeros
        x = np.maximum(x, 0.0)
    elif kind == "coarse":  # few distinct values: ties among nonzeros too
        x = np.round(x * 2.0) / 2.0
    elif kind == "bf16dup":  # distinct in f32, duplicates once in bf16
        x = (1.0 + rng.integers(0, 3, size=shape) * 2.0 ** -7
             + rng.uniform(0, 2.0 ** -10, size=shape)).astype(np.float32)
    return x


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("kind", ["relu", "coarse", "bf16dup"])
@pytest.mark.parametrize("shape", [
    (2, 8, 8, 3),     # C % 8 != 0
    (2, 9, 7, 8),     # odd H and W: the floor cuts a row and a column
    (1, 6, 10, 16),
    (3, 5, 5, 1),
])
def test_pool_grad_equals_jax_vjp(dtype, kind, shape):
    jdt, tdt = _DTYPES[dtype]
    x = _plateau_input(shape, 0, kind)
    b, h, w, c = shape
    g = np.random.default_rng(1).normal(size=(b, h // 2, w // 2, c)).astype(
        np.float32)
    y_j, dx_j = _jax_pool_and_grad(x, g, jdt)
    y_t, dx_t = _port_pool_and_grad(x, g, tdt)
    assert np.array_equal(y_t, y_j)
    assert np.array_equal(dx_t, dx_j)
    if h % 2:
        assert not dx_t[:, -1].any()  # the row the floor cuts off
    if w % 2:
        assert not dx_t[:, :, -1].any()


def test_tied_window_routes_to_the_first_element():
    """A 2x2 window of zeros with an upstream gradient of 1: XLA gives
    [1, 0, 0, 0]; ``amax``'s autograd would give [0.25] * 4."""
    x = torch.zeros(1, 1, 2, 2, requires_grad=True)
    pyramid.maxpool(x, 2).sum().backward()
    assert x.grad.flatten().tolist() == [1.0, 0.0, 0.0, 0.0]
    _, dx_j = _jax_pool_and_grad(np.zeros((1, 2, 2, 1), np.float32),
                                 np.ones((1, 1, 1, 1), np.float32),
                                 jnp.float32)
    assert dx_j.flatten().tolist() == [1.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("window", [
    [np.nan, 1, 2, 3], [1, np.nan, 2, 0], [1, 2, np.nan, 0],
    [3, 2, 1, np.nan], [np.nan, np.nan, 1, 1], [2, np.nan, 2, np.nan]])
def test_nan_windows_route_as_xla(window):
    """With a NaN in the window XLA's select walks on (``!(sel >= e)``):
    the port routes the gradient to the same element."""
    x = np.asarray(window, np.float32).reshape(1, 2, 2, 1)
    g = np.ones((1, 1, 1, 1), np.float32)
    _, dx_j = _jax_pool_and_grad(x, g, jnp.float32)
    _, dx_t = _port_pool_and_grad(x, g, torch.float32)
    assert np.array_equal(dx_t, dx_j)


def test_gradcheck_on_tie_free_input():
    """``torch.autograd.gradcheck`` in float64 on distinct values (the
    pool is smooth away from ties), odd H and W included."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.permutation(2 * 3 * 5 * 7).reshape(2, 3, 5, 7)
                         .astype(np.float64) / 10.0).requires_grad_()
    assert torch.autograd.gradcheck(lambda t: pyramid.maxpool(t, 2), (x,))


def test_plain_backward_takes_any_layout_and_dtype_pair():
    """The plain backward accepts a contiguous (NCHW) gradient and returns
    channels_last; a gradient of another dtype or shape is refused."""
    x = torch.randn(2, 4, 6, 6).contiguous(memory_format=torch.channels_last)
    g = torch.randn(2, 4, 3, 3)
    dx = pool_backward.maxpool_backward(x, g, 2)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(dx, pool_backward.maxpool_backward_plain(
        x.contiguous(), g, 2))
    # each window's gradient lands on exactly one element
    assert torch.equal(dx.reshape(2, 4, 3, 2, 3, 2).sum(dim=(3, 5)), g)
    with pytest.raises(TypeError):
        pool_backward.maxpool_backward(x, g.double(), 2)
    with pytest.raises(ValueError):
        pool_backward.maxpool_backward(x, g[:, :, :2], 2)


def test_cpu_pool_launches_no_kernel():
    before = (pyramid.launches.value, pool_backward.launches.value)
    x = torch.randn(1, 2, 4, 4, requires_grad=True)
    pyramid.maxpool(x, 2).sum().backward()
    assert (pyramid.launches.value, pool_backward.launches.value) == before
