"""The max pools by 64 in both ranks against the JAX package, on the CPU
(where every pool is the kernels' plain version):

- level 6 of one ``maxpool_levels`` / ``maxpool1d_levels`` call and the
  pools by 64 (``pyramid.maxpool``, ``pyramid.maxpool1d``) with their
  gradients against ``lax.reduce_window`` and ``jax.vjp`` (XLA's
  select_and_scatter walks the whole window of 64 x 64, or 64, in
  row-major order), bit for bit, on ragged sizes, plateaus of ties and
  NaN windows, and a tie across two quarters of a 2D window;
- the 1D models that pool by 64 (UNet3P and MLMRSNet_V2 at depth 7,
  UNet4P at depth 8) at W2 on (2, 256, 2) signals against JAX's
  ``model_selector_1d`` with converted random variables, every head
  within 1e-4 of max(1, its size) (``assert_deep_forward_matches_jax``);
- one train step of the 1D UNet3P at depth 6 with ``d_s = 1``, whose
  targets pool the mask by 2 .. 64 (``assert_1d_model_matches_jax``:
  the port's float64 step within 1e-6 of JAX's float64 step, its float32
  step within 1e-4 or the relative bar).

The 2D models are in test_torch_pools_by_64_2d.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_deep_pools_1d import (  # noqa: E402
    assert_deep_forward_matches_jax)
from test_torch_pool1d import _equal, nlc_to_torch, torch_to_nlc  # noqa: E402
from test_torch_pool_factors import _check as check_pool_by  # noqa: E402
from test_torch_pool_factors import _input  # noqa: E402
from test_torch_pyramid_levels import (  # noqa: E402
    _DTYPES, _cotangents, _jax, _port)
from test_torch_recurrent_1d import assert_1d_model_matches_jax  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.ops.blocks import (  # noqa: E402
    downsample_pool as jax_pool)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pool_backward, pyramid)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("kind", ["relu", "nan"])
def test_level_6_of_one_call_and_its_gradient_equal_jax(dtype, kind):
    """``maxpool_levels(x, 6)``: every level equals the JAX pool by 2**l
    and dx for a cotangent on each level equals ``jax.vjp`` of the
    separate pools, bit for bit (130 x 70: the floor cuts 2 rows and 6
    columns at 64)."""
    jdt, tdt = _DTYPES[dtype]
    x = _input((2, 130, 70, 3), 6, kind)
    grads = _cotangents(x, 6, seed=2)
    y_t, dx_t = _port(x, 6, tdt, grads)
    y_j, dx_j = _jax(x, 6, jdt, grads)
    assert [y.shape[1:3] for y in y_t][-1] == (2, 1)
    for a, b in zip(y_t, y_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dx_t, dx_j)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("kind", ["relu", "coarse", "nan"])
def test_pool_by_64_and_its_gradient_equal_jax(dtype, kind):
    """``pyramid.maxpool(·, 64)`` (level 6 alone, and ``maxpool_backward``
    with window 64) against ``jax.vjp`` of the JAX ``downsample_pool``,
    ragged (the floor cuts 2 rows and 6 columns)."""
    dx = check_pool_by(_input((2, 130, 70, 2), 64, kind), 64, dtype)
    assert float(np.abs(dx[:, 128:]).max()) == 0.0  # the rows cut off
    assert float(np.abs(dx[:, :, 64:]).max()) == 0.0


def test_pool_by_64_routes_a_tie_across_quarters_in_row_major_order():
    """Ones at (40, 0) and (3, 50) of a zero 64 x 64 window, in two of its
    32 x 32 quarters: the walk keeps (3, 50), which comes first in
    row-major order; a fold of the quarters in order would keep (40, 0)."""
    x = np.zeros((1, 64, 64, 1), np.float32)
    x[0, 40, 0, 0] = x[0, 3, 50, 0] = 1.0
    dx = check_pool_by(x, 64, "float32")
    assert np.argwhere(dx[0, :, :, 0] != 0).tolist() == [[3, 50]]


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("shape,kind", [((2, 200, 3), "relu"),
                                        ((3, 130, 1), "coarse"),
                                        ((2, 63, 8), "relu")])
def test_pool1d_by_64_and_its_gradient_equal_jax(dtype, shape, kind):
    """``downsample_pool(rank=1)`` by 64 forward and gradient bit for bit
    against JAX, with two NaNs: ragged tails and a signal shorter than a
    window (no output, a zero gradient)."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(64)
    x = rng.normal(size=shape).astype(np.float32)
    x = np.maximum(x, 0.0) if kind == "relu" else np.round(x * 2.0) / 2.0
    x.reshape(-1)[x.size // 3] = x.reshape(-1)[x.size // 2 + 1] = np.nan
    b, n, c = shape
    g = rng.normal(size=(b, n // 64, c)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda t: jax_pool(t, 64, op="max"),
                       jnp.asarray(x, jdt))
    (dx_j,) = vjp(jnp.asarray(g, jdt))
    xt = nlc_to_torch(x, tdt).detach().requires_grad_()
    y_t = blocks.downsample_pool(xt, 64, op="max", rank=1)
    y_t.backward(nlc_to_torch(g, tdt))
    assert _equal(torch_to_nlc(y_t), np.asarray(y_j.astype(jnp.float32)))
    dx_t = torch_to_nlc(xt.grad)
    assert _equal(dx_t, np.asarray(dx_j.astype(jnp.float32)))
    assert not dx_t[:, (n // 64) * 64:].any()


def test_pool1d_levels_to_6_equal_separate_jax_pools():
    """``maxpool1d_levels(x, 6)`` on 200 samples: each level equals the JAX
    pool by 2**l and dx for a cotangent on each equals ``jax.vjp`` of the
    separate pools, bit for bit, on ReLU plateaus with a NaN."""
    rng = np.random.default_rng(66)
    x = np.maximum(rng.normal(size=(2, 200, 3)), 0.0).astype(np.float32)
    x[1, 77, 2] = np.nan
    gs = [rng.normal(size=(2, 200 >> lvl, 3)).astype(np.float32)
          for lvl in range(1, 7)]
    ys, vjp = jax.vjp(lambda t: [jax_pool(t, 2 ** lvl, op="max")
                                 for lvl in range(1, 7)], jnp.asarray(x))
    (dx_j,) = vjp([jnp.asarray(g) for g in gs])
    xt = nlc_to_torch(x).detach().requires_grad_()
    got = pyramid.maxpool1d_levels(xt, 6)
    torch.autograd.backward(got, [nlc_to_torch(g) for g in gs])
    for a, b in zip(got, ys):
        assert _equal(torch_to_nlc(a), np.asarray(b))
    assert _equal(torch_to_nlc(xt.grad), np.asarray(dx_j))


@pytest.mark.parametrize("arch,depth,level", [
    ("UNet3P", 7, 6), ("MLMRSNet_V2", 7, 6), ("UNet4P", 8, 6)])
def test_1d_models_that_pool_by_64_equal_jax(arch, depth, level):
    assert_deep_forward_matches_jax(arch, depth, level=level, width=2)


def test_1d_unet3p_d6_ds_train_step_equals_jax():
    """UNet3P at depth 6 with ``d_s = 1`` at W2: the train verb's targets
    pool the mask to level 6; no pool launches a kernel on the CPU."""
    before = (pyramid.launches.value, pool_backward.launches.value)
    assert_1d_model_matches_jax("UNet3P", 2, 6, length=256, ds=1)
    assert (pyramid.launches.value, pool_backward.launches.value) == before
