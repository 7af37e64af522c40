"""The port's 1D max pools by 2 to 32 (``pyramid.maxpool1d_pyramid`` and
its plain version, ``maxpool1d_levels``, ``maxpool1d``; backward
``pool_backward.maxpool1d_backward``) against the JAX package's
``downsample_pool`` on (B, L, C) arrays and ``jax.vjp`` of it (XLA's
select_and_scatter routes each gradient to the first maximum of its
window).  Exact: max and the gradient's routing are bit for bit, on
inputs full of ties, with a NaN, and with lengths the windows do not
divide.  Also ``prepare_train_dict(spatial_rank=1)`` against the JAX
function.  On the CPU every call takes the plain versions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.data.pyramid import (  # noqa: E402
    prepare_train_dict as jax_prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_tpu.ops.blocks import (  # noqa: E402
    downsample_pool as jax_pool)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pool_backward, pyramid)

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def nlc_to_torch(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """(B, L, C) numpy -> the port's (B, C, 1, L) channels_last view."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).permute(
        0, 2, 1).unsqueeze(2)


def torch_to_nlc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float()[:, :, 0].permute(0, 2, 1).numpy()


def _input(shape, seed, kind, nan=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "relu":      # post-ReLU: plateaus of exact zeros
        x = np.maximum(x, 0.0)
    elif kind == "coarse":  # few distinct values: ties among nonzeros too
        x = np.round(x * 2.0) / 2.0
    if nan:
        x.reshape(-1)[x.size // 3] = np.nan
        x.reshape(-1)[x.size // 2 + 1] = np.nan
    return x


def _equal(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b))
            and np.array_equal(np.nan_to_num(a, nan=7.0),
                               np.nan_to_num(b, nan=7.0)))


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("factor", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("shape,kind", [
    ((2, 64, 3), "relu"),     # C % 8 != 0
    ((2, 37, 8), "coarse"),   # the floor cuts the tail
    ((3, 50, 1), "relu"),     # a DS mask's width
    ((2, 100, 5), "coarse"),  # three windows of 32 and a ragged tail
])
def test_pool1d_and_its_gradient_equal_jax(dtype, factor, shape, kind):
    """``downsample_pool(rank=1)`` forward and gradient bit for bit
    against JAX (the plain 1D pyramid and backward on the CPU), with two
    NaNs in the input; positions past the floor get zero gradient."""
    jdt, tdt = _DTYPES[dtype]
    x = _input(shape, factor, kind, nan=True)
    b, n, c = shape
    g = np.random.default_rng(1).normal(size=(b, n // factor, c)).astype(
        np.float32)
    y_j, vjp = jax.vjp(lambda t: jax_pool(t, factor, op="max"),
                       jnp.asarray(x, jdt))
    (dx_j,) = vjp(jnp.asarray(g, jdt))
    xt = nlc_to_torch(x, tdt).detach().requires_grad_()
    y_t = blocks.downsample_pool(xt, factor, op="max", rank=1)
    assert y_t.is_contiguous(memory_format=torch.channels_last)
    y_t.backward(nlc_to_torch(g, tdt))
    assert _equal(torch_to_nlc(y_t), np.asarray(y_j.astype(jnp.float32)))
    dx_t = torch_to_nlc(xt.grad)
    assert _equal(dx_t, np.asarray(dx_j.astype(jnp.float32)))
    assert not dx_t[:, (n // factor) * factor:].any()


def test_pool1d_avg_equals_jax():
    x = _input((2, 37, 5), 0, "normal")
    got = torch_to_nlc(blocks.downsample_pool(nlc_to_torch(x), 4, op="avg",
                                              rank=1))
    want = np.asarray(jax_pool(jnp.asarray(x), 4, op="avg"))
    assert float(np.abs(got - want).max()) <= 1e-6


@pytest.mark.parametrize("levels,wanted", [(3, None), (4, (1, 3)),
                                           (2, (2,)), (5, None), (5, (2, 5)),
                                           (5, (5,))])
def test_pool1d_levels_equal_separate_jax_pools(levels, wanted):
    """``maxpool1d_levels``: level l equals the JAX pool by 2**l, and the
    gradient of a sum over the stored levels equals ``jax.vjp`` of the
    separate pools, summed as JAX sums them (highest level first), bit
    for bit."""
    n = 45 if levels < 5 else 101  # level 5 keeps 3 windows of 32
    x = _input((2, n, 6), 3, "coarse")
    lv = list(range(1, levels + 1)) if wanted is None else list(wanted)
    rng = np.random.default_rng(4)
    gs = [rng.normal(size=(2, n >> l, 6)).astype(np.float32) for l in lv]

    def f(t):
        return [jax_pool(t, 2 ** l, op="max") for l in lv]

    ys_j, vjp = jax.vjp(f, jnp.asarray(x))
    (dx_j,) = vjp([jnp.asarray(g) for g in gs])
    xt = nlc_to_torch(x).detach().requires_grad_()
    ys_t = pyramid.maxpool1d_levels(xt, levels, wanted)
    assert len(ys_t) == len(lv)
    for y_t, y_j in zip(ys_t, ys_j):
        assert np.array_equal(torch_to_nlc(y_t), np.asarray(y_j))
    torch.autograd.backward(ys_t, [nlc_to_torch(g) for g in gs])
    assert np.array_equal(torch_to_nlc(xt.grad), np.asarray(dx_j))


def test_pool1d_levels_without_gradient_launch_no_backward():
    """A level with no gradient runs no backward; the plain versions do
    not count as launches."""
    x = nlc_to_torch(_input((2, 32, 4), 0, "relu")).requires_grad_()
    before = (pyramid.launches.value, pool_backward.launches.value)
    ys = pyramid.maxpool1d_levels(x, 3)
    ys[1].sum().backward()
    assert x.grad is not None and float(x.grad.sum()) == 2 * 8 * 4
    assert (pyramid.launches.value,
            pool_backward.launches.value) == before


def test_pool1d_plain_backward_ties_go_to_the_first_element():
    x = nlc_to_torch(np.zeros((1, 8, 2), np.float32))
    g = nlc_to_torch(np.ones((1, 2, 2), np.float32))
    dx = torch_to_nlc(pool_backward.maxpool1d_backward(x, g, 4))
    assert dx[0, :, 0].tolist() == [1, 0, 0, 0, 1, 0, 0, 0]


def test_pool1d_rejects_bad_calls():
    x = nlc_to_torch(np.zeros((1, 8, 2), np.float32))
    with pytest.raises(NotImplementedError):
        pyramid.maxpool1d(x, 3)
    with pytest.raises(NotImplementedError):
        pyramid.maxpool1d_levels(x, 7)  # a pool by 128
    with pytest.raises(NotImplementedError):
        pyramid.maxpool1d(x, 128)
    with pytest.raises(ValueError):
        pool_backward.maxpool1d_backward(x, torch.zeros(1, 2, 1, 0), 128)
    with pytest.raises(ValueError):
        pyramid.maxpool1d_pyramid(torch.zeros(1, 2, 2, 8), 1)
    with pytest.raises(ValueError):
        pool_backward.maxpool1d_backward(x, torch.zeros(1, 2, 1, 3), 2)
    with pytest.raises(ValueError):
        pyramid.route1d(x, 1)  # the kernels run on CUDA tensors
    with pytest.raises(ValueError):
        pool_backward.route1d(x, torch.zeros(1, 2, 1, 4), 2)


@pytest.mark.parametrize("ds_type", ["UNet", "UNetPP"])
@pytest.mark.parametrize("shape,depth", [((3, 64, 1), 3), ((3, 37), 3),
                                         ((3, 96, 1), 5), ((2, 77), 5)],
                         ids=["shape0", "shape1", "depth5", "depth5-ragged"])
def test_prepare_train_dict_1d_equals_jax(ds_type, shape, depth):
    """The 1D targets (one 1D pyramid call for ds_type UNet) equal the
    JAX function's, a (B, L) mask gaining its channel axis; at depth 5 the
    mask is pooled by 2 .. 32."""
    y = (np.random.default_rng(0).uniform(size=shape) > 0.6).astype(
        np.float32)
    want = jax_prepare_train_dict(jnp.asarray(y), depth, ds_type,
                                  spatial_rank=1)
    got = prepare_train_dict(torch.from_numpy(y), depth, ds_type,
                             spatial_rank=1)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(w)), k
