"""``pyramid.maxpool_levels`` (the pools by 2, 4, .., 2**m of one tensor
from one pyramid launch, each with XLA's gradient) against the JAX
package's ``downsample_pool`` per level and ``jax.vjp`` of those separate
pools; and UNet3+'s ``FullScaleDecoder``, which takes every pooled tap of a
skip from one such call.  The CUDA kernels themselves are held against the
plain version on the card, in tests/test_torch_cuda.py."""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.ops.blocks import (  # noqa: E402
    downsample_pool as jax_pool)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    decoders)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pool_backward, pyramid)

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _input(shape, seed, kind):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if kind in ("relu", "nan"):  # post-ReLU: plateaus of exact zeros
        x = np.maximum(x, 0.0)
    if kind == "nan":  # NaNs planted in some windows of every level
        x.reshape(-1)[rng.choice(x.size, max(x.size // 40, 1),
                                 replace=False)] = np.nan
    return x


def _port(x, levels, tdt, grads=None):
    """maxpool_levels of NHWC ``x`` (as a channels_last NCHW tensor); with
    ``grads`` (one NHWC cotangent or None per level), also dx."""
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).detach()
    xt.requires_grad_(grads is not None)
    ys = pyramid.maxpool_levels(xt, levels)
    nhwc = [y.detach().float().permute(0, 2, 3, 1).numpy() for y in ys]
    if grads is None:
        return nhwc, None
    used = [(y, torch.from_numpy(g).to(tdt).permute(0, 3, 1, 2))
            for y, g in zip(ys, grads) if g is not None]
    torch.autograd.backward([y for y, _ in used], [g for _, g in used])
    return nhwc, xt.grad.float().permute(0, 2, 3, 1).numpy()


def _jax(x, levels, jdt, grads):
    """The separate reduce_window pools by 2**l and jax.vjp of all of them
    (a zero cotangent for a level without a gradient)."""
    def pools(t):
        return [jax_pool(t, 2 ** lvl, op="max")
                for lvl in range(1, levels + 1)]

    ys, vjp = jax.vjp(pools, jnp.asarray(x, jdt))
    cts = [jnp.zeros_like(y) if g is None else jnp.asarray(g, jdt)
           for y, g in zip(ys, grads)]
    (dx,) = vjp(cts)
    return ([np.asarray(y.astype(jnp.float32)) for y in ys],
            np.asarray(dx.astype(jnp.float32)))


def _cotangents(x, levels, seed):
    b, h, w, c = x.shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h >> lvl, w >> lvl, c)).astype(np.float32)
            for lvl in range(1, levels + 1)]


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("shape,levels", [((2, 37, 53, 3), 4),
                                          ((2, 32, 32, 16), 3),
                                          ((3, 13, 6, 1), 2)])
def test_levels_forward_equals_jax_pool_per_level(shape, levels, dtype):
    """Level l of one call == the JAX ``downsample_pool`` by 2**l, bit for
    bit, with a planted NaN and ragged edges (VALID floor truncation)."""
    jdt, tdt = _DTYPES[dtype]
    x = _input(shape, levels, "normal")
    x.reshape(-1)[x.size // 3] = np.nan
    got, _ = _port(x, levels, tdt)
    assert len(got) == levels
    for lvl, g in enumerate(got, 1):
        want = np.asarray(jax_pool(jnp.asarray(x, jdt), 2 ** lvl,
                                   op="max").astype(jnp.float32))
        assert g.shape == want.shape
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("kind", ["relu", "nan"])
@pytest.mark.parametrize("shape,levels", [((2, 37, 53, 3), 3),
                                          ((2, 16, 16, 8), 4)])
def test_levels_gradient_equals_jax_vjp(shape, levels, kind, dtype):
    """dx for a random cotangent per level == ``jax.vjp`` of the separate
    pools, bit for bit.  An element routed at one level gets that one
    gradient.  One routed at several levels (the first maximum of a 4x4
    window is often that of its 2x2 window too) gets a sum, and float
    addition depends on its order: the port adds the levels from the
    highest down, the order in which jax.vjp's transpose adds the pools'
    cotangents, so the sums agree too (adding from the lowest up differs
    by 4.8e-7 in float32 and by one bf16 ulp on these inputs)."""
    jdt, tdt = _DTYPES[dtype]
    x = _input(shape, levels, kind)
    grads = _cotangents(x, levels, seed=1)
    y_t, dx_t = _port(x, levels, tdt, grads)
    y_j, dx_j = _jax(x, levels, jdt, grads)
    for a, b in zip(y_t, y_j):
        np.testing.assert_array_equal(a, b)
    # how many levels route a gradient to each element: sums must occur
    routed = sum(_jax(x, levels, jnp.float32,
                      [np.ones_like(g) if k == lvl else None
                       for k, g in enumerate(grads)])[1] != 0
                 for lvl in range(levels))
    assert routed.max() >= 2
    np.testing.assert_array_equal(dx_t, dx_j)


def test_level_without_gradient_launches_no_backward():
    """``set_materialize_grads(False)``: a level whose output takes no part
    in the loss calls ``maxpool_backward`` for no level; the others call it
    once each, with their own window."""
    x = torch.randn(2, 3, 16, 16).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    with mock.patch.object(pyramid, "maxpool_backward",
                           wraps=pool_backward.maxpool_backward) as spy:
        ys = pyramid.maxpool_levels(x, 3)
        (ys[0].sum() + 2.0 * ys[2].sum()).backward()
        assert sorted(c.args[2] for c in spy.call_args_list) == [2, 8]
        spy.reset_mock()
        x.grad = None
        pyramid.maxpool_levels(x, 3)[1].sum().backward()
        assert [c.args[2] for c in spy.call_args_list] == [4]
    want = pyramid.maxpool_pyramid_plain(x.detach(), 3)[1]
    assert float(x.grad.sum()) == float(want.numel())
    with pytest.raises(NotImplementedError):
        pyramid.maxpool_levels(x, 7)  # level 6 is ported; 7 is not


def test_full_scale_decoder_pools_each_skip_once():
    """UNet3+ at D=4: one ``maxpool_levels`` call per pooled skip (skips 0,
    1, 2 to levels 3, 2, 1) and no single-level pool; on the CPU no kernel
    is counted."""
    W, D = 2, 4
    dec = decoders.FullScaleDecoder(W, D, generator=torch.Generator()
                                    .manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    skips = [torch.randn(1, W * 2 ** k, 32 >> k, 32 >> k, generator=gen)
             .contiguous(memory_format=torch.channels_last)
             for k in range(D)]
    skips.append(torch.randn(1, W * 2 ** D, 2, 2, generator=gen)
                 .contiguous(memory_format=torch.channels_last))
    before = (pyramid.launches.value, pool_backward.launches.value)
    with mock.patch.object(pyramid, "maxpool_levels",
                           wraps=pyramid.maxpool_levels) as levels, \
            mock.patch.object(pyramid, "maxpool",
                              wraps=pyramid.maxpool) as single, \
            mock.patch.object(blocks, "downsample_pool",
                              wraps=blocks.downsample_pool) as pool:
        out, heads = dec(skips)
    assert [c.args[1] for c in levels.call_args_list] == [3, 2, 1]
    assert all(c.args[0] is skips[k]
               for k, c in enumerate(levels.call_args_list))
    assert single.call_count == 0 and pool.call_count == 0
    assert tuple(out.shape) == (1, W * (D + 1), 32, 32) and heads == []
    assert (pyramid.launches.value, pool_backward.launches.value) == before
