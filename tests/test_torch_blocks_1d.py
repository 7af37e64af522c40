"""The port's rank-1 blocks against the flax blocks on (B, L, C) arrays,
with the same variables (random, from numpy, converted by
utils/flax_to_torch.py): ``ConvBlock`` with odd and even kernels (flax's
uneven SAME padding), the 1D ``TransConv`` (2-wide, BatchNorm, ReLU),
``AttentionGate(dialect="1d")``, ``MultiResBlock(multiplier)`` and
``ResPath``, in eval mode and in training mode (``jax.vjp``: output, every
input's gradient and every parameter's gradient in float32 within 1e-4,
BatchNorm's new running statistics within 1e-5)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402
from test_torch_pool1d import nlc_to_torch, torch_to_nlc  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.ops import blocks as jblocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

ATOL = 1e-4


def _pair(jmod, tmod, inputs, seed=0):
    """Both blocks, eval and training mode, on the (B, L, C) ``inputs``
    with the same variables and upstream gradient; asserts the bar."""
    jx = [jnp.asarray(x) for x in inputs]
    variables = random_variables(jmod, *jx, seed=seed)
    sd = flax_to_state_dict(variables, tmod.state_dict())
    assert sorted(sd) == sorted(tmod.state_dict())
    tmod.load_state_dict(sd)
    with torch.no_grad():
        y = tmod.eval()(*[nlc_to_torch(x) for x in inputs])
    want = np.asarray(jax.jit(jmod.apply)(variables, *jx))
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch_to_nlc(y).shape == want.shape
    assert float(np.abs(torch_to_nlc(y) - want).max()) <= ATOL
    assert float(want.std()) > 1e-2

    def f(p, xs, g):
        y, upd = jmod.apply({"params": p,
                             "batch_stats": variables["batch_stats"]},
                            *xs, train=True, mutable=["batch_stats"])
        # the gradient of sum(y * g) is the VJP of g
        return jnp.sum(y * g), (y, upd["batch_stats"])

    shape = jax.eval_shape(lambda p, xs: f(p, xs, 0.0)[1][0],
                           variables["params"], jx).shape
    g = np.random.default_rng(seed + 7).normal(size=shape).astype(np.float32)
    (dparams, dx_j), (y_j, new_bs) = jax.jit(jax.grad(
        f, argnums=(0, 1), has_aux=True))(variables["params"], jx,
                                          jnp.asarray(g))
    xt = [nlc_to_torch(x).detach().requires_grad_() for x in inputs]
    y_t = tmod.train()(*xt)
    y_t.backward(nlc_to_torch(g))
    assert float(np.abs(torch_to_nlc(y_t) - np.asarray(y_j)).max()) <= ATOL
    for t, d in zip(xt, dx_j):
        assert float(np.abs(torch_to_nlc(t.grad) - np.asarray(d)).max()) \
            <= ATOL
        assert float(np.abs(np.asarray(d)).max()) > 1e-3
    names = dict(tmod.named_parameters())
    jg = flax_to_state_dict({"params": dparams}, names)
    for k, p in names.items():
        assert float((jg[k] - p.grad).abs().max()) <= ATOL, k
    stats = {k: v for k, v in tmod.state_dict().items() if "running" in k}
    js = flax_to_state_dict({"batch_stats": new_bs}, stats)
    for k, v in stats.items():
        assert float((js[k] - v).abs().max()) <= 1e-5, k


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kernel", [1, 3, 4, 5])
def test_conv_block_1d_equals_flax(kernel):
    """k = 4 pads 1 before and 2 after, as flax's SAME does."""
    _pair(jblocks.ConvBlock(6, kernel), blocks.ConvBlock(3, 6, kernel,
                                                         rank=1),
          [_x((2, 17, 3))])


def test_trans_conv_1d_equals_flax():
    """The 2-wide stride-2 transposed conv, BatchNorm and ReLU: output 2i
    + t is input i times tap t (no flip of the converted kernel)."""
    _pair(jblocks.TransConv(5, kernel=2, use_bn=True, activation="relu"),
          blocks.TransConv(4, 5, dialect="1d"), [_x((2, 9, 4))])


@pytest.mark.parametrize("length", [16, 24])
def test_attention_gate_1d_equals_flax(length):
    """The 1D gate: a strided 1x1 conv on the skip (positions 0, 2, ..),
    nearest upsampling and the 1D TransConv."""
    _pair(jblocks.AttentionGate(4, dialect="1d"),
          blocks.AttentionGate(4, 6, 4, dialect="1d"),
          [_x((2, length, 4), 1), _x((2, length // 2, 6), 2)])


@pytest.mark.parametrize("multiplier,alpha", [(1, 1.0), (2, 1.0), (4, 1.67)])
def test_multires_block_1d_equals_flax(multiplier, alpha):
    """Branch widths truncate before the multiplier: W = 8 gives (1, 2, 4)
    x ``multiplier`` at alpha 1."""
    tmod = blocks.MultiResBlock(3, 8, 3, alpha=alpha, multiplier=multiplier,
                                rank=1)
    assert tmod.out_features == blocks.multires_features(8, alpha,
                                                         multiplier)
    if alpha == 1.0:
        assert tmod.out_features == 7 * multiplier
    _pair(jblocks.MultiResBlock(8, 3, alpha=alpha, multiplier=multiplier),
          tmod, [_x((2, 16, 3))])


@pytest.mark.parametrize("length,kernel", [(1, 3), (2, 4)])
def test_res_path_1d_equals_flax(length, kernel):
    _pair(jblocks.ResPath(length, 6, kernel),
          blocks.ResPath(5, length, 6, kernel, rank=1), [_x((2, 16, 5))])


def test_nearest_upsample_1d_is_a_repeat():
    x = _x((2, 5, 3))
    got = torch_to_nlc(blocks.upsample(nlc_to_torch(x), 4, method="nearest",
                                       rank=1))
    want = np.asarray(jblocks.upsample(jnp.asarray(x), 4, method="nearest"))
    assert np.array_equal(got, want)
