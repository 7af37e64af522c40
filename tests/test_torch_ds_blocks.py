"""The pieces the deep-supervision slice adds, against the JAX package on
the same numpy inputs: bilinear ``upsample`` (UNet3+'s resize), the
softmax head, ``CategoricalCrossentropy``, and the target pyramid
``prepare_train_dict`` (one pyramid launch on the card; the plain version
here)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.data.pyramid import (  # noqa: E402
    prepare_train_dict as jax_prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_tpu.ops import (  # noqa: E402
    blocks as jblocks)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    losses as jlosses)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pyramid)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import losses  # noqa: E402


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _upsample_pair(x, g, factor, jdt, tdt):
    y, vjp = jax.vjp(lambda t: jblocks.upsample(t, factor, "bilinear"),
                     jnp.asarray(x, jdt))
    (dx,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).requires_grad_()
    yt = blocks.upsample(xt, factor, "bilinear")
    assert yt.is_contiguous(memory_format=torch.channels_last)
    yt.backward(torch.from_numpy(g).to(tdt).permute(0, 3, 1, 2))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return ((f32(y), yt.detach().float().permute(0, 2, 3, 1).numpy()),
            (f32(dx), xt.grad.float().permute(0, 2, 3, 1).numpy()))


def _upsample_inputs(factor, shape=(2, 5, 7, 3)):
    rng = np.random.default_rng(factor)
    x = rng.normal(size=shape).astype(np.float32) * 2.0
    b, h, w, c = shape
    g = rng.normal(size=(b, h * factor, w * factor, c)).astype(np.float32)
    return x, g


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_float32_matches_jax(factor):
    """``F.interpolate(bilinear, align_corners=False)`` against
    ``jax.image.resize(bilinear)``, edges included: the forward and the
    gradient within 1e-6 (the sample weights agree; the sums round in
    another order)."""
    (y_j, y_t), (dx_j, dx_t) = _upsample_pair(
        *_upsample_inputs(factor), factor, jnp.float32, torch.float32)
    assert y_t.shape == y_j.shape
    assert float(np.abs(y_t - y_j).max()) <= 1e-6
    assert float(np.abs(dx_t - dx_j).max()) <= 1e-6 * max(
        1.0, float(np.abs(dx_j).max()))


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_bfloat16_within_one_ulp(factor):
    """The same in bf16.  An output is a weighted sum of up to four inputs
    that the two frameworks form in another order before rounding to bf16;
    where the terms cancel, the outputs differ by more than one ulp of
    their own small magnitude, but never by more than one bf16 ulp (2**-7
    of the magnitude's power of two) of the largest input.  Likewise the
    gradient sums factor**2 upstream values per input: held to one bf16
    ulp of the largest gradient."""
    x, g = _upsample_inputs(factor)
    (y_j, y_t), (dx_j, dx_t) = _upsample_pair(x, g, factor, jnp.bfloat16,
                                              torch.bfloat16)
    assert float(np.abs(y_t - y_j).max()) <= float(
        _bf16_ulp(np.abs(x).max()))
    assert float(np.abs(dx_t - dx_j).max()) <= float(
        _bf16_ulp(np.abs(dx_j).max()))


def test_softmax_head_and_its_gradient_match_jax():
    """Softmax over the channels (NCHW dim 1, the JAX NHWC last axis):
    values and gradients within 1e-6."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 6, 4)) * 3).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    fn = jblocks.get_activation("softmax")
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    yt = blocks.apply_activation(xt, "softmax")
    yt.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    assert float(np.abs(yt.detach().permute(0, 2, 3, 1).numpy()
                        - np.asarray(y)).max()) <= 1e-6
    assert float(np.abs(xt.grad.permute(0, 2, 3, 1).numpy()
                        - np.asarray(dx)).max()) <= 1e-6


@pytest.mark.parametrize("source", ["softmax", "raw"])
def test_categorical_crossentropy_and_its_gradient_match_jax(source):
    """Keras CCE on probabilities (normalized by the channel sum, clipped):
    value and gradient w.r.t. the prediction within 1e-6, on softmax
    outputs and on unnormalized positive maps with the clip's edges."""
    rng = np.random.default_rng(1)
    t = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 5, 6))]
    p = rng.uniform(size=(2, 5, 6, 4)).astype(np.float32)
    if source == "softmax":
        p = np.asarray(jax.nn.softmax(jnp.asarray(p * 6.0), axis=-1))
    else:
        p.reshape(-1, 4)[0] = [1.0, 0.0, 0.0, 0.0]  # clipped at both ends
    want, jgrad = jax.value_and_grad(
        lambda q: jlosses.get_loss("CategoricalCrossentropy")(
            jnp.asarray(t), q))(jnp.asarray(p))
    pt = torch.tensor(p, requires_grad=True)
    got = losses.get_loss("CategoricalCrossentropy")(torch.from_numpy(t), pt)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    assert float(np.abs(pt.grad.numpy() - np.asarray(jgrad)).max()) <= 1e-6


@pytest.mark.parametrize("ds_type", ["UNet", "UNetPP"])
@pytest.mark.parametrize("shape,depth", [((2, 32, 24, 1), 3),
                                         ((2, 19, 23), 2)])
def test_prepare_train_dict_equals_jax(ds_type, shape, depth):
    """The same keys, shapes and values, exactly; a (B, H, W) mask gains a
    channel axis, and ragged levels floor as the JAX pools do."""
    mask = (np.random.default_rng(4).uniform(size=shape) > 0.6).astype(
        np.float32)
    want = jax_prepare_train_dict(jnp.asarray(mask), depth, ds_type,
                                  spatial_rank=2)
    before = pyramid.launches.value
    got = prepare_train_dict(torch.from_numpy(mask), depth, ds_type)
    assert pyramid.launches.value == before  # plain version on the CPU
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_prepare_train_dict_refuses_an_unknown_ds_type():
    with pytest.raises(ValueError, match="ds_type"):
        prepare_train_dict(torch.zeros(1, 8, 8, 1), 2, "UNet3P")
    with pytest.raises(ValueError, match="ds_type"):
        jax_prepare_train_dict(jnp.zeros((1, 8, 8, 1)), 2, "UNet3P")
