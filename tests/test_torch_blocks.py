"""The port's blocks against the flax modules of the JAX package, with the
same weights (random, from numpy, converted by utils/flax_to_torch.py) and
the same inputs.  float32, max-abs <= 1e-4: the repo's parity bar
(BASELINE.md)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# Every pytest-xdist worker imports this module while it collects, so this
# bounds the intra-op threads of each worker's torch: the tier-1 run's six
# workers on eight cores otherwise each start one thread a core, and the
# port's CPU tests spent most of their time contending for them.
torch.set_num_threads(min(2, torch.get_num_threads()))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.ops import blocks as jblocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict, load_flax_variables)

ATOL = 1e-4


def random_variables(module, *args, seed=0):
    """flax variables of ``module`` drawn with numpy: kernels scaled by
    fan-in, biases and BatchNorm affine non-trivial, running statistics
    away from (0, 1) so eval-mode BN is really exercised."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(size=shape).astype(np.float32) * np.float32(
                np.sqrt(2.0 / fan_in))
        if name == "var":
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        return (rng.normal(size=shape) * 0.2).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree.map(np.asarray, tree)


def nhwc_to_torch(x: np.ndarray, dtype=None):
    """NHWC numpy -> (B, C, H, W) channels_last torch view."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dtype is not None:
        t = t.to(dtype)
    return t.permute(0, 3, 1, 2)


def torch_to_nhwc(t) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) -
                                np.asarray(b, np.float32))))


def _run_pair(jmod, tmod, x, seed=0):
    variables = random_variables(jmod, jnp.asarray(x), seed=seed)
    load_flax_variables(tmod, variables)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = torch_to_nhwc(tmod.eval()(nhwc_to_torch(x)))
    assert got.shape == want.shape
    return got, want


@pytest.mark.parametrize("kernel,activation,use_bn", [
    (3, "relu", True), (1, None, False), (3, "leaky_relu", True)])
def test_convblock_matches_flax(kernel, activation, use_bn):
    x = np.random.default_rng(1).normal(size=(2, 9, 11, 5)).astype(np.float32)
    jmod = jblocks.ConvBlock(6, kernel, use_bn=use_bn, activation=activation)
    tmod = blocks.ConvBlock(5, 6, kernel, use_bn=use_bn,
                            activation=activation)
    got, want = _run_pair(jmod, tmod, x)
    assert _max_abs(got, want) <= ATOL


@pytest.mark.parametrize("size", [8, 7])
def test_transconv_matches_flax(size):
    """k4 s2 SAME transposed conv + LeakyReLU 0.3: the kernel mapping
    ``permute(3, 2, 0, 1)`` with ``padding=1`` and no flip, at an even and
    an odd input (7 -> 14)."""
    x = np.random.default_rng(2).normal(size=(2, size, size, 6)).astype(
        np.float32)
    got, want = _run_pair(jblocks.TransConv(4), blocks.TransConv(6, 4), x)
    assert got.shape == (2, 2 * size, 2 * size, 4)
    assert _max_abs(got, want) <= ATOL


@pytest.mark.parametrize("num_layers", [1, 2])
def test_denseblock_matches_flax(num_layers):
    x = np.random.default_rng(3).normal(size=(2, 6, 6, 8)).astype(np.float32)
    got, want = _run_pair(jblocks.DenseBlock(8, 3, num_layers=num_layers),
                          blocks.DenseBlock(8, 8, 3, num_layers=num_layers),
                          x)
    assert _max_abs(got, want) <= ATOL


def test_concat_matches_jax():
    rng = np.random.default_rng(4)
    a, b = (rng.normal(size=(2, 5, 5, c)).astype(np.float32) for c in (3, 4))
    got = torch_to_nhwc(blocks.concat(nhwc_to_torch(a), nhwc_to_torch(b)))
    np.testing.assert_array_equal(
        got, np.asarray(jblocks.concat(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("name", ["relu", "leaky_relu", "sigmoid", "linear"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activations_match_jax(name, dtype):
    """Same values in the activation dtype; bf16 LeakyReLU multiplies by the
    slope rounded to bf16, as JAX does."""
    x = np.random.default_rng(5).normal(size=(4, 64)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jblocks.apply_activation(jnp.asarray(x, jdt), name)
                      .astype(jnp.float32))
    got = blocks.apply_activation(torch.from_numpy(x).to(tdt), name)
    assert got.dtype == tdt
    # sigmoid's transcendental may round differently by one ulp
    tol = 0.0 if name != "sigmoid" else (1e-6 if dtype == "float32"
                                         else 2 ** -8)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_converter_layouts():
    """Conv HWIO -> OIHW and ConvTranspose (kh, kw, C_out, C_in) ->
    (C_in, C_out, kh, kw), both ``permute(3, 2, 0, 1)``; BN leaves
    renamed; 1-D leaves as they are."""
    rng = np.random.default_rng(6)
    conv = rng.normal(size=(3, 3, 5, 6)).astype(np.float32)
    tconv = rng.normal(size=(4, 4, 4, 6)).astype(np.float32)
    variables = {
        "params": {"C": {"Conv_0": {"kernel": conv, "bias": np.ones(6)},
                         "BatchNorm_0": {"scale": np.full(6, 2.0),
                                         "bias": np.zeros(6)}},
                   "T": {"ConvTranspose_0": {"kernel": tconv,
                                             "bias": np.ones(4)}}},
        "batch_stats": {"C": {"BatchNorm_0": {"mean": np.arange(6.0),
                                              "var": np.full(6, 3.0)}}},
    }
    model = torch.nn.Module()
    model.C = blocks.ConvBlock(5, 6)
    model.T = blocks.TransConv(6, 4)
    sd = flax_to_state_dict(variables, model.state_dict())
    assert sorted(sd) == sorted(model.state_dict())
    np.testing.assert_array_equal(sd["C.Conv_0.weight"].numpy()[4, 2],
                                  conv[:, :, 2, 4])
    np.testing.assert_array_equal(sd["T.ConvTranspose_0.weight"].numpy()[5, 3],
                                  tconv[:, :, 3, 5])
    np.testing.assert_array_equal(sd["C.BatchNorm_0.running_mean"].numpy(),
                                  np.arange(6.0))
    np.testing.assert_array_equal(sd["C.BatchNorm_0.weight"].numpy(),
                                  np.full(6, 2.0))


@pytest.mark.parametrize("fault", ["unmapped", "missing", "shape"])
def test_converter_refuses_incomplete_or_mismatched_trees(fault):
    model = blocks.ConvBlock(5, 6)
    variables = {"params": {"Conv_0": {"kernel": np.zeros((3, 3, 5, 6)),
                                       "bias": np.zeros(6)},
                            "BatchNorm_0": {"scale": np.ones(6),
                                            "bias": np.zeros(6)}},
                 "batch_stats": {"BatchNorm_0": {"mean": np.zeros(6),
                                                 "var": np.ones(6)}}}
    flax_to_state_dict(variables, model.state_dict())  # complete: fine
    if fault == "unmapped":
        variables["params"]["Conv_0"]["gamma"] = np.zeros(6)
    elif fault == "missing":
        del variables["batch_stats"]["BatchNorm_0"]["var"]
    else:
        variables["params"]["Conv_0"]["kernel"] = np.zeros((3, 3, 4, 6))
    with pytest.raises((KeyError, ValueError)):
        flax_to_state_dict(variables, model.state_dict())


def test_init_distributions_follow_flax():
    """he_uniform for ConvBlock kernels, lecun_normal (truncated) for
    ConvTranspose, zero biases, BN at identity: in distribution."""
    g = torch.Generator().manual_seed(0)
    cb = blocks.ConvBlock(64, 64, 3, generator=g)
    w = cb.Conv_0.weight.detach()
    lim = np.sqrt(6.0 / (9 * 64))
    assert float(w.abs().max()) <= lim
    assert abs(float(w.std()) - lim / np.sqrt(3.0)) < 0.02 * lim
    assert float(cb.Conv_0.bias.detach().abs().max()) == 0.0
    assert torch.equal(cb.BatchNorm_0.running_var, torch.ones(64))
    tc = blocks.TransConv(64, 32, generator=g)
    w = tc.ConvTranspose_0.weight.detach()
    std = np.sqrt(1.0 / (16 * 32))
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(w.abs().max()) <= 2 * std / .8796
