"""The port's blocks in training mode against ``jax.vjp`` of the flax
blocks with converted variables: forward output, input gradient and
parameter gradients in float32 within 1e-4 (the repo's parity bar), and
BatchNorm's new running statistics against flax's
``mutable=["batch_stats"]`` result.  Also the activation gradients at
+-0 and with the bf16 slope, against the JAX package's hand-written
VJPs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import nhwc_to_torch, random_variables, torch_to_nhwc  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.ops import blocks as jblocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict, load_flax_variables)

ATOL = 1e-4


def _train_pair(jmod, tmod, x, seed=0):
    """Forward + backward of both blocks in training mode on ``x`` with
    the same random upstream gradient.  Returns per quantity (port, JAX)
    as numpy / state_dict-keyed tensors."""
    variables = random_variables(jmod, jnp.asarray(x), seed=seed)
    load_flax_variables(tmod, variables)
    params = variables["params"]
    bs = variables.get("batch_stats")

    def f(p, xj):
        v = {"params": p}
        if bs is not None:
            v["batch_stats"] = bs
            out, upd = jmod.apply(v, xj, train=True, mutable=["batch_stats"])
            return out, upd["batch_stats"]
        return jmod.apply(v, xj, train=True), None

    y_j, vjp, new_bs = jax.vjp(f, params, jnp.asarray(x), has_aux=True)
    g = np.random.default_rng(seed + 7).normal(size=y_j.shape).astype(
        np.float32)
    dparams, dx_j = vjp(jnp.asarray(g))

    tmod.train()
    xt = nhwc_to_torch(x).detach().requires_grad_()
    y_t = tmod(xt)
    y_t.backward(nhwc_to_torch(g))
    names = dict(tmod.named_parameters())
    out = {
        "y": (torch_to_nhwc(y_t), np.asarray(y_j)),
        "dx": (torch_to_nhwc(xt.grad), np.asarray(dx_j)),
        "dparams": ({k: p.grad for k, p in names.items()},
                    flax_to_state_dict({"params": dparams}, names)),
    }
    if new_bs is not None:
        stats = {k: v for k, v in tmod.state_dict().items() if "running" in k}
        out["stats"] = (stats, flax_to_state_dict({"batch_stats": new_bs},
                                                  stats))
    return out


def _max_abs_dict(a, b):
    return max(float((a[k].detach() - b[k]).abs().max()) for k in b)


def _check(res):
    y_t, y_j = res["y"]
    assert float(np.abs(y_t - y_j).max()) <= ATOL
    dx_t, dx_j = res["dx"]
    assert float(np.abs(dx_t - dx_j).max()) <= ATOL
    assert float(np.abs(dx_j).max()) > 1e-3  # a real gradient
    assert _max_abs_dict(*res["dparams"]) <= ATOL
    if "stats" in res:
        assert _max_abs_dict(*res["stats"]) <= 1e-6


@pytest.mark.parametrize("kernel,activation", [
    (3, "relu"), (3, "leaky_relu"), (1, None)])
def test_convblock_train_matches_flax(kernel, activation):
    x = np.random.default_rng(1).normal(size=(2, 9, 11, 5)).astype(np.float32)
    _check(_train_pair(
        jblocks.ConvBlock(6, kernel, activation=activation),
        blocks.ConvBlock(5, 6, kernel, activation=activation), x))


@pytest.mark.parametrize("hw", [(8, 8), (7, 5)])
def test_transconv_train_matches_flax(hw):
    x = np.random.default_rng(2).normal(size=(2, *hw, 6)).astype(np.float32)
    _check(_train_pair(jblocks.TransConv(4),
                       blocks.TransConv(6, 4), x))


@pytest.mark.parametrize("num_layers", [1, 2])
def test_denseblock_train_matches_flax(num_layers):
    x = np.random.default_rng(3).normal(size=(2, 6, 6, 8)).astype(np.float32)
    _check(_train_pair(jblocks.DenseBlock(8, 3, num_layers=num_layers),
                       blocks.DenseBlock(8, 8, 3, num_layers=num_layers), x))


def test_batchnorm_train_statistics_match_flax():
    """flax's BatchNorm in training mode: the biased variance
    E[x**2] - E[x]**2, the running statistics advanced with momentum
    0.99; a second step starts from the first's statistics."""
    import flax.linen as nn

    x = np.random.default_rng(4).normal(1.5, 2.0, size=(3, 4, 5, 6)).astype(
        np.float32)
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    variables = random_variables(jbn, jnp.asarray(x), seed=5)
    tbn = blocks.BatchNorm(6)
    load_flax_variables(tbn, variables)
    tbn.train()
    for _ in range(2):
        y_j, upd = jbn.apply(variables, jnp.asarray(x),
                             mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        y_t = tbn(nhwc_to_torch(x))
        assert float(np.abs(torch_to_nhwc(y_t) - np.asarray(y_j)).max()) \
            <= ATOL
        got = tbn.state_dict()
        want = flax_to_state_dict(variables, got)
        for k in ("running_mean", "running_var"):
            assert float((got[k] - want[k]).abs().max()) <= 1e-6, k
    # the biased variance, not torch's unbiased one
    xf = torch.from_numpy(x).reshape(-1, 6)
    assert not torch.allclose(xf.var(0, unbiased=True), xf.var(0, unbiased=False))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["relu", "leaky_relu"])
def test_activation_gradients_match_output_residual_vjps(name, dtype):
    """d/dx of the port's ReLU / LeakyReLU equals ``_relu_outres_bwd`` /
    ``_leaky_outres_bwd`` bit for bit, at +0, -0 and with the bf16 slope
    0.30078125 (0.3 rounded to bf16) scaling negative inputs' gradients."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    x = np.array([-2.0, -0.5, -0.0, 0.0, 0.25, 3.0, -1e-3, 7.0], np.float32)
    g = np.array([1.0, -3.0, 2.0, 5.0, 0.7, -1.1, 9.0, 1.0], np.float32)
    jfn = jblocks.relu_outres if name == "relu" else jblocks.leaky_relu_outres
    y_j, vjp = jax.vjp(jfn, jnp.asarray(x, jdt))
    (dx_j,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y_t = blocks.get_activation(name)(xt)
    y_t.backward(torch.from_numpy(g).to(tdt))
    assert np.array_equal(y_t.detach().float().numpy(),
                          np.asarray(y_j.astype(jnp.float32)))
    assert np.array_equal(xt.grad.float().numpy(),
                          np.asarray(dx_j.astype(jnp.float32)))
    if name == "leaky_relu" and dtype == "bfloat16":
        assert float(xt.grad[0]) == 0.30078125
