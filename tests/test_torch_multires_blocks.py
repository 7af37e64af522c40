"""The MultiRes family's blocks and the attention gate against the flax
blocks with converted variables: ``MultiResBlock`` (with ``alpha`` 1 and
1.67), ``ResPath`` and the 2D ``AttentionGate``, in eval mode and in
training mode (``jax.vjp``: output, every input's gradient and every
parameter's gradient in float32 within 1e-4, and BatchNorm's new running
statistics within 1e-5).  Also the branch widths the blocks truncate to,
and the gate's output layout."""
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


def _pair(jmod, tmod, inputs, seed):
    """Eval and training mode of both blocks on the NHWC ``inputs`` with
    the same random variables and upstream gradient.  Returns per quantity
    (port, JAX)."""
    jx = [jnp.asarray(x) for x in inputs]
    variables = random_variables(jmod, *jx, seed=seed)
    sd = flax_to_state_dict(variables, tmod.state_dict())
    assert sorted(sd) == sorted(tmod.state_dict())
    tmod.load_state_dict(sd)
    out = {}
    with torch.no_grad():
        y = tmod.eval()(*[nhwc_to_torch(x) for x in inputs])
    out["eval"] = (torch_to_nhwc(y), np.asarray(jmod.apply(variables, *jx)))

    def f(p, *xs):
        y, upd = jmod.apply({"params": p,
                             "batch_stats": variables["batch_stats"]},
                            *xs, train=True, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y_j, vjp, new_bs = jax.vjp(f, variables["params"], *jx, has_aux=True)
    g = np.random.default_rng(seed + 7).normal(size=y_j.shape).astype(
        np.float32)
    dparams, *dx_j = vjp(jnp.asarray(g))
    xt = [nhwc_to_torch(x).detach().requires_grad_() for x in inputs]
    y_t = tmod.train()(*xt)
    y_t.backward(nhwc_to_torch(g))
    names = dict(tmod.named_parameters())
    stats = {k: v for k, v in tmod.state_dict().items() if "running" in k}
    out["train"] = (torch_to_nhwc(y_t), np.asarray(y_j))
    out["dx"] = [(torch_to_nhwc(t.grad), np.asarray(d))
                 for t, d in zip(xt, dx_j)]
    out["dparams"] = ({k: p.grad for k, p in names.items()},
                      flax_to_state_dict({"params": dparams}, names))
    out["stats"] = (stats, flax_to_state_dict({"batch_stats": new_bs}, stats))
    out["y"] = y_t
    return out


def _max_abs(a, b):
    return max(float((a[k].detach() - b[k]).abs().max()) for k in b)


def _check(res):
    for mode in ("eval", "train"):
        got, want = res[mode]
        assert got.shape == want.shape, mode
        assert float(np.abs(got - want).max()) <= ATOL, mode
        assert float(want.std()) > 1e-2, mode  # a real signal
    for got, want in res["dx"]:
        assert float(np.abs(got - want).max()) <= ATOL
        assert float(np.abs(want).max()) > 1e-3  # a real gradient
    assert _max_abs(*res["dparams"]) <= ATOL
    assert _max_abs(*res["stats"]) <= 1e-5


@pytest.mark.parametrize("width,alpha,want", [
    (8, 1.0, (1, 2, 4)), (32, 1.0, (5, 10, 16)), (32, 1.67, (8, 17, 26)),
    (512, 1.0, (85, 170, 256)), (2, 1.0, (1, 1, 1))])
def test_multires_widths_match_flax(width, alpha, want):
    """The branch widths, truncated and clamped at 1, are the flax
    block's: its ConvBlock_1..3 kernels have them as output channels."""
    assert blocks.multires_widths(width, alpha) == want
    assert blocks.multires_features(width, alpha) == sum(want)
    shapes = jax.eval_shape(
        jblocks.MultiResBlock(width, 3, alpha=alpha).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3)))["params"]
    assert tuple(shapes[f"ConvBlock_{k}"]["Conv_0"]["kernel"].shape[-1]
                 for k in (1, 2, 3)) == want
    assert shapes["ConvBlock_0"]["Conv_0"]["kernel"].shape[-1] == sum(want)


@pytest.mark.parametrize("width,alpha", [(8, 1.0), (8, 1.67), (16, 1.0)])
def test_multires_block_matches_flax(width, alpha):
    """W=8 gives 1 + 2 + 4 = 7 channels, W=16 2 + 5 + 8 = 15, alpha 1.67
    at W=8 2 + 4 + 6 = 12: odd and even widths from an odd input."""
    x = np.random.default_rng(1).normal(size=(2, 10, 12, 5)).astype(
        np.float32)
    tmod = blocks.MultiResBlock(5, width, 3, alpha=alpha)
    res = _pair(jblocks.MultiResBlock(width, 3, alpha=alpha), tmod, [x],
                seed=2)
    assert res["y"].shape[1] == tmod.out_features == blocks.multires_features(
        width, alpha)
    _check(res)


@pytest.mark.parametrize("length", [0, 1, 3])
def test_res_path_matches_flax(length):
    """``max(length, 1)`` units; the first reads the input's 7 channels,
    every unit is 8 wide."""
    x = np.random.default_rng(3).normal(size=(2, 8, 9, 7)).astype(np.float32)
    tmod = blocks.ResPath(7, length, 8, 3)
    assert sum(n.startswith("BatchNorm_")
               for n, _ in tmod.named_children()) == max(length, 1)
    _check(_pair(jblocks.ResPath(length, 8, 3), tmod, [x], seed=4))


@pytest.mark.parametrize("skip_hw,skip_c,gate_c,features", [
    ((8, 10), 4, 8, 4), ((12, 6), 7, 15, 5)])
def test_attention_gate_matches_flax(skip_hw, skip_c, gate_c, features):
    """The gate (at half the skip's resolution) and the skip both get
    their gradients; the output keeps the skip's channels."""
    rng = np.random.default_rng(5)
    skip = rng.normal(size=(2, *skip_hw, skip_c)).astype(np.float32)
    gate = rng.normal(size=(2, skip_hw[0] // 2, skip_hw[1] // 2,
                            gate_c)).astype(np.float32)
    tmod = blocks.AttentionGate(skip_c, gate_c, features)
    res = _pair(jblocks.AttentionGate(features), tmod, [skip, gate], seed=6)
    assert tuple(res["y"].shape) == (2, skip_c, *skip_hw)
    assert res["y"].is_contiguous(memory_format=torch.channels_last)
    _check(res)


def test_attention_gate_output_is_channels_last_whatever_the_map_layout(
        monkeypatch):
    """A one-channel map has the same memory in NCHW and channels_last,
    so a convolution may hand it back with either strides (cuDNN's
    transposed conv on the card); the gated skip stays channels_last and
    equal.  Here the transposed conv's output is given NCHW strides."""
    rng = np.random.default_rng(7)
    skip = nhwc_to_torch(rng.normal(size=(2, 8, 8, 6)).astype(np.float32))
    gate = nhwc_to_torch(rng.normal(size=(2, 4, 4, 12)).astype(np.float32))
    gated = blocks.AttentionGate(6, 12, 6, generator=torch.Generator()
                                 .manual_seed(0)).eval()
    with torch.no_grad():
        want = gated(skip, gate)
    forward = blocks.TransConv.forward

    def nchw(self, x):
        y = forward(self, x)
        out = torch.empty_strided(y.shape, (y[0].numel(), y[0].numel(),
                                            y.shape[3], 1), dtype=y.dtype)
        return out.copy_(y)

    monkeypatch.setattr(blocks.TransConv, "forward", nchw)
    with torch.no_grad():
        got = gated(skip, gate)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
