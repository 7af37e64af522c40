"""The port's recurrent 1D archs (RUNet, R2UNet, R2UNetPP, R2UNet3P) and
their ``RecurrentConvBlock`` against the JAX package, with the same
variables (random, from numpy, converted by utils/flax_to_torch.py):

- ``RecurrentConvBlock`` at t = 1, 2, 3 on (B, L, C) arrays in eval and
  training mode (output, every input's and parameter's gradient within
  1e-4, the new running statistics within 1e-5);
- each arch at W4/D2-3 on (2, 32, 2) signals with the options on and
  off (``d_s``, ``a_g``, ``lstm``, ``is_transconv``, kernel 3 and 4,
  ``t``): every leaf mapped, the parameter counts equal, every head in
  eval mode within 1e-4, and one float32 ``make_train_step``
  (MeanAbsoluteError, the DS heads weighted by ``default_ds_weights``)
  against JAX's step in float64 (``assert_1d_model_matches_jax``): the
  loss within 1e-4 and every gradient, in units of the larger of its
  size and 1, within 1e-4 or, where the port misses that, within four
  times JAX's own float32 step's distance from its float64 step (the
  relative bar: JAX's own is 6e-4 off on R2UNet with t = 3, whose
  recurrent concats chain many convolutions; at W4 a BatchNorm over 16
  samples of one channel amplifies rounding); the port's float64 step
  against JAX's within 1e-6 shows the arithmetic is the same; the new
  running statistics within 1e-5;
- the flax auto-names of R2UNet3P's quirks (a plain ConvBlock on the
  same-level tap, a 1x1 ConvBlock and one RecurrentConvBlock on an
  earlier step's output)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402
from test_torch_config2_models import _grad_capture, scale_kernels  # noqa: E402
from test_torch_specials_1d import _pair, _x  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.data.pyramid import (  # noqa: E402
    prepare_train_dict as jax_prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.api_1d import (  # noqa: E402
    model_selector_1d as jax_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.ops import blocks as jblocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    losses as jlosses, state as jstate)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    model_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    default_ds_weights, get_loss, make_optimizer, make_train_step)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

ATOL = 1e-4
L = 32
#: the ds_type whose targets fit an arch's heads: the chains' and the
#: UNet3+-type level k at L / 2**k, the grids' at L
GRIDS = ("UNetE", "UNetP", "UNetPP", "UNet4P", "R2UNetPP", "ConvMixerUNetE",
         "ConvMixerUNetP", "ConvMixerUNetPP", "SelfR2UNetPP", "SelfUNetPP")


def build_1d(arch, W, D, kernel=3, length=L, **kw):
    """The JAX and the port's model of ``arch`` on two-channel signals."""
    return (jax_selector_1d(arch, length, D, 2, W, kernel, **kw),
            model_selector_1d(arch, length, D, 2, W, kernel, **kw))


def assert_1d_model_matches_jax(arch, W, D, kernel=3, length=L,
                                x_scale=1.0, kernel_scale=1.0, **kw):
    """The bar of this slice's 1D models: ``arch`` built by both
    packages' ``model_selector_1d`` (``kw``: its options) on (2,
    ``length``, 2) signals with random variables: every torch key filled
    from a flax leaf and the parameter counts equal; every head in eval
    mode within 1e-4 of JAX's float64 forward (compiled in one program
    with JAX's float64 step); one training step of the port in float64 against
    JAX's in float64, the loss and every gradient within 1e-6 of max(1,
    its size); the port's float32 step against JAX's float64 one: the
    loss within 1e-4, every gradient within ``bar`` of max(1, its size),
    the new running statistics within 1e-5.  ``bar`` is 1e-4 or, where
    the port misses it, four times the largest such distance of JAX's
    own float32 step from its float64 step (the relative bar).  The
    signals are normal times ``x_scale``, the random kernels scaled by
    ``kernel_scale`` (the Self-ONN archs' cubes overflow otherwise).
    Returns the port's model."""
    jm, tm = build_1d(arch, W, D, kernel, length, **kw)
    ds = kw.get("ds", 0)
    ds_type = "UNetPP" if arch in GRIDS else "UNet"
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, length, 2)) * x_scale).astype(np.float32)
    y = (rng.uniform(size=(2, length, 1)) > 0.6).astype(np.float32)
    variables = scale_kernels(random_variables(jm, jnp.asarray(x), seed=3),
                              kernel_scale)
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(v.size for v in jax.tree.leaves(variables["params"])) == sum(
        p.numel() for p in tm.parameters())
    tm.load_state_dict(sd)
    weights = default_ds_weights(D) if ds else None

    def jax_step(dtype, with_eval=False):
        with jax.enable_x64(dtype == jnp.float64):
            def cast(tree):
                return jax.tree.map(lambda a: np.asarray(a).astype(dtype), tree)

            jy = (jax_prepare_train_dict(jnp.asarray(y), D, ds_type,
                                         spatial_rank=1)
                  if ds else jnp.asarray(y))
            step_model = jm.clone(dtype=dtype)
            state = jstate.create_train_state(
                step_model, jax.random.PRNGKey(0), cast(x), _grad_capture(),
                variables=cast(variables))
            step = jstate.make_train_step(
                step_model, _grad_capture(),
                jlosses.get_loss("MeanAbsoluteError"), loss_weights=weights)

            def both(state, xs, ys):
                # the eval forward and the step, one compiled program
                out = (step_model.apply({"params": state.params,
                                         "batch_stats": state.batch_stats},
                                        xs, train=False)
                       if with_eval else None)
                return out, step(state, xs, ys)

            out, (state, loss, _) = jax.jit(both)(state, cast(x), cast(jy))
            return float(loss), jax.tree.map(
                lambda a: np.asarray(a).astype(np.float32), (state, out))

    jloss, (state, want) = jax_step(jnp.float64, with_eval=True)
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x))
    assert sorted(got) == sorted(want) and len(got) == 1 + D * ds
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1.0)
        assert float(np.abs(got[key].numpy() - w).max()) <= ATOL * scale, key
    assert float(want["out"].std()) > 1e-3
    ty = (prepare_train_dict(torch.from_numpy(y), D, ds_type, spatial_rank=1)
          if ds else torch.from_numpy(y))

    def port_step(model):
        params = dict(model.named_parameters())
        loss, _ = make_train_step(model, make_optimizer(
            "Adam", params.values(), 1e-3), get_loss("MeanAbsoluteError"),
            weights)(torch.from_numpy(x), ty)
        return float(loss), params

    # the same step in float64: the port's arithmetic is JAX's
    tm64 = model_selector_1d(arch, length, D, 2, W, kernel,
                             dtype=torch.float64, **kw)
    tm64.load_state_dict(sd)
    loss64, names64 = port_step(tm64)
    assert abs(jloss - loss64) <= 1e-6
    names = dict(tm.named_parameters())
    jg = flax_to_state_dict({"params": state.opt_state}, names)

    def scaled(a, b):  # |a - b| in units of max(1, |b|)
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)

    for key, p in names64.items():
        assert scaled(p.grad.float(), jg[key]) <= 1e-6, key

    tloss, names = port_step(tm)
    assert abs(jloss - tloss) <= ATOL
    assert max(float(v.abs().max()) for v in jg.values()) > 1e-3
    assert all(p.grad is not None for p in names.values())
    bar = ATOL
    if any(scaled(p.grad, jg[k]) > bar for k, p in names.items()):
        # the relative bar: four times JAX's own float32 step's distance
        # from its float64 step (computed only where 1e-4 is missed)
        jg32 = flax_to_state_dict({"params": jax_step(jnp.float32)[1][0]
                                   .opt_state}, names)
        bar = max(ATOL, 4 * max(scaled(jg32[k], jg[k]) for k in names))
    for key, p in names.items():
        assert scaled(p.grad, jg[key]) <= bar, (key, bar)
    stats = {k: v for k, v in tm.state_dict().items() if "running" in k}
    js = flax_to_state_dict({"batch_stats": state.batch_stats}, stats)
    for key, v in stats.items():
        assert float((js[key] - v).abs().max()) <= 1e-5, key
    return tm


@pytest.mark.parametrize("t", [1, 2, 3])
def test_recurrent_conv_block_equals_flax(t):
    """t ConvBlocks each concatenated with the block's input, then a
    last one: ConvBlock_0 .. ConvBlock_t."""
    tmod = blocks.RecurrentConvBlock(3, 4, 3, t=t, rank=1)
    assert sorted(n for n, _ in tmod.named_children()) == [
        f"ConvBlock_{i}" for i in range(t + 1)]
    _pair(jblocks.RecurrentConvBlock(4, 3, t=t), tmod, [_x((2, 16, 3))])


#: (arch, W, D, options)
CASES = [
    ("RUNet", 4, 3, dict()),
    ("RUNet", 4, 2, dict(ds=1, ag=1, lstm=1, is_transconv=False,
                         kernel=4, t=1)),
    ("R2UNet", 4, 3, dict(ds=1)),
    ("R2UNet", 4, 2, dict(ag=1, lstm=1, is_transconv=False, t=3)),
    ("R2UNetPP", 4, 2, dict(ds=1, ag=1)),
    ("R2UNetPP", 4, 3, dict(lstm=1, is_transconv=False, kernel=4)),
    ("R2UNet3P", 4, 3, dict(ds=1)),
    ("R2UNet3P", 4, 2, dict(ag=1, lstm=1, is_transconv=False, kernel=4,
                            t=1)),
]


def _ids(c):
    return f"{c[0]}-W{c[1]}D{c[2]}-" + "-".join(
        f"{k}{int(v)}" for k, v in c[3].items())


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_recurrent_arch_float32_matches_jax(case):
    arch, W, D, kw = case
    assert_1d_model_matches_jax(arch, W, D, **kw)


def test_flax_auto_names_of_r2unet3p():
    """At D2 the FullScaleDecoder creates, per step j: a plain ConvBlock
    on the same-level tap, an r2 node (a 1x1 ConvBlock and 2 recurrent
    blocks) per pooled tap and on the previous output, at j = 1 a 1x1
    ConvBlock and one recurrent block on step 0's output, then the r2
    node of width W * (D + 1): 4 ConvBlocks and 6 recurrent blocks at j
    = 0, 4 and 5 at j = 1."""
    tm = model_selector_1d("R2UNet3P", 32, 2, 1, 4, 3)
    jm = jax_selector_1d("R2UNet3P", 32, 2, 1, 4, 3)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 1)))["params"]
    dec = params["FullScaleDecoder_0"]
    assert sorted(n for n, _ in tm.FullScaleDecoder_0.named_children()) == \
        sorted(dec)
    assert sorted(n for n, _ in tm.named_children()) == sorted(params)
    kinds = [n.rsplit("_", 1)[0] for n, _ in
             tm.FullScaleDecoder_0.named_children()]
    assert kinds.count("ConvBlock") == 8 and \
        kinds.count("RecurrentConvBlock") == 11
