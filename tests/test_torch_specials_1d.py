"""The port's 1D special families against the JAX package, with the same
variables (random, from numpy, converted by utils/flax_to_torch.py):

- the new blocks on (B, L, C) arrays, in eval mode and in training mode
  (``jax.vjp``: output, every input's and every parameter's gradient in
  float32 within 1e-4, BatchNorm's new running statistics within 1e-5):
  ``SqueezeExcite``, ``ConvLSTMCell`` (its unapplied ``recurrent_kernel``
  gets a zero gradient, as optax's), ``ConvLSTMFusion``, ``BiConvLSTM``,
  ``DenseConcatBlock``, ``RIBlock`` (with its tiny-width projection) and
  ``AttentionLSTMGate``;
- BCDUNet, SEDUNet, IBAUNet and NABNet at W8/D2-3 on (2, 32, 2) signals,
  with ``d_s``, ``a_g``, ``lstm`` and ``is_transconv`` on and off: every
  leaf mapped, the parameter counts equal, every head in eval mode
  (against JAX's float64 forward, compiled with its step), and one
  float32 ``make_train_step`` (MeanAbsoluteError, the DS heads
  weighted by ``default_ds_weights``) against JAX's step in float64: its
  loss within 1e-4, every gradient within 1e-4 (of its size where that
  is above 1), the new running statistics within 1e-5;
- BASELINE config 5's full-width trees (W32/D3) leaf for leaf;
- what JAX refuses, refused alike: NABNet's full-length DS heads under
  ds_type UNet, NABNet with nearest upsampling; ``ae = 1`` without the
  signals' length."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402
from test_torch_config2_models import _grad_capture  # noqa: E402
from test_torch_pool1d import nlc_to_torch, torch_to_nlc  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.data.pyramid import (  # noqa: E402
    prepare_train_dict as jax_prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    specials_1d as jspecials)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.api_1d import (  # noqa: E402
    model_selector_1d as jax_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.ops import blocks as jblocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    losses as jlosses, state as jstate)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    model_selector_1d, specials_1d)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    default_ds_weights, get_loss, make_optimizer, make_train_step)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

ATOL = 1e-4
L = 32


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(jmod, tmod, inputs, train_arg=True, seed=0, rngs=None):
    """Both blocks on the (B, L, C) ``inputs`` with the same variables, in
    eval mode and in training mode with the same upstream gradient;
    asserts the bar.  ``train_arg``: the flax block takes ``train``;
    ``rngs`` go to its training-mode ``apply``."""
    jx = [jnp.asarray(x) for x in inputs]
    variables = dict(random_variables(jmod, *jx, seed=seed))
    sd = flax_to_state_dict(variables, tmod.state_dict())
    assert sorted(sd) == sorted(tmod.state_dict())
    tmod.load_state_dict(sd)
    stats = variables.get("batch_stats", {})
    with torch.no_grad():
        y = tmod.eval()(*[nlc_to_torch(x) for x in inputs])
    want = np.asarray(jax.jit(jmod.apply)(variables, *jx))
    assert torch_to_nlc(y).shape == want.shape
    assert float(np.abs(torch_to_nlc(y) - want).max()) <= ATOL
    assert float(want.std()) > 1e-2

    def f(p, xs, g):
        kw = dict(train=True, mutable=["batch_stats"]) if train_arg else {}
        if rngs is not None:
            kw["rngs"] = rngs
        out = jmod.apply({"params": p, "batch_stats": stats}, *xs, **kw)
        y, upd = out if train_arg else (out, {"batch_stats": {}})
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
    names = dict(tmod.named_parameters())
    jg = flax_to_state_dict({"params": dparams}, names)
    for k, p in names.items():
        assert p.grad is not None, k
        assert float((jg[k] - p.grad).abs().max()) <= ATOL, k
    run = {k: v for k, v in tmod.state_dict().items() if "running" in k}
    js = flax_to_state_dict({"batch_stats": new_bs}, run) if run else {}
    for k, v in run.items():
        assert float((js[k] - v).abs().max()) <= 1e-5, k
    return tmod


@pytest.mark.parametrize("channels,ratio", [(16, 8), (6, 8)])
def test_squeeze_excite_equals_flax(channels, ratio):
    """Dense layers to max(C // ratio, 1) and back; 6 // 8 clamps to 1."""
    _pair(jblocks.SqueezeExcite(ratio=ratio),
          blocks.SqueezeExcite(channels, ratio), [_x((2, 12, channels))],
          train_arg=False)


def test_conv_lstm_cell_equals_flax_with_a_zero_recurrent_gradient():
    tmod = _pair(jblocks.ConvLSTMCell(5), blocks.ConvLSTMCell(6, 5),
                 [_x((2, 16, 6))], train_arg=False)
    assert tmod.recurrent_kernel.shape == (20, 5, 1, 3)
    assert float(tmod.recurrent_kernel.grad.abs().max()) == 0.0


def test_conv_lstm_fusion_equals_flax():
    _pair(jblocks.ConvLSTMFusion(3), blocks.ConvLSTMFusion(7, 3),
          [_x((2, 16, 4), 1), _x((2, 16, 3), 2)], train_arg=False)


@pytest.mark.parametrize("kernel", [3, 4])
def test_bi_conv_lstm_equals_flax(kernel):
    """Two steps each way with shared convs: the recurrent conv's gradient
    is real, and the output is [h_fwd, h_bwd]."""
    tmod = _pair(jblocks.BiConvLSTM(3, kernel),
                 blocks.BiConvLSTM(4, 3, kernel), [_x((2, 16, 4), 1),
                                                   _x((2, 16, 4), 2)],
                 train_arg=False)
    assert float(tmod.recurrent_conv.weight.grad.abs().max()) > 1e-3


def test_dense_concat_block_equals_flax():
    tmod = specials_1d.DenseConcatBlock(3, 4, 3, num_layers=2)
    assert tmod.out_features == 11
    _pair(jspecials.DenseConcatBlock(4, 3, num_layers=2), tmod,
          [_x((2, 16, 3))])


@pytest.mark.parametrize("features", [8, 12, 2])
def test_ri_block_equals_flax(features):
    """Branches ceil(f/6), floor(f/3), int(f/2); f = 2 gives 1 + 1 + 1
    and the bare 1x1 projection to 2."""
    tmod = specials_1d.RIBlock(3, features)
    assert tmod.project == (features == 2)
    _pair(jspecials.RIBlock(features), tmod, [_x((2, 16, 3))])


def test_ri_widths_at_config5():
    assert [sum(specials_1d.ri_widths(f)[1:]) for f in (32, 64, 128, 256)] \
        == [32, 64, 128, 256]
    assert specials_1d.ri_widths(256)[1:] == (43, 85, 128)


@pytest.mark.parametrize("length", [16, 18])
def test_attention_lstm_gate_equals_flax(length):
    _pair(jspecials.AttentionLSTMGate(4, lstm_features=2),
          specials_1d.AttentionLSTMGate(4, 6, 4, 2),
          [_x((2, length, 4), 1), _x((2, length, 6), 2)])


#: (arch, W, D, ds, ag, lstm, transconv, kernel)
CASES = [
    ("BCDUNet", 8, 3, 0, 0, 1, 1, 3), ("BCDUNet", 8, 2, 1, 1, 1, 0, 3),
    ("BCDUNet", 8, 2, 0, 1, 0, 1, 4),
    ("SEDUNet", 8, 3, 1, 0, 0, 1, 3), ("SEDUNet", 8, 2, 0, 1, 1, 0, 3),
    ("IBAUNet", 8, 3, 0, 1, 0, 1, 3), ("IBAUNet", 8, 2, 1, 0, 0, 0, 3),
    ("NABNet", 8, 3, 0, 0, 0, 1, 3), ("NABNet", 8, 2, 1, 1, 1, 1, 3),
]


def _ids(c):
    return (f"{c[0]}-W{c[1]}D{c[2]}-ds{c[3]}-ag{c[4]}-lstm{c[5]}-tc{c[6]}"
            f"-k{c[7]}")


def _models(arch, W, D, ds, ag, lstm, tc, k, length=L):
    kw = dict(ds=ds, ag=ag, lstm=lstm, is_transconv=bool(tc), dense_loop=2,
              se_ratio=4)
    return (jax_selector_1d(arch, length, D, 2, W, k, **kw),
            model_selector_1d(arch, length, D, 2, W, k, **kw))


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_special_1d_float32_matches_jax(case):
    arch, W, D, ds = case[:4]
    jm, tm = _models(*case)
    # the chains' and IBAUNet's level k at L / 2**k, NABNet's at L
    ds_type = "UNetPP" if arch == "NABNet" else "UNet"
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, L, 2)).astype(np.float32)
    y = (rng.uniform(size=(2, L, 1)) > 0.6).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), seed=3)
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(v.size for v in jax.tree.leaves(variables["params"])) == sum(
        p.numel() for p in tm.parameters())
    tm.load_state_dict(sd)

    # JAX's step in float64: at W8 the RIBlocks' branches are 2 wide and
    # the depth-3 chains deep enough that JAX's own float32 step is off
    # the exact gradients by more than the bar (as for the one-channel
    # MultiRes branches of tests/test_torch_config4_models.py); the
    # port's float32 step meets it against the float64 one
    weights = default_ds_weights(D) if ds else None
    with jax.enable_x64(True):
        def cast(tree):
            return jax.tree.map(lambda a: np.asarray(a).astype(jnp.float64), tree)

        jy = (jax_prepare_train_dict(jnp.asarray(y), D, ds_type,
                                     spatial_rank=1) if ds else jnp.asarray(y))
        step_model = jm.clone(dtype=jnp.float64)
        state = jstate.create_train_state(step_model, jax.random.PRNGKey(0),
                                          cast(x), _grad_capture(),
                                          variables=cast(variables))
        step = jstate.make_train_step(step_model, _grad_capture(),
                                      jlosses.get_loss("MeanAbsoluteError"),
                                      loss_weights=weights)

        def both(state, xs, ys):
            # the eval forward and the step, one compiled program
            return step_model.apply({"params": state.params,
                                     "batch_stats": state.batch_stats},
                                    xs, train=False), step(state, xs, ys)

        want, (state, jloss, _) = jax.jit(both)(state, cast(x), cast(jy))
        jloss = float(jloss)
        state, want = jax.tree.map(
            lambda a: np.asarray(a).astype(np.float32), (state, want))

    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x))
    assert sorted(got) == sorted(want) and len(got) == 1 + D * ds
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert float(np.abs(got[key].numpy() - w).max()) <= ATOL, key
    assert float(want["out"].std()) > 1e-3

    ty = (prepare_train_dict(torch.from_numpy(y), D, ds_type, spatial_rank=1)
          if ds else torch.from_numpy(y))
    names = dict(tm.named_parameters())
    tloss, _ = make_train_step(tm, make_optimizer("Adam", names.values(),
                                                  1e-3),
                               get_loss("MeanAbsoluteError"), weights)(
        torch.from_numpy(x), ty)
    assert abs(float(jloss) - float(tloss)) <= ATOL
    jg = flax_to_state_dict({"params": state.opt_state}, names)
    assert max(float(v.abs().max()) for v in jg.values()) > 1e-3
    for key, p in names.items():
        # every parameter has a gradient, zero where JAX's is (the
        # ConvLSTM cells' recurrent kernels, a gate nothing reads); a
        # gradient larger than 1 is held to 1e-4 of its size (float32
        # carries 6e-8 of it a rounding, and SEDUNet's and NABNet's
        # first weights reach 8-12 at D3)
        assert p.grad is not None, key
        scale = max(float(jg[key].abs().max()), 1.0)
        assert float((jg[key] - p.grad).abs().max()) <= ATOL * scale, key
    stats = {k: v for k, v in tm.state_dict().items() if "running" in k}
    js = flax_to_state_dict({"batch_stats": state.batch_stats}, stats)
    for key, v in stats.items():
        assert float((js[key] - v).abs().max()) <= 1e-5, key


CONFIG5 = {"BCDUNet": dict(lstm=1, dense_loop=2),
           "SEDUNet": dict(se_ratio=8), "NABNet": dict(dense_loop=2),
           "IBAUNet": dict(ag=1)}


@pytest.mark.parametrize("arch", sorted(CONFIG5))
def test_config5_full_width_tree_maps_leaf_for_leaf(arch):
    """BASELINE config 5's size (W32 D3 L1024, one channel): every flax
    leaf has its torch tensor of the converted shape, no torch key is left
    over, and the parameter counts are equal (``jax.eval_shape``)."""
    jm = jax_selector_1d(arch, 1024, 3, 1, 32, 3, **CONFIG5[arch])
    tm = model_selector_1d(arch, 1024, 3, 1, 32, 3, **CONFIG5[arch])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1024, 1)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_state_dict(dict(zeros), tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        shapes["params"])) == sum(p.numel() for p in tm.parameters())


def test_flax_auto_names_of_bcdunet():
    tm = model_selector_1d("BCDUNet", 64, 2, 1, 8, 3, lstm=1, ag=1, ds=1)
    jm = jax_selector_1d("BCDUNet", 64, 2, 1, 8, 3, lstm=1, ag=1, ds=1)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 1)))["params"]
    assert sorted(n for n, _ in tm.named_children()) == sorted(params)
    assert "ConvLSTMFusion_1" in params and "level2" in params


def test_nabnet_ds_heads_need_ds_type_unetpp():
    """NABNet's DS heads are all full length (named level D .. 1): the
    pooled ds_type UNet targets do not fit them, and the step fails in
    both packages; under UNetPP the losses match (the test above)."""
    jm, tm = _models("NABNet", 4, 2, 1, 0, 0, 1, 3, length=16)
    x = _x((2, 16, 2))
    y = (_x((2, 16, 1), 1) > 0).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), seed=1)
    tm.load_state_dict(flax_to_state_dict(variables, tm.state_dict()))
    state = jstate.create_train_state(jm, jax.random.PRNGKey(0), x,
                                      _grad_capture(), variables=variables)
    step = jstate.make_train_step(jm, _grad_capture(),
                                  jlosses.get_loss("MeanAbsoluteError"),
                                  loss_weights=default_ds_weights(2))
    with pytest.raises((TypeError, ValueError)):
        jax.jit(step)(state, jnp.asarray(x),
             jax_prepare_train_dict(jnp.asarray(y), 2, "UNet",
                                    spatial_rank=1))
    with pytest.raises(RuntimeError, match="size of tensor"):
        make_train_step(tm, make_optimizer("Adam", tm.parameters(), 1e-3),
                        get_loss("MeanAbsoluteError"),
                        default_ds_weights(2))(
            torch.from_numpy(x),
            prepare_train_dict(torch.from_numpy(y), 2, "UNet",
                               spatial_rank=1))


def test_nabnet_with_nearest_upsampling_fails_in_both():
    jm = jax_selector_1d("NABNet", 16, 2, 1, 4, 3, is_transconv=False)
    with pytest.raises(Exception):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 1)))
    with pytest.raises(ValueError, match="is_transconv"):
        model_selector_1d("NABNet", 16, 2, 1, 4, 3, is_transconv=False)


@pytest.mark.parametrize("arch", sorted(CONFIG5))
def test_specials_refuse_ae(arch):
    """``ae = 1`` is built from the signals' length (the bottleneck's
    Dense is sized by it): without one the family refuses it; through
    ``model_selector_1d`` (which passes ``length``) it builds
    ``FeatureExtractionBlock_0`` (tests/test_torch_zoo_1d.py holds it to
    JAX)."""
    with pytest.raises(ValueError, match="ae = 1"):
        getattr(specials_1d, arch)(4, 2, ae=1)
    tm = model_selector_1d(arch, 32, 2, 1, 4, 3, ae=1, feature_number=8)
    assert tm.FeatureExtractionBlock_0.features.out_features == 8


def test_bfloat16_special_forward_is_bf16_and_finite():
    tm = model_selector_1d("SEDUNet", 64, 2, 1, 8, 3, ds=1, lstm=1,
                           dtype=torch.bfloat16)
    out = tm.train()(torch.randn(2, 64, 1))
    assert all(v.dtype == torch.bfloat16 and bool(torch.isfinite(v).all())
               for v in out.values())
    assert sorted(out) == ["level1", "level2", "out"]
    fresh = tm.reinitialized(torch.Generator().manual_seed(3))
    assert sorted(fresh.state_dict()) == sorted(tm.state_dict())
