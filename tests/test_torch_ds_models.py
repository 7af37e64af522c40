"""UNet3+ and UNet++ with deep supervision (``ds=1``) against the JAX
``SegModel`` with converted weights: every head (``out`` and ``level1`` ..
``levelD``) in eval and training mode, the parameter trees leaf for leaf,
and three float32 train steps of UNet3+ with the deep-supervision targets
and loss weights of the JAX train verb."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.data.pyramid import (  # noqa: E402
    prepare_train_dict as jax_prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    losses as jlosses, optimizers as joptim, state as jstate)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    bce_dice_loss, default_ds_weights, make_optimizer, make_train_step)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict, load_adam_state, load_flax_variables)

W, D, SIZE = 4, 3, 32
#: (decoder, output_nums, final activation): config 3's multiclass head
#: on UNet++, the binary one on UNet3+
MODELS = [("UNet3P", 1, "sigmoid"), ("UNetPP", 4, "softmax")]


def _pair(decoder, classes, act, dtype_name):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype_name == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jm = JaxSegModel(decoder_name=decoder, model_width=W, model_depth=D,
                     output_nums=classes, ds=1, final_activation=act,
                     dtype=jdt)
    tm = SegModel(decoder, W, D, in_channels=3, output_nums=classes, ds=1,
                  final_activation=act, dtype=tdt)
    return jm, tm


def _x(seed=11):
    return np.random.default_rng(seed).uniform(size=(2, SIZE, SIZE, 3)
                                                ).astype(np.float32)


def _outputs(decoder, classes, act, dtype_name, train):
    jm, tm = _pair(decoder, classes, act, dtype_name)
    x = _x()
    variables = random_variables(jm, jnp.asarray(x), seed=3)
    load_flax_variables(tm, variables)
    if train:
        want, _ = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables,
                                                        jnp.asarray(x))
        tm.train()
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
    else:
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            variables, jnp.asarray(x))
        with torch.inference_mode():
            got = tm.eval()(torch.from_numpy(x))
    assert sorted(got) == sorted(want)  # jit returns the keys sorted
    return ({k: v.float().numpy() for k, v in got.items()},
            {k: np.asarray(v.astype(jnp.float32)) for k, v in want.items()})


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("decoder,classes,act", MODELS)
def test_ds_heads_float32_match_jax(decoder, classes, act, train):
    """W4/D3 on (2, 32, 32, 3), random BN statistics: ``out`` and every
    ``level{k}`` (UNet3+: stride-2 heads at 32 / 2**k; UNet++: full
    resolution) within 1e-4, in eval mode and in training mode (batch
    statistics)."""
    got, want = _outputs(decoder, classes, act, "float32", train)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.all(np.isfinite(got[k])), k
        assert float(np.abs(got[k] - want[k]).max()) <= 1e-4, k
        assert float(want[k].std()) > 1e-3, k  # a real signal
    if decoder == "UNet3P":
        assert [want[f"level{k}"].shape[1] for k in (1, 2, 3)] == [16, 8, 4]


@pytest.mark.parametrize("decoder,classes,act", MODELS)
def test_ds_heads_bfloat16_within_bound(decoder, classes, act):
    """The same in bf16 (eval mode).  Both sides cast at the same places,
    but the convolutions, resizes and sigmoids round their f32 sums to bf16
    at other points (UNet++ alone: 1 bf16 ulp of the output, tests/
    test_torch_segmodel.py; here up to 2 ulp, mean 0.33 ulp).  Bound for
    ``out``, a probability: max-abs <= 4 ulp on [0.5, 1) (4 * 2**-8),
    mean-abs <= 1/2 of that ulp.  The heads are raw 1x1 convs of unbounded
    scale (here up to 1.9% of the head's largest magnitude, mean 0.44%):
    max-abs <= 4% of it, mean-abs <= 1%."""
    got, want = _outputs(decoder, classes, act, "bfloat16", False)
    err = np.abs(got["out"] - want["out"])
    assert float(err.max()) <= 4 * 2 ** -8
    assert float(err.mean()) <= 2 ** -8 / 2
    for k in (1, 2, 3):
        scale = float(np.abs(want[f"level{k}"]).max())
        err = np.abs(got[f"level{k}"] - want[f"level{k}"])
        assert float(err.max()) <= 0.04 * scale, k
        assert float(err.mean()) <= 0.01 * scale, k


@pytest.mark.parametrize("decoder", ["UNet3P", "UNetPP"])
def test_ds_parameter_tree_maps_leaf_for_leaf(decoder):
    """Config 3's W32/D4 models with ``ds=1`` (benchmarks/zoo_bench.py:
    83-99): every flax leaf has a torch key of the converted shape and vice
    versa, and the parameter counts agree.  Shapes only; nothing runs."""
    jm = JaxSegModel(decoder_name=decoder, model_width=32, model_depth=4,
                     output_nums=4, ds=1, final_activation="softmax")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 256, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = SegModel(decoder, 32, 4, output_nums=4, ds=1,
                  final_activation="softmax")
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(int(np.prod(s.shape)) for s in
               jax.tree.leaves(shapes["params"])) == sum(
        p.numel() for p in tm.parameters())


LR = 1e-3


def test_unet3p_ds_train_steps_float32_match_jax():
    """Three float32 steps of UNet3+ W4/D3 with ``ds=1``, BCEDice on every
    head, ``default_ds_weights(3)`` and the ds_type ``UNet`` targets (the
    mask max-pooled by 2**k for ``level{k}``), from the same parameters,
    BatchNorm statistics and Adam state (converted after one JAX step):
    loss and every gradient within 1e-4 at each step.

    The heads have no activation, so BCE and the per-pixel dice act on raw
    conv outputs, and where one of them lands near 0 (``log(p)``, and
    ``p**2 + 1e-6`` in the dice) the gradient amplifies float32 rounding
    of the forward without bound: with random heads one such pixel makes
    JAX's jitted and op-by-op gradients differ by 9e-4.  So the converted
    heads are rescaled to give values in (0.05, 0.95), checked at every
    step, where the comparison measures the port and not that
    amplification."""
    jm, tm = _pair("UNet3P", 1, "sigmoid", "float32")
    rng = np.random.default_rng(5)
    batches = [(rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32),
                (rng.uniform(size=(2, SIZE, SIZE, 1)) > 0.6).astype(
                    np.float32)) for _ in range(4)]
    weights = default_ds_weights(D)
    assert weights == jlosses.default_ds_weights(D)

    def jtargets(y):
        return jax_prepare_train_dict(jnp.asarray(y), D, "UNet")

    variables = random_variables(jm, jnp.asarray(batches[0][0]), seed=3)
    for k in range(1, D + 1):
        head = variables["params"]["FullScaleDecoder_0"][f"level{k}"]
        head["kernel"] = head["kernel"] * np.float32(0.01)
        head["bias"] = np.full_like(head["bias"], 0.5)
    opt = joptim.make_optimizer("Adam", LR)
    state = jstate.create_train_state(jm, jax.random.PRNGKey(0),
                                      jnp.asarray(batches[0][0]), opt,
                                      variables=variables)
    step = jax.jit(jstate.make_train_step(jm, opt, jlosses.bce_dice_loss,
                                          loss_weights=weights))
    state, _, _ = step(state, jnp.asarray(batches[0][0]),
                       jtargets(batches[0][1]))

    load_flax_variables(tm, {"params": state.params,
                             "batch_stats": state.batch_stats})
    topt = make_optimizer("Adam", tm.parameters(), LR)
    adam = state.opt_state.inner_state[0]
    load_adam_state(topt, tm, adam.mu, adam.nu, int(adam.count))
    tstep = make_train_step(tm, topt, bce_dice_loss, loss_weights=weights)
    names = dict(tm.named_parameters())

    def loss_of(params, bs, x, y):
        out, _ = jm.apply({"params": params, "batch_stats": bs}, x,
                          train=True, mutable=["batch_stats"])
        out = jax.tree.map(lambda t: t.astype(jnp.float32), out)
        return jlosses.deep_supervision_loss(jlosses.bce_dice_loss, out, y,
                                             weights)

    grad_fn = jax.jit(jax.value_and_grad(loss_of))
    for x, y in batches[1:]:
        before = {k: v.clone() for k, v in tm.state_dict().items()}
        jloss, jgrads = grad_fn(state.params, state.batch_stats,
                                jnp.asarray(x), jtargets(y))
        state, jloss2, _ = step(state, jnp.asarray(x), jtargets(y))
        assert float(jloss2) == float(jloss)
        with torch.no_grad():
            heads = tm.train()(torch.from_numpy(x))
        tm.load_state_dict(before)  # undo that forward's BN update
        for k in range(1, D + 1):
            h = heads[f"level{k}"]
            assert bool(((h > 0.05) & (h < 0.95)).all()), k
        tloss, _ = tstep(torch.from_numpy(x),
                         prepare_train_dict(torch.from_numpy(y), D, "UNet"))
        assert np.isfinite(float(tloss))
        assert abs(float(jloss) - float(tloss)) <= 1e-4
        jg = flax_to_state_dict({"params": jgrads}, names)
        assert max(float(v.abs().max()) for v in jg.values()) > 1e-3
        for k, p in names.items():
            assert float((jg[k] - p.grad).abs().max()) <= 1e-4, k
