"""BASELINE config 2's decoders (UNet, UNetE, UNetP) against the JAX
``SegModel`` with converted weights, with and without deep supervision
and with and without transposed convs: the converter maps every flax leaf
and leaves no torch key unfilled, every head matches in eval mode, and
one float32 training step gives JAX's ``make_train_step`` loss, gradients
and BatchNorm statistics."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.data.pyramid import (  # noqa: E402
    prepare_train_dict as jax_prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    losses as jlosses, state as jstate)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    bce_dice_loss, default_ds_weights, make_optimizer, make_train_step)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

W, D, SIZE = 4, 3, 32
#: the decoder module's flax name and the ds_type whose targets fit its
#: heads: the chain's level k sits at SIZE / 2**k, the grids' at SIZE
DECODERS = {"UNet": ("ChainDecoder_0", "UNet"),
            "UNetE": ("GridDecoder_0", "UNetPP"),
            "UNetP": ("GridDecoder_0", "UNetPP"),
            "UNetPP": ("GridDecoder_0", "UNetPP")}
CASES = [(name, ds, tc) for name in ("UNet", "UNetE", "UNetP")
         for ds in (0, 1) for tc in (1, 0)] + [("UNetPP", 0, 0)]


def _grad_capture() -> optax.GradientTransformation:
    """An optax transformation whose state is the last gradient and whose
    update is zero: ``make_train_step`` then hands back its own gradient
    in ``opt_state``.  The initial state is numpy zeros: an eager
    ``jnp.zeros_like`` compiles once per parameter shape."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(np.zeros_like, params),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))


def _models(name, ds, tc):
    jm = JaxSegModel(decoder_name=name, model_width=W, model_depth=D,
                     output_nums=1, ds=ds, is_transconv=bool(tc),
                     final_activation="sigmoid")
    tm = SegModel(name, W, D, in_channels=3, output_nums=1, ds=ds,
                  is_transconv=bool(tc), final_activation="sigmoid")
    return jm, tm


def scale_kernels(variables, factor):
    """``variables`` with every kernel scaled by ``factor``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a * np.float32(factor)
        if path[-1].key == "kernel" else a, variables)


def assert_model_matches_jax(jm, tm, ds, module, ds_type, depth=D,
                             size=SIZE, step_dtype=jnp.float32, heads=None,
                             kernel_scale=1.0, relative=False):
    """The bar every ported model is held to: ``jm`` (JAX ``SegModel``)
    and ``tm`` (the port's) on (2, size, size, 3) with random parameters
    and BN statistics: the converter fills every torch key from a flax
    leaf and the parameter counts agree; in eval mode ``out`` and every
    ``level{k}`` within 1e-4 of JAX's forward in ``step_dtype`` (one
    compiled program with its step); one float32 training step of the port
    (BCEDice on every head, weighted by ``default_ds_weights``, the
    targets of ``ds_type``, the decoder ``module``'s heads scaled into
    (0.05, 0.95), as tests/test_torch_ds_models.py explains) gives the
    loss and every gradient of JAX's ``make_train_step`` within 1e-4 and
    its new BatchNorm statistics within 1e-5.  JAX's step computes in
    ``step_dtype``: float64 (under ``jax.enable_x64``) where JAX's own
    float32 step is off the exact one by more than the bar.

    ``heads(params)`` gives the deep-supervision heads' parameter dicts
    (default: ``level1`` .. ``level{depth}`` of ``module``);
    ``kernel_scale`` scales every random kernel (the Self-ONN models'
    cubes overflow at the default draw).  ``relative``: each gradient and
    running statistic within its bar times its size where that is above
    1 (a trainable backbone's first convolutions sum their gradients over
    every pixel, and a float32 step rounds them in proportion)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(2, size, size, 3)).astype(np.float32)
    y = (rng.uniform(size=(2, size, size, 1)) > 0.6).astype(np.float32)
    variables = scale_kernels(random_variables(jm, jnp.asarray(x), seed=3),
                              kernel_scale)
    for head in ((heads or (lambda p: [p[module][f"level{k}"] for k in
                                       range(1, depth + 1)]))(
            variables["params"]) if ds else ()):
        head["kernel"] = head["kernel"] * np.float32(0.01)
        head["bias"] = np.full_like(head["bias"], 0.5)
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(v.size for v in jax.tree.leaves(variables["params"])) == sum(
        p.numel() for p in tm.parameters())
    tm.load_state_dict(sd)

    weights = default_ds_weights(depth) if ds else None
    with jax.enable_x64(step_dtype == jnp.float64):
        def cast(tree):
            return jax.tree.map(lambda a: np.asarray(a).astype(step_dtype), tree)

        jy = (jax_prepare_train_dict(jnp.asarray(y), depth, ds_type) if ds
              else jnp.asarray(y))
        step_model = jm.clone(dtype=step_dtype)
        state = jstate.create_train_state(step_model, jax.random.PRNGKey(0),
                                          cast(x), _grad_capture(),
                                          variables=cast(variables))
        step = jstate.make_train_step(step_model, _grad_capture(),
                                      jlosses.bce_dice_loss,
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
    assert sorted(got) == sorted(want)
    assert len(got) == 1 + depth * ds
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert float(np.abs(got[k].numpy() - w).max()) <= 1e-4, k
    assert float(want["out"].std()) > 1e-3  # a real signal

    if ds:
        with torch.no_grad():
            heads = tm.train()(torch.from_numpy(x))
        tm.load_state_dict(sd)  # undo that forward's BN update
        for k in range(1, depth + 1):
            h = heads[f"level{k}"]
            assert bool(((h > 0.05) & (h < 0.95)).all()), k
    ty = (prepare_train_dict(torch.from_numpy(y), depth, ds_type) if ds
          else torch.from_numpy(y))
    names = dict(tm.named_parameters())
    tloss, _ = make_train_step(tm, make_optimizer("Adam", names.values(),
                                                  1e-3),
                               bce_dice_loss, weights)(torch.from_numpy(x), ty)
    assert np.isfinite(float(tloss))
    assert abs(float(jloss) - float(tloss)) <= 1e-4
    jg = flax_to_state_dict({"params": state.opt_state}, names)
    assert max(float(v.abs().max()) for v in jg.values()) > 1e-3
    def size_of(t):
        return max(float(t.abs().max()), 1.0) if relative else 1.0

    for k, p in names.items():
        assert float((jg[k] - p.grad).abs().max()) <= 1e-4 * size_of(
            jg[k]), k
    stats = {k: v for k, v in tm.state_dict().items() if "running" in k}
    js = flax_to_state_dict({"batch_stats": state.batch_stats}, stats)
    for k, v in stats.items():
        assert float((js[k] - v).abs().max()) <= 1e-5 * size_of(js[k]), k


@pytest.mark.parametrize("name,ds,tc", CASES,
                         ids=[f"{n}-ds{d}-tc{t}" for n, d, t in CASES])
def test_config2_model_float32_matches_jax(name, ds, tc):
    """W4/D3 UNet, UNetE, UNetP and UNet++ on (2, 32, 32, 3), with and
    without transposed convs, held to ``assert_model_matches_jax``."""
    jm, tm = _models(name, ds, tc)
    assert_model_matches_jax(jm, tm, ds, *DECODERS[name])


def test_unet_e_without_ds_builds_only_the_last_diagonal():
    """UNetE with ``d_s = 0`` builds the nodes with i + j == D only, and
    the flax auto-names count those: W4/D3 has nodes (1, 2), (2, 1) and
    (3, 0) as ``TransConv_0..2`` and ``ConvBlock_0..2``, each upsampling
    the one before (the bottleneck first), and no others.  With
    ``d_s = 1`` all six nodes are built."""
    jm, tm = _models("UNetE", 0, 1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    dec = shapes["GridDecoder_0"]
    assert sorted(dec) == [f"{kind}_{n}" for kind in ("ConvBlock",
                                                      "TransConv")
                           for n in range(3)]
    # (C_in, C_out) of each upsampling and node: widths 16, 8, 4
    want = {0: (32, 16), 1: (16, 8), 2: (8, 4)}
    for n, (cin, cout) in want.items():
        assert dec[f"TransConv_{n}"]["ConvTranspose_0"]["kernel"].shape == (
            4, 4, cout, cin)
        assert dec[f"ConvBlock_{n}"]["Conv_0"]["kernel"].shape == (
            3, 3, 2 * cout, cout)
        assert tuple(tm.GridDecoder_0.get_submodule(
            f"TransConv_{n}.ConvTranspose_0").weight.shape) == (cin, cout, 4, 4)
        assert tuple(tm.GridDecoder_0.get_submodule(
            f"ConvBlock_{n}.Conv_0").weight.shape) == (cout, 2 * cout, 3, 3)
    assert sorted(n for n, _ in tm.GridDecoder_0.named_children()) == sorted(
        dec)
    _, tm_ds = _models("UNetE", 1, 1)
    assert sum(n.startswith("ConvBlock_")
               for n, _ in tm_ds.GridDecoder_0.named_children()) == 6
