"""The port's pretrained-encoder path against the JAX package, with the
same variables (random, from numpy, converted by utils/flax_to_torch.py):

- flax's ``SAME`` padding at stride 2 (uneven: 0 before and 1 after for
  k = 3 on an even size, 1 and 2 for k = 5) at odd and even sizes, plain
  and depthwise (a (k, k, 1, C) kernel is the grouped (C, 1, k, k)
  weight);
- ``EfficientNetBackbone(width=0.25, depth=0.34)``, built on both sides
  so that it stays narrow, every tap in eval mode and in training mode
  (the VJP of all taps against JAX's in float64: every parameter's
  gradient, ``InputNorm``'s trained ``mean`` and ``var`` included,
  within 1e-4 of its size where that is above 1; the running statistics
  within 1e-5);
- EfficientNetB0 at ``max_tap`` 2, 4 and 5 and B1-B7 at depth 4 leaf for
  leaf (``jax.eval_shape``: no compile);
- ``SegModel`` UNet on B0 at 32x32, D2-4 (and D5 at 64x64), eval heads
  and one float32 ``make_train_step`` against JAX's step in float64
  (gradients within 1e-4, statistics within 1e-5, of their size where
  that is above 1);
- ``encoder_trainable``: with 0 the backbone's running statistics stay
  and with 1 they move in training, Adam moves its parameters in both;
- what stays unported raises ``NotImplementedError``, an unknown
  backbone the JAX ``ValueError``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402
from test_torch_blocks import nhwc_to_torch, random_variables, torch_to_nhwc  # noqa: E402
from test_torch_config2_models import _grad_capture  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.backbones import (  # noqa: E402
    get_backbone as jax_get_backbone)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.backbones.efficientnet import (  # noqa: E402
    EfficientNetBackbone as JaxEfficientNet)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    losses as jlosses, state as jstate)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.models.backbones import (  # noqa: E402
    BACKBONE_NAMES, EfficientNetBackbone, get_backbone)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import (  # noqa: E402
    SameConv, same_pads)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    bce_dice_loss, make_optimizer, make_train_step)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

ATOL = 1e-4


def _img(shape, seed=0):
    """Pixel-range input: InputNorm divides by 255 first."""
    return (np.random.default_rng(seed).uniform(size=shape) * 255).astype(
        np.float32)


def _close(got, want, what, scale_above_one=False):
    want = np.asarray(want)
    bar = ATOL * (max(float(np.abs(want).max()), 1.0)
                  if scale_above_one else 1.0)
    assert got.shape == want.shape, what
    assert float(np.abs(got - want).max()) <= bar, what


@pytest.mark.parametrize("size,k,groups", [(16, 3, 1), (17, 3, 1),
                                           (16, 5, 4), (17, 5, 4),
                                           (15, 3, 4)])
def test_same_conv_at_stride_2_equals_flax(size, k, groups):
    pads = same_pads(size, k, 2)
    if size % 2 == 0:
        assert pads == ((0, 1) if k == 3 else (1, 2))
    jm = fnn.Conv(4, (k, k), strides=(2, 2), padding="SAME",
                  feature_group_count=groups, use_bias=False)
    x = np.random.default_rng(1).normal(size=(2, size, size, 4)).astype(
        np.float32)
    variables = random_variables(jm, jnp.asarray(x))
    tm = SameConv(4, 4, k, 2, groups=groups, bias=False)
    sd = flax_to_state_dict(variables, tm.state_dict())
    if groups == 4:  # the depthwise (k, k, 1, C) kernel
        assert variables["params"]["kernel"].shape == (k, k, 1, 4)
        assert sd["weight"].shape == (4, 1, k, k)
        assert torch.equal(sd["weight"][2, 0], torch.from_numpy(
            variables["params"]["kernel"][:, :, 0, 2]))
    tm.load_state_dict(sd)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nhwc_to_torch(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(torch_to_nhwc(got), want, "conv")


def test_narrow_efficientnet_equals_flax():
    """Every tap of EfficientNetBackbone(0.25, 0.34) (widths 8 to 320,
    one or two blocks a stage) on (2, 64, 64, 3) in eval mode, then in
    training mode with the VJP of all taps.  (At 32x32 the top is 1x1,
    and its training-mode BatchNorm normalizes two values a channel.)"""
    jm = JaxEfficientNet(width=0.25, depth=0.34, max_tap=5)
    tm = EfficientNetBackbone(0.25, 0.34, max_tap=5)
    x = _img((2, 64, 64, 3))
    variables = dict(random_variables(jm, jnp.asarray(x), seed=2))
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict(sd)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(nhwc_to_torch(x))
    assert len(got) == len(want) == 6
    assert [t.shape[1] for t in got] == tm.tap_features
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.is_contiguous(memory_format=torch.channels_last), k
        _close(torch_to_nhwc(g), w, f"tap {k}", scale_above_one=True)
        assert k == 0 or float(np.asarray(w).std()) > 1e-2

    gs = [np.random.default_rng(9 + k).normal(size=np.shape(w)).astype(
        np.float32) for k, w in enumerate(want)]

    # JAX's VJP in float64, the exact one the port's float32 is held to
    with jax.enable_x64(True):
        def cast(tree):
            return jax.tree.map(
                lambda a: np.asarray(a).astype(jnp.float64), tree)

        j64 = jm.clone(dtype=jnp.float64)

        def f(p):
            taps, upd = j64.apply({"params": p,
                                   "batch_stats": cast(
                                       variables["batch_stats"])},
                                  cast(x), train=True,
                                  mutable=["batch_stats"])
            return sum(jnp.sum(t * g) for t, g in zip(taps, cast(gs))), (
                taps, upd["batch_stats"])

        dparams, (taps_j, new_bs) = jax.tree.map(
            lambda a: np.asarray(a).astype(np.float32),
            jax.jit(jax.grad(f, has_aux=True))(cast(variables["params"])))
    taps_t = tm.train()(nhwc_to_torch(x))
    sum((t * nhwc_to_torch(g)).sum() for t, g in zip(taps_t, gs)).backward()
    for k, (t, w) in enumerate(zip(taps_t, taps_j)):
        _close(torch_to_nhwc(t), w, f"train tap {k}", scale_above_one=True)
    names = dict(tm.named_parameters())
    jg = flax_to_state_dict({"params": dparams}, names)
    assert float(names["InputNorm_0.mean"].grad.abs().max()) > 1e-3
    for key, p in names.items():
        _close(p.grad.numpy(), jg[key].numpy(), key, scale_above_one=True)
    stats = {k: v for k, v in tm.state_dict().items() if "running" in k}
    js = flax_to_state_dict({"batch_stats": new_bs}, stats)
    for key, v in stats.items():
        assert float((js[key] - v).abs().max()) <= 1e-5, key


@pytest.mark.parametrize("name,max_tap", [("EfficientNetB0", 2),
                                          ("EfficientNetB0", 4),
                                          ("EfficientNetB0", 5),
                                          ("EfficientNetB3", 4),
                                          ("EfficientNetB7", 4)])
def test_backbone_tree_maps_leaf_for_leaf(name, max_tap):
    """``max_tap`` prunes both graphs alike (at 4 the backbone stops after
    block 6a's expand conv); shapes only."""
    jm = jax_get_backbone(name, max_tap=max_tap)
    tm = get_backbone(name, max_tap=max_tap)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_state_dict(dict(zeros), tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        shapes["params"])) == sum(p.numel() for p in tm.parameters())
    assert len(tm.tap_features) == max_tap + 1


def _unet(D, trainable, W=4):
    kw = dict(model_width=W, model_depth=D, output_nums=1,
              final_activation="sigmoid", train_mode="pretrained_encoder",
              backbone="EfficientNetB0", backbone_trainable=trainable)
    return (JaxSegModel(decoder_name="UNet", **kw),
            SegModel("UNet", in_channels=3, **kw))


@pytest.mark.parametrize("D,size,trainable", [(2, 32, 1), (3, 32, 0),
                                              (4, 32, 1), (4, 32, 0),
                                              (5, 64, 1)])
def test_efficientnet_unet_matches_jax(D, size, trainable):
    """The UNet on B0 (W4): heads in eval mode within 1e-4, then one
    float32 step (BCEDice, Adam) of the port against JAX's float64 step:
    loss within 1e-4, every gradient within 1e-4 and every running
    statistic within 1e-5, of its size where that is above 1 (B0's depth
    scales them up); with ``trainable`` 0 the backbone's statistics stay
    as they were."""
    jm, tm = _unet(D, trainable)
    x = _img((2, size, size, 3), seed=4)
    y = (np.random.default_rng(6).uniform(size=(2, size, size, 1)) > 0.6
         ).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), seed=3)
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(v.size for v in jax.tree.leaves(variables["params"])) == sum(
        p.numel() for p in tm.parameters())
    tm.load_state_dict(sd)

    with jax.enable_x64(True):
        def cast(tree):
            return jax.tree.map(
                lambda a: np.asarray(a).astype(jnp.float64), tree)

        step_model = jm.clone(dtype=jnp.float64)
        state = jstate.create_train_state(step_model, jax.random.PRNGKey(0),
                                          cast(x), _grad_capture(),
                                          variables=cast(variables))
        step = jstate.make_train_step(step_model, _grad_capture(),
                                      jlosses.bce_dice_loss)

        def both(state, xs, ys):
            # the eval forward and the step, one compiled program
            return step_model.apply({"params": state.params,
                                     "batch_stats": state.batch_stats},
                                    xs, train=False)["out"], step(state, xs,
                                                                  ys)

        want, (state, jloss, _) = jax.jit(both)(state, cast(x), cast(y))
        jloss = float(jloss)
        state, want = jax.tree.map(
            lambda a: np.asarray(a).astype(np.float32), (state, want))
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x))["out"]
    _close(got.numpy(), want, "out")
    assert float(np.asarray(want).std()) > 1e-3
    names = dict(tm.named_parameters())
    tloss, _ = make_train_step(tm, make_optimizer("Adam", names.values(),
                                                  1e-3), bce_dice_loss)(
        torch.from_numpy(x), torch.from_numpy(y))
    assert abs(jloss - float(tloss)) <= ATOL
    jg = flax_to_state_dict({"params": state.opt_state}, names)
    for key, p in names.items():
        _close(p.grad.numpy(), jg[key].numpy(), key, scale_above_one=True)
    stats = {k: v for k, v in tm.state_dict().items() if "running" in k}
    js = flax_to_state_dict({"batch_stats": state.batch_stats}, stats)
    for key, v in stats.items():
        # the decoder's variances reach 10-100 on pixel-range inputs
        bar = 1e-5 * max(float(js[key].abs().max()), 1.0)
        assert float((js[key] - v).abs().max()) <= bar, key
        if key.startswith("EfficientNetBackbone_0.") and not trainable:
            assert torch.equal(v, sd[key]), key


@pytest.mark.parametrize("trainable", [0, 1])
def test_encoder_trainable_freezes_the_statistics_not_the_weights(trainable):
    """Three Adam steps: the backbone's running statistics move only with
    ``trainable`` (the model's ``train()`` leaves a frozen backbone in
    eval mode), its parameters move in both cases, the decoder's
    statistics in both."""
    _, tm = _unet(3, trainable)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    step = make_train_step(tm, make_optimizer("Adam", tm.parameters(), 1e-3),
                           bce_dice_loss)
    x = torch.from_numpy(_img((2, 32, 32, 3)))
    y = (torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(
        1)) > 0.5).float()
    for _ in range(3):
        step(x, y)
    assert tm.EfficientNetBackbone_0.training == bool(trainable)
    after = tm.state_dict()
    moved = {k: not torch.equal(before[k], after[k]) for k in before}
    bb_stats = [m for k, m in moved.items()
                if k.startswith("EfficientNetBackbone_0.") and "running" in k]
    bb_params = [m for k, m in moved.items()
                 if k.startswith("EfficientNetBackbone_0.")
                 and "running" not in k]
    assert bb_stats and all(m == bool(trainable) for m in bb_stats)
    assert sum(bb_params) > 0.9 * len(bb_params)
    assert moved["LatentLayer_0.DenseBlock_0.ConvBlock_0.BatchNorm_0."
                 "running_mean"]


def test_b1_to_b7_build_and_run():
    for name in ("EfficientNetB1", "EfficientNetB7"):
        tm = SegModel("UNet", 4, 2, train_mode="pretrained_encoder",
                      backbone=name)
        with torch.no_grad():
            assert tm.eval()(torch.rand(1, 32, 32, 3))["out"].shape == (
                1, 32, 32, 1)


def test_unported_pretrained_settings_raise():
    """Every name of the JAX registry builds now (here pruned at tap 1:
    tests/test_torch_backbones_zoo.py maps each leaf for leaf), and every
    decoder family on a backbone, the gated projectors included; what
    still raises: an unknown name (the JAX ``ValueError``), a depth out of
    1 to 5, and ``encoder_weights`` other than ``none`` in the train verb
    (no ImageNet or .h5 weights are in the repository)."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TrainConfig, unported_train_keys)

    for name in BACKBONE_NAMES:
        assert len(get_backbone(name, max_tap=1).tap_features) == 2, name
    with pytest.raises(ValueError, match="Unknown backbone"):
        get_backbone("ResNet9000")
    for decoder in ("MultiResUNet", "MultiResUNet3P", "KSSNet", "UNet4P",
                    "AHNet", "UNet4PV2"):
        model = SegModel(decoder, 4, 2, train_mode="pretrained_encoder",
                         backbone="EfficientNetB0")
        assert [type(getattr(model, f"PretrainedTapProjector_{k}")).__name__
                for k in range(3)] == ["PretrainedTapProjector"] * 3
    with pytest.raises(ValueError, match="1 to 5"):
        SegModel("UNet", 4, 6, train_mode="pretrained_encoder",
                 backbone="EfficientNetB0")
    cfg = TrainConfig(encoder_mode="pretrained_encoder",
                      encoder_name="ResNet50", encoder_weights="imagenet")
    assert unported_train_keys(cfg) == ["encoder_weights = 'imagenet'"]
