"""The rest of the backbone zoo (ResNet and ResNetV2, VGG, DenseNet and
CheXNet, MobileNet V1/V2/V3, InceptionV3, InceptionResNetV2,
EfficientNetV2) and the pretrained-encoder branches that were missing,
against the JAX package with the same variables (random, from numpy,
converted by utils/flax_to_torch.py):

- XLA's ``SAME`` pools (``backbones.base``) on odd and even sizes, and
  the stems' -inf-padded VALID 3x3 stride-2 pool, forward and VJP on
  plateaus (the windows overlap; ties go to the first maximum);
- (the parameter trees of the UNet on each of the 33 names and of each
  decoder on a backbone: tests/test_torch_backbone_trees.py);
- narrow instances through the classes' own fields in eval and training
  mode, every tap, the VJP of all taps and the running statistics, the
  port computing in float64 against JAX's float64, within 1e-6 of their
  size where that is above 1; MobileNetV3Small, the Inceptions and
  EfficientNetV2B0, which have no width field, every tap in both modes
  on 64x64 (the stride-32 tap 2 x 2);
- the gated tap projectors (MultiResUNet, KSSNet, UNet4P/UNet4PV2,
  AHNet) and ``a_e`` on a narrow MobileNet, held to
  ``assert_model_matches_jax``;
- a frozen backbone keeps its statistics, a trained one moves them.

The full-width backbones are in test_torch_backbones_full.py, the
projectors in test_torch_backbones_projectors.py (split to keep each file
short on one test worker)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import nhwc_to_torch, random_variables, torch_to_nhwc  # noqa: E402
from test_torch_config2_models import assert_model_matches_jax  # noqa: E402
from test_torch_pool_factors import _input  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    backbones as jbackbones)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.backbones import (  # noqa: E402
    convnets as jconv, efficientnet as jeff, inception as jinc)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    SegModel, segmodel)
from tf_1d_2d_segmentation_end2endpipelines_torch.models.backbones import (  # noqa: E402
    base, convnets, efficientnet, inception)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    bce_dice_loss, make_optimizer, make_train_step)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)


def _close(got, want, what, bar=1e-4):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= bar * scale, what


# ---- XLA's pools -----------------------------------------------------

def _jax_pool_vjp(fn, x, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def _port_pool_vjp(fn, x, g):
    xt = nhwc_to_torch(x).detach().requires_grad_()
    y = fn(xt)
    y.backward(nhwc_to_torch(g))
    return torch_to_nhwc(y), torch_to_nhwc(xt.grad)


@pytest.mark.parametrize("size", [15, 16, 17])
@pytest.mark.parametrize("k,s", [(3, 2), (2, 2), (1, 2), (3, 1)])
def test_same_max_pool_and_its_gradient_equal_xla(size, k, s):
    """``base.maxpool`` (flax ``SAME``: 0 before and 1 after for k = 3 at
    stride 2 on an even size) against JAX's ``_maxpool``, bit for bit on
    post-ReLU plateaus: overlapping windows add their gradients, each to
    the first maximum of its window in row-major order."""
    x = _input((2, size, size + 2, 3), size + k, "relu")
    y_j = jconv._maxpool(jnp.asarray(x), k, s)
    g = np.random.default_rng(k).normal(size=y_j.shape).astype(np.float32)
    y_j, dx_j = _jax_pool_vjp(lambda t: jconv._maxpool(t, k, s), x, g)
    y_t, dx_t = _port_pool_vjp(lambda t: base.maxpool(t, k, s), x, g)
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(dx_t, dx_j)


@pytest.mark.parametrize("size", [15, 16])
def test_stem_pool_and_its_gradient_equal_xla(size):
    """The ResNet/DenseNet stem pool: -inf padding of 1, then a VALID 3x3
    stride-2 max (JAX convnets.py:68-71)."""
    def jax_stem(t):
        t = jnp.pad(t, ((0, 0), (1, 1), (1, 1), (0, 0)),
                    constant_values=-jnp.inf)
        return jax.lax.reduce_window(t, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                     (1, 2, 2, 1), "VALID")

    x = _input((2, size, size, 4), 7, "relu")
    g = np.random.default_rng(2).normal(
        size=jax_stem(jnp.asarray(x)).shape).astype(np.float32)
    y_j, dx_j = _jax_pool_vjp(jax_stem, x, g)
    y_t, dx_t = _port_pool_vjp(convnets._stem_pool, x, g)
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(dx_t, dx_j)


@pytest.mark.parametrize("size", [7, 8])
def test_same_average_pool_equals_xla(size):
    """Inception's pool: the SAME sum over 3x3 at stride 1 divided by the
    count of real cells (JAX inception.py:42-47), and its gradient."""
    x = np.random.default_rng(3).normal(size=(2, size, size + 1, 5)).astype(
        np.float32)
    g = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    y_j, dx_j = _jax_pool_vjp(jinc._avgpool, x, g)
    y_t, dx_t = _port_pool_vjp(base.avgpool_same, x, g)
    _close(y_t, y_j, "avgpool", 1e-6)
    _close(dx_t, dx_j, "its gradient", 1e-6)


# ---- numerics --------------------------------------------------------

def _cast64(tree):
    return jax.tree.map(lambda a: np.asarray(a).astype(jnp.float64), tree)


def _assert_backbone_matches_jax(jm, make, size, vjp=True, seed=2):
    """``make(dtype)`` builds the port's backbone, which computes in
    float64 here against JAX's float64 step, within 1e-6 (of the size
    where that is above 1): every tap in eval mode and in training mode
    and, with ``vjp``, the VJP of all taps (every parameter's gradient)
    and the new running statistics.  In eval mode on random statistics
    these graphs amplify rounding by up to 1e5 (JAX's own float32
    forward of EfficientNetV2B0 at 64 x 64 is 1.3% off its float64 one at
    the top), so float32 cannot be held to a bar there; the port's own
    float32 forward runs and stays finite.  (In training mode at 1 x 1, 2
    values a channel, the batch variance E[x^2] - E[x]^2 of two random
    images' stride-32 features cancels to rounding even in float64, so
    the inputs are at least 64 x 64.)"""
    tm, tm64 = make(torch.float32), make(torch.float64)
    x = np.random.default_rng(seed).uniform(size=(2, size, size, 3)).astype(
        np.float32)
    variables = dict(random_variables(jm, jnp.asarray(x), seed=seed))
    variables.setdefault("batch_stats", {})
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict(sd)
    tm64.load_state_dict(sd)
    gs = None
    with jax.enable_x64(True):
        j64 = jm.clone(dtype=jnp.float64)
        bs = _cast64(variables["batch_stats"])

        def train_taps(p):
            taps, upd = j64.apply({"params": p, "batch_stats": bs},
                                  _cast64(x), train=True,
                                  mutable=["batch_stats"])
            return taps, upd.get("batch_stats", {})

        def both(p, gs):
            want = j64.apply({"params": p, "batch_stats": bs}, _cast64(x))
            if gs is None:
                return want, train_taps(p), None

            def loss(p):
                taps, new_bs = train_taps(p)
                return sum(jnp.sum(t * g) for t, g in zip(taps, gs)), (
                    taps, new_bs)

            grads, aux = jax.grad(loss, has_aux=True)(p)
            return want, aux, grads

        p64 = _cast64(variables["params"])
        if vjp:
            shapes = jax.eval_shape(lambda p: j64.apply(
                {"params": p, "batch_stats": bs}, _cast64(x)), p64)
            gs = [np.random.default_rng(9 + k).normal(size=s.shape)
                  for k, s in enumerate(shapes)]
        want, (taps_j, new_bs), dparams = jax.tree.map(
            np.asarray, jax.jit(both)(p64, gs))
    with torch.no_grad():
        got32 = tm.eval()(nhwc_to_torch(x))
        got = tm64.eval()(nhwc_to_torch(x))
    assert len(got) == len(want) == len(tm.tap_features) == len(got32)
    for k, (g, w) in enumerate(zip(got, want)):
        assert got32[k].is_contiguous(memory_format=torch.channels_last), k
        assert bool(got32[k].isfinite().all()), k
        assert g.shape[1] == tm.tap_features[k], k
        _close(g.permute(0, 2, 3, 1).numpy(), w, f"tap {k}", 1e-6)
        assert k == 0 or float(np.asarray(w).std()) > 1e-3, k
    taps_t = tm64.train()(nhwc_to_torch(x))
    for k, (t, w) in enumerate(zip(taps_t, taps_j)):
        _close(t.detach().permute(0, 2, 3, 1).numpy(), w, f"train tap {k}",
               1e-6)
    if not vjp:
        return
    sum((t * nhwc_to_torch(g)).sum() for t, g in zip(taps_t, gs)).backward()
    names = dict(tm64.named_parameters())
    jg = flax_to_state_dict({"params": jax.tree.map(
        lambda a: a.astype(np.float32), dparams)}, names)
    for key, p in names.items():
        _close(p.grad.numpy(), jg[key].numpy(), key, 1e-6)
    stats = {k: v for k, v in tm64.state_dict().items() if "running" in k}
    if stats:
        js = flax_to_state_dict({"batch_stats": jax.tree.map(
            lambda a: a.astype(np.float32), new_bs)}, stats)
        for key, v in stats.items():
            _close(v.numpy(), js[key].numpy(), key, 1e-6)


# narrow instances: (JAX class, the port's, their fields).  ResNetV2 takes
# two blocks in each strided stage: a stage of one block makes it both the
# first (a stride-1 conv shortcut) and the last (the stride-2 3x3), whose
# shapes disagree, in the JAX graph as in keras's stack2
NARROW = {
    "ResNet": (jconv.ResNetBackbone, convnets.ResNetBackbone,
               dict(blocks=(1, 1, 1, 1))),
    "ResNetV2": (jconv.ResNetV2Backbone, convnets.ResNetV2Backbone,
                 dict(blocks=(2, 2, 2, 1))),
    "VGG": (jconv.VGGBackbone, convnets.VGGBackbone,
            dict(convs=(1, 1, 1, 1, 1))),
    "DenseNet": (jconv.DenseNetBackbone, convnets.DenseNetBackbone,
                 dict(blocks=(1, 1, 1, 1), growth=8)),
    "MobileNet": (jconv.MobileNetBackbone, convnets.MobileNetBackbone,
                  dict(alpha=0.25)),
    "MobileNetV2": (jconv.MobileNetV2Backbone, convnets.MobileNetV2Backbone,
                    dict(alpha=0.35)),
}


@pytest.mark.parametrize("name", sorted(NARROW))
def test_narrow_backbone_equals_flax(name):
    """The narrow instances on (2, 64, 64, 3): taps, the VJP of all taps
    and the running statistics."""
    jcls, tcls, kw = NARROW[name]
    _assert_backbone_matches_jax(
        jcls(**kw), lambda dtype: tcls(**kw, dtype=dtype), 64)


# ---- the projectors and a_e on a narrow backbone ----------------------


@pytest.mark.parametrize("trainable", [0, 1])
def test_a_frozen_backbone_keeps_its_statistics(trainable):
    """Three Adam steps of the W4/D3 UNet on DenseNet121 (pruned at tap 3,
    inside its third dense block's transition): the backbone's running
    statistics move only when it trains, its parameters in both cases."""
    tm = SegModel("UNet", 4, 3, train_mode="pretrained_encoder",
                  backbone="DenseNet121", backbone_trainable=bool(trainable),
                  generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    step = make_train_step(tm, make_optimizer("Adam", tm.parameters(), 1e-3),
                           bce_dice_loss)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = (x[..., :1] > 0.5).float()
    for _ in range(3):
        step(x, y)
    bb = tm._encoder
    assert bb == "DenseNetBackbone_0"
    assert getattr(tm, bb).training == bool(trainable)
    after = tm.state_dict()
    stats = [not torch.equal(before[k], after[k]) for k in before
             if k.startswith(bb) and "running" in k]
    params = [not torch.equal(before[k], after[k]) for k in before
              if k.startswith(bb) and "running" not in k]
    assert stats and all(m == bool(trainable) for m in stats)
    assert sum(params) > 0.9 * len(params)


def test_optimizer_state_and_ema_map_onto_a_scaleless_backbone():
    """Adam's moments and the EMA shadow of the UNet on InceptionV3 (its
    BatchNorms have no ``scale`` leaf, hence no ``weight``) and on
    MobileNet (depthwise kernels) cross through the parameters' mapping:
    every parameter gets its moment of its shape and nothing is left."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E501
        ema_from_flax, load_adam_state)

    for name in ("InceptionV3", "MobileNet"):
        kw = dict(model_width=4, model_depth=2, output_nums=1,
                  train_mode="pretrained_encoder", backbone=name)
        jm = JaxSegModel(decoder_name="UNet", **kw)
        tm = SegModel("UNet", in_channels=3, **kw)
        params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)))["params"]
        rng = np.random.default_rng(0)
        mu, nu, ema = (jax.tree.map(lambda s: rng.normal(size=s.shape)
                                    .astype(np.float32), params)
                       for _ in range(3))
        opt = make_optimizer("Adam", tm.parameters(), 1e-3)
        load_adam_state(opt, tm, mu, nu, 3)
        shadow = ema_from_flax(tm, ema)
        named = list(tm.named_parameters())
        assert len(shadow) == len(named) == len(opt.state)
        for (key, p), s in zip(named, shadow):
            assert s.shape == p.shape, key
            assert opt.state[p]["exp_avg"].shape == p.shape, key
            assert int(opt.state[p]["step"]) == 3
        bns = [k for k in dict(named) if "BatchNorm" in k
               and k.startswith(tm._encoder)]
        if name == "InceptionV3":
            assert bns and not any(k.endswith(".weight") for k in bns)
