"""The rest of the port's 1D zoo against the JAX package: UNet4P (its
dense encoder and inter-decoder skip paths) and the 1D MultiResUNet3P (a
network of its own, whose gates are JAX's 2D-dialect ones), each under
tests/test_torch_recurrent_1d.py's bar (``assert_1d_model_matches_jax``:
every leaf mapped, heads within 1e-4, the port's float64 step equal to
JAX's within 1e-6, its float32 step within 1e-4 of JAX's float64 step or
the stated relative bar).  Also: UNet3+ ignores ``lstm`` as JAX does;
``FeatureExtractionBlock`` in both ranks; the full-width trees (W32 D3
L1024) of every arch this slice ports, with and without ``ae``, leaf for
leaf; UNet4P's dense encoder launches one pool a tap (its shared pool's
gradient is the sum of the two reads'); the flax auto-names of the
recurrent, ConvMixer and MultiResUNet3P trees; the ``UNet1D`` facade's
methods."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_recurrent_1d import assert_1d_model_matches_jax  # noqa: E402
from test_torch_specials_1d import _pair, _x  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.models.api_1d import (  # noqa: E402
    model_selector_1d as jax_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.ops import blocks as jblocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    api_1d, model_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pool_backward, pyramid)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

#: (arch, W, D, options)
CASES = [
    ("UNet4P", 4, 3, dict(ds=1)),
    ("UNet4P", 4, 3, dict(ag=1, lstm=1, is_transconv=False, kernel=4)),
    ("MultiResUNet3P", 8, 2, dict(ds=1, ag=1)),
    ("MultiResUNet3P", 8, 2, dict(is_transconv=False, alpha=1.67,
                                  kernel=4)),
]


def _ids(c):
    return f"{c[0]}-W{c[1]}D{c[2]}-" + "-".join(
        f"{k}{v}" for k, v in c[3].items())


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_unet4p_and_multiresunet3p_match_jax(case):
    arch, W, D, kw = case
    assert_1d_model_matches_jax(arch, W, D, **kw)


def test_unet3p_ignores_lstm_as_jax_does():
    """The full-scale decoder reads neither ``lstm`` nor ``a_g`` (JAX
    decoders.py:324-386): the same tree and the same output."""
    plain = model_selector_1d("UNet3P", 32, 2, 1, 4, 3)
    fused = model_selector_1d("UNet3P", 32, 2, 1, 4, 3, lstm=1, ag=1)
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(2, 32, 1)
    with torch.no_grad():
        assert torch.equal(plain.eval()(x)["out"], fused.eval()(x)["out"])
    jm = jax_selector_1d("UNet3P", 32, 2, 1, 4, 3, lstm=1, ag=1)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 1)))["params"]
    assert sorted(params) == sorted(n for n, _ in fused.named_children())


@pytest.mark.parametrize("shape,spatial", [((2, 8, 3), (1, 8)),
                                           ((2, 4, 4, 3), (4, 4))])
def test_feature_extraction_block_equals_flax(shape, spatial):
    """Flattened in NLC (NHWC) order, two Dense layers, reshaped back to
    ``model_width`` channels; 1D and 2D."""
    tmod = blocks.FeatureExtractionBlock(3, spatial, 5, 6)
    jmod = jblocks.FeatureExtractionBlock(5, 6)
    if len(shape) == 3:
        _pair(jmod, tmod, [_x(shape)], train_arg=False)
        return
    x = _x(shape)
    variables = dict(jax.tree.map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x))))
    tmod.load_state_dict(flax_to_state_dict(variables, tmod.state_dict()))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    got = tmod(xt).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, 4, 4, 5)
    assert float(np.abs(got - want).max()) <= 1e-5
    with pytest.raises(ValueError, match="ae = 1"):
        tmod(torch.zeros(1, 3, 2, 4))


NEW_ARCHS = ("UNet4P", "MultiResUNet3P", "RUNet", "R2UNet", "R2UNetPP",
             "R2UNet3P", "ConvMixerUNet", "ConvMixerUNetE", "ConvMixerUNetP",
             "ConvMixerUNetPP", "ConvMixerUNet3P", "ConvMixerMultiResUNet")


@pytest.mark.parametrize("arch,kw", [(a, {}) for a in NEW_ARCHS] + [
    ("UNet", dict(ae=1)), ("UNetPP", dict(lstm=1)),
    ("BCDUNet", dict(ae=1, lstm=1, dense_loop=2))])
def test_full_width_tree_maps_leaf_for_leaf(arch, kw):
    """Config 1's size (W32 D3 L1024, k3, one channel): every flax leaf
    has its torch tensor of the converted shape, no torch key is left
    over, and the parameter counts are equal (``jax.eval_shape``)."""
    jm = jax_selector_1d(arch, 1024, 3, 1, 32, 3, **kw)
    tm = model_selector_1d(arch, 1024, 3, 1, 32, 3, **kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1024, 1)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_state_dict(dict(zeros), tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        shapes["params"])) == sum(p.numel() for p in tm.parameters())


def test_flax_auto_names_of_the_new_trees():
    """The encoder, latent and bottleneck blocks are direct children
    counted by type in flax's call order (r2: the 1x1 ConvBlock before
    its recurrent blocks; MultiResUNet3P: D + 1 MultiRes levels and
    ResPaths, then the decoder's inline blocks)."""
    for arch, kw in (("R2UNet", dict(ae=1)), ("ConvMixerUNetPP", {}),
                     ("MultiResUNet3P", dict(ds=1, ag=1))):
        tm = model_selector_1d(arch, 64, 2, 1, 8, 3, **kw)
        jm = jax_selector_1d(arch, 64, 2, 1, 8, 3, **kw)
        params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 1)))["params"]
        assert sorted(n for n, _ in tm.named_children()) == sorted(params)
    assert "FeatureExtractionBlock_0" in dict(
        model_selector_1d("R2UNet", 64, 2, 1, 8, 3, ae=1).named_children())


def test_unet4p_dense_encoder_pools_each_tap_once():
    """At D3 tap 1 is read pooled twice (the encoder's pool, and level 3's
    dense input, JAX api_1d.py:276-282): one pyramid launch a tap, and one
    backward launch for it, whose gradient is the two reads' sum."""
    tm = model_selector_1d("UNet4P", 64, 3, 1, 4, 3)
    calls = []
    real = pyramid.maxpool1d_pyramid
    back = pool_backward.maxpool1d_backward

    def counted(x, levels, wanted=None):
        calls.append(("fwd", tuple(x.shape), levels))
        return real(x, levels, wanted)

    def counted_back(x, g, f):
        calls.append(("bwd", tuple(x.shape), f))
        return back(x, g, f)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pyramid, "maxpool1d_pyramid", counted)
        mp.setattr(pyramid, "maxpool1d_backward", counted_back)
        tm.train()(torch.randn(2, 64, 1))["out"].sum().backward()
    assert [c for c in calls if c[0] == "fwd"] == [
        ("fwd", (2, 4, 1, 64), 1), ("fwd", (2, 8, 1, 32), 1),
        ("fwd", (2, 16, 1, 16), 1)]
    assert len([c for c in calls if c[0] == "bwd"]) == 3


def test_unet1d_facade_builds_every_ported_arch():
    """The ``UNet1D`` methods of every arch name build; the facade hands
    the Self-ONN archs its ``q`` (their first Oper stacks q powers of the
    one-channel input)."""
    facade = api_1d.UNet1D(32, 2, 1, 4, 3, ds=0)
    for arch in api_1d.ARCH_NAMES_1D:
        assert getattr(facade, arch)().arch == arch
    for q in (3, 2):
        tm = api_1d.UNet1D(32, 2, 1, 4, 3, ds=0, q=q).SelfUNetPP()
        assert tm.Oper_0.onn_conv.in_channels == q
