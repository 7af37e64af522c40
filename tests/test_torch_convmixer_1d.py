"""The port's ConvMixer 1D archs (ConvMixerUNet, ConvMixerUNetE,
ConvMixerUNetP, ConvMixerUNetPP, ConvMixerUNet3P and
ConvMixerMultiResUNet), their ``ConvMixerBlock`` and the MultiRes block
with ConvMixer units against the JAX package, with the same variables
(random, from numpy, converted by utils/flax_to_torch.py):

- ``ConvMixerBlock`` (a depthwise ``dw`` conv, the exact gelu, BN, the
  residual, a 1x1 conv, gelu, BN) at C_in 1 and 5, kernels 3 and 4, and
  ``MultiResBlock(mixer=True)`` with the 1D level multiplier, in eval
  and training mode (output, every input's and parameter's gradient
  within 1e-4, the new running statistics within 1e-5);
- each arch at W4-8/D2-3 on (2, 32, 2) signals with its options on
  (ConvMixerUNet also off), under tests/test_torch_recurrent_1d.py's bar
  (``assert_1d_model_matches_jax``: heads within 1e-4, the float32 step
  against JAX's float64 step within 1e-4 or the stated relative bar);
- the ``ConvMixerUNet`` facade's methods build these archs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_recurrent_1d import assert_1d_model_matches_jax  # noqa: E402
from test_torch_specials_1d import _pair, _x  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    api_1d as japi_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.ops import blocks as jblocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    api_1d)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402


@pytest.mark.parametrize("cin,kernel", [(1, 3), (5, 4)])
def test_conv_mixer_block_equals_flax(cin, kernel):
    """At C_in = 1 the depthwise conv is an ordinary one-channel conv:
    the name ``dw`` still maps it, a (1, 1, 1, k) weight."""
    tmod = blocks.ConvMixerBlock(cin, 6, kernel, rank=1)
    assert tmod.dw.groups == cin
    _pair(jblocks.ConvMixerBlock(6, kernel), tmod, [_x((2, 16, cin))])


def test_conv_mixer_gelu_is_the_exact_one():
    x = torch.linspace(-4, 4, 101)
    assert torch.equal(blocks.gelu_exact(x),
                       torch.nn.functional.gelu(x, approximate="none"))
    assert float((blocks.gelu_exact(x) - blocks.get_activation("gelu")(x))
                 .abs().max()) > 1e-4


@pytest.mark.parametrize("multiplier", [1, 2])
def test_mixer_multires_block_equals_flax(multiplier):
    """Branch widths truncated before the level multiplier (W8: 1, 2, 4
    times ``multiplier``), ``ConvMixerBlock_0..3``."""
    tmod = blocks.MultiResBlock(3, 8, 3, multiplier=multiplier, rank=1,
                                mixer=True)
    assert tmod.out_features == 7 * multiplier
    assert sorted(n for n, _ in tmod.named_children()) == [
        "BatchNorm_0", "BatchNorm_1"] + [f"ConvMixerBlock_{i}"
                                         for i in range(4)]
    _pair(jblocks.MultiResBlock(8, 3, multiplier=multiplier, mixer=True),
          tmod, [_x((2, 16, 3))])


#: (arch, W, D, options)
CASES = [
    ("ConvMixerUNet", 4, 2, dict(ds=1, ag=1, lstm=1, kernel=4)),
    ("ConvMixerUNet", 4, 2, dict(is_transconv=False)),
    ("ConvMixerUNetE", 4, 2, dict(ds=1, lstm=1)),
    ("ConvMixerUNetP", 4, 2, dict(ag=1, is_transconv=False)),
    ("ConvMixerUNetPP", 4, 2, dict(ds=1, ag=1, lstm=1)),
    ("ConvMixerUNet3P", 4, 3, dict(ds=1)),
    ("ConvMixerMultiResUNet", 8, 2, dict(ds=1, ag=1, lstm=1, alpha=1.67)),
]


def _ids(c):
    return f"{c[0]}-W{c[1]}D{c[2]}-" + "-".join(
        f"{k}{v}" for k, v in c[3].items())


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_convmixer_arch_float32_matches_jax(case):
    arch, W, D, kw = case
    assert_1d_model_matches_jax(arch, W, D, **kw)


def test_convmixer_facade_builds_the_convmixer_archs():
    """``ConvMixerUNet(...).UNet()`` is the ConvMixerUNet arch, and so
    on, as JAX api_1d.py:359-384 maps them; the same parameter tree."""
    for method, arch in japi_1d.ConvMixerUNet._MAP.items():
        tm = getattr(api_1d.ConvMixerUNet(32, 2, 1, 4, 3, ds=1), method)()
        ref = api_1d.model_selector_1d(arch, 32, 2, 1, 4, 3, ds=1)
        assert tm.arch == arch
        assert sorted(tm.state_dict()) == sorted(ref.state_dict())
    with pytest.raises(AttributeError):
        api_1d.ConvMixerUNet(32, 2, 1, 4, 3).UNet4P()


def test_convmixer_pools_read_channels_last(monkeypatch):
    """Every pool of ConvMixerMultiResUNet and ConvMixerUNet reads a
    channels_last signal (channel stride 1; the kernel on the card
    refuses any other), also where a block's input has one channel,
    whose strides cannot say channels_last, and a depthwise conv's output
    comes back in the NCHW layout (cuDNN's may)."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)
    real_pool, real_conv = pyramid.maxpool1d_pyramid, blocks.SameConv.forward
    seen = []

    def pool(x, levels, wanted=None):
        seen.append(x.stride(1) == 1)
        return real_pool(x, levels, wanted)

    def nchw_conv(self, x):  # the depthwise conv as cuDNN may return it
        y = real_conv(self, x)
        return y.contiguous() if self.groups > 1 else y

    monkeypatch.setattr(pyramid, "maxpool1d_pyramid", pool)
    monkeypatch.setattr(blocks.SameConv, "forward", nchw_conv)
    for arch in ("ConvMixerMultiResUNet", "ConvMixerUNet"):
        tm = api_1d.model_selector_1d(arch, 32, 2, 1, 8, 3)
        x = torch.randn(2, 32, 1)
        tm.train()(x[:, :, :1].expand(2, 32, 1))["out"].sum().backward()
    assert len(seen) == 4 and all(seen)
