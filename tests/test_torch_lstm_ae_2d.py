"""ConvLSTM fusion (``lstm = 1``) and the autoencoder bottleneck (``ae =
1``) in the port's 2D ``SegModel`` against the JAX ``SegModel``, and the
``final_activation`` names tanh, gelu, elu and selu:

- ``lstm = 1`` on the chains (UNet, MultiResUNet, KSSNet) and the grids
  (UNetE, UNetP, UNet++), with and without attention gates and deep
  supervision, and ``ae = 1`` (``FeatureExtractionBlock(W * 2**D,
  feature_number)`` after the latent) on the from-scratch families, held
  to tests/test_torch_config2_models.py's ``assert_model_matches_jax``
  (every leaf mapped, every head within 1e-4 in eval mode, one float32
  training step's loss and gradients within 1e-4 and statistics within
  1e-5 of JAX's step, in float64 for the MultiRes families, as
  tests/test_torch_config4_models.py explains);
- the flagship's width and depth (W32 D4) with ``lstm = 1`` and ``a_g =
  1`` on UNet++ and KSSNet, and with ``ae = 1`` on 64 x 64 inputs (at
  256 x 256 the two Dense layers hold 268M parameters), leaf for leaf;
- the ``train`` verb's model builder sizes the bottleneck by the image
  or, under ``patchify``, the patch, as JAX's init batch does;
- each new activation name against flax's, value and gradient (``gelu``
  by name is flax's tanh approximation)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_config2_models import assert_model_matches_jax  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.ops import blocks as jblocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch import drivers  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TrainConfig)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

SIZE = 32
#: decoder -> its flax module name, the ds_type whose targets fit its
#: heads, and JAX's step dtype (float64 for the MultiRes families)
DECODERS = {"UNet": ("ChainDecoder_0", "UNet", jnp.float32),
            "MultiResUNet": ("ChainDecoder_0", "UNet", jnp.float64),
            "KSSNet": ("ChainDecoder_0", "UNet", jnp.float64),
            "UNetE": ("GridDecoder_0", "UNetPP", jnp.float32),
            "UNetP": ("GridDecoder_0", "UNetPP", jnp.float32),
            "UNetPP": ("GridDecoder_0", "UNetPP", jnp.float32),
            "UNet3P": ("FullScaleDecoder_0", "UNet", jnp.float32)}
#: (decoder, W, D, options)
CASES = [
    ("UNet", 4, 3, dict(lstm=1, ds=1)),
    ("UNet", 4, 2, dict(lstm=1, ag=1, is_transconv=False)),
    ("MultiResUNet", 8, 2, dict(lstm=1, ag=1)),
    ("KSSNet", 8, 2, dict(lstm=1, ds=1)),
    ("UNetE", 4, 2, dict(lstm=1, ds=1)),
    ("UNetP", 4, 2, dict(lstm=1, ag=1)),
    ("UNetPP", 4, 2, dict(lstm=1, ag=1, ds=1)),
    ("UNet", 4, 2, dict(ae=1, ds=1)),
    ("MultiResUNet", 8, 2, dict(ae=1)),
    ("UNet3P", 4, 2, dict(ae=1)),
    ("UNetPP", 4, 2, dict(ae=1, lstm=1)),
]


def _ids(c):
    return f"{c[0]}-W{c[1]}D{c[2]}-" + "-".join(
        f"{k}{int(v)}" for k, v in c[3].items())


def _models(name, W, D, feature_number=8, **kw):
    jm = JaxSegModel(decoder_name=name, model_width=W, model_depth=D,
                     output_nums=1, final_activation="sigmoid",
                     feature_number=feature_number, **kw)
    tm = SegModel(name, W, D, in_channels=3, output_nums=1,
                  final_activation="sigmoid", feature_number=feature_number,
                  input_size=(SIZE, SIZE), **kw)
    return jm, tm


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_lstm_and_ae_2d_match_jax(case):
    name, W, D, kw = case
    jm, tm = _models(name, W, D, **kw)
    module, ds_type, step_dtype = DECODERS[name]
    if kw.get("lstm") and name != "UNet3P":
        assert "ConvLSTMFusion_0" in dict(
            getattr(tm, module).named_children())
    if kw.get("ae"):
        assert tm.FeatureExtractionBlock_0.spatial == (SIZE >> D,) * 2
    assert_model_matches_jax(jm, tm, kw.get("ds", 0), module, ds_type,
                             depth=D, step_dtype=step_dtype)


@pytest.mark.parametrize("name,kw", [
    ("UNetPP", dict(lstm=1, ag=1)), ("KSSNet", dict(lstm=1, ag=1)),
    ("UNet", dict(ae=1)), ("MultiResUNet3P", dict(ae=1, lstm=1))])
def test_w32_d4_tree_maps_leaf_for_leaf(name, kw):
    """The flagship's width and depth: every flax leaf has its torch
    tensor of the converted shape and the parameter counts agree
    (``jax.eval_shape``; ``ae`` on 64 x 64: a 4 x 4 x 512 bottleneck)."""
    size = 64
    jm = JaxSegModel(decoder_name=name, model_width=32, model_depth=4,
                     output_nums=1, **kw)
    tm = SegModel(name, 32, 4, in_channels=3, output_nums=1,
                  input_size=(size, size), **kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_state_dict(dict(zeros), tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        shapes["params"])) == sum(p.numel() for p in tm.parameters())


def test_train_verb_sizes_the_bottleneck_by_the_input_it_trains_on():
    cfg = TrainConfig(imlength=48, imwidth=32, model_width=4, model_depth=2,
                      a_e=1, feature_number=8)
    assert drivers._build_model(cfg).FeatureExtractionBlock_0.spatial == \
        (12, 8)
    patched = dataclasses.replace(cfg, patchify=True, patch_width=16,
                                  patch_height=24)
    assert drivers._build_model(patched).FeatureExtractionBlock_0.spatial \
        == (4, 6)
    # on a backbone (ported): sized by the backbone's tap D for the input
    # (InceptionV3's stride-4 tap of a 48 x 40 image: 12 x 10)
    on_bb = SegModel("UNet", 4, 2, ae=1, input_size=(48, 40),
                     feature_number=8, train_mode="pretrained_encoder",
                     backbone="InceptionV3")
    assert on_bb.FeatureExtractionBlock_0.spatial == (12, 10)


@pytest.mark.parametrize("name", ["tanh", "gelu", "elu", "selu"])
def test_final_activation_equals_flax(name):
    x = np.random.default_rng(1).normal(size=(2, 3, 5, 4)).astype(
        np.float32) * 3
    g = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    jfn = jblocks.get_activation(name)
    want, vjp = jax.vjp(jfn, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = blocks.apply_activation(xt, name)
    got.backward(torch.from_numpy(g))
    assert float(np.abs(got.detach().numpy() - np.asarray(want)).max()) \
        <= 1e-6
    assert float(np.abs(xt.grad.numpy() - np.asarray(
        vjp(jnp.asarray(g))[0])).max()) <= 1e-5
