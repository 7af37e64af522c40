"""The Self-ONN family and the FPN genre in the port against the JAX
package, on the CPU, with the same variables (random, from numpy,
converted by utils/flax_to_torch.py):

- 2D (``SegModel``, W4 on 32 x 32 images): SelfUNet, SelfUNetPP,
  SelfUNet3P and SelfFPN (genre FPN), and FPN with ConvBlock nodes, with
  and without deep supervision and transposed convs, q = 1 and 3,
  ``dense_loop``, FPN with ``a_g`` and ``lstm``; on EfficientNetB0
  (D2): FPN's ConvBlock and SelfFPN's Oper projections, SelfUNet's Self
  tap projectors.  Each is held to tests/test_torch_config2_models.py's
  ``assert_model_matches_jax``: every leaf mapped, every head in eval
  mode within 1e-4, one float32 training step (BCEDice on every head)
  against JAX's step in float64: the loss and every gradient within
  1e-4, the new running statistics within 1e-5.  The random kernels are
  scaled by 0.5 (at the default draw the cubes of five unnormalized
  encoder Opers overflow in both packages).
- 1D (``model_selector_1d``, W4 on 32-sample signals): SelfR2UNetPP,
  SelfUNetPP and SelfUNet3P with the options, held to
  tests/test_torch_recurrent_1d.py's ``assert_1d_model_matches_jax``
  (float64 steps within 1e-6, the float32 step within 1e-4 or the
  relative bar), on normal signals times 0.03, the random kernels scaled
  by 0.25 (at 0.5 SelfR2UNetPP's outputs reach a loss of 5, whose
  float32 rounding through the cubes exceeds the loss's absolute 1e-4).
- The reference's overflow: W8/D3 on config 1's signals times 1, 0.3,
  0.1 and 0.03 with JAX's own initial weights (converted), a training
  forward: the port's output is non-finite exactly where JAX's is, and
  where finite within 1e-4 of the largest finite magnitude.  At W32/D3,
  config 1's width, on phase 29's 128 signals, JAX's forward of all
  three archs is finite at ``chip_smoke.SELF_1D_SCALE`` and
  SelfR2UNetPP's not at the scales above it; at W32/D4 JAX's 2D
  SelfUNet overflows on phase 28's images and no Self model does at
  ``chip_smoke.SELF_2D_SCALE`` times them.
- The verbs: ``train`` through the command line on SelfUNetPP and
  SelfFPN (genre FPN) writes ``best.pt``, which ``serve`` restores;
  ``test`` and
  ``predict`` on the JAX verb's initial weights label every pixel as the
  JAX verbs do but within 1e-5 of the threshold; ``train1d`` on
  SelfUNetPP, then ``test1d`` and ``predict1d`` on JAX's initial weights
  against JAX's verbs (metrics and predictions within 1e-4).

The overflow and the verbs are in test_torch_self_verbs.py, the chip
scales in test_torch_self_scales.py (split to keep each file short on one
test worker)."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402
from test_torch_config2_models import assert_model_matches_jax  # noqa: E402
from test_torch_recurrent_1d import assert_1d_model_matches_jax  # noqa: E402
from test_torch_test_verb import _labels, _write_ini  # noqa: E402
from test_torch_verbs_1d import _cfg as _signal_cfg  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu import (  # noqa: E402
    drivers as jdrivers, drivers_1d as jdrivers_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.api_1d import (  # noqa: E402
    model_selector_1d as jax_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    Trainer as JaxTrainer)
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jconfig)
from tf_1d_2d_segmentation_end2endpipelines_torch import (  # noqa: E402
    drivers, drivers_1d, serve)
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import main  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    SegmentationFolderDataset, save_pt, synthetic, synthetic_signals)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    SegModel, model_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TestConfig as EvalConfig, TrainConfig, load_signal_config,
    load_train_config, save_train_config)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

SIZE = 32
NEAR = 1e-5
#: decoder -> its flax module name and the ds_type whose targets fit its
#: heads (the chains' and UNet3+'s level k at SIZE / 2**k, the grid's at
#: SIZE)
DECODERS = {"SelfUNet": ("SelfChainDecoder_0", "UNet"),
            "SelfFPN": ("SelfChainDecoder_0", "UNet"),
            "SelfUNetPP": ("SelfGridDecoder_0", "UNetPP"),
            "SelfUNet3P": ("SelfFullScaleDecoder_0", "UNet"),
            "FPN": ("ChainDecoder_0", "UNet")}
#: (decoder, W, D, options); the FPN decoders run in the FPN genre
CASES = [
    ("SelfUNet", 4, 3, dict()),
    ("SelfUNet", 4, 3, dict(ds=1, is_transconv=False, q=1)),
    ("SelfUNetPP", 4, 3, dict(ds=1)),
    ("SelfUNetPP", 4, 2, dict(is_transconv=False, dense_loop=2)),
    ("SelfUNet3P", 4, 3, dict(ds=1)),
    ("SelfUNet3P", 4, 2, dict(q=1, ag=1, lstm=1)),
    ("SelfFPN", 4, 3, dict(ds=1)),
    ("SelfFPN", 4, 2, dict(q=2)),
    ("FPN", 4, 3, dict(ds=1)),
    ("FPN", 4, 2, dict(ag=1, lstm=1, is_transconv=False)),
    ("FPN", 4, 2, dict(train_mode="pretrained_encoder", ds=1)),
    ("SelfFPN", 4, 2, dict(train_mode="pretrained_encoder")),
    ("SelfUNet", 4, 2, dict(train_mode="pretrained_encoder", ds=1)),
]


def _ids(c):
    return f"{c[0]}-W{c[1]}D{c[2]}-" + "-".join(
        f"{k}{v if isinstance(v, str) else int(v)}".replace(
            "pretrained_encoder", "B0") for k, v in c[3].items())


def _models(name, W, D, **kw):
    kw = dict(kw)
    genre = "FPN" if name.endswith("FPN") else "UNet"
    if kw.get("train_mode") == "pretrained_encoder":
        kw["backbone"] = "EfficientNetB0"
    jm = JaxSegModel(decoder_name=name, model_width=W, model_depth=D,
                     genre=genre, **kw)
    tm = SegModel(name, W, D, in_channels=3, genre=genre, **kw)
    return jm, tm


def _self_heads(module):
    """The deep-supervision heads of a Self decoder: its 1-filter Opers."""
    return lambda params: [o["onn_conv"] for n, o in params[module].items()
                           if n.startswith("Oper_")
                           and o["onn_conv"]["kernel"].shape[-1] == 1]


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_self_and_fpn_models_match_jax(case):
    name, W, D, kw = case
    jm, tm = _models(name, W, D, **kw)
    module, ds_type = DECODERS[name]
    assert_model_matches_jax(
        jm, tm, kw.get("ds", 0), module, ds_type, depth=D,
        step_dtype=jnp.float64, kernel_scale=0.5,
        heads=_self_heads(module) if name.startswith("Self") else None)


def test_flax_names_of_the_self_and_fpn_models():
    """SelfUNet3P's decoder interleaves Opers and BatchNorms as flax
    numbers them (per step: a BatchNorm after each tap Oper); the FPN
    genre builds no latent; on a backbone its projections are
    ``ConvBlock_<k>`` (FPN) or ``Oper_<k>`` (SelfFPN) beside ``out``, the
    Self head an Oper."""
    for name, kw, want in [
            ("SelfUNet3P", dict(ds=1), None),
            ("SelfFPN", {}, None),
            ("FPN", dict(train_mode="pretrained_encoder"),
             ["ConvBlock_0", "ConvBlock_1", "ConvBlock_2"]),
            ("SelfFPN", dict(train_mode="pretrained_encoder"),
             ["Oper_0", "Oper_1", "Oper_2"])]:
        jm, tm = _models(name, 4, 2, **kw)
        params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, SIZE, SIZE, 3)))["params"]
        assert sorted(n for n, _ in tm.named_children()) == sorted(params)
        module = DECODERS[name][0]
        assert sorted(n for n, _ in getattr(tm, module).named_children()) \
            == sorted(params[module])
        if name.endswith("FPN"):
            assert "LatentLayer_0" not in params
        if want:
            assert [n for n in params
                    if n.startswith(("ConvBlock_", "Oper_"))] == want
        if name.startswith("Self"):
            assert list(params["out"]) == ["onn_conv"]
    dec = dict(_models("SelfUNet3P", 4, 2, ds=1)[1].SelfFullScaleDecoder_0
               .named_children())
    # D2: step 0: tap Oper + BN, pooled tap Oper + BN, prev, node, head;
    # step 1: tap Oper + BN, prev, earlier, node, head
    assert sum(n.startswith("Oper_") for n in dec) == 10
    assert sum(n.startswith("BatchNorm_") for n in dec) == 3


def test_fpn_without_transposed_convs_raises():
    """The FPN chains add the skip to the upsampled output; a resize keeps
    the source's width, and the JAX package fails on the shapes."""
    for name in ("FPN", "SelfFPN"):
        with pytest.raises(ValueError, match="is_transconv"):
            SegModel(name, 4, 2, genre="FPN", is_transconv=False)
        jm = JaxSegModel(decoder_name=name, model_width=4, model_depth=2,
                         genre="FPN", is_transconv=False)
        with pytest.raises(Exception):
            jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                           jnp.zeros((1, SIZE, SIZE, 3)))


#: (arch, W, D, options)
CASES_1D = [
    ("SelfR2UNetPP", 4, 3, dict(ds=1)),
    ("SelfR2UNetPP", 4, 2, dict(is_transconv=False, t=1, q=2)),
    ("SelfUNetPP", 4, 3, dict()),
    ("SelfUNetPP", 4, 2, dict(ds=1, is_transconv=False, kernel=4)),
    ("SelfUNet3P", 4, 3, dict(ds=1)),
    ("SelfUNet3P", 4, 2, dict(q=1, ag=1, lstm=1)),
]


@pytest.mark.parametrize("case", CASES_1D, ids=[_ids(c) for c in CASES_1D])
def test_self_1d_archs_match_jax(case):
    arch, W, D, kw = case
    assert_1d_model_matches_jax(arch, W, D, x_scale=0.03, kernel_scale=0.25,
                                **kw)


def test_self_1d_pools_read_channels_last(monkeypatch):
    """Every pool of the 1D Self archs reads a channels_last signal
    (channel stride 1; the kernel on the card refuses any other), also
    where the first Oper stacks the powers of a one-channel signal, whose
    strides cannot say channels_last, and at q = 1."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)
    real_pool = pyramid.maxpool1d_pyramid
    seen = []

    def pool(x, levels, wanted=None):
        seen.append(x.stride(1) == 1)
        return real_pool(x, levels, wanted)

    monkeypatch.setattr(pyramid, "maxpool1d_pyramid", pool)
    for arch, q in (("SelfR2UNetPP", 3), ("SelfUNetPP", 1),
                    ("SelfUNet3P", 3)):
        tm = model_selector_1d(arch, 32, 2, 1, 4, 3, q=q)
        x = torch.randn(2, 32, 1) * 0.1
        tm.train()(x)["out"].sum().backward()
    assert len(seen) == 7 and all(seen)
