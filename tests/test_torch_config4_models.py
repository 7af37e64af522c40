"""BASELINE config 4's models (MultiResUNet; UNet with attention gates)
and the gates on the MultiResUNet and KSSNet chains and on the UNetE,
UNetP and UNet++ grids against the JAX
``SegModel`` with converted weights, at the bar of
tests/test_torch_config2_models.py; the parameter trees at W32/D4 with the
truncated MultiRes widths; what still raises; and the gated skips'
layout.  MultiResUNet3+ and KSSNet: tests/test_torch_multires_family.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_config2_models import assert_model_matches_jax  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    SegModel, decoders, encoders)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pyramid)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

#: the decoder module's flax name and the ds_type whose targets fit its
#: heads (the chains' and the full-scale decoder's level k at SIZE / 2**k,
#: the grids' at SIZE)
DECODERS = {"MultiResUNet": ("ChainDecoder_0", "UNet"),
            "KSSNet": ("ChainDecoder_0", "UNet"),
            "MultiResUNet3P": ("FullScaleDecoder_0", "UNet"),
            "UNet": ("ChainDecoder_0", "UNet"),
            "UNetE": ("GridDecoder_0", "UNetPP"),
            "UNetP": ("GridDecoder_0", "UNetPP"),
            "UNetPP": ("GridDecoder_0", "UNetPP")}
# (name, W, D, ds, ag, alpha): MultiResUNet W8/D3 has the MultiRes widths
# 7, 15, 31 and 63, W8/D2 at alpha 1.67 12, 26 and 53; the gated MultiRes
# chains gate ResPath taps of W * 2**k channels by truncated node outputs
#: the gated chains and grids; the MultiRes models' cases are in
#: test_torch_config4_multires.py
CASES = ([("UNet", 4, 3, ds, 1, 1.0) for ds in (0, 1)]
         + [(name, 4, 2, ds, 1, 1.0)
            for name in ("UNetE", "UNetP", "UNetPP") for ds in (0, 1)])


def _models(name, W, D, ds=0, ag=0, alpha=1.0):
    kw = dict(output_nums=1, ds=ds, ag=ag, alpha=alpha,
              final_activation="sigmoid")
    return (JaxSegModel(decoder_name=name, model_width=W, model_depth=D,
                        **kw),
            SegModel(name, W, D, in_channels=3, **kw))


def assert_config4_model_matches_jax(name, W, D, ds, ag, alpha):
    """Held to ``assert_model_matches_jax`` with JAX's train step in
    float64: at these widths the MultiRes blocks have one-channel branches
    (W = 8 gives 1 + 2 + 4), which make the first block's weight
    gradients sensitive to float32 rounding; JAX's float32 step on the
    CPU missed the 1e-4 bar against the port there, whose float32 step
    meets it against JAX's float64 step."""
    jm, tm = _models(name, W, D, ds, ag, alpha)
    assert_model_matches_jax(jm, tm, ds, *DECODERS[name], depth=D,
                             step_dtype=jnp.float64)


@pytest.mark.parametrize(
    "name,W,D,ds,ag,alpha", CASES,
    ids=[f"{n}-W{w}D{d}-ds{s}-ag{g}-a{a}" for n, w, d, s, g, a in CASES])
def test_config4_model_float32_matches_jax(name, W, D, ds, ag, alpha):
    assert_config4_model_matches_jax(name, W, D, ds, ag, alpha)


@pytest.mark.parametrize("name,ag", [("MultiResUNet", 0), ("UNet", 1),
                                     ("MultiResUNet3P", 0), ("KSSNet", 0),
                                     ("UNetPP", 1), ("MultiResUNet", 1),
                                     ("KSSNet", 1)])
def test_w32_d4_parameter_tree_maps_leaf_for_leaf(name, ag):
    """At the width config 4 trains (W32/D4, 256x256): every flax leaf has
    a torch key of the converted shape and vice versa, and the parameter
    counts agree.  The MultiRes encoder levels are 31, 63, 127, 255 and
    511 wide: MultiResUNet's head reads 31 channels and its first
    transposed conv 511, as KSSNet's head; MultiResUNet3+'s head reads
    W * D truncated, 127.  Shapes only; nothing runs."""
    jm, tm = _models(name, 32, 4, ag=ag)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 256, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        shapes["params"])) == sum(p.numel() for p in tm.parameters())
    if name in encoders.MULTIRES_FAMILIES:
        enc = tm.ScratchEncoder_0
        assert [getattr(enc, f"MultiResBlock_{i}").out_features
                for i in range(5)] == [31, 63, 127, 255, 511]
        assert not hasattr(enc, "ResPath_4")  # the dangling one
    head = {"MultiResUNet": 31, "KSSNet": 31, "MultiResUNet3P": 127}.get(
        name, 32)
    assert tm.out.in_channels == head
    if name == "MultiResUNet":
        assert tm.ChainDecoder_0.TransConv_0.ConvTranspose_0.in_channels \
            == 511


def test_lstm_and_other_families_still_raise():
    """The UNet4P/AHNet encoders, the MultiRes tap projector and every
    backbone build now, with ConvLSTM fusion and gates too: the 4P and AH
    grids gate and fuse their skips (new keys), UNet3+, UNet4PV2 and
    MultiResUNet3+ ignore ``ag`` and ``lstm``, as the JAX decoder does.
    What still raises is a pool by 128: a dense-input encoder at depth 7,
    with or without gates."""
    b0 = dict(train_mode="pretrained_encoder", backbone="EfficientNetB0")
    for name, kw in (("UNet4P", {}), ("UNet4PV2", {}), ("AHNet", {}),
                     ("MultiResUNet", b0),
                     ("UNet", dict(b0, backbone="ResNet50"))):
        gated = set(SegModel(name, 4, 2, ag=1, lstm=1, **kw).state_dict())
        plain = set(SegModel(name, 4, 2, **kw).state_dict())
        assert plain <= gated and (gated == plain) == (name == "UNet4PV2")
        if not kw:
            with pytest.raises(NotImplementedError, match="pools by 128"):
                SegModel(name, 4, 7, ag=1, lstm=1)
    for name in ("UNet3P", "MultiResUNet3P", "UNet4PV2"):
        assert sorted(SegModel(name, 4, 2, ag=1, lstm=1).state_dict()) == \
            sorted(SegModel(name, 4, 2).state_dict())


@pytest.mark.parametrize("name", ["UNet", "UNetPP", "KSSNet"])
def test_gated_skips_and_their_concats_are_channels_last(name, monkeypatch):
    """Every attention gate's output and every decoder concat (and every
    pool's input) is channels_last, in a training step on an input from
    numpy's ``x[None]`` (stride 0 on the batch axis), also when the
    gates' one-channel maps come back from the transposed conv with NCHW
    strides, as cuDNN may hand them back on the card."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops import blocks

    seen = []
    cat, pools = decoders.concat, pyramid.maxpool_pyramid
    forward = blocks.TransConv.forward

    def spy_cat(*tensors):
        out = cat(*tensors)
        seen.append(("cat", out.is_contiguous(
            memory_format=torch.channels_last)))
        return out

    def spy_pool(x, levels, wanted=None):
        seen.append(("pool", x.is_contiguous(
            memory_format=torch.channels_last)))
        return pools(x, levels, wanted)

    def nchw_maps(self, x):
        y = forward(self, x)
        if y.shape[1] != 1:
            return y
        n = y[0].numel()
        return torch.empty_strided(y.shape, (n, n, y.shape[3], 1),
                                   dtype=y.dtype).copy_(y)

    monkeypatch.setattr(decoders, "concat", spy_cat)
    monkeypatch.setattr(encoders, "concat", spy_cat)
    monkeypatch.setattr(pyramid, "maxpool_pyramid", spy_pool)
    monkeypatch.setattr(blocks.TransConv, "forward", nchw_maps)
    model = SegModel(name, 4, 2, ag=1 if name != "KSSNet" else 0,
                     generator=torch.Generator().manual_seed(0)).train()
    gates = [m for m in model.modules() if isinstance(m, blocks.AttentionGate)]
    for m in gates:
        m.register_forward_hook(lambda mod, args, out: seen.append(
            ("gate", out.is_contiguous(memory_format=torch.channels_last))))
    x = np.random.default_rng(1).uniform(size=(16, 16, 3)).astype(
        np.float32)[None]
    assert x.strides[0] == 0
    model(torch.from_numpy(x))["out"].sum().backward()
    kinds = [k for k, _ in seen]
    assert kinds.count("gate") == len(gates) and (
        len(gates) > 0) == (name != "KSSNet")
    assert kinds.count("cat") >= 2 and kinds.count("pool") >= 2
    assert all(ok for _, ok in seen), seen
