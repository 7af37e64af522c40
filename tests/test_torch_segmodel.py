"""The port's UNet++ against the JAX ``SegModel`` with converted weights:
float32 within the repo's 1e-4 bar, bfloat16 within a stated bound, and
the flagship's parameter tree mapped leaf for leaf."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    SegModel, model_selector)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict, load_flax_variables)


def _pair(width, depth, dtype_name, seed=0):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype_name == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jm = JaxSegModel(decoder_name="UNetPP", model_width=width,
                     model_depth=depth, output_nums=1,
                     final_activation="sigmoid", dtype=jdt)
    tm = SegModel("UNetPP", width, depth, in_channels=3, output_nums=1,
                  final_activation="sigmoid", dtype=tdt).eval()
    return jm, tm


def _outputs(dtype_name):
    jm, tm = _pair(4, 3, dtype_name)
    x = np.random.default_rng(11).uniform(size=(2, 32, 32, 3)).astype(
        np.float32)
    variables = random_variables(jm, jnp.asarray(x), seed=3)
    load_flax_variables(tm, variables)
    apply = jax.jit(lambda v, x: jm.apply(v, x, train=False)["out"])
    want = np.asarray(apply(variables, jnp.asarray(x)).astype(jnp.float32))
    with torch.inference_mode():
        out = tm(torch.from_numpy(x))["out"]
    assert out.dtype == tm.dtype and tuple(out.shape) == (2, 32, 32, 1)
    return out.float().numpy(), want


def test_unetpp_float32_matches_jax():
    """UNet++ W=4 D=3 on (2, 32, 32, 3), random BN statistics: ``out``
    within 1e-4 of ``SegModel.apply(train=False)``."""
    got, want = _outputs("float32")
    assert np.all(np.isfinite(got))
    assert float(np.max(np.abs(got - want))) <= 1e-4
    assert float(want.std()) > 1e-2  # a real signal, not a saturated map


def test_unetpp_bfloat16_matches_jax():
    """The same in bf16.  Both sides cast weights and activations to bf16
    at the same places, but the convolutions accumulate in another order
    (and XLA:CPU and PyTorch's CPU kernels round their f32 sums to bf16 at
    different points), so a few bf16 ulps of the sigmoid output differ:
    bf16 has 8 bits of mantissa, one ulp is 2**-8 on [0.5, 1).  Bound:
    max-abs <= 2 ulp, mean-abs <= 1/4 ulp."""
    got, want = _outputs("bfloat16")
    err = np.abs(got - want)
    assert float(err.max()) <= 2 * 2 ** -8
    assert float(err.mean()) <= 2 ** -8 / 4


def test_flagship_parameter_tree_maps_leaf_for_leaf():
    """The W32/D4 UNet++ (the flagship, __graft_entry__.py:26-29): every
    flax leaf has a torch key of the converted shape and vice versa, and
    the parameter counts agree.  Shapes only; nothing runs."""
    jm = JaxSegModel(decoder_name="UNetPP", model_width=32, model_depth=4,
                     output_nums=1, final_activation="sigmoid")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 256, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = model_selector("UNet", "from_scratch", "UNetPP", 256, 256,
                        model_width=32, model_depth=4, num_channels=3)
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    n_flax = sum(int(np.prod(s.shape)) for s in
                 jax.tree.leaves(shapes["params"]))
    n_torch = sum(p.numel() for p in tm.parameters())
    assert n_flax == n_torch


def test_unported_configurations_raise():
    """These configurations raised before the rest of the 2D zoo was
    ported; each builds now and runs a forward of the right shape.  What
    still raises: each of them at depth 6 on a backbone, by the
    ``ValueError`` of both packages, and a dense-input encoder from
    scratch at depth 7, by a pool by 128."""
    x = torch.rand(1, 64, 64, 3)
    for kw in ({"train_mode": "pretrained_encoder",
                "backbone": "EfficientNetV2B0"},
               {"train_mode": "pretrained_encoder", "backbone": "VGG16",
                "ag": 1, "lstm": 1},
               {"train_mode": "pretrained_encoder",
                "backbone": "DenseNet121", "lstm": 1},
               {"ae": 1, "input_size": (64, 64),
                "train_mode": "pretrained_encoder",
                "backbone": "EfficientNetB0"},
               {"train_mode": "pretrained_encoder",
                "backbone": "ResNet50"}):
        with torch.no_grad():
            assert SegModel("UNetPP", 4, 2, **kw).eval()(x)["out"].shape \
                == (1, 64, 64, 1)
        with pytest.raises(ValueError, match="1 to 5"):
            SegModel("UNetPP", 4, 6, **kw)
    for name, kw in (("UNet4PV2", {}), ("UNet4P", {}), ("AHNet", {}),
                     ("KSSNet", {"train_mode": "pretrained_encoder",
                                 "backbone": "EfficientNetB0"})):
        with torch.no_grad():
            assert SegModel(name, 4, 2, **kw).eval()(x)["out"].shape == (
                1, 64, 64, 1)
        with pytest.raises(ValueError if kw else NotImplementedError):
            SegModel(name, 4, 6 if kw else 7, **kw)


def test_batch_of_one_from_numpy_reaches_the_pool_channels_last(monkeypatch):
    """numpy's ``x[None]`` has stride 0 on the batch axis; the model still
    hands the pool (and so the CUDA kernel, which takes nothing else) a
    channels_last tensor at every level.  Before the model copied its
    input into a fresh channels_last tensor, the convolutions wrote NCHW
    here and a served request of one image on the card failed."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)

    seen = []
    plain = pyramid.maxpool_pyramid

    def spy(x, levels, wanted=None):
        seen.append(x.is_contiguous(memory_format=torch.channels_last))
        return plain(x, levels, wanted)

    monkeypatch.setattr(pyramid, "maxpool_pyramid", spy)
    x = np.random.default_rng(3).uniform(size=(16, 16, 3)).astype(
        np.float32)[None]
    assert x.strides[0] == 0
    model = SegModel("UNetPP", 4, 2).eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(x))["out"]
    assert seen == [True, True] and tuple(out.shape) == (1, 16, 16, 1)
