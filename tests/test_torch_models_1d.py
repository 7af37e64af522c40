"""The port's 1D models (``SegModel1D``: UNet, UNetE, UNetP, UNetPP,
UNet3P and MultiResUNet, with and without deep supervision, attention
gates and transposed convs, odd and even kernels, ``alpha``) against the
JAX ``SegModel1D`` with converted weights, on (2, 64, 2) signals: the
converter maps every flax leaf and leaves no torch key unfilled, every
head matches in eval mode, and one float32 training step (Regression,
linear head, MeanAbsoluteError on every head weighted by
``default_ds_weights``, the targets of the decoder's ds_type) gives JAX's
``make_train_step`` loss and every gradient within 1e-4 and its new
BatchNorm statistics within 1e-5.  Also BASELINE config 1's full-width
tree (W32 D3 L1024), leaf for leaf by shape, the flax auto-names, the
MultiResUNet at D3 under the relative bar, and what the port refuses."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402
from test_torch_config2_models import _grad_capture  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.data.pyramid import (  # noqa: E402
    prepare_train_dict as jax_prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.api_1d import (  # noqa: E402
    model_selector_1d as jax_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    losses as jlosses, state as jstate)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    SegModel1D, model_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    default_ds_weights, get_loss, make_optimizer, make_train_step)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

L = 64
#: arch -> the ds_type whose targets fit its heads: the chains' and
#: UNet3P's level k at L / 2**k, the grids' at L
DS_TYPES = {"UNet": "UNet", "UNetE": "UNetPP", "UNetP": "UNetPP",
            "UNetPP": "UNetPP", "UNet3P": "UNet", "MultiResUNet": "UNet"}
#: (arch, W, D, ds, ag, transconv, kernel, alpha)
CASES = [
    ("UNet", 4, 3, 0, 0, 1, 3, 1.0), ("UNet", 4, 2, 1, 1, 0, 4, 1.0),
    ("UNetE", 4, 3, 0, 0, 1, 3, 1.0), ("UNetE", 4, 2, 1, 1, 1, 3, 1.0),
    ("UNetP", 4, 2, 1, 0, 0, 3, 1.0), ("UNetP", 4, 2, 0, 1, 1, 4, 1.0),
    ("UNetPP", 4, 3, 0, 0, 1, 3, 1.0), ("UNetPP", 4, 2, 1, 1, 0, 3, 1.0),
    ("UNet3P", 4, 3, 0, 0, 1, 3, 1.0), ("UNet3P", 4, 3, 1, 0, 1, 4, 1.0),
    ("MultiResUNet", 8, 2, 0, 0, 1, 3, 1.0),
    ("MultiResUNet", 8, 2, 1, 1, 0, 3, 1.67),
]


def _ids(c):
    return f"{c[0]}-W{c[1]}D{c[2]}-ds{c[3]}-ag{c[4]}-tc{c[5]}-k{c[6]}-a{c[7]}"


def _models(arch, W, D, ds, ag, tc, k, alpha):
    kw = dict(ds=ds, ag=ag, is_transconv=bool(tc), alpha=alpha)
    return (jax_selector_1d(arch, L, D, 2, W, k, **kw),
            model_selector_1d(arch, L, D, 2, W, k, **kw))


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_model_1d_float32_matches_jax(case):
    arch, W, D, ds, ag, tc, k, alpha = case
    jm, tm = _models(*case)
    ds_type = DS_TYPES[arch]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, L, 2)).astype(np.float32)
    y = (rng.uniform(size=(2, L, 1)) > 0.6).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), seed=3)
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(v.size for v in jax.tree.leaves(variables["params"])) == sum(
        p.numel() for p in tm.parameters())
    tm.load_state_dict(sd)

    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x))
    assert sorted(got) == sorted(want) and len(got) == 1 + D * ds
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].shape == w.shape, key
        assert float(np.abs(got[key].numpy() - w).max()) <= 1e-4, key
    assert float(np.asarray(want["out"]).std()) > 1e-3

    weights = default_ds_weights(D) if ds else None
    jy = (jax_prepare_train_dict(jnp.asarray(y), D, ds_type, spatial_rank=1)
          if ds else jnp.asarray(y))
    state = jstate.create_train_state(jm, jax.random.PRNGKey(0), x,
                                      _grad_capture(), variables=variables)
    step = jstate.make_train_step(jm, _grad_capture(),
                                  jlosses.get_loss("MeanAbsoluteError"),
                                  loss_weights=weights)
    state, jloss, _ = jax.jit(step)(state, jnp.asarray(x), jy)
    state = jax.tree.map(np.asarray, state)

    ty = (prepare_train_dict(torch.from_numpy(y), D, ds_type, spatial_rank=1)
          if ds else torch.from_numpy(y))
    names = dict(tm.named_parameters())
    tloss, _ = make_train_step(tm, make_optimizer("Adam", names.values(),
                                                  1e-3),
                               get_loss("MeanAbsoluteError"), weights)(
        torch.from_numpy(x), ty)
    assert abs(float(jloss) - float(tloss)) <= 1e-4
    jg = flax_to_state_dict({"params": state.opt_state}, names)
    assert max(float(v.abs().max()) for v in jg.values()) > 1e-3
    for key, p in names.items():
        assert float((jg[key] - p.grad).abs().max()) <= 1e-4, key
    stats = {k: v for k, v in tm.state_dict().items() if "running" in k}
    js = flax_to_state_dict({"batch_stats": state.batch_stats}, stats)
    for key, v in stats.items():
        assert float((js[key] - v).abs().max()) <= 1e-5, key


def test_multires_unet_d3_matches_jax():
    """The 1D MultiResUNet at D3 (W8, deep supervision, gates), where
    JAX's own float32 step is off its float64 step by more than 1e-4 (the
    one-channel branches at W8): held to the relative bar of
    tests/test_torch_recurrent_1d.py's ``assert_1d_model_matches_jax``
    (the port's float64 step within 1e-6 of JAX's; its float32 step
    within 1e-4 of JAX's float64 step, or four times JAX's own float32
    distance from it)."""
    from test_torch_recurrent_1d import assert_1d_model_matches_jax
    assert_1d_model_matches_jax("MultiResUNet", 8, 3, ds=1, ag=1)


@pytest.mark.parametrize("arch", sorted(DS_TYPES))
def test_config1_full_width_tree_maps_leaf_for_leaf(arch):
    """BASELINE config 1's size (W32 D3 L1024, k3, one channel): every
    flax leaf has its torch tensor of the converted shape and no torch
    key is left over (shapes only: ``jax.eval_shape``, no step)."""
    jm = jax_selector_1d(arch, 1024, 3, 1, 32, 3)
    tm = model_selector_1d(arch, 1024, 3, 1, 32, 3)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1024, 1)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_state_dict(dict(zeros), tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    for key, v in sd.items():
        assert v.shape == tm.state_dict()[key].shape, key


def test_flax_auto_names_inside_segmodel1d():
    """The encoder's and latent's blocks are direct children counted
    across both (ConvBlock_0 .. ConvBlock_{2D+1}, or MultiResBlock_<i>
    and ResPath_<i>), then the decoder and ``out``; UNetE without deep
    supervision builds (and names) only its last diagonal, two ConvBlocks
    a node."""
    for arch, children in (
            ("UNet", [f"ConvBlock_{i}" for i in range(8)]
             + ["ChainDecoder_0", "out"]),
            ("MultiResUNet", ["MultiResBlock_0", "ResPath_0",
                              "MultiResBlock_1", "ResPath_1",
                              "MultiResBlock_2", "ResPath_2",
                              "MultiResBlock_3", "ChainDecoder_0", "out"])):
        tm = model_selector_1d(arch, 64, 3, 1, 8, 3)
        assert [n for n, _ in tm.named_children()] == children
        jm = jax_selector_1d(arch, 64, 3, 1, 8, 3)
        params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 1)))["params"]
        assert sorted(params) == sorted(children)
    tm = model_selector_1d("UNetE", 64, 3, 1, 4, 3)
    dec = dict(tm.GridDecoder_0.named_children())
    assert sorted(dec) == sorted([f"ConvBlock_{i}" for i in range(6)]
                                 + [f"TransConv_{i}" for i in range(3)])


def test_bfloat16_forward_is_bf16_and_finite():
    tm = model_selector_1d("UNet3P", 64, 2, 1, 4, 3, ds=1,
                           dtype=torch.bfloat16)
    out = tm.train()(torch.randn(2, 64, 1))
    assert all(v.dtype == torch.bfloat16 and bool(torch.isfinite(v).all())
               for v in out.values())
    assert sorted(out) == ["level1", "level2", "out"]


def test_classification_head_is_a_softmax():
    tm = model_selector_1d("UNet", 32, 2, 1, 4, 3,
                           problem_type="Classification", output_nums=3)
    out = tm.eval()(torch.randn(2, 32, 1))["out"]
    assert out.shape == (2, 32, 3)
    assert torch.allclose(out.sum(-1), torch.ones(2, 32))


@pytest.mark.parametrize("arch,kw,error", [
    ("AlbUNet19", {}, ValueError),
    ("TernausNet12", {}, ValueError),
    ("MLMRSNet_V3", {}, ValueError),
    ("SAUNetPP", {}, ValueError),
    ("DenseInceptionUNet", {}, ValueError),
    ("LinkNet4P", {}, ValueError),
    ("FPN3P", {}, ValueError),
    ("MultiResUNet3P", {"lstm": 1}, NotImplementedError),
    ("AlbUNet", {}, ValueError),
    ("LinkNetX", {}, ValueError),
])
def test_unported_1d_models_raise(arch, kw, error):
    with pytest.raises(error, match=arch if error is ValueError else None):
        model_selector_1d(arch, 32, 2, 1, 4, 3, **kw)


def test_reinitialized_draws_the_same_architecture():
    tm = SegModel1D("UNetP", 4, 2, ds=1, in_channels=2)
    fresh = tm.reinitialized(torch.Generator().manual_seed(3))
    assert sorted(fresh.state_dict()) == sorted(tm.state_dict())
