"""The dense-input 2D family, UNet4P, UNet4PV2 and AHNet, against the JAX
``SegModel`` with converted weights, and the max pools by 32 their
encoders need at depth 5:

- each model at W4/D2-3 on 32x32 and at D5 on 64x64, with and without
  deep supervision, held to ``assert_model_matches_jax`` (heads in eval
  mode, the loss, every gradient and every running statistic of one
  float32 step against JAX's float64 step);
- level 5 of ``pyramid.maxpool_levels`` and ``pyramid.maxpool(·, 32)``
  against ``lax.reduce_window`` and its VJP, bit for bit, on plateaus;
- the encoders' pools: UNet4P pools each tap once (one launch storing
  every level a deeper block reads), AHNet one level of each fresh
  ResPath;
- every name of the JAX ``DECODER_NAMES`` from scratch at D2 and D5,
  leaf for leaf (``jax.eval_shape``: nothing runs);
- what still raises: a pool by 128 (a dense-input encoder at depth 7);
- the ``train``, ``test`` and ``predict`` verbs on AHNet and UNet4P.

The D5 models are in test_torch_dense_input_2d_deep.py (split to keep
each file short on one test worker)."""
import os
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_config2_models import assert_model_matches_jax  # noqa: E402
from test_torch_pool_factors import _check as check_pool_by  # noqa: E402
from test_torch_pool_factors import _input  # noqa: E402
from test_torch_pyramid_levels import _cotangents, _jax, _port  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.decoders import (  # noqa: E402
    DECODER_NAMES)
from tf_1d_2d_segmentation_end2endpipelines_torch import drivers  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    synthetic)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    SegModel)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pool_backward, pyramid)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TestConfig as EvalConfig, TrainConfig)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

#: the decoder module's flax name and the ds_type whose targets fit its
#: heads (the grids' at full resolution, the full-scale decoder's at
#: half, as UNet3+'s)
DECODERS = {"UNet4P": ("GridDecoder_0", "UNetPP"),
            "AHNet": ("GridDecoder_0", "UNetPP"),
            "UNet4PV2": ("FullScaleDecoder_0", "UNet")}
# (name, D, size, ds); the depth-5 cases are in
# test_torch_dense_input_2d_deep.py
CASES = [(name, D, 32, ds) for name in DECODERS
         for D, ds in ((2, 1), (3, 0))]


def _models(name, W, D, ds=0, **kw):
    kw = dict(output_nums=1, ds=ds, final_activation="sigmoid", **kw)
    return (JaxSegModel(decoder_name=name, model_width=W, model_depth=D,
                        **kw),
            SegModel(name, W, D, in_channels=3, **kw))


def assert_dense_input_model_matches_jax(name, D, size, ds):
    """W4: the encoder's gated taps (UNet4P/UNet4PV2 the taps' own pools,
    AHNet each through a fresh ResPath), the 4P/AH grid's sigmoid skip
    paths (AH through ``ResPath(j, W)``) or UNet3+'s decoder; at D5 tap 1
    pooled by 32.  JAX's step in float64 (the one-to-few-channel ResPaths
    at W4 make its own float32 step miss the bar, as the MultiRes models
    do, tests/test_torch_config4_models.py)."""
    jm, tm = _models(name, 4, D, ds)
    assert_model_matches_jax(jm, tm, ds, *DECODERS[name], depth=D,
                             size=size, step_dtype=jnp.float64)


@pytest.mark.parametrize("name,D,size,ds", CASES,
                         ids=[f"{n}-D{d}-{s}px-ds{x}" for n, d, s, x in CASES])
def test_dense_input_model_matches_jax(name, D, size, ds):
    assert_dense_input_model_matches_jax(name, D, size, ds)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["relu", "nan"])
def test_level_5_of_one_call_and_its_gradient_equal_jax(dtype, kind):
    """``maxpool_levels(x, 5)``: every level equals the JAX pool by 2**l and
    dx for a cotangent on each level equals ``jax.vjp`` of the separate
    pools, bit for bit, on post-ReLU plateaus (and NaN windows), with
    ragged edges (70 x 66: the floor cuts 6 rows and 2 columns at 32)."""
    from test_torch_pyramid_levels import _DTYPES

    jdt, tdt = _DTYPES[dtype]
    x = _input((2, 70, 66, 3), 5, kind)
    grads = _cotangents(x, 5, seed=2)
    y_t, dx_t = _port(x, 5, tdt, grads)
    y_j, dx_j = _jax(x, 5, jdt, grads)
    assert [y.shape[1:3] for y in y_t] == [(35, 33), (17, 16), (8, 8),
                                           (4, 4), (2, 2)]
    for a, b in zip(y_t, y_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dx_t, dx_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["relu", "coarse", "nan"])
def test_pool_by_32_and_its_gradient_equal_jax(dtype, kind):
    """``pyramid.maxpool(·, 32)`` (level 5 alone, and ``maxpool_backward``
    with window 32) against ``jax.vjp`` of the JAX ``downsample_pool``:
    XLA routes each window's gradient to its first maximum in row-major
    order over the whole 32 x 32 window."""
    dx = check_pool_by(_input((2, 70, 66, 2), 32, kind), 32, dtype)
    assert float(np.abs(dx[:, 64:]).max()) == 0.0  # the rows cut off


def test_pool_by_32_routes_a_tie_across_the_window_in_row_major_order():
    """Ones at (0, 20) and (3, 1) of a zero 32 x 32 window: the walk keeps
    (0, 20), where walks of nested smaller windows would not."""
    x = np.zeros((1, 32, 32, 1), np.float32)
    x[0, 0, 20, 0] = x[0, 3, 1, 0] = 1.0
    dx = check_pool_by(x, 32, "float32")
    assert np.argwhere(dx[0, :, :, 0] != 0).tolist() == [[0, 20]]


def _spied_pools(model, x):
    """The pyramid calls (their wanted levels) and the pool gradients
    (their windows) of one training forward and backward of ``model``."""
    with mock.patch.object(pyramid, "maxpool_pyramid",
                           wraps=pyramid.maxpool_pyramid) as fwd, \
            mock.patch.object(pyramid, "maxpool_backward",
                              wraps=pool_backward.maxpool_backward) as bwd:
        model.train()(x)["out"].float().sum().backward()
    return ([tuple(c.args[2]) for c in fwd.call_args_list],
            sorted(c.args[2] for c in bwd.call_args_list))


@pytest.mark.parametrize("name", ["UNet4P", "UNet4PV2", "AHNet"])
def test_encoder_pools_as_the_chip_counts_them(name):
    """At D4: UNet4P and UNet4PV2 pool encoder taps 0..3 once each, to
    levels 1-4, 1-3, 1-2 and 1 (4 calls, 10 pool gradients; UNet4PV2's
    decoder adds UNet3+'s 3 + 6); AHNet pools one level of a fresh
    ResPath for each (block, tap) pair and each block's chain pool by 2
    (14 + 14).  The CPU counts no kernel launch."""
    torch.manual_seed(0)
    model = SegModel(name, 2, 4, generator=torch.Generator().manual_seed(1))
    x = torch.rand(1, 32, 32, 3)
    before = (pyramid.launches.value, pool_backward.launches.value)
    calls, windows = _spied_pools(model, x)
    assert (pyramid.launches.value, pool_backward.launches.value) == before
    if name == "AHNet":
        # per block i: its ResPath pools of taps 0 .. i-1, then its chain
        # pool; the order JAX's encoder takes them in
        want = []
        for i in range(1, 5):
            want += [(i - k,) for k in range(i)] + [(1,)]
        assert calls == want
        assert windows == sorted([2 ** lvl for lvl, in want])
        return
    enc = [(1, 2, 3, 4), (1, 2, 3), (1, 2), (1,)]
    assert calls[:4] == enc
    enc_windows = [2 ** lvl for levels in enc for lvl in levels]
    if name == "UNet4P":
        assert calls == enc and windows == sorted(enc_windows)
    else:  # UNet3+'s pooled skips: skips 0, 1, 2 to levels 3, 2, 1
        assert calls[4:] == [(1, 2, 3), (1, 2), (1,)]
        assert windows == sorted(enc_windows + [2, 4, 8, 2, 4, 2])


@pytest.mark.parametrize("name", DECODER_NAMES)
@pytest.mark.parametrize("D", [2, 5])
def test_every_decoder_from_scratch_maps_leaf_for_leaf(name, D):
    """Each of the 16 ``DECODER_NAMES`` at W4 from scratch: every flax
    leaf has a torch key of the converted shape and vice versa, and the
    parameter counts agree.  Shapes only; nothing runs."""
    jm, tm = _models(name, 4, D)
    size = 2 ** D * 2
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        shapes["params"])) == sum(p.numel() for p in tm.parameters())


def test_pools_by_64_raise_when_the_model_is_built():
    """A from-scratch dense-input or KSSNet encoder at depth 7 pools tap 1
    by 128, a full-scale decoder at depth 8 its first skip: the port's pool
    kernels stop at 64, so these raise ``NotImplementedError`` before
    anything runs (the JAX package builds them); one depth shallower, the
    pools by 64, they build.  A backbone at depth 6 raises the
    ``ValueError`` both packages raise."""
    for name in ("UNet4P", "UNet4PV2", "AHNet", "KSSNet"):
        SegModel(name, 2, 6)
        with pytest.raises(NotImplementedError, match="pools by 128"):
            SegModel(name, 2, 7)
    SegModel("UNet3P", 2, 7)
    with pytest.raises(NotImplementedError, match="pools by 128"):
        SegModel("UNet3P", 2, 8)
    with pytest.raises(ValueError, match="1 to 5"):
        SegModel("UNet4P", 2, 6, train_mode="pretrained_encoder",
                 backbone="MobileNet")


SIZE = 32


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    """One epoch of the ``train`` verb on the CPU for AHNet and UNet4P
    (W4/D3, 32x32), on one small synthetic folder."""
    tmp = str(tmp_path_factory.mktemp("dense_input_verbs"))
    for sub, n, seed in (("Train", 4, 0), ("Val", 2, 1), ("Test", 3, 2)):
        x, y = synthetic.synthetic_images(n, SIZE, seed=seed)
        synthetic.write_image_folder(os.path.join(tmp, "Data", sub), x, y)
    out = {}
    for name in ("AHNet", "UNet4P"):
        cfg = TrainConfig(
            train_dir=os.path.join(tmp, "Data", "Train"),
            val_dir=os.path.join(tmp, "Data", "Val"), imlength=SIZE,
            imwidth=SIZE, decoder_name=name, model_width=4, model_depth=3,
            batch_size=2, num_epochs=1, learning_rate=1e-3,
            loss_function="BCEDiceLoss", metric_list=("BinaryIoU",),
            save_dir=os.path.join(tmp, f"Results{name}"), seed=3)
        drivers.train(config=cfg, device="cpu")
        out[name] = cfg
    return tmp, out


@pytest.mark.parametrize("name", ["AHNet", "UNet4P"])
def test_verbs_train_test_and_predict_the_dense_input_models(folds, name):
    """``train`` writes the fold's ``best.pt``; ``test`` restores it and
    labels every pixel of the test images; ``predict`` writes one mask an
    image."""
    tmp, cfgs = folds
    cfg = cfgs[name]
    assert os.path.isfile(os.path.join(cfg.save_dir, "Fold_1", "best.pt"))
    test_dir = os.path.join(tmp, "Data", "Test")
    rep = drivers.test(config=EvalConfig(
        test_dir=test_dir, imheight=SIZE, imwidth=SIZE, batch_size=2,
        save_dir=cfg.save_dir), train_config=cfg, device="cpu")[1]
    assert rep["checkpoint_restored"] is True
    assert int(rep["confusion_matrix"].sum()) == 3 * SIZE * SIZE
    masks = drivers.predict(cfg, input_path=os.path.join(test_dir, "images"),
                            out_dir=os.path.join(tmp, f"masks{name}"),
                            batch=2, device="cpu")
    assert len(masks) == 3 and all(os.path.isfile(m) for m in masks)
