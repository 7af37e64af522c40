"""The port's evaluation modules against the JAX package's on the same
numpy inputs: the confusion matrix and its report, the helpers of
``segmetrics``, test-time augmentation (the views, and the averaged
prediction of a converted model), patchify, the results CSVs and the
figures."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.data import (  # noqa: E402
    patch as jpatch)
from tf_1d_2d_segmentation_end2endpipelines_tpu.eval import (  # noqa: E402
    reports as jreports, segmetrics as jseg, tta as jtta)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    state as jstate)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import patch  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.eval import (  # noqa: E402
    reports, segmetrics as seg, tta)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    load_flax_variables)


@pytest.mark.parametrize("n,size", [(2, 1000), (3, 4096), (5, 777)])
def test_confusion_matrix_and_report_equal_jax(n, size):
    """Two updates from random labels, numpy and torch inputs: the same
    int64 matrix as JAX's, and the same report, key for key."""
    rng = np.random.default_rng(n)
    cm, jcm = seg.init_confusion_matrix(n), jseg.init_confusion_matrix(n)
    for as_tensor in (False, True):
        t = rng.integers(0, n, (2, size // 2)).astype(np.int32)
        p = rng.integers(0, n, (2, size // 2)).astype(np.int32)
        args = (torch.from_numpy(t), torch.from_numpy(p)) if as_tensor \
            else (t, p)
        cm = seg.confusion_matrix_update(cm, *args)
        jcm = jseg.confusion_matrix_update(jcm, jnp.asarray(t),
                                           jnp.asarray(p))
    assert cm.dtype == np.int64 and np.array_equal(cm, jcm)
    labels = [f"class_{i}" for i in range(n)]
    got, want = seg.evaluation_table(cm, labels), jseg.evaluation_table(
        jcm, labels)
    assert list(got) == list(want)
    for key, w in want.items():
        assert np.array_equal(np.asarray(got[key]), np.asarray(w)), key
    assert np.array_equal(seg.per_class_binary_counts(cm),
                          jseg.per_class_binary_counts(jcm))


def test_confusion_matrix_int64_exact_above_2_24():
    """A running count past 2**24 stays exact (float32 would round
    2**24 + 3 to 2**24 + 4), and labels outside the table are dropped as
    JAX drops them."""
    cm = seg.init_confusion_matrix(2)
    cm[0, 0] = 2 ** 24
    cm = seg.confusion_matrix_update(cm, np.zeros(3, np.int32),
                                     np.array([0, 0, 0], np.int32))
    assert cm.dtype == np.int64 and cm[0, 0] == 2 ** 24 + 3
    t, p = np.array([0, 1, 2, 1]), np.array([0, 1, 1, 3])
    assert np.array_equal(
        seg.confusion_matrix_update(seg.init_confusion_matrix(2), t, p),
        jseg.confusion_matrix_update(jseg.init_confusion_matrix(2),
                                     jnp.asarray(t), jnp.asarray(p)))


def test_segmetrics_helpers_equal_jax():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 4, (3, 5))
    oh = seg.one_hot_encoding(labels, 4)
    assert np.array_equal(oh, jseg.one_hot_encoding(labels, 4))
    assert np.array_equal(seg.reverse_one_hot_encoding(oh), labels)
    t, p = rng.uniform(size=50), rng.uniform(size=50)
    assert seg.dice(t, p) == jseg.dice(t, p)
    pred = rng.uniform(size=(4, 6, 6, 3)).astype(np.float32)
    for classes in (1, 3):
        assert np.array_equal(seg.label_from_pred(pred, classes, 0.4),
                              jseg.label_from_pred(pred, classes, 0.4))


@pytest.mark.parametrize("name", sorted(tta.TTA_2D))
def test_tta_views_equal_jax_and_invert_exactly(name):
    x = np.random.default_rng(0).normal(size=(2, 6, 6, 3)).astype(np.float32)
    fwd, inv = tta.TTA_2D[name]
    jfwd, _ = jtta.TTA_2D[name]
    view = fwd(torch.from_numpy(x))
    assert np.array_equal(view.numpy(), np.asarray(jfwd(jnp.asarray(x))))
    assert torch.equal(inv(view), torch.from_numpy(x))


def test_parse_tta_equals_jax():
    for spec, square in (("", True), ("all", True), ("all", False),
                         ("hflip; vflip,rot180", False), ("none", True)):
        assert tta.parse_tta(spec, square=square) == jtta.parse_tta(
            spec, rank=2, square=square)
    for spec, square in (("rot90", False), ("shear", True)):
        with pytest.raises(ValueError):
            tta.parse_tta(spec, square=square)


def test_trainer_predict_with_tta_equals_jax():
    """A W4/D2 UNet++ with ``ds=1`` and converted weights: the port's
    ``Trainer.predict`` (every view in one forward) against JAX's
    ``make_tta_fn`` over its predict step, for every head, within 1e-5;
    without views it is the plain predict."""
    jm = JaxSegModel(decoder_name="UNetPP", model_width=4, model_depth=2,
                     ds=1)
    x = np.random.default_rng(1).uniform(size=(3, 16, 16, 3)).astype(
        np.float32)
    variables = random_variables(jm, jnp.asarray(x), seed=2)
    tm = SegModel("UNetPP", 4, 2, ds=1)
    load_flax_variables(tm, variables)
    trainer = Trainer(tm, device="cpu")
    state = jstate.create_train_state(jm, jax.random.PRNGKey(0),
                                      jnp.asarray(x), optax.identity(),
                                      variables=variables)
    base = jstate.make_predict_step(jm)
    views = ("hflip", "vflip", "rot90")
    want = jax.jit(jtta.make_tta_fn(lambda v: base(state, v), views))(
        jnp.asarray(x))
    got = trainer.predict(x, tta=views)
    assert sorted(got) == sorted(want) and len(got) == 3
    for k, w in want.items():
        assert got[k].dtype == np.float32
        assert float(np.abs(got[k] - np.asarray(w)).max()) <= 1e-5, k
    plain = trainer.predict(x)
    jplain = base(state, jnp.asarray(x))
    assert float(np.abs(plain["out"] - np.asarray(jplain["out"])).max()) \
        <= 1e-5
    assert float(np.abs(plain["out"] - got["out"]).max()) > 1e-4


@pytest.mark.parametrize("shape,patch_size,overlap", [
    ((64, 64, 3), 32, 0.0), ((64, 48, 1), 16, 0.5), ((40, 40), 16, 0.25)])
def test_patches_equal_jax_numpy_path(monkeypatch, shape, patch_size,
                                      overlap):
    """``create_patches`` and ``unpatchify`` against the JAX package's
    numpy path (its native path is taken on hosts with several cores; one
    core is reported to it here)."""
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    img = np.random.default_rng(3).uniform(size=shape).astype(np.float32)
    got, n = patch.create_patches(img, (patch_size, patch_size), overlap)
    want, jn = jpatch.create_patches(img, (patch_size, patch_size), overlap)
    assert n == jn and got.dtype == want.dtype and np.array_equal(got, want)
    back = patch.unpatchify(got, shape[:2], overlap)
    assert np.array_equal(back, jpatch.unpatchify(want, shape[:2], overlap))
    if overlap == 0.0:  # the patches tile the image
        assert np.array_equal(back, img)
    with pytest.raises(ValueError):
        patch.create_patches(img, (patch_size, patch_size + 1), overlap)


def _report(n=3):
    rng = np.random.default_rng(4)
    cm = seg.confusion_matrix_update(
        seg.init_confusion_matrix(n), rng.integers(0, n, 500),
        rng.integers(0, n, 500))
    return seg.evaluation_table(cm, [f"class_{i}" for i in range(n)])


def test_results_csvs_equal_jax(tmp_path):
    """The two CSVs, byte for byte as the JAX package's pandas fallback
    writes them (this host has no openpyxl, so JAX writes CSVs too)."""
    rep = _report()
    got = reports.export_results_sheet(rep, str(tmp_path / "port.xlsx"))
    want = jreports.export_results_sheet(rep, str(tmp_path / "jax.xlsx"))
    assert got == str(tmp_path / "port_results.csv")
    assert want == str(tmp_path / "jax_results.csv")
    for suffix in ("_results.csv", "_confusion_matrix.csv"):
        with open(tmp_path / f"port{suffix}") as f, \
                open(tmp_path / f"jax{suffix}") as g:
            assert f.read() == g.read(), suffix


def test_figures_are_drawn(tmp_path):
    rep = _report()
    rng = np.random.default_rng(5)
    yt, yp = rng.integers(0, 3, 300), rng.integers(0, 3, 300)
    ys = rng.uniform(size=(300, 3))
    assert reports.have_matplotlib()
    paths = [
        reports.plot_conf_mat(rep["confusion_matrix"], rep["labels"],
                              str(tmp_path / "cm.png")),
        reports.plot_multiclass_roc(yt, yp, 3, str(tmp_path / "roc.png"),
                                    y_score=ys),
        reports.plot_multiclass_precision_recall_curves(
            yt, yp, 3, str(tmp_path / "prc.png")),
        reports.plot_prediction_distributions(yt, yp,
                                              str(tmp_path / "dist.png")),
        reports.plot_sample_grid([rng.uniform(size=(8, 8, 3))] * 2,
                                 [yt[:64].reshape(8, 8)] * 2,
                                 [yp[:64].reshape(8, 8)] * 2,
                                 str(tmp_path / "grid.png")),
        reports.plot_history({"loss": [1.0, 0.5], "val_loss": [1.1, 0.7],
                              "BinaryIoU": [0.2, 0.4]},
                             str(tmp_path / "hist.png"), "BinaryIoU"),
    ]
    for p in paths:
        assert os.path.getsize(p) > 1000, p
