"""The port's loss and metric registries against the JAX package's, and
the train verb's history with the clips, Nadam and seven metrics against
the JAX verb (moved from test_torch_registries.py, whose docstring gives
the bars, to keep each file short on one test worker)."""
import configparser
import json
import os
import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu import drivers as jdrivers  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    Trainer as JaxTrainer, losses as jlosses, metrics as jmetrics,
    optimizers as joptim)
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jconfig)
from tf_1d_2d_segmentation_end2endpipelines_torch import drivers  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import (  # noqa: E402
    main as cli_main)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import synthetic  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    losses, metrics, optimizers)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TrainConfig, load_train_config, save_train_config,
    unported_train_keys)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict, load_flax_variables, load_optax_state)
from test_torch_registries import (  # noqa: E402
    IOU, KERAS, SHORT)


def _loss_inputs(name, channels, seed=0):
    """Probabilities with the clip's edges (0, 1, 1e-9), errors of exactly
    0 and exactly 1 (Huber's delta), tied channel maxima (CategoricalHinge)
    and an all-zero channel vector (CosineSimilarity); integer labels for
    the sparse CCE, -1 among them (counted from the end)."""
    rng = np.random.default_rng(seed)
    shape = (2, 5, 6, channels)
    p = rng.uniform(size=shape).astype(np.float32)
    t = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    p.reshape(-1)[:3] = [0.0, 1.0, 1e-9]
    t.reshape(-1)[:3] = [0.0, 0.0, 1.0]    # |err| 0, 1 and ~1
    p[0, 1] = t[0, 1]                       # |err| exactly 0
    p[1, 1, 1] = 0.0                        # an all-zero channel vector
    if channels == 3:
        t[1, 0, 0], p[1, 0, 0] = [1, 0, 0], [0.2, 0.6, 0.6]  # tied maxima
    if name == "SparseCategoricalCrossentropy":
        t = rng.integers(0, channels, shape[:-1] + (1,)).astype(np.float32)
        t.reshape(-1)[0] = -1.0
    return t, p


def test_loss_registry_has_the_jax_names():
    assert list(losses.LOSSES) == list(jlosses.LOSSES)
    with pytest.raises(ValueError):
        losses.get_loss("NoSuchLoss")


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("name", list(jlosses.LOSSES))
def test_loss_and_its_gradient_equal_jax(name, channels):
    t, p = _loss_inputs(name, channels)
    want, jgrad = jax.value_and_grad(
        lambda q: jlosses.get_loss(name)(jnp.asarray(t), q))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    got = losses.get_loss(name)(torch.from_numpy(t), pt)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-4)


def test_sparse_cce_label_outside_the_channels_is_nan_as_in_jax():
    """JAX's ``take_along_axis`` fills NaN (no gradient) where ``gather``
    would fault."""
    p = np.full((1, 2, 2), 0.5, np.float32)
    t = np.array([[[1.0], [2.0]]], np.float32)
    want, jgrad = jax.value_and_grad(lambda q: jlosses.get_loss(
        "SparseCategoricalCrossentropy")(jnp.asarray(t), q))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    got = losses.get_loss("SparseCategoricalCrossentropy")(
        torch.from_numpy(t), pt)
    got.backward()
    assert np.isnan(float(want)) and np.isnan(float(got.detach()))
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jgrad))


_TH = [np.float32(0.5), np.float32(1 / 199), np.float32(100 / 199),
       np.float32(0.0), np.float32(1.0)]


def _metric_batch(name, seed, num_classes):
    """One batch for ``name``: integer labels for IoU and MeanIoU (both
    arguments) and for the sparse metrics (targets); one-hot targets and
    7 channels for the top-k accuracies; binary targets and probabilities
    with values exactly at thresholds otherwise."""
    rng = np.random.default_rng(seed)
    short = name[len(KERAS):] if name.startswith(KERAS) else name
    channels = 7 if "TopK" in short else max(num_classes, 3)
    shape = (2, 5, 6, channels)
    p = rng.uniform(size=shape).astype(np.float32)
    p.reshape(-1)[:len(_TH)] = _TH
    if short in ("IoU", "MeanIoU"):
        lab = rng.integers(0, num_classes, (2, 5, 6, 2)).astype(np.float32)
        return lab[..., :1], lab[..., 1:]
    if short.startswith("Sparse"):
        t = rng.integers(0, channels, shape[:-1] + (1,))
        return t.astype(np.float32), p
    if short in ("CategoricalAccuracy", "TopKCategoricalAccuracy",
                 "OneHotIoU", "OneHotMeanIoU", "CategoricalCrossentropy",
                 "CategoricalHinge"):
        t = np.eye(channels, dtype=np.float32)[
            rng.integers(0, num_classes, shape[:-1])]
        return t, p
    t = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    p[0, 0, 0] = t[0, 0, 0]  # Accuracy counts exact equality
    return t, p


def _stream(name, num_classes, batches=(0, 1, 2)):
    jm = jmetrics.make_metric(name, num_classes=num_classes)
    tm = metrics.make_metric(name, num_classes=num_classes)
    js, ts = jm.init(), tm.init(None)
    for seed in batches:
        t, p = _metric_batch(name, seed, num_classes)
        js = jm.update(js, jnp.asarray(t), jnp.asarray(p))
        ts = tm.update(ts, torch.from_numpy(t), torch.from_numpy(p))
    return float(tm.result(ts)), float(jm.result(js)), tm, ts


@pytest.mark.parametrize("name", jmetrics.METRIC_NAMES + SHORT)
def test_streamed_metric_equals_jax(name):
    got, want, _, _ = _stream(name, 2)
    assert np.isfinite(want)
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("num_classes", [2, 3])
@pytest.mark.parametrize("name", IOU)
def test_iou_family_sized_by_num_classes_equals_jax(name, num_classes):
    got, want, tm, ts = _stream(name, num_classes)
    assert ts["cm"].shape == (num_classes, num_classes)
    assert abs(got - want) <= 1e-6, (got, want)


@pytest.mark.parametrize("name", jmetrics.METRIC_NAMES)
def test_metric_states_merge_additively(name):
    """Two batches' states added key by key give the result of one stream
    over both (the JAX states merge with one psum)."""
    m = metrics.make_metric(name)
    states = []
    for seed in (0, 1):
        t, p = _metric_batch(name, seed, 2)
        states.append(m.update(m.init(None), torch.from_numpy(t),
                               torch.from_numpy(p)))
    merged = {k: states[0][k] + states[1][k] for k in states[0]}
    assert all(v.dtype == torch.float32 for v in merged.values())
    _, _, _, streamed = _stream(name, 2, batches=(0, 1))
    a, b = float(m.result(merged)), float(m.result(streamed))
    assert abs(a - b) <= 1e-6 * max(1.0, abs(b))


def test_metric_names_and_refusals():
    for name in jmetrics.METRIC_NAMES + SHORT:
        assert metrics.make_metric(name).name == name
    for bad in ("NoSuchMetric", KERAS + "AUC"):
        with pytest.raises(ValueError):
            metrics.make_metric(bad)
        with pytest.raises(ValueError):
            jmetrics.make_metric(bad)


@pytest.mark.parametrize("num_thresholds", [1, 3, 200])
def test_bucketize_counts_equal_the_broadcast_counts(num_thresholds):
    """Every threshold hit exactly, NaN, and values outside [0, 1]: the
    counts equal the broadcast's and the JAX ``_conf_counts``'s."""
    th = np.asarray(jmetrics._keras_thresholds(num_thresholds), np.float32)
    rng = np.random.default_rng(num_thresholds)
    p = np.concatenate([th, th, rng.uniform(-0.1, 1.1, 500).astype(
        np.float32), [np.nan, -1.0, 2.0]]).astype(np.float32)
    t = (rng.uniform(size=p.shape) > 0.4).astype(np.float32)
    tth = torch.from_numpy(th)
    got = metrics.conf_counts(torch.from_numpy(t), torch.from_numpy(p), tth)
    ref = metrics.conf_counts_broadcast(torch.from_numpy(t),
                                        torch.from_numpy(p), tth)
    want = jmetrics._conf_counts(jnp.asarray(t), jnp.asarray(p),
                                 jnp.asarray(th))
    for k in ("tp", "fp", "fn", "tn"):
        assert torch.equal(got[k], ref[k]), k
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert float((got["tp"] + got["fn"])[0]) == float(t.sum())


VERB_METRICS = ("MeanIoU", "OneHotMeanIoU", "AUC", "Precision", "Recall",
                "BinaryAccuracy", "tf.keras.metrics.TruePositives")


@pytest.fixture(scope="module")
def nadam_fold(tmp_path_factory):
    """The port's train verb through the command line on the CPU: W4/D2
    UNet 32x32, ``class_number = 2``, FocalLoss, Nadam with every clip,
    the IoU and threshold metrics, 1 epoch."""
    tmp = str(tmp_path_factory.mktemp("registries_verb"))
    for name, n, seed in (("Train", 4, 0), ("Val", 2, 1)):
        synthetic.write_image_folder(os.path.join(tmp, "Data", name),
                                     *synthetic.synthetic_images(n, 32,
                                                                 seed=seed))
    cfg = TrainConfig(
        train_dir=os.path.join(tmp, "Data", "Train"),
        val_dir=os.path.join(tmp, "Data", "Val"), imlength=32, imwidth=32,
        decoder_name="UNet", model_width=4, model_depth=2, batch_size=2,
        num_epochs=1, learning_rate=1e-3, class_number=2,
        loss_function="FocalLoss", optimizer_function="Nadam",
        clipnorm=0.5, clipvalue=0.05, global_clipnorm=1.0,
        metric_list=VERB_METRICS, save_dir=os.path.join(tmp, "Results"),
        load_weights=False, seed=3)
    ini = os.path.join(tmp, "Train_Configs.ini")
    save_train_config(cfg, ini)
    cli_main(["train", ini, "--device", "cpu"])
    return tmp, cfg, ini


def test_train_verb_history_equals_the_jax_verbs(nadam_fold, tmp_path):
    """Every metric under the JAX key, train and val, each value finite;
    the JAX verb on the same INI gives the same keys in the same order;
    both packages' Trainers size the IoU matrices by class_number + 1."""
    _, cfg, ini = nadam_fold
    with open(os.path.join(cfg.save_dir, "Fold_1", "history.json")) as f:
        got = json.load(f)
    for m in VERB_METRICS:
        for key in (m, f"val_{m}"):
            assert len(got[key]) == 1 and np.isfinite(got[key][0]), key
    jcfg = jconfig.load_train_config(ini)
    jcfg.save_dir = str(tmp_path / "jax")
    want = jdrivers.train(config=jcfg)[1]
    assert list(got) == list(want)
    trainer = drivers._make_trainer(cfg, drivers._build_model(cfg), "cpu")
    cm = [s["cm"] for s in trainer._metric_init() if "cm" in s]
    assert [tuple(c.shape) for c in cm] == [(3, 3), (3, 3)]
    assert isinstance(trainer.optimizer, optimizers.Nadam)
    assert len(trainer.optimizer._optimizer_step_pre_hooks) == 1  # clips
    parser = configparser.ConfigParser()
    parser.read(os.path.join(cfg.save_dir, "Train_Configs.ini"))
    assert float(parser["TRAIN"]["global_clipnorm"]) == 1.0
