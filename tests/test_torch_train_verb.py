"""The port's ``train`` verb as a whole on the CPU (``--device cpu``): a
tiny synthetic PNG folder, UNet++ W4/D3 at 32x32, 2 epochs.  It writes
``best.pt``, which the port's ``serve`` loads and answers with; its
history has the JAX driver's keys on the same INI; settings it does not
take raise before anything is written.  And the host-side pieces it is
made of (losses, metrics, callbacks, the loader's batch order, image
decode, synthetic data) against the JAX package's on the same numpy
inputs."""
import io
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu import drivers as jdrivers  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu.data import (  # noqa: E402
    generators as jgen, synthetic as jsyn)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    callbacks as jcb, losses as jlosses, metrics as jmetrics)
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jconfig)
from tf_1d_2d_segmentation_end2endpipelines_torch import drivers, serve  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch import eval as ev  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import (  # noqa: E402
    main as cli_main)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    generators, synthetic)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    callbacks, losses, metrics)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TrainConfig, load_train_config, save_train_config, unported_train_keys)

SIZE = 32
METRICS = ("BinaryAccuracy", "MeanSquaredError", "BinaryIoU",
           "BinaryCrossentropy")


def _write_data(root):
    x, y = synthetic.synthetic_images(6, SIZE, seed=0)
    synthetic.write_image_folder(os.path.join(root, "Train"), x, y)
    x, y = synthetic.synthetic_images(2, SIZE, seed=1)
    synthetic.write_image_folder(os.path.join(root, "Val"), x, y)


def _cfg(tmp, **kw):
    base = dict(train_dir=os.path.join(tmp, "Data", "Train"),
                val_dir=os.path.join(tmp, "Data", "Val"), imlength=SIZE,
                imwidth=SIZE, decoder_name="UNetPP", model_width=4,
                model_depth=3, dense_loop=1, batch_size=2, num_epochs=2,
                learning_rate=1e-3, loss_function="BCEDiceLoss",
                metric_list=METRICS, save_dir=os.path.join(tmp, "Results"),
                load_weights=False, seed=3)
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One run of the verb through the command line, on the CPU."""
    tmp = str(tmp_path_factory.mktemp("train_verb"))
    _write_data(os.path.join(tmp, "Data"))
    cfg = _cfg(tmp)
    ini = os.path.join(tmp, "Train_Configs.ini")
    save_train_config(cfg, ini)
    cli_main(["train", ini, "--device", "cpu"])
    return tmp, cfg, ini


def test_train_verb_writes_best_weights_that_serve_answers_with(trained):
    from PIL import Image

    tmp, cfg, _ = trained
    fold = os.path.join(cfg.save_dir, "Fold_1")
    want = ["best.pt", "best_optimizer.pt", "history.h5", "history.json"]
    if ev.have_matplotlib():
        want.append("history.png")
    assert sorted(os.listdir(fold)) == want
    with open(os.path.join(fold, "history.json")) as f:
        hist = json.load(f)
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
    # the config as trained, readable by both packages
    saved = os.path.join(cfg.save_dir, "Train_Configs.ini")
    assert load_train_config(saved) == cfg
    assert jconfig.load_train_config(saved).model_depth == 3

    server = serve.make_server(load_train_config(saved), fold, port=0,
                               max_batch=2, device="cpu")
    best = torch.load(os.path.join(fold, drivers.BEST_WEIGHTS),
                      weights_only=True)
    served = server.predictor.model.state_dict()
    assert all(torch.equal(served[k], best[k]) for k in best)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        buf = io.BytesIO()
        Image.fromarray(np.zeros((SIZE, SIZE, 3), np.uint8)).save(buf, "PNG")
        resp = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict",
            data=buf.getvalue(), method="POST"), timeout=60)
        assert resp.status == 200
        assert np.asarray(Image.open(io.BytesIO(resp.read()))).shape == (
            SIZE, SIZE)
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_test_verb_evaluates_the_trained_fold(trained, capsys):
    """``test Test_Configs.ini --device cpu`` on the fold the verb wrote:
    it restores ``best.pt`` (no warning) and scores every pixel of the
    validation folder."""
    import configparser

    tmp, cfg, _ = trained
    ini = os.path.join(tmp, "Test_Configs.ini")
    parser = configparser.ConfigParser()
    parser["TEST"] = {"test_dir": cfg.val_dir, "imheight": str(SIZE),
                      "imwidth": str(SIZE), "batch_size": "2",
                      "save_dir": cfg.save_dir}
    with open(ini, "w") as f:
        parser.write(f)
    cli_main(["test", ini, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "no 'best' checkpoint" not in out
    assert "Fold 1: overall accuracy" in out
    cm = np.loadtxt(os.path.join(cfg.save_dir, "test_results", "fold_1",
                                 "results_confusion_matrix.csv"),
                    delimiter=",", skiprows=1, usecols=(1, 2))
    assert cm.sum() == 2 * SIZE * SIZE


def test_history_keys_equal_the_jax_drivers(trained, tmp_path):
    """The JAX driver on the same INI (its own save_dir) gives the same
    history keys in the same order."""
    tmp, cfg, ini = trained
    jcfg = jconfig.load_train_config(ini)
    jcfg.save_dir = str(tmp_path / "jax")
    jcfg.num_epochs = 1
    want = jdrivers.train(config=jcfg)[1]
    with open(os.path.join(cfg.save_dir, "Fold_1", "history.json")) as f:
        got = json.load(f)
    assert list(got) == list(want)


def test_train_verb_resumes_from_best(trained, tmp_path):
    """load_weights = 1 restores best.pt and its optimizer state."""
    tmp, cfg, _ = trained
    import shutil
    save_dir = str(tmp_path / "again")
    shutil.copytree(cfg.save_dir, save_dir)
    out = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(out):
        drivers.train(config=_cfg(tmp, save_dir=save_dir, load_weights=True,
                                  num_epochs=1), device="cpu")
    assert "resumed from" in out.getvalue()


#: (key, value, further settings): UNet4P and UNet4PV2 are ported
#: (tests/test_torch_dense_input_2d.py trains them); what still raises for
#: them: UNet4PV2 at depth 7 (a pool by 128) and UNet4P on a backbone with
#: ImageNet weights, which are not in the repository
UNPORTED = [
    ("decoder_name", "UNet4PV2", {"model_depth": 7}), ("model_parallel", 2, {}),
    ("spatial_parallel", 2, {}), ("pipeline_parallel", 2, {}),
    ("zero1", True, {}),
    ("decoder_name", "UNet4P", {"encoder_mode": "pretrained_encoder",
                                "encoder_name": "ResNet50",
                                "encoder_weights": "imagenet"}),
]


@pytest.mark.parametrize("key,value,more", UNPORTED,
                         ids=[f"{k}-{v}" for k, v, _ in UNPORTED])
def test_unported_settings_raise_before_anything_is_written(tmp_path, key,
                                                            value, more):
    cfg = _cfg(str(tmp_path), **{key: value}, **more)
    with pytest.raises(NotImplementedError):
        drivers.train(config=cfg, device="cpu")
    assert not os.path.exists(cfg.save_dir)


@pytest.mark.parametrize("key,value", [
    ("augment", True), ("augment_device", True), ("patchify", True),
    ("accumulation_steps", 2), ("remat", "dots"), ("remat", "blocks"),
    ("ema_decay", 0.9), ("exact_resume", True), ("tensorboard_dir", "tb"),
])
def test_training_settings_pass_the_verbs_check(tmp_path, key, value):
    """The settings this verb takes since the rest of training was ported
    pass its check, which writes nothing."""
    cfg = _cfg(str(tmp_path), **{key: value})
    assert unported_train_keys(cfg) == []
    drivers._check_train_config(cfg)
    assert not os.path.exists(cfg.save_dir)


@pytest.mark.parametrize("settings,match", [
    (dict(augment=True, augment_device=True), "alternatives"),
    (dict(augment_device=True, patchify=True), "does not compose"),
    (dict(accumulation_steps=3), "divisible"),
], ids=["augment_twice", "device_augment_patches", "accumulation"])
def test_combinations_raise_before_anything_is_written(tmp_path, settings,
                                                       match):
    """The JAX verb's guards (drivers.py:207-220, :309-313), before the
    port's verb writes anything."""
    cfg = _cfg(str(tmp_path), **settings)
    with pytest.raises(ValueError, match=match):
        drivers.train(config=cfg, device="cpu")
    assert not os.path.exists(cfg.save_dir)


def test_train_verb_runs_on_cuda_by_default(tmp_path, monkeypatch):
    """No ``--device``: the GPU, and on a host without one an error before
    anything is written (never the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(str(tmp_path))
    ini = str(tmp_path / "t.ini")
    save_train_config(cfg, ini)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["train", ini])
    assert not os.path.exists(cfg.save_dir)


# ------------------------------------------ host pieces against the JAX ones

def _probs_and_targets(seed, shape=(2, 5, 6, 1)):
    rng = np.random.default_rng(seed)
    p = rng.uniform(size=shape).astype(np.float32)
    p.reshape(-1)[:3] = [0.0, 1.0, 1e-9]  # the clip's edges
    t = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    return t, p


@pytest.mark.parametrize("name", ["BinaryCrossentropy", "DiceLoss",
                                  "BCEDiceLoss"])
@pytest.mark.parametrize("channels", [1, 3])
def test_losses_and_their_gradients_equal_jax(name, channels):
    """Value within 1e-6 and gradient w.r.t. the prediction within 1e-6,
    the clip's edges included."""
    import jax

    t, p = _probs_and_targets(channels, (2, 5, 6, channels))
    want, jgrad = jax.value_and_grad(
        lambda q: jlosses.get_loss(name)(jnp.asarray(t), q))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    got = losses.get_loss(name)(torch.from_numpy(t), pt)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    assert float(np.abs(pt.grad.numpy() - np.asarray(jgrad)).max()) <= 1e-6


def test_loss_registry_refusals():
    for name in jlosses.LOSSES:  # every JAX name builds
        assert losses.get_loss(name) is losses.LOSSES[name]
    with pytest.raises(ValueError):
        losses.get_loss("NoSuchLoss")
    assert losses.default_ds_weights(3) == jlosses.default_ds_weights(3)
    t, p = _probs_and_targets(0)
    outs = {"out": p, "level1": p[:, ::2], "level9": p}
    tars = {"out": t, "level1": t[:, ::2]}
    w = {"out": 1.0, "level1": 0.9}
    want = jlosses.deep_supervision_loss(
        jlosses.bce_dice_loss, {k: jnp.asarray(v) for k, v in outs.items()},
        {k: jnp.asarray(v) for k, v in tars.items()}, w)
    got = losses.deep_supervision_loss(
        losses.bce_dice_loss,
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in outs.items()},
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in tars.items()}, w)
    assert abs(float(got) - float(want)) <= 1e-6


@pytest.mark.parametrize("name", METRICS)
def test_streaming_metrics_equal_jax(name):
    """Two updates, then the result, within 1e-6."""
    jm = jmetrics.make_metric(name)
    tm = metrics.make_metric(name)
    js, ts = jm.init(), tm.init(None)
    for seed in (0, 1):
        t, p = _probs_and_targets(seed)
        js = jm.update(js, jnp.asarray(t), jnp.asarray(p))
        ts = tm.update(ts, torch.from_numpy(t), torch.from_numpy(p))
    assert abs(float(tm.result(ts)) - float(jm.result(js))) <= 1e-6


def test_metric_registry_refusals():
    for name in jmetrics.METRIC_NAMES:  # every JAX name builds
        assert metrics.make_metric(name).name == name
    with pytest.raises(ValueError):
        metrics.make_metric("NoSuchMetric")


def test_callbacks_follow_the_same_sequence_as_jax():
    """EarlyStopping, ReduceLROnPlateau and BestTracker over one series of
    epoch logs make the same decisions as the JAX callbacks."""
    series = [1.0, 0.9, 0.95, 0.9, 0.89995, 0.7, 0.71, 0.72, 0.73, 0.74]
    pairs = [(cls(monitor="val_loss", patience=2),
              jcls(monitor="val_loss", patience=2))
             for cls, jcls in ((callbacks.EarlyStopping, jcb.EarlyStopping),
                               (callbacks.ReduceLROnPlateau,
                                jcb.ReduceLROnPlateau))]
    best, jbest = (callbacks.BestTracker("val_loss"),
                   jcb.BestTracker("val_loss"))
    lr = jlr = 1e-3
    for epoch, v in enumerate(series):
        logs = {"val_loss": v}
        (es, jes), (rl, jrl) = pairs
        es.on_epoch_end(epoch, logs)
        jes.on_epoch_end(epoch, logs)
        assert (es.stopped, es.wait, es.best) == (jes.stopped, jes.wait,
                                                  jes.best)
        lr = rl.on_epoch_end(epoch, logs, lr)
        jlr = jrl.on_epoch_end(epoch, logs, jlr)
        assert lr == jlr
        assert best.is_best(logs) == jbest.is_best(logs)
    for monitor in ("val_loss", "val_BinaryIoU", "MeanSquaredError"):
        assert callbacks.infer_mode(monitor) == jcb.infer_mode(monitor)


@pytest.mark.parametrize("shuffle,drop", [(True, False), (False, False),
                                          (True, True)])
def test_prefetch_loader_batches_equal_jax(tmp_path, shuffle, drop):
    """Same folder, same seed: the same batches in the same order over two
    epochs (images and masks equal), and the same validation split."""
    x, y = synthetic.synthetic_images(7, 16, seed=4)
    synthetic.write_image_folder(str(tmp_path), x, y)
    args = (str(tmp_path), (12, 16))
    ds, jds = (generators.SegmentationFolderDataset(*args),
               jgen.SegmentationFolderDataset(*args))
    kw = dict(shuffle=shuffle, seed=5, drop_remainder=drop)
    loader = generators.PrefetchLoader(ds, 3, **kw)
    jloader = jgen.PrefetchLoader(jds, 3, **kw)
    for _ in range(2):
        got, want = list(loader()), list(jloader())
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    tr, va = generators.split_dataset(ds, 0.3, seed=2)
    jtr, jva = jgen.split_dataset(jds, 0.3, seed=2)
    assert tr.indices == list(jtr.indices) and va.indices == list(
        jva.indices)


def test_loader_refuses_what_is_not_ported(tmp_path):
    """Nothing of the loader is refused any more: augment and patchify
    give batches (tests/test_torch_augment.py holds them to JAX's); an
    epoch without a batch still raises."""
    x, y = synthetic.synthetic_images(2, 8, seed=0)
    synthetic.write_image_folder(str(tmp_path), x, y)
    ds = generators.SegmentationFolderDataset(str(tmp_path), (8, 8))
    for kw in ({"augment": True}, {"patchify": True,
                                   "patch_shape": (4, 4)}):
        assert len(list(generators.PrefetchLoader(ds, 2, **kw)())) == 1
    with pytest.raises(ValueError, match="no batches"):
        generators.PrefetchLoader(ds, 3, drop_remainder=True)()


@pytest.mark.parametrize("mode,resample,size", [
    ("rgb", "lanczos", (12, 16)), ("grayscale", "nearest", (16, 16)),
    ("grayscale", "lanczos", (7, 9))])
def test_load_image_equals_jax(tmp_path, mode, resample, size):
    x, y = synthetic.synthetic_images(1, 16, seed=6)
    synthetic.write_image_folder(str(tmp_path), x, y)
    path = os.path.join(str(tmp_path), "images", "00000.png")
    got = generators.load_image(path, size, mode, resample, 255.0)
    want = jgen.load_image(path, size, mode, resample, 255.0)
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_synthetic_images_equal_jax():
    for classes in (1, 3):
        got = synthetic.synthetic_images(3, 24, classes=classes, seed=7)
        want = jsyn.synthetic_images(3, 24, classes=classes, seed=7)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
