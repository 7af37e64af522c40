"""The port's 1D verbs and their modules against the JAX package's: the
``[SIGNAL1D]`` INI read by both packages, ``.pt`` IO, the NILM metrics,
``train1d`` on the CPU, and ``test1d`` and ``predict1d`` on weights
converted from a fold the JAX ``train_1d`` trained (JAX's metrics and
predictions within 1e-4); what the port does not take raises before
anything is written.  Tiny sizes: W4, D2, 64-sample signals."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tf_1d_2d_segmentation_end2endpipelines_tpu import (  # noqa: E402
    drivers_1d as jdrivers_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.data import (  # noqa: E402
    pt_io as jpt_io)
from tf_1d_2d_segmentation_end2endpipelines_tpu.eval import (  # noqa: E402
    nilm as jnilm)
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jconfig)
from tf_1d_2d_segmentation_end2endpipelines_torch import (  # noqa: E402
    drivers_1d, eval as ev)
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import main  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    load_signal_dataset, load_signal_inputs, save_pt, synthetic_signals)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    Signal1DConfig, load_signal_config, resume_token, save_signal_config)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

L = 64


def _data(tmp):
    x, y = synthetic_signals(12, length=L, seed=3)
    save_pt({"samples": x, "labels": y}, os.path.join(tmp, "Train_Set.pt"))
    save_pt({"samples": x[:6], "labels": y[:6]},
            os.path.join(tmp, "Test_Set.pt"))
    return x, y


def _cfg(tmp, **over):
    kw = dict(train_set=os.path.join(tmp, "Train_Set.pt"),
              val_set=os.path.join(tmp, "Test_Set.pt"),
              test_set=os.path.join(tmp, "Test_Set.pt"),
              signal_length=L, model_name="UNet", model_depth=2,
              model_width=4, d_s=1, batch_size=4, num_epochs=2,
              learning_rate=1e-3, save_dir=os.path.join(tmp, "port"),
              load_weights=False, tta="flip")
    kw.update(over)
    return Signal1DConfig(**kw)


def test_signal_ini_is_read_by_both_packages(tmp_path):
    """The port writes what JAX reads and reads what JAX writes, field for
    field, and both fingerprint it with the same resume token."""
    cfg = _cfg(str(tmp_path), model_name="UNet3P", kernel_size=4, alpha=1.67,
               metric_list=("MeanSquaredError", "MeanAbsoluteError"),
               remat="conv_outs", ema_decay=0.9)
    path = str(tmp_path / "port.ini")
    save_signal_config(cfg, path)
    jcfg = jconfig.load_signal_config(path)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert jconfig.resume_token(jcfg) == resume_token(cfg)
    jpath = str(tmp_path / "jax.ini")
    jconfig.save_signal_config(jcfg, jpath)
    assert load_signal_config(jpath) == cfg


def test_pt_io_equals_jax(tmp_path):
    """Dict, tuple and bare containers, a channel-first (B, C, L) set and
    a (B, L) set load as the JAX readers load them, both ways."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40, 2)).astype(np.float32)
    y = rng.uniform(size=(3, 40)).astype(np.float32)
    cases = {"dict": {"samples": np.moveaxis(x, 1, 2), "labels": y},
             "tuple": (x, y)}
    for name, obj in cases.items():
        for writer in (save_pt, jpt_io.save_pt):
            path = str(tmp_path / f"{name}.pt")
            writer(obj, path)
            got = load_signal_dataset(path)
            want = jpt_io.load_signal_dataset(path)
            for g, w in zip(got, want):
                assert g.dtype == np.float32 and np.array_equal(g, w)
            assert got[0].shape == (3, 40, 2) and got[1].shape == (3, 40, 1)
            assert np.array_equal(load_signal_inputs(path),
                                  jpt_io.load_signal_inputs(path))
    save_pt(x, str(tmp_path / "bare.pt"))
    assert np.array_equal(load_signal_inputs(str(tmp_path / "bare.pt")), x)


def test_nilm_metrics_equal_jax():
    """Each NILM metric on the same nonnegative arrays equals the JAX
    function's, rounded the same way (the energy overlaps, summed in
    float32 on both sides, within one unit of their 4th decimal)."""
    rng = np.random.default_rng(1)
    g = np.abs(rng.normal(size=(5, 64, 1))).astype(np.float32)
    p = (g + rng.normal(scale=0.3, size=g.shape)).astype(np.float32)
    assert ev.construction_error(g, p) == jnilm.construction_error(g, p)
    assert ev.calculate_sae(g, p) == jnilm.calculate_sae(g, p)
    assert ev.calculate_ea(g, p) == jnilm.calculate_ea(g, p)
    for ours, theirs in ((ev.calculate_jeoi, jnilm.calculate_jeoi),
                         (ev.calculate_deoi, jnilm.calculate_deoi)):
        a, b = ours(g, p), theirs(g, p)
        assert 0.0 < a < 1.0 and abs(a - b) <= 1e-4 + 1e-9
    flat = np.ones((2, 8, 1), np.float32)  # zero variance: skipped
    assert np.isnan(ev.construction_error(flat, flat)["MAE"])


def test_verbs_1d_on_a_jax_trained_fold_equal_jax(tmp_path, capsys):
    """The port's ``train1d`` on the CPU writes the JAX verb's artifacts
    and history keys; then ``test1d`` and ``predict1d`` (through the
    command line) on the weights of the fold JAX's ``train_1d`` trained
    (converted into the port's ``best.pt``) give JAX's ``test_1d``
    metrics and ``predict_1d`` arrays within 1e-4, with the ``flip`` view
    and the deep-supervision heads."""
    tmp = str(tmp_path)
    _data(tmp)
    cfg = _cfg(tmp)
    jcfg = jconfig.Signal1DConfig(**dict(
        dataclasses.asdict(cfg), save_dir=os.path.join(tmp, "jax")))
    hist = drivers_1d.train_1d(config=cfg, device="cpu", verbose=0)
    jhist = jdrivers_1d.train_1d(config=jcfg)
    assert sorted(hist) == sorted(jhist) and len(hist["loss"]) == 2
    assert all(np.isfinite(hist["loss"]))
    for name in ("Signal_Configs.ini", "best.pt", "history.json"):
        assert os.path.exists(os.path.join(cfg.save_dir, name)), name
    assert load_signal_config(os.path.join(cfg.save_dir,
                                           "Signal_Configs.ini")) == cfg

    _, jtrainer, restored = jdrivers_1d._restore_trainer_1d(jcfg, "x")
    assert restored
    model, _ = drivers_1d._restore_model_1d(cfg, "x", "cpu")
    torch.save(flax_to_state_dict(
        {"params": jtrainer.state.params,
         "batch_stats": jtrainer.state.batch_stats}, model.state_dict()),
        os.path.join(cfg.save_dir, "best.pt"))
    ini = os.path.join(cfg.save_dir, "Signal_Configs.ini")
    main(["test1d", ini, "--device", "cpu"])
    want = jdrivers_1d.test_1d(config=jcfg)
    with open(os.path.join(cfg.save_dir, "test_metrics_1d.json")) as f:
        got = json.load(f)
    assert sorted(got) == sorted(want) and got["restored_checkpoint"]
    for key, w in want.items():
        if key != "restored_checkpoint":
            assert abs(got[key] - w) <= 1e-4 + 1e-9, key

    out = str(tmp_path / "port.npz")
    main(["predict1d", ini, "--device", "cpu", "--out", out])
    jout = jdrivers_1d.predict_1d(config=jcfg,
                                  out_path=str(tmp_path / "jax.npz"))
    got, want = np.load(out), np.load(jout)
    assert sorted(got.files) == sorted(want.files) == [
        "level1", "level2", "output"]
    for key in want.files:
        assert got[key].shape == want[key].shape
        assert float(np.abs(got[key] - want[key]).max()) <= 1e-4, key
    assert "wrote 6 predictions" in capsys.readouterr().out


@pytest.mark.parametrize("over,error", [
    ({"model_name": "AlbUNet19"}, ValueError),
    ({"model_name": "MLMRSNet_V3"}, ValueError),
    ({"model_name": "MultiResUNet3P", "lstm": 1}, NotImplementedError),
    ({"model_name": "TernausNet12"}, ValueError),
    ({"model_parallel": 2}, NotImplementedError),
    ({"spatial_parallel": 2}, NotImplementedError),
    ({"pipeline_parallel": 2}, NotImplementedError),
    ({"zero1": True}, NotImplementedError),
    ({"remat": "blocks"}, ValueError),
    ({"ds_type": "UNet4"}, ValueError),
    ({"accumulation_steps": 3}, ValueError),
])
def test_train1d_refuses_before_writing(tmp_path, over, error):
    cfg = _cfg(str(tmp_path), **over)
    with pytest.raises(error):
        drivers_1d.train_1d(config=cfg, device="cpu")
    assert not os.path.exists(cfg.save_dir)


def test_test1d_and_predict1d_refuse_before_writing(tmp_path):
    tmp = str(tmp_path)
    _data(tmp)
    cfg = _cfg(tmp, model_name="MultiResUNet3P", lstm=1)
    with pytest.raises(NotImplementedError, match="lstm"):
        drivers_1d.test_1d(config=cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="lstm"):
        drivers_1d.predict_1d(config=cfg, out_path=str(tmp_path / "p.npz"),
                              device="cpu")
    assert not os.path.exists(cfg.save_dir)
    assert not os.path.exists(str(tmp_path / "p.npz"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_1d_verbs_default_to_cuda_and_refuse_without_it(tmp_path):
    tmp = str(tmp_path)
    _data(tmp)
    cfg = _cfg(tmp)
    for verb in (drivers_1d.train_1d, drivers_1d.test_1d,
                 drivers_1d.predict_1d):
        with pytest.raises(RuntimeError, match="CUDA"):
            verb(config=cfg)
    assert not os.path.exists(cfg.save_dir)


def test_train1d_partial_batches_and_missing_val_set(tmp_path, capsys):
    """Fewer signals than a batch still train a step an epoch; a missing
    val_set warns and the monitor falls back to the train loss."""
    tmp = str(tmp_path)
    _data(tmp)
    cfg = _cfg(tmp, batch_size=32, d_s=0, num_epochs=1, tta="",
               val_set=os.path.join(tmp, "missing.pt"))
    hist = drivers_1d.train_1d(config=cfg, device="cpu")
    assert len(hist["loss"]) == 1 and "val_loss" not in hist
    out = capsys.readouterr().out
    assert "does not exist" in out and "[1 steps]" in out
