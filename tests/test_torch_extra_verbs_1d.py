"""The 1D verbs on the last 1D families against the JAX verbs: ``train1d``
on the CPU writes the JAX verb's artifacts and history keys, then
``test1d`` and ``predict1d`` (through the command line) on the weights of
the fold JAX's ``train_1d`` trained, converted into the port's
``best.pt``, give JAX's metrics and predictions within 1e-4.  SAUNet
trains with DropBlock at keep_prob 0.9 (the draws are the port's own;
``test1d`` and ``predict1d`` draw nothing), LinkNetPP with ``d_s = 1`` on
``ds_type = UNetPP`` targets.  W4, D2, 64-sample signals."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_verbs_1d import _cfg, _data  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu import (  # noqa: E402
    drivers_1d as jdrivers_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jconfig)
from tf_1d_2d_segmentation_end2endpipelines_torch import drivers_1d  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import main  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import stochastic  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

CASES = {"SAUNet": dict(model_name="SAUNet", d_s=0, keep_prob=0.9,
                        block_size=3, tta=""),
         "LinkNetPP": dict(model_name="LinkNetPP", d_s=1, ds_type="UNetPP")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_signal_verbs_equal_jax(tmp_path, capsys, name):
    tmp = str(tmp_path)
    _data(tmp)
    cfg = _cfg(tmp, **CASES[name])
    jcfg = jconfig.Signal1DConfig(**dict(
        dataclasses.asdict(cfg), save_dir=os.path.join(tmp, "jax")))
    hist = drivers_1d.train_1d(config=cfg, device="cpu", verbose=0)
    jhist = jdrivers_1d.train_1d(config=jcfg)
    assert sorted(hist) == sorted(jhist) and len(hist["loss"]) == 2
    assert all(np.isfinite(hist["loss"]))

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
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert got[key].shape == want[key].shape
        assert float(np.abs(got[key] - want[key]).max()) <= 1e-4, key
    assert "wrote 6 predictions" in capsys.readouterr().out
    restored_model, _ = drivers_1d._restore_model_1d(cfg, "x", "cpu")
    assert stochastic.drawn_by_name(restored_model) == {}
