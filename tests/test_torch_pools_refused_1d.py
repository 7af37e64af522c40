"""The 1D models that pool by more than the port's 1D kernels take
(``FACTORS_1D``, pools by 2 to 64) are refused when they are built, so the
1D verbs raise before they write anything: ``train1d`` leaves ``save_dir``
unmade, ``test1d`` and ``predict1d`` raise when they build the model.  The
check (``models.api_1d.check_pools_1d``) refuses exactly the (arch, depth)
pairs whose first forward would pool by 128 (on 1024 samples at W4: UNet3P,
R2UNet3P, SelfUNet3P, ConvMixerUNet3P and MLMRSNet_V2 at depth 8, UNet4P
at depth 9; the JAX package builds and applies each of them), and each
arch one depth shallower, which pools by 64, builds and runs.  ``d_s = 1``
adds the train verb's targets, the mask pooled to level D.  (The test
names keep the pools by 32 their pairs were refused for before the 1D
kernels took them, then the pools by 64.)"""
import os

import pytest

torch = pytest.importorskip("torch")

from tf_1d_2d_segmentation_end2endpipelines_torch import drivers_1d  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    save_pt, synthetic_signals)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    api_1d)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    Signal1DConfig)

L = 1024
#: (arch, depth) of the first model of each arch that pools by 128
REFUSED = [("UNet3P", 8), ("R2UNet3P", 8), ("SelfUNet3P", 8),
           ("ConvMixerUNet3P", 8), ("MLMRSNet_V2", 8), ("UNet4P", 9)]


def _cfg(tmp, **over):
    x, y = synthetic_signals(4, length=L, seed=3)
    save_pt({"samples": x, "labels": y}, os.path.join(tmp, "Set.pt"))
    kw = dict(train_set=os.path.join(tmp, "Set.pt"),
              test_set=os.path.join(tmp, "Set.pt"), signal_length=L,
              model_width=4, kernel_size=3, batch_size=4, num_epochs=1,
              save_dir=os.path.join(tmp, "port"), load_weights=False)
    kw.update(over)
    return Signal1DConfig(**kw)


@pytest.mark.parametrize("arch,depth", REFUSED)
def test_verbs_refuse_pools_by_32_before_writing(tmp_path, arch, depth):
    cfg = _cfg(str(tmp_path), model_name=arch, model_depth=depth)
    with pytest.raises(NotImplementedError,
                       match=r"pools by 128.*FACTORS_1D = \(2, 4, 8, 16, 32, 64\)"):
        drivers_1d.train_1d(config=cfg, device="cpu")
    assert not os.path.exists(cfg.save_dir)
    assert not os.path.exists(os.path.join(cfg.save_dir,
                                           "Signal_Configs.ini"))
    out = str(tmp_path / "p.npz")
    for verb in (lambda: drivers_1d.test_1d(config=cfg, device="cpu"),
                 lambda: drivers_1d.predict_1d(config=cfg, out_path=out,
                                               device="cpu")):
        with pytest.raises(NotImplementedError, match="pools by 128"):
            verb()
    assert not os.path.exists(cfg.save_dir) and not os.path.exists(out)


@pytest.mark.parametrize("arch,depth", REFUSED)
def test_refused_pairs_are_those_whose_forward_pools_by_32(monkeypatch, arch,
                                                           depth):
    """Without the check the model builds, and its first forward raises
    at the pool by 128; one depth shallower, pooling by 64, it builds and
    runs (on 256 samples, which every level of these depths keeps)."""
    n = 256
    x = torch.zeros(1, n, 1)
    shallower = api_1d.model_selector_1d(
        arch, n, depth - 1, 1, 4, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert shallower.eval()(x)["out"].shape == (1, n, 1)
    monkeypatch.setattr(api_1d, "check_pools_1d", lambda *a, **k: None)
    model = api_1d.model_selector_1d(
        arch, n, depth, 1, 4, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="level 7|pool by 128"):
        model.eval()(x)


def test_deep_supervision_targets_by_32_are_refused(tmp_path):
    """``d_s = 1`` at depth 7 pools the mask to level 7 for its targets:
    ``train1d`` refuses it before writing (the model alone pools by 2);
    at depth 6, and with ``ds_type = UNetPP`` (no pooled targets), it
    passes the check."""
    cfg = _cfg(str(tmp_path), model_name="UNet", model_depth=7, d_s=1)
    with pytest.raises(NotImplementedError, match="d_s = 1.*pools by 128"):
        drivers_1d.train_1d(config=cfg, device="cpu")
    assert not os.path.exists(cfg.save_dir)
    assert api_1d.deepest_pool_1d("UNet", 7) == 1
    api_1d.check_pools_1d("UNet", 6, ds_targets=True)
    drivers_1d._check_signal_config(
        _cfg(str(tmp_path), model_name="UNet", model_depth=6, d_s=1))
    drivers_1d._check_signal_config(
        _cfg(str(tmp_path), model_name="UNet", model_depth=7, d_s=1,
             ds_type="UNetPP"))
