"""The scales chip_smoke.py puts on the Self-ONN models' inputs against the
JAX package's overflow (moved from test_torch_self_models.py, whose
docstring gives the family's bars, to keep each file short on one test
worker): chip_smoke.SELF_1D_SCALE and SELF_2D_SCALE are the largest
scales at which JAX's float32 training forward of the Self archs at the
chip's widths is finite."""
import dataclasses
import json
import os
import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402
import chip_smoke  # noqa: E402
from test_torch_config2_models import assert_model_matches_jax  # noqa: E402
from test_torch_recurrent_1d import assert_1d_model_matches_jax  # noqa: E402
from test_torch_test_verb import _labels, _write_ini  # noqa: E402
from test_torch_verbs_1d import _cfg as _signal_cfg  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu import (  # noqa: E402
    drivers as jdrivers, drivers_1d as jdrivers_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.api_1d import (  # noqa: E402
    model_selector_1d as jax_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    Trainer as JaxTrainer)
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jconfig)
from tf_1d_2d_segmentation_end2endpipelines_torch import (  # noqa: E402
    drivers, drivers_1d, serve)
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import main  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    SegmentationFolderDataset, save_pt, synthetic, synthetic_signals)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    SegModel, model_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TestConfig as EvalConfig, TrainConfig, load_signal_config,
    load_train_config, save_train_config)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)


def test_chip_scales_are_the_largest_finite_ones():
    """``chip_smoke.SELF_1D_SCALE`` is the largest of 1, 0.3, 0.1, 0.03,
    0.01 and 0.001 at which JAX's float32 training forward of the three
    1D Self archs at W32/D3 (JAX's PRNGKey(0) weights) is finite on
    phase 29's 128 signals (SelfR2UNetPP's is not at any larger one,
    SelfUNetPP's and SelfUNet3P's are from 0.03 down);
    ``chip_smoke.SELF_2D_SCALE`` the largest of 1 and 0.3 at which the
    four 2D Self models' at W32/D4 are on two of phase 28's images (64 x
    64 here: SelfUNet overflows at 1 at this size too)."""
    def fwd(jm, x):
        variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x[:1])
        apply = jax.jit(lambda a: jm.apply(
            variables, a, train=True, mutable=["batch_stats"])[0]["out"])
        return lambda s: bool(jnp.isfinite(apply(x * np.float32(s))).all())

    x, _ = synthetic_signals(chip_smoke.N_SIG_TRAIN + chip_smoke.N_SIG_VAL
                             + chip_smoke.N_SIG_TEST, 1024,
                             seed=chip_smoke.SEED + 21)
    x = jnp.asarray(x[-chip_smoke.N_SIG_TEST:])
    scales = (1.0, 0.3, 0.1, 0.03, 0.01, 0.001)
    assert chip_smoke.SELF_1D_SCALE == scales[-1]
    r2 = fwd(jax_selector_1d("SelfR2UNetPP", 1024, 3, 1, 32, 3), x)
    assert [r2(s) for s in scales] == [False] * 5 + [True]
    for arch in ("SelfUNetPP", "SelfUNet3P"):
        finite = fwd(jax_selector_1d(arch, 1024, 3, 1, 32, 3), x)
        assert [finite(s) for s in scales] == [False] * 3 + [True] * 3
    x, _ = synthetic.synthetic_images(2, 64, seed=chip_smoke.SEED + 8)
    x = jnp.asarray(x)
    assert chip_smoke.SELF_2D_SCALE == 0.3
    for name in ("SelfUNet", "SelfUNetPP", "SelfUNet3P", "SelfFPN"):
        finite = fwd(JaxSegModel(
            decoder_name=name, model_width=32, model_depth=4,
            genre="FPN" if name == "SelfFPN" else "UNet"), x)
        assert finite(0.3)
        if name == "SelfUNet":
            assert not finite(1.0)
