"""The 1D models that pool by 32, which the port builds since its 1D pool
kernels take level 5 (``FACTORS_1D = (2, 4, 8, 16, 32)``), against the
JAX package's ``model_selector_1d`` with the same variables (random,
from numpy, converted by utils/flax_to_torch.py), on the CPU, where every
pool is the kernels' plain version: UNet3P, SelfUNet3P and
ConvMixerUNet3P at depth 6 (their full-scale skips pool encoder tap 0 by
32) and UNet4P at depth 7 (its dense encoder pools tap 1 by 32), at W4
on (2, 256, 2) signals, every torch key filled from a flax leaf and every
head in eval mode within 1e-4 of JAX's (in units of max(1, its size)).
``assert_deep_forward_matches_jax`` is the bar; R2UNet3P and MLMRSNet_V2
are in test_torch_deep_pools_1d_taps.py, the train steps in
test_torch_deep_pools_1d_steps.py (the files split to keep each short on
one test worker)."""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402
from test_torch_config2_models import scale_kernels  # noqa: E402
from test_torch_recurrent_1d import build_1d  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    api_1d)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pyramid)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

L = 256
#: the Self-ONN archs' signals and kernels are scaled: their cubes
#: overflow float32 on unit inputs (ROADMAP C.2), SelfUNet3P's at depth 6
#: with kernels at half their draws; at a quarter (the scale of
#: tests/test_torch_self_models.py) its output barely varies
SCALES = {"SelfUNet3P": (0.1, 0.5)}


def assert_deep_forward_matches_jax(arch, depth, level=5, width=4):
    """The forward of ``arch`` at ``depth`` and ``width``, which pools by
    2**level (eval mode, float32), equals JAX's within 1e-4 of max(1, its
    size), and it runs pools to ``level``: they pass through the 1D
    pyramid's plain version."""
    assert api_1d.deepest_pool_1d(arch, depth) == level
    x_scale, kernel_scale = SCALES.get(arch, (1.0, 1.0))
    jm, tm = build_1d(arch, width, depth, length=L)
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(2, L, 2)) * x_scale).astype(np.float32)
    variables = scale_kernels(random_variables(jm, jnp.asarray(x), seed=3),
                              kernel_scale)
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict(sd)
    want = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    levels = []
    wrapper = pyramid.maxpool1d_pyramid

    def spy(t, lv, wanted=None):
        levels.append(max(pyramid._wanted(lv, wanted)))
        return wrapper(t, lv, wanted)

    with mock.patch.object(pyramid, "maxpool1d_pyramid", spy), \
            torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x))
    assert max(levels) == level
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        assert got[key].shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1.0)
        assert float(np.abs(got[key].numpy() - w).max()) <= 1e-4 * scale, key
    assert float(want["out"].std()) > 1e-3


@pytest.mark.parametrize("arch,depth", [
    ("UNet3P", 6), ("SelfUNet3P", 6), ("ConvMixerUNet3P", 6), ("UNet4P", 7)])
def test_deep_1d_model_forward_equals_jax(arch, depth):
    assert_deep_forward_matches_jax(arch, depth)
