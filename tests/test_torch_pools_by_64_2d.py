"""The 2D models that pool by 64, which the port builds since its pool
kernels take level 6 (``FACTORS = (2, .., 64)``), against the JAX
``SegModel`` with the same random variables (converted by utils/
flax_to_torch.py), on the CPU, where every pool is the kernels' plain
version, at W2 on (2, 128, 128, 3):

- KSSNet at depth 6 (its MultiRes encoder pools tap 0 to levels 1-6):
  every head in eval mode within 1e-4 of max(1, its size) of JAX's
  float32 forward;
- UNet3P at depth 7 with ``d_s = 1`` (its full-scale decoder pools skip 0
  to levels 1-6, its targets the mask to level 7): the forward and one
  train step held to ``assert_model_matches_jax`` against JAX's float64
  step (the loss and every gradient within 1e-4, the running statistics
  within 1e-5)."""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402
from test_torch_config2_models import assert_model_matches_jax  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    SegModel)
from tf_1d_2d_segmentation_end2endpipelines_torch.models.segmodel import (  # noqa: E402
    deepest_pool)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pyramid)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

SIZE, W = 128, 2


def _models(name, depth, ds=0):
    kw = dict(output_nums=1, ds=ds, final_activation="sigmoid")
    return (JaxSegModel(decoder_name=name, model_width=W, model_depth=depth,
                        **kw),
            SegModel(name, W, depth, in_channels=3, **kw))


def test_kssnet_at_depth_6_forward_equals_jax():
    """KSSNet D6's forward (eval mode, float32) runs a pool to level 6 and
    equals JAX's within 1e-4 of max(1, its size)."""
    assert deepest_pool("KSSNet", 6, False) == 6
    jm, tm = _models("KSSNet", 6)
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), seed=3)
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict(sd)
    want = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    levels = []
    wrapper = pyramid.maxpool_pyramid

    def spy(t, lv, wanted=None):
        levels.append(max(pyramid._wanted(lv, wanted)))
        return wrapper(t, lv, wanted)

    with mock.patch.object(pyramid, "maxpool_pyramid", spy), \
            torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x))
    assert max(levels) == 6
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        assert got[key].shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1.0)
        assert float(np.abs(got[key].numpy() - w).max()) <= 1e-4 * scale, key
    assert float(want["out"].std()) > 1e-4


def test_unet3p_at_depth_7_with_ds_matches_jax():
    """UNet3P D7 with ``d_s = 1``: the forward and one train step against
    JAX's float64 step (the deep 2 x 2 bottom's training-mode BatchNorms
    amplify float32 rounding)."""
    assert deepest_pool("UNet3P", 7, False) == 6
    jm, tm = _models("UNet3P", 7, ds=1)
    assert_model_matches_jax(jm, tm, 1, "FullScaleDecoder_0", "UNet",
                             depth=7, size=SIZE, step_dtype=jnp.float64)
