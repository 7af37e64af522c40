"""One full train step of the 1D UNet3P that pools by 32 against the JAX
package's (tests/test_torch_recurrent_1d.py's
``assert_1d_model_matches_jax``: W4 on (2, 256, 2) signals, converted
random variables, MeanAbsoluteError, the loss and every gradient of the
port's float64 step within 1e-6 of JAX's, its float32 step within 1e-4
or the relative bar, every head in eval mode within 1e-4): at depth 6,
whose skip 0 is pooled by 2 .. 32, and at depth 5 with ``d_s = 1``,
whose targets pool the mask by 2 .. 32.  On the CPU no pool launches a
kernel."""
import pytest

pytest.importorskip("torch")

from test_torch_recurrent_1d import assert_1d_model_matches_jax  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pool_backward, pyramid)


@pytest.mark.parametrize("depth,ds", [(6, 0), (5, 1)])
def test_deep_unet3p_train_step_equals_jax(depth, ds):
    before = (pyramid.launches.value, pool_backward.launches.value)
    assert_1d_model_matches_jax("UNet3P", 4, depth, length=256, ds=ds)
    assert (pyramid.launches.value, pool_backward.launches.value) == before
