"""R2UNet3P at depth 6 (its full-scale skips pool encoder tap 0 by 32)
and MLMRSNet_V2 at depth 6 (its decoder pools tap 0 by 32, its encoder
taps 1 .. 4 by up to 16) against the JAX package's ``model_selector_1d``:
test_torch_deep_pools_1d.py's ``assert_deep_forward_matches_jax`` (W4,
(2, 256, 2) signals, converted random variables, every head in eval mode
within 1e-4 of JAX's, level-5 pools run by the plain version)."""
import pytest

pytest.importorskip("torch")

from test_torch_deep_pools_1d import assert_deep_forward_matches_jax  # noqa: E402


@pytest.mark.parametrize("arch,depth", [("R2UNet3P", 6), ("MLMRSNet_V2", 6)])
def test_deep_1d_taps_forward_equals_jax(arch, depth):
    assert_deep_forward_matches_jax(arch, depth)
