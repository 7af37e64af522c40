"""AlbUNet18, 34, 50, 101 and 152 against the JAX package
(``assert_family_matches_jax`` of tests/test_torch_extra_models_1d.py):
the strided stem and connectors, the residual groups with and without
bottleneck, ``a_e``, the Dense head; every leaf mapped, every head in eval
mode, one ``make_train_step`` in float64 and float32 against JAX's
float64 step.  AlbUNet101 and 152 are in test_torch_albunet_1d_deep.py
(split to keep each file short on one test worker)."""
import pytest

pytest.importorskip("torch")

from test_torch_extra_models_1d import _ids, assert_family_matches_jax  # noqa: E402

#: (arch, W, D, options)
CASES = [
    # AlbUNet's last group sees L / 32: at 64 samples a batch of two gives
    # its BatchNorms 4 values, whose float32 statistics round far apart
    # from the float64 ones in the deep bottleneck variants
    ("AlbUNet18", 4, 2, dict()),
    ("AlbUNet34", 4, 2, dict(ae=1, feature_number=8, length=256)),
    ("AlbUNet50", 4, 2, dict(length=1024)),
    # AlbUNet101 and 152: test_torch_albunet_1d_deep.py
]


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_albunet_matches_jax(case):
    arch, W, D, kw = case
    assert_family_matches_jax(arch, W, D, **kw)
