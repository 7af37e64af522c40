"""AlbUNet101 and 152 against the JAX package
(``assert_family_matches_jax`` of tests/test_torch_extra_models_1d.py), as
tests/test_torch_albunet_1d.py holds AlbUNet18, 34 and 50 (moved from it to
keep each file short on one test worker)."""
import pytest

pytest.importorskip("torch")

from test_torch_extra_models_1d import _ids, assert_family_matches_jax  # noqa: E402

#: (arch, W, D, options)
CASES = [
    ("AlbUNet101", 2, 2, dict(length=256, sensitive=True)),
    ("AlbUNet152", 2, 2, dict(length=256, sensitive=True)),
]


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_albunet_matches_jax(case):
    arch, W, D, kw = case
    assert_family_matches_jax(arch, W, D, **kw)
