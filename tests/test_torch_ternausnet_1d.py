"""TernausNet11, 13, 16 and 19 against the JAX package
(``assert_family_matches_jax`` of tests/test_torch_extra_models_1d.py, at
its bar: every leaf mapped, every head in eval mode, one
``make_train_step`` in float64 and float32 against JAX's float64 step),
with ``d_s``, ``a_g``, ``is_transconv`` and ``a_e`` (moved from that file
to keep each file short on one test worker)."""
import pytest

pytest.importorskip("torch")

from test_torch_extra_models_1d import _ids, assert_family_matches_jax  # noqa: E402

#: (arch, W, D, options)
CASES = [
    ("TernausNet11", 4, 2, dict(ds=1)),
    ("TernausNet13", 4, 2, dict(ag=1)),
    ("TernausNet16", 4, 2, dict(is_transconv=False)),
    ("TernausNet19", 4, 2, dict(ae=1, feature_number=8)),
]


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_family_matches_jax(case):
    arch, W, D, kw = case
    assert_family_matches_jax(arch, W, D, **kw)
