"""UNet4P, UNet4PV2 and AHNet from scratch at depth 5 on 64x64, tap 1
pooled by 32, against the JAX ``SegModel`` with converted weights, held to
``assert_model_matches_jax`` (moved from test_torch_dense_input_2d.py,
whose docstring gives the bars, to keep each file short on one test
worker)."""
import pytest

pytest.importorskip("torch")

from test_torch_dense_input_2d import (  # noqa: E402
    assert_dense_input_model_matches_jax)

# (name, D, size, ds)
CASES = [("UNet4P", 5, 64, 0), ("UNet4PV2", 5, 64, 1), ("AHNet", 5, 64, 1)]


@pytest.mark.parametrize("name,D,size,ds", CASES,
                         ids=[f"{n}-D{d}-{s}px-ds{x}" for n, d, s, x in CASES])
def test_dense_input_model_matches_jax(name, D, size, ds):
    assert_dense_input_model_matches_jax(name, D, size, ds)
