"""Config 4's MultiRes models (MultiResUNet with alpha 1 and 1.67, with
and without gates and deep supervision, and KSSNet) against the JAX
``SegModel`` with converted weights, held to ``assert_model_matches_jax``
with JAX's train step in float64 (moved from test_torch_config4_models.py,
whose ``assert_config4_model_matches_jax`` says why, to keep each file
short on one test worker)."""
import pytest

pytest.importorskip("torch")

from test_torch_config4_models import (  # noqa: E402
    assert_config4_model_matches_jax)

CASES = [("MultiResUNet", 8, 3, 0, 0, 1.0),
         ("MultiResUNet", 8, 2, 1, 0, 1.67),
         ("MultiResUNet", 8, 2, 1, 1, 1.0),
         ("KSSNet", 8, 2, 0, 1, 1.67)]


@pytest.mark.parametrize(
    "name,W,D,ds,ag,alpha", CASES,
    ids=[f"{n}-W{w}D{d}-ds{s}-ag{g}-a{a}" for n, w, d, s, g, a in CASES])
def test_config4_model_float32_matches_jax(name, W, D, ds, ag, alpha):
    assert_config4_model_matches_jax(name, W, D, ds, ag, alpha)
