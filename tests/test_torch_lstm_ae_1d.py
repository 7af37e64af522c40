"""ConvLSTM fusion (``lstm = 1``) on the 1D chains and grids ported
before this slice (UNet, UNetE, UNetP, UNet++, MultiResUNet) and the
autoencoder bottleneck (``ae = 1``: ``FeatureExtractionBlock`` on the
pooled bottleneck, before the latent) on ``UNet1D`` archs and on the
four special families (after their bottleneck's first block), against
the JAX package under tests/test_torch_recurrent_1d.py's bar
(``assert_1d_model_matches_jax``: every leaf mapped, heads within 1e-4,
the port's float64 step equal to JAX's within 1e-6, its float32 step
within 1e-4 of JAX's float64 step or the stated relative bar)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_recurrent_1d import assert_1d_model_matches_jax  # noqa: E402

#: (arch, W, D, options)
CASES = [
    ("UNet", 4, 3, dict(lstm=1, ds=1)),
    ("UNetE", 4, 2, dict(lstm=1, ag=1)),
    ("UNetP", 4, 2, dict(lstm=1, ds=1, is_transconv=False)),
    ("UNetPP", 4, 2, dict(lstm=1, ag=1, ds=1)),
    ("MultiResUNet", 8, 2, dict(lstm=1, ag=1)),
    ("UNet", 4, 2, dict(ae=1, feature_number=16, ds=1)),
    ("MultiResUNet", 8, 2, dict(ae=1, feature_number=8)),
    ("R2UNetPP", 4, 2, dict(ae=1, feature_number=8)),
    ("BCDUNet", 8, 2, dict(ae=1, lstm=1, dense_loop=2, feature_number=8)),
    ("SEDUNet", 8, 2, dict(ae=1, se_ratio=4, feature_number=8)),
    ("IBAUNet", 8, 2, dict(ae=1, ag=1, feature_number=8)),
    ("NABNet", 8, 2, dict(ae=1, feature_number=8)),
]


def _ids(c):
    return f"{c[0]}-W{c[1]}D{c[2]}-" + "-".join(
        f"{k}{v}" for k, v in c[3].items())


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_lstm_and_ae_1d_match_jax(case):
    arch, W, D, kw = case
    tm = assert_1d_model_matches_jax(arch, W, D, **kw)
    names = dict(tm.named_children())
    if kw.get("ae"):
        assert "FeatureExtractionBlock_0" in names
