"""MLMRSNet, MLMRSNet_V2, LDNet, SAUNet, SAMultiResUNet, SelfSAUNet and
Dense_Inception_UNet against the JAX package (``assert_family_matches_jax``
of tests/test_torch_extra_models_1d.py): W4/D2 on (2, 64, 2) signals with
``d_s``, ``a_g``, ``a_e``, ``cardinality``, ``pooling_type`` and
``is_transconv`` where the family takes them; every leaf mapped, every
head in eval mode, one ``make_train_step`` in float64 and float32 against
JAX's float64 step.  The SAUNet family trains with DropBlock drawing
(``keep_prob`` 0.8): both packages run on the port's draws, replayed.
With ``d_s = 1`` each family trains on the targets that fit its heads
(MLMRSNet_V2's stride-2 heads on the ``UNet`` ones, LDNet's full-length
heads on ``UNetPP``) and raises, as JAX's step does, on the others."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_extra_models_1d import (  # noqa: E402
    _ids, assert_both_steps_raise, assert_family_matches_jax)

from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    model_selector_1d)

#: (arch, W, D, options)
CASES = [
    ("MLMRSNet", 4, 2, dict(ds=1, cardinality=3, pooling_type="mix",
                            reference32=True)),
    ("MLMRSNet", 4, 2, dict(is_transconv=False, ae=1, feature_number=8,
                            cardinality=2, pooling_type="max",
                            reference32=True)),
    ("MLMRSNet_V2", 4, 2, dict(ds=1)),
    ("LDNet", 4, 2, dict(ds=1, ds_type="UNetPP")),
    ("LDNet", 4, 3, dict(is_transconv=False, pooling_type="mix")),
    ("SAUNet", 4, 2, dict(ds=1, keep_prob=0.8, block_size=3)),
    ("SAUNet", 4, 2, dict(is_transconv=False, ae=1, feature_number=8,
                          keep_prob=1.0)),
    ("SAMultiResUNet", 4, 2, dict(keep_prob=0.8, block_size=4)),
    ("SelfSAUNet", 4, 2, dict(ds=1, keep_prob=0.8, block_size=3)),
    ("Dense_Inception_UNet", 4, 2, dict(ds=1, ag=1)),
]


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_family_matches_jax(case, monkeypatch):
    arch, W, D, kw = case
    assert_family_matches_jax(arch, W, D, monkeypatch=monkeypatch, **kw)


RAISES = [("MLMRSNet", "UNetPP"), ("MLMRSNet_V2", "UNetPP"),
          ("LDNet", "UNet"), ("SAUNet", "UNetPP"),
          ("Dense_Inception_UNet", "UNetPP")]


@pytest.mark.parametrize("arch,ds_type", RAISES)
def test_ds_heads_raise_where_jax_raises(arch, ds_type):
    kw = {"keep_prob": 1.0} if arch == "SAUNet" else {}
    assert_both_steps_raise(arch, 4, 2, ds_type, **kw)


def test_flax_names_and_odd_pool_input():
    """Per-type auto-names in flax's creation order; Dense-Inception's
    first DownsamplingBlock pools 1 + W channels (the odd-C route on the
    card); SAUNet's head is a softmax for two outputs."""
    sa = model_selector_1d("SelfSAUNet", 64, 2, 1, 4, 3)
    names = [n for n, _ in sa.named_children()]
    assert names[:3] == ["Oper_0", "DropBlock_0", "BatchNorm_0"]
    assert "SpatialAttention_0" in names and "OperTranspose_1" in names
    di = model_selector_1d("Dense_Inception_UNet", 64, 2, 1, 4, 3)
    assert di.InceptionResBlock_0.out_features == 5
    seen = []
    di.DownsamplingBlock_0.register_forward_pre_hook(
        lambda m, inp: seen.append(inp[0].shape[1]))
    di.eval()(torch.randn(2, 64, 1))
    assert seen == [5]
    ld = model_selector_1d("LDNet", 64, 3, 1, 4, 3)
    assert ld.MRPBlock_3.out_features == 16  # the latent: 2**(D-1) W
    two = model_selector_1d("SAUNet", 64, 2, 1, 4, 3, output_nums=2)
    out = two.eval()(torch.randn(2, 64, 1))["out"]
    assert torch.allclose(out.sum(-1), torch.ones(2, 64))
