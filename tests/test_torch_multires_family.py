"""The rest of the MultiRes family, MultiResUNet3+ and KSSNet, against
the JAX ``SegModel`` with converted weights, at the bar of
tests/test_torch_config2_models.py; and KSSNet's encoder, which takes every
pool of an encoder tap from one pyramid launch."""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_config2_models import assert_model_matches_jax  # noqa: E402
from test_torch_config4_models import DECODERS, _models  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    encoders)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pool_backward, pyramid)


@pytest.mark.parametrize("name", ["MultiResUNet3P", "KSSNet"])
def test_multires_family_model_float32_matches_jax(name):
    """W8/D3 with deep supervision: MultiResUNet3+'s ResPaths of lengths 1
    and 2 on earlier decoder steps and its pooled skips, KSSNet's gated
    encoder taps and decoder stages.  JAX's train step in float64, for
    the reason tests/test_torch_config4_models.py gives."""
    jm, tm = _models(name, 8, 3, ds=1)
    assert_model_matches_jax(jm, tm, 1, *DECODERS[name], depth=3,
                             step_dtype=jnp.float64)


def _kssnet_grads(model, x, g, per_level):
    """Encoder taps, bottom and every gradient of ``sum(bottom * g)`` with
    KSSNet's tap pools from one ``maxpool_levels`` per tap, or
    (``per_level``) from one single-level pool per level."""
    levels = pyramid.maxpool_levels

    def separate(t, n, wanted=None):
        return [levels(t, lvl, (lvl,))[0]
                for lvl in (wanted or range(1, n + 1))]

    model.zero_grad()
    xt = x.detach().requires_grad_()
    with mock.patch.object(pyramid, "maxpool_levels",
                           side_effect=separate if per_level else levels):
        taps, bottom = model(xt)
    (bottom.float() * g).sum().backward()
    return ([t.detach() for t in taps], xt.grad,
            {k: p.grad.clone() for k, p in model.named_parameters()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kssnet_pools_each_tap_once_with_the_per_level_gradient(dtype):
    """KSSNet's encoder at D=4: one ``maxpool_levels`` call per tap (taps
    0..3 to levels 4, 3, 2, 1) beside the 4 pools by 2, and no kernel on
    the CPU; its taps and every gradient equal, bit for bit, those of one
    pool per level (which JAX's encoder takes, encoders.py:75), since the
    levels' gradients are summed from the highest level down."""
    enc = encoders.ScratchEncoder(
        "KSSNet", 3, 2, 4, dtype=dtype,
        generator=torch.Generator().manual_seed(0)).train()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(size=(2, 3, 32, 32)).astype(
        np.float32)).contiguous(memory_format=torch.channels_last)
    before = (pyramid.launches.value, pool_backward.launches.value)
    with mock.patch.object(pyramid, "maxpool_levels",
                           wraps=pyramid.maxpool_levels) as calls:
        taps, _ = enc(x)
    tap_calls = [c for c in calls.call_args_list if len(c.args) == 2]
    assert [c.args[1] for c in tap_calls] == [4, 3, 2, 1]
    assert all(c.args[0] is taps[k] for k, c in enumerate(tap_calls))
    assert [c.args[1:] for c in calls.call_args_list
            if len(c.args) == 3] == [(1, (1,))] * 4  # the encoder's pools
    g = torch.from_numpy(rng.normal(size=(2, 31, 2, 2)).astype(np.float32))
    state = {k: v.clone() for k, v in enc.state_dict().items()}
    got = _kssnet_grads(enc, x, g, per_level=False)
    enc.load_state_dict(state)
    want = _kssnet_grads(enc, x, g, per_level=True)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1])
    assert float(got[1].abs().max()) > 0
    for k, v in want[2].items():
        assert torch.equal(got[2][k], v), k
    assert (pyramid.launches.value, pool_backward.launches.value) == before
