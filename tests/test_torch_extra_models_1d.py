"""TernausNet, LinkNet and the 1D FPN against the JAX package
(``assert_family_matches_jax``, which tests/test_torch_albunet_1d.py and
tests/test_torch_mlmrs_saunet_1d.py hold their families to as well):
every method name at W4 on (2, 64, 2)
signals (D2 where the family takes a depth; TernausNet's and AlbUNet's
depth is fixed), with ``d_s``, ``a_g``, ``lstm``, ``a_e`` and
``is_transconv`` where the family takes them: every leaf mapped, every
head in eval mode, one ``make_train_step`` in float64 and float32 against
JAX's float64 step.  With ``d_s = 1`` each family trains on the targets
that fit its heads and raises, as JAX's step does, on the others
(AlbUNet on both: its heads are half their targets' length); the flax
auto-names of the new trees.  TernausNet's models are in
test_torch_ternausnet_1d.py (split to keep each file short on one test
worker)."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402
from test_torch_config2_models import _grad_capture  # noqa: E402
from test_torch_pool1d import torch_to_nlc  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.data.pyramid import (  # noqa: E402
    prepare_train_dict as jax_prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.api_1d import (  # noqa: E402
    model_selector_1d as jax_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    losses as jlosses, state as jstate)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    model_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import stochastic  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    default_ds_weights, get_loss, make_optimizer, make_train_step)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

ATOL = 1e-4


def build(arch, W, D, kernel=3, length=64, dtype=None, **kw):
    """The JAX and the port's model of ``arch`` on two-channel signals."""
    jm = jax_selector_1d(arch, length, D, 2, W, kernel, **kw)
    tkw = {} if dtype is None else {"dtype": dtype}
    return jm, model_selector_1d(arch, length, D, 2, W, kernel, **kw, **tkw)


def _data(length):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, length, 2)).astype(np.float32)
    y = (rng.uniform(size=(2, length, 1)) > 0.6).astype(np.float32)
    return x, y


def _drawn_in_order(model, x):
    """The draws of a training forward of a copy of ``model`` on ``x``, in
    the order its stochastic layers run: [(name, draws)]."""
    m = copy.deepcopy(model).train()
    order = []
    for name, layer in stochastic.stochastic_layers(m).items():
        layer.register_forward_hook(
            lambda mod, inp, out, n=name: order.append(n))
    with torch.no_grad(), stochastic.random_stream(
            torch.Generator().manual_seed(11)):
        m(x)
    drawn = stochastic.drawn_by_name(m)
    return [(n, drawn[n]) for n in order if n in drawn]


class ReplayedBernoulli:
    """``jax.random.bernoulli`` replaced by the port's draws, in call
    order, as (B, L, C) arrays."""

    def __init__(self, draws):
        self.draws = [np.asarray(torch_to_nlc(d.float())) > 0
                      for d in draws]

    def __call__(self, key, p, shape):
        want = self.draws.pop(0)
        assert tuple(shape) == want.shape
        return jnp.asarray(want)


def _jax_targets(y, D, ds, ds_type):
    return (jax_prepare_train_dict(jnp.asarray(y), D, ds_type,
                                   spatial_rank=1) if ds else jnp.asarray(y))


def _port_targets(y, D, ds, ds_type):
    return (prepare_train_dict(torch.from_numpy(y), D, ds_type,
                               spatial_rank=1)
            if ds else torch.from_numpy(y))


def _port_step(model, x, targets, weights):
    params = dict(model.named_parameters())
    loss, _ = make_train_step(model, make_optimizer(
        "Adam", params.values(), 1e-3), get_loss("MeanAbsoluteError"),
        weights)(torch.from_numpy(x), targets)
    return float(loss), params


def _scaled(a, b):  # |a - b| in units of max(1, |b|)
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def assert_family_matches_jax(arch, W, D, kernel=3, length=64,
                              ds_type="UNet", monkeypatch=None,
                              sensitive=False, reference32=False, **kw):
    """``arch`` built by both packages' ``model_selector_1d`` (``kw``: its
    options) on (2, ``length``, 2) signals with random variables: every
    torch key filled from a flax leaf, the parameter counts equal; every
    head in eval mode within 1e-4 (of max(1, its size)) of JAX's; one
    training step (MeanAbsoluteError, the DS heads on ``ds_type`` targets
    weighted by ``default_ds_weights(D)``): the port's in float64 against
    JAX's in float64 within 1e-6 (loss, every gradient in units of
    max(1, its size)), the port's in float32 within 1e-4 of it (the loss)
    and within ``bar`` (every gradient), the new running statistics
    within 1e-5.  ``bar`` is 1e-4 or, where the port misses it, four
    times JAX's own float32 step's distance from its float64 step.  With
    DropBlock drawing (``keep_prob`` < 1) both packages run on the port's
    draws, replayed (``monkeypatch`` patches ``jax.random.bernoulli``).
    JAX's eval forward and its float64 step are one compiled program.

    ``sensitive`` (AlbUNet101 and AlbUNet152, whose 25 and 37 bottleneck
    units deep last groups make a random-init step's gradients hang on
    rounding: JAX's own float64 step moves its stem's gradient by 2e-5 of
    its size when the input changes by 1e-13 of its own): the port's
    float64 step is held to four times that change of JAX's float64 step
    (loss, gradients, running statistics) where it exceeds the plain
    bars, and its float32 step, AlbUNet50's code, only to a finite loss.

    ``reference32`` (MLMRSNet): JAX's float64 step is no reference there,
    its gradients at the first MRP block lie 2.5e-2 (of their size) from
    its own float32 step's, while the port's float32 and float64 steps
    agree within 4e-5; both of the port's steps are held to JAX's
    float32 step instead (loss 1e-4, running statistics 1e-5, gradients
    1e-4 or, where that is missed, four times the port's own float32
    step's distance from its float64 step).
    Returns the port's model."""
    jm, tm = build(arch, W, D, kernel, length, **kw)
    ds = kw.get("ds", 0)
    x, y = _data(length)
    variables = random_variables(jm, jnp.asarray(x), seed=3)
    sd = flax_to_state_dict(variables, tm.state_dict())
    assert sorted(sd) == sorted(tm.state_dict())
    assert sum(v.size for v in jax.tree.leaves(variables["params"])) == sum(
        p.numel() for p in tm.parameters())
    tm.load_state_dict(sd)
    tm64 = model_selector_1d(arch, length, D, 2, W, kernel,
                             dtype=torch.float64, **kw)
    tm64.load_state_dict(sd)
    draws = _drawn_in_order(tm, torch.from_numpy(x))
    if draws:
        assert all(d.any() for _, d in draws)
        for m in (tm, tm64):
            stochastic.replay(m, dict(draws))
    weights = default_ds_weights(D) if ds else None

    def jax_step(dtype, with_eval, x_factor=1.0):
        if draws:
            monkeypatch.setattr(jax.random, "bernoulli", ReplayedBernoulli(
                [d for _, d in draws]))
        with jax.enable_x64(dtype == jnp.float64):
            def cast(tree):
                return jax.tree.map(lambda a: np.asarray(a).astype(dtype),
                                    tree)

            step_model = jm.clone(dtype=dtype)
            state = jstate.create_train_state(
                step_model, jax.random.PRNGKey(0), cast(x), _grad_capture(),
                variables=cast(variables))
            step = jstate.make_train_step(
                step_model, _grad_capture(),
                jlosses.get_loss("MeanAbsoluteError"), loss_weights=weights)

            def both(state, xs, ys):
                out = (step_model.apply({"params": state.params,
                                         "batch_stats": state.batch_stats},
                                        xs, train=False)
                       if with_eval else None)
                return out, step(state, xs, ys)

            out, (state, loss, _) = jax.jit(both)(
                state, cast(x) * x_factor,
                cast(_jax_targets(y, D, ds, ds_type)))
            return (jax.tree.map(lambda a: np.asarray(a).astype(np.float32),
                                 out), float(loss),
                    jax.tree.map(lambda a: np.asarray(a).astype(np.float32),
                                 state))

    if reference32:
        want, jloss, state = jax_step(jnp.float32, True)
        _check_eval(tm, x, want)
        targets = _port_targets(y, D, ds, ds_type)
        loss64, names64 = _port_step(tm64, x, targets, weights)
        tloss, names = _port_step(tm, x, targets, weights)
        jg = flax_to_state_dict({"params": state.opt_state}, names)
        own = max(_scaled(p.grad, names64[k].grad.float())
                  for k, p in names.items())
        bar = ATOL
        if any(_scaled(p.grad, jg[k]) > bar for k, p in names.items()):
            bar = max(ATOL, 4 * own)
        for loss in (loss64, tloss):
            assert abs(jloss - loss) <= ATOL
        for key, p in names.items():
            for grad in (p.grad, names64[key].grad.float()):
                assert _scaled(grad, jg[key]) <= bar, (key, bar)
        _check_stats(tm, state)
        return tm
    want, jloss, state = jax_step(jnp.float64, True)
    _check_eval(tm, x, want)

    targets = _port_targets(y, D, ds, ds_type)
    loss64, names64 = _port_step(tm64, x, targets, weights)
    names = dict(tm.named_parameters())
    jg = flax_to_state_dict({"params": state.opt_state}, names)
    stats = {k: v for k, v in tm.state_dict().items() if "running" in k}
    js = flax_to_state_dict({"batch_stats": state.batch_stats}, stats)
    bars = (1e-6, 1e-6, 1e-5)  # loss, gradients, running statistics
    if sensitive:
        _, loss_p, moved = jax_step(jnp.float64, False, 1.0 + 1e-13)
        jgp = flax_to_state_dict({"params": moved.opt_state}, names)
        jsp = flax_to_state_dict({"batch_stats": moved.batch_stats}, stats)
        bars = (max(1e-6, 4 * abs(loss_p - jloss)),
                max(1e-6, 4 * max(_scaled(jgp[k], jg[k]) for k in names)),
                max(1e-5, 4 * max(float((jsp[k] - js[k]).abs().max())
                                  for k in stats)))
    assert abs(jloss - loss64) <= bars[0]
    for key, p in names64.items():
        assert _scaled(p.grad.float(), jg[key]) <= bars[1], (key, bars)
    stats64 = {k: v for k, v in tm64.state_dict().items() if "running" in k}
    for key, v in stats64.items():
        assert float((js[key] - v.float()).abs().max()) <= bars[2], key

    tloss, names = _port_step(tm, x, targets, weights)
    if sensitive:
        assert np.isfinite(tloss)
        return tm
    assert abs(jloss - tloss) <= ATOL
    assert max(float(v.abs().max()) for v in jg.values()) > 1e-3
    assert all(p.grad is not None for p in names.values())
    bar = ATOL
    if any(_scaled(p.grad, jg[k]) > bar for k, p in names.items()):
        jg32 = flax_to_state_dict({"params": jax_step(jnp.float32, False)[2]
                                   .opt_state}, names)
        bar = max(ATOL, 4 * max(_scaled(jg32[k], jg[k]) for k in names))
    for key, p in names.items():
        assert _scaled(p.grad, jg[key]) <= bar, (key, bar)
    _check_stats(tm, state)
    return tm


def _check_eval(tm, x, want):
    """Every head of ``tm`` in eval mode within 1e-4 of max(1, its size)
    of JAX's ``want``."""
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1.0)
        assert float(np.abs(got[key].numpy() - w).max()) <= ATOL * scale, key
    assert float(want["out"].std()) > 1e-3


def _check_stats(tm, state):
    """The running statistics after the step within 1e-5 of JAX's."""
    stats = {k: v for k, v in tm.state_dict().items() if "running" in k}
    js = flax_to_state_dict({"batch_stats": state.batch_stats}, stats)
    for key, v in stats.items():
        assert float((js[key] - v).abs().max()) <= 1e-5, key


def assert_both_steps_raise(arch, W, D, ds_type, length=64, **kw):
    """With ``d_s = 1`` on ``ds_type`` targets that do not fit the heads,
    JAX's train step raises, and so does the port's."""
    jm, tm = build(arch, W, D, length=length, ds=1, **kw)
    x, y = _data(length)
    weights = default_ds_weights(D)
    state = jstate.create_train_state(
        jm, jax.random.PRNGKey(0), jnp.asarray(x), _grad_capture(),
        variables=random_variables(jm, jnp.asarray(x), seed=3))
    step = jstate.make_train_step(jm, _grad_capture(),
                                  jlosses.get_loss("MeanAbsoluteError"),
                                  loss_weights=weights)
    errors = (TypeError, ValueError, RuntimeError)
    with pytest.raises(errors):
        jax.jit(step)(state, jnp.asarray(x),
                      _jax_targets(y, D, 1, ds_type))
    with pytest.raises(errors):
        _port_step(tm, x, _port_targets(y, D, 1, ds_type), weights)


#: (arch, W, D, options); ds_type: the targets that fit the heads
#: (TernausNet's cases: test_torch_ternausnet_1d.py)
CASES = [
    ("LinkNet", 4, 2, dict(ds=1, ag=1)),
    ("LinkNetE", 4, 2, dict(lstm=1, ds=1, ds_type="UNetPP")),
    ("LinkNetP", 4, 2, dict(ag=1, ae=1, feature_number=8)),
    ("LinkNetPP", 4, 2, dict(ds=1, ag=1, ds_type="UNetPP")),
    ("LinkNetPP", 4, 2, dict(lstm=1, kernel=4)),
    ("MultiResLinkNet", 4, 2, dict(ag=1, ds=1)),
    ("FPN", 4, 2, dict(ds=1, ag=1)),
    ("FPN", 4, 2, dict(is_transconv=False, ae=1, feature_number=8)),
]


def _ids(c):
    return f"{c[0]}-W{c[1]}D{c[2]}-" + "-".join(
        f"{k}{v}" for k, v in c[3].items())


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_family_matches_jax(case):
    arch, W, D, kw = case
    assert_family_matches_jax(arch, W, D, **kw)


#: per family: (arch, the ds_type whose targets do not fit its heads)
RAISES = [("TernausNet11", "UNetPP"), ("AlbUNet18", "UNet"),
          ("AlbUNet18", "UNetPP"), ("LinkNet", "UNetPP"),
          ("LinkNetE", "UNet"), ("LinkNetP", "UNet"), ("LinkNetPP", "UNet"),
          ("MultiResLinkNet", "UNetPP"), ("FPN", "UNetPP")]


@pytest.mark.parametrize("arch,ds_type", RAISES)
def test_ds_heads_raise_where_jax_raises(arch, ds_type):
    assert_both_steps_raise(arch, 4, 2, ds_type)


def test_flax_names_of_the_new_trees():
    """Per-type auto-names in flax's creation order, the explicit heads,
    the strided stem and the Dense head of AlbUNet."""
    tern = model_selector_1d("TernausNet16", 64, 2, 1, 4, 3, ds=1, ag=1)
    names = [n for n, _ in tern.named_children()]
    assert names[:3] == ["ConvBlock_0", "ConvBlock_1", "ConvBlock_2"]
    assert "AttentionGate_4" in names and "TransConv_4" in names
    assert [n for n in names if n.startswith("level")] == [
        "level4", "level3", "level2", "level1", "level0"]
    alb = model_selector_1d("AlbUNet50", 64, 2, 1, 4, 3)
    names = [n for n, _ in alb.named_children()]
    assert names[:3] == ["ConvBlock_0", "_ResidualGroup_0", "ConvBlock_1"]
    assert alb.ConvBlock_0.Conv_0.stride == (1, 2)
    assert isinstance(alb.out, torch.nn.Linear)
    fpn = model_selector_1d("FPN", 64, 2, 1, 4, 3)
    assert [n for n, _ in fpn.named_children()][:6] == [
        "ConvBlock_0", "ConvBlock_1", "Conv_0", "ConvBlock_2", "ConvBlock_3",
        "Conv_1"]
    link = model_selector_1d("LinkNetPP", 64, 2, 1, 4, 3)
    assert link.GridDecoder_0.merge == "add"


def test_unknown_family_names_raise_jax_value_error():
    """Names the JAX package does not build either."""
    for name in ("AlbUNet19", "TernausNet12", "MLMRSNet_V3"):
        with pytest.raises(ValueError, match=name):
            model_selector_1d(name, 64, 2, 1, 4, 3)
        with pytest.raises((ValueError, AttributeError)):
            jax_selector_1d(name, 64, 2, 1, 4, 3)
