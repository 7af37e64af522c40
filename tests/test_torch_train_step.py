"""The port's train step against the JAX ``make_train_step`` on a
flagship-shaped model (UNet++ W4/D3 on (2, 32, 32, 3), BCEDiceLoss,
Adam 1e-3): both start from the same parameters, BatchNorm statistics and
Adam state (converted from the JAX side after one JAX step, so the
moments are not zero) and take 3 steps on the same batches.  Each step
compares the loss, every gradient, the new BatchNorm statistics and the
new parameters."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    losses as jlosses, metrics as jmetrics, optimizers as joptim,
    state as jstate)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    bce_dice_loss, make_eval_step, make_metric, make_optimizer,
    make_predict_step, make_train_step)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict, load_adam_state, load_flax_variables)

LR = 1e-3
STEPS = 3


def _batches(n, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
        y = (rng.uniform(size=(2, 32, 32, 1)) > 0.6).astype(np.float32)
        out.append((x, y))
    return out


def _run(dtype_name):
    """Per step: (JAX, port) pairs of loss, grads, batch_stats and params,
    each side as numpy in the port's state_dict keys."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype_name == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jm = JaxSegModel(decoder_name="UNetPP", model_width=4, model_depth=3,
                     output_nums=1, final_activation="sigmoid", dtype=jdt)
    batches = _batches(STEPS + 1)
    variables = random_variables(jm, jnp.asarray(batches[0][0]), seed=3)
    opt = joptim.make_optimizer("Adam", LR)
    state = jstate.create_train_state(jm, jax.random.PRNGKey(0),
                                      jnp.asarray(batches[0][0]), opt,
                                      variables=variables)
    step = jax.jit(jstate.make_train_step(jm, opt, jlosses.bce_dice_loss))
    # one JAX step first: the converted Adam state then has moments
    state, _, _ = step(state, jnp.asarray(batches[0][0]),
                       jnp.asarray(batches[0][1]))

    tm = SegModel("UNetPP", 4, 3, in_channels=3, output_nums=1,
                  final_activation="sigmoid", dtype=tdt)
    load_flax_variables(tm, {"params": state.params,
                             "batch_stats": state.batch_stats})
    topt = make_optimizer("Adam", tm.parameters(), LR)
    adam = state.opt_state.inner_state[0]
    load_adam_state(topt, tm, adam.mu, adam.nu, int(adam.count))
    tstep = make_train_step(tm, topt, bce_dice_loss)
    names = dict(tm.named_parameters())
    stats = {k: v for k, v in tm.state_dict().items() if "running" in k}

    def loss_of(params, bs, x, y):
        out, upd = jm.apply({"params": params, "batch_stats": bs}, x,
                            train=True, mutable=["batch_stats"])
        return jlosses.bce_dice_loss(y, out["out"].astype(jnp.float32)), upd

    grad_fn = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
    # the float32 gradient at the same state: the yardstick of bf16 error
    jm32 = jm.clone(dtype=jnp.float32)

    def loss_of32(params, bs, x, y):
        out, _ = jm32.apply({"params": params, "batch_stats": bs}, x,
                            train=True, mutable=["batch_stats"])
        return jlosses.bce_dice_loss(y, out["out"])

    grad_fn32 = jax.jit(jax.grad(loss_of32))
    records = []
    for x, y in batches[1:]:
        (jloss, _), jgrads = grad_fn(state.params, state.batch_stats,
                                     jnp.asarray(x), jnp.asarray(y))
        grads32 = grad_fn32(state.params, state.batch_stats, jnp.asarray(x),
                            jnp.asarray(y))
        state, jloss2, _ = step(state, jnp.asarray(x), jnp.asarray(y))
        assert float(jloss2) == float(jloss)
        tloss, _ = tstep(torch.from_numpy(x), torch.from_numpy(y))
        rec = {
            "loss": (float(jloss), float(tloss)),
            "grads": (flax_to_state_dict({"params": jgrads}, names),
                      {k: p.grad for k, p in names.items()}),
            "grads32": flax_to_state_dict({"params": grads32}, names),
            "stats": (flax_to_state_dict(
                {"batch_stats": state.batch_stats}, stats),
                {k: v.clone() for k, v in tm.state_dict().items()
                 if k in stats}),
            "params": (flax_to_state_dict({"params": state.params}, names),
                       {k: p.detach().clone() for k, p in names.items()}),
        }
        records.append(rec)
    return records


def _max_abs(a, b):
    return max(float((a[k].float() - b[k].detach().float()).abs().max())
               for k in a)


@pytest.fixture(scope="module")
def f32_records():
    return _run("float32")


def test_train_step_float32_matches_jax(f32_records):
    """Loss and every gradient within 1e-4 at each of the 3 steps, and
    the new BatchNorm running statistics within 1e-5 (a 0.01-weighted
    average of batch statistics that agree to float32 rounding).

    Parameters: Adam's update is lr * m_hat / (sqrt(v_hat) + eps).  Where
    a gradient is far from 0 the two sides move a parameter by the same
    amount to float32 rounding, within 1e-5 here.  A gradient that
    rounding puts on the other side of 0 can move its parameter by up to
    2 * lr in one step; the bound is therefore 2 * lr * steps for every
    parameter, and 1e-5 for all but 0.1% of them."""
    for i, rec in enumerate(f32_records):
        jl, tl = rec["loss"]
        assert abs(jl - tl) <= 1e-4, (i, jl, tl)
        assert _max_abs(*rec["grads"]) <= 1e-4, i
        assert _max_abs(*rec["stats"]) <= 1e-5, i
        jp, tp_ = rec["params"]
        diffs = torch.cat([(jp[k] - tp_[k].detach()).abs().flatten()
                           for k in jp])
        assert float(diffs.max()) <= 2 * LR * (i + 1), i
        assert float((diffs > 1e-5).float().mean()) <= 1e-3, i


def test_train_step_comparison_is_not_vacuous(f32_records):
    """The port's losses are finite and the gradients compared above are
    not all zero."""
    for rec in f32_records:
        assert np.isfinite(rec["loss"][1])
        jg, _ = rec["grads"]
        assert max(float(v.abs().max()) for v in jg.values()) > 1e-3


def _rel_l2(a, ref):
    """||a - ref|| / ||ref|| over all gradient tensors together."""
    num = sum(float(((a[k].float() - ref[k]) ** 2).sum()) for k in ref)
    return (num / sum(float((ref[k] ** 2).sum()) for k in ref)) ** 0.5


def test_train_step_bfloat16_within_bound():
    """The same in bf16 (activations bf16; parameters, BatchNorm
    statistics and loss f32).  The two frameworks round their bf16 sums
    at other points (1 bf16 ulp of the forward, tests/test_torch_
    segmodel.py).  At this size (4-16 channels, a 2x32x32 batch) that
    moves a bf16 gradient far from the float32 one on both sides: JAX's
    is 21-25% away (relative L2 over all tensors) in this setup.  So the
    port is held to the float32 gradient at the same state, with JAX's
    bf16 gradient as the yardstick: no farther from it than JAX's bf16
    gradient is.  Loss within 1e-2 of JAX's bf16 loss, BatchNorm
    statistics within 1e-2."""
    for i, rec in enumerate(_run("bfloat16")):
        jl, tl = rec["loss"]
        assert np.isfinite(tl) and abs(jl - tl) <= 1e-2, (i, jl, tl)
        jg, tg = rec["grads"]
        ref = rec["grads32"]
        port_err, jax_err = _rel_l2(tg, ref), _rel_l2(jg, ref)
        assert port_err <= jax_err, (i, port_err, jax_err)
        assert _max_abs(*rec["stats"]) <= 1e-2, i


def test_eval_and_predict_steps_match_jax():
    """``make_eval_step`` (eval-mode forward, f32 loss, metric update) and
    ``make_predict_step`` against the JAX steps on converted variables:
    outputs within 1e-4, loss and metric within 1e-5."""
    jm = JaxSegModel(decoder_name="UNetPP", model_width=4, model_depth=3,
                     output_nums=1, final_activation="sigmoid")
    x, y = _batches(1, seed=9)[0]
    variables = random_variables(jm, jnp.asarray(x), seed=4)
    state = jstate.create_train_state(
        jm, jax.random.PRNGKey(0), jnp.asarray(x),
        joptim.make_optimizer("Adam", LR), variables=variables)
    jmetric = jmetrics.make_metric("BinaryAccuracy")
    jloss, jout, (jms,) = jstate.make_eval_step(
        jm, jlosses.bce_dice_loss, metrics=[jmetric])(
        state, jnp.asarray(x), jnp.asarray(y), (jmetric.init(),))
    jpred = jstate.make_predict_step(jm)(state, jnp.asarray(x))["out"]

    tm = SegModel("UNetPP", 4, 3, in_channels=3, output_nums=1,
                  final_activation="sigmoid")
    load_flax_variables(tm, variables)
    metric = make_metric("BinaryAccuracy")
    loss, out, (ms,) = make_eval_step(tm, bce_dice_loss, metrics=[metric])(
        torch.from_numpy(x), torch.from_numpy(y), (metric.init(None),))
    pred = make_predict_step(tm)(torch.from_numpy(x))["out"]
    assert not tm.training
    assert float(np.abs(out["out"].numpy() - np.asarray(jout["out"])).max()) \
        <= 1e-4
    assert float(np.abs(pred.numpy() - np.asarray(jpred)).max()) <= 1e-4
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert abs(float(metric.result(ms)) - float(jmetric.result(jms))) <= 1e-5
