"""Train, eval and predict steps of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/train/state.py).

The JAX package threads an immutable ``TrainState`` through jitted pure
steps.  Here the state is the model (parameters and BatchNorm running
statistics) and the optimizer, updated in place by the step; nothing
waits for the card, so a loop of steps stays queued on it.

Ported: ``make_train_step`` (:110) with gradient accumulation
(``accum_steps``), rematerialization (``remat``, ``ops/remat.py``) and an
EMA shadow of the parameters (``ema``, ``ema_decay``); ``make_eval_step``
(:242) and ``make_predict_step`` (:268), which run on the shadow when
given one (``TrainState.eval_params``, :39-43).
"""
from __future__ import annotations

import contextlib
import typing as tp

import numpy as np
import torch

from ..ops import remat as _remat
from ..ops import stochastic as _stochastic
from .losses import LossFn, deep_supervision_loss
from .metrics import Metric

Targets = tp.Union[torch.Tensor, tp.Mapping[str, torch.Tensor]]


def _as_target_dict(y: Targets) -> tp.Dict[str, torch.Tensor]:
    if isinstance(y, tp.Mapping):
        return dict(y)
    return {"out": y}


def _float32(outputs: tp.Mapping[str, torch.Tensor]
             ) -> tp.Dict[str, torch.Tensor]:
    # the loss runs in float32 on outputs computed in the compute dtype
    # (under bf16 the head's sigmoid is bf16; JAX state.py:157)
    return {k: v.float() for k, v in outputs.items()}


def ema_shadow(model: torch.nn.Module) -> tp.List[torch.Tensor]:
    """A float32 copy of every parameter of ``model`` (not the BatchNorm
    statistics), in ``model.parameters()`` order: a fresh EMA shadow
    (JAX ``create_train_state(ema=True)``, :64)."""
    return [p.detach().float().clone() for p in model.parameters()]


@torch.no_grad()
def ema_update(ema: tp.Sequence[torch.Tensor],
               params: tp.Sequence[torch.Tensor], decay: float) -> None:
    """``e = e * d + p * (1 - d)`` for every shadow ``e`` and parameter
    ``p``: two products rounded apart, then their sum, as the JAX step
    (not ``lerp``, which rounds otherwise), with ``d`` rounded to float32
    and ``1 - d`` subtracted in float32 as there (:231-233)."""
    d = np.float32(decay)
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, torch._foreach_mul(
        [p.detach().float() for p in params], float(np.float32(1.0) - d)))


@contextlib.contextmanager
def shadow_weights(model: torch.nn.Module,
                   ema: tp.Optional[tp.Sequence[torch.Tensor]]):
    """Within the block, ``model``'s parameters hold the shadow ``ema``
    (when given), the BatchNorm statistics their current values; the
    parameters come back after.  The tensors are swapped, not copied."""
    if ema is None:
        yield
        return
    params = list(model.parameters())
    saved = [p.data for p in params]
    for p, e in zip(params, ema):
        p.data = e
    try:
        yield
    finally:
        for p, d in zip(params, saved):
            p.data = d


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: LossFn,
    loss_weights: tp.Optional[tp.Mapping[str, float]] = None,
    metrics: tp.Sequence[Metric] = (),
    remat: tp.Optional[str] = None,
    accum_steps: int = 1,
    ema: tp.Optional[tp.List[torch.Tensor]] = None,
    ema_decay: float = 0.0,
    seed: int = 0,
) -> tp.Callable:
    """``train_step(x, y, metric_states, step) -> (loss, metric_states)``:
    the
    forward in training mode (BatchNorm on batch statistics, its running
    statistics advanced once), the float32 loss, the backward and one
    optimizer update (which clips the gradients first when
    ``make_optimizer`` was given clips: its step pre-hook, the JAX
    chain's place), and the metrics of this forward's outputs.  ``x``
    is an NHWC batch on the model's device, ``y`` its NHWC target (or a
    dict of targets by head); ``loss`` is a 0-d float32 tensor on the
    device.

    ``remat`` (``dots``, ``conv_outs`` or ``full``) recomputes the forward
    and loss in the backward (``ops.remat.checkpoint``): the same numbers
    for more time.  It saves no peak memory: the backward revives the
    whole forward at once, so on the H100 the step's peak is the plain
    step's (PERF.md section 5; ROADMAP queue B item 15).  Only ``remat =
    blocks`` (in the model) and ``accum_steps`` lower the peak.

    ``accum_steps`` > 1 splits the batch into that many microbatches, runs
    a forward and a backward for each (BatchNorm's statistics advance once
    a microbatch, the metrics update a microbatch), sums their raw
    gradients, divides the sum once by ``accum_steps`` and updates once;
    the loss is the mean of the microbatch losses (JAX :183-221).

    ``ema`` (a shadow from ``ema_shadow``) with ``ema_decay`` > 0 is
    updated in place after the optimizer (``ema_update``).

    Every parameter is updated, with a zero gradient where the loss does
    not reach it (a deep-supervision head without a target), as optax's
    update is.

    A model with stochastic layers (DropBlock, Dropout) draws them from a
    generator on ``x``'s device keyed by (``seed``, ``step``) and, under
    accumulation, by the microbatch too (``ops.stochastic``; JAX
    :166-174, :207).  ``step`` is the count of updates so far (the
    trainer's, restored on resume); without it the step counts its own
    calls from 0.  While a forward is recomputed the layers reuse their
    draws, so every ``remat`` mode gives the plain step's gradients."""
    policy = _remat.check_policy(remat)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    params = [p for g in optimizer.param_groups for p in g["params"]]
    model_params = list(model.parameters())
    stochastic = bool(_stochastic.stochastic_layers(model))
    calls = [0]

    def loss_for(xi: torch.Tensor, ti: tp.Dict[str, torch.Tensor]):
        outputs = _float32(model(xi))
        return (deep_supervision_loss(loss_fn, outputs, ti, loss_weights),
                outputs["out"])

    def forward_backward(xi, ti, *key):
        gen = (_stochastic.stream_generator(xi.device, seed, *key)
               if stochastic else None)
        with _stochastic.random_stream(gen):
            if policy is None:
                loss, out = loss_for(xi, ti)
            else:
                loss, out = _remat.checkpoint(loss_for, xi, ti, policy=policy)
            loss.backward()
        return loss.detach(), out.detach()

    def train_step(x: torch.Tensor, y: Targets, metric_states: tp.Tuple = (),
                   step: tp.Optional[int] = None):
        if step is None:
            step = calls[0]
        calls[0] = step + 1
        targets = _as_target_dict(y)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        states = tuple(metric_states)
        if accum_steps == 1:
            loss, out = forward_backward(x, targets, step)
            micro = [(targets["out"], out)]
        else:
            if x.shape[0] % accum_steps:
                raise ValueError(f"batch {x.shape[0]} not divisible by "
                                 f"accum_steps={accum_steps}")
            xs = x.chunk(accum_steps)
            ts = {k: v.chunk(accum_steps) for k, v in targets.items()}
            loss = torch.zeros((), dtype=torch.float32, device=x.device)
            micro = []
            for i in range(accum_steps):
                ti = {k: v[i] for k, v in ts.items()}
                loss_i, out = forward_backward(xs[i], ti, step, i)
                loss = loss + loss_i
                micro.append((ti["out"], out))
            loss = loss / accum_steps
            with torch.no_grad():
                torch._foreach_div_([p.grad for p in params
                                     if p.grad is not None], accum_steps)
        for p in params:  # optax updates them all (a zero where the loss
            if p.grad is None:  # does not reach them: heads without targets)
                p.grad = torch.zeros_like(p)
        optimizer.step()
        if ema is not None and ema_decay > 0.0:
            ema_update(ema, model_params, ema_decay)
        with torch.no_grad():
            for yt, out in micro:
                states = tuple(m.update(s, yt, out)
                               for m, s in zip(metrics, states))
        return loss, states

    return train_step


def make_eval_step(
    model: torch.nn.Module,
    loss_fn: tp.Optional[LossFn] = None,
    loss_weights: tp.Optional[tp.Mapping[str, float]] = None,
    metrics: tp.Sequence[Metric] = (),
    ema: tp.Optional[tp.Sequence[torch.Tensor]] = None,
) -> tp.Callable:
    """``eval_step(x, y, metric_states) -> (loss, outputs, metric_states)``
    in eval mode (running statistics), without gradients, on the shadow
    ``ema`` when given."""

    def eval_step(x: torch.Tensor, y: Targets, metric_states: tp.Tuple = ()):
        targets = _as_target_dict(y)
        model.eval()
        with torch.inference_mode(), shadow_weights(model, ema):
            outputs = _float32(model(x))
            loss = torch.zeros((), dtype=torch.float32, device=x.device)
            if loss_fn is not None:
                loss = deep_supervision_loss(loss_fn, outputs, targets,
                                             loss_weights)
            new_states = tuple(m.update(s, targets["out"], outputs["out"])
                               for m, s in zip(metrics, metric_states))
        return loss, outputs, new_states

    return eval_step


def make_predict_step(model: torch.nn.Module,
                      ema: tp.Optional[tp.Sequence[torch.Tensor]] = None
                      ) -> tp.Callable:
    """``predict_step(x) -> outputs`` in eval mode, without gradients, in
    the model's compute dtype, on the shadow ``ema`` when given."""

    def predict_step(x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        model.eval()
        with torch.inference_mode(), shadow_weights(model, ema):
            return model(x)

    return predict_step
