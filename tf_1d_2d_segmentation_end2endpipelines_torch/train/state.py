"""Train, eval and predict steps of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/train/state.py).

The JAX package threads an immutable ``TrainState`` through jitted pure
steps.  Here the state is the model (parameters and BatchNorm running
statistics) and the optimizer, updated in place by the step; nothing
waits for the card, so a loop of steps stays queued on it.

Ported: ``make_train_step`` (:110) for one microbatch per step
(``accum_steps=1``), no rematerialization and no EMA shadow;
``make_eval_step`` (:242) and ``make_predict_step`` (:268).
"""
from __future__ import annotations

import typing as tp

import torch

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


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: LossFn,
    loss_weights: tp.Optional[tp.Mapping[str, float]] = None,
    metrics: tp.Sequence[Metric] = (),
) -> tp.Callable:
    """``train_step(x, y, metric_states) -> (loss, metric_states)``: the
    forward in training mode (BatchNorm on batch statistics, its running
    statistics advanced once), the float32 loss, the backward and one
    optimizer update (which clips the gradients first when
    ``make_optimizer`` was given clips: its step pre-hook, the JAX
    chain's place), and the metrics of this forward's outputs.  ``x``
    is an NHWC batch on the model's device, ``y`` its NHWC target (or a
    dict of targets by head); ``loss`` is a 0-d float32 tensor on the
    device."""

    def train_step(x: torch.Tensor, y: Targets, metric_states: tp.Tuple = ()):
        targets = _as_target_dict(y)
        model.train()
        outputs = _float32(model(x))
        loss = deep_supervision_loss(loss_fn, outputs, targets, loss_weights)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            new_states = tuple(
                m.update(s, targets["out"], outputs["out"].detach())
                for m, s in zip(metrics, metric_states))
        return loss.detach(), new_states

    return train_step


def make_eval_step(
    model: torch.nn.Module,
    loss_fn: tp.Optional[LossFn] = None,
    loss_weights: tp.Optional[tp.Mapping[str, float]] = None,
    metrics: tp.Sequence[Metric] = (),
) -> tp.Callable:
    """``eval_step(x, y, metric_states) -> (loss, outputs, metric_states)``
    in eval mode (running statistics), without gradients."""

    def eval_step(x: torch.Tensor, y: Targets, metric_states: tp.Tuple = ()):
        targets = _as_target_dict(y)
        model.eval()
        with torch.inference_mode():
            outputs = _float32(model(x))
            loss = torch.zeros((), dtype=torch.float32, device=x.device)
            if loss_fn is not None:
                loss = deep_supervision_loss(loss_fn, outputs, targets,
                                             loss_weights)
            new_states = tuple(m.update(s, targets["out"], outputs["out"])
                               for m, s in zip(metrics, metric_states))
        return loss, outputs, new_states

    return eval_step


def make_predict_step(model: torch.nn.Module) -> tp.Callable:
    """``predict_step(x) -> outputs`` in eval mode, without gradients, in
    the model's compute dtype."""

    def predict_step(x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        model.eval()
        with torch.inference_mode():
            return model(x)

    return predict_step
