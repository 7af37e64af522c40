"""Losses of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/train/losses.py).

Ported: ``BinaryCrossentropy`` (:31), ``CategoricalCrossentropy``
(:52), ``DiceLoss`` (:146) and ``BCEDiceLoss`` (:154), with the Keras
reduction (mean over every leading axis of the per-element loss) and the
Keras clip of probabilities to [1e-7, 1 - 1e-7].  The dice terms sum over the last axis, as the
reference's do: with one output channel the dice is per pixel.  That is
the reference's formula, copied as it is.
"""
from __future__ import annotations

import typing as tp

import torch

_EPS = 1e-7  # keras backend epsilon

LossFn = tp.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

#: every loss name of the JAX package's registry (train/losses.py:191)
LOSS_NAMES = (
    "BinaryCrossentropy", "BinaryFocalCrossentropy",
    "CategoricalCrossentropy", "CategoricalHinge", "CosineSimilarity",
    "Hinge", "Huber", "KLDivergence", "LogCosh", "MeanAbsoluteError",
    "MeanAbsolutePercentageError", "MeanSquaredError",
    "MeanSquaredLogarithmicError", "Poisson",
    "SparseCategoricalCrossentropy", "SquaredHinge", "DiceLoss",
    "BCEDiceLoss", "IoULoss", "FocalLoss",
)


def _clip(p: torch.Tensor) -> torch.Tensor:
    # jnp.clip is maximum(lo, p) then minimum(hi, .); torch.maximum and
    # torch.minimum split a tie's gradient in half, as jax.lax's do
    lo = torch.tensor(_EPS, dtype=p.dtype, device=p.device)
    hi = torch.tensor(1.0 - _EPS, dtype=p.dtype, device=p.device)
    return torch.minimum(hi, torch.maximum(lo, p))


def _bce(y_true: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return -(y_true * torch.log(p) + (1.0 - y_true) * torch.log1p(-p))


def binary_crossentropy(y_true: torch.Tensor,
                        y_pred: torch.Tensor) -> torch.Tensor:
    return _bce(y_true, _clip(y_pred)).mean()


def categorical_crossentropy(y_true: torch.Tensor,
                             y_pred: torch.Tensor) -> torch.Tensor:
    """Keras's on probabilities: normalized by their sum over the last
    (channel) axis, clipped, and the negative channel sum of
    ``y_true * log(p)`` averaged."""
    p = _clip(y_pred / y_pred.sum(dim=-1, keepdim=True))
    return (-(y_true * torch.log(p)).sum(dim=-1)).mean()


def _abs(v: torch.Tensor) -> torch.Tensor:
    # jnp.abs's gradient at 0 is +1 (select(v >= 0, g, -g)); torch.abs's
    # is 0, and v = y_true * y_pred is exactly 0 wherever the target is
    return torch.where(v >= 0, v, -v)


def _dice(y_true: torch.Tensor, y_pred: torch.Tensor,
          smooth: float) -> torch.Tensor:
    inter = _abs(y_true * y_pred).sum(dim=-1)
    denom = (y_true * y_true).sum(dim=-1) + (y_pred * y_pred).sum(dim=-1)
    return 1.0 - (2.0 * inter + smooth) / (denom + smooth)


def dice_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
              smooth: float = 1e-6) -> torch.Tensor:
    return _dice(y_true, y_pred, smooth).mean()


def bce_dice_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                  smooth: float = 1e-6) -> torch.Tensor:
    bce = _bce(y_true, _clip(y_pred)).mean(dim=-1)
    return (bce + _dice(y_true, y_pred, smooth)).mean()


LOSSES: tp.Dict[str, LossFn] = {
    "BinaryCrossentropy": binary_crossentropy,
    "CategoricalCrossentropy": categorical_crossentropy,
    "DiceLoss": dice_loss,
    "BCEDiceLoss": bce_dice_loss,
}


def get_loss(name: str) -> LossFn:
    """Loss by the reference's name.  ``NotImplementedError`` for a name
    of the JAX registry that is not ported yet, ``ValueError`` for an
    unknown one (as the JAX ``get_loss``)."""
    if name in LOSSES:
        return LOSSES[name]
    if name in LOSS_NAMES:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet (ported: {sorted(LOSSES)})")
    raise ValueError(
        "Please select a valid loss function. Check for spelling "
        f"mistakes, capital/small letters, etc. (got {name!r})")


def deep_supervision_loss(
    loss_fn: LossFn,
    outputs: tp.Mapping[str, torch.Tensor],
    targets: tp.Mapping[str, torch.Tensor],
    loss_weights: tp.Optional[tp.Mapping[str, float]] = None,
) -> torch.Tensor:
    """Weighted sum of ``loss_fn`` over the heads that have a target
    (``{'out', 'level1', ...}``); weight 1 for a head ``loss_weights``
    does not name."""
    first = next(iter(outputs.values()))
    total = torch.zeros((), dtype=torch.float32, device=first.device)
    for key, pred in outputs.items():
        if key not in targets:
            continue
        w = 1.0 if loss_weights is None else loss_weights.get(key, 1.0)
        total = total + w * loss_fn(targets[key], pred)
    return total


def default_ds_weights(model_depth: int) -> tp.Dict[str, float]:
    """out=1.0, level{k} weighted 1 - 0.1*k (1D notebook cell 29)."""
    weights = {"out": 1.0}
    for k in range(1, model_depth + 1):
        weights[f"level{k}"] = max(1.0 - 0.1 * k, 0.0)
    return weights
