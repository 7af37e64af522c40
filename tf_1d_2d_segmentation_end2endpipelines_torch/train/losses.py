"""Losses of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/train/losses.py).

Every loss of the JAX registry (:191-214), with the Keras reduction: the
per-element or per-pixel loss (a sum or mean over the last, channel,
axis where the formula has one), then the mean over every leading axis;
probabilities are clipped to [1e-7, 1 - 1e-7] where the reference clips.
Each loss matches the JAX one in value and in its gradient with respect
to ``y_pred``, which the train step differentiates: hence ``_abs`` for
``jnp.abs`` (gradient +1 at 0), ``torch.maximum``/``torch.minimum`` for
``jnp.maximum``/``jnp.minimum`` (a tie's gradient split in half),
``torch.amax`` for ``jnp.max`` (split evenly among tied maxima) and the
norm written as ``sqrt(sum(x * x))``, as ``jnp.linalg.norm`` computes it
(an all-zero channel vector gives the same NaN gradient in both).  The
dice terms sum over the last axis, as the reference's do: with one output
channel the dice is per pixel.  That is the reference's formula, copied
as it is, and so is ``iou_loss``'s batch-wide total.
"""
from __future__ import annotations

import math
import typing as tp

import torch

_EPS = 1e-7  # keras backend epsilon

LossFn = tp.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _clip(p: torch.Tensor) -> torch.Tensor:
    # jnp.clip is maximum(lo, p) then minimum(hi, .); torch.maximum and
    # torch.minimum split a tie's gradient in half, as jax.lax's do
    return torch.minimum(_const(p, 1.0 - _EPS),
                         torch.maximum(_const(p, _EPS), p))


def _relu(v: torch.Tensor) -> torch.Tensor:
    # jnp.maximum(v, 0.0): half the gradient at v == 0 (clamp_min: all)
    return torch.maximum(v, _const(v, 0.0))


def _abs(v: torch.Tensor) -> torch.Tensor:
    # jnp.abs's gradient at 0 is +1 (select(v >= 0, g, -g)); torch.abs's
    # is 0, and v = y_true * y_pred is exactly 0 wherever the target is
    return torch.where(v >= 0, v, -v)


def _norm(v: torch.Tensor) -> torch.Tensor:
    # jnp.linalg.norm over the last axis, kept
    return torch.sqrt((v * v).sum(dim=-1, keepdim=True))


def _bce(y_true: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return -(y_true * torch.log(p) + (1.0 - y_true) * torch.log1p(-p))


# ---------------------------------------------------------------- keras core

def binary_crossentropy(y_true: torch.Tensor,
                        y_pred: torch.Tensor) -> torch.Tensor:
    return _bce(y_true, _clip(y_pred)).mean()


def binary_focal_crossentropy(y_true: torch.Tensor, y_pred: torch.Tensor,
                              gamma: float = 2.0) -> torch.Tensor:
    p = _clip(y_pred)
    p_t = y_true * p + (1.0 - y_true) * (1.0 - p)
    return (torch.pow(1.0 - p_t, gamma) * _bce(y_true, p)).mean()


def categorical_crossentropy(y_true: torch.Tensor,
                             y_pred: torch.Tensor) -> torch.Tensor:
    """Keras's on probabilities: normalized by their sum over the last
    (channel) axis, clipped, and the negative channel sum of
    ``y_true * log(p)`` averaged."""
    p = _clip(y_pred / y_pred.sum(dim=-1, keepdim=True))
    return (-(y_true * torch.log(p)).sum(dim=-1)).mean()


def sparse_labels(y_true: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``y_true`` as integer labels of the channels of ``p``, truncated,
    a trailing axis of 1 dropped."""
    labels = y_true.to(torch.int64)
    if labels.shape == p.shape[:-1] + (1,):
        labels = labels[..., 0]
    return labels


def sparse_cce_el(y_true: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per element, ``-log`` of the clipped probability the label picks.
    As ``jnp.take_along_axis``: a negative label counts from the end once,
    and a label still outside the channels picks NaN (no gradient) where
    ``gather`` would fault."""
    p = _clip(p)
    labels, c = sparse_labels(y_true, p), p.shape[-1]
    labels = torch.where(labels < 0, labels + c, labels)
    valid = (labels >= 0) & (labels < c)
    picked = torch.gather(torch.log(p), -1,
                          labels.clamp(0, c - 1)[..., None])[..., 0]
    return -torch.where(valid, picked, _const(picked, math.nan))


def sparse_categorical_crossentropy(y_true: torch.Tensor,
                                    y_pred: torch.Tensor) -> torch.Tensor:
    return sparse_cce_el(y_true, y_pred).mean()


def categorical_hinge(y_true: torch.Tensor,
                      y_pred: torch.Tensor) -> torch.Tensor:
    pos = (y_true * y_pred).sum(dim=-1)
    neg = torch.amax((1.0 - y_true) * y_pred, dim=-1)
    return _relu(neg - pos + 1.0).mean()


def cosine_similarity(y_true: torch.Tensor,
                      y_pred: torch.Tensor) -> torch.Tensor:
    a = y_true / torch.maximum(_norm(y_true), _const(y_true, _EPS))
    b = y_pred / torch.maximum(_norm(y_pred), _const(y_pred, _EPS))
    return (-(a * b).sum(dim=-1)).mean()


def hinge(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    y = 2.0 * y_true - 1.0  # keras maps {0,1} -> {-1,1}
    return _relu(1.0 - y * y_pred).mean()


def squared_hinge(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    y = 2.0 * y_true - 1.0
    return torch.square(_relu(1.0 - y * y_pred)).mean()


def huber(y_true: torch.Tensor, y_pred: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
    abs_err = _abs(y_pred - y_true)
    quad = torch.minimum(abs_err, _const(abs_err, delta))
    return (0.5 * quad * quad + delta * (abs_err - quad)).mean()


def kl_divergence(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    t, p = _clip(y_true), _clip(y_pred)
    return (t * torch.log(t / p)).sum(dim=-1).mean()


def log_cosh(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    # the JAX package's stable form: |x| + softplus(-2|x|) - log 2
    a = _abs(y_pred - y_true)
    return (a + torch.nn.functional.softplus(-2.0 * a)
            - math.log(2.0)).mean()


def mean_absolute_error(y_true: torch.Tensor,
                        y_pred: torch.Tensor) -> torch.Tensor:
    return _abs(y_pred - y_true).mean()


def mean_absolute_percentage_error(y_true: torch.Tensor,
                                   y_pred: torch.Tensor) -> torch.Tensor:
    diff = _abs((y_true - y_pred)
                / torch.maximum(_abs(y_true), _const(y_true, _EPS)))
    return (100.0 * diff).mean()


def mean_squared_error(y_true: torch.Tensor,
                       y_pred: torch.Tensor) -> torch.Tensor:
    return torch.square(y_pred - y_true).mean()


def mean_squared_logarithmic_error(y_true: torch.Tensor,
                                   y_pred: torch.Tensor) -> torch.Tensor:
    a = torch.log1p(torch.maximum(y_true, _const(y_true, _EPS)))
    b = torch.log1p(torch.maximum(y_pred, _const(y_pred, _EPS)))
    return torch.square(a - b).mean()


def poisson(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return (y_pred - y_true * torch.log(y_pred + _EPS)).mean()


# ------------------------------------------------------------- custom losses

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


def iou_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
             smooth: float = 1e-6) -> torch.Tensor:
    """The reference's formula (custom_losses.py:26-37): the intersection
    per pixel, the total over the whole batch."""
    inter = _abs(y_true * y_pred).sum(dim=-1)
    union = y_true.sum() + y_pred.sum() - inter
    return (1.0 - (inter + smooth) / (union + smooth)).mean()


def focal_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
               alpha: float = 0.8, gamma: float = 2.0) -> torch.Tensor:
    bce = _bce(y_true, _clip(y_pred)).mean(dim=-1)
    return (alpha * torch.pow(1.0 - torch.exp(-bce), gamma) * bce).mean()


#: the JAX registry, keyed by the reference's name strings
LOSSES: tp.Dict[str, LossFn] = {
    "BinaryCrossentropy": binary_crossentropy,
    "BinaryFocalCrossentropy": binary_focal_crossentropy,
    "CategoricalCrossentropy": categorical_crossentropy,
    "CategoricalHinge": categorical_hinge,
    "CosineSimilarity": cosine_similarity,
    "Hinge": hinge,
    "Huber": huber,
    "KLDivergence": kl_divergence,
    "LogCosh": log_cosh,
    "MeanAbsoluteError": mean_absolute_error,
    "MeanAbsolutePercentageError": mean_absolute_percentage_error,
    "MeanSquaredError": mean_squared_error,
    "MeanSquaredLogarithmicError": mean_squared_logarithmic_error,
    "Poisson": poisson,
    "SparseCategoricalCrossentropy": sparse_categorical_crossentropy,
    "SquaredHinge": squared_hinge,
    "DiceLoss": dice_loss,
    "BCEDiceLoss": bce_dice_loss,
    "IoULoss": iou_loss,
    "FocalLoss": focal_loss,
}


def get_loss(name: str) -> LossFn:
    """Loss by the reference's name; ``ValueError`` for an unknown one (as
    the JAX ``get_loss``)."""
    if name not in LOSSES:
        raise ValueError(
            "Please select a valid loss function. Check for spelling "
            f"mistakes, capital/small letters, etc. (got {name!r})")
    return LOSSES[name]


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
