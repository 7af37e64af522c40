"""Streaming metrics of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/train/metrics.py).

A metric is ``init(device) -> state``, ``update(state, y_true, y_pred) ->
state`` and ``result(state) -> 0-d tensor``; states are tensors on the
device, so a train loop accumulates them without waiting for the card.

Ported: the ``_mean_metric`` family (:32) for ``MeanSquaredError`` (the
reference INI's default), ``BinaryAccuracy`` and ``BinaryCrossentropy``,
and ``BinaryIoU`` (:126).
"""
from __future__ import annotations

import typing as tp

import torch

_EPS = 1e-7

#: every metric name of the JAX package (train/metrics.py:333)
METRIC_NAMES = (
    "AUC", "Accuracy", "BinaryAccuracy", "BinaryCrossentropy", "BinaryIoU",
    "CategoricalAccuracy", "CategoricalCrossentropy", "CategoricalHinge",
    "CosineSimilarity", "Hinge", "IoU", "KLDivergence", "LogCoshError",
    "Mean", "MeanAbsoluteError", "MeanAbsolutePercentageError", "MeanIoU",
    "MeanSquaredError", "MeanSquaredLogarithmicError", "OneHotIoU",
    "OneHotMeanIoU", "Poisson", "Precision", "Recall",
    "RootMeanSquaredError", "SparseCategoricalAccuracy",
    "SparseCategoricalCrossentropy", "SparseTopKCategoricalAccuracy",
    "SquaredHinge", "Sum", "TopKCategoricalAccuracy",
    "tf.keras.metrics.TrueNegatives", "tf.keras.metrics.TruePositives",
    "tf.keras.metrics.FalseNegatives", "tf.keras.metrics.FalsePositives",
    "tf.keras.metrics.PrecisionAtRecall", "tf.keras.metrics.RecallAtPrecision",
    "tf.keras.metrics.SensitivityAtSpecificity",
    "tf.keras.metrics.SpecificityAtSensitivity",
    "TrueNegatives", "TruePositives", "FalseNegatives", "FalsePositives",
    "PrecisionAtRecall", "RecallAtPrecision", "SensitivityAtSpecificity",
    "SpecificityAtSensitivity",
)

State = tp.Dict[str, torch.Tensor]


class Metric(tp.NamedTuple):
    name: str
    init: tp.Callable[[tp.Optional[torch.device]], State]
    update: tp.Callable[[State, torch.Tensor, torch.Tensor], State]
    result: tp.Callable[[State], torch.Tensor]


def _mean_metric(name: str, fn: tp.Callable[[torch.Tensor, torch.Tensor],
                                            torch.Tensor]) -> Metric:
    """Streaming mean of a per-element value: sum and count."""

    def init(device=None):
        return {"total": torch.zeros((), device=device),
                "count": torch.zeros((), device=device)}

    def update(state, y_true, y_pred):
        v = fn(y_true.float(), y_pred.float())
        return {"total": state["total"] + v.sum(),
                "count": state["count"] + float(v.numel())}

    def result(state):
        return state["total"] / torch.clamp_min(state["count"], 1.0)

    return Metric(name, init, update, result)


def _bce_el(t, p):
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return -(t * torch.log(p) + (1 - t) * torch.log1p(-p))


def _binary_accuracy_el(t, p):
    return ((p > 0.5).float() == t).float()


def _binary_iou(name: str,
                target_class_ids: tp.Optional[tp.Sequence[int]]) -> Metric:
    """IoU over an accumulated 2x2 confusion matrix of labels thresholded
    at 0.5 (JAX ``_iou_metric`` with mode 'binary')."""
    ids = [i for i in (target_class_ids if target_class_ids is not None
                       else (0, 1)) if i < 2]

    def init(device=None):
        return {"cm": torch.zeros((2, 2), device=device)}

    def update(state, y_true, y_pred):
        t = (y_true.reshape(-1) > 0.5).long()
        p = (y_pred.reshape(-1) > 0.5).long()
        # index_add_ where bincount would wait for the card to size it
        counts = torch.zeros(4, device=t.device).index_add_(
            0, t * 2 + p, torch.ones(t.shape, device=t.device))
        return {"cm": state["cm"] + counts.reshape(2, 2)}

    def result(state):
        cm = state["cm"]
        row, col, diag = cm.sum(dim=1), cm.sum(dim=0), torch.diagonal(cm)
        union = row + col - diag
        iou = diag / torch.clamp_min(union, _EPS)
        sel = torch.tensor(ids, dtype=torch.long, device=cm.device)
        valid = union[sel] > 0
        return torch.where(valid, iou[sel], 0.0).sum() / torch.clamp_min(
            valid.float().sum(), 1.0)

    return Metric(name, init, update, result)


def make_metric(name: str,
                target_class_ids: tp.Optional[tp.Sequence[int]] = None
                ) -> Metric:
    """Streaming metric by the reference's name.  ``NotImplementedError``
    for a name of the JAX registry that is not ported yet, ``ValueError``
    for an unknown one.  (The JAX ``make_metric``'s ``num_classes`` sizes
    the multiclass IoU metrics, none of which is ported.)"""
    table: tp.Dict[str, tp.Callable[[], Metric]] = {
        "BinaryAccuracy": lambda: _mean_metric(name, _binary_accuracy_el),
        "BinaryCrossentropy": lambda: _mean_metric(name, _bce_el),
        "BinaryIoU": lambda: _binary_iou(name, target_class_ids),
        "MeanSquaredError": lambda: _mean_metric(
            name, lambda t, p: torch.square(p - t)),
    }
    if name in table:
        return table[name]()
    if name in METRIC_NAMES:
        raise NotImplementedError(
            f"metric {name!r} is not ported yet (ported: {sorted(table)})")
    raise ValueError(
        "Please select a valid metric. Check for spelling mistakes, "
        f"capital/small letters, etc. (got {name!r})")
