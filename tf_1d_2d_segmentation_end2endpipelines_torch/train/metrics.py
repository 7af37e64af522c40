"""Streaming metrics of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/train/metrics.py).

A metric is ``init(device) -> state``, ``update(state, y_true, y_pred) ->
state`` and ``result(state) -> 0-d tensor``.  States are dicts of float32
tensors on the device (sums, counts, per-threshold count vectors,
confusion matrices) that two runs merge by adding key by key, as the JAX
package's pytrees merge with one ``psum``; a train loop accumulates them
without waiting for the card.

Every name of the JAX ``make_metric`` (:232-331) is here, with its
short aliases for the ``tf.keras.metrics.`` names.  The threshold metrics
count ``pred > threshold`` per threshold, as the JAX ``_conf_counts``
(:78) does, but from ``torch.bucketize`` against the sorted thresholds:
memory in the pixels, not in pixels times thresholds.
"""
from __future__ import annotations

import math
import typing as tp

import torch

from .losses import _abs, sparse_cce_el, sparse_labels

_EPS = 1e-7
_KERAS = "tf.keras.metrics."

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
)

State = tp.Dict[str, torch.Tensor]
ElementFn = tp.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class Metric(tp.NamedTuple):
    name: str
    init: tp.Callable[[tp.Optional[torch.device]], State]
    update: tp.Callable[[State, torch.Tensor, torch.Tensor], State]
    result: tp.Callable[[State], torch.Tensor]


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


# ------------------------------------------------------------- mean metrics

def _mean_metric(name: str, fn: ElementFn,
                 result: tp.Optional[tp.Callable[[State], torch.Tensor]] = None
                 ) -> Metric:
    """Streaming mean of a per-element value: sum and count."""

    def init(device=None):
        return {"total": _zeros((), device), "count": _zeros((), device)}

    def update(state, y_true, y_pred):
        v = fn(y_true.float(), y_pred.float())
        return {"total": state["total"] + v.sum(),
                "count": state["count"] + float(v.numel())}

    def mean(state):
        return state["total"] / torch.clamp_min(state["count"], 1.0)

    return Metric(name, init, update, result or mean)


def _clip(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p, _EPS, 1.0 - _EPS)


def _bce_el(t, p):
    p = _clip(p)
    return -(t * torch.log(p) + (1 - t) * torch.log1p(-p))


def _cce_el(t, p):
    p = _clip(p / p.sum(dim=-1, keepdim=True))
    return -(t * torch.log(p)).sum(dim=-1)


def _unit(v):
    return v / torch.clamp_min(torch.linalg.vector_norm(
        v, dim=-1, keepdim=True), _EPS)


def _accuracy_el(t, p):
    return (t == p).float()


def _binary_accuracy_el(t, p):
    return ((p > 0.5).float() == t).float()


def _categorical_accuracy_el(t, p):
    return (t.argmax(-1) == p.argmax(-1)).float()


def _sparse_categorical_accuracy_el(t, p):
    return (sparse_labels(t, p) == p.argmax(-1)).float()


def _topk_el(k: int, sparse: bool) -> ElementFn:
    def fn(t, p):
        labels = sparse_labels(t, p) if sparse else t.argmax(-1)
        topk = torch.topk(p, min(k, p.shape[-1]), dim=-1).indices
        return (topk == labels[..., None]).any(dim=-1).float()
    return fn


_ELEMENTWISE: tp.Dict[str, ElementFn] = {
    "Accuracy": _accuracy_el,
    "BinaryAccuracy": _binary_accuracy_el,
    "BinaryCrossentropy": _bce_el,
    "CategoricalAccuracy": _categorical_accuracy_el,
    "CategoricalCrossentropy": _cce_el,
    "CategoricalHinge": lambda t, p: torch.clamp_min(
        torch.amax((1 - t) * p, -1) - (t * p).sum(-1) + 1, 0),
    "CosineSimilarity": lambda t, p: (_unit(t) * _unit(p)).sum(-1),
    "Hinge": lambda t, p: torch.clamp_min(1 - (2 * t - 1) * p, 0),
    "KLDivergence": lambda t, p: (
        _clip(t) * torch.log(_clip(t) / _clip(p))).sum(-1),
    "LogCoshError": lambda t, p: (
        _abs(p - t) + torch.nn.functional.softplus(-2 * _abs(p - t))
        - math.log(2.0)),
    "Mean": lambda t, p: p,
    "MeanAbsoluteError": lambda t, p: _abs(p - t),
    "MeanAbsolutePercentageError": lambda t, p: 100 * _abs(
        (t - p) / torch.clamp_min(_abs(t), _EPS)),
    "MeanSquaredError": lambda t, p: torch.square(p - t),
    "MeanSquaredLogarithmicError": lambda t, p: torch.square(
        torch.log1p(torch.clamp_min(t, _EPS))
        - torch.log1p(torch.clamp_min(p, _EPS))),
    "Poisson": lambda t, p: p - t * torch.log(p + _EPS),
    "SparseCategoricalAccuracy": _sparse_categorical_accuracy_el,
    "SparseCategoricalCrossentropy": sparse_cce_el,
    "SquaredHinge": lambda t, p: torch.square(
        torch.clamp_min(1 - (2 * t - 1) * p, 0)),
}


# ------------------------------------------------- confusion-based metrics

def conf_counts_broadcast(y_true: torch.Tensor, y_pred: torch.Tensor,
                          thresholds: torch.Tensor) -> State:
    """Per-threshold TP/FP/FN/TN as the JAX ``_conf_counts`` computes them:
    every pixel against every threshold (a thresholds x pixels mask).  The
    reference that ``conf_counts`` is held to."""
    t = y_true.reshape(-1).float()
    p = y_pred.reshape(-1).float()
    pred_pos = p[None, :] > thresholds[:, None]
    pos = t[None, :] > 0.5
    return {"tp": (pred_pos & pos).sum(1).float(),
            "fp": (pred_pos & ~pos).sum(1).float(),
            "fn": (~pred_pos & pos).sum(1).float(),
            "tn": (~pred_pos & ~pos).sum(1).float()}


def conf_counts(y_true: torch.Tensor, y_pred: torch.Tensor,
                thresholds: torch.Tensor) -> State:
    """``conf_counts_broadcast``'s counts in memory linear in the pixels:
    a pixel's bucket among the ascending ``thresholds`` is how many lie
    strictly below it (``bucketize``, ``right=False``), so ``p > th[j]``
    exactly when its bucket exceeds j; the buckets of the positive and of
    the negative pixels are counted (``index_add_``, which does not wait
    for the card as ``bincount`` does to size its output) and summed from
    the top down.  A NaN prediction is above no threshold."""
    t = y_true.reshape(-1).float()
    p = y_pred.reshape(-1).float()
    n = thresholds.numel()
    bucket = torch.bucketize(p, thresholds, right=False)
    bucket = torch.where(torch.isnan(p), 0, bucket)
    pos = (t > 0.5).long()
    hist = torch.zeros(2 * (n + 1), dtype=torch.int64, device=p.device)
    hist.index_add_(0, pos * (n + 1) + bucket,
                    torch.ones_like(bucket))
    hist = hist.reshape(2, n + 1)
    # above[:, j] = pixels whose bucket > j, i.e. p > thresholds[j]
    above = hist.flip(1).cumsum(1).flip(1)[:, 1:]
    totals = hist.sum(1, keepdim=True)
    below = totals - above
    return {"tp": above[1].float(), "fp": above[0].float(),
            "fn": below[1].float(), "tn": below[0].float()}


def _conf_metric(name: str, thresholds: tp.Sequence[float],
                 result: tp.Callable[[State], torch.Tensor]) -> Metric:
    cache: tp.Dict[torch.device, torch.Tensor] = {}

    def init(device=None):
        z = _zeros((len(thresholds),), device)
        return {"tp": z, "fp": z, "fn": z, "tn": z}

    def update(state, y_true, y_pred):
        th = cache.get(y_pred.device)
        if th is None:
            th = cache[y_pred.device] = torch.tensor(
                thresholds, dtype=torch.float32, device=y_pred.device)
        c = conf_counts(y_true, y_pred, th)
        return {k: state[k] + c[k] for k in state}

    return Metric(name, init, update, result)


def _keras_thresholds(num: int) -> tp.List[float]:
    # keras: [-eps, 1/(n-1), ..., (n-2)/(n-1), 1 + eps]
    if num == 1:
        return [0.5]
    inner = [(i + 1) * 1.0 / (num - 1) for i in range(num - 2)]
    return [-1e-7] + inner + [1.0 + 1e-7]


def _auc_roc_result(state: State) -> torch.Tensor:
    tp_, fp_, fn_, tn_ = state["tp"], state["fp"], state["fn"], state["tn"]
    tpr = tp_ / torch.clamp_min(tp_ + fn_, _EPS)
    fpr = fp_ / torch.clamp_min(fp_ + tn_, _EPS)
    # thresholds ascending -> rates descending; the trapezoid rule
    return ((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0).sum()


def _at_param_result(kind: str, value: float
                     ) -> tp.Callable[[State], torch.Tensor]:
    def result(state):
        tp_, fp_, fn_, tn_ = state["tp"], state["fp"], state["fn"], state["tn"]
        precision = tp_ / torch.clamp_min(tp_ + fp_, _EPS)
        recall = tp_ / torch.clamp_min(tp_ + fn_, _EPS)
        specificity = tn_ / torch.clamp_min(tn_ + fp_, _EPS)
        constraint, target = {
            "precision_at_recall": (recall, precision),
            "recall_at_precision": (precision, recall),
            "sensitivity_at_specificity": (specificity, recall),
            "specificity_at_sensitivity": (recall, specificity),
        }[kind]
        return torch.where(constraint >= value, target, 0.0).max()
    return result


def _ratio(num: str, other: str) -> tp.Callable[[State], torch.Tensor]:
    return lambda s: (s[num] / torch.clamp_min(s[num] + s[other], _EPS))[0]


# --------------------------------------------------------- IoU / confusion

def _iou_metric(name: str, num_classes: int,
                target_class_ids: tp.Optional[tp.Sequence[int]],
                mode: str) -> Metric:
    """IoU over an accumulated num_classes x num_classes confusion matrix
    (JAX ``_iou_metric`` :126).  ``mode``: 'iou' (labels truncated to
    integers), 'binary' (thresholded at 0.5) or 'onehot' (argmax over the
    channels).  A (true, predicted) pair lands at ``true * n + pred``;
    as ``jnp.bincount(length=n * n)`` counts, an index below 0 counts in
    cell 0 and one past the matrix is dropped."""
    n = num_classes
    ids = [i for i in (target_class_ids if target_class_ids is not None
                       else range(n)) if i < n]

    def init(device=None):
        return {"cm": _zeros((n, n), device)}

    def update(state, y_true, y_pred):
        if mode == "binary":
            t = (y_true.reshape(-1) > 0.5).long()
            p = (y_pred.reshape(-1) > 0.5).long()
        elif mode == "onehot":
            t = y_true.argmax(-1).reshape(-1)
            p = y_pred.argmax(-1).reshape(-1)
        else:
            t = y_true.reshape(-1).to(torch.int32).long()
            p = y_pred.reshape(-1).to(torch.int32).long()
        idx = torch.clamp_min(t * n + p, 0)
        inside = idx < n * n
        counts = torch.zeros(n * n, dtype=torch.int64, device=idx.device)
        counts.index_add_(0, torch.where(inside, idx, 0), inside.long())
        return {"cm": state["cm"] + counts.reshape(n, n).float()}

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


def _sum_metric(name: str) -> Metric:
    def init(device=None):
        return {"total": _zeros((), device)}

    def update(state, y_true, y_pred):
        return {"total": state["total"] + y_pred.float().sum()}

    return Metric(name, init, update, lambda s: s["total"])


def make_metric(name: str, num_classes: int = 2,
                target_class_ids: tp.Optional[tp.Sequence[int]] = None,
                k: int = 5, num_thresholds: int = 200,
                at_param: float = 0.5) -> Metric:
    """Streaming metric by the reference's name, a ``tf.keras.metrics.``
    name also by its short form, with the JAX ``make_metric``'s arguments
    and defaults: ``num_classes`` sizes IoU, MeanIoU, OneHotIoU and
    OneHotMeanIoU (BinaryIoU is 2), ``target_class_ids`` the classes IoU,
    OneHotIoU and BinaryIoU average over, ``k`` the top-k accuracies,
    ``num_thresholds`` the curve of AUC and the "at" metrics and
    ``at_param`` their constraint.  ``ValueError`` for an unknown name."""
    if name not in METRIC_NAMES and _KERAS + name not in METRIC_NAMES:
        raise ValueError(
            "Please select a valid metric. Check for spelling mistakes, "
            f"capital/small letters, etc. (got {name!r})")
    short = name[len(_KERAS):] if name.startswith(_KERAS) else name
    if short in _ELEMENTWISE:
        return _mean_metric(name, _ELEMENTWISE[short])
    kth = _keras_thresholds(num_thresholds)
    at = {"PrecisionAtRecall": "precision_at_recall",
          "RecallAtPrecision": "recall_at_precision",
          "SensitivityAtSpecificity": "sensitivity_at_specificity",
          "SpecificityAtSensitivity": "specificity_at_sensitivity"}
    if short in at:
        return _conf_metric(name, kth, _at_param_result(at[short], at_param))
    counts = {"TruePositives": "tp", "FalsePositives": "fp",
              "TrueNegatives": "tn", "FalseNegatives": "fn"}
    if short in counts:
        return _conf_metric(name, [0.5],
                            lambda s, key=counts[short]: s[key][0])
    iou = {"BinaryIoU": (2, target_class_ids, "binary"),
           "IoU": (num_classes, target_class_ids, "iou"),
           "MeanIoU": (num_classes, None, "iou"),
           "OneHotIoU": (num_classes, target_class_ids, "onehot"),
           "OneHotMeanIoU": (num_classes, None, "onehot")}
    if short in iou:
        return _iou_metric(name, *iou[short])
    if short == "AUC":
        return _conf_metric(name, kth, _auc_roc_result)
    if short == "Precision":
        return _conf_metric(name, [0.5], _ratio("tp", "fp"))
    if short == "Recall":
        return _conf_metric(name, [0.5], _ratio("tp", "fn"))
    if short == "RootMeanSquaredError":
        return _mean_metric(
            name, _ELEMENTWISE["MeanSquaredError"],
            lambda s: torch.sqrt(s["total"] / torch.clamp_min(s["count"],
                                                              1.0)))
    if short == "Sum":
        return _sum_metric(name)
    # the top-k accuracies are the names left
    return _mean_metric(name, _topk_el(k, sparse=short.startswith("Sparse")))
