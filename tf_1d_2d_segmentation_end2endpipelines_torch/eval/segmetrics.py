"""Segmentation evaluation metrics
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/eval/segmetrics.py:23-143;
reference 2DCNN/Test.py:169-262).

The confusion matrix counts each batch with one ``torch.bincount`` on the
labels' device; the running total stays in int64 on the host, exact at
any pixel count.  The report's formulas, percent scaling and rounding to
2 decimals are the reference's.
"""
from __future__ import annotations

import typing as tp

import numpy as np
import torch

Labels = tp.Union[np.ndarray, torch.Tensor]


def confusion_matrix_update(cm: np.ndarray, y_true: Labels,
                            y_pred: Labels) -> np.ndarray:
    """``cm`` (C, C) plus the counts of the integer label pairs (true
    row, predicted column).  The counting runs where the labels are (a
    CUDA tensor's on the card, numpy on the CPU); pairs outside the C x C
    table are dropped, as ``jnp.bincount(..., length=C*C)`` drops them."""
    n = np.shape(cm)[0]
    t = torch.as_tensor(y_true).reshape(-1).long()
    p = torch.as_tensor(y_pred, device=t.device).reshape(-1).long()
    counts = torch.bincount(t * n + p, minlength=n * n)[:n * n]
    return np.asarray(cm, np.int64) + counts.reshape(n, n).cpu().numpy()


def init_confusion_matrix(num_classes: int) -> np.ndarray:
    return np.zeros((num_classes, num_classes), np.int64)


def per_class_binary_counts(cm: np.ndarray) -> np.ndarray:
    """(C, 2, 2) one-vs-rest matrices [[TN, FP], [FN, TP]] from the (C, C)
    matrix (sklearn's multilabel_confusion_matrix on integer labels)."""
    cm = np.asarray(cm, np.float64)
    total = cm.sum()
    out = np.zeros((cm.shape[0], 2, 2), np.float64)
    for k in range(cm.shape[0]):
        tp_ = cm[k, k]
        fn_ = cm[k].sum() - tp_
        fp_ = cm[:, k].sum() - tp_
        tn_ = total - tp_ - fn_ - fp_
        out[k] = [[tn_, fp_], [fn_, tp_]]
    return out


def evaluation_table(cm: np.ndarray, labels: tp.Sequence[str]
                     ) -> tp.Dict[str, tp.Any]:
    """Per class: Accuracy, Precision, Sensitivity, F1-score, Specificity,
    DSC and IOU in percent, rounded to 2 decimals; their average weighted
    by class size; the overall accuracy (Test.py:216-262)."""
    cm = np.asarray(cm, np.float64)
    per_class = per_class_binary_counts(cm)
    rows = []
    for k in range(len(labels)):
        TN, FP = per_class[k][0]
        FN, TP = per_class[k][1]
        denom = TP + TN + FP + FN
        acc = round(100 * (TP + TN) / denom, 2) if denom else 0.0
        prec = round(100 * TP / (TP + FP), 2) if TP + FP else 0.0
        sens = round(100 * TP / (TP + FN), 2) if TP + FN else 0.0
        f1 = (round((2 * prec * sens) / (prec + sens), 2)
              if prec + sens else 0.0)
        spec = round(100 * TN / (TN + FP), 2) if TN + FP else 0.0
        dsc = (round(100 * (2 * TP) / (2 * TP + FP + FN), 2)
               if 2 * TP + FP + FN else 0.0)
        iou = round(100 * TP / (TP + FP + FN), 2) if TP + FP + FN else 0.0
        rows.append([acc, prec, sens, f1, spec, dsc, iou])
    rows = np.asarray(rows)
    sizes = cm.sum(axis=1)
    weights = sizes / max(sizes.sum(), 1.0)
    weighted = np.round(rows.T @ sizes / max(sizes.sum(), 1.0), 2)
    overall_acc = round(100 * np.trace(cm) / max(cm.sum(), 1.0), 2)
    headers = ["Accuracy", "Precision", "Sensitivity", "F1-score",
               "Specificity", "DSC", "IOU"]
    return {
        "headers": headers,
        "labels": list(labels),
        "per_class": rows,
        "weighted_average": weighted,
        "overall_accuracy": overall_acc,
        "confusion_matrix": cm,
        "normalized_confusion_matrix": cm / np.maximum(
            cm.sum(axis=1, keepdims=True), 1.0),
        "class_sizes": sizes,
        "class_weights": weights,
    }


def one_hot_encoding(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Reference ``one_hot_encoding`` (utils/helper_functions.py:31-36)."""
    return np.eye(num_classes, dtype=np.float32)[np.asarray(labels,
                                                            np.int64)]


def reverse_one_hot_encoding(one_hot: np.ndarray) -> np.ndarray:
    """Reference ``reverse_one_hot_encoding`` (helper_functions.py:39-44)."""
    return np.argmax(one_hot, axis=-1)


def dice(y_true: np.ndarray, y_pred: np.ndarray, smooth: float = 1.0
         ) -> float:
    """Reference ``dice`` (helper_functions.py:383-388)."""
    t = np.asarray(y_true).ravel()
    p = np.asarray(y_pred).ravel()
    inter = np.sum(t * p)
    return (2.0 * inter + smooth) / (t.sum() + p.sum() + smooth)


def label_from_pred(pred: np.ndarray, class_number: int,
                    threshold: float = 0.5) -> np.ndarray:
    """Model output -> integer label map (reference Test.py:169-175):
    binary = threshold channel 0; multiclass = binarize each of the
    ``class_number`` foreground channels at the threshold and sum, so
    ordinal mask encodings land in 0..class_number."""
    pred = np.asarray(pred)
    if class_number <= 1:
        return (pred[..., 0] > threshold).astype(np.int32)
    fg = pred[..., :class_number]
    return (fg > threshold).astype(np.int32).sum(-1)
