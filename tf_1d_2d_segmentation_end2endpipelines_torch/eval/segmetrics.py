"""Prediction-to-label rule
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/eval/segmetrics.py:129)."""
from __future__ import annotations

import numpy as np


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
