"""Evaluation helpers of the port."""
from .segmetrics import label_from_pred  # noqa: F401
