"""Optimizers of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/train/optimizers.py).

Ported: ``Adam`` with the reference's hyperparameters (b1 0.9, b2 0.999,
eps 1e-7 outside the square root, as optax's and Keras's).  The learning
rate lives in the optimizer's ``param_groups``, where the JAX package
injects it with ``optax.inject_hyperparams``; ``set_learning_rate`` and
``get_learning_rate`` are ReduceLROnPlateau's hooks.
"""
from __future__ import annotations

import typing as tp

import torch

#: every optimizer name of the JAX package (train/optimizers.py:134)
OPTIMIZER_NAMES = ("Adam", "Adadelta", "Adagrad", "Adamax", "FTRL", "Nadam",
                   "RMSprop", "SGD")


def make_optimizer(name: str, params: tp.Iterable[torch.nn.Parameter],
                   learning_rate: float, clipnorm: float = 0.0,
                   clipvalue: float = 0.0, global_clipnorm: float = 0.0
                   ) -> torch.optim.Optimizer:
    """Optimizer by the reference's name over ``params``.  Gradient
    clipping and every name but ``Adam`` raise ``NotImplementedError``
    (not ported yet); an unknown name raises ``ValueError``."""
    if clipnorm or clipvalue or global_clipnorm:
        raise NotImplementedError("gradient clipping is not ported yet")
    if name == "Adam":
        return torch.optim.Adam(params, lr=learning_rate,
                                betas=(0.9, 0.999), eps=1e-7)
    if name in OPTIMIZER_NAMES:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ported: Adam)")
    raise ValueError(
        "Please select a valid optimizer. Check for spelling mistakes, "
        f"capital/small letters, etc. (got {name!r})")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group (RLRoP hook)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
