"""Checkpoints of the port: ``state_dict`` files in a fold's directory,
where the JAX package writes orbax trees (train/checkpoint.py there).

``<directory>/<name>.pt`` holds the model's ``state_dict`` (parameters and
BatchNorm running statistics, on the CPU): the file ``serve`` loads
(``drivers.BEST_WEIGHTS``).  ``<directory>/<name>_optimizer.pt`` holds the
optimizer's ``state_dict`` beside it, for a run that resumes with
``load_weights``.  Each file is written to a temporary name and renamed
into place, so a reader never sees half a file.
"""
from __future__ import annotations

import os
import typing as tp

import torch


def weights_file(name: str) -> str:
    return f"{name}.pt"


def optimizer_file(name: str) -> str:
    return f"{name}_optimizer.pt"


def _save(obj: tp.Any, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = directory

    def path(self, name: str) -> str:
        return os.path.join(self.directory, weights_file(name))

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))

    def save(self, model: torch.nn.Module,
             optimizer: tp.Optional[torch.optim.Optimizer],
             name: str = "best") -> None:
        os.makedirs(self.directory, exist_ok=True)
        _save({k: v.detach().cpu() for k, v in model.state_dict().items()},
              self.path(name))
        if optimizer is not None:
            _save(optimizer.state_dict(),
                  os.path.join(self.directory, optimizer_file(name)))

    def restore(self, model: torch.nn.Module,
                optimizer: tp.Optional[torch.optim.Optimizer] = None,
                name: str = "best") -> None:
        """Load the weights into ``model`` and, when given and saved, the
        optimizer state into ``optimizer`` (moved to its parameters'
        device by ``load_state_dict``)."""
        model.load_state_dict(torch.load(self.path(name), map_location="cpu",
                                         weights_only=True))
        opt_path = os.path.join(self.directory, optimizer_file(name))
        if optimizer is not None and os.path.exists(opt_path):
            optimizer.load_state_dict(torch.load(
                opt_path, map_location="cpu", weights_only=True))
