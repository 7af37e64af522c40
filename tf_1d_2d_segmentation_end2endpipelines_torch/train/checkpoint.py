"""Checkpoints of the port: ``torch.save`` files in a fold's directory,
where the JAX package writes orbax trees (train/checkpoint.py there).

Two flavors, as in the JAX package:

- ``save``/``restore``, weights only: ``<name>.pt`` holds the model's
  ``state_dict`` (parameters and BatchNorm running statistics, on the CPU),
  the file ``serve`` loads (``drivers.BEST_WEIGHTS``);
  ``<name>_optimizer.pt`` the optimizer's ``state_dict`` beside it, for a
  run that resumes with ``load_weights``; and, when the trainer keeps an
  EMA shadow, ``<name>_ema.pt`` the shadow by parameter name beside the
  SHA-256 of the ``<name>.pt`` it was saved with (JAX puts both in one
  payload, :124-128).  A kill between the two files' renames leaves a
  shadow whose digest names other weights: ``read_shadow`` and
  ``restore`` ignore it, so the weights are never served with another
  epoch's shadow.
- ``save_full``/``restore_full``: ``<name>.pt`` holds the whole training
  state in one file (the model, the optimizer, the step count and the
  shadow), and ``<name>.meta.json`` a JSON sidecar (epoch, history,
  callback state, and the step count again as the pairing token), for
  exact resume (JAX :170-292).

Every file is written to a temporary name and renamed into place, so a
reader never sees half a file.  The sidecar is staged before the arrays
and renamed after them: a kill between the two leaves the new arrays, the
old sidecar and the new one staged, and ``restore_full`` adopts the staged
one by its step token (JAX ``_reconcile_meta``).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import typing as tp

import torch


def weights_file(name: str) -> str:
    return f"{name}.pt"


def optimizer_file(name: str) -> str:
    return f"{name}_optimizer.pt"


def ema_file(name: str) -> str:
    return f"{name}_ema.pt"


def _save(obj: tp.Any, path: str) -> str:
    """Write ``obj`` to ``path`` through a temporary name; returns the
    SHA-256 of the bytes written."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    data = buf.getbuffer()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return hashlib.sha256(data).hexdigest()


def _load(path: str) -> tp.Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_digest(path: str) -> tp.Tuple[tp.Any, str]:
    """The object in ``path`` and the SHA-256 of its bytes."""
    with open(path, "rb") as f:
        data = f.read()
    return (torch.load(io.BytesIO(data), map_location="cpu",
                       weights_only=True), hashlib.sha256(data).hexdigest())


def _cpu_state(model: torch.nn.Module) -> tp.Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def ema_state(model: torch.nn.Module, ema: tp.Sequence[torch.Tensor]
              ) -> tp.Dict[str, torch.Tensor]:
    """The shadow ``ema`` (in ``model.parameters()`` order) by parameter
    name, on the CPU."""
    return {name: e.detach().cpu()
            for (name, _), e in zip(model.named_parameters(), ema)}


def load_ema(model: torch.nn.Module, ema: tp.List[torch.Tensor],
             state: tp.Mapping[str, torch.Tensor]) -> None:
    """Copy a shadow by parameter name into ``ema`` in place."""
    with torch.no_grad():
        for (name, _), e in zip(model.named_parameters(), ema):
            e.copy_(state[name])


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = directory

    def path(self, name: str) -> str:
        return os.path.join(self.directory, weights_file(name))

    def _file(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _meta_path(self, name: str) -> str:
        return self._file(f"{name}.meta.json")

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))

    def _remove_meta(self, name: str) -> None:
        """Remove the sidecar of ``name`` and any staged one."""
        path = self._meta_path(name)
        for stale in (path, path + ".staging"):
            if os.path.isfile(stale):
                os.remove(stale)

    def save(self, model: torch.nn.Module,
             optimizer: tp.Optional[torch.optim.Optimizer],
             name: str = "best",
             ema: tp.Optional[tp.Sequence[torch.Tensor]] = None) -> None:
        """Weights only: the model's ``state_dict``, the optimizer's beside
        it when given, the shadow ``ema`` when given.  A weights-only save
        over a full checkpoint of the same name removes its sidecar, and
        one without ``ema`` removes a stale shadow file.  The shadow
        carries the digest of the weights file it belongs to, so one left
        behind by a kill (before its own rename, or before the removal)
        is never read with these weights."""
        os.makedirs(self.directory, exist_ok=True)
        self._remove_meta(name)
        digest = _save(_cpu_state(model), self.path(name))
        if optimizer is not None:
            _save(optimizer.state_dict(), self._file(optimizer_file(name)))
        shadow = self._file(ema_file(name))
        if ema is not None:
            _save({"weights_sha256": digest, "ema": ema_state(model, ema)},
                  shadow)
        elif os.path.exists(shadow):
            os.remove(shadow)

    def _paired_shadow(self, name: str, digest: str
                       ) -> tp.Optional[tp.Dict[str, torch.Tensor]]:
        """The shadow beside ``name`` when it was saved with the weights
        whose digest is ``digest``; None (with a warning for a stale
        one) otherwise."""
        path = self._file(ema_file(name))
        if not os.path.exists(path):
            return None
        saved = _load(path)
        if saved.get("weights_sha256") != digest:
            print(f"WARNING: {path} belongs to other weights than "
                  f"{self.path(name)} (a save cut between the two files); "
                  "ignoring the shadow", flush=True)
            return None
        return saved["ema"]

    def read_shadow(self, name: str = "best"
                    ) -> tp.Optional[tp.Dict[str, torch.Tensor]]:
        """The EMA shadow by parameter name saved with ``<name>.pt``, or
        None when there is none or it belongs to other weights."""
        return self._paired_shadow(name, _load_digest(self.path(name))[1])

    def restore(self, model: torch.nn.Module,
                optimizer: tp.Optional[torch.optim.Optimizer] = None,
                name: str = "best",
                ema: tp.Optional[tp.List[torch.Tensor]] = None
                ) -> tp.Optional[tp.Dict[str, torch.Tensor]]:
        """Load the weights into ``model`` and, when given and saved, the
        optimizer state into ``optimizer`` (moved to its parameters'
        device by ``load_state_dict``).  Tolerates an EMA mismatch either
        way (JAX :294-324): a saved shadow goes into ``ema`` when given,
        a checkpoint without one (or with a shadow saved with other
        weights) seeds ``ema`` from the restored parameters.  Returns the
        saved shadow by parameter name, or None (a caller without ``ema``
        may still serve it)."""
        weights, digest = _load_digest(self.path(name))
        model.load_state_dict(weights)
        opt_path = self._file(optimizer_file(name))
        if optimizer is not None and os.path.exists(opt_path):
            optimizer.load_state_dict(_load(opt_path))
        shadow = self._paired_shadow(name, digest)
        if ema is not None:
            if shadow is None:
                with torch.no_grad():
                    for e, p in zip(ema, model.parameters()):
                        e.copy_(p)
            else:
                load_ema(model, ema, shadow)
        return shadow

    # ------------------------------------------------- full checkpoints
    def save_full(self, model: torch.nn.Module,
                  optimizer: torch.optim.Optimizer, step: int,
                  name: str = "last",
                  ema: tp.Optional[tp.Sequence[torch.Tensor]] = None,
                  meta: tp.Optional[dict] = None) -> str:
        """The whole training state in ``<name>.pt`` and the JSON ``meta``
        (plus ``full``, ``has_ema`` and the ``step`` token) in its
        sidecar, staged first and placed after the arrays."""
        os.makedirs(self.directory, exist_ok=True)
        meta = dict(meta or {}, full=True, has_ema=ema is not None,
                    step=int(step))
        payload = {"model": _cpu_state(model),
                   "optimizer": optimizer.state_dict(), "step": int(step)}
        if ema is not None:
            payload["ema"] = ema_state(model, ema)
        staging = self._meta_path(name) + ".staging"
        with open(staging, "w") as f:
            json.dump(meta, f)
        _save(payload, self.path(name))
        os.replace(staging, self._meta_path(name))
        return self.path(name)

    @staticmethod
    def _read_json(path: str) -> tp.Optional[dict]:
        if not os.path.isfile(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None  # a torn write: unusable

    def read_meta(self, name: str = "last") -> tp.Optional[dict]:
        """The sidecar of a full checkpoint (None when absent); the staged
        one when only that survives beside the arrays."""
        meta = self._read_json(self._meta_path(name))
        if meta is None and self.exists(name):
            meta = self._read_json(self._meta_path(name) + ".staging")
        return meta

    def has_full(self, name: str = "last") -> bool:
        meta = self.read_meta(name)
        return bool(meta and meta.get("full")) and self.exists(name)

    def restore_full(self, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, name: str = "last",
                     ema: tp.Optional[tp.List[torch.Tensor]] = None
                     ) -> tp.Tuple[int, dict]:
        """Load a full checkpoint into ``model``, ``optimizer`` and
        ``ema`` in place (same model and optimizer as the saving run, and
        an EMA shadow on both sides or on neither); returns ``(step,
        meta)``."""
        meta = self.read_meta(name)
        if not meta or not meta.get("full"):
            raise FileNotFoundError(
                f"{self.path(name)} is not a full checkpoint (no meta "
                "sidecar); was it saved with save_full()?")
        if bool(meta.get("has_ema")) != (ema is not None):
            which = ("checkpoint tracks EMA but the trainer does not"
                     if meta.get("has_ema") else
                     "trainer tracks EMA but the checkpoint does not")
            raise ValueError(f"{which}; exact resume requires the same "
                             "ema_decay setting")
        payload = _load(self.path(name))
        try:
            model.load_state_dict(payload["model"])
            optimizer.load_state_dict(payload["optimizer"])
        except (KeyError, RuntimeError, ValueError) as e:
            raise ValueError(
                "full-checkpoint restore failed: exact resume requires the "
                "same model and optimizer configuration as the saving run "
                f"({e})") from e
        if ema is not None:
            load_ema(model, ema, payload["ema"])
        step = int(payload["step"])
        return step, self._reconcile_meta(name, meta, step)

    def _reconcile_meta(self, name: str, meta: dict, step: int) -> dict:
        """The sidecar that describes the restored arrays, by the step
        token: a kill between the arrays and the sidecar's rename leaves
        the right one staged; adopt it.  Tokenless sidecars pass."""
        if meta.get("step") in (None, step):
            return meta
        staging = self._meta_path(name) + ".staging"
        staged = self._read_json(staging)
        if staged and staged.get("step") == step:
            os.replace(staging, self._meta_path(name))
            return staged
        print(f"WARNING: checkpoint '{name}' meta sidecar does not match "
              f"its arrays (arrays step {step}, meta step "
              f"{meta.get('step')}); resuming from the recorded epoch: the "
              "resumed trajectory may repeat one epoch", flush=True)
        return meta
