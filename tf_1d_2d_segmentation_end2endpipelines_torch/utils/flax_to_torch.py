"""Convert the JAX package's flax variables into the port's ``state_dict``,
and optax's Adam state into ``torch.optim.Adam``'s (``load_adam_state``).

The port's modules carry the flax auto-names, so a flax path maps to a
``state_dict`` key by joining it with dots and renaming the leaf:

======================  ===================  ==============================
flax leaf               torch key            layout
======================  ===================  ==============================
params .../kernel       .../weight           4-D: ``permute(3, 2, 0, 1)``
params .../bias         .../bias             as is
params .../scale        .../weight           as is (BatchNorm)
batch_stats .../mean    .../running_mean     as is
batch_stats .../var     .../running_var      as is
======================  ===================  ==============================

The one permutation serves both kernels: a Conv's HWIO becomes OIHW, and
a ConvTranspose's (kh, kw, C_out, C_in), stored with
``transpose_kernel=True``, becomes ``conv_transpose2d``'s
(C_in, C_out, kh, kw).
"""
from __future__ import annotations

import typing as tp

import numpy as np
import torch

_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree: tp.Mapping, prefix: tp.Tuple[str, ...] = ()
             ) -> tp.Iterator[tp.Tuple[tp.Tuple[str, ...], tp.Any]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, tp.Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def flax_to_state_dict(variables: tp.Mapping[str, tp.Mapping],
                       reference: tp.Mapping[str, torch.Tensor]
                       ) -> tp.Dict[str, torch.Tensor]:
    """Map ``{"params": ..., "batch_stats": ...}`` (nested dicts of arrays)
    onto the keys of ``reference`` (a model's ``state_dict()``).

    Raises ``KeyError`` on a flax leaf with no torch key, on a torch key no
    flax leaf fills, and ``ValueError`` on a shape mismatch."""
    out: tp.Dict[str, torch.Tensor] = {}
    for (collection, *path), value in _flatten(variables):
        leaf = _LEAVES.get((collection, path[-1]))
        if leaf is None:
            raise KeyError(f"unmapped flax leaf {collection}/"
                           f"{'/'.join(path)}")
        key = ".".join(path[:-1] + [leaf])
        if key not in reference:
            raise KeyError(f"flax leaf {collection}/{'/'.join(path)} has no "
                           f"torch counterpart {key!r}")
        arr = torch.from_numpy(np.array(value, dtype=np.float32))
        if arr.dim() == 4:
            arr = arr.permute(3, 2, 0, 1).contiguous()
        want = tuple(reference[key].shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: converted shape {tuple(arr.shape)} != "
                             f"model shape {want}")
        out[key] = arr
    missing = sorted(set(reference) - set(out))
    if missing:
        raise KeyError(f"torch keys no flax leaf fills: {missing}")
    return out


def load_flax_variables(model: torch.nn.Module,
                        variables: tp.Mapping[str, tp.Mapping]) -> None:
    """Convert ``variables`` and load them into ``model`` in place."""
    model.load_state_dict(flax_to_state_dict(variables, model.state_dict()))


def load_adam_state(optimizer: torch.optim.Optimizer,
                    model: torch.nn.Module, mu: tp.Mapping,
                    nu: tp.Mapping, count: int) -> None:
    """Carry optax's Adam state into ``torch.optim.Adam``'s for the
    parameters of ``model``: ``mu`` (the first moments, a tree shaped like
    flax ``params``) becomes ``exp_avg``, ``nu`` becomes ``exp_avg_sq``
    and ``count`` (updates so far) ``step``.  The moments are placed on
    each parameter's device."""
    params = dict(model.named_parameters())
    moments = [flax_to_state_dict({"params": tree}, params)
               for tree in (mu, nu)]
    for name, p in params.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": moments[0][name].to(p.device),
            "exp_avg_sq": moments[1][name].to(p.device),
        }
