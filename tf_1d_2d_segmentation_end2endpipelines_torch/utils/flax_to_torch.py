"""Convert the JAX package's flax variables into the port's ``state_dict``,
and optax's optimizer states into the port's optimizers'
(``load_optax_state`` for the eight of the registry; ``load_adam_state``
for a bare Adam state).

The port's modules carry the flax auto-names, so a flax path maps to a
``state_dict`` key by joining it with dots and renaming the leaf:

==========================  ========================  =====================
flax leaf                   torch key                 layout
==========================  ========================  =====================
params .../kernel           .../weight                4-D: ``permute(3, 2,
                                                      0, 1)``; 3-D (1D):
                                                      ``permute(2, 1, 0)``
                                                      then a unit H axis;
                                                      2-D (Dense): ``.t()``
params .../recurrent_kernel .../recurrent_kernel      as a kernel
params .../bias             .../bias                  as is
params .../scale            .../weight                as is (BatchNorm)
params .../mean, .../var    .../mean, .../var         as is (``InputNorm``'s
                                                      trained parameters)
batch_stats .../mean        .../running_mean          as is
batch_stats .../var         .../running_var           as is
==========================  ========================  =====================

The Self-ONN layers' leaves map the same way: ``Oper_<k>/onn_conv``
(the model's Self head ``out/onn_conv`` too) and
``OperTranspose_<k>/onn_trans_conv``, whose kernels' input channels are
the power stack's ``[x, x**2, x**3]`` in the port's order as well
(ops/onn.py).

The one permutation serves both kernels: a Conv's HWIO becomes OIHW, and
a ConvTranspose's (kh, kw, C_out, C_in), stored with
``transpose_kernel=True``, becomes ``conv_transpose2d``'s
(C_in, C_out, kh, kw), and a depthwise conv's (k, k, 1, C) the grouped
(C, 1, k, k) weight.  A Dense kernel (in, out) becomes ``nn.Linear``'s
(out, in) weight.  The 1D models convolve (B, C, 1, L) tensors, so
a 1D Conv's (k, C_in, C_out) becomes (C_out, C_in, 1, k) and a 1D
ConvTranspose's (k, C_out, C_in) the (C_in, C_out, 1, k) weight, both by
``permute(2, 1, 0)`` and a unit axis (no flip: ``ops/blocks.py``'s
``TransConv``).
"""
from __future__ import annotations

import typing as tp

import numpy as np
import torch

_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("params", "recurrent_kernel"): "recurrent_kernel",
    ("params", "mean"): "mean",
    ("params", "var"): "var",
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
    flax leaf fills or two fill, and ``ValueError`` on a shape mismatch:
    each flax leaf is one torch tensor and back (the per-variable
    ``clipnorm`` depends on it)."""
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
        if key in out:
            raise KeyError(f"two flax leaves fill the torch key {key!r}")
        arr = torch.from_numpy(np.array(value, dtype=np.float32))
        if arr.dim() == 4:
            arr = arr.permute(3, 2, 0, 1).contiguous()
        elif arr.dim() == 3:
            arr = arr.permute(2, 1, 0).unsqueeze(2).contiguous()
        elif arr.dim() == 2:
            arr = arr.t().contiguous()
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


#: per optimizer: the optax state that holds its per-parameter trees (by
#: the fields that hold them) -> the torch state keys they become
_OPTAX_TREES = {
    "Adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "Adamax": {"mu": "exp_avg", "nu": "exp_inf"},
    "Nadam": {"mu": "mu", "nu": "nu"},
    "Adadelta": {"e_g": "square_avg", "e_x": "acc_delta"},
    "Adagrad": {"sum_of_squares": "sum_of_squares"},
    "RMSprop": {"nu": "nu"},
    "SGD": {},
}
#: the torch.optim classes' float32 ``step`` tensor; the port's Nadam
#: counts in a Python int
_TENSOR_STEP = ("Adam", "Adamax", "Adadelta")


def load_optax_state(optimizer: torch.optim.Optimizer,
                     model: torch.nn.Module, name: str,
                     opt_state: tp.Any) -> None:
    """Carry the JAX ``make_optimizer(name, ...)``'s state into the port's
    ``make_optimizer(name, ...)`` over the parameters of ``model``: the
    injected learning rate into ``param_groups``, and the inner state of
    the optimizer, through the clip chain when there is one (its clips
    keep no state), into ``optimizer.state``, each tree through the
    parameters' layout (``flax_to_state_dict``) and onto each parameter's
    device.  ``opt_state`` is read by its fields (``inner_state``,
    ``hyperparams``, ``count``, ``mu``, ...), so optax need not be
    importable here."""
    params = dict(model.named_parameters())
    lr = float(np.asarray(opt_state.hyperparams["learning_rate"]))
    for group in optimizer.param_groups:
        group["lr"] = lr
    count = int(np.asarray(opt_state.count))
    inner = opt_state.inner_state
    if (isinstance(inner, tuple) and isinstance(inner[-1], tuple)
            and not hasattr(inner[-1], "_fields")):
        inner = inner[-1]  # (clip states..., the optimizer's chain)
    if name == "FTRL":
        trees = {"accum": inner[0], "linear": inner[1]}
    elif name in _OPTAX_TREES:
        fields = _OPTAX_TREES[name]
        trees = {}
        if fields:
            st = next(s for s in inner
                      if all(hasattr(s, f) for f in fields))
            trees = {key: getattr(st, f) for f, key in fields.items()}
            if "count" in st._fields:
                count = int(np.asarray(st.count))
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    converted = {key: flax_to_state_dict({"params": tree}, params)
                 for key, tree in trees.items()}
    for pname, p in params.items():
        state = {key: c[pname].to(p.device) for key, c in converted.items()}
        if name in _TENSOR_STEP:
            state["step"] = torch.tensor(float(count), dtype=torch.float32)
        elif name == "Nadam":
            state["step"] = count
        optimizer.state[p] = state


def ema_from_flax(model: torch.nn.Module,
                  ema_params: tp.Mapping) -> tp.List[torch.Tensor]:
    """The JAX state's ``ema_params`` (a tree shaped like flax ``params``)
    as the port's EMA shadow: float32 tensors in ``model.parameters()``
    order, each on its parameter's device (``train.state.ema_shadow``'s
    layout), through the parameters' leaf mapping."""
    params = dict(model.named_parameters())
    shadow = flax_to_state_dict({"params": ema_params}, params)
    return [shadow[name].to(p.device) for name, p in params.items()]
