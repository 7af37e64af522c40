"""Optimizers of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/train/optimizers.py).

The eight names of the JAX registry with its hyperparameters, and
optax's update formulas, not torch's defaults:

- ``Adam`` (b1 0.9, b2 0.999, eps 1e-7 outside the square root),
  ``Adadelta`` (rho 0.95, eps 1e-7), ``Adamax`` (b1 0.9, b2 0.999, eps
  1e-7) and ``SGD`` (no momentum) are ``torch.optim``'s classes, whose
  updates are optax's under these settings;
- ``Adagrad``, ``RMSprop`` and ``Nadam`` differ from torch's and
  ``FTRL`` has no torch counterpart: they are written here, as optax
  computes them (and the JAX ``_ftrl``, :18-51).

The learning rate lives in the optimizer's ``param_groups``, where the
JAX package injects it with ``optax.inject_hyperparams``;
``set_learning_rate`` and ``get_learning_rate`` are ReduceLROnPlateau's
hooks.  The gradient clips (``global_clipnorm``, then ``clipnorm`` per
parameter, then ``clipvalue``: the JAX chain's order, :117-128) run in a
step pre-hook, on the raw gradients before the optimizer's statistics.
"""
from __future__ import annotations

import typing as tp

import torch

#: every optimizer name of the JAX package (train/optimizers.py:134)
OPTIMIZER_NAMES = ("Adam", "Adadelta", "Adagrad", "Adamax", "FTRL", "Nadam",
                   "RMSprop", "SGD")

_Params = tp.Iterable[torch.nn.Parameter]


def _with_grads(group: dict) -> tp.List[torch.nn.Parameter]:
    return [p for p in group["params"] if p.grad is not None]


def _state(opt: torch.optim.Optimizer, params: tp.List[torch.Tensor],
           key: str, fill: float) -> tp.List[torch.Tensor]:
    """The per-parameter state ``key`` of ``params``, created full of
    ``fill`` at a parameter's first step."""
    out = []
    for p in params:
        st = opt.state[p]
        if key not in st:
            st[key] = torch.full_like(p, fill,
                                      memory_format=torch.preserve_format)
        out.append(st[key])
    return out


def _step_count(opt: torch.optim.Optimizer, params) -> int:
    """Count this step in every parameter's ``step`` (optax's one
    ``count``); returns the new count."""
    count = 0
    for p in params:
        st = opt.state[p]
        st["step"] = int(st.get("step", 0)) + 1
        count = st["step"]
    return count


class Adagrad(torch.optim.Optimizer):
    """optax ``adagrad``: ``sum_of_squares`` starts at
    ``initial_accumulator_value`` and adds g**2; the update is
    ``-lr * g * rsqrt(sum_of_squares + eps)`` where the sum is positive,
    else 0 (torch's divides by ``sqrt(sum) + eps``)."""

    def __init__(self, params: _Params, lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = _with_grads(group)
            if not params:
                continue
            grads = [p.grad for p in params]
            acc = _state(self, params, "sum_of_squares",
                         group["initial_accumulator_value"])
            torch._foreach_addcmul_(acc, grads, grads)
            for p, g, a in zip(params, grads, acc):
                scale = torch.where(a > 0, torch.rsqrt(a + group["eps"]), 0.0)
                p.addcmul_(g, scale, value=-group["lr"])


class RMSprop(torch.optim.Optimizer):
    """optax ``rmsprop`` (not centered, no momentum): ``nu = decay * nu +
    (1 - decay) * g**2`` from ``initial_scale``, the update ``-lr * g *
    rsqrt(nu + eps)``, eps inside the root and no bias correction
    (torch's has eps outside the root)."""

    def __init__(self, params: _Params, lr: float, decay: float = 0.9,
                 eps: float = 1e-7, initial_scale: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      initial_scale=initial_scale))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = _with_grads(group)
            if not params:
                continue
            grads = [p.grad for p in params]
            decay = group["decay"]
            nu = _state(self, params, "nu", group["initial_scale"])
            torch._foreach_mul_(nu, decay)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - decay)
            for p, g, n in zip(params, grads, nu):
                p.addcmul_(g, torch.rsqrt(n + group["eps"]),
                           value=-group["lr"])


class Nadam(torch.optim.Optimizer):
    """optax ``nadam``: Adam with the Nesterov form of the first moment,
    ``mu_hat = b1 * mu / (1 - b1**(t+1)) + (1 - b1) * g / (1 - b1**t)``,
    ``nu_hat = nu / (1 - b2**t)``, the update ``-lr * mu_hat /
    (sqrt(nu_hat) + eps)`` (torch's ``NAdam`` decays the momentum on a
    schedule)."""

    def __init__(self, params: _Params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = _with_grads(group)
            if not params:
                continue
            grads = [p.grad for p in params]
            b1, b2 = group["b1"], group["b2"]
            mu = _state(self, params, "mu", 0.0)
            nu = _state(self, params, "nu", 0.0)
            t = _step_count(self, params)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            mu_hat = torch._foreach_mul(mu, b1 / (1.0 - b1 ** (t + 1)))
            torch._foreach_add_(mu_hat, grads,
                                alpha=(1.0 - b1) / (1.0 - b1 ** t))
            denom = torch._foreach_div(nu, 1.0 - b2 ** t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_addcdiv_(params, mu_hat, denom,
                                    value=-group["lr"])


class FTRL(torch.optim.Optimizer):
    """FTRL-proximal as the JAX package writes it (``_ftrl``, Keras's
    hyperparameters): ``accum`` from ``initial_accumulator_value`` adds
    g**2, ``linear += g - sigma * p`` with ``sigma = (accum_new**-power -
    accum**-power) / lr``, and the parameter becomes ``(clip(linear, -l1,
    l1) - linear) / (accum_new**-power / lr + 2 * l2)`` (``-linear / ...``
    when l1 is 0).  ``lr`` is read at every step, so ReduceLROnPlateau's
    hook changes sigma as it changes the JAX package's."""

    def __init__(self, params: _Params, lr: float,
                 learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1: float = 0.0, l2: float = 0.0):
        super().__init__(params, dict(
            lr=lr, learning_rate_power=learning_rate_power,
            initial_accumulator_value=initial_accumulator_value,
            l1=l1, l2=l2))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = _with_grads(group)
            if not params:
                continue
            lr, power = group["lr"], -group["learning_rate_power"]
            l1, l2 = group["l1"], group["l2"]
            accum = _state(self, params, "accum",
                           group["initial_accumulator_value"])
            linear = _state(self, params, "linear", 0.0)
            for p, a, lin in zip(params, accum, linear):
                g = p.grad
                new_a = a + g * g
                sigma = (torch.pow(new_a, power) - torch.pow(a, power)) / lr
                lin.add_(g - sigma * p)
                quad = torch.pow(new_a, power) / lr + 2 * l2
                pre = (torch.clamp(lin, -l1, l1) - lin) if l1 > 0 else -lin
                p.copy_(pre / quad)
                a.copy_(new_a)


def _factory(name: str) -> tp.Callable[[_Params, float],
                                       torch.optim.Optimizer]:
    if name == "Adam":
        return lambda ps, lr: torch.optim.Adam(ps, lr=lr, betas=(0.9, 0.999),
                                               eps=1e-7)
    if name == "Adadelta":
        return lambda ps, lr: torch.optim.Adadelta(ps, lr=lr, rho=0.95,
                                                   eps=1e-7)
    if name == "Adagrad":
        return lambda ps, lr: Adagrad(ps, lr, initial_accumulator_value=0.1,
                                      eps=1e-7)
    if name == "Adamax":
        return lambda ps, lr: torch.optim.Adamax(ps, lr=lr,
                                                 betas=(0.9, 0.999), eps=1e-7)
    if name == "FTRL":
        return FTRL
    if name == "Nadam":
        return lambda ps, lr: Nadam(ps, lr, b1=0.9, b2=0.999, eps=1e-7)
    if name == "RMSprop":
        return lambda ps, lr: RMSprop(ps, lr, decay=0.9, eps=1e-7)
    if name == "SGD":
        return lambda ps, lr: torch.optim.SGD(ps, lr=lr)
    raise ValueError(
        "Please select a valid optimizer. Check for spelling mistakes, "
        f"capital/small letters, etc. (got {name!r})")


def clip_gradients(params: tp.Sequence[torch.Tensor],
                   global_clipnorm: float = 0.0, clipnorm: float = 0.0,
                   clipvalue: float = 0.0) -> None:
    """Clip the gradients of ``params`` in place, as the JAX chain does
    (0 = off), in its order:

    1. ``global_clipnorm``: optax ``clip_by_global_norm``, every gradient
       times ``max_norm / norm`` when the global L2 norm is at least
       ``max_norm`` (``clip_grad_norm_`` divides by ``norm + 1e-6``);
    2. ``clipnorm``: each parameter's gradient (one flax leaf) times
       ``min(1, max_norm / max(its norm, 1e-12))``;
    3. ``clipvalue``: each element into [-clipvalue, clipvalue].

    Nothing waits for the card: the factors stay on the device."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    if global_clipnorm:
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        factor = torch.where(norm < global_clipnorm, 1.0,
                             global_clipnorm / norm)
        torch._foreach_mul_(grads, factor)
    if clipnorm:
        norms = torch._foreach_norm(grads)
        for g, n in zip(grads, norms):
            g.mul_(torch.clamp_max(clipnorm / torch.clamp_min(n, 1e-12),
                                   1.0))
    if clipvalue:
        torch._foreach_clamp_min_(grads, -clipvalue)
        torch._foreach_clamp_max_(grads, clipvalue)


def make_optimizer(name: str, params: _Params, learning_rate: float,
                   clipnorm: float = 0.0, clipvalue: float = 0.0,
                   global_clipnorm: float = 0.0) -> torch.optim.Optimizer:
    """Optimizer by the reference's name over ``params``, its gradients
    clipped before each step when a clip is set (``clip_gradients``); an
    unknown name raises ``ValueError``."""
    optimizer = _factory(name)(params, learning_rate)
    if clipnorm or clipvalue or global_clipnorm:
        def clip(opt, args, kwargs):
            clip_gradients([p for g in opt.param_groups for p in g["params"]],
                           global_clipnorm, clipnorm, clipvalue)
        optimizer.register_step_pre_hook(clip)
    return optimizer


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group (RLRoP hook)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
