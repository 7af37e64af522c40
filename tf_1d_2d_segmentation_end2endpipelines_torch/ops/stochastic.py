"""The port's stochastic layers and their random stream (JAX: ``DropBlock``,
tf_1d_2d_segmentation_end2endpipelines_tpu/ops/blocks.py:875, and flax's
``nn.Dropout``, drawn from the ``dropout`` rng the train step folds from
the trainer seed and the step, train/state.py:166-174 and :207).

The train step opens a ``random_stream``: a ``torch.Generator`` on the
model's device, keyed by (seed, step) or, under gradient accumulation,
(seed, step, microbatch) (``stream_generator``).  Every draw of a forward
in training mode comes from it, in the forward's order, so the same key
gives the same masks and a resumed run replays a straight one's.  A
training-mode forward outside a train step draws from torch's global
generator, as ``torch.nn.Dropout`` does.  In eval mode nothing is drawn:
the ``test`` and ``predict`` verbs and the server are deterministic.

A layer keeps the Bernoulli draws of its last forward (``drawn``).  While
the backward recomputes a checkpointed forward (``ops/remat.py``) it
reuses them instead of drawing: ``torch.utils.checkpoint`` restores the
global generator, not an explicit one, so under every ``remat`` mode the
gradients are the plain step's.  ``replay(model, draws)`` injects draws
(by module name, as ``drawn_by_name`` gives them) that every forward then
uses until ``replay(model, None)``: the tests replay one mask in the JAX
package's layer and the port's, and chip_smoke.py the card's draws on the
CPU.  The threefry bits of the JAX package cannot be reproduced, so the
draws themselves differ from JAX's; their law is the same (a uniform below
the rate).

The expansion of DropBlock's seeds into blocks is a stride-1 max pool over
a random constant, where JAX has a ``reduce_window`` outside any Pallas
kernel: it stays plain PyTorch.
"""
from __future__ import annotations

import contextlib
import threading
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from . import remat as _remat
from ..utils.rng import stream_seed

#: keeps the train step's stream apart from the other keyed streams
#: (utils/rng.py) that take as many integers
_DROPOUT_KEY = 0x44524F50

_state = threading.local()


def stream_generator(device: tp.Union[str, torch.device], seed: int,
                     step: int, *micro: int) -> torch.Generator:
    """The train step's generator on ``device`` for ``seed`` and ``step``
    (and the microbatch under accumulation)."""
    gen = torch.Generator(device=torch.device(device))
    return gen.manual_seed(stream_seed(_DROPOUT_KEY, seed, step, *micro))


@contextlib.contextmanager
def random_stream(generator: tp.Optional[torch.Generator]):
    """Within the block, the stochastic layers draw from ``generator``."""
    saved = getattr(_state, "generator", None)
    _state.generator = generator
    try:
        yield
    finally:
        _state.generator = saved


class _Stochastic(nn.Module):
    """A layer that draws a Bernoulli mask in training mode: from the
    stream, from the injected ``replayed`` draws, or, while a forward is
    recomputed, the draws of its forward."""

    def __init__(self):
        super().__init__()
        self.drawn: tp.Optional[torch.Tensor] = None
        self.replayed: tp.Optional[torch.Tensor] = None

    def _bernoulli(self, like: torch.Tensor, p: float) -> torch.Tensor:
        """A bool tensor shaped as ``like``: True with probability ``p``
        (a uniform below ``p``, as ``jax.random.bernoulli``)."""
        if self.replayed is not None:
            if self.replayed.shape != like.shape:
                raise ValueError(
                    f"replayed draws {tuple(self.replayed.shape)} do not fit "
                    f"the input {tuple(like.shape)}")
            self.drawn = self.replayed.to(like.device, torch.bool)
        elif not (_remat.recomputing() and self.drawn is not None):
            gen = getattr(_state, "generator", None)
            u = torch.rand(like.shape, generator=gen, device=like.device)
            self.drawn = u < p
        return self.drawn


class DropBlock(_Stochastic):
    """Contiguous-block dropout (JAX ``DropBlock``, blocks.py:875) over
    the length of a (B, C, 1, L) signal, in training mode only and when
    ``keep_prob`` < 1.  With ``bs = min(block_size, L)``, seeds are drawn
    per element and channel with rate ``gamma = (1 - keep_prob) / bs * L
    / (L - bs + 1)``, kept at the valid centres ``[(bs - 1) // 2, L - bs
    // 2)``, grown into blocks by a stride-1 SAME max over a ``bs`` window
    (padding ``((bs - 1) // 2, bs // 2)``, asymmetric for even ``bs``),
    and the output is ``x * mask / max(mean(mask), 1e-7)`` with ``mask =
    1 - block``, in ``x``'s dtype (the mean accumulated in at least
    float32, as ``jnp.mean``)."""

    def __init__(self, block_size: int = 7, keep_prob: float = 0.9):
        super().__init__()
        self.block_size = block_size
        self.keep_prob = keep_prob
        #: the kept share of the last training forward (a 0-d tensor)
        self.kept: tp.Optional[torch.Tensor] = None

    def block_mask(self, x: torch.Tensor) -> torch.Tensor:
        """The draw of this forward grown into ``1 - block``, in ``x``'s
        dtype."""
        n = x.shape[3]
        bs = min(self.block_size, n)
        gamma = (1.0 - self.keep_prob) / bs * n / (n - bs + 1)
        lo, hi = (bs - 1) // 2, bs // 2
        idx = torch.arange(n, device=x.device)
        seeds = self._bernoulli(x, gamma).to(x.dtype) * (
            (idx >= lo) & (idx < n - hi)).to(x.dtype)
        return 1.0 - F.max_pool2d(F.pad(seeds, (lo, hi)), (1, bs), stride=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.keep_prob >= 1.0:
            return x
        mask = self.block_mask(x)
        denom = mask.to(torch.promote_types(mask.dtype, torch.float32)
                        ).mean().to(x.dtype)
        self.kept = denom.detach()
        return x * mask / torch.clamp_min(denom, 1e-7)


class Dropout(_Stochastic):
    """flax ``nn.Dropout(rate)``: in training mode, each element kept with
    probability ``1 - rate`` and divided by it, the others 0; the
    identity in eval mode or at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = self._bernoulli(x, keep_prob)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def stochastic_layers(model: nn.Module) -> tp.Dict[str, _Stochastic]:
    """The stochastic layers of ``model`` by module name."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, _Stochastic)}


def drawn_by_name(model: nn.Module) -> tp.Dict[str, torch.Tensor]:
    """Each stochastic layer's draws of the last forward, by module
    name."""
    return {name: m.drawn for name, m in stochastic_layers(model).items()
            if m.drawn is not None}


def replay(model: nn.Module,
           draws: tp.Optional[tp.Mapping[str, torch.Tensor]]) -> None:
    """Make every stochastic layer of ``model`` use ``draws[name]`` (its
    module name) in each training forward from now on, or draw again
    (``None``)."""
    layers = stochastic_layers(model)
    if draws is not None and set(draws) - set(layers):
        raise KeyError(f"no stochastic layer named "
                       f"{sorted(set(draws) - set(layers))}")
    for name, m in layers.items():
        m.replayed = None if draws is None else draws.get(name)
