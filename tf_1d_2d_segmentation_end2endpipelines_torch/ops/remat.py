"""Rematerialization of the port (JAX: ``REMAT_POLICIES`` and
``_remat_policy``, tf_1d_2d_segmentation_end2endpipelines_tpu/train/
state.py:87-107; ``remat_block``, ops/blocks.py:33-73).

``checkpoint(fn, *args, policy=name)`` runs ``fn`` under
``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
forward of ``fn`` instead of keeping its activations.  The policies, by
the JAX names:

- ``full`` saves nothing (``nothing_saveable``);
- ``dots`` would save the outputs of matrix products (``checkpoint_dots``);
  no model, block or loss of the port has one (their products are all
  convolutions), so it saves nothing either, as on the TPU, and runs as
  ``full``;
- ``conv_outs`` saves the convolutions' outputs (plain and transposed),
  and recomputes the elementwise tail (bias, BatchNorm, activations,
  concatenations, pools), through a selective-checkpoint context.

While the backward recomputes a forward, ``recomputing()`` is true: the
port's BatchNorm then leaves its running statistics alone, so they
advance once a step as in the JAX package's functional step.  The max
pools run again in the recompute, and their kernels launch again.

A checkpoint around the whole forward (the train step's ``remat``) is
recomputed whole when the backward starts, so every activation the
backward needs is live again at once: on the card its peak memory is the
plain step's (PERF.md section 5).  ``remat = blocks`` recomputes one block
at a time.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import typing as tp

import torch
from torch.utils import checkpoint as _ckpt

REMAT_POLICIES = ("dots", "conv_outs", "full")

# per thread: autograd recomputes in the thread that runs the backward
_state = threading.local()


def recomputing() -> bool:
    """True while this thread recomputes a checkpointed forward."""
    return getattr(_state, "depth", 0) > 0


@contextlib.contextmanager
def _recompute_context(inner: tp.ContextManager):
    with inner:
        _state.depth = getattr(_state, "depth", 0) + 1
        try:
            yield
        finally:
            _state.depth -= 1


def _context_fn(policy: str):
    if policy != "conv_outs":  # full, and dots (nothing to save here)
        return contextlib.nullcontext(), _recompute_context(
            contextlib.nullcontext())
    conv = torch.ops.aten.convolution.default

    def choose(ctx, op, *args, **kwargs):
        return (_ckpt.CheckpointPolicy.MUST_SAVE if op == conv
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    forward, recompute = _ckpt.create_selective_checkpoint_contexts(choose)
    return forward, _recompute_context(recompute)


def check_policy(policy: tp.Optional[str]) -> tp.Optional[str]:
    """``policy`` when it names a policy, None for none (None or ""); an
    unknown name raises ``ValueError`` (JAX state.py:96-98)."""
    if not policy:
        return None
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; expected one "
                         f"of {sorted(REMAT_POLICIES)}")
    return policy


def checkpoint(fn: tp.Callable, *args, policy: str = "full"):
    """``fn(*args)``, its forward recomputed in the backward under
    ``policy``."""
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            context_fn=functools.partial(
                                _context_fn, check_policy(policy)))
