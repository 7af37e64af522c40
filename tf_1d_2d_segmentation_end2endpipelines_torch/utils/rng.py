"""Seeds of the port's random streams keyed by tuples of integers.

The JAX package folds integers into threefry keys
(``jax.random.fold_in``), whose bits cannot be reproduced without JAX.
The port keys ``torch.Generator``s instead, through numpy's
``SeedSequence``: the same key gives the same stream on every host, and
the draws run on the CPU, so the card and the CPU see the same values.
"""
from __future__ import annotations

import numpy as np
import torch


def stream_seed(*keys: int) -> int:
    """A seed for ``torch.Generator.manual_seed`` from non-negative
    integers: distinct tuples give unrelated streams."""
    state = np.random.SeedSequence([int(k) for k in keys]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def generator(*keys: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from ``keys``."""
    return torch.Generator().manual_seed(stream_seed(*keys))
