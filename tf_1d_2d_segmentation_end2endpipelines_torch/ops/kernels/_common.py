"""What the kernel wrappers share: the launch counter and the dtype codes
that the kernels' C entry points take."""
from __future__ import annotations

import threading

import torch

#: dtype -> its code in the kernels' C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class Counter:
    """A count that several threads (the server's batcher and its callers)
    may raise at once.  A wrapper adds one where it launches its kernel, or
    makes the copy it counts, and nowhere else."""

    def __init__(self) -> None:
        self.value = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0
