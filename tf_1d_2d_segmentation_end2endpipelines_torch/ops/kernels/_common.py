"""What the kernel wrappers share: the launch counter and the dtype codes
that the kernels' C entry points take."""
from __future__ import annotations

import threading

import torch

#: dtype -> its code in the kernels' C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class Counter:
    """A count that several threads (the server's batcher and its callers)
    may raise at once.  A wrapper adds one where it launches its kernel,
    under the name of the kernel that the C launcher reports it launched
    (``by_kernel``), or makes the copy it counts, and nowhere else."""

    def __init__(self) -> None:
        self.value = 0
        #: kernel name -> launches, over the same span as ``value``
        self.by_kernel: dict = {}
        self._lock = threading.Lock()

    def add(self, kernel: "str | None" = None) -> None:
        with self._lock:
            self.value += 1
            if kernel is not None:
                self.by_kernel[kernel] = self.by_kernel.get(kernel, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0
            self.by_kernel.clear()
