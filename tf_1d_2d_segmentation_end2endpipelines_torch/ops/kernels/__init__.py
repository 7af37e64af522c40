"""Kernels written by hand for Hopper (``csrc/``), each with its plain
PyTorch version and a launch count.  Nothing is built at import: a kernel
is compiled at its first launch (``_build.py``)."""
from . import pool_backward, pyramid  # noqa: F401
