"""The kernels' launch counters: each wrapper adds one to its counter
under the name of the kernel that the C launcher reports it launched
(``_build.launch``), so that a run's launches are counted per kernel, not
inferred from its calls.  Here the C entry point is a stand-in that
reports a name through the same ``const char**`` the kernels' library
fills; on a card ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` read
the names the real launcher reports."""
import ctypes
import threading

import pytest

pytest.importorskip("torch")

from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    _build)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels._common import (  # noqa: E402
    Counter)


class _FakeLibrary:
    """A stand-in for the kernels' library: ``tpuseg_fake`` records its
    arguments, reports ``name`` as the kernel it launched and returns
    ``code``."""

    def __init__(self, name: bytes, code: int = 0):
        self.name, self.code, self.calls = name, code, []

    def tpuseg_fake(self, *args):
        *rest, launched, stream = args
        self.calls.append((tuple(rest), stream))
        ctypes.cast(launched, ctypes.POINTER(ctypes.c_char_p))[0] = self.name
        return self.code

    @staticmethod
    def tpuseg_cuda_error_string(code):
        return b"invalid argument"


def test_counter_counts_by_kernel_and_resets():
    c = Counter()
    for name in ("pool_rows_kernel<V=16B>", "pool_vec_kernel",
                 "pool_rows_kernel<V=16B>"):
        c.add(name)
    c.add()  # a copy: counted, under no kernel
    assert c.value == 4
    assert c.by_kernel == {"pool_rows_kernel<V=16B>": 2, "pool_vec_kernel": 1}
    held = c.by_kernel
    c.reset()
    assert c.value == 0 and c.by_kernel == {} and held is c.by_kernel


def test_counter_by_kernel_under_threads():
    c = Counter()
    names = ["pool_backward_block_kernel", "pool_backward_rows_kernel"]

    def add(name):
        for _ in range(500):
            c.add(name)

    threads = [threading.Thread(target=add, args=(names[i % 2],))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 4000
    assert c.by_kernel == {names[0]: 2000, names[1]: 2000}


@pytest.mark.parametrize("name,counted", [
    (b"pool_rows_kernel<V=16B>", 1), (b"pool_backward_block_kernel<V=1>", 1),
    (b"none", 0)])
def test_launch_counts_the_kernel_the_launcher_reports(name, counted):
    lib, c = _FakeLibrary(name), Counter()
    _build.launch(lib, "tpuseg_fake", (1, b"pool_vec_kernel"), 7, "fake", c)
    assert lib.calls == [((1, b"pool_vec_kernel"), 7)]
    assert c.value == counted
    assert c.by_kernel == ({name.decode(): 1} if counted else {})


def test_launch_raises_on_an_error_and_counts_nothing():
    lib, c = _FakeLibrary(b"none", code=1), Counter()
    with pytest.raises(RuntimeError, match="fake: CUDA error 1 "
                                           r"\(invalid argument\)"):
        _build.launch(lib, "tpuseg_fake", (), 0, "fake", c)
    assert c.value == 0 and c.by_kernel == {}

