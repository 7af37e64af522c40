"""Build the hand-written CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` of the package is compiled by its own ``nvcc``, all
started together, and the objects are linked into one shared library with
a plain C interface, at first use, into ``build/kernels/`` at the root of
the checkout.  The library's file name carries a hash of the
sources and flags, so an edited kernel is rebuilt and a stale library is
never loaded.  The build goes to a process-unique temporary file that is
renamed into place, so two processes racing to build never load a
half-written library.

A C interface needs no PyTorch headers, so a build takes seconds rather
than the minutes ``torch.utils.cpp_extension.load`` takes.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _sources() -> list:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libtpuseg_kernels-{h.hexdigest()[:12]}.so")


def _run_all(cmds: list) -> None:
    """Run ``cmds`` side by side; raise with the output of each that
    failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.build.{os.getpid()}"
    nvcc, srcs = _nvcc(), _sources()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                  for src, obj in zip(srcs, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' library, with
    the ``argtypes``/``restype`` of every exported function set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        cp, pcp = ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)
        lib.tpuseg_maxpool_pyramid.argtypes = [vp, vp, i32, i64, i32, i32,
                                               i32, i32, cp, pcp, vp]
        lib.tpuseg_maxpool_pyramid.restype = i32
        lib.tpuseg_maxpool_backward.argtypes = [vp, vp, vp, i32, i64, i32,
                                                i32, i32, i32, pcp, vp]
        lib.tpuseg_maxpool_backward.restype = i32
        lib.tpuseg_maxpool_pyramid_route.argtypes = [vp, vp, i32, i64, i32,
                                                     i32, i32, i32]
        lib.tpuseg_maxpool_pyramid_route.restype = ctypes.c_char_p
        lib.tpuseg_maxpool_backward_route.argtypes = [vp, vp, vp, i32, i64,
                                                      i32, i32, i32, i32]
        lib.tpuseg_maxpool_backward_route.restype = ctypes.c_char_p
        lib.tpuseg_maxpool1d_pyramid.argtypes = [vp, vp, i32, i64, i32, i32,
                                                 i32, pcp, vp]
        lib.tpuseg_maxpool1d_pyramid.restype = i32
        lib.tpuseg_maxpool1d_pyramid_route.argtypes = [vp, vp, i32, i64, i32,
                                                       i32, i32]
        lib.tpuseg_maxpool1d_pyramid_route.restype = ctypes.c_char_p
        lib.tpuseg_maxpool1d_backward.argtypes = [vp, vp, vp, i32, i64, i32,
                                                  i32, i32, pcp, vp]
        lib.tpuseg_maxpool1d_backward.restype = i32
        lib.tpuseg_maxpool1d_backward_route.argtypes = [vp, vp, vp, i32, i64,
                                                        i32, i32, i32]
        lib.tpuseg_maxpool1d_backward_route.restype = ctypes.c_char_p
        lib.tpuseg_cuda_error_string.argtypes = [i32]
        lib.tpuseg_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def route_name(name: "bytes | None", what: str) -> str:
    """The kernel a route query named; raise if it refused the call."""
    if name is None:
        raise ValueError(f"{what}: the kernel refuses these arguments")
    return name.decode()


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.tpuseg_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch(lib: ctypes.CDLL, entry: str, args: tuple, stream: int,
           what: str, counter) -> None:
    """Call ``lib``'s C entry point ``entry`` with ``args``, a pointer for
    the name of the kernel it launched, and ``stream``; raise on a CUDA
    error; add one to ``counter`` under that name if it launched a
    kernel."""
    launched = ctypes.c_char_p()
    check(lib, getattr(lib, entry)(*args, ctypes.byref(launched), stream),
          what)
    name = launched.value.decode()
    if name != "none":
        counter.add(name)
