"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``mxnet_tpu_torch/csrc/<name>.cu`` exports a plain C
function.  ``nvcc`` compiles it for Hopper (``sm_90a``) into a shared
library under ``build/torch_kernels/`` at the root of the checkout, at
first use; ``ctypes`` loads it.  Sources include no PyTorch header, so a
build takes seconds.  The library's file name carries a hash of its
source, so an edited source is never served by a stale build; nvcc's
output (ptxas's registers and spills) is kept beside it as ``.log``.

Nothing here runs at import time: the CPU tests import every module on
a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..base import MXNetError

__all__ = ["build", "load", "BUILD_DIR", "SOURCE_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs = {}


def _nvcc():
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found (set NVCC or put the CUDA toolkit's "
                     "bin/ on PATH); the port's kernels build with it")


def _paths(name):
    src = os.path.join(SOURCE_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, digest))


def _command(name):
    src, lib = _paths(name)
    return lib, [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
                 "-o", lib + ".tmp", src]


def build(name):
    """Compile kernel *name* unless its library and log exist.  Returns
    ``{"path", "seconds", "log"}``: the library, the nvcc seconds (0 when
    it was already built) and nvcc's output, read back from the log kept
    beside a library that was already built."""
    lib, cmd = _command(name)
    if os.path.exists(lib) and os.path.exists(lib + ".log"):
        with open(lib + ".log") as f:
            return {"path": lib, "seconds": 0.0, "log": f.read()}
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise MXNetError("nvcc failed on %s.cu (exit %d):\n%s"
                         % (name, proc.returncode, proc.stdout))
    with open(lib + ".log.tmp", "w") as f:
        f.write(proc.stdout)
    os.replace(lib + ".log.tmp", lib + ".log")
    os.replace(lib + ".tmp", lib)
    return {"path": lib, "seconds": time.perf_counter() - t0,
            "log": proc.stdout}


def load(name, bind=None):
    """The ``ctypes`` library of kernel *name*, built on first use.
    *bind(lib)* sets the argument and return types once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)["path"])
            if bind is not None:
                bind(lib)
            _libs[name] = lib
    return lib
