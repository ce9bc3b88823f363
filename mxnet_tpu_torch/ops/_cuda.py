"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``mxnet_tpu_torch/csrc/<name>.cu`` exports a plain C
function (``nvjpeg_decode.cu`` binds the toolkit's nvJPEG and links it).  ``nvcc`` compiles it for Hopper (``sm_90a``) into a shared
library under ``build/torch_kernels/`` at the root of the checkout (or
the directory ``MXNET_COMPILE_CACHE_DIR`` names), at first use; ``ctypes``
loads it.  Sources include no PyTorch header, so a build takes seconds.
The library's file name carries a hash of its source and of every header
of ``csrc/`` it includes (``#include "name.cuh"``, followed through the
headers' own includes), so an edited source or header is never served by
a stale build; nvcc's output (ptxas's registers and spills) is kept
beside it as ``.log``.

Several processes may share one build directory (a serving fleet's
replicas do): a build holds an ``flock`` on ``<library>.lock`` while it
checks and compiles, nvcc writes a temporary name unique to its process
and thread, and the log is published before the library, so a process
that finds the library finds a whole one and its log.

Nothing here runs at import time: the CPU tests import every module on
a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from ..base import MXNetError

__all__ = ["build", "load", "build_dir", "nvcc_seconds", "BUILD_DIR",
           "SOURCE_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: libraries a source links beyond the CUDA runtime
LINK = {"nvjpeg_decode": ["-lnvjpeg"]}

_lock = threading.Lock()     # guards _libs; held by load() over build()
_libs = {}
_seconds_lock = threading.Lock()
_nvcc_seconds = [0.0]       # nvcc wall seconds spent by this process


def _nvcc():
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found (set NVCC or put the CUDA toolkit's "
                     "bin/ on PATH); the port's kernels build with it")


def build_dir(default=None):
    """Where libraries are looked up and built: ``MXNET_COMPILE_CACHE_DIR``
    when set, else *default* (:data:`BUILD_DIR` when None).  The native
    IO libraries (``runtime/native.py``) share this directory."""
    from ..config import get_env
    return get_env("MXNET_COMPILE_CACHE_DIR") or default or BUILD_DIR


def nvcc_seconds():
    """The nvcc wall seconds this process has spent building (0 in a
    process that found every library built)."""
    with _seconds_lock:
        return _nvcc_seconds[0]


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(src):
    """*src* and the files of its directory it includes with quotes,
    each once, in the order they are first reached."""
    seen, order, todo = set(), [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        order.append((path, text))
        for inc in _INCLUDE.findall(text):
            dep = os.path.join(os.path.dirname(path), inc.decode())
            if os.path.exists(dep):
                todo.append(dep)
    return order


def _paths(name):
    src = os.path.join(SOURCE_DIR, name + ".cu")
    h = hashlib.sha256()
    for path, text in _sources(src):
        h.update(os.path.basename(path).encode() + b"\0")
        h.update(hashlib.sha256(text).digest())
    digest = h.hexdigest()[:12]
    return src, os.path.join(build_dir(), "lib%s-%s.so" % (name, digest))


def _command(name, out=None):
    """(library path, the nvcc command that builds it into *out*, by
    default the library path itself)."""
    src, lib = _paths(name)
    return lib, [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
                 "-o", out or lib, src, *LINK.get(name, [])]


def _built(lib):
    if os.path.exists(lib) and os.path.exists(lib + ".log"):
        with open(lib + ".log") as f:
            return {"path": lib, "seconds": 0.0, "log": f.read()}
    return None


def build(name):
    """Compile kernel *name* unless its library and log exist.  Returns
    ``{"path", "seconds", "log"}``: the library, the nvcc seconds (0 when
    it was already built, here or by another process) and nvcc's output,
    read back from the log kept beside a library that was already
    built."""
    _, lib = _paths(name)
    info = _built(lib)
    if info is not None:
        return info
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    with open(lib + ".lock", "a") as lock:
        # held while checking and compiling: a second process (or
        # thread) waits here, then finds the first one's library
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            info = _built(lib)
            if info is not None:
                return info
            tmp = "%s.%d.%d.tmp" % (lib, os.getpid(), threading.get_ident())
            t0 = time.perf_counter()
            proc = subprocess.run(_command(name, tmp)[1],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            seconds = time.perf_counter() - t0
            with _seconds_lock:
                _nvcc_seconds[0] += seconds
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise MXNetError("nvcc failed on %s.cu (exit %d):\n%s"
                                 % (name, proc.returncode, proc.stdout))
            with open(tmp + ".log", "w") as f:
                f.write(proc.stdout)
            os.replace(tmp + ".log", lib + ".log")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return {"path": lib, "seconds": seconds, "log": proc.stdout}


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
