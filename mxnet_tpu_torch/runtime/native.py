"""Build and load the native IO libraries from the repository's C++
sources.

``src/io/recordio_reader.cc`` (the RecordIO reader) and
``src/io/jpeg_decode_pool.cc`` (the libjpeg decode and augment worker
team) export plain C functions.  ``g++ -O2 -fPIC -shared -std=c++17``
compiles each into ``build/torch_kernels/`` (or the directory
``MXNET_COMPILE_CACHE_DIR`` names) beside the port's CUDA kernels, at
first use; ``ctypes`` loads it.  As for the kernels, the
library's file name carries a hash of its source and the compiler's
output is kept beside it as ``.log``.  A failed build raises with that
output: no caller falls back to another decoder.

Nothing here runs at import time.
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

__all__ = ["LIBS", "build", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
SOURCE_DIR = os.path.join(_ROOT, "src", "io")
BUILD_DIR = os.path.join(_ROOT, "build", "torch_kernels")
FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

#: library name -> (source under src/io, link flags)
LIBS = {
    "recordio_reader": ("recordio_reader.cc", []),
    "jpeg_decode_pool": ("jpeg_decode_pool.cc", ["-ljpeg", "-lpthread"]),
}

_lock = threading.Lock()
_libs = {}


def _cxx():
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 shutil.which("c++")):
        if cand and shutil.which(cand):
            return cand
    raise MXNetError("no C++ compiler found (set CXX or install g++); the "
                     "native IO libraries build from src/io with it")


def _paths(name):
    source, _ = LIBS[name]
    src = os.path.join(SOURCE_DIR, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    from ..ops._cuda import build_dir
    return src, os.path.join(build_dir(BUILD_DIR),
                             "lib%s-%s.so" % (name, digest))


def command(name):
    """(library path, the compiler command that builds it)."""
    src, lib = _paths(name)
    tmp = "%s.%d.tmp" % (lib, os.getpid())
    return lib, [_cxx(), *FLAGS, "-o", tmp, src, *LIBS[name][1]]


def build(name):
    """Compile library *name* unless it and its log exist.  Returns
    ``{"path", "seconds", "log", "command"}`` (seconds 0 when it was
    built before).  Raises :class:`MXNetError` with the compiler's
    output when the build fails."""
    lib, cmd = command(name)
    if os.path.exists(lib) and os.path.exists(lib + ".log"):
        with open(lib + ".log") as f:
            return {"path": lib, "seconds": 0.0, "log": f.read(),
                    "command": " ".join(cmd)}
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = cmd[cmd.index("-o") + 1]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        with open(lib + ".failed.log", "w") as f:
            f.write(proc.stdout)
        raise MXNetError("building %s from src/io/%s failed (exit %d): %s\n%s"
                         % (os.path.basename(lib), LIBS[name][0],
                            proc.returncode, " ".join(cmd), proc.stdout))
    # the log lands first: a library without its log is built again
    log_tmp = "%s.log.%d.tmp" % (lib, os.getpid())
    with open(log_tmp, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout)
    os.replace(tmp, lib)
    os.replace(log_tmp, lib + ".log")
    return {"path": lib, "seconds": time.perf_counter() - t0,
            "log": proc.stdout, "command": " ".join(cmd)}


def load(name, bind):
    """The ``ctypes`` library *name*, built on first use; *bind(lib)*
    sets its argument and return types once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)["path"])
            bind(lib)
            _libs[name] = lib
    return lib
