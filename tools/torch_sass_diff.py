#!/usr/bin/env python3
"""Compare the SASS of the port's CUDA kernels with another checkout's.

Builds ``mxnet_tpu_torch/csrc/<source>.cu`` of this checkout and of
*OTHER* (a second copy of the repository, e.g. a ``git archive`` of the
parent commit under ``build/``) with the flags ``ops/_cuda.py`` uses, dumps
both libraries with ``cuobjdump -sass`` and compares every kernel's
instructions, function by function.  The anonymous-namespace prefix of a
kernel's name, which carries a hash of the source's path, is left out of
the match.  Use it to show that a change around a kernel (a helper moved
into a header, a host-side rule) left the kernel's instruction stream as
it was.  Needs nvcc and cuobjdump: run it on the machine with the card.

Usage: python3 tools/torch_sass_diff.py OTHER [SOURCE ...]  (default:
flash_fwd).  Prints a line for each kernel that differs or is missing on
one side, then one summary line a source; exits 1 if any kernel differs.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(root, name, out_dir):
    """The library of *root*'s ``csrc/<name>.cu``, built into *out_dir*."""
    sys.path.insert(0, ROOT)
    from mxnet_tpu_torch.ops import _cuda
    src_dir = os.path.join(root, "mxnet_tpu_torch", "csrc")
    lib = os.path.join(out_dir, "lib%s.so" % name)
    proc = subprocess.run(
        [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-I", src_dir, "-o", lib,
         os.path.join(src_dir, name + ".cu"), *_cuda.LINK.get(name, [])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s's %s.cu:\n%s"
                           % (root, name, proc.stdout))
    return lib


def kernels(lib):
    """{kernel name without its namespace hash: its SASS lines}."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_\w{8}", "", m.group(1))
            out[name] = []
        elif name is not None:
            out[name].append(line.strip())
    return out


def main(argv):
    if not argv:
        print("usage: python3 tools/torch_sass_diff.py OTHER [SOURCE ...]",
              file=sys.stderr)
        return 2
    other, sources = os.path.abspath(argv[0]), argv[1:] or ["flash_fwd"]
    out = os.path.join(ROOT, "build", "torch_kernels", "sass_diff")
    dirs = {side: os.path.join(out, side) for side in ("this", "other")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    jobs = [(side, root, name) for name in sources
            for side, root in (("this", ROOT), ("other", other))]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(
            lambda j: build(j[1], j[2], dirs[j[0]]), jobs)))
    differ = 0
    for name in sources:
        mine = kernels(libs[("this", ROOT, name)])
        theirs = kernels(libs[("other", other, name)])
        same = 0
        for kernel in sorted(set(mine) | set(theirs)):
            if kernel not in mine or kernel not in theirs:
                print("%s: %s only in %s" % (
                    name, kernel, "this checkout" if kernel in mine
                    else other))
                differ += 1
            elif mine[kernel] != theirs[kernel]:
                print("%s: %s differs (%d against %d SASS lines)" % (
                    name, kernel, len(mine[kernel]), len(theirs[kernel])))
                differ += 1
            else:
                same += 1
        print("%s.cu: %d kernels with the same SASS in both checkouts, %d "
              "differ or are missing" % (name, same,
                                          len(set(mine) | set(theirs)) - same))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
