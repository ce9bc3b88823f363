"""Kernel builds shared by several processes (``ops/_cuda.py``).

A serving fleet starts replica processes on one build directory while
others run.  Two processes that need the same kernel at once must build
it once: the second waits on the library's lock, then loads the first
one's library; no process ever loads a library another is still
writing.  ``NVCC`` points at a stand-in compiler that sleeps, counts its
runs and writes a real shared object to its ``-o`` path.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import ctypes, json, sys, time
from mxnet_tpu_torch.ops import _cuda
start = float(sys.argv[1])
while time.time() < start:
    time.sleep(0.005)
info = _cuda.build("flash_fwd")
lib = _cuda.load("flash_fwd")
print(json.dumps({"path": info["path"], "seconds": info["seconds"],
                  "log": info["log"], "loaded": lib._name,
                  "nvcc": _cuda.nvcc_seconds()}))
"""

# a kernel's first use: load() builds the missing library itself
LOAD_WORKER = r"""
import json, sys, time
from mxnet_tpu_torch.ops import _cuda
start = float(sys.argv[1])
while time.time() < start:
    time.sleep(0.005)
lib = _cuda.load("flash_fwd")
print(json.dumps({"loaded": lib._name, "nvcc": _cuda.nvcc_seconds()}))
"""


def _fake_nvcc(tmp_path):
    import _ctypes
    runs = tmp_path / "runs"
    path = tmp_path / "nvcc"
    path.write_text(
        "#!%s\nimport shutil, sys, time\n"
        "open(%r, 'a').write('run\\n')\n"
        "time.sleep(1.0)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "with open(out, 'wb') as f:\n"
        "    f.write(open(%r, 'rb').read()[:100])\n"
        "    f.flush()\n"
        "    time.sleep(0.5)\n"      # a half-written library, for a while
        "shutil.copyfile(%r, out)\n"
        "print('ptxas info    : Used 1 registers')\n"
        % (sys.executable, str(runs), _ctypes.__file__, _ctypes.__file__))
    path.chmod(0o755)
    return str(path), runs


def test_two_processes_build_a_kernel_once_and_load_the_same_file(
        tmp_path):
    import time
    nvcc, runs = _fake_nvcc(tmp_path)
    build_dir = tmp_path / "kernels"
    env = dict(os.environ, NVCC=nvcc, PYTHONPATH=ROOT,
               MXNET_COMPILE_CACHE_DIR=str(build_dir),
               CUDA_VISIBLE_DEVICES="")
    # both start building at one instant, after their imports
    start = time.time() + 8.0
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, repr(start)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert runs.read_text() == "run\n"             # one build
    assert outs[0]["path"] == outs[1]["path"]
    assert outs[0]["loaded"] == outs[1]["loaded"] == outs[0]["path"]
    # one process compiled, the other waited and found the library
    assert sorted(o["seconds"] > 0 for o in outs) == [False, True]
    assert sorted(o["nvcc"] > 0 for o in outs) == [False, True]
    assert all("Used 1 registers" in o["log"] for o in outs)
    # the directory holds the library, its log and its lock, no temporary
    lib = os.path.basename(outs[0]["path"])
    assert sorted(os.listdir(build_dir)) == sorted(
        [lib, lib + ".log", lib + ".lock"])


def _run_at_once(worker, n, env):
    """Start *n* processes of *worker* that begin together after their
    imports; their last stdout lines, parsed.  A process that has not
    finished within the timeout (a deadlock) fails the test."""
    import time
    start = time.time() + 6.0
    procs = [subprocess.Popen([sys.executable, "-c", worker, repr(start)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for _ in range(n)]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_load_builds_a_missing_kernel_without_build_first(tmp_path):
    """The first use of a kernel whose library is missing goes through
    ``load`` alone (a fresh checkout, an edited source, a replica on a
    build directory without it).  It returns, alone and from two
    processes at once, and the kernel is built once."""
    nvcc, runs = _fake_nvcc(tmp_path)
    env = dict(os.environ, NVCC=nvcc, PYTHONPATH=ROOT,
               CUDA_VISIBLE_DEVICES="")
    env["MXNET_COMPILE_CACHE_DIR"] = str(tmp_path / "alone")
    (one,) = _run_at_once(LOAD_WORKER, 1, env)
    assert one["nvcc"] > 0 and runs.read_text() == "run\n"
    assert os.path.dirname(one["loaded"]) == str(tmp_path / "alone")
    runs.unlink()
    env["MXNET_COMPILE_CACHE_DIR"] = str(tmp_path / "pair")
    outs = _run_at_once(LOAD_WORKER, 2, env)
    assert runs.read_text() == "run\n"           # one build
    assert outs[0]["loaded"] == outs[1]["loaded"]
    assert os.path.dirname(outs[0]["loaded"]) == str(tmp_path / "pair")
    assert sorted(o["nvcc"] > 0 for o in outs) == [False, True]


def test_chip_smoke_reports_the_nvjpeg_build_command(tmp_path, monkeypatch):
    """Phase 12's build report on the card reads the nvcc command of a
    library built in the shared directory (a stand-in nvcc here)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    nvcc, runs = _fake_nvcc(tmp_path)
    monkeypatch.setenv("NVCC", nvcc)
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "k"))
    out = dict((name, (secs, cmd)) for name, secs, cmd
               in chip_smoke.data_builds(on_card=True))
    secs, cmd = out["nvjpeg_decode"]
    assert secs > 0 and runs.read_text() == "run\n"
    assert "nvjpeg_decode.cu" in cmd and "-lnvjpeg" in cmd
    assert str(tmp_path / "k") in cmd
