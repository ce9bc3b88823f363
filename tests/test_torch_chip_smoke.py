"""``chip_smoke.py``'s build gate on the CPU: it reads registers and
spills from nvcc's ``-Xptxas -v`` log and fails the run when the
training path's dkdv instantiation (f32, D = 64) spills or is missing,
on a fresh build and on one that an earlier run left behind."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

DKDV64 = ("_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelIfLi64ELi64ELi64EEEvPKT_"
          "S4_S4_S4_PKfS6_PS2_S7_iiifii")
DKDV64_BF16 = DKDV64.replace("kernelIf", "kernelI13__nv_bfloat16")
DQ64 = "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelIfLi2EEEvPKT_S4_S4_S4_PKfS6_PS2_iiifi"


def _log(entries):
    """An nvcc -Xptxas -v log of *entries* (name, registers, stores,
    loads), in ptxas's own line format."""
    lines = ["ptxas info    : 0 bytes gmem"]
    for name, regs, st, ld in entries:
        lines += [
            "ptxas info    : Compiling entry function '%s' for 'sm_90a'"
            % name,
            "ptxas info    : Function properties for %s" % name,
            "    0 bytes stack frame, %d bytes spill stores, %d bytes spill "
            "loads" % (st, ld),
            "ptxas info    : Used %d registers, used 1 barriers, 448 bytes "
            "cmem[0]" % regs]
    return "\n".join(lines) + "\n"


def test_ptxas_usage_reads_every_entry():
    got = chip_smoke.ptxas_usage(_log([(DKDV64, 168, 0, 0),
                                       (DQ64, 214, 68, 72)]))
    assert got == {
        DKDV64: {"registers": 168, "spill_stores": 0, "spill_loads": 0},
        DQ64: {"registers": 214, "spill_stores": 68, "spill_loads": 72}}


def test_path_dkdv_usage_passes_a_clean_build():
    text = _log([(DKDV64_BF16, 255, 96, 96), (DKDV64, 168, 0, 0),
                 (DQ64, 214, 68, 72)])
    assert chip_smoke.path_dkdv_usage(text) == {
        "registers": 168, "spill_stores": 0, "spill_loads": 0}


@pytest.mark.parametrize("entries", [
    [(DKDV64, 255, 68, 0)],             # spill stores
    [(DKDV64, 255, 0, 4)],              # spill loads
    [(DKDV64_BF16, 128, 0, 0)],         # the f32 instantiation is missing
    [(DKDV64, 128, 0, 0), (DKDV64 + "x", 128, 0, 0)],   # ambiguous
])
def test_path_dkdv_usage_fails_the_run(entries):
    with pytest.raises(RuntimeError):
        chip_smoke.path_dkdv_usage(_log(entries))


def test_path_dkdv_usage_fails_without_the_spill_line():
    text = "\n".join(line for line in _log([(DKDV64, 128, 0, 0)])
                     .splitlines() if "spill" not in line)
    with pytest.raises(RuntimeError):
        chip_smoke.path_dkdv_usage(text)


def _fake_nvcc(tmp_path, text):
    """An executable that stands in for nvcc: it prints *text* and writes
    the file named after ``-o``."""
    path = tmp_path / "nvcc"
    path.write_text(
        "#!%s\nimport sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n"
        "sys.stdout.write(%r)\n" % (sys.executable, text))
    path.chmod(0o755)
    return str(path)


@pytest.mark.parametrize("spill", [0, 68])
def test_build_gate_reads_a_library_built_before(tmp_path, monkeypatch,
                                                 spill):
    """A second run in the same checkout finds both libraries built: the
    gate reads ptxas's lines from the nvcc log kept beside each, so it
    passes a clean build and still fails a spilling one."""
    from mxnet_tpu_torch.ops import _cuda
    nvcc = _fake_nvcc(tmp_path, _log([(DKDV64, 168, spill, spill),
                                      (DQ64, 214, 0, 0)]))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_cuda, "_nvcc", lambda: nvcc)
    results = []
    for run in range(2):
        if run:
            os.remove(nvcc)     # the second run must not compile again
        if spill:
            with pytest.raises(RuntimeError, match="spills"):
                chip_smoke.phase_build()
        else:
            results.append(chip_smoke.phase_build())
        info = _cuda.build("flash_bwd")
        assert info["seconds"] == 0.0 and DKDV64 in info["log"]
    if not spill:
        assert results[0] == results[1] == {
            "registers": 168, "spill_stores": 0, "spill_loads": 0}
