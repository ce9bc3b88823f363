"""The PyTorch port stands alone: it imports neither ``jax`` nor
``mxnet_tpu``, and it never runs on the CPU unless asked to."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo.transformer import get_transformer_lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mxnet_tpu_torch")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(mod):
    return mod == "jax" or mod.startswith("jax.") or mod == "mxnet_tpu" or \
        mod.startswith("mxnet_tpu.")


def _env_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_import_leaves_jax_and_mxnet_tpu_unloaded():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serve, "
            "mxnet_tpu_torch.gluon.model_zoo.transformer, "
            "mxnet_tpu_torch.autograd, mxnet_tpu_torch.optimizer, "
            "mxnet_tpu_torch.gluon.trainer, mxnet_tpu_torch.gluon.loss; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=_env_without_cuda())
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_mxnet_tpu(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(m) for m in mods), (path, node.lineno)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_context_is_the_gpu_and_tpu_aliases_it():
    assert mx.current_context() == mx.gpu(0)
    assert mx.tpu is mx.gpu
    assert mx.Context("tpu", 1) == mx.gpu(1)
    assert mx.cpu().torch_device == torch.device("cpu")
    with mx.cpu():
        assert mx.current_context() == mx.cpu()


def test_gpu_context_without_cuda_raises(no_cuda):
    with pytest.raises(mx.MXNetError, match="ctx=mx.cpu"):
        mx.gpu(0).torch_device


@pytest.mark.parametrize("entry", ["nd.array", "nd.zeros", "initialize",
                                   "load_checkpoint", "nd.load", "Trainer"])
def test_entry_points_without_ctx_raise_instead_of_using_the_cpu(
        no_cuda, tmp_path, entry):
    if entry == "nd.array":
        call = lambda: mx.nd.array(np.ones(3))
    elif entry == "nd.zeros":
        call = lambda: mx.nd.zeros((2, 2))
    elif entry == "initialize":
        net = get_transformer_lm(vocab=10, dim=8, heads=2, layers=1,
                                 max_seq=4)
        call = net.initialize
    elif entry == "Trainer":
        # a deferred parameter waits for its shape on gpu(0): the new
        # trainer resolves that device and raises
        p = mx.gluon.Parameter("w", shape=(0,), allow_deferred_init=True)
        p.initialize(ctx=mx.gpu(0))
        call = lambda: mx.gluon.Trainer([p], "sgd")
    else:
        mx.nd.save(str(tmp_path / "m-0000.params"),
                   {"arg:w": mx.nd.array(np.ones(2), ctx=mx.cpu())})
        mx.sym.var("w").save(str(tmp_path / "m-symbol.json"))
        if entry == "nd.load":
            call = lambda: mx.nd.load(str(tmp_path / "m-0000.params"))
        else:
            call = lambda: mx.serve.ModelRegistry().load_checkpoint(
                "m", str(tmp_path / "m"), 0, data_shapes={"w": (2,)})
    with pytest.raises(mx.MXNetError, match="CUDA"):
        call()


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Without CUDA it exits non-zero and prints no result line; alone in
    a directory (no package beside it) it cannot run either."""
    for where in (ROOT, str(tmp_path)):
        script = os.path.join(where, "chip_smoke.py")
        if where != ROOT:
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), script)
        out = subprocess.run([sys.executable, script], cwd=where,
                             capture_output=True, text=True, timeout=120,
                             env=_env_without_cuda())
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
