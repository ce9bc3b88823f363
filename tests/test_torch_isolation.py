"""The PyTorch port stands alone: it imports neither ``jax`` nor
``mxnet_tpu``, and it never runs on the CPU unless asked to."""

import ast
import json
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
            "mxnet_tpu_torch.gluon.model_zoo.vision, "
            "mxnet_tpu_torch.gluon.nn.conv_layers, "
            "mxnet_tpu_torch.autograd, mxnet_tpu_torch.optimizer, "
            "mxnet_tpu_torch.gluon.trainer, mxnet_tpu_torch.gluon.loss, "
            "mxnet_tpu_torch.parallel, mxnet_tpu_torch.lr_scheduler, "
            "mxnet_tpu_torch.serve.batcher, mxnet_tpu_torch.serve.health, "
            "mxnet_tpu_torch.serve.kvpool, mxnet_tpu_torch.serve.decode, "
            "mxnet_tpu_torch.serve.graphs, "
            "mxnet_tpu_torch.test_utils, "
            "mxnet_tpu_torch.ndarray.random, mxnet_tpu_torch.ndarray.contrib, "
            "mxnet_tpu_torch.ndarray.utils, mxnet_tpu_torch.random, "
            "mxnet_tpu_torch.runtime.rng, mxnet_tpu_torch.ops.random_ops, "
            "mxnet_tpu_torch.gluon.nn.basic_layers, "
            "mxnet_tpu_torch.gluon.utils, mxnet_tpu_torch.initializer, "
            "mxnet_tpu_torch.config, mxnet_tpu_torch.sanitizer, "
            "mxnet_tpu_torch.observability, mxnet_tpu_torch.resilience, "
            "mxnet_tpu_torch.module, mxnet_tpu_torch.io, "
            "mxnet_tpu_torch.metric, mxnet_tpu_torch.callback, "
            "mxnet_tpu_torch.executor, mxnet_tpu_torch.optimizer.tree_opt, "
            "mxnet_tpu_torch.name, mxnet_tpu_torch.attribute, "
            "mxnet_tpu_torch.rnn, mxnet_tpu_torch.rnn.io, "
            "mxnet_tpu_torch.gluon.rnn, mxnet_tpu_torch.gluon.contrib.rnn, "
            "mxnet_tpu_torch.gluon.model_zoo.lm, mxnet_tpu_torch.ops.rnn, "
            "mxnet_tpu_torch.ops.control_flow, "
            "mxnet_tpu_torch.symbol.contrib, "
            "mxnet_tpu_torch.module.bucketing_module, "
            "mxnet_tpu_torch.module.sequential_module, "
            "mxnet_tpu_torch.module.python_module, "
            "mxnet_tpu_torch.recordio, mxnet_tpu_torch.recordio_native, "
            "mxnet_tpu_torch.runtime.native, mxnet_tpu_torch.image, "
            "mxnet_tpu_torch.io.native_decode, "
            "mxnet_tpu_torch.io.image_record, "
            "mxnet_tpu_torch.io.device_prefetch, mxnet_tpu_torch.ops.image, "
            "mxnet_tpu_torch.ndarray.image, mxnet_tpu_torch.symbol.image, "
            "mxnet_tpu_torch.gluon.data, "
            "mxnet_tpu_torch.gluon.data.dataloader, "
            "mxnet_tpu_torch.gluon.data.vision.transforms, "
            "mxnet_tpu_torch.ops.quantization, mxnet_tpu_torch.quantize, "
            "mxnet_tpu_torch.quantize.calibrate, "
            "mxnet_tpu_torch.quantize.lower, mxnet_tpu_torch.quantize.policy, "
            "mxnet_tpu_torch.contrib, mxnet_tpu_torch.contrib.quantization, "
            "mxnet_tpu_torch.autotune, mxnet_tpu_torch.autotune.space, "
            "mxnet_tpu_torch.autotune.trace, mxnet_tpu_torch.autotune.store, "
            "mxnet_tpu_torch.autotune.measure, "
            "mxnet_tpu_torch.autotune.search, "
            "mxnet_tpu_torch.autotune.__main__, "
            "mxnet_tpu_torch.resilience.checkpoint, "
            "mxnet_tpu_torch._kvstore_impl, mxnet_tpu_torch.serve.replica, "
            "mxnet_tpu_torch.serve.router, mxnet_tpu_torch.serve.fleet; "
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
                                   "load_checkpoint", "nd.load", "Trainer",
                                   "resnet initialize", "make_mesh",
                                   "make_mesh gpu", "ParallelTrainer",
                                   "KVPool", "DecodeEngine",
                                   "tiny_attention_lm", "nd.ones",
                                   "nd.full", "nd.arange", "nd.empty",
                                   "nd._arange", "nd.random.uniform",
                                   "nd.random.normal", "mx.random.randint",
                                   "load_parameters", "simple_bind", "bind",
                                   "Module", "Module.load",
                                   "BucketingModule", "LSTM initialize",
                                   "get_lstm_lm initialize",
                                   "SequentialModule", "DevicePrefetcher",
                                   "ImageRecordIter", "fit device_prefetch",
                                   "ImageRecordDataset",
                                   "load quantize int8",
                                   "load quantize int8-weight-only",
                                   "calibrate", "quantize_model",
                                   "contrib quantize_model", "tune",
                                   "DecodeMeasurer", "ReplicaServer LOAD",
                                   "replica main"])
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
    elif entry == "resnet initialize":
        net = mx.gluon.model_zoo.vision.get_model("resnet18_v1")
        call = net.initialize
    elif entry == "Trainer":
        # a deferred parameter waits for its shape on gpu(0): the new
        # trainer resolves that device and raises
        p = mx.gluon.Parameter("w", shape=(0,), allow_deferred_init=True)
        p.initialize(ctx=mx.gpu(0))
        call = lambda: mx.gluon.Trainer([p], "sgd")
    elif entry == "make_mesh":
        call = mx.parallel.make_mesh
    elif entry == "make_mesh gpu":
        call = lambda: mx.parallel.make_mesh({"dp": 1}, [mx.gpu(0)])
    elif entry == "ParallelTrainer":
        # no mesh: the default one is cuda:0; only an explicit CPU mesh
        # trains on the CPU
        net = mx.gluon.model_zoo.vision.get_model("resnet18_v1")
        call = lambda: mx.parallel.ParallelTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "lbsgd",
            {"learning_rate": 0.1}, multi_precision=True)
    elif entry == "KVPool":
        call = lambda: mx.serve.KVPool(
            {"k": torch.empty((4,), device="meta")}, 3, 2)
    elif entry == "DecodeEngine":
        from mxnet_tpu_torch.test_utils import tiny_attention_lm
        params, step, prefill, token_spec, input_spec = tiny_attention_lm(
            ctx=mx.cpu())
        call = lambda: mx.serve.DecodeEngine(
            step, prefill, token_spec, input_spec, params=params,
            max_len=8, block_size=4, num_blocks=5, session_rungs=(1,))
    elif entry in ("nd.ones", "nd.empty"):
        call = lambda: getattr(mx.nd, entry[3:])((2, 2))
    elif entry == "nd.full":
        call = lambda: mx.nd.full((2,), 1.0)
    elif entry == "nd.arange":
        call = lambda: mx.nd.arange(4)
    elif entry == "nd._arange":
        call = lambda: mx.nd._arange(start=0, stop=4)
    elif entry == "nd.random.uniform":
        call = lambda: mx.nd.random.uniform(shape=(2,))
    elif entry == "nd.random.normal":
        call = lambda: mx.nd.random.normal(shape=(2,))
    elif entry == "mx.random.randint":
        call = lambda: mx.random.randint(0, 3, shape=(2,))
    elif entry in ("simple_bind", "bind", "Module", "Module.load"):
        out = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2,
                                    name="fc")
        shapes = [("data", (2, 3))]
        if entry == "simple_bind":
            call = lambda: out.simple_bind(data=(2, 3))
        elif entry == "bind":
            x = mx.nd.zeros((2, 3), ctx=mx.cpu())
            call = lambda: out.bind(args={"data": x, "fc_weight": x[:2],
                                          "fc_bias": x[0, :2]})
        elif entry == "Module":
            call = lambda: mx.mod.Module(out, label_names=None).bind(shapes)
        else:
            mx.model.save_checkpoint(str(tmp_path / "m"), 1, out, {
                "fc_weight": mx.nd.zeros((2, 3), ctx=mx.cpu()),
                "fc_bias": mx.nd.zeros((2,), ctx=mx.cpu())}, {})
            call = lambda: mx.mod.Module.load(
                str(tmp_path / "m"), 1, label_names=None).bind(shapes)
    elif entry in ("BucketingModule", "SequentialModule"):
        out = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2,
                                    name="fc")
        if entry == "BucketingModule":
            mod = mx.mod.BucketingModule(lambda key: (out, ("data",), ()),
                                         default_bucket_key=3)
        else:
            mod = mx.mod.SequentialModule().add(
                mx.mod.Module(out, label_names=None))
        call = lambda: mod.bind([("data", (2, 3))])
    elif entry == "LSTM initialize":
        call = mx.gluon.rnn.LSTM(4, input_size=3).initialize
    elif entry == "get_lstm_lm initialize":
        call = mx.gluon.model_zoo.lm.get_lstm_lm(10, 4, 2).initialize
    elif entry == "load_parameters":
        net = mx.gluon.nn.Dense(2, in_units=3, prefix="d_")
        net.initialize(ctx=mx.cpu())
        net.save_parameters(str(tmp_path / "d.params"))
        fresh = mx.gluon.nn.Dense(2, in_units=3, prefix="d_")
        call = lambda: fresh.load_parameters(str(tmp_path / "d.params"))
    elif entry == "tiny_attention_lm":
        from mxnet_tpu_torch.test_utils import tiny_attention_lm
        call = tiny_attention_lm
    elif entry in ("DevicePrefetcher", "fit device_prefetch"):
        it = mx.io.NDArrayIter(np.zeros((4, 3), np.float32),
                               np.zeros((4,), np.float32), batch_size=2)
        if entry == "DevicePrefetcher":
            call = lambda: mx.io.DevicePrefetcher(it)
        else:
            out = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
                mx.sym.var("data"), num_hidden=2, name="fc"), name="softmax")
            call = lambda: mx.mod.Module(out).fit(it, num_epoch=1,
                                                  device_prefetch=2)
    elif entry in ("ImageRecordIter", "ImageRecordDataset"):
        rec = mx.recordio.MXIndexedRecordIO(
            str(tmp_path / "i.idx"), str(tmp_path / "i.rec"), "w")
        rec.write_idx(0, mx.recordio.pack_img(
            mx.recordio.IRHeader(0, 1.0, 0, 0),
            np.zeros((8, 8, 3), np.uint8), img_fmt=".png"))
        rec.close()
        if entry == "ImageRecordIter":
            call = lambda: mx.io.ImageRecordIter(
                path_imgrec=str(tmp_path / "i.rec"), data_shape=(3, 4, 4),
                batch_size=1)
        else:
            ds = mx.gluon.data.vision.ImageRecordDataset(
                str(tmp_path / "i.rec"))
            call = lambda: ds[0]
    elif entry.startswith(("load quantize", "calibrate", "quantize_model",
                           "contrib")):
        out = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2,
                                    name="fc")
        w = {"fc_weight": mx.nd.ones((2, 3), ctx=mx.cpu()),
             "fc_bias": mx.nd.zeros((2,), ctx=mx.cpu())}
        batches = [np.ones((2, 3), np.float32)]
        if entry.startswith("load quantize"):
            call = lambda: mx.serve.ModelRegistry().load(
                "q", out, w, data_shapes={"data": (1, 3)},
                quantize=entry.split()[-1], calib_batches=batches)
        elif entry == "calibrate":
            call = lambda: mx.quantize.calibrate(out, w, batches)
        elif entry == "quantize_model":
            call = lambda: mx.quantize.quantize_model(
                out, w, policy="int8-weight-only")
        else:
            call = lambda: mx.contrib.quantization.quantize_model(
                out, w, calib_mode="none")
    elif entry == "tune":
        from mxnet_tpu_torch.autotune import (serve_space, synth_serve_trace,
                                              tune)
        from mxnet_tpu_torch.autotune.measure import ServeMeasurer
        from mxnet_tpu_torch.autotune.search import serve_objective
        trace = synth_serve_trace(rate=50, seconds=0.1, dim=4)
        call = lambda: tune(serve_space(max_rows=4), ServeMeasurer(trace),
                            serve_objective(), model="m", workload="serve",
                            trials=1, neighbor_trials=0)
    elif entry in ("ReplicaServer LOAD", "replica main"):
        out = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2,
                                    name="fc")
        mx.model.save_checkpoint(str(tmp_path / "m"), 1, out, {
            "fc_weight": mx.nd.zeros((2, 3), ctx=mx.cpu()),
            "fc_bias": mx.nd.zeros((2,), ctx=mx.cpu())}, {})
        model = {"model": "m", "name": "m", "prefix": str(tmp_path / "m"),
                 "epoch": 1, "data_shapes": {"data": [1, 3]}}
        if entry == "ReplicaServer LOAD":
            from mxnet_tpu_torch.serve.replica import MSG_LOAD
            def call():
                rep = mx.serve.ReplicaServer()
                try:
                    rep._handle(MSG_LOAD, model, ())
                finally:
                    rep.close()
        else:
            from mxnet_tpu_torch.serve.replica import main
            (tmp_path / "spec.json").write_text(
                '{"models": [%s]}' % json.dumps(model))
            call = lambda: main(["--spec", str(tmp_path / "spec.json")])
    elif entry == "DecodeMeasurer":
        from mxnet_tpu_torch.autotune import synth_decode_trace
        from mxnet_tpu_torch.autotune.measure import DecodeMeasurer
        call = lambda: DecodeMeasurer(synth_decode_trace(seconds=0.5))
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
