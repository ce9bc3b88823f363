"""The dense autoregressive ``DecodeSession``
(``CompiledPredictor.make_decoder``) of ``mxnet_tpu_torch.serve`` on the
CPU, mirroring the JAX package's ``tests/test_serve.py::TestDecode``
case by case and holding each step against the JAX package's session on
the same model, cache and inputs.

Two reference tests change form: the port donates no buffer and has no
graftsan, so ``test_decode_donation_declared_in_program`` and
``test_decode_stale_cache_alias_poisoned`` become tests that the cache
is updated in place (the same storage every step, an alias of it sees
each step) and that the lowered-text accessor raises "not ported".
"""

import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import (BucketLadder, CompiledPredictor,
                                   ServeError)
from mxnet_tpu_torch.symbol.symbol import _infer_shapes

CPU = mx.cpu()


def _mlp(m):
    data = m.sym.var("data")
    net = m.sym.FullyConnected(data, num_hidden=32, name="h")
    net = m.sym.Activation(net, act_type="relu")
    net = m.sym.FullyConnected(net, num_hidden=4, name="o")
    return m.sym.softmax(net)


def _decode_pred():
    net = _mlp(mx)
    rs = np.random.RandomState(0)
    shapes = _infer_shapes(net, {"data": (1, 12)})[1]
    params = {n: mx.nd.array(rs.randn(*shapes[n]).astype(np.float32) * 0.1,
                             ctx=CPU)
              for n in net.list_arguments() if n != "data"}
    return CompiledPredictor(net, params, data_shapes={"data": (1, 12)},
                             ladder=BucketLadder(batches=(1,)), ctx=CPU)


def _append_step(p, cache, inputs, t):
    """Toy KV-cache decode: write this step's token column, emit the
    running row sums."""
    new = cache["kv"].index_copy(1, t.long().reshape(1),
                                 inputs["tok"][:, None])
    return new.sum(dim=1), {"kv": new}


def _jax_decoder(steps, rows):
    """The JAX package's session on the same model and toy step."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as jmx

    def step(p, cache, inputs, t):
        new = jax.lax.dynamic_update_slice(
            cache["kv"], inputs["tok"][:, None], (0, t))
        return jnp.sum(new, axis=1), {"kv": new}
    net = _mlp(jmx)
    rs = np.random.RandomState(0)
    arg_shapes, _, _ = net.infer_shape(data=(1, 12))
    params = {n: jmx.nd.array(rs.randn(*s).astype(np.float32) * 0.1)
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n != "data"}
    pred = jmx.serve.CompiledPredictor(
        net, params, data_shapes={"data": (1, 12)},
        ladder=jmx.serve.BucketLadder(batches=(1,)))
    return pred.make_decoder(step, {"kv": jnp.zeros((rows, steps),
                                                    jnp.float32)},
                             {"tok": (rows,)}, donate=False)


class TestDecode:
    def test_decode_matches_eager_loop_cache_never_copied(self):
        pred = _decode_pred()
        steps = 6
        sess = pred.make_decoder(
            _append_step, {"kv": np.zeros((2, steps), np.float32)},
            {"tok": (2,)}, donate=True)
        jsess = _jax_decoder(steps, 2)
        compiles = pred.compile_count
        ptr = sess.cache["kv"].data_ptr()
        ref = np.zeros((2, steps), np.float32)
        for t in range(steps):
            tok = np.full((2,), float(t + 1), np.float32)
            out = np.asarray(sess.step({"tok": tok}))
            ref[:, t] = tok
            assert np.array_equal(out, ref.sum(axis=1))
            # the same step in the JAX package, exactly
            assert np.array_equal(out, np.asarray(jsess.step({"tok": tok})))
        assert sess.step_count == steps
        assert pred.compile_count == compiles   # one program, N steps
        assert np.array_equal(sess.cache["kv"].numpy(), ref)
        assert sess.cache["kv"].data_ptr() == ptr   # never copied
        assert np.array_equal(sess.cache["kv"].numpy(),
                              np.asarray(jsess.cache["kv"]))

    def test_decode_cache_updated_in_place(self):
        """(Reference: test_decode_donation_declared_in_program.)  With
        or without *donate*, every step writes the session's own cache
        tensor; the lowered text is not ported."""
        pred = _decode_pred()
        for donate in (True, False):
            sess = pred.make_decoder(
                _append_step, {"kv": np.zeros((1, 4), np.float32)},
                {"tok": (1,)}, donate=donate)
            cache = sess.cache["kv"]
            sess.step({"tok": np.ones((1,), np.float32)})
            sess.step({"tok": np.full((1,), 2.0, np.float32)})
            assert sess.cache["kv"] is cache
            assert cache.tolist() == [[1.0, 2.0, 0.0, 0.0]]
            with pytest.raises(ServeError, match="not ported"):
                sess.lowered_text()

    def test_decode_cache_alias_sees_each_step(self):
        """(Reference: test_decode_stale_cache_alias_poisoned.)  An
        NDArray aliasing the cache is never stale: no buffer is donated,
        so the alias reads every step's write."""
        pred = _decode_pred()
        with warnings.catch_warnings():
            warnings.simplefilter("error")     # nothing to warn about
            sess = pred.make_decoder(
                _append_step, {"kv": np.zeros((1, 4), np.float32)},
                {"tok": (1,)}, donate=True)
            alias = mx.nd.NDArray(sess.cache["kv"])
            sess.step({"tok": np.ones((1,), np.float32)})
            assert alias.asnumpy().tolist() == [[1.0, 0.0, 0.0, 0.0]]
            sess.step({"tok": np.full((1,), 5.0, np.float32)})
            assert alias.asnumpy().tolist() == [[1.0, 5.0, 0.0, 0.0]]

    def test_decode_shape_validation(self):
        pred = _decode_pred()
        sess = pred.make_decoder(
            _append_step, {"kv": np.zeros((1, 4), np.float32)},
            {"tok": (1,)}, donate=False)
        with pytest.raises(ServeError, match="fixed-shape"):
            sess.step({"tok": np.ones((2,), np.float32)})
        with pytest.raises(ServeError, match="missing input"):
            sess.step({})


def test_decoder_default_context_is_the_gpu():
    """Without ``ctx=mx.cpu()`` the predictor and its decoders are on
    ``gpu(0)``, which raises without CUDA instead of running here."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    net = _mlp(mx)
    with pytest.raises(MXNetError, match="CUDA"):
        CompiledPredictor(net, {}, data_shapes={"data": (1, 12)})
