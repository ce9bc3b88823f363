"""Continuous-batching decode in ``mxnet_tpu_torch.serve`` on the CPU,
mirroring the JAX package's ``tests/test_decode.py`` case by case —
paged KV pool, tick engine, decode batcher, registry lifecycle, the
dense ``DecodeSession``'s input elision, speculative decode and
quarantine-and-rebuild.

The anchor everywhere: a paged session's token stream must equal the
port's SOLO dense-cache decode (``test_utils.dense_decode_reference``,
the same step function over one dense worst-case cache), bit for bit.
Each stream that fits the JAX engine's length is also held equal to the
JAX package's ``DecodeEngine`` stream on the same weights (both
fixtures draw them from one ``np.random.RandomState(seed)`` sequence):
the tokens are argmaxes, compared exactly.  Every port object runs with
``device=mx.cpu()``, where a program is the eager body; the CUDA graph
per rung is held on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 8.

Two reference tests change form: the port has no buffer donation (the
pool is updated in place by the programs) and no graftsan, so
``test_donation_declared_in_programs`` and
``test_stale_pool_alias_poisoned`` become tests that the pool's tensors
are updated in place across ticks, prefills and verifies — the same
storage, no copy.
"""

import time
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import sym
from mxnet_tpu_torch.resilience import chaos
from mxnet_tpu_torch.serve import (BucketLadder, CompiledPredictor,
                                   DeadlineExceededError, DecodeBatcher,
                                   DecodeEngine, KVPool, KVPoolExhausted,
                                   ModelRegistry, RequestCancelled,
                                   ServeError, SpeculativeDecoder)
from mxnet_tpu_torch.symbol.symbol import _infer_shapes
from mxnet_tpu_torch.test_utils import (dense_decode_reference,
                                        tiny_attention_lm)

VOCAB, DIM = 32, 16
CPU = mx.cpu()
# the JAX engine that the cross-package checks run: streams do not
# depend on max_len (masked positions add exact zeros), so one length
# serves every stream of at most JAX_MAX_LEN positions
JAX_MAX_LEN = 24
_JAX_ENGINES = {}


def _lm(dtype="float32", seed=0):
    return tiny_attention_lm(vocab=VOCAB, dim=DIM, seed=seed, dtype=dtype,
                             ctx=CPU)


def _engine(dtype="float32", seed=0, **kwargs):
    params, step_fn, prefill_fn, token_spec, input_spec = _lm(dtype, seed)
    kwargs.setdefault("max_len", 24)
    kwargs.setdefault("block_size", 4)
    kwargs.setdefault("num_blocks", 40)
    kwargs.setdefault("session_rungs", (1, 2, 4))
    kwargs.setdefault("device", CPU)
    return DecodeEngine(step_fn, prefill_fn, token_spec, input_spec,
                        params=params, **kwargs), params, step_fn


def _jax_stream(prompt, n_new, dtype="float32", seed=0):
    """The JAX package's DecodeEngine stream for *prompt* on the same
    weights (solo, rung 1)."""
    from mxnet_tpu.serve import DecodeEngine as JEngine
    from mxnet_tpu.test_utils import tiny_attention_lm as jlm
    key = (dtype, seed)
    if key not in _JAX_ENGINES:
        params, step_fn, prefill_fn, token_spec, input_spec = jlm(
            vocab=VOCAB, dim=DIM, seed=seed, dtype=dtype)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _JAX_ENGINES[key] = JEngine(
                step_fn, prefill_fn, token_spec, input_spec, params=params,
                max_len=JAX_MAX_LEN, block_size=4, num_blocks=40,
                session_rungs=(1,), donate=False)
    eng = _JAX_ENGINES[key]
    sess = eng.admit({"tok": np.asarray(prompt, np.int32)},
                     max_new_tokens=n_new)
    eng.prefill(sess)
    while not sess.done():
        eng.tick([sess])
    return [int(o) for o in sess.result(10)]


def _dense_ref(params, step_fn, prompt, n_new, padded_len,
               dtype="float32", seed=0):
    """The port's solo dense-cache greedy decode; where the stream fits
    the JAX engine, also held equal to the JAX package's engine."""
    ref = dense_decode_reference(params, step_fn, prompt, n_new,
                                 padded_len, DIM, dtype=dtype)
    if len(prompt) + n_new <= JAX_MAX_LEN:
        assert ref == _jax_stream(prompt, n_new, dtype, seed), \
            "the port's dense decode disagrees with the JAX engine"
    return ref


def _tokens(sess):
    return [int(o) for o in sess.outputs()]


def _wait_blocks_free(eng, timeout=5):
    deadline = time.monotonic() + timeout
    while eng.pool.blocks_in_use and time.monotonic() < deadline:
        time.sleep(0.005)
    return eng.pool.blocks_in_use


# ---------------------------------------------------------------------------
# KVPool
# ---------------------------------------------------------------------------

class TestKVPool:
    def _spec(self):
        return {"k": torch.empty((DIM,), dtype=torch.float32,
                                 device="meta")}

    def test_alloc_free_and_gauges(self):
        from mxnet_tpu_torch.observability import metrics
        pool = KVPool(self._spec(), num_blocks=9, block_size=4, device=CPU)
        assert pool.blocks_total == 8          # null block reserved
        assert tuple(pool.arrays["k"].shape) == (9, 4, DIM)
        base = metrics.snapshot()["serve_kv_blocks_in_use"]["value"]
        got = pool.alloc(3)
        assert len(got) == 3 and 0 not in got
        assert pool.blocks_in_use == 3
        assert metrics.snapshot()["serve_kv_blocks_in_use"]["value"] \
            == base + 3
        pool.free(got)
        assert pool.blocks_in_use == 0
        pool.close()

    def test_exhaustion_typed_and_all_or_nothing(self):
        pool = KVPool(self._spec(), num_blocks=5, block_size=4, device=CPU)
        got = pool.alloc(3)
        with pytest.raises(KVPoolExhausted, match="exhausted"):
            pool.alloc(2)                      # only 1 free: no partial
        assert pool.blocks_free == 1
        pool.free(got)
        assert len(pool.alloc(4)) == 4         # recovered
        pool.close()

    def test_null_block_never_freed(self):
        pool = KVPool(self._spec(), num_blocks=4, block_size=4, device=CPU)
        with pytest.raises(ServeError, match="null block"):
            pool.free([0])
        pool.close()

    def test_set_arrays_and_clone_empty_write_in_place(self):
        """set_arrays copies into the pool's own tensors; clone_empty
        with reuse_arrays takes them over zeroed (the rebuild the
        engine's graphs survive), without it allocates its own."""
        pool = KVPool(self._spec(), num_blocks=3, block_size=2, device=CPU)
        k = pool.arrays["k"]
        pool.set_arrays({"k": torch.ones_like(k)})
        assert pool.arrays["k"] is k and bool((k == 1).all())
        fresh = pool.clone_empty()
        assert fresh.arrays["k"].data_ptr() != k.data_ptr()
        reused = pool.clone_empty(reuse_arrays=True)
        assert reused.arrays["k"] is k and not bool(k.any())
        assert (reused.num_blocks, reused.block_size) == (3, 2)
        for p in (pool, fresh, reused):
            p.close()

    def test_close_idempotent_and_gauge_drop(self):
        from mxnet_tpu_torch.observability import metrics
        base = metrics.snapshot()["serve_kv_blocks_total"]["value"]
        pool = KVPool(self._spec(), num_blocks=5, block_size=4, device=CPU)
        assert metrics.snapshot()["serve_kv_blocks_total"]["value"] \
            == base + 4
        pool.alloc(2)
        pool.close()
        pool.close()
        snap = metrics.snapshot()
        assert snap["serve_kv_blocks_total"]["value"] == base
        assert snap["serve_kv_blocks_in_use"]["value"] >= 0


# ---------------------------------------------------------------------------
# engine: programs + bit-equality
# ---------------------------------------------------------------------------

class TestDecodeEngine:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_solo_paged_matches_dense(self, dtype):
        eng, params, step_fn = _engine(dtype)
        prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
        sess = eng.admit({"tok": prompt}, max_new_tokens=8)
        eng.prefill(sess)
        while not sess.done():
            eng.tick([sess])
        got = [int(o) for o in sess.result(10)]
        ref = _dense_ref(params, step_fn, prompt, 8, eng.padded_len, dtype)
        assert got == ref
        assert eng.pool.blocks_in_use == 0
        eng.close()

    def test_multi_session_staggered_bit_equal_one_compile_per_rung(self):
        eng, params, step_fn = _engine()
        warm = eng.compile_count
        assert warm == len(eng.ladder.batches) + len(eng.prefill_rungs)
        rs = np.random.RandomState(0)
        prompts = [rs.randint(0, VOCAB, size=n).astype(np.int32)
                   for n in (1, 3, 7, 12)]
        n_new = [9, 4, 6, 2]
        sess = [eng.admit({"tok": p}, max_new_tokens=n)
                for p, n in zip(prompts, n_new)]
        for s in sess:
            eng.prefill(s)
        # sessions leave at different ticks -> rung shrinks 4->2->1,
        # padding rows ride along; none of it may touch the tokens
        while any(not s.done() for s in sess):
            eng.tick([s for s in sess if not s.done()])
        for s, p, n in zip(sess, prompts, n_new):
            assert [int(o) for o in s.result(10)] == \
                _dense_ref(params, step_fn, p, n, eng.padded_len)
        assert eng.compile_count == warm       # zero request-path builds
        assert eng.pool.blocks_in_use == 0
        eng.close()

    def test_co_tenant_garbage_invariance(self):
        """Poisoning the null block and a FREED co-tenant block with
        huge finite values must not change any stream — the step
        contract masks beyond-position garbage."""
        eng, params, step_fn = _engine()
        prompt = np.asarray([7, 2, 9], np.int32)
        ref = _dense_ref(params, step_fn, prompt, 6, eng.padded_len)

        other = eng.admit({"tok": np.asarray([5] * 10, np.int32)},
                          max_new_tokens=1)
        eng.prefill(other)
        eng.tick([other])                      # writes then frees
        assert other.done()

        sess = eng.admit({"tok": prompt}, max_new_tokens=6)
        eng.prefill(sess)
        while not sess.done():
            # poison block 0 (the null block) between ticks, in place:
            # every unused table entry points there
            with eng._lock:
                for p in eng.pool.arrays.values():
                    p[0].fill_(1e6)
            eng.tick([sess])
        assert [int(o) for o in sess.result(10)] == ref
        eng.close()

    def test_pool_updated_in_place_across_programs(self):
        """(Reference: test_donation_declared_in_programs.)  The port
        donates nothing: every tick, prefill and verify program writes
        the pool's own tensors in place — the same storage before and
        after, and the writes land in the session's blocks.  The
        lowered-text accessors are not ported and raise."""
        eng, _, _ = _engine(session_rungs=(1, 2), spec_k=2,
                            prefill_rungs=(4,))
        arrays = dict(eng.pool.arrays)
        ptrs = {k: a.data_ptr() for k, a in arrays.items()}
        sess = eng.admit({"tok": np.asarray([1, 2, 3], np.int32)},
                         max_new_tokens=6)
        blk = sess.blocks[0]
        before = arrays["k"][blk].clone()
        eng.prefill(sess)                      # writes positions 0, 1
        assert not torch.equal(arrays["k"][blk, :2], before[:2])
        eng.tick([sess])                       # writes position 2
        assert not torch.equal(arrays["k"][blk, 2], before[2])
        eng.verify(sess, {"tok": np.asarray([4, 5], np.int32)})
        for k, a in eng.pool.arrays.items():
            assert a is arrays[k] and a.data_ptr() == ptrs[k]
        for what in ("tick_lowered_text", "prefill_lowered_text"):
            with pytest.raises(ServeError, match="not ported"):
                getattr(eng, what)(1)
        with pytest.raises(ServeError, match="not ported"):
            eng.verify_lowered_text()
        eng.close()

    def test_pool_alias_sees_ticks_in_place(self):
        """(Reference: test_stale_pool_alias_poisoned.)  An NDArray
        aliasing the pool before a tick is not stale after it: there is
        no donation, the tick wrote the same storage, so the alias reads
        the new K at the session's position — no copy across ticks."""
        eng, _, _ = _engine(session_rungs=(1,))
        sess = eng.admit({"tok": np.asarray([1, 2], np.int32)},
                         max_new_tokens=4)
        eng.prefill(sess)
        alias = mx.nd.NDArray(eng.pool.arrays["k"])
        blk, at = sess.blocks[0], sess.pos
        zero = alias.asnumpy()[blk, at]
        eng.tick([sess])
        seen = alias.asnumpy()[blk, at]
        assert not np.array_equal(seen, zero)
        np.testing.assert_array_equal(
            seen, eng.pool.arrays["k"][blk, at].numpy())
        eng.close()

    def test_validation_errors(self):
        eng, _, _ = _engine(session_rungs=(1, 2))
        with pytest.raises(ServeError, match="empty prompt"):
            eng.admit({"tok": np.zeros((0,), np.int32)})
        with pytest.raises(ServeError, match="exceeds padded_len"):
            eng.admit({"tok": np.zeros((99,), np.int32)})
        with pytest.raises(ServeError, match="missing input"):
            eng.admit({"wrong": np.zeros((2,), np.int32)})
        s1 = eng.admit({"tok": np.asarray([1], np.int32)},
                       max_new_tokens=1)
        s2 = eng.admit({"tok": np.asarray([2], np.int32)},
                       max_new_tokens=1)
        s3 = eng.admit({"tok": np.asarray([3], np.int32)},
                       max_new_tokens=1)
        with pytest.raises(ServeError, match="top rung"):
            eng.tick([s1, s2, s3])             # ladder tops out at 2
        eng.close()

    def test_engine_needs_full_length_session_capacity(self):
        params, step_fn, prefill_fn, token_spec, input_spec = _lm()
        with pytest.raises(ServeError, match="full-length session"):
            DecodeEngine(step_fn, prefill_fn, token_spec, input_spec,
                         params=params, max_len=64, block_size=4,
                         num_blocks=5, session_rungs=(1,), device=CPU)

    def test_stop_fn_and_next_output(self):
        eng, params, step_fn = _engine(session_rungs=(1,))
        prompt = np.asarray([4, 4], np.int32)
        ref = _dense_ref(params, step_fn, prompt, 12, eng.padded_len)
        stop_at = ref[3]
        sess = eng.admit({"tok": prompt}, max_new_tokens=50,
                         stop_fn=lambda out: int(out) == stop_at)
        eng.prefill(sess)
        got = []
        while not sess.done():
            eng.tick([sess])
        while True:
            try:
                got.append(int(sess.next_output(1)))
            except StopIteration:
                break
        # stopped ON the first occurrence of the token
        assert got == ref[:ref.index(stop_at) + 1]
        assert sess.finish_reason == "finished"
        eng.close()


# ---------------------------------------------------------------------------
# batcher: continuous ticks, cancel, deadline, drain, exhaustion
# ---------------------------------------------------------------------------

class TestDecodeBatcher:
    def test_concurrent_sessions_share_ticks_bit_equal(self):
        eng, params, step_fn = _engine(session_rungs=(1, 2, 4))
        bat = DecodeBatcher(eng, max_wait_ms=20.0)
        rs = np.random.RandomState(1)
        prompts = [rs.randint(0, VOCAB, size=n).astype(np.int32)
                   for n in (2, 5, 9, 13)]
        sess = [bat.start({"tok": p}, max_new_tokens=6) for p in prompts]
        for s, p in zip(sess, prompts):
            assert [int(o) for o in s.result(30)] == \
                _dense_ref(params, step_fn, p, 6, eng.padded_len)
        # 4 sessions x 6 tokens from far fewer than 24 dispatches
        assert eng.dispatch_count < 4 * 6
        bat.close()
        eng.close()

    def test_cancel_mid_decode_keeps_accepted_frees_blocks(self):
        eng, params, step_fn = _engine(max_len=400, num_blocks=200,
                                       session_rungs=(1,),
                                       prefill_rungs=(4,))
        bat = DecodeBatcher(eng, max_wait_ms=1.0)
        sess = bat.start({"tok": np.asarray([1, 2], np.int32)},
                         max_new_tokens=10 ** 6)
        while sess.token_count < 5 and not sess.done():
            time.sleep(0.002)
        assert sess.cancel()
        with pytest.raises(RequestCancelled):
            sess.result(10)
        kept = _tokens(sess)
        assert len(kept) >= 5                 # accepted steps survive
        assert kept == _dense_ref(params, step_fn,
                                  np.asarray([1, 2], np.int32), len(kept),
                                  eng.padded_len)
        assert _wait_blocks_free(eng) == 0
        bat.close()
        eng.close()

    def test_join_deadline_sheds_typed(self, monkeypatch):
        eng, _, _ = _engine(session_rungs=(1,))
        bat = DecodeBatcher(eng, max_wait_ms=0.0)
        # a slow prefill ahead in the queue pushes the second join past
        # its deadline — it must shed typed, never decode
        orig_prefill = eng.prefill

        def slow_prefill(s):
            time.sleep(0.06)
            orig_prefill(s)
        monkeypatch.setattr(eng, "prefill", slow_prefill)
        blocker = bat.start({"tok": np.asarray([4], np.int32)},
                            max_new_tokens=1)
        sess = bat.start({"tok": np.asarray([1, 2], np.int32)},
                         max_new_tokens=2, deadline_ms=20)
        with pytest.raises(DeadlineExceededError):
            sess.result(10)
        blocker.result(10)
        assert eng.pool.blocks_in_use == 0
        bat.close()
        eng.close()

    def test_pool_exhaustion_sheds_then_recovers(self):
        eng, params, step_fn = _engine(max_len=16, block_size=4,
                                       num_blocks=5, session_rungs=(1, 2))
        bat = DecodeBatcher(eng, max_wait_ms=1.0)
        # 4 allocatable blocks; two 8-token prompts take them all (max
        # new 1: the generated token lands in the last prompt block, so
        # neither session needs mid-stream growth)
        a = bat.start({"tok": np.ones(8, np.int32)}, max_new_tokens=1)
        b = bat.start({"tok": np.full(8, 2, np.int32)}, max_new_tokens=1)
        with pytest.raises(KVPoolExhausted):
            bat.start({"tok": np.asarray([3], np.int32)},
                      max_new_tokens=1)
        a.result(30)
        b.result(30)
        c = bat.start({"tok": np.asarray([3], np.int32)}, max_new_tokens=2)
        assert [int(o) for o in c.result(30)] == _dense_ref(
            params, step_fn, np.asarray([3], np.int32), 2, eng.padded_len)
        bat.close()
        eng.close()

    def test_drain_finishes_or_typed_fails_and_releases(self):
        eng, _, _ = _engine(max_len=4000, num_blocks=1100,
                            session_rungs=(1, 2), prefill_rungs=(4,))
        bat = DecodeBatcher(eng, max_wait_ms=1.0)
        finishing = bat.start({"tok": np.asarray([1], np.int32)},
                              max_new_tokens=3)
        runaway = bat.start({"tok": np.asarray([2], np.int32)},
                            max_new_tokens=10 ** 6)
        assert bat.drain(timeout=0.2) is False   # runaway can't finish
        assert finishing.done() and finishing.error is None
        with pytest.raises(ServeError, match="drained"):
            runaway.result(5)
        assert len(runaway.outputs()) > 0        # accepted steps kept
        assert eng.pool.blocks_in_use == 0
        with pytest.raises(ServeError, match="draining"):
            bat.start({"tok": np.asarray([1], np.int32)})
        bat.close()
        eng.close()

    def test_drain_sees_inflight_iteration(self, monkeypatch):
        """A lone join the tick loop has popped into its LOCALS (the
        window where _joins and _sessions are both empty) must still
        hold drain() open."""
        eng, params, step_fn = _engine(session_rungs=(1,))
        bat = DecodeBatcher(eng, max_wait_ms=0.0)
        orig_tick = eng.tick

        def slow_tick(sessions):
            time.sleep(0.05)
            return orig_tick(sessions)
        monkeypatch.setattr(eng, "tick", slow_tick)
        p = np.asarray([1, 2], np.int32)
        sess = bat.start({"tok": p}, max_new_tokens=3)
        assert bat.drain(10.0)     # waits out the in-flight ticks
        assert sess.done() and sess.error is None
        assert _tokens(sess) == _dense_ref(params, step_fn, p, 3,
                                           eng.padded_len)
        bat.close()
        eng.close()

    def test_close_fails_live_sessions_typed(self):
        eng, _, _ = _engine(max_len=400, num_blocks=200,
                            session_rungs=(1,), prefill_rungs=(4,))
        bat = DecodeBatcher(eng, max_wait_ms=1.0)
        sess = bat.start({"tok": np.asarray([5], np.int32)},
                         max_new_tokens=10 ** 6)
        while sess.token_count < 1:
            time.sleep(0.002)
        assert bat.close()
        with pytest.raises(ServeError, match="closed"):
            sess.result(5)
        assert eng.pool.blocks_in_use == 0
        with pytest.raises(ServeError, match="closed"):
            bat.start({"tok": np.asarray([1], np.int32)})
        eng.close()


# ---------------------------------------------------------------------------
# registry lifecycle + dense DecodeSession interop
# ---------------------------------------------------------------------------

def _mlp_model(dim=12, seed=0):
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=8, name="h")
    net = sym.softmax(net)
    rs = np.random.RandomState(seed)
    shapes = _infer_shapes(net, {"data": (1, dim)})[1]
    params = {n: mx.nd.array(rs.randn(*shapes[n]).astype(np.float32) * 0.1,
                             ctx=CPU)
              for n in net.list_arguments() if n != "data"}
    return net, params


def _load(registry, name, seed=0):
    net, params = _mlp_model(seed=seed)
    registry.load(name, net, params, data_shapes={"data": (1, 12)},
                  ladder=BucketLadder(batches=(1,)), ctx=CPU)


class TestRegistryDecodeLifecycle:
    def _attach_engine(self, registry, name, **kwargs):
        params, step_fn, prefill_fn, token_spec, input_spec = _lm()

        def wrapped_step(p, view, inputs, pos):
            # the host predictor's params are the MLP's; the decode
            # model's weights ride the closure
            return step_fn(params, view, inputs, pos)

        def wrapped_prefill(p, inputs, length):
            return prefill_fn(params, inputs, length)

        pred = registry.get(name)
        kwargs.setdefault("max_len", 24)
        kwargs.setdefault("block_size", 4)
        kwargs.setdefault("num_blocks", 40)
        kwargs.setdefault("session_rungs", (1, 2))
        eng = pred.make_paged_decoder(wrapped_step, wrapped_prefill,
                                      token_spec, input_spec, **kwargs)
        assert eng.device == torch.device("cpu")   # the predictor's
        return eng, params, step_fn

    def test_unload_drains_decode_sessions_zero_lost_steps(self):
        registry = ModelRegistry()
        _load(registry, "m")
        eng, params, step_fn = self._attach_engine(registry, "m")
        bat = DecodeBatcher(eng, max_wait_ms=1.0)
        prompts = [np.asarray([1, 2, 3], np.int32),
                   np.asarray([9, 8], np.int32)]
        sess = [bat.start({"tok": p}, max_new_tokens=6) for p in prompts]
        registry.unload("m", drain=True)
        # every accepted session completed its FULL stream before the
        # teardown — zero lost accepted steps
        for s, p in zip(sess, prompts):
            assert [int(o) for o in s.result(5)] == _dense_ref(
                params, step_fn, p, 6, eng.padded_len)
        assert eng.pool.blocks_in_use == 0
        with pytest.raises(ServeError):
            bat.start({"tok": prompts[0]})
        assert "m" not in registry.names()

    def test_alias_cutover_drains_old_targets_decode(self):
        registry = ModelRegistry()
        _load(registry, "v1")
        _load(registry, "v2", seed=5)
        registry.alias("live", "v1")
        eng, params, step_fn = self._attach_engine(registry, "v1")
        bat = DecodeBatcher(eng, max_wait_ms=1.0)
        p = np.asarray([2, 7], np.int32)
        sess = bat.start({"tok": p}, max_new_tokens=5)
        registry.alias("live", "v2")          # cutover
        assert [int(o) for o in sess.result(5)] == _dense_ref(
            params, step_fn, p, 5, eng.padded_len)
        assert eng.pool.blocks_in_use == 0
        # FLUSH, not close: v1 is still registered, so its decode path
        # keeps serving after the repoint — the predict cutover rule
        later = bat.start({"tok": p}, max_new_tokens=3)
        assert [int(o) for o in later.result(10)] == _dense_ref(
            params, step_fn, p, 3, eng.padded_len)
        assert registry.live()
        registry.close()

    def test_reload_drains_the_displaced_models_decode(self):
        """Loading a model under a live name drains the displaced
        predictor's decode batchers (accepted sessions finish their
        streams) and closes its engines; the replacement starts with
        none."""
        registry = ModelRegistry()
        _load(registry, "m")
        eng, params, step_fn = self._attach_engine(registry, "m")
        bat = DecodeBatcher(eng, max_wait_ms=1.0)
        p = np.asarray([4, 2, 6], np.int32)
        sess = bat.start({"tok": p}, max_new_tokens=5)
        _load(registry, "m", seed=3)
        assert [int(o) for o in sess.result(5)] == _dense_ref(
            params, step_fn, p, 5, eng.padded_len)
        assert eng._closed and eng.pool.blocks_in_use == 0
        assert registry.get("m")._decode_engines == []
        with pytest.raises(ServeError, match="closed"):
            bat.start({"tok": p})
        registry.close()

    def test_live_survives_clean_batcher_close(self):
        registry = ModelRegistry()
        _load(registry, "m")
        eng, params, step_fn = self._attach_engine(registry, "m")
        bat = DecodeBatcher(eng, max_wait_ms=1.0)
        bat.start({"tok": np.asarray([1], np.int32)},
                  max_new_tokens=2).result(30)
        assert bat.close()
        # a retired batcher is not a liveness failure
        assert registry.live()
        assert bat not in eng._batchers
        registry.close()

    def test_health_and_live_cover_decode(self):
        registry = ModelRegistry()
        _load(registry, "m")
        eng, _, _ = self._attach_engine(registry, "m")
        bat = DecodeBatcher(eng, max_wait_ms=1.0)
        sess = bat.start({"tok": np.asarray([1, 2, 3], np.int32)},
                         max_new_tokens=3)
        info = registry.health("m")
        assert "decode" in info
        assert info["decode"]["kv_blocks_total"] == eng.pool.blocks_total
        assert registry.live()
        sess.result(10)
        registry.close()


# ---------------------------------------------------------------------------
# DecodeSession.step input elision
# ---------------------------------------------------------------------------

def _dense_pred():
    net, params = _mlp_model()
    return CompiledPredictor(net, params, data_shapes={"data": (1, 12)},
                             ladder=BucketLadder(batches=(1,)), ctx=CPU)


class TestDenseStepElision:
    def test_device_resident_chain_elides_host_round_trip(self):
        from mxnet_tpu_torch.observability import metrics
        pred = _dense_pred()

        def _step(p, cache, inputs, t):
            new = cache["kv"].index_copy(1, t.long().reshape(1),
                                         inputs["tok"][:, None])
            return new.sum(dim=1), {"kv": new}

        sess = pred.make_decoder(
            _step, {"kv": np.zeros((2, 6), np.float32)}, {"tok": (2,)})
        elided = metrics.REGISTRY.get("device_put_elided_total")
        out = sess.step({"tok": np.ones((2,), np.float32)})
        base = elided.value
        # the previous step's device-resident output fed straight back:
        # no host round trip, the elision counter ticks
        out2 = sess.step({"tok": out})
        assert elided.value == base + 1
        # and the chain computes the same thing the host path does
        assert np.array_equal(np.asarray(out2), np.asarray(out) * 2)

    def test_host_inputs_still_route_through_numpy(self):
        from mxnet_tpu_torch.observability import metrics
        pred = _dense_pred()

        def _step(p, cache, inputs, t):
            return inputs["tok"] + 1.0, cache

        sess = pred.make_decoder(
            _step, {"kv": np.zeros((1,), np.float32)}, {"tok": (2,)})
        elided = metrics.REGISTRY.get("device_put_elided_total")
        base = elided.value
        out = sess.step({"tok": np.zeros((2,), np.float32)})
        assert elided.value == base            # host input: no elision
        assert np.array_equal(np.asarray(out), np.ones((2,)))


# ---------------------------------------------------------------------------
# speculative decode
# ---------------------------------------------------------------------------

class TestSpeculative:
    def test_bit_equal_to_plain_greedy_and_fewer_dispatches(self):
        eng_t, params, step_fn = _engine(session_rungs=(1,), spec_k=4,
                                         max_len=24, num_blocks=40,
                                         prefill_rungs=(4,))
        eng_d, _, _ = _engine(session_rungs=(1,), max_len=24,
                              num_blocks=40, prefill_rungs=(4,))
        spec = SpeculativeDecoder(eng_t, eng_d)   # a perfect draft
        prompt = np.asarray([1, 2, 3], np.int32)
        sess = spec.run({"tok": prompt}, max_new_tokens=12)
        assert _tokens(sess) == _dense_ref(params, step_fn, prompt, 12,
                                           eng_t.padded_len)
        # a perfect draft accepts everything: far fewer target
        # dispatches than tokens
        assert spec.stats["accepted"] == spec.stats["proposed"]
        assert spec.stats["target_dispatches"] < 12
        eng_t.close()
        eng_d.close()

    def test_wrong_draft_still_bit_equal(self):
        eng_t, params, step_fn = _engine(session_rungs=(1,), spec_k=3,
                                         max_len=24, num_blocks=40,
                                         prefill_rungs=(4,))
        eng_d, _, _ = _engine(session_rungs=(1,), seed=99, max_len=24,
                              num_blocks=40, prefill_rungs=(4,))
        spec = SpeculativeDecoder(eng_t, eng_d)   # a junk draft
        prompt = np.asarray([6, 6, 7], np.int32)
        sess = spec.run({"tok": prompt}, max_new_tokens=10)
        assert _tokens(sess) == _dense_ref(params, step_fn, prompt, 10,
                                           eng_t.padded_len)
        eng_t.close()
        eng_d.close()

    def test_verify_failure_releases_target_session(self):
        """A pool-exhausted verify must not strand the live target
        session: blocks come back, the gauge drops, delivered tokens
        stay readable."""
        # 4 allocatable blocks; a co-tenant holds 3, the spec session's
        # verify growth needs a 2nd block -> exhausted
        eng_t, params, step_fn = _engine(session_rungs=(1,), spec_k=4,
                                         max_len=16, block_size=4,
                                         num_blocks=5)
        eng_d, _, _ = _engine(session_rungs=(1,), max_len=16,
                              block_size=4, num_blocks=8)
        hog = eng_t.admit({"tok": np.ones(12, np.int32)},
                          max_new_tokens=10 ** 6)
        spec = SpeculativeDecoder(eng_t, eng_d)
        with pytest.raises(KVPoolExhausted):
            spec.run({"tok": np.asarray([1, 2, 3], np.int32)},
                     max_new_tokens=12)
        assert eng_t.active_sessions == 1      # only the hog remains
        eng_t.release(hog, "finished", None)
        assert eng_t.pool.blocks_in_use == 0
        eng_t.close()
        eng_d.close()

    def test_verify_requires_spec_k(self):
        eng, _, _ = _engine(session_rungs=(1,))
        sess = eng.admit({"tok": np.asarray([1], np.int32)},
                         max_new_tokens=2)
        with pytest.raises(ServeError, match="spec_k"):
            eng.verify(sess, {"tok": np.zeros((4,), np.int32)})
        eng.close()

    def test_draft_crash_falls_back_bit_equal(self, monkeypatch):
        """A draft engine dying mid-run degrades to plain greedy target
        ticks — invisible in the stream, named in ``fallback_reason``,
        and the draft session is retired, never stranded."""
        eng_t, params, step_fn = _engine(session_rungs=(1,), spec_k=3,
                                         max_len=24, num_blocks=40,
                                         prefill_rungs=(4,))
        eng_d, _, _ = _engine(session_rungs=(1,), max_len=24,
                              num_blocks=40, prefill_rungs=(4,))
        spec = SpeculativeDecoder(eng_t, eng_d)
        calls = [0]
        orig_tick = eng_d.tick

        def dying_tick(sessions):
            calls[0] += 1
            if calls[0] > 2:
                raise RuntimeError("injected draft device loss")
            return orig_tick(sessions)
        monkeypatch.setattr(eng_d, "tick", dying_tick)
        prompt = np.asarray([1, 2, 3], np.int32)
        sess = spec.run({"tok": prompt}, max_new_tokens=10)
        assert _tokens(sess) == _dense_ref(params, step_fn, prompt, 10,
                                           eng_t.padded_len)
        assert spec.fallback_reason == "draft_tick"
        assert spec.stats["fallbacks"] == 1
        assert eng_d.active_sessions == 0      # draft retired
        eng_t.close()
        eng_d.close()


# ---------------------------------------------------------------------------
# quarantine-and-rebuild: resume-edge determinism
# ---------------------------------------------------------------------------

class TestRebuildResume:
    """The chaos-armed tick-crash path, edge by edge: the batcher
    quarantines the suspect pool, a fresh one takes over its tensors
    zeroed in place against the built programs, and journaled sessions
    are re-admitted via one re-prefill + replayed ticks — bit-equal to
    an uninterrupted stream, or typed, never wrong and never wedged."""

    @pytest.fixture(autouse=True)
    def _clean_chaos(self):
        chaos.reset()
        yield
        chaos.reset()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_crash_before_first_token_resumes_bit_equal(self, dtype):
        # the crash lands on the very first tick: the journal holds the
        # identity and prompt but ZERO accepted tokens — resume is one
        # re-prefill, no replay
        eng, params, step_fn = _engine(dtype, session_rungs=(1,),
                                       prefill_rungs=(4,))
        ptrs = {k: a.data_ptr() for k, a in eng.pool.arrays.items()}
        bat = DecodeBatcher(eng, max_wait_ms=1.0, rebuilds=1)
        p = np.asarray([3, 1, 4], np.int32)
        chaos.configure(decode_tick_raise_at=1)
        sess = bat.start({"tok": p}, max_new_tokens=6)
        got = [int(o) for o in sess.result(60)]
        assert got == _dense_ref(params, step_fn, p, 6, eng.padded_len,
                                 dtype)
        assert bat.rebuild_count == 1
        assert bat.health_state() == "ready"
        assert eng.pool.blocks_in_use == 0
        # the rebuilt pool is the quarantined one's storage, zeroed
        assert {k: a.data_ptr() for k, a in eng.pool.arrays.items()} \
            == ptrs
        bat.close()
        eng.close()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_crash_at_block_boundary_resumes_bit_equal(self, dtype):
        # the 3-token prompt plus the first generated token exactly
        # fills one block (block_size=4), so the crash on tick 2 leaves
        # the journal frontier block-ALIGNED — re-admission must grow a
        # fresh block for the replayed cache before the first new step
        eng, params, step_fn = _engine(dtype, session_rungs=(1,),
                                       prefill_rungs=(4,))
        bat = DecodeBatcher(eng, max_wait_ms=1.0, rebuilds=1)
        p = np.asarray([3, 1, 4], np.int32)
        chaos.configure(decode_tick_raise_at=2)
        sess = bat.start({"tok": p}, max_new_tokens=6)
        got = [int(o) for o in sess.result(60)]
        assert got == _dense_ref(params, step_fn, p, 6, eng.padded_len,
                                 dtype)
        assert bat.rebuild_count == 1
        assert eng.pool.blocks_in_use == 0
        bat.close()
        eng.close()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_cancel_racing_rebuild_is_never_resumed(self, dtype):
        # a CANCEL landing in the rebuild window (fresh pool up,
        # re-admission not yet run) wins: the session is released typed
        # with its accepted prefix intact and is never replayed; its
        # co-tenant still resumes bit-equal
        eng, params, step_fn = _engine(dtype, session_rungs=(1, 2),
                                       prefill_rungs=(4,))
        seen = []

        def on_state(state):
            seen.append(state)
            if state == "rebuilding":
                victim.cancel()
        bat = DecodeBatcher(eng, max_wait_ms=1.0, rebuilds=1,
                            on_state=on_state)
        chaos.configure(decode_tick_raise_at=2)
        victim = bat.start({"tok": np.asarray([1, 2], np.int32)},
                           max_new_tokens=8)
        other = bat.start({"tok": np.asarray([5, 6], np.int32)},
                          max_new_tokens=8)
        with pytest.raises(RequestCancelled, match="rebuild"):
            victim.result(60)
        got = [int(o) for o in other.result(60)]
        assert "rebuilding" in seen
        assert got == _dense_ref(params, step_fn,
                                 np.asarray([5, 6], np.int32), 8,
                                 eng.padded_len, dtype)
        # the cancelled stream kept its pre-crash prefix, bit-equal
        kept = _tokens(victim)
        assert kept == _dense_ref(params, step_fn,
                                  np.asarray([1, 2], np.int32), len(kept),
                                  eng.padded_len, dtype)
        assert _wait_blocks_free(eng) == 0
        bat.close()
        eng.close()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_pool_exhausted_readmission_sheds_typed(self, dtype,
                                                    monkeypatch):
        # a fresh pool that cannot hold one session's resume prompt
        # sheds THAT session typed — the rebuild itself still lands, the
        # co-tenant resumes bit-equal, and the batcher stays open
        eng, params, step_fn = _engine(dtype, session_rungs=(1, 2),
                                       prefill_rungs=(4,))
        bat = DecodeBatcher(eng, max_wait_ms=1.0, rebuilds=1)
        orig_readmit = eng.readmit

        def starved_readmit(s):
            if s.sid == victim.sid:
                raise KVPoolExhausted(
                    "injected: fresh pool cannot hold the resume")
            return orig_readmit(s)
        monkeypatch.setattr(eng, "readmit", starved_readmit)
        chaos.configure(decode_tick_raise_at=2)
        victim = bat.start({"tok": np.asarray([1, 2], np.int32)},
                           max_new_tokens=8)
        other = bat.start({"tok": np.asarray([5, 6], np.int32)},
                          max_new_tokens=8)
        with pytest.raises(KVPoolExhausted):
            victim.result(60)
        got = [int(o) for o in other.result(60)]
        assert got == _dense_ref(params, step_fn,
                                 np.asarray([5, 6], np.int32), 8,
                                 eng.padded_len, dtype)
        assert bat.rebuild_count == 1
        assert bat.health_state() == "ready"
        chaos.reset()
        # not wedged: a new session decodes end to end
        fresh = bat.start({"tok": np.asarray([7], np.int32)},
                          max_new_tokens=3)
        assert [int(o) for o in fresh.result(60)] == _dense_ref(
            params, step_fn, np.asarray([7], np.int32), 3, eng.padded_len,
            dtype)
        assert _wait_blocks_free(eng) == 0
        bat.close()
        eng.close()

    def test_past_budget_crash_degrades_typed_never_wedged(self):
        # past MXNET_SERVE_DECODE_REBUILDS the batcher must fail typed
        # and report unhealthy — never decode over a pool it cannot
        # trust, never hang callers
        eng, _, _ = _engine(session_rungs=(1,), prefill_rungs=(4,))
        bat = DecodeBatcher(eng, max_wait_ms=1.0, rebuilds=0)
        chaos.configure(decode_tick_raise_at=1)
        sess = bat.start({"tok": np.asarray([1, 2], np.int32)},
                         max_new_tokens=4)
        with pytest.raises(ServeError, match="unhealthy"):
            sess.result(60)
        assert bat.unhealthy
        assert bat.health_state() == "unhealthy"
        assert bat.rebuild_count == 0
        with pytest.raises(ServeError, match="unhealthy"):
            bat.start({"tok": np.asarray([1], np.int32)})
        assert eng.pool.blocks_in_use == 0
        bat.close()
        eng.close()


def test_replica_kill_decode_exits_137_through_the_exit_seam(monkeypatch):
    """``replica_kill_decode_at=K`` leaves the engine's tick alone and
    hard-exits the replica (``servechaos._exit``, patched here to record
    instead of dying) on its K-th DECODE_OPEN / DECODE_NEXT request."""
    from mxnet_tpu_torch.resilience import servechaos

    class Exited(Exception):
        pass

    codes = []

    def _exit(code):
        codes.append(code)
        raise Exited(code)

    monkeypatch.setattr(servechaos, "_exit", _exit)
    eng, params, step_fn = _engine(session_rungs=(1,), prefill_rungs=(4,))
    prompt = np.asarray([1, 2], np.int32)
    sess = eng.admit({"tok": prompt}, max_new_tokens=2)
    eng.prefill(sess)
    chaos.configure(replica_kill_decode_at=3)
    try:
        eng.tick([sess])            # the engine decodes as if unarmed
        eng.tick([sess])
        servechaos.on_replica_decode("replica-0")
        servechaos.on_replica_decode("replica-0")
        assert codes == []
        with pytest.raises(Exited):
            servechaos.on_replica_decode("replica-0")
        assert codes == [137]
        servechaos.on_replica_decode("replica-0")   # only the K-th
        assert codes == [137]
    finally:
        chaos.reset()
    assert [int(o) for o in sess.outputs()] == _dense_ref(
        params, step_fn, prompt, 2, eng.padded_len, "float32")
    eng.close()
