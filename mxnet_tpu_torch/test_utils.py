"""Test fixtures (port of ``mxnet_tpu/test_utils.py``, subset: the tiny
attention language model behind the paged-decode tests and its dense
greedy-decode oracle)."""

from __future__ import annotations

import numpy as np
import torch

from .base import torch_dtype
from .serve.kvpool import as_device

__all__ = ["tiny_attention_lm", "dense_decode_reference"]


def tiny_attention_lm(vocab=32, dim=16, seed=0, dtype="float32", ctx=None):
    """A single-head attention language model sized for CPU tests — the
    fixture behind the paged-decode tests.

    The weights are drawn from the same ``np.random.RandomState(seed)``
    sequence as the JAX package's fixture, so both packages hold
    identical weights for one seed.  *ctx* is where they live (default:
    the current context, ``gpu(0)``).

    Returns ``(params, step_fn, prefill_fn, token_spec, input_spec)``
    matching the :class:`mxnet_tpu_torch.serve.DecodeEngine` contract:

    * ``step_fn(params, view, {"tok": (S,)}, pos)`` embeds the token,
      writes its K/V **exactly at position pos**, attends causally
      (everything past ``pos`` masked to -1e30 — positions beyond the
      cursor hold co-tenant garbage by design) and emits the greedy
      argmax next token, ``(S,) int32``;
    * ``prefill_fn`` computes K/V for a whole prompt prefix in one
      matrix product.

    The greedy emission makes every decode path — dense solo, paged
    batched ticks, speculative verify — comparable on the token stream.
    """
    dev = as_device(ctx)
    tdt = torch_dtype(dtype)
    rs = np.random.RandomState(seed)
    params = {
        name: torch.from_numpy(
            rs.randn(*shape).astype(np.float32) * 0.3).to(dev, tdt)
        for name, shape in (("E", (vocab, dim)), ("Wq", (dim, dim)),
                            ("Wk", (dim, dim)), ("Wv", (dim, dim)),
                            ("Wo", (dim, vocab)))}
    # device scalars made here, not in the step: under CUDA graph capture
    # a tensor made from a Python number is a host copy, which is refused
    scale = torch.tensor(1.0 / np.sqrt(dim), dtype=tdt, device=dev)
    masked = torch.tensor(-1e30, dtype=tdt, device=dev)

    def embed(p, tok):
        # the reference's p["E"][tok]: a negative id wraps, then the
        # gather clamps into range (and the device never asserts)
        tok = tok.long()
        tok = torch.where(tok < 0, tok + vocab, tok).clamp(0, vocab - 1)
        return p["E"][tok]

    def step_fn(p, view, inputs, pos):
        x = embed(p, inputs["tok"])            # (S, D)
        q = x @ p["Wq"]
        k = x @ p["Wk"]
        v = x @ p["Wv"]
        idx = torch.arange(view["k"].shape[0], device=x.device)
        at = (idx, pos.long())
        nk = view["k"].index_put(at, k)        # write AT pos only
        nv = view["v"].index_put(at, v)
        seq = view["k"].shape[1]
        scores = torch.einsum("sd,sld->sl", q, nk) * scale
        mask = torch.arange(seq, device=x.device)[None, :] <= \
            pos.long()[:, None]
        scores = torch.where(mask, scores, masked)
        # jax.nn.softmax as XLA compiles it for a 16-bit dtype: exp in
        # f32, summed unrounded, the sum and exp rounded before the
        # divide (a fused softmax rounds once and moves bf16 ties)
        e = torch.exp((scores - scores.max(dim=-1, keepdim=True).values)
                      .float())
        probs = e.to(tdt) / e.sum(dim=-1, keepdim=True).to(tdt)
        ctx_ = torch.einsum("sl,sld->sd", probs, nv)
        logits = ctx_ @ p["Wo"]
        out = torch.argmax(logits, dim=-1).to(torch.int32)
        return out, {"k": nk, "v": nv}

    def prefill_fn(p, inputs, length):
        x = embed(p, inputs["tok"][0])         # (Lr, D)
        return {"k": (x @ p["Wk"])[None], "v": (x @ p["Wv"])[None]}

    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    token_spec = {"k": meta((dim,), tdt), "v": meta((dim,), tdt)}
    input_spec = {"tok": meta((), torch.int32)}
    return params, step_fn, prefill_fn, token_spec, input_spec


def dense_decode_reference(params, step_fn, prompt, n_new, padded_len,
                           dim, dtype="float32", input_name="tok",
                           cache_keys=("k", "v")):
    """Solo dense-cache greedy decode — THE bit-equality oracle for the
    paged decode path: the same ``step_fn`` over ONE dense worst-case
    cache ``(1, padded_len, dim)`` on the parameters' device, one eager
    call per token.  The prompt is fed token by token at ``pos = t``;
    the LAST prompt token's output is the first generated token
    (matching the engine's prefill-prefix + first-tick convention).
    Returns the generated token stream as a list of ints."""
    dev = next(iter(params.values())).device
    tdt = torch_dtype(dtype)
    view = {k: torch.zeros((1, padded_len, dim), dtype=tdt, device=dev)
            for k in cache_keys}

    def stepped(tok, t):
        with torch.no_grad():
            return step_fn(
                params, view,
                {input_name: torch.tensor([tok], dtype=torch.int32,
                                          device=dev)},
                torch.tensor([t], dtype=torch.int32, device=dev))

    cur, t = None, 0
    for tok in prompt:
        out, view = stepped(int(tok), t)
        t += 1
        cur = int(out[0])
    stream = []
    for _ in range(int(n_new)):
        stream.append(cur)
        if len(stream) >= int(n_new):
            break
        out, view = stepped(cur, t)
        t += 1
        cur = int(out[0])
    return stream
