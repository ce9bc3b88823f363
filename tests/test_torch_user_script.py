"""The slice as a whole: the training loop of
examples/train_transformer_lm.py (lines 91-183: gluon Dense / LayerNorm /
Embedding blocks, ``qkv[0]`` slicing, a standalone ``gluon.Parameter``
for positions, ``nd.contrib.DotProductAttention``, ``Trainer(dict,
"adam")``, the copy task with lag 7) run in both packages at a small
size (2 layers, dim 64, 4 heads, seq 64, vocab 32, batch 4) from the
same weights, carried across with ``gluon.load_jax_params``.  Each of 5
adam steps' loss is held to 1e-5 of the JAX package's (relative: only f32
summation order differs), and the weights after them to 1e-4 of each
tensor's scale (adam moves a weight by up to lr = 3e-3 whatever its
gradient's size, so the noise of a near-zero gradient shows there).  A
parameter file written by either package loads in the other to bit-equal
values."""

import os
import sys
import types

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
from train_transformer_lm import TransformerBlock, copy_task_batch  # noqa

VOCAB, DIM, HEADS, LAYERS, SEQ, BATCH, LAG, LR = 32, 64, 4, 2, 64, 4, 7, 3e-3
STEPS = 5
TOL = 1e-5


def _model(pkg, ctx):
    """The example's model, its parameters as the example collects them."""
    gluon = pkg.gluon
    embed = gluon.nn.Embedding(VOCAB, DIM, prefix="embed_")
    blocks = [TransformerBlock(pkg, DIM, HEADS, "blk%d_" % i)
              for i in range(LAYERS)]
    head = gluon.nn.Dense(VOCAB, flatten=False, prefix="head_")
    pos = gluon.Parameter("pos_embed", shape=(1, SEQ, DIM))
    all_blocks = [embed, head] + [b for blk in blocks for b in blk.blocks]
    for b in all_blocks:
        b.initialize(pkg.init.Xavier(), ctx=ctx)
    pos.initialize(pkg.init.Normal(0.02), ctx=ctx)
    params = {}
    for b in all_blocks:
        params.update(b.collect_params())
    params[pos.name] = pos
    return embed, blocks, head, pos, params


def _train(pkg, ctx, model):
    """The example's loop (attention on the package's kernels or their
    plain versions); the loss of each step."""
    embed, blocks, head, pos, params = model
    trainer = pkg.gluon.Trainer(params, "adam", {"learning_rate": LR})
    lossfn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()

    def attention_fn(q, k, v):
        return pkg.nd.contrib.DotProductAttention(q, k, v, causal=True)

    rng = np.random.RandomState(0)
    losses = []
    for _ in range(STEPS):
        xb, yb = copy_task_batch(rng, BATCH, SEQ, VOCAB, LAG)
        x, y = pkg.nd.array(xb, ctx=ctx), pkg.nd.array(yb, ctx=ctx)
        with pkg.autograd.record():
            h = embed(x) + pos.data()
            for blk in blocks:
                h = blk(h, attention_fn)
            logits = head(h)
            L = pkg.nd.mean(lossfn(pkg.nd.reshape(logits, (-1, VOCAB)),
                                   pkg.nd.reshape(y, (-1,))))
        L.backward()
        trainer.step(1)
        losses.append(float(L.asnumpy()))
    return losses


def _forward(pkg, ctx, model, xb):
    embed, blocks, head, pos, _ = model
    h = embed(pkg.nd.array(xb, ctx=ctx)) + pos.data()
    for blk in blocks:
        h = blk(h, lambda q, k, v: pkg.nd.contrib.DotProductAttention(
            q, k, v, causal=True))
    return head(h)


def _models():
    jmodel = _model(jmx, jmx.cpu())
    tmodel = _model(mx, mx.cpu())
    # one forward creates the JAX model's deferred weights
    _forward(jmx, jmx.cpu(), jmodel, np.zeros((1, SEQ), np.float32))
    # the JAX weights into the port
    mx.gluon.load_jax_params(
        types.SimpleNamespace(collect_params=lambda: tmodel[-1]),
        {n: p.data() for n, p in jmodel[-1].items()})
    return jmodel, tmodel


def test_five_adam_steps_match_the_jax_package():
    jmodel, tmodel = _models()
    want = _train(jmx, jmx.cpu(), jmodel)
    got = _train(mx, mx.cpu(), tmodel)
    assert want[-1] < want[0]
    for g, w in zip(got, want):
        assert abs(g - w) <= TOL * abs(w), (got, want)
    # and the weights after the steps, relative to each tensor's scale
    for name, tp in tmodel[-1].items():
        w = jmodel[-1][name].data().asnumpy()
        err = np.max(np.abs(tp.data().asnumpy() - w))
        assert err <= 1e-4 * max(1.0, float(np.max(np.abs(w)))), name


def _pdict(pkg, params):
    d = pkg.gluon.ParameterDict()
    d.update(params)
    return d


def test_params_files_cross_both_ways(tmp_path):
    jmodel, tmodel = _models()
    # the port's steps move its weights off the JAX ones first
    _train(mx, mx.cpu(), tmodel)
    tpath = str(tmp_path / "port.params")
    _pdict(mx, tmodel[-1]).save(tpath)
    _pdict(jmx, jmodel[-1]).load(tpath, ctx=jmx.cpu())
    for name, jp in jmodel[-1].items():
        np.testing.assert_array_equal(jp.data().asnumpy(),
                                      tmodel[-1][name].data().asnumpy())
    _train(jmx, jmx.cpu(), jmodel)
    jpath = str(tmp_path / "jax.params")
    _pdict(jmx, jmodel[-1]).save(jpath)
    _pdict(mx, tmodel[-1]).load(jpath, ctx=mx.cpu())
    for name, tp in tmodel[-1].items():
        np.testing.assert_array_equal(tp.data().asnumpy(),
                                      jmodel[-1][name].data().asnumpy())
