"""Test fixtures (port of ``mxnet_tpu/test_utils.py``, subset: the tiny
attention language model behind the paged-decode tests and its dense
greedy-decode oracle), and the op sweep: one or more small cases for
every op name of the elementwise, reduce, tensor, random and Dropout /
InstanceNorm families, which the CPU tests run against the JAX package
and ``chip_smoke.py`` runs on the card against the CPU."""

from __future__ import annotations

import numpy as np
import torch

from .base import torch_dtype
from .serve.kvpool import as_device

__all__ = ["tiny_attention_lm", "dense_decode_reference", "op_sweep_cases",
           "SAMPLER_MOMENTS", "moments_within"]


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


# ---------------------------------------------------------------------------
# the op sweep
# ---------------------------------------------------------------------------

# aliases of one op share its cases
_SWEEP_ALIASES = {
    "broadcast_add": ("_Plus", "_add", "_grad_add", "_plus", "broadcast_plus",
                      "elemwise_add"),
    "broadcast_sub": ("_Minus", "_minus", "_sub", "broadcast_minus",
                      "elemwise_sub"),
    "broadcast_mul": ("_Mul", "_mul", "elemwise_mul"),
    "broadcast_div": ("_Div", "_div", "elemwise_div"),
    "broadcast_mod": ("_Mod", "_mod"),
    "broadcast_power": ("_Power", "_power"),
    "broadcast_maximum": ("_Maximum", "_maximum"),
    "broadcast_minimum": ("_Minimum", "_minimum"),
    "broadcast_hypot": ("_Hypot", "_hypot"),
    "broadcast_equal": ("_Equal", "_equal"),
    "broadcast_not_equal": ("_Not_Equal", "_not_equal"),
    "broadcast_greater": ("_Greater", "_greater"),
    "broadcast_greater_equal": ("_Greater_Equal", "_greater_equal"),
    "broadcast_lesser": ("_Lesser", "_lesser"),
    "broadcast_lesser_equal": ("_Lesser_Equal", "_lesser_equal"),
    "broadcast_logical_and": ("_Logical_And", "_logical_and"),
    "broadcast_logical_or": ("_Logical_Or", "_logical_or"),
    "broadcast_logical_xor": ("_Logical_Xor", "_logical_xor"),
    "_plus_scalar": ("_PlusScalar",), "_minus_scalar": ("_MinusScalar",),
    "_rminus_scalar": ("_RMinusScalar",), "_mul_scalar": ("_MulScalar",),
    "_div_scalar": ("_DivScalar",), "_rdiv_scalar": ("_RDivScalar",),
    "_mod_scalar": ("_ModScalar",), "_rmod_scalar": ("_RModScalar",),
    "_power_scalar": ("_PowerScalar",),
    "_rpower_scalar": ("_RPowerScalar",),
    "_maximum_scalar": ("_MaximumScalar",),
    "_minimum_scalar": ("_MinimumScalar",),
    "_hypot_scalar": ("_HypotScalar",), "_equal_scalar": ("_EqualScalar",),
    "_not_equal_scalar": ("_NotEqualScalar",),
    "_greater_scalar": ("_GreaterScalar",),
    "_greater_equal_scalar": ("_GreaterEqualScalar",),
    "_lesser_scalar": ("_LesserScalar",),
    "_lesser_equal_scalar": ("_LesserEqualScalar",),
    "_logical_and_scalar": ("_LogicalAndScalar",),
    "_logical_or_scalar": ("_LogicalOrScalar",),
    "_logical_xor_scalar": ("_LogicalXorScalar",),
    "_copy": ("_copyto",), "Cast": ("cast",),
    "add_n": ("ElementWiseSum", "_sum_nary"),
    "sum": ("sum_axis",), "mean": ("mean_axis",), "max": ("max_axis",),
    "min": ("min_axis",), "Reshape": ("reshape",), "Flatten": ("flatten",),
    "SwapAxis": ("swapaxes",), "broadcast_axis": ("broadcast_axes",),
    "Concat": ("concat", "_rnn_param_concat"), "SliceChannel": ("split",),
    "slice": ("crop",), "Pad": ("pad",), "reverse": ("flip",),
    "ravel_multi_index": ("_ravel_multi_index",),
    "unravel_index": ("_unravel_index",), "shuffle": ("_shuffle",),
    "_random_uniform": ("uniform", "random_uniform"),
    "_random_normal": ("normal", "_random_gaussian", "random_normal"),
    "_random_gamma": ("gamma_sample", "random_gamma"),
    "_random_exponential": ("random_exponential",),
    "_random_poisson": ("random_poisson",),
    "_random_negative_binomial": ("random_negative_binomial",),
    "_random_generalized_negative_binomial":
        ("random_generalized_negative_binomial",),
    "_sample_multinomial": ("sample_multinomial",),
}

# the mean and variance of each element a sampler case draws (the
# parameters below); _sample_* cases give one (mean, var) per row
SAMPLER_MOMENTS = {
    "_random_uniform": (1.0, 16.0 / 12),
    "_random_normal": (1.0, 4.0),
    "_random_gamma": (3.0, 4.5),
    "_random_exponential": (0.5, 0.25),
    "_random_poisson": (3.0, 3.0),
    "_random_negative_binomial": (4.5, 11.25),
    "_random_generalized_negative_binomial": (2.0, 4.0),
    "_random_randint": (0.5, 5.25),
    "_random_bernoulli": (0.3, 0.21),
    "_sample_uniform": ([0.5, 2.0], [1.0 / 12, 4.0 / 12]),
    "_sample_normal": ([0.0, 3.0], [1.0, 0.25]),
    "_sample_gamma": ([2.0, 4.5], [2.0, 6.75]),
    "_sample_multinomial": ([1.4, 1.0], [0.64, 0.5]),
}


def moments_within(draws, mean, var, sigmas=4.0):
    """(ok, text): the sample mean and variance of *draws* (a 1-d float64
    numpy array) each within *sigmas* standard errors of *mean* and
    *var*; the variance's standard error from the sample's fourth
    central moment."""
    n = draws.size
    m = draws.mean()
    c = draws - m
    s2 = (c ** 2).mean()
    m4 = (c ** 4).mean()
    se_mean = np.sqrt(var / n)
    se_var = np.sqrt(max(m4 - s2 * s2, 0.0) / n)
    ok = abs(m - mean) <= sigmas * se_mean and \
        abs(s2 - var) <= sigmas * se_var
    return ok, ("mean %.6g (expected %.6g, 4 se %.3g), var %.6g (expected "
                "%.6g, 4 se %.3g)" % (m, mean, sigmas * se_mean, s2, var,
                                      sigmas * se_var))


def op_sweep_cases(seed=0, draws=100000):
    """The op sweep's cases: dicts with ``name`` (the op), ``id``,
    ``inputs`` (numpy arrays), ``params`` and ``kind``: "exact" (shape,
    index, comparison, integer and exactly-rounded ops: equal values,
    NaNs in the same places, equal dtypes), "float" (transcendental and
    summing ops, within a tolerance the caller states) or "random" (a
    sampler, Dropout or shuffle: held by distribution or by permutation,
    not by draws; a sampler case draws *draws* values per element of its
    parameters).  Every alias of an op gets its op's cases."""
    rs = np.random.RandomState(seed)
    f32 = np.float32

    def n(*shape):
        return rs.standard_normal(shape).astype(f32)

    def u(lo, hi, *shape):
        return rs.uniform(lo, hi, shape).astype(f32)

    def away(*shape):        # |x| in [0.2, 2.2)
        x = u(0.2, 2.2, *shape)
        return np.where(rs.rand(*shape) < 0.5, -x, x).astype(f32)

    ints = rs.randint(-9, 10, (3, 4)).astype(np.int32)
    cases = []

    def add(name, inputs, kind, params=None, tag=""):
        cases.append({"name": name, "inputs": [np.asarray(a) for a in inputs],
                      "params": dict(params or {}), "kind": kind,
                      "tag": tag})

    x = n(3, 4)
    # -- unary -----------------------------------------------------------
    for name in ("exp", "expm1", "sin", "cos", "arctan", "sinh", "cosh",
                 "tanh", "arcsinh", "erf", "sigmoid", "softsign",
                 "softrelu", "degrees", "radians", "cbrt"):
        add(name, [x], "float")
    add("tan", [u(-1.2, 1.2, 3, 4)], "float")
    add("rcbrt", [away(3, 4)], "float")
    pos = u(0.2, 3.0, 3, 4)
    for name in ("log", "log10", "log2", "sqrt", "rsqrt", "gammaln",
                 "gamma"):
        add(name, [pos], "float")
    neg = (-u(0.1, 0.9, 3, 4) - rs.randint(0, 3, (3, 4))).astype(f32)
    add("gamma", [neg], "float", tag="negative")
    add("gammaln", [neg], "float", tag="negative")
    add("log1p", [u(-0.5, 3.0, 3, 4)], "float")
    for name in ("arcsin", "arccos", "arctanh", "erfinv"):
        add(name, [u(-0.9, 0.9, 3, 4)], "float")
    add("arccosh", [u(1.1, 4.0, 3, 4)], "float")
    add("reciprocal", [away(3, 4)], "exact")
    special = np.array([[0.5, 1.5, -0.5, -2.5], [-0.0, 0.0, 2.7, -3.2],
                        [np.nan, 1.0, -1.0, 4.5]], f32)
    for name in ("abs", "sign", "rint", "round", "ceil", "floor", "trunc",
                 "fix", "square", "negative", "relu", "logical_not",
                 "_copy", "identity", "zeros_like", "ones_like"):
        add(name, [special], "exact")
        add(name, [ints], "exact", tag="int32")
    inf = np.array([[np.nan, np.inf, -np.inf, 1.0], [0.0, -2.0, 3.0, 5.0]],
                   f32)
    for name in ("isnan", "isinf", "isfinite"):
        add(name, [inf], "exact")
    add("zeros_like", [x], "exact", {"dtype": "int32"}, tag="dtype")
    add("clip", [x], "exact", {"a_min": -0.5, "a_max": 0.5})
    add("clip", [ints], "exact", {"a_min": -3.5}, tag="int32")
    add("Cast", [x * 40], "exact", {"dtype": "int32"})
    add("Cast", [x], "exact", {"dtype": "float16"}, tag="float16")
    add("LeakyReLU", [x], "exact", {"act_type": "leaky", "slope": 0.1})
    add("LeakyReLU", [x, u(0.1, 0.5, 4)], "exact", {"act_type": "prelu"},
        tag="prelu")
    add("LeakyReLU", [x], "exact", {"act_type": "rrelu"}, tag="rrelu")
    for act in ("elu", "selu", "gelu"):
        add("LeakyReLU", [x], "float", {"act_type": act}, tag=act)
    # -- binary (broadcasting (3, 4) against (1, 4)) ----------------------
    a, b = n(3, 4), n(1, 4)
    b_eq = a[:1].copy()
    b_eq[0, ::2] = b[0, ::2]
    bz = b.copy()
    bz[0, 1] = 0.0
    for name in ("broadcast_add", "broadcast_sub", "broadcast_mul",
                 "broadcast_maximum", "broadcast_minimum"):
        add(name, [a, b], "exact")
        add(name, [ints, ints[:1] + 1], "exact", tag="int32")
    add("broadcast_div", [a, away(1, 4)], "exact")
    add("broadcast_div", [ints, np.array([[2, -3, 4, 5]], np.int32)],
        "exact", tag="int32")
    add("broadcast_mod", [a * 3, away(1, 4)], "exact")
    add("broadcast_mod", [ints, np.array([[2, -3, 4, 5]], np.int32)],
        "exact", tag="int32")
    add("broadcast_power", [pos, n(1, 4)], "float")
    add("broadcast_power", [np.abs(ints), np.array([[0, 1, 2, 3]],
                                                   np.int32)],
        "exact", tag="int32")
    add("broadcast_hypot", [a, b], "float")
    for name in ("broadcast_equal", "broadcast_not_equal",
                 "broadcast_greater", "broadcast_greater_equal",
                 "broadcast_lesser", "broadcast_lesser_equal"):
        add(name, [a, b_eq], "exact")
        add(name, [ints, ints[:1]], "exact", tag="int32")
    az = a.copy()
    az[1, 2] = 0.0
    for name in ("broadcast_logical_and", "broadcast_logical_or",
                 "broadcast_logical_xor"):
        add(name, [az, bz], "exact")
    # -- scalar ops ------------------------------------------------------
    for name in ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
                 "_mul_scalar", "_div_scalar", "_maximum_scalar",
                 "_minimum_scalar", "_scatter_plus_scalar", "_mod_scalar"):
        add(name, [a], "exact", {"scalar": 1.5})
        add(name, [ints], "exact", {"scalar": 2.0}, tag="int32")
    add("_rdiv_scalar", [away(3, 4)], "exact", {"scalar": 1.5})
    add("_rmod_scalar", [away(3, 4)], "exact", {"scalar": 2.5})
    add("_power_scalar", [pos], "float", {"scalar": 3.0})
    add("_power_scalar", [a], "exact", {"scalar": 2.0}, tag="square")
    add("_rpower_scalar", [a], "float", {"scalar": 2.0})
    add("_hypot_scalar", [a], "float", {"scalar": 0.5})
    sx = special.copy()
    sx[2, 0] = 1.5
    for name in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
                 "_greater_equal_scalar", "_lesser_scalar",
                 "_lesser_equal_scalar"):
        add(name, [sx], "exact", {"scalar": 1.5})
        add(name, [ints], "exact", {"scalar": 2.0}, tag="int32")
    for name in ("_logical_and_scalar", "_logical_or_scalar",
                 "_logical_xor_scalar"):
        add(name, [az], "exact", {"scalar": 1.0})
        add(name, [az], "exact", {"scalar": 0.0}, tag="zero")
    add("smooth_l1", [x * 2], "float", {"scalar": 1.0})
    add("add_n", [a, n(3, 4), n(3, 4)], "exact")
    # -- reduce ----------------------------------------------------------
    r = n(3, 4, 5)
    rn = r.copy()
    rn[0, 1, 2] = np.nan
    for name in ("sum", "mean", "prod", "logsumexp"):
        add(name, [r], "float", {"axis": 1})
        add(name, [r], "float", {}, tag="all")
        add(name, [r], "float", {"axis": (0, 2), "keepdims": True},
            tag="keepdims")
        add(name, [r], "float", {"axis": 1, "exclude": True}, tag="exclude")
    for name in ("max", "min"):
        add(name, [r], "exact", {"axis": 1})
        add(name, [r], "exact", {}, tag="all")
        add(name, [r], "exact", {"axis": 1, "exclude": True},
            tag="exclude")
    add("sum", [ints], "exact", {"axis": 0}, tag="int32")
    for name in ("nansum", "nanprod"):
        add(name, [rn], "float", {"axis": 1})
        add(name, [rn], "float", {}, tag="all")
    for mode in ("instance", "channel", "spatial"):
        add("L2Normalization", [r], "float", {"mode": mode}, tag=mode)
    # -- creation --------------------------------------------------------
    add("_zeros", [], "exact", {"shape": (2, 3)})
    add("_ones", [], "exact", {"shape": (4,), "dtype": "int32"})
    add("_full", [], "exact", {"shape": (2, 2), "value": 7.5})
    add("_arange", [], "exact", {"start": 1.0, "stop": 10.0, "step": 1.5,
                                 "repeat": 2})
    add("_arange", [], "exact", {"start": 0.1, "stop": 1.0, "step": 0.1},
        tag="fraction")
    add("_eye", [], "exact", {"N": 3, "M": 4, "k": 1})
    add("_linspace", [], "float", {"start": -1.0, "stop": 2.0, "num": 7})
    add("_linspace", [], "float", {"start": 0.0, "stop": 1.0, "num": 5,
                                   "endpoint": False}, tag="open")
    # -- shape -----------------------------------------------------------
    t = n(2, 3, 4)
    add("Reshape", [t], "exact", {"shape": (0, -1)})
    add("Reshape", [t], "exact", {"shape": (-3, 4)}, tag="merge")
    add("Reshape", [t], "exact", {"shape": (-4, 1, 2, 0, 0)}, tag="split")
    add("reshape_like", [t, n(6, 4)], "exact")
    add("Flatten", [t], "exact")
    add("transpose", [t], "exact", {"axes": (1, 0, 2)})
    add("transpose", [t], "exact", {}, tag="reverse")
    add("SwapAxis", [t], "exact", {"dim1": 0, "dim2": 2})
    add("expand_dims", [t], "exact", {"axis": -1})
    add("squeeze", [n(2, 1, 3, 1)], "exact", {})
    add("squeeze", [n(2, 1, 3, 1)], "exact", {"axis": 1}, tag="axis")
    add("broadcast_to", [n(2, 1)], "exact", {"shape": (0, 3)})
    add("broadcast_like", [n(1, 3), n(4, 3)], "exact")
    add("broadcast_axis", [n(2, 1, 1)], "exact", {"axis": (1, 2),
                                                  "size": (3, 4)})
    add("Concat", [a, n(2, 4)], "exact", {"dim": 0})
    add("stack", [a, n(3, 4)], "exact", {"axis": 1})
    add("SliceChannel", [n(2, 6)], "exact", {"num_outputs": 3, "axis": 1})
    add("SliceChannel", [n(4, 2)], "exact", {"num_outputs": 4, "axis": 0,
                                             "squeeze_axis": True},
        tag="squeeze")
    add("slice", [t], "exact", {"begin": (0, 1), "end": (2, 3)})
    add("slice", [t], "exact", {"begin": (None, -1), "end": (None, None),
                                "step": (None, -1)}, tag="negative_step")
    add("slice_axis", [t], "exact", {"axis": 2, "begin": 1, "end": -1})
    add("slice_like", [t, n(1, 2, 3)], "exact", {"axes": (1, 2)})
    add("tile", [n(2, 3)], "exact", {"reps": (2, 1, 2)})
    add("repeat", [n(2, 3)], "exact", {"repeats": 2, "axis": 1})
    add("repeat", [n(2, 3)], "exact", {"repeats": 3}, tag="flat")
    for mode in ("constant", "edge", "reflect"):
        add("Pad", [n(1, 2, 3, 4)], "exact",
            {"mode": mode, "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
             "constant_value": 1.5}, tag=mode)
    add("reverse", [t], "exact", {"axis": (0, 2)})
    add("space_to_depth", [n(1, 2, 4, 6)], "exact", {"block_size": 2})
    add("depth_to_space", [n(1, 8, 2, 3)], "exact", {"block_size": 2})
    # -- indexing: indices out of range on purpose -----------------------
    w = n(5, 3)
    idx = np.array([[0, 4, 7], [-1, -6, 2]], f32)
    add("take", [w, idx], "exact", {})
    add("take", [w, idx], "exact", {"mode": "wrap"}, tag="wrap")
    add("take", [n(3, 5), np.array([1, -2, 9], np.int32)], "exact",
        {"axis": 1}, tag="axis1")
    add("pick", [n(3, 4), np.array([0, 3, 5], f32)], "exact", {})
    add("pick", [n(3, 4), np.array([1, -1, 2, -9], f32)], "exact",
        {"axis": 0, "keepdims": True}, tag="axis0")
    add("batch_take", [n(4, 3), np.array([0, 2, 1, 5], np.int32)], "exact")
    add("Embedding", [idx, w], "exact", {"input_dim": 5, "output_dim": 3})
    add("one_hot", [np.array([0, 3, 5, -1], np.int32)], "exact",
        {"depth": 4})
    add("one_hot", [np.array([[1., 2.], [0., 9.]], f32)], "exact",
        {"depth": 3, "on_value": 2.0, "off_value": -1.0}, tag="values")
    add("gather_nd", [n(3, 4, 2), np.array([[0, 2, -1, 5], [1, 3, 0, 9]],
                                           np.int32)], "exact")
    add("scatter_nd", [n(4), np.array([[0, 2, 1, 7], [1, 3, -1, 0]],
                                      np.int32)], "exact", {"shape": (3, 4)})
    add("_scatter_set_nd", [n(3, 4), n(3, 4), np.array([[0, 2, 5]],
                                                      np.int32)],
        "exact", {"shape": (3, 4)})
    add("where", [np.array([[1, 0, 1, 0]] * 3, f32), a, n(3, 4)], "exact")
    seq = n(5, 3, 2)
    lens = np.array([2, 5, 1], f32)
    for name in ("SequenceMask", "SequenceLast", "SequenceReverse"):
        add(name, [seq, lens], "exact", {"use_sequence_length": True})
        add(name, [seq], "exact", {}, tag="full")
    add("SequenceMask", [np.swapaxes(seq, 0, 1).copy(), lens], "exact",
        {"use_sequence_length": True, "value": -1.0, "axis": 1},
        tag="axis1")
    # -- ordering --------------------------------------------------------
    o = n(3, 5)
    add("sort", [o], "exact", {})
    add("sort", [o], "exact", {"axis": 0, "is_ascend": False}, tag="desc")
    add("argsort", [o], "exact", {})
    add("argsort", [o], "exact", {"is_ascend": False, "dtype": "int32"},
        tag="desc")
    for ret in ("indices", "value", "both", "mask"):
        add("topk", [o], "exact", {"k": 2, "ret_typ": ret}, tag=ret)
    add("topk", [o], "exact", {"axis": 0, "k": 2, "is_ascend": True,
                               "ret_typ": "both"}, tag="ascend")
    for name in ("argmax", "argmin"):
        add(name, [o], "exact", {"axis": 1})
        add(name, [o], "exact", {}, tag="all")
        add(name, [o], "exact", {"axis": 0, "keepdims": True},
            tag="keepdims")
    add("argmax_channel", [o], "exact")
    # -- products, norm, index arithmetic ---------------------------------
    add("dot", [n(3, 5), n(5, 4)], "float")
    add("dot", [n(3, 5), n(4, 5)], "float", {"transpose_b": True},
        tag="transpose_b")
    add("dot", [n(5), n(5)], "float", tag="vector")
    add("dot", [n(2, 3, 5), n(5, 4)], "float", tag="3d")
    add("batch_dot", [n(2, 3, 5), n(2, 5, 4)], "float")
    add("batch_dot", [n(2, 5, 3), n(2, 5, 4)], "float",
        {"transpose_a": True}, tag="transpose_a")
    add("khatri_rao", [n(2, 3), n(4, 3)], "exact")
    add("diag", [n(4)], "exact", {"k": 1})
    add("diag", [n(3, 4)], "exact", {"k": -1}, tag="matrix")
    add("norm", [r], "float", {})
    add("norm", [r], "float", {"axis": 1, "keepdims": True}, tag="axis")
    add("norm", [r], "float", {"ord": 1, "axis": (0, 2)}, tag="l1")
    add("ravel_multi_index", [np.array([[1, 2, 0], [3, 0, 4]], f32)],
        "exact", {"shape": (3, 5)})
    add("unravel_index", [np.array([0, 7, 14], f32)], "exact",
        {"shape": (3, 5)})
    # -- nn ----------------------------------------------------------------
    add("InstanceNorm", [n(2, 3, 4, 5), u(0.5, 1.5, 3), n(3)], "float",
        {"eps": 1e-3})
    add("Dropout", [np.ones((1000, 1000), f32)], "random",
        {"p": 0.3, "training": True})
    add("shuffle", [np.arange(40, dtype=f32).reshape(10, 4)], "random")
    # -- samplers ----------------------------------------------------------
    scalar = {
        "_random_uniform": {"low": -1.0, "high": 3.0},
        "_random_normal": {"loc": 1.0, "scale": 2.0},
        "_random_gamma": {"alpha": 2.0, "beta": 1.5},
        "_random_exponential": {"lam": 2.0},
        "_random_poisson": {"lam": 3.0},
        "_random_negative_binomial": {"k": 3, "p": 0.4},
        "_random_generalized_negative_binomial": {"mu": 2.0, "alpha": 0.5},
        "_random_randint": {"low": -3, "high": 5},
        "_random_bernoulli": {"p": 0.3},
    }
    for name, params in scalar.items():
        add(name, [], "random", dict(params, shape=(draws,)))
    per_row = {"shape": (draws,)}
    add("_sample_uniform", [np.array([0., 1.], f32), np.array([1., 3.], f32)],
        "random", per_row)
    add("_sample_normal", [np.array([0., 3.], f32), np.array([1., .5], f32)],
        "random", per_row)
    add("_sample_gamma", [np.array([2., 3.], f32), np.array([1., 1.5], f32)],
        "random", per_row)
    add("_sample_multinomial", [np.array([[.2, .2, .6], [.25, .5, .25]],
                                         f32)], "random", per_row)
    out = []
    for c in cases:
        for name in (c["name"],) + _SWEEP_ALIASES.get(c["name"], ()):
            c2 = dict(c, name=name)
            c2["id"] = name + ("-" + c["tag"] if c["tag"] else "")
            out.append(c2)
    return out
