"""Test fixtures (port of ``mxnet_tpu/test_utils.py``, subset: the tiny
attention language model behind the paged-decode tests and its dense
greedy-decode oracle), and the op sweeps: one or more small cases for
every op name of the elementwise, reduce, tensor, random and Dropout /
InstanceNorm families (``op_sweep_cases``) and of the layer ops
(``layer_op_cases``: Deconvolution, LRN, the resizes, the softmax
variants, CTC and the ``*_v1`` spellings), of the detection ops
(``detection_op_cases``) and of the long tail and sparse storage
(``sparse_op_cases``), which the CPU tests run against the JAX package
and ``chip_smoke.py`` runs on the card against the CPU."""

from __future__ import annotations

import numpy as np
import torch

from .base import torch_dtype
from .serve.kvpool import as_device

__all__ = ["tiny_attention_lm", "dense_decode_reference", "op_sweep_cases",
           "layer_op_cases", "SAMPLER_MOMENTS", "moments_within",
           "detection_op_cases", "sparse_op_cases", "align_signs"]


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
    # the per-row samplers of ops/parity.py (sparse_op_cases)
    "_sample_exponential": ([1.0, 0.4], [1.0, 0.16]),
    "_sample_poisson": ([3.0, 7.5], [3.0, 7.5]),
    "_sample_negative_binomial": ([4.5, 10.0 / 3], [11.25, 50.0 / 9]),
    "_sample_generalized_negative_binomial": ([2.0, 4.0], [4.0, 8.0]),
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


# Deconvolution cases: (id, data shape, params, with bias).  1-d, 2-d and
# 3-d; groups; dilation; adj below the stride (torch's output_padding)
# and at or past it (the full transposed convolution, windowed), with pad
# 0 and pad > 0
DECONV_CASES = [
    ("1d-adj-ge-stride", (2, 4, 7),
     dict(kernel=(3,), stride=(3,), pad=(1,), adj=(4,), num_filter=5), True),
    ("2d-s2-p1", (2, 8, 5, 6),
     dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), num_filter=6), False),
    ("2d-adj-lt-stride", (2, 4, 5, 6),
     dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), adj=(1, 1),
          num_filter=3), True),
    ("2d-adj-ge-stride-pad0", (2, 4, 5, 6),
     dict(kernel=(3, 3), stride=(2, 2), adj=(2, 2), num_filter=6), False),
    ("2d-adj-ge-stride-pad1-groups", (2, 4, 5, 6),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(3, 2),
          num_group=2, num_filter=6), True),
    ("2d-dilate-groups", (2, 4, 5, 6),
     dict(kernel=(3, 2), stride=(1, 2), pad=(2, 0), adj=(0, 1),
          dilate=(2, 1), num_group=4, num_filter=8), True),
    ("3d-adj-ge-stride", (1, 2, 3, 4, 3),
     dict(kernel=(2, 3, 2), stride=(2, 1, 2), pad=(0, 1, 1), adj=(1, 0, 3),
          dilate=(1, 1, 2), num_filter=3), True),
    ("2d-wide", (2, 16, 6, 6),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
          num_filter=16), True),
]

# the CTC op's spellings, each given the cases of "CTCLoss"
CTC_NAMES = ("CTCLoss", "ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss")
# the deprecated spellings and the case each gets
V1_NAMES = ("BatchNorm_v1", "Convolution_v1", "Pooling_v1")


def layer_op_cases(seed=0):
    """The layer op sweep: dicts with ``name``, ``id``, ``inputs`` (numpy
    arrays), ``params`` and ``grads`` (the indices of the inputs that take
    gradients), one or more for each op name of ops/nn.py that the JAX
    package has and the op sweep lacks: Deconvolution (``DECONV_CASES``),
    LRN, UpSampling (nearest with one and two inputs, concat and sum;
    bilinear with its ignored weight), the contrib BilinearResize2D
    (shrink, enlarge, by scale), AdaptiveAvgPooling2D (divisible, not
    divisible, global) and div_sqrt_dim, softmin, SoftmaxActivation
    (instance and channel), softmax_cross_entropy, the CTC loss under its
    four names (both blank modes, with and without lengths, and an
    alignment that cannot exist) and the ``*_v1`` spellings."""
    rs = np.random.RandomState(seed)
    f32 = np.float32

    def n(*shape):
        return rs.standard_normal(shape).astype(f32)

    cases = []

    def add(name, inputs, params=None, grads=(0,), tag=""):
        cases.append({"name": name, "inputs": [np.asarray(a) for a in inputs],
                      "params": dict(params or {}), "grads": tuple(grads),
                      "id": name + ("-" + tag if tag else "")})

    for tag, shape, params, bias in DECONV_CASES:
        g = params.get("num_group", 1)
        w = (shape[1], params["num_filter"] // g) + params["kernel"]
        ins = [n(*shape), n(*w) / np.sqrt(np.prod(w[1:])).astype(f32)]
        if bias:
            ins.append(n(params["num_filter"]))
        add("Deconvolution", ins, dict(params, no_bias=not bias),
            grads=range(len(ins)), tag=tag)
    img = n(2, 5, 17, 23)
    add("LRN", [img])
    add("LRN", [img], dict(nsize=4, alpha=1e-2, beta=0.5, knorm=1.0),
        tag="nsize4")
    add("UpSampling", [img], dict(scale=2), tag="nearest")
    add("UpSampling", [img, n(2, 3, 17, 23)], dict(scale=3, num_args=2),
        grads=(0, 1), tag="nearest-concat")
    add("UpSampling", [img, n(2, 5, 17, 23)],
        dict(scale=2, num_args=2, multi_input_mode="sum"), grads=(0, 1),
        tag="nearest-sum")
    add("UpSampling", [img, n(5, 1, 4, 4)],
        dict(scale=2, sample_type="bilinear", num_args=2, num_filter=5),
        tag="bilinear")
    add("_contrib_BilinearResize2D", [img], dict(height=5, width=7),
        tag="shrink")
    add("_contrib_BilinearResize2D", [img], dict(height=40, width=31),
        tag="enlarge")
    add("_contrib_BilinearResize2D", [img],
        dict(scale_height=0.5, scale_width=1.5), tag="scale")
    add("_contrib_AdaptiveAvgPooling2D", [img], dict(output_size=(5, 7)),
        tag="resize")
    add("_contrib_AdaptiveAvgPooling2D", [img[:, :, :16, :20]],
        dict(output_size=(4, 5)), tag="divisible")
    add("_contrib_AdaptiveAvgPooling2D", [img], tag="global")
    add("_contrib_div_sqrt_dim", [img])
    add("softmin", [img], dict(axis=1))
    add("SoftmaxActivation", [img], tag="instance")
    add("SoftmaxActivation", [img], dict(mode="channel"), tag="channel")
    add("softmax_cross_entropy",
        [n(6, 10), rs.randint(0, 10, 6).astype(f32)])
    t, b, a = 12, 4, 6
    acts = n(t, b, a)
    labels = np.array([[1, 2, 3, 0], [2, 2, 0, 0], [1, 1, 1, 1],
                       [5, 4, 3, 2]], f32)
    data_len = np.array([12, 3, 7, 4], f32)
    label_len = np.array([3, 2, 4, 4], f32)
    # rows 0 and 2 cannot align: 2 frames for 3 labels, 6 for 4 labels
    # with 3 repeats; row 3's label 0 inside its length is the blank
    impossible = (np.array([2, 3, 6, 12], f32), np.array([3, 2, 4, 2], f32),
                  np.array([[1, 2, 3, 0], [2, 2, 0, 0], [1, 1, 1, 1],
                            [5, 0, 3, 2]], f32))
    for name in CTC_NAMES:
        add(name, [acts, labels], tag="first")
        add(name, [acts, labels - 1], dict(blank_label="last"), tag="last")
        add(name, [acts, labels, data_len, label_len],
            dict(use_data_lengths=True, use_label_lengths=True),
            tag="lengths")
        add(name, [acts, labels - 1, data_len],
            dict(use_data_lengths=True, blank_label="last"),
            tag="last-data-lengths")
        add(name, [acts, labels, label_len], dict(use_label_lengths=True),
            tag="label-lengths")
        add(name, [acts, impossible[2], impossible[0], impossible[1]],
            dict(use_data_lengths=True, use_label_lengths=True),
            tag="impossible")
    add("BatchNorm_v1", [n(4, 3, 5, 5), n(3), n(3), n(3),
                         rs.uniform(0.5, 2.0, 3).astype(f32)],
        dict(fix_gamma=False), grads=(0, 1, 2))
    add("Convolution_v1", [n(2, 4, 9, 8), n(6, 4, 3, 3) / f32(6), n(6)],
        dict(kernel=(3, 3), stride=(1, 2), pad=(1, 0), num_filter=6),
        grads=(0, 1, 2))
    add("Pooling_v1", [n(2, 3, 9, 9)],
        dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
             pooling_convention="full"))
    return cases


# ---------------------------------------------------------------------------
# detection and spatial op cases
# ---------------------------------------------------------------------------

DETECTION_NAMES = (
    "_contrib_MultiBoxPrior", "MultiBoxPrior", "_contrib_MultiBoxTarget",
    "MultiBoxTarget", "_contrib_MultiBoxDetection", "MultiBoxDetection",
    "_contrib_box_iou", "box_iou", "_contrib_box_nms", "box_nms",
    "_contrib_box_non_maximum_suppression", "_contrib_ROIAlign", "ROIAlign",
    "_contrib_Proposal", "Proposal", "_contrib_MultiProposal",
    "MultiProposal")
SPATIAL_NAMES = (
    "BilinearSampler", "GridGenerator", "SpatialTransformer", "Correlation",
    "_contrib_DeformableConvolution", "DeformableConvolution",
    "_contrib_PSROIPooling", "PSROIPooling", "_contrib_SyncBatchNorm",
    "SyncBatchNorm", "_contrib_fft", "fft", "_contrib_ifft", "ifft",
    "_contrib_count_sketch", "count_sketch", "_contrib_quadratic",
    "quadratic", "_contrib_index_copy")


def _np_iou(a, b):
    """IoU of corner boxes a (N, 4) against b (M, 4) in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    iw = np.maximum(0.0, np.minimum(a[:, None, 2], b[None, :, 2]) -
                    np.maximum(a[:, None, 0], b[None, :, 0]))
    ih = np.maximum(0.0, np.minimum(a[:, None, 3], b[None, :, 3]) -
                    np.maximum(a[:, None, 1], b[None, :, 1]))
    inter = iw * ih
    area_a = np.maximum(0.0, a[:, 2] - a[:, 0]) * \
        np.maximum(0.0, a[:, 3] - a[:, 1])
    area_b = np.maximum(0.0, b[:, 2] - b[:, 0]) * \
        np.maximum(0.0, b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def _gaps(values):
    """The smallest gap between two different values (inf if none)."""
    v = np.unique(np.asarray(values, np.float64).ravel())
    return float(np.diff(v).min()) if v.size > 1 else np.inf


def nms_margin(boxes, scores, valid, thresh, topk=-1, ids=None,
               force=True):
    """How near greedy NMS's decisions sit to a flip, in float64: the
    smallest |IoU - thresh| over pairs of valid boxes among the top-k.
    boxes (B, N, 4) corner, scores and valid (B, N)."""
    worst = np.inf
    for b in range(boxes.shape[0]):
        order = np.argsort(-np.asarray(scores[b], np.float64),
                           kind="stable")
        k = len(order) if topk <= 0 else min(len(order), topk)
        top = order[:k][np.asarray(valid[b])[order[:k]]]
        if top.size < 2:
            continue
        iou = _np_iou(boxes[b][top], boxes[b][top])
        pair = ~np.eye(top.size, dtype=bool)
        if ids is not None and not force:
            pair &= ids[b][top][:, None] == ids[b][top][None, :]
        if pair.any():
            worst = min(worst, float(np.abs(iou[pair] - thresh).min()))
    return worst


def target_margin(anchor, label, cls_pred, overlap_threshold=0.5,
                  negative_mining_ratio=-1.0, negative_mining_thresh=0.5,
                  **_):
    """The same for MultiBoxTarget, its matching replayed in float64: the
    smallest gap between the best and the next IoU of each bipartite
    round and of each anchor's best label, |best IoU - threshold| and,
    when mining, |best IoU - mining threshold| and the gap between two
    background probabilities."""
    anchors = anchor.reshape(-1, 4)
    worst = np.inf
    for n in range(label.shape[0]):
        lbl = label[n][label[n, :, 0] != -1]
        if not lbl.size:
            continue
        iou = _np_iou(anchors, lbl[:, 1:5])
        used = iou.copy()
        for _ in range(lbl.shape[0]):
            flat = np.sort(used.ravel())[::-1]
            if flat[0] <= 1e-6:
                break
            worst = min(worst, flat[0] - flat[1])
            i, j = np.unravel_index(np.argmax(used), used.shape)
            used[i, :] = -1.0
            used[:, j] = -1.0
        if iou.shape[1] > 1:
            top2 = np.sort(iou, 1)[:, -2:]
            live = top2[:, 1] > overlap_threshold
            if live.any():
                worst = min(worst, float((top2[live, 1] -
                                          top2[live, 0]).min()))
        best = iou.max(1)
        worst = min(worst, float(np.abs(best - overlap_threshold).min()))
        if negative_mining_ratio > 0:
            z = cls_pred[n].astype(np.float64)
            p0 = np.exp(z[0] - z.max(0)) / np.exp(z - z.max(0)).sum(0)
            worst = min(worst, _gaps(p0), float(np.abs(
                best - negative_mining_thresh).min()))
    return float(worst)


def _decode(loc, anchors, var=(0.1, 0.1, 0.2, 0.2), clip=True):
    a = anchors.reshape(-1, 4).astype(np.float64)
    aw, ah = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
    ax, ay = (a[:, 0] + a[:, 2]) / 2, (a[:, 1] + a[:, 3]) / 2
    loc = loc.reshape(loc.shape[0], -1, 4).astype(np.float64)
    px = loc[..., 0] * var[0] * aw + ax
    py = loc[..., 1] * var[1] * ah + ay
    pw = np.exp(loc[..., 2] * var[2]) * aw / 2
    ph = np.exp(loc[..., 3] * var[3]) * ah / 2
    out = np.stack([px - pw, py - ph, px + pw, py + ph], -1)
    return np.clip(out, 0.0, 1.0) if clip else out


def detection_op_cases(seed=0):
    """The detection and spatial op sweep, in layer_op_cases' format
    (``name``, ``id``, ``inputs``, ``params``, ``grads``), over the 37
    names of ops/detection.py, ROIPooling and ops/spatial.py, each with at
    least one case.  A case whose outputs rest on discrete decisions
    (matching, suppression, sorting) also has ``exact``, [(output index,
    columns or None)] that must agree bit for bit, and ``margin``: how far
    (in float64) its decision quantities lie from a flip, so that a
    difference between two devices can be told from a fault."""
    rs = np.random.RandomState(seed)
    f32 = np.float32

    def n(*shape):
        return rs.standard_normal(shape).astype(f32)

    def u(lo, hi, *shape):
        return rs.uniform(lo, hi, shape).astype(f32)

    cases = []

    def add(name, inputs, params=None, grads=(0,), tag="", exact=None,
            margin=None):
        case = {"name": name, "inputs": [np.asarray(a) for a in inputs],
                "params": dict(params or {}), "grads": tuple(grads),
                "id": name + ("-" + tag if tag else "")}
        if exact is not None:
            case["exact"] = list(exact)
            case["margin"] = float(margin)
        cases.append(case)

    def boxes(*lead, lo=0.0, hi=1.0, size=(0.05, 0.4)):
        c = u(lo, hi, *lead, 2)
        wh = u(size[0], size[1], *lead, 2)
        return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(f32)

    # MultiBoxPrior: shape only (the data's gradient is zero)
    add("_contrib_MultiBoxPrior", [n(2, 3, 5, 7)],
        dict(sizes=(0.5, 0.3), ratios=(1.0, 2.0, 0.5)))
    add("MultiBoxPrior", [n(1, 4, 38, 38)],
        dict(sizes=(0.1, 0.141), ratios=(1.0, 2.0, 0.5), clip=True),
        tag="ssd-scale0")
    add("MultiBoxPrior", [n(1, 2, 3, 4)],
        dict(sizes=(0.7,), ratios=(1.0, 3.0), steps=(0.3, 0.2),
             offsets=(0.2, 0.7), clip=True), tag="steps")

    # MultiBoxTarget over a prior grid
    grid = np.concatenate([
        _np_prior(6, 6, (0.2, 0.3), (1.0, 2.0, 0.5)),
        _np_prior(3, 3, (0.5, 0.6), (1.0, 2.0))], axis=1)
    # jittered, so that no two anchors tie in area by construction
    grid = (grid + rs.uniform(-0.01, 0.01, grid.shape)).astype(f32)
    A = grid.shape[1]
    label = np.full((3, 4, 5), -1.0, f32)
    for i, k in enumerate((1, 3, 4)):
        label[i, :k, 0] = rs.randint(0, 3, k)
        label[i, :k, 1:] = boxes(k, lo=0.2, hi=0.8, size=(0.15, 0.5))
    cls = n(3, 4, A)
    for name, tag, params in (
            ("_contrib_MultiBoxTarget", "", {}),
            ("MultiBoxTarget", "mining", dict(negative_mining_ratio=3.0,
                                              negative_mining_thresh=0.5,
                                              minimum_negative_samples=2)),
            ("MultiBoxTarget", "thresh", dict(overlap_threshold=0.3,
                                              ignore_label=-2.0,
                                              variances=(0.2, 0.2, 0.1,
                                                         0.1)))):
        add(name, [grid, label, cls], params, grads=(0, 1), tag=tag,
            exact=[(1, None), (2, None)],
            margin=target_margin(grid, label, cls, **params))

    # box_iou
    add("_contrib_box_iou", [boxes(2, 3), boxes(5)], grads=(0, 1))
    add("box_iou", [u(0.2, 0.8, 4, 4), u(0.2, 0.8, 3, 2, 4)],
        dict(format="center"), grads=(0, 1), tag="center")

    # box_nms: [id, score, l, t, r, b] rows
    def nms_rows(b, k, ids=3):
        r = np.zeros((b, k, 6), f32)
        r[..., 0] = rs.randint(0, ids, (b, k))
        r[..., 1] = u(0.0, 1.0, b, k)
        r[..., 2:] = boxes(b, k, lo=0.3, hi=0.7, size=(0.1, 0.5))
        return r
    r = nms_rows(2, 24)
    add("_contrib_box_nms", [r], dict(overlap_thresh=0.5,
                                      force_suppress=True),
        tag="force", exact=[(0, [1])],
        margin=nms_margin(r[..., 2:], r[..., 1], r[..., 1] > 0, 0.5))
    r = nms_rows(3, 20)
    add("box_nms", [r], dict(overlap_thresh=0.4, valid_thresh=0.3, topk=8,
                             id_index=0), tag="per-class-topk",
        exact=[(0, [0, 1])],
        margin=min(nms_margin(r[..., 2:], r[..., 1], r[..., 1] > 0.3, 0.4,
                              8, r[..., 0], False),
                   float(np.abs(r[..., 1] - 0.3).min())))
    r = nms_rows(2, 16)
    rc = r.copy()
    rc[..., 2:4] = (r[..., 2:4] + r[..., 4:6]) / 2
    rc[..., 4:6] = r[..., 4:6] - r[..., 2:4]
    add("_contrib_box_non_maximum_suppression", [rc],
        dict(overlap_thresh=0.5, topk=50, in_format="center",
             out_format="corner"), tag="center-topk-past-n",
        exact=[(0, [1])],
        margin=nms_margin(r[..., 2:], r[..., 1], r[..., 1] > 0, 0.5, 50))

    # MultiBoxDetection: softmax probabilities over 4 classes
    def probs(*shape):
        z = n(*shape) * 2.0
        e = np.exp(z - z.max(1, keepdims=True))
        return (e / e.sum(1, keepdims=True)).astype(f32)
    cp, lp = probs(2, 4, A), n(2, A * 4) * f32(0.5)
    dec = _decode(lp, grid)
    sc = cp[:, 1:].max(1)
    ids = cp[:, 1:].argmax(1)
    add("_contrib_MultiBoxDetection", [cp, lp, grid], grads=(0, 1, 2),
        exact=[(0, [0, 1])],
        margin=min(nms_margin(dec, sc, sc > 0.01, 0.5, -1, ids, False),
                   float(np.abs(sc - 0.01).min())))
    cp, lp = probs(2, 4, A), n(2, A * 4) * f32(0.5)
    dec = _decode(lp, grid, clip=False)
    sc = cp[:, 1:].max(1)
    add("MultiBoxDetection", [cp, lp, grid],
        dict(nms_topk=20, force_suppress=True, threshold=0.3, clip=False,
             nms_threshold=0.45), grads=(0, 1, 2), tag="topk-force",
        exact=[(0, [0, 1])],
        margin=min(nms_margin(dec, sc, sc > 0.3, 0.45, 20),
                   float(np.abs(sc - 0.3).min())))

    # ROIAlign, ROIPooling: rois [batch_idx, x1, y1, x2, y2] in pixels
    def rois(r, nb, h, w):
        x = np.sort(u(-1.0, w + 1.0, r, 2), 1)
        y = np.sort(u(-1.0, h + 1.0, r, 2), 1)
        b = rs.randint(0, nb, (r, 1)).astype(f32)
        return np.concatenate([b, x[:, :1], y[:, :1], x[:, 1:], y[:, 1:]],
                              1).astype(f32)
    add("_contrib_ROIAlign", [n(2, 3, 8, 9), rois(4, 2, 16, 18)],
        dict(pooled_size=(2, 3), spatial_scale=0.5, sample_ratio=2),
        grads=(0, 1))
    add("ROIAlign", [n(2, 3, 8, 9), rois(3, 2, 8, 9)],
        dict(pooled_size=(3, 3)), grads=(0, 1), tag="sr-default")
    add("ROIPooling", [n(2, 3, 10, 12), rois(4, 2, 20, 24)],
        dict(pooled_size=(3, 2), spatial_scale=0.5))

    # Proposal and its batched names
    def rpn(nb, na, h, w):
        return (u(0.0, 1.0, nb, 2 * na, h, w), n(nb, 4 * na, h, w) *
                f32(0.1), np.tile(np.array([[64, 64, 1.0]], f32), (nb, 1)))
    for name, tag, nb, params in (
            ("_contrib_Proposal", "", 1, {}),
            ("Proposal", "scores", 2, dict(output_score=True)),
            ("_contrib_MultiProposal", "", 2, dict(rpn_pre_nms_top_n=20)),
            ("MultiProposal", "scores", 2, dict(output_score=True,
                                                threshold=0.5))):
        c, b, info = rpn(nb, 3, 4, 4)
        params = dict(dict(rpn_post_nms_top_n=10, scales=(2,),
                           ratios=(0.5, 1, 2), feature_stride=16,
                           rpn_min_size=4), **params)
        add(name, [c, b, info], params, grads=(0, 1), tag=tag,
            exact=[(1, None)] if params.get("output_score") else [],
            margin=_proposal_margin(c, b, info, params))

    # spatial
    add("BilinearSampler", [n(2, 3, 5, 6), u(-1.1, 1.1, 2, 2, 4, 7)],
        grads=(0, 1))
    add("GridGenerator", [n(2, 6)], dict(target_shape=(5, 7)), tag="affine")
    add("GridGenerator", [n(2, 2, 4, 5)], dict(transform_type="warp"),
        tag="warp")
    theta = np.tile(np.array([[0.8, 0.1, 0.05, -0.1, 0.9, 0.02]], f32),
                    (2, 1)) + n(2, 6) * f32(0.05)
    add("SpatialTransformer", [n(2, 3, 8, 8), theta],
        dict(target_shape=(6, 5)), grads=(0, 1))
    add("Correlation", [n(2, 4, 7, 8), n(2, 4, 7, 8)],
        dict(max_displacement=2, pad_size=2), grads=(0, 1))
    add("Correlation", [n(2, 3, 9, 9), n(2, 3, 9, 9)],
        dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2,
             pad_size=3, is_multiply=False), grads=(0, 1), tag="abs-k3")
    x = n(2, 4, 7, 7)
    add("_contrib_DeformableConvolution",
        [x, n(2, 2 * 9 * 2, 7, 7) * f32(0.7), n(6, 2, 3, 3) / f32(4), n(6)],
        dict(kernel=(3, 3), pad=(1, 1), num_filter=6, num_group=2,
             num_deformable_group=2), grads=(0, 1, 2, 3), tag="groups")
    add("DeformableConvolution",
        [n(2, 3, 9, 9), n(2, 18, 5, 5) * f32(0.7), n(4, 3, 3, 3) / f32(5)],
        dict(kernel=(3, 3), stride=(2, 2), pad=(2, 2), dilate=(2, 2),
             num_filter=4, no_bias=True), grads=(0, 1, 2),
        tag="strided-dilated")
    add("DeformableConvolution",
        [n(2, 16, 14, 14), n(2, 18, 14, 14) * f32(0.7),
         n(32, 16, 3, 3) / f32(12), n(32)],
        dict(kernel=(3, 3), pad=(1, 1), num_filter=32), grads=(0, 1, 2, 3),
        tag="wide")
    feat = n(2, 8, 6, 6)
    add("_contrib_PSROIPooling", [feat, rois(3, 2, 6, 6)],
        dict(output_dim=2, pooled_size=2, group_size=2))
    add("PSROIPooling", [n(2, 9, 8, 8), rois(3, 2, 16, 16)],
        dict(output_dim=1, pooled_size=3, spatial_scale=0.5), tag="k3")
    bn = [n(4, 3, 5, 5), u(0.5, 1.5, 3), n(3), n(3),
          u(0.5, 2.0, 3)]
    add("_contrib_SyncBatchNorm", bn, dict(fix_gamma=False),
        grads=(0, 1, 2))
    add("SyncBatchNorm", bn, dict(fix_gamma=False, use_global_stats=True),
        grads=(0, 1, 2), tag="global-stats")
    add("_contrib_fft", [n(3, 8)])
    add("fft", [n(2, 3, 5)], tag="odd")
    add("_contrib_ifft", [n(3, 16)])
    add("ifft", [n(2, 2, 10)], tag="3d")
    add("_contrib_count_sketch",
        [n(2, 6), np.array([0, 2, 1, 2, 0, 1], f32),
         np.array([1, -1, 1, 1, -1, 1], f32)], dict(out_dim=3),
        grads=(0, 2))
    add("count_sketch", [n(3, 4, 10), rs.randint(0, 5, 10).astype(f32),
                         rs.choice([-1.0, 1.0], 10).astype(f32)],
        dict(out_dim=5), grads=(0, 2), tag="3d")
    add("_contrib_quadratic", [n(3, 4)], dict(a=0.5, b=-2.0, c=1.5))
    add("quadratic", [n(2, 5)], dict(a=-1.0, c=3.0), tag="no-b")
    add("_contrib_index_copy", [n(5, 3), np.array([-1, 7, 2], f32),
                                n(3, 3)], grads=(0, 2))
    return cases


def _np_prior(h, w, sizes, ratios):
    """MultiBoxPrior's anchors (1, h*w*A, 4) in numpy (clip off)."""
    cy = (np.arange(h) + 0.5) / h
    cx = (np.arange(w) + 0.5) / w
    ws = [s * h / w / 2 for s in sizes]
    hs = [s / 2 for s in sizes]
    for r in ratios[1:]:
        ws.append(sizes[0] * h / w * np.sqrt(r) / 2)
        hs.append(sizes[0] / np.sqrt(r) / 2)
    ws, hs = np.array(ws), np.array(hs)
    cxg = np.broadcast_to(cx[None, :, None], (h, w, ws.size))
    cyg = np.broadcast_to(cy[:, None, None], (h, w, ws.size))
    return np.stack([cxg - ws, cyg - hs, cxg + ws, cyg + hs],
                    -1).reshape(1, -1, 4)


def _proposal_margin(cls_prob, bbox_pred, im_info, params):
    """nms_margin of Proposal's decoded boxes (float64), and how near a
    box side sits to the minimum size."""
    nb, na2, h, w = cls_prob.shape
    na = na2 // 2
    base, worst = params["feature_stride"], np.inf
    ws, hs = [], []
    for r in params["ratios"]:
        w0 = round((base * base / r) ** 0.5)
        for s in params["scales"]:
            ws.append(w0 * s)
            hs.append(round(w0 * r) * s)
    ws, hs = np.array(ws, np.float64), np.array(hs, np.float64)
    cx = (base - 1) / 2.0
    acx = cx + np.arange(w)[None, :, None] * base
    acy = cx + np.arange(h)[:, None, None] * base
    anc = np.stack([np.broadcast_to(acx - (ws - 1) / 2, (h, w, na)),
                    np.broadcast_to(acy - (hs - 1) / 2, (h, w, na)),
                    np.broadcast_to(acx + (ws - 1) / 2, (h, w, na)),
                    np.broadcast_to(acy + (hs - 1) / 2, (h, w, na))],
                   -1).reshape(-1, 4)
    aw, ah = anc[:, 2] - anc[:, 0] + 1, anc[:, 3] - anc[:, 1] + 1
    ax, ay = anc[:, 0] + 0.5 * (aw - 1), anc[:, 1] + 0.5 * (ah - 1)
    thresh = params.get("threshold", 0.7)
    topk = params.get("rpn_pre_nms_top_n", 6000)
    for i in range(nb):
        sc = cls_prob[i, na:].transpose(1, 2, 0).reshape(-1)
        d = bbox_pred[i].reshape(na, 4, h, w).transpose(2, 3, 0, 1) \
            .reshape(-1, 4).astype(np.float64)
        px, py = d[:, 0] * aw + ax, d[:, 1] * ah + ay
        pw, ph = np.exp(d[:, 2]) * aw, np.exp(d[:, 3]) * ah
        bx = np.stack([px - 0.5 * (pw - 1), py - 0.5 * (ph - 1),
                       px + 0.5 * (pw - 1), py + 0.5 * (ph - 1)], -1)
        bx[:, 0::2] = np.clip(bx[:, 0::2], 0, im_info[i, 1] - 1)
        bx[:, 1::2] = np.clip(bx[:, 1::2], 0, im_info[i, 0] - 1)
        sides = np.stack([bx[:, 2] - bx[:, 0] + 1, bx[:, 3] - bx[:, 1] + 1])
        min_size = params["rpn_min_size"] * im_info[i, 2]
        worst = min(worst, float(np.abs(sides - min_size).min()))
        ok = (sides >= min_size).all(0)
        worst = min(worst, nms_margin(bx[None], sc[None], ok[None], thresh,
                                      topk))
    return worst


# ---------------------------------------------------------------------------
# the long tail and sparse storage
# ---------------------------------------------------------------------------

# the op names sparse_op_cases covers: ops/parity.py's, the linalg ops,
# histogram, the SparseEmbedding alias and Custom
SPARSE_SLICE_NAMES = (
    "hard_sigmoid", "shape_array", "size_array", "_zeros_without_dtype",
    "_identity_with_attr_like_rhs", "_scatter_minus_scalar",
    "_scatter_elemwise_div", "_slice_assign", "_crop_assign",
    "_slice_assign_scalar", "_crop_assign_scalar", "Crop", "SVMOutput",
    "IdentityAttachKLSparseReg", "_sample_exponential", "_sample_poisson",
    "_sample_negative_binomial", "_sample_generalized_negative_binomial",
    "_contrib_group_adagrad_update", "_contrib_bipartite_matching",
    "_contrib_DeformablePSROIPooling", "cast_storage", "_sparse_retain",
    "_square_sum", "_contrib_SparseEmbedding", "histogram", "_histogram",
    "Custom") + tuple(
        p + "linalg_" + k for k in ("gemm", "gemm2", "potrf", "potri",
                                    "trmm", "trsm", "syrk", "sumlogdiag",
                                    "syevd", "gelqf") for p in ("_", ""))


def align_signs(got, want, axis):
    """*got* with each vector along *axis* (-1: rows, -2: columns) given
    the sign that best matches *want*'s (eigenvectors and LQ factors are
    signed differently by different solvers); also the signs (+1/-1)."""
    dims = -1 if axis == -1 else -2
    dot = (got * want).sum(dim=dims, keepdim=True)
    sign = torch.where(dot < 0, -1.0, 1.0).to(got.dtype)
    return got * sign, sign


def _register_case_op():
    """The Custom op of the sweep: y = x^2 with its own backward."""
    from . import operator as op_mod

    @op_mod.register("test_utils_sqr")
    class _SqrProp(op_mod.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class _Sqr(op_mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                2 * in_data[0] * out_grad[0])
            return _Sqr()

    return "test_utils_sqr"


def sparse_op_cases(seed=0, draws=20000):
    """The long-tail and sparse sweep.  Each case is a dict with ``id`` and
    ``kind``:

    - "op": ``name``, ``inputs`` (numpy), ``params``, ``grads`` (indices of
      the inputs whose gradients are held), optional ``exact`` (output
      indices that must agree bit for bit) and ``signs`` ({output: axis}
      for eigenvectors and LQ factors, held after ``align_signs`` with
      the linked outputs in ``sign_links``);
    - "sample": a per-row sampler, ``name``, ``inputs``, ``params``; its
      draws are held by ``SAMPLER_MOMENTS`` within 4 standard errors;
    - "call": ``run(mx, ctx)`` -> a list of tensors: a function of
      ``nd.sparse``, a lazy row update, the executor's CSR and
      sparse-gradient paths or a ``subgraph.partition_graph`` round trip,
      with optional ``exact``.

    Every name of ``SPARSE_SLICE_NAMES`` has at least one case."""
    rs = np.random.RandomState(seed)
    f32 = np.float32

    def n(*shape):
        return rs.standard_normal(shape).astype(f32)

    def u(lo, hi, *shape):
        return rs.uniform(lo, hi, shape).astype(f32)

    cases = []

    def add(name, inputs, params=None, grads=(0,), tag="", **extra):
        case = {"kind": "op", "name": name,
                "inputs": [np.asarray(a) for a in inputs],
                "params": dict(params or {}), "grads": tuple(grads),
                "id": name + ("-" + tag if tag else "")}
        case.update(extra)
        cases.append(case)

    # elementwise long tail
    add("hard_sigmoid", [3 * n(4, 5)])
    add("hard_sigmoid", [n(6)], dict(alpha=0.5, beta=0.25), tag="ab")
    add("shape_array", [n(2, 3, 4)], grads=(), exact=[0])
    add("size_array", [n(2, 3, 4)], grads=(), exact=[0])
    add("_zeros_without_dtype", [], dict(shape=(2, 3)), grads=(),
        exact=[0])
    add("_identity_with_attr_like_rhs", [n(3, 4), n(3, 4)], grads=(0, 1))
    add("_scatter_minus_scalar", [n(3, 4)], dict(scalar=0.5))
    add("_scatter_elemwise_div", [n(3, 4), u(0.5, 2.0, 3, 4)],
        grads=(0, 1))
    # slice assignment
    add("_slice_assign", [n(4, 5), n(2, 3)], dict(begin=(1, 1), end=(3, 4)),
        grads=(0, 1))
    add("_crop_assign", [n(4, 5), n(2, 3)],
        dict(begin=(0, 1), end=(4, 4), step=(2, 1)), grads=(0, 1))
    add("_slice_assign_scalar", [n(4, 5)],
        dict(scalar=2.0, begin=(1,), end=(3,)))
    add("_crop_assign_scalar", [n(3, 4, 5)],
        dict(scalar=-1.0, begin=(0, 1), end=(2, None)))
    # Crop, SVMOutput, IdentityAttachKLSparseReg
    add("Crop", [n(2, 3, 8, 9)], dict(h_w=(4, 5), offset=(1, 2)))
    add("Crop", [n(2, 3, 8, 9), n(2, 1, 5, 4)],
        dict(center_crop=True, num_args=2), tag="like")
    label = rs.randint(0, 5, 6).astype(f32)
    add("SVMOutput", [n(6, 5), label], dict(margin=1.0))
    add("SVMOutput", [n(6, 5), label],
        dict(margin=0.5, regularization_coefficient=2.0, use_linear=True),
        tag="linear")
    add("IdentityAttachKLSparseReg", [u(0.05, 0.95, 8, 6)],
        dict(sparseness_target=0.2, penalty=0.01))
    # per-row samplers
    for name, ins in (
            ("_sample_exponential", [np.array([1.0, 2.5], f32)]),
            ("_sample_poisson", [np.array([3.0, 7.5], f32)]),
            ("_sample_negative_binomial", [np.array([3.0, 5.0], f32),
                                           np.array([0.4, 0.6], f32)]),
            ("_sample_generalized_negative_binomial",
             [np.array([2.0, 4.0], f32), np.array([0.5, 0.25], f32)])):
        cases.append({"kind": "sample", "name": name, "id": name,
                      "inputs": ins, "params": {"shape": (draws,)},
                      "grads": ()})
    # group adagrad (weight and history written in place)
    add("_contrib_group_adagrad_update",
        [n(6, 4), n(6, 4), u(0.0, 1.0, 6)],
        dict(lr=0.1, rescale_grad=0.5, clip_gradient=1.0), grads=())
    # bipartite matching: distinct scores, so no tie decides
    sc = rs.permutation(40).reshape(2, 5, 4).astype(f32) / 40
    add("_contrib_bipartite_matching", [sc], dict(threshold=0.1), grads=(),
        exact=[0, 1])
    add("_contrib_bipartite_matching", [sc],
        dict(is_ascend=True, threshold=0.8, topk=3), grads=(), exact=[0, 1],
        tag="ascend")
    # deformable PSROI pooling
    od, g, k = 2, 2, 3
    rois = np.array([[0, 1.3, 2.2, 9.6, 8.4], [1, 0.0, 0.5, 5.2, 11.0],
                     [0, 4.0, 3.0, 7.0, 6.0]], f32)
    add("_contrib_DeformablePSROIPooling",
        [n(2, od * g * g, 12, 12), rois, 0.5 * n(3, 2, k, k)],
        dict(spatial_scale=1.0, output_dim=od, group_size=g,
             pooled_size=k, part_size=k, sample_per_part=2, trans_std=0.1),
        grads=(0, 2))
    # graph-level sparse ops on dense values
    add("cast_storage", [n(3, 4)], dict(stype="default"))
    add("_sparse_retain", [n(6, 3), np.array([1, 4, 4, 9], f32)])
    add("_square_sum", [n(5, 4)], dict(axis=1, keepdims=True))
    add("_square_sum", [n(3, 4)], tag="all")
    add("_contrib_SparseEmbedding",
        [rs.randint(0, 10, (3, 4)).astype(f32), n(10, 5)],
        dict(input_dim=10, output_dim=5, sparse_grad=True), grads=(1,))
    # linalg, both spellings
    spd = n(2, 4, 4)
    spd = (spd @ spd.transpose(0, 2, 1) + 4 * np.eye(4, dtype=f32)).astype(f32)
    low = np.linalg.cholesky(spd.astype(np.float64)).astype(f32)
    tri = (np.tril(n(2, 4, 4)) + 3 * np.eye(4, dtype=f32)).astype(f32)
    sym = n(4, 4)
    sym = (sym + sym.T + np.diag([-6.0, -2.0, 2.0, 6.0])).astype(f32)
    add("_linalg_gemm", [n(2, 3, 4), n(2, 4, 5), n(2, 3, 5)],
        dict(alpha=0.5, beta=2.0), grads=(0, 1, 2))
    add("linalg_gemm", [n(4, 3), n(5, 4), n(3, 5)],
        dict(transpose_a=True, transpose_b=True), grads=(0, 1, 2))
    add("_linalg_gemm2", [n(2, 3, 4), n(2, 4, 5)], dict(alpha=2.0),
        grads=(0, 1))
    add("linalg_gemm2", [n(64, 48), n(96, 48)], dict(transpose_b=True),
        grads=(0, 1), tag="wide")
    add("_linalg_potrf", [spd])
    add("linalg_potrf", [spd[0]])
    add("_linalg_potri", [low])
    add("linalg_potri", [low[1]])
    add("_linalg_trmm", [tri, n(2, 4, 3)], dict(alpha=1.5), grads=(0, 1))
    add("linalg_trmm", [tri[0], n(3, 4)],
        dict(rightside=True, transpose=True), grads=(0, 1))
    add("_linalg_trsm", [tri, n(2, 4, 3)], dict(alpha=0.5), grads=(0, 1))
    add("linalg_trsm", [np.swapaxes(tri[1], 0, 1).copy(), n(3, 4)],
        dict(rightside=True, lower=False, transpose=True), grads=(0, 1))
    add("_linalg_syrk", [n(2, 3, 5)], dict(alpha=0.5))
    add("linalg_syrk", [n(64, 96)], dict(transpose=True), tag="wide")
    add("_linalg_sumlogdiag", [spd])
    add("linalg_sumlogdiag", [spd[1]])
    add("_linalg_syevd", [sym], grads=(), signs={0: -1})
    add("linalg_syevd", [sym[None]], grads=(), signs={0: -1})
    lq = n(3, 5)
    add("_linalg_gelqf", [lq], grads=(), signs={0: -1, 1: -2},
        sign_links={1: 0})
    add("linalg_gelqf", [n(2, 2, 4)], grads=(), signs={0: -1, 1: -2},
        sign_links={1: 0})
    # histogram: data on the edges
    edges = np.array([0, 1, 2, 3, 4, 5, 0.5, 2.5, 5, 5, -1, 6, 1.0],
                     f32).reshape(13)
    add("histogram", [edges], dict(bin_cnt=5, range=(0, 5)), grads=(),
        exact=[0, 1])
    add("_histogram", [np.array([0.0, 0.25, 0.5, 0.75, 1.0, 0.125, 0.5],
                                f32)], dict(bin_cnt=4), grads=(),
        exact=[0, 1])
    # Custom
    add("Custom", [n(3, 4)], dict(op_type=_register_case_op()))

    cases += _sparse_call_cases(rs)
    return cases


def _sparse_call_cases(rs):
    """The "call" cases of sparse_op_cases."""
    f32 = np.float32
    dense = rs.standard_normal((6, 8)).astype(f32)
    dense[rs.rand(6, 8) > 0.3] = 0
    rhs = rs.standard_normal((8, 3)).astype(f32)
    rhs_t = rs.standard_normal((6, 3)).astype(f32)
    w0 = rs.standard_normal((10, 4)).astype(f32)
    g_rows = rs.standard_normal((3, 4)).astype(f32)
    hist0 = rs.uniform(0.1, 1.0, (10, 4)).astype(f32)
    ids = np.array([[3, 1, 3], [7, 1, 1]], f32)
    uniq = np.array([[2, 5, 0], [9, 4, 6]], f32)
    emb_w = rs.standard_normal((10, 4)).astype(f32)
    fc_w = rs.standard_normal((5, 6)).astype(f32)
    x_part = rs.standard_normal((4, 6)).astype(f32)
    cases = []

    def call(tag, run, exact=()):
        cases.append({"kind": "call", "id": "sparse." + tag, "run": run,
                      "exact": list(exact)})

    def sp_of(mx):
        return mx.nd.sparse

    def csr(mx, ctx):
        return sp_of(mx).csr_matrix(dense, shape=dense.shape, ctx=ctx)

    def rsp(mx, ctx):
        return sp_of(mx).row_sparse_array((g_rows, [1, 4, 8]),
                                          shape=(10, 4), ctx=ctx)

    call("dot", lambda mx, ctx: [sp_of(mx).dot(
        csr(mx, ctx), mx.nd.array(rhs, ctx=ctx))._data])
    call("dot-transpose", lambda mx, ctx: [sp_of(mx).dot(
        csr(mx, ctx), mx.nd.array(rhs_t, ctx=ctx), transpose_a=True)._data])
    call("csr-todense-slice", lambda mx, ctx: [
        csr(mx, ctx).todense()._data, csr(mx, ctx)[2:5].todense()._data,
        csr(mx, ctx)[2:5].indptr._data], exact=(0, 1, 2))
    call("cast-storage", lambda mx, ctx: [
        t._data for t in (lambda c: (c.data, c.indices, c.indptr))(
            mx.nd.array(dense, ctx=ctx).tostype("csr"))] + [
        mx.nd.array(dense, ctx=ctx).tostype("row_sparse").indices._data],
        exact=(0, 1, 2, 3))
    call("rsp-todense-retain-add", lambda mx, ctx: [
        rsp(mx, ctx).todense()._data,
        sp_of(mx).retain(rsp(mx, ctx),
                         mx.nd.array([4, 5], ctx=ctx)).todense()._data,
        sp_of(mx).sparse_add(rsp(mx, ctx), rsp(mx, ctx)).todense()._data,
        sp_of(mx).elemwise_mul(rsp(mx, ctx),
                               mx.nd.array(w0, ctx=ctx))._data])
    call("compress-rowsparse", lambda mx, ctx: (lambda r: [
        r.indices._data, r.data._data])(sp_of(mx).compress_rowsparse(
            rsp(mx, ctx).todense())), exact=(0, 1))

    def lazy(kind):
        def run(mx, ctx):
            sp = sp_of(mx)
            w = mx.nd.array(w0, ctx=ctx)
            st = mx.nd.array(hist0, ctx=ctx)
            g = rsp(mx, ctx)
            if kind == "sgd":
                sp.sgd_row_update(w, g, lr=0.1, wd=0.01, rescale_grad=0.5)
            elif kind == "sgd-mom":
                sp.sgd_mom_row_update(w, g, st, lr=0.1, momentum=0.9,
                                      wd=0.01, clip_gradient=0.5)
            else:
                sp.adagrad_row_update(w, g, st, lr=0.1, wd=0.01)
            return [w._data, st._data]
        return run

    for kind in ("sgd", "sgd-mom", "adagrad"):
        call("lazy-" + kind, lazy(kind))

    def dedup(which):
        def run(mx, ctx):
            from .ops.sparse_graph import dedup_rsp_pairs
            t = torch.from_numpy(which).to(ctx.torch_device)
            vals = torch.from_numpy(np.arange(24, dtype=f32).reshape(
                2, 3, 4)).to(ctx.torch_device)
            i, v = dedup_rsp_pairs(t, vals, 10)
            return [i, v]
        return run

    call("dedup-repeats", dedup(ids), exact=(0, 1))
    call("dedup-unique", dedup(uniq), exact=(0, 1))

    def graph_dot(mx, ctx):
        x = mx.sym.var("x", stype="csr")
        w = mx.sym.var("w")
        ex = mx.sym.dot(x, w).bind(
            ctx, {"x": csr(mx, ctx), "w": mx.nd.array(rhs, ctx=ctx)},
            args_grad={"w": mx.nd.zeros(rhs.shape, ctx=ctx)})
        out = ex.forward(is_train=True)[0]
        ex.backward(mx.nd.ones(out.shape, ctx=ctx))
        return [out._data, ex.grad_dict["w"]._data]

    call("graph-csr-dot", graph_dot)

    def sparse_grad(mx, ctx):
        data = mx.sym.var("ids")
        emb = mx.sym.Embedding(data, mx.sym.var("w"), input_dim=10,
                               output_dim=4, sparse_grad=True)
        loss = mx.sym.sum(mx.sym.square(emb))
        ex = loss.bind(ctx, {"ids": mx.nd.array(ids, ctx=ctx),
                             "w": mx.nd.array(emb_w, ctx=ctx)},
                       args_grad={"w": mx.nd.zeros((10, 4), ctx=ctx)},
                       grad_req={"w": "write", "ids": "null"})
        ex.forward(is_train=True)
        ex.backward()
        g = ex.grad_dict["w"]
        return [g.indices._data, g.data._data, g.todense()._data]

    call("graph-sparse-grad", sparse_grad, exact=(0,))

    def partition(mx, ctx):
        from . import subgraph
        d = mx.sym.var("data")
        h = mx.sym.FullyConnected(d, mx.sym.var("w"), num_hidden=5,
                                  no_bias=True, name="fc")
        h = mx.sym.Activation(h, act_type="relu") + 1.0
        net = mx.sym.sum(mx.sym.tanh(h * 2.0))
        part = subgraph.partition_graph(net, "MXTPU_FUSE")
        outs = []
        for s in (net, part):
            ex = s.bind(ctx, {"data": mx.nd.array(x_part, ctx=ctx),
                              "w": mx.nd.array(fc_w, ctx=ctx)},
                        args_grad={"w": mx.nd.zeros((5, 6), ctx=ctx)},
                        grad_req={"w": "write", "data": "null"})
            outs.append(ex.forward(is_train=True)[0]._data)
            ex.backward()
            outs.append(ex.grad_dict["w"]._data)
        n_sub = sum(1 for nd_ in part._topo()
                    if not nd_.is_var and nd_.op.name == "_subgraph_exec")
        outs.append(torch.tensor([n_sub]))
        return outs

    call("partition-graph", partition, exact=(4,))
    return cases
