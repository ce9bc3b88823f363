"""Elementwise unary, binary and scalar ops (port of
``mxnet_tpu/ops/elemwise.py``, with the legacy spellings of
``mxnet_tpu/ops/parity.py`` that name these ops).

Every op is a plain expression on tensors; the reference's are plain
``jnp`` expressions that XLA fuses, and here PyTorch runs them.  The
semantics are the reference's where PyTorch's differ: comparisons and
logical ops return the input's dtype (0/1), not ``bool``; ``%`` is the
floor modulo (``torch.remainder``); ``sign`` keeps ``-0.`` and NaN;
``gamma`` is ``exp(gammaln(x))``, the absolute value of Gamma.

The JAX package registers several ops over a numpy function (``jnp.add``
for ``broadcast_add``), and its registry then reads that function's
signature: no input names and ``('out', 'where')`` as parameters.  Such
ops declare the same names here, so a symbol JSON and the registry's
contracts agree across the packages.
"""

from __future__ import annotations

import math

import torch

from ..base import narrow_dtype, torch_dtype
from .registry import register_op, alias, get_op

# the JAX registry's contracts of ops registered over numpy ufuncs
_UFUNC = dict(input_names=(), param_names=("out", "where"))


def _sign(x):
    # torch.sign maps -0. to 0. and NaN to 0.; jnp.sign keeps both
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


def _keep_int(fn):
    """``fn`` on a floating tensor; an integer one comes back as it is,
    as ``jnp.floor`` and friends return it."""
    def f(x):
        if not (x.is_floating_point() or x.is_complex()):
            return x + 0
        return fn(x)
    return f


def _cbrt(x):
    x = x if x.is_floating_point() else x.to(torch.float32)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|))
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


_UNARY = {
    "abs": torch.abs,
    "sign": _sign,
    # (jnp.rint gives an integer array back as float32)
    "rint": lambda x: torch.round(x if x.is_floating_point()
                                  else x.to(torch.float32)),
    "ceil": _keep_int(torch.ceil),
    "floor": _keep_int(torch.floor),
    "trunc": _keep_int(torch.trunc),
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "reciprocal": lambda x: 1.0 / x,
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (torch.abs(x) + 1),
    "softrelu": _softplus,
    # x + 0, as the reference writes it: -0. becomes 0.
    "_copy": lambda x: x + 0,
    "identity": lambda x: x,
    "isnan": torch.isnan,
    "isinf": torch.isinf,
    "isfinite": torch.isfinite,
}


def _unary_op(fn):
    # a Python signature (torch's builtins have none the registry can
    # read): the op's input is named "x", as the JAX registry names it
    def op(x):
        return fn(x)
    return op


for _name, _f in _UNARY.items():
    register_op(_name)(_unary_op(_f))


@register_op("negative", **_UFUNC)
def _negative(x):
    return torch.neg(x)


@register_op("round", input_names=("a",), param_names=("decimals", "out"))
def _round(a, decimals=0):
    """Half to even, as ``jnp.round``."""
    if not (a.is_floating_point() or a.is_complex()):
        return a + 0
    return torch.round(a, decimals=decimals) if decimals else torch.round(a)


@register_op("fix", param_names=("out",))
def _fix(x):
    return _keep_int(torch.trunc)(x)


@register_op("zeros_like")
def _zeros_like(a, dtype=None, shape=None, device=None, out_sharding=None):
    return torch.zeros(a.shape if shape is None else shape,
                       dtype=a.dtype if dtype is None else torch_dtype(dtype),
                       device=a.device)


@register_op("ones_like")
def _ones_like(a, dtype=None, shape=None, device=None, out_sharding=None):
    return torch.ones(a.shape if shape is None else shape,
                      dtype=a.dtype if dtype is None else torch_dtype(dtype),
                      device=a.device)


@register_op("clip")
def _clip(x, a_min=None, a_max=None):
    if a_min is None and a_max is None:
        return x
    return torch.clamp(x, a_min, a_max)


@register_op("Cast", aliases=("cast",))
def _cast(x, dtype="float32"):
    """A 64-bit *dtype* narrows as in the reference (JAX without x64),
    unless ``enable_x64()`` is open."""
    return x.to(torch_dtype(narrow_dtype(dtype)))


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


@register_op("LeakyReLU", input_names=("data", "gamma"))
def _leaky_relu(x, *rest, act_type="leaky", slope=0.25, lower_bound=0.125,
                upper_bound=0.334):
    """leaky / prelu / elu / selu / gelu (exact erf) / rrelu at the
    midpoint of [lower_bound, upper_bound], as the reference computes
    each (prelu's *gamma* broadcasts against the data's trailing axes,
    as ``gamma * x`` does there)."""
    if act_type == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act_type == "prelu":
        return torch.where(x > 0, x, rest[0] * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(x > 0, x,
                                         _SELU_ALPHA * torch.expm1(x))
    if act_type == "gelu":
        return x * (torch.erf(x / math.sqrt(2)) + 1) / 2
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(x > 0, x, mid * x)
    raise ValueError("unknown LeakyReLU act_type %r" % act_type)


def _leaky_inputs(params):
    if params.get("act_type", "leaky") == "prelu":
        return ("data", "gamma")
    return ("data",)


get_op("LeakyReLU").active_inputs = _leaky_inputs


# ---------------------------------------------------------------------------
# binary: broadcast_* (the elemwise_* names broadcast as well)
# ---------------------------------------------------------------------------

def _cmp(fn):
    def op(a, b):
        return fn(a, b).to(a.dtype)
    return op


def _logical(fn):
    def op(a, b):
        return fn(a != 0, b != 0).to(a.dtype)
    return op


# (torch function, the JAX registry's input names) of each binary op; the
# names are those of the numpy function the reference registered
_BINARY = {
    "add": (torch.add, None),
    "sub": (torch.sub, None),
    "mul": (torch.mul, None),
    "div": (torch.true_divide, ("x1", "x2")),
    "mod": (torch.remainder, ("x1", "x2")),
    "power": (torch.pow, ("x1", "x2")),
    "maximum": (torch.maximum, None),
    "minimum": (torch.minimum, None),
    "hypot": (torch.hypot, ("x1", "x2")),
    "equal": (_cmp(torch.eq), ("a", "b")),
    "not_equal": (_cmp(torch.ne), ("a", "b")),
    "greater": (_cmp(torch.gt), ("a", "b")),
    "greater_equal": (_cmp(torch.ge), ("a", "b")),
    "lesser": (_cmp(torch.lt), ("a", "b")),
    "lesser_equal": (_cmp(torch.le), ("a", "b")),
    "logical_and": (_logical(torch.logical_and), ("a", "b")),
    "logical_or": (_logical(torch.logical_or), ("a", "b")),
    "logical_xor": (_logical(torch.logical_xor), ("a", "b")),
}


def _binary_op(fn):
    # (a signature the registry can read, as for the unary ops)
    def op(lhs, rhs):
        return fn(lhs, rhs)
    return op


for _name, (_f, _inputs) in _BINARY.items():
    _kw = _UFUNC if _inputs is None else dict(input_names=_inputs)
    register_op("broadcast_" + _name, **_kw)(_binary_op(_f))

for _name in ("add", "sub", "mul", "div"):
    alias("elemwise_" + _name, "broadcast_" + _name)
for _name in ("mod", "power", "maximum", "minimum", "hypot", "equal",
              "not_equal", "greater", "greater_equal", "lesser",
              "lesser_equal"):
    alias("_" + _name, "broadcast_" + _name)
alias("_plus", "broadcast_add")
alias("_minus", "broadcast_sub")
alias("_mul", "broadcast_mul")
alias("_div", "broadcast_div")


# ---------------------------------------------------------------------------
# scalar variants; the Python scalar takes part in type promotion as it
# does in the reference (an int32 array with a float scalar gives float32)
# ---------------------------------------------------------------------------

def _like(x, scalar):
    return torch.full_like(x, scalar, dtype=torch.result_type(x, scalar))


def _logical_scalar(kind):
    def op(x, scalar=0.0):
        nz = x != 0
        if kind == "and":
            out = nz if scalar != 0 else torch.zeros_like(nz)
        elif kind == "or":
            out = torch.ones_like(nz) if scalar != 0 else nz
        else:
            out = ~nz if scalar != 0 else nz
        return out.to(x.dtype)
    return op


_SCALAR = {
    "_plus_scalar": lambda x, scalar=0.0: x + scalar,
    "_minus_scalar": lambda x, scalar=0.0: x - scalar,
    "_rminus_scalar": lambda x, scalar=0.0: scalar - x,
    "_mul_scalar": lambda x, scalar=1.0: x * scalar,
    # both divide by a tensor: PyTorch turns x / scalar into x * (1 /
    # scalar) on the card, and scalar / x into reciprocal(x) * scalar,
    # two roundings each where the reference rounds once
    "_div_scalar": lambda x, scalar=1.0: x / _like(x, scalar),
    "_rdiv_scalar": lambda x, scalar=1.0: _like(x, scalar) / x,
    "_mod_scalar": lambda x, scalar=1.0: torch.remainder(x, scalar),
    "_rmod_scalar": lambda x, scalar=1.0: torch.remainder(scalar, x),
    "_power_scalar": lambda x, scalar=1.0: torch.pow(x, scalar),
    "_rpower_scalar": lambda x, scalar=1.0: torch.pow(scalar, x),
    "_maximum_scalar": lambda x, scalar=0.0: torch.clamp_min(x, scalar),
    "_minimum_scalar": lambda x, scalar=0.0: torch.clamp_max(x, scalar),
    "_hypot_scalar":
        lambda x, scalar=0.0: torch.hypot(x, _like(x, scalar)),
    "_equal_scalar": lambda x, scalar=0.0: (x == scalar).to(x.dtype),
    "_not_equal_scalar": lambda x, scalar=0.0: (x != scalar).to(x.dtype),
    "_greater_scalar": lambda x, scalar=0.0: (x > scalar).to(x.dtype),
    "_greater_equal_scalar":
        lambda x, scalar=0.0: (x >= scalar).to(x.dtype),
    "_lesser_scalar": lambda x, scalar=0.0: (x < scalar).to(x.dtype),
    "_lesser_equal_scalar":
        lambda x, scalar=0.0: (x <= scalar).to(x.dtype),
    "_logical_and_scalar": _logical_scalar("and"),
    "_logical_or_scalar": _logical_scalar("or"),
    "_logical_xor_scalar": _logical_scalar("xor"),
    "_scatter_plus_scalar": lambda x, scalar=0.0: x + scalar,
}

for _name, _f in _SCALAR.items():
    register_op(_name)(_f)


@register_op("smooth_l1")
def _smooth_l1(x, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       torch.abs(x) - 0.5 / s2)


@register_op("add_n", aliases=("ElementWiseSum", "_sum_nary"))
def _add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# -- the legacy spellings (the reference's ops/parity.py) --------------------
_LEGACY = {
    "_Plus": "broadcast_add", "_Minus": "broadcast_sub",
    "_Mul": "broadcast_mul", "_Div": "broadcast_div",
    "_Mod": "broadcast_mod", "_Power": "broadcast_power",
    "_Maximum": "broadcast_maximum", "_Minimum": "broadcast_minimum",
    "_Hypot": "broadcast_hypot",
    "_add": "broadcast_add", "_sub": "broadcast_sub",
    "_grad_add": "broadcast_add",
    "broadcast_plus": "broadcast_add", "broadcast_minus": "broadcast_sub",
    "_Equal": "_equal", "_Not_Equal": "_not_equal",
    "_Greater": "_greater", "_Greater_Equal": "_greater_equal",
    "_Lesser": "_lesser", "_Lesser_Equal": "_lesser_equal",
    "_Logical_And": "broadcast_logical_and",
    "_Logical_Or": "broadcast_logical_or",
    "_Logical_Xor": "broadcast_logical_xor",
    "_logical_and": "broadcast_logical_and",
    "_logical_or": "broadcast_logical_or",
    "_logical_xor": "broadcast_logical_xor",
    "_PlusScalar": "_plus_scalar", "_MinusScalar": "_minus_scalar",
    "_RMinusScalar": "_rminus_scalar", "_MulScalar": "_mul_scalar",
    "_DivScalar": "_div_scalar", "_RDivScalar": "_rdiv_scalar",
    "_ModScalar": "_mod_scalar", "_RModScalar": "_rmod_scalar",
    "_PowerScalar": "_power_scalar", "_RPowerScalar": "_rpower_scalar",
    "_MaximumScalar": "_maximum_scalar",
    "_MinimumScalar": "_minimum_scalar",
    "_HypotScalar": "_hypot_scalar",
    "_EqualScalar": "_equal_scalar",
    "_NotEqualScalar": "_not_equal_scalar",
    "_GreaterScalar": "_greater_scalar",
    "_GreaterEqualScalar": "_greater_equal_scalar",
    "_LesserScalar": "_lesser_scalar",
    "_LesserEqualScalar": "_lesser_equal_scalar",
    "_LogicalAndScalar": "_logical_and_scalar",
    "_LogicalOrScalar": "_logical_or_scalar",
    "_LogicalXorScalar": "_logical_xor_scalar",
    "_copyto": "_copy",
}

for _name, _target in _LEGACY.items():
    alias(_name, _target)
