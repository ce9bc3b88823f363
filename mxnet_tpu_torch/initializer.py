"""Weight initializers (port of ``mxnet_tpu/initializer.py``).

Initializers fill an NDArray in place.  ``Initializer.__call__(desc,
arr)`` routes by the parameter's name to the reference's hooks, each
``hook(self, desc, arr)`` with the ``InitDesc``: ``*weight`` to
``_init_weight``, ``*bias`` to ``_init_bias``, ``*gamma``/``*beta``,
running and moving statistics to ``_init_zero``/``_init_one``, anything
else to ``_init_default``.  Random ones draw from the instance's
generator while :func:`using_generator` sets one, else from the global
stream on the array's device that ``mx.random.seed`` sets
(``runtime.rng``), as the reference's initializers draw from its global
stream.
"""

from __future__ import annotations

import contextlib
import json
import math
import re

import numpy as _np
import torch

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "Constant",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "InitDesc", "register", "create", "using_generator"]

_REGISTRY = {}


def register(obj=None, name=None, aliases=()):
    """Make a class creatable by its lower-cased name (or *name*) and by
    each of *aliases*; a class decorator with or without arguments."""
    def _do(cls):
        for n in (name or cls.__name__,) + tuple(aliases):
            _REGISTRY[n.lower()] = cls
        return cls
    return _do if obj is None else _do(obj)


def create(name, **kwargs):
    """An initializer by registered name ('uniform', 'normal', 'zeros'),
    or from its ``dumps()`` JSON; an Initializer passes through."""
    if isinstance(name, Initializer):
        return name
    if name.startswith("["):
        name, kwargs = json.loads(name)
    try:
        return _REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise KeyError("initializer %r is not registered; known: %s"
                       % (name, sorted(_REGISTRY)))


def _stream(arr, generator):
    """*generator*, or the global stream on *arr*'s device."""
    if generator is not None:
        return generator
    from .runtime import rng
    return rng.generator(arr._data.device)


@contextlib.contextmanager
def using_generator(init, generator):
    """Within the block, the random draws of *init* (an Initializer or a
    Mixed) come from the ``torch.Generator`` *generator* (None: the
    global stream)."""
    old = getattr(init, "_generator", None)
    init._generator = generator
    try:
        yield init
    finally:
        init._generator = old


class InitDesc(str):
    """A parameter's name with its attributes: ``attrs["__init__"]`` names
    the initializer (a ``dumps()`` string) that fills it, whatever the
    name's suffix."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Base initializer with the reference's name-based dispatch."""

    _generator = None

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``[name, kwargs]`` as JSON, which :func:`create` reads."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def _rng(self, arr):
        """The generator a random hook draws *arr*'s values from."""
        return _stream(arr, self._generator)

    def __call__(self, desc, arr):
        """Fill NDArray *arr*, the parameter *desc* (a name or an
        ``InitDesc``)."""
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        init = desc.attrs.get("__init__", "")
        if init:
            with using_generator(create(init), self._generator) as inner:
                inner._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith(("running_mean", "moving_mean")):
            self._init_zero(desc, arr)
        elif name.endswith(("running_var", "moving_var")):
            self._init_one(desc, arr)
        elif name.endswith(("moving_inv_var", "moving_avg")):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    def _init_bias(self, desc, arr):
        arr._data.zero_()

    def _init_gamma(self, desc, arr):
        arr._data.fill_(1.0)

    def _init_beta(self, desc, arr):
        arr._data.zero_()

    def _init_zero(self, desc, arr):
        arr._data.zero_()

    def _init_one(self, desc, arr):
        arr._data.fill_(1.0)

    def _init_default(self, desc, arr):
        self._init_weight(desc, arr)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._kwargs)


class Zero(Initializer):
    def _init_weight(self, desc, arr):
        arr._data.zero_()


class One(Initializer):
    def _init_weight(self, desc, arr):
        arr._data.fill_(1.0)


class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr):
        arr._data.uniform_(-self.scale, self.scale, generator=self._rng(arr))


class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr):
        arr._data.normal_(0.0, self.sigma, generator=self._rng(arr))


class Constant(Initializer):
    """Every element *value*."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr):
        arr._data.fill_(self.value)


class Xavier(Initializer):
    """Xavier/Glorot: scale = sqrt(magnitude / factor), the factor the
    fan in, the fan out or their mean (*factor_type* 'in', 'out', 'avg'),
    each fan counting the kernel's spatial extent; then U(-scale, scale)
    (*rnd_type* 'uniform') or N(0, scale^2) ('gaussian')."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier requires >=2D weight for %s" % desc)
        hw_scale = float(math.prod(shape[2:]))
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        try:
            factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                      "out": fan_out}[self.factor_type]
        except KeyError:
            raise ValueError("invalid factor_type %r" % self.factor_type)
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr._data.uniform_(-scale, scale, generator=self._rng(arr))
        elif self.rnd_type == "gaussian":
            arr._data.normal_(0.0, scale, generator=self._rng(arr))
        else:
            raise ValueError("invalid rnd_type %r" % self.rnd_type)


class MSRAPrelu(Xavier):
    """He initialization for PReLU of *slope*: gaussian Xavier of
    magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


class Orthogonal(Initializer):
    """*scale* times an orthogonal matrix: the singular vectors of a
    (nout, nin) draw, U(-1, 1) (*rand_type* 'uniform') or N(0, 1)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        dev = arr._data.device
        if self.rand_type == "uniform":
            tmp = torch.rand((nout, nin), generator=self._rng(arr), device=dev,
                             dtype=torch.float64) * 2 - 1
        else:
            tmp = torch.randn((nout, nin), generator=self._rng(arr), device=dev,
                              dtype=torch.float64)
        u, _, q = torch.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else q
        with torch.no_grad():
            arr._data.copy_((self.scale * res).reshape(arr.shape))


class Bilinear(Initializer):
    """The bilinear upsampling kernel (for a Deconvolution's weight)."""

    def _init_weight(self, desc, arr):
        shape = arr.shape
        weight = _np.zeros(shape, dtype=_np.float32)
        f = shape[3] / 2.0
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(_np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        with torch.no_grad():
            arr._data.copy_(torch.from_numpy(weight))


class LSTMBias(Initializer):
    """Zeros, but the forget gate's quarter (the second of four) set to
    *forget_bias*."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        n = arr.shape[0] // 4
        with torch.no_grad():
            arr._data.zero_()
            arr._data[n:2 * n] = self.forget_bias

    _init_bias = _init_weight


class Mixed:
    """The first initializer whose pattern (a regular expression) matches
    the parameter's name fills it."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    _generator = None

    def __call__(self, desc, arr):
        for prog, init in self.map:
            if prog.match(str(desc)):
                with using_generator(init, self._generator):
                    init(desc, arr)
                return
        raise ValueError("no initializer pattern matches %r" % str(desc))


register(Zero, aliases=("zeros",))
register(One, aliases=("ones",))
for _cls in (Uniform, Normal, Constant, Orthogonal, Xavier, MSRAPrelu,
             Bilinear, LSTMBias, Mixed):
    register(_cls)
