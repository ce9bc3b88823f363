"""Weight initializers (port of ``mxnet_tpu/initializer.py``).

Initializers fill an NDArray in place.  Random ones draw from the
``torch.Generator`` the caller passes, else from the global stream on the
array's device that ``mx.random.seed`` sets (``runtime.rng``), as the
reference's initializers draw from its global stream.  The name-pattern
dispatch (``*_bias`` -> zeros, ``*_gamma`` -> ones, ...) is
the reference's ``Initializer.__call__`` routing.
"""

from __future__ import annotations

import json
import math
import re

import numpy as _np
import torch

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "Constant",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "InitDesc", "register", "create"]

_REGISTRY = {}


def _register(cls, *names):
    for n in (cls.__name__,) + names:
        _REGISTRY[n.lower()] = cls
    return cls


def register(cls):
    """Class decorator: make *cls* creatable by its lower-cased name."""
    return _register(cls)


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
    """Base initializer with name-based dispatch."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``[name, kwargs]`` as JSON, which :func:`create` reads."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, name, arr, generator=None):
        """Fill NDArray *arr*, the parameter called *name*."""
        generator = _stream(arr, generator)
        init = getattr(name, "attrs", {}).get("__init__", "")
        if init:
            create(init)._init_weight(name, arr, generator)
            return
        name = name.lower()
        if name.endswith("weight"):
            self._init_weight(name, arr, generator)
        elif name.endswith(("bias", "beta", "running_mean", "moving_mean")):
            arr._data.zero_()
        elif name.endswith(("gamma", "running_var", "moving_var")):
            arr._data.fill_(1.0)
        else:
            self._init_weight(name, arr, generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._kwargs)


class Zero(Initializer):
    def _init_weight(self, name, arr, generator):
        arr._data.zero_()


class One(Initializer):
    def _init_weight(self, name, arr, generator):
        arr._data.fill_(1.0)


class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        arr._data.uniform_(-self.scale, self.scale, generator=generator)


class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr, generator):
        arr._data.normal_(0.0, self.sigma, generator=generator)


class Constant(Initializer):
    """Every element *value*."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr, generator):
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

    def _init_weight(self, name, arr, generator):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier requires >=2D weight for %s" % name)
        hw_scale = float(math.prod(shape[2:]))
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        try:
            factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                      "out": fan_out}[self.factor_type]
        except KeyError:
            raise ValueError("invalid factor_type %r" % self.factor_type)
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr._data.uniform_(-scale, scale, generator=generator)
        elif self.rnd_type == "gaussian":
            arr._data.normal_(0.0, scale, generator=generator)
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

    def _init_weight(self, name, arr, generator):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        dev = arr._data.device
        if self.rand_type == "uniform":
            tmp = torch.rand((nout, nin), generator=generator, device=dev,
                             dtype=torch.float64) * 2 - 1
        else:
            tmp = torch.randn((nout, nin), generator=generator, device=dev,
                              dtype=torch.float64)
        u, _, q = torch.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else q
        with torch.no_grad():
            arr._data.copy_((self.scale * res).reshape(arr.shape))


class Bilinear(Initializer):
    """The bilinear upsampling kernel (for a Deconvolution's weight)."""

    def _init_weight(self, name, arr, generator):
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

    def _init_weight(self, name, arr, generator):
        n = arr.shape[0] // 4
        with torch.no_grad():
            arr._data.zero_()
            arr._data[n:2 * n] = self.forget_bias

    def __call__(self, name, arr, generator=None):
        if str(name).lower().endswith("bias"):
            self._init_weight(name, arr, _stream(arr, generator))
        else:
            super().__call__(name, arr, generator)


class Mixed:
    """The first initializer whose pattern (a regular expression) matches
    the parameter's name fills it."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr, generator=None):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr, generator)
                return
        raise ValueError("no initializer pattern matches %r" % str(name))


_register(Zero, "zeros")
_register(One, "ones")
_register(Uniform)
_register(Normal)
_register(Constant)
_register(Orthogonal)
_register(Xavier)
_register(MSRAPrelu)
_register(Bilinear)
_register(LSTMBias)
