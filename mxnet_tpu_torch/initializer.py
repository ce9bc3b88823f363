"""Weight initializers (port of ``mxnet_tpu/initializer.py``, subset:
Uniform, Normal, Zero, One, Constant, Xavier, MSRAPrelu).

Initializers fill an NDArray in place.  Random ones draw from an explicit
``torch.Generator`` on the array's device; the caller owns its seed.  The
name-pattern dispatch (``*_bias`` -> zeros, ``*_gamma`` -> ones, ...) is
the reference's ``Initializer.__call__`` routing.
"""

from __future__ import annotations

import math

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "Constant",
           "Xavier", "MSRAPrelu", "create"]

_REGISTRY = {}


def _register(cls, *names):
    for n in (cls.__name__,) + names:
        _REGISTRY[n.lower()] = cls
    return cls


def create(name, **kwargs):
    """An initializer by registered name ('uniform', 'normal', 'zeros')."""
    try:
        return _REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise KeyError("initializer %r is not registered; known: %s"
                       % (name, sorted(_REGISTRY)))


class Initializer:
    """Base initializer with name-based dispatch."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr, generator=None):
        """Fill NDArray *arr*, the parameter called *name*."""
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


_register(Zero, "zeros")
_register(One, "ones")
_register(Uniform)
_register(Normal)
_register(Constant)
_register(Xavier)
_register(MSRAPrelu)
