"""Weight initializers (port of ``mxnet_tpu/initializer.py``, subset:
Uniform, Normal, Zero, One).

Initializers fill an NDArray in place.  Random ones draw from an explicit
``torch.Generator`` on the array's device; the caller owns its seed.  The
name-pattern dispatch (``*_bias`` -> zeros, ``*_gamma`` -> ones, ...) is
the reference's ``Initializer.__call__`` routing.
"""

from __future__ import annotations

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "create"]

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


_register(Zero, "zeros")
_register(One, "ones")
_register(Uniform)
_register(Normal)
