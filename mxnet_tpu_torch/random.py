"""``mx.random`` (port of ``mxnet_tpu/random.py``): the ``nd.random``
samplers and ``seed``."""

from __future__ import annotations

from .runtime import rng as _rng
from .ndarray import random as _ndrandom

uniform = _ndrandom.uniform
normal = _ndrandom.normal
randn = _ndrandom.randn
gamma = _ndrandom.gamma
exponential = _ndrandom.exponential
poisson = _ndrandom.poisson
negative_binomial = _ndrandom.negative_binomial
generalized_negative_binomial = _ndrandom.generalized_negative_binomial
multinomial = _ndrandom.multinomial
shuffle = _ndrandom.shuffle
randint = _ndrandom.randint


def seed(seed_state, ctx="all"):
    """Seed the global random stream on every device (reference:
    ``mx.random.seed``): the same seed gives the same draws again."""
    _rng.seed(seed_state)
