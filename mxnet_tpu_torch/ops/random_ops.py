"""Random samplers (port of ``mxnet_tpu/ops/random_ops.py``).

Each sampler takes a ``torch.Generator`` as its first argument (the
eager path passes the global stream's generator of the target device,
``runtime/rng.py``) and draws on that generator's device.  The draws are
PyTorch's: the same distributions as the reference's, not the same
numbers.
"""

from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register_op, alias
from .tensor import _shape


def _uniform01(rng, shape, dtype=torch.float32):
    return torch.rand(shape, generator=rng, device=rng.device, dtype=dtype)


def _standard_gamma(rng, alpha):
    return torch._standard_gamma(alpha, generator=rng)


def _poisson(rng, lam):
    return torch.poisson(lam, generator=rng)


@register_op("_random_uniform", needs_rng=True, aliases=("uniform",))
def _uniform(rng, low=0.0, high=1.0, shape=(), dtype="float32"):
    u = _uniform01(rng, _shape(shape), torch_dtype(dtype))
    return low + (high - low) * u


@register_op("_random_normal", needs_rng=True,
             aliases=("normal", "_random_gaussian"))
def _normal(rng, loc=0.0, scale=1.0, shape=(), dtype="float32"):
    z = torch.randn(_shape(shape), generator=rng, device=rng.device,
                    dtype=torch_dtype(dtype))
    return loc + scale * z


@register_op("_random_gamma", needs_rng=True, aliases=("gamma_sample",))
def _gamma(rng, alpha=1.0, beta=1.0, shape=(), dtype="float32"):
    a = torch.full(_shape(shape), float(alpha), device=rng.device,
                   dtype=torch_dtype(dtype))
    return beta * _standard_gamma(rng, a)


@register_op("_random_exponential", needs_rng=True)
def _exponential(rng, lam=1.0, shape=(), dtype="float32"):
    e = torch.empty(_shape(shape), device=rng.device,
                    dtype=torch_dtype(dtype)).exponential_(generator=rng)
    return e / lam


@register_op("_random_poisson", needs_rng=True)
def _poisson_op(rng, lam=1.0, shape=(), dtype="float32"):
    lam_t = torch.full(_shape(shape), float(lam), device=rng.device)
    return _poisson(rng, lam_t).to(torch_dtype(dtype))


def _gamma_poisson(rng, shape, k, p):
    g = _standard_gamma(rng, torch.full(shape, float(k), device=rng.device))
    return _poisson(rng, g * (1 - p) / p)


@register_op("_random_negative_binomial", needs_rng=True)
def _neg_binomial(rng, k=1, p=1.0, shape=(), dtype="float32"):
    """Failures before the k-th success at success rate p, as a
    gamma-Poisson mixture."""
    return _gamma_poisson(rng, _shape(shape), k, p).to(torch_dtype(dtype))


@register_op("_random_generalized_negative_binomial", needs_rng=True)
def _gen_neg_binomial(rng, mu=1.0, alpha=1.0, shape=(), dtype="float32"):
    """Negative binomial of mean *mu* and dispersion *alpha*."""
    r = 1.0 / alpha
    return _gamma_poisson(rng, _shape(shape), r, r / (r + mu)).to(
        torch_dtype(dtype))


@register_op("_random_randint", needs_rng=True)
def _randint(rng, low=0, high=1, shape=(), dtype="int32"):
    return torch.randint(int(low), int(high), _shape(shape), generator=rng,
                         device=rng.device, dtype=torch_dtype(dtype))


def _expand(t, s):
    return t.reshape(tuple(t.shape) + (1,) * len(s))


@register_op("_sample_uniform", needs_rng=True)
def _sample_uniform(rng, low, high, shape=(), dtype="float32"):
    """*shape* draws for each element of *low*, *high*."""
    s = _shape(shape)
    u = _uniform01(rng, tuple(low.shape) + s, torch_dtype(dtype))
    return _expand(low, s) + _expand(high - low, s) * u.to(low.device)


@register_op("_sample_normal", needs_rng=True)
def _sample_normal(rng, mu, sigma, shape=(), dtype="float32"):
    s = _shape(shape)
    z = torch.randn(tuple(mu.shape) + s, generator=rng, device=rng.device,
                    dtype=torch_dtype(dtype))
    return _expand(mu, s) + _expand(sigma, s) * z.to(mu.device)


@register_op("_sample_gamma", needs_rng=True)
def _sample_gamma(rng, alpha, beta, shape=(), dtype="float32"):
    s = _shape(shape)
    a = torch.broadcast_to(_expand(alpha, s), tuple(alpha.shape) + s)
    g = _standard_gamma(rng, a.to(rng.device, torch_dtype(dtype)))
    return g.to(alpha.device) * _expand(beta, s)


@register_op("_sample_multinomial", needs_rng=True,
             aliases=("sample_multinomial",))
def _sample_multinomial(rng, data, shape=(), get_prob=False,
                        dtype="int32"):
    """*shape* class ids drawn with replacement from each row of
    probabilities *data* (weights, normalized per row)."""
    s = _shape(shape)
    n = 1
    for d in s:
        n *= d
    probs = torch.clamp_min(data, 1e-38).to(rng.device)
    if data.dim() == 1:
        out = torch.multinomial(probs, n, replacement=True, generator=rng)
        out = out.reshape(s)
    else:
        out = torch.multinomial(probs, n, replacement=True, generator=rng)
        out = out.reshape((data.shape[0],) + s)
    return out.to(data.device, torch_dtype(dtype))


@register_op("_random_bernoulli", needs_rng=True)
def _bernoulli(rng, p=0.5, shape=(), dtype="float32"):
    return (_uniform01(rng, _shape(shape)) < p).to(torch_dtype(dtype))


# the reference's spellings of ops/parity.py
for _name in ("uniform", "normal", "gamma", "exponential", "poisson",
              "negative_binomial", "generalized_negative_binomial"):
    alias("random_" + _name, "_random_" + _name)
