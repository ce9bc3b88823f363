"""``nd.random`` (port of ``mxnet_tpu/ndarray/random.py``).

Samplers draw from the global stream's generator of their device
(``runtime/rng.py``; ``mx.random.seed`` reseeds it), on *ctx* (default:
the current context) or, given NDArray parameters, on theirs: one draw
of *shape* per element then.
"""

from __future__ import annotations

from .ndarray import imperative_invoke, NDArray

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle", "bernoulli"]


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _maybe_sample(op_scalar, op_sample, arrs, shape, dtype, ctx, out=None,
                  **scalars):
    nd_args = [a for a in arrs if isinstance(a, NDArray)]
    if nd_args:
        return imperative_invoke(op_sample, *nd_args, shape=_shape(shape),
                                 dtype=dtype, out=out)
    return imperative_invoke(op_scalar, shape=_shape(shape), dtype=dtype,
                             out=out, ctx=ctx, **scalars)


def uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None, out=None,
            **kwargs):
    if out is not None and not shape:
        shape = out.shape
    return _maybe_sample("_random_uniform", "_sample_uniform", (low, high),
                         shape, dtype, ctx, out=out, low=low, high=high)


def normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None, out=None,
           **kwargs):
    if out is not None and not shape:
        shape = out.shape
    return _maybe_sample("_random_normal", "_sample_normal", (loc, scale),
                         shape, dtype, ctx, out=out, loc=loc, scale=scale)


randn = normal


def gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", ctx=None,
          out=None):
    return _maybe_sample("_random_gamma", "_sample_gamma", (alpha, beta),
                         shape, dtype, ctx, alpha=alpha, beta=beta)


def exponential(scale=1.0, shape=(), dtype="float32", ctx=None, out=None):
    return imperative_invoke("_random_exponential", lam=1.0 / scale,
                             shape=_shape(shape), dtype=dtype, ctx=ctx)


def poisson(lam=1.0, shape=(), dtype="float32", ctx=None, out=None):
    return imperative_invoke("_random_poisson", lam=lam,
                             shape=_shape(shape), dtype=dtype, ctx=ctx)


def negative_binomial(k=1, p=1.0, shape=(), dtype="float32", ctx=None,
                      out=None):
    return imperative_invoke("_random_negative_binomial", k=k, p=p,
                             shape=_shape(shape), dtype=dtype, ctx=ctx)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(),
                                  dtype="float32", ctx=None, out=None):
    return imperative_invoke("_random_generalized_negative_binomial",
                             mu=mu, alpha=alpha, shape=_shape(shape),
                             dtype=dtype, ctx=ctx)


def randint(low, high, shape=(), dtype="int32", ctx=None, out=None):
    return imperative_invoke("_random_randint", low=low, high=high,
                             shape=_shape(shape), dtype=dtype, ctx=ctx)


def multinomial(data, shape=(), get_prob=False, dtype="int32", out=None):
    return imperative_invoke("_sample_multinomial", data,
                             shape=_shape(shape), get_prob=get_prob,
                             dtype=dtype)


def shuffle(data, out=None):
    return imperative_invoke("shuffle", data)


def bernoulli(p=0.5, shape=(), dtype="float32", ctx=None, out=None):
    return imperative_invoke("_random_bernoulli", p=p, shape=_shape(shape),
                             dtype=dtype, ctx=ctx)
