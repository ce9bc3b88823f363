"""Neural-network ops (port of ``mxnet_tpu/ops/nn.py``, subset:
FullyConnected, Activation, LayerNorm, softmax, log_softmax).

Matrix products stay with PyTorch (cuBLAS on the card), as the JAX
package left them to XLA.  A float32 product runs in full float32:
``torch.backends.cuda.matmul.allow_tf32`` is False by default, which
matches the JAX package's ``Precision.HIGHEST`` policy for float32
(``mxnet_tpu/ops/_precision.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op, get_op


@register_op("FullyConnected", input_names=("data", "weight", "bias"))
def _fully_connected(data, weight, *rest, num_hidden=0, no_bias=False,
                     flatten=True):
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    # weight: (num_hidden, in_units), contracted on in_units
    out = torch.matmul(data, weight.t())
    if not no_bias and rest:
        out = out + rest[0]
    return out


get_op("FullyConnected").active_inputs = \
    lambda p: ("data", "weight") if p.get("no_bias", False) \
    else ("data", "weight", "bias")


_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "gelu": F.gelu,
    "swish": F.silu,
}


@register_op("Activation")
def _activation(x, act_type="relu"):
    try:
        fn = _ACTS[act_type]
    except KeyError:
        raise ValueError("unknown act_type %r" % act_type)
    return fn(x)


@register_op("LayerNorm", num_outputs=3,
             num_visible_outputs=lambda p: 3 if p.get("output_mean_var")
             else 1)
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + eps)
    bshape = [1] * data.dim()
    bshape[axis % data.dim()] = data.shape[axis % data.dim()]
    out = (data - mean) * inv * gamma.reshape(bshape) + beta.reshape(bshape)
    return out, mean.squeeze(axis), var.squeeze(axis)


def _temper(x, temperature):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return x


@register_op("softmax")
def _softmax(x, axis=-1, temperature=None, length=None):
    return torch.softmax(_temper(x, temperature), dim=axis)


@register_op("log_softmax")
def _log_softmax(x, axis=-1, temperature=None):
    return torch.log_softmax(_temper(x, temperature), dim=axis)
