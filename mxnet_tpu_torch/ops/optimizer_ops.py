"""Optimizer update ops (port of ``mxnet_tpu/ops/optimizer_ops.py``).

The JAX package runs each update as one XLA computation with the weight
and state buffers donated, so the update reuses their memory.  Here the
update is in place: an op writes the new weight and states into the
tensors it is given and returns those same tensors (weight first, then
the states, in the JAX op's output order).  The ops run under
``torch.no_grad()``, so a weight that is a leaf of the tape can be
updated.  ``lr`` (and ``wd``) may be a 0-dim tensor on the weight's
device, as ``ParallelTrainer``'s per-tensor LARS rates are, so no rate
is read back to the host.  These were XLA code on the TPU, not Pallas
kernels, so they stay plain PyTorch.

The multi-precision ops (``mp_sgd_update``, ``mp_sgd_mom_update``) take a
16-bit weight and its float32 master copy: the gradient is cast to
float32, the master is updated, and the weight is written as the master
rounded to the weight's dtype.  ``_sparse_adagrad_update`` (alias
``adagrad_update``) is the dense update, as in the JAX package.
"""

from __future__ import annotations

import torch

from .registry import register_op


def _rescale_clip(grad, rescale_grad, clip_gradient, wd=None, weight=None):
    """The gradient the update applies, in the reference's order: rescale,
    then clip (when clip_gradient >= 0), then add weight decay."""
    grad = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        grad = torch.clamp(grad, -clip_gradient, clip_gradient)
    if wd is not None and weight is not None:
        grad = grad + wd * weight
    return grad


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        return torch.clamp(w, -clip_weights, clip_weights)
    return w


def _write(targets, values):
    """Copy each new value into its target tensor; returns the targets
    (one tensor, or a tuple)."""
    for t, v in zip(targets, values):
        t.copy_(v)
    return targets[0] if len(targets) == 1 else tuple(targets)


@register_op("sgd_update")
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    """weight -= lr * g, in place."""
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        weight.sub_(lr * g)
    return weight


@register_op("sgd_mom_update", num_outputs=2)
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum * mom - lr * g; weight += mom; both in place."""
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        mom.mul_(momentum).sub_(lr * g)
        weight.add_(mom)
    return weight, mom


@register_op("nag_mom_update", num_outputs=2)
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov: mom = momentum * mom + g; weight -= lr * (g + momentum *
    mom)."""
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        mom.mul_(momentum).add_(g)
        weight.sub_(lr * (g + momentum * mom))
    return weight, mom


@register_op("mp_sgd_update", num_outputs=2)
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    """weight32 -= lr * g (g from the float32 cast of grad); weight =
    weight32 in weight's dtype."""
    with torch.no_grad():
        g = _rescale_clip(grad.float(), rescale_grad, clip_gradient, wd,
                          weight32)
        weight32.sub_(lr * g)
        weight.copy_(weight32)
    return weight, weight32


@register_op("mp_sgd_mom_update", num_outputs=3)
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    """mom = momentum * mom - lr * g; weight32 += mom; weight = weight32 in
    weight's dtype (mom and weight32 float32)."""
    with torch.no_grad():
        g = _rescale_clip(grad.float(), rescale_grad, clip_gradient, wd,
                          weight32)
        mom.mul_(momentum).sub_(lr * g)
        weight32.add_(mom)
        weight.copy_(weight32)
    return weight, mom, weight32


@register_op("adam_update", num_outputs=3)
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True):
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        m = beta1 * mean + (1 - beta1) * g
        v = beta2 * var + (1 - beta2) * torch.square(g)
        w = weight - lr * m / (torch.sqrt(v) + epsilon)
        return _write((weight, mean, var), (w, m, v))


@register_op("rmsprop_update", num_outputs=2)
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        n_new = gamma1 * n + (1 - gamma1) * torch.square(g)
        w = _clip_weights(weight - lr * g / torch.sqrt(n_new + epsilon),
                          clip_weights)
        return _write((weight, n), (w, n_new))


@register_op("rmspropalex_update", num_outputs=4)
def _rmspropalex_update(weight, grad, n, g_avg, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves)."""
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        n_new = gamma1 * n + (1 - gamma1) * torch.square(g)
        avg = gamma1 * g_avg + (1 - gamma1) * g
        d = gamma2 * delta - lr * g / torch.sqrt(
            n_new - torch.square(avg) + epsilon)
        w = _clip_weights(weight + d, clip_weights)
        return _write((weight, n, g_avg, delta), (w, n_new, avg, d))


@register_op("ftrl_update", num_outputs=3)
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal; weight decay enters the denominator, not g."""
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient)
        new_n = n + torch.square(g)
        sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
        z_new = z + g - sigma * weight
        w = torch.where(
            torch.abs(z_new) <= lamda1, torch.zeros_like(weight),
            -(z_new - torch.sign(z_new) * lamda1) /
            ((beta + torch.sqrt(new_n)) / lr + wd))
        return _write((weight, z, n), (w, z_new, new_n))


@register_op("ftml_update", num_outputs=4)
def _ftml_update(weight, grad, d, v, z, lr=0.001, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                 clip_grad=-1.0):
    """Follow the moving leader; the clip knob is named ``clip_grad``."""
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_grad, wd, weight)
        v_new = beta2 * v + (1 - beta2) * torch.square(g)
        d_t = (1 - beta1 ** t) / lr * \
            (torch.sqrt(v_new / (1 - beta2 ** t)) + epsilon)
        sigma = d_t - beta1 * d
        z_new = beta1 * z + (1 - beta1) * g - sigma * weight
        return _write((weight, d, v, z), (-z_new / d_t, d_t, v_new, z_new))


@register_op("signsgd_update")
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient)
        return _write((weight,), (weight - lr * (torch.sign(g) +
                                                 wd * weight),))


@register_op("signum_update", num_outputs=2)
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        m = momentum * mom - (1 - momentum) * g
        w = (1 - lr * wd_lh) * weight + lr * torch.sign(m)
        return _write((weight, mom), (w, m))


@register_op("_sparse_adagrad_update", num_outputs=2,
             aliases=("adagrad_update",))
def _adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad, dense."""
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        h = history + torch.square(g)
        w = weight - lr * g / (torch.sqrt(h) + epsilon)
        return _write((weight, history), (w, h))


@register_op("adadelta_update", num_outputs=3)
def _adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                     wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        ag = rho * acc_g + (1 - rho) * torch.square(g)
        delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(ag + epsilon) \
            * g
        ad = rho * acc_delta + (1 - rho) * torch.square(delta)
        return _write((weight, acc_g, acc_delta), (weight - delta, ag, ad))


@register_op("adamax_update", num_outputs=3)
def _adamax_update(weight, grad, mean, var, lr=0.002, beta1=0.9, beta2=0.999,
                   epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        m = beta1 * mean + (1 - beta1) * g
        u = torch.maximum(beta2 * var, torch.abs(g))
        w = weight - (lr / (1 - beta1 ** t)) * m / (u + epsilon)
        return _write((weight, mean, var), (w, m, u))


@register_op("nadam_update", num_outputs=3)
def _nadam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                  epsilon=1e-8, t=1, schedule_decay=0.004, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0):
    with torch.no_grad():
        g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
        m_t = beta1 * (1 - 0.5 * 0.96 ** (t * schedule_decay))
        m_t1 = beta1 * (1 - 0.5 * 0.96 ** ((t + 1) * schedule_decay))
        m = beta1 * mean + (1 - beta1) * g
        v = beta2 * var + (1 - beta2) * torch.square(g)
        g_hat = g / (1 - m_t)
        m_hat = m / (1 - m_t1)
        m_bar = (1 - m_t) * g_hat + m_t1 * m_hat
        w = weight - lr * m_bar / (torch.sqrt(v / (1 - beta2 ** t)) +
                                   epsilon)
        return _write((weight, mean, var), (w, m, v))
