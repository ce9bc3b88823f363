"""Scaled-dot-product attention (port of ``mxnet_tpu/ops/attention.py``).

Layout is (batch, heads, seq, head_dim) at every public function.

- ``attention_reference``: O(S^2)-memory attention, the numeric oracle.
- ``_chunked_attention``: the plain PyTorch version of the flash forward,
  a port of the JAX package's ``_chunked_attention`` with its online
  softmax (``_online_softmax_update`` / ``_finalize_softmax``), able to
  return the logsumexp too.  CPU tensors run it.
- ``flash_fwd``: the wrapper of the hand-written Hopper kernel
  ``mxnet_tpu_torch/csrc/flash_fwd.cu``, which replaces the TPU kernel
  ``_flash_fwd_kernel`` (``mxnet_tpu/ops/attention.py:164``).  At the
  serving shape the kernel is bound by operations, not bytes (about 128
  flop per byte moved in f32), so its design keeps every score, weight
  and partial output in registers and stages each K/V tile once in
  shared memory for a whole tile of query rows; see the source's header.
- ``flash_attention``: the dispatcher.  A CUDA tensor launches the kernel
  or raises; there is no fallback to the plain version.
- ``_contrib_DotProductAttention``: the registered operator.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _cuda
from .registry import register_op

__all__ = ["flash_attention", "attention_reference", "flash_fwd"]

_NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 256


def attention_reference(q, k, v, causal=False, sm_scale=None):
    """Einsum attention in float32; a causal row that sees no key outputs
    zeros (the degenerate-row convention of every path here)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        qlen, klen = s.shape[-2], s.shape[-1]
        mask = torch.ones(qlen, klen, dtype=torch.bool,
                          device=s.device).tril(klen - qlen)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        p = torch.softmax(s, dim=-1) * mask.any(-1)[:, None]
    else:
        p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _online_softmax_update(o, m, l, s, vb):
    """One online-softmax step over masked f32 scores *s* against value
    block *vb*.  p goes to vb's storage dtype for the P.V product while
    the o/m/l state stays f32 (products of two storage-dtype values are
    exact in f32, so this is f32 accumulation of storage-dtype products,
    as on the TPU)."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    o = o * alpha[..., None] + torch.matmul(p.to(vb.dtype).float(),
                                            vb.float())
    return o, m_new, l


def _finalize_softmax(o, m, l):
    """o / l, with zeros for rows that saw no visible key; also the
    per-row logsumexp (+1e30 on those rows)."""
    degenerate = m <= _NEG_INF * 0.5
    l_safe = torch.where(degenerate, torch.ones_like(l), l)
    out = torch.where(degenerate[..., None], torch.zeros_like(o),
                      o / l_safe[..., None])
    lse = torch.where(degenerate, torch.full_like(m, -_NEG_INF),
                      m + torch.log(l_safe))
    return out, lse


def _chunked_attention(q, k, v, causal=False, sm_scale=None, chunk=512,
                       with_lse=False):
    """Blockwise attention with an online softmax over K chunks: the plain
    version of the flash forward (O(Sq * chunk) score memory)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, sq, d = q.shape
    sk = k.shape[2]
    chunk = max(1, min(int(chunk), sk))
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    o = torch.zeros(b, h, sq, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(b, h, sq, dtype=torch.float32, device=q.device)
    qf = q.float()
    for c0 in range(0, sk, chunk):
        kb = k[:, :, c0:c0 + chunk]
        vb = v[:, :, c0:c0 + chunk]
        s = torch.matmul(qf, kb.float().transpose(-1, -2)) * sm_scale
        if causal:
            k_pos = torch.arange(c0, c0 + kb.shape[2], device=q.device)
            valid = k_pos[None, :] <= q_pos[:, None]
            s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        o, m, l = _online_softmax_update(o, m, l, s, vb)
    out, lse = _finalize_softmax(o, m, l)
    out = out.to(q.dtype)
    return (out, lse) if with_lse else out


def _bind(lib):
    vp = ctypes.c_void_p
    lib.flash_fwd.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_int, ctypes.c_int, vp]
    lib.flash_fwd.restype = ctypes.c_int


def flash_fwd(q, k, v, causal=False, sm_scale=None, with_lse=False):
    """Launch the Hopper flash-attention forward on CUDA tensors.

    q (B, H, Sq, D), k and v (B, H, Sk, D): contiguous, on one CUDA
    device, one dtype of float32 / bfloat16 / float16, D <= 256.
    Returns o (like q), and with *with_lse* also the f32 logsumexp
    (B, H, Sq).  Raises on any input the kernel does not take."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise MXNetError("flash_fwd: %s is on %s; the kernel takes "
                             "CUDA tensors" % (name, t.device))
        if t.dim() != 4:
            raise MXNetError("flash_fwd: %s must be (B, H, S, D), got "
                             "shape %s" % (name, tuple(t.shape)))
        if not t.is_contiguous():
            raise MXNetError("flash_fwd: %s must be contiguous (strides "
                             "%s)" % (name, t.stride()))
    if not (q.device == k.device == v.device):
        raise MXNetError("flash_fwd: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise MXNetError("flash_fwd: q, k, v must share one dtype of %s, "
                         "got %s" % (sorted(map(str, _KERNEL_DTYPES)),
                                     (q.dtype, k.dtype, v.dtype)))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d):
        raise MXNetError("flash_fwd: k %s and v %s do not match q %s"
                         % (tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise MXNetError("flash_fwd: head dim %d outside 1..%d"
                         % (d, _MAX_HEAD_DIM))
    if b * h > 65535 or max(b * h * sq, b * h * sk) * d >= 2 ** 62 or \
            max(sq, sk) >= 2 ** 31:
        raise MXNetError("flash_fwd: shape %s is too large for the kernel's "
                         "grid" % (tuple(q.shape),))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if b * h * sq == 0:
        return (o, lse) if with_lse else o
    lib = _cuda.load("flash_fwd", _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(),
                           lse.data_ptr() if with_lse else None,
                           b * h, sq, sk, d, float(sm_scale), int(causal),
                           _KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise MXNetError("flash_fwd: kernel launch failed with CUDA error "
                         "%d" % rc)
    flash_fwd.launches += 1
    return (o, lse) if with_lse else o


flash_fwd.launches = 0


def flash_attention(q, k, v, causal=False, sm_scale=None, chunk=512,
                    with_lse=False):
    """Flash attention, (B, H, S, D) layout.

    Mixed input dtypes are promoted once.  CUDA tensors run the Hopper
    kernel (``flash_fwd``), which raises on anything it does not take;
    tensors elsewhere (the CPU, or the meta device during shape
    inference) run the plain chunked version, *chunk* keys at a time."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    qc, kc, vc = q.to(dt), k.to(dt), v.to(dt)
    if q.device.type == "cuda":
        res = flash_fwd(qc.contiguous(), kc.contiguous(), vc.contiguous(),
                        causal, float(sm_scale), with_lse)
    else:
        res = _chunked_attention(qc, kc, vc, causal, sm_scale, chunk,
                                 with_lse)
    if with_lse:
        return res[0].to(q.dtype), res[1]
    return res.to(q.dtype)


@register_op("_contrib_DotProductAttention",
             input_names=("query", "key", "value"))
def _dot_product_attention(query, key, value, causal=False, sm_scale=None,
                           chunk=512):
    """Fused scaled-dot-product attention over the flash forward."""
    return flash_attention(query, key, value, causal=bool(causal),
                           sm_scale=sm_scale, chunk=chunk)
