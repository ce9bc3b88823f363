"""Scaled-dot-product attention (port of ``mxnet_tpu/ops/attention.py``).

Layout is (batch, heads, seq, head_dim) at every public function.

- ``attention_reference``: O(S^2)-memory attention, the numeric oracle.
- ``_chunked_attention``: the plain PyTorch version of the flash forward,
  a port of the JAX package's ``_chunked_attention`` with its online
  softmax (``_online_softmax_update`` / ``_finalize_softmax``), able to
  return the logsumexp too.  CPU tensors run it.
- ``_flash_bwd_dkdv_plain`` / ``_flash_bwd_dq_plain``: the plain versions
  of the two backward kernels, blockwise over *chunk* keys (dK, dV) or
  queries (dQ), with p recomputed from the saved logsumexp.
- ``flash_fwd``: the wrapper of the hand-written Hopper kernels of
  ``mxnet_tpu_torch/csrc/flash_fwd.cu``, which replace the TPU kernel
  ``_flash_fwd_kernel`` (``mxnet_tpu/ops/attention.py:164``).  At the
  serving shape the work is bound by operations, not bytes (about 128
  flop per byte moved in f32).  A rule on dtype, head dim and alignment
  (``_fwd_route``) picks one of three kernels: 16-bit storage at D <= 128
  runs on the tensor cores (wgmma on a TMA ring, P kept in registers);
  float32, and the 16-bit shapes off that route up to D = 256, run the
  register-tiled FMA kernel on a cp.async stream; D > 256 the wide
  kernel.  See the source's header.
- ``flash_bwd_dkdv`` / ``flash_bwd_dq`` (and ``flash_bwd``, which runs
  both): the wrappers of ``mxnet_tpu_torch/csrc/flash_bwd.cu``, which
  replaces ``_flash_bwd_dkdv_kernel`` (attention.py:335) and
  ``_flash_bwd_dq_kernel`` (:380).  Also bound by operations; see the
  source's header.  ``_dkdv_route`` picks dK/dV's kernel by the forward's
  rule, with dout's base among the aligned ones: 16-bit storage at D <= 128
  runs on the tensor cores (S^T and dP^T by wgmma, P^T and dS^T kept in
  registers for dV and dK); the rest as the forward.  dQ runs the
  register-tiled kernel in every dtype up to D = 256.
- ``_FlashAttention``: the ``torch.autograd.Function`` over the forward
  with lse and the two backward kernels (the JAX package's
  ``jax.custom_vjp`` ``_flash``, attention.py:482-499).
- ``flash_attention``: the dispatcher.  A CUDA tensor launches the kernels
  or raises; there is no fallback to the plain versions.
- ``_contrib_DotProductAttention``: the registered operator.

Each wrapper counts its kernel's launches in its ``launches`` attribute.
A call made while its stream is being captured into a CUDA graph only
records the kernel into the graph, and counts in ``captured`` instead;
``launch_counts`` and ``capture_counts`` read both per kernel.
``flash_fwd`` and ``flash_bwd_dkdv`` also split their launches by route
(``launches_by_route``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _cuda
from .registry import register_op

__all__ = ["flash_attention", "attention_reference", "flash_fwd",
           "flash_bwd", "flash_bwd_dkdv", "flash_bwd_dq", "launch_counts",
           "capture_counts"]

_NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The largest head dim the kernels take (``kMaxHeadDim`` in both CUDA
# sources).  D <= 256 runs the register-tiled kernels, a compile-time tile
# for each padded head dim (32, 64, 128, 256); past 256, simple kernels
# that keep a warp's row operands and float32 sums in shared memory, whose
# wide dK/dV block (4 warps x 4 float32 rows of D) sets the bound: 2048 is
# the largest power of two whose block fits a block's 227 KB.
KERNEL_MAX_HEAD_DIM = 2048


def _acc_dtype(t):
    """The dtype the plain versions accumulate in: float32, or float64
    for float64 inputs (so ``gradcheck`` can run them)."""
    return torch.promote_types(t.dtype, torch.float32)


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
    """One online-softmax step over masked scores *s* against value block
    *vb*.  p goes to vb's storage dtype for the P.V product while the
    o/m/l state stays in o's dtype (products of two storage-dtype values
    are exact in f32, so this is f32 accumulation of storage-dtype
    products, as on the TPU)."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    o = o * alpha[..., None] + torch.matmul(p.to(vb.dtype).to(o.dtype),
                                            vb.to(o.dtype))
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
    acc = _acc_dtype(q)
    chunk = max(1, min(int(chunk), sk))
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    o = torch.zeros(b, h, sq, d, dtype=acc, device=q.device)
    m = torch.full((b, h, sq), _NEG_INF, dtype=acc, device=q.device)
    l = torch.zeros(b, h, sq, dtype=acc, device=q.device)
    qf = q.to(acc)
    for c0 in range(0, sk, chunk):
        kb = k[:, :, c0:c0 + chunk]
        vb = v[:, :, c0:c0 + chunk]
        s = torch.matmul(qf, kb.to(acc).transpose(-1, -2)) * sm_scale
        if causal:
            k_pos = torch.arange(c0, c0 + kb.shape[2], device=q.device)
            valid = k_pos[None, :] <= q_pos[:, None]
            s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        o, m, l = _online_softmax_update(o, m, l, s, vb)
    out, lse = _finalize_softmax(o, m, l)
    out = out.to(q.dtype)
    return (out, lse) if with_lse else out


def _bwd_p(qb, kb, lse_b, q0, k0, sq, sk, causal, sm_scale):
    """The recomputed softmax block p = exp(q k^T * scale - lse) of
    queries [q0, ...) against keys [k0, ...) (``_bwd_p_block``,
    attention.py:315); masked scores sit at the -1e30 sentinel."""
    s = torch.matmul(qb, kb.transpose(-1, -2)) * sm_scale
    if causal:
        q_pos = torch.arange(q0, q0 + qb.shape[2], device=qb.device) + \
            (sk - sq)
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=qb.device)
        s = s.masked_fill(k_pos[None, :] > q_pos[:, None], _NEG_INF)
    return torch.exp(s - lse_b[..., None])


def _delta(o, dout):
    """delta = rowsum(dO * O), the per-row term of ds (attention.py:434)."""
    acc = _acc_dtype(o)
    return (dout.to(acc) * o.to(acc)).sum(dim=-1)


def _flash_bwd_dkdv_plain(q, k, v, dout, lse, delta, causal=False,
                          sm_scale=None, chunk=512):
    """dK and dV, *chunk* keys at a time against every query: the plain
    version of the dkdv kernel.  Rounds where the TPU kernel does
    (``dv += round(p, dO.dtype)^T dO``, ``dk += round(ds, q.dtype)^T q``)
    and accumulates in f32."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sq, sk = q.shape[2], k.shape[2]
    acc = _acc_dtype(q)
    qf, dof = q.to(acc), dout.to(acc)
    dk = torch.empty(k.shape, dtype=acc, device=k.device)
    dv = torch.empty(v.shape, dtype=acc, device=v.device)
    chunk = max(1, int(chunk))
    for c0 in range(0, sk, chunk):
        kb = k[:, :, c0:c0 + chunk].to(acc)
        vb = v[:, :, c0:c0 + chunk].to(acc)
        p = _bwd_p(qf, kb, lse, 0, c0, sq, sk, causal, sm_scale)
        dv[:, :, c0:c0 + chunk] = torch.matmul(
            p.to(dout.dtype).to(acc).transpose(-1, -2), dof)
        ds = p * (torch.matmul(dof, vb.transpose(-1, -2))
                  - delta[..., None]) * sm_scale
        dk[:, :, c0:c0 + chunk] = torch.matmul(
            ds.to(q.dtype).to(acc).transpose(-1, -2), qf)
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal=False,
                        sm_scale=None, chunk=512):
    """dQ, *chunk* queries at a time against every key: the plain version
    of the dq kernel (``dq += round(ds, k.dtype) k``, f32 sums)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sq, sk = q.shape[2], k.shape[2]
    acc = _acc_dtype(q)
    kf, vf = k.to(acc), v.to(acc)
    dq = torch.empty(q.shape, dtype=acc, device=q.device)
    chunk = max(1, int(chunk))
    for c0 in range(0, sq, chunk):
        sl = slice(c0, c0 + chunk)
        dob = dout[:, :, sl].to(acc)
        p = _bwd_p(q[:, :, sl].to(acc), kf, lse[:, :, sl], c0, 0, sq, sk,
                   causal, sm_scale)
        ds = p * (torch.matmul(dob, vf.transpose(-1, -2))
                  - delta[:, :, sl, None]) * sm_scale
        dq[:, :, sl] = torch.matmul(ds.to(k.dtype).to(acc), kf)
    return dq.to(q.dtype)


def _flash_bwd_plain(q, k, v, o, lse, dout, causal=False, sm_scale=None,
                     chunk=512):
    """(dq, dk, dv) by the plain versions of both backward kernels."""
    delta = _delta(o, dout)
    dk, dv = _flash_bwd_dkdv_plain(q, k, v, dout, lse, delta, causal,
                                   sm_scale, chunk)
    dq = _flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal, sm_scale,
                             chunk)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_qkv(who, q, k, v, dout=None):
    """The checks every attention kernel's wrapper makes: q (B, H, Sq, D),
    k and v (B, H, Sk, D), and *dout* like q, contiguous CUDA tensors on
    one device in one dtype of float32 / bfloat16 / float16, D <= 2048
    (``KERNEL_MAX_HEAD_DIM``), element offsets within 2**62, and B*H, Sq, Sk
    within the kernels' 32-bit ints (B*H goes on grid.x, which takes up to
    2**31 - 1).  Returns (b, h, sq, sk, d)."""
    named = [("q", q), ("k", k), ("v", v)]
    if dout is not None:
        named.append(("dout", dout))
    for name, t in named:
        if t.device.type != "cuda":
            raise MXNetError("%s: %s is on %s; the kernel takes CUDA "
                             "tensors" % (who, name, t.device))
        if t.dim() != 4:
            raise MXNetError("%s: %s must be (B, H, S, D), got shape %s"
                             % (who, name, tuple(t.shape)))
        if not t.is_contiguous():
            raise MXNetError("%s: %s must be contiguous (strides %s)"
                             % (who, name, t.stride()))
    if any(t.device != q.device for _, t in named):
        raise MXNetError("%s: inputs on different devices" % who)
    if any(t.dtype != q.dtype for _, t in named) or \
            q.dtype not in _KERNEL_DTYPES:
        raise MXNetError("%s: %s must share one dtype of %s, got %s" % (
            who, ", ".join(n for n, _ in named),
            sorted(map(str, _KERNEL_DTYPES)), tuple(t.dtype for _, t in named)))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d):
        raise MXNetError("%s: k %s and v %s do not match q %s"
                         % (who, tuple(k.shape), tuple(v.shape),
                            tuple(q.shape)))
    if dout is not None and dout.shape != q.shape:
        raise MXNetError("%s: dout %s does not match q %s"
                         % (who, tuple(dout.shape), tuple(q.shape)))
    if not 1 <= d <= KERNEL_MAX_HEAD_DIM:
        raise MXNetError("%s: head dim %d outside 1..%d (KERNEL_MAX_HEAD_DIM,"
                         " set by the kernels' shared memory)"
                         % (who, d, KERNEL_MAX_HEAD_DIM))
    if max(b * h * sq, b * h * sk) * d >= 2 ** 62 or \
            max(sq, sk, b * h) >= 2 ** 31:
        raise MXNetError("%s: shape %s is too large for the kernel's grid"
                         % (who, tuple(q.shape)))
    return b, h, sq, sk, d


def _check_rows(who, q, **rows):
    """lse / delta: contiguous float32 (B, H, Sq) on q's device."""
    for name, t in rows.items():
        if t.device != q.device or t.dtype != torch.float32 or \
                tuple(t.shape) != tuple(q.shape[:3]) or \
                not t.is_contiguous():
            raise MXNetError("%s: %s must be a contiguous float32 %s on %s, "
                             "got %s %s on %s" % (
                                 who, name, tuple(q.shape[:3]), q.device,
                                 t.dtype, tuple(t.shape), t.device))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(wrapper, capturing):
    """One kernel launch of *wrapper*, or, when its stream was
    *capturing*, one record of the kernel into a CUDA graph."""
    if capturing:
        wrapper.captured += 1
    else:
        wrapper.launches += 1


# flash_fwd's routes, indexed as the source's flash_fwd_route numbers them
FWD_ROUTES = ("simt", "wide", "wgmma")


def _fwd_route(dtype, d, aligned):
    """The kernel a ``flash_fwd`` launch takes: "wgmma" (the tensor-core
    kernel) for bfloat16 / float16 storage at D <= 128 with rows of whole
    16-byte chunks (D % 8 == 0) and q, k, v bases 16-byte aligned
    (*aligned*); else "simt" (the register-tiled FMA kernel) up to D =
    256 and "wide" past it.  The same rule as the source's ``route``
    (``flash_fwd_route`` in the library)."""
    if dtype in (torch.bfloat16, torch.float16) and d <= 128 and \
            d % 8 == 0 and aligned:
        return "wgmma"
    return "simt" if d <= 256 else "wide"


# flash_bwd_dkdv's routes, indexed as the source's flash_bwd_dkdv_route
# numbers them (the same three as the forward's)
DKDV_ROUTES = FWD_ROUTES


def _dkdv_route(dtype, d, aligned):
    """The kernel a ``flash_bwd_dkdv`` launch takes: "wgmma" (the
    tensor-core kernel) for bfloat16 / float16 storage at D <= 128 with
    rows of whole 16-byte chunks (D % 8 == 0) and q, k, v and dout bases
    16-byte aligned (*aligned*); else "simt" (the register-tiled FMA
    kernel) up to D = 256 and "wide" past it.  The same rule as the
    source's ``route`` (``flash_bwd_dkdv_route`` in the library)."""
    return _fwd_route(dtype, d, aligned)


def _aligned16(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _bind_fwd(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                              ctypes.c_float, ci, ci, vp]
    lib.flash_fwd.restype = ci
    lib.flash_fwd_route.argtypes = [ci, ci, ci]
    lib.flash_fwd_route.restype = ci


def _bind_bwd(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    tail = [ci, ci, ci, ci, ctypes.c_float, ci, ci, vp]
    lib.flash_bwd_dkdv.argtypes = [vp] * 8 + tail
    lib.flash_bwd_dkdv.restype = ci
    lib.flash_bwd_dq.argtypes = [vp] * 7 + tail
    lib.flash_bwd_dq.restype = ci
    lib.flash_bwd_dkdv_route.argtypes = [ci, ci, ci]
    lib.flash_bwd_dkdv_route.restype = ci


def flash_fwd(q, k, v, causal=False, sm_scale=None, with_lse=False):
    """Launch the Hopper flash-attention forward on CUDA tensors.

    q (B, H, Sq, D), k and v (B, H, Sk, D): contiguous, on one CUDA
    device, one dtype of float32 / bfloat16 / float16, D <= 2048
    (``KERNEL_MAX_HEAD_DIM``).  Returns o (like q), and with *with_lse* also the f32 logsumexp
    (B, H, Sq).  Raises on any input the kernel does not take."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, sq, sk, d = _check_qkv("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if b * h * sq == 0:
        return (o, lse) if with_lse else o
    route = _fwd_route(q.dtype, d, _aligned16(q, k, v))
    lib = _cuda.load("flash_fwd", _bind_fwd)
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(),
                           lse.data_ptr() if with_lse else None,
                           b * h, sq, sk, d, float(sm_scale), int(causal),
                           _KERNEL_DTYPES[q.dtype], _stream(q))
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise MXNetError("flash_fwd: kernel launch failed with CUDA error "
                         "%d (route %s)" % (rc, route))
    _count(flash_fwd, capturing)
    if not capturing:
        flash_fwd.launches_by_route[route] += 1
    return (o, lse) if with_lse else o


flash_fwd.launches = 0
flash_fwd.captured = 0
# the launches split by the route each took (``_fwd_route``)
flash_fwd.launches_by_route = dict.fromkeys(FWD_ROUTES, 0)


def flash_bwd_dkdv(q, k, v, dout, lse, delta, causal=False, sm_scale=None):
    """Launch the Hopper dK/dV kernel: (dk, dv), like k and v.

    q, dout (B, H, Sq, D), k, v (B, H, Sk, D) as ``flash_fwd`` takes them;
    lse (the forward's) and delta (``rowsum(dout * o)``) contiguous
    float32 (B, H, Sq).  Raises on any input the kernel does not take."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, sq, sk, d = _check_qkv("flash_bwd_dkdv", q, k, v, dout)
    _check_rows("flash_bwd_dkdv", q, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if b * h * sk == 0:
        return dk, dv
    if sq == 0:
        return dk.zero_(), dv.zero_()
    route = _dkdv_route(q.dtype, d, _aligned16(q, k, v, dout))
    lib = _cuda.load("flash_bwd", _bind_bwd)
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, sq, sk, d, float(sm_scale), int(causal),
            _KERNEL_DTYPES[q.dtype], _stream(q))
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise MXNetError("flash_bwd_dkdv: kernel launch failed with CUDA "
                         "error %d (route %s)" % (rc, route))
    _count(flash_bwd_dkdv, capturing)
    if not capturing:
        flash_bwd_dkdv.launches_by_route[route] += 1
    return dk, dv


flash_bwd_dkdv.launches = 0
flash_bwd_dkdv.captured = 0
# the launches split by the route each took (``_dkdv_route``)
flash_bwd_dkdv.launches_by_route = dict.fromkeys(DKDV_ROUTES, 0)


def flash_bwd_dq(q, k, v, dout, lse, delta, causal=False, sm_scale=None):
    """Launch the Hopper dQ kernel: dq, like q.  Inputs as
    ``flash_bwd_dkdv`` takes them; raises on any it does not take."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, sq, sk, d = _check_qkv("flash_bwd_dq", q, k, v, dout)
    _check_rows("flash_bwd_dq", q, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    if b * h * sq == 0:
        return dq
    if sk == 0:
        return dq.zero_()
    lib = _cuda.load("flash_bwd", _bind_bwd)
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b * h, sq, sk, d, float(sm_scale), int(causal),
            _KERNEL_DTYPES[q.dtype], _stream(q))
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise MXNetError("flash_bwd_dq: kernel launch failed with CUDA "
                         "error %d" % rc)
    _count(flash_bwd_dq, capturing)
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.captured = 0


_WRAPPERS = (flash_fwd, flash_bwd_dkdv, flash_bwd_dq)


def launch_counts():
    """{kernel: launches} of every kernel wrapper."""
    return {w.__name__: w.launches for w in _WRAPPERS}


def capture_counts():
    """{kernel: calls recorded into CUDA graphs} of every kernel
    wrapper."""
    return {w.__name__: w.captured for w in _WRAPPERS}


def flash_bwd(q, k, v, o, lse, dout, causal=False, sm_scale=None):
    """The attention gradient on CUDA tensors: (dq, dk, dv) from the
    forward's inputs, output *o* and f32 *lse*, and the output gradient
    *dout*.  delta = rowsum(dout * o) is one PyTorch reduction; the
    products run in the two Hopper kernels."""
    if o.shape != q.shape:
        raise MXNetError("flash_bwd: o %s does not match q %s"
                         % (tuple(o.shape), tuple(q.shape)))
    delta = _delta(o, dout)
    dk, dv = flash_bwd_dkdv(q, k, v, dout, lse, delta, causal, sm_scale)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal, sm_scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: (o, lse) from q, k, v; lse is
    not differentiable.  Saves (q, k, v, o, lse).  CUDA tensors run
    ``flash_fwd(..., with_lse=True)`` and ``flash_bwd``; CPU tensors the
    plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, chunk):
        if q.device.type == "cuda":
            o, lse = flash_fwd(q, k, v, causal, sm_scale, with_lse=True)
        else:
            o, lse = _chunked_attention(q, k, v, causal, sm_scale, chunk,
                                        with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.sm_scale, ctx.chunk = causal, sm_scale, chunk
        return o, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        if q.device.type == "cuda":
            dq, dk, dv = flash_bwd(q, k, v, o, lse, dout, ctx.causal,
                                   ctx.sm_scale)
        else:
            dq, dk, dv = _flash_bwd_plain(q, k, v, o, lse, dout, ctx.causal,
                                          ctx.sm_scale, ctx.chunk)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None, chunk=512,
                    with_lse=False):
    """Flash attention, (B, H, S, D) layout.

    Mixed input dtypes are promoted once.  CUDA tensors run the Hopper
    kernels (``flash_fwd``, and ``flash_bwd`` for the gradient), which
    raise on anything they do not take; tensors elsewhere (the CPU, or
    the meta device during shape inference) run the plain chunked
    versions, *chunk* keys at a time.  The ``_FlashAttention`` Function
    is taken only when a gradient is needed (grad mode on and an input
    that requires grad); otherwise no lse is kept.

    On CUDA the head dim D is at most ``KERNEL_MAX_HEAD_DIM`` (2048) and
    a larger one raises ``MXNetError``.  The forward and the dK/dV
    gradient of 16-bit inputs with D <= 128 (D % 8 == 0, 16-byte aligned
    bases) run on the tensor cores (``_fwd_route``, ``_dkdv_route``).
    Otherwise D <= 256 runs the register-tiled
    kernels, one compile-time tile for each padded head dim (32, 64, 128,
    256); a larger D runs simple kernels that keep each warp's row and its
    float32 sums in shared memory, whose size sets the bound (the JAX
    package's Pallas path has a memory-set bound too: a 1024-row block of
    D-wide rows in VMEM).  B*H may exceed 65535."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    qc, kc, vc = q.to(dt), k.to(dt), v.to(dt)
    cuda = q.device.type == "cuda"
    if cuda:
        qc, kc, vc = qc.contiguous(), kc.contiguous(), vc.contiguous()
    if torch.is_grad_enabled() and (qc.requires_grad or kc.requires_grad or
                                    vc.requires_grad):
        res = _FlashAttention.apply(qc, kc, vc, bool(causal),
                                    float(sm_scale), int(chunk))
        if not with_lse:
            res = res[0]
    elif cuda:
        res = flash_fwd(qc, kc, vc, causal, float(sm_scale), with_lse)
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
    """Fused scaled-dot-product attention over the flash kernels.  On
    CUDA the head dim is at most ``KERNEL_MAX_HEAD_DIM`` (2048;
    ``flash_attention`` says why) and a larger one raises ``MXNetError``;
    the CPU takes any."""
    return flash_attention(query, key, value, causal=bool(causal),
                           sm_scale=sm_scale, chunk=chunk)
