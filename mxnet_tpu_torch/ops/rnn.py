"""The fused multi-layer, bidirectional RNN op (port of
``mxnet_tpu/ops/rnn.py``).

Modes ``rnn_relu``, ``rnn_tanh``, ``lstm`` and ``gru``.  The parameters
arrive packed in one vector, the reference's layout: all weights first —
per layer, per direction: W_i2h (G*H, in), W_h2h (G*H, H) — then all
biases in the same order: b_i2h (G*H,), b_h2h (G*H,).  Gate order: LSTM
i, f, g, o; GRU r, z, n with the reset gate applied after the recurrent
product (n = tanh(x_n + r * (W_hn h + b_hn))).  ``_unpack`` slices the
vector into views, so gradients flow back into the packed argument.

The JAX op is ``lax.scan``, code XLA generated rather than a Pallas
kernel, so the port runs it on PyTorch and its libraries, two routes:

- ``plain`` (a tensor on the CPU): the reference's own structure, one
  input-projection product per (layer, direction) outside the loop, then
  a per-step recurrent product and the gate math (``_scan_direction``).
  It is the CPU path and the oracle the card's route is held to.
- ``cudnn`` (a tensor on the card): PyTorch's fused recurrent functions
  (``torch.lstm``, ``torch.gru``, ``torch.rnn_tanh``, ``torch.rnn_relu``)
  on the unpacked views, which cuDNN runs.  A float32 recurrence runs in
  full float32: cuDNN's RNN precision (``torch.backends.cudnn.rnn.
  fp32_precision``) is set to "ieee" around the forward and again around
  the backward (``_FusedRNN``), as ``Convolution`` does.  PyTorch hands
  cuDNN float32, float16 and float64 only, so a bfloat16 recurrence runs
  in float32 on bfloat16 values and its results are rounded to bfloat16
  once: the hidden and cell states are kept in float32 across steps,
  where the reference rounds them to bfloat16 at every step.

Between layers, dropout (``training`` and ``p`` > 0, never after the last
layer) draws its mask from the op's generator, so with dropout the card
makes one library call per layer.  As in the reference, the LSTM clip
(``lstm_state_clip_min``/``max``, with ``lstm_state_clip_nan``) applies
to the returned cell state only, after the whole sequence; MXNet clips
each step's cell, so cuDNN's own per-step clip is not used.  The reverse
direction runs on the time-reversed sequence (no sequence lengths).

``ROUTES`` counts the op's calls by route.
"""

from __future__ import annotations

import contextlib

import torch

from ..runtime import rng as _rng
from .registry import register_op, get_op

__all__ = ["rnn_param_size", "rnn_precision", "route_of", "plain_rnn",
           "ROUTES"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}

# calls of the op by route
ROUTES = {"cudnn": 0, "plain": 0}

_FUSED_FN = {"lstm": torch.lstm, "gru": torch.gru,
             "rnn_tanh": torch.rnn_tanh, "rnn_relu": torch.rnn_relu}


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    """Total packed parameter count."""
    g = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * g * state_size * (in_sz + state_size + 2)
    return size


def _unpack(params, mode, input_size, state_size, num_layers, bidirectional):
    """Views of the packed vector: ([[(w_x, w_h) per direction] per
    layer], [[(b_x, b_h) per direction] per layer])."""
    g = _GATES[mode]
    dirs = 2 if bidirectional else 1
    h = state_size
    weights, biases = [], []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * dirs
        per_layer = []
        for _ in range(dirs):
            w_x = params[off:off + g * h * in_sz].view(g * h, in_sz)
            off += g * h * in_sz
            w_h = params[off:off + g * h * h].view(g * h, h)
            off += g * h * h
            per_layer.append((w_x, w_h))
        weights.append(per_layer)
    for layer in range(num_layers):
        per_layer = []
        for _ in range(dirs):
            b_x = params[off:off + g * h]
            off += g * h
            b_h = params[off:off + g * h]
            off += g * h
            per_layer.append((b_x, b_h))
        biases.append(per_layer)
    return weights, biases


# -- the plain route ---------------------------------------------------------

def _scan_direction(mode, x_proj, w_h, b_h, h0, c0):
    """One direction, step by step.  x_proj: (T, B, G*H) input
    projections.  Returns (outputs (T, B, H), h_T, c_T or None)."""
    outs = []
    hy, cy = h0, c0
    for xp in x_proj:
        rec = torch.matmul(hy, w_h.t()) + b_h
        if mode == "lstm":
            i, f, g, o = (xp + rec).chunk(4, dim=-1)
            cy = torch.sigmoid(f) * cy + torch.sigmoid(i) * torch.tanh(g)
            hy = torch.sigmoid(o) * torch.tanh(cy)
        elif mode == "gru":
            xr, xz, xn = xp.chunk(3, dim=-1)
            hr, hz, hn = rec.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            hy = (1 - z) * n + z * hy
        elif mode == "rnn_tanh":
            hy = torch.tanh(xp + rec)
        elif mode == "rnn_relu":
            hy = torch.relu(xp + rec)
        else:
            raise ValueError("unknown RNN mode %r" % mode)
        outs.append(hy)
    return torch.stack(outs), hy, cy


def _plain_layer(mode, x, weights, biases, h0s, c0s):
    """One layer, every direction, on the plain route: (layer output,
    [h_T per direction], [c_T per direction])."""
    outs, hs, cs = [], [], []
    for d, ((w_x, w_h), (b_x, b_h)) in enumerate(zip(weights, biases)):
        xs = torch.flip(x, (0,)) if d == 1 else x
        # one big (T*B, in) @ (in, G*H) product outside the loop
        x_proj = torch.matmul(xs, w_x.t()) + b_x
        out, hT, cT = _scan_direction(mode, x_proj, w_h, b_h, h0s[d],
                                      c0s[d] if c0s is not None else None)
        if d == 1:
            out = torch.flip(out, (0,))
        outs.append(out)
        hs.append(hT)
        cs.append(cT)
    return (outs[0] if len(outs) == 1 else torch.cat(outs, -1)), hs, cs


# -- the cudnn route ----------------------------------------------------------

def rnn_precision(dtype):
    """cuDNN's float32 RNN precision for a recurrence computed in *dtype*:
    full float32 ("ieee") for float32, None (left as it is) otherwise."""
    return "ieee" if dtype == torch.float32 else None


@contextlib.contextmanager
def _cudnn_rnn_precision(precision):
    """``torch.backends.cudnn.rnn.fp32_precision`` for the calls inside,
    restored on exit; None leaves it as it is."""
    if precision is None:
        yield
        return
    rnn = torch.backends.cudnn.rnn
    prev = rnn.fp32_precision
    rnn.fp32_precision = precision
    try:
        yield
    finally:
        rnn.fp32_precision = prev


def _fused_call(mode, num_layers, bidirectional, x, h0, c0, flat):
    """PyTorch's fused recurrent function of *mode*: (output, h_n[, c_n])."""
    fn = _FUSED_FN[mode]
    hx = (h0, c0) if mode == "lstm" else h0
    return tuple(fn(x, hx, flat, True, num_layers, 0.0,
                    torch.is_grad_enabled(), bidirectional, False))


class _FusedRNN(torch.autograd.Function):
    """The fused recurrence with its forward and its backward each run
    under one cuDNN precision.  The forward records the library call on
    an inner tape over detached inputs; the backward takes that tape's
    gradients under the precision again (autograd would otherwise run
    cuDNN's backward later, outside any block around the forward)."""

    @staticmethod
    def forward(ctx, mode, num_layers, bidirectional, precision, x, h0,
                c0, *flat):
        tensors = [x, h0] + ([c0] if c0 is not None else []) + list(flat)
        ins = [t.detach().requires_grad_(t.requires_grad) for t in tensors]
        xi, hi = ins[0], ins[1]
        ci = ins[2] if c0 is not None else None
        wi = ins[3 if c0 is not None else 2:]
        with torch.enable_grad(), _cudnn_rnn_precision(precision):
            outs = _fused_call(mode, num_layers, bidirectional, xi, hi, ci,
                               wi)
        ctx.inner = (ins, outs)
        ctx.precision = precision
        ctx.has_c = c0 is not None
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *gouts):
        ins, outs = ctx.inner
        ctx.inner = None
        want = [t for t in ins if t.requires_grad]
        with _cudnn_rnn_precision(ctx.precision):
            grads = torch.autograd.grad(outs, want, gouts, allow_unused=True)
        it = iter(grads)
        got = [next(it) if t.requires_grad else None for t in ins]
        x_g, h_g = got[0], got[1]
        c_g = got[2] if ctx.has_c else None
        w_g = got[3 if ctx.has_c else 2:]
        return (None, None, None, None, x_g, h_g, c_g, *w_g)


def _cudnn_layers(mode, x, weights, biases, h0, c0, bidirectional):
    """The layers of *weights*/*biases* (their views) in one library call
    in the compute dtype: (output, h_n, c_n or None)."""
    flat = []
    for lw, lb in zip(weights, biases):
        for (w_x, w_h), (b_x, b_h) in zip(lw, lb):
            flat += [w_x, w_h, b_x, b_h]
    args = (mode, len(weights), bidirectional, rnn_precision(x.dtype), x,
            h0.contiguous(), c0.contiguous() if c0 is not None else None,
            *flat)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, h0, c0, *flat) if t is not None):
        res = _FusedRNN.apply(*args)
    else:
        with _cudnn_rnn_precision(args[3]):
            res = _fused_call(mode, len(weights), bidirectional, x,
                              args[5], args[6], flat)
    return res[0], res[1], (res[2] if mode == "lstm" else None)


def route_of(data):
    """The route the op takes for *data*: "cudnn" on the card, "plain" on
    the CPU."""
    return "cudnn" if data.is_cuda else "plain"


def _dropout_mask(rng, x, p):
    keep = 1.0 - p
    if rng is None:
        rng = _rng.generator(x.device)
    u = torch.rand(x.shape, generator=rng, device=x.device)
    return (u < keep).to(x.dtype) / keep


def _rnn_inputs(params):
    if params.get("mode", "lstm") == "lstm":
        return ("data", "parameters", "state", "state_cell")
    return ("data", "parameters", "state")


@register_op("RNN", needs_rng=True,
             input_names=("data", "parameters", "state", "state_cell"),
             num_outputs=lambda p: 3 if p.get("mode", "lstm") == "lstm"
             else 2,
             num_visible_outputs=lambda p:
             (3 if p.get("mode", "lstm") == "lstm" else 2)
             if p.get("state_outputs") else 1)
def _rnn(rng, data, parameters, *rest, state_size=0, num_layers=1,
         bidirectional=False, mode="lstm", p=0.0, state_outputs=False,
         lstm_state_clip_min=None, lstm_state_clip_max=None,
         lstm_state_clip_nan=False, training=True):
    """data: (T, B, input) sequence-major; optional state (L*dirs, B, H)
    and, for lstm, state_cell (zeros when omitted).  Returns (output,
    hy[, cy])."""
    return _run(route_of(data), rng, data, parameters, *rest,
                state_size=state_size, num_layers=num_layers,
                bidirectional=bidirectional, mode=mode, p=p,
                lstm_state_clip_min=lstm_state_clip_min,
                lstm_state_clip_max=lstm_state_clip_max,
                lstm_state_clip_nan=lstm_state_clip_nan, training=training)


def plain_rnn(rng, data, parameters, *rest, state_outputs=False, **params):
    """The op on the plain route whatever the device: the oracle the
    card's route is held to (same arguments as the op)."""
    return _run("plain", rng, data, parameters, *rest, **params)


def _run(route, rng, data, parameters, *rest, state_size=0, num_layers=1,
         bidirectional=False, mode="lstm", p=0.0, lstm_state_clip_min=None,
         lstm_state_clip_max=None, lstm_state_clip_nan=False,
         training=True):
    mode = str(mode)
    dirs = 2 if bidirectional else 1
    h = int(state_size)
    num_layers = int(num_layers)
    p = float(p)
    in_size = data.shape[2]
    ROUTES[route] += 1
    # the card computes a bfloat16 recurrence in float32 (module docstring)
    cdt = torch.float32 if route == "cudnn" and \
        data.dtype == torch.bfloat16 else data.dtype
    x = data.to(cdt)
    weights, biases = _unpack(parameters.to(cdt), mode, in_size, h,
                              num_layers, bidirectional)
    sshape = (num_layers * dirs, data.shape[1], h)
    state = rest[0].to(cdt) if rest else \
        torch.zeros(sshape, dtype=cdt, device=data.device)
    cell0 = None
    if mode == "lstm":
        cell0 = rest[1].to(cdt) if len(rest) > 1 else \
            torch.zeros(sshape, dtype=cdt, device=data.device)
    dropout = training and p > 0.0
    h_out, c_out = [], []
    if route == "cudnn" and not dropout:
        x, hy, cy = _cudnn_layers(mode, x, weights, biases, state, cell0,
                                  bidirectional)
        h_out, c_out = [hy], [cy]
    else:
        for layer in range(num_layers):
            lo, hi = layer * dirs, (layer + 1) * dirs
            if route == "cudnn":
                x, hy, cy = _cudnn_layers(
                    mode, x, weights[layer:layer + 1],
                    biases[layer:layer + 1], state[lo:hi],
                    cell0[lo:hi] if cell0 is not None else None,
                    bidirectional)
                h_out.append(hy)
                c_out.append(cy)
            else:
                x, hs, cs = _plain_layer(
                    mode, x, weights[layer], biases[layer],
                    list(state[lo:hi]),
                    list(cell0[lo:hi]) if cell0 is not None else None)
                h_out.append(torch.stack(hs))
                c_out.append(torch.stack(cs) if cell0 is not None else None)
            if dropout and layer < num_layers - 1:
                x = x * _dropout_mask(rng, x, p)
    out_dt = data.dtype
    hy = torch.cat(h_out).to(out_dt)
    x = x.to(out_dt)
    if mode != "lstm":
        return x, hy
    # clipped in the compute dtype, then rounded: a bfloat16 state on the
    # card is clipped where its float32 value lies, as the oracle clips it
    cy = torch.cat(c_out)
    if lstm_state_clip_min is not None and lstm_state_clip_max is not None:
        if lstm_state_clip_nan:
            # the reference's semantics: a NaN cell state becomes the
            # upper bound rather than propagating
            cy = torch.nan_to_num(cy, nan=float(lstm_state_clip_max))
        cy = torch.clamp(cy, float(lstm_state_clip_min),
                         float(lstm_state_clip_max))
    return x, hy, cy.to(out_dt)


# non-LSTM modes consume no cell state, so a symbolic RNN of another mode
# creates no phantom "state_cell" variable
get_op("RNN").active_inputs = _rnn_inputs
