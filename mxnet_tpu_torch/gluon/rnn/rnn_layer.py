"""Fused recurrent layers over the RNN op (port of
``mxnet_tpu/gluon/rnn/rnn_layer.py``).

Each layer owns per-(layer, direction) parameters named as in the
reference (``{l|r}{i}_{i2h|h2h}_{weight|bias}``) and packs them into the
op's flat vector at forward time: all weights, then all biases, each in
(layer, direction, i2h/h2h) order, the op's ``_unpack`` layout.
"""

from __future__ import annotations

from ..block import HybridBlock
from ... import ndarray as nd

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError("layout must be TNC or NTC, got %r" % layout)
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._dtype = dtype
        self._gates = _GATES[mode]
        ng, nh = self._gates, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for d in ("l", "r")[:self._dir]:
                    in_sz = input_size if i == 0 else hidden_size * self._dir
                    for conn, wshape, bshape in (
                            ("i2h", (ng * nh, in_sz), (ng * nh,)),
                            ("h2h", (ng * nh, nh), (ng * nh,))):
                        wname = "%s%d_%s_weight" % (d, i, conn)
                        bname = "%s%d_%s_bias" % (d, i, conn)
                        winit = i2h_weight_initializer if conn == "i2h" \
                            else h2h_weight_initializer
                        binit = i2h_bias_initializer if conn == "i2h" \
                            else h2h_bias_initializer
                        setattr(self, wname, self.params.get(
                            wname, shape=wshape, init=winit, dtype=dtype,
                            allow_deferred_init=True))
                        setattr(self, bname, self.params.get(
                            bname, shape=bshape, init=binit, dtype=dtype))

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size,
                 self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"} for _ in range(n)]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (or *func*'s) of ``state_info(batch_size)``; pass
        ``ctx=`` for the device (default: the current context)."""
        func = func or nd.zeros
        if kwargs.get("ctx") is None:
            kwargs.pop("ctx", None)
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _finish_deferred(self, x):
        """Resolve layer 0's input size from the first real input (the
        feature axis is last in both layouts)."""
        if self._input_size:
            return
        in_sz = x.shape[2]
        self._input_size = in_sz
        ng, nh = self._gates, self._hidden_size
        for d in ("l", "r")[:self._dir]:
            getattr(self, "%s0_i2h_weight" % d).shape = (ng * nh, in_sz)
        for p in self.collect_params().values():
            if p._deferred_init is not None and p._known():
                p._finish_deferred_init()

    def __call__(self, inputs, states=None, **kwargs):
        if isinstance(inputs, nd.NDArray):
            self._finish_deferred(inputs)
        if states is None:
            # no states: the op starts from zeros, eagerly and in a trace
            return super().__call__(inputs)
        if isinstance(states, nd.NDArray) or not isinstance(
                states, (list, tuple)):
            states = [states]
        out = super().__call__(inputs, *states)
        sep = out if isinstance(out, (list, tuple)) else [out]
        return sep[0], list(sep[1:])

    def hybrid_forward(self, F, inputs, *states, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        parts = []
        for conn in ("weight", "bias"):
            for i in range(self._num_layers):
                for d in ("l", "r")[:self._dir]:
                    for loc in ("i2h", "h2h"):
                        p = params["%s%d_%s_%s" % (d, i, loc, conn)]
                        parts.append(F.reshape(p, shape=(-1,)))
        flat = F.concat(*parts, dim=0) if len(parts) > 1 else parts[0]
        rnn_out = F.RNN(inputs, flat, *states,
                        state_size=self._hidden_size,
                        num_layers=self._num_layers,
                        bidirectional=self._dir == 2,
                        p=self._dropout, state_outputs=bool(states),
                        mode=self._mode)
        if not states:
            outputs, states_out = rnn_out, []
        else:
            outputs, states_out = rnn_out[0], list(rnn_out[1:])
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        if not states_out:
            return outputs
        return [outputs] + states_out

    def __repr__(self):
        return "%s(%s, %d, layers=%d%s)" % (
            type(self).__name__, self._mode, self._hidden_size,
            self._num_layers, ", bidirectional" if self._dir == 2 else "")


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (relu or tanh) layer."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 input_size=0, **kwargs):
        super().__init__("rnn_" + activation, hidden_size, num_layers,
                         layout, dropout, bidirectional,
                         input_size=input_size, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM layer (gate order i, f, g, o)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size=input_size, **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU layer (gate order r, z, n; reset after the
    recurrent product)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size=input_size, **kwargs)
