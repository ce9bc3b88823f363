"""Convolutional recurrent cells (port of
``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``):
``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``.

The gates come from two convolutions (input to hidden, hidden to hidden)
instead of dense products, on the port's ``Convolution`` (float32 in full
float32 on cuDNN); states are (batch, channels, *spatial).
"""

from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _to_tuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvGateCell(HybridRecurrentCell):
    """The i2h and h2h convolutions over spatial states."""

    def __init__(self, input_shape, hidden_channels, gates, dims,
                 i2h_kernel, h2h_kernel, i2h_pad=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 conv_layout="NCHW", activation="tanh", **kwargs):
        super().__init__(**kwargs)
        self._dims = dims
        self._input_shape = tuple(input_shape)  # (C, *spatial)
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._i2h_kernel = _to_tuple(i2h_kernel, dims)
        self._h2h_kernel = _to_tuple(h2h_kernel, dims)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise ValueError(
                    "h2h_kernel dimensions must be odd so the state "
                    "shape is preserved (got %r)" % (self._h2h_kernel,))
        self._i2h_pad = _to_tuple(i2h_pad, dims)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        in_c = self._input_shape[0]
        g = gates
        # the state's spatial extent: input + 2 pad - kernel + 1
        self._state_shape = (hidden_channels,) + tuple(
            s + 2 * p - k + 1 for s, p, k in
            zip(self._input_shape[1:], self._i2h_pad, self._i2h_kernel))
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight",
                shape=(g * hidden_channels, in_c) + self._i2h_kernel,
                init=i2h_weight_initializer)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(g * hidden_channels, hidden_channels) +
                self._h2h_kernel,
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(g * hidden_channels,),
                init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(g * hidden_channels,),
                init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        shape = (batch_size,) + self._state_shape
        return [{"shape": shape, "__layout__": "NC" + "DHW"[-self._dims:]}
                ] * self._num_states

    def _conv_gates(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                    h2h_bias):
        g = self._gates
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            num_filter=g * self._hidden_channels)
        h2h = F.Convolution(h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            num_filter=g * self._hidden_channels)
        return i2h, h2h


class _ConvRNNCell(_ConvGateCell):
    _num_states = 1
    _gates = 1

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_gates(F, inputs, states, i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class _ConvLSTMCell(_ConvGateCell):
    _num_states = 2
    _gates = 4

    def hybrid_forward(self, F, inputs, h, c, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_gates(F, inputs, h, i2h_weight, h2h_weight,
                                    i2h_bias, h2h_bias)
        sl = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1)
        i = F.Activation(sl[0], act_type="sigmoid")
        f = F.Activation(sl[1], act_type="sigmoid")
        g = F.Activation(sl[2], act_type=self._activation)
        o = F.Activation(sl[3], act_type="sigmoid")
        nc = f * c + i * g
        nh = o * F.Activation(nc, act_type=self._activation)
        return nh, [nh, nc]


class _ConvGRUCell(_ConvGateCell):
    _num_states = 1
    _gates = 3

    def hybrid_forward(self, F, inputs, h, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_gates(F, inputs, h, i2h_weight, h2h_weight,
                                    i2h_bias, h2h_bias)
        xi = F.SliceChannel(i2h, num_outputs=3, axis=1)
        hi = F.SliceChannel(h2h, num_outputs=3, axis=1)
        r = F.Activation(xi[0] + hi[0], act_type="sigmoid")
        z = F.Activation(xi[1] + hi[1], act_type="sigmoid")
        n = F.Activation(xi[2] + r * hi[2], act_type=self._activation)
        nh = (1 - z) * n + z * h
        return nh, [nh]


def _make(cell_base, dims, name):
    class _Cell(cell_base):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, **kwargs):
            super().__init__(input_shape, hidden_channels,
                             self._gates, dims, i2h_kernel, h2h_kernel,
                             i2h_pad=i2h_pad, **kwargs)
    _Cell.__name__ = name
    _Cell.__qualname__ = name
    return _Cell


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell")
