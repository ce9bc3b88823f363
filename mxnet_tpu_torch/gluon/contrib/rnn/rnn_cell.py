"""Contrib cells (port of ``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``):
``VariationalDropoutCell`` and ``LSTMPCell``."""

from __future__ import annotations

from ...rnn.rnn_cell import ModifierCell, HybridRecurrentCell
from .... import ndarray as nd

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Locked (variational) dropout: one mask per sequence, drawn at the
    first step and reused at every step, on the inputs, the states and
    the outputs as configured."""

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0., **kwargs):
        super().__init__(base_cell, **kwargs)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._input_mask = None
        self._state_masks = None
        self._output_mask = None

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_masks = None
        self._output_mask = None

    @staticmethod
    def _mask(arr, p):
        # a keep-mask scaled by 1 / (1 - p); Dropout is the identity
        # outside training, so inference is unmasked
        return nd.Dropout(nd.ones_like(arr), p=p)

    def __call__(self, inputs, states, **kwargs):
        self._counter += 1
        if self.drop_inputs:
            if self._input_mask is None:
                self._input_mask = self._mask(inputs, self.drop_inputs)
            inputs = inputs * self._input_mask
        if self.drop_states:
            if self._state_masks is None:
                self._state_masks = [self._mask(s, self.drop_states)
                                     for s in states]
            states = [s * m for s, m in zip(states, self._state_masks)]
        output, states = self.base_cell(inputs, states)
        if self.drop_outputs:
            if self._output_mask is None:
                self._output_mask = self._mask(output, self.drop_outputs)
            output = output * self._output_mask
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)


class LSTMPCell(HybridRecurrentCell):
    """An LSTM with a projection of its hidden state (Sak et al. 2014)."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, projection_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size),
                init=h2r_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, r, c, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size * 4)
        h2h = F.FullyConnected(r, h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size * 4)
        sl = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1)
        i = F.Activation(sl[0], act_type="sigmoid")
        f = F.Activation(sl[1], act_type="sigmoid")
        g = F.Activation(sl[2], act_type="tanh")
        o = F.Activation(sl[3], act_type="sigmoid")
        nc = f * c + i * g
        hidden = o * F.Activation(nc, act_type="tanh")
        nr = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                              num_hidden=self._projection_size)
        return nr, [nr, nc]
