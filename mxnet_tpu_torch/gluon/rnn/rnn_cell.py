"""Recurrent cells: one step of a recurrence as a HybridBlock (port of
``mxnet_tpu/gluon/rnn/rnn_cell.py``): ``RNNCell``, ``LSTMCell``,
``GRUCell``, ``SequentialRNNCell``, ``ModifierCell``, ``DropoutCell``,
``ResidualCell``, ``BidirectionalCell`` and ``RecurrentCell.unroll``.

``unroll`` without ``begin_state`` starts from zeros on the inputs'
device.
"""

from __future__ import annotations

from ..block import HybridBlock
from ... import ndarray as nd

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell",
           "BidirectionalCell", "ResidualCell", "ModifierCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _steps(inputs, length, axis):
    """A list of *length* per-step arrays from one array or a list."""
    if isinstance(inputs, (list, tuple)):
        assert len(inputs) == length
        return list(inputs)
    steps = nd.split(inputs, num_outputs=length, axis=axis,
                     squeeze_axis=True)
    return [steps] if isinstance(steps, nd.NDArray) else list(steps)


class RecurrentCell(HybridBlock):
    """Base: a cell maps (input_t, states) -> (output_t, new_states)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells, call the modifier's begin_state"
        func = func or nd.zeros
        if kwargs.get("ctx") is None:
            kwargs.pop("ctx", None)
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(func(shape=info["shape"], **kwargs))
        return states

    def __call__(self, inputs, states, **kwargs):
        self._counter += 1
        if isinstance(states, nd.NDArray):
            states = [states]
        return super().__call__(inputs, *states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell *length* steps.  *inputs*: (B, T, C) for NTC,
        (T, B, C) for TNC, or a list of T (B, C) arrays.  Returns
        (outputs, final states), the outputs merged into one array unless
        *merge_outputs* is False."""
        self.reset()
        axis = layout.find("T")
        steps = _steps(inputs, length, axis)
        states = begin_state if begin_state is not None else \
            self.begin_state(steps[0].shape[0], ctx=steps[0].context)
        outputs = []
        for t in range(length):
            out, states = self(steps[t], states)
            outputs.append(out)
        if valid_length is not None:
            stacked = nd.stack(*outputs, axis=axis)
            stacked = nd.SequenceMask(
                stacked, valid_length, use_sequence_length=True,
                axis=axis)
            if merge_outputs is False:
                outputs = _steps(stacked, length, axis)
            else:
                return stacked, states
        if merge_outputs is None or merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states


class HybridRecurrentCell(RecurrentCell):
    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _BaseGatedCell(HybridRecurrentCell):
    """Parameter plumbing shared by the three dense-gate cells."""

    def __init__(self, hidden_size, gates, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._input_size = input_size
        g = gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(g * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(g * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def _proj(self, F, x, h, i2h_weight, h2h_weight, i2h_bias, h2h_bias,
              gates):
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size * gates)
        h2h = F.FullyConnected(h, h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size * gates)
        return i2h, h2h


class RNNCell(_BaseGatedCell):
    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, 1, input_size, **kwargs)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._proj(F, inputs, states, i2h_weight, h2h_weight,
                              i2h_bias, h2h_bias, 1)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_BaseGatedCell):
    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 4, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"} for _ in range(2)]

    def hybrid_forward(self, F, inputs, h, c, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._proj(F, inputs, h, i2h_weight, h2h_weight,
                              i2h_bias, h2h_bias, 4)
        slices = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1)
        i = F.Activation(slices[0], act_type="sigmoid")
        f = F.Activation(slices[1], act_type="sigmoid")
        g = F.Activation(slices[2], act_type="tanh")
        o = F.Activation(slices[3], act_type="sigmoid")
        nc = f * c + i * g
        nh = o * F.Activation(nc, act_type="tanh")
        return nh, [nh, nc]


class GRUCell(_BaseGatedCell):
    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 3, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, h, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._proj(F, inputs, h, i2h_weight, h2h_weight,
                              i2h_bias, h2h_bias, 3)
        xi = F.SliceChannel(i2h, num_outputs=3, axis=1)
        hi = F.SliceChannel(h2h, num_outputs=3, axis=1)
        r = F.Activation(xi[0] + hi[0], act_type="sigmoid")
        z = F.Activation(xi[1] + hi[1], act_type="sigmoid")
        n = F.Activation(xi[2] + r * hi[2], act_type="tanh")
        nh = (1 - z) * n + z * h
        return nh, [nh]


class SequentialRNNCell(RecurrentCell):
    """Stacked cells; their states are concatenated."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._cells = []

    def add(self, cell):
        self.register_child(cell)
        self._cells.append(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._cells, batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return _cells_begin_state(self._cells, batch_size=batch_size,
                                  **kwargs)

    def __call__(self, inputs, states, **kwargs):
        self._counter += 1
        if isinstance(states, nd.NDArray):
            states = [states]
        next_states = []
        pos = 0
        for cell in self._cells:
            n = len(cell.state_info())
            inputs, st = cell(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(st)
        return inputs, next_states

    def __len__(self):
        return len(self._cells)

    def __getitem__(self, i):
        return self._cells[i]


class ModifierCell(HybridRecurrentCell):
    """Base of the cells that wrap another cell."""

    def __init__(self, base_cell, **kwargs):
        super().__init__(**kwargs)
        base_cell._modified = True
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size,
                                           func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class DropoutCell(RecurrentCell):
    """Dropout on every step's input."""

    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def __call__(self, inputs, states, **kwargs):
        self._counter += 1
        if self._rate > 0:
            inputs = nd.Dropout(inputs, p=self._rate)
        return inputs, states if isinstance(states, list) else [states]


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def __call__(self, inputs, states, **kwargs):
        self._counter += 1
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """One cell forward and one backward over the sequence (unroll
    only)."""

    def __init__(self, l_cell, r_cell, **kwargs):
        super().__init__(**kwargs)
        self._l_cell = l_cell           # children by attribute
        self._r_cell = r_cell

    def state_info(self, batch_size=0):
        return _cells_state_info([self._l_cell, self._r_cell], batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return _cells_begin_state([self._l_cell, self._r_cell],
                                  batch_size=batch_size, **kwargs)

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped — use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        axis = layout.find("T")
        steps = _steps(inputs, length, axis)
        states = begin_state if begin_state is not None else \
            self.begin_state(steps[0].shape[0], ctx=steps[0].context)
        n_l = len(self._l_cell.state_info())
        l_out, l_states = self._l_cell.unroll(
            length, steps, states[:n_l], layout="NTC", merge_outputs=False)
        r_out, r_states = self._r_cell.unroll(
            length, list(reversed(steps)), states[n_l:], layout="NTC",
            merge_outputs=False)
        outs = [nd.concat(lo, ro, dim=1)
                for lo, ro in zip(l_out, list(reversed(r_out)))]
        if merge_outputs is None or merge_outputs:
            outs = nd.stack(*outs, axis=axis)
        return outs, l_states + r_states
