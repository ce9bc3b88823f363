"""Symbolic RNN cells (port of ``mxnet_tpu/rnn/rnn_cell.py``).

The cells build unrolled Symbol graphs for the BucketingModule workflow:
one executor per sequence length, all sharing one parameter set through
``RNNParams``.  ``FusedRNNCell`` unrolls to the single fused ``RNN`` op.
"""

from __future__ import annotations

from .. import symbol as sym


class RNNParams:
    """Weight symbols shared across time steps and cells."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.var(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """The base of the symbolic cells."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def prefix(self):
        return self._prefix

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [s["shape"] for s in self.state_info]

    @property
    def _gate_names(self):
        return ("",)

    def begin_state(self, func=None, **kwargs):
        """Initial-state symbols.

        With no *func*, returns ``None`` and :meth:`unroll` builds
        zero states from the input symbol (shape inference here has no
        "0 = unknown batch" convention, so standalone zeros symbols
        cannot be created without the batch size — pass
        ``func=sym.zeros, batch_size=N`` for explicit states)."""
        if func is None:
            return None
        states = []
        batch = kwargs.pop("batch_size", 0)
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            shape = tuple(batch if s == 0 else s for s in info["shape"])
            states.append(func(name=name, shape=shape, **kwargs))
        return states

    def _zero_state_from(self, ref):
        """Zero initial states derived from a per-step input symbol
        ``ref`` of shape (batch, feat): (batch, 1) zeros tiled to each
        state's trailing dims."""
        z1 = sym.sum(ref * 0.0, axis=-1, keepdims=True)  # (batch, 1)
        states = []
        for info in self.state_info:
            shape = info["shape"]
            if len(shape) == 2:       # (batch, H)
                states.append(sym.tile(z1, reps=(1, shape[1])))
            else:                     # (L, batch, H) fused layout
                z = sym.expand_dims(z1, axis=0)       # (1, batch, 1)
                states.append(sym.tile(z, reps=(shape[0], 1, shape[2])))
        return states

    def __call__(self, inputs, states):
        raise NotImplementedError

    def unroll(self, length, inputs=None, begin_state=None,
               layout="NTC", merge_outputs=None, input_prefix=""):
        """Unroll over *length* steps.

        inputs: a single (batch, seq, feat) symbol (layout NTC), a
        (seq, batch, feat) symbol (TNC), or a list of per-step symbols.
        Returns (outputs, states): outputs is a list of per-step symbols
        or one merged symbol when merge_outputs=True.
        """
        self.reset()
        if inputs is None:
            inputs = [sym.var("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, sym.Symbol):
            axis = 1 if layout == "NTC" else 0
            inputs = list(sym.split(inputs, num_outputs=length,
                                    axis=axis, squeeze_axis=True))
        assert len(inputs) == length
        states = begin_state if begin_state is not None else \
            self._zero_state_from(inputs[0])
        outputs = []
        for i in range(length):
            out, states = self(inputs[i], states)
            outputs.append(out)
        if merge_outputs:
            axis = 1 if layout == "NTC" else 0
            merged = [sym.expand_dims(o, axis=axis) for o in outputs]
            outputs = sym.concat(*merged, dim=axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Elman RNN: h' = act(W x + b_i + U h + b_h)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(data=inputs, weight=self._iW,
                                 bias=self._iB,
                                 num_hidden=self._num_hidden,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=self._num_hidden,
                                 name="%sh2h" % name)
        output = sym.Activation(i2h + h2h, act_type=self._activation,
                                name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM (gate order i, f, c, o: the fused op's packed layout)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(data=inputs, weight=self._iW,
                                 bias=self._iB,
                                 num_hidden=4 * self._num_hidden,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=4 * self._num_hidden,
                                 name="%sh2h" % name)
        gates = i2h + h2h
        slices = list(sym.SliceChannel(gates, num_outputs=4,
                                       name="%sslice" % name))
        in_gate = sym.Activation(slices[0], act_type="sigmoid")
        forget_gate = sym.Activation(slices[1] + self._forget_bias,
                                     act_type="sigmoid")
        in_trans = sym.Activation(slices[2], act_type="tanh")
        out_gate = sym.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * sym.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU (gate order r, z, n)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(data=inputs, weight=self._iW,
                                 bias=self._iB,
                                 num_hidden=3 * self._num_hidden,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=3 * self._num_hidden,
                                 name="%sh2h" % name)
        i_r, i_z, i_n = list(sym.SliceChannel(i2h, num_outputs=3))
        h_r, h_z, h_n = list(sym.SliceChannel(h2h, num_outputs=3))
        reset = sym.Activation(i_r + h_r, act_type="sigmoid")
        update = sym.Activation(i_z + h_z, act_type="sigmoid")
        newmem = sym.Activation(i_n + reset * h_n, act_type="tanh")
        next_h = update * states[0] + (1.0 - update) * newmem
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """The single fused RNN op over the whole sequence (the fast path
    for full-sequence unrolls)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, prefix=None,
                 params=None):
        prefix = prefix if prefix is not None else "%s_" % mode
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._param = self.params.get("parameters")

    @property
    def state_info(self):
        b = 2 if self._bidirectional else 1
        info = [{"shape": (b * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"}]
        if self._mode == "lstm":
            info.append({"shape": (b * self._num_layers, 0,
                                   self._num_hidden),
                         "__layout__": "LNC"})
        return info

    def unroll(self, length, inputs=None, begin_state=None,
               layout="NTC", merge_outputs=None, input_prefix=""):
        self.reset()
        if isinstance(inputs, (list, tuple)):
            inputs = sym.concat(*[sym.expand_dims(i, axis=0)
                                  for i in inputs], dim=0)  # TNC
        elif layout == "NTC":
            inputs = sym.swapaxes(inputs, dim1=0, dim2=1)
        if begin_state is None:
            # (T, B, F) -> (B, F): the row the zero states take shape from
            ref = sym.sum(inputs * 0.0, axis=0)
            begin_state = self._zero_state_from(ref)
        states = list(begin_state)
        kwargs = {"state_size": self._num_hidden,
                  "num_layers": self._num_layers,
                  "mode": self._mode,
                  "bidirectional": self._bidirectional,
                  "p": self._dropout,
                  "state_outputs": True}
        if self._mode == "lstm":
            out = sym.RNN(inputs, self._param, states[0], states[1],
                          name="%srnn" % self._prefix, **kwargs)
            outputs, s0, s1 = out[0], out[1], out[2]
            nstates = [s0, s1]
        else:
            out = sym.RNN(inputs, self._param, states[0],
                          name="%srnn" % self._prefix, **kwargs)
            outputs, s0 = out[0], out[1]
            nstates = [s0]
        if layout == "NTC":
            outputs = sym.swapaxes(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            axis = 1 if layout == "NTC" else 0
            outputs = list(sym.split(outputs, num_outputs=length,
                                     axis=axis, squeeze_axis=True))
        return outputs, nstates


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in sequence ."""

    def __init__(self, params=None):
        super().__init__("", params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        return self

    @property
    def state_info(self):
        out = []
        for c in self._cells:
            out.extend(c.state_info)
        return out

    def begin_state(self, func=None, **kwargs):
        if func is None:
            return None
        out = []
        for c in self._cells:
            out.extend(c.begin_state(func=func, **kwargs))
        return out

    def reset(self):
        super().reset()
        for c in self._cells:
            c.reset()

    def __call__(self, inputs, states):
        next_states = []
        pos = 0
        for c in self._cells:
            n = len(c.state_info)
            inputs, st = c(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(st)
        return inputs, next_states

    def unroll(self, length, inputs=None, begin_state=None,
               layout="NTC", merge_outputs=None, input_prefix=""):
        self.reset()
        pos = 0
        next_states = []
        outputs = inputs
        for i, c in enumerate(self._cells):
            n = len(c.state_info)
            bs = begin_state[pos:pos + n] if begin_state is not None \
                else None
            outputs, st = c.unroll(
                length, inputs=outputs, begin_state=bs,
                layout=layout,
                merge_outputs=(merge_outputs
                               if i == len(self._cells) - 1 else None),
                input_prefix=input_prefix)
            pos += n
            next_states.extend(st)
        return outputs, next_states


class BidirectionalCell(BaseRNNCell):
    """Runs one cell forward and one backward over the sequence and
    concatenates outputs."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params)
        self._l = l_cell
        self._r = r_cell
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._l.state_info + self._r.state_info

    def begin_state(self, func=None, **kwargs):
        if func is None:
            return None
        return self._l.begin_state(func=func, **kwargs) + \
            self._r.begin_state(func=func, **kwargs)

    def reset(self):
        super().reset()
        self._l.reset()
        self._r.reset()

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs=None, begin_state=None,
               layout="NTC", merge_outputs=None, input_prefix=""):
        self.reset()
        if inputs is None:
            inputs = [sym.var("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, sym.Symbol):
            axis = 1 if layout == "NTC" else 0
            inputs = list(sym.split(inputs, num_outputs=length,
                                    axis=axis, squeeze_axis=True))
        nl = len(self._l.state_info)
        l_bs = begin_state[:nl] if begin_state is not None else None
        r_bs = begin_state[nl:] if begin_state is not None else None
        l_out, l_states = self._l.unroll(
            length, inputs=inputs, begin_state=l_bs, layout=layout,
            merge_outputs=False)
        r_out, r_states = self._r.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=r_bs, layout=layout, merge_outputs=False)
        outputs = [sym.concat(l, r, dim=1,
                              name="%st%d" % (self._output_prefix, i))
                   for i, (l, r) in enumerate(
                       zip(l_out, reversed(r_out)))]
        if merge_outputs:
            axis = 1 if layout == "NTC" else 0
            outputs = sym.concat(*[sym.expand_dims(o, axis=axis)
                                   for o in outputs], dim=axis)
        return outputs, l_states + r_states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell."""

    def __init__(self, base_cell):
        super().__init__("", None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, **kwargs):
        return self.base_cell.begin_state(**kwargs)

    def reset(self):
        super().reset()
        self.base_cell.reset()


class DropoutCell(ModifierCell):
    """Applies dropout on the base cell's output."""

    def __init__(self, base_cell, dropout=0.5):
        super().__init__(base_cell)
        self._dropout = dropout

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        if self._dropout > 0:
            out = sym.Dropout(out, p=self._dropout)
        return out, states


class ResidualCell(ModifierCell):
    """Adds the input to the base cell's output."""

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states
