"""Recurrent layers — the counterpart of ``paddle_tpu/nn/layer_rnn.py``.

The cells (``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``) hold JAX's
parameters under JAX's names and shapes (``weight_ih`` ``[G·H, in]``,
``weight_hh`` ``[G·H, H]``, ``bias_ih`` / ``bias_hh`` ``[G·H]``, G the
gate count), all drawn from ``Uniform(-1/√H, 1/√H)``, and compute one
step as ONE function through ``ops.apply_like`` under JAX's op name
(``rnn_cell``, ``lstm_cell``, ``gru_cell``), with JAX's formulas as they
are (:45-48, :77-85, :114-121): LSTM gates in the order i, f, g, o; the
GRU candidate ``tanh(ic + r·hc)`` with ``hc`` holding its bias, and the
output ``cand + z·(h - cand)``.

``RNN`` runs a cell over time in a Python loop (reversed for
``is_reverse``), as JAX's eager loop (:138-155); nothing in the loop reads
a value back to the host, so a ``jit.TrainStep`` captures it. ``_RNNBase``
(``SimpleRNN``, ``LSTM``, ``GRU``) runs one ``RNN`` per layer and
direction, concatenates the two directions, applies dropout between layers
in training only (never after the last), and stacks the final states
``[L·dirs, B, H]`` (``(h, c)`` for LSTM) (:184-223).

JAX accepts ``sequence_length`` and further keyword arguments
(``proj_size``, the weight attributes) and never reads them; the port
raises ``NotImplementedError`` on a value other than the default instead
(ROADMAP C). Layers take and return the paddle-style ``Tensor`` or a bare
``torch.Tensor``, the kind they are given.
"""
from __future__ import annotations

import math

import torch

from ..ops import apply_like
from . import initializer as I
from .layer import Layer

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "SimpleRNN",
           "LSTM", "GRU", "RNNCellBase"]


def _refuse(what, **given):
    """NotImplementedError for arguments JAX accepts and never reads, when
    one is given a value other than its default (None, 0 or False)."""
    bad = [k for k, v in given.items() if v is not None and not (
        isinstance(v, (bool, int, float)) and v == 0)]
    if bad:
        raise NotImplementedError(
            f"{what}: {bad} not ported (the JAX package accepts "
            f"and ignores them; ROADMAP C)")


def _zeros_like_batch(x, hidden):
    v = x._value if hasattr(x, "_value") else x
    return torch.zeros((v.shape[0], hidden), dtype=v.dtype, device=v.device)


class _RNNCellBase(Layer):
    def _make_weights(self, input_size, hidden_size, gates, attrs):
        self.input_size, self.hidden_size = input_size, hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        wi, wh, bi, bh = attrs
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], wi, default_initializer=u)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], wh, default_initializer=u)
        self.bias_ih = self.create_parameter(
            [gates * hidden_size], bi, is_bias=True, default_initializer=u)
        self.bias_hh = self.create_parameter(
            [gates * hidden_size], bh, is_bias=True, default_initializer=u)

    def _weights(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)


RNNCellBase = _RNNCellBase


class SimpleRNNCell(_RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.activation = activation
        self._make_weights(input_size, hidden_size, 1,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            states = _zeros_like_batch(inputs, self.hidden_size)
        act = torch.tanh if self.activation == "tanh" else torch.relu

        def f(x, h, wi, wh, bi, bh):
            return act(x @ wi.T + bi + h @ wh.T + bh)

        out = apply_like(f, "rnn_cell", inputs, states, *self._weights())
        return out, out


class LSTMCell(_RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=None, name=None):
        super().__init__()
        _refuse("LSTMCell", proj_size=proj_size)
        self._make_weights(input_size, hidden_size, 4,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            states = (_zeros_like_batch(inputs, self.hidden_size),
                      _zeros_like_batch(inputs, self.hidden_size))
        h, c = states

        def f(x, hv, cv, wi, wh, bi, bh):
            gates = x @ wi.T + bi + hv @ wh.T + bh
            i, fg, g, o = gates.chunk(4, dim=-1)
            new_c = torch.sigmoid(fg) * cv + torch.sigmoid(i) * torch.tanh(g)
            return torch.sigmoid(o) * torch.tanh(new_c), new_c

        new_h, new_c = apply_like(f, "lstm_cell", inputs, h, c,
                                  *self._weights())
        return new_h, (new_h, new_c)


class GRUCell(_RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._make_weights(input_size, hidden_size, 3,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            states = _zeros_like_batch(inputs, self.hidden_size)

        def f(x, h, wi, wh, bi, bh):
            ir, iz, ic = (x @ wi.T + bi).chunk(3, dim=-1)
            hr, hz, hc = (h @ wh.T + bh).chunk(3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            cand = torch.tanh(ic + r * hc)
            return cand + z * (h - cand)

        out = apply_like(f, "gru_cell", inputs, states, *self._weights())
        return out, out


def _stack(outs, axis):
    return apply_like(lambda *vs: torch.stack(vs, axis), "stack", *outs)


def _concat(outs, axis):
    return apply_like(lambda *vs: torch.cat(vs, axis), "concat", *outs)


class RNN(Layer):
    """A cell over the time axis (axis 0 when ``time_major``, else 1)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _refuse("RNN", sequence_length=sequence_length)
        seq_axis = 0 if self.time_major else 1
        steps = inputs.shape[seq_axis]
        idxs = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        outputs = []
        states = initial_states
        for t in idxs:
            xt = inputs[t] if self.time_major else inputs[:, t]
            out, states = self.cell(xt, states)
            outputs.append(out)
        if self.is_reverse:
            outputs = outputs[::-1]
        return _stack(outputs, seq_axis), states


class _RNNBase(Layer):
    _CELLS = {"RNN_TANH": SimpleRNNCell, "RNN_RELU": SimpleRNNCell,
              "LSTM": LSTMCell, "GRU": GRUCell}

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__()
        _refuse(type(self).__name__, **{k: v for k, v in kw.items()
                                        if k != "name"})
        self.mode = mode
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirect else 1
        extra = {}
        if mode.startswith("RNN_"):
            extra["activation"] = mode[4:].lower()
        from .layer_common import LayerList

        self.cells = LayerList()
        for layer in range(num_layers):
            for _ in range(self.num_directions):
                in_sz = (input_size if layer == 0
                         else hidden_size * self.num_directions)
                self.cells.append(self._CELLS[mode](in_sz, hidden_size,
                                                    **extra))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _refuse(type(self).__name__, sequence_length=sequence_length)
        x = inputs
        final_h, final_c = [], []
        is_lstm = self.mode == "LSTM"
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.num_directions):
                idx = layer * self.num_directions + d
                rnn = RNN(self.cells[idx], is_reverse=(d == 1),
                          time_major=self.time_major)
                st = None
                if initial_states is not None:
                    st = ((initial_states[0][idx], initial_states[1][idx])
                          if is_lstm else initial_states[idx])
                o, s = rnn(x, st)
                outs.append(o)
                if is_lstm:
                    final_h.append(s[0])
                    final_c.append(s[1])
                else:
                    final_h.append(s)
            x = outs[0] if len(outs) == 1 else _concat(outs, -1)
            if self.dropout and layer < self.num_layers - 1 and self.training:
                from .functional import dropout

                x = dropout(x, self.dropout, training=True)
        if is_lstm:
            return x, (_stack(final_h, 0), _stack(final_c, 0))
        return x, _stack(final_h, 0)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)
