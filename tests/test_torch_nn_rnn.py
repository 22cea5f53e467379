"""The recurrent layers of the port (``nn/layer_rnn.py``, ``BiRNN`` and the
beam search of ``nn/layer_extra.py``) held against the JAX package on the
CPU, with JAX's weights carried across by ``bridge.from_paddle_tpu_state``
(every cell's ``weight_ih`` / ``weight_hh`` / ``bias_ih`` / ``bias_hh``
per layer and direction, under JAX's structured names).

* Every cell, and ``SimpleRNN`` (tanh, relu), ``LSTM`` and ``GRU`` with
  two layers in both directions, time-major and not, with and without
  initial states: outputs, final states and the gradient of every
  parameter and of the input, against one jitted ``value_and_grad`` of
  JAX's functional call, within 1e-5 (f32 sums in other orders over a few
  steps).
* The arguments JAX accepts and never reads (``sequence_length``,
  ``proj_size``, the weight attributes of the multi-layer forms) raise.
* ``BiRNN``: outputs and both final states.
* ``dynamic_decode`` over a ``BeamSearchDecoder``: ids equal, scores
  within 1e-5 (relative), with an ``LSTMCell`` and with a
  ``SimpleRNNCell``, against JAX's loop with its beam states reordered
  (JAX's own loop leaves them in place: its ``tree_map`` reaches the
  arrays inside the Tensors, which ``_reorder_beam`` passes through; the
  test wraps them back, ``_reordering``, and shows a case where that
  changes the ids).
* An LSTM language model step through ``TrainStep`` equals the eager step.

JAX's answers are computed once per module (``jax_answers``), outside the
call-phase budget.
"""
import functools

import jax
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.autograd import tape
from paddle_tpu_torch import from_paddle_tpu_state
from port_bodies import on_cpu  # noqa: F401

IN, HID, B, T = 5, 6, 3, 4
TOL = 1e-5

# name -> (layer class name, kwargs)
LAYERS = {}
for _mode, _kw in (("SimpleRNN", {}), ("SimpleRNN_relu",
                                       {"activation": "relu"}),
                   ("LSTM", {}), ("GRU", {})):
    for _dir in ("forward", "bidirect"):
        for _tm in (False, True):
            LAYERS[f"{_mode}-{_dir}-{'tm' if _tm else 'bm'}"] = (
                _mode.split("_")[0], dict(_kw, num_layers=2, direction=_dir,
                                          time_major=_tm))
CELLS = {"SimpleRNNCell": {}, "SimpleRNNCell_relu": {"activation": "relu"},
         "LSTMCell": {}, "GRUCell": {}}


def _r(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _build(pkg, cls, kw, seed=3):
    if pkg is paddle:
        with paddle.utils.unique_name.guard():
            paddle.seed(seed)
            return getattr(paddle.nn, cls)(IN, HID, **kw)
    return getattr(pkg.nn, cls)(IN, HID, **kw)


def _layer_inputs(name):
    _, kw = LAYERS[name]
    tm = kw["time_major"]
    x = _r((T, B, IN) if tm else (B, T, IN), 1)
    dirs = 2 if kw["direction"] == "bidirect" else 1
    h0 = _r((2 * dirs, B, HID), 2) if tm else None
    c0 = _r((2 * dirs, B, HID), 3) if tm else None
    return x, h0, c0


def _states(mode, h0, c0, wrap):
    if h0 is None:
        return None
    return (wrap(h0), wrap(c0)) if mode == "LSTM" else wrap(h0)


def _flat(mode, states):
    return list(states) if mode == "LSTM" else [states]


def _weights(shapes, seed=7):
    return [_r(s, seed + i) for i, s in enumerate(shapes)]


def _jax_layer(name):
    """(outputs, final states, {param: grad}, input grad) of JAX's layer,
    and its state as numpy."""
    cls, kw = LAYERS[name]
    layer = _build(paddle, cls, kw)
    x, h0, c0 = _layer_inputs(name)
    state = {k: v._value for k, v in layer.state_dict().items()}

    def f(st, xv):
        with tape.no_grad():
            out, fin = layer.functional_call(
                st, paddle.Tensor(xv),
                _states(cls, h0, c0, paddle.to_tensor))
        outs = [out._value] + [s._value for s in _flat(cls, fin)]
        ws = _weights([o.shape for o in outs])
        loss = sum((o * w).sum() for o, w in zip(outs, ws))
        return loss, outs

    (_, outs), (g, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(state, x)
    return ({k: np.asarray(v) for k, v in state.items()},
            [np.asarray(o) for o in outs],
            {k: np.asarray(v) for k, v in g.items()}, np.asarray(gx))


def _jax_cell(name):
    cls = name.split("_")[0]
    with paddle.utils.unique_name.guard():
        paddle.seed(4)
        cell = getattr(paddle.nn, cls)(IN, HID, **CELLS[name])
    state = {k: v._value for k, v in cell.state_dict().items()}
    x = _r((B, IN), 5)
    h = _r((B, HID), 6)
    c = _r((B, HID), 7)

    def f(st, xv, hv, cv):
        with tape.no_grad():
            st0 = ((paddle.Tensor(hv), paddle.Tensor(cv))
                   if cls == "LSTMCell" else paddle.Tensor(hv))
            out, fin = cell.functional_call(st, paddle.Tensor(xv), st0)
        outs = [out._value] + [s._value for s in (
            fin if cls == "LSTMCell" else [fin])]
        ws = _weights([o.shape for o in outs])
        return sum((o * w).sum() for o, w in zip(outs, ws)), outs

    (_, outs), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        state, x, h, c)
    return ({k: np.asarray(v) for k, v in state.items()},
            [np.asarray(o) for o in outs],
            {k: np.asarray(v) for k, v in g.items()})


@pytest.fixture(scope="module")
def jax_answers():
    return {**{n: _jax_layer(n) for n in LAYERS},
            **{n: _jax_cell(n) for n in CELLS}}


def _grads(layer):
    return {k: p.grad.numpy() for k, p in layer.named_parameters()}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_outputs_states_and_gradients_match_jax(name, jax_answers,
                                                      on_cpu):
    cls, kw = LAYERS[name]
    state, jouts, jgrads, jgx = jax_answers[name]
    layer = from_paddle_tpu_state(state, _build(tp, cls, kw))
    x, h0, c0 = _layer_inputs(name)
    xt = tp.to_tensor(x, stop_gradient=False)
    out, fin = layer(xt, _states(cls, h0, c0, tp.to_tensor))
    outs = [out] + _flat(cls, fin)
    assert [list(o.shape) for o in outs] == [list(o.shape) for o in jouts]
    loss = None
    for o, w, jo in zip(outs, _weights([o.shape for o in jouts]), jouts):
        np.testing.assert_allclose(o.numpy(), jo, atol=TOL, rtol=TOL)
        term = (o * tp.to_tensor(w)).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    got = _grads(layer)
    assert set(got) == set(jgrads)
    for k in jgrads:
        np.testing.assert_allclose(got[k], jgrads[k], atol=TOL, rtol=TOL,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), jgx, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_step_and_gradients_match_jax(name, jax_answers, on_cpu):
    cls = name.split("_")[0]
    state, jouts, jgrads = jax_answers[name]
    cell = from_paddle_tpu_state(state, getattr(tp.nn, cls)(
        IN, HID, **CELLS[name]))
    x, h, c = _r((B, IN), 5), _r((B, HID), 6), _r((B, HID), 7)
    st = ((tp.to_tensor(h), tp.to_tensor(c)) if cls == "LSTMCell"
          else tp.to_tensor(h))
    out, fin = cell(tp.to_tensor(x), st)
    outs = [out] + list(fin if cls == "LSTMCell" else [fin])
    loss = None
    for o, w, jo in zip(outs, _weights([o.shape for o in jouts]), jouts):
        np.testing.assert_allclose(o.numpy(), jo, atol=TOL, rtol=TOL)
        term = (o * tp.to_tensor(w)).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    got = _grads(cell)
    for k in jgrads:
        np.testing.assert_allclose(got[k], jgrads[k], atol=TOL, rtol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("cls", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_cell_parameters_have_jax_names_shapes_and_law(cls, on_cpu):
    """weight_ih [G·H, in], weight_hh [G·H, H], biases [G·H], all drawn
    from Uniform(±1/√H): within the bound, and with the uniform law's
    variance bound² / 3 within 5 standard errors."""
    H = 64
    gates = {"SimpleRNNCell": 1, "LSTMCell": 4, "GRUCell": 3}[cls]
    tcell = getattr(tp.nn, cls)(32, H)
    jcell = getattr(paddle.nn, cls)(32, H)
    tshapes = {k: list(v.shape) for k, v in tcell.state_dict().items()}
    assert tshapes == {k: list(v.shape)
                       for k, v in jcell.state_dict().items()}
    assert tshapes["weight_ih"] == [gates * H, 32]
    bound = 1 / np.sqrt(H)
    w = np.concatenate([v.numpy().ravel()
                        for v in tcell.state_dict().values()])
    assert np.abs(w).max() <= bound
    var = bound ** 2 / 3
    se = np.sqrt((bound ** 4 / 5 - var ** 2) / w.size)
    assert abs(w.var() - var) < 5 * se


def test_unread_arguments_raise(on_cpu):
    x = tp.to_tensor(_r((B, T, IN), 1))
    with pytest.raises(NotImplementedError, match="sequence_length"):
        tp.nn.LSTM(IN, HID)(x, sequence_length=tp.to_tensor(
            np.array([4, 3, 2])))
    with pytest.raises(NotImplementedError, match="sequence_length"):
        tp.nn.RNN(tp.nn.GRUCell(IN, HID))(x, sequence_length=[4, 3, 2])
    with pytest.raises(NotImplementedError, match="proj_size"):
        tp.nn.LSTM(IN, HID, proj_size=3)
    with pytest.raises(NotImplementedError, match="proj_size"):
        tp.nn.LSTMCell(IN, HID, proj_size=3)
    with pytest.raises(NotImplementedError, match="weight_ih_attr"):
        tp.nn.GRU(IN, HID, weight_ih_attr=tp.nn.ParamAttr(name="w"))
    # the defaults a Paddle script passes are accepted
    tp.nn.LSTM(IN, HID, proj_size=0, weight_ih_attr=None, name="lstm")


def test_dropout_between_layers_in_training_only(on_cpu):
    """dropout applies between layers in training, never after the last
    layer (a one-layer LSTM is unchanged by it) and not in eval."""
    x = tp.to_tensor(_r((B, T, IN), 1))
    tp.seed(0)
    one = tp.nn.LSTM(IN, HID, dropout=0.9)
    tp.seed(0)
    ref = tp.nn.LSTM(IN, HID)
    np.testing.assert_array_equal(one(x)[0].numpy(), ref(x)[0].numpy())
    tp.seed(0)
    two = tp.nn.LSTM(IN, HID, num_layers=2, dropout=0.9)
    tp.seed(0)
    two_ref = tp.nn.LSTM(IN, HID, num_layers=2)
    assert not np.array_equal(two(x)[0].numpy(), two_ref(x)[0].numpy())
    two.eval()
    np.testing.assert_array_equal(two(x)[0].numpy(), two_ref(x)[0].numpy())


@functools.lru_cache(maxsize=None)
def _jax_birnn(time_major):
    with paddle.utils.unique_name.guard():
        paddle.seed(8)
        bi = paddle.nn.BiRNN(paddle.nn.GRUCell(IN, HID),
                             paddle.nn.LSTMCell(IN, HID),
                             time_major=time_major)
    x = _r((T, B, IN) if time_major else (B, T, IN), 9)
    out, (sf, (hb, cb)) = bi(paddle.to_tensor(x))
    return ({k: np.asarray(v._value) for k, v in bi.state_dict().items()},
            x, [np.asarray(t._value) for t in (out, sf, hb, cb)])


@pytest.mark.parametrize("time_major", [False, True])
def test_birnn_matches_jax(time_major, on_cpu):
    state, x, want = _jax_birnn(time_major)
    bi = from_paddle_tpu_state(state, tp.nn.BiRNN(
        tp.nn.GRUCell(IN, HID), tp.nn.LSTMCell(IN, HID),
        time_major=time_major))
    out, (sf, (hb, cb)) = bi(tp.to_tensor(x))
    assert list(out.shape) == list(want[0].shape)
    assert out.shape[-1] == 2 * HID
    for g, w in zip((out, sf, hb, cb), want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL)


DECODE = {"lstm": ("LSTMCell", 3, 7), "simple": ("SimpleRNNCell", 4, 12)}
V_DEC, EMB = 11, 4


def _decoder(pkg, kind):
    cls, K, steps = DECODE[kind]
    emb = pkg.nn.Embedding(V_DEC, EMB)
    cell = getattr(pkg.nn, cls)(EMB, HID)
    proj = pkg.nn.Linear(HID, V_DEC)
    return emb, cell, proj, K, steps


def _reordering(orig):
    """JAX's ``_reorder_beam`` as its ``dynamic_decode`` means it: JAX maps
    it over the states with ``jax.tree_util.tree_map``, which reaches the
    raw arrays inside the Tensors, so it passes every state through
    unordered (ROADMAP C); this wraps each array back into a Tensor."""
    def fixed(state, beam_src, B, K):
        if isinstance(state, paddle.Tensor):
            return orig(state, beam_src, B, K)
        return orig(paddle.Tensor(state), beam_src, B, K)._value

    return fixed


@functools.lru_cache(maxsize=None)
def _jax_decode(kind, reorder=True):
    from paddle_tpu.nn import layer_extra as jextra

    with paddle.utils.unique_name.guard():
        paddle.seed(12)
        emb, cell, proj, K, steps = _decoder(paddle, kind)
    # a projection wide enough that the beams' tokens, and so their
    # states, differ from step to step
    proj.weight.set_value(np.random.default_rng(13).normal(
        0, 3, (HID, V_DEC)).astype(np.float32))
    dec = paddle.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                      beam_size=K, embedding_fn=emb,
                                      output_fn=proj)
    orig = jextra._reorder_beam
    if reorder:
        jextra._reorder_beam = _reordering(orig)
    try:
        ids, scores = paddle.nn.dynamic_decode(dec, max_step_num=steps,
                                               batch_size=2)
    finally:
        jextra._reorder_beam = orig
    states = [{k: np.asarray(v._value) for k, v in m.state_dict().items()}
              for m in (emb, cell, proj)]
    return states, np.asarray(ids._value), np.asarray(scores._value)


def _port_decode(kind, states):
    emb, cell, proj, K, steps = _decoder(tp, kind)
    for m, st in zip((emb, cell, proj), states):
        from_paddle_tpu_state(st, m)
    dec = tp.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                  beam_size=K, embedding_fn=emb,
                                  output_fn=proj)
    return tp.nn.dynamic_decode(dec, max_step_num=steps, batch_size=2)


@pytest.mark.parametrize("kind", list(DECODE))
def test_dynamic_decode_ids_equal_and_scores_match_jax(kind, on_cpu):
    """Against JAX's loop with its states reordered as it means them."""
    states, jids, jscores = _jax_decode(kind)
    ids, scores = _port_decode(kind, states)
    K = DECODE[kind][1]
    assert list(ids.shape) == list(jids.shape)
    assert ids.shape[:2] == [2, K]
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(scores.numpy(), jscores, rtol=TOL, atol=0)
    assert (np.diff(scores.numpy(), axis=1) <= 0).all()


def test_dynamic_decode_reorders_the_states_jax_leaves_in_place(on_cpu):
    """The states' order matters here: JAX's loop as it runs (states not
    reordered) gives other ids than the port's, which equal those of
    JAX's loop with the reorder."""
    states, _, _ = _jax_decode("simple")
    _, raw_ids, _ = _jax_decode("simple", reorder=False)
    ids, _ = _port_decode("simple", states)
    assert not np.array_equal(ids.numpy(), raw_ids)


def test_beam_search_stops_when_every_beam_has_finished(on_cpu):
    """A projection whose bias makes end_token certain: the first step
    keeps one beam, whose best token is end; the other beams end at the
    second step, and the loop stops there, well before max_step_num."""
    emb, cell, proj, K, _ = _decoder(tp, "lstm")
    b = np.zeros(V_DEC, np.float32)
    b[1] = 1e4
    proj.bias.set_value(b)
    dec = tp.nn.BeamSearchDecoder(cell, 0, 1, K, emb, proj)
    ids, scores = tp.nn.dynamic_decode(dec, max_step_num=9, batch_size=2)
    got = ids.numpy()
    assert got.shape == (2, K, 2)
    assert (got[:, 0, 0] == 1).all() and (got[:, :, -1] == 1).all()
    assert (np.abs(scores.numpy()[:, 0]) < 1e-3).all()


class _LM(tp.nn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = tp.nn.Embedding(20, 8)
        self.lstm = tp.nn.LSTM(8, 8, num_layers=2)
        self.head = tp.nn.Linear(8, 20)

    def forward(self, ids, labels):
        out, _ = self.lstm(self.emb(ids))
        logits = self.head(out)
        return logits, tp.nn.functional.cross_entropy(
            logits.reshape([-1, 20]), labels.reshape([-1]))


def test_lstm_lm_train_step_equals_eager_steps(on_cpu):
    """Two ``TrainStep`` calls of an LSTM LM (SGD, global-norm clip) give
    the eager steps' losses and parameters (on the CPU the step runs its
    body on its static buffers, the code a capture records)."""
    from paddle_tpu_torch.jit import TrainStep

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 20, (4, 6))
    labels = np.roll(ids, -1, 1)

    def make():
        tp.seed(1)
        m = _LM()
        opt = tp.optimizer.SGD(
            0.5, parameters=m.parameters(),
            grad_clip=tp.nn.ClipGradByGlobalNorm(1.0))
        return m, opt

    m1, o1 = make()
    eager = []
    for _ in range(2):
        _, loss = m1(tp.to_tensor(ids), tp.to_tensor(labels))
        loss.backward()
        o1.step()
        o1.clear_grad()
        eager.append(float(loss))
    m2, o2 = make()
    step = TrainStep(m2, lambda logits, loss: loss, o2)
    got = [float(step(tp.to_tensor(ids), tp.to_tensor(labels)))
           for _ in range(2)]
    np.testing.assert_allclose(got, eager, rtol=1e-6)
    assert got[1] < got[0]
    for (k, a), (_, b) in zip(m1.state_dict().items(),
                              m2.state_dict().items()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
