"""``paddle.Model`` (hapi) and its callbacks, ``summary`` and ``flops``,
against the JAX package on the CPU.

``Model.fit`` is held to the JAX package's on the same weights (numpy,
through ``set_state_dict`` or ``bridge.py``) and the same batches: a small
``nn.Sequential`` under Adam (per-step losses within 1e-5 relative: f32
sums in another order) and ``gpt_tiny()`` under AdamW (1e-5), whose JAX
answers are computed once in a module fixture. ``tests/test_metrics_hapi.py``'s
fit / evaluate / predict and early-stopping bodies run on both packages
(``port_bodies.run``). A checkpointed ``gpt_tiny`` fit killed mid-way and
resumed equals the uninterrupted run bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as port
from paddle_tpu_torch import from_paddle_tpu_state
from paddle_tpu_torch.models import gpt as tgpt
from port_bodies import npy, on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


class _Losses:
    """A duck-typed callback recording the training losses."""

    def __init__(self):
        self.losses = []

    def set_model(self, model):
        self.model = model

    def __getattr__(self, name):
        if name.startswith("on_"):
            return (self._end if name == "on_batch_end"
                    else (lambda *a, **k: None))
        raise AttributeError(name)

    def _end(self, mode, step, logs=None):
        if mode == "train":
            self.losses.append(logs["loss"][0])


def _data(n=64, seed=0):
    X = np.random.default_rng(seed).standard_normal((n, 16)).astype(
        "float32")
    Y = np.random.default_rng(seed + 1).integers(0, 4, (n, 1))
    return X, Y


def _seq_model(paddle, metrics=True, opt="Adam"):
    nn = paddle.nn
    net = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))
    rng = np.random.default_rng(7)
    net.set_state_dict({k: (rng.standard_normal(t.shape) * 0.3)
                        .astype("float32")
                        for k, t in net.state_dict().items()})
    model = paddle.Model(net)
    model.prepare(getattr(paddle.optimizer, opt)(
        1e-2, parameters=net.parameters()), nn.CrossEntropyLoss(),
        paddle.metric.Accuracy() if metrics else None)
    return model


def _dataset(paddle):
    X, Y = _data()

    class DS(paddle.io.Dataset):
        def __len__(self):
            return 64

        def __getitem__(self, i):
            return X[i], Y[i]

    return DS()


def fit_evaluate_predict(paddle):
    model, ds = _seq_model(paddle), _dataset(paddle)
    rec = _Losses()
    model.fit(ds, batch_size=16, epochs=2, shuffle=False, verbose=0,
              callbacks=[rec])
    res = model.evaluate(ds, batch_size=16, verbose=0)
    preds = model.predict(ds, batch_size=16)
    assert len(preds) == 4 and tuple(preds[0].shape) == (16, 4)
    return {"losses": np.asarray(rec.losses), "eval_loss":
            np.asarray(res["loss"]), "acc": np.float64(res["acc"]),
            "pred0": npy(preds[0]), "keys": sorted(res)}


def early_stopping_and_checkpoint(paddle):
    from importlib import import_module

    cb = import_module(f"{paddle.__name__}.hapi.callbacks")
    import tempfile

    d = tempfile.mkdtemp()
    model, ds = _seq_model(paddle), _dataset(paddle)
    model.fit(ds, batch_size=16, epochs=5, shuffle=False, verbose=0,
              callbacks=[cb.EarlyStopping(monitor="loss", patience=1,
                                          min_delta=1e9),
                         cb.ModelCheckpoint(save_dir=d)])
    saved = sorted(os.listdir(d))
    return {"stopped": model.stop_training, "saved": saved}


def save_load_model(paddle):
    import tempfile

    d = tempfile.mkdtemp()
    model, ds = _seq_model(paddle, metrics=False), _dataset(paddle)
    model.fit(ds, batch_size=16, epochs=1, shuffle=False, verbose=0)
    model.save(os.path.join(d, "m"))
    other = _seq_model(paddle, metrics=False)
    other.load(os.path.join(d, "m"))
    x = paddle.to_tensor(_data()[0][:4])
    same = np.array_equal(npy(other.predict_batch(x)),
                          npy(model.predict_batch(x)))
    opt_step = other._optimizer.state_dict()["@step"]
    return {"files": sorted(os.listdir(d)), "same": same,
            "opt_step": opt_step}


def summary_and_flops(paddle):
    net = _seq_model(paddle).network
    s = paddle.summary(net, (2, 16))
    return {"summary": s, "flops": paddle.flops(net, [2, 16])}


def lr_scheduler_callback(paddle):
    from importlib import import_module

    cb = import_module(f"{paddle.__name__}.hapi.callbacks")
    nn = paddle.nn
    net = nn.Linear(16, 4)
    sched = paddle.optimizer.lr.StepDecay(learning_rate=0.1, step_size=2)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.SGD(sched, parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    model.fit(_dataset(paddle), batch_size=16, epochs=1, shuffle=False,
              verbose=0, callbacks=[cb.LRScheduler()])
    return {"last_epoch": sched.last_epoch, "lr": float(sched())}


BODIES = [fit_evaluate_predict, early_stopping_and_checkpoint,
          save_load_model, lr_scheduler_callback]


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX package's answers to every body, computed once before the
    tests (``port_bodies.jax_results`` keeps them): the JAX legs' eager
    programs compile per op, which belongs to setup, not to a test's
    call."""
    from port_bodies import jax_results

    return {b: jax_results(b) for b in BODIES}


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_hapi_body(on_cpu, jax_answers, body, pkg):
    run(body, pkg, rtol=1e-5, atol=1e-6)


def test_summary_counts_and_flops_count_the_products(on_cpu):
    """``summary`` counts as JAX's does; ``flops`` counts the port's
    matrix products (2 M N K each), which JAX's XLA count also holds
    beside its elementwise work."""
    got = summary_and_flops(port)
    want = summary_and_flops(paddle_tpu)
    assert got["summary"] == want["summary"] == {
        "total_params": 16 * 32 + 32 + 32 * 4 + 4,
        "trainable_params": 16 * 32 + 32 + 32 * 4 + 4}
    products = 2 * 2 * (16 * 32 + 32 * 4)
    assert got["flops"] == products
    assert products <= want["flops"] <= 1.2 * products


# ------------------------------------------------------------- gpt_tiny fit
GPT = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
           max_position=128)


def _windows(n=8, S=24, seed=3):
    ids = np.random.default_rng(seed).integers(0, 1024, (n, S + 1))
    return [(ids[i, :-1], ids[i, 1:]) for i in range(n)]


@pytest.fixture
def one_thread():
    """torch on one CPU thread within the test: it shares the machine with
    the other test workers, and torch's own threads would oversubscribe
    it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_gpt_fit():
    """The JAX package's gpt_tiny fit: its initial weights and per-step
    losses (computed once)."""
    from paddle_tpu.distributed.fleet.meta_parallel import (
        ParallelCrossEntropy)
    from paddle_tpu.models import gpt as jgpt

    with paddle_tpu.utils.unique_name.guard():
        paddle_tpu.seed(11)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**GPT))
    state = {k: np.asarray(v) for k, v in jm.gpt.raw_state().items()}
    ce = ParallelCrossEntropy()

    def loss(logits, labels):
        return ce(logits.reshape([-1, 1024]), labels.reshape([-1])).mean()

    model = paddle_tpu.Model(jm)
    model.prepare(paddle_tpu.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01),
        loss)
    rec = _Losses()
    model.fit(_windows(), batch_size=2, shuffle=False, verbose=0,
              callbacks=[rec])
    return state, rec.losses


def _port_gpt_model(state):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ParallelCrossEntropy)

    net = from_paddle_tpu_state(state, tgpt.GPTConfig(**GPT), device="cpu")
    ce = ParallelCrossEntropy()
    model = port.Model(net)
    model.prepare(port.optimizer.AdamW(
        learning_rate=1e-3, parameters=net.parameters(), weight_decay=0.01),
        lambda logits, labels: ce(logits.reshape(-1, 1024),
                                  labels.reshape(-1)).mean())
    return model


def test_gpt_tiny_fit_losses_match_jax(on_cpu, one_thread, jax_gpt_fit):
    state, want = jax_gpt_fit
    rec = _Losses()
    model = _port_gpt_model(state)
    model.fit(_windows(), batch_size=2, shuffle=False, verbose=0,
              callbacks=[rec])
    np.testing.assert_allclose(rec.losses, want, rtol=1e-5)
    assert len(rec.losses) == 4 and not model._train_step_broken


def test_gpt_tiny_fit_resumes_equal_to_an_uninterrupted_run(
        on_cpu, one_thread, tmp_path, jax_gpt_fit):
    from paddle_tpu.inference.faults import ThreadDeath

    state, _ = jax_gpt_fit
    base = _Losses()
    _port_gpt_model(state).fit(_windows(), batch_size=2, shuffle=False,
                               verbose=0, callbacks=[base])

    class Kill(_Losses):
        def _end(self, mode, step, logs=None):
            super()._end(mode, step, logs)
            if len(self.losses) == 3:
                raise ThreadDeath()

    with pytest.raises(ThreadDeath):
        _port_gpt_model(state).fit(_windows(), batch_size=2, shuffle=False,
                                   verbose=0, callbacks=[Kill()],
                                   checkpoint_dir=str(tmp_path),
                                   checkpoint_every=2)
    rec = _Losses()
    _port_gpt_model(state).fit(_windows(), batch_size=2, shuffle=False,
                               verbose=0, callbacks=[rec],
                               checkpoint_dir=str(tmp_path),
                               checkpoint_every=2)
    assert rec.losses == base.losses[2:]


def test_a_failed_capture_runs_the_step_eagerly_on_the_same_device(
        on_cpu, monkeypatch):
    """JAX's untraceable-forward fallback, as the port meets it: a step
    whose capture fails (``CaptureError``) warns, and that step and the
    next run eagerly on the network's device; the losses are the compiled
    step's."""
    from paddle_tpu_torch.jit import TrainStep, graphs

    want = _Losses()
    _seq_model(port, metrics=False).fit(_dataset(port), batch_size=16,
                                        shuffle=False, verbose=0,
                                        callbacks=[want])
    calls = []

    def failing(self, *a, **k):
        calls.append(1)
        raise graphs.CaptureError("CUDA graph capture failed: planted")

    monkeypatch.setattr(TrainStep, "__call__", failing)
    model = _seq_model(port, metrics=False)
    got = _Losses()
    with pytest.warns(RuntimeWarning, match="could not be captured"):
        model.fit(_dataset(port), batch_size=16, shuffle=False, verbose=0,
                  callbacks=[got])
    assert model._train_step_broken and len(calls) == 1
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-6)
    assert all(p.place.is_cpu_place() for p in model.parameters())


def test_callbacks_progbar_visualdl_and_monitor(on_cpu, tmp_path, capsys):
    cb = port.hapi.callbacks
    model = _seq_model(port)
    mon = cb.MonitorCallback(samples_per_step=16)
    model.fit(_dataset(port), batch_size=16, epochs=1, shuffle=False,
              callbacks=[cb.ProgBarLogger(log_freq=2, verbose=1),
                         cb.VisualDL(log_dir=str(tmp_path)), mon],
              checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    out = capsys.readouterr().out
    assert "[train] epoch 0 step 0: loss:" in out and "ips:" in out
    lines = open(tmp_path / "scalars.tsv").read().splitlines()
    assert len(lines) == 4 * 2            # loss and acc for 4 batches
    assert lines[0].startswith("train\t0\tloss\t")
    # the bound StepMonitor's series: 4 step observations, 3 loader gaps,
    # two checkpoints' phases in order and their results
    m = mon.monitor
    text = m.render()
    assert "paddle_train_step_seconds_count 4" in text
    spans = [s.name for s in m.tracer.spans()]
    assert spans.count("step") == 4 and spans.count("data_wait") == 3
    ckpt = [s.name for s in sorted(m.tracer.spans(),
                                   key=lambda s: s.end_us)
            if s.name.startswith("ckpt_")]
    for phase in ("snapshot", "serialize", "commit"):
        assert ckpt.count(f"ckpt_{phase}") == 2, ckpt
        assert (f'paddle_train_checkpoint_seconds_count{{phase="{phase}"}} 2'
                in text)
    assert ckpt[0] == "ckpt_snapshot" and ckpt[-1] == "ckpt_commit"
    assert 'paddle_train_checkpoints_total{result="committed"} 2' in text
    assert model._step_monitor is m and model._train_step._monitor is None


def test_sigterm_in_a_fit_fed_by_workers_exits_101(tmp_path):
    """A fresh process whose fit reads from DataLoader worker processes
    takes SIGTERM mid-run: it flushes, exits with 101 (not hanging on its
    workers, which must not keep the fit's SIGTERM hook), and the
    checkpoint holds the preempted step."""
    import subprocess
    import sys
    import textwrap

    from paddle_tpu_torch.framework.checkpoint import latest_step

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = textwrap.dedent(f"""
        import os, signal, sys
        sys.path.insert(0, {repo!r})
        import numpy as np
        import paddle_tpu_torch as paddle
        paddle.set_device("cpu")
        nn = paddle.nn
        rs = np.random.RandomState(0)
        X, Y = rs.randn(64, 8).astype("float32"), rs.randint(0, 4, (64, 1))
        class DS(paddle.io.Dataset):
            def __len__(self):
                return 64
            def __getitem__(self, i):
                return X[i], Y[i]
        class Term(paddle.hapi.callbacks.Callback):
            n = 0
            def on_batch_end(self, mode, step, logs=None):
                Term.n += 1
                if Term.n == 3:
                    os.kill(os.getpid(), signal.SIGTERM)
        net = nn.Sequential(nn.Linear(8, 4))
        m = paddle.Model(net)
        m.prepare(paddle.optimizer.SGD(0.1, parameters=net.parameters()),
                  nn.CrossEntropyLoss())
        loader = paddle.io.DataLoader(DS(), batch_size=4, num_workers=2)
        m.fit(loader, verbose=0, callbacks=[Term()],
              checkpoint_dir={str(tmp_path)!r}, checkpoint_every=2)
    """)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 101, r.stderr[-2000:]
    assert latest_step(str(tmp_path)) == 3
