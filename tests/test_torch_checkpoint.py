"""``framework.checkpoint`` (``CheckpointManager``, ``latest_step``,
``PreemptionFlush``) and ``Model.fit``'s checkpointing, on both packages.

The bodies are ``tests/test_checkpoint.py``'s, run on the JAX package and
on the port over each package's own ``TrainStep`` (``port_bodies.run``:
the port's results, which are step numbers, retained steps, flags and
bit-equality verdicts, equal to the JAX package's). Left out: the sharded
mesh restore (the port saves one device's tensors whole), the bench-wiring
and ``StepMonitor`` goodput legs (neither is ported) and the slow soak.
Faults are injected with the JAX package's test harness
(``inference/faults.py``: ``FaultInjector``, ``ThreadDeath``), which both
managers take as their ``injector``.
"""
import json
import os
import signal
import tempfile
import threading

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as port
from paddle_tpu.inference.faults import FaultInjector, ThreadDeath
from port_bodies import on_cpu, run  # noqa: F401

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _ck(paddle):
    if paddle is paddle_tpu:
        from paddle_tpu.framework import checkpoint
    else:
        from paddle_tpu_torch.framework import checkpoint
    return checkpoint


def _train_step_cls(paddle):
    if paddle is paddle_tpu:
        from paddle_tpu.jit.train import TrainStep
    else:
        from paddle_tpu_torch.jit import TrainStep
    return TrainStep


def _build(paddle, seed=0, lr=1e-2):
    nn = paddle.nn
    paddle.seed(seed)
    model = nn.Sequential(nn.Linear(8, 16), nn.GELU(), nn.Linear(16, 4))
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=model.parameters())
    loss_fn = nn.CrossEntropyLoss()
    return model, _train_step_cls(paddle)(model, lambda o, y: loss_fn(o, y),
                                          opt)


def _batch(paddle, b=16, seed=0):
    rs = np.random.RandomState(seed)
    return (paddle.to_tensor(rs.randn(b, 8).astype("float32")),
            paddle.to_tensor(rs.randint(0, 4, b).astype("int64")))


def _params(step):
    if hasattr(step, "_param_tensors"):
        return {k: np.asarray(t._value) for k, t in
                step._param_tensors.items()}
    return {k: v.detach().numpy().copy() for k, v in
            torch.nn.Module.state_dict(step.model).items()}


def _same(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def _steps_run(paddle, step, n, x, y):
    losses = step.run_steps(n, x, y)
    return np.asarray(getattr(losses, "_value", losses))


def kill_resume_matches_uninterrupted(paddle):
    ck = _ck(paddle)
    K = 4
    x, y = _batch(paddle)
    _, full_step = _build(paddle, 0)
    full = [float(full_step(x, y)) for _ in range(2 * K)]
    full_params = _params(full_step)
    tmp = tempfile.mkdtemp()
    _, a = _build(paddle, 0)
    mgr = ck.CheckpointManager(tmp, async_save=True)
    pre = [float(a(x, y)) for _ in range(K)]
    mgr.save(a, K)
    float(a(x, y))      # steps that run but are never checkpointed
    float(a(x, y))
    mgr.close()
    _, b = _build(paddle, 123)          # another init
    restored = ck.CheckpointManager(tmp).restore(b)
    resumed = [float(b(x, y)) for _ in range(K)]
    return {"restored": restored, "pre_equal": pre == full[:K],
            "resumed_equal": resumed == full[K:],
            "params_equal": _same(_params(b), full_params)}


def run_steps_restore(paddle):
    ck = _ck(paddle)
    x, y = _batch(paddle)
    _, full_step = _build(paddle, 0)
    full = _steps_run(paddle, full_step, 6, x, y)
    tmp = tempfile.mkdtemp()
    _, a = _build(paddle, 0)
    first = _steps_run(paddle, a, 3, x, y)
    ck.CheckpointManager(tmp, async_save=False).save(a, 3)
    _, b = _build(paddle, 9)
    restored = ck.CheckpointManager(tmp).restore(b)
    rest = _steps_run(paddle, b, 3, x, y)
    return {"restored": restored,
            "first_equal": bool(np.array_equal(first, full[:3])),
            "rest_equal": bool(np.array_equal(rest, full[3:]))}


def mid_commit_kill_falls_back(paddle):
    ck = _ck(paddle)
    x, y = _batch(paddle)
    tmp = tempfile.mkdtemp()
    inj = FaultInjector()
    _, step = _build(paddle, 0)
    mgr = ck.CheckpointManager(tmp, async_save=False, injector=inj)
    [float(step(x, y)) for _ in range(2)]
    mgr.save(step, 2)
    at_2 = _params(step)
    [float(step(x, y)) for _ in range(2)]
    inj.install("ckpt.commit", error=ThreadDeath())
    with pytest.raises(ThreadDeath):
        mgr.save(step, 4)
    torn = (os.path.isdir(os.path.join(tmp, "step_0000000004.tmp")),
            os.path.isdir(os.path.join(tmp, "step_0000000004")))
    _, fresh = _build(paddle, 7)
    restored = ck.CheckpointManager(tmp).restore(fresh)
    return {"torn": torn, "latest": ck.latest_step(tmp),
            "restored": restored, "equal": _same(_params(fresh), at_2)}


def snapshot_and_serialize_kills_keep_previous(paddle):
    ck = _ck(paddle)
    x, y = _batch(paddle)
    tmp = tempfile.mkdtemp()
    inj = FaultInjector()
    _, step = _build(paddle, 0)
    mgr = ck.CheckpointManager(tmp, async_save=False, injector=inj)
    float(step(x, y))
    mgr.save(step, 1)
    for site, n in (("ckpt.snapshot", 2), ("ckpt.serialize", 3)):
        inj.install(site, error=ThreadDeath())
        with pytest.raises(ThreadDeath):
            mgr.save(step, n)
    return {"steps": ck.CheckpointManager(tmp).steps()}


def async_writer_failure_surfaces(paddle):
    ck = _ck(paddle)
    x, y = _batch(paddle)
    tmp = tempfile.mkdtemp()
    inj = FaultInjector()
    _, step = _build(paddle, 0)
    mgr = ck.CheckpointManager(tmp, async_save=True, injector=inj)
    inj.install("ckpt.serialize", error=RuntimeError("disk on fire"))
    float(step(x, y))
    mgr.save(step, 1)
    with pytest.raises(RuntimeError, match="disk on fire"):
        mgr.wait()
    float(step(x, y))
    mgr.save(step, 2)       # the writer survives and the next save lands
    mgr.wait()
    latest = mgr.latest_step()
    mgr.close()
    return {"latest": latest}


def corrupt_shard_falls_back(paddle):
    ck = _ck(paddle)
    x, y = _batch(paddle)
    tmp = tempfile.mkdtemp()
    _, step = _build(paddle, 0)
    mgr = ck.CheckpointManager(tmp, async_save=False)
    float(step(x, y))
    mgr.save(step, 1)
    at_1 = _params(step)
    float(step(x, y))
    mgr.save(step, 2)
    data = os.path.join(tmp, "step_0000000002", "data_r0.npz")
    with open(data, "r+b") as f:       # truncated: a torn write
        f.truncate(os.path.getsize(data) // 2)
    _, fresh = _build(paddle, 5)
    with pytest.warns(ck.CheckpointCorruptWarning, match="truncated"):
        r1 = ck.CheckpointManager(tmp).restore(fresh)
    equal = _same(_params(fresh), at_1)
    mgr.save(step, 3)
    data3 = os.path.join(tmp, "step_0000000003", "data_r0.npz")
    raw = bytearray(open(data3, "rb").read())
    raw[len(raw) // 2] ^= 0xFF         # a flipped bit, same size
    with open(data3, "wb") as f:
        f.write(bytes(raw))
    _, fresh2 = _build(paddle, 6)
    with pytest.warns(ck.CheckpointCorruptWarning, match="crc32"):
        r2 = ck.CheckpointManager(tmp).restore(fresh2)
    return {"r1": r1, "r2": r2, "equal": equal}


def clock_skew_orders_by_step(paddle):
    ck = _ck(paddle)
    x, y = _batch(paddle)
    tmp = tempfile.mkdtemp()
    inj = FaultInjector()
    _, step = _build(paddle, 0)
    mgr = ck.CheckpointManager(tmp, async_save=False, injector=inj)
    float(step(x, y))
    inj.skew_clock(3600.0)
    mgr.save(step, 1)
    inj.skew_clock(7200.0)
    float(step(x, y))
    mgr.save(step, 2)
    nonneg = all(mgr.last_timings[p] >= 0.0
                 for p in ("snapshot", "serialize", "commit"))
    _, fresh = _build(paddle, 3)
    return {"nonneg": nonneg,
            "restored": ck.CheckpointManager(tmp).restore(fresh)}


def retention_keep_last_plus_keep_every(paddle):
    ck = _ck(paddle)
    x, y = _batch(paddle)
    tmp = tempfile.mkdtemp()
    _, step = _build(paddle, 0)
    mgr = ck.CheckpointManager(tmp, async_save=False, keep_last=2,
                               keep_every=4)
    for i in range(1, 9):
        float(step(x, y))
        mgr.save(step, i)
    _, fresh = _build(paddle, 2)
    return {"steps": mgr.steps(),
            "restored": ck.CheckpointManager(tmp).restore(fresh, step=4)}


def async_save_queues(paddle):
    ck = _ck(paddle)
    x, y = _batch(paddle)
    tmp = tempfile.mkdtemp()
    inj = FaultInjector()
    _, step = _build(paddle, 0)
    mgr = ck.CheckpointManager(tmp, async_save=True, injector=inj)
    inj.install("ckpt.serialize", delay=0.2)
    float(step(x, y))
    d = mgr.save(step, 1)              # returns before the write lands
    early = os.path.isdir(d)
    float(step(x, y))
    mgr.save(step, 2)
    mgr.wait()
    steps = mgr.steps()
    mgr.close()
    return {"early": early, "steps": steps}


def empty_dir_restore_returns_none(paddle):
    ck = _ck(paddle)
    tmp = tempfile.mkdtemp()
    _, step = _build(paddle, 0)
    return {"restored": ck.CheckpointManager(tmp).restore(step),
            "latest": ck.latest_step(tmp)}


def export_import_counters_and_rng(paddle):
    x, y = _batch(paddle)
    _, step = _build(paddle, 0)
    float(step(x, y))
    float(step(x, y))
    opt = getattr(step.optimizer, "_inner_opt", step.optimizer)
    snap = step.export_state()
    snap_np = {"params": {k: np.array(getattr(v, "_value", v))
                          for k, v in snap["params"].items()},
               "acc": {a: {k: np.array(getattr(v, "_value", v))
                           for k, v in per.items()}
                       for a, per in snap["acc"].items()},
               "meta": dict(snap["meta"])}
    count, seed = opt._step_count, step._seed
    programs = len(getattr(step, "_programs", {}))
    after = float(step(x, y))
    float(step(x, y))
    moved = opt._step_count - count
    step.import_state(snap_np)
    return {"moved": moved, "count_back": opt._step_count == count,
            "seed_back": step._seed == seed,
            "replay_equal": float(step(x, y)) == after,
            "no_new_program": len(getattr(step, "_programs", {})) == programs}


def export_state_carries_the_scheduler(paddle):
    nn = paddle.nn
    x, y = _batch(paddle)
    loss_fn = nn.CrossEntropyLoss()

    def make():
        paddle.seed(0)
        model = nn.Sequential(nn.Linear(8, 4))
        sched = paddle.optimizer.lr.StepDecay(learning_rate=0.1, step_size=2)
        opt = paddle.optimizer.Momentum(learning_rate=sched,
                                        parameters=model.parameters())
        return sched, _train_step_cls(paddle)(
            model, lambda o, t: loss_fn(o, t), opt)

    sched, step = make()
    for _ in range(3):
        float(step(x, y))
        sched.step()
    snap = step.export_state()
    sched2, step2 = make()
    step2.import_state(snap)
    return {"in_meta": snap["meta"]["lr_sched"] == sched.state_dict(),
            "restored": sched2.state_dict() == sched.state_dict(),
            "last_lr": float(sched2.get_lr())}


def manifest_records_files_and_meta(paddle):
    ck = _ck(paddle)
    x, y = _batch(paddle)
    _, step = _build(paddle, 0)
    tmp = tempfile.mkdtemp()
    mgr = ck.CheckpointManager(tmp, async_save=False)
    float(step(x, y))
    mgr.save(step, 1)
    d = os.path.join(tmp, "step_0000000001")
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    info = manifest["files"]["data_r0.npz"]
    return {"step": manifest["step"],
            "step_count": manifest["meta"]["step_count"],
            "files": list(manifest["files"]),
            "bytes_ok": info["bytes"] == os.path.getsize(
                os.path.join(d, "data_r0.npz")),
            "params": any(k.startswith("params.") for k in manifest["keys"]),
            "acc": any(k.startswith("acc.") for k in manifest["keys"])}


# ------------------------------------------------------------ Model.fit
class _LossRecorder:
    def __init__(self):
        self.losses = []

    def set_model(self, model):
        self.model = model

    def __getattr__(self, name):
        if name.startswith("on_"):
            if name == "on_batch_end":
                return self._on_batch_end
            return lambda *a, **k: None
        raise AttributeError(name)

    def _on_batch_end(self, mode, step, logs=None):
        if mode == "train":
            self.losses.append(logs["loss"][0])


class _Killer(_LossRecorder):
    def __init__(self, after):
        super().__init__()
        self.after = after

    def _on_batch_end(self, mode, step, logs=None):
        super()._on_batch_end(mode, step, logs)
        if len(self.losses) >= self.after:
            raise ThreadDeath()


class _Preemptor(_LossRecorder):
    def __init__(self, after):
        super().__init__()
        self.after = after

    def _on_batch_end(self, mode, step, logs=None):
        super()._on_batch_end(mode, step, logs)
        if mode == "train" and len(self.losses) == self.after:
            os.kill(os.getpid(), signal.SIGTERM)


def _fit_model(paddle, seed):
    nn = paddle.nn
    paddle.seed(seed)
    m = paddle.Model(nn.Sequential(nn.Linear(8, 16), nn.GELU(),
                                   nn.Linear(16, 4)))
    loss_fn = nn.CrossEntropyLoss()
    m.prepare(optimizer=paddle.optimizer.AdamW(
        learning_rate=1e-2, parameters=m.network.parameters()),
        loss=lambda o, t: loss_fn(o, t))
    return m


def _fit_data():
    rs = np.random.RandomState(0)
    X = rs.randn(32, 8).astype("float32")
    Y = rs.randint(0, 4, (32, 1)).astype("int64")
    return [(X[i], Y[i]) for i in range(32)]


def _fit(paddle, seed, epochs, callbacks, **kw):
    _fit_model(paddle, seed).fit(_fit_data(), batch_size=4, epochs=epochs,
                                 shuffle=False, verbose=0,
                                 callbacks=callbacks, **kw)


def fit_kill_auto_resume(paddle):
    ck = _ck(paddle)
    base = _LossRecorder()
    _fit(paddle, 0, 2, [base])
    d = tempfile.mkdtemp()
    killer = _Killer(11)
    with pytest.raises(ThreadDeath):
        _fit(paddle, 0, 2, [killer], checkpoint_dir=d, checkpoint_every=4)
    latest_killed = ck.latest_step(d)
    rec = _LossRecorder()
    _fit(paddle, 99, 2, [rec], checkpoint_dir=d, checkpoint_every=4)
    return {"n": len(base.losses), "killed": killer.losses == base.losses[:11],
            "latest_killed": latest_killed,
            "resumed": rec.losses == base.losses[8:],
            "latest": ck.latest_step(d)}


def fit_graceful_flush_and_noop_resume(paddle):
    ck = _ck(paddle)
    d = tempfile.mkdtemp()
    _fit(paddle, 0, 1, [_LossRecorder()], checkpoint_dir=d)
    latest = ck.latest_step(d)
    again = _LossRecorder()
    _fit(paddle, 1, 1, [again], checkpoint_dir=d)
    more = _LossRecorder()
    _fit(paddle, 2, 2, [more], checkpoint_dir=d)
    base = _LossRecorder()
    _fit(paddle, 0, 2, [base])
    return {"latest": latest, "again": again.losses,
            "more": len(more.losses), "equal": more.losses == base.losses[8:]}


def fit_resume_never_starts_fresh(paddle):
    d = tempfile.mkdtemp()
    with pytest.raises(ThreadDeath):
        _fit(paddle, 0, 1, [_Killer(6)], checkpoint_dir=d,
             checkpoint_every=4)
    rec = _LossRecorder()
    _fit(paddle, 0, 1, [rec], checkpoint_dir=d, checkpoint_every=4,
         resume="never")
    return {"n": len(rec.losses)}


def fit_sigterm_flushes_and_exits_elastic(paddle):
    ck = _ck(paddle)
    base = _LossRecorder()
    _fit(paddle, 0, 2, [base])
    sentinel = lambda *a: None                  # noqa: E731
    prev = signal.signal(signal.SIGTERM, sentinel)
    try:
        d = tempfile.mkdtemp()
        pre = _Preemptor(5)
        with pytest.raises(ck.PreemptionExit) as ei:
            _fit(paddle, 0, 2, [pre], checkpoint_dir=d, checkpoint_every=4)
        handler_back = signal.getsignal(signal.SIGTERM) is sentinel
        latest_pre = ck.latest_step(d)
        rec = _LossRecorder()
        _fit(paddle, 99, 2, [rec], checkpoint_dir=d, checkpoint_every=4)
    finally:
        signal.signal(signal.SIGTERM, prev)
    return {"code": ei.value.code, "pre": pre.losses == base.losses[:5],
            "latest_pre": latest_pre, "handler_back": handler_back,
            "resumed": rec.losses == base.losses[5:],
            "latest": ck.latest_step(d)}


def preemption_flush_off_main_thread(paddle):
    got = {}

    def off_main():
        fl = _ck(paddle).PreemptionFlush().install()
        got["installed"] = fl.installed
        fl.restore()

    t = threading.Thread(target=off_main)
    t.start()
    t.join(10)
    return dict(got)


def monitor_counters_through_a_manager(paddle):
    """A bound StepMonitor's counters ride a checkpoint: the manager feeds
    its phases and result; a restored step parks them for the next bind,
    whose step count continues (JAX train.py:425-483)."""
    obs, ck = paddle.observability, _ck(paddle)
    x, y = _batch(paddle)
    _, step = _build(paddle, 0)
    mon = obs.StepMonitor(peak_flops=None, lint=False).bind(step)
    for _ in range(3):
        float(step(x, y))
    with tempfile.TemporaryDirectory() as d:
        ck.CheckpointManager(d, async_save=False, monitor=mon).save(step, 3)
        _, fresh = _build(paddle, 1)
        watcher = obs.StepMonitor(peak_flops=None, lint=False)
        restored = ck.CheckpointManager(d, monitor=watcher).restore(fresh)
    pending = dict(fresh._pending_monitor_counters or {})
    later = obs.StepMonitor(peak_flops=None, lint=False).bind(fresh)
    float(fresh(x, y))
    text = mon.render()
    return {"restored": restored, "pending": json.dumps(pending),
            "step": later.last_fields["step"],
            "phases": ",".join(s.name for s in mon.tracer.spans()
                               if s.name.startswith("ckpt_")),
            "restore": [s.name for s in watcher.tracer.spans()] == [
                "ckpt_restore"],
            "committed": ('paddle_train_checkpoints_total{result="committed"}'
                          ' 1') in text}


BODIES = [kill_resume_matches_uninterrupted, run_steps_restore,
          mid_commit_kill_falls_back,
          snapshot_and_serialize_kills_keep_previous,
          async_writer_failure_surfaces, corrupt_shard_falls_back,
          clock_skew_orders_by_step, retention_keep_last_plus_keep_every,
          async_save_queues, empty_dir_restore_returns_none,
          export_import_counters_and_rng, export_state_carries_the_scheduler,
          manifest_records_files_and_meta, fit_kill_auto_resume,
          fit_graceful_flush_and_noop_resume, fit_resume_never_starts_fresh,
          fit_sigterm_flushes_and_exits_elastic,
          preemption_flush_off_main_thread,
          monitor_counters_through_a_manager]


@PKG
@pytest.mark.parametrize("body", BODIES, ids=[b.__name__ for b in BODIES])
def test_checkpoint_body(on_cpu, body, pkg):
    run(body, pkg)


def test_fit_sigterm_flushes_and_exits_elastic(on_cpu):
    """``test_checkpoint.py``'s SIGTERM body on the port alone: the JAX
    package's synchronous flush does not wait for the periodic write still
    in flight, whose ``.tmp`` directory its retention sweep then removes
    (ROADMAP C), so its leg fails now and then under load; the port's flush
    waits for it first."""
    got = fit_sigterm_flushes_and_exits_elastic(port)
    assert got == {"code": 101, "pre": True, "latest_pre": 5,
                   "handler_back": True, "resumed": True, "latest": 16}


def test_a_blocking_save_waits_for_the_write_in_flight(on_cpu):
    """A periodic (asynchronous) save whose write is slow, then at once a
    blocking one: both commit, and no write fails."""
    ck = _ck(port)
    x, y = _batch(port)
    tmp = tempfile.mkdtemp()
    inj = FaultInjector()
    _, step = _build(port, 0)
    mgr = ck.CheckpointManager(tmp, async_save=True, injector=inj)
    inj.install("ckpt.serialize", delay=0.3)
    float(step(x, y))
    mgr.save(step, 1)
    float(step(x, y))
    mgr.save(step, 2, blocking=True)
    mgr.close()
    assert mgr.steps() == [1, 2] and mgr.commits == 2


def test_port_bfloat16_state_round_trips_bit_for_bit(on_cpu, tmp_path):
    """bf16 parameters and moments (the O2 state) are stored as their bits
    and come back as bf16 tensors, equal bit for bit, through a restore."""
    from paddle_tpu_torch.framework.checkpoint import CheckpointManager

    model, step = _build(port, 0)
    port.amp.decorate(model, level="O2", dtype="bfloat16")
    _, step = model, _train_step_cls(port)(
        model, lambda o, y: port.nn.CrossEntropyLoss()(o, y),
        port.optimizer.AdamW(learning_rate=1e-2,
                             parameters=model.parameters()))
    x, y = _batch(port)
    x = port.Tensor(x._value.bfloat16())
    float(step(x, y))
    want = step.export_state()
    CheckpointManager(str(tmp_path), async_save=False).save(step, 1)
    float(step(x, y))
    assert CheckpointManager(str(tmp_path)).restore(step) == 1
    got = step.export_state()
    for part in ("params", "acc"):
        flat_w = {f"{k}/{j}": v for k, d in want[part].items()
                  for j, v in (d.items() if isinstance(d, dict)
                               else [("", d)])}
        flat_g = {f"{k}/{j}": v for k, d in got[part].items()
                  for j, v in (d.items() if isinstance(d, dict)
                               else [("", d)])}
        assert flat_w.keys() == flat_g.keys()
        for k in flat_w:
            assert flat_g[k].dtype == flat_w[k].dtype, k
            assert torch.equal(flat_g[k], flat_w[k]), k
    assert any(v.dtype == torch.bfloat16 for v in want["params"].values())
