"""The port's elastic training (``fleet.elastic``) against the bodies of
``tests/test_elastic.py``: the node registry's scale events over the
port's store, ``parse_np``, and a worker killed (crash) or preempted
(SIGTERM -> autocheckpoint -> exit 101) mid-training that the launcher
restarts, resuming with the same losses. The workers
(``tests/torch_elastic_worker.py``) train JAX's seeded model, moved across
as numpy arrays; their losses before the kill are held to JAX's eager
steps on the same data (rtol 1e-5). The crash soak keeps JAX's ``slow``
mark."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import dist_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_elastic_worker.py")


def test_elastic_manager_scale_events():
    from paddle_tpu_torch.distributed.fleet.elastic import (
        ElasticManager, ElasticStatus,
    )
    from paddle_tpu_torch.distributed.store import TCPStore

    master = TCPStore(is_master=True, world_size=1)
    try:
        a = ElasticManager(master, "node-a", np_spec="1:3", ttl=0.5)
        b = ElasticManager(master, "node-b", np_spec="1:3", ttl=0.5)
        assert a.register() == 0
        assert b.register() == 1
        assert a.alive_slots() == [0, 1]
        assert a.rank_assignment() == {"node-a": 0, "node-b": 1}
        st, n = a.decide(current_world=2)
        assert st is ElasticStatus.COMPLETED and n == 2
        # scale out: a third node joins
        c = ElasticManager(master, "node-c", np_spec="1:3", ttl=0.5)
        assert c.register() == 2
        st, n = a.decide(current_world=2)
        assert st is ElasticStatus.RESTART and n == 3
        # scale in: node-c leaves, node-b's lease expires
        c.deregister()
        time.sleep(0.6)
        a.heartbeat()
        assert a.alive_slots() == [0]
        st, n = a.decide(current_world=2)
        assert st is ElasticStatus.RESTART and n == 1
        b2 = ElasticManager(master, "node-b", np_spec="1:3", ttl=0.5)
        assert b2.register() in (1, 2)
        assert a.rank_assignment()["node-a"] == 0
        assert a.rank_assignment()["node-b"] == 1
        st, _ = ElasticManager(master, "x", np_spec="3").decide(2)
        assert st is ElasticStatus.HOLD
    finally:
        master.close()


def test_parse_np():
    from paddle_tpu_torch.distributed.fleet.elastic.manager import parse_np

    assert parse_np("4") == (4, 4)
    assert parse_np("2:4") == (2, 4)
    with pytest.raises(ValueError):
        parse_np("4:2")


def _jax_reference(path, total):
    """JAX's model (``paddle.seed(0)``, as JAX's elastic worker) saved to
    ``path``, and its eager Adam losses on the workers' data."""
    import paddle_tpu as paddle
    from paddle_tpu import nn

    paddle.seed(0)
    model = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 1))
    np.savez(path, **{k: np.asarray(v._value)
                      for k, v in model.state_dict().items()})
    opt = paddle.optimizer.Adam(parameters=model.parameters(),
                                learning_rate=0.05)
    rs = np.random.RandomState(42)
    data = [(rs.randn(8, 4).astype("float32"),
             rs.randn(8, 1).astype("float32")) for _ in range(total)]
    losses = []
    for x, y in data:
        loss = ((model(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2
                ).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


TOTAL, CRASH_STEP = 12, 3


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The weights file and JAX's losses, once for the module."""
    path = tmp_path_factory.mktemp("elastic") / "w.npz"
    return str(path), _jax_reference(str(path), TOTAL)


def _launch(tmp_path, mode, nproc, max_restarts, total, crash_step,
            weights):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update({
        "ELASTIC_TEST_MODE": mode,
        "ELASTIC_CRASH_STEP": str(crash_step),
        "ELASTIC_TOTAL_STEPS": str(total),
        "ELASTIC_CKPT_DIR": str(tmp_path / "ckpt"),
        "ELASTIC_LOG": str(tmp_path / "losses"),
        "ELASTIC_WEIGHTS": weights,
        # the crash must land while the other rank is mid-run
        "ELASTIC_STEP_DELAY": "0.25" if mode == "crash" else "0.05",
    })
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--backend", "gloo", "--nproc_per_node", str(nproc),
           "--max_restarts", str(max_restarts),
           "--log_dir", str(tmp_path / "log"), WORKER]
    with dist_ranks.spawn_lock():
        return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                              text=True, timeout=300,
                              preexec_fn=dist_ranks.below_workers)


def _read_losses(tmp_path, rank):
    out = {}
    with open(tmp_path / f"losses.{rank}") as f:
        for line in f:
            attempt, r, step, loss = line.split()
            out.setdefault(int(attempt), {})[int(step)] = float(loss)
    return out


def _check_run(tmp_path, res, mode, ref):
    total, crash_step = TOTAL, CRASH_STEP
    assert res.returncode == 0, res.stdout + res.stderr
    losses0 = _read_losses(tmp_path, 0)
    assert max(losses0[0]) >= crash_step
    assert 1 in losses0, "no restart happened"
    resumed_first = min(losses0[1])
    if mode == "preempt":
        # SIGTERM -> save at the preempted step -> exit 101 -> resume one
        # step later, the restart free of the crash budget (0 here)
        assert resumed_first == crash_step + 1
        assert "preempted" in res.stdout
    else:
        assert crash_step < resumed_first <= max(losses0[0]) + 1
    for s in set(losses0[0]) & set(losses0[1]):
        np.testing.assert_allclose(losses0[0][s], losses0[1][s], rtol=1e-6)
    assert max(losses0[1]) == total - 1
    both = {**losses0[0], **losses0[1]}
    np.testing.assert_allclose([both[s] for s in range(total)], ref,
                               rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def preempted(tmp_path_factory, reference):
    """One launched job (one worker) preempted at step 3 and restarted."""
    tmp = tmp_path_factory.mktemp("preempt")
    return tmp, _launch(tmp, "preempt", 1, 0, TOTAL, CRASH_STEP,
                        reference[0])


def test_preempted_mid_step_resumes_with_loss_continuity(preempted,
                                                         reference):
    tmp, res = preempted
    _check_run(tmp, res, "preempt", reference[1])


@pytest.mark.slow  # the crash soak rides the slow tier, as JAX's
def test_crashed_mid_step_resumes_with_loss_continuity(tmp_path, reference):
    res = _launch(tmp_path, "crash", 2, 1, TOTAL, CRASH_STEP, reference[0])
    _check_run(tmp_path, res, "crash", reference[1])
