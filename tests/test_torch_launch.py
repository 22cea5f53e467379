"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``)
against the bodies of ``tests/test_launch.py``: collectives across
launched processes (the world and a two-process group), send / receive,
a multi-node restart coordinated through one store, the comm-task
tracker, the restart policy, and a ``DataParallel`` ``TrainStep`` across
processes held to JAX's single-process step on the same weights and
batch (rtol 1e-5, atol 1e-6, JAX's bound).

The collective, send / receive and TrainStep bodies run in one launched
job of 4 gloo ranks (one spawn, ``tests/torch_launch_worker.py``), each
rank writing its record. A launched job takes the tests' one spawn slot
and runs at nice 10 (``dist_ranks.spawn_lock``, ``below_workers``). The
two restart soaks keep JAX's ``slow`` mark.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

import dist_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_launch_worker.py")
WORLD = 4


def _launch(tmp_path, extra, worker_args=(), timeout=240):
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    env = dict(os.environ, PADDLE_LOG_DIR_OUT=str(out))
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--backend", "gloo", "--log_dir", str(tmp_path / "log"),
           "--heartbeat_interval", "0.5", *extra, WORKER, *worker_args]
    with dist_ranks.spawn_lock():
        r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=timeout,
                           preexec_fn=dist_ranks.below_workers)
    recs = {}
    for p in out.glob("rank*.json"):
        rec = json.loads(p.read_text())
        recs[rec["rank"]] = rec
    return r, recs


def _logs(tmp_path):
    d = tmp_path / "log"
    return {p.name: p.read_text() for p in d.glob("workerlog.*")} \
        if d.exists() else {}


def _jax_trainstep(path):
    """JAX's single-process TrainStep on the whole batch; the weights and
    the batch written to ``path`` for the workers."""
    import paddle_tpu as paddle
    from paddle_tpu import nn
    from paddle_tpu.jit.train import TrainStep

    paddle.seed(0)
    model = nn.Sequential(nn.Linear(16, 32), nn.GELU(), nn.Linear(32, 16))
    state = {f"w:{k}": np.asarray(v._value)
             for k, v in model.state_dict().items()}
    opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                 parameters=model.parameters())
    loss_fn = nn.MSELoss()
    step = TrainStep(model, lambda o, y: loss_fn(o, y), opt)
    rs = np.random.RandomState(0)
    x = rs.randn(16, 16).astype("float32")
    y = rs.randn(16, 16).astype("float32")
    np.savez(path, x=x, y=y, **state)
    return [float(step(paddle.to_tensor(x), paddle.to_tensor(y)))
            for _ in range(3)]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    ref = _jax_trainstep(str(tmp / "ts.npz"))
    r, recs = _launch(tmp, ["--nproc_per_node", str(WORLD)],
                      ["--trainstep", str(tmp / "ts.npz")])
    return r, recs, ref, _logs(tmp)


def test_launch_collective_4_ranks(job):
    r, recs, _, logs = job
    assert r.returncode == 0, (r.stdout, r.stderr, logs)
    assert sorted(recs) == list(range(WORLD))
    for rec in recs.values():
        assert rec["world"] == WORLD and rec["attempt"] == 0
        assert rec["sum"] == [WORLD * (WORLD + 1) / 2] * 4
        assert rec["server"] == "native"
        assert rec["heartbeats"] >= 1


def test_launch_two_process_collective(job):
    _, recs, _, _ = job
    for rank in (0, 1):
        assert recs[rank]["pair_sum"] == [3.0] * 3


def test_launch_cross_process_send_recv(job):
    _, recs, _, _ = job
    want = np.arange(6, dtype=np.float32).reshape(2, 3)
    first, second = recs[1]["received"]
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want + 100)


def test_launch_multiprocess_trainstep_parity(job):
    _, recs, ref, _ = job
    for rec in recs.values():
        np.testing.assert_allclose(rec["ts_losses"], ref, rtol=1e-5,
                                   atol=1e-6)


def test_multinode_restart_coordination(tmp_path):
    """Two controllers (nnodes 2) share one store: a failure on node 1
    restarts both pods in lockstep, and the job completes on attempt 1."""
    from paddle_tpu_torch.distributed.launch.context import (
        Context, free_port, parse_args,
    )
    from paddle_tpu_torch.distributed.launch.controller import (
        CollectiveController,
    )

    worker = tmp_path / "w.py"
    worker.write_text(textwrap.dedent("""
        import os, time
        attempt = int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0"))
        rank = int(os.environ["PADDLE_TRAINER_ID"])
        if attempt == 0 and rank == 1:
            os._exit(9)
        time.sleep(1.0)   # both attempts: node 0's worker is restarted too
    """))
    port = free_port()
    results = {}

    def run_node(node_rank):
        args = parse_args([
            "--master", f"127.0.0.1:{port}", "--nnodes", "2", "--node_rank",
            str(node_rank), "--nproc_per_node", "1", "--max_restarts", "1",
            "--backend", "gloo", "--log_dir", str(tmp_path / f"n{node_rank}"),
            str(worker)])
        ctx = Context(args)
        c = CollectiveController(ctx)
        try:
            results[node_rank] = c.watch()
        finally:
            c.finalize()

    ts = [threading.Thread(target=run_node, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert results == {0: 0, 1: 0}, results
    for node in range(2):
        log = (tmp_path / f"n{node}" / "workerlog.0").read_text()
        assert "attempt 1" in log, (node, log)


def test_comm_task_tracker_unit():
    """``current_comm_task`` names the collective in flight (what the
    heartbeat publishes)."""
    from paddle_tpu_torch.distributed.collective import (
        _track_comm, current_comm_task,
    )

    assert current_comm_task() is None
    with _track_comm("all_reduce"):
        op, seq, age = current_comm_task()
        assert op == "all_reduce" and seq >= 1 and age >= 0
    assert current_comm_task() is None


def test_worker_environment_and_exit_code_policy():
    """The worker's variables (no JAX coordinator; the process group's
    port is not the store's) and ``_pick_exit_code``: a crash outranks
    the elastic codes, which restart for free."""
    from paddle_tpu_torch.distributed.fleet.elastic import (
        ELASTIC_AUTO_PARALLEL_EXIT_CODE, ELASTIC_EXIT_CODE,
    )
    from paddle_tpu_torch.distributed.launch.context import (
        Context, parse_args,
    )
    from paddle_tpu_torch.distributed.launch.controller import (
        _pick_exit_code,
    )

    ctx = Context(parse_args(["--master", "10.0.0.1:7000", "--nnodes", "2",
                              "--node_rank", "1", "--nproc_per_node", "2",
                              "--backend", "cpu", "train.py"]))
    env = ctx.worker_env(1)
    assert env["PADDLE_TRAINER_ID"] == "3"
    assert env["PADDLE_TRAINERS_NUM"] == "4"
    assert env["PADDLE_MASTER"] == "10.0.0.1:7000"
    assert env["MASTER_PORT"] == "7001" and env["MASTER_ADDR"] == "10.0.0.1"
    assert env["PADDLE_DISTRI_BACKEND"] == "gloo"
    # the launcher sets no JAX coordinator of its own
    assert env.get("PADDLE_JAX_COORDINATOR") == os.environ.get(
        "PADDLE_JAX_COORDINATOR")
    assert (ELASTIC_EXIT_CODE, ELASTIC_AUTO_PARALLEL_EXIT_CODE) == (101, 102)
    assert _pick_exit_code([ELASTIC_EXIT_CODE, 9]) == 9
    assert _pick_exit_code([ELASTIC_EXIT_CODE]) == ELASTIC_EXIT_CODE
    from paddle_tpu_torch.framework import checkpoint

    assert checkpoint.ELASTIC_EXIT_CODE is ELASTIC_EXIT_CODE


@pytest.mark.slow  # a multi-process restart soak, as JAX's
def test_launch_restart_on_failure(tmp_path):
    r, recs = _launch(tmp_path, ["--nproc_per_node", "2",
                                 "--max_restarts", "1"], ["--fail-once"])
    assert "crash budget 1/1" in r.stdout, (r.stdout, r.stderr)
    assert r.returncode == 0, (r.stdout, r.stderr, _logs(tmp_path))
    assert {rec["attempt"] for rec in recs.values()} == {1}


@pytest.mark.slow  # a multi-process soak, as JAX's
def test_launch_propagates_failure_when_no_restarts(tmp_path):
    r, _ = _launch(tmp_path, ["--nproc_per_node", "2", "--max_restarts",
                              "0"], ["--fail-once"])
    assert r.returncode == 17, (r.returncode, r.stdout, r.stderr)
