"""``distributed.rpc`` of the port against ``tests/test_rpc.py``'s bodies:
in-process agents over one TCP store (round trip and remote exceptions,
numpy payloads, a poison payload answered without killing the agent, the
inbox cursor a restarted agent resumes, a future's timeout), and a real
two-process job started by the port's launcher (``tests/
torch_launch_worker.py --rpc``, over the launcher's store), in a module
fixture that takes the tests' spawn slot at nice 10.
"""
import numpy as np
import pytest

from paddle_tpu_torch.distributed.rpc import _Future, _RpcAgent
from paddle_tpu_torch.distributed.store import TCPStore

from test_torch_launch import _launch, _logs


def _mul(a, b):
    return a * b


def _boom():
    raise ValueError("remote kaboom")


def _make_unpicklable():
    import threading

    return threading.Lock()


@pytest.fixture
def agents():
    master = TCPStore(is_master=True, world_size=2)
    c1 = TCPStore(port=master.port, world_size=2)
    a0 = _RpcAgent(master, "w0", 0, 2)
    a1 = _RpcAgent(c1, "w1", 1, 2)
    box = {"a1": a1}
    yield a0, box, c1
    a0.stop()
    box["a1"].stop()
    c1.close()
    master.close()


def test_agents_roundtrip_and_exceptions(agents):
    a0, box, _ = agents
    a1 = box["a1"]
    assert a0.call(1, _mul, (6, 7), {}, 10).wait(10) == 42
    assert a1.call(0, _mul, ("ab", 2), {}, 10).wait(10) == "abab"
    futs = [a0.call(1, _mul, (i, 10), {}, 10) for i in range(5)]
    assert [f.wait(10) for f in futs] == [0, 10, 20, 30, 40]
    with pytest.raises(ValueError, match="remote kaboom"):
        a0.call(1, _boom, (), {}, 10).wait(10)


def test_numpy_payloads(agents):
    a0, _, _ = agents
    x = np.arange(12, dtype="float32").reshape(3, 4)
    out = a0.call(1, np.transpose, (x,), {}, 10).wait(10)
    np.testing.assert_array_equal(out, x.T)


def test_poison_payload_does_not_kill_agent(agents):
    a0, _, _ = agents
    with pytest.raises(RuntimeError, match="not picklable"):
        a0.call(1, _make_unpicklable, (), {}, 10).wait(10)
    assert a0.call(1, _mul, (3, 3), {}, 10).wait(10) == 9


def test_agent_restart_resumes_inbox_cursor(agents):
    a0, box, c1 = agents
    assert a0.call(1, _mul, (2, 2), {}, 10).wait(10) == 4
    box["a1"].stop()
    box["a1"] = _RpcAgent(c1, "w1", 1, 2)
    assert a0.call(1, _mul, (5, 5), {}, 10).wait(10) == 25


def test_future_timeout():
    with pytest.raises(TimeoutError):
        _Future().wait(0.05)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rpc")
    r, recs = _launch(tmp, ["--nproc_per_node", "2"], ["--rpc"])
    return r, recs, _logs(tmp)


def test_two_process_rpc_via_launch(launched):
    r, recs, logs = launched
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:], logs)
    assert sorted(recs) == [0, 1]
    for rank, rec in recs.items():
        assert rec["rpc"] == (rank + 2) ** 2
        assert rec["workers"] == ["worker0", "worker1"]
