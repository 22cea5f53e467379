"""The port's control-plane store (``paddle_tpu_torch.distributed.store``)
against the JAX package's: ``tests/test_launch.py``'s store bodies on both
server forms (the native C++ server, built into the git-ignored
``paddle_tpu_torch/_build/``, and the threaded Python one), and the wire
protocol both ways: the port's client on JAX's servers and JAX's client
on the port's."""
import struct
import threading

import pytest

from paddle_tpu_torch.distributed.store import TCPStore


def _exercise(master, client):
    """``test_store_set_get_add_wait``'s body over a master and a client
    (of either package)."""
    master.set("k", b"v1")
    assert client.get("k") == b"v1"
    client.set("k", "v2")
    assert master.get("k") == b"v2"
    assert master.get("nope", wait=False) is None
    assert client.add("ctr", 3) == 3
    assert master.add("ctr", -1) == 2
    assert client.wait_key("k", 1.0)
    assert not client.wait_key("absent", 0.2)
    assert master.delete_key("k")
    assert not master.delete_key("k")
    n0 = master.num_keys()
    master.set("another", b"x")
    assert master.num_keys() == n0 + 1
    master.set("pre/a", b"1")
    client.set("pre/b", b"2")
    assert client.clear("pre/") == 2
    assert master.get("pre/a", wait=False) is None


@pytest.mark.parametrize("prefer_native", [True, False])
def test_store_set_get_add_wait(prefer_native):
    master = TCPStore(is_master=True, world_size=2,
                      prefer_native=prefer_native)
    assert master.server_kind == ("native" if prefer_native else "python")
    client = TCPStore(port=master.port, world_size=2)
    assert client.server_kind is None
    try:
        _exercise(master, client)
    finally:
        client.close()
        master.close()


def test_native_server_is_built_outside_the_source_tree():
    from paddle_tpu_torch.distributed import store

    path = store._build_native()
    assert "/_build/" in path and path.endswith(".so")
    assert not list(store._SRC.parent.glob("*.so"))


def test_store_barrier_blocks_until_all():
    master = TCPStore(is_master=True, world_size=3)
    clients = [TCPStore(port=master.port, world_size=3) for _ in range(2)]
    errs, order = [], []

    def arrive(st, name):
        try:
            st.barrier("b", 3, timeout=10)
            order.append(name)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    try:
        ts = [threading.Thread(target=arrive, args=(s, i))
              for i, s in enumerate([master] + clients)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(15)
        assert not errs
        assert len(order) == 3
        with pytest.raises(TimeoutError):
            master.barrier("b2", 3, timeout=0.3)
    finally:
        for s in clients:
            s.close()
        master.close()


def test_store_concurrent_add_is_atomic():
    master = TCPStore(is_master=True)
    clients = [TCPStore(port=master.port) for _ in range(4)]
    try:
        def bump(st):
            for _ in range(50):
                st.add("n", 1)

        ts = [threading.Thread(target=bump, args=(s,)) for s in clients]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert struct.unpack("<q", master.get("n"))[0] == 200
    finally:
        for s in clients:
            s.close()
        master.close()


@pytest.mark.parametrize("prefer_native", [True, False])
@pytest.mark.parametrize("server", ["jax", "port"])
def test_wire_protocol_interoperates_both_ways(server, prefer_native):
    """A server of one package and a client of the other speak one
    protocol: the store body runs with either as the master."""
    from paddle_tpu.distributed.store import TCPStore as JaxStore

    Master, Client = ((JaxStore, TCPStore) if server == "jax"
                      else (TCPStore, JaxStore))
    master = Master(is_master=True, world_size=2,
                    prefer_native=prefer_native)
    client = Client(port=master.port, world_size=2)
    try:
        _exercise(master, client)
        assert client.add("n", 5) == 5
        assert struct.unpack("<q", master.get("n"))[0] == 5
    finally:
        client.close()
        master.close()
