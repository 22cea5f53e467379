"""``paddle.distributed.rpc`` — worker-to-worker remote procedure calls;
the counterpart of ``paddle_tpu/distributed/rpc/__init__.py`` (Paddle
``rpc.py``: ``init_rpc:85``, ``rpc_sync:160``, ``rpc_async:206``,
``shutdown``, ``get_worker_info``).

The transport is the job's own control plane, as in the JAX package: each
worker runs an agent thread serving requests posted to a TCP store, the
launcher's (``env.store()``, in a job started by
``python -m paddle_tpu_torch.distributed.launch``) or one given as
``store=`` / ``master_endpoint=`` ("host:port", rank 0 hosts it).
Payloads are pickled: the peers are the job's own trusted workers.
Requests to a rank land at ``rpc/req/<rank>/<seq>`` and its agent serves
them in order; the answer goes to ``rpc/resp/<request id>``, the
request id riding outside the pickle so a poison payload is still
answered. A fresh agent resumes the inbox cursor it finds in the store.

It carries control-plane traffic (the replica fleet's proxies, metrics,
coordination); tensors between ranks go through the collectives.
"""
from __future__ import annotations

import pickle
import threading
import time
import uuid

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown", "get_worker_info",
           "get_all_worker_infos", "WorkerInfo"]


class WorkerInfo:
    def __init__(self, name, rank):
        self.name = name
        self.rank = rank

    def __repr__(self):
        return f"WorkerInfo(name={self.name!r}, rank={self.rank})"


class _Future:
    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._exc = None

    def _resolve(self, value=None, exc=None):
        self._value, self._exc = value, exc
        self._event.set()

    def wait(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("rpc future timed out")
        if self._exc is not None:
            raise self._exc
        return self._value


class _RpcAgent:
    """Store-backed request/response loop.

    Requests land at ``rpc/req/<rank>/<seq>``; the serving agent polls its
    inbox counter, executes, and writes ``rpc/resp/<req_id>``.
    """

    POLL_S = 0.02

    def __init__(self, store, name, rank, world_size):
        self.store = store
        self.name = name
        self.rank = rank
        self.world_size = world_size
        self._stop = threading.Event()
        # resume the inbox cursor: a fresh agent on a store with history
        # (agent restart without shutdown()'s rpc/ wipe) must not re-poll
        # slot 0 forever while callers write at the live sequence number
        raw = store.get(f"rpc/served/{rank}", wait=False)
        self._served = int(raw) if raw else 0
        # the serving loop gets its OWN connection: a blocking wait_key on a
        # shared client holds its socket lock, which would starve this loop
        # (and with it every inbound request) until the wait times out
        self._serve_store = self._clone()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"rpc-agent-{rank}")
        self._thread.start()

    def _clone(self):
        from ..store import TCPStore

        return TCPStore(host=self.store.host, port=self.store.port,
                        world_size=self.world_size)

    def _serve(self):
        st = self._serve_store
        while not self._stop.is_set():
            key = f"rpc/req/{self.rank}/{self._served}"
            try:
                # blocking server-side wait (NOT a 20ms busy-poll: idle agents
                # would otherwise hammer the control-plane store); the short
                # timeout bounds how long stop() waits
                if not st.wait_key(key, timeout=0.5):
                    continue
                raw = st.get(key, wait=False)
            except Exception:
                return  # connection closed: job tearing down
            if raw is None:
                continue
            st.delete_key(key)
            self._served += 1
            st.set(f"rpc/served/{self.rank}", str(self._served))
            # req_id rides OUTSIDE the pickle so a poison payload can still be
            # answered (a dead letter beats a dead agent + caller timeout)
            req_id, _, body = raw.partition(b"|")
            req_id = req_id.decode()
            try:
                _, fn, args, kwargs = pickle.loads(body)
                result = {"ok": True, "value": fn(*args, **kwargs)}
            except Exception as e:
                result = {"ok": False, "error": e}
            try:
                blob = pickle.dumps(result)
            except Exception as e:  # unpicklable result/exception state
                blob = pickle.dumps({"ok": False,
                                     "error": RuntimeError(
                                         f"rpc result not picklable: {e!r}")})
            try:
                st.set(f"rpc/resp/{req_id}", blob)
            except Exception:
                return

    def call(self, to_rank, fn, args, kwargs, timeout):
        req_id = uuid.uuid4().hex
        seq = self.store.add(f"rpc/seq/{to_rank}", 1) - 1
        self.store.set(f"rpc/req/{to_rank}/{seq}",
                       req_id.encode() + b"|"
                       + pickle.dumps((req_id, fn, args, kwargs)))
        fut = _Future()

        def waiter():
            # dedicated connection per outstanding call: blocking waits must
            # not serialize behind each other (or the serving loop)
            st = self._clone()
            try:
                raw = st.get(f"rpc/resp/{req_id}", timeout=timeout)
                st.delete_key(f"rpc/resp/{req_id}")
                result = pickle.loads(raw)
                if result["ok"]:
                    fut._resolve(value=result["value"])
                else:
                    fut._resolve(exc=result["error"])
            except Exception as e:
                fut._resolve(exc=e)
            finally:
                st._sock.close()

        threading.Thread(target=waiter, daemon=True).start()
        return fut

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
        try:
            self._serve_store._sock.close()
        except Exception:
            pass


_agent: _RpcAgent | None = None
_workers: dict[str, WorkerInfo] = {}


def init_rpc(name, rank=None, world_size=None, master_endpoint=None, store=None):
    """Start this worker's RPC agent. Inside a launched job the control-plane
    store is reused automatically; standalone callers pass `store` (TCPStore)
    or `master_endpoint` ("host:port", rank 0 hosts)."""
    global _agent
    if _agent is not None:
        raise RuntimeError("init_rpc already called")
    from .. import env as _env

    if store is None:
        store = _env.store()
    if store is None:
        if master_endpoint is None:
            raise ValueError("outside a launched job, pass store= or "
                             "master_endpoint=")
        from ..store import TCPStore

        host, port = master_endpoint.rsplit(":", 1)
        store = TCPStore(host=host, port=int(port), world_size=world_size,
                         is_master=(rank == 0))
    if rank is None:
        rank = _env.get_rank()
    if world_size is None:
        world_size = _env.get_world_size()
    # register worker name <-> rank
    store.set(f"rpc/worker/{rank}", name.encode())
    for r in range(world_size):
        raw = store.get(f"rpc/worker/{r}", timeout=60)
        _workers[raw.decode()] = WorkerInfo(raw.decode(), r)
    _agent = _RpcAgent(store, name, rank, world_size)
    store.barrier("rpc_init", world_size, timeout=60)
    return _agent


def _resolve_rank(to):
    if isinstance(to, int):
        return to
    if isinstance(to, WorkerInfo):
        return to.rank
    if to in _workers:
        return _workers[to].rank
    raise ValueError(f"unknown rpc worker {to!r}")


def rpc_async(to, fn, args=None, kwargs=None, timeout=60.0):
    """Reference rpc.py:206 — returns a future with .wait()."""
    if _agent is None:
        raise RuntimeError("call init_rpc first")
    return _agent.call(_resolve_rank(to), fn, tuple(args or ()),
                       dict(kwargs or {}), timeout)


def rpc_sync(to, fn, args=None, kwargs=None, timeout=60.0):
    """Reference rpc.py:160 — blocking call, returns the remote result."""
    return rpc_async(to, fn, args, kwargs, timeout).wait(timeout)


def get_worker_info(name=None):
    if name is None:
        return _workers.get(_agent.name) if _agent else None
    return _workers[name]


def get_all_worker_infos():
    return sorted(_workers.values(), key=lambda w: w.rank)


def shutdown():
    """Reference rpc.py shutdown — barrier, stop the agent, wipe rpc/* state
    so a later init_rpc on the same store starts with fresh seq counters."""
    global _agent
    if _agent is None:
        return
    try:
        _agent.store.barrier("rpc_shutdown", _agent.world_size, timeout=30)
    except Exception:
        pass
    _agent.stop()
    try:
        if _agent.rank == 0:
            _agent.store.clear("rpc/")
        _agent.store.barrier("rpc_cleared", _agent.world_size, timeout=30)
    except Exception:
        pass
    _agent = None
    _workers.clear()
