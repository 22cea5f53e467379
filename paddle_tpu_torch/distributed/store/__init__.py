"""The control-plane key-value store — the counterpart of
``paddle_tpu/distributed/store`` (reference
``paddle/phi/core/distributed/store/tcp_store.cc``, ``store.py``): the
launcher hosts a TCP server, every worker connects a client.

The server is native when it can be (``tcp_store.cc``, the port's own copy
of the JAX package's, built with ``g++`` at first use into
``paddle_tpu_torch/_build/``, git-ignored, never beside the source), so
it stays responsive while a worker holds the GIL; a threaded Python
server serves otherwise (``prefer_native=False``, or no compiler), as in
JAX. ``StoreServer.kind`` and ``TCPStore.server_kind`` say which serves
("native" or "python"). Client and both servers speak one length-prefixed
wire protocol, the JAX package's, so either package's client works with
either package's server.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import socket
import socketserver
import struct
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["TCPStore", "StoreServer"]

_SRC = Path(__file__).resolve().parent / "tcp_store.cc"
_BUILD = Path(__file__).resolve().parents[2] / "_build"

_CMD_SET, _CMD_GET, _CMD_ADD, _CMD_WAIT, _CMD_DEL, _CMD_NUM, _CMD_CLR = 1, 2, 3, 4, 5, 6, 7


def _build_native():
    """``tcp_store.cc`` compiled into ``_build/`` (named by a hash of the
    source: an edited source builds anew; a temporary name and a rename
    let concurrent builds race safely)."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = _BUILD / f"libtcp_store-{digest}.so"
    if so_path.exists():
        return str(so_path)
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-pthread",
           str(_SRC), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so_path)
    return str(so_path)


_native_lib = None
_native_failed = False


def _native():
    global _native_lib, _native_failed
    if _native_lib is None and not _native_failed:
        try:
            lib = ctypes.CDLL(_build_native())
            lib.tps_start.restype = ctypes.c_void_p
            lib.tps_start.argtypes = [ctypes.c_int]
            lib.tps_port.restype = ctypes.c_int
            lib.tps_port.argtypes = [ctypes.c_void_p]
            lib.tps_stop.argtypes = [ctypes.c_void_p]
            _native_lib = lib
        except Exception:
            _native_failed = True
    return _native_lib


# ------------------------------------------------------------------ fallback server
class _PyHandler(socketserver.BaseRequestHandler):
    def _read(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.request.recv(n - len(buf))
            if not chunk:
                raise ConnectionError
            buf += chunk
        return buf

    def _read_lv(self):
        (n,) = struct.unpack("<I", self._read(4))
        return self._read(n) if n else b""

    def handle(self):
        srv = self.server
        try:
            while True:
                cmd = self._read(1)[0]
                if cmd == _CMD_SET:
                    key, val = self._read_lv(), self._read_lv()
                    with srv.cond:
                        srv.data[key] = val
                        srv.cond.notify_all()
                    self.request.sendall(b"\x01")
                elif cmd == _CMD_GET:
                    key = self._read_lv()
                    with srv.cond:
                        val = srv.data.get(key)
                    if val is None:
                        self.request.sendall(b"\x00")
                    else:
                        self.request.sendall(b"\x01" + struct.pack("<I", len(val)) + val)
                elif cmd == _CMD_ADD:
                    key = self._read_lv()
                    (delta,) = struct.unpack("<q", self._read(8))
                    with srv.cond:
                        prev = srv.data.get(key)
                        # non-8-byte values count as 0, matching the native server
                        cur = struct.unpack("<q", prev)[0] if prev is not None and len(prev) == 8 else 0
                        new = cur + delta
                        srv.data[key] = struct.pack("<q", new)
                        srv.cond.notify_all()
                    self.request.sendall(struct.pack("<q", new))
                elif cmd == _CMD_WAIT:
                    key = self._read_lv()
                    (timeout_ms,) = struct.unpack("<I", self._read(4))
                    deadline = None if timeout_ms == 0 else time.monotonic() + timeout_ms / 1e3
                    with srv.cond:
                        while key not in srv.data:
                            remaining = None if deadline is None else deadline - time.monotonic()
                            if remaining is not None and remaining <= 0:
                                break
                            srv.cond.wait(remaining)
                        found = key in srv.data
                    self.request.sendall(b"\x01" if found else b"\x00")
                elif cmd == _CMD_DEL:
                    key = self._read_lv()
                    with srv.cond:
                        existed = srv.data.pop(key, None) is not None
                    self.request.sendall(b"\x01" if existed else b"\x00")
                elif cmd == _CMD_NUM:
                    with srv.cond:
                        n = len(srv.data)
                    self.request.sendall(struct.pack("<I", n))
                elif cmd == _CMD_CLR:
                    prefix = self._read_lv()
                    with srv.cond:
                        doomed = [k for k in srv.data if k.startswith(prefix)]
                        for k in doomed:
                            del srv.data[k]
                    self.request.sendall(struct.pack("<I", len(doomed)))
                else:
                    return
        except (ConnectionError, OSError):
            return


class _PyServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, port):
        super().__init__(("0.0.0.0", port), _PyHandler)
        self.data = {}
        self.cond = threading.Condition()


class StoreServer:
    """Hosts the store: the native C++ server unless ``prefer_native`` is
    False or it cannot be built, else the Python one. ``kind`` says which
    serves."""

    def __init__(self, port=0, prefer_native=True):
        self._handle = None
        self._py = None
        lib = _native() if prefer_native else None
        if lib is not None:
            self._handle = lib.tps_start(port)
        if self._handle:
            self.port = lib.tps_port(self._handle)
            self.native = True
            self.kind = "native"
        else:
            self._py = _PyServer(port)
            self.port = self._py.server_address[1]
            self.native = False
            self.kind = "python"
            t = threading.Thread(target=self._py.serve_forever, daemon=True)
            t.start()

    def stop(self):
        if self._handle:
            _native().tps_stop(self._handle)
            self._handle = None
        if self._py:
            self._py.shutdown()
            self._py.server_close()
            self._py = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


# ------------------------------------------------------------------ client
class TCPStore:
    """Reference: python/paddle/distributed ``core.TCPStore``.

    ``TCPStore(host, port, world_size, is_master)``: the master also starts
    the server (native if possible). All methods are blocking calls.
    """

    def __init__(self, host="127.0.0.1", port=0, world_size=1, is_master=False,
                 timeout=120.0, prefer_native=True):
        self.server = None
        if is_master:
            self.server = StoreServer(port, prefer_native=prefer_native)
            port = self.server.port
        self.host, self.port, self.world_size = host, port, world_size
        self._sock = None
        self._lock = threading.Lock()
        self._timeout = timeout
        self._connect(timeout)

    @property
    def server_kind(self):
        """"native" or "python" for the master's own server; None for a
        client (the launcher publishes its server's kind as
        ``job/server``)."""
        return self.server.kind if self.server is not None else None

    def _connect(self, timeout):
        deadline = time.monotonic() + timeout
        last = None
        while time.monotonic() < deadline:
            try:
                s = socket.create_connection((self.host, self.port), timeout=5)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(None)
                self._sock = s
                return
            except OSError as e:
                last = e
                time.sleep(0.1)
        raise TimeoutError(f"could not reach store at {self.host}:{self.port}: {last}")

    def _read(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("store server closed connection")
            buf += chunk
        return buf

    @staticmethod
    def _lv(b):
        return struct.pack("<I", len(b)) + b

    @staticmethod
    def _enc(v):
        if isinstance(v, bytes):
            return v
        if isinstance(v, str):
            return v.encode()
        return bytes(v)

    def set(self, key, value):
        k, v = self._enc(key), self._enc(value)
        with self._lock:
            self._sock.sendall(bytes([_CMD_SET]) + self._lv(k) + self._lv(v))
            assert self._read(1) == b"\x01"

    def _get_once(self, key):
        k = self._enc(key)
        with self._lock:
            self._sock.sendall(bytes([_CMD_GET]) + self._lv(k))
            if self._read(1) == b"\x00":
                return None
            (n,) = struct.unpack("<I", self._read(4))
            return self._read(n) if n else b""

    def get(self, key, wait=True, timeout=None):
        """Blocking get (paddle semantics: get waits for the key). WAIT and GET
        are separate RPCs, so a concurrent delete can sneak between them — loop
        until the value is actually in hand or the deadline passes."""
        if not wait:
            return self._get_once(key)
        t = timeout if timeout is not None else self._timeout
        deadline = time.monotonic() + t
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not self.wait_key(key, remaining):
                raise TimeoutError(f"store key {key!r} never appeared")
            val = self._get_once(key)
            if val is not None:
                return val

    def add(self, key, delta=1):
        k = self._enc(key)
        with self._lock:
            self._sock.sendall(bytes([_CMD_ADD]) + self._lv(k) + struct.pack("<q", delta))
            return struct.unpack("<q", self._read(8))[0]

    def wait_key(self, key, timeout=0.0):
        """Block until key exists. timeout<=0 waits forever. Returns found."""
        k = self._enc(key)
        ms = max(0, int(timeout * 1000))
        with self._lock:
            self._sock.sendall(bytes([_CMD_WAIT]) + self._lv(k) + struct.pack("<I", ms))
            return self._read(1) == b"\x01"

    def wait(self, keys, timeout=None):
        t = timeout if timeout is not None else self._timeout
        for key in keys if isinstance(keys, (list, tuple)) else [keys]:
            if not self.wait_key(key, t):
                raise TimeoutError(f"store key {key!r} never appeared")

    def delete_key(self, key):
        k = self._enc(key)
        with self._lock:
            self._sock.sendall(bytes([_CMD_DEL]) + self._lv(k))
            return self._read(1) == b"\x01"

    def num_keys(self):
        with self._lock:
            self._sock.sendall(bytes([_CMD_NUM]))
            return struct.unpack("<I", self._read(4))[0]

    def clear(self, prefix=""):
        """Delete every key starting with `prefix` ("" = all). Returns count."""
        p = self._enc(prefix)
        with self._lock:
            self._sock.sendall(bytes([_CMD_CLR]) + self._lv(p))
            return struct.unpack("<I", self._read(4))[0]

    def barrier(self, name, world_size=None, timeout=None):
        """All `world_size` participants block until everyone arrives."""
        n = world_size or self.world_size
        t = timeout if timeout is not None else self._timeout
        arrived = self.add(f"__barrier/{name}/count", 1)
        if arrived >= n:
            self.set(f"__barrier/{name}/done", b"1")
        if not self.wait_key(f"__barrier/{name}/done", t):
            raise TimeoutError(f"barrier {name!r}: {arrived}/{n} after {t}s")

    def close(self):
        if self._sock:
            self._sock.close()
            self._sock = None
        if self.server:
            self.server.stop()
            self.server = None
