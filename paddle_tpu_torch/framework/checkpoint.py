"""Preemption-tolerant training checkpoints — the counterpart of
``paddle_tpu/framework/checkpoint.py``.

``CheckpointManager`` owns the on-disk lifecycle of a state provider's
training state: anything with ``export_state()`` / ``import_state()``, as
``jit.TrainStep`` has (parameters, optimizer accumulators, step counter,
RNG states, scheduler state). Three properties, as in JAX:

1. **Asynchrony.** ``save()`` splits into three phases. *snapshot* runs
   on the caller's thread right after a step: the provider's copies are
   moved to the host, all at once (a non-blocking copy of each CUDA tensor
   into pinned memory, then one wait), so the result is numpy that no
   later step can touch; captured replays go on writing the live tensors
   while the writer runs. *serialize* (npz write + fsync) and *commit*
   (manifest + atomic rename + retention) run on a background writer
   thread. Only the snapshot lands on the training loop.
2. **Crash-atomicity.** Each checkpoint is a step-numbered directory,
   assembled under a ``.tmp`` name and renamed into place only after
   every data file is fsynced and the manifest, written last through its
   own tmp + rename, records each file's size and crc32. ``restore()``
   walks manifests newest first, verifies them, and falls back to the
   previous intact checkpoint with a ``CheckpointCorruptWarning``.
3. **Layout.** Each process writes its chunks into ``data_r{rank}.npz``
   and a sidecar; the coordinator (rank 0) collates the sidecars into the
   manifest. The port runs one process per card and saves each tensor
   whole (one chunk); the reader stitches any chunk layout of a manifest.

bfloat16 tensors are stored as their uint16 bits with ``"bfloat16"`` in the
manifest (JAX's ``storable_view``) and read back as torch bfloat16 tensors.
``PreemptionFlush`` turns SIGTERM into a flag the fit loop polls; after
its synchronous flush the loop raises ``PreemptionExit`` with
``ELASTIC_EXIT_CODE`` (101), the code an elastic launcher restarts on.
``monitor`` and ``injector`` are duck-typed as in JAX
(``checkpoint_phase`` / ``checkpoint_result``; ``check(site)`` /
``monotonic()``); the port has no ``StepMonitor`` or fault injector of its
own.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
import warnings
import zlib

import numpy as np
import torch

from .io_utils import fsync_dir, fsync_file

__all__ = ["CheckpointManager", "CheckpointCorruptWarning", "latest_step",
           "PreemptionFlush", "PreemptionExit", "ELASTIC_EXIT_CODE"]

# the elastic launcher's "restart me, this is not a crash" code (JAX
# distributed/fleet/elastic/manager.py, not ported)
ELASTIC_EXIT_CODE = 101

_MANIFEST = "manifest.json"
_STEP_PREFIX = "step_"
_TMP_SUFFIX = ".tmp"


class CheckpointCorruptWarning(UserWarning):
    """A checkpoint directory failed validation (torn manifest, missing,
    truncated or corrupt shard); restore fell back to an older one."""


class PreemptionExit(SystemExit):
    """Raised by the fit loop after a SIGTERM-triggered final flush; its
    code is ``ELASTIC_EXIT_CODE``."""


class PreemptionFlush:
    """SIGTERM -> ``preempted``; the fit loop polls it at batch boundaries,
    flushes synchronously and raises ``PreemptionExit``. The handler only
    sets the flag (the signal can land mid-step). ``install()`` outside the
    main thread installs nothing (poll-only); ``restore()`` puts the
    previous handler back."""

    def __init__(self):
        self.preempted = False
        self.installed = False
        self._prev = None

    def install(self) -> "PreemptionFlush":
        import signal

        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_sigterm)
            self.installed = True
        except ValueError:      # not the main thread: poll-only mode
            self.installed = False
        return self

    def _on_sigterm(self, signum, frame):
        self.preempted = True

    def restore(self):
        if not self.installed:
            return
        import signal

        signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
        self.installed = False

    @staticmethod
    def exit_code() -> int:
        return ELASTIC_EXIT_CODE


def _step_dirname(step):
    return f"{_STEP_PREFIX}{int(step):010d}"


def _parse_step(name):
    if not name.startswith(_STEP_PREFIX) or name.endswith(_TMP_SUFFIX):
        return None
    try:
        return int(name[len(_STEP_PREFIX):])
    except ValueError:
        return None


def _committed_steps(directory):
    """Step numbers whose directory holds a manifest, ascending."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(s for s in map(_parse_step, names) if s is not None
                  and os.path.exists(os.path.join(
                      directory, _step_dirname(s), _MANIFEST)))


def latest_step(directory):
    """Highest step number with a manifest present (validation happens in
    ``restore``); None when there is none."""
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def _flatten(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix=f"{name}."))
        else:
            flat[name] = v
    return flat


def _crc_file(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def _dtype_name(t):
    """A tensor's dtype as the manifest names it (numpy's names; bfloat16
    as ml_dtypes names it)."""
    return str(t.dtype).removeprefix("torch.")


def _storable(t):
    """A host tensor as the numpy array np.savez keeps (bfloat16 as its
    uint16 bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _readback(arr, dtype):
    """The reverse of ``_storable``: a CPU torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype)))


def _to_host(tensors):
    """Host copies of ``tensors`` (name -> tensor): CUDA tensors copied
    into pinned memory without blocking, all started before one wait."""
    out, cuda = {}, False
    for name, t in tensors.items():
        t = t.detach()
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            out[name], cuda = host, True
        else:
            out[name] = t
    if cuda:
        torch.cuda.synchronize()
    return out


class _CorruptCheckpoint(Exception):
    """Internal: validation failure reason (becomes the warning message)."""


class CheckpointManager:
    """Async save / restore of a state provider's training state.

    Usage (bare loop)::

        mgr = CheckpointManager(ckpt_dir, keep_last=3, keep_every=100)
        start = mgr.restore(step) or 0          # step = TrainStep(...)
        for i in range(start, total):
            loss = step(x, labels=y)
            if (i + 1) % save_every == 0:
                mgr.save(step, i + 1)           # snapshot now, write async
        mgr.save(step, total)
        mgr.close()                             # drain pending writes

    ``Model.fit(checkpoint_dir=...)`` wires this up. The provider's
    ``export_state()`` returns ``{"params": {...}, "acc": {...},
    ["master": {...}], "meta": {...}}`` with tensor or array leaves and a
    JSON-able ``meta``; ``import_state(state)`` takes the same shape back
    with CPU tensors as leaves.

    * ``keep_last``: newest N checkpoints kept (0 / None keeps all).
    * ``keep_every``: also keep every step that is a multiple of M.
    * ``async_save``: False serializes and commits on the caller's thread.
    * ``monitor``, ``injector``: see the module docstring.
    """

    def __init__(self, directory, *, keep_last=3, keep_every=0,
                 async_save=True, rank=0, world_size=1, monitor=None,
                 injector=None):
        self.directory = str(directory)
        self.keep_last = None if not keep_last else int(keep_last)
        self.keep_every = int(keep_every or 0)
        self.async_save = bool(async_save)
        self.rank = int(rank)
        self.world_size = max(1, int(world_size))
        self.monitor = monitor
        self.injector = injector
        self.last_timings: dict = {}   # phase -> seconds, last finished save
        self.last_bytes = None         # bytes of the last data file written
        self.saves = 0                 # snapshots taken
        self.commits = 0               # manifests landed (this process)
        self.last_restored = None      # {"step", "dir", "meta"} after restore
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._writer = None
        self._writer_err = None
        # one lock guards the writer's lifecycle and the scalars both
        # threads write (saves, commits, last_timings, _writer_err)
        self._lock = threading.Lock()
        os.makedirs(self.directory, exist_ok=True)

    # ----------------------------------------------------------------- clock
    def _now(self):
        inj = self.injector
        return inj.monotonic() if inj is not None else time.monotonic()

    def _check(self, site):
        inj = self.injector
        if inj is not None:
            inj.check(site)

    def _phase(self, phase, seconds):
        with self._lock:
            self.last_timings[phase] = seconds
        mon = self.monitor
        if mon is not None:
            mon.checkpoint_phase(phase, seconds)

    # ------------------------------------------------------------------ save
    def save(self, provider, step, blocking=None):
        """Snapshot ``provider``'s state at optimizer step ``step`` and hand
        it to the writer. Returns the checkpoint's directory (which exists
        once the commit lands: ``wait()`` joins)."""
        self._raise_writer_error()
        t0 = self._now()
        self._check("ckpt.snapshot")
        snap = provider.export_state()
        chunks, entries = self._snapshot(snap)
        meta = dict(snap.get("meta") or {})
        self._phase("snapshot", self._now() - t0)
        with self._lock:
            self.saves += 1
        job = {"step": int(step), "chunks": chunks, "entries": entries,
               "meta": meta}
        if blocking is None:
            blocking = not self.async_save
        if blocking:
            # the writes in flight land first: this commit's retention
            # sweep would otherwise take their .tmp directories from under
            # them (a SIGTERM flush right after a periodic save)
            self.wait()
            self._write(job)
        else:
            self._ensure_writer()
            self._q.put(job)   # maxsize=1: a third save waits for the
            # write in flight (at most two snapshots held on the host)
        return os.path.join(self.directory, _step_dirname(step))

    def _snapshot(self, snap):
        """Every tensor or array leaf on the host as a chunk, with its
        manifest entry; scalars go into the manifest."""
        flat = {k: v for k, v in _flatten(snap).items()
                if not k.startswith("meta.")}
        host = _to_host({k: v for k, v in flat.items()
                         if isinstance(v, torch.Tensor)})
        chunks, entries = {}, {}
        for name, v in flat.items():
            if v is None or isinstance(v, (int, float, str, bool)):
                entries[name] = {"kind": "scalar", "value": v}
                continue
            if name in host:
                t = host[name]
                dtype, arr = _dtype_name(t), _storable(t)
            else:
                arr = np.asarray(v)
                dtype = str(arr.dtype)
            entries[name] = {"kind": "tensor", "shape": list(arr.shape),
                             "dtype": dtype, "chunks": []}
            if self.rank == 0:   # one device: rank 0 owns every value
                cname = f"{name}/0"
                chunks[cname] = arr
                entries[name]["chunks"].append(
                    {"offset": [0] * arr.ndim, "shape": list(arr.shape),
                     "file": self._data_name(), "key": cname})
        return chunks, entries

    def _data_name(self):
        return f"data_r{self.rank}.npz"

    # ---------------------------------------------------------- writer thread
    def _ensure_writer(self):
        with self._lock:
            if self._writer is not None and self._writer.is_alive():
                return
            self._writer = threading.Thread(
                target=self._writer_loop, name="ckpt-writer", daemon=True)
            self._writer.start()

    def _writer_loop(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                self._write(job)
            except BaseException as e:   # surfaced on next save() / wait()
                with self._lock:
                    self._writer_err = e
            finally:
                self._q.task_done()

    def _raise_writer_error(self):
        with self._lock:
            err, self._writer_err = self._writer_err, None
        if err is not None:
            mon = self.monitor
            if mon is not None:
                mon.checkpoint_result(ok=False)
            raise RuntimeError(
                f"async checkpoint write failed: {err!r}") from err

    def wait(self, timeout=None):
        """Join all pending async writes; re-raises a writer failure."""
        if self._writer is not None and self._writer.is_alive():
            self._q.join()
        self._raise_writer_error()

    def close(self):
        """Drain pending writes and stop the writer thread."""
        self.wait()
        with self._lock:
            w, self._writer = self._writer, None
        if w is not None and w.is_alive():
            self._q.put(None)
            w.join(timeout=5.0)

    # ----------------------------------------------------------------- write
    def _tmp_dir(self, step):
        return os.path.join(self.directory, _step_dirname(step) + _TMP_SUFFIX)

    def _write(self, job):
        step = job["step"]
        tmp = self._tmp_dir(step)
        final = os.path.join(self.directory, _step_dirname(step))
        t0 = self._now()
        self._check("ckpt.serialize")
        os.makedirs(tmp, exist_ok=True)
        data_path = os.path.join(tmp, self._data_name())
        if job["chunks"]:
            with open(data_path, "wb") as f:
                np.savez(f, **job["chunks"])
                fsync_file(f)
        files = {}
        if os.path.exists(data_path):
            files[self._data_name()] = {
                "bytes": os.path.getsize(data_path),
                "crc32": _crc_file(data_path)}
            self.last_bytes = files[self._data_name()]["bytes"]
        sidecar = {"rank": self.rank, "keys": job["entries"], "files": files}
        sc_path = os.path.join(tmp, f"meta_r{self.rank}.json")
        with open(sc_path + ".w", "w") as f:
            json.dump(sidecar, f)
            fsync_file(f)
        os.replace(sc_path + ".w", sc_path)
        self._phase("serialize", self._now() - t0)

        t0 = self._now()
        self._check("ckpt.commit")
        if self.rank == 0:
            self._commit(step, tmp, final, job["meta"])
            self._phase("commit", self._now() - t0)
            with self._lock:
                self.commits += 1
            mon = self.monitor
            if mon is not None:
                mon.checkpoint_result(ok=True, step=step)
            self._retain()

    def _commit(self, step, tmp, final, meta, timeout=120.0):
        """Coordinator: wait for every rank's sidecar, collate the manifest,
        fsync, and rename the directory into place. A directory without a
        manifest is torn and ignored at restore."""
        deadline = self._now() + timeout
        while True:
            sidecars = [n for n in os.listdir(tmp)
                        if n.startswith("meta_r") and n.endswith(".json")]
            if len(sidecars) >= self.world_size:
                break
            if self._now() > deadline:
                raise TimeoutError(
                    f"checkpoint step {step}: {len(sidecars)}/"
                    f"{self.world_size} rank sidecars within {timeout}s — "
                    "refusing to commit an incomplete checkpoint")
            time.sleep(0.05)
        keys, files = {}, {}
        for name in sorted(sidecars):
            with open(os.path.join(tmp, name)) as f:
                part = json.load(f)
            files.update(part.get("files", {}))
            for key, entry in part["keys"].items():
                if key not in keys:
                    keys[key] = entry
                elif entry.get("kind") == "tensor":
                    have = {tuple(c["offset"]) for c in keys[key]["chunks"]}
                    keys[key]["chunks"] += [c for c in entry["chunks"]
                                            if tuple(c["offset"]) not in have]
        manifest = {"version": 1, "step": int(step),
                    "world_size": self.world_size,
                    "wall_time": time.time(),   # informational only:
                    # discovery orders by step number, never by clock
                    "meta": meta, "keys": keys, "files": files}
        mpath = os.path.join(tmp, _MANIFEST)
        with open(mpath + ".w", "w") as f:
            json.dump(manifest, f)
            fsync_file(f)
        os.replace(mpath + ".w", mpath)
        fsync_dir(tmp)
        if os.path.isdir(final):   # a re-save of the same step replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)
        fsync_dir(self.directory)

    # ------------------------------------------------------------- retention
    def _retain(self):
        """keep-last-N + keep-every-M, and ``.tmp`` debris of steps at or
        below the newest committed one (their writers are gone)."""
        steps = sorted(s for s in map(_parse_step,
                                      os.listdir(self.directory))
                       if s is not None)
        keep = set(steps[-self.keep_last:] if self.keep_last else steps)
        if self.keep_every > 0:
            keep.update(s for s in steps if s % self.keep_every == 0)
        for s in steps:
            if s not in keep:
                shutil.rmtree(
                    os.path.join(self.directory, _step_dirname(s)),
                    ignore_errors=True)
        newest = steps[-1] if steps else None
        for name in os.listdir(self.directory):
            if not name.endswith(_TMP_SUFFIX):
                continue
            step = _parse_step(name[:-len(_TMP_SUFFIX)])
            if step is not None and newest is not None and step <= newest:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self):
        """Committed (manifest-bearing) step numbers, ascending."""
        return _committed_steps(self.directory)

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def _validate(self, d):
        """The manifest of checkpoint dir ``d`` after checking every file's
        size and crc32; raises _CorruptCheckpoint with the reason."""
        mpath = os.path.join(d, _MANIFEST)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise _CorruptCheckpoint(f"unreadable manifest: {e!r}")
        for fname, info in manifest.get("files", {}).items():
            fpath = os.path.join(d, fname)
            if not os.path.exists(fpath):
                raise _CorruptCheckpoint(f"missing shard file {fname}")
            size = os.path.getsize(fpath)
            if size != info.get("bytes"):
                raise _CorruptCheckpoint(
                    f"shard {fname}: {size} bytes, manifest says "
                    f"{info.get('bytes')} (truncated write?)")
            if _crc_file(fpath) != info.get("crc32"):
                raise _CorruptCheckpoint(f"shard {fname}: crc32 mismatch")
        return manifest

    def restore(self, provider, step=None):
        """Load the newest intact checkpoint (or exactly ``step``) into
        ``provider`` and return its step, or None when there is none.
        Corrupt or torn directories are skipped with a warning."""
        t0 = self._now()
        candidates = self.steps()
        if step is not None:
            candidates = [s for s in candidates if s == int(step)]
        for s in sorted(candidates, reverse=True):
            d = os.path.join(self.directory, _step_dirname(s))
            try:
                manifest = self._validate(d)
            except _CorruptCheckpoint as e:
                warnings.warn(
                    f"checkpoint {d} failed validation ({e}); falling back "
                    f"to the previous manifest", CheckpointCorruptWarning)
                continue
            provider.import_state(self._read_state(d, manifest, provider))
            with self._lock:
                self.last_restored = {"step": s, "dir": d,
                                      "meta": manifest.get("meta", {})}
            self._phase("restore", self._now() - t0)
            return s
        return None

    def _read_state(self, d, manifest, provider):
        """Manifest entries -> the provider's nested state shape (walked
        from its current ``export_state()``: parameter names hold dots)."""
        keys = manifest["keys"]
        template = {k: v for k, v in provider.export_state().items()
                    if k != "meta"}
        files = {}

        def read(entry):
            out = np.empty(entry["shape"], dtype=np.uint16
                           if entry["dtype"] == "bfloat16"
                           else np.dtype(entry["dtype"]))
            for c in entry["chunks"]:
                if c["file"] not in files:
                    files[c["file"]] = np.load(os.path.join(d, c["file"]))
                region = tuple(slice(o, o + n)
                               for o, n in zip(c["offset"], c["shape"]))
                out[region] = files[c["file"]][c["key"]]
            return _readback(out, entry["dtype"])

        def fill(node, prefix):
            out = {}
            for k, v in node.items():
                name = f"{prefix}{k}"
                if isinstance(v, dict):
                    out[k] = fill(v, f"{name}.")
                    continue
                entry = keys.get(name)
                if entry is None:
                    raise ValueError(
                        f"checkpoint {d} has no entry for {name!r} — "
                        "restoring into a different model/optimizer?")
                out[k] = (entry["value"] if entry["kind"] == "scalar"
                          else read(entry))
            return out

        try:
            state = fill(template, "")
        finally:
            for f in files.values():
                f.close()
        state["meta"] = dict(manifest.get("meta") or {})
        return state
