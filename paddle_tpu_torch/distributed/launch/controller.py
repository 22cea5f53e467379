"""The collective controller: build the pod, start the workers, watch,
restart — the counterpart of ``paddle_tpu/distributed/launch/controller.py``
(reference launch/controllers/collective.py ``build_pod``, controller.py's
watch loop and signals, fleet/elastic/manager.py:125's restart policy).

The store carries the job's metadata (``job/nnodes``, ``job/world_size``,
``job/server``: the kind of server that serves), the workers' heartbeats
(``hb/<rank>``, with the collective in flight) and the multi-node restart
and abort flags; the process group rendezvous on their own port. An exit
with ``ELASTIC_EXIT_CODE`` (101) or ``ELASTIC_AUTO_PARALLEL_EXIT_CODE``
(102) restarts the pod without spending the crash budget
(``--max_restarts``); any other code outranks them (``_pick_exit_code``).
A worker whose heartbeat is older than ``--heartbeat_timeout`` is hung:
the pod is torn down with exit code 124.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

from ..fleet.elastic.manager import (
    ELASTIC_AUTO_PARALLEL_EXIT_CODE, ELASTIC_EXIT_CODE,
)
from ..store import TCPStore
from .context import Context


def _pick_exit_code(codes):
    """A real crash concurrent with a preemption must be billed as a crash:
    any non-elastic code outranks the elastic (free-restart) codes."""
    non_elastic = [c for c in codes
                   if c not in (ELASTIC_EXIT_CODE,
                                ELASTIC_AUTO_PARALLEL_EXIT_CODE)]
    return non_elastic[0] if non_elastic else codes[0]


__all__ = ["CollectiveController", "WorkerProc"]


class WorkerProc:
    def __init__(self, local_rank, rank, proc, log_path):
        self.local_rank = local_rank
        self.rank = rank
        self.proc = proc
        self.log_path = log_path


class CollectiveController:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.store = None
        self.procs: list[WorkerProc] = []
        self._restarts = 0   # crash-restart budget consumed
        self._attempts = 0   # total relaunches (rendezvous numbering)
        self._interrupted = False
        self._remote_restart = False

    # ------------------------------------------------------------- pod lifecycle
    def build_pod(self):
        ctx = self.ctx
        os.makedirs(ctx.log_dir, exist_ok=True)
        if self.store is None:
            self.store = TCPStore(
                host=ctx.master_host,
                port=ctx.master_port,
                world_size=ctx.world_size,
                is_master=ctx.spawn_store,
            )
            if ctx.spawn_store:
                self._job_keys()
        script = ctx.args.training_script
        script_args = list(ctx.args.training_script_args)
        if script_args and script_args[0] == "--":
            script_args = script_args[1:]
        if getattr(ctx.args, "module", False):
            cmd_base = [sys.executable, "-u", "-m", script] + script_args
        elif script.endswith(".py"):
            cmd_base = [sys.executable, "-u", script] + script_args
        else:
            cmd_base = [script] + script_args
        attempt = self._attempts
        for local_rank in range(ctx.nproc_per_node):
            rank = ctx.rank_of(local_rank)
            log_path = os.path.join(ctx.log_dir, f"workerlog.{local_rank}")
            logf = open(log_path, "ab")
            logf.write(f"---- attempt {attempt} rank {rank} ----\n".encode())
            env = ctx.worker_env(local_rank)
            env["PADDLE_RESTART_ATTEMPT"] = str(attempt)
            proc = subprocess.Popen(
                cmd_base, env=env, stdout=logf, stderr=subprocess.STDOUT,
                start_new_session=True,
            )
            logf.close()
            self.procs.append(WorkerProc(local_rank, rank, proc, log_path))

    def stop_pod(self, sig=signal.SIGTERM, grace=None):
        if grace is None:
            # must outlive a worker's preemption autocheckpoint (SIGTERM ->
            # save -> exit); SIGKILL before the save completes loses the step
            grace = getattr(self.ctx.args, "stop_grace", 30.0)
        for w in self.procs:
            if w.proc.poll() is None:
                try:
                    os.killpg(w.proc.pid, sig)
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + grace
        for w in self.procs:
            timeout = max(0.1, deadline - time.monotonic())
            try:
                w.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(w.proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                w.proc.wait()
        self.procs = []

    # ------------------------------------------------------------- watch loop
    def _hung_workers(self):
        """Heartbeat staleness check (reference comm_task_manager.cc:66 watchdog
        role, moved to the controller: workers publish hb/<rank> timestamps)."""
        timeout = self.ctx.args.heartbeat_timeout
        if not timeout or self.store is None:
            return []
        now = time.time()
        hung = []
        for w in self.procs:
            raw = self.store.get(f"hb/{w.rank}", wait=False)
            if raw is None:
                continue  # worker hasn't started heartbeating yet
            text = raw.decode()
            ts_part, _, task_part = text.partition("|")
            try:
                ts = float(ts_part)
            except ValueError:
                continue
            if now - ts > timeout:
                hung.append((w, task_part or None))
        return hung

    def watch(self, poll_interval=0.5):
        """Block until the pod exits. Returns the pod's exit code. On a worker
        failure: tear down, and restart the pod if restart budget remains.

        Multi-node: restarts must be JOB-wide, not per-node. The failing node
        publishes ``__launch/restart_req/<n>``; every controller's poll loop sees
        it, tears down its local pod, and joins the restart rendezvous
        (ready/<n>/<node> keys → node 0 wipes the store → go/<n>). A node that
        gives up publishes ``__launch/abort`` so the others exit too."""
        while True:
            self.build_pod()
            remote = self._remote_restart = False
            code = self._watch_once(poll_interval)
            remote = self._remote_restart
            if code == 0:
                return 0
            # ELASTIC_EXIT_CODE = preemption/scale event: restart for free
            # (reference manager.py:33 — an elastic event is not a crash)
            elastic = code in (ELASTIC_EXIT_CODE,
                               ELASTIC_AUTO_PARALLEL_EXIT_CODE)
            if self._interrupted or (not remote and not elastic and
                                     self._restarts >= self.ctx.args.max_restarts):
                if self.ctx.nnodes > 1 and self.store is not None:
                    self.store.set("__launch/abort", str(code))
                return code
            if not elastic:
                self._restarts += 1
            self._attempts += 1
            n = self._attempts
            print(f"[launch] pod {'preempted' if elastic else 'failed'} "
                  f"(exit {code}); restart (crash budget "
                  f"{self._restarts}/{self.ctx.args.max_restarts})", flush=True)
            if self.store is not None:
                if self.ctx.nnodes > 1:
                    if not remote:
                        self.store.set(f"__launch/restart_req/{n}", str(code))
                    self.store.set(f"__launch/ready/{n}/{self.ctx.node_rank}", b"1")
                    if self.ctx.node_rank == 0:
                        for r in range(self.ctx.nnodes):
                            self.store.wait([f"__launch/ready/{n}/{r}"])
                        self._reset_store()
                        self.store.set(f"__launch/go/{n}", b"1")
                    else:
                        self.store.wait([f"__launch/go/{n}"])
                else:
                    self._reset_store()

    def _reset_store(self):
        """Wipe ALL rendezvous state (heartbeats, barrier counters, app keys)
        so the next attempt starts fresh, then restore job metadata."""
        self.store.clear()
        self._job_keys()
        self.store.set("job/restart_attempt", str(self._attempts))

    def _job_keys(self):
        self.store.set("job/nnodes", str(self.ctx.nnodes))
        self.store.set("job/world_size", str(self.ctx.world_size))
        if self.store.server_kind is not None:
            self.store.set("job/server", self.store.server_kind)

    def _check_remote_signals(self):
        """Another node may have requested a job-wide restart or abort."""
        if self.ctx.nnodes <= 1 or self.store is None:
            return None
        raw = self.store.get("__launch/abort", wait=False)
        if raw is not None:
            self._interrupted = True  # terminal: do not restart
            try:
                return int(raw.decode()) or 1
            except ValueError:
                return 1
        raw = self.store.get(f"__launch/restart_req/{self._attempts + 1}", wait=False)
        if raw is not None:
            self._remote_restart = True
            try:
                return int(raw.decode()) or 1
            except ValueError:
                return 1
        return None

    def _watch_once(self, poll_interval):
        try:
            while True:
                remote_code = self._check_remote_signals()
                if remote_code is not None:
                    print(f"[launch] remote node signalled "
                          f"{'abort' if self._interrupted else 'restart'}", flush=True)
                    self.stop_pod()
                    return remote_code
                statuses = [w.proc.poll() for w in self.procs]
                if all(s is not None for s in statuses):
                    bad = [s for s in statuses if s != 0]
                    self.procs = []
                    return _pick_exit_code(bad) if bad else 0
                failed = [w for w in self.procs if w.proc.poll() not in (None, 0)]
                hung = self._hung_workers()
                if failed or hung:
                    for w in failed:
                        print(f"[launch] rank {w.rank} exited "
                              f"{w.proc.poll()}; see {w.log_path}", flush=True)
                    for w, task in hung:
                        where = (f" inside collective {task}" if task
                                 else "")
                        print(f"[launch] rank {w.rank} heartbeat stale "
                              f"(> {self.ctx.args.heartbeat_timeout}s)"
                              f"{where}; killing pod", flush=True)
                    code = (_pick_exit_code([w.proc.poll() for w in failed])
                            if failed else 124)
                    self.stop_pod()
                    return code
                time.sleep(poll_interval)
        except KeyboardInterrupt:
            # terminal: watch() must not treat the user's Ctrl-C as a worker
            # failure and burn a restart relaunching the pod
            self._interrupted = True
            self.stop_pod(signal.SIGINT)
            return 130

    def finalize(self):
        if self.store is not None:
            self.store.close()
            self.store = None
