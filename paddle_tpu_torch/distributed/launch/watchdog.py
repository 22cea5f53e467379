"""The worker's side of the control plane: the heartbeat and the hang
dump — the counterpart of ``paddle_tpu/distributed/launch/watchdog.py``
(reference paddle/phi/core/distributed/comm_task_manager.cc:66,137).

Each worker publishes ``hb/<rank>`` = its clock (and the collective in
flight, ``collective.current_comm_task``) to the launcher's store from a
daemon thread; the controller declares a worker hung when its heartbeat
goes stale and tears the pod down. On SIGUSR1 a worker dumps every Python
thread's stack to stderr (faulthandler).
"""
from __future__ import annotations

import faulthandler
import os
import signal
import threading
import time

__all__ = ["Heartbeat", "install_hang_dump"]


def install_hang_dump():
    """Dump all thread stacks on SIGUSR1 (safe to call multiple times)."""
    try:
        faulthandler.register(signal.SIGUSR1, all_threads=True, chain=False)
    except (AttributeError, ValueError):
        pass  # non-main thread or platform without SIGUSR1


class Heartbeat:
    """Publishes ``hb/<rank>`` = unix time to the store every ``interval``
    seconds; ``beats`` counts the ones sent."""

    def __init__(self, store, rank, interval=5.0):
        self.store = store
        self.rank = rank
        self.interval = interval
        self.beats = 0
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is not None:
            return self
        install_hang_dump()

        def run():
            misses = 0
            while not self._stop.is_set():
                try:
                    hb = str(time.time())
                    # attach the in-flight collective (comm_task_manager role):
                    # on a hang the controller names WHAT the rank died inside
                    try:
                        from ..collective import current_comm_task

                        task = current_comm_task()
                        if task is not None:
                            op, seq, age = task
                            hb += f"|{op}:{seq}:{age:.1f}s"
                    except Exception:
                        pass
                    self.store.set(f"hb/{self.rank}", hb)
                    self.beats += 1
                    misses = 0
                except Exception:
                    # a transient store hiccup must not silence the heartbeat
                    # for good (the watchdog would kill a healthy pod); only
                    # give up after repeated consecutive failures
                    misses += 1
                    if misses >= 5:
                        return
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=run, daemon=True, name="paddle-heartbeat")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
