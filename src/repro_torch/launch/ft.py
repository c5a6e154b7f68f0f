"""Fault-tolerance runtime pieces for the train and serve CLIs, as the
reference's.

* PreemptionHandler: SIGTERM/SIGINT -> a final checkpoint at the next
  step boundary (the preemptible-VM protocol).
* Heartbeat: a liveness file per host; a stale one marks a host as
  presumed dead.
* restore_or_init: the one entry point that makes restarts idempotent.

A replacement host resumes losslessly from step N because the data is
a function of the step (``data/pipeline.py``) and checkpoints store
whole (logical) arrays (``checkpoint/manager.py``).
"""
from __future__ import annotations

import os
import signal
import time

from repro_torch.checkpoint.manager import CheckpointManager


class PreemptionHandler:
    def __init__(self):
        self.requested = False
        self._orig = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                pass  # not the main thread

    def _on_signal(self, signum, frame):
        self.requested = True

    def restore(self):
        for sig, h in self._orig.items():
            signal.signal(sig, h)


class Heartbeat:
    """Liveness file per host; a stale mtime means a presumed-dead
    host."""

    def __init__(self, directory: str, host_id: int,
                 interval_s: float = 10.0):
        self.path = os.path.join(directory, f"host_{host_id}.hb")
        os.makedirs(directory, exist_ok=True)
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self) -> None:
        now = time.time()
        if now - self._last >= self.interval_s:
            with open(self.path, "w") as f:
                f.write(str(now))
            self._last = now

    @staticmethod
    def stale_hosts(directory: str, timeout_s: float = 60.0) -> list:
        out = []
        now = time.time()
        for fn in os.listdir(directory):
            if fn.endswith(".hb"):
                if now - os.path.getmtime(os.path.join(directory, fn)) \
                        > timeout_s:
                    out.append(fn)
        return out


def restore_or_init(mgr: CheckpointManager, init_fn, target_struct=None):
    """Resume from the latest complete checkpoint, else initialize fresh.

    Returns (state, start_step).  Idempotent: a host that crashes and
    re-enters gets exactly the same state (checkpoints are atomic, the
    data is seekable by step)."""
    step = mgr.latest_step()
    if step is None:
        return init_fn(), 0
    target = target_struct if target_struct is not None else init_fn()
    return mgr.restore(target, step=step), step
