"""Fault-tolerance utilities: straggler detection, heartbeat registry,
preemption handling, elastic re-meshing.

Counterpart of ``repro/runtime/fault_tolerance.py``, a copy of it (numpy
only; the port imports nothing of the JAX package).  One change:
``PreemptionHandler(install=True)`` installs its SIGTERM handler only when
it is built on the main thread (Python refuses a signal handler from any
other), and ``restore()`` puts the previous handler back.

On a real multi-host deployment these hooks bind to the cluster scheduler;
here every mechanism is fully implemented and unit-tested against simulated
hosts so the control logic (the hard part) is real.
"""
from __future__ import annotations

import collections
import dataclasses
import signal
import threading
import time
from typing import Callable, Dict, List

import numpy as np


# ---------------------------------------------------------------------------
# Straggler mitigation
# ---------------------------------------------------------------------------

class StragglerMonitor:
    """Tracks per-step wall times; flags hosts whose rolling median exceeds
    the fleet median by ``threshold``×.  At scale this feeds the scheduler's
    hot-swap decision; the detector itself is the deliverable."""

    def __init__(self, window: int = 20, threshold: float = 1.5):
        self.window = window
        self.threshold = threshold
        self.times: Dict[int, collections.deque] = {}

    def record(self, step: int, dt: float, host: int = 0):
        """Record one step duration ``dt`` for ``host``."""
        self.times.setdefault(host, collections.deque(
            maxlen=self.window)).append(dt)

    def medians(self) -> Dict[int, float]:
        """Rolling median step time per host."""
        return {h: float(np.median(list(v)))
                for h, v in self.times.items() if v}

    def stragglers(self) -> List[int]:
        """Hosts whose median exceeds the fleet median by ``threshold``×."""
        meds = self.medians()
        if len(meds) < 2:
            return []
        fleet = float(np.median(list(meds.values())))
        return [h for h, m in meds.items() if m > self.threshold * fleet]


# ---------------------------------------------------------------------------
# Heartbeats / failure detection
# ---------------------------------------------------------------------------

class HeartbeatRegistry:
    """Host-liveness registry: hosts ping; anyone silent for ``timeout``
    seconds is declared failed and the run controller triggers
    checkpoint-restore on the surviving mesh."""

    def __init__(self, timeout: float = 30.0, clock: Callable = time.time):
        self.timeout = timeout
        self.clock = clock
        self.last_seen: Dict[int, float] = {}
        self.lock = threading.Lock()

    def ping(self, host: int):
        """Mark ``host`` alive now."""
        with self.lock:
            self.last_seen[host] = self.clock()

    def failed_hosts(self) -> List[int]:
        """Hosts silent longer than ``timeout`` seconds."""
        now = self.clock()
        with self.lock:
            return [h for h, t in self.last_seen.items()
                    if now - t > self.timeout]

    def healthy_hosts(self) -> List[int]:
        """Hosts seen within the last ``timeout`` seconds."""
        now = self.clock()
        with self.lock:
            return [h for h, t in self.last_seen.items()
                    if now - t <= self.timeout]


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------

class PreemptionHandler:
    """SIGTERM-driven graceful shutdown flag (callable for train_loop)."""

    def __init__(self, install: bool = False):
        self._flag = threading.Event()
        self._previous = None
        if install and threading.current_thread() is threading.main_thread():
            self._previous = signal.signal(signal.SIGTERM, self._on_signal)

    def restore(self):
        """Put back the SIGTERM handler that ``install`` replaced."""
        if self._previous is not None:
            signal.signal(signal.SIGTERM, self._previous)
            self._previous = None

    def _on_signal(self, signum, frame):
        self._flag.set()

    def preempt(self):
        """Set the shutdown flag programmatically (as SIGTERM would)."""
        self._flag.set()

    def __call__(self) -> bool:
        return self._flag.is_set()


# ---------------------------------------------------------------------------
# Elastic re-meshing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ElasticPlan:
    """Given a failed host set, compute the survivor mesh shape.

    Policy: drop whole ``data``-axis rows (each row = one host group) so the
    model axis stays intact; global batch shrinks proportionally and the
    data pipeline re-shards deterministically (stream is a pure function of
    host_id/num_hosts)."""
    old_data: int
    old_model: int

    def survivor_mesh(self, failed_fraction: float):
        """New ``(data, model)`` mesh shape after dropping failed rows."""
        lost_rows = int(np.ceil(self.old_data * failed_fraction))
        new_data = max(1, self.old_data - lost_rows)
        # keep power-of-two friendliness for collectives
        while new_data > 1 and (self.old_data % new_data):
            new_data -= 1
        return (new_data, self.old_model)

    def batch_scale(self, failed_fraction: float) -> float:
        """Fraction of the global batch the survivor mesh sustains."""
        nd, _ = self.survivor_mesh(failed_fraction)
        return nd / self.old_data
