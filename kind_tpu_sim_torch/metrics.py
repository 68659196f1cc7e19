"""Fault and recovery event log for the serving engines.

The port's own copy of the JAX package's ``RecoveryLog`` and
``recovery_log()`` (``kind_tpu_sim/metrics.py``). The serving engines
record ``request_shed`` (``max_queue`` shedding), ``slot_failure`` and
``slot_requeue`` (``inject_slot_failure``) here, so a chaos run reports
recovery as counted events.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List


class RecoveryLog:
    """Thread-safe counter and bounded trail of fault/recovery events.
    Events keep only a bounded recent window; counts are exact."""

    def __init__(self, window: int = 256):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = collections.Counter()
        self._events = collections.deque(maxlen=window)

    def record(self, event: str, **info) -> None:
        with self._lock:
            self._counts[event] += 1
            self._events.append({"event": event, **info})

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def snapshot_since(self, before: Dict[str, int]) -> Dict[str, int]:
        """Counts delta against an earlier ``counts()`` snapshot: how a
        run attributes exactly its own events when the process-global
        log is shared."""
        now = self.counts()
        return {k: now[k] - before.get(k, 0) for k in now
                if now[k] - before.get(k, 0)}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._events.clear()

    def as_dict(self) -> Dict[str, object]:
        return {"counts": self.counts(), "events": self.events()}


_RECOVERY_LOG = RecoveryLog()


def recovery_log() -> RecoveryLog:
    """The process-global fault/recovery event log (the engines record
    into it; callers snapshot and take deltas)."""
    return _RECOVERY_LOG
