"""Fault and recovery event log, and the fleet's counter boards.

The port's own copies of the JAX package's ``RecoveryLog`` /
``recovery_log()`` and ``CounterBoard`` with the boards the engine
fleet counts on: ``fleet_board()``, ``health_board()``,
``tenant_board()``, ``integrity_board()``, ``sched_board()``,
``train_board()``, ``disagg_board()``, ``zoo_board()`` and
``globe_board()`` (``kind_tpu_sim/metrics.py``). The serving engines record
``request_shed`` (``max_queue`` shedding), ``slot_failure`` and
``slot_requeue`` (``inject_slot_failure``) in the log, the training loop
``preemption_checkpoint``, and the fleet its preemptions, restores and
sheds, so a chaos run reports recovery as counted events. The fleet's
router, loop and autoscaler count requests routed, shed, requeued and
expired and scale events on the fleet board, the failure detector its
suspicions, quarantines, probes and restores on the health board, the
tenancy layer its quota sheds on the tenant board, and the audit lane
its audits, copies and mismatches on the integrity board, the cluster
scheduler its bindings, preemptions, evictions and node and link events
on the scheduler board, and the training tenant its gangs, preemptions,
migrations and resizes on the training board, the disaggregated pools
their prefills, KV handoffs and pool events on the disagg board, and the
globe its front door's, chaos's and planner's events on the globe board;
a fleet or globe report carries the counts of its own run
(``snapshot_since``). The cold worker grids (``utils/worker_pool.py``)
record their injected faults (``fault_injected``), requeues
(``cell_requeued``), respawns (``cell_worker_respawn``,
``grid_worker_respawn``) and speculative copies (``cell_speculated``) in
the log and count ``speculative_redispatch`` on the health board; the
sharded globe (``globe/shard.py``) records each shard worker it starts
again and replays from its journal (``globe_shard_respawn``, with the
shard and the journal's length).
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


class CounterBoard:
    """Thread-safe named monotonic counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = collections.Counter()

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counts[name] += by

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def snapshot_since(self, before: Dict[str, int]) -> Dict[str, int]:
        """Counter delta against an earlier ``counts()``: how one fleet
        run attributes its own traffic on the shared board."""
        now = self.counts()
        return {k: now[k] - before.get(k, 0) for k in now
                if now[k] - before.get(k, 0)}


_FLEET_BOARD = CounterBoard()


def fleet_board() -> CounterBoard:
    """The process-global fleet counter board (the router, the fleet
    loop and the autoscaler count into it)."""
    return _FLEET_BOARD


_HEALTH_BOARD = CounterBoard()


def health_board() -> CounterBoard:
    """The process-global gray-failure board (the failure detector and
    the fleet's probes, quarantines and false positives)."""
    return _HEALTH_BOARD


_GLOBE_BOARD = CounterBoard()


def globe_board() -> CounterBoard:
    """The process-global globe board (the front door's admissions,
    spills, queueing and sheds, zone losses and restores, DCN degrades,
    cell drains, herd re-admissions, the planner's grants and
    reclaims)."""
    return _GLOBE_BOARD


_TENANT_BOARD = CounterBoard()


def tenant_board() -> CounterBoard:
    """The process-global multi-tenancy board (quota sheds)."""
    return _TENANT_BOARD


_INTEGRITY_BOARD = CounterBoard()


def integrity_board() -> CounterBoard:
    """The process-global integrity board (the duplicate-compute audit
    lane's audits, copies, mismatches and quarantines)."""
    return _INTEGRITY_BOARD


_SCHED_BOARD = CounterBoard()


def sched_board() -> CounterBoard:
    """The process-global scheduler board (gangs submitted, scheduled
    and released, failed scheduling decisions, preemptions, defrag
    migrations, node drains and failures, link events)."""
    return _SCHED_BOARD


_TRAIN_BOARD = CounterBoard()


def train_board() -> CounterBoard:
    """The process-global training-tenant board (gangs submitted,
    bound and done, graceful preemptions and hard kills, migrations,
    elastic grows and shrinks, spot grants)."""
    return _TRAIN_BOARD


_DISAGG_BOARD = CounterBoard()


def disagg_board() -> CounterBoard:
    """The process-global disaggregated-serving board (prefills done, KV
    handoffs delivered and routed, queued handoffs expired, pool losses,
    link degrades, pool scale events)."""
    return _DISAGG_BOARD


_ZOO_BOARD = CounterBoard()


def zoo_board() -> CounterBoard:
    """The process-global model-zoo board (model swaps)."""
    return _ZOO_BOARD
