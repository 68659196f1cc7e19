"""The columnar (struct-of-arrays) mirror of an all-analytic fleet.

The port's copy of ``kind_tpu_sim/fleet/columnar.py``. With the event
core each stepped boundary still paid O(replicas) in Python: the wake
scan asked every replica for ``next_due()``, the tick fan-out called
every replica's ``tick()`` (most of them no-ops), and every routed
request sorted the whole replica list.

:class:`FleetColumns` keeps each ``router.SimReplica``'s scheduling
state in numpy arrays: the wake bounds ``next_due()`` gives
(``ge``, ``cover``), queue length, outstanding count and health,
refreshed lazily from a dirty set that the replicas keep (every method
of a replica that changes that state calls ``_touch()``). The hot paths
become array reductions:

* the wake scan is the minimum of the ``ge`` and ``cover`` columns;
* the tick fan-out visits only the replicas that can act in the window
  (queued work, slots in flight, or a covering bound inside it): an idle
  replica's tick is a no-op, and busy ones are visited every stepped
  boundary, as the per-object loop visits them, since a gray ``slow``
  changes a replica's rate mid-run;
* least-outstanding routing is one masked ``argmin`` over
  ``outstanding * K + replica_id``, the sorted path's (load, id) order.

Reports are byte-identical with the mirror on or off. ``FleetConfig
.columnar`` chooses; unset, the knob KIND_TPU_SIM_FLEET_COLUMNAR (default
on) turns it on for fleets of at least ``COLUMNAR_MIN_REPLICAS``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from kind_tpu_sim_torch.fleet import knobs

_INF = float("inf")
# the knob engages the mirror only from this many replicas on: below it
# the per-object scans cost less than the numpy calls (a cost heuristic;
# an explicit FleetConfig.columnar=True engages at any size)
COLUMNAR_MIN_REPLICAS = 32
# the routing key of a masked (unhealthy) replica: above every reachable
# outstanding * K + id, within int64
_MASKED = np.int64(1) << np.int64(62)


def resolve_columnar(value: Optional[bool] = None) -> bool:
    """``value``, else KIND_TPU_SIM_FLEET_COLUMNAR, else on."""
    if value is not None:
        return bool(value)
    return bool(knobs.get(knobs.FLEET_COLUMNAR))


class FleetColumns:
    """The mirror, indexed by position in the fleet's replica list (kept
    in id order), so the fan-out visits replicas in the per-object
    loop's order: the order completions are observed in is part of the
    report."""

    __slots__ = ("replicas", "n", "ge", "cover", "qlen", "out",
                 "healthy", "ids", "_key_base", "dirty")

    def __init__(self, replicas: Sequence):
        self.replicas: List = []
        self.rebuild(replicas)

    def rebuild(self, replicas: Sequence) -> None:
        """Mirror a new membership (a scale event)."""
        new = list(replicas)
        keep = {id(r) for r in new}
        for r in self.replicas:
            if id(r) not in keep:
                r._cols = None
        self.replicas = new
        n = len(new)
        self.n = n
        self.ge = np.full(n, _INF)
        self.cover = np.full(n, _INF)
        self.qlen = np.zeros(n, dtype=np.int64)
        self.out = np.zeros(n, dtype=np.int64)
        self.healthy = np.zeros(n, dtype=bool)
        self.ids = np.array([r.replica_id for r in new],
                            dtype=np.int64).reshape(n)
        self._key_base = (int(self.ids.max()) + 1) if n else 1
        for i, r in enumerate(new):
            r._cols = self
            r._idx = i
        self.dirty = set(range(n))

    def flush(self) -> None:
        """Refresh the dirty rows from their replicas."""
        d = self.dirty
        if not d:
            return
        reps = self.replicas
        ge, cover = self.ge, self.cover
        qlen, out, healthy = self.qlen, self.out, self.healthy
        for i in d:
            r = reps[i]
            g, c = r.next_due()
            ge[i] = _INF if g is None else g
            cover[i] = _INF if c is None else c
            qlen[i] = len(r.queue)
            out[i] = r.outstanding()
            healthy[i] = r.healthy
        d.clear()

    def wake(self) -> tuple:
        """(ge_min, cover_min) over the fleet: the replicas' part of the
        event core's wake scan."""
        self.flush()
        if not self.n:
            return (None, None)
        g = float(self.ge.min())
        c = float(self.cover.min())
        return (None if g == _INF else g,
                None if c == _INF else c)

    def active_indices(self, end: float) -> Sequence[int]:
        """Positions, ascending, of the replicas whose ``tick()`` over a
        window ending at ``end`` is not a no-op: queued work, slots in
        flight, or a healthy replica's covering bound inside the
        window."""
        self.flush()
        if not self.n:
            return ()
        mask = ((self.qlen > 0) | (self.out > 0)
                | (self.healthy & (self.cover <= end)))
        return np.nonzero(mask)[0]

    def all_idle(self) -> bool:
        """Quiescence's replica part: no healthy replica holds work."""
        self.flush()
        if not self.n:
            return True
        return not bool((self.out[self.healthy] > 0).any())

    def healthy_outstanding(self) -> int:
        """Outstanding requests summed over healthy replicas (the
        autoscaler's backlog)."""
        self.flush()
        if not self.n:
            return 0
        return int(self.out[self.healthy].sum())

    def pick_least_outstanding(self):
        """The healthy replica of least (outstanding, replica_id), the
        sorted path's first candidate, or None when none is healthy."""
        self.flush()
        if not self.n:
            return None
        key = np.where(self.healthy,
                       self.out * self._key_base + self.ids,
                       _MASKED)
        i = int(key.argmin())
        if key[i] >= _MASKED:
            return None
        return self.replicas[i]
