"""The deterministic event heap and the fleet's choice of loop.

The port's copy of ``kind_tpu_sim/fleet/events.py``:

* :class:`EventHeap`: a min-heap of ``(time, lane, seq, payload)``.
  ``lane`` is a fixed order over event kinds and ``seq`` a per-lane
  counter, so a pop is a pure function of the push sequence and
  payloads are never compared.
* :class:`DueSet`: the answer to "when must the loop step next?"
  (``immediate``, the earliest boundary-condition time ``ge``, or the
  earliest mid-tick slot event ``cover`` of an analytic replica).
* :func:`resolve_event_core`: the ``KIND_TPU_SIM_FLEET_EVENT_CORE``
  switch (default on). The event core steps only the tick boundaries
  where something can happen and takes the same tick-sized float
  additions across the others, so its reports equal the per-tick
  loop's byte for byte.
"""

from __future__ import annotations

import heapq
from typing import List, Optional

from kind_tpu_sim_torch.fleet import knobs

EVENT_CORE_ENV = knobs.FLEET_EVENT_CORE

# The fixed total order over event kinds at one instant. Lower lane
# wins the tie at equal time; within a lane, insertion order (seq)
# wins. The order mirrors the step() sequence the fleet loop keeps at
# each boundary, so heap order and processing order agree.
LANE_ARRIVAL = 0
LANE_COMPLETION = 1
LANE_CHAOS = 2
LANE_HEALTH_PROBE = 3
LANE_AUTOSCALER = 4
LANE_PLANNER = 5
LANE_KV_TRANSFER = 6
LANE_MODEL_SWAP = 7
# sampled duplicate-compute integrity audits (docs/SDC.md): audit
# copies of served requests re-execute on a second replica; the lane
# orders them after every first-class occurrence at the same instant
LANE_INTEGRITY_AUDIT = 8

LANES = (LANE_ARRIVAL, LANE_COMPLETION, LANE_CHAOS,
         LANE_HEALTH_PROBE, LANE_AUTOSCALER, LANE_PLANNER,
         LANE_KV_TRANSFER, LANE_MODEL_SWAP, LANE_INTEGRITY_AUDIT)


def resolve_event_core(value: Optional[bool] = None) -> bool:
    """Explicit value > env (KIND_TPU_SIM_FLEET_EVENT_CORE) > on."""
    if value is not None:
        return bool(value)
    return bool(knobs.get(EVENT_CORE_ENV))


class EventHeap:
    """Deterministic min-heap of ``(time, lane, seq, payload)``.

    The comparison NEVER reaches the payload: ``(time, lane)`` ties
    break on the per-lane monotone ``seq``, so pop order is a pure
    function of the seeded push sequence — the property the whole
    byte-identical-replay contract rests on, and the property
    ``detlint``'s ``heap-order`` rule checks every raw heappush in
    the tree for.
    """

    __slots__ = ("_heap", "_seq")

    def __init__(self) -> None:
        self._heap: List[tuple] = []
        self._seq: List[int] = [0] * len(LANES)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, time_s: float, lane: int, payload: object) -> None:
        seq = self._seq[lane]
        self._seq[lane] = seq + 1
        heapq.heappush(self._heap, (time_s, lane, seq, payload))

    def peek_time(self) -> Optional[float]:
        """Time of the earliest entry (None when empty) — the O(1)
        read the loop's next-wake computation is built on."""
        return self._heap[0][0] if self._heap else None

    def pop_due(self, now: float) -> List[object]:
        """Payloads of every entry with ``time <= now``, in (time,
        lane, seq) order — the per-boundary drain the loop calls."""
        out: List[object] = []
        while self._heap and self._heap[0][0] <= now:
            out.append(heapq.heappop(self._heap)[3])
        return out


class DueSet:
    """The three-way answer to "when must the loop step next?".

    ``immediate``: some state machine needs every boundary (a non-empty
    router queue, a draining replica, scheduler activity, an engine
    replica mid-stream): step the very next tick. ``ge``: the earliest
    boundary-condition instant ``t``; the first grid boundary
    ``B >= t`` must be stepped (arrivals, chaos, timers, warm-ups,
    rebinds, training events and probe deadlines apply at ``t <=
    now``). ``cover``: the earliest mid-tick instant ``t`` (an analytic
    replica's next slot event); the boundary ``B`` with ``B + tick >= t``
    must be stepped, because a tick processes the slot events in
    ``(B, B + tick]``.
    """

    __slots__ = ("immediate", "ge", "cover")

    def __init__(self) -> None:
        self.immediate = False
        self.ge = float("inf")
        self.cover = float("inf")

    def need_now(self) -> "DueSet":
        self.immediate = True
        return self

    def at(self, t: Optional[float]) -> "DueSet":
        if t is not None and t < self.ge:
            self.ge = t
        return self

    def covering(self, t: Optional[float]) -> "DueSet":
        if t is not None and t < self.cover:
            self.cover = t
        return self
