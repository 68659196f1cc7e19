"""One cell of the globe: a sched inventory + fleet sim, embedded (the
port's copy of ``kind_tpu_sim/globe/cell.py``).

A **cell** is the unit of deployment the production papers describe
(one cluster of accelerator slices behind one regional load balancer):
here it is exactly one :class:`~kind_tpu_sim_torch.fleet.FleetSim` — router,
replicas, optional autoscaler, optionally scheduler-backed placement
on its own zone-labeled inventory (``FleetConfig.sched``) — advanced
tick-by-tick by the globe driver on ONE shared virtual clock instead
of running its own loop. The front door (frontdoor.py) is the only
traffic source: requests arrive with a modeled DCN delivery delay
and join ``pending``; everything after that is the unmodified fleet
data plane, which is the point — the globe composes the existing
layers, it does not reimplement them.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional

from kind_tpu_sim_torch.fleet.events import LANE_ARRIVAL, DueSet, EventHeap
from kind_tpu_sim_torch.fleet.loadgen import TraceRequest, VirtualClock
from kind_tpu_sim_torch.fleet.sim import FleetConfig, FleetSim


@dataclasses.dataclass(frozen=True)
class CellConfig:
    """One cell's identity + its fleet. ``name`` sorts the globe's
    deterministic iteration order; ``zone`` is the correlated
    failure domain the cell dies with under ``zone_loss``."""

    name: str
    zone: str
    fleet: FleetConfig

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "zone": self.zone,
            "fleet": self.fleet.as_dict(),
        }


class Cell:
    """A fleet sim plus the globe-facing plumbing: a delivery heap
    (requests in DCN flight), the admitted-but-unticked ``pending``
    deque the fleet pops each step, and alive/draining flags the
    front door consults."""

    def __init__(self, cfg: CellConfig, clock: VirtualClock,
                 on_complete: Optional[Callable] = None):
        self.cfg = cfg
        self.name = cfg.name
        self.zone = cfg.zone
        self.sim = FleetSim(cfg.fleet, trace=[], clock=clock)
        if on_complete is not None:
            self.sim.on_complete = on_complete
        self.pending: deque = deque()
        # requests in DCN flight, on the deterministic event heap
        # (fleet/events.py): (deliver_s, ARRIVAL lane, seq, request)
        # — seq is admission order, the tiebreak for same-tick
        # deliveries
        self.delivery = EventHeap()
        # hedge-cancelled request ids still in DCN flight: the heap
        # has no removal, so cancellation is lazy — the id is
        # dropped when its delivery pops (docs/OVERLOAD.md)
        self._cancelled: set = set()
        self.alive = True
        self.draining = False
        self.peak_outstanding = 0

    # -- capacity / load (the front door's scoring inputs) -----------

    def routable_replicas(self) -> int:
        return sum(1 for r in self.sim.router.replicas if r.healthy)

    def capacity(self) -> int:
        """Concurrent service slots across routable replicas — the
        unit the front door's admission bounds are denominated in."""
        slots = getattr(self.sim.cfg.sim, "max_slots", 1)
        return self.routable_replicas() * slots

    def outstanding(self) -> int:
        """Everything the cell owes: queued at the router, in flight
        on replicas, admitted but unticked, still in DCN flight, and
        (phase-split cells) riding the KV lane between the pools."""
        return (len(self.sim.router.queue)
                + sum(r.outstanding()
                      for r in self.sim.replicas if r.healthy)
                + len(self.pending) + len(self.delivery)
                + len(self.sim.router.kv_queue)
                + len(self.sim._kv_heap))

    def routable(self) -> bool:
        return (self.alive and not self.draining
                and self.routable_replicas() > 0)

    # -- model zoo (docs/ZOO.md) --------------------------------------

    def serves(self, model: str) -> bool:
        """Whether any healthy replica here can run ``model`` at all
        (it fits the replica's generation HBM). Vacuously true for
        unzooed traffic."""
        if not model:
            return True
        return any(
            getattr(r, "can_serve", lambda m: True)(model)
            for r in self.sim.replicas if r.healthy)

    def models_warm(self) -> set:
        """Models resident (weights loaded) on at least one healthy
        replica — the front door's warm-cell spill signal."""
        return {r.resident_model
                for r in self.sim.replicas
                if r.healthy and getattr(r, "resident_model", "")}

    # -- the globe driver's surface ----------------------------------

    def admit(self, req: TraceRequest, deliver_s: float) -> None:
        self.delivery.push(deliver_s, LANE_ARRIVAL, req)
        self.peak_outstanding = max(self.peak_outstanding,
                                    self.outstanding())

    def deliver_due(self, now: float) -> None:
        for req in self.delivery.pop_due(now):
            if self._cancelled:
                if req.request_id in self._cancelled:
                    self._cancelled.discard(req.request_id)
                    continue
            self.pending.append(req)

    def cancel(self, request_id: str) -> bool:
        """First-completion-wins cancellation across the cell (the
        globe hedging layer's lever, docs/OVERLOAD.md): withdraw the
        request wherever it is — admitted-but-unticked, queued at
        the router, or mid-stream on a replica; one still in DCN
        flight cancels lazily at delivery. Returns False when the
        request is nowhere here (already completed) so the caller
        dedupes the late completion instead."""
        for i, req in enumerate(self.pending):
            if req.request_id == request_id:
                del self.pending[i]
                return True
        queue = self.sim.router.queue
        for i, req in enumerate(queue):
            if req.request_id == request_id:
                del queue[i]
                return True
        for replica in self.sim.replicas:
            if (hasattr(replica, "cancel")
                    and replica.cancel(request_id)):
                return True
        kv_queue = self.sim.router.kv_queue
        for i, handoff in enumerate(kv_queue):
            if handoff.request.request_id == request_id:
                del kv_queue[i]
                self.sim._prefill_done_ids.discard(request_id)
                return True
        for entry in self.sim._kv_heap._heap:
            # a KV transfer on the wire cancels lazily, like a
            # request in DCN flight: the sim drops it at delivery
            if entry[3].request.request_id == request_id:
                self.sim._kv_cancelled.add(request_id)
                return True
        for entry in self.delivery._heap:
            if entry[3].request_id == request_id:
                self._cancelled.add(request_id)
                return True
        return False

    def warm_prefix(self, group: int) -> None:
        """Pre-warm one prefix-cache group on every replica (the
        cross-cell failover warm-up, docs/OVERLOAD.md)."""
        for replica in self.sim.replicas:
            if hasattr(replica, "warm_prefix"):
                replica.warm_prefix(group)

    def step(self, now: float, tick: float) -> None:
        if self.alive:
            self.sim.step(now, tick, self.pending)

    def quiescent(self) -> bool:
        return (not self.pending and not self.delivery
                and self.sim.quiescent(self.pending))

    def idle_gap(self) -> bool:
        """Nothing due on this cell before external input arrives —
        the per-cell leg of the globe's fast-forward test."""
        if self.pending or self.delivery:
            return False
        if not self.alive:
            # a dead cell is inert by construction (its load was
            # displaced at failure; it is not stepped)
            return True
        return self.sim._idle_gap(self.pending)

    def event_due(self) -> DueSet:
        """The event core's per-cell leg (docs/PERFORMANCE.md "The
        event core"): delivered-but-unticked work needs the next
        boundary; in-DCN-flight requests apply at their delivery
        instants; everything inside the fleet answers through the
        fleet's own wake computation. A dead cell is inert."""
        due = DueSet()
        if not self.alive:
            return due
        if self.pending:
            return due.need_now()
        due.at(self.delivery.peek_time())
        return due.merge(self.sim._next_wake(self.pending))

    # -- blast-radius chaos ------------------------------------------

    def fail(self, now: float) -> List[TraceRequest]:
        """Zone loss / herd failover hits this cell: every queued,
        in-flight, admitted, and in-DCN-flight request is displaced
        back to the front door; replicas go unhealthy until
        :meth:`restore`."""
        displaced: List[TraceRequest] = []
        if self.sim.trainer is not None:
            # training gangs ride the PreemptionGuard contract
            # (docs/TRAINING.md): checkpoint at the current step,
            # evict, requeue — they rebind when the cell returns,
            # with zero counted steps lost
            self.sim._now = now
            self.sim.trainer.evict_all(now, reason="cell failed")
        for replica in self.sim.replicas:
            if replica.healthy:
                for req in replica.fail(now):
                    # a decode replica's queue may hold KV handoffs:
                    # the front door re-admits TraceRequests, so
                    # unwrap to the base request (full re-prefill on
                    # the failover cell)
                    base = (req.request
                            if getattr(req, "is_kv_handoff", False)
                            else req)
                    self.sim._prefill_done_ids.discard(
                        base.request_id)
                    displaced.append(base)
        displaced.extend(self.sim.displace_disagg())
        displaced.extend(self.sim.router.queue)
        self.sim.router.queue = []
        displaced.extend(self.pending)
        self.pending.clear()
        for req in self.delivery.pop_due(float("inf")):
            if req.request_id in self._cancelled:
                self._cancelled.discard(req.request_id)
                continue
            displaced.append(req)
        self.alive = False
        return displaced

    def restore(self, now: float) -> None:
        for replica in self.sim.replicas:
            if not replica.healthy:
                replica.restore(now)
        self.alive = True

    def report(self) -> Dict[str, object]:
        """Per-cell board for the globe report: the cell's own SLO
        view, router counters, and replica health — everything but
        the per-request log (the globe's global log carries that)."""
        out: Dict[str, object] = {
            "zone": self.zone,
            "alive": self.alive,
            "draining": self.draining,
            "replicas": len(self.sim.replicas),
            "routable_replicas": self.routable_replicas(),
            "peak_outstanding": self.peak_outstanding,
            "slo": self.sim.tracker.report(),
            "router": self.sim.router.report(),
        }
        if self.sim.autoscaler is not None:
            out["autoscaler"] = self.sim.autoscaler.report()
        if self.sim.overload is not None:
            out["overload"] = self.sim.overload.report()
        if self.sim.sched is not None:
            out["sched_event_counts"] = \
                self.sim.sched.report()["event_counts"]
        if self.sim.trainer is not None:
            out["training"] = self.sim.trainer.report()
        if self.sim._zoo is not None:
            out["zoo"] = {
                "generation": (self.sim._gen_of(0)
                               if self.sim._generations else None),
                "warm": sorted(self.models_warm()),
                "swaps": len(self.sim._swap_log),
            }
        return out
