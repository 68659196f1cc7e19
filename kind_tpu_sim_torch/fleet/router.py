"""SLO-aware routing over real serving engines (the fleet data plane).

The port's copy of the engine-backed half of
``kind_tpu_sim/fleet/router.py``:

* :class:`EngineReplica` -- a ``models/serving.ServingEngine`` of the
  port as a fleet replica, driven one ``step_round()`` a tick with its
  latency clock bound to the fleet's virtual clock, so real token
  streams flow under fleet traffic and the chaos scenarios drive the
  engine's own slot-failure recovery.
  A hedge's losing copy is withdrawn with :meth:`EngineReplica.cancel`
  while it still waits in the engine's queue.
* :class:`Router` -- the balancing policies (round-robin,
  least-outstanding, prefix-affinity over the shared-prefix cohorts),
  deadlines of queued requests, and admission control: a bounded
  central queue sheds, and a replica that refuses a submit (its own
  ``max_queue``) passes the request to the next candidate. A failed
  replica's displaced requests requeue at the front of the queue. With
  a failure detector (``health``) quarantined replicas leave the
  candidates and the load orderings weigh queue depth by each
  replica's relative service time; with overload containment
  (``overload``) an open circuit breaker takes its replica out of the
  candidates; with tenant isolation (``tenancy``) the queue drains by
  deficit round robin over tenants, strict priority across QoS tiers.

The reference's analytic ``SimReplica`` and the router's disaggregated
pools, model zoo and columnar fast path belong to simulator layers the
port does not carry.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.fleet.loadgen import TraceRequest
from kind_tpu_sim_torch.fleet.tenancy import tenant_of
from kind_tpu_sim_torch.models.serving import EngineSaturated, Request

POLICIES = ("round-robin", "least-outstanding", "prefix-affinity")


@dataclasses.dataclass(frozen=True)
class ReplicaCompletion:
    """One request's terminal outcome at a replica, on the virtual
    clock. ``tokens_crc`` is the crc32 of the emitted token list's
    repr, so stream identity is checked without logging every token."""

    request: TraceRequest
    dispatch_s: float
    first_s: Optional[float]
    finish_s: float
    tokens: int
    tokens_crc: int
    finish_reason: str  # length | stop | deadline_exceeded | shed


class EngineReplica:
    """A real ``ServingEngine`` as a fleet replica: one ``step_round()``
    a tick, completions mapped back to virtual time through the engine's
    latency stamps (read from the fleet's clock), and ``fail()`` driving
    the engine's slot-failure machinery."""

    def __init__(self, replica_id: int, engine):
        self.replica_id = replica_id
        self.engine = engine
        self.healthy = True
        # a slowdown of k steps the engine every k-th tick only: the
        # math cannot be slowed, virtual time can
        self._stride = 1
        self._tick_no = 0
        self._dispatched: Dict[str, TraceRequest] = {}
        self._dispatch_s: Dict[str, float] = {}

    @property
    def slowdown(self) -> float:
        return float(self._stride)

    def set_slowdown(self, factor: float) -> None:
        self._stride = max(1, int(round(factor)))

    def outstanding(self) -> int:
        return self.engine.outstanding()

    def idle(self) -> bool:
        return self.outstanding() == 0

    def submit(self, req: TraceRequest, now: float) -> bool:
        if not self.healthy:
            return False
        try:
            self.engine.submit(Request(
                request_id=req.request_id,
                prompt=list(req.prompt),
                max_new=req.max_new,
                seed=req.seed,
                deadline_s=req.deadline_s,
                cache_prefix=req.prefix_group >= 0,
            ))
        except EngineSaturated:
            return False
        self._dispatched[req.request_id] = req
        self._dispatch_s[req.request_id] = now
        return True

    def tick(self, now: float, dt: float) -> List[ReplicaCompletion]:
        if not self.healthy:
            return []
        self._tick_no += 1
        if not self.idle() and self._tick_no % self._stride == 0:
            self.engine.step_round()
        out = []
        for c in self.engine.poll():
            req = self._dispatched.pop(c.request_id)
            disp = self._dispatch_s.pop(c.request_id)
            crc = zlib.crc32(repr(tuple(c.tokens)).encode("utf-8"))
            first = (disp + c.ttft_s if c.ttft_s is not None
                     and c.tokens else None)
            out.append(ReplicaCompletion(
                request=req,
                dispatch_s=round(disp, 9),
                first_s=round(first, 9) if first is not None else None,
                finish_s=round(disp + (c.e2e_s or 0.0), 9),
                tokens=len(c.tokens),
                tokens_crc=crc,
                finish_reason=c.finish_reason))
        return out

    def cancel(self, request_id: str) -> bool:
        """Withdraw a hedge's losing copy: a request still in the
        engine's queue leaves it and every record the replica and the
        engine keep of it (True); one already claimed by a slot keeps
        it and completes, and the caller drops that late completion
        (False)."""
        eng = self.engine
        for i, r in enumerate(eng.queue):
            if r.request_id == request_id:
                del eng.queue[i]
                eng._req_clock.pop(request_id, None)
                self._dispatched.pop(request_id, None)
                self._dispatch_s.pop(request_id, None)
                return True
        return False

    def fail(self, now: float) -> List[TraceRequest]:
        """Every slot takes ``inject_slot_failure`` (mid-stream requests
        requeue inside the engine), then the engine's whole queue goes
        back to the router. The quarantine holds until :meth:`restore`."""
        eng = self.engine
        for slot in range(eng.serving.max_slots):
            eng.inject_slot_failure(slot, quarantine=True)
        displaced = []
        for r in eng.queue:
            displaced.append(self._dispatched.pop(r.request_id))
            self._dispatch_s.pop(r.request_id, None)
            # the engine keyed its latency clocks by id at submit: drop
            # them so a resubmit after recovery is not a duplicate
            eng._req_clock.pop(r.request_id, None)
        eng.queue = []
        self.healthy = False
        return displaced

    def restore(self, now: float) -> None:
        for slot in range(self.engine.serving.max_slots):
            self.engine.restore_slot(slot)
        self.healthy = True

    def report(self) -> Dict[str, object]:
        return {
            "kind": "engine",
            "healthy": self.healthy,
            "outstanding": self.outstanding(),
            "engine": self.engine.report(),
        }


class Router:
    """The fleet's balancing and admission layer.

    Requests wait in a bounded central queue; each ``dispatch()`` pass
    drains it head first onto replicas by policy. A head that no
    candidate takes blocks the pass (FCFS, no overtaking). Queued
    requests past their deadline complete as ``deadline_exceeded``
    without reaching a replica; a full queue sheds on arrival."""

    def __init__(self, replicas: Sequence, policy: str = "round-robin",
                 max_queue: int = 0, affinity_spill: int = 8,
                 health=None, overload=None, tenancy=None):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; known: {', '.join(POLICIES)}")
        self.replicas: List = list(replicas)
        self.policy = policy
        self.max_queue = max_queue
        # optional health.FailureDetector, overload.OverloadState and
        # tenancy.TenancyState (see the module's docstring)
        self.health = health
        self.overload = overload
        self.tenancy = tenancy
        self._drr_deficit: Dict[str, float] = {}
        self._drr_pos: Dict[int, int] = {}
        self.drr_rounds = 0
        # called (request, replica, now) on every successful placement:
        # the fleet arms its hedge timers through it
        self.on_place = None
        # prefix-affinity: the home replica may be this many requests
        # more loaded than the least-loaded one before the request
        # spills elsewhere
        self.affinity_spill = affinity_spill
        self.queue: List[TraceRequest] = []
        self._rr = 0
        self.routed = 0
        self.shed = 0
        self.expired_queued = 0
        self.requeues = 0
        self.per_replica: Dict[int, int] = {}
        self.affinity_hits = 0
        self.affinity_spills = 0

    # -- policy ------------------------------------------------------

    def _healthy(self, now: float) -> List:
        """The routable replicas: healthy ones, less the quarantined and
        those whose breaker is open, unless that would leave none
        (degraded capacity beats none)."""
        out = [r for r in self.replicas if r.healthy]
        if self.health is not None:
            clean = [r for r in out if not self.health.quarantined(
                f"replica-{r.replica_id}")]
            if clean:
                out = clean
        if self.overload is not None:
            allowed = [r for r in out if self.overload.breaker_allows(
                f"replica-{r.replica_id}", now)]
            if allowed:
                out = allowed
        return out

    def _load_key(self, r) -> float:
        """A replica's load for the orderings: its queue depth, weighted
        by its relative service time when a detector is on."""
        if self.health is None:
            return float(r.outstanding())
        rel = self.health.relative_latency(f"replica-{r.replica_id}")
        return (r.outstanding() + 1) * rel

    def _pick_order(self, req: TraceRequest, now: float = 0.0) -> List:
        """Candidate replicas, best first; ties break on replica_id."""
        healthy = self._healthy(now)
        if not healthy:
            return []
        if self.policy == "round-robin":
            start = self._rr % len(healthy)
            return healthy[start:] + healthy[:start]
        by_load = sorted(healthy,
                         key=lambda r: (self._load_key(r), r.replica_id))
        if self.policy == "least-outstanding" or req.prefix_group < 0:
            return by_load
        # prefix-affinity: a group's home is the crc of its id over the
        # whole replica list, so the mapping survives scale events
        key = zlib.crc32(f"group:{req.prefix_group}".encode("utf-8"))
        home = self.replicas[key % len(self.replicas)]
        # affinity never overrides a quarantine or an open breaker
        if home not in healthy or (
                self.health is not None and self.health.quarantined(
                    f"replica-{home.replica_id}")):
            return by_load
        floor = by_load[0].outstanding()
        if home.outstanding() - floor > self.affinity_spill:
            self.affinity_spills += 1
            return by_load
        self.affinity_hits += 1
        return [home] + [r for r in by_load if r is not home]

    # -- surface -----------------------------------------------------

    def offer(self, req: TraceRequest,
              now: float) -> Optional[ReplicaCompletion]:
        """Admit one arrival into the central queue; returns a shed
        completion when the queue is full."""
        if self.max_queue and len(self.queue) >= self.max_queue:
            self.shed += 1
            metrics.fleet_board().incr("requests_shed")
            metrics.recovery_log().record(
                "fleet_shed", request=req.request_id)
            return ReplicaCompletion(
                request=req, dispatch_s=now, first_s=None,
                finish_s=now, tokens=0, tokens_crc=0,
                finish_reason="shed")
        self.queue.append(req)
        return None

    def requeue_front(self, displaced: Sequence[TraceRequest]) -> None:
        """A failed replica's requests go back to the queue head in
        arrival order."""
        ordered = sorted(displaced,
                         key=lambda r: (r.arrival_s, r.request_id))
        self.queue[:0] = ordered
        self.requeues += len(ordered)
        metrics.fleet_board().incr("fleet_requeues", len(ordered))

    def dispatch(self, now: float) -> List[ReplicaCompletion]:
        """One placement pass; returns the outcomes decided at the
        router (queued requests past their deadline)."""
        out: List[ReplicaCompletion] = []
        still: List[TraceRequest] = []
        for req in self.queue:
            if (req.deadline_s is not None
                    and now >= req.arrival_s + req.deadline_s):
                self.expired_queued += 1
                metrics.fleet_board().incr("deadline_expired_queued")
                out.append(ReplicaCompletion(
                    request=req, dispatch_s=now, first_s=None,
                    finish_s=round(req.arrival_s + req.deadline_s, 9),
                    tokens=0, tokens_crc=0,
                    finish_reason="deadline_exceeded"))
            else:
                still.append(req)
        self.queue = still
        if self.tenancy is not None and self.tenancy.isolation:
            self._dispatch_drr(now)
        else:
            while self.queue:
                if not self._try_place(self.queue[0], now):
                    break  # head blocks: FCFS, retry next pass
        return out

    def _try_place(self, req: TraceRequest, now: float) -> bool:
        for replica in self._pick_order(req, now):
            if replica.submit(req, now):
                self._note_place(req, replica, now)
                return True
        return False

    def _dispatch_drr(self, now: float) -> None:
        """Deficit round robin over tenants: serve the best QoS rank
        present (strict priority), rotate its tenants, top each visit up
        by ``quantum x weight`` (capped at twice that), and place the
        tenant's FIFO head while credit lasts. A blocked tenant head
        passes to the next tenant instead of blocking the rank. A
        tenant's deficit resets when its backlog empties; all state
        moves only on placements."""
        ten = self.tenancy
        progress = True
        while progress and self.queue:
            progress = False
            fifos: Dict[str, List[TraceRequest]] = {}
            for req in self.queue:
                fifos.setdefault(tenant_of(req), []).append(req)
            rank = min(ten.qos_rank(n) for n in fifos)
            names = sorted(n for n in fifos if ten.qos_rank(n) == rank)
            pos = self._drr_pos.get(rank, 0) % len(names)
            for name in names[pos:] + names[:pos]:
                fifo = fifos[name]
                topup = ten.drr_quantum * ten.weight(name)
                deficit = min(self._drr_deficit.get(name, 0.0) + topup,
                              2.0 * topup)
                while fifo and deficit >= 1.0:
                    if not self._try_place(fifo[0], now):
                        break
                    fifo.pop(0)
                    deficit -= 1.0
                    progress = True
                self._drr_deficit[name] = deficit if fifo else 0.0
            if len(names) > 1:
                self._drr_pos[rank] = (pos + 1) % len(names)
            if progress:
                self.drr_rounds += 1

    def _note_place(self, req: TraceRequest, replica, now: float) -> None:
        """A placement's bookkeeping. Deficit round robin may place from
        mid-queue; ids are unique, so remove() is unambiguous."""
        self.queue.remove(req)
        self.routed += 1
        self.per_replica[replica.replica_id] = (
            self.per_replica.get(replica.replica_id, 0) + 1)
        metrics.fleet_board().incr("requests_routed")
        if self.policy == "round-robin":
            self._rr += 1
        if self.overload is not None:
            self.overload.breaker_dispatch(f"replica-{replica.replica_id}")
        if self.on_place is not None:
            self.on_place(req, replica, now)

    def report(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "policy": self.policy,
            "routed": self.routed,
            "shed": self.shed,
            "expired_queued": self.expired_queued,
            "requeues": self.requeues,
            "queued": len(self.queue),
            "per_replica": {str(k): v for k, v in
                            sorted(self.per_replica.items())},
        }
        if self.policy == "prefix-affinity":
            out["affinity"] = {"hits": self.affinity_hits,
                               "spills": self.affinity_spills}
        if self.tenancy is not None and self.tenancy.isolation:
            out["fair_queue"] = {"quantum": round(self.tenancy.drr_quantum, 6),
                                 "rounds": self.drr_rounds}
        return out
