"""SLO-aware routing over serving replicas (the fleet data plane).

The port's copy of ``kind_tpu_sim/fleet/router.py``:

* :class:`SimReplica` -- the analytic continuous-batching replica on the
  virtual clock: prefill is a base plus a per-token time, decode a time
  per output token, ``max_slots`` run at once, and admission happens at
  tick boundaries, the engine's shape without the matmuls. Each slot
  keeps the absolute time of its next event, so a span gives the same
  floats however ticks cover it. A replica has a phase: ``unified``
  (prefill and decode), ``prefill`` (a request completes at its first
  token as ``prefill_done``, and the fleet ships its KV cache) or
  ``decode`` (it admits ``disagg.KvHandoff``s). Its prices come from
  :class:`SimReplicaConfig`, or from the H100's calibration through
  ``disagg.calibrated_sim_config``.
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
  With disaggregated pools (``disagg``) arrivals go to the prefill pool
  and KV handoffs wait in a lane of their own for the decode pool, which
  drains first and never sheds; under isolation a tenant over its
  decode-pool budget defers without blocking the others. With the model
  zoo (``zoo``) a request that names a model goes to the replicas that
  can hold it, those with it resident first, then by load; a model that
  no replica can hold is shed.

A replica of a zoo fleet (``SimReplicaConfig``'s ``model_*`` maps, from
``zoo.model_sim_config``) holds one model resident: admitting another
pays its swap time before the prefill, on the slot's closed-form
timeline, and reports the swap through ``on_swap``. In a columnar fleet
(``fleet/columnar.py``) every method of a ``SimReplica`` that changes
its queue, slots, health or timing calls ``_touch()``, and the router's
least-outstanding choice is one ``argmin`` over the mirror.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.fleet.loadgen import TraceRequest
from kind_tpu_sim_torch.fleet.tenancy import tenant_of

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
    # length | stop | deadline_exceeded | shed | prefill_done
    finish_reason: str
    # ground truth that an analytic replica's defective chip corrupted
    # this stream's fingerprint; detection reads only tokens_crc
    corrupted: bool = False


@dataclasses.dataclass(frozen=True)
class SimReplicaConfig:
    """The analytic replica's service model. The defaults are the
    reference's round figures for a small model, not a measurement of
    any chip; ``disagg.calibrated_sim_config`` prices a replica from the
    H100's calibration instead. The ``model_*`` fields are the model
    zoo's per-model prices as sorted (name, value) pairs, empty on an
    unzooed replica (whose prices are then the plain fields, float for
    float); a model absent from them cannot be served here.
    ``model_swap_s`` is a cold admission's weight load, and
    ``resident_model`` the model warm at bring-up."""

    max_slots: int = 4
    prefill_base_s: float = 0.010
    prefill_per_tok_s: float = 0.001
    tpot_s: float = 0.005
    max_queue: int = 64          # submit() refuses beyond this
    prefix_cache_entries: int = 8  # prefix groups remembered (0: off)
    model_prefill_per_tok_s: tuple = ()
    model_tpot_s: tuple = ()
    model_swap_s: tuple = ()
    resident_model: str = ""

    def as_dict(self) -> dict:
        """The config's report form: the zoo's fields only when set."""
        out = dataclasses.asdict(self)
        if not self.model_tpot_s:
            for key in ("model_prefill_per_tok_s", "model_tpot_s",
                        "model_swap_s", "resident_model"):
                del out[key]
        else:
            for key in ("model_prefill_per_tok_s", "model_tpot_s",
                        "model_swap_s"):
                out[key] = [list(pair) for pair in out[key]]
        return out


class SimReplica:
    """The deterministic service-time model of one continuous-batching
    engine. Each slot runs a prefill then decode timeline in closed
    form: it carries the absolute virtual time of its next event (the
    first token, then each decoded token), so advancing it over
    [t0, t1] gives the same floats in one ``tick()`` or a hundred, which
    is what lets the event core skip boundaries. Admission and the
    queue's deadline reaping happen at tick boundaries."""

    def __init__(self, replica_id: int,
                 cfg: SimReplicaConfig = SimReplicaConfig(),
                 phase: str = "unified"):
        if phase not in ("prefill", "decode", "unified"):
            raise ValueError(
                f"unknown replica phase {phase!r}; known: "
                "prefill, decode, unified")
        self.replica_id = replica_id
        self.cfg = cfg
        self.phase = phase
        self.healthy = True
        # gray failure: a factor on every service time (1.0 nominal)
        self.slowdown = 1.0
        # silent data corruption: the share of completions whose
        # fingerprint a defective chip flips while timings stay nominal
        self.corrupt_frac = 0.0
        self.queue: List[TraceRequest] = []
        self._slots: List[Optional[dict]] = [None] * cfg.max_slots
        # prefix groups seen, LRU-bounded: a hit skips the group
        # prefix's share of prefill
        self._prefix_seen: Dict[int, bool] = {}
        # under tenant isolation: group -> owning tenant, and the
        # per-tenant entry caps the fleet installs, so a tenant evicts
        # its own oldest groups before a neighbour's
        self._prefix_owner: Dict[int, str] = {}
        self.tenant_prefix_caps: Optional[Dict[str, int]] = None
        self.prefix_hits = 0
        self.prefix_misses = 0
        # the model zoo: the resident model, the per-model prices and
        # the swap ledger (empty and zero on an unzooed replica)
        self.resident_model = cfg.resident_model
        self._model_prefill = dict(cfg.model_prefill_per_tok_s)
        self._model_tpot = dict(cfg.model_tpot_s)
        self._model_swap = dict(cfg.model_swap_s)
        self.swaps = 0
        self.warm_hits = 0
        # called (SwapEvent) when an admission loads a model: the fleet
        # puts it on LANE_MODEL_SWAP
        self.on_swap = None
        # the columnar mirror and this replica's row in it (None outside
        # a columnar fleet)
        self._cols = None
        self._idx = -1

    def _touch(self) -> None:
        c = self._cols
        if c is not None:
            c.dirty.add(self._idx)

    def set_slowdown(self, factor: float) -> None:
        """Scale prefill and decode times by ``factor`` (1 restores)
        from now on; a token already scheduled keeps its time."""
        self.slowdown = max(1.0, float(factor))
        self._touch()

    def set_corrupt(self, frac: float) -> None:
        """Make this replica's chip defective: a deterministic ``frac``
        of its completions carry a wrong, replica-keyed fingerprint
        (0 restores clean output)."""
        self.corrupt_frac = max(0.0, min(1.0, float(frac)))
        self._touch()

    def cancel(self, request_id: str) -> bool:
        """Withdraw a hedge's losing copy from the queue or free its
        slot mid-stream (its partial stream is discarded); False when
        the request is not here."""
        for i, req in enumerate(self.queue):
            if req.request_id == request_id:
                del self.queue[i]
                self._touch()
                return True
        for i, slot in enumerate(self._slots):
            if (slot is not None
                    and slot["req"].request_id == request_id):
                self._slots[i] = None
                self._touch()
                return True
        return False

    def warm_prefix(self, group: int) -> None:
        """Pre-warm one prefix-cache group (the globe's cross-cell
        failover warm-up): the group enters the LRU as if just seen,
        without counting a hit or a miss, so the cohort's next request
        prefills its suffix alone."""
        if self.cfg.prefix_cache_entries <= 0 or group < 0:
            return
        self._prefix_seen.pop(group, None)
        self._prefix_seen[group] = True
        while len(self._prefix_seen) > self.cfg.prefix_cache_entries:
            evicted = next(iter(self._prefix_seen))
            self._prefix_seen.pop(evicted)
            self._prefix_owner.pop(evicted, None)

    # -- the model zoo -------------------------------------------------

    def can_serve(self, model: str) -> bool:
        """Whether ``model`` is in this replica's price maps (absent: it
        does not fit the replica's generation). The empty model and an
        unzooed replica serve anywhere."""
        return (not model or not self._model_tpot
                or model in self._model_tpot)

    def _swap_in(self, model: str, now: float) -> float:
        """An admission's weight load, in seconds: 0 when ``model`` is
        resident (a warm hit), else its swap time at the current
        slowdown. The model is resident from the admission on, and the
        fleet hears of the swap through ``on_swap``."""
        if not model or not self._model_tpot:
            return 0.0
        if model == self.resident_model:
            self.warm_hits += 1
            return 0.0
        cost = self._model_swap.get(model, 0.0) * self.slowdown
        evicted = self.resident_model
        self.resident_model = model
        self.swaps += 1
        self._touch()
        if self.on_swap is not None:
            from kind_tpu_sim_torch.fleet.zoo import SwapEvent

            self.on_swap(SwapEvent(
                replica_id=self.replica_id, model=model,
                evicted=evicted, ready_s=round(now + cost, 9)))
        return cost

    # -- the replica interface -----------------------------------------

    def outstanding(self) -> int:
        return (len(self.queue)
                + sum(1 for s in self._slots if s is not None))

    def idle(self) -> bool:
        return self.outstanding() == 0

    def holds(self, request_id: str) -> bool:
        """Whether ``request_id`` is queued or in a slot here."""
        return (any(r.request_id == request_id for r in self.queue)
                or any(s is not None and s["req"].request_id == request_id
                       for s in self._slots))

    def submit(self, req: TraceRequest, now: float) -> bool:
        if not self.healthy:
            return False
        if not self.can_serve(getattr(req, "model", "")):
            return False
        if (self.cfg.max_queue
                and len(self.queue) >= self.cfg.max_queue):
            return False
        self.queue.append(req)
        self._touch()
        return True

    def _prefill_cost(self, req: TraceRequest) -> float:
        """The whole prompt's prefill time, less the cached prefix's
        share on a group hit."""
        toks = len(req.prompt)
        if (self.cfg.prefix_cache_entries > 0
                and req.prefix_group >= 0):
            if req.prefix_group in self._prefix_seen:
                self.prefix_hits += 1
                self._prefix_seen.pop(req.prefix_group)
                self._prefix_seen[req.prefix_group] = True
                toks = max(1, toks - self._group_prefix_len(req))
            else:
                self.prefix_misses += 1
                self._prefix_seen[req.prefix_group] = True
                caps = self.tenant_prefix_caps
                if caps is not None:
                    owner = tenant_of(req)
                    self._prefix_owner[req.prefix_group] = owner
                    cap = caps.get(owner)
                    if cap is not None:
                        owned = [g for g in self._prefix_seen
                                 if self._prefix_owner.get(g) == owner]
                        while len(owned) > cap:
                            g = owned.pop(0)
                            self._prefix_seen.pop(g, None)
                            self._prefix_owner.pop(g, None)
                while (len(self._prefix_seen)
                       > self.cfg.prefix_cache_entries):
                    evicted = next(iter(self._prefix_seen))
                    self._prefix_seen.pop(evicted)
                    self._prefix_owner.pop(evicted, None)
        # the model's prefill rate; an unzooed replica's is the plain one
        per_tok = self._model_prefill.get(
            req.model, self.cfg.prefill_per_tok_s)
        return (self.cfg.prefill_base_s + per_tok * toks) * self.slowdown

    @staticmethod
    def _group_prefix_len(req: TraceRequest) -> int:
        """The shared prefix's length: at most half the prompt, so a hit
        never removes prefill entirely."""
        return min(len(req.prompt) // 2, 16)

    def next_due(self) -> tuple:
        """``(ge_s, cover_s)``, the event core's view of this replica.
        ``ge_s``: the earliest boundary-condition instant (a queued
        request's deadline, or 0.0 when queued work can take a free slot
        at the next boundary). ``cover_s``: a lower bound on the earliest
        completion in a slot, by length or by deadline (per-token events
        between completions need no stepping), taken a float-noise
        margin early because the closed form multiplies where the slot
        sums. None when nothing is scheduled."""
        if not self.healthy:
            return (None, None)
        ge = None
        if self.queue:
            if any(s is None for s in self._slots):
                ge = 0.0
            else:
                for req in self.queue:
                    if req.deadline_s is None:
                        continue
                    d = req.arrival_s + req.deadline_s
                    if ge is None or d < ge:
                        ge = d
        cover = None
        for slot in self._slots:
            if slot is None:
                continue
            # a zoo slot decodes at its model's TPOT
            step = slot.get("tpot_s", self.cfg.tpot_s) * self.slowdown
            req = slot["req"]
            if slot["first_s"] is None:
                # the prefill event, then at least max(max_new - 1, 1)
                # decodes; for a prefill-pool replica the prefill event
                # ends the slot
                k = (0 if self.phase == "prefill"
                     else max(req.max_new - 1, 1))
            else:
                k = max(req.max_new - slot["tokens"], 1) - 1
            lb = slot["next_s"] + k * step
            if req.deadline_s is not None:
                # a deadline fires at the last token event within its
                # budget, in (deadline - step, deadline]
                d = req.arrival_s + req.deadline_s - step
                if d < lb:
                    lb = d
            lb -= 1e-9 + 1e-12 * abs(lb)
            if cover is None or lb < cover:
                cover = lb
        return (ge, cover)

    def tick(self, now: float, dt: float) -> List[ReplicaCompletion]:
        """Advance through (now, now + dt]: reap and admit at the
        boundary, then every slot event in the window. A call that
        covers no event changes nothing."""
        if not self.healthy:
            return []
        done: List[ReplicaCompletion] = []
        if self.queue:
            still: List[TraceRequest] = []
            for req in self.queue:
                if (req.deadline_s is not None
                        and now >= req.arrival_s + req.deadline_s):
                    base = (req.request
                            if getattr(req, "is_kv_handoff", False)
                            else req)
                    done.append(ReplicaCompletion(
                        request=base, dispatch_s=now, first_s=None,
                        finish_s=round(req.arrival_s + req.deadline_s, 9),
                        tokens=0, tokens_crc=0,
                        finish_reason="deadline_exceeded"))
                else:
                    still.append(req)
            self.queue = still
            for i, slot in enumerate(self._slots):
                if slot is None and self.queue:
                    req = self.queue.pop(0)
                    if getattr(req, "is_kv_handoff", False):
                        # a decode-pool admission: the KV arrived
                        # prefilled, the slot resumes at the handoff's
                        # token count, and the dispatch and first-token
                        # stamps stay the request's; a cold model loads
                        # before the first step
                        model = req.request.model
                        swap = self._swap_in(model, now)
                        step = (self._model_tpot.get(
                            model, self.cfg.tpot_s) * self.slowdown)
                        slot = {
                            "req": req.request,
                            "dispatch_s": req.dispatch_s,
                            "next_s": now + swap + step,
                            "first_s": req.first_s,
                            "tokens": req.tokens,
                        }
                        if model and model in self._model_tpot:
                            slot["tpot_s"] = self._model_tpot[model]
                        self._slots[i] = slot
                        continue
                    model = req.model
                    # a cold model's load precedes its prefill (zero on
                    # a warm hit and on an unzooed replica)
                    swap = self._swap_in(model, now)
                    slot = {
                        "req": req,
                        "dispatch_s": now,
                        # the slot's next event: the first token at the
                        # end of prefill, then one a decoded token
                        "next_s": now + swap + self._prefill_cost(req),
                        "first_s": None,
                        "tokens": 0,
                    }
                    if model and model in self._model_tpot:
                        slot["tpot_s"] = self._model_tpot[model]
                    self._slots[i] = slot
        end = now + dt
        for i, slot in enumerate(self._slots):
            if slot is None or slot["next_s"] > end:
                continue
            tpot = slot.get("tpot_s", self.cfg.tpot_s)
            req = slot["req"]
            deadline = (req.arrival_s + req.deadline_s
                        if req.deadline_s is not None else None)
            while slot["next_s"] <= end:
                t = slot["next_s"]
                if slot["first_s"] is None:
                    slot["first_s"] = t
                    slot["tokens"] = 1
                    if self.phase == "prefill":
                        # the request's KV leaves for the decode pool
                        done.append(self._complete(
                            slot, finish_s=t, reason="prefill_done"))
                        self._slots[i] = None
                        break
                else:
                    slot["tokens"] += 1
                    if slot["tokens"] >= req.max_new:
                        done.append(self._complete(
                            slot, finish_s=t, reason="length"))
                        self._slots[i] = None
                        break
                # the next token at the current slowdown; a deadline it
                # would overshoot fires now, stamped at the deadline
                nxt = t + tpot * self.slowdown
                if deadline is not None and nxt > deadline:
                    done.append(self._complete(
                        slot, finish_s=deadline,
                        reason="deadline_exceeded"))
                    self._slots[i] = None
                    break
                slot["next_s"] = nxt
        # a slot freed mid-tick stays empty until the next boundary
        self._touch()
        return done

    def _complete(self, slot: dict, finish_s: float,
                  reason: str) -> ReplicaCompletion:
        req = slot["req"]
        # an audit copy (``~a``) fingerprints its base request, so the
        # copies compare
        base_id = req.request_id.split("~a", 1)[0]
        crc = zlib.crc32(repr((base_id, req.seed,
                               slot["tokens"])).encode("utf-8"))
        corrupted = False
        if (self.corrupt_frac > 0.0 and reason == "length"
                and zlib.crc32(
                    f"sdc:{self.replica_id}:{base_id}".encode(
                        "utf-8")) / 2**32 < self.corrupt_frac):
            # keyed by the replica, so two defective chips never agree
            crc ^= zlib.crc32(
                f"sdcbits:{self.replica_id}".encode("utf-8"))
            corrupted = True
        return ReplicaCompletion(
            request=req,
            dispatch_s=round(slot["dispatch_s"], 9),
            first_s=(round(slot["first_s"], 9)
                     if slot["first_s"] is not None else None),
            finish_s=round(finish_s, 9),
            tokens=slot["tokens"],
            tokens_crc=crc,
            finish_reason=reason,
            corrupted=corrupted)

    def fail(self, now: float) -> List[TraceRequest]:
        """Preempt: every queued and in-flight request is returned for
        the router to requeue, the prefix cache is lost, and the replica
        refuses traffic until :meth:`restore`."""
        displaced = list(self.queue)
        displaced.extend(s["req"] for s in self._slots if s is not None)
        self.queue = []
        self._slots = [None] * self.cfg.max_slots
        self._prefix_seen.clear()
        self._prefix_owner.clear()
        # the warm pool dies with the replica: it comes back with its
        # bring-up model resident
        self.resident_model = self.cfg.resident_model
        self.healthy = False
        self._touch()
        return displaced

    def restore(self, now: float) -> None:
        self.healthy = True
        self._touch()

    def report(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "kind": "sim",
            "healthy": self.healthy,
            "outstanding": self.outstanding(),
        }
        if self.phase != "unified":
            out["phase"] = self.phase
        if self.slowdown != 1.0:
            out["slowdown"] = round(self.slowdown, 6)
        if self.corrupt_frac:
            out["corrupt_frac"] = round(self.corrupt_frac, 6)
        if self.prefix_hits or self.prefix_misses:
            out["prefix"] = {"hits": self.prefix_hits,
                             "misses": self.prefix_misses}
        if self._model_tpot:
            out["zoo"] = {"resident": self.resident_model,
                          "swaps": self.swaps,
                          "warm_hits": self.warm_hits}
        return out


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

    def holds(self, request_id: str) -> bool:
        """Whether ``request_id`` is queued or in flight on the engine."""
        return request_id in self._dispatched

    def submit(self, req: TraceRequest, now: float) -> bool:
        # the engine's module loads torch: imported here, so the analytic
        # fleet and the globe import without it
        from kind_tpu_sim_torch.models.serving import EngineSaturated, Request

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
                 health=None, overload=None, disagg: bool = False,
                 tenancy=None, zoo: bool = False):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; known: {', '.join(POLICIES)}")
        self.replicas: List = list(replicas)
        self.policy = policy
        self.max_queue = max_queue
        # disaggregated pools: arrivals route to the prefill pool, KV
        # handoffs wait in their own lane for the decode pool (a blocked
        # prefill head never starves prefilled work) and are never shed
        self.disagg = disagg
        self.kv_queue: List = []
        self.kv_routed = 0
        self.kv_expired = 0
        self.kv_deferred = 0
        # optional health.FailureDetector, overload.OverloadState and
        # tenancy.TenancyState (see the module's docstring)
        self.health = health
        self.overload = overload
        self.tenancy = tenancy
        self._drr_deficit: Dict[str, float] = {}
        self._drr_pos: Dict[int, int] = {}
        self.drr_rounds = 0
        # the model zoo: a request that names a model routes warm first
        self.zoo = zoo
        self.warm_routes = 0
        self.cold_routes = 0
        # called (request, replica, now) on every successful placement:
        # the fleet arms its hedge timers through it
        self.on_place = None
        # prefix-affinity: the home replica may be this many requests
        # more loaded than the least-loaded one before the request
        # spills elsewhere
        self.affinity_spill = affinity_spill
        self.queue: List[TraceRequest] = []
        self._rr = 0
        # a columnar fleet's mirror (fleet/columnar.py): the
        # least-outstanding argmin
        self._columns = None
        self.routed = 0
        self.shed = 0
        self.expired_queued = 0
        self.requeues = 0
        self.per_replica: Dict[int, int] = {}
        self.affinity_hits = 0
        self.affinity_spills = 0

    # -- policy ------------------------------------------------------

    def _pool(self, need: str) -> List:
        """The replicas of phase ``need`` and the unified ones (every
        replica without disaggregated pools)."""
        if not self.disagg:
            return self.replicas
        return [r for r in self.replicas
                if getattr(r, "phase", "unified") in ("unified", need)]

    def _healthy(self, now: float = 0.0,
                 pool: Optional[List] = None) -> List:
        """The routable replicas of ``pool`` (default: all): healthy
        ones, less the quarantined and those whose breaker is open,
        unless that would leave none (degraded capacity beats none)."""
        base = self.replicas if pool is None else pool
        out = [r for r in base if r.healthy]
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
        """Candidate replicas, best first; ties break on replica_id. With
        disaggregated pools the request's pool is chosen first, so the
        never-empty fallbacks hold per pool; a KV handoff goes to the
        least loaded decode replica under every policy."""
        is_handoff = getattr(req, "is_kv_handoff", False)
        pool = self._pool("decode" if is_handoff else "prefill")
        healthy = self._healthy(now, pool)
        if not healthy:
            return []
        model = getattr(req, "model", "") if self.zoo else ""
        if model:
            # the replicas that can hold the model, those with it
            # resident first (a warm hit skips the load), then by load
            serving = [r for r in healthy
                       if getattr(r, "can_serve", lambda m: True)(model)]
            return sorted(
                serving,
                key=lambda r: (
                    0 if getattr(r, "resident_model", "") == model else 1,
                    self._load_key(r), r.replica_id))
        if is_handoff:
            return sorted(healthy,
                          key=lambda r: (self._load_key(r), r.replica_id))
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
        home = pool[key % len(pool)]
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

    def _fast_pick(self, req: TraceRequest):
        """A columnar fleet's first candidate where the order is exactly
        (outstanding, replica_id): least-outstanding, and prefix-affinity
        for ungrouped requests, without a detector, breakers, pools or
        the zoo. Otherwise None, and the sorted path runs; a refused
        submit falls back to it too (a refusal changes nothing)."""
        cols = self._columns
        if (cols is None or self.disagg or self.zoo
                or self.health is not None
                or self.overload is not None):
            return None
        if self.policy == "round-robin":
            return None
        if self.policy == "prefix-affinity" and req.prefix_group >= 0:
            return None
        return cols.pick_least_outstanding()

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

    def offer_handoff(self, handoff) -> None:
        """A delivered KV handoff enters the decode lane; no admission
        control, since its prefill is already spent."""
        self.kv_queue.append(handoff)

    def requeue_front(self, displaced: Sequence[TraceRequest]) -> None:
        """A failed replica's requests go back to the queue head in
        arrival order. A KV handoff unwraps to its request, which
        prefills again: its cache died with the replica."""
        ordered = sorted(
            (r.request if getattr(r, "is_kv_handoff", False) else r
             for r in displaced),
            key=lambda r: (r.arrival_s, r.request_id))
        self.queue[:0] = ordered
        self.requeues += len(ordered)
        metrics.fleet_board().incr("fleet_requeues", len(ordered))

    def dispatch(self, now: float) -> List[ReplicaCompletion]:
        """One placement pass; returns the outcomes decided at the
        router (queued requests past their deadline). The KV lane drains
        before the arrival queue."""
        out: List[ReplicaCompletion] = []
        if self.kv_queue:
            still_kv: List = []
            for h in self.kv_queue:
                if (h.deadline_s is not None
                        and now >= h.arrival_s + h.deadline_s):
                    self.kv_expired += 1
                    metrics.disagg_board().incr("kv_expired_queued")
                    out.append(ReplicaCompletion(
                        request=h.request, dispatch_s=now, first_s=None,
                        finish_s=round(h.arrival_s + h.deadline_s, 9),
                        tokens=0, tokens_crc=0,
                        finish_reason="deadline_exceeded"))
                else:
                    still_kv.append(h)
            self.kv_queue = still_kv
            if self.tenancy is not None and self.tenancy.isolation:
                self._drain_kv_tenanted(now)
            else:
                # the head blocks while the decode pool is full or gone;
                # a handoff waits, it is never shed
                while self.kv_queue and self._place_handoff(
                        self.kv_queue[0], now):
                    self.kv_queue.pop(0)
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
            elif (self.zoo and req.model
                  and not self._servable(req.model)):
                # no replica can ever hold the model: shed it now rather
                # than block the queue's head for good
                self.shed += 1
                metrics.fleet_board().incr("requests_shed")
                metrics.recovery_log().record(
                    "fleet_shed", request=req.request_id)
                out.append(ReplicaCompletion(
                    request=req, dispatch_s=now, first_s=None,
                    finish_s=now, tokens=0, tokens_crc=0,
                    finish_reason="shed"))
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
        """One placement: the columnar pick, then the sorted path."""
        fast = self._fast_pick(req)
        if fast is not None and fast.submit(req, now):
            self._note_place(req, fast, now)
            return True
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

    def _servable(self, model: str) -> bool:
        """Whether any replica, healthy or not, can hold ``model``."""
        return any(getattr(r, "can_serve", lambda m: True)(model)
                   for r in self.replicas)

    def _place_handoff(self, h, now: float) -> bool:
        """Submit one KV handoff into the decode pool."""
        for replica in self._pick_order(h, now):
            if replica.submit(h, now):
                self.kv_routed += 1
                self.per_replica[replica.replica_id] = (
                    self.per_replica.get(replica.replica_id, 0) + 1)
                metrics.disagg_board().incr("kv_handoffs_routed")
                return True
        return False

    def _drain_kv_tenanted(self, now: float) -> None:
        """The KV lane under isolation: a handoff whose tenant holds its
        decode-pool budget defers (it stays queued) without blocking
        other tenants' handoffs; a full pool still blocks everyone."""
        ten = self.tenancy
        pool = self._pool("decode")
        capacity = self._pool_capacity(pool)
        kept: List = []
        blocked = False
        for h in self.kv_queue:
            if blocked:
                kept.append(h)
                continue
            name = tenant_of(h)
            budget = ten.kv_budget(name, capacity)
            if (budget is not None
                    and self._tenant_pool_load(name, pool) >= budget):
                ten.note_kv_deferred(name)
                self.kv_deferred += 1
                kept.append(h)
                continue
            if not self._place_handoff(h, now):
                kept.append(h)
                blocked = True
        self.kv_queue = kept

    @staticmethod
    def _pool_capacity(pool) -> int:
        """A decode pool's slots (the KV budget's denominator); its
        replicas are analytic."""
        return sum(r.cfg.max_slots for r in pool)

    @staticmethod
    def _tenant_pool_load(name: str, pool) -> int:
        """A tenant's requests queued at or running on a pool's
        replicas."""
        return (sum(1 for r in pool for req in r.queue
                    if tenant_of(req) == name)
                + sum(1 for r in pool for slot in r._slots
                      if slot is not None
                      and tenant_of(slot["req"]) == name))

    def _note_place(self, req: TraceRequest, replica, now: float) -> None:
        """A placement's bookkeeping. Deficit round robin may place from
        mid-queue; ids are unique, so remove() is unambiguous."""
        self.queue.remove(req)
        self.routed += 1
        self.per_replica[replica.replica_id] = (
            self.per_replica.get(replica.replica_id, 0) + 1)
        metrics.fleet_board().incr("requests_routed")
        if self.zoo and req.model:
            if getattr(replica, "resident_model", "") == req.model:
                self.warm_routes += 1
            else:
                self.cold_routes += 1
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
        if self.disagg:
            out["kv"] = {"routed": self.kv_routed,
                         "expired": self.kv_expired,
                         "queued": len(self.kv_queue)}
            if self.kv_deferred:
                out["kv"]["deferred"] = self.kv_deferred
        if self.zoo:
            out["zoo"] = {"warm_routes": self.warm_routes,
                          "cold_routes": self.cold_routes}
        return out
