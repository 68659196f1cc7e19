"""The global front door: anycast-style admission over N cells (the
port's copy of ``kind_tpu_sim/globe/frontdoor.py``).

The planet-facing half of the globe layer (docs/GLOBE.md). Every
request originates in a zone and hits the front door at its arrival
tick; the front door picks a cell the way a global load balancer
does — **nearest healthy cell first** (DCN round-trip to the cell's
zone is the leading cost), **capacity-aware** (a cell's queue depth,
normalized by its routable slots, is the second), with **sticky
prefix-affinity** (a shared-prefix cohort keeps one home cell so the
cell-level prefix caches stay warm) and **spill** when the preferred
cell is saturated or breaching its SLO window.

Two bounds make the spill safe instead of a cascade amplifier:

* the **nominal depth** (``queue_depth`` × slots) past which a cell
  stops being anyone's first choice, and
* the **hard limit** (nominal × (1 + ``spill_headroom``)) past which
  the front door refuses to admit AT ALL — a surviving cell can
  never be flooded beyond its configured headroom by a thundering
  herd; overflow waits in the front door's own FCFS queue (admission
  control at the planet tier, the same move the router makes at the
  cell tier) and sheds loudly only past ``max_queue``.

Determinism: candidate order is (saturation, cost, cell name); the
affinity map hashes the group id over the STATIC cell list; no
entropy anywhere — same seed, same admissions, byte-identical
reports.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.fleet.loadgen import TraceRequest
from kind_tpu_sim_torch.globe.cell import Cell


@dataclasses.dataclass(frozen=True)
class FrontDoorConfig:
    # requests per routable slot a cell absorbs before it stops
    # being a first choice (the saturation-spill trigger)
    queue_depth: float = 4.0
    # extra fraction over nominal depth a cell will accept from
    # spill before the front door refuses outright — the herd bound
    spill_headroom: float = 0.5
    # how many requests MORE loaded (absolute) a cohort's home cell
    # may be than the best candidate before affinity yields
    affinity_spill: int = 8
    # spill away from a cell whose recent SLO window drops below
    # this attainment (None = saturation-only spill)
    slo_spill_below: Optional[float] = 0.7
    slo_window: int = 32
    # cost weight of one unit of normalized load vs one second of
    # DCN round-trip (0.01 ~ "10 ms of latency buys one queue slot
    # per slot of capacity")
    load_weight_s: float = 0.01
    # front-door FCFS overflow queue bound; beyond it, shed loudly
    max_queue: int = 4096
    # shed records kept for inspection (the TOTAL is a counter —
    # a 1M-request surge run must not hold every shed request alive)
    shed_window: int = 64
    # cross-cell prefix-cache warm-up on failover (docs/OVERLOAD.md):
    # when a cohort's home cell stops being routable, the cell now
    # serving the cohort pre-warms its prefix group so post-failover
    # TTFT recovers faster than a cold spill
    warm_on_failover: bool = True

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class FrontDoor:
    """Admission + cross-cell spill. ``rtt_s(origin_zone, zone)`` is
    the globe's DCN latency model (degraded links inflate it, which
    is how a browned-out path steers traffic away)."""

    def __init__(self, cfg: FrontDoorConfig, cells: Sequence[Cell],
                 rtt_s: Callable[[str, str], float],
                 overload=None):
        self.cfg = cfg
        self.cells = list(cells)          # static: affinity keyspace
        self.rtt_s = rtt_s
        # optional fleet.overload.OverloadState: per-CELL circuit
        # breakers gate the candidate set (the cell tier of the
        # breaker ladder, docs/OVERLOAD.md) and note_result feeds
        # them each completion's SLO verdict
        self.overload = overload
        # admission hook: called (request, origin, cell, now) on
        # every admit — the globe driver arms cross-cell hedge
        # timers through it
        self.on_admit = None
        self.queue: deque = deque()       # (request, origin_zone)
        self.routed = 0
        self.spilled = 0
        self.affinity_hits = 0
        # bounded recent window + exact total: long shed-heavy soaks
        # must not hold every shed request alive
        self.shed: deque = deque(maxlen=max(1, cfg.shed_window))
        self.shed_total = 0
        self.readmitted = 0
        self.prefix_warmups = 0
        self._warmed: set = set()         # (cell, group) once each
        self._slo_window: Dict[str, deque] = {
            c.name: deque(maxlen=cfg.slo_window) for c in cells}

    # -- scoring ------------------------------------------------------

    def _nominal(self, cell: Cell) -> float:
        return max(1.0, cell.capacity() * self.cfg.queue_depth)

    def _hard_limit(self, cell: Cell) -> float:
        return math.ceil(
            self._nominal(cell) * (1.0 + self.cfg.spill_headroom))

    def _slo_breaching(self, cell: Cell) -> bool:
        if self.cfg.slo_spill_below is None:
            return False
        window = self._slo_window[cell.name]
        if len(window) < window.maxlen // 2:
            return False
        return (sum(window) / len(window)
                < self.cfg.slo_spill_below)

    def note_result(self, cell_name: str, slo_ok: bool,
                    now: float = 0.0) -> None:
        """The globe streams every completion's SLO verdict back so
        spill can react to a breaching cell before its queue shows
        it (slow-but-alive cells fill slowly); the same verdict
        feeds the cell's circuit breaker when overload containment
        is on."""
        window = self._slo_window.get(cell_name)
        if window is not None:
            window.append(1 if slo_ok else 0)
        if self.overload is not None:
            self.overload.breaker_record(cell_name, slo_ok, now)

    def _candidates(self, origin: str, now: float = 0.0,
                    model: str = "") -> List[Cell]:
        """Routable cells under their hard limit, best first:
        unsaturated before saturated, then (zoo traffic) cells with
        the model WARM before cells that would cold-swap, then
        DCN-latency + load cost, then name — a pure function of
        (origin, cell states). A model-stamped request only
        considers cells that can serve the model at all (it fits
        some healthy replica's generation); with no model the cold
        bit is constant and the order is the historical one. An
        OPEN per-cell breaker removes its cell from the set (shed
        fast) unless every breaker is open — degraded candidates
        beat a global black hole, the same never-empty rule the
        fleet router applies to quarantine."""
        scored = []
        for cell in self.cells:
            if not cell.routable():
                continue
            if model and not cell.serves(model):
                continue
            load = cell.outstanding()
            if load >= self._hard_limit(cell):
                continue  # the herd bound: never flood past headroom
            saturated = (load >= self._nominal(cell)
                         or self._slo_breaching(cell))
            cold = (1 if model
                    and model not in cell.models_warm() else 0)
            cost = (self.rtt_s(origin, cell.zone)
                    + self.cfg.load_weight_s
                    * load / max(1, cell.capacity()))
            scored.append((1 if saturated else 0, cold, cost,
                           cell.name, cell))
        scored.sort(key=lambda t: t[:4])
        out = [t[4] for t in scored]
        if self.overload is not None:
            allowed = [c for c in out
                       if self.overload.breaker_allows(c.name, now)]
            if allowed:
                out = allowed
        return out

    def _home(self, req: TraceRequest) -> Optional[Cell]:
        """Sticky prefix-affinity: the cohort's home cell, hashed
        over the static cell list so the mapping survives cell
        failures (a dead home just spills until it returns)."""
        if req.prefix_group < 0 or not self.cells:
            return None
        key = zlib.crc32(
            f"globe-group:{req.prefix_group}".encode("utf-8"))
        return self.cells[key % len(self.cells)]

    def pick(self, req: TraceRequest, origin: str,
             now: float = 0.0) -> Optional[Cell]:
        model = getattr(req, "model", "")
        candidates = self._candidates(origin, now, model)
        if not candidates:
            return None
        chosen = candidates[0]
        home = self._home(req)
        if home is not None and home in candidates:
            floor = min(c.outstanding() for c in candidates)
            if home.outstanding() - floor <= self.cfg.affinity_spill:
                self.affinity_hits += 1
                metrics.globe_board().incr("affinity_hits")
                chosen = home
        if model:
            # warm-cell spill accounting (docs/ZOO.md) — zoo traffic
            # only, so unzooed boards keep their historical bytes
            metrics.zoo_board().incr(
                "warm_cell_picks"
                if model in chosen.models_warm()
                else "cold_cell_picks")
        return chosen

    # -- admission ----------------------------------------------------

    def offer(self, req: TraceRequest, origin: str, now: float,
              readmit: bool = False) -> Optional[tuple]:
        """Route one request (or queue it when every cell is at its
        bound). Returns a shed marker tuple only when even the
        front-door queue is full — the caller records it."""
        cell = self.pick(req, origin, now)
        if cell is not None:
            self._admit(cell, req, origin, now, readmit)
            return None
        if len(self.queue) < self.cfg.max_queue:
            self.queue.append((req, origin))
            metrics.globe_board().incr("frontdoor_queued")
            return None
        metrics.globe_board().incr("frontdoor_shed")
        self.shed_total += 1
        self.shed.append((req.request_id, origin, round(now, 6)))
        return (req, origin, now)

    def _warm_failover(self, cell: Cell, req: TraceRequest) -> None:
        """Cross-cell prefix-cache warm-up (docs/OVERLOAD.md): the
        cohort's home cell stopped being routable, so the cell now
        serving it pre-warms the cohort's prefix group — once per
        (cell, group) — and the first post-failover request of the
        cohort prefills suffix-only instead of cold."""
        if not self.cfg.warm_on_failover or req.prefix_group < 0:
            return
        home = self._home(req)
        if home is None or home is cell or home.routable():
            return
        key = (cell.name, req.prefix_group)
        if key in self._warmed:
            return
        self._warmed.add(key)
        cell.warm_prefix(req.prefix_group)
        self.prefix_warmups += 1
        metrics.globe_board().incr("prefix_warmups")

    def _admit(self, cell: Cell, req: TraceRequest, origin: str,
               now: float, readmit: bool) -> None:
        self._warm_failover(cell, req)
        # the full DCN round trip rides on the delivery time, so
        # every latency the cell later measures for this request
        # already includes the network the front door chose
        cell.admit(req, now + self.rtt_s(origin, cell.zone))
        self.routed += 1
        if origin == cell.zone:
            metrics.globe_board().incr("admit_local")
        else:
            self.spilled += 1
            metrics.globe_board().incr("admit_spill")
        if readmit:
            self.readmitted += 1
            metrics.globe_board().incr("herd_readmissions")
        if self.overload is not None:
            self.overload.breaker_dispatch(cell.name)
        if self.on_admit is not None:
            self.on_admit(req, origin, cell, now)

    def pump(self, now: float) -> None:
        """Retry the FCFS overflow queue head-first; the head
        blocking keeps global admission fair, same as the cell
        router's dispatch."""
        while self.queue:
            req, origin = self.queue[0]
            cell = self.pick(req, origin, now)
            if cell is None:
                return
            self.queue.popleft()
            self._admit(cell, req, origin, now, readmit=False)

    def report(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "routed": self.routed,
            "spilled": self.spilled,
            "affinity_hits": self.affinity_hits,
            "readmitted": self.readmitted,
            "queued": len(self.queue),
            "shed": self.shed_total,
            "hard_limits": {
                c.name: self._hard_limit(c) for c in self.cells},
            "peak_outstanding": {
                c.name: c.peak_outstanding for c in self.cells},
        }
        if self.prefix_warmups:
            out["prefix_warmups"] = self.prefix_warmups
        return out
