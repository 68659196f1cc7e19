"""Sharded GlobeSim: cells partitioned across worker processes (the
port's copy of ``kind_tpu_sim/globe/shard.py``).

:class:`ShardedGlobeSim` runs the same globe as
:class:`~kind_tpu_sim_torch.globe.sim.GlobeSim`, with the cells split
round-robin across cold pool workers (the worker protocol of
utils/worker_pool.py, bulk payloads over its shared-memory segments)
and driven through
parent-side :class:`CellProxy` stand-ins. Reports are
**byte-identical** to the single-process driver — sharding is an
execution strategy like fast-forward and the event core, chosen at
the driver (``ShardedGlobeSim`` / ``globe run --shards``), never in
``GlobeConfig``, so it cannot drift into ``as_dict()``.

How byte-identity holds, by construction:

* **The parent replicates the lockstep loop's boundary decisions
  exactly.** Every input to ``_skip_uninteresting`` lives on the
  parent or in state that cannot change while a shard is idle:
  arrivals, chaos, front-door queue, each shard's merged
  :class:`~kind_tpu_sim_torch.fleet.events.DueSet` (refreshed post-step,
  and cell event horizons only move when a cell is stepped or takes
  an op — both of which refresh the cache), and a parent-side
  mirror of every cell's tick-grid index for autoscaler cadence
  (``B - tick_debt``: boundaries completed, minus boundaries missed
  while dead).
* **A stepped boundary dispatches one window job per shard that
  needs it** (pending ops, due work, or an eval-due cell); the
  others are provably no-ops — the event core's partition
  invariance argument applied per shard. Each worker advances its
  clock by the owed tick count (the identical tick-sized float
  additions, so worker and parent clocks agree bit-for-bit),
  applies queued ops in parent call order, then delivers and steps
  its cells in name order.
* **Completion merge order matches lockstep.** A completion with
  finish time t is observed at the unique grid boundary b with
  b < t <= b + tick in EVERY mode (``cell.step(b, tick)`` processes
  ``(b, b+tick]`` and the cover bound forces b to be stepped), so
  concatenating the stepped shards' completion buffers and stable
  sorting by global cell index reproduces the lockstep sequence:
  per boundary, cells in name order, hook-call order within a cell.
  The parent then applies the unchanged ``_completion_hook`` to
  each record (log, SLO trackers, front-door feedback all live on
  the parent).
* **Chaos is a synchronization point.** ``cell.fail`` needs its
  displaced load immediately (the herd re-enters the front door at
  the same boundary), so a proxy ``fail`` flushes the shard's
  pending ops plus the fail in one synchronous job; restore /
  drain / warm / admit ride the ordered per-shard op queue into the
  next window. Alive status therefore only changes at boundaries
  both sides observe.

Worker crashes are survivable and invisible in the report: every
job is journaled per shard, and a crashed worker is respawned (with
any injected ``CHAOS_FAULT`` env stripped, so a crash fault cannot
re-fire during recovery) and replayed from genesis — determinism
makes the replayed answer THE answer.

Scaling honesty: each stepped boundary costs
one IPC round trip per dispatched shard, so sharding pays off when
per-boundary cell work dominates that round trip — many cells, or
heavy (scheduler-backed, large-replica) cells. For small globes the
single-process driver is faster; the columnar fleet state is where
the headline per-event cost win lives.

A shard worker imports this module, the globe, the analytic fleet and
the pool, and never torch: it is a cold worker, up in a fraction of a
second.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.analysis import knobs
from kind_tpu_sim_torch.fleet.autoscaler import AutoscalerConfig
from kind_tpu_sim_torch.fleet.events import DueSet
from kind_tpu_sim_torch.fleet.loadgen import TraceRequest, VirtualClock
from kind_tpu_sim_torch.fleet.router import SimReplicaConfig
from kind_tpu_sim_torch.fleet.sim import resolve_tick_s
from kind_tpu_sim_torch.fleet.slo import SloPolicy
from kind_tpu_sim_torch.globe.cell import Cell, CellConfig
from kind_tpu_sim_torch.globe.sim import (
    GlobeConfig,
    GlobeSim,
    fleet_config_for,
)
from kind_tpu_sim_torch.utils import worker_pool as wp

_INF = float("inf")

# worker job targets, resolved by the pool's generic "call" job
_INIT = "kind_tpu_sim_torch.globe.shard:job_shard_init"
_WINDOW = "kind_tpu_sim_torch.globe.shard:job_shard_window"
_REPORT = "kind_tpu_sim_torch.globe.shard:job_shard_report"


def resolve_shards(value: Optional[int] = None) -> int:
    """Explicit value > env (KIND_TPU_SIM_GLOBE_SHARDS) > 0 (off)."""
    if value is not None:
        return int(value)
    return int(knobs.get(knobs.GLOBE_SHARDS))


# -- the wire copy of the config ---------------------------------------
#
# Only the fields cell construction consumes (fleet_config_for +
# cell naming); planner / overload / training / tenancy are rejected
# up front (v1) and the front door never leaves the parent.


def config_to_wire(cfg: GlobeConfig) -> dict:
    return {
        "zones": list(cfg.zones),
        "cells_per_zone": cfg.cells_per_zone,
        "replicas_per_cell": cfg.replicas_per_cell,
        "policy": cfg.policy,
        "tick_s": cfg.tick_s,
        "max_virtual_s": cfg.max_virtual_s,
        "sim": dataclasses.asdict(cfg.sim),
        "slo": dataclasses.asdict(cfg.slo),
        "sched": cfg.sched,
        "sched_policy": cfg.sched_policy,
        "cell_pods": ([list(p) for p in cfg.cell_pods]
                      if cfg.cell_pods is not None else None),
        "autoscale": cfg.autoscale,
        "autoscaler": dataclasses.asdict(cfg.autoscaler),
    }


def config_from_wire(d: dict) -> GlobeConfig:
    return GlobeConfig(
        zones=tuple(d["zones"]),
        cells_per_zone=d["cells_per_zone"],
        replicas_per_cell=d["replicas_per_cell"],
        policy=d["policy"],
        tick_s=d["tick_s"],
        max_virtual_s=d["max_virtual_s"],
        sim=SimReplicaConfig(**d["sim"]),
        slo=SloPolicy(**d["slo"]),
        sched=d["sched"],
        sched_policy=d["sched_policy"],
        cell_pods=(tuple(tuple(p) for p in d["cell_pods"])
                   if d["cell_pods"] is not None else None),
        autoscale=d["autoscale"],
        autoscaler=AutoscalerConfig(**d["autoscaler"]))


# -- worker side -------------------------------------------------------
#
# One session per worker process, holding this shard's cells on a
# private VirtualClock kept bit-identical to the parent's (the same
# chain of tick-sized additions from 0.0). The tick-grid contract:
# every cell's ``_ticks`` must count every completed boundary of its
# alive spans, exactly once — ``step`` counts a stepped landing
# boundary, the advance loop counts interior boundaries, and the
# ``uncounted`` flag settles a landing boundary this shard was never
# stepped at (chaos-only jobs, or a skipped boundary-0) when the
# next job advances away from it.

_SESSION: Optional[dict] = None


def _buffer_hook(buf: List[dict], ci: int):
    def hook(entry: dict, comp) -> None:
        buf.append({
            "ci": ci,
            "entry": entry,
            "req": comp.request.as_dict(),
            "first_s": comp.first_s,
            "finish_s": comp.finish_s,
            "tokens": comp.tokens,
            "finish_reason": comp.finish_reason,
        })
    return hook


def _count_tick(cells: Sequence[Cell]) -> None:
    for cell in cells:
        if cell.alive:
            cell.sim._ticks += 1


def _snapshots(s: dict) -> List[list]:
    return [[ci, {"out": cell.outstanding(),
                  "routable": cell.routable_replicas(),
                  "quiescent": cell.quiescent()}]
            for ci, cell in zip(s["cis"], s["cells"])]


def _merged_due(s: dict) -> dict:
    due = DueSet()
    for cell in s["cells"]:
        due.merge(cell.event_due())
    return {"immediate": due.immediate,
            "ge": None if due.ge == _INF else due.ge,
            "cover": None if due.cover == _INF else due.cover}


def job_shard_init(cfg: dict, names: Sequence[str],
                   indices: Sequence[int], tick: float) -> dict:
    global _SESSION
    gcfg = config_from_wire(cfg)
    clock = VirtualClock()
    cells = [
        Cell(CellConfig(name=name, zone=name.split("/")[0],
                        fleet=fleet_config_for(
                            gcfg, name.split("/")[0])),
             clock)
        for name in names]
    buf: List[dict] = []
    cis = list(indices)
    for ci, cell in zip(cis, cells):
        cell.sim.on_complete = _buffer_hook(buf, ci)
    _SESSION = {
        "clock": clock, "tick": float(tick),
        "cells": cells, "cis": cis,
        "by_ci": dict(zip(cis, cells)),
        "buf": buf,
        # boundary 0 is the current landing and has not been
        # stepped here yet — see the tick-grid contract above
        "uncounted": True,
    }
    return {"eval_ticks": cells[0].sim._eval_ticks,
            "cells": _snapshots(_SESSION),
            "due": _merged_due(_SESSION)}


def job_shard_window(advance: int = 0, ops: Sequence[list] = (),
                     step: bool = True) -> dict:
    s = _SESSION
    assert s is not None, "job_shard_init must run first"
    clock, tick, cells = s["clock"], s["tick"], s["cells"]
    if advance and s["uncounted"]:
        # the boundary we are leaving was never stepped here;
        # count it now (alive status is unchanged since then —
        # it only moves via ops, and none arrived in between)
        _count_tick(cells)
        s["uncounted"] = False
    for i in range(advance):
        clock.advance(tick)
        if i < advance - 1:
            _count_tick(cells)
    now = clock.now()
    by_ci = s["by_ci"]
    displaced: List[list] = []
    for op in ops:
        kind, ci = op[0], op[1]
        cell = by_ci[ci]
        if kind == "admit":
            cell.admit(TraceRequest.from_dict(op[2]), op[3])
        elif kind == "warm":
            cell.warm_prefix(op[2])
        elif kind == "drain":
            cell.draining = bool(op[2])
        elif kind == "restore":
            cell.restore(op[2])
        elif kind == "fail":
            displaced.append(
                [ci, [r.as_dict() for r in cell.fail(op[2])]])
        else:
            raise ValueError(f"unknown shard op {kind!r}")
    if step:
        for cell in cells:
            cell.deliver_due(now)
            cell.step(now, tick)
        s["uncounted"] = False
    else:
        s["uncounted"] = True
    buf = s["buf"]
    completions = list(buf)
    buf.clear()
    resp = {"completions": completions,
            "cells": _snapshots(s),
            "due": _merged_due(s)}
    if displaced:
        resp["displaced"] = displaced
    return resp


def job_shard_report() -> List[list]:
    s = _SESSION
    assert s is not None, "job_shard_init must run first"
    return [[ci, cell.report()]
            for ci, cell in zip(s["cis"], s["cells"])]


# -- parent side -------------------------------------------------------


class _Comp:
    """The completion view ``_completion_hook`` reads, rebuilt from
    a streamed record."""

    __slots__ = ("request", "first_s", "finish_s", "tokens",
                 "finish_reason", "dispatch_s")

    def __init__(self, rec: dict):
        self.request = TraceRequest.from_dict(rec["req"])
        self.first_s = rec["first_s"]
        self.finish_s = rec["finish_s"]
        self.tokens = rec["tokens"]
        self.finish_reason = rec["finish_reason"]
        self.dispatch_s = None  # only read under overload (not in v1)


class _SimShim:
    """What ``_report`` peeks at through ``cell.sim`` — training is
    rejected up front in v1, so the trainer is always absent."""

    trainer = None


class _ShardHandle:
    """One worker process: its cells, op queue, owed clock advances,
    cached due horizon, and the replayable job journal."""

    __slots__ = ("index", "proc", "env", "cis",
                 "pending", "owed", "due", "journal",
                 "crashed", "sent")

    def __init__(self, index: int, env: Dict[str, str],
                 cis: List[int]):
        self.index = index
        self.env = env
        self.cis = cis
        self.proc = wp.PoolWorker(env)
        self.pending: List[list] = []
        self.owed = 0
        self.due: Tuple[bool, float, float] = (True, _INF, _INF)
        self.journal: List[Tuple[str, dict]] = []
        self.crashed = False
        self.sent = 0


class CellProxy:
    """Parent-side stand-in for a worker-resident cell: exactly the
    surface the front door, chaos, and the run loop touch. Counters
    are exact, not approximate — between a shard's stepped
    boundaries its cells only change through ops the proxy itself
    queued, so last-snapshot + queued-admits reproduces the worker
    value at every parent read."""

    __slots__ = ("_driver", "ci", "name", "zone", "_slots", "shard",
                 "sim", "alive", "_draining", "peak_outstanding",
                 "_out", "_admits", "_routable", "_quiescent",
                 "_routable_at_fail", "tick_debt", "_died_at",
                 "_report")

    def __init__(self, driver: "ShardedGlobeSim", ci: int,
                 name: str, slots: int):
        self._driver = driver
        self.ci = ci
        self.name = name
        self.zone = name.split("/")[0]
        self._slots = slots
        self.shard: Optional[_ShardHandle] = None
        self.sim = _SimShim()
        self.alive = True
        self._draining = False
        self.peak_outstanding = 0
        self._out = 0
        self._admits = 0
        self._routable = 0
        self._quiescent = True
        self._routable_at_fail = 0
        self.tick_debt = 0
        self._died_at = 0
        self._report: Optional[dict] = None

    # -- the front-door surface ---------------------------------------

    def outstanding(self) -> int:
        return self._out + self._admits

    def capacity(self) -> int:
        return self._routable * self._slots

    def routable_replicas(self) -> int:
        return self._routable

    def routable(self) -> bool:
        return (self.alive and not self._draining
                and self._routable > 0)

    def admit(self, req: TraceRequest, deliver_s: float) -> None:
        self._driver._enqueue(
            self, ["admit", self.ci, req.as_dict(), deliver_s])
        self._admits += 1
        out = self.outstanding()
        if out > self.peak_outstanding:
            # matches the worker cell exactly: both sides see the
            # identical admit/completion sequence at each boundary
            self.peak_outstanding = out

    def warm_prefix(self, group: int) -> None:
        self._driver._enqueue(self, ["warm", self.ci, group])

    # -- the chaos / loop surface -------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    @draining.setter
    def draining(self, flag: bool) -> None:
        flag = bool(flag)
        self._draining = flag
        self._driver._enqueue(self, ["drain", self.ci, flag])

    def quiescent(self) -> bool:
        return self._quiescent and self._admits == 0

    def fail(self, now: float) -> List[TraceRequest]:
        return self._driver._fail_cell(self, now)

    def restore(self, now: float) -> None:
        self._driver._restore_cell(self, now)

    def report(self) -> dict:
        assert self._report is not None, "report fetched post-run"
        return self._report


class ShardedGlobeSim(GlobeSim):
    """GlobeSim with worker-resident cells. Same constructor plus
    ``shards`` (None reads KIND_TPU_SIM_GLOBE_SHARDS); reports are
    byte-identical to the single-process driver — replaycheck's
    referee holds across shard counts and seeds."""

    def __init__(self, cfg: GlobeConfig, traces=None, seed=None,
                 chaos_events: Sequence = (),
                 shards: Optional[int] = None,
                 rpc_timeout_s: float = 600.0,
                 _test_kill: Optional[Tuple[int, int]] = None):
        for field, label in ((cfg.overload, "overload"),
                             (cfg.planner, "planner"),
                             (cfg.training, "training"),
                             (cfg.tenancy, "tenancy"),
                             (cfg.zoo, "zoo"),
                             (cfg.generations, "generations")):
            if field is not None:
                raise ValueError(
                    f"sharded GlobeSim does not support "
                    f"GlobeConfig.{label} yet — run the "
                    f"single-process driver")
        self._n_shards = max(1, resolve_shards(shards))
        self._rpc_timeout_s = rpc_timeout_s
        # test hook: (shard index, nth job sent to it) — the parent
        # kills the worker after sending that job, exercising the
        # journal respawn+replay path mid-window
        self._test_kill = _test_kill
        self._seq = 0
        self._boundaries = 0  # completed grid boundaries (B)
        self._shards: List[_ShardHandle] = []
        self._proxies: List[CellProxy] = []
        self._eval_ticks = 1
        self._hooks: List = []
        self._closed = False
        super().__init__(cfg, traces=traces, seed=seed,
                         chaos_events=chaos_events)

    # -- construction --------------------------------------------------

    def _build_cells(self, training_cells: set) -> List[CellProxy]:
        names = self.cfg.cell_names()
        n = max(1, min(self._n_shards, len(names)))
        self._n_shards = n
        tick = resolve_tick_s(self.cfg.tick_s)
        slots = getattr(self.cfg.sim, "max_slots", 1)
        self._proxies = [CellProxy(self, ci, name, slots)
                         for ci, name in enumerate(names)]
        wire = config_to_wire(self.cfg)
        env = wp.pool_child_env(warm=False)
        self._shards = [
            _ShardHandle(s, env, list(range(s, len(names), n)))
            for s in range(n)]
        for sh in self._shards:
            for ci in sh.cis:
                self._proxies[ci].shard = sh
            self._send(sh, _INIT,
                       {"cfg": wire,
                        "names": [names[ci] for ci in sh.cis],
                        "indices": sh.cis, "tick": tick})
        for sh in self._shards:
            result = self._collect(sh)
            self._eval_ticks = result["eval_ticks"]
            self._absorb(sh, result)
        return self._proxies

    def _wire_cells(self) -> None:
        # completions stream back as records; the unchanged hook
        # runs on the parent against each one
        self._hooks = [self._completion_hook(c) for c in self.cells]

    # -- the journaled RPC layer --------------------------------------

    def _request(self, sh: _ShardHandle, target: str,
                 kwargs: dict) -> dict:
        self._seq += 1
        req = {"id": self._seq, "job": "call",
               "kwargs": {"target": target, "kwargs": kwargs}}
        deadline = (time.monotonic()  # detlint: ok(wallclock) -- subprocess IO deadline, never feeds the report
                    + self._rpc_timeout_s)
        sh.proc.ensure_ready(deadline)
        sh.proc.send(req)
        resp = sh.proc.read_frame(deadline)
        if not resp.get("ok"):
            raise RuntimeError(
                f"globe shard {sh.index} job failed: "
                f"{resp.get('error')}\n{resp.get('traceback', '')}")
        return resp["result"]

    def _send(self, sh: _ShardHandle, target: str,
              kwargs: dict) -> None:
        """Journal and dispatch one job; a dead pipe is noted, not
        raised — ``_collect`` runs the recovery."""
        sh.journal.append((target, kwargs))
        sh.sent += 1
        self._seq += 1
        req = {"id": self._seq, "job": "call",
               "kwargs": {"target": target, "kwargs": kwargs}}
        deadline = (time.monotonic()  # detlint: ok(wallclock) -- subprocess IO deadline, never feeds the report
                    + self._rpc_timeout_s)
        try:
            sh.proc.ensure_ready(deadline)
            sh.proc.send(req)
            if (self._test_kill is not None
                    and self._test_kill == (sh.index, sh.sent)):
                self._test_kill = None
                sh.proc.kill()
        except wp.WorkerCrash:
            sh.crashed = True

    def _collect(self, sh: _ShardHandle) -> dict:
        if sh.crashed:
            sh.crashed = False
            return self._respawn_replay(sh)
        deadline = (time.monotonic()  # detlint: ok(wallclock) -- subprocess IO deadline, never feeds the report
                    + self._rpc_timeout_s)
        try:
            resp = sh.proc.read_frame(deadline)
        except (wp.WorkerCrash, TimeoutError):
            return self._respawn_replay(sh)
        if not resp.get("ok"):
            raise RuntimeError(
                f"globe shard {sh.index} job failed: "
                f"{resp.get('error')}\n{resp.get('traceback', '')}")
        return resp["result"]

    def _respawn_replay(self, sh: _ShardHandle) -> dict:
        """Fresh process, journal replayed from genesis; the final
        replayed job is the one that crashed, and determinism makes
        its replayed answer THE answer."""
        try:
            sh.proc.kill()
        except Exception:
            pass
        env = dict(sh.env)
        # an env-injected crash fault would re-fire at the same job
        # number forever; a respawn heals (run_grid does the same)
        env.pop(wp.CHAOS_FAULT_ENV, None)
        sh.proc = wp.PoolWorker(env)
        metrics.recovery_log().record(
            "globe_shard_respawn", shard=sh.index,
            jobs=len(sh.journal))
        last: Optional[dict] = None
        for target, kwargs in sh.journal:
            last = self._request(sh, target, kwargs)
        assert last is not None
        return last

    # -- proxy callbacks ----------------------------------------------

    def _enqueue(self, proxy: CellProxy, op: list) -> None:
        proxy.shard.pending.append(op)

    def _fail_cell(self, proxy: CellProxy,
                   now: float) -> List[TraceRequest]:
        """Synchronous: the displaced load re-enters the front door
        at this same boundary, so the shard settles its queued ops
        plus the fail before the parent proceeds."""
        sh = proxy.shard
        proxy._routable_at_fail = proxy._routable
        ops = sh.pending + [["fail", proxy.ci, now]]
        sh.pending = []
        kwargs = {"advance": sh.owed, "ops": ops, "step": False}
        sh.owed = 0
        self._send(sh, _WINDOW, kwargs)
        result = self._collect(sh)
        self._absorb(sh, result)
        proxy.alive = False
        proxy._died_at = self._boundaries
        for ci, reqs in result.get("displaced", ()):
            if ci == proxy.ci:
                return [TraceRequest.from_dict(d) for d in reqs]
        return []

    def _restore_cell(self, proxy: CellProxy, now: float) -> None:
        self._enqueue(proxy, ["restore", proxy.ci, now])
        proxy.alive = True
        # frozen while dead in BOTH drivers: the missed boundaries
        # become debt so autoscaler cadence lands identically
        proxy.tick_debt += self._boundaries - proxy._died_at
        # cell.restore heals every replica; membership cannot have
        # changed while dead (dead cells are never stepped)
        proxy._routable = proxy._routable_at_fail
        proxy._quiescent = True

    # -- the sharded loop ---------------------------------------------

    def _absorb(self, sh: _ShardHandle, result: dict) -> None:
        for ci, snap in result["cells"]:
            p = self._proxies[ci]
            p._out = snap["out"]
            p._admits = 0
            p._routable = snap["routable"]
            p._quiescent = snap["quiescent"]
        d = result["due"]
        sh.due = (bool(d["immediate"]),
                  _INF if d["ge"] is None else d["ge"],
                  _INF if d["cover"] is None else d["cover"])

    def _eval_due(self, proxy: CellProxy) -> bool:
        """Mirror of the pre-step ``_ticks % _eval_ticks == 0``
        check in fleet/sim.py: this cell's tick index is
        B - tick_debt (boundaries completed minus boundaries missed
        while dead)."""
        return ((self._boundaries - proxy.tick_debt)
                % self._eval_ticks == 0)

    def _step_boundary(self, now: float, tick: float) -> None:
        autoscale = self.cfg.autoscale
        todo = []
        for sh in self._shards:
            need = bool(sh.pending)
            if not need:
                im, ge, cover = sh.due
                need = im or ge <= now or cover <= now + tick
            if not need and autoscale:
                for ci in sh.cis:
                    p = self._proxies[ci]
                    if p.alive and self._eval_due(p):
                        need = True
                        break
            if need:
                todo.append(sh)
        if not todo:
            return
        for sh in todo:
            kwargs = {"advance": sh.owed, "ops": sh.pending,
                      "step": True}
            sh.owed = 0
            sh.pending = []
            self._send(sh, _WINDOW, kwargs)
        recs: List[dict] = []
        for sh in todo:
            result = self._collect(sh)
            self._absorb(sh, result)
            recs.extend(result["completions"])
        # lockstep observes completions per boundary, cells in name
        # order, hook-call order within a cell; a stable sort of the
        # per-shard buffers by global cell index reproduces it
        recs.sort(key=lambda r: r["ci"])
        for rec in recs:
            self._hooks[rec["ci"]](rec["entry"], _Comp(rec))

    def _advance_sharded(self, tick: float) -> None:
        """The ``_advance`` + ``_skip_uninteresting`` mirror: the
        identical dense-path exits and skip-loop break conditions,
        fed from cached shard DueSets and the parent tick mirror
        (no per-boundary scan backoff — an extra stepped boundary
        is semantically invisible, so the heuristic need not be
        replicated)."""
        self._boundaries += 1
        self.clock.advance(tick)
        for sh in self._shards:
            sh.owed += 1
        b = self.clock.now()
        if self._arrivals and self._arrivals[0][0].arrival_s <= b:
            return
        if self.chaos_events and self.chaos_events[0].at_s <= b:
            return
        if self.frontdoor.queue:
            return
        due_im = False
        due_ge = _INF
        due_cover = _INF
        if self._arrivals:
            due_ge = min(due_ge, self._arrivals[0][0].arrival_s)
        if self.chaos_events:
            due_ge = min(due_ge, self.chaos_events[0].at_s)
        for sh in self._shards:
            im, ge, cover = sh.due
            due_im = due_im or im
            due_ge = min(due_ge, ge)
            due_cover = min(due_cover, cover)
        evals_away = -1
        if self.cfg.autoscale:
            e = self._eval_ticks
            base = self._boundaries
            for p in self._proxies:
                if p.alive:
                    away = (e - ((base - p.tick_debt) % e)) % e
                    if evals_away < 0 or away < evals_away:
                        evals_away = away
        if due_im or evals_away == 0:
            return
        limit = self.cfg.max_virtual_s
        adv = self.clock.advance
        nowf = self.clock.now
        shards = self._shards
        skipped = 0
        while True:
            bb = nowf()
            if bb > limit or due_ge <= bb or due_cover <= bb + tick:
                break
            adv(tick)
            self._boundaries += 1
            for sh in shards:
                sh.owed += 1
            skipped += 1
            if evals_away > 0:
                evals_away -= 1
                if evals_away == 0:
                    break
        self.ev_skipped += skipped

    def run(self) -> Dict[str, object]:
        board_before = metrics.globe_board().counts()
        tick = resolve_tick_s(self.cfg.tick_s)
        for zone, reqs in self.traces.items():
            for req in reqs:
                self._origin[req.request_id] = zone
        try:
            while True:
                now = self.clock.now()
                if now > self.cfg.max_virtual_s:
                    break
                self._apply_chaos(now)
                while (self._arrivals
                       and self._arrivals[0][0].arrival_s <= now):
                    req, origin = self._arrivals.popleft()
                    shed = self.frontdoor.offer(req, origin, now)
                    if shed is not None:
                        self._record_frontdoor_shed(req, origin,
                                                    now)
                self.frontdoor.pump(now)
                self._step_boundary(now, tick)
                if self._done():
                    break
                self._advance_sharded(tick)
            self._fetch_reports()
        finally:
            self.close()
        self.log.sort(key=lambda e: (e["finish_s"],
                                     e["request_id"]))
        return self._report(board_before)

    def _fetch_reports(self) -> None:
        for sh in self._shards:
            self._send(sh, _REPORT, {})
        for sh in self._shards:
            for ci, rep in self._collect(sh):
                self._proxies[ci]._report = rep

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for sh in self._shards:
            try:
                sh.proc.shutdown(grace_s=0.5)
            except Exception:
                pass

    def __del__(self):  # best-effort; run() closes on all paths
        try:
            self.close()
        except Exception:
            pass
