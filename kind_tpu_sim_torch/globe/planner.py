"""The global capacity planner: reserved vs spot across zones (the
port's copy of ``kind_tpu_sim/globe/planner.py``).

Sits ABOVE the per-cell autoscalers (docs/GLOBE.md). Each cell's
autoscaler still makes the local scale-up/scale-down calls — but its
ceiling is no longer a static config: every cell permanently owns its
**reserved** pool (the autoscaler's ``min_replicas`` floor — capacity
you paid for up front), while a shared **spot/preemptible** budget of
replicas moves between cells as demand does. A cell under backlog
pressure is granted spot replicas (its autoscaler cap rises and the
local autoscaler does the actual scale-up, paying the usual placement
+ warm-up); a cell that has gone quiet hands its grant back once it
has actually shrunk beneath it (reclaim never displaces running
work — spot here is preemptible at the PLANNING tier, not a kill
switch). With follow-the-sun diurnal zones, the budget provably
follows the peak around the planet, which is the whole economic
argument for spot capacity.

Deterministic: cells are evaluated in (pressure, name) order on a
fixed virtual-time cadence; the grant ledger is part of the globe
report and replays byte-identically.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch.globe.cell import Cell


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    # spot replicas shared across every cell (the global chip budget
    # expressed in replica units; chips = replicas x slice size)
    spot_budget: int = 4
    eval_every_s: float = 0.5
    # backlog per routable replica that earns a cell a spot grant
    up_backlog: float = 4.0
    # ... and the calm level below which its grant is reclaimed
    down_backlog: float = 0.5

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class GlobalPlanner:
    """Pure decision logic over the cells' observable state: the
    globe driver calls :meth:`evaluate` on the cadence; grants are
    enacted by raising/lowering each cell autoscaler's
    ``max_replicas`` cap in place."""

    def __init__(self, cfg: PlannerConfig, cells: Sequence[Cell]):
        self.cfg = cfg
        self.cells = [c for c in cells
                      if c.sim.autoscaler is not None]
        self.grants: Dict[str, int] = {c.name: 0 for c in self.cells}
        self.reserved: Dict[str, int] = {
            c.name: c.sim.autoscaler.cfg.min_replicas
            for c in self.cells}
        # training tenants (docs/TRAINING.md): cells whose fleets
        # run an elastic training tenancy can consume IDLE spot
        # budget as growth rungs — and hand it back (shrink, never
        # abort) when serving pressure wants the budget
        self.train_cells = [c for c in cells
                            if c.sim.trainer is not None]
        self.train_grants: Dict[str, int] = {
            c.name: 0 for c in self.train_cells}
        self.events: List[dict] = []
        # pin every managed cell's starting cap to its reserved
        # floor: capacity beyond it must be granted from the budget
        for cell in self.cells:
            self._set_cap(cell)

    def _set_cap(self, cell: Cell) -> None:
        scaler = cell.sim.autoscaler
        cap = self.reserved[cell.name] + self.grants[cell.name]
        scaler.cfg = dataclasses.replace(scaler.cfg,
                                         max_replicas=cap)

    def budget_left(self) -> int:
        return (self.cfg.spot_budget - sum(self.grants.values())
                - sum(self.train_grants.values()))

    @staticmethod
    def _pressure(cell: Cell) -> float:
        backlog = (len(cell.sim.router.queue) + len(cell.pending)
                   + sum(r.outstanding()
                         for r in cell.sim.replicas if r.healthy))
        return backlog / max(1, cell.routable_replicas())

    def _event(self, now: float, action: str, cell: Cell) -> None:
        ev = {
            "at_s": round(now, 6), "action": action,
            "cell": cell.name,
            "grants": self.grants.get(cell.name, 0),
            "budget_left": self.budget_left()}
        if action.startswith("train_"):
            ev["train_grants"] = self.train_grants[cell.name]
        self.events.append(ev)
        metrics.globe_board().incr(f"planner_{action}s")

    def _settle_training(self, now: float) -> None:
        """Training-rung settlement: a tenant asked to shrink hands
        its rung back only once the shrink actually happened
        (reclaim never aborts — the planner reads the tenant's own
        outstanding-grant count, it does not seize capacity)."""
        for cell in self.train_cells:
            trainer = cell.sim.trainer
            granted = self.train_grants[cell.name]
            if trainer.spot_granted < granted:
                self.train_grants[cell.name] = trainer.spot_granted
                self._event(now, "train_return", cell)

    def evaluate(self, now: float) -> None:
        """One planning pass: settle training rungs, reclaim from
        the calm, then grant to the pressured — reclaim first so a
        budget freed in zone A's evening is grantable in zone B's
        morning within the same pass (the sun does not wait a
        cadence). Serving outranks training: under serving pressure
        with an empty budget, training rungs are reclaimed FIRST
        (the tenant shrinks at its next checkpointed repartition);
        leftover budget after every serving need is met flows to
        elastic training as growth rungs — spot capacity never
        idles while a tenant could use it."""
        self._settle_training(now)
        by_calm = sorted(self.cells,
                         key=lambda c: (self._pressure(c), c.name))
        for cell in by_calm:
            grant = self.grants[cell.name]
            if grant <= 0:
                continue
            # only reclaim capacity the cell has actually vacated:
            # the local autoscaler drains first, the planner takes
            # the replica back after — spot reclaim never displaces
            if (self._pressure(cell) < self.cfg.down_backlog
                    and len(cell.sim.replicas)
                    <= self.reserved[cell.name] + grant - 1):
                self.grants[cell.name] = grant - 1
                self._set_cap(cell)
                self._event(now, "reclaim", cell)
        pressured = [c for c in self.cells if c.alive
                     and self._pressure(c) > self.cfg.up_backlog]
        if pressured and self.budget_left() <= 0:
            # serving wants budget and none is free: pull training
            # rungs back, most-granted tenant first (name tiebreak)
            for cell in sorted(
                    self.train_cells,
                    key=lambda c: (-self.train_grants[c.name],
                                   c.name)):
                if self.train_grants[cell.name] <= 0:
                    continue
                cell.sim.trainer.reclaim_spot(now)
                self._event(now, "train_reclaim", cell)
                break
        for cell in sorted(self.cells,
                           key=lambda c: (-self._pressure(c),
                                          c.name)):
            if self.budget_left() <= 0:
                break
            if not cell.alive:
                continue
            if self._pressure(cell) > self.cfg.up_backlog:
                self.grants[cell.name] += 1
                self._set_cap(cell)
                self._event(now, "grant", cell)
        if not pressured:
            # idle budget flows to elastic training (growth rungs)
            for cell in sorted(self.train_cells,
                               key=lambda c: c.name):
                if self.budget_left() <= 0:
                    break
                if not cell.alive:
                    continue
                trainer = cell.sim.trainer
                if (trainer.wants_spot()
                        and trainer.spot_granted
                        == self.train_grants[cell.name]):
                    trainer.grant_spot(now)
                    self.train_grants[cell.name] += 1
                    self._event(now, "train_grant", cell)

    def active(self) -> bool:
        """Whether a future evaluation could still act — the globe's
        fast-forward must not skip evals that would reclaim."""
        return (any(g > 0 for g in self.grants.values())
                or any(g > 0 for g in self.train_grants.values()))

    def report(self) -> Dict[str, object]:
        out = {
            "spot_budget": self.cfg.spot_budget,
            "budget_left": self.budget_left(),
            "reserved": dict(sorted(self.reserved.items())),
            "grants": dict(sorted(self.grants.items())),
            "events": self.events,
        }
        if self.train_cells:
            out["train_grants"] = dict(
                sorted(self.train_grants.items()))
        return out
