"""Training as a first-class fleet tenant (docs/TRAINING.md).

The port's copy of ``kind_tpu_sim/fleet/training.py``, the kube manifest
round trip included (``gangs_from_manifest`` / ``to_manifest``). The gangs are analytic: step time, the ring all-reduce and the loss
curve are closed forms that put no work on a device.

The tenant class the scheduler's strict-priority preemption, defrag and
chaos machinery were built for: a **training gang** is a long-running
scheduler-placed workload with a throughput SLO (work units per virtual second,
time-to-completion) co-scheduled UNDER serving — serving replicas run
at priority 10, training gangs default to the batch tier's -10
(``pods/tpu-batch-train-job.yaml``), so a serving scale-up evicts
training first and training only ever scavenges what serving leaves.

Three pieces:

* **Step model** — a gang steps in CLOSED FORM on the event core:
  step time = perfectly-scaling compute share / chips + the ring
  all-reduce of the gradient exchange over the gang's ICI block
  (:func:`kind_tpu_sim_torch.parallel.collectives.ring_allreduce_s`, the
  same slowest-link model the gray-failure math uses), sized from a
  logical GSPMD mesh (:func:`gang_mesh` — the NamedSharding
  ``(data, model)`` mesh shape of SNIPPETS [1]/[3], derived from
  :mod:`kind_tpu_sim_torch.topology` exactly as `parallel/mesh.py` derives
  device meshes). Advancing a segment in one call or a hundred
  produces identical floats — the partition invariance the event
  core (docs/PERFORMANCE.md) rests on. The non-LLM tenant kind
  (``ising`` — Monte-Carlo Ising sweeps, PAPERS.md 1903.11714) is
  all-throughput/no-latency and nearly collective-free, so it ships
  sub-host chip-granular gangs that stress binpack/defrag in ways a
  latency tenant cannot.

* **Checkpoint economics** — the cadence knob trades checkpoint
  write cost against expected lost-step work under the measured
  preemption rate (:func:`optimal_cadence_steps` is the Young-Daly
  optimum; :func:`expected_overhead` prices any cadence). Graceful
  preemption (``replica_preempt`` displacement, ``node_drain``,
  ``node_fail``, zone loss, spot reclaim) follows
  ``models/checkpoint.PreemptionGuard`` semantics: checkpoint at the
  current (last completed) step -> evict -> reschedule -> resume
  bit-identical, so ZERO counted steps are ever lost; a HARD kill
  (``train_kill`` — no 30s grace) rolls back to the last cadence
  checkpoint and re-runs the gap, which is exactly the work the
  cadence is priced against. The **progress ledger** records every
  run segment, checkpoint, rollback, and resize;
  :func:`verify_ledger` machine-checks zero-lost/zero-duplicated
  against it.

* **Elasticity** — an elastic gang grows onto scavenged capacity
  (free inventory, or a spot grant from the globe planner,
  docs/GLOBE.md) by a checkpointed repartition: checkpoint -> evict
  -> resubmit at the doubled topology -> resume with a modeled
  restart cost; on reclaim it shrinks back toward its base shape —
  shrink-never-abort, the gang always finishes.

Determinism: no wall clock, no entropy — every number is a pure
function of (config, virtual time); the loss trajectory itself is a
seeded closed form (:meth:`TrainingGang.loss_at`) so resume
bit-identity is testable without a model.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, Optional, Tuple

from kind_tpu_sim_torch import metrics
from kind_tpu_sim_torch import topology as topo
from kind_tpu_sim_torch.analysis import knobs
from kind_tpu_sim_torch.parallel import collectives

TRAIN_KINDS = ("llm", "ising")

CKPT_EVERY_ENV = knobs.TRAIN_CKPT_EVERY
CKPT_WRITE_ENV = knobs.TRAIN_CKPT_WRITE_S
RESTART_ENV = knobs.TRAIN_RESTART_S
MTBF_ENV = knobs.TRAIN_MTBF_S
ELASTIC_ENV = knobs.TRAIN_ELASTIC

# scheduler gang-name prefix: keeps the training namespace disjoint
# from the serving fleet's "replica-N" gangs
GANG_PREFIX = "train-"


def resolve_ckpt_write_s(value: Optional[float] = None) -> float:
    """Explicit value > env (KIND_TPU_SIM_TRAIN_CKPT_WRITE_S) >
    0.05."""
    if value is not None:
        return float(value)
    return float(knobs.get(CKPT_WRITE_ENV))


def resolve_restart_s(value: Optional[float] = None) -> float:
    """Explicit value > env (KIND_TPU_SIM_TRAIN_RESTART_S) > 0.2."""
    if value is not None:
        return float(value)
    return float(knobs.get(RESTART_ENV))


def resolve_mtbf_s(value: Optional[float] = None) -> float:
    """Explicit value > env (KIND_TPU_SIM_TRAIN_MTBF_S) > 60."""
    if value is not None:
        return float(value)
    return float(knobs.get(MTBF_ENV))


def resolve_elastic(value: Optional[bool] = None) -> bool:
    """Explicit value > env (KIND_TPU_SIM_TRAIN_ELASTIC) > on."""
    if value is not None:
        return bool(value)
    return bool(knobs.get(ELASTIC_ENV))


# -- the GSPMD mesh + step model ---------------------------------------


def gang_mesh(accelerator: str, topology_str: str,
              kind: str = "llm") -> Dict[str, int]:
    """Logical GSPMD mesh for a gang's ICI block — the NamedSharding
    mesh shape (SNIPPETS [1]/[3]) the gang's train step would run
    under, derived from :class:`~kind_tpu_sim_torch.topology.SliceTopology`
    the same way ``parallel/mesh.py`` derives device meshes. LLM
    gangs shard ``(data, model)`` = (hosts, chips-per-host): data-
    parallel across hosts (the gradient ring crosses ICI), model-
    parallel within a host. Ising sweeps are embarrassingly parallel
    — one ``batch`` axis over every chip, no meaningful collective.
    """
    if kind not in TRAIN_KINDS:
        raise ValueError(
            f"unknown training kind {kind!r}; known: "
            f"{', '.join(TRAIN_KINDS)}")
    s = topo.make_slice(accelerator, topology_str)
    if kind == "ising":
        return {"batch": s.num_chips}
    return {"data": s.num_hosts, "model": s.chips_per_host}


@dataclasses.dataclass(frozen=True)
class TrainingGangConfig:
    """One training tenant. ``topology`` is the base ICI block the
    gang is submitted at; an elastic gang may grow up to
    ``max_topology`` (doubling the last dimension per step) and
    shrinks back toward the base on reclaim. ``step_compute_chip_s``
    is the perfectly-scaling per-step compute on ONE chip;
    ``allreduce_bytes`` is the per-step gradient exchange the ring
    model prices over the gang's hosts. ``work_per_step`` /
    ``work_unit`` are the throughput SLO's reporting units (tokens
    for LLM, lattice sweeps for Ising)."""

    name: str
    kind: str = "llm"
    accelerator: str = topo.DEFAULT_ACCELERATOR
    topology: str = "4x4"
    priority: int = -10
    arrival_s: float = 0.0
    total_steps: int = 120
    step_compute_chip_s: float = 0.4
    allreduce_bytes: float = 100e6
    work_per_step: float = 65536.0
    work_unit: str = "tok"
    checkpoint_every: Optional[int] = None  # None -> knob (0=auto)
    checkpoint_write_s: Optional[float] = None
    restart_s: Optional[float] = None
    elastic: bool = False
    max_topology: Optional[str] = None
    loss_seed: int = 0

    def __post_init__(self) -> None:
        if self.kind not in TRAIN_KINDS:
            raise ValueError(
                f"unknown training kind {self.kind!r}; known: "
                f"{', '.join(TRAIN_KINDS)}")
        topo.make_slice(self.accelerator, self.topology)
        if self.max_topology is not None:
            topo.make_slice(self.accelerator, self.max_topology)
        if self.total_steps <= 0:
            raise ValueError("total_steps must be > 0")

    def as_dict(self) -> dict:
        out = {
            "name": self.name,
            "kind": self.kind,
            "accelerator": self.accelerator,
            "topology": self.topology,
            "priority": self.priority,
            "arrival_s": round(self.arrival_s, 6),
            "total_steps": self.total_steps,
            "step_compute_chip_s": self.step_compute_chip_s,
            "allreduce_bytes": self.allreduce_bytes,
            "work_per_step": self.work_per_step,
            "work_unit": self.work_unit,
            "elastic": self.elastic,
            "loss_seed": self.loss_seed,
        }
        if self.max_topology is not None:
            out["max_topology"] = self.max_topology
        if self.checkpoint_every is not None:
            out["checkpoint_every"] = self.checkpoint_every
        if self.checkpoint_write_s is not None:
            out["checkpoint_write_s"] = self.checkpoint_write_s
        if self.restart_s is not None:
            out["restart_s"] = self.restart_s
        return out


def ising_gang(name: str, **overrides) -> TrainingGangConfig:
    """An all-throughput Monte-Carlo Ising sweep tenant (PAPERS.md
    1903.11714): sub-host chip-granular (binpack fodder — it fits in
    fragments no gang block can use), essentially collective-free (a
    per-sweep scalar energy reduce), progress counted in lattice
    sweeps."""
    base = dict(kind="ising", topology="2x2",
                step_compute_chip_s=0.08, allreduce_bytes=8.0,
                work_per_step=1.0, work_unit="sweep")
    base.update(overrides)
    return TrainingGangConfig(name=name, **base)


def step_time_s(cfg: TrainingGangConfig, topology_str: str,
                link_factor: float = 1.0) -> float:
    """Closed-form per-step time of ``cfg`` on an ICI block of shape
    ``topology_str`` whose slowest link runs at ``link_factor`` of
    nominal: compute scales perfectly with chips (fixed global
    batch), the gradient ring runs over the block's hosts at the
    slowest link's pace. Single-host gangs pay no ring (intra-host
    bandwidth is not the modeled bottleneck) — which is exactly why
    the Ising tenant's placement is ICI-indifferent."""
    s = topo.make_slice(cfg.accelerator, topology_str)
    compute = cfg.step_compute_chip_s / s.num_chips
    ring = collectives.ring_allreduce_s(
        cfg.allreduce_bytes, s.num_hosts,
        link_factors=[link_factor], tier="ici")
    return compute + ring


def grow_topology(accelerator: str,
                  topology_str: str) -> Optional[str]:
    """The elastic ladder's next rung: double the last topology
    dimension (4x4 -> 4x8 -> 4x16). None when the doubled shape is
    not a valid slice of this accelerator."""
    dims = topo.parse_topology(topology_str)
    grown = dims[:-1] + (dims[-1] * 2,)
    try:
        topo.make_slice(accelerator, topo.format_topology(grown))
    except ValueError:
        return None
    return topo.format_topology(grown)


def shrink_topology(accelerator: str, topology_str: str,
                    floor: str) -> Optional[str]:
    """The ladder's previous rung (halve the last dimension), never
    below ``floor`` — shrink-never-abort means the base shape is the
    hard minimum."""
    dims = topo.parse_topology(topology_str)
    if dims[-1] % 2 != 0:
        return None
    shrunk = dims[:-1] + (dims[-1] // 2,)
    shrunk_str = topo.format_topology(shrunk)
    floor_chips = topo.make_slice(accelerator, floor).num_chips
    if topo.make_slice(accelerator, shrunk_str).num_chips \
            < floor_chips:
        return None
    return shrunk_str


# -- checkpoint economics ----------------------------------------------


def optimal_cadence_steps(step_s: float, ckpt_write_s: float,
                          mtbf_s: float) -> int:
    """The Young-Daly checkpoint interval, in steps: sqrt(2 * write
    cost * MTBF) of work between checkpoints minimizes (write
    overhead + expected re-run after a hard kill). Floored at one
    step."""
    if step_s <= 0:
        raise ValueError(f"step_s must be > 0; got {step_s}")
    interval_s = math.sqrt(2.0 * max(ckpt_write_s, 0.0)
                           * max(mtbf_s, 0.0))
    return max(1, int(round(interval_s / step_s)))


def expected_overhead(step_s: float, cadence_steps: int,
                      ckpt_write_s: float,
                      mtbf_s: float) -> Dict[str, float]:
    """The economics of one cadence choice: ``write_frac`` is time
    spent writing checkpoints per unit of work, ``lost_frac`` the
    expected re-run fraction under HARD kills at the given MTBF
    (half an interval plus one restart's worth of re-derivation on
    average), ``total_frac`` their sum — the number the cadence knob
    minimizes. Graceful preemptions (the PreemptionGuard path) cost
    restarts but never re-runs, so they are priced separately by the
    simulated runs themselves."""
    interval_s = cadence_steps * step_s
    write_frac = ckpt_write_s / (interval_s + ckpt_write_s)
    lost_frac = ((interval_s / 2.0 + ckpt_write_s)
                 / max(mtbf_s, 1e-9))
    return {
        "interval_s": round(interval_s, 6),
        "write_frac": round(write_frac, 6),
        "lost_frac": round(lost_frac, 6),
        "total_frac": round(write_frac + lost_frac, 6),
    }


# -- the ledger --------------------------------------------------------


def verify_ledger(ledger: List[dict],
                  total_steps: int) -> Dict[str, object]:
    """Machine-check the zero-lost / zero-duplicated contract
    against the gang's own progress ledger: replaying the segment /
    checkpoint / rollback records in order, every ``run`` segment
    must start exactly where committed progress stood (no gap =
    nothing silently lost, no overlap = nothing double-counted; an
    overlap is legal only as the re-run a ``rollback`` record
    explicitly opened). Returns unique/lost/re-run step counts and
    the violation list (empty = the contract held)."""
    committed = 0
    high_water = 0
    lost = 0
    rerun = 0
    violations: List[str] = []
    for rec in ledger:
        kind = rec.get("kind")
        if kind == "run":
            if rec["from_step"] != committed:
                violations.append(
                    f"segment at t0={rec['t0']} starts at step "
                    f"{rec['from_step']}, committed progress was "
                    f"{committed}")
            if rec["to_step"] < rec["from_step"]:
                violations.append(
                    f"segment at t0={rec['t0']} runs backwards")
            rerun += max(0, min(high_water, rec["to_step"])
                         - rec["from_step"])
            committed = rec["to_step"]
            high_water = max(high_water, committed)
        elif kind == "rollback":
            if rec["from_step"] != committed:
                violations.append(
                    f"rollback at {rec['at_s']} from step "
                    f"{rec['from_step']}, committed was {committed}")
            lost += rec["from_step"] - rec["to_step"]
            committed = rec["to_step"]
    if committed > total_steps:
        violations.append(
            f"committed {committed} > total {total_steps}")
    return {
        "ok": not violations,
        "unique_steps": committed,
        "lost_steps": lost,
        "rerun_steps": rerun,
        "violations": violations,
    }


# -- one gang ----------------------------------------------------------


class TrainingGang:
    """Runtime state of one gang: a closed-form segment timeline.

    Within one **segment** (one binding at one shape on one ICI
    domain) step completion times are an affine function of the step
    index — ``f(n) = n * step_s + (cadence checkpoints crossed) *
    write_s`` from the segment origin — so progress at any instant
    is computed by inverting ``f``, never by accumulating per-tick
    remainders (partition invariance). Every binding, checkpoint,
    rollback, and resize appends to the progress ledger."""

    def __init__(self, cfg: TrainingGangConfig, *,
                 ckpt_every: int, ckpt_write_s: float,
                 restart_s: float, elastic: bool):
        self.cfg = cfg
        self.ckpt_every = max(1, int(ckpt_every))
        self.ckpt_write_s = float(ckpt_write_s)
        self.restart_s = float(restart_s)
        self.elastic = bool(elastic and cfg.elastic)
        self.topology = cfg.topology
        self.state = "waiting"  # waiting|pending|running|done
        self.steps_done = 0
        self.high_water = 0
        self.last_ckpt_step = 0
        self.step_s: Optional[float] = None
        self.seg_t0: Optional[float] = None
        self.seg_step0 = 0
        self.done_s: Optional[float] = None
        self.first_bound_s: Optional[float] = None
        self.ledger: List[dict] = []
        self.ckpt_writes = 0
        self.ckpt_time_s = 0.0
        self.restart_time_s = 0.0
        self.evictions = 0
        self.migrations = 0
        self.grows = 0
        self.shrinks = 0
        self.lost_steps = 0
        # one growth rung per outstanding spot grant
        self.spot_rungs = 0
        # -- silent data corruption (docs/SDC.md): chip index ->
        # corrupt fraction for every live defective chip in the
        # gang; a defect PERSISTS until bisection names the chip
        # and quarantine pulls it
        self.sdc_chips: Dict[int, float] = {}
        # first step index whose loss the live defects perturb —
        # the closed-form detection event (None = clean horizon)
        self._sdc_spike_step: Optional[int] = None
        # named culprits (chip, detection step, bisection rounds)
        self.sdc_culprits: List[dict] = []
        # verdicts awaiting the fleet loop's quarantine drain
        self.sdc_verdicts_out: List[dict] = []

    # -- the closed-form timeline ---------------------------------

    def _ckpts_through(self, a: int, b: int) -> int:
        """Cadence checkpoints written after steps in (a, b] —
        mirrors ``train_with_checkpointing``'s ``done % every == 0``
        rule (the final step's own write is priced separately)."""
        every = self.ckpt_every
        return b // every - a // every

    def _f(self, n: int) -> float:
        """Virtual seconds from the segment origin to completion of
        the segment's n-th step: pure in n (a multiply each), never
        an accumulation — one call or a hundred land on identical
        floats."""
        if n <= 0:
            return 0.0
        writes = self._ckpts_through(self.seg_step0,
                                     self.seg_step0 + n - 1)
        return n * self.step_s + writes * self.ckpt_write_s

    def _steps_at(self, now: float) -> int:
        """Completed segment steps by ``now`` (clamped to the
        remaining work): largest n with f(n) <= elapsed, by binary
        search over the monotone closed form."""
        if self.seg_t0 is None or now < self.seg_t0:
            return 0
        elapsed = now - self.seg_t0
        lo, hi = 0, self.cfg.total_steps - self.seg_step0
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self._f(mid) <= elapsed:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def completion_s(self) -> Optional[float]:
        """The instant this segment would finish the gang (last step
        plus its final checkpoint write) — the event the core must
        step a boundary for. None unless running."""
        if self.state != "running":
            return None
        rem = self.cfg.total_steps - self.seg_step0
        return self.seg_t0 + self._f(rem) + self.ckpt_write_s

    def loss_at(self, step: int) -> float:
        """The gang's deterministic loss trajectory — a pure
        function of (loss_seed, step), which is exactly what makes
        resume bit-identity checkable: re-running a step after a
        resume MUST produce the identical float."""
        noise = zlib.crc32(
            f"{self.cfg.name}:{self.cfg.loss_seed}:{step}"
            .encode("utf-8")) / 2.0 ** 32
        loss = 4.0 / (1.0 + 0.05 * step) + 0.01 * noise
        if self._sdc_corrupts(step):
            # a defective chip perturbed this step's gradient: the
            # spike (+1.0 over a <=0.01 noise band) is what the
            # closed-form checker detects (docs/SDC.md)
            loss += 1.0
        return loss

    # -- silent data corruption (docs/SDC.md) ----------------------

    def _sdc_corrupts(self, step: int) -> bool:
        """Whether any LIVE defective chip corrupts ``step`` — a
        pure function of (gang name, chip, step, loss_seed, frac),
        so re-running the step during bisection reproduces the
        identical verdict."""
        for chip in sorted(self.sdc_chips):
            frac = self.sdc_chips[chip]
            draw = zlib.crc32(
                f"sdc:{self.cfg.name}:{chip}:{step}:"
                f"{self.cfg.loss_seed}".encode("utf-8")) / 2.0 ** 32
            if draw < frac:
                return True
        return False

    def _recompute_spike(self, from_step: int) -> None:
        """First corrupted step at or after ``from_step`` (bounded
        by total_steps) — the detection horizon advance() clamps
        segment progress against."""
        self._sdc_spike_step = None
        if not self.sdc_chips:
            return
        for step in range(max(1, from_step),
                          self.cfg.total_steps + 1):
            if self._sdc_corrupts(step):
                self._sdc_spike_step = step
                return

    def seed_defect(self, chip: int, frac: float,
                    now: float) -> None:
        """Chaos seeded a defective chip: from ``now`` on, a
        ``frac`` share of this gang's steps compute a silently wrong
        gradient. Progress through ``now`` commits clean first —
        the defect cannot retroactively corrupt finished work."""
        self.advance(now)
        if self.state == "done":
            return
        self.sdc_chips[int(chip)] = max(0.0, min(1.0, float(frac)))
        self._recompute_spike(self.steps_done + 1)

    def next_event_s(self) -> Optional[float]:
        """The segment's next boundary-condition instant for the
        event core: the SDC detection point when a spike is ahead
        (the loss checker fires there, docs/SDC.md), else the
        ordinary segment completion."""
        if self.state != "running":
            return None
        if self._sdc_spike_step is not None:
            return self.seg_t0 + self._f(
                self._sdc_spike_step - self.seg_step0)
        return self.completion_s()

    def _run_bisection(self, detect_step: int,
                       ts: float) -> Tuple[int, int, float]:
        """Deterministic culprit bisection: binary-search the gang's
        chip range by re-running the suspect segment (the rolled-
        back steps) on the candidate half-gang — the spike
        reproduces iff the defective chip is in the half, because
        :meth:`_sdc_corrupts` is a pure function of (chip, step).
        Every round is priced as REAL chip-seconds in the ledger
        (``bisect`` records). Returns (culprit chip, rounds, total
        re-run virtual seconds) — rounds <= ceil(log2(chips))."""
        chips = topo.make_slice(self.cfg.accelerator,
                                self.topology).num_chips
        culprit = min(self.sdc_chips)
        rerun = max(1, detect_step - self.last_ckpt_step)
        round_s = rerun * self.step_s
        lo, hi = 0, chips
        rounds = 0
        t = ts
        while hi - lo > 1:
            mid = (lo + hi) // 2
            hit = lo <= culprit < mid
            rounds += 1
            t += round_s
            self.ledger.append({
                "kind": "bisect", "round": rounds,
                "chips_lo": lo, "chips_hi": mid, "hit": hit,
                "steps": rerun,
                "chip_s": round(round_s * (mid - lo), 6),
                "at_s": round(t, 6),
            })
            metrics.integrity_board().incr("bisection_steps")
            if hit:
                hi = mid
            else:
                lo = mid
        return culprit, rounds, t - ts

    def _sdc_detect(self, spike_step: int, ts: float) -> None:
        """The loss checker fired at ``spike_step``'s completion:
        roll back to the last cadence checkpoint (PreemptionGuard
        semantics — the corrupted step itself never committed),
        bisect to the culprit chip, hand the verdict to the fleet
        loop's quarantine drain, and resume from the checkpoint
        with the defect retired."""
        self._close_segment(ts)
        lost = self.steps_done - self.last_ckpt_step
        if lost:
            self.ledger.append({
                "kind": "rollback",
                "from_step": self.steps_done,
                "to_step": self.last_ckpt_step,
                "at_s": round(ts, 6),
                "lost_steps": lost,
                "cause": "sdc",
            })
            self.lost_steps += lost
            self.steps_done = self.last_ckpt_step
            metrics.integrity_board().incr("steps_rolled_back",
                                           lost)
        metrics.integrity_board().incr("sdc_detections")
        culprit, rounds, bisect_s = self._run_bisection(
            spike_step, ts)
        frac = self.sdc_chips.pop(culprit)
        record = {
            "chip": culprit,
            "corrupt_frac": round(frac, 6),
            "detected_step": spike_step,
            "detected_at_s": round(ts, 6),
            "bisection_rounds": rounds,
            "lost_steps": lost,
        }
        self.sdc_culprits.append(record)
        self.sdc_verdicts_out.append(dict(record))
        resume = ts + bisect_s + self.restart_s
        self.restart_time_s += self.restart_s
        self.seg_t0 = resume
        self.seg_step0 = self.steps_done
        self.ledger.append({
            "kind": "sdc", "step": spike_step,
            "culprit_chip": culprit, "rounds": rounds,
            "at_s": round(ts, 6), "resume_s": round(resume, 6),
        })
        metrics.train_board().incr("sdc_detections")
        metrics.recovery_log().record(
            "train_sdc_detected", gang=self.cfg.name,
            step=spike_step, chip=culprit, rounds=rounds,
            at_s=round(ts, 6))
        self._recompute_spike(self.steps_done + 1)

    # -- lifecycle -------------------------------------------------

    def advance(self, now: float) -> None:
        """Commit progress through ``now``: closed-form step count,
        cadence checkpoint records for every boundary crossed, and
        the done transition (with its final checkpoint) when the
        last step lands. When a defective chip's loss spike lies in
        the window, the clean prefix commits first, the detection /
        rollback / bisection sequence runs at its closed-form
        instants, and the loop resumes committing in the reopened
        segment — one call or a hundred land on identical ledgers
        (partition invariance, docs/SDC.md)."""
        while self.state == "running":
            spike = self._sdc_spike_step
            if spike is None or self.seg_t0 is None:
                break
            rel = spike - self.seg_step0
            ts = self.seg_t0 + self._f(rel)
            if now < ts:
                break
            # commit exactly the clean prefix (through spike-1 —
            # the corrupted step itself must never commit), then
            # detect at the spike step's completion instant
            self._advance_core(self.seg_t0 + self._f(rel - 1))
            self._sdc_detect(spike, ts)
        self._advance_core(now)

    def _advance_core(self, now: float) -> None:
        if self.state != "running":
            return
        n = self._steps_at(now)
        new_done = self.seg_step0 + n
        if new_done > self.steps_done:
            every = self.ckpt_every
            first = (self.steps_done // every + 1) * every
            for c in range(first, new_done + 1, every):
                self.ledger.append({
                    "kind": "ckpt", "step": c,
                    "at_s": round(self.seg_t0
                                  + self._f(c - self.seg_step0), 6),
                    "write_s": self.ckpt_write_s,
                })
                self.ckpt_writes += 1
                self.ckpt_time_s += self.ckpt_write_s
                self.last_ckpt_step = c
            self.steps_done = new_done
            self.high_water = max(self.high_water, new_done)
        done_s = self.completion_s()
        if (self.steps_done >= self.cfg.total_steps
                and now >= done_s):
            self._close_segment(done_s)
            if self.last_ckpt_step < self.cfg.total_steps:
                self.ledger.append({
                    "kind": "ckpt",
                    "step": self.cfg.total_steps,
                    "at_s": round(done_s, 6),
                    "write_s": self.ckpt_write_s,
                })
                self.ckpt_writes += 1
                self.ckpt_time_s += self.ckpt_write_s
                self.last_ckpt_step = self.cfg.total_steps
            self.done_s = round(done_s, 6)
            self.state = "done"
            metrics.train_board().incr("gangs_done")

    def _close_segment(self, now: float) -> None:
        self.ledger.append({
            "kind": "run",
            "from_step": self.seg_step0,
            "to_step": self.steps_done,
            "t0": round(self.seg_t0, 6),
            "t1": round(now, 6),
            "topology": self.topology,
            "step_s": round(self.step_s, 9),
        })
        self.seg_t0 = None

    def preempt(self, now: float, graceful: bool,
                reason: str) -> None:
        """Displacement. Graceful = the PreemptionGuard contract
        (docs/CHAOS.md): the checkpoint lands at the current (last
        completed) step before the gang leaves the hardware, so
        resume loses nothing — the in-flight partial step never
        counted, and re-deriving it is not a re-count. Hard = a
        crash with no grace: progress rolls back to the last cadence
        checkpoint and the gap is priced as lost work (the quantity
        the cadence knob trades against write cost)."""
        if self.state != "running":
            return  # already displaced/queued (or done): a no-op
        self.advance(now)
        if self.state == "done":
            return
        self._close_segment(now)
        self.evictions += 1
        if graceful:
            if self.last_ckpt_step != self.steps_done:
                self.ledger.append({
                    "kind": "ckpt", "step": self.steps_done,
                    "at_s": round(now, 6),
                    "write_s": self.ckpt_write_s,
                    "cause": "preempt",
                })
                self.ckpt_writes += 1
                self.ckpt_time_s += self.ckpt_write_s
                self.last_ckpt_step = self.steps_done
            metrics.train_board().incr("graceful_preemptions")
        else:
            lost = self.steps_done - self.last_ckpt_step
            if lost:
                self.ledger.append({
                    "kind": "rollback",
                    "from_step": self.steps_done,
                    "to_step": self.last_ckpt_step,
                    "at_s": round(now, 6),
                    "lost_steps": lost,
                })
                self.lost_steps += lost
                self.steps_done = self.last_ckpt_step
            metrics.train_board().incr("hard_kills")
        self.ledger.append({
            "kind": "evict", "step": self.steps_done,
            "at_s": round(now, 6), "reason": reason,
            "graceful": graceful,
        })
        self.state = "pending"
        metrics.recovery_log().record(
            "train_gang_evict", gang=self.cfg.name,
            step=self.steps_done, graceful=graceful,
            at_s=round(now, 6))

    def bound(self, now: float, link_factor: float,
              bind_s: float) -> float:
        """The scheduler placed (or re-placed) the gang: stepping
        resumes from the committed step after bind latency plus the
        modeled restart cost (checkpoint load + collective re-init),
        at the step time of the NEW shape and domain. Returns the
        resume instant."""
        ready = now + bind_s + self.restart_s
        self.step_s = step_time_s(self.cfg, self.topology,
                                  link_factor)
        self.seg_t0 = ready
        self.seg_step0 = self.steps_done
        self.restart_time_s += self.restart_s
        if self.first_bound_s is None:
            self.first_bound_s = round(ready, 6)
        self.state = "running"
        # re-scan the corruption horizon from the resume step: a
        # re-placed gang keeps its live defects (the chips moved
        # with the topology — only quarantine retires one)
        self._recompute_spike(self.steps_done + 1)
        self.ledger.append({
            "kind": "bind", "step": self.steps_done,
            "at_s": round(now, 6), "resume_s": round(ready, 6),
            "topology": self.topology,
            "step_s": round(self.step_s, 9),
        })
        metrics.train_board().incr("gangs_bound")
        return ready

    def reprice(self, now: float, link_factor: float) -> None:
        """The domain's link state changed mid-segment (gray
        degrade/restore): commit progress, close the segment, and
        open a new one at the new step time from ``now`` — a pure
        rate change, no checkpoint and no restart cost."""
        if self.state != "running":
            return
        new_step_s = step_time_s(self.cfg, self.topology,
                                 link_factor)
        if self.step_s == new_step_s:
            return
        self.advance(now)
        if self.state != "running":
            return
        # resume from the NEXT whole-step boundary at the new rate:
        # the in-flight partial step re-derives at the new pace
        self._close_segment(now)
        self.step_s = new_step_s
        self.seg_t0 = now
        self.seg_step0 = self.steps_done
        self.ledger.append({
            "kind": "reprice", "step": self.steps_done,
            "at_s": round(now, 6),
            "step_s": round(new_step_s, 9),
        })

    # -- reporting -------------------------------------------------

    def work_done(self) -> float:
        return self.high_water * self.cfg.work_per_step

    def report(self) -> Dict[str, object]:
        verify = verify_ledger(self.ledger, self.cfg.total_steps)
        productive = sum(
            rec["t1"] - rec["t0"] for rec in self.ledger
            if rec.get("kind") == "run")
        overhead = self.ckpt_time_s + self.restart_time_s
        span = (self.done_s - self.cfg.arrival_s
                if self.done_s is not None else None)
        out: Dict[str, object] = {
            "config": self.cfg.as_dict(),
            "mesh": gang_mesh(self.cfg.accelerator, self.topology,
                              self.cfg.kind),
            "state": self.state,
            "topology": self.topology,
            "steps_done": self.steps_done,
            "unique_steps": self.high_water,
            "lost_steps": self.lost_steps,
            "rerun_steps": verify["rerun_steps"],
            "checkpoint": {
                "every": self.ckpt_every,
                "writes": self.ckpt_writes,
                "write_s": self.ckpt_write_s,
                "time_s": round(self.ckpt_time_s, 6),
            },
            "restart_time_s": round(self.restart_time_s, 6),
            "evictions": self.evictions,
            "migrations": self.migrations,
            "grows": self.grows,
            "shrinks": self.shrinks,
            "overhead_frac": (
                round(overhead / (productive + overhead), 6)
                if productive + overhead > 0 else 0.0),
            "ledger": self.ledger,
            "ledger_verify": verify,
        }
        if self.sdc_culprits or self.sdc_chips:
            # conditional: gangs that never saw an SDC fault keep
            # their historical report bytes
            out["sdc"] = {
                "culprits": self.sdc_culprits,
                "active_defects": sorted(self.sdc_chips),
                "bisection_rounds": sum(
                    c["bisection_rounds"]
                    for c in self.sdc_culprits),
            }
        if self.done_s is not None:
            out["done_s"] = self.done_s
            out["time_to_completion_s"] = round(span, 6)
            if span and span > 0:
                out["work_per_s"] = round(
                    self.work_done() / span, 3)
                out["work_unit"] = self.cfg.work_unit
        return out


# -- the tenant manager ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """The fleet's training tenancy: the gangs plus the economics
    defaults every gang inherits unless it overrides them.
    ``checkpoint_every`` 0 (or the knob's 0 default) derives the
    Young-Daly optimum per gang from its own step time."""

    gangs: Tuple[TrainingGangConfig, ...] = ()
    checkpoint_every: Optional[int] = None
    checkpoint_write_s: Optional[float] = None
    restart_s: Optional[float] = None
    mtbf_s: Optional[float] = None
    elastic: Optional[bool] = None
    # scavenge growth straight from free inventory (no planner in
    # the loop); spot-grant growth (docs/GLOBE.md) works either way
    scavenge: bool = False

    def as_dict(self) -> dict:
        return {
            "gangs": [g.as_dict() for g in self.gangs],
            "checkpoint_every": self.checkpoint_every,
            "checkpoint_write_s": resolve_ckpt_write_s(
                self.checkpoint_write_s),
            "restart_s": resolve_restart_s(self.restart_s),
            "mtbf_s": resolve_mtbf_s(self.mtbf_s),
            "elastic": resolve_elastic(self.elastic),
            "scavenge": self.scavenge,
        }


class TrainingTenant:
    """The training side of one scheduler-backed fleet: submits
    gangs at arrival, receives bind/evict callbacks from the fleet
    loop, applies chaos, runs the elastic ladder at evaluation
    boundaries, and publishes the per-gang ledgers. Deterministic:
    gangs iterate in sorted name order; every decision is a pure
    function of (config, scheduler state, virtual time)."""

    def __init__(self, cfg: TrainingConfig, sched):
        self.cfg = cfg
        self.sched = sched
        write_s = resolve_ckpt_write_s(cfg.checkpoint_write_s)
        restart = resolve_restart_s(cfg.restart_s)
        self.mtbf_s = resolve_mtbf_s(cfg.mtbf_s)
        elastic = resolve_elastic(cfg.elastic)
        self.gangs: Dict[str, TrainingGang] = {}
        for g in cfg.gangs:
            every = (g.checkpoint_every
                     if g.checkpoint_every is not None
                     else cfg.checkpoint_every)
            if every is None:
                every = int(knobs.get(CKPT_EVERY_ENV))
            if every <= 0:
                every = optimal_cadence_steps(
                    step_time_s(g, g.topology),
                    (g.checkpoint_write_s
                     if g.checkpoint_write_s is not None
                     else write_s),
                    self.mtbf_s)
            name = GANG_PREFIX + g.name
            if name in self.gangs:
                raise ValueError(f"duplicate gang name {g.name!r}")
            self.gangs[name] = TrainingGang(
                g, ckpt_every=every,
                ckpt_write_s=(g.checkpoint_write_s
                              if g.checkpoint_write_s is not None
                              else write_s),
                restart_s=(g.restart_s if g.restart_s is not None
                           else restart),
                elastic=elastic)
        self._arrivals = sorted(
            self.gangs, key=lambda n: (self.gangs[n].cfg.arrival_s,
                                       n))
        self._hard_kill: Optional[str] = None
        # spot grants outstanding (the globe planner's training leg,
        # docs/GLOBE.md): one grant = one growth rung
        self.spot_granted = 0
        self._reclaim_wanted = 0

    # -- identity ---------------------------------------------------

    def owns(self, gang_name: str) -> bool:
        return gang_name in self.gangs

    def quiescent(self) -> bool:
        return all(g.state == "done"
                   for g in self.gangs.values())

    def wants_evals(self) -> bool:
        """Whether evaluation boundaries matter: the elastic ladder
        (and spot reclaim confirmation) only act there. A fully
        inelastic (or finished) tenancy needs none — the event core
        may skip its eval boundaries without divergence because
        :meth:`evaluate` would be a no-op anyway."""
        return (not self.quiescent()
                and (self._reclaim_wanted > 0
                     or any(g.elastic
                            for g in self.gangs.values()
                            if g.state != "done")))

    # -- scheduler callbacks (via the fleet loop) -----------------

    def _request(self, name: str):
        from kind_tpu_sim_torch.sched.scheduler import SliceRequest

        gang = self.gangs[name]
        return SliceRequest(
            name=name, accelerator=gang.cfg.accelerator,
            topology=gang.topology, priority=gang.cfg.priority)

    def tick(self, now: float) -> None:
        """Per-boundary bookkeeping: submit due arrivals, commit
        closed-form progress, release completed gangs' inventory."""
        while self._arrivals:
            name = self._arrivals[0]
            if self.gangs[name].cfg.arrival_s > now:
                break
            self._arrivals.pop(0)
            self.gangs[name].state = "pending"
            self.sched.submit(self._request(name), now)
            metrics.train_board().incr("gangs_submitted")
        for name in sorted(self.gangs):
            gang = self.gangs[name]
            if gang.state != "running":
                continue
            gang.advance(now)
            if gang.state == "done":
                self.sched.release(name, now,
                                   reason="training complete")

    def on_bound(self, name: str, now: float, link_factor: float,
                 bind_s: float) -> None:
        self.gangs[name].bound(now, link_factor, bind_s)

    def on_evicted(self, name: str, now: float) -> None:
        """Preemption/node-chaos displacement (the scheduler already
        requeued the request): graceful unless a pending hard-kill
        chaos marked this gang."""
        gang = self.gangs[name]
        hard = self._hard_kill == name
        gang.preempt(now, graceful=not hard,
                     reason="hard kill" if hard else "preempted")

    def on_migrated(self, name: str, now: float,
                    link_factor: float, bind_s: float) -> None:
        """Defrag moved the gang (it is already rebound elsewhere):
        a checkpointed repartition at the same shape — checkpoint,
        restart cost, resume on the new domain's link state."""
        gang = self.gangs[name]
        gang.preempt(now, graceful=True, reason="defrag migration")
        gang.migrations += 1
        gang.bound(now, link_factor, bind_s)
        metrics.train_board().incr("migrations")

    def apply_chaos(self, action: str, target: int,
                    now: float) -> None:
        """``train_preempt`` (graceful, the spot-reclaim /
        maintenance shape) or ``train_kill`` (hard crash, loses the
        steps since the last cadence checkpoint) against gang index
        ``target`` in sorted-name order."""
        names = sorted(self.gangs)
        name = names[target % len(names)]
        gang = self.gangs[name]
        if gang.state == "done":
            return
        if gang.state != "running":
            # still queued: a preemption of nothing; a hard kill of
            # a checkpointed, unscheduled gang is also a no-op
            return
        if action == "train_kill":
            self._hard_kill = name
        try:
            self.sched.evict_gang(
                name, now,
                reason=("chaos: hard kill (no grace)"
                        if action == "train_kill"
                        else "chaos: training gang preempted"))
        finally:
            self._hard_kill = None

    def apply_sdc(self, target: int, frac: float,
                  now: float) -> None:
        """``sdc_train_chip`` chaos: seed a defective chip into gang
        index ``target`` (sorted-name order, the same addressing
        ``apply_chaos`` uses). The chip index is a crc32 draw over
        the gang's CURRENT chip count, so the culprit the bisection
        must name is itself a pure function of (gang, target)."""
        names = sorted(self.gangs)
        name = names[target % len(names)]
        gang = self.gangs[name]
        if gang.state == "done":
            return
        chips = topo.make_slice(gang.cfg.accelerator,
                                gang.topology).num_chips
        chip = zlib.crc32(
            f"sdc:{name}:{target}".encode("utf-8")) % chips
        gang.seed_defect(chip, frac, now)
        metrics.recovery_log().record(
            "train_sdc_seeded", gang=gang.cfg.name, chip=chip,
            frac=round(frac, 6), at_s=round(now, 6))

    def drain_sdc_verdicts(self) -> List[dict]:
        """Bisection verdicts since the last drain, in sorted gang
        order — the fleet loop turns each into a chip-granular
        quarantine (docs/SDC.md)."""
        out: List[dict] = []
        for name in sorted(self.gangs):
            gang = self.gangs[name]
            while gang.sdc_verdicts_out:
                verdict = gang.sdc_verdicts_out.pop(0)
                verdict["gang"] = name
                out.append(verdict)
        return out

    def evict_all(self, now: float, reason: str) -> None:
        """Blast-radius displacement (zone loss / cell failure,
        docs/GLOBE.md): every bound gang checkpoints and evicts; the
        requeued requests rebind when the cell returns."""
        for name in sorted(self.gangs):
            if name in self.sched.bound:
                self.sched.evict_gang(name, now, reason=reason)

    # -- elasticity --------------------------------------------------

    def grant_spot(self, now: float) -> None:
        """The planner granted one spot growth rung."""
        self.spot_granted += 1
        metrics.train_board().incr("spot_grants")

    def reclaim_spot(self, now: float) -> None:
        """The planner wants one rung back. An UNUSED rung returns
        immediately; a consumed one is flagged — the next evaluation
        shrinks a grown gang (never aborts it) and the grant is only
        counted returned once :meth:`spot_in_use` reflects the
        shrink."""
        if self.spot_granted <= 0:
            return
        in_use = self.spot_in_use()
        if self.spot_granted > in_use:
            self.spot_granted -= 1
            metrics.train_board().incr("spot_returns")
            return
        if self._reclaim_wanted < in_use:
            self._reclaim_wanted += 1
            metrics.train_board().incr("spot_reclaims")

    def spot_in_use(self) -> int:
        return sum(g.spot_rungs for g in self.gangs.values())

    def wants_spot(self) -> bool:
        """Whether a grant could actually be consumed: some elastic,
        unfinished gang has ladder headroom AND the grown shape is
        feasibly placeable right now — the planner must not park
        budget on a tenant that cannot use it."""
        return any(
            g.elastic and g.state == "running"
            and self._feasible_grow(g) is not None
            for g in self.gangs.values())

    def _growable(self, gang: TrainingGang) -> Optional[str]:
        grown = grow_topology(gang.cfg.accelerator, gang.topology)
        if grown is None:
            return None
        if gang.cfg.max_topology is not None:
            cap = topo.make_slice(gang.cfg.accelerator,
                                  gang.cfg.max_topology).num_chips
            if topo.make_slice(gang.cfg.accelerator,
                               grown).num_chips > cap:
                return None
        return grown

    def _feasible_grow(self, gang: TrainingGang) -> Optional[str]:
        """The ladder's next rung IF the grown shape has a feasible
        placement in the current inventory (never counting on
        eviction — training scavenges, it does not displace)."""
        grown = self._growable(gang)
        if grown is None:
            return None
        grown_slice = topo.make_slice(gang.cfg.accelerator, grown)
        cands = self.sched.inv.candidate_placements(
            accelerator=gang.cfg.accelerator,
            host_block=grown_slice.host_grid,
            chips_per_node=grown_slice.chips_per_host)
        return grown if cands else None

    def _resize(self, name: str, new_topology: str,
                now: float) -> None:
        """Checkpointed repartition: evict (graceful checkpoint),
        withdraw the auto-requeued old-shape request, resubmit at
        the new shape — the next scheduling pass rebinds and the
        gang resumes with the restart cost."""
        gang = self.gangs[name]
        if name in self.sched.bound:
            self.sched.evict_gang(
                name, now,
                reason=f"elastic resize {gang.topology} "
                       f"-> {new_topology}")
        self.sched.withdraw(name, now, reason="resize resubmit")
        gang.topology = new_topology
        gang.ledger.append({
            "kind": "resize", "step": gang.steps_done,
            "at_s": round(now, 6), "topology": new_topology,
        })
        self.sched.submit(self._request(name), now)

    def evaluate(self, now: float) -> None:
        """The elastic ladder, on the fleet's evaluation cadence.
        Shrinks serve reclaim debt first (shrink-never-abort: the
        floor is the base shape); grows spend spot rungs, or
        scavenge free inventory when ``TrainingConfig.scavenge`` —
        and only ever onto capacity that is feasibly placeable RIGHT
        NOW, so a grow can never strand a gang in the queue."""
        if not self.wants_evals():
            return
        for name in sorted(self.gangs):
            if self._reclaim_wanted <= 0:
                break
            gang = self.gangs[name]
            if gang.state == "done" or gang.spot_rungs <= 0:
                continue
            shrunk = shrink_topology(gang.cfg.accelerator,
                                     gang.topology,
                                     gang.cfg.topology)
            if shrunk is None:
                continue
            self._resize(name, shrunk, now)
            gang.spot_rungs -= 1
            gang.shrinks += 1
            self.spot_granted -= 1
            self._reclaim_wanted -= 1
            metrics.train_board().incr("shrinks")
        for name in sorted(self.gangs):
            gang = self.gangs[name]
            if (not gang.elastic or gang.state != "running"):
                continue
            spot_ok = self.spot_granted > self.spot_in_use()
            if not (spot_ok or self.cfg.scavenge):
                continue
            grown = self._feasible_grow(gang)
            if grown is None:
                continue  # nothing scavengeable without eviction
            self._resize(name, grown, now)
            gang.grows += 1
            if spot_ok:
                gang.spot_rungs += 1
            metrics.train_board().incr("grows")
        # hand back rungs nothing here can use (the planner settles
        # them on its next pass) — budget must never idle on a
        # tenant with no feasible growth
        while (self.spot_granted > self.spot_in_use()
               and not self.wants_spot()):
            self.spot_granted -= 1
            metrics.train_board().incr("spot_returns")

    # -- event-core plumbing ----------------------------------------

    def due(self, due_set) -> None:
        """Contribute this tenant's boundary-condition instants:
        gang arrivals and segment completions (a completed gang
        releases inventory, which can unblock the pending queue).
        Everything else — checkpoint boundaries, mid-segment
        progress — is closed form and needs no stepping."""
        for name in self._arrivals[:1]:
            due_set.at(self.gangs[name].cfg.arrival_s)
        for name in sorted(self.gangs):
            # spike-aware: an SDC detection point is a boundary-
            # condition event exactly like a completion
            due_set.at(self.gangs[name].next_event_s())

    # -- reporting ---------------------------------------------------

    def report(self) -> Dict[str, object]:
        gangs = {name[len(GANG_PREFIX):]: g.report()
                 for name, g in sorted(self.gangs.items())}
        verify_ok = all(g["ledger_verify"]["ok"]
                        for g in gangs.values())
        return {
            "gangs": gangs,
            "all_done": self.quiescent(),
            "ledger_ok": verify_ok,
            "lost_steps": sum(g["lost_steps"]
                              for g in gangs.values()),
            "rerun_steps": sum(g["rerun_steps"]
                               for g in gangs.values()),
            "evictions": sum(g["evictions"]
                             for g in gangs.values()),
            "migrations": sum(g["migrations"]
                              for g in gangs.values()),
            "checkpoint_writes": sum(
                g["checkpoint"]["writes"] for g in gangs.values()),
            "grows": sum(g["grows"] for g in gangs.values()),
            "shrinks": sum(g["shrinks"] for g in gangs.values()),
            "spot": {"granted": self.spot_granted,
                     "in_use": self.spot_in_use()},
            "mtbf_s": self.mtbf_s,
        }


# -- the kubernetes face (pods/tpu-batch-train-job.yaml) ---------------


# -- the kubernetes face (pods/tpu-batch-train-job.yaml) ---------------


def gangs_from_manifest(text: str) -> List[TrainingGangConfig]:
    """Parse a kubernetes manifest's TPU training workloads into
    training-tenant specs — the same StatefulSet-is-one-gang mapping
    :mod:`kind_tpu_sim_torch.sched.kubeface` applies (all-or-nothing
    multi-host worlds), carrying the priority tier through. This is
    what lets ``pods/tpu-batch-train-job.yaml`` drive the sim
    instead of sitting unused."""
    from kind_tpu_sim_torch.sched import kubeface

    out: List[TrainingGangConfig] = []
    for req in kubeface.slice_requests_from_yaml(text):
        out.append(TrainingGangConfig(
            name=req.name, accelerator=req.accelerator,
            topology=req.topology, priority=req.priority))
    return out


def to_manifest(cfg: TrainingGangConfig) -> str:
    """Render a training-tenant spec back to schedulable YAML (a
    StatefulSet gang for multi-host shapes) — the round-trip inverse
    of :func:`gangs_from_manifest`:
    ``gangs_from_manifest(to_manifest(cfg))`` reproduces the
    scheduling-relevant fields."""
    from kind_tpu_sim_torch.sched import kubeface
    from kind_tpu_sim_torch.sched.scheduler import SliceRequest

    return kubeface.to_pod_manifest(SliceRequest(
        name=cfg.name, accelerator=cfg.accelerator,
        topology=cfg.topology, priority=cfg.priority))
