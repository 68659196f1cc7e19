"""Seeded chaos: fault plans and the scenarios that drive the port's
engines, trainer and fleet through their recovery paths.

The port's copy of the engine-backed part of ``kind_tpu_sim/chaos.py``:

* the fault vocabulary (``FAULT_KINDS``), each kind's schema
  (``FAULT_SCHEMAS``: its layer, its magnitude's draw) and
  :func:`draw_param`, whole and in the reference's order;
* :class:`ChaosSchedule`: ``plan()`` derives a :class:`FaultPlan` from
  the seed and its arguments alone (a ``random.Random`` keyed by the
  crc32 of the arguments' repr; each event's ``param`` drawn before its
  slot and target), so a plan equals the reference's for the same seed;
* the scenario registry: the three scenarios that drive device work
  and two analytic ones, each with the reference's bar:

  - ``preempt-train``: SIGTERM mid-step; a checkpoint is written at that
    step, and the resumed loss trajectory equals the uninterrupted one
    exactly (``drift == 0.0``);
  - ``serving-slot-failure``: a serving slot dies mid-stream; its request
    requeues and every stream equals the fault-free run's;
  - ``fleet-preemption``: a replica of real engines is preempted and
    restored under seeded traffic; streams equal the fault-free run's
    and tail SLO attainment recovers;
  - ``disagg-pool-loss`` (analytic, no device work): a disaggregated
    fleet of analytic replicas, priced from the cost model's
    calibration, loses its whole prefill pool and then has its KV link
    degraded; the decode pool finishes prefilled work through the
    outage, no request is lost, and tail attainment recovers;
  - ``zoo-swap-storm`` (analytic): six replicas of the port's generations
    (``costmodel.GENERATIONS``, the H100's alone) serve the default
    model zoo under model-swap-storm pulses; no request is lost, the
    swap ledger holds every reload, and the storm's e2e p99 must stay
    within 1.25x of the steady run's. Priced from the H100's
    calibration (decode at 260.4 GB/s), six replicas fail that bound:
    the verdict is ``ok: false``, and ``chaos run --scenario all``
    exits 1.

Each scenario takes the reference's ``seed`` and returns its result
dict. A device scenario's model is the reference's tiny config unless
``cfg`` names another, with weights drawn from ``torch.Generator`` seed
0 (the reference draws from ``jax.random``, so only the fields that do
not depend on the weights equal the reference's). It runs on the card
unless ``device="cpu"`` is given. ``preempt-train`` signals its own
process: run it in the main thread, where the guard's handler is
installed. The analytic scenarios take neither ``device`` nor ``cfg``;
with the same calibration (and, for ``zoo-swap-storm``, the same
generation registry) their results are the reference's.

The reference's other scenarios drive the simulator's control plane,
worker pools, scheduler and the rest of its analytic fleets, and are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import tempfile
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from kind_tpu_sim_torch import fleet, metrics
from kind_tpu_sim_torch.device import resolve
from kind_tpu_sim_torch.fleet import knobs
from kind_tpu_sim_torch.models import checkpoint as ckpt
from kind_tpu_sim_torch.models import transformer as tf
from kind_tpu_sim_torch.models.serving import (
    Request,
    ServingConfig,
    ServingEngine,
)

FAULT_KINDS = (
    "worker_crash",
    "worker_hang",
    "device_flap",
    "node_kill",
    "node_restart",
    "preempt_sigterm",
    "cmd_transient",
    "slot_failure",
    "replica_preempt",
    "replica_flap",
    "node_drain",
    "node_fail",
    "straggler_worker",
    "degraded_link",
    "slow_replica",
    "flaky_node",
    "zone_loss",
    "dcn_degrade",
    "herd_failover",
    "cell_drain",
    "demand_surge",
    "retry_storm",
    "train_preempt",
    "train_kill",
    "prefill_pool_loss",
    "kv_transfer_degrade",
    "noisy_neighbor",
    "tenant_surge",
    "model_swap_storm",
    "generation_cell_drain",
    "sdc_chip",
    "correlated_domain_fault",
)

FAULT_LAYERS = ("runtime", "grid", "cluster", "engine", "fleet",
                "sched", "health", "globe", "overload", "train",
                "tenant", "zoo")


def resolve_seed(seed: Optional[int] = None) -> int:
    """Explicit seed > env (KIND_TPU_SIM_CHAOS_SEED) > 0."""
    if seed is not None:
        return int(seed)
    return int(knobs.get(knobs.CHAOS_SEED))


@dataclasses.dataclass(frozen=True)
class FaultSchema:
    """One fault kind's contract: its owning ``layer``; ``param`` None
    (no magnitude) or ``(draw, lo, hi)`` with ``draw`` "int"
    (``rng.randint(lo, hi)``) or "uniform" (``round(rng.uniform(lo,
    hi), 3)``); the topologies it can strike (``scopes``), its
    prerequisites (``needs``), and whether the reference's fuzzer may
    compose it (``fuzzable``, ``exclusive``)."""

    kind: str
    layer: str
    param: Optional[tuple] = None
    param_doc: str = ""
    scopes: tuple = ()
    needs: tuple = ()
    fuzzable: bool = False
    exclusive: bool = False

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "layer": self.layer,
            "param": list(self.param) if self.param is not None else None,
            "param_doc": self.param_doc,
            "scopes": list(self.scopes),
            "needs": list(self.needs),
            "fuzzable": self.fuzzable,
            "exclusive": self.exclusive,
        }


FAULT_SCHEMAS: Dict[str, FaultSchema] = {s.kind: s for s in (
    FaultSchema("worker_crash", "grid", scopes=("worker",)),
    FaultSchema("worker_hang", "grid", param=("int", 1, 5),
                param_doc="hang seconds before the deadline kill",
                scopes=("worker",)),
    FaultSchema("device_flap", "cluster", scopes=("control-plane",)),
    FaultSchema("node_kill", "cluster", scopes=("control-plane",)),
    FaultSchema("node_restart", "cluster", scopes=("control-plane",)),
    FaultSchema("preempt_sigterm", "engine", scopes=("train",),
                needs=("jax",)),
    FaultSchema("cmd_transient", "runtime", param=("int", 1, 3),
                param_doc="transient failures before success",
                scopes=("control-plane",)),
    FaultSchema("slot_failure", "engine", scopes=("serving",),
                needs=("jax",)),
    FaultSchema("replica_preempt", "fleet", scopes=("fleet",),
                fuzzable=True),
    FaultSchema("replica_flap", "fleet", scopes=("fleet",),
                fuzzable=True),
    FaultSchema("node_drain", "sched", scopes=("fleet",),
                needs=("sched",), fuzzable=True),
    FaultSchema("node_fail", "sched", scopes=("fleet",),
                needs=("sched",), fuzzable=True),
    FaultSchema("straggler_worker", "health",
                param=("uniform", 1.6, 2.4),
                param_doc="per-cell stall seconds",
                scopes=("worker",)),
    FaultSchema("degraded_link", "health",
                param=("uniform", 0.08, 0.25),
                param_doc="ICI link bandwidth factor",
                scopes=("fleet",), needs=("sched",), fuzzable=True),
    FaultSchema("slow_replica", "health",
                param=("uniform", 3.0, 6.0),
                param_doc="service-time inflation factor",
                scopes=("fleet",), fuzzable=True),
    FaultSchema("flaky_node", "health",
                param=("uniform", 0.5, 1.5),
                param_doc="intermittent stall seconds",
                scopes=("worker",)),
    FaultSchema("zone_loss", "globe", scopes=("globe",),
                fuzzable=True, exclusive=True),
    FaultSchema("dcn_degrade", "globe",
                param=("uniform", 0.08, 0.25),
                param_doc="inter-zone DCN bandwidth factor",
                scopes=("globe",), fuzzable=True),
    FaultSchema("herd_failover", "globe", scopes=("globe",),
                fuzzable=True, exclusive=True),
    FaultSchema("cell_drain", "globe", scopes=("globe",),
                fuzzable=True),
    FaultSchema("demand_surge", "overload",
                param=("uniform", 3.0, 5.0),
                param_doc="arrival-rate step multiplier",
                scopes=("fleet",), needs=("overload",),
                fuzzable=True, exclusive=True),
    FaultSchema("retry_storm", "overload", param=("int", 3, 5),
                param_doc="uncontrolled client max attempts",
                scopes=("fleet",), needs=("overload",)),
    FaultSchema("train_preempt", "train", scopes=("fleet",),
                needs=("sched", "training"), fuzzable=True),
    FaultSchema("train_kill", "train", scopes=("fleet",),
                needs=("sched", "training"), fuzzable=True),
    FaultSchema("prefill_pool_loss", "fleet", scopes=("fleet",),
                needs=("disagg",), fuzzable=True, exclusive=True),
    FaultSchema("kv_transfer_degrade", "fleet",
                param=("uniform", 0.08, 0.25),
                param_doc="KV-transfer link bandwidth factor",
                scopes=("fleet",), needs=("disagg",),
                fuzzable=True),
    FaultSchema("noisy_neighbor", "tenant",
                param=("uniform", 3.0, 6.0),
                param_doc="aggressor-tenant arrival multiplier",
                scopes=("fleet",), needs=("tenancy",),
                fuzzable=True, exclusive=True),
    FaultSchema("tenant_surge", "tenant",
                param=("uniform", 2.0, 4.0),
                param_doc="one tenant's windowed rate multiplier",
                scopes=("fleet",), needs=("tenancy",),
                fuzzable=True, exclusive=True),
    FaultSchema("model_swap_storm", "zoo",
                param=("int", 2, 4),
                param_doc="resident-model eviction pulses across "
                          "the window",
                scopes=("fleet",), needs=("zoo",),
                fuzzable=True, exclusive=True),
    FaultSchema("generation_cell_drain", "zoo",
                scopes=("globe",), needs=("zoo",),
                fuzzable=True),
    FaultSchema("sdc_chip", "health",
                param=("uniform", 0.2, 0.6),
                param_doc="fraction of work the defective chip "
                          "corrupts (persists until quarantined)",
                scopes=("fleet",), needs=("sdc",),
                fuzzable=True),
    FaultSchema("correlated_domain_fault", "sched",
                scopes=("fleet",), needs=("sdc", "sched"),
                fuzzable=True, exclusive=True),
)}


def draw_param(kind: str, rng: random.Random) -> float:
    """One seeded magnitude draw for ``kind``, per its schema."""
    schema = FAULT_SCHEMAS[kind]
    if schema.param is None:
        return 0.0
    draw, lo, hi = schema.param
    if draw == "int":
        return float(rng.randint(int(lo), int(hi)))
    return round(rng.uniform(float(lo), float(hi)), 3)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One planned fault: ``kind`` strikes ``target`` at schedule index
    ``at`` (the scenario's unit: step, round, request); ``param`` is its
    magnitude."""

    kind: str
    at: int
    target: int = 0
    param: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered, immutable fault schedule."""

    seed: int
    events: tuple

    def for_kind(self, kind: str) -> List[FaultEvent]:
        return [e for e in self.events if e.kind == kind]

    def as_dict(self) -> dict:
        return {"seed": self.seed,
                "events": [e.as_dict() for e in self.events]}


class ChaosSchedule:
    """Seeded fault-plan generator: the same seed and arguments give the
    same plan. Each ``plan()`` derives its own stream from the canonical
    repr of its arguments."""

    def __init__(self, seed: Optional[int] = None):
        self.seed = resolve_seed(seed)

    def plan(self, kinds: Sequence[str] = ("worker_crash",),
             n_faults: int = 1, horizon: int = 8,
             targets: int = 2) -> FaultPlan:
        """``n_faults`` events over ``horizon`` slots and ``targets``
        victims, kinds drawn from the seeded stream, each ``param``
        drawn from its kind's schema before its slot and target."""
        for kind in kinds:
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; known: "
                    f"{', '.join(FAULT_KINDS)}")
        key = repr((self.seed, tuple(kinds), int(n_faults),
                    int(horizon), int(targets)))
        rng = random.Random(zlib.crc32(key.encode("utf-8")))
        events = []
        for _ in range(n_faults):
            kind = rng.choice(list(kinds))
            param = draw_param(kind, rng)
            events.append(FaultEvent(
                kind=kind,
                at=rng.randrange(max(1, horizon)),
                target=rng.randrange(max(1, targets)),
                param=param,
            ))
        events.sort(key=lambda e: (e.at, e.target, e.kind))
        return FaultPlan(seed=self.seed, events=tuple(events))


# ---------------------------------------------------------------------
# named scenarios


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    fn: Callable[..., dict]
    description: str
    slow: bool = False
    # True: it does device work and takes ``device`` and ``cfg``
    device: bool = True


SCENARIOS: Dict[str, Scenario] = {}


def _scenario(name: str, description: str, slow: bool = False,
              device: bool = True):
    def register(fn):
        SCENARIOS[name] = Scenario(name, fn, description, slow=slow,
                                   device=device)
        return fn

    return register


def _tiny_config(max_seq: int) -> tf.ModelConfig:
    """The reference scenarios' model (bf16 activations)."""
    return tf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                          d_ff=64, max_seq=max_seq)


def _params(cfg: tf.ModelConfig, dev: torch.device):
    return tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)


@_scenario("preempt-train",
           "SIGTERM mid-step; checkpoint written, resume reproduces the "
           "uninterrupted loss trajectory", slow=True)
def _scenario_preempt_train(seed: int, *, device="cuda",
                            cfg: Optional[tf.ModelConfig] = None) -> dict:
    dev = resolve(device)
    plan = ChaosSchedule(seed).plan(kinds=("preempt_sigterm",),
                                    n_faults=1, horizon=5, targets=1)
    kill_step = plan.events[0].at + 1
    total = 8
    cfg = cfg or _tiny_config(16)
    with tempfile.TemporaryDirectory() as tmp:
        straight_dir = os.path.join(tmp, "straight")
        chaos_dir = os.path.join(tmp, "chaos")
        _, straight = ckpt.train_with_checkpointing(
            cfg, straight_dir, total_steps=total, checkpoint_every=total,
            device=dev)

        def preempt(step: int) -> None:
            if step == kill_step:
                os.kill(os.getpid(), signal.SIGTERM)

        preempted_at = None
        try:
            ckpt.train_with_checkpointing(
                cfg, chaos_dir, total_steps=total, checkpoint_every=total,
                on_step=preempt, device=dev)
        except ckpt.Preempted as exc:
            preempted_at = exc.step
            losses = exc.losses
        else:
            losses = {}
        _, resumed = ckpt.train_with_checkpointing(
            cfg, chaos_dir, total_steps=total, checkpoint_every=total,
            device=dev)
        combined = {**losses, **resumed}
        drift = max(abs(combined[i] - straight[i]) for i in range(total))
    return {
        "plan": plan.as_dict(),
        "preempted_at_step": preempted_at,
        "resume_max_loss_drift": drift,
        "ok": bool(preempted_at == kill_step + 1 and drift == 0.0),
    }


@_scenario("serving-slot-failure",
           "a serving slot dies mid-stream; its request requeues and every "
           "accepted request completes uncorrupted", slow=True)
def _scenario_serving_slot_failure(seed: int, *, device="cuda",
                                   cfg: Optional[tf.ModelConfig] = None
                                   ) -> dict:
    dev = resolve(device)
    plan = ChaosSchedule(seed).plan(kinds=("slot_failure",),
                                    n_faults=1, horizon=2, targets=2)
    ev = plan.events[0]
    cfg = cfg or _tiny_config(64)
    params = _params(cfg, dev)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=4 + 3 * i).tolist()
               for i in range(4)]
    # one engine serves both runs: the clean run drains it, and the
    # faulted run's counts are then its own (its rounds and admissions
    # replay the clean run's graphs on a card)
    eng = ServingEngine(params, cfg,
                        ServingConfig(max_slots=2, max_len=48, chunk=8),
                        device=dev)

    def run(inject: bool):
        for i, p in enumerate(prompts):
            # max_new > 2 chunks, so the failure lands on a slot that is
            # still mid-stream
            eng.submit(Request(f"c{i}", p, max_new=20, seed=seed + i))
        if inject:
            for _ in range(ev.at + 1):
                eng.step_round()
            eng.inject_slot_failure(ev.target)
            eng.restore_slot(ev.target)
        comps = eng.poll() + eng.run()
        return {c.request_id: tuple(c.tokens) for c in comps}

    clean = run(inject=False)
    faulted = run(inject=True)
    return {
        "plan": plan.as_dict(),
        "requests": len(prompts),
        "slot_failures": eng.slot_failures,
        "requeues": eng.requeues,
        "streams_identical": faulted == clean,
        "ok": bool(faulted == clean and eng.slot_failures == 1
                   and eng.requeues >= 1),
    }


class _RunClock:
    """An engine clock that reads the current run's virtual clock, so
    one engine serves runs that each start their clock at 0."""

    def __init__(self):
        self.clock = fleet.VirtualClock()

    def __call__(self) -> float:
        return self.clock.now()


@_scenario("fleet-preemption",
           "a serving replica (real engines) preempted mid-traffic; the "
           "router drains + requeues via the slot-failure machinery, "
           "streams stay identical to fault-free, and SLO attainment "
           "recovers to baseline", slow=True)
def _scenario_fleet_preemption(seed: int, *, device="cuda",
                               cfg: Optional[tf.ModelConfig] = None) -> dict:
    dev = resolve(device)
    plan = ChaosSchedule(seed).plan(kinds=("replica_preempt",),
                                    n_faults=1, horizon=4, targets=2)
    target = plan.events[0].target % 2
    cfg = cfg or _tiny_config(64)
    params = _params(cfg, dev)
    spec = fleet.WorkloadSpec(process="poisson", rps=150.0,
                              n_requests=14, prompt_len=(3, 8),
                              max_new=(6, 12), vocab=cfg.vocab_size)
    trace = fleet.generate_trace(spec, seed)
    tick = 0.05
    # each replica id keeps its engine across the two runs: a run
    # drains every engine and a restore lifts every quarantine, so the
    # faulted run starts from the clean run's state (and replays its
    # graphs on a card); the clock reads the current run's
    clock = _RunClock()
    engines: Dict[int, ServingEngine] = {}

    def factory(rid):
        if rid not in engines:
            engines[rid] = ServingEngine(
                params, cfg, ServingConfig(max_slots=2, max_len=48, chunk=4),
                device=dev, clock=clock)
        return fleet.EngineReplica(rid, engines[rid])

    def run(events):
        clock.clock = fleet.VirtualClock()
        fc = fleet.FleetConfig(replicas=2, policy="round-robin",
                               tick_s=tick,
                               slo=fleet.SloPolicy(ttft_s=1.0, e2e_s=5.0))
        return fleet.FleetSim(fc, trace, replica_factory=factory,
                              chaos_events=events, clock=clock.clock).run()

    clean = run([])
    # preempt just after a mid-trace dispatch onto the target replica:
    # the runs are identical up to that instant, so the victim holds
    # in-flight work and the displacement is certain
    victim_disp = sorted(e["dispatch_s"] for e in clean["completions"]
                         if e["replica"] == target)
    at = (victim_disp[len(victim_disp) // 4] + tick / 2
          if victim_disp else tick)
    restore = at + 4 * tick
    faulted = run([
        fleet.ChaosEvent(at_s=round(at, 6), action="preempt", target=target),
        fleet.ChaosEvent(at_s=round(restore, 6), action="restore",
                         target=target),
    ])

    def crc(rep):
        return {e["request_id"]: e["tokens_crc"] for e in rep["completions"]}

    tail_clean = fleet.attainment_over(clean["completions"], restore)
    tail_faulted = fleet.attainment_over(faulted["completions"], restore)
    recovered = (tail_clean is None or tail_faulted is None
                 or tail_faulted >= tail_clean)
    return {
        "plan": plan.as_dict(),
        "requests": len(trace),
        "preempted_replica": target,
        "preempt_at_s": round(at, 6),
        "requeues": faulted["router"]["requeues"],
        "streams_identical": crc(faulted) == crc(clean),
        "tail_attainment_clean": tail_clean,
        "tail_attainment_faulted": tail_faulted,
        "ok": bool(faulted["ok"] and clean["ok"]
                   and crc(faulted) == crc(clean)
                   and faulted["router"]["requeues"] >= 1
                   and recovered),
    }


@_scenario("disagg-pool-loss",
           "a disaggregated fleet loses its whole prefill pool "
           "mid-traffic, then its KV link degrades; the decode pool "
           "keeps finishing already-prefilled work through the "
           "outage, zero requests are lost, and post-heal SLO "
           "attainment recovers to baseline", device=False)
def _scenario_disagg_pool_loss(seed: int) -> dict:
    plan = ChaosSchedule(seed).plan(kinds=("kv_transfer_degrade",),
                                    n_faults=1, horizon=8, targets=1)
    factor = plan.events[0].param
    spec = fleet.WorkloadSpec(process="poisson", rps=120.0,
                              n_requests=100, prompt_len=(8, 24),
                              max_new=(8, 16))
    trace = fleet.generate_trace(spec, seed)
    dis = fleet.DisaggConfig(prefill_replicas=2, decode_replicas=2)
    fc = fleet.FleetConfig(replicas=4, policy="least-outstanding",
                           tick_s=0.01, disagg=dis,
                           slo=fleet.SloPolicy(ttft_s=1.0, e2e_s=5.0))
    clean = fleet.FleetSim(fc, trace).run()
    span = clean["virtual_s"]
    loss = round(span * 0.3, 6)
    heal = round(span * 0.45, 6)
    last_restore = round(span * 0.65, 6)
    events = [
        fleet.ChaosEvent(at_s=loss, action="prefill_pool_loss", target=0),
        fleet.ChaosEvent(at_s=heal, action="prefill_pool_restore",
                         target=0),
        fleet.ChaosEvent(at_s=round(span * 0.5, 6), action="kv_degrade",
                         target=0, param=factor),
        fleet.ChaosEvent(at_s=last_restore, action="kv_restore", target=0),
    ]
    faulted = fleet.FleetSim(fc, trace, chaos_events=events).run()
    # requests whose KV crossed before the loss keep finishing inside
    # the outage
    survivors = sum(1 for e in faulted["completions"]
                    if loss <= e["finish_s"] < heal
                    and e["finish_reason"] == "length")

    def tokens(rep):
        return sum(e["tokens"] for e in rep["completions"])

    tail_clean = fleet.attainment_over(clean["completions"], last_restore)
    tail_faulted = fleet.attainment_over(faulted["completions"],
                                         last_restore)
    recovered = (tail_clean is None or tail_faulted is None
                 or tail_faulted >= tail_clean)
    return {
        "plan": plan.as_dict(),
        "requests": len(trace),
        "kv_factor": factor,
        "decode_survivors": survivors,
        "requeues": faulted["router"]["requeues"],
        "kv": faulted["disagg"]["kv"],
        "tail_attainment_clean": tail_clean,
        "tail_attainment_faulted": tail_faulted,
        "ok": bool(faulted["ok"] and clean["ok"] and survivors > 0
                   and tokens(faulted) == tokens(clean) and recovered),
    }


@_scenario("zoo-swap-storm",
           "a fleet of the registered generations serving the default "
           "model zoo under model-swap-storm pulses: every resident "
           "model is evicted repeatedly mid-window, the warm pool "
           "rebuilds through the swap lane each time, zero requests "
           "are lost, the swap ledger accounts every reload, and p99 "
           "holds within 1.25x of the steady-mix run", device=False)
def _scenario_zoo_swap_storm(seed: int) -> dict:
    from kind_tpu_sim_torch.fleet import costmodel
    from kind_tpu_sim_torch.fleet import zoo as zoo_mod

    plan = ChaosSchedule(seed).plan(kinds=("model_swap_storm",),
                                    n_faults=1, horizon=8, targets=1)
    pulses = max(1, int(plan.events[0].param))
    zoo = zoo_mod.default_zoo()
    # the reference's trace: long, so that a pulse's one reload a
    # replica touches few of its 2000 requests
    spec = fleet.WorkloadSpec(process="poisson", rps=120.0,
                              n_requests=2000, prompt_len=(4, 16),
                              max_new=(16, 32), zoo=zoo)
    trace = fleet.generate_trace(spec, seed)
    span = max(r.arrival_s for r in trace)
    t0 = round(span * 0.3, 6)
    t1 = round(span * 0.7, 6)
    cfg = fleet.FleetConfig(
        replicas=6, policy="least-outstanding",
        slo=fleet.SloPolicy(ttft_s=1.0, e2e_s=5.0),
        zoo=zoo, generations=tuple(costmodel.GENERATIONS))

    def storm_events():
        out = []
        for k in range(pulses):
            frac = k / max(1, pulses - 1) if pulses > 1 else 0.0
            out.append(fleet.ChaosEvent(
                round(t0 + (t1 - t0) * frac, 6), "model_swap_evict", 0))
        return out

    steady = fleet.FleetSim(cfg, trace).run()
    storm = fleet.FleetSim(cfg, trace, chaos_events=storm_events()).run()
    replay = fleet.FleetSim(cfg, trace, chaos_events=storm_events()).run()

    def p99(rep: dict) -> Optional[float]:
        return rep["slo"].get("e2e", {}).get("p99_s")

    def tokens(rep: dict) -> int:
        return sum(e["tokens"] for e in rep["completions"])

    p99_steady = p99(steady)
    p99_storm = p99(storm)
    ratio = (round(p99_storm / p99_steady, 6)
             if p99_steady and p99_storm is not None else None)
    return {
        "plan": plan.as_dict(),
        "requests": len(trace),
        "pulses": pulses,
        "generations": sorted(set(storm["generations"].values())),
        "swaps_steady": steady["zoo"]["swaps"]["completed"],
        "swaps_storm": storm["zoo"]["swaps"]["completed"],
        "per_model_slo": {
            name: board.get("e2e", {}).get("p99_s")
            for name, board in storm["zoo"]["per_model_slo"].items()},
        "p99_steady_s": p99_steady,
        "p99_storm_s": p99_storm,
        "p99_ratio": ratio,
        "replay_identical": storm == replay,
        "ok": bool(storm["ok"] and steady["ok"]
                   and storm == replay
                   and tokens(storm) == tokens(steady)
                   and storm["zoo"]["swaps"]["completed"]
                   >= steady["zoo"]["swaps"]["completed"]
                   and ratio is not None and ratio <= 1.25),
    }


def scenario_names(include_slow: bool = False) -> List[str]:
    """The registry's names, sorted; slow ones only on request."""
    return sorted(n for n, s in SCENARIOS.items()
                  if include_slow or not s.slow)


def run_scenario(name: str, seed: Optional[int] = None, **kwargs) -> dict:
    """Run one named scenario (``kwargs``: a device scenario's ``device``
    and ``cfg``; an analytic scenario takes none and ignores them); the
    report carries the seed, the plan, the recovery-log delta of this
    run and the verdict."""
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r}; ported: "
            f"{', '.join(sorted(SCENARIOS))}")
    seed = resolve_seed(seed)
    scenario = SCENARIOS[name]
    before = metrics.recovery_log().counts()
    report = scenario.fn(seed, **(kwargs if scenario.device else {}))
    report.update({
        "scenario": name,
        "seed": seed,
        "recovery_events": metrics.recovery_log().snapshot_since(before),
    })
    return report
