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
* the cluster layer's fault levers: :class:`FlakyExecutor` (transient
  failures the classified retry of ``utils/shell.py`` must absorb) and
  :class:`ChaosManager` (``chaos fail | heal | kill-node | start-node``:
  a node's devices marked unhealthy through the plugin's unhealthy
  file, and node containers stopped and started);
* :func:`soak`: seeded scenario runs drawn from the registry's pool;
* the scenario registry: the three scenarios that drive device work
  and twenty-five that do none, each with the reference's bar:

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
  - the virtual-clock scenarios of the simulator's control layers, on
    analytic replicas priced from round figures
    (``SimReplicaConfig(max_slots=4, prefill_per_tok_s=0.002,
    tpot_s=0.002)``): ``fleet-flaky-replica``,
    ``tenant-noisy-neighbor``, ``sched-node-drain``,
    ``sched-preemption-priority``, ``gray-slow-replica``,
    ``gray-degraded-ici``, ``overload-surge``, ``retry-storm``,
    ``train-preempt-economics``, ``train-mixed-soak``,
    ``sdc-training-bisect``, ``sdc-serving-audit`` and
    ``correlated-rack-loss``. Each keeps the reference's trace, rates,
    windows, bounds and verdict. ``retry-storm`` departs from the
    reference where the reference queues a duplicate of a request on
    the replica holding it (seed 0: a stale hedge timer, ROADMAP C-17;
    seed 2: a requeue onto the hedge copy's replica, C-19), which the
    port never does: its retry counters differ there.
  - the cold worker grids, on the wall clock with real subprocess
    workers (``parallel/multihost.scatter_grid_cells`` over
    ``utils/worker_pool.run_cells``): ``worker-crash-grid`` (a worker
    killed mid-sweep; its cell requeues and the results equal the
    fault-free run's), ``worker-hang-grid`` (a worker wedged past the 3 s
    cell deadline is killed and its cell requeued) and
    ``gray-straggler-grid`` (a slow but alive worker is probed out and
    quarantined; detection on must finish within, and detection off
    past, bounds derived from two clean runs by
    :func:`derive_straggler_bounds`). The straggler's verdict times the
    host: on a loaded host a healthy worker can miss its 0.8 s probe.
  - the globe's blast-radius scenarios (``globe/``, analytic cells on one
    virtual clock): ``globe-zone-loss``, ``globe-herd-failover``,
    ``globe-dcn-degrade`` and ``train-globe-spot``.
  - the control-plane scenarios, over the fake runtime's recorded
    command stream (no cluster, no daemon): ``flaky-exec`` (transient
    kubectl failures retried away), ``device-flap`` (seeded fail / heal
    cycles, every flap healed) and ``node-flap`` (seeded kill / restart
    cycles, every killed node started again).

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
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import random
import signal
import tempfile
import zlib
from typing import Callable, Dict, List, Optional, Sequence

from kind_tpu_sim_torch import fleet, metrics
from kind_tpu_sim_torch.analysis import knobs
from kind_tpu_sim_torch.utils.shell import (
    CommandError,
    ExecResult,
    FakeExecutor,
    RetryPolicy,
    run_with_retry,
)

log = logging.getLogger("kind-tpu-sim-torch")

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


class FlakyExecutor(FakeExecutor):
    """FakeExecutor that injects TRANSIENT failures from a fault
    plan: commands matching ``flaky_prefix`` fail their first
    ``fail_attempts`` invocations with a retryable error, then
    delegate to the normal rule table. The unit under test is the
    retry layer (shell.run_with_retry): the command stream must
    complete as if nothing happened, with the retries observable in
    metrics.recovery_log()."""

    def __init__(self, rules=None, binaries=None,
                 flaky_prefix: str = "kubectl",
                 fail_attempts: int = 2,
                 error_text: str = ("Unable to connect to the server: "
                                    "dial tcp 127.0.0.1:6443: connect:"
                                    " connection refused")):
        super().__init__(rules, binaries)
        self.flaky_prefix = flaky_prefix
        self.fail_attempts = fail_attempts
        self.error_text = error_text
        self.injected_failures = 0
        self._attempts: Dict[str, int] = {}

    def run(self, argv, *, input_text=None, check=True, capture=True,
            env=None, timeout=None):
        joined = " ".join(argv)
        if joined.startswith(self.flaky_prefix):
            seen = self._attempts.get(joined, 0)
            if seen < self.fail_attempts:
                self._attempts[joined] = seen + 1
                self.injected_failures += 1
                self.calls.append((list(argv), input_text))
                result = ExecResult(1, "", self.error_text)
                if check and not result.ok:
                    raise CommandError(argv, result)
                return result
        return super().run(argv, input_text=input_text, check=check,
                           capture=capture, env=env, timeout=timeout)


class ChaosManager:
    """The manual levers (``chaos fail | heal | kill-node |
    start-node``) against a cluster's node containers: device health
    through the plugin's unhealthy file, and node stop / start."""

    def __init__(self, cfg: "SimConfig", runtime: "ContainerRuntime",
                 cluster: "ClusterManager"):
        self.cfg = cfg
        self.rt = runtime
        self.cluster = cluster

    def resolve_node(self, node: Optional[str],
                     worker: Optional[int]) -> str:
        if node:
            return node
        workers = self.cluster.worker_nodes()
        if worker is None:
            raise ValueError("specify --node or --worker")
        if not 0 <= worker < len(workers):
            raise ValueError(
                f"--worker {worker} out of range ({len(workers)} workers)"
            )
        return workers[worker]

    def fail_devices(self, node: str, device_ids: List[str]) -> None:
        """Mark devices unhealthy on a node (empty list = all).

        Device IDs come from ``MultiSlice.device_ids`` on the node's
        GLOBAL worker index — the job-level scheme the plugin uses
        (``DevicePlugin::DeviceIds``), valid on every slice of a
        ``--num-slices > 1`` cluster (per-slice ``Slice.device_ids``
        would reject nodes of slice >= 1).
        """
        if not device_ids:
            workers = self.cluster.worker_nodes()
            device_ids = self.cfg.multislice.device_ids(
                workers.index(node))
        from kind_tpu_sim_torch import manifests

        content = "\n".join(device_ids) + "\n"
        self.rt.run(
            "exec", node, "mkdir", "-p", manifests.SIM_STATE_DIR
        )
        self.rt.run(
            "exec", "-i", node, "sh", "-c",
            f"cat > {manifests.UNHEALTHY_FILE}",
            input_text=content,
        )
        log.info("marked %d device(s) unhealthy on %s",
                 len(device_ids), node)

    def heal(self, node: str) -> None:
        from kind_tpu_sim_torch import manifests

        self.rt.run(
            "exec", node, "sh", "-c",
            f"rm -f {manifests.UNHEALTHY_FILE}",
        )
        log.info("healed all devices on %s", node)

    def kill_node(self, node: str) -> None:
        self.rt.run("stop", node)
        log.info("stopped node container %s", node)

    def start_node(self, node: str) -> None:
        self.rt.run("start", node)
        log.info("started node container %s", node)


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


def _fake_chaos_manager(num_slices: int = 1) -> ChaosManager:
    """A ChaosManager over the dry-run control plane — scenario
    plumbing for the device/node fault kinds, no daemon needed."""
    from kind_tpu_sim_torch.cluster import ClusterManager
    from kind_tpu_sim_torch.config import SimConfig
    from kind_tpu_sim_torch.fakes import dry_run_executor
    from kind_tpu_sim_torch.registry import LocalRegistry
    from kind_tpu_sim_torch.runtime import detect_runtime

    cfg = SimConfig(runtime="fake", num_slices=num_slices)
    executor = dry_run_executor(cfg)
    # detect_runtime('fake') binds the SAME recording executor, so
    # scenarios can assert on the full command stream afterwards
    runtime = detect_runtime(executor, prefer="fake")
    cluster = ClusterManager(cfg, runtime,
                             LocalRegistry(cfg, runtime))
    return ChaosManager(cfg, runtime, cluster)


@_scenario("flaky-exec",
           "transient kubectl failures recovered by the classified "
           "retry policy (exponential backoff + jitter)", device=False)
def _scenario_flaky_exec(seed: int) -> dict:
    plan = ChaosSchedule(seed).plan(kinds=("cmd_transient",),
                                    n_faults=2, horizon=4, targets=1)
    fail_attempts = max(1, int(plan.events[0].param))
    fake = FlakyExecutor(fail_attempts=fail_attempts)
    policy = RetryPolicy(max_retries=3, base_ms=1.0, seed=seed)
    commands = (["kubectl", "get", "nodes", "-o", "jsonpath={..}"],
                ["kubectl", "get", "pods", "-A", "-o", "json"])
    results = [run_with_retry(fake, argv, policy=policy)
               for argv in commands]
    ok = all(r.ok for r in results)
    return {
        "plan": plan.as_dict(),
        "injected_failures": fake.injected_failures,
        "commands_completed": sum(1 for r in results if r.ok),
        "ok": bool(ok and fake.injected_failures
                   == fail_attempts * len(commands)),
    }


@_scenario("device-flap",
           "seeded fail/heal cycles through the device plugin's "
           "health channel (dry-run control plane)", device=False)
def _scenario_device_flap(seed: int) -> dict:
    plan = ChaosSchedule(seed).plan(kinds=("device_flap",),
                                    n_faults=3, horizon=6, targets=2)
    mgr = _fake_chaos_manager()
    workers = mgr.cluster.worker_nodes()
    flaps = 0
    for ev in plan.events:
        node = workers[ev.target % len(workers)]
        mgr.fail_devices(node, [])
        mgr.heal(node)
        flaps += 1
        metrics.recovery_log().record("device_flap", node=node)
    cmds = mgr.rt.executor.commands()
    from kind_tpu_sim_torch import manifests

    fails = sum(1 for c in cmds if "cat >" in c or "exec -i" in c)
    heals = sum(1 for c in cmds
                if f"rm -f {manifests.UNHEALTHY_FILE}" in c)
    return {
        "plan": plan.as_dict(),
        "flaps": flaps,
        "fail_writes": fails,
        "heal_writes": heals,
        # every flap must end healed — the recovery invariant
        "ok": bool(flaps == len(plan.events) and heals == flaps),
    }


@_scenario("node-flap",
           "seeded kill/restart cycles of kind node containers "
           "(dry-run control plane)", device=False)
def _scenario_node_flap(seed: int) -> dict:
    plan = ChaosSchedule(seed).plan(
        kinds=("node_kill", "node_restart"), n_faults=4, horizon=8,
        targets=2)
    mgr = _fake_chaos_manager()
    workers = mgr.cluster.worker_nodes()
    killed: List[str] = []
    for ev in plan.events:
        node = workers[ev.target % len(workers)]
        if ev.kind == "node_kill":
            mgr.kill_node(node)
            killed.append(node)
            metrics.recovery_log().record("node_kill", node=node)
        else:
            mgr.start_node(node)
            metrics.recovery_log().record("node_restart", node=node)
    # recovery invariant: every killed node is restarted before the
    # scenario ends, whatever order the plan drew. sorted(): set
    # order is hash-seed noise, and these restarts drive the
    # recorded command stream scenarios assert on byte-for-byte.
    for node in sorted(set(killed)):
        mgr.start_node(node)
    cmds = mgr.rt.executor.commands()
    stops = [c for c in cmds if c.startswith("docker stop")]
    starts = [c for c in cmds if c.startswith("docker start")]
    ok = all(any(s.endswith(node) for s in starts)
             for node in sorted(set(killed)))
    return {
        "plan": plan.as_dict(),
        "kills": len(stops),
        "restarts": len(starts),
        "ok": bool(ok),
    }


# The device scenarios import torch and the models inside their
# functions: the fault vocabulary, the plans and the analytic scenarios
# load without torch (cold workers, the tuner's chaos schedules).


def _tiny_config(max_seq: int) -> "tf.ModelConfig":
    """The reference scenarios' model (bf16 activations)."""
    from kind_tpu_sim_torch.models import transformer as tf

    return tf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                          d_ff=64, max_seq=max_seq)


def _params(cfg: "tf.ModelConfig", dev: "torch.device"):
    import torch

    from kind_tpu_sim_torch.models import transformer as tf

    return tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)


@_scenario("preempt-train",
           "SIGTERM mid-step; checkpoint written, resume reproduces the "
           "uninterrupted loss trajectory", slow=True)
def _scenario_preempt_train(seed: int, *, device="cuda",
                            cfg: Optional["tf.ModelConfig"] = None) -> dict:
    from kind_tpu_sim_torch.device import resolve
    from kind_tpu_sim_torch.models import checkpoint as ckpt

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
                                   cfg: Optional["tf.ModelConfig"] = None
                                   ) -> dict:
    import numpy as np

    from kind_tpu_sim_torch.device import resolve
    from kind_tpu_sim_torch.models.serving import (Request, ServingConfig,
                                                   ServingEngine)

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
                               cfg: Optional["tf.ModelConfig"] = None) -> dict:
    from kind_tpu_sim_torch.device import resolve
    from kind_tpu_sim_torch.models.serving import (Request, ServingConfig,
                                                   ServingEngine)

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


# ---------------------------------------------------------------------
# the cold worker grids (wall clock: real subprocess workers)


@_scenario("worker-crash-grid",
           "a slice worker killed mid-sweep; its grid cells requeue "
           "on survivors and results match the fault-free run",
           device=False)
def _scenario_worker_crash_grid(seed: int) -> dict:
    from kind_tpu_sim_torch.parallel import multihost

    plan = ChaosSchedule(seed).plan(kinds=("worker_crash",),
                                    n_faults=1, horizon=6, targets=2)
    ev = plan.events[0]
    cells = [{"cell": i, "payload": seed} for i in range(6)]
    clean, _ = multihost.scatter_grid_cells(cells, workers=2, timeout=120.0)
    faulted, stats = multihost.scatter_grid_cells(
        cells, workers=2, timeout=120.0,
        fault=("crash", ev.at % len(cells)))
    return {
        "plan": plan.as_dict(),
        "cells": len(cells),
        "faults_injected": stats["faults_injected"],
        "requeues": stats["requeues"],
        "respawns": stats["respawns"],
        "results_identical": faulted == clean,
        "ok": bool(faulted == clean
                   and stats["faults_injected"] == 1
                   and stats["requeues"] >= 1),
    }


@_scenario("worker-hang-grid",
           "a slice worker wedges mid-cell; the deadline kill "
           "requeues its cell and the sweep still completes",
           device=False)
def _scenario_worker_hang_grid(seed: int) -> dict:
    from kind_tpu_sim_torch.parallel import multihost

    plan = ChaosSchedule(seed).plan(kinds=("worker_hang",),
                                    n_faults=1, horizon=5, targets=2)
    ev = plan.events[0]
    cells = [{"cell": i, "payload": seed} for i in range(5)]
    clean, _ = multihost.scatter_grid_cells(cells, workers=2, timeout=120.0)
    faulted, stats = multihost.scatter_grid_cells(
        cells, workers=2, timeout=120.0, cell_timeout=3.0,
        fault=("hang", ev.at % len(cells), ev.param * 20))
    return {
        "plan": plan.as_dict(),
        "cells": len(cells),
        "faults_injected": stats["faults_injected"],
        "requeues": stats["requeues"],
        "results_identical": faulted == clean,
        "ok": bool(faulted == clean
                   and stats["faults_injected"] == 1
                   and stats["requeues"] >= 1),
    }


def derive_straggler_bounds(clean_a_s: float, clean_b_s: float,
                            stall_s: float) -> Dict[str, float]:
    """The straggler grid's makespan bounds, from two clean runs (their
    spread is this host's wall-clock noise now) and the injected stall,
    an absolute quantity: detection on must finish under 1.25x the
    slower clean run plus 0.9 of a stall (``on_limit_s``: the detector
    eats at most about a window of stalled work before it quarantines),
    and detection off must take longer than the faster clean run plus
    0.6 of a stall (``off_floor_s``: the unmitigated straggler puts
    stalled work into the makespan). Additive stall terms, unlike
    ratios, are not made or erased by a uniform slowdown of the host."""
    calib_hi = max(clean_a_s, clean_b_s)
    calib_lo = max(1e-9, min(clean_a_s, clean_b_s))
    return {
        "calib_hi_s": calib_hi,
        "calib_lo_s": calib_lo,
        "on_limit_s": 1.25 * calib_hi + 0.9 * stall_s,
        "off_floor_s": calib_lo + 0.6 * stall_s,
    }


@_scenario("gray-straggler-grid",
           "a gray straggler worker (alive but slow) is probed out "
           "and quarantined; the grid rebalances and its wall "
           "recovers to within a calibration-derived tolerance of "
           "fault-free, results bit-identical — detection-off "
           "provably does not recover",
           device=False)
def _scenario_gray_straggler_grid(seed: int) -> dict:
    from kind_tpu_sim_torch import health
    from kind_tpu_sim_torch.parallel import multihost

    plan = ChaosSchedule(seed).plan(kinds=("straggler_worker",),
                                    n_faults=1, horizon=8, targets=6)
    ev = plan.events[0]
    workers = 6
    stall = min(2.4, max(1.6, ev.param))
    cells = [{"cell": i, "payload": seed % 997, "sleep_s": 0.08}
             for i in range(36)]
    hcfg = dataclasses.replace(health.DetectorConfig.from_env(),
                               probe_timeout_s=0.8)
    # two clean runs: the calibration the bounds derive from
    clean, clean_stats = multihost.scatter_grid_cells(
        cells, workers=workers, timeout=180.0, detect=True, health_cfg=hcfg)
    clean2, clean2_stats = multihost.scatter_grid_cells(
        cells, workers=workers, timeout=180.0, detect=True, health_cfg=hcfg)
    bounds = derive_straggler_bounds(
        clean_stats["makespan_s"], clean2_stats["makespan_s"], stall)
    fault = ("straggler", ev.target % workers, stall)
    on, on_stats = multihost.scatter_grid_cells(
        cells, workers=workers, timeout=180.0, detect=True, health_cfg=hcfg,
        fault=fault, max_respawns=1)
    off, off_stats = multihost.scatter_grid_cells(
        cells, workers=workers, timeout=240.0, fault=fault, max_respawns=0)
    detected = (on_stats["quarantines"] + on_stats["speculative"]) >= 1
    # the hard transitions alone: no wall-clock value in the report
    detection = [d for d in on_stats.get("detection", [])
                 if d["transition"] in ("quarantined", "restored")]
    recovered = on_stats["makespan_s"] <= bounds["on_limit_s"]
    off_degraded = off_stats["makespan_s"] >= bounds["off_floor_s"]
    return {
        "plan": plan.as_dict(),
        "workers": workers,
        "cells": len(cells),
        "faulted_worker": ev.target % workers,
        "results_identical": bool(on == clean and off == clean
                                  and clean2 == clean),
        "fault_free_quarantines": clean_stats["quarantines"]
        + clean2_stats["quarantines"],
        "detected": bool(detected),
        "detection": detection,
        "recovered_within_tolerance": bool(recovered),
        "off_degraded": bool(off_degraded),
        "ok": bool(on == clean and off == clean and clean2 == clean
                   and clean_stats["quarantines"] == 0
                   and clean2_stats["quarantines"] == 0
                   and detected and recovered and off_degraded),
    }

def _window_p99_ttft(completions, t_from: float,
                     t_to: float) -> Optional[float]:
    """p99 TTFT over requests ARRIVING in [t_from, t_to) — the
    post-detection recovery window the gray fleet scenarios are
    judged over."""
    vals = [(e["first_s"] if e["first_s"] is not None
             else e["finish_s"]) - e["arrival_s"]
            for e in completions
            if t_from <= e["arrival_s"] < t_to]
    return fleet.brute_force_percentile(vals, 0.99)


def _overload_window_stats(completions, t_from: float,
                           t_to: float) -> dict:
    """Windowed observables the overload scenarios are judged on:
    p99 TTFT over arrivals in the window plus attained-goodput
    (tokens of SLO-attained requests per second of window)."""
    toks = sum(e["tokens"] for e in completions
               if t_from <= e["arrival_s"] < t_to and e["slo_ok"])
    return {
        "p99_ttft_s": _window_p99_ttft(completions, t_from, t_to),
        "goodput_tok_s": round(toks / max(1e-9, t_to - t_from), 3),
    }


@_scenario("fleet-flaky-replica",
           "a fleet replica fails and heals repeatedly under seeded "
           "open-loop traffic; every request still completes and "
           "post-recovery SLO attainment matches the fault-free run", device=False)
def _scenario_fleet_flaky_replica(seed: int) -> dict:
    plan = ChaosSchedule(seed).plan(kinds=("replica_flap",),
                                    n_faults=2, horizon=8, targets=3)
    spec = fleet.WorkloadSpec(process="poisson", rps=300.0,
                              n_requests=120, prompt_len=(8, 24),
                              max_new=(4, 12))
    trace = fleet.generate_trace(spec, seed)
    sim_cfg = fleet.SimReplicaConfig(max_slots=4,
                                     prefill_per_tok_s=0.002,
                                     tpot_s=0.002)
    fc = fleet.FleetConfig(replicas=3, policy="least-outstanding",
                           tick_s=0.01, sim=sim_cfg,
                           slo=fleet.SloPolicy(ttft_s=1.0,
                                               e2e_s=5.0))
    clean = fleet.FleetSim(fc, trace).run()
    span = clean["virtual_s"]
    events = []
    last_restore = 0.0
    for ev in plan.events:
        # flaps land in the first 60% of the clean makespan so
        # arrivals keep coming after the final heal (the recovery
        # window the invariant is judged over)
        at = round((ev.at + 1) / 9.0 * span * 0.6, 6)
        heal = round(at + 0.05 * span, 6)
        events.append(fleet.ChaosEvent(at_s=at, action="preempt",
                                       target=ev.target % 3))
        events.append(fleet.ChaosEvent(at_s=heal, action="restore",
                                       target=ev.target % 3))
        last_restore = max(last_restore, heal)
    faulted = fleet.FleetSim(fc, trace, chaos_events=events).run()
    tail_clean = fleet.attainment_over(clean["completions"],
                                       last_restore)
    tail_faulted = fleet.attainment_over(faulted["completions"],
                                         last_restore)
    tokens = lambda rep: sum(e["tokens"] for e in rep["completions"])  # noqa: E731
    recovered = (tail_clean is None or tail_faulted is None
                 or tail_faulted >= tail_clean)
    return {
        "plan": plan.as_dict(),
        "requests": len(trace),
        "flaps": len(plan.events),
        "requeues": faulted["router"]["requeues"],
        "tail_attainment_clean": tail_clean,
        "tail_attainment_faulted": tail_faulted,
        "ok": bool(faulted["ok"] and clean["ok"]
                   and tokens(faulted) == tokens(clean)
                   and recovered),
    }


@_scenario("tenant-noisy-neighbor",
           "the batch tenant floods a tenanted fleet mid-window; "
           "per-tenant quotas throttle the aggressor, weighted-fair "
           "queuing holds the interactive victim's p99 near its "
           "alone-run, zero requests are lost, and the isolation-off "
           "contrast is reported alongside", device=False)
def _scenario_tenant_noisy_neighbor(seed: int) -> dict:
    from kind_tpu_sim_torch.fleet import tenancy as tenancy_mod

    plan = ChaosSchedule(seed).plan(kinds=("noisy_neighbor",),
                                    n_faults=1, horizon=8, targets=1)
    mult = plan.events[0].param
    ten = tenancy_mod.default_tenancy()
    spec = fleet.WorkloadSpec(process="poisson", rps=90.0,
                              n_requests=240, prompt_len=(4, 16),
                              max_new=(4, 10), tenancy=ten)
    base = fleet.generate_trace(spec, seed)
    span = max(r.arrival_s for r in base)
    t0 = round(span * 0.3, 6)
    t1 = round(span * 0.7, 6)
    flood = tenancy_mod.tenant_surge_trace(spec, seed, t0, t1,
                                           mult, "bronze")
    slo = fleet.SloPolicy(ttft_s=1.0, e2e_s=5.0)
    # enforcement config: same tenant population (the traffic
    # signature covers only traffic-shaping fields, so the trace is
    # unchanged) but a tighter batch quota and a finer DRR quantum —
    # the admission bursts the stock burst allows are exactly the
    # slot-occupancy spikes that would bleed into the victim's p99
    enforce = tenancy_mod.TenancyConfig(
        tenants=tuple(
            (dataclasses.replace(t, quota_rps=22.0, quota_burst=3.0)
             if t.name == "bronze" else t)
            for t in ten.tenants),
        drr_quantum=1.0)
    cfg = fleet.FleetConfig(replicas=3, policy="least-outstanding",
                            slo=slo, tenancy=enforce)
    # the victim's alone-run: the interactive tenant's own trace on
    # the same fleet, nobody else admitted — its entitled latency
    alone = fleet.FleetSim(
        cfg, [r for r in base if r.tenant == "gold"]).run()
    noisy = fleet.FleetSim(cfg, flood).run()
    replay = fleet.FleetSim(cfg, tenancy_mod.tenant_surge_trace(
        spec, seed, t0, t1, mult, "bronze")).run()
    # the contrast column: same flood, isolation off (FIFO router,
    # no quotas enforced at admission) — reported, not gated
    off_cfg = fleet.FleetConfig(
        replicas=3, policy="least-outstanding", slo=slo,
        tenancy=tenancy_mod.TenancyConfig(tenants=enforce.tenants,
                                          isolation=False))
    off = fleet.FleetSim(off_cfg, flood).run()

    def victim_p99(rep: dict) -> Optional[float]:
        gold = rep["tenancy"]["slo"].get("gold", {})
        return gold.get("e2e", {}).get("p99_s")

    p99_alone = victim_p99(alone)
    p99_noisy = victim_p99(noisy)
    p99_off = victim_p99(off)
    ratio = (round(p99_noisy / p99_alone, 6)
             if p99_alone and p99_noisy is not None else None)
    bronze = noisy["tenancy"]["tenants"]["bronze"]
    return {
        "plan": plan.as_dict(),
        "requests": len(flood),
        "multiplier": mult,
        "victim_p99_alone_s": p99_alone,
        "victim_p99_noisy_s": p99_noisy,
        "victim_p99_isolation_off_s": p99_off,
        "victim_p99_ratio": ratio,
        "aggressor_quota_shed": bronze["quota_shed"],
        "aggressor_admitted": bronze["admitted"],
        "fair_queue_rounds":
            noisy["router"]["fair_queue"]["rounds"],
        "replay_identical": noisy == replay,
        "ok": bool(noisy["ok"] and alone["ok"]
                   and noisy == replay
                   and bronze["quota_shed"] >= 1
                   and ratio is not None and ratio <= 1.25),
    }


@_scenario("sched-node-drain",
           "a TPU node drained mid-traffic under the scheduler-"
           "backed fleet: its replica's gang evicts, reschedules "
           "onto surviving nodes, warms up, and post-recovery SLO "
           "attainment matches the fault-free run", device=False)
def _scenario_sched_node_drain(seed: int) -> dict:
    plan = ChaosSchedule(seed).plan(kinds=("node_drain",),
                                    n_faults=1, horizon=4, targets=4)
    ev = plan.events[0]
    # arrivals span ~4 virtual seconds — long enough that the
    # evicted gang's rebind + bind latency + 0.55s warm-up all land
    # WELL before the last third of the trace (the judged window)
    spec = fleet.WorkloadSpec(process="poisson", rps=60.0,
                              n_requests=240, prompt_len=(8, 24),
                              max_new=(4, 12))
    trace = fleet.generate_trace(spec, seed)
    sim_cfg = fleet.SimReplicaConfig(max_slots=4,
                                     prefill_per_tok_s=0.002,
                                     tpot_s=0.002)
    fc = fleet.FleetConfig(replicas=2, policy="least-outstanding",
                           tick_s=0.01, sim=sim_cfg,
                           slo=fleet.SloPolicy(ttft_s=1.0,
                                               e2e_s=5.0),
                           sched=fleet.FleetSchedConfig())
    clean = fleet.FleetSim(fc, trace).run()
    # drain a node that PROVABLY hosts a replica gang (the runs are
    # identical up to the drain instant, so the clean run's t=0
    # placement names the victim) — displacement is guaranteed, not
    # seed-lucky; ChaosEvent.target is the node's index in the
    # sorted inventory, the same resolution FleetSim applies
    victim_replica = ev.target % fc.replicas
    placed = next(
        e for e in clean["scheduler"]["events"]
        if e["type"] == "Scheduled"
        and e["gang"] == f"replica-{victim_replica}")
    node_names = sorted(
        n["name"]
        for d in fleet.FleetSim(fc, []).sched.inv.as_dict()[
            "domains"].values()
        for n in d["nodes"])
    target = node_names.index(placed["nodes"][0])
    # the drain lands a third into the arrival window and the node
    # restores at two thirds — a full third of the trace arrives
    # post-restore, so the recovery window has real traffic to judge
    arr_max = max(r.arrival_s for r in trace)
    at = round(arr_max / 3.0, 6)
    restore = round(2.0 * arr_max / 3.0, 6)
    events = [
        fleet.ChaosEvent(at_s=at, action="node_drain",
                         target=target),
        fleet.ChaosEvent(at_s=restore, action="node_restore",
                         target=target),
    ]
    faulted = fleet.FleetSim(fc, trace, chaos_events=events).run()
    tail_clean = fleet.attainment_over(clean["completions"],
                                       restore)
    tail_faulted = fleet.attainment_over(faulted["completions"],
                                         restore)
    tokens = lambda rep: sum(e["tokens"] for e in rep["completions"])  # noqa: E731
    recovered = (tail_clean is None or tail_faulted is None
                 or tail_faulted >= tail_clean)
    sched_counts = faulted["scheduler"]["event_counts"]
    return {
        "plan": plan.as_dict(),
        "requests": len(trace),
        "drain_at_s": at,
        "restore_at_s": restore,
        "sched_events": sched_counts,
        "requeues": faulted["router"]["requeues"],
        "tail_attainment_clean": tail_clean,
        "tail_attainment_faulted": tail_faulted,
        "ok": bool(faulted["ok"] and clean["ok"]
                   and tokens(faulted) == tokens(clean)
                   and sched_counts.get("NodeDrained", 0) == 1
                   and recovered),
    }


@_scenario("sched-preemption-priority",
           "a full cluster meets a high-priority gang: the "
           "scheduler evicts strictly-lower-priority victims "
           "(never equals), reschedules them when capacity frees, "
           "and the seeded event log replays byte-identically", device=False)
def _scenario_sched_preemption(seed: int) -> dict:
    from kind_tpu_sim_torch import sched as sched_mod

    plan = ChaosSchedule(seed).plan(kinds=("node_fail",),
                                    n_faults=1, horizon=8, targets=4)
    ev = plan.events[0]
    # one v5e 4x8 pod: 4 hosts. Fill with 4 low-priority single-host
    # batch gangs that release in a few virtual seconds, then land a
    # high-priority 2-host slice on the full cluster.
    def run():
        inv = sched_mod.build_inventory(
            [("tpu-v5-lite-podslice", "4x8")])
        sched = sched_mod.ClusterScheduler(
            inv, sched_mod.SchedConfig(policy="ici"))
        for i in range(4):
            # hold times vary with the seed so different soak draws
            # exercise different release orders
            sched.submit(sched_mod.SliceRequest(
                name=f"batch-{i}", topology="2x4", priority=-10,
                hold_s=round(3.0 + ((seed >> i) + i) % 4, 6)),
                0.0)
        sched.step(0.0)
        sched.submit(sched_mod.SliceRequest(
            name="serving-hi", topology="4x4", priority=10), 1.0)
        sched.step(1.0)
        # batch victims rescheduled as their preemptor's capacity
        # frees (hold expiry releases both tiers over time)
        now = 1.0
        while (sched.pending or any(
                g.release_s is not None
                for g in sched.bound.values())):
            now = round(now + 0.5, 6)
            if now > 60.0:
                break
            sched.step(now)
        return sched

    s1 = run()
    s2 = run()
    evicted = [e for e in s1.events if e["type"] == "Preempted"]
    hi_bound = [e for e in s1.events
                if e["type"] == "Scheduled"
                and e["gang"] == "serving-hi"]
    sched_counts: Dict[str, int] = {}
    for e in s1.events:
        if e["type"] == "Scheduled":
            sched_counts[e["gang"]] = (
                sched_counts.get(e["gang"], 0) + 1)
    victims = {e["gang"] for e in evicted}
    # a victim was RE-scheduled iff it has a second Scheduled event
    batch_resched = {g for g, n in sched_counts.items()
                     if g.startswith("batch") and n >= 2}
    # strictly-by-priority invariant: only priority -10 batch gangs
    # may ever be displaced by the priority-10 preemptor
    strict = all(g.startswith("batch-") for g in victims)
    identical = (json.dumps(s1.events, sort_keys=True)
                 == json.dumps(s2.events, sort_keys=True))
    metrics.recovery_log().record(
        "sched_preemption_scenario", victims=len(victims),
        fault_target=ev.target)
    return {
        "plan": plan.as_dict(),
        "evictions": len(evicted),
        "victims": sorted(victims),
        "high_priority_bound": bool(hi_bound),
        "victims_rescheduled": sorted(
            batch_resched & victims),
        "events_identical": identical,
        "ok": bool(hi_bound and evicted and strict and identical
                   and victims <= batch_resched),
    }


@_scenario("gray-slow-replica",
           "one fleet replica silently slows under seeded traffic; "
           "the detector quarantines it, the router routes around, "
           "probes restore it after the fault lifts, and windowed "
           "p99 TTFT recovers to within tolerance of fault-free — "
           "detection-off provably does not", device=False)
def _scenario_gray_slow_replica(seed: int) -> dict:
    from kind_tpu_sim_torch import health

    plan = ChaosSchedule(seed).plan(kinds=("slow_replica",),
                                    n_faults=1, horizon=8, targets=3)
    ev = plan.events[0]
    target = ev.target % 3
    factor = max(3.0, ev.param)
    spec = fleet.WorkloadSpec(process="poisson", rps=60.0,
                              n_requests=500, prompt_len=(8, 24),
                              max_new=(4, 12))
    trace = fleet.generate_trace(spec, seed)
    span = max(r.arrival_s for r in trace)
    t1, t2 = round(span * 0.25, 6), round(span * 0.65, 6)
    sim_cfg = fleet.SimReplicaConfig(max_slots=4,
                                     prefill_per_tok_s=0.002,
                                     tpot_s=0.002)
    events = [fleet.ChaosEvent(at_s=t1, action="slow",
                               target=target, param=factor),
              fleet.ChaosEvent(at_s=t2, action="unslow",
                               target=target)]
    hcfg = health.DetectorConfig.from_env()

    def run(detect: bool, ev_list):
        fc = fleet.FleetConfig(
            replicas=3, policy="least-outstanding", tick_s=0.01,
            sim=sim_cfg, slo=fleet.SloPolicy(ttft_s=1.0, e2e_s=5.0),
            health=(hcfg if detect else None))
        return fleet.FleetSim(fc, trace,
                              chaos_events=list(ev_list)).run()

    clean = run(True, [])
    on = run(True, events)
    replay = run(True, events)
    off = run(False, events)
    counters = on["health"]["counters"]
    q_events = [e for e in on["health"]["detector"]["events"]
                if e["transition"] == "quarantined"]
    t_q = q_events[0]["at_s"] if q_events else t1 + 0.5
    p99_clean = _window_p99_ttft(clean["completions"], t_q, t2)
    p99_on = _window_p99_ttft(on["completions"], t_q, t2)
    p99_off = _window_p99_ttft(off["completions"], t_q, t2)
    tokens = lambda rep: sum(e["tokens"]  # noqa: E731
                             for e in rep["completions"])
    recovered = (p99_clean is not None and p99_on is not None
                 and p99_on <= 1.25 * p99_clean)
    off_degraded = (p99_clean is not None and p99_off is not None
                    and p99_off > 1.25 * p99_clean)
    identical = (json.dumps(on["completions"], sort_keys=True)
                 == json.dumps(replay["completions"],
                                sort_keys=True)
                 and json.dumps(on["health"]["detector"]["events"],
                                 sort_keys=True)
                 == json.dumps(
                     replay["health"]["detector"]["events"],
                     sort_keys=True))
    restored = any(e["transition"] == "restored"
                   and e["component"] == f"replica-{target}"
                   for e in on["health"]["detector"]["events"])
    return {
        "plan": plan.as_dict(),
        "requests": len(trace),
        "slow_replica": target,
        "factor": round(factor, 3),
        "fault_free_quarantines":
            clean["health"]["counters"].get("quarantines", 0),
        "quarantines": counters.get("quarantines", 0),
        "false_positives": counters.get("false_positives", 0),
        "restored_via_probes": bool(restored),
        "p99_recovered": bool(recovered),
        "p99_off_degraded": bool(off_degraded),
        "replay_identical": bool(identical),
        "ok": bool(clean["ok"] and on["ok"] and off["ok"]
                   and clean["health"]["counters"].get(
                       "quarantines", 0) == 0
                   and counters.get("quarantines", 0) >= 1
                   and counters.get("false_positives", 0) == 0
                   and restored
                   and tokens(on) == tokens(clean) == tokens(off)
                   and recovered and off_degraded and identical),
    }


@_scenario("gray-degraded-ici",
           "an ICI link degrades under a scheduler-backed fleet: "
           "the replicas on that domain are quarantined and their "
           "gangs migrate (one at a time) onto the healthy domain, "
           "the scheduler scores the degraded domain last, and "
           "windowed p99 TTFT recovers to fault-free levels — "
           "detection-off stays degraded until the link heals", device=False)
def _scenario_gray_degraded_ici(seed: int) -> dict:
    from kind_tpu_sim_torch import health

    plan = ChaosSchedule(seed).plan(kinds=("degraded_link",),
                                    n_faults=1, horizon=8, targets=2)
    ev = plan.events[0]
    factor = min(0.25, max(0.08, ev.param))
    spec = fleet.WorkloadSpec(process="poisson", rps=60.0,
                              n_requests=500, prompt_len=(8, 24),
                              max_new=(4, 12))
    trace = fleet.generate_trace(spec, seed)
    span = max(r.arrival_s for r in trace)
    t1, t2 = round(span * 0.25, 6), round(span * 0.7, 6)
    sim_cfg = fleet.SimReplicaConfig(max_slots=4,
                                     prefill_per_tok_s=0.002,
                                     tpot_s=0.002)
    # spread placement: one replica per ICI domain, so degrading one
    # domain grays out ONE replica — ici/binpack would co-locate both
    # gangs and a single bad link would migrate the whole fleet
    sc = fleet.FleetSchedConfig(
        pods=(("tpu-v5-lite-podslice", "4x8"),
              ("tpu-v5-lite-podslice", "4x8")),
        policy="spread")
    hcfg = health.DetectorConfig.from_env()

    def run(detect: bool, ev_list):
        fc = fleet.FleetConfig(
            replicas=2, policy="least-outstanding", tick_s=0.01,
            sim=sim_cfg, slo=fleet.SloPolicy(ttft_s=1.0, e2e_s=5.0),
            sched=sc, health=(hcfg if detect else None))
        return fleet.FleetSim(fc, trace,
                              chaos_events=list(ev_list)).run()

    clean = run(True, [])
    # degrade the domain that PROVABLY hosts a replica gang (the
    # runs are identical up to the degrade instant, so the clean
    # run's t=0 placement names the victim domain)
    placed = next(
        e for e in clean["scheduler"]["events"]
        if e["type"] == "Scheduled"
        and e["gang"] == f"replica-{ev.target % 2}")
    victim_domain = int(placed["nodes"][0].split("-")[2])
    events = [fleet.ChaosEvent(at_s=t1, action="link_degrade",
                               target=victim_domain, param=factor),
              fleet.ChaosEvent(at_s=t2, action="link_restore",
                               target=victim_domain)]
    on = run(True, events)
    replay = run(True, events)
    off = run(False, events)
    counters = on["health"]["counters"]
    sched_counts = on["scheduler"]["event_counts"]
    restored_events = [
        e for e in on["health"]["detector"]["events"]
        if e["transition"] == "restored"]
    ready = (max(e["at_s"] for e in restored_events) + 0.3
             if restored_events else t1 + 1.0)
    p99_clean = _window_p99_ttft(clean["completions"], ready, t2)
    p99_on = _window_p99_ttft(on["completions"], ready, t2)
    p99_off = _window_p99_ttft(off["completions"], ready, t2)
    # every post-migration Scheduled event must land OFF the
    # degraded domain (the scoring + avoid-mark contract)
    migrated_clean = all(
        int(e["nodes"][0].split("-")[2]) != victim_domain
        for e in on["scheduler"]["events"]
        if e["type"] == "Scheduled" and e["at_s"] > t1)
    tokens = lambda rep: sum(e["tokens"]  # noqa: E731
                             for e in rep["completions"])
    recovered = (p99_clean is not None and p99_on is not None
                 and p99_on <= 1.25 * p99_clean)
    off_degraded = (p99_clean is not None and p99_off is not None
                    and p99_off > 1.25 * p99_clean)
    identical = (
        json.dumps(on["completions"], sort_keys=True)
        == json.dumps(replay["completions"], sort_keys=True)
        and json.dumps(on["scheduler"]["events"], sort_keys=True)
        == json.dumps(replay["scheduler"]["events"],
                       sort_keys=True)
        and json.dumps(on["health"]["detector"]["events"],
                        sort_keys=True)
        == json.dumps(replay["health"]["detector"]["events"],
                       sort_keys=True))
    return {
        "plan": plan.as_dict(),
        "requests": len(trace),
        "degraded_domain": victim_domain,
        "link_factor": round(factor, 3),
        "fault_free_quarantines":
            clean["health"]["counters"].get("quarantines", 0),
        "quarantines": counters.get("quarantines", 0),
        "false_positives": counters.get("false_positives", 0),
        "gray_migrations": counters.get("gray_migrations", 0),
        "link_events": {
            "degraded": sched_counts.get("LinkDegraded", 0),
            "restored": sched_counts.get("LinkRestored", 0)},
        "migrations_avoid_degraded_domain": bool(migrated_clean),
        "p99_recovered": bool(recovered),
        "p99_off_degraded": bool(off_degraded),
        "replay_identical": bool(identical),
        "ok": bool(clean["ok"] and on["ok"] and off["ok"]
                   and clean["health"]["counters"].get(
                       "quarantines", 0) == 0
                   and counters.get("quarantines", 0) >= 1
                   and counters.get("false_positives", 0) == 0
                   and counters.get("gray_migrations", 0) >= 1
                   and sched_counts.get("LinkDegraded", 0) == 1
                   and migrated_clean
                   and tokens(on) == tokens(clean) == tokens(off)
                   and recovered and off_degraded and identical),
    }


@_scenario("overload-surge",
           "a seeded demand surge (step multiplier on arrivals) "
           "saturates the fleet: retry budgets, hedging bounds, "
           "breakers, and brownout keep goodput above the floor and "
           "p99 recovers to fault-free once the surge clears, while "
           "a controls-off client provably enters sustained "
           "metastable collapse — load returns to normal, latency "
           "does not", device=False)
def _scenario_overload_surge(seed: int) -> dict:
    plan = ChaosSchedule(seed).plan(kinds=("demand_surge",),
                                    n_faults=1, horizon=8, targets=1)
    mult = min(5.0, max(3.0, plan.events[0].param))
    # ~72% base utilization (3 replicas x 4 slots at ~17 req/s per
    # slot): healthy headroom fault-free, saturated x3-x5 under the
    # surge; the tight deadline makes saturation produce the misses
    # a storm feeds on
    spec = fleet.WorkloadSpec(process="poisson", rps=150.0,
                              n_requests=900, prompt_len=(8, 24),
                              max_new=(4, 12), deadline_s=0.6)
    base = fleet.generate_trace(spec, seed)
    span = max(r.arrival_s for r in base)
    t0, t1 = round(span * 0.3, 6), round(span * 0.45, 6)
    surge = fleet.surge_trace(spec, seed, t0, t1, mult)
    sim_cfg = fleet.SimReplicaConfig(max_slots=4,
                                     prefill_per_tok_s=0.002,
                                     tpot_s=0.002)
    slo = fleet.SloPolicy(ttft_s=0.3, e2e_s=0.6)

    def run(trace, ov):
        fc = fleet.FleetConfig(replicas=3,
                               policy="least-outstanding",
                               tick_s=0.01, sim=sim_cfg, slo=slo,
                               max_queue=512, overload=ov,
                               max_virtual_s=60.0)
        return fleet.FleetSim(fc, trace).run()

    clean = run(base, fleet.OverloadConfig())
    on = run(surge, fleet.OverloadConfig())
    replay = run(surge, fleet.OverloadConfig())
    off = run(surge, fleet.OverloadConfig.uncontrolled(
        max_attempts=6))
    # the judged windows: goodput floor DURING the surge, p99
    # recovery well after the trigger cleared (arrivals only — the
    # backlog-drain period must not pollute the recovery verdict)
    w0, w1 = round(t1 + 2.0, 6), round(span - 0.2, 6)
    surge_clean = _overload_window_stats(clean["completions"],
                                         t0, t1)
    surge_on = _overload_window_stats(on["completions"], t0, t1)
    rec_clean = _overload_window_stats(clean["completions"], w0, w1)
    rec_on = _overload_window_stats(on["completions"], w0, w1)
    rec_off = _overload_window_stats(off["completions"], w0, w1)
    goodput_floor = 0.4  # fraction of fault-free surge-window goodput
    floor_held = (surge_on["goodput_tok_s"]
                  >= goodput_floor * surge_clean["goodput_tok_s"])
    p_c = rec_clean["p99_ttft_s"]
    p_on = rec_on["p99_ttft_s"]
    p_off = rec_off["p99_ttft_s"]
    recovered = (p_c is not None and p_on is not None
                 and p_on <= 1.25 * p_c)
    # the metastable signature: arrivals are back at the base rate
    # in the judged window, yet the controls-off fleet still serves
    # them collapsed
    off_collapsed = (p_c is not None and p_off is not None
                     and p_off > 1.25 * p_c)
    oc_on = on["overload"]["counters"]
    oc_off = off["overload"]["counters"]
    identical = (json.dumps(on["completions"], sort_keys=True)
                 == json.dumps(replay["completions"],
                                sort_keys=True)
                 and json.dumps(on["overload"], sort_keys=True)
                 == json.dumps(replay["overload"], sort_keys=True))
    return {
        "plan": plan.as_dict(),
        "requests": len(surge),
        "surge_multiplier": round(mult, 3),
        "surge_window_s": [t0, t1],
        "recovery_window_s": [w0, w1],
        "goodput_floor_frac": goodput_floor,
        "surge_goodput_clean": surge_clean["goodput_tok_s"],
        "surge_goodput_on": surge_on["goodput_tok_s"],
        "goodput_floor_held": bool(floor_held),
        "p99_recovery_ratio_on": (round(p_on / p_c, 3)
                                  if p_c and p_on is not None
                                  else None),
        "p99_recovery_ratio_off": (round(p_off / p_c, 3)
                                   if p_c and p_off is not None
                                   else None),
        "retries_suppressed": oc_on.get("retries_suppressed", 0),
        "retries_on": oc_on.get("retries_scheduled", 0),
        "retries_off": oc_off.get("retries_scheduled", 0),
        "hedges_issued": oc_on.get("hedges_issued", 0),
        "hedges_suppressed": oc_on.get("hedges_suppressed", 0),
        "brownout": on["overload"]["brownout"]["transitions"],
        "replay_identical": bool(identical),
        "ok": bool(clean["ok"] and on["ok"] and off["ok"]
                   and floor_held and recovered and off_collapsed
                   and oc_on.get("retries_suppressed", 0) >= 1
                   and oc_off.get("retries_scheduled", 0)
                   > oc_on.get("retries_scheduled", 0)
                   and identical),
    }


@_scenario("retry-storm",
           "a transient replica outage under seeded traffic turns "
           "client retries into a storm: the token-bucket retry "
           "budget suppresses the amplification (suppressed count "
           "proves it) and p99 recovers once the replica heals, "
           "while an unbudgeted client keeps the surviving capacity "
           "saturated long after — the retry-storm flavor of "
           "metastable failure", device=False)
def _scenario_retry_storm(seed: int) -> dict:
    plan = ChaosSchedule(seed).plan(kinds=("retry_storm",),
                                    n_faults=1, horizon=8, targets=2)
    ev = plan.events[0]
    amplification = int(min(5.0, max(3.0, ev.param)))
    # ~85% utilization on 2 replicas: fault-free holds the SLO, but
    # losing one replica mid-trace halves capacity well below the
    # arrival rate — the kick that starts the storm
    spec = fleet.WorkloadSpec(process="poisson", rps=118.0,
                              n_requests=800, prompt_len=(8, 24),
                              max_new=(4, 12), deadline_s=0.6)
    trace = fleet.generate_trace(spec, seed)
    span = max(r.arrival_s for r in trace)
    t1, t2 = round(span * 0.25, 6), round(span * 0.55, 6)
    target = ev.target % 2
    events = [fleet.ChaosEvent(at_s=t1, action="preempt",
                               target=target),
              fleet.ChaosEvent(at_s=t2, action="restore",
                               target=target)]
    sim_cfg = fleet.SimReplicaConfig(max_slots=4,
                                     prefill_per_tok_s=0.002,
                                     tpot_s=0.002)
    slo = fleet.SloPolicy(ttft_s=0.3, e2e_s=0.6)

    def run(evs, ov):
        fc = fleet.FleetConfig(replicas=2,
                               policy="least-outstanding",
                               tick_s=0.01, sim=sim_cfg, slo=slo,
                               max_queue=512, overload=ov,
                               max_virtual_s=60.0)
        return fleet.FleetSim(fc, trace,
                              chaos_events=list(evs)).run()

    clean = run([], fleet.OverloadConfig())
    on = run(events, fleet.OverloadConfig())
    replay = run(events, fleet.OverloadConfig())
    off = run(events, fleet.OverloadConfig.uncontrolled(
        max_attempts=amplification))
    w0, w1 = round(t2 + 2.0, 6), round(span - 0.2, 6)
    rec_clean = _overload_window_stats(clean["completions"], w0, w1)
    rec_on = _overload_window_stats(on["completions"], w0, w1)
    rec_off = _overload_window_stats(off["completions"], w0, w1)
    p_c = rec_clean["p99_ttft_s"]
    p_on = rec_on["p99_ttft_s"]
    p_off = rec_off["p99_ttft_s"]
    recovered = (p_c is not None and p_on is not None
                 and p_on <= 1.25 * p_c)
    off_collapsed = (p_c is not None and p_off is not None
                     and p_off > 1.25 * p_c)
    oc_on = on["overload"]["counters"]
    oc_off = off["overload"]["counters"]
    identical = (json.dumps(on["completions"], sort_keys=True)
                 == json.dumps(replay["completions"],
                                sort_keys=True)
                 and json.dumps(on["overload"], sort_keys=True)
                 == json.dumps(replay["overload"], sort_keys=True))
    return {
        "plan": plan.as_dict(),
        "requests": len(trace),
        "amplification": amplification,
        "outage_window_s": [t1, t2],
        "recovery_window_s": [w0, w1],
        "preempted_replica": target,
        "p99_recovery_ratio_on": (round(p_on / p_c, 3)
                                  if p_c and p_on is not None
                                  else None),
        "p99_recovery_ratio_off": (round(p_off / p_c, 3)
                                   if p_c and p_off is not None
                                   else None),
        "retries_suppressed": oc_on.get("retries_suppressed", 0),
        "retries_on": oc_on.get("retries_scheduled", 0),
        "retries_off": oc_off.get("retries_scheduled", 0),
        "requeues": on["router"]["requeues"],
        "replay_identical": bool(identical),
        "ok": bool(clean["ok"] and on["ok"] and off["ok"]
                   and recovered and off_collapsed
                   and oc_on.get("retries_suppressed", 0) >= 1
                   and oc_off.get("retries_scheduled", 0)
                   > oc_on.get("retries_scheduled", 0)
                   and identical),
    }


@_scenario("train-preempt-economics",
           "a training gang under graceful preemption and a hard "
           "kill, run at a tight (Young-Daly) vs loose checkpoint "
           "cadence: graceful preemptions lose zero steps at BOTH "
           "cadences (the PreemptionGuard contract), the hard kill "
           "loses strictly more at the loose cadence while the "
           "tight one pays more write overhead — the economics the "
           "cadence knob trades — and the ledger verifies zero "
           "duplicated steps, byte-identical on replay", device=False)
def _scenario_train_preempt_economics(seed: int) -> dict:
    plan = ChaosSchedule(seed).plan(
        kinds=("train_preempt", "train_kill"),
        n_faults=2, horizon=8, targets=1)
    spec = fleet.WorkloadSpec(process="poisson", rps=40.0,
                              n_requests=120, prompt_len=(8, 24),
                              max_new=(4, 12))
    trace = fleet.generate_trace(spec, seed)
    sim_cfg = fleet.SimReplicaConfig(max_slots=4,
                                     prefill_per_tok_s=0.002,
                                     tpot_s=0.002)
    sc = fleet.FleetSchedConfig(
        pods=(("tpu-v5-lite-podslice", "4x8"),
              ("tpu-v5-lite-podslice", "4x8")))
    total = 90
    gang = fleet.TrainingGangConfig(name="llm0", total_steps=total)
    step_s = fleet.step_time_s(gang, gang.topology)
    # one graceful preempt early, the hard kill well after it: the
    # kill's rollback distance is then the cadence's to bound
    t_preempt = round(0.5 + 0.1 * plan.events[0].at, 6)
    t_kill = round(t_preempt + 1.2 + 0.05 * plan.events[1].at, 6)
    events = [
        fleet.ChaosEvent(at_s=t_preempt, action="train_preempt",
                         target=0),
        fleet.ChaosEvent(at_s=t_kill, action="train_kill",
                         target=0),
    ]
    write_s = fleet.TrainingConfig().as_dict()[
        "checkpoint_write_s"]
    tight = fleet.optimal_cadence_steps(step_s, write_s,
                                        mtbf_s=1.0)
    loose = total  # only the final checkpoint

    def run(cadence):
        tc = fleet.TrainingConfig(gangs=(dataclasses.replace(
            gang, checkpoint_every=cadence),))
        fc = fleet.FleetConfig(
            replicas=2, policy="least-outstanding", tick_s=0.01,
            sim=sim_cfg, slo=fleet.SloPolicy(ttft_s=1.0, e2e_s=5.0),
            sched=sc, training=tc, max_virtual_s=120.0)
        return fleet.FleetSim(fc, trace,
                              chaos_events=list(events)).run()

    rep_t = run(tight)
    replay = run(tight)
    rep_l = run(loose)
    g_t = rep_t["training"]["gangs"]["llm0"]
    g_l = rep_l["training"]["gangs"]["llm0"]
    eo_t = fleet.expected_overhead(step_s, tight, write_s,
                                   mtbf_s=1.0)
    eo_l = fleet.expected_overhead(step_s, loose, write_s,
                                   mtbf_s=1.0)
    identical = (json.dumps(rep_t, sort_keys=True)
                 == json.dumps(replay, sort_keys=True))
    # graceful-preempt evictions lose nothing: every lost step must
    # be attributable to the ONE hard kill (<= one cadence interval
    # at the tight cadence)
    econ = (g_l["lost_steps"] > g_t["lost_steps"]
            and g_t["lost_steps"] <= tight
            and g_t["checkpoint"]["writes"]
            > g_l["checkpoint"]["writes"]
            and eo_t["write_frac"] > eo_l["write_frac"]
            and eo_t["lost_frac"] < eo_l["lost_frac"])
    return {
        "plan": plan.as_dict(),
        "cadences": {"tight": tight, "loose": loose},
        "preempt_at_s": t_preempt,
        "kill_at_s": t_kill,
        "lost_steps": {"tight": g_t["lost_steps"],
                       "loose": g_l["lost_steps"]},
        "checkpoint_writes": {
            "tight": g_t["checkpoint"]["writes"],
            "loose": g_l["checkpoint"]["writes"]},
        "overhead_frac": {"tight": g_t["overhead_frac"],
                          "loose": g_l["overhead_frac"]},
        "expected_overhead": {"tight": eo_t, "loose": eo_l},
        "ledger_ok": bool(g_t["ledger_verify"]["ok"]
                          and g_l["ledger_verify"]["ok"]),
        "economics_hold": bool(econ),
        "replay_identical": bool(identical),
        "ok": bool(rep_t["ok"] and rep_l["ok"]
                   and g_t["state"] == "done"
                   and g_l["state"] == "done"
                   and g_t["ledger_verify"]["ok"]
                   and g_l["ledger_verify"]["ok"]
                   and econ and identical),
    }


@_scenario("train-mixed-soak",
           "serving + LLM training + Ising batch co-scheduled on "
           "one tight inventory under node_drain / node_fail / "
           "replica_preempt chaos: strict priority preempts "
           "training for serving (never the reverse), every gang "
           "finishes with a clean ledger (zero lost, zero "
           "duplicated steps), serving p99 stays within 1.25x of "
           "serving-alone, and the report is byte-identical on "
           "replay AND with the event core off", device=False)
def _scenario_train_mixed_soak(seed: int) -> dict:
    plan = ChaosSchedule(seed).plan(
        kinds=("node_drain", "replica_preempt", "node_fail"),
        n_faults=3, horizon=9, targets=4)
    spec = fleet.WorkloadSpec(process="poisson", rps=60.0,
                              n_requests=300, prompt_len=(8, 24),
                              max_new=(4, 12))
    trace = fleet.generate_trace(spec, seed)
    span = max(r.arrival_s for r in trace)
    sim_cfg = fleet.SimReplicaConfig(max_slots=4,
                                     prefill_per_tok_s=0.002,
                                     tpot_s=0.002)
    # heterogeneous inventory: serving owns the v5e domain (3
    # whole-host replicas + the Ising batch's chip fragment fill it
    # EXACTLY), training's LLM gang owns a 4-host v4 domain. The
    # accelerator split makes every completion provable — serving
    # can never strand the v4 gang — while the FULL v5e domain
    # forces the strict-priority path: a failed serving node has no
    # free host, so the scheduler must preempt the lowest-priority
    # training tenant (the Ising sweep) to rebind serving
    sc = fleet.FleetSchedConfig(
        pods=(("tpu-v5-lite-podslice", "4x8"),
              ("tpu-v4-podslice", "2x2x4")))
    tc = fleet.TrainingConfig(gangs=(
        fleet.TrainingGangConfig(name="llm0",
                                 accelerator="tpu-v4-podslice",
                                 topology="2x2x4",
                                 total_steps=70,
                                 checkpoint_every=8),
        # long enough that the sweep provably still runs when the
        # node_fail lands at 0.7x the trace span — the sweep IS the
        # strict-priority victim the full domain forces
        fleet.ising_gang("ising0", total_steps=200, priority=-20,
                         checkpoint_every=25),
    ))

    def run(training, event_core=None):
        fc = fleet.FleetConfig(
            replicas=3, policy="least-outstanding", tick_s=0.01,
            sim=sim_cfg, slo=fleet.SloPolicy(ttft_s=1.0, e2e_s=5.0),
            sched=sc, training=(tc if training else None),
            max_virtual_s=120.0, event_core=event_core,
            fast_forward=(False if event_core is False else None))
        return fleet.FleetSim(fc, trace,
                              chaos_events=events).run()

    # the clean mixed run names (a) a node provably hosting the LLM
    # gang (drain it: checkpoint -> evict -> resume on restore) and
    # (b) a node provably hosting a SERVING replica (fail it: the
    # full domain forces preemption of the Ising tenant) —
    # guaranteed displacement, not seed-lucky
    events = []
    clean = run(True)
    node_names = sorted(
        n["name"]
        for d in fleet.FleetSim(
            fleet.FleetConfig(replicas=3, sched=sc),
            []).sched.inv.as_dict()["domains"].values()
        for n in d["nodes"])
    llm_placed = next(
        e for e in clean["scheduler"]["events"]
        if e["type"] == "Scheduled" and e["gang"] == "train-llm0")
    drain_target = node_names.index(
        llm_placed["nodes"][plan.events[0].target
                            % len(llm_placed["nodes"])])
    victim_replica = plan.events[1].target % 3
    srv_placed = next(
        e for e in clean["scheduler"]["events"]
        if e["type"] == "Scheduled"
        and e["gang"] == f"replica-{victim_replica}")
    fail_target = node_names.index(srv_placed["nodes"][0])
    t1 = round(span * 0.2, 6)
    t2 = round(span * 0.45, 6)
    t3 = round(span * 0.55, 6)
    t4 = round(span * 0.7, 6)
    events = [
        fleet.ChaosEvent(at_s=t1, action="node_drain",
                         target=drain_target),
        fleet.ChaosEvent(at_s=t2, action="node_restore",
                         target=drain_target),
        fleet.ChaosEvent(at_s=t3, action="preempt",
                         target=(victim_replica + 1) % 3),
        fleet.ChaosEvent(at_s=round(t3 + 0.1 * span, 6),
                         action="restore",
                         target=(victim_replica + 1) % 3),
        fleet.ChaosEvent(at_s=t4, action="node_fail",
                         target=fail_target),
        fleet.ChaosEvent(at_s=round(t4 + 0.15 * span, 6),
                         action="node_restore",
                         target=fail_target),
    ]
    alone = run(False)
    mixed = run(True)
    replay = run(True)
    off = run(True, event_core=False)
    tr = mixed["training"]
    p99_alone = _window_p99_ttft(alone["completions"], 0.0,
                                 span + 1.0)
    p99_mixed = _window_p99_ttft(mixed["completions"], 0.0,
                                 span + 1.0)
    serving_held = (p99_alone is not None and p99_mixed is not None
                    and p99_mixed <= 1.25 * p99_alone)
    # strict priority: training was preempted FOR serving at least
    # once (the full-domain node_fail path), and NO serving gang
    # was ever displaced by a training gang
    sched_evs = mixed["scheduler"]["events"]
    train_victims = [e for e in sched_evs
                     if e["type"] == "Preempted"
                     and e["gang"].startswith("train-")]
    strict_preempts = [e for e in train_victims
                       if "preempted by" in e["message"]]
    serving_victims = [e for e in sched_evs
                      if e["type"] == "Preempted"
                      and e["gang"].startswith("replica-")
                      and "preempted by" in e["message"]]
    identical = (json.dumps(mixed, sort_keys=True)
                 == json.dumps(replay, sort_keys=True))
    core_identical = (json.dumps(mixed, sort_keys=True)
                      == json.dumps(off, sort_keys=True))
    tokens = lambda rep: sum(e["tokens"] for e in rep["completions"])  # noqa: E731
    return {
        "plan": plan.as_dict(),
        "requests": len(trace),
        "drain_node": node_names[drain_target],
        "p99_alone_s": p99_alone,
        "p99_mixed_s": p99_mixed,
        "p99_ratio": (round(p99_mixed / p99_alone, 3)
                      if p99_alone and p99_mixed is not None
                      else None),
        "training": {
            "all_done": tr["all_done"],
            "ledger_ok": tr["ledger_ok"],
            "lost_steps": tr["lost_steps"],
            "rerun_steps": tr["rerun_steps"],
            "evictions": tr["evictions"],
        },
        "train_preemptions": len(train_victims),
        "strict_priority_preemptions": len(strict_preempts),
        "serving_preempted_by_training": len(serving_victims),
        "replay_identical": bool(identical),
        "event_core_identical": bool(core_identical),
        "ok": bool(mixed["ok"] and alone["ok"]
                   and tokens(mixed) == tokens(alone)
                   and tr["all_done"] and tr["ledger_ok"]
                   and tr["lost_steps"] == 0
                   and tr["rerun_steps"] == 0
                   and len(train_victims) >= 2
                   and len(strict_preempts) >= 1
                   and not serving_victims
                   and serving_held
                   and identical and core_identical),
    }


@_scenario("sdc-training-bisect",
           "a defective chip seeded into a training gang perturbs "
           "the seeded loss stream; the closed-form loss-spike "
           "checker fires, the gang rolls back at most one "
           "checkpoint cadence of steps (the corrupted step never "
           "commits), deterministic bisection re-runs — priced as "
           "real chip-seconds in the ledger — name the exact seeded "
           "culprit chip in ceil(log2(chips)) rounds, the chip is "
           "quarantined chip-granularly, the ledger verifies clean, "
           "and the report is byte-identical on replay AND with the "
           "event core off", device=False)
def _scenario_sdc_training_bisect(seed: int) -> dict:

    plan = ChaosSchedule(seed).plan(
        kinds=("sdc_chip",), n_faults=1, horizon=8, targets=4)
    spec = fleet.WorkloadSpec(process="poisson", rps=40.0,
                              n_requests=120, prompt_len=(8, 24),
                              max_new=(4, 12))
    trace = fleet.generate_trace(spec, seed)
    sim_cfg = fleet.SimReplicaConfig(max_slots=4,
                                     prefill_per_tok_s=0.002,
                                     tpot_s=0.002)
    sc = fleet.FleetSchedConfig(
        pods=(("tpu-v5-lite-podslice", "4x8"),
              ("tpu-v5-lite-podslice", "4x8")))
    cadence = 10
    gang = fleet.TrainingGangConfig(name="llm0", total_steps=90,
                                    checkpoint_every=cadence)
    tc = fleet.TrainingConfig(gangs=(gang,))
    t_sdc = round(0.5 + 0.1 * plan.events[0].at, 6)
    frac = max(0.2, plan.events[0].param)
    events = [fleet.ChaosEvent(at_s=t_sdc, action="sdc_train_chip",
                               target=plan.events[0].target,
                               param=frac)]

    def run(event_core=None):
        fc = fleet.FleetConfig(
            replicas=2, policy="least-outstanding", tick_s=0.01,
            sim=sim_cfg, slo=fleet.SloPolicy(ttft_s=1.0, e2e_s=5.0),
            sched=sc, training=tc, max_virtual_s=120.0,
            event_core=event_core,
            fast_forward=(False if event_core is False else None))
        return fleet.FleetSim(fc, trace,
                              chaos_events=events).run()

    rep = run()
    replay = run()
    off = run(event_core=False)
    g = rep["training"]["gangs"]["llm0"]
    sdc = g.get("sdc", {})
    culprits = sdc.get("culprits", [])
    # the culprit the bisection MUST name is a pure function of
    # (gang, target): the same crc32 draw apply_sdc made
    from kind_tpu_sim_torch import topology as _topo
    chips = _topo.make_slice(gang.accelerator,
                             gang.topology).num_chips
    expected_chip = zlib.crc32(
        f"sdc:train-llm0:{plan.events[0].target}".encode(
            "utf-8")) % chips
    exact = (len(culprits) == 1
             and culprits[0]["chip"] == expected_chip
             and not sdc.get("active_defects"))
    # rollback loses AT MOST one cadence of steps (the corrupted
    # step itself never commits, so strictly < cadence)
    lost_ok = all(c["lost_steps"] < cadence for c in culprits)
    # binary search over a power-of-2 chip count: exactly
    # ceil(log2(chips)) pricing rounds, every one in the ledger
    want_rounds = int(math.ceil(math.log2(chips)))
    bisects = [r for r in g["ledger"] if r["kind"] == "bisect"]
    rounds_ok = (sdc.get("bisection_rounds") == want_rounds
                 and len(bisects) == want_rounds
                 and all(b["chip_s"] > 0 for b in bisects))
    integ = rep.get("integrity", {})
    counters = integ.get("counters", {})
    identical = (json.dumps(rep, sort_keys=True)
                 == json.dumps(replay, sort_keys=True))
    core_identical = (json.dumps(rep, sort_keys=True)
                      == json.dumps(off, sort_keys=True))
    return {
        "plan": plan.as_dict(),
        "sdc_at_s": t_sdc,
        "corrupt_frac": round(frac, 6),
        "expected_chip": expected_chip,
        "culprits": culprits,
        "bisection_rounds": sdc.get("bisection_rounds"),
        "expected_rounds": want_rounds,
        "bisect_chip_s": round(sum(b["chip_s"]
                                   for b in bisects), 6),
        "lost_steps": g["lost_steps"],
        "integrity": counters,
        "ledger_ok": g["ledger_verify"]["ok"],
        "gang_done": g["state"] == "done",
        "replay_identical": bool(identical),
        "event_core_identical": bool(core_identical),
        "ok": bool(rep["ok"] and g["state"] == "done"
                   and g["ledger_verify"]["ok"]
                   and exact and lost_ok and rounds_ok
                   and counters.get("sdc_detections", 0) >= 1
                   and counters.get("chips_quarantined", 0) >= 1
                   and identical and core_identical),
    }


@_scenario("sdc-serving-audit",
           "a serving replica's chip silently corrupts its answers; "
           "the sampled duplicate-compute audit lane catches the "
           "mismatch, withholds the corrupted response, and "
           "quarantines the chip — NOTHING corrupted serves after "
           "detection — while the audit-off contrast run provably "
           "serves every corrupted answer; and the audit tax keeps "
           "p99 TTFT within 1.25x of audit-off, byte-identical on "
           "replay", device=False)
def _scenario_sdc_serving_audit(seed: int) -> dict:
    plan = ChaosSchedule(seed).plan(
        kinds=("sdc_chip",), n_faults=1, horizon=8, targets=3)
    spec = fleet.WorkloadSpec(process="poisson", rps=30.0,
                              n_requests=200, prompt_len=(8, 24),
                              max_new=(4, 12))
    trace = fleet.generate_trace(spec, seed)
    span = max(r.arrival_s for r in trace)
    sim_cfg = fleet.SimReplicaConfig(max_slots=4,
                                     prefill_per_tok_s=0.002,
                                     tpot_s=0.002)
    victim = plan.events[0].target % 3
    frac = max(0.3, plan.events[0].param)
    t_sdc = round(span * 0.25, 6)
    events = [fleet.ChaosEvent(at_s=t_sdc, action="sdc_chip",
                               target=victim, param=frac)]

    def run(audit_frac):
        fc = fleet.FleetConfig(
            replicas=3, policy="least-outstanding", tick_s=0.01,
            sim=sim_cfg, slo=fleet.SloPolicy(ttft_s=1.0, e2e_s=5.0),
            audit_frac=audit_frac, max_virtual_s=120.0)
        return fleet.FleetSim(fc, trace,
                              chaos_events=events).run()

    audit = run(0.4)
    replay = run(0.4)
    off = run(0.0)
    c_on = audit["integrity"]["counters"]
    c_off = off["integrity"]["counters"]
    detections = audit["integrity"]["detections"]
    # containment: the audit lane caught corrupted work before it
    # served, named the defective chip, and pulled it — after
    # detection NOTHING corrupted serves (an unsampled escape
    # BEFORE detection is the audit_frac trade-off, and must stay
    # strictly below the audit-off tally); audits off, the same
    # seeded defect provably reaches users uncaught
    detect_s = {d["replica"]: d["at_s"] for d in detections}
    post = [e for e in audit["completions"]
            if e.get("corrupted") and not e.get("sdc_caught")
            and e["finish_s"] > detect_s.get(e["replica"],
                                             float("inf"))]
    # detection can come from EITHER side of the duplicate compute:
    # a sampled corrupted original (corrupted_caught) or a clean
    # original whose copy ran on the defective chip — both end in a
    # mismatch and the quarantine, so the gate is mismatch-based
    contained = (c_on.get("audit_mismatches", 0) >= 1
                 and c_on.get("chips_quarantined", 0) >= 1
                 and victim in detect_s
                 and not post
                 and c_on.get("corrupted_served", 0)
                 < c_off.get("corrupted_served", 0))
    escaped = (c_off.get("corrupted_served", 0) >= 1
               and c_off.get("corrupted_caught", 0) == 0)
    p99_on = _window_p99_ttft(audit["completions"], 0.0,
                              span + 1.0)
    p99_off = _window_p99_ttft(off["completions"], 0.0,
                               span + 1.0)
    tax_ok = (p99_on is not None and p99_off is not None
              and p99_on <= 1.25 * p99_off)
    identical = (json.dumps(audit, sort_keys=True)
                 == json.dumps(replay, sort_keys=True))
    return {
        "plan": plan.as_dict(),
        "sdc_at_s": t_sdc,
        "victim_replica": victim,
        "corrupt_frac": round(frac, 6),
        "audit": {"frac": 0.4, "counters": c_on,
                  "detections": detections},
        "audit_off": {"counters": c_off},
        "corrupted_served_on": c_on.get("corrupted_served", 0),
        "corrupted_served_off": c_off.get("corrupted_served", 0),
        "p99_audit_s": p99_on,
        "p99_off_s": p99_off,
        "p99_ratio": (round(p99_on / p99_off, 3)
                      if p99_on and p99_off else None),
        "replay_identical": bool(identical),
        "ok": bool(audit["ok"] and off["ok"]
                   and c_on.get("audits", 0) >= 1
                   and contained and escaped and tax_ok
                   and identical),
    }


@_scenario("correlated-rack-loss",
           "one correlated domain fault takes out a whole rack's "
           "nodes at once; the contrast run fails the SAME nodes "
           "for the SAME per-node outage, drawn independently "
           "(staggered) — the correlated draw is strictly worse: "
           "more capacity dead simultaneously and a worse fault-"
           "window p99 / SLO attainment, byte-identical on replay", device=False)
def _scenario_correlated_rack_loss(seed: int) -> dict:
    plan = ChaosSchedule(seed).plan(
        kinds=("correlated_domain_fault",), n_faults=1, horizon=8,
        targets=2)
    # heavy enough that losing a rack's worth of replicas SHOWS:
    # at light load the crunch hides inside idle slot headroom
    spec = fleet.WorkloadSpec(process="poisson", rps=90.0,
                              n_requests=400, prompt_len=(8, 24),
                              max_new=(4, 12))
    trace = fleet.generate_trace(spec, seed)
    span = max(r.arrival_s for r in trace)
    sim_cfg = fleet.SimReplicaConfig(max_slots=4,
                                     prefill_per_tok_s=0.002,
                                     tpot_s=0.002)
    # four 1-host pods, racked in pairs: every replica is a whole
    # node, so a rack is exactly two replicas' worth of hardware
    sc = fleet.FleetSchedConfig(
        pods=(("tpu-v5-lite-podslice", "2x4"),) * 4, rack_pods=2)

    def run(events):
        fc = fleet.FleetConfig(
            replicas=3, policy="least-outstanding", tick_s=0.01,
            sim=sim_cfg, slo=fleet.SloPolicy(ttft_s=1.0, e2e_s=5.0),
            sched=sc, max_virtual_s=120.0)
        return fleet.FleetSim(fc, trace,
                              chaos_events=events).run()

    # a clean probe run resolves which rack actually HOSTS serving
    # replicas — the blast radius must displace real capacity, not
    # idle nodes — and the independent contrast must then fail the
    # SAME hardware
    probe = fleet.FleetSim(fleet.FleetConfig(replicas=3, sched=sc),
                           [])
    fds = probe.sched.inv.failure_domains()
    node_names = sorted(
        n["name"]
        for d in probe.sched.inv.as_dict()["domains"].values()
        for n in d["nodes"])
    clean = run([])
    replica_nodes = {
        n for e in clean["scheduler"]["events"]
        if e["type"] == "Scheduled"
        and e["gang"].startswith("replica-")
        for n in e["nodes"]}
    fd = max(fds, key=lambda f: (len(
        set(probe.sched.inv.failure_domain_nodes(f))
        & replica_nodes), f))
    target = fds.index(fd)
    rack_nodes = sorted(probe.sched.inv.failure_domain_nodes(fd))
    idxs = [node_names.index(n) for n in rack_nodes]
    dur = round(span * 0.2, 6)
    t0 = round(span * 0.3, 6)
    correlated = [
        fleet.ChaosEvent(at_s=t0, action="domain_fault",
                         target=target),
        fleet.ChaosEvent(at_s=round(t0 + dur, 6),
                         action="domain_restore",
                         target=target),
    ]
    # the independent draw: same nodes, same per-node outage DUR,
    # but staggered — never more than one down at once
    independent = []
    for k, idx in enumerate(idxs):
        at = round(t0 + k * dur, 6)
        independent.append(fleet.ChaosEvent(
            at_s=at, action="node_fail", target=idx))
        independent.append(fleet.ChaosEvent(
            at_s=round(at + dur, 6), action="node_restore",
            target=idx))
    rep_c = run(correlated)
    replay = run(correlated)
    rep_i = run(independent)
    # worst window: requests arriving DURING the correlated outage
    # — when the whole rack is dark vs one node of it
    p99_c = _window_p99_ttft(rep_c["completions"], t0, t0 + dur)
    p99_i = _window_p99_ttft(rep_i["completions"], t0, t0 + dur)

    def _attain(rep):
        comps = rep["completions"]
        return (sum(1 for e in comps if e["slo_ok"])
                / max(1, len(comps)))

    att_c = round(_attain(rep_c), 6)
    att_i = round(_attain(rep_i), 6)
    # strictly worse: the whole rack is dead AT ONCE (len(idxs)
    # simultaneous vs 1 staggered — structural, by construction)
    # and the service FELT it — strictly worse fault-window p99,
    # with whole-run attainment as the saturated-fleet fallback
    worse = ((p99_c is not None and p99_i is not None
              and p99_c > p99_i)
             or att_c < att_i)
    identical = (json.dumps(rep_c, sort_keys=True)
                 == json.dumps(replay, sort_keys=True))
    return {
        "plan": plan.as_dict(),
        "failure_domain": fd,
        "rack_nodes": rack_nodes,
        "outage_s": dur,
        "fault_at_s": t0,
        "max_simultaneous_dead": {"correlated": len(idxs),
                                  "independent": 1},
        "p99_window_s": {"correlated": p99_c,
                         "independent": p99_i},
        "slo_attainment": {"correlated": att_c,
                           "independent": att_i},
        "domain_faults": rep_c["integrity"]["counters"].get(
            "domain_faults", 0),
        "replay_identical": bool(identical),
        "ok": bool(rep_c["ok"] and rep_i["ok"]
                   and len(idxs) >= 2 and worse
                   and rep_c["integrity"]["counters"].get(
                       "domain_faults", 0) >= 1
                   and identical),
    }


# ---------------------------------------------------------------------
# the globe (analytic cells, one virtual clock)


@_scenario("globe-zone-loss",
           "a whole MULTI-CELL zone goes dark under the globe's "
           "front door: both of its cells' load spills cross-zone "
           "(nearest healthy first), zero requests are lost, global "
           "p99 recovers after the zone returns, and the surviving "
           "zones' boards stay within noise of fault-free — the "
           "blast radius is the zone, not the planet",
           device=False)
def _scenario_globe_zone_loss(seed: int) -> dict:
    from kind_tpu_sim_torch import globe

    plan = ChaosSchedule(seed).plan(kinds=("zone_loss",),
                                    n_faults=1, horizon=6, targets=3)
    ev = plan.events[0]
    # 2 cells per zone: the blast radius spans BOTH cells of the
    # lost zone (they die together — a zone is a correlated failure
    # domain) and the herd readmission spreads over the survivors'
    # four cells, sibling-first within each zone
    cfg = globe.GlobeConfig(
        zones=("zone-a", "zone-b", "zone-c"), cells_per_zone=2,
        replicas_per_cell=1,
        workload=globe.GlobeWorkloadSpec(process="poisson",
                                         rps=30.0, n_per_zone=120))
    traces = globe.generate_globe_traces(cfg, seed)
    span = max(r.arrival_s for reqs in traces.values()
               for r in reqs)
    lost_zone = cfg.zones[ev.target % len(cfg.zones)]
    # the loss lands a third into the arrival window and the zone
    # returns at two thirds — a full third of the trace arrives
    # post-restore, so the recovery window has real traffic to judge
    at = round(span / 3.0, 6)
    restore = round(2.0 * span / 3.0, 6)
    events = [
        globe.GlobeChaosEvent(at_s=at, action="zone_loss",
                              target=lost_zone),
        globe.GlobeChaosEvent(at_s=restore, action="zone_restore",
                              target=lost_zone),
    ]
    clean = globe.GlobeSim(cfg, traces=traces, seed=seed).run()
    faulted = globe.GlobeSim(cfg, traces=traces, seed=seed,
                             chaos_events=events).run()
    replay = globe.GlobeSim(cfg, traces=traces, seed=seed,
                            chaos_events=events).run()
    # recovery: post-restore global p99 back to fault-free levels
    p99_clean = _window_p99_ttft(clean["completions"], restore,
                                 span + 1.0)
    p99_faulted = _window_p99_ttft(faulted["completions"], restore,
                                   span + 1.0)
    recovered = (p99_clean is not None and p99_faulted is not None
                 and p99_faulted <= 1.25 * p99_clean)
    # containment: the surviving zones' per-zone boards (whole run,
    # fault window included) must sit within noise of fault-free —
    # a zone loss that degrades its neighbors was not contained.
    # One histogram bucket is 1.12x; survivors legitimately carry
    # the herd's spill DURING the window (they absorb 1.5x load by
    # design), so their tolerance is ~3 buckets (1.12^3 = 1.405) —
    # soak seeds land ratios up to ~1.35 with the spill fully
    # bounded. Post-restore RECOVERY keeps the tighter 1.25.
    survivors = [z for z in cfg.zones if z != lost_zone]
    containment = {}
    for z in survivors:
        pc = clean["zones"][z]["slo"]["ttft"].get("p99_s")
        pf = faulted["zones"][z]["slo"]["ttft"].get("p99_s")
        containment[z] = (round(pf / pc, 3)
                          if pc and pf is not None else None)
    contained = all(r is not None and r <= 1.405
                    for r in containment.values())
    tokens = lambda rep: sum(e["tokens"] for e in rep["completions"])  # noqa: E731
    identical = (json.dumps(faulted["completions"],
                             sort_keys=True)
                 == json.dumps(replay["completions"],
                                sort_keys=True))
    return {
        "plan": plan.as_dict(),
        "requests": faulted["requests"],
        "lost_zone": lost_zone,
        "loss_at_s": at,
        "restore_at_s": restore,
        "spilled": faulted["frontdoor"]["spilled"],
        "readmitted": faulted["frontdoor"]["readmitted"],
        "shed": faulted["global_slo"]["shed"],
        "p99_post_restore_ratio": (
            round(p99_faulted / p99_clean, 3)
            if p99_clean and p99_faulted is not None else None),
        "surviving_zone_p99_ratio": containment,
        "replay_identical": bool(identical),
        "ok": bool(clean["ok"] and faulted["ok"]
                   and faulted["global_slo"]["shed"] == 0
                   and tokens(faulted) == tokens(clean)
                   and faulted["frontdoor"]["spilled"] >= 1
                   and recovered and contained and identical),
    }


@_scenario("globe-herd-failover",
           "a zone dies at peak burst: its whole load hits the "
           "front door at once, and the spill bound spreads it "
           "without cascade — no surviving cell is flooded past its "
           "configured headroom, nothing sheds, and attainment "
           "recovers once the zone returns",
           device=False)
def _scenario_globe_herd_failover(seed: int) -> dict:
    from kind_tpu_sim_torch import globe

    plan = ChaosSchedule(seed).plan(kinds=("herd_failover",),
                                    n_faults=1, horizon=6, targets=3)
    ev = plan.events[0]
    cfg = globe.GlobeConfig(
        zones=("zone-a", "zone-b", "zone-c"), replicas_per_cell=2,
        workload=globe.GlobeWorkloadSpec(process="bursty",
                                         rps=40.0, n_per_zone=150))
    traces = globe.generate_globe_traces(cfg, seed)
    span = max(r.arrival_s for reqs in traces.values()
               for r in reqs)
    herd_zone = cfg.zones[ev.target % len(cfg.zones)]
    clean = globe.GlobeSim(cfg, traces=traces, seed=seed).run()
    # kill the zone just after a mid-trace dispatch INTO it: the
    # runs are identical up to that instant, so the zone provably
    # holds in-flight work — the herd (displacement + re-admission)
    # is guaranteed, not seed-lucky (burst valleys are empty)
    tick = 0.01
    herd_disp = sorted(
        e["dispatch_s"] for e in clean["completions"]
        if e["serving_zone"] == herd_zone
        and span / 4.0 <= e["dispatch_s"] <= 2.0 * span / 3.0)
    at = round((herd_disp[len(herd_disp) // 2] + tick / 2
                if herd_disp else span / 3.0), 6)
    restore = round(max(2.0 * span / 3.0, at + 0.15 * span), 6)
    events = [
        globe.GlobeChaosEvent(at_s=at, action="herd_failover",
                              target=herd_zone),
        globe.GlobeChaosEvent(at_s=restore, action="zone_restore",
                              target=herd_zone),
    ]
    faulted = globe.GlobeSim(cfg, traces=traces, seed=seed,
                             chaos_events=events).run()
    replay = globe.GlobeSim(cfg, traces=traces, seed=seed,
                            chaos_events=events).run()
    fd = faulted["frontdoor"]
    # the cascade-prevention invariant: admission never floods any
    # surviving cell past its hard limit (nominal x (1 + headroom)),
    # and neither tier sheds — overflow waits at the front door
    bounded = all(
        fd["peak_outstanding"][name] <= fd["hard_limits"][name]
        for name in fd["hard_limits"])
    cell_sheds = sum(c["router"]["shed"]
                     for c in faulted["cells"].values())
    tail_clean = globe.attainment_over(clean["completions"],
                                       restore)
    tail_faulted = globe.attainment_over(faulted["completions"],
                                         restore)
    recovered = (tail_clean is None or tail_faulted is None
                 or tail_faulted >= tail_clean)
    tokens = lambda rep: sum(e["tokens"] for e in rep["completions"])  # noqa: E731
    identical = (json.dumps(faulted["completions"],
                             sort_keys=True)
                 == json.dumps(replay["completions"],
                                sort_keys=True))
    return {
        "plan": plan.as_dict(),
        "requests": faulted["requests"],
        "herd_zone": herd_zone,
        "failover_at_s": at,
        "readmitted": fd["readmitted"],
        "spilled": fd["spilled"],
        "peak_outstanding": fd["peak_outstanding"],
        "hard_limits": fd["hard_limits"],
        "spill_bound_held": bool(bounded),
        "cell_sheds": cell_sheds,
        "frontdoor_sheds": fd["shed"],
        "tail_attainment_clean": tail_clean,
        "tail_attainment_faulted": tail_faulted,
        "replay_identical": bool(identical),
        "ok": bool(clean["ok"] and faulted["ok"]
                   and bounded and cell_sheds == 0
                   and fd["shed"] == 0
                   and fd["readmitted"] >= 1
                   and tokens(faulted) == tokens(clean)
                   and recovered and identical),
    }


@_scenario("globe-dcn-degrade",
           "an inter-zone DCN link browns out under cross-zone "
           "spill (one cell drained for maintenance forces the "
           "spill): the latency-aware front door routes around the "
           "degraded path, the untouched zone's board stays within "
           "noise, and the spill path heals when the link does",
           device=False)
def _scenario_globe_dcn_degrade(seed: int) -> dict:
    from kind_tpu_sim_torch import globe

    plan = ChaosSchedule(seed).plan(kinds=("dcn_degrade",),
                                    n_faults=1, horizon=8, targets=1)
    factor = min(0.25, max(0.08, plan.events[0].param))
    # 3 replicas/cell: zone-a must absorb zone-b's whole spill
    # WITHOUT ever saturating — a saturated near cell would let the
    # front door legitimately prefer the far (degraded) path, and
    # this scenario is about latency steering, not overload
    cfg = globe.GlobeConfig(
        zones=("zone-a", "zone-b", "zone-c"), replicas_per_cell=3,
        workload=globe.GlobeWorkloadSpec(process="poisson",
                                         rps=30.0, n_per_zone=120))
    traces = globe.generate_globe_traces(cfg, seed)
    span = max(r.arrival_s for reqs in traces.values()
               for r in reqs)
    t1 = round(span * 0.25, 6)
    t2 = round(span * 0.65, 6)
    # zone-b's cell is under maintenance the whole run (baseline
    # includes the drain, so the faulted-vs-baseline delta is PURELY
    # the browned-out link); its traffic must spill cross-zone,
    # where zone-a and zone-c are equidistant candidates
    drain = [globe.GlobeChaosEvent(at_s=0.0, action="cell_drain",
                                   target="zone-b/c0")]
    dcn = drain + [
        globe.GlobeChaosEvent(at_s=t1, action="dcn_degrade",
                              target="zone-c", param=factor),
        globe.GlobeChaosEvent(at_s=t2, action="dcn_restore",
                              target="zone-c"),
    ]
    base = globe.GlobeSim(cfg, traces=traces, seed=seed,
                          chaos_events=list(drain)).run()
    faulted = globe.GlobeSim(cfg, traces=traces, seed=seed,
                             chaos_events=list(dcn)).run()
    replay = globe.GlobeSim(cfg, traces=traces, seed=seed,
                            chaos_events=list(dcn)).run()
    # steering: while zone-c's DCN is browned out, NO zone-b
    # request may be served through it — the front door's
    # latency-aware scoring must prefer the healthy path to zone-a.
    # The window edges back off a tick: an arrival 1ms before the
    # restore is ADMITTED at the next tick, after the link healed
    window = [e for e in faulted["completions"]
              if e["origin"] == "zone-b"
              and t1 + 0.1 <= e["arrival_s"] < t2 - 0.05]
    routed_around = (all(e["serving_zone"] != "zone-c"
                         for e in window)
                     and any(e["serving_zone"] == "zone-a"
                             for e in window))
    # containment: zone-c's own (purely local) traffic must not
    # notice its DCN links browning out (1.25 = ~2 histogram
    # buckets, the repo-wide fault-free tolerance)
    pc = base["zones"]["zone-c"]["slo"]["ttft"].get("p99_s")
    pf = faulted["zones"]["zone-c"]["slo"]["ttft"].get("p99_s")
    contained = bool(pc and pf is not None and pf <= 1.25 * pc)
    # recovery: once the link heals, the spill path costs what it
    # did under maintenance alone
    p99_base = _window_p99_ttft(base["completions"], t2, span + 1.0)
    p99_faulted = _window_p99_ttft(faulted["completions"], t2,
                                   span + 1.0)
    recovered = (p99_base is not None and p99_faulted is not None
                 and p99_faulted <= 1.25 * p99_base)
    tokens = lambda rep: sum(e["tokens"] for e in rep["completions"])  # noqa: E731
    identical = (json.dumps(faulted["completions"],
                             sort_keys=True)
                 == json.dumps(replay["completions"],
                                sort_keys=True))
    return {
        "plan": plan.as_dict(),
        "requests": faulted["requests"],
        "link_factor": round(factor, 3),
        "degrade_window_s": [t1, t2],
        "spill_window_requests": len(window),
        "routed_around_degraded_link": bool(routed_around),
        "zone_c_p99_ratio": (round(pf / pc, 3)
                             if pc and pf is not None else None),
        "p99_post_restore_ratio": (
            round(p99_faulted / p99_base, 3)
            if p99_base and p99_faulted is not None else None),
        "dcn_degrades": faulted["globe_counters"].get(
            "dcn_degrades", 0),
        "replay_identical": bool(identical),
        "ok": bool(base["ok"] and faulted["ok"]
                   and len(window) >= 5
                   and routed_around and contained and recovered
                   and faulted["globe_counters"].get(
                       "dcn_degrades", 0) == 1
                   and tokens(faulted) == tokens(base)
                   and identical),
    }


@_scenario("train-globe-spot",
           "an elastic training gang grows onto the globe planner's "
           "idle spot budget; a zone loss checkpoints and evicts it "
           "(zero steps lost), the displaced serving herd pressures "
           "the surviving zone so the planner reclaims the training "
           "rung — the gang shrinks (never aborts) after its zone "
           "returns, finishes with a clean ledger, and the whole "
           "report replays byte-identically",
           device=False)
def _scenario_train_globe_spot(seed: int) -> dict:
    from kind_tpu_sim_torch import globe

    plan = ChaosSchedule(seed).plan(kinds=("zone_loss",),
                                    n_faults=1, horizon=6, targets=2)
    tc = fleet.TrainingConfig(gangs=(
        fleet.TrainingGangConfig(name="llm0", total_steps=160,
                                 checkpoint_every=10, elastic=True,
                                 max_topology="4x8"),))
    cfg = globe.GlobeConfig(
        zones=("zone-a", "zone-b"), cells_per_zone=1,
        replicas_per_cell=1, autoscale=True,
        # 3 domains per cell: serving + the base gang still leave a
        # whole domain free, so the spot-granted growth is feasible
        cell_pods=(("tpu-v5-lite-podslice", "4x8"),
                   ("tpu-v5-lite-podslice", "4x8"),
                   ("tpu-v5-lite-podslice", "4x8")),
        planner=globe.PlannerConfig(spot_budget=2,
                                    eval_every_s=0.25),
        training=tc, training_cells=("zone-a/c0",),
        workload=globe.GlobeWorkloadSpec(process="poisson",
                                         rps=25.0, n_per_zone=150))
    traces = globe.generate_globe_traces(cfg, seed)
    span = max(r.arrival_s for reqs in traces.values()
               for r in reqs)
    lost_zone = "zone-a"  # the training zone is the one that dies
    at = round(span * (0.35 + 0.05 * (plan.events[0].at % 3)), 6)
    restore = round(max(2.0 * span / 3.0, at + 0.2 * span), 6)
    events = [
        globe.GlobeChaosEvent(at_s=at, action="zone_loss",
                              target=lost_zone),
        globe.GlobeChaosEvent(at_s=restore, action="zone_restore",
                              target=lost_zone),
    ]
    rep = globe.GlobeSim(cfg, traces=traces, seed=seed,
                         chaos_events=events).run()
    replay = globe.GlobeSim(cfg, traces=traces, seed=seed,
                            chaos_events=events).run()
    g = rep["cells"]["zone-a/c0"]["training"]["gangs"]["llm0"]
    planner = rep["planner"]
    grants = sum(1 for e in planner["events"]
                 if e["action"] == "train_grant")
    reclaims = sum(1 for e in planner["events"]
                   if e["action"] == "train_reclaim")
    identical = (json.dumps(rep, sort_keys=True)
                 == json.dumps(replay, sort_keys=True))
    return {
        "plan": plan.as_dict(),
        "requests": rep["requests"],
        "loss_at_s": at,
        "restore_at_s": restore,
        "train_grants": grants,
        "train_reclaims": reclaims,
        "grows": g["grows"],
        "shrinks": g["shrinks"],
        "evictions": g["evictions"],
        "final_topology": g["topology"],
        "lost_steps": g["lost_steps"],
        "ledger_ok": g["ledger_verify"]["ok"],
        "gang_done": g["state"] == "done",
        "replay_identical": bool(identical),
        "ok": bool(rep["ok"] and g["state"] == "done"
                   and g["ledger_verify"]["ok"]
                   and g["lost_steps"] == 0
                   and g["grows"] >= 1
                   and grants >= 1
                   and g["evictions"] >= 1
                   and identical),
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


def soak(iterations: int = 10, seed: Optional[int] = None,
         include_slow: bool = False, **kwargs) -> dict:
    """Repeated seeded scenario runs (the `chaos soak` CLI): the
    iteration stream is itself derived from the seed, so a soak that
    finds a failure names the exact (scenario, seed) pair to replay
    with `chaos run`. ``kwargs`` (a device scenario's ``device``) go
    to :func:`run_scenario`."""
    from kind_tpu_sim_torch.scenarios import registry

    seed = resolve_seed(seed)
    rng = random.Random(zlib.crc32(f"soak:{seed}".encode("utf-8")))
    # the pick pool derives from the registry (sorted), so a new
    # scenario can never be silently missing from soak — and the
    # seeded stream stays a pure function of the registry contents
    names = registry.soak_names(include_slow=include_slow)
    runs = []
    failures = 0
    for i in range(iterations):
        name = rng.choice(names)
        sub_seed = rng.randrange(2 ** 31)
        report = run_scenario(name, seed=sub_seed, **kwargs)
        runs.append({"scenario": name, "seed": sub_seed,
                     "ok": report["ok"]})
        if not report["ok"]:
            failures += 1
            log.error("soak failure: replay with "
                      "`chaos run --scenario %s --seed %d`",
                      name, sub_seed)
    return {
        "seed": seed,
        "iterations": iterations,
        "failures": failures,
        "runs": runs,
        "recovery_events": metrics.recovery_log().counts(),
        "ok": failures == 0,
    }
