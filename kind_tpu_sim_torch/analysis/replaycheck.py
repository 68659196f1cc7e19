"""replaycheck — the runtime replay-divergence bisector (the port's copy
of ``kind_tpu_sim/analysis/replaycheck.py``).

The reference's detlint catches the hazard *classes* statically; this
module checks the contract itself at runtime: run a scenario twice under the same
seed, flatten each report into its canonical event stream, hash the
stream incrementally, and — on mismatch — **bisect the prefix-digest
arrays to the first divergent event**, printing both sides' context.
A failing byte-identity assert used to say "reports differ"; the
bisector says *"event 143 (stream completions): run 0 finished
request zone-b/r17 at 3.41s, run 1 at 3.42s"* — the difference
between an afternoon of print-debugging and a one-line diff.

Event extraction is structural: every list under a known stream key
(``completions``, ``events``, ``chaos``, ``runs``) anywhere in the
report becomes a sequence of indexed events (path-labeled, traversed
in sorted-key order), and everything else collapses into one final
``report`` summary event — so a divergence anywhere in the document
is localized to the tightest unit the report offers.

Targets (:data:`REPLAY_TARGETS`) cover every virtual-clock layer:
direct ``fleet-run`` / ``sched-run`` / ``globe-run`` sims, the
``globe-sharded`` cross-driver referee, plus the deterministic chaos
scenarios of the port's registry (``globe-zone-loss`` etc.). The
reference's ``tune`` target comes with the tuner (ROADMAP Queue A item
5), and the registry's ``flaky-exec``, ``device-flap`` and ``node-flap``
targets with the cluster layer (item 7). The sim
targets also support a **deliberately injected entropy bug**
(``inject=True`` perturbs the second run's workload mid-stream) — the
self-test proving the bisector finds and names the first divergent
event rather than just declaring failure.

CLI: ``python -m kind_tpu_sim_torch analysis replay --scenario
globe-zone-loss``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

STREAM_KEYS = ("completions", "events", "chaos", "runs")

# How many events of leading context ride along with a divergence.
CONTEXT_EVENTS = 2


# -- event stream extraction ------------------------------------------


def event_stream(report: dict) -> List[dict]:
    """Flatten a report into its canonical event sequence: one entry
    per element of every stream-keyed list (any depth, sorted-key
    traversal), then a final summary event with the streams elided."""
    events: List[dict] = []

    def walk(obj, path):
        if isinstance(obj, dict):
            rest = {}
            for key in sorted(obj):
                value = obj[key]
                label = f"{path}{key}"
                if key in STREAM_KEYS and isinstance(value, list):
                    for i, item in enumerate(value):
                        events.append({"stream": label, "index": i,
                                       "event": item})
                    rest[key] = f"<stream: {len(value)} events>"
                elif isinstance(value, (dict, list)):
                    rest[key] = walk(value, label + ".")
                else:
                    rest[key] = value
            return rest
        if isinstance(obj, list):
            return [walk(item, path) for item in obj]
        return obj

    summary = walk(report, "")
    events.append({"stream": "report", "index": 0, "event": summary})
    return events


def event_digest(event: dict) -> str:
    """Canonical per-event digest (sorted-keys JSON, sha256)."""
    blob = json.dumps(event, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def prefix_digests(events: Sequence[dict]) -> List[str]:
    """Rolling digests: entry i commits to events[0..i]. Two streams
    are byte-identical iff their final entries match — and the first
    index where the arrays differ IS the first divergent event."""
    out: List[str] = []
    h = ""
    for ev in events:
        h = hashlib.sha256(
            (h + event_digest(ev)).encode("ascii")).hexdigest()
        out.append(h)
    return out


@dataclasses.dataclass(frozen=True)
class Divergence:
    index: int
    stream: str
    a: Optional[dict]       # the event on run 0 (None: stream ended)
    b: Optional[dict]       # ... and on the diverging run
    context: List[dict]     # shared events just before the split

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def first_divergence(a: Sequence[dict], b: Sequence[dict]
                     ) -> Optional[Divergence]:
    """Binary-search the prefix-digest arrays for the first index
    where the two event streams disagree (None: identical)."""
    pa, pb = prefix_digests(a), prefix_digests(b)
    n = min(len(pa), len(pb))
    # the rolling digest commits to the whole prefix: equal finals +
    # equal lengths => identical streams, no scan needed
    if len(pa) == len(pb) and (not pa or pa[-1] == pb[-1]):
        return None
    lo, hi = 0, n  # smallest i in [0, n] with pa[i] != pb[i]
    while lo < hi:
        mid = (lo + hi) // 2
        if pa[mid] == pb[mid]:
            lo = mid + 1
        else:
            hi = mid
    idx = lo  # == n means one stream is a strict prefix of the other
    ev_a = a[idx] if idx < len(a) else None
    ev_b = b[idx] if idx < len(b) else None
    stream = (ev_a or ev_b or {}).get("stream", "report")
    context = list(a[max(0, idx - CONTEXT_EVENTS):idx])
    return Divergence(index=idx, stream=stream, a=ev_a, b=ev_b,
                      context=context)


# -- replay targets ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplayTarget:
    """``runner(seed, inject)`` returns one report dict. ``inject``
    perturbs the run's *workload* mid-stream (the modeled stray-
    entropy bug); targets that cannot inject raise ValueError."""

    name: str
    description: str
    runner: Callable[[int, bool], dict]
    slow: bool = False
    injectable: bool = False


def _inject_trace(trace: list):
    """The modeled entropy bug: one request near the middle of the
    stream grows its decode length by one token — exactly the shape
    of an unseeded sample leaking into a replayed run."""
    import dataclasses as dc

    mid = len(trace) // 2
    trace[mid] = dc.replace(trace[mid],
                            max_new=trace[mid].max_new + 1)


def _run_fleet(seed: int, inject: bool) -> dict:
    from kind_tpu_sim_torch import fleet

    spec = fleet.WorkloadSpec(process="poisson", rps=60.0,
                              n_requests=120)
    trace = fleet.generate_trace(spec, seed)
    if inject:
        _inject_trace(trace)
    cfg = fleet.FleetConfig(replicas=2, policy="least-outstanding")
    return fleet.FleetSim(cfg, trace).run()


def _run_sched(seed: int, inject: bool) -> dict:
    from kind_tpu_sim_torch import sched

    if inject:
        raise ValueError("sched-run does not support injection")
    cfg = sched.SchedSimConfig(
        workload=sched.SchedWorkloadSpec(n_gangs=16))
    return sched.run_sched_sim(cfg, seed)


def _run_globe(seed: int, inject: bool) -> dict:
    from kind_tpu_sim_torch import globe

    cfg = globe.GlobeConfig(
        zones=("zone-a", "zone-b"), replicas_per_cell=2,
        workload=globe.GlobeWorkloadSpec(process="poisson",
                                         rps=30.0, n_per_zone=60))
    traces = globe.generate_globe_traces(cfg, seed)
    if inject:
        _inject_trace(traces[sorted(traces)[0]])
    return globe.GlobeSim(cfg, traces=traces, seed=seed).run()


# alternates the drivers call by call (run 0 single-process, run 1
# sharded, ...) so replay()'s byte-identity verdict IS the
# cross-driver referee — any mixed sequence must agree anyway
_GLOBE_SHARD_FLIP = [1]


def _run_globe_sharded(seed: int, inject: bool) -> dict:
    from kind_tpu_sim_torch import globe

    cfg = globe.GlobeConfig(
        zones=("zone-a", "zone-b"), cells_per_zone=2,
        replicas_per_cell=2,
        workload=globe.GlobeWorkloadSpec(process="poisson",
                                         rps=30.0, n_per_zone=60))
    traces = globe.generate_globe_traces(cfg, seed)
    if inject:
        _inject_trace(traces[sorted(traces)[0]])
    _GLOBE_SHARD_FLIP[0] ^= 1
    if _GLOBE_SHARD_FLIP[0]:
        return globe.ShardedGlobeSim(cfg, traces=traces,
                                     seed=seed, shards=2).run()
    return globe.GlobeSim(cfg, traces=traces, seed=seed).run()


def _scenario_runner(name: str):
    def run(seed: int, inject: bool) -> dict:
        if inject:
            raise ValueError(
                f"scenario target {name!r} does not support "
                "injection; use fleet-run or globe-run")
        from kind_tpu_sim_torch import chaos

        return chaos.run_scenario(name, seed=seed)
    return run


# driver-level targets: direct sim runs and cross-driver referees,
# not chaos scenarios. Everything in REPLAY_TARGETS outside this
# tuple MUST come from the scenario registry's replayable set — the
# bijection test in tests/test_torch_replay.py pins that, so a new
# driver target belongs here, not in an ad-hoc test exclusion. The
# reference's "tune" target joins with the tuner (ROADMAP Queue A item 5).
DRIVER_TARGETS = ("fleet-run", "sched-run", "globe-run",
                  "globe-sharded")


def _targets() -> Dict[str, ReplayTarget]:
    # The scenario targets derive from the registry's `replayable`
    # flags (scenarios/registry.py) — the single declaration of
    # which reports are pure functions of (config, seed). The
    # worker-process scenarios (pids, wall timings) and the
    # device-engine ones (slow) are declared non-replayable there, so a
    # new scenario can never be silently missing from this list.
    from kind_tpu_sim_torch.scenarios import registry

    out = {
        "fleet-run": ReplayTarget(
            "fleet-run", "direct FleetSim run (120 poisson "
            "requests, 2 replicas)", _run_fleet, injectable=True),
        "sched-run": ReplayTarget(
            "sched-run", "direct scheduler sim run (16 gangs)",
            _run_sched),
        "globe-run": ReplayTarget(
            "globe-run", "direct GlobeSim run (2 zones)",
            _run_globe, injectable=True),
        "globe-sharded": ReplayTarget(
            "globe-sharded", "GlobeSim vs ShardedGlobeSim(2) on "
            "one seed — the cross-driver byte-identity referee",
            _run_globe_sharded, slow=True, injectable=True),
    }
    for name in registry.replayable_names():
        out[name] = ReplayTarget(
            name, f"chaos scenario {name!r}, full report",
            _scenario_runner(name))
    return out


REPLAY_TARGETS: Dict[str, ReplayTarget] = _targets()


# -- the check --------------------------------------------------------


def replay(target: str, seed: Optional[int] = None, runs: int = 2,
           inject: bool = False) -> dict:
    """Run ``target`` ``runs`` times under one seed; byte-identity of
    the event streams is the verdict. ``inject=True`` plants the
    entropy bug in every run after the first — the report must then
    name the first divergent event (bisector self-test)."""
    if target not in REPLAY_TARGETS:
        known = ", ".join(sorted(REPLAY_TARGETS))
        raise ValueError(f"unknown replay target {target!r}; "
                         f"known: {known}")
    if runs < 2:
        raise ValueError("replay needs runs >= 2")
    from kind_tpu_sim_torch.chaos import resolve_seed

    seed = resolve_seed(seed)
    t = REPLAY_TARGETS[target]
    streams: List[Tuple[List[dict], List[str]]] = []
    for i in range(runs):
        report = t.runner(seed, inject and i > 0)
        events = event_stream(report)
        streams.append((events, prefix_digests(events)))
    base_events, base_prefix = streams[0]
    divergence = None
    diverged_run = None
    for i in range(1, runs):
        events_i, prefix_i = streams[i]
        if (len(prefix_i) == len(base_prefix)
                and (not prefix_i or prefix_i[-1] == base_prefix[-1])):
            continue
        divergence = first_divergence(base_events, events_i)
        diverged_run = i
        break
    out = {
        "target": target,
        "seed": seed,
        "runs": runs,
        "injected": bool(inject),
        "events": len(base_events),
        "stream_digest": (base_prefix[-1] if base_prefix else ""),
        "ok": divergence is None,
    }
    if divergence is not None:
        out["diverged_run"] = diverged_run
        out["divergence"] = divergence.as_dict()
    return out


def list_targets() -> List[dict]:
    return [
        {"name": t.name, "description": t.description,
         "slow": t.slow, "injectable": t.injectable}
        for _, t in sorted(REPLAY_TARGETS.items())
    ]
