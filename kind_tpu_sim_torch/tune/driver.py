"""The tune search driver (the port's copy of
``kind_tpu_sim/tune/driver.py``): seeded successive halving
over candidate fleet designs, evaluated in parallel on the worker
pool, with a chaos-aware rescoring mode.

The whole report is a pure function of ``(space, workload, slo, seed,
budget, workers..., chaos_budget)`` — and deliberately NOT of
``workers``: every candidate evaluation is itself a pure function of
its serialized eval spec (:func:`evaluate`), evals are sharded over
workers in contiguous index chunks, and results are merged back in
index order, so the search trace is byte-identical whether it ran
in-process (``workers=0``) or across any worker-pool size
(``run_grid``, one cold protocol worker per chunk).

Halving schedule (two rungs, screen -> finalists):

* **screen** — every drawn candidate on the short trace
  (``screen_frac`` of the workload's request count, floor 8);
* **final** — survivors on the full trace. Survivors are the top
  half by rank, every screen-rung Pareto-non-dominated candidate,
  and (transitively) anything that dominates a survivor, so halving
  can never drop a candidate that dominates a survivor — the
  property ``tests/test_torch_tune.py`` pins.

Chaos mode (``chaos_budget > 0``) re-scores each finalist under
``chaos_budget`` fuzzer-drawn fault schedules — one crc32 sub-seeded
stream per schedule index (the ``scenarios/fuzz.py`` discipline),
identical schedules for every finalist — and the winner pick then
prefers finalists that survived every schedule: "cheapest fleet that
survives a zone loss" becomes a query.
"""

from __future__ import annotations

import dataclasses
import json
import random
import zlib
from typing import Dict, List, Optional, Sequence

from kind_tpu_sim_torch.analysis import knobs
from kind_tpu_sim_torch.tune import pareto as pareto_mod
from kind_tpu_sim_torch.tune.space import (TuneSpace, candidate_replicas,
                                     candidate_spec,
                                     fleet_workload_from_dict,
                                     generation_cost_factor,
                                     globe_replicas,
                                     globe_workload_from_dict,
                                     price_factor, slo_from_dict,
                                     workload_to_dict)

REPORT_SCHEMA = 1

# short-trace screen fidelity (fraction of the workload's request
# count) and the floor below which a screen trace stops being a
# signal at all
SCREEN_FRAC = 0.25
MIN_SCREEN_REQUESTS = 8

# a finalist "survives" a chaos schedule when the run completed and
# held at least this SLO attainment under the injected faults
CHAOS_ATTAINMENT = 0.5

# the distinct-candidate draw stream gives up after budget * this
# many draws — a space with fewer distinct points than the budget
# simply yields them all
DRAW_CAP_FACTOR = 16

# fault kinds a chaos schedule draws from, per target — the common
# denominators every candidate in a space can legally experience
# (candidate-dependent kinds would score different candidates against
# different storms; sched-only kinds like degraded_link are out —
# tune renders plain, non-scheduler-backed fleets)
FLEET_CHAOS_KINDS = ("replica_flap", "replica_preempt",
                     "slow_replica")
GLOBE_CHAOS_KINDS = ("cell_drain", "dcn_degrade", "zone_loss")
# spaces that search an `audit_frac` dim (sdc_space) are scored
# against pure defective-chip storms instead — every schedule
# exerts corruption pressure, so "zero uncontained corrupted
# responses" discriminates candidates rather than holding vacuously
SDC_FLEET_CHAOS_KINDS = ("sdc_chip",)

_WINDOW_START = (0.15, 0.5)
_WINDOW_DURATION = (0.1, 0.25)
_WINDOW_END_CAP = 0.75


TUNE_SEED_ENV = knobs.TUNE_SEED
TUNE_BUDGET_ENV = knobs.TUNE_BUDGET
TUNE_CHAOS_BUDGET_ENV = knobs.TUNE_CHAOS_BUDGET


def resolve_seed(seed: Optional[int] = None) -> int:
    """Explicit seed > env (KIND_TPU_SIM_TUNE_SEED) > 0."""
    if seed is not None:
        return seed
    return int(knobs.get(TUNE_SEED_ENV))


def resolve_budget(budget: Optional[int] = None) -> int:
    if budget is not None:
        return budget
    return int(knobs.get(TUNE_BUDGET_ENV))


def resolve_chaos_budget(chaos_budget: Optional[int] = None) -> int:
    if chaos_budget is not None:
        return chaos_budget
    return int(knobs.get(TUNE_CHAOS_BUDGET_ENV))


# -- chaos schedules --------------------------------------------------


def draw_fault_schedule(target: str, seed: int, index: int):
    """Fault schedule ``index`` of chaos stream ``seed`` — a pure
    function of its arguments, one crc32 sub-seeded rng per index
    (the fuzz discipline), candidate-independent so every finalist
    faces the same storms. ``target`` picks the kind pool ("fleet",
    "globe", or "fleet-sdc" for integrity searches) and is part of
    the rng key, so each pool is its own stream."""
    from kind_tpu_sim_torch.chaos import draw_param
    from kind_tpu_sim_torch.scenarios.spec import FaultWindow

    rng = random.Random(zlib.crc32(
        f"tune:chaos:{target}:{seed}:{index}".encode()))
    pools = {"fleet": FLEET_CHAOS_KINDS,
             "fleet-sdc": SDC_FLEET_CHAOS_KINDS,
             "globe": GLOBE_CHAOS_KINDS}
    pool = pools[target]
    windows = []
    for _ in range(rng.randint(1, 2)):
        kind = pool[rng.randrange(len(pool))]
        start = round(rng.uniform(*_WINDOW_START), 3)
        end = round(min(_WINDOW_END_CAP,
                        start + rng.uniform(*_WINDOW_DURATION)), 3)
        windows.append(FaultWindow(
            kind=kind, start_frac=start, end_frac=end,
            target=rng.randint(0, 7),
            param=draw_param(kind, rng)))
    windows.sort(key=lambda f: (f.start_frac, f.kind, f.target))
    return tuple(windows)


def _fleet_chaos_events(windows, replicas: int, span: float):
    """Compile fault windows through the scenario compiler — the
    same FaultWindow -> ChaosEvent translation run_spec uses."""
    from kind_tpu_sim_torch.scenarios.spec import (ScenarioSpec,
                                             TopologySpec,
                                             WorkloadDims,
                                             _fleet_events)

    stub = ScenarioSpec(
        name="tune-chaos", description="tune chaos schedule",
        kind="spec", seed=0,
        topology=TopologySpec(kind="fleet", replicas=replicas),
        workload=WorkloadDims(), faults=tuple(windows))
    return _fleet_events(stub, span)


def _globe_chaos_events(windows, zones, cells, span: float):
    from kind_tpu_sim_torch.scenarios.spec import (ScenarioSpec,
                                             TopologySpec,
                                             WorkloadDims,
                                             _globe_events)

    stub = ScenarioSpec(
        name="tune-chaos", description="tune chaos schedule",
        kind="spec", seed=0,
        topology=TopologySpec(kind="globe", replicas=2,
                              zones=len(zones)),
        workload=WorkloadDims(), faults=tuple(windows))
    return _globe_events(stub, span, list(zones), list(cells))


# -- one candidate evaluation (the worker-side pure function) ---------


def _scaled(n: int, fidelity: float) -> int:
    if fidelity >= 1.0:
        return n
    return max(MIN_SCREEN_REQUESTS, int(round(n * fidelity)))


def _work_chip_s(trace, dtype: str) -> float:
    """CostModel-priced demand: the chip-seconds the trace's prefill
    and decode work costs on the calibrated hardware (utilization =
    work / provisioned)."""
    from kind_tpu_sim_torch import fleet

    cost = fleet.CostModel()
    total = 0.0
    for req in trace:
        rc = cost.request_cost(len(req.prompt), req.max_new,
                               dtype=dtype)
        total += rc.prefill_s + rc.decode_s
    return round(total, 6)


def evaluate(spec: Dict[str, object]) -> Dict[str, object]:
    """Score one serialized eval spec — a pure function of the spec
    dict (the whole point: in-process and worker-pool evaluation are
    interchangeable). Returns the flat metrics row the search trace
    records."""
    target = spec["target"]
    candidate = dict(spec["candidate"])
    fidelity = float(spec.get("fidelity", 1.0))
    seed = int(spec["seed"])
    slo = slo_from_dict(dict(spec["slo"]))
    max_virtual_s = float(spec.get("max_virtual_s", 600.0))
    chaos_index = spec.get("chaos_index")
    if target == "fleet":
        metrics = _evaluate_fleet(spec, candidate, fidelity, seed,
                                  slo, max_virtual_s, chaos_index)
    else:
        metrics = _evaluate_globe(spec, candidate, fidelity, seed,
                                  slo, max_virtual_s, chaos_index)
    metrics["index"] = int(spec["index"])
    metrics["fidelity"] = fidelity
    if chaos_index is not None:
        metrics["chaos_index"] = int(chaos_index)
    return metrics


def _slo_metrics(slo_report: Dict[str, object]) -> Dict[str, object]:
    return {
        "attainment": slo_report.get("attainment"),
        "goodput_tok_s": slo_report.get("goodput_tok_s"),
        "e2e_p50_s": slo_report["e2e"].get("p50_s"),
        "ttft_p50_s": slo_report["ttft"].get("p50_s"),
        "shed": slo_report.get("shed", 0),
    }


def _evaluate_fleet(spec, candidate, fidelity, seed, slo,
                    max_virtual_s, chaos_index):
    from kind_tpu_sim_torch import fleet
    from kind_tpu_sim_torch.tune.space import render_fleet

    workload = fleet_workload_from_dict(dict(spec["workload"]))
    n = _scaled(workload.n_requests, fidelity)
    if n != workload.n_requests:
        workload = dataclasses.replace(workload, n_requests=n)
    trace = fleet.generate_trace(workload, seed)
    cfg = render_fleet(candidate, slo, tenancy=workload.tenancy,
                       max_virtual_s=max_virtual_s)
    chaos_events = ()
    if chaos_index is not None:
        span = max(r.arrival_s for r in trace) if trace else 0.0
        chaos_target = ("fleet-sdc" if "audit_frac" in candidate
                        else "fleet")
        windows = draw_fault_schedule(chaos_target, seed,
                                      int(chaos_index))
        chaos_events = _fleet_chaos_events(windows, cfg.replicas,
                                           span)
    rep = fleet.FleetSim(cfg, trace,
                         chaos_events=chaos_events).run()
    replicas = candidate_replicas(candidate)
    price = price_factor(candidate)
    # generation-weighted chip-seconds (the zoo): a mixed-
    # generation candidate pays each replica's relative chip-second
    # price. The factor is exactly 1.0 without a generation_split,
    # and x * 1.0 == x bitwise, so pre-zoo search reports keep
    # their bytes.
    gen_factor = generation_cost_factor(candidate)
    dtype = (cfg.disagg.dtype if cfg.disagg is not None else "bf16")
    out = {
        "ok": bool(rep["ok"]),
        "completed": rep["completed"],
        "virtual_s": rep["virtual_s"],
        "provisioned_replicas": replicas,
        "price_factor": price,
        "cost_chip_s": round(
            replicas * rep["virtual_s"] * price * gen_factor, 6),
        "work_chip_s": _work_chip_s(trace, dtype),
    }
    if gen_factor != 1.0:
        out["generation_cost_factor"] = gen_factor
    out.update(_slo_metrics(rep["slo"]))
    if cfg.disagg is not None:
        out["kv_handoffs"] = rep["disagg"]["kv"]["handoffs"]
    integ = rep.get("integrity")
    if isinstance(integ, dict):
        # integrity scoring (the SDC lane), keyed only when the run
        # was SDC-active so pre-SDC metrics rows keep their bytes.
        # An "uncontained" corrupted response was served by a chip
        # that was never caught, or after its detection — the
        # pre-detection escapes an audit_frac prices are the lane's
        # accepted latency cost, everything else is a dead fleet.
        counters = integ.get("counters") or {}
        detect_s = {d["replica"]: d["at_s"]
                    for d in integ.get("detections", ())}
        out["corrupted_served"] = int(
            counters.get("corrupted_served", 0))
        out["corrupted_uncontained"] = sum(
            1 for e in rep["completions"]
            if e.get("corrupted") and not e.get("sdc_caught")
            and (e["replica"] not in detect_s
                 or e["finish_s"] > detect_s[e["replica"]]))
        out["audits"] = int(counters.get("audits", 0))
        out["chips_quarantined"] = int(
            counters.get("chips_quarantined", 0))
    return out


def _evaluate_globe(spec, candidate, fidelity, seed, slo,
                    max_virtual_s, chaos_index):
    from kind_tpu_sim_torch import globe
    from kind_tpu_sim_torch.tune.space import render_globe

    workload = globe_workload_from_dict(dict(spec["workload"]))
    n = _scaled(workload.n_per_zone, fidelity)
    if n != workload.n_per_zone:
        workload = dataclasses.replace(workload, n_per_zone=n)
    cfg = render_globe(candidate, slo, workload,
                       max_virtual_s=max_virtual_s)
    traces = globe.generate_globe_traces(cfg, seed)
    chaos_events = ()
    if chaos_index is not None:
        span = max((r.arrival_s for reqs in traces.values()
                    for r in reqs), default=0.0)
        windows = draw_fault_schedule("globe", seed,
                                      int(chaos_index))
        chaos_events = _globe_chaos_events(
            windows, cfg.zones, cfg.cell_names(), span)
    rep = globe.GlobeSim(cfg, traces=traces, seed=seed,
                         chaos_events=chaos_events).run()
    replicas = globe_replicas(candidate)
    price = price_factor(candidate)
    flat = [r for reqs in traces.values() for r in reqs]
    out = {
        "ok": bool(rep["ok"]),
        "completed": rep["completed"],
        "virtual_s": rep["virtual_s"],
        "provisioned_replicas": replicas,
        "price_factor": price,
        "cost_chip_s": round(
            replicas * rep["virtual_s"] * price, 6),
        "work_chip_s": _work_chip_s(flat, "bf16"),
    }
    out.update(_slo_metrics(rep["global_slo"]))
    return out


def _eval_batch(evals: Sequence[dict]) -> List[dict]:
    """The ``run_grid`` worker target: one contiguous index chunk of
    eval specs, scored in order."""
    return [evaluate(dict(spec)) for spec in evals]


def _run_evals(evals: List[dict], workers: int,
               timeout: float) -> List[dict]:
    """Score every eval spec, in the order given. ``workers <= 1``
    runs in-process; otherwise the evals are sharded into contiguous
    chunks over ``run_grid`` cold workers (``utils/worker_pool.py``,
    which load this module and the analytic simulators, never torch)
    and concatenated back —
    chunking is a pure function of (len(evals), workers), so the
    merged order (and with it the whole search trace) is identical
    across worker counts and completion orders."""
    if workers <= 1 or len(evals) <= 1:
        return [evaluate(spec) for spec in evals]
    from kind_tpu_sim_torch.utils.worker_pool import run_grid

    workers = min(workers, len(evals))
    base, extra = divmod(len(evals), workers)
    chunks: List[List[dict]] = []
    at = 0
    for w in range(workers):
        size = base + (1 if w < extra else 0)
        chunks.append(evals[at:at + size])
        at += size
    results = run_grid(
        [{} for _ in range(workers)],
        "kind_tpu_sim_torch.tune.driver:_eval_batch",
        timeout,
        kwargs_list=[{"evals": chunk} for chunk in chunks])
    merged: List[dict] = []
    for chunk_result in results:
        merged.extend(chunk_result)
    return merged


# -- the search -------------------------------------------------------


def _rank_key(metrics: Dict[str, object]):
    """Screen/final ranking: goodput first, then attainment, then
    e2e p50, then index — deterministic under ties."""
    good = metrics.get("goodput_tok_s") or 0.0
    att = metrics.get("attainment") or 0.0
    e2e = metrics.get("e2e_p50_s")
    return (-float(good), -float(att),
            float("inf") if e2e is None else float(e2e),
            int(metrics["index"]))


def _pareto_points(rows: Sequence[Dict[str, object]]) -> List[dict]:
    return [{
        "index": int(m["index"]),
        "cost_chip_s": m.get("cost_chip_s"),
        "goodput_tok_s": m.get("goodput_tok_s"),
        "attainment": m.get("attainment"),
    } for m in rows]


def survivors_of(screen: Sequence[Dict[str, object]]) -> List[int]:
    """Indices advancing from the screen rung: the top half by rank,
    every screen-Pareto-non-dominated candidate, and — transitively —
    any candidate that dominates a survivor. The closure is what
    makes halving dominance-safe: the rank key ignores cost, so a
    strictly-cheaper-but-otherwise-equal candidate can sit below the
    rank cut AND off the front (dominated by some third point) while
    dominating a rank-kept survivor; without the closure it would be
    dropped. The property ``tests/test_torch_tune.py`` pins."""
    ranked = sorted(screen, key=_rank_key)
    keep = max(1, len(ranked) // 2)
    survivors = {int(m["index"]) for m in ranked[:keep]}
    survivors |= {int(p["index"]) for p in
                  pareto_mod.pareto_front(_pareto_points(screen))}
    rows = {int(m["index"]): m for m in screen}
    changed = True
    while changed:
        changed = False
        for m in screen:
            idx = int(m["index"])
            if idx in survivors:
                continue
            if any(pareto_mod.dominates(m, rows[s])
                   for s in survivors):
                survivors.add(idx)
                changed = True
    return sorted(survivors)


def tune(space: TuneSpace, workload, slo,
         seed: Optional[int] = None, budget: Optional[int] = None,
         workers: int = 0, chaos_budget: Optional[int] = None,
         screen_frac: float = SCREEN_FRAC,
         max_virtual_s: float = 600.0,
         workload_seed: Optional[int] = None,
         timeout: float = 600.0, timer=None) -> Dict[str, object]:
    """Run the search. The canonical report is a pure function of
    (space, workload, slo, seed, workload_seed, budget, screen_frac,
    max_virtual_s, chaos_budget) — wall-clock timings only join when
    the caller passes a ``timer`` (the CLI and the tests do not).
    ``seed`` drives the candidate draw stream;
    ``workload_seed`` (default: same value) drives trace generation
    and the chaos schedules, and is what winner specs carry."""
    seed = resolve_seed(seed)
    budget = resolve_budget(budget)
    chaos_budget = resolve_chaos_budget(chaos_budget)
    ws = seed if workload_seed is None else workload_seed
    if budget < 2:
        raise ValueError("tune needs budget >= 2")
    t0 = timer() if timer is not None else 0.0

    # draw until `budget` DISTINCT candidates (or the capped draw
    # stream runs dry — a small discrete space simply yields fewer):
    # duplicates waste sim time and random draws over tiny spaces
    # would otherwise miss values the budget could afford to cover.
    # A candidate's index is its DRAW index, so every spec stays
    # `space.draw(seed, index)`-replayable.
    candidates: Dict[int, Dict[str, object]] = {}
    seen: set = set()
    for draw_index in range(budget * DRAW_CAP_FACTOR):
        if len(candidates) >= budget:
            break
        cand = space.draw(seed, draw_index)
        key = json.dumps(cand, sort_keys=True)
        if key in seen:
            continue
        seen.add(key)
        candidates[draw_index] = cand
    indices = sorted(candidates)

    def eval_spec(index: int, fidelity: float,
                  chaos_index: Optional[int] = None) -> dict:
        spec = candidate_spec(space, candidates[index], index, ws,
                              workload, slo,
                              max_virtual_s=max_virtual_s)
        spec["fidelity"] = fidelity
        if chaos_index is not None:
            spec["chaos_index"] = chaos_index
        return spec

    runs: List[dict] = []

    def record(rung: str, rows: List[dict]) -> None:
        for m in rows:
            entry = {"rung": rung, "index": m["index"],
                     "candidate": dict(candidates[m["index"]]),
                     "metrics": m}
            runs.append(entry)

    # rung 0: every candidate on the short trace
    screen_specs = [eval_spec(i, screen_frac) for i in indices]
    screen = _run_evals(screen_specs, workers, timeout)
    record("screen", screen)
    t_screen = timer() if timer is not None else 0.0

    # rung 1: survivors on the full trace
    finalists = survivors_of(screen)
    final_specs = [eval_spec(i, 1.0) for i in finalists]
    final = _run_evals(final_specs, workers, timeout)
    record("final", final)

    front = pareto_mod.pareto_front(_pareto_points(final))
    by_index = {int(m["index"]): m for m in final}

    # chaos rescoring: every finalist against the same drawn storms
    chaos_section: Optional[dict] = None
    survived_all: Dict[int, bool] = {}
    if chaos_budget > 0:
        chaos_specs = [eval_spec(i, 1.0, chaos_index=j)
                       for i in finalists
                       for j in range(chaos_budget)]
        chaos_rows = _run_evals(chaos_specs, workers, timeout)
        record("chaos", chaos_rows)
        per_finalist: Dict[str, dict] = {}
        for i in finalists:
            mine = [m for m in chaos_rows if m["index"] == i]
            survived = [
                bool(m["ok"]
                     and (m.get("attainment") or 0.0)
                     >= CHAOS_ATTAINMENT
                     # integrity searches: surviving
                     # an SDC storm additionally means zero
                     # uncontained corrupted responses. Absent on
                     # every non-SDC row (None -> passes), so
                     # pre-SDC reports keep their bytes.
                     and not m.get("corrupted_uncontained"))
                for m in mine]
            survived_all[i] = all(survived)
            per_finalist[str(i)] = {
                "survived_all": all(survived),
                "survival_frac": round(
                    sum(survived) / len(survived), 6),
                "schedules": [
                    {"chaos_index": m["chaos_index"],
                     "ok": m["ok"],
                     "attainment": m.get("attainment"),
                     "survived": s}
                    for m, s in zip(mine, survived)],
            }
        if space.target != "fleet":
            chaos_kinds = GLOBE_CHAOS_KINDS
        elif any(d.name == "audit_frac" for d in space.dims):
            chaos_kinds = SDC_FLEET_CHAOS_KINDS
        else:
            chaos_kinds = FLEET_CHAOS_KINDS
        chaos_section = {
            "budget": chaos_budget,
            "min_attainment": CHAOS_ATTAINMENT,
            "kinds": list(chaos_kinds),
            "finalists": per_finalist,
        }

    # winner: knee of the front — restricted to all-schedule chaos
    # survivors when chaos mode is on and any finalist survived
    pick_from = front
    if chaos_section is not None:
        surviving = [p for p in front
                     if survived_all.get(int(p["index"]))]
        if not surviving and any(survived_all.values()):
            # no fault-free-front point rode out every storm, but
            # some finalist did (typical of integrity searches:
            # audits only pay off under faults, so the fault-free
            # front is all cheap no-audit configs). "Cheapest fleet
            # that survives" outranks fault-free Pareto membership:
            # rebuild the front over the survivors alone and pick
            # the knee there.
            surviving = pareto_mod.pareto_front(_pareto_points(
                [by_index[i] for i in finalists
                 if survived_all.get(i)]))
        if surviving:
            pick_from = surviving
        chaos_section["front_survivors"] = [
            int(p["index"]) for p in surviving]
    knee = pareto_mod.knee_point(pick_from)

    winner: Optional[dict] = None
    if knee is not None:
        widx = int(knee["index"])
        winner = {
            "index": widx,
            "candidate": dict(candidates[widx]),
            "metrics": by_index[widx],
            "spec": candidate_spec(space, candidates[widx], widx,
                                   ws, workload, slo,
                                   max_virtual_s=max_virtual_s),
        }
        if chaos_section is not None:
            winner["survived_all"] = bool(survived_all.get(widx))

    report: Dict[str, object] = {
        "schema": REPORT_SCHEMA,
        "target": space.target,
        "space": space.as_dict(),
        "seed": seed,
        "workload_seed": ws,
        "budget": budget,
        "screen_frac": screen_frac,
        "workload": workload_to_dict(workload),
        "slo": {k: v for k, v in
                dataclasses.asdict(slo).items() if v is not None},
        "evaluations": len(runs),
        "candidates": {str(i): dict(candidates[i])
                       for i in indices},
        "distinct_candidates": len(indices),
        "finalists": finalists,
        "runs": runs,
        "pareto": {
            "front": front,
            "knee": knee,
        },
        "winner": winner,
        "ok": bool(winner is not None
                   and all(m["ok"] for m in final)),
    }
    if chaos_section is not None:
        report["chaos"] = chaos_section
    if timer is not None:
        elapsed = max(1e-9, timer() - t0)
        screen_s = max(0.0, t_screen - t0)
        report["timings"] = {
            "elapsed_s": round(elapsed, 3),
            "screen_s": round(screen_s, 3),
            "final_s": round(elapsed - screen_s, 3),
            "screen_frac_of_elapsed": round(
                screen_s / elapsed, 4),
            "candidates_per_s": round(len(runs) / elapsed, 3),
        }
    return report


# -- grid evaluation -------------------------------------------------


def evaluate_candidates(space: TuneSpace,
                        candidates: Sequence[Dict[str, object]],
                        workload, slo, seed: int,
                        max_virtual_s: float = 600.0,
                        workers: int = 0,
                        timeout: float = 600.0) -> List[dict]:
    """Exhaustively score an explicit candidate list at full
    fidelity — the tune driver as a sweep engine. Results come back in
    candidate order."""
    specs = []
    for i, cand in enumerate(candidates):
        spec = candidate_spec(space, cand, i, seed, workload, slo,
                              max_virtual_s=max_virtual_s)
        spec["fidelity"] = 1.0
        specs.append(spec)
    return _run_evals(specs, workers, timeout)


# -- winner spec replay -----------------------------------------------


def replay(spec: Dict[str, object]) -> Dict[str, object]:
    """Re-run one winner spec standalone. The returned metrics row
    must be byte-identical to the search's ``winner.metrics`` — the
    replayable-by-construction contract."""
    spec = dict(spec)
    spec.setdefault("fidelity", 1.0)
    return evaluate(spec)


def winner_spec_text(report: Dict[str, object]) -> Optional[str]:
    """The winner's runnable sorted-keys JSON spec (None when the
    search produced no winner)."""
    winner = report.get("winner")
    if not winner:
        return None
    return json.dumps(winner["spec"], sort_keys=True, indent=2)
