"""The named invariant catalog (the port's copy of
``kind_tpu_sim/scenarios/invariants.py``).

Every scenario assertion that used to live as a bespoke ``assert``
inside a chaos.py scenario function has a NAME here, and every spec
(legacy or declarative) declares which names it must satisfy. The
UNIVERSAL set is checked on every fuzzer run regardless of spec —
they are properties of the simulator itself, not of one experiment:

* ``verdict-ok`` — the report's own verdict is green.
* ``no-lost-work`` — zero lost or duplicated work: every traced
  request reaches exactly one terminal outcome (the training
  ledger's conservation law generalized to serving completions),
  and no attempt id is double-logged.
* ``ledger-clean`` — every training ledger verifies, and no gang
  loses steps unless the spec composed a ``train_kill`` (hard
  kills are the ONLY sanctioned step-loss path).
* ``containment`` — overload controls stay inside their budgets:
  token-bucket arithmetic holds (spent <= burst + ratio * earned)
  and the scheduled/suppressed counters reconcile with the buckets.
* ``tenant-accounting`` — tenancy conservation: per-tenant admission
  books (admitted + quota/token sheds) reconcile with the distinct
  base ids reaching terminal outcomes.
* ``no-corruption-escapes`` — once a replica's defective chip is
  detected, no later completion it produced serves a corrupted
  payload uncaught (SDC containment).
* ``recovery`` — after the faults lift, the control planes let go:
  no breaker still open, brownout back at level 0.
* ``replay-identical`` — a second run of the same (spec, seed) is
  byte-identical; a violation names the first divergent event via
  the replaycheck bisector.
* ``event-core-equality`` — the event-heap core on/off produces the
  identical report (execution strategy, never semantics).

Checks walk the report structurally (any nested sim report — legacy
scenarios embed clean/faulted runs — is checked wherever it
appears), return ``None`` on pass and a human-readable violation
detail on failure. All details are pure functions of the report, so
fuzz reports stay byte-identical across runs of one seed.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

from kind_tpu_sim_torch.analysis import replaycheck
from kind_tpu_sim_torch.scenarios.spec import ScenarioSpec

# Report sub-trees that deliberately break the universal rules:
# controls-off comparison runs (the storm the budgets exist to
# prevent) are evidence, not violations.
_EXEMPT_KEYS = ("uncontrolled", "no_controls", "controls_off")


class InvariantContext:
    """What a check sees: the spec, the report, and (fuzz runs
    only) a ``rerun(event_core)`` hook for the invariants that need
    a second simulation. Reruns are memoized — replay-identical and
    event-core-equality cost one extra run each, once."""

    def __init__(self, spec: ScenarioSpec, report: dict,
                 rerun: Optional[Callable[[Optional[bool]], dict]]
                 = None):
        self.spec = spec
        self.report = report
        self._rerun = rerun
        self._cache: Dict[object, dict] = {}

    @property
    def can_rerun(self) -> bool:
        return self._rerun is not None

    def rerun(self, event_core: Optional[bool] = None) -> dict:
        if self._rerun is None:
            raise ValueError("this context cannot rerun its spec")
        if event_core not in self._cache:
            self._cache[event_core] = self._rerun(event_core)
        return self._cache[event_core]


@dataclasses.dataclass(frozen=True)
class Invariant:
    """One named machine-checkable property. ``check(ctx)`` returns
    None (holds) or the violation detail. ``universal`` invariants
    are checked on every fuzzer run regardless of what the spec
    declares; ``needs_rerun`` ones silently pass when the context
    cannot rerun (legacy reports evaluated post-hoc)."""

    name: str
    description: str
    check: Callable[[InvariantContext], Optional[str]]
    universal: bool = True
    needs_rerun: bool = False


def _walk(obj, path=""):
    """Depth-first (sorted-key) walk yielding (path, dict) for every
    dict in the report, skipping controls-off exemplar sub-trees."""
    if isinstance(obj, dict):
        yield path, obj
        for key in sorted(obj):
            if key in _EXEMPT_KEYS:
                continue
            yield from _walk(obj[key], f"{path}{key}.")
    elif isinstance(obj, list):
        for i, item in enumerate(obj):
            yield from _walk(item, f"{path}{i}.")


def _sim_reports(report: dict):
    """Every (path, dict) that looks like a fleet/globe sim report:
    has both a completion log and a request count."""
    for path, d in _walk(report):
        if (isinstance(d.get("completions"), list)
                and isinstance(d.get("requests"), int)):
            yield path, d


def _check_verdict(ctx: InvariantContext) -> Optional[str]:
    ok = ctx.report.get("ok")
    if ok is True:
        return None
    return f"report verdict ok={ok!r}"


def _check_no_lost_work(ctx: InvariantContext) -> Optional[str]:
    for path, d in _sim_reports(ctx.report):
        log = d["completions"]
        ids = [e.get("request_id") for e in log
               if isinstance(e, dict)]
        if len(set(ids)) != len(ids):
            dupes = sorted({i for i in ids if ids.count(i) > 1})
            return (f"{path or 'report'}: duplicated attempt "
                    f"ids {dupes[:4]}")
        base = {str(i).split("~r", 1)[0] for i in ids}
        if len(base) != d["requests"]:
            return (f"{path or 'report'}: {d['requests']} requests "
                    f"but {len(base)} reached a terminal outcome "
                    "(lost or phantom work)")
    return None


def _check_ledger(ctx: InvariantContext) -> Optional[str]:
    kinds = ctx.spec.all_fault_kinds()
    # hard kills roll back to the last cadence checkpoint; an SDC
    # detection does the same (the corrupted segment is the loss the
    # bisection re-runs) — both are sanctioned
    allow_loss = ("train_kill" in kinds or "sdc_chip" in kinds)
    for path, d in _walk(ctx.report):
        if "ledger_ok" in d:
            if d["ledger_ok"] is not True:
                return (f"{path or 'report'}: training ledger "
                        "failed verification")
            lost = d.get("lost_steps", 0)
            if lost and not allow_loss:
                return (f"{path or 'report'}: {lost} training "
                        "step(s) lost without a train_kill in the "
                        "spec")
    return None


def _bucket_over(bucket: dict, burst: float) -> bool:
    ratio = bucket.get("ratio", 0.0)
    if ratio <= 0.0:
        return False    # disabled bucket: controls-off mode
    cap = burst + ratio * bucket.get("earned", 0) + 1e-9
    return bucket.get("spent", 0) > cap


def _check_containment(ctx: InvariantContext) -> Optional[str]:
    for path, d in _walk(ctx.report):
        if "retry_budget" not in d or "counters" not in d:
            continue
        cfg = d.get("config", {})
        # OverloadConfig.as_dict serializes every field, so the bursts
        # come straight from the report — a report without them is
        # itself the bug
        retry_burst = cfg["retry_budget_burst"]
        hedge_burst = cfg["hedge_budget_burst"]
        spent = suppressed = 0
        disabled = False
        for origin in sorted(d["retry_budget"]):
            bucket = d["retry_budget"][origin]
            disabled = disabled or bucket.get("ratio", 0.0) <= 0.0
            spent += bucket.get("spent", 0)
            suppressed += bucket.get("suppressed", 0)
            if _bucket_over(bucket, retry_burst):
                return (f"{path or 'report'}: origin {origin!r} "
                        f"retry bucket overspent ({bucket['spent']}"
                        f" > burst {retry_burst} + ratio x "
                        f"{bucket['earned']} earned)")
        hedge = d.get("hedge_budget", {})
        if _bucket_over(hedge, hedge_burst):
            return (f"{path or 'report'}: hedge budget overspent "
                    f"({hedge['spent']} > burst {hedge_burst} + "
                    f"ratio x {hedge.get('earned', 0)} earned)")
        # per-tenant hedge buckets: each tenant's
        # bucket is bound by the same burst — isolation means no
        # tenant can borrow another's hedge headroom
        for tenant in sorted(d.get("hedge_budget_by_tenant", {})):
            bucket = d["hedge_budget_by_tenant"][tenant]
            if _bucket_over(bucket, hedge_burst):
                return (f"{path or 'report'}: tenant {tenant!r} "
                        f"hedge budget overspent ({bucket['spent']}"
                        f" > burst {hedge_burst} + ratio x "
                        f"{bucket.get('earned', 0)} earned)")
        counters = d["counters"]
        if not disabled and counters.get(
                "retries_scheduled", 0) != spent:
            return (f"{path or 'report'}: retries_scheduled="
                    f"{counters.get('retries_scheduled', 0)} but "
                    f"buckets spent {spent} (amplification outside "
                    "the budget path)")
        if not disabled and counters.get(
                "retries_suppressed", 0) != suppressed:
            return (f"{path or 'report'}: retries_suppressed="
                    f"{counters.get('retries_suppressed', 0)} but "
                    f"buckets suppressed {suppressed}")
    return None


def _check_tenant_accounting(ctx: InvariantContext) -> Optional[str]:
    """Tenancy conservation: every fresh arrival a
    tenanted sim booked at admission (admitted + quota sheds + token
    sheds) corresponds to exactly one distinct base request id in the
    completion log — quota enforcement may refuse work but never
    lose or invent it."""
    for path, d in _sim_reports(ctx.report):
        ten = d.get("tenancy")
        if not isinstance(ten, dict) or "tenants" not in ten:
            continue
        tallies: Dict[str, set] = {}
        for e in d["completions"]:
            if not isinstance(e, dict):
                continue
            name = e.get("tenant", "") or "default"
            tallies.setdefault(name, set()).add(
                str(e.get("request_id")).split("~", 1)[0])
        for name in sorted(ten["tenants"]):
            t = ten["tenants"][name]
            booked = (t.get("admitted", 0) + t.get("quota_shed", 0)
                      + t.get("token_shed", 0))
            seen = len(tallies.get(name, ()))
            if booked != seen:
                return (f"{path or 'report'}: tenant {name!r} "
                        f"booked {booked} fresh arrivals (admitted "
                        f"+ quota/token sheds) but {seen} distinct "
                        "base ids reached a terminal outcome")
    return None


def _check_no_corruption_escape(ctx: InvariantContext
                                ) -> Optional[str]:
    """No corruption escapes after detection: once a
    replica's defective chip is detected (its entry in the integrity
    section's ``detections``), no LATER completion it produced may
    carry a corrupted payload that was served uncaught. Earlier
    escapes are the detection latency the audit_frac knob prices;
    later ones would mean quarantine failed to contain the chip."""
    for path, d in _sim_reports(ctx.report):
        integ = d.get("integrity")
        if not isinstance(integ, dict):
            continue
        detected = {det["replica"]: det["at_s"]
                    for det in integ.get("detections", ())
                    if isinstance(det, dict)}
        if not detected:
            continue
        for e in d["completions"]:
            if not isinstance(e, dict) or not e.get("corrupted"):
                continue
            if e.get("sdc_caught"):
                continue
            rid = e.get("replica")
            at = detected.get(rid)
            if at is not None and e["finish_s"] > at:
                return (f"{path or 'report'}: replica {rid} served "
                        f"corrupted {e['request_id']!r} at "
                        f"{e['finish_s']} — AFTER its detection at "
                        f"{at} (containment failed)")
    return None


def _check_recovery(ctx: InvariantContext) -> Optional[str]:
    # an SDC quarantine is a TERMINAL capacity loss:
    # the defective chip has no heal event, so the overload layer's
    # return-to-healthy contract (breakers closed, brownout
    # released) no longer applies — the survivors may legitimately
    # still be saturated at quiesce. Every other fault is windowed
    # and must heal.
    sdc_quarantined = any(
        d["integrity"].get("detections")
        for _, d in _walk(ctx.report)
        if isinstance(d.get("integrity"), dict))
    if sdc_quarantined:
        return None
    for path, d in _walk(ctx.report):
        if "brownout" in d and isinstance(d["brownout"], dict):
            b = d["brownout"]
            if b.get("enabled") and b.get("level", 0) != 0:
                return (f"{path or 'report'}: brownout still at "
                        f"level {b['level']} after quiesce")
        if "breakers" in d and isinstance(d["breakers"], dict):
            for name in sorted(d["breakers"]):
                st = d["breakers"][name].get("state")
                if st == "open":
                    return (f"{path or 'report'}: breaker "
                            f"{name!r} still open after quiesce")
    return None


def _divergence_detail(a: dict, b: dict) -> str:
    div = replaycheck.first_divergence(
        replaycheck.event_stream(a), replaycheck.event_stream(b))
    if div is None:
        return "reports differ but event streams match"
    return (f"first divergent event #{div.index} (stream "
            f"{div.stream}): "
            + json.dumps({"a": div.a, "b": div.b},
                         sort_keys=True, default=str)[:400])


def _check_replay(ctx: InvariantContext) -> Optional[str]:
    if not ctx.can_rerun:
        return None
    again = ctx.rerun(None)
    a = json.dumps(ctx.report, sort_keys=True, default=str)
    b = json.dumps(again, sort_keys=True, default=str)
    if a == b:
        return None
    return "replay diverged: " + _divergence_detail(
        ctx.report, again)


def _check_event_core(ctx: InvariantContext) -> Optional[str]:
    if not ctx.can_rerun:
        return None
    off = ctx.rerun(False)
    a = json.dumps(ctx.report, sort_keys=True, default=str)
    b = json.dumps(off, sort_keys=True, default=str)
    if a == b:
        return None
    return ("event-core on/off reports differ: "
            + _divergence_detail(ctx.report, off))


def _check_selftest_bug(ctx: InvariantContext) -> Optional[str]:
    """The DELIBERATELY BROKEN invariant behind ``chaos fuzz
    --inject-invariant-bug`` (the `--inject-entropy-bug` idiom): it
    flags a perfectly legal composition — a slow_replica window
    overlapping a replica_preempt window — so the self-test can
    prove the fuzzer finds it and the shrinker reduces the spec to
    exactly that fault pair."""
    slows = [f for f in ctx.spec.faults
             if f.kind == "slow_replica"]
    preempts = [f for f in ctx.spec.faults
                if f.kind == "replica_preempt"]
    for a in slows:
        for b in preempts:
            if (a.start_frac < b.end_frac
                    and b.start_frac < a.end_frac):
                return ("planted bug: slow_replica "
                        f"[{a.start_frac}, {a.end_frac}] overlaps "
                        f"replica_preempt [{b.start_frac}, "
                        f"{b.end_frac}]")
    # the SDC flavor of the same plant: an sdc_chip composed with
    # any replica_preempt — the pair the shrinker self-test must
    # reduce a 4-fault SDC schedule down to
    sdcs = [f for f in ctx.spec.faults if f.kind == "sdc_chip"]
    if sdcs and preempts:
        a, b = sdcs[0], preempts[0]
        return ("planted bug: sdc_chip at "
                f"{a.start_frac} composed with replica_preempt "
                f"[{b.start_frac}, {b.end_frac}]")
    return None


CATALOG: Dict[str, Invariant] = {inv.name: inv for inv in (
    Invariant("verdict-ok",
              "the report's own verdict is green",
              _check_verdict),
    Invariant("no-lost-work",
              "every traced request reaches exactly one terminal "
              "outcome; no attempt id is double-logged",
              _check_no_lost_work),
    Invariant("ledger-clean",
              "training ledgers verify; steps are lost only under "
              "a composed train_kill",
              _check_ledger),
    Invariant("containment",
              "retry/hedge token-bucket arithmetic holds and the "
              "counters reconcile with the buckets",
              _check_containment),
    Invariant("tenant-accounting",
              "per-tenant admission books (admitted + quota/token "
              "sheds) reconcile with distinct completed base ids",
              _check_tenant_accounting),
    Invariant("no-corruption-escapes",
              "after a replica's SDC detection, no later corrupted "
              "completion it produced is served uncaught",
              _check_no_corruption_escape),
    Invariant("recovery",
              "after quiesce no breaker is open and brownout is "
              "back at level 0",
              _check_recovery),
    Invariant("replay-identical",
              "a second run of (spec, seed) is byte-identical "
              "(divergences named by the replaycheck bisector)",
              _check_replay, needs_rerun=True),
    Invariant("event-core-equality",
              "event-heap core on/off produces the identical "
              "report",
              _check_event_core, needs_rerun=True),
    Invariant("fuzz-selftest-bug",
              "DELIBERATELY BROKEN self-test invariant: flags any "
              "overlapping slow_replica x replica_preempt "
              "composition (chaos fuzz --inject-invariant-bug)",
              _check_selftest_bug, universal=False),
)}

# Checked on every fuzzer run regardless of what the spec declares.
UNIVERSAL: Tuple[str, ...] = tuple(
    inv.name for inv in CATALOG.values() if inv.universal)


def check(spec: ScenarioSpec, report: dict,
          rerun: Optional[Callable[[Optional[bool]], dict]] = None,
          names: Optional[Tuple[str, ...]] = None) -> List[dict]:
    """Evaluate the named invariants (default: the spec's declared
    set plus UNIVERSAL when the context can rerun) and return the
    violations, each ``{"invariant": name, "detail": str}``, in
    catalog order — deterministic for byte-identical fuzz reports."""
    ctx = InvariantContext(spec, report, rerun)
    if names is None:
        names = tuple(dict.fromkeys(
            (UNIVERSAL if rerun is not None else ())
            + tuple(spec.invariants)))
    out: List[dict] = []
    for name in names:
        inv = CATALOG.get(name)
        if inv is None:
            raise ValueError(
                f"unknown invariant {name!r}; known: "
                f"{', '.join(sorted(CATALOG))}")
        detail = inv.check(ctx)
        if detail is not None:
            out.append({"invariant": name, "detail": detail})
    return out
