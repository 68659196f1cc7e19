"""Multi-tenant serving: the tenant population and its isolation.

The port's copy of ``kind_tpu_sim/fleet/tenancy.py``:

* :class:`TenantSpec` / :class:`TenancyConfig`: the declared tenants,
  each with a QoS tier (``interactive`` / ``standard`` / ``batch``), a
  weighted-fair share, a user count with Zipf per-user rates, a session
  shape and admission quotas (request-rate and token-metered).
* :func:`generate_tenant_trace`: the seeded heavy-tailed workload
  (``loadgen.generate_trace`` hands a spec with ``tenancy`` to it):
  Lewis thinning for arrivals, tenants drawn by ``rps_share``, users by
  Zipf rank, sessions of think-time-spaced requests, per-(tenant, user)
  prefix cohorts.
* :class:`RateBucket`: ``overload.TokenBucket`` refilled by virtual
  time, so a quota is a rate.
* :class:`TenancyState`: one fleet's quota buckets, admission verdicts
  and shed counts, and the weights, ranks and tiers that the router's
  deficit round robin and the brownout ladder read.
* :func:`tenant_surge_trace`: extra arrivals from one tenant in a
  window (the noisy-neighbour workload).

Traces are host data drawn with ``random.Random`` streams keyed by
``zlib.crc32``, in the reference's draw order, so they equal the
reference's item for item. An unset ``isolation`` and ``drr_quantum``
resolve from their environment knobs (``KIND_TPU_SIM_TENANT_*``), else
the knobs' defaults. A tenant's ``kv_budget_frac`` below 1 caps
its share of a decode pool's slots (:meth:`TenancyState.kv_budget`,
read by the router's KV lane) and of an analytic replica's prefix-cache
entries; engine replicas have neither.
"""

from __future__ import annotations

import bisect
import dataclasses
import random
import zlib
from typing import Dict, List, Optional, Tuple

from kind_tpu_sim_torch.analysis import knobs
from kind_tpu_sim_torch.fleet.overload import TokenBucket

# QoS ladder, best first: strict priority at the router; batch is the
# tier brownout sheds
QOS_TIERS = ("interactive", "standard", "batch")

TENANT_ISOLATION_ENV = knobs.TENANT_ISOLATION
TENANT_DRR_QUANTUM_ENV = knobs.TENANT_DRR_QUANTUM


def resolve_isolation(value: Optional[bool] = None) -> bool:
    """Explicit value > env (KIND_TPU_SIM_TENANT_ISOLATION) > on."""
    if value is not None:
        return bool(value)
    return bool(knobs.get(TENANT_ISOLATION_ENV))


def resolve_drr_quantum(value: Optional[float] = None) -> float:
    """Explicit value > env (KIND_TPU_SIM_TENANT_DRR_QUANTUM) > 4.0
    (requests credited per DRR visit per unit weight)."""
    if value is not None:
        return float(value)
    return float(knobs.get(TENANT_DRR_QUANTUM_ENV))


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: its traffic (share, users, sessions) and its
    isolation (tier, weight, quotas). A quota of 0 is unlimited."""

    name: str
    qos: str = "standard"
    weight: float = 1.0
    rps_share: float = 1.0
    users: int = 100
    zipf_a: float = 1.1
    session_len: Tuple[int, int] = (1, 3)
    think_time_s: float = 0.2
    quota_rps: float = 0.0
    quota_burst: float = 8.0
    token_quota_per_s: float = 0.0
    token_quota_burst: float = 512.0
    kv_budget_frac: float = 1.0

    def __post_init__(self):
        if self.qos not in QOS_TIERS:
            raise ValueError(f"unknown qos tier {self.qos!r}; known: "
                             f"{', '.join(QOS_TIERS)}")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r} weight must be > 0 "
                             f"(got {self.weight})")
        if self.rps_share <= 0:
            raise ValueError(f"tenant {self.name!r} rps_share must be > 0 "
                             f"(got {self.rps_share})")
        if self.users < 1:
            raise ValueError(f"tenant {self.name!r} needs at least one user")

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["session_len"] = list(self.session_len)
        return d


# the spec of a request without a tenant under a tenancy-on fleet
DEFAULT_TENANT = TenantSpec(name="default")


@dataclasses.dataclass(frozen=True)
class TenancyConfig:
    """The tenant population and the isolation switches;
    ``isolation=False`` keeps the traffic model but turns off quotas and
    fair queuing."""

    tenants: Tuple[TenantSpec, ...] = ()
    isolation: Optional[bool] = None
    drr_quantum: Optional[float] = None

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("TenancyConfig needs >= 1 tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {sorted(names)}")

    def lookup(self, name: str) -> TenantSpec:
        for t in self.tenants:
            if t.name == name:
                return t
        return DEFAULT_TENANT

    def qos_rank(self, name: str) -> int:
        return QOS_TIERS.index(self.lookup(name).qos)

    def weight(self, name: str) -> float:
        return self.lookup(name).weight

    def tier(self, name: str) -> int:
        """The brownout tier: 1 (sheddable) for batch, else 0."""
        return 1 if self.lookup(name).qos == "batch" else 0

    def signature(self) -> tuple:
        """The fields that shape the traffic, which key the trace's
        random stream (quotas and weights do not)."""
        return tuple(
            (t.name, t.rps_share, t.users, t.zipf_a, tuple(t.session_len),
             t.think_time_s)
            for t in self.tenants)

    def without_quotas(self) -> "TenancyConfig":
        """The cell tier's copy in a globe: quotas are charged once, at
        the front door, while weighted-fair queuing and the KV budgets
        stay with the cells' routers."""
        return dataclasses.replace(self, tenants=tuple(
            dataclasses.replace(t, quota_rps=0.0, token_quota_per_s=0.0)
            for t in self.tenants))

    def as_dict(self) -> dict:
        return {
            "tenants": [t.as_dict() for t in self.tenants],
            "isolation": resolve_isolation(self.isolation),
            "drr_quantum": resolve_drr_quantum(self.drr_quantum),
        }


def default_tenancy() -> TenancyConfig:
    """The stock three tenants: interactive gold, standard silver, and a
    quota-bounded batch bronze."""
    return TenancyConfig(tenants=(
        TenantSpec(name="gold", qos="interactive", weight=4.0,
                   rps_share=0.3, users=50, zipf_a=1.2),
        TenantSpec(name="silver", qos="standard", weight=2.0,
                   rps_share=0.4, users=200),
        TenantSpec(name="bronze", qos="batch", weight=1.0,
                   rps_share=0.3, users=1000,
                   quota_rps=40.0, quota_burst=20.0),
    ))


def tenant_of(req) -> str:
    """The request's tenant, ``default`` when it has none."""
    return getattr(req, "tenant", "") or "default"


class RateBucket(TokenBucket):
    """A :class:`TokenBucket` refilled continuously at ``rate_per_s`` of
    virtual time; a ``take`` may cost a fraction of tokens.
    ``rate_per_s`` <= 0 disables it (every take succeeds)."""

    __slots__ = ("rate_per_s", "_last_s")

    def __init__(self, rate_per_s: float, burst: float):
        super().__init__(ratio=(1.0 if rate_per_s > 0 else 0.0),
                         burst=burst)
        self.rate_per_s = float(rate_per_s)
        self._last_s = 0.0

    def refill(self, now: float) -> None:
        if self.disabled:
            return
        dt = now - self._last_s
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + self.rate_per_s * dt)
            self._last_s = now

    def take(self, now: float, cost: float = 1.0) -> bool:
        if self.disabled:
            self.spent += 1
            return True
        self.refill(now)
        if self.tokens >= cost:
            self.tokens -= cost
            self.spent += 1
            return True
        self.suppressed += 1
        return False

    def report(self) -> Dict[str, object]:
        out = super().report()
        out["rate_per_s"] = self.rate_per_s
        return out


class TenancyState:
    """One fleet's tenancy state: quota buckets made per tenant as its
    requests are seen, admission and shed counts, and the declared
    weights, ranks and tiers."""

    def __init__(self, cfg: TenancyConfig):
        self.cfg = cfg
        self.isolation = resolve_isolation(cfg.isolation)
        self.drr_quantum = resolve_drr_quantum(cfg.drr_quantum)
        self._quota: Dict[str, RateBucket] = {}
        self._token_quota: Dict[str, RateBucket] = {}
        self.admitted: Dict[str, int] = {}
        self.quota_shed: Dict[str, int] = {}
        self.token_shed: Dict[str, int] = {}
        self.kv_deferred: Dict[str, int] = {}

    def qos_rank(self, name: str) -> int:
        return self.cfg.qos_rank(name)

    def weight(self, name: str) -> float:
        return self.cfg.weight(name)

    def tier(self, name: str) -> int:
        return self.cfg.tier(name)

    def kv_budget(self, name: str, capacity: int) -> Optional[int]:
        """The tenant's cap out of ``capacity`` units (a decode pool's
        slots or a replica's prefix-cache entries); None when uncapped
        (``kv_budget_frac`` >= 1, or isolation off)."""
        if not self.isolation:
            return None
        frac = self.cfg.lookup(name).kv_budget_frac
        if frac >= 1.0:
            return None
        return max(1, int(frac * capacity))

    def note_kv_deferred(self, name: str) -> None:
        self.kv_deferred[name] = self.kv_deferred.get(name, 0) + 1

    def _bucket(self, buckets: Dict[str, RateBucket], name: str,
                rate: str, burst: str) -> RateBucket:
        b = buckets.get(name)
        if b is None:
            ts = self.cfg.lookup(name)
            b = buckets[name] = RateBucket(getattr(ts, rate),
                                           getattr(ts, burst))
        return b

    def admit(self, req, now: float) -> Optional[str]:
        """The quota verdict for one fresh arrival: None admits, else
        the shed reason. Without isolation everything is admitted."""
        name = tenant_of(req)
        if self.isolation:
            if not self._bucket(self._quota, name, "quota_rps",
                                "quota_burst").take(now):
                self.quota_shed[name] = self.quota_shed.get(name, 0) + 1
                return "tenant_quota"
            cost = float(len(req.prompt) + req.max_new)
            if not self._bucket(self._token_quota, name, "token_quota_per_s",
                                "token_quota_burst").take(now, cost):
                self.token_shed[name] = self.token_shed.get(name, 0) + 1
                return "tenant_token_quota"
        self.admitted[name] = self.admitted.get(name, 0) + 1
        return None

    def report(self) -> Dict[str, object]:
        tenants: Dict[str, object] = {}
        names = sorted(set(self.admitted) | set(self.quota_shed)
                       | set(self.token_shed) | set(self.kv_deferred)
                       | {t.name for t in self.cfg.tenants})
        for name in names:
            ts = self.cfg.lookup(name)
            row: Dict[str, object] = {
                "qos": ts.qos,
                "weight": ts.weight,
                "admitted": self.admitted.get(name, 0),
                "quota_shed": self.quota_shed.get(name, 0),
                "token_shed": self.token_shed.get(name, 0),
            }
            if name in self._quota:
                row["quota"] = self._quota[name].report()
            if name in self._token_quota:
                row["token_quota"] = self._token_quota[name].report()
            if name in self.kv_deferred:
                row["kv_deferred"] = self.kv_deferred[name]
            tenants[name] = row
        return {"isolation": self.isolation,
                "drr_quantum": self.drr_quantum,
                "tenants": tenants}


# -- the tenant workload -------------------------------------------------


def _zipf_cum(users: int, a: float) -> List[float]:
    """Cumulative Zipf(a) weights over user ranks (rank 0 hottest)."""
    w = [(u + 1) ** -a for u in range(users)]
    total = sum(w)
    cum: List[float] = []
    acc = 0.0
    for x in w:
        acc += x
        cum.append(acc / total)
    return cum


def _user_cohort(seed: int, tenant: str, user: int, prefix_len: int,
                 vocab: int) -> tuple:
    """A (tenant, user)'s prefix cohort: group id and shared prefix,
    from a crc32 sub-stream."""
    sub = random.Random(zlib.crc32(
        f"tenant-prefix:{seed}:{tenant}:{user}".encode("utf-8")))
    group = sub.randrange(2 ** 31)
    prefix = tuple(sub.randrange(vocab) for _ in range(max(1, prefix_len)))
    return group, prefix


def generate_tenant_trace(spec, seed: int) -> list:
    """The tenancy-on trace: Lewis thinning against the process's peak
    rate, each accepted arrival opening a session of a (tenant, user)
    drawn by share and Zipf rank; session requests are think-time
    spaced and share the user's prefix cohort (at the spec's
    ``shared_prefix_frac``). Ids follow the final (arrival, draw) order."""
    from kind_tpu_sim_torch.fleet.loadgen import (
        TraceRequest,
        _rate_at,
        _spec_rng,
    )

    tn: TenancyConfig = spec.tenancy
    rng = _spec_rng(spec, seed)
    if spec.process == "bursty":
        peak = spec.rps * max(1.0, spec.burst_factor)
    elif spec.process == "diurnal":
        peak = 2.0 * spec.rps
    else:
        peak = spec.rps
    share_total = sum(t.rps_share for t in tn.tenants)
    share_cum: List[float] = []
    acc = 0.0
    for t in tn.tenants:
        acc += t.rps_share / share_total
        share_cum.append(acc)
    zipf_cum = {t.name: _zipf_cum(t.users, t.zipf_a) for t in tn.tenants}
    cohorts: Dict[tuple, tuple] = {}
    entries: List[tuple] = []
    t_now = 0.0
    gen = 0
    while len(entries) < spec.n_requests:
        t_now += rng.expovariate(peak)
        if rng.random() * peak > _rate_at(spec, t_now):
            continue
        ts = tn.tenants[min(bisect.bisect_left(share_cum, rng.random()),
                            len(tn.tenants) - 1)]
        user = min(bisect.bisect_left(zipf_cum[ts.name], rng.random()),
                   ts.users - 1)
        n_sess = rng.randint(*ts.session_len)
        for k in range(n_sess):
            at = round(t_now + k * ts.think_time_s, 6)
            p_len = rng.randint(*spec.prompt_len)
            grouped = (spec.shared_prefix_frac > 0
                       and rng.random() < spec.shared_prefix_frac)
            if grouped:
                key = (ts.name, user)
                if key not in cohorts:
                    cohorts[key] = _user_cohort(seed, ts.name, user,
                                                spec.prefix_len, spec.vocab)
                group, prefix = cohorts[key]
                body_len = max(1, p_len - len(prefix))
                prompt = prefix + tuple(rng.randrange(spec.vocab)
                                        for _ in range(body_len))
            else:
                group = -1
                prompt = tuple(rng.randrange(spec.vocab)
                               for _ in range(max(1, p_len)))
            entries.append((at, gen, prompt, rng.randint(*spec.max_new),
                            rng.randrange(2 ** 31), group, ts.name, user))
            gen += 1
    entries.sort(key=lambda e: (e[0], e[1]))
    return [
        TraceRequest(request_id=f"t{i:05d}", arrival_s=at, prompt=prompt,
                     max_new=max_new, seed=req_seed, prefix_group=group,
                     deadline_s=spec.deadline_s, tenant=tname, user_id=user)
        for i, (at, _gen, prompt, max_new, req_seed, group, tname, user)
        in enumerate(entries[:spec.n_requests])]


def tenant_surge_trace(spec, seed: int, t0: float, t1: float,
                       multiplier: float, tenant: str) -> list:
    """The tenant trace plus extra arrivals from ``tenant`` at
    ``(multiplier - 1) x`` its nominal rate in ``[t0, t1)``, drawn from a
    crc32 sub-seed of the arguments. Surge ids are ``s``-prefixed."""
    from kind_tpu_sim_torch.fleet.loadgen import generate_trace

    tn: TenancyConfig = spec.tenancy
    ts = tn.lookup(tenant)
    share = ts.rps_share / sum(t.rps_share for t in tn.tenants)
    extra_rps = spec.rps * share * max(0.0, multiplier - 1.0)
    n_extra = int(extra_rps * max(0.0, t1 - t0))
    merged = list(generate_trace(spec, seed))
    if n_extra > 0:
        sub_seed = zlib.crc32(repr(
            ("tenant-surge", seed, tenant, round(t0, 6), round(t1, 6),
             round(multiplier, 6))).encode("utf-8"))
        surge_spec = dataclasses.replace(
            spec, process="poisson", rps=extra_rps, n_requests=n_extra,
            tenancy=TenancyConfig(tenants=(ts,), isolation=tn.isolation,
                                  drr_quantum=tn.drr_quantum))
        for req in generate_trace(surge_spec, sub_seed):
            at = round(t0 + req.arrival_s, 6)
            if at >= t1:
                break
            merged.append(dataclasses.replace(
                req, request_id=f"s{req.request_id}", arrival_s=at))
    merged.sort(key=lambda r: (r.arrival_s, r.request_id))
    return merged
