"""Search space + candidate encoding for `fleet tune` (the port's copy
of ``kind_tpu_sim/tune/space.py``).

A :class:`TuneSpace` is a frozen tuple of typed dimensions over the
fleet design space — disagg pool ratio, replica count, placement
policy, autoscaler/brownout, reserved-vs-spot split, tenancy DRR
quantum. Candidate ``index`` of stream ``seed`` is drawn from its own
``random.Random(zlib.crc32(f"tune:{space}:{seed}:{index}"))`` — the
``scenarios/fuzz.py`` per-index rng discipline — so the same seed
produces the byte-identical candidate sequence regardless of how many
candidates are drawn, in what order, or on which worker.

Every candidate renders to a complete, runnable ``FleetConfig`` /
``GlobeConfig`` (:func:`render_fleet` / :func:`render_globe`), and
:func:`candidate_spec` wraps one candidate plus its workload, SLO and
seed into a self-contained sorted-keys JSON spec — winners are
replayable by construction (:func:`kind_tpu_sim_torch.tune.driver.replay`).
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import zlib
from typing import Dict, Optional, Tuple

SPEC_SCHEMA = 1

_DIM_KINDS = ("choice", "int", "float", "bool")

# blended price of one provisioned replica-second at a given spot
# fraction: reserved capacity costs 1.0, spot capacity this fraction
# of it (the globe planner's economics, reused as a pricing
# constant so the tune cost axis rewards spot exposure)
SPOT_PRICE = 0.4


@dataclasses.dataclass(frozen=True)
class TuneDim:
    """One typed dimension. ``choice`` draws uniformly from
    ``choices``; ``int`` draws ``randint(lo, hi)`` (closed); ``float``
    draws ``uniform(lo, hi)`` rounded to 4 decimals; ``bool`` draws a
    fair coin."""

    name: str
    kind: str
    choices: Tuple = ()
    lo: Optional[float] = None
    hi: Optional[float] = None

    def __post_init__(self):
        if self.kind not in _DIM_KINDS:
            raise ValueError(f"dim {self.name!r}: unknown kind "
                             f"{self.kind!r} (want {_DIM_KINDS})")
        if self.kind == "choice" and not self.choices:
            raise ValueError(f"dim {self.name!r}: choice needs "
                             "non-empty choices")
        if self.kind in ("int", "float") and (self.lo is None
                                              or self.hi is None):
            raise ValueError(f"dim {self.name!r}: {self.kind} needs "
                             "lo and hi")

    def draw(self, rng: random.Random):
        if self.kind == "choice":
            return self.choices[rng.randrange(len(self.choices))]
        if self.kind == "int":
            return rng.randint(int(self.lo), int(self.hi))
        if self.kind == "float":
            return round(rng.uniform(self.lo, self.hi), 4)
        return rng.random() < 0.5

    def as_dict(self) -> dict:
        out: dict = {"name": self.name, "kind": self.kind}
        if self.kind == "choice":
            out["choices"] = list(self.choices)
        else:
            if self.lo is not None:
                out["lo"] = self.lo
            if self.hi is not None:
                out["hi"] = self.hi
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "TuneDim":
        return cls(name=d["name"], kind=d["kind"],
                   choices=tuple(d.get("choices", ())),
                   lo=d.get("lo"), hi=d.get("hi"))


@dataclasses.dataclass(frozen=True)
class TuneSpace:
    """A named, frozen design space over one sim target ("fleet" or
    "globe"). The name is part of every candidate's rng key, so two
    spaces never share a draw stream even under one seed."""

    name: str
    target: str
    dims: Tuple[TuneDim, ...]

    def __post_init__(self):
        if self.target not in ("fleet", "globe"):
            raise ValueError(f"space {self.name!r}: target must be "
                             "'fleet' or 'globe'")
        names = [d.name for d in self.dims]
        if len(set(names)) != len(names):
            raise ValueError(f"space {self.name!r}: duplicate dim "
                             "names")

    def draw(self, seed: int, index: int) -> Dict[str, object]:
        """Candidate ``index`` of stream ``seed`` — a pure function
        of (space, seed, index). Each candidate gets its own crc32
        sub-seeded rng (the fuzz discipline): drawing candidate 7
        never depends on having drawn 0..6."""
        rng = random.Random(zlib.crc32(
            f"tune:{self.name}:{seed}:{index}".encode()))
        return {d.name: d.draw(rng) for d in self.dims}

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "target": self.target,
            "dims": [d.as_dict() for d in self.dims],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TuneSpace":
        return cls(name=d["name"], target=d["target"],
                   dims=tuple(TuneDim.from_dict(x)
                              for x in d["dims"]))


def default_fleet_space() -> TuneSpace:
    """The stock fleet design space: every dimension family the
    tentpole names — pool ratio, replica count, placement policy,
    autoscaler/brownout, reserved-vs-spot split, tenancy DRR quantum
    (inert unless the workload carries a tenant population)."""
    return TuneSpace(
        name="fleet-default",
        target="fleet",
        dims=(
            TuneDim("pool_ratio", "choice",
                    choices=("unified", "1:3", "2:2", "3:1")),
            TuneDim("replicas", "int", lo=2, hi=6),
            TuneDim("policy", "choice",
                    choices=("least-outstanding", "round-robin")),
            TuneDim("autoscale", "bool"),
            TuneDim("brownout", "bool"),
            TuneDim("spot_frac", "choice",
                    choices=(0.0, 0.25, 0.5)),
            TuneDim("drr_quantum", "choice",
                    choices=(1.0, 4.0, 8.0)),
        ))


def default_globe_space() -> TuneSpace:
    """The stock globe design space: zone/cell/replica geometry plus
    the same economic and policy levers at front-door scope."""
    return TuneSpace(
        name="globe-default",
        target="globe",
        dims=(
            TuneDim("zones", "int", lo=2, hi=3),
            TuneDim("cells_per_zone", "int", lo=1, hi=2),
            TuneDim("replicas_per_cell", "int", lo=1, hi=3),
            TuneDim("policy", "choice",
                    choices=("least-outstanding", "round-robin")),
            TuneDim("autoscale", "bool"),
            TuneDim("spot_frac", "choice",
                    choices=(0.0, 0.25, 0.5)),
            TuneDim("spill_headroom", "choice",
                    choices=(0.25, 0.5)),
        ))


def zoo_space() -> TuneSpace:
    """The heterogeneous-fleet design space (the reference's
    docs/ZOO.md): which accelerator generations to buy
    (``generation_split``, a ``+``-joined cycle rendered into
    ``FleetConfig.generations``), where the zoo's largest model should
    live (``large_model_gen`` — ``zoo.placements``' forced-placement
    lever), plus the usual replica-count and policy levers. Candidates
    are priced with :func:`generation_cost_factor`, so a fleet of a
    dearer generation must earn its chip-second premium on the quality
    axes.

    Both generation dims draw from the port's registry
    (``costmodel.GENERATIONS``, as ``scenarios/spec.py`` does): each
    registered generation alone, then every ``+``-joined mix of two or
    more of them in registry order. On the one-generation registry each
    dim has the single value ``h100``, and every candidate's
    ``generation_cost_factor`` is 1.0."""
    from kind_tpu_sim_torch.fleet import costmodel

    gens = tuple(costmodel.GENERATIONS)
    mixes = tuple("+".join(combo) for r in range(2, len(gens) + 1)
                  for combo in itertools.combinations(gens, r))
    return TuneSpace(
        name="zoo-fleet",
        target="fleet",
        dims=(
            TuneDim("generation_split", "choice",
                    choices=gens + mixes),
            TuneDim("large_model_gen", "choice", choices=gens),
            TuneDim("replicas", "int", lo=3, hi=6),
            TuneDim("policy", "choice",
                    choices=("least-outstanding", "round-robin")),
        ))


def sdc_space() -> TuneSpace:
    """The integrity design space (the SDC lane): how much sampled
    duplicate-compute auditing to buy (``audit_frac`` — 0.0 is the
    do-nothing baseline) alongside the usual replica-count and
    policy levers. The driver scores spaces carrying an
    ``audit_frac`` dim against a dedicated ``sdc_chip`` storm pool,
    and chaos survival additionally demands zero uncontained
    corrupted responses — so "cheapest fleet serving zero corrupted
    responses under SDC chaos" is the query the knee answers, and
    the winner has to buy audits to answer it."""
    return TuneSpace(
        name="sdc-fleet",
        target="fleet",
        dims=(
            TuneDim("audit_frac", "choice",
                    choices=(0.0, 0.25, 0.5)),
            TuneDim("replicas", "int", lo=2, hi=4),
            TuneDim("policy", "choice",
                    choices=("least-outstanding", "round-robin")),
        ))


def ratio_space(ratios: Tuple[str, ...],
                policy: str = "least-outstanding") -> TuneSpace:
    """A one-dimension disagg-ratio space at a fixed policy (``fleet
    tune --ratios`` and the ``tune`` replay target)."""
    return TuneSpace(
        name="disagg-ratio",
        target="fleet",
        dims=(
            TuneDim("pool_ratio", "choice", choices=tuple(ratios)),
            TuneDim("policy", "choice", choices=(policy,)),
        ))


# -- candidate -> runnable config -------------------------------------


def candidate_replicas(candidate: Dict[str, object]) -> int:
    """Provisioned replica count a fleet candidate pays for (pool
    sum when disaggregated, the replicas dim otherwise)."""
    ratio = str(candidate.get("pool_ratio", "unified"))
    if ratio != "unified":
        p, d = ratio.split(":")
        return int(p) + int(d)
    return int(candidate.get("replicas", 2))


def render_fleet(candidate: Dict[str, object], slo,
                 tenancy=None, max_virtual_s: float = 600.0):
    """A complete runnable ``FleetConfig`` for one candidate. Pure:
    same candidate, same config. ``tenancy`` is the workload's tenant
    population (or None); a candidate's ``drr_quantum`` retunes its
    weighted-fair quantum and is inert on untenanted workloads."""
    from kind_tpu_sim_torch import fleet

    ratio = str(candidate.get("pool_ratio", "unified"))
    disagg = (fleet.DisaggConfig.parse(ratio)
              if ratio != "unified" else None)
    replicas = candidate_replicas(candidate)
    ten = tenancy
    if ten is not None and "drr_quantum" in candidate:
        ten = dataclasses.replace(
            ten, drr_quantum=float(candidate["drr_quantum"]))
    # heterogeneous-generation candidates (zoo_space): the split is
    # the generation cycle, and the fleet serves the stock zoo so
    # model placement is a searched lever. Only zoo candidates pass
    # these keys — every other space renders the exact config it
    # always did.
    generations = None
    zoo_cfg = None
    large_gen = None
    if "generation_split" in candidate:
        from kind_tpu_sim_torch.fleet.zoo import default_zoo

        generations = tuple(
            str(candidate["generation_split"]).split("+"))
        zoo_cfg = default_zoo()
        if "large_model_gen" in candidate:
            large_gen = str(candidate["large_model_gen"])
    # integrity candidates (sdc_space): the searched audit fraction
    # becomes the fleet's duplicate-compute sampling rate. None (not
    # 0.0) when the dim is absent, so every pre-SDC space renders
    # the exact config it always did.
    audit_frac = (float(candidate["audit_frac"])
                  if "audit_frac" in candidate else None)
    return fleet.FleetConfig(
        replicas=replicas,
        policy=str(candidate.get("policy", "least-outstanding")),
        max_virtual_s=max_virtual_s,
        autoscale=bool(candidate.get("autoscale", False)),
        slo=slo,
        overload=(fleet.OverloadConfig()
                  if candidate.get("brownout") else None),
        disagg=disagg,
        tenancy=ten,
        zoo=zoo_cfg,
        generations=generations,
        zoo_large_model_gen=large_gen,
        audit_frac=audit_frac)


def render_globe(candidate: Dict[str, object], slo, workload,
                 max_virtual_s: float = 600.0):
    """A complete runnable ``GlobeConfig`` for one candidate.
    Scheduler-backed cells stay off (the analytic flat-warm-up path):
    tune evaluates thousands of fleets, and placement detail is not a
    searched dimension here."""
    from kind_tpu_sim_torch import globe

    n_zones = int(candidate.get("zones", 2))
    zones = tuple(f"zone-{chr(ord('a') + i)}"
                  for i in range(n_zones))
    return globe.GlobeConfig(
        zones=zones,
        cells_per_zone=int(candidate.get("cells_per_zone", 1)),
        replicas_per_cell=int(candidate.get("replicas_per_cell", 2)),
        policy=str(candidate.get("policy", "least-outstanding")),
        max_virtual_s=max_virtual_s,
        slo=slo,
        sched=False,
        autoscale=bool(candidate.get("autoscale", False)),
        frontdoor=globe.FrontDoorConfig(
            spill_headroom=float(
                candidate.get("spill_headroom", 0.25))),
        workload=workload)


def globe_replicas(candidate: Dict[str, object]) -> int:
    """Provisioned replica count a globe candidate pays for."""
    return (int(candidate.get("zones", 2))
            * int(candidate.get("cells_per_zone", 1))
            * int(candidate.get("replicas_per_cell", 2)))


def price_factor(candidate: Dict[str, object]) -> float:
    """Blended per-replica-second price under the candidate's
    reserved-vs-spot split: ``1 - spot_frac * (1 - SPOT_PRICE)``."""
    spot = float(candidate.get("spot_frac", 0.0))
    return round(1.0 - spot * (1.0 - SPOT_PRICE), 6)


def generation_cost_factor(candidate: Dict[str, object]) -> float:
    """Mean relative chip-second price over the candidate's replica
    generation cycle (``GENERATION_FACTS[*]["chip_second_cost"]``,
    relative to the default generation's) — the generation-weighted
    term of the tune cost axis. Exactly 1.0 for candidates without a
    ``generation_split``, so every pre-zoo search report keeps its
    bytes."""
    split = candidate.get("generation_split")
    if not split:
        return 1.0
    from kind_tpu_sim_torch.fleet.costmodel import GENERATION_FACTS

    gens = str(split).split("+")
    n = max(1, candidate_replicas(candidate))
    total = sum(GENERATION_FACTS[gens[i % len(gens)]]
                ["chip_second_cost"] for i in range(n))
    return round(total / n, 6)


# -- workload / slo (de)serialization ---------------------------------


def slo_to_dict(slo) -> dict:
    return {k: v for k, v in dataclasses.asdict(slo).items()
            if v is not None}


def slo_from_dict(d: dict):
    from kind_tpu_sim_torch import fleet

    return fleet.SloPolicy(**d)


def workload_to_dict(spec) -> dict:
    """A fleet ``WorkloadSpec`` (or globe ``GlobeWorkloadSpec``) as a
    plain sorted-friendly dict. The tenant population is carried as a
    boolean (``default_tenancy()`` on replay) — tune searches *over*
    quota/quantum dims, it does not serialize bespoke populations."""
    d = dataclasses.asdict(spec)
    for key in ("prompt_len", "max_new"):
        if key in d and d[key] is not None:
            d[key] = list(d[key])
    if "tenancy" in d:
        d["tenancy"] = spec.tenancy is not None
    # the zoo serializes in full (unlike tenancy, the model set IS
    # a searched-over axis) but stays OFF the wire when absent so
    # every unzooed tune spec/report keeps its bytes
    if "zoo" in d:
        if spec.zoo is None:
            del d["zoo"]
        else:
            d["zoo"] = spec.zoo.as_dict()
    return d


def fleet_workload_from_dict(d: dict):
    from kind_tpu_sim_torch import fleet

    d = dict(d)
    for key in ("prompt_len", "max_new"):
        if key in d and d[key] is not None:
            d[key] = tuple(d[key])
    if d.pop("tenancy", False):
        d["tenancy"] = fleet.default_tenancy()
    if d.get("zoo"):
        from kind_tpu_sim_torch.fleet.zoo import zoo_config_from_dict
        d["zoo"] = zoo_config_from_dict(d["zoo"])
    return fleet.WorkloadSpec(**d)


def globe_workload_from_dict(d: dict):
    from kind_tpu_sim_torch import globe

    d = dict(d)
    d.pop("tenancy", None)
    for key in ("prompt_len", "max_new"):
        if key in d and d[key] is not None:
            d[key] = tuple(d[key])
    return globe.GlobeWorkloadSpec(**d)


def candidate_spec(space: TuneSpace, candidate: Dict[str, object],
                   index: int, seed: int, workload, slo,
                   max_virtual_s: float = 600.0) -> dict:
    """The self-contained runnable spec of one candidate — what the
    winner file holds. ``driver.replay(spec)`` reruns it standalone
    and must reproduce the search's metrics byte-identically."""
    return {
        "schema": SPEC_SCHEMA,
        "target": space.target,
        "space": space.as_dict(),
        "candidate": dict(candidate),
        "index": index,
        "seed": seed,
        "workload": workload_to_dict(workload),
        "slo": slo_to_dict(slo),
        "max_virtual_s": max_virtual_s,
    }
