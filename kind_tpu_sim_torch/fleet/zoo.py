"""The model zoo: one fleet serving several models.

The port's copy of ``kind_tpu_sim/fleet/zoo.py``. Each replica holds one
model's weights resident (its warm pool), every request names the model
it targets, and a request routed to a replica whose resident model
differs pays a modeled weight load, the **model swap**, priced from the
generation's calibration (weights stream in at ``SWAP_LOAD_FRACTION`` of
the achieved HBM bandwidth; the KIND_TPU_SIM_ZOO_SWAP_FACTOR knob scales
it).

* :class:`ModelSpec` / :class:`ZooConfig`: the declared models (weight
  and KV footprints as multipliers over the calibration's geometry) and
  the request mixes, per tenant if declared.
* :func:`stamp_models`: the trace hook; it stamps a model on every
  request from a fresh crc32 sub-stream (``zoo:<sig>:<seed>``), so the
  base trace's stream is untouched and an unzooed trace stays as it was.
* The per-(model, generation) prices: :func:`model_sim_config` (a
  ``SimReplicaConfig`` whose per-model maps carry each fitting model's
  prefill, TPOT and swap time on one generation's calibration),
  :func:`swap_s` and :func:`fits` (whether a model's weights and a KV
  headroom fit the generation's HBM).

The port registers one generation, ``h100`` (``costmodel``), priced from
the H100's calibration. Everything here is float arithmetic over
(config, calibration) and the seeded stamp stream, so zoo runs replay
byte for byte.
"""

from __future__ import annotations

import dataclasses
import random
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from kind_tpu_sim_torch.analysis import knobs
from kind_tpu_sim_torch.fleet.costmodel import (
    DEFAULT_GENERATION,
    GENERATION_FACTS,
    load_generation,
)

# The share of the achieved HBM bandwidth a weight load streams at: the
# checkpoint arrives over the host path and is resharded on the way in.
# The reference's modelling constant, not a measurement of any chip; the
# overall scale is the ZOO_SWAP_FACTOR knob.
SWAP_LOAD_FRACTION = 0.125


def resolve_generation(value: Optional[str] = None) -> str:
    """``value``, else KIND_TPU_SIM_GENERATION, else ``h100``; a name the
    registry lacks raises."""
    from kind_tpu_sim_torch.fleet.costmodel import GENERATIONS

    gen = value if value is not None else knobs.get(knobs.GENERATION)
    if gen not in GENERATIONS:
        raise ValueError(
            f"unknown generation {gen!r}; registered: "
            f"{', '.join(GENERATIONS)}")
    return gen


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One zoo member. ``weight_mb`` is the resident footprint a swap
    loads and the fit check charges; ``compute_scale`` and ``kv_scale``
    multiply the calibration's prefill time and per-request KV bytes."""

    name: str
    weight_mb: float
    compute_scale: float = 1.0
    kv_scale: float = 1.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("zoo model needs a name")
        if self.weight_mb <= 0:
            raise ValueError(
                f"model {self.name!r} weight_mb must be > 0 "
                f"(got {self.weight_mb})")
        if self.compute_scale <= 0 or self.kv_scale <= 0:
            raise ValueError(
                f"model {self.name!r} scales must be > 0")

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "weight_mb": self.weight_mb,
            "compute_scale": self.compute_scale,
            "kv_scale": self.kv_scale,
        }


@dataclasses.dataclass(frozen=True)
class ZooConfig:
    """The declared models and the request mixes: ``mix`` is the default
    (model name, weight) distribution, ``tenant_mixes`` overrides it per
    tenant. Weights are normalized at draw time."""

    models: Tuple[ModelSpec, ...]
    mix: Tuple[Tuple[str, float], ...] = ()
    tenant_mixes: Tuple[Tuple[str, Tuple[Tuple[str, float], ...]],
                        ...] = ()

    def __post_init__(self):
        if not self.models:
            raise ValueError("zoo needs at least one model")
        names = [m.name for m in self.models]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate zoo model names: {names}")
        known = set(names)
        for name, _ in self.mix:
            if name not in known:
                raise ValueError(
                    f"mix references unknown model {name!r}")
        for tenant, mix in self.tenant_mixes:
            for name, _ in mix:
                if name not in known:
                    raise ValueError(
                        f"tenant {tenant!r} mix references unknown "
                        f"model {name!r}")

    def model(self, name: str) -> ModelSpec:
        for m in self.models:
            if m.name == name:
                return m
        raise ValueError(
            f"unknown zoo model {name!r}; known: "
            f"{', '.join(m.name for m in self.models)}")

    def names(self) -> List[str]:
        return [m.name for m in self.models]

    def mix_for(self, tenant: str) -> Tuple[Tuple[str, float], ...]:
        """The mix one tenant's requests draw from: its override, else
        the default mix, else uniform."""
        for name, mix in self.tenant_mixes:
            if name == tenant:
                return mix
        if self.mix:
            return self.mix
        return tuple((m.name, 1.0) for m in self.models)

    def signature(self) -> tuple:
        """What keys the stamp stream: model names and mixes (prices do
        not change which model a request targets)."""
        return (tuple(m.name for m in self.models), self.mix,
                self.tenant_mixes)

    def as_dict(self) -> dict:
        out: Dict[str, object] = {
            "models": [m.as_dict() for m in self.models],
        }
        if self.mix:
            out["mix"] = {k: v for k, v in self.mix}
        if self.tenant_mixes:
            out["tenant_mixes"] = {
                t: {k: v for k, v in mix}
                for t, mix in self.tenant_mixes}
        return out


def zoo_config_from_dict(d: dict) -> ZooConfig:
    """A ZooConfig from its :meth:`ZooConfig.as_dict` form."""
    return ZooConfig(
        models=tuple(ModelSpec(**m) for m in d["models"]),
        mix=tuple((k, float(v))
                  for k, v in dict(d.get("mix", {})).items()),
        tenant_mixes=tuple(
            (t, tuple((k, float(v)) for k, v in dict(mix).items()))
            for t, mix in dict(d.get("tenant_mixes", {})).items()),
    )


def default_zoo(n_models: Optional[int] = None) -> ZooConfig:
    """The reference's three-model zoo (the first ``n_models``, default
    KIND_TPU_SIM_ZOO_MODELS): ``small`` is the calibration's own model
    (838.9 MB), ``medium`` 16 GB and ``large`` 60 GB; the mix weighs
    them 8:3:1."""
    if n_models is None:
        n_models = int(knobs.get(knobs.ZOO_MODELS))
    members = (
        ModelSpec("small", weight_mb=838.9),
        ModelSpec("medium", weight_mb=16000.0, compute_scale=8.0,
                  kv_scale=4.0),
        ModelSpec("large", weight_mb=60000.0, compute_scale=24.0,
                  kv_scale=8.0),
    )
    n = max(1, min(int(n_models), len(members)))
    return ZooConfig(
        models=members[:n],
        mix=tuple((m.name, w) for m, w in
                  zip(members[:n], (8.0, 3.0, 1.0))),
    )


def stamp_models(zoo: ZooConfig, trace, seed: int):
    """The trace with a model stamped on every request, drawn in trace
    order from ``random.Random(crc32(repr(("zoo", signature, seed))))``:
    a pure function of (zoo, the requests' tenants, seed)."""
    sig = repr(("zoo", zoo.signature(), int(seed)))
    rng = random.Random(zlib.crc32(sig.encode("utf-8")))
    out = []
    for req in trace:
        mix = zoo.mix_for(req.tenant)
        names = [name for name, _ in mix]
        weights = [max(0.0, float(w)) for _, w in mix]
        if len(names) == 1 or sum(weights) <= 0:
            choice = names[0]
        else:
            choice = rng.choices(names, weights=weights, k=1)[0]
        out.append(dataclasses.replace(req, model=choice))
    return out


# -- per-(model, generation) prices -----------------------------------


def swap_s(model: ModelSpec, cal: dict, dtype: str = "bf16",
           factor: Optional[float] = None) -> float:
    """The modeled weight load: the model's bytes over the achieved HBM
    bandwidth times ``SWAP_LOAD_FRACTION``, scaled by ``factor`` (default
    KIND_TPU_SIM_ZOO_SWAP_FACTOR; 0 or less makes it free)."""
    if factor is None:
        factor = float(knobs.get(knobs.ZOO_SWAP_FACTOR))
    if factor <= 0:
        return 0.0
    gbps = float(cal["decode"][dtype]["achieved_gbps"])
    load_bytes_per_s = gbps * 1e9 * SWAP_LOAD_FRACTION
    return round(model.weight_mb * 1e6 / load_bytes_per_s * factor, 9)


def fits(model: ModelSpec, cal: dict, dtype: str = "bf16",
         kv_headroom_frac: float = 0.2) -> bool:
    """Whether the model's weights fit the generation's HBM with a KV
    headroom of ``kv_headroom_frac`` of it. The HBM is the calibration's
    ``hbm_gib``, else the registry's for its generation (the default
    calibration, ``h100.json``, carries neither key: the registry's
    ``h100``)."""
    hbm_gib = cal.get("hbm_gib")
    if hbm_gib is None:
        gen = cal.get("generation", DEFAULT_GENERATION)
        hbm_gib = GENERATION_FACTS[gen]["hbm_gib"]
    budget_bytes = float(hbm_gib) * (1 << 30) * (1 - kv_headroom_frac)
    return model.weight_mb * 1e6 <= budget_bytes


def model_sim_config(zoo: ZooConfig, cal: dict, dtype: str = "bf16",
                     max_slots: int = 8, max_queue: int = 64,
                     prefix_cache_entries: int = 8,
                     resident_model: str = ""):
    """A ``SimReplicaConfig`` for a replica of one generation serving the
    zoo: the base prices are ``disagg.calibrated_sim_config``'s, and the
    per-model maps carry each fitting model's prefill (scaled by its
    compute), TPOT (its weights shared by the slots plus its KV read,
    over the achieved bandwidth) and swap time. A model that does not fit
    is absent from the maps, and the router reads absence as "cannot
    serve here"."""
    from kind_tpu_sim_torch.fleet.disagg import calibrated_sim_config

    base = calibrated_sim_config(
        cal, dtype=dtype, max_slots=max_slots, max_queue=max_queue,
        prefix_cache_entries=prefix_cache_entries)
    d = cal["decode"][dtype]
    slots = base.max_slots
    kv_per_req = d["kv_mb"] * 1e6 / max(1, int(cal["slots"]))
    gbps = d["achieved_gbps"] * 1e9
    prefill: Dict[str, float] = {}
    tpot: Dict[str, float] = {}
    swaps: Dict[str, float] = {}
    for m in zoo.models:
        if not fits(m, cal, dtype=dtype):
            continue
        prefill[m.name] = round(
            base.prefill_per_tok_s * m.compute_scale, 12)
        step_bytes = (m.weight_mb * 1e6 / slots
                      + kv_per_req * m.kv_scale)
        tpot[m.name] = round(step_bytes / gbps, 9)
        swaps[m.name] = swap_s(m, cal, dtype=dtype)
    if resident_model and resident_model not in swaps:
        raise ValueError(
            f"resident model {resident_model!r} does not fit "
            f"generation {cal.get('generation', '?')!r}")
    return dataclasses.replace(
        base,
        model_prefill_per_tok_s=tuple(sorted(prefill.items())),
        model_tpot_s=tuple(sorted(tpot.items())),
        model_swap_s=tuple(sorted(swaps.items())),
        resident_model=resident_model,
    )


def placements(zoo: ZooConfig, generations: Sequence[str],
               large_model_gen: Optional[str] = None) -> List[str]:
    """The resident model of each entry of ``generations``: the largest
    model that fits it, or, with ``large_model_gen``, the largest model
    only on that generation. The smallest model is the fallback."""
    cals = {g: load_generation(g) for g in sorted(set(generations))}
    by_weight = sorted(zoo.models, key=lambda m: -m.weight_mb)
    largest = by_weight[0]
    out: List[str] = []
    for gen in generations:
        cal = cals[gen]
        if (large_model_gen is not None and gen == large_model_gen
                and fits(largest, cal)):
            out.append(largest.name)
            continue
        for m in by_weight:
            if (large_model_gen is not None
                    and m.name == largest.name
                    and gen != large_model_gen):
                continue
            if fits(m, cal):
                out.append(m.name)
                break
        else:
            out.append(by_weight[-1].name)
    return out


@dataclasses.dataclass(frozen=True)
class SwapEvent:
    """One model swap on the LANE_MODEL_SWAP lane: replica
    ``replica_id`` loads ``model`` (evicting ``evicted``), ready at
    ``ready_s``. Bookkeeping only: the swap's latency is already in the
    admitted slot's closed-form timeline."""

    replica_id: int
    model: str
    evicted: str
    ready_s: float

    def as_dict(self) -> dict:
        return {
            "replica_id": self.replica_id,
            "model": self.model,
            "evicted": self.evicted,
            "ready_s": round(self.ready_s, 9),
        }
