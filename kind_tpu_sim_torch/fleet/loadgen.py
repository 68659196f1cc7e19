"""Seeded open-loop workload generation on a virtual clock.

The port's copy of ``kind_tpu_sim/fleet/loadgen.py``: the fleet's
traffic source. A trace is a pure function of (spec, seed): arrivals,
prompt and output lengths, shared prefixes and per-request sampling
seeds are drawn from one ``random.Random`` stream keyed by the crc32 of
the spec's argument repr, in the reference's draw order, so the same
spec and seed give the reference's trace field for field.

Three arrival processes, all by Lewis thinning against the process's
peak rate: ``poisson`` (exponential inter-arrivals at ``rps``),
``bursty`` (on/off bursts at ``burst_factor * rps``) and ``diurnal``
(a raised-cosine rate over ``diurnal_period_s``). Traces round-trip
through JSON lines (:func:`save_trace` / :func:`load_trace`).

A spec with a tenant population (``WorkloadSpec.tenancy``) is drawn by
``tenancy.generate_tenant_trace``. A spec with a model zoo
(``WorkloadSpec.zoo``) gets a model stamped on every request by
``zoo.stamp_models``, from a stream of its own, so the base trace is the
unzooed one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
import zlib
from typing import List, Optional, Sequence

from kind_tpu_sim_torch.fleet import knobs


def resolve_seed(seed: Optional[int] = None) -> int:
    """Explicit seed > env (KIND_TPU_SIM_FLEET_SEED) > 0."""
    if seed is not None:
        return int(seed)
    return int(knobs.get(knobs.FLEET_SEED))


class VirtualClock:
    """The fleet's time: starts at 0.0 and moves only when the loop
    advances it. Every latency the fleet reports is measured on this
    clock, never the wall, so two runs of one seed report the same."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"virtual time cannot rewind (dt={dt})")
        self._now += dt
        return self._now


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One generated request: ``arrival_s`` is virtual time;
    ``prefix_group`` >= 0 marks a shared-prompt-prefix cohort;
    ``deadline_s`` is the e2e budget from arrival (None: none)."""

    request_id: str
    arrival_s: float
    prompt: tuple
    max_new: int
    seed: int
    prefix_group: int = -1
    deadline_s: Optional[float] = None
    tenant: str = ""
    user_id: int = -1
    model: str = ""

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["prompt"] = list(self.prompt)
        # default-valued tenancy and zoo fields stay off the wire, as
        # in the reference's trace files
        if not self.tenant:
            d.pop("tenant")
        if self.user_id < 0:
            d.pop("user_id")
        if not self.model:
            d.pop("model")
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRequest":
        d = dict(d)
        d["prompt"] = tuple(d["prompt"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Knobs of one generated workload; lengths are drawn uniform in
    [lo, hi] (closed); a ``shared_prefix_frac`` of requests get a
    group-common prefix of ``prefix_len`` tokens."""

    process: str = "poisson"        # poisson | bursty | diurnal
    rps: float = 50.0               # mean arrival rate (requests/s)
    n_requests: int = 100
    prompt_len: Sequence[int] = (4, 24)
    max_new: Sequence[int] = (4, 16)
    vocab: int = 64
    shared_prefix_frac: float = 0.0
    prefix_groups: int = 4
    prefix_len: int = 8
    deadline_s: Optional[float] = None
    burst_factor: float = 4.0
    burst_period_s: float = 2.0
    diurnal_period_s: float = 20.0
    phase_s: float = 0.0
    tenancy: Optional[object] = None
    zoo: Optional[object] = None

    PROCESSES = ("poisson", "bursty", "diurnal")


def _spec_rng(spec: WorkloadSpec, seed: int) -> random.Random:
    sig = (seed, spec.process, spec.rps, spec.n_requests,
           tuple(spec.prompt_len), tuple(spec.max_new),
           spec.vocab, spec.shared_prefix_frac,
           spec.prefix_groups, spec.prefix_len, spec.deadline_s,
           spec.burst_factor, spec.burst_period_s,
           spec.diurnal_period_s)
    # phase_s joins the key only when set, as in the reference: every
    # phase-0 spec keeps its stream
    if spec.phase_s:
        sig = sig + (spec.phase_s,)
    # so does the tenant population, by its traffic-shaping fields
    if spec.tenancy is not None:
        sig = sig + (spec.tenancy.signature(),)
    return random.Random(zlib.crc32(repr(sig).encode("utf-8")))


def _rate_at(spec: WorkloadSpec, t: float) -> float:
    """Instantaneous arrival rate (the thinning envelope)."""
    if spec.process == "poisson":
        return spec.rps
    if spec.process == "bursty":
        # duty cycle 1/burst_factor at burst_factor * rps: mean rps
        phase = (((t + spec.phase_s) % spec.burst_period_s)
                 / spec.burst_period_s)
        duty = 1.0 / max(1.0, spec.burst_factor)
        return (spec.rps * max(1.0, spec.burst_factor)
                if phase < duty else 0.0)
    if spec.process == "diurnal":
        phase = (((t + spec.phase_s) % spec.diurnal_period_s)
                 / spec.diurnal_period_s)
        return spec.rps * (1.0 - math.cos(2 * math.pi * phase))
    raise ValueError(
        f"unknown arrival process {spec.process!r}; known: "
        f"{', '.join(WorkloadSpec.PROCESSES)}")


def generate_trace(spec: WorkloadSpec,
                   seed: Optional[int] = None) -> List[TraceRequest]:
    """The seeded trace: ``n_requests`` arrivals by thinning, each with
    drawn prompt and output lengths, a sampling seed and an optional
    prefix group, in the reference's draw order."""
    if spec.process not in WorkloadSpec.PROCESSES:
        raise ValueError(
            f"unknown arrival process {spec.process!r}; known: "
            f"{', '.join(WorkloadSpec.PROCESSES)}")
    if spec.rps <= 0:
        raise ValueError(f"rps must be > 0 (got {spec.rps})")
    seed = resolve_seed(seed)
    if spec.tenancy is not None:
        # a late import: tenancy builds TraceRequests
        from kind_tpu_sim_torch.fleet.tenancy import generate_tenant_trace

        return _stamp_zoo(spec, generate_tenant_trace(spec, seed), seed)
    rng = _spec_rng(spec, seed)
    if spec.process == "bursty":
        peak = spec.rps * max(1.0, spec.burst_factor)
    elif spec.process == "diurnal":
        peak = 2.0 * spec.rps
    else:
        peak = spec.rps
    group_prefixes = [
        tuple(rng.randrange(spec.vocab) for _ in range(spec.prefix_len))
        for _ in range(max(1, spec.prefix_groups))]
    out: List[TraceRequest] = []
    t = 0.0
    i = 0
    while len(out) < spec.n_requests:
        t += rng.expovariate(peak)
        if rng.random() * peak > _rate_at(spec, t):
            continue  # thinned
        p_len = rng.randint(*spec.prompt_len)
        grouped = (spec.shared_prefix_frac > 0
                   and rng.random() < spec.shared_prefix_frac)
        group = (rng.randrange(max(1, spec.prefix_groups))
                 if grouped else -1)
        if grouped:
            prefix = group_prefixes[group]
            body_len = max(1, p_len - len(prefix))
            prompt = prefix + tuple(
                rng.randrange(spec.vocab) for _ in range(body_len))
        else:
            prompt = tuple(rng.randrange(spec.vocab)
                           for _ in range(max(1, p_len)))
        out.append(TraceRequest(
            request_id=f"f{i:05d}",
            arrival_s=round(t, 6),
            prompt=prompt,
            max_new=rng.randint(*spec.max_new),
            seed=rng.randrange(2 ** 31),
            prefix_group=group,
            deadline_s=spec.deadline_s,
        ))
        i += 1
    return _stamp_zoo(spec, out, seed)


def _stamp_zoo(spec: WorkloadSpec, trace: List[TraceRequest],
               seed: int) -> List[TraceRequest]:
    """The trace with the zoo's models stamped on, when the spec has a
    zoo; else the trace as it is."""
    if spec.zoo is None:
        return trace
    from kind_tpu_sim_torch.fleet.zoo import stamp_models

    return stamp_models(spec.zoo, trace, seed)


def save_trace(path: str, trace: Sequence[TraceRequest]) -> None:
    """One JSON object per line, keys sorted."""
    with open(path, "w", encoding="utf-8") as fh:
        for req in trace:
            fh.write(json.dumps(req.as_dict(), sort_keys=True))
            fh.write("\n")


def load_trace(path: str) -> List[TraceRequest]:
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(TraceRequest.from_dict(json.loads(line)))
    return out
