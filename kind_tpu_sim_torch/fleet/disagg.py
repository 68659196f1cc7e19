"""Disaggregated prefill/decode serving.

The port's copy of ``kind_tpu_sim/fleet/disagg.py``. A fleet's analytic
replicas take a phase: a ``prefill`` replica runs prompts through
prefill only and hands each finished request, really its KV cache, to a
``decode`` replica over a modeled interconnect transfer; a ``decode``
replica generates tokens only; ``unified`` is the plain replica.

* :class:`DisaggConfig`: the pool split (``P:D``), the KV transfer's
  interconnect tier (``ici`` or ``dcn``, priced from
  ``parallel.collectives.TIER_LINK_GBPS``) and the serving dtype
  (``bf16`` or ``int8``: int8 halves the shipped KV bytes and prices
  decode from the int8 roofline).
* :class:`KvHandoff`: a prefilled request in flight between the pools,
  with its dispatch and first-token stamps and its KV bytes. It has the
  ``TraceRequest`` fields the router reads, so the decode pool is placed
  by the same machinery.
* :func:`calibrated_sim_config`: a ``SimReplicaConfig`` priced from a
  cost-model calibration (the H100's by default), in place of the
  config's round-figure defaults.

Knobs: KIND_TPU_SIM_DISAGG_TIER (``resolve_tier``),
KIND_TPU_SIM_DISAGG_DTYPE (``resolve_dtype``).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

from kind_tpu_sim_torch.analysis import knobs
from kind_tpu_sim_torch.fleet.costmodel import DTYPE_BYTES, DTYPES
from kind_tpu_sim_torch.fleet.loadgen import TraceRequest
from kind_tpu_sim_torch.parallel.collectives import TIER_LINK_GBPS

PHASES = ("prefill", "decode", "unified")
KV_TIERS = tuple(sorted(TIER_LINK_GBPS))


def resolve_tier(value: Optional[str] = None) -> str:
    """``value``, else KIND_TPU_SIM_DISAGG_TIER, else ``ici``."""
    tier = value if value is not None else knobs.get(knobs.DISAGG_TIER)
    if tier not in TIER_LINK_GBPS:
        raise ValueError(
            f"unknown KV-transfer tier {tier!r}; known: "
            f"{', '.join(KV_TIERS)}")
    return tier


def resolve_dtype(value: Optional[str] = None) -> str:
    """``value``, else KIND_TPU_SIM_DISAGG_DTYPE, else ``bf16``."""
    dtype = value if value is not None else knobs.get(knobs.DISAGG_DTYPE)
    if dtype not in DTYPE_BYTES:
        raise ValueError(
            f"unknown serving dtype {dtype!r}; known: "
            f"{', '.join(DTYPES)}")
    return dtype


def kv_transfer_s(kv_bytes: int, tier: str, factor: float = 1.0) -> float:
    """Seconds to ship one request's KV cache between the pools over
    ``tier``; ``factor`` scales the link's bandwidth (the
    ``kv_degrade`` chaos action: 0.2 is a fifth of nominal)."""
    if tier not in TIER_LINK_GBPS:
        raise ValueError(
            f"unknown KV-transfer tier {tier!r}; known: "
            f"{', '.join(KV_TIERS)}")
    # TIER_LINK_GBPS is in gigabits a second
    bytes_per_s = TIER_LINK_GBPS[tier] * 1e9 / 8.0 * factor
    return max(0, int(kv_bytes)) / bytes_per_s


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """A fleet's phase split: ``prefill_replicas : decode_replicas``
    (``--disagg P:D``; the fleet's replica count is their sum), the KV
    link's ``tier``, the serving ``dtype``, and whether the replicas are
    priced from the calibration (``calibrated``) or by
    ``FleetConfig.sim``."""

    enabled: bool = True
    prefill_replicas: int = 1
    decode_replicas: int = 1
    tier: str = "ici"
    dtype: str = "bf16"
    calibrated: bool = True

    def __post_init__(self):
        if self.prefill_replicas < 1 or self.decode_replicas < 1:
            raise ValueError(
                "disagg needs at least one replica per pool "
                f"(got {self.prefill_replicas}:{self.decode_replicas})")
        resolve_tier(self.tier)
        resolve_dtype(self.dtype)

    @classmethod
    def parse(cls, spec: str, *, tier: Optional[str] = None,
              dtype: Optional[str] = None) -> "DisaggConfig":
        """From the command line's ``P:D``."""
        parts = spec.split(":")
        if len(parts) != 2:
            raise ValueError(
                f"--disagg wants P:D (e.g. 2:2), got {spec!r}")
        try:
            p, d = int(parts[0]), int(parts[1])
        except ValueError:
            raise ValueError(
                f"--disagg wants integer P:D, got {spec!r}") from None
        return cls(prefill_replicas=p, decode_replicas=d,
                   tier=resolve_tier(tier), dtype=resolve_dtype(dtype))

    def as_dict(self) -> dict:
        return {
            "enabled": self.enabled,
            "prefill_replicas": self.prefill_replicas,
            "decode_replicas": self.decode_replicas,
            "tier": self.tier,
            "dtype": self.dtype,
            "calibrated": self.calibrated,
        }


@dataclasses.dataclass(frozen=True)
class KvHandoff:
    """One prefilled request on its way from the prefill pool to the
    decode pool: its prefill's dispatch and first-token stamps (TTFT
    belongs to the request, not to the decode replica), its tokens so
    far and the KV bytes the transfer ships."""

    is_kv_handoff: ClassVar[bool] = True

    request: TraceRequest
    dispatch_s: float
    first_s: float
    tokens: int
    kv_bytes: int
    from_replica: int

    @property
    def request_id(self) -> str:
        return self.request.request_id

    @property
    def arrival_s(self) -> float:
        return self.request.arrival_s

    @property
    def deadline_s(self) -> Optional[float]:
        return self.request.deadline_s

    @property
    def prefix_group(self) -> int:
        return self.request.prefix_group

    @property
    def prompt(self) -> Tuple[int, ...]:
        return self.request.prompt

    @property
    def max_new(self) -> int:
        return self.request.max_new

    @property
    def seed(self) -> int:
        return self.request.seed

    @property
    def tenant(self) -> str:
        return self.request.tenant

    @property
    def user_id(self) -> int:
        return self.request.user_id

    @property
    def model(self) -> str:
        return self.request.model


def calibrated_sim_config(cal: dict, dtype: str = "bf16",
                          max_slots: int = 8, max_queue: int = 64,
                          prefix_cache_entries: int = 8):
    """A ``SimReplicaConfig`` priced from a calibration: a prefill token
    at the forward rate, and a decode step from the decode roofline at
    ``max_slots`` (the weight read shared by the slots, plus the
    calibration point's KV read a request, over the achieved HBM
    bandwidth)."""
    from kind_tpu_sim_torch.fleet.router import SimReplicaConfig

    prefill_rate = float(cal["prefill"]["analytic_tokens_per_s"])
    d = cal["decode"][dtype]
    slots = max(1, int(max_slots))
    kv_per_req_bytes = d["kv_mb"] * 1e6 / max(1, int(cal["slots"]))
    step_bytes = d["weight_mb"] * 1e6 / slots + kv_per_req_bytes
    tpot = step_bytes / (d["achieved_gbps"] * 1e9)
    return SimReplicaConfig(
        max_slots=slots,
        prefill_base_s=0.0,
        prefill_per_tok_s=1.0 / prefill_rate,
        tpot_s=round(tpot, 9),
        max_queue=max_queue,
        prefix_cache_entries=prefix_cache_entries,
    )
