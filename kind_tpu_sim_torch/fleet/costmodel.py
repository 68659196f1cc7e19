"""The analytic serving cost model, priced from the H100's calibration.

The port's copy of ``kind_tpu_sim/fleet/costmodel.py``. It prices the
two serving phases from first principles, anchored to a bench artifact
of the card:

* **prefill** is compute-bound: a prompt runs through one forward pass,
  so its time is ``prompt_tokens`` over the forward rate the bench
  measured (``fwd_tokens_per_s``). The serving prefill rate the bench
  also measures is that calibration point's ``measured_tokens_per_s``;
  the gap between the two is the prefill ``error_frac``.
* **decode** is bound by HBM bytes: every generated token reads the
  weights (shared by the batch) plus the request's KV cache, so a step
  is ``weight_bytes / batch + kv_bytes(context)`` over the bandwidth the
  bench achieved.

The numbers live in a calibration file that :func:`calibrate` derives
from one ``bench --model-only`` artifact (``python -m kind_tpu_sim_torch
fleet calibrate``). The port's default is the H100's,
``kind_tpu_sim_torch/calibration/h100.json``; the knob
KIND_TPU_SIM_CALIBRATION names another. Every function here is float
arithmetic over the calibration dict, so a fleet priced by it replays
byte for byte.

The generation registry (the model zoo's and ``FleetConfig.generations``'
pricing) names one calibration file a card generation. The port has
numbers for one card, so it registers one generation, ``h100``: its file
``calibration/generations/h100.json`` is ``calibration/h100.json`` plus
the metadata keys ``generation``, ``hbm_gib`` (79.18, the card's
``total_memory`` of 85,017,493,504 bytes) and ``chip_second_cost`` (1.0,
the anchor). Generation files live in a folder of their own because
``h100.json`` is the default calibration, which ``fleet calibrate``
writes without those keys. Every accelerator label of
``kind_tpu_sim_torch.topology.ACCELERATORS`` (the scheduler's labels,
the reference's TPU names) prices as ``h100``; ``h100`` maps back to
``topology.DEFAULT_ACCELERATOR``, and ``GENERATION_SCHED_TOPOLOGY`` keeps
the reference's inventory shapes for the labels. :func:`derive_generation`
keeps the reference's scaling rule, for a generation a caller registers
with its own facts; the port ships no derived file.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
from typing import Dict, Optional

from kind_tpu_sim_torch import topology
from kind_tpu_sim_torch.analysis import knobs

# the calibration file's schema; the loader refuses any other
CALIBRATION_SCHEMA = 1

DEFAULT_CALIBRATION = (pathlib.Path(__file__).resolve().parents[1]
                       / "calibration" / "h100.json")
# the generation registry's files, calibration/generations/<gen>.json
CALIBRATION_DIR = DEFAULT_CALIBRATION.parent / "generations"

DEFAULT_GENERATION = "h100"
GENERATIONS = ("h100",)

# accelerator label -> the generation that prices a replica placed on it
ACCELERATOR_GENERATIONS = {accel: DEFAULT_GENERATION
                           for accel in sorted(topology.ACCELERATORS)}

# generation -> the accelerator label a scheduler pool of it requests
GENERATION_ACCELERATORS = {DEFAULT_GENERATION: topology.DEFAULT_ACCELERATOR}

# scheduler inventory shapes a label: (pod topology, replica slice
# topology), the reference's
GENERATION_SCHED_TOPOLOGY = {
    "tpu-v5-lite-podslice": ("4x8", "2x4"),
    "tpu-v4-podslice": ("4x4x4", "2x2x2"),
    "tpu-v5p-slice": ("4x4x4", "2x2x2"),
}

# A generation's facts against the anchor: the compute and bandwidth
# ratios derive_generation scales by, the HBM the zoo's fit check
# charges, and the relative price of a chip-second. h100 is the anchor;
# its HBM is torch.cuda.get_device_properties(0).total_memory of an
# NVIDIA H100 80GB HBM3 (85,017,493,504 bytes) in GiB.
GENERATION_FACTS = {
    "h100": {"compute_ratio": 1.0, "bandwidth_ratio": 1.0,
             "hbm_gib": 79.18, "chip_second_cost": 1.0},
}

DTYPES = ("bf16", "int8")
DTYPE_BYTES = {"bf16": 2, "int8": 1}

# The bench model block's keys, and each decode roofline's, without
# which calibrate() refuses an artifact (bench.py writes them).
REQUIRED_MODEL_KEYS = (
    "backend", "chip", "decode_roofline", "decode_tokens_per_s",
    "decode_int8_roofline", "decode_int8_tokens_per_s",
    "fwd_tokens_per_s", "model", "prefill_tokens_per_s", "serving",
)
REQUIRED_ROOFLINE_KEYS = (
    "achieved_gbps", "bytes_per_step_mb", "kv_mb", "roof_gbps",
    "weight_mb",
)

# the simulator's bar on each phase's error_frac (`fleet calibrate`
# exits 1 above it)
MAX_ERROR_FRAC = 0.15

_GEOMETRY_RE = re.compile(r"^d(\d+)xL(\d+)(?:-gqa(\d+))?$")


def parse_geometry(model: str) -> Dict[str, int]:
    """The bench's model string (``d2048xL8-gqa4``) as the dimensions
    the KV cache's size depends on."""
    m = _GEOMETRY_RE.match(model)
    if m is None:
        raise ValueError(
            f"unparseable model geometry {model!r} (expected "
            "d<d_model>xL<layers>[-gqa<group>])")
    return {
        "d_model": int(m.group(1)),
        "layers": int(m.group(2)),
        "gqa": int(m.group(3) or 1),
    }


def kv_bytes_per_token(geometry: Dict[str, int], dtype: str) -> int:
    """KV-cache bytes of one context token: K and V, every layer, at the
    grouped-query width."""
    if dtype not in DTYPE_BYTES:
        raise ValueError(
            f"unknown dtype {dtype!r}; known: {', '.join(DTYPES)}")
    return (2 * geometry["layers"]
            * (geometry["d_model"] // geometry["gqa"])
            * DTYPE_BYTES[dtype])


def _error_frac(analytic: float, measured: float) -> float:
    return round(abs(analytic - measured) / measured, 6)


def calibrate(bench: dict) -> dict:
    """The calibration file's contents from one bench report. Raises a
    ValueError naming every absent key when the report lacks the model
    block or its roofline sweeps."""
    model = bench.get("model")
    if not isinstance(model, dict):
        raise ValueError(
            "bench report has no top-level 'model' block — not a "
            "BENCH_LOCAL_*.json roofline round")
    missing = [k for k in REQUIRED_MODEL_KEYS if k not in model]
    for roof_key in ("decode_roofline", "decode_int8_roofline"):
        roof = model.get(roof_key)
        if isinstance(roof, dict):
            missing.extend(f"{roof_key}.{k}"
                           for k in REQUIRED_ROOFLINE_KEYS
                           if k not in roof)
    if missing:
        raise ValueError(
            "bench model block is missing roofline key(s): "
            + ", ".join(sorted(missing)))
    slots = int(model["serving"].get("slots", 1))
    geometry = parse_geometry(model["model"])

    # prefill: the analytic rate is the forward pass alone; the
    # measured serving prefill differs by what the model leaves out
    fwd = float(model["fwd_tokens_per_s"])
    prefill_measured = float(model["prefill_tokens_per_s"])

    decode: Dict[str, dict] = {}
    for dtype, roof_key, rate_key in (
            ("bf16", "decode_roofline", "decode_tokens_per_s"),
            ("int8", "decode_int8_roofline",
             "decode_int8_tokens_per_s")):
        roof = model[roof_key]
        measured = float(model[rate_key])
        # bytes a step are the whole batch's reads, and a step emits a
        # token a slot: slots x achieved bytes/s over bytes a step
        analytic = (slots * float(roof["achieved_gbps"]) * 1e9
                    / (float(roof["bytes_per_step_mb"]) * 1e6))
        decode[dtype] = {
            "achieved_gbps": float(roof["achieved_gbps"]),
            "analytic_tokens_per_s": round(analytic, 3),
            "bytes_per_step_mb": float(roof["bytes_per_step_mb"]),
            "error_frac": _error_frac(analytic, measured),
            "kv_mb": float(roof["kv_mb"]),
            "measured_tokens_per_s": measured,
            "roof_gbps": float(roof["roof_gbps"]),
            "weight_mb": float(roof["weight_mb"]),
        }

    return {
        "schema": CALIBRATION_SCHEMA,
        "backend": str(model["backend"]),
        "chip": str(model["chip"]),
        "model": str(model["model"]),
        "geometry": geometry,
        "slots": slots,
        "prefill": {
            "analytic_tokens_per_s": fwd,
            "measured_tokens_per_s": prefill_measured,
            "error_frac": _error_frac(fwd, prefill_measured),
        },
        "decode": decode,
    }


def load_calibration(path: Optional[str] = None) -> dict:
    """A calibration file: ``path``, else KIND_TPU_SIM_CALIBRATION's,
    else the H100's."""
    if path is None:
        path = knobs.get(knobs.CALIBRATION)
    if path is None:
        path = str(DEFAULT_CALIBRATION)
    with open(path, encoding="utf-8") as fh:
        cal = json.load(fh)
    if cal.get("schema") != CALIBRATION_SCHEMA:
        raise ValueError(
            f"calibration file {path} has schema "
            f"{cal.get('schema')!r}; this build expects "
            f"{CALIBRATION_SCHEMA} — regenerate with "
            "`python -m kind_tpu_sim_torch fleet calibrate`")
    return cal


def generation_path(name: str) -> pathlib.Path:
    """Where generation ``name``'s calibration file lives."""
    return CALIBRATION_DIR / f"{name}.json"


def load_generation(name: str) -> dict:
    """A registered generation's calibration. The file must name its
    generation (``generation`` equal to ``name``), so a renamed or
    misderived file cannot price a fleet."""
    if name not in GENERATIONS:
        raise ValueError(
            f"unknown generation {name!r}; registered: "
            f"{', '.join(GENERATIONS)}")
    cal = load_calibration(str(generation_path(name)))
    if cal.get("generation") != name:
        raise ValueError(
            f"calibration file {generation_path(name)} declares "
            f"generation {cal.get('generation')!r}, expected "
            f"{name!r}")
    return cal


def generation_of_accelerator(accelerator: str) -> str:
    """The generation a scheduler accelerator label prices as."""
    try:
        return ACCELERATOR_GENERATIONS[accelerator]
    except KeyError:
        raise ValueError(
            f"accelerator {accelerator!r} maps to no registered "
            f"generation; known: "
            f"{', '.join(sorted(ACCELERATOR_GENERATIONS))}") from None


def derive_generation(base: dict, name: str) -> dict:
    """The calibration ``base`` scaled onto generation ``name`` by its
    ratios in ``GENERATION_FACTS``: prefill rates by the compute ratio,
    decode bandwidths and rates by the bandwidth ratio. Analytic and
    measured sides scale together, so every ``error_frac`` is kept."""
    facts = GENERATION_FACTS[name]
    compute = facts["compute_ratio"]
    bw = facts["bandwidth_ratio"]
    slots = int(base["slots"])
    prefill_analytic = round(
        base["prefill"]["analytic_tokens_per_s"] * compute, 3)
    prefill_measured = round(
        base["prefill"]["measured_tokens_per_s"] * compute, 3)
    decode: Dict[str, dict] = {}
    for dtype, d in base["decode"].items():
        achieved = round(d["achieved_gbps"] * bw, 3)
        analytic = (slots * achieved * 1e9
                    / (d["bytes_per_step_mb"] * 1e6))
        measured = round(d["measured_tokens_per_s"] * bw, 3)
        decode[dtype] = {
            "achieved_gbps": achieved,
            "analytic_tokens_per_s": round(analytic, 3),
            "bytes_per_step_mb": d["bytes_per_step_mb"],
            "error_frac": _error_frac(analytic, measured),
            "kv_mb": d["kv_mb"],
            "measured_tokens_per_s": measured,
            "roof_gbps": round(d["roof_gbps"] * bw, 3),
            "weight_mb": d["weight_mb"],
        }
    return {
        "schema": CALIBRATION_SCHEMA,
        "backend": base["backend"],
        "chip": name,
        "generation": name,
        "hbm_gib": facts["hbm_gib"],
        "chip_second_cost": facts["chip_second_cost"],
        "model": base["model"],
        "geometry": dict(base["geometry"]),
        "slots": slots,
        "prefill": {
            "analytic_tokens_per_s": prefill_analytic,
            "measured_tokens_per_s": prefill_measured,
            "error_frac": base["prefill"]["error_frac"],
        },
        "decode": decode,
    }


@dataclasses.dataclass(frozen=True)
class RequestCost:
    """One request priced end to end: virtual seconds, and the KV bytes
    a disaggregated handoff would ship."""

    prefill_s: float
    decode_s: float
    kv_bytes: int

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s

    def as_dict(self) -> dict:
        return {
            "prefill_s": round(self.prefill_s, 9),
            "decode_s": round(self.decode_s, 9),
            "kv_bytes": self.kv_bytes,
            "total_s": round(self.total_s, 9),
        }


class CostModel:
    """Per-request prices over one calibration dict; every method is a
    pure function of its arguments."""

    def __init__(self, calibration: Optional[dict] = None):
        self.cal = (calibration if calibration is not None
                    else load_calibration())
        self.geometry = self.cal["geometry"]

    def kv_bytes(self, prompt_tokens: int, dtype: str = "bf16") -> int:
        """The KV cache a prefilled prompt holds: what a prefill to
        decode handoff ships."""
        return (max(0, int(prompt_tokens))
                * kv_bytes_per_token(self.geometry, dtype))

    def prefill_s(self, prompt_tokens: int, batch: int = 1,
                  dtype: str = "bf16") -> float:
        """Compute-bound: tokens over the forward rate. The pass is
        already saturated, so the batch leaves a request's time as it
        is; both dtypes take the same path."""
        del batch, dtype
        rate = float(self.cal["prefill"]["analytic_tokens_per_s"])
        return max(0, int(prompt_tokens)) / rate

    def decode_step_s(self, context_tokens: int, batch: int = 1,
                      dtype: str = "bf16") -> float:
        """Byte-bound: a token a slot costs the weight read (shared by
        the batch) plus this request's KV read, over the achieved
        bandwidth."""
        d = self.cal["decode"][dtype]
        step_bytes = (d["weight_mb"] * 1e6 / max(1, batch)
                      + self.kv_bytes(context_tokens, dtype))
        return step_bytes / (d["achieved_gbps"] * 1e9)

    def decode_s(self, gen_tokens: int, context_tokens: int,
                 batch: int = 1, dtype: str = "bf16") -> float:
        """A whole generation at a fixed context (the KV cache's growth
        over a short generation is second order to the weight read)."""
        return (max(0, int(gen_tokens))
                * self.decode_step_s(context_tokens, batch=batch,
                                     dtype=dtype))

    def request_cost(self, prompt_tokens: int, gen_tokens: int,
                     batch: int = 1, dtype: str = "bf16") -> RequestCost:
        return RequestCost(
            prefill_s=self.prefill_s(prompt_tokens, batch=batch,
                                     dtype=dtype),
            decode_s=self.decode_s(gen_tokens, prompt_tokens,
                                   batch=batch, dtype=dtype),
            kv_bytes=self.kv_bytes(prompt_tokens, dtype))

    def errors(self) -> Dict[str, float]:
        """Each phase's analytic-against-measured error at the
        calibration point."""
        return {
            "prefill": self.cal["prefill"]["error_frac"],
            "decode_bf16": self.cal["decode"]["bf16"]["error_frac"],
            "decode_int8": self.cal["decode"]["int8"]["error_frac"],
        }
