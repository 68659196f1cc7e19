"""Phase 11's training worlds with and without phase 13's processes beside
them, on one card, in turns.

Can phase 13's six processes (torch-smoke at NCCL world 1 and on 4 gloo
ranks, the three pods' payloads: host-bound start-ups) run in a thread
beside phase 11's training worlds ((c) the dense flagship at ('model', 2)
and ('data', 2), (d) the 4-expert flagship at ('expert', 2)) without moving
the worlds' numbers? This script measures it: phase 13 alone first, then
the worlds alone, beside phase 13, beside phase 13, alone (ABBA), each run
through the functions ``chip_smoke.py`` itself calls and held to its
checks. It prints, for every run, each group's wall (its unsharded steps
and its worlds), each rank's step walls, the losses and peaks, and beside
them phase 13's walls and torch-smoke's cold and warm suite seconds; the
same goes as JSON to ``--out``. Needs one CUDA device:

    python3 tools/phase13_overlap.py --out chiprun_out/phase13_overlap.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ARMS = ("alone", "beside", "beside", "alone")


def _entry_summary(ran: dict) -> dict:
    out = {"wall_s": ran["wall_s"]}
    for label, res in ran["runs"].items():
        row = {"rc": res["rc"], "wall_s": res["wall_s"]}
        if label.startswith("torch-smoke") and res["rc"] == 0:
            rep = json.loads(res["stdout"].strip().splitlines()[-1])
            row["cold_suite_s"] = rep["cold_suite_s"]
            row["warm_suite_s"] = rep["warm_suite_s"]
        out[label] = row
    return out


def _training_summary(train: dict) -> dict:
    return {label: {"group_wall_s": x["group_wall_s"],
                    "walls_ms": [r["walls_ms"] for r in x["ranks"]],
                    "peak_gib": [r["peak_gib"] for r in x["ranks"]],
                    "losses": x["losses"]}
            for label, x in train.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="write the runs as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("phase13_overlap: no CUDA device")
    import chip_smoke as cs
    from kind_tpu_sim_torch import profile_train as trainer
    from kind_tpu_sim_torch.models import transformer as tf
    from kind_tpu_sim_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    cs.log(f"build {time.perf_counter() - t0:.1f} s")

    ran = cs.entry_runs()
    cs.entry_points_phase(ran)
    runs = [{"arm": "phase 13 alone", "phase13": _entry_summary(ran)}]
    cs.log(json.dumps(runs[-1]))
    for arm in ARMS:
        t0 = time.perf_counter()
        if arm == "beside":
            with ThreadPoolExecutor(1) as pool:
                fut = pool.submit(cs.entry_runs)
                train = cs.training_worlds_phase(tf, trainer)
                ran = fut.result()
            cs.entry_points_phase(ran)
        else:
            train = cs.training_worlds_phase(tf, trainer)
        row = {"arm": f"training worlds {arm}",
               "wall_s": time.perf_counter() - t0,
               "training": _training_summary(train)}
        if arm == "beside":
            row["phase13"] = _entry_summary(ran)
        runs.append(row)
        cs.log(json.dumps(row))
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    cs.log(smi)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "runs": runs},
                                       indent=1))
    cs.log("PHASE13 OVERLAP OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
