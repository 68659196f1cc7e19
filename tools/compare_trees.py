"""Serving on one card, two checkouts of this repository, in turns.

    python3 tools/compare_trees.py --base DIR [--pairs N] [--out FILE]

``DIR`` is another checkout (for example the parent commit, unpacked
with ``git archive`` into a directory that ``.gitignore`` lists); the
"change" is the checkout that holds this script. Each of the two runs,
in its own process with its own tree as working directory and on
``sys.path`` (so each builds and loads its own kernels):

* ``python3 -m kind_tpu_sim_torch.profile_serving`` -- the flagship
  stream's tok/s and one traced decode round;
* the host time of one ``paged_attention`` wrapper call on the inputs
  of ``chip_smoke.paged_decode_inputs`` (this checkout's definition,
  used for both trees), by ``chip_smoke.host_us``: the median, and the
  least, of 11 rounds' means over 200 calls in a row.

The order is base, change, change, base, ... (``--pairs`` of each).
Prints one JSON line a run, then one with each tree's medians of
``tok_per_s``, ``step_wall_ms``, ``device_busy_ms``,
``device_busy_share``, ``device_ops_per_step``, ``paged_ms`` (the
traced round's device time in kernels whose name holds
``paged_attention``), ``paged_host_us`` and ``paged_host_us_min``. Run
it on the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

CHANGE = Path(__file__).resolve().parent.parent
KEYS = ("tok_per_s", "step_wall_ms", "device_busy_ms", "device_busy_share",
        "device_ops_per_step", "paged_ms", "paged_host_us",
        "paged_host_us_min")

# the wrapper's host time, run inside one tree (its own package) on this
# checkout's chip_smoke inputs and timer
HOST_TIME = f"""
import importlib.util, json
spec = importlib.util.spec_from_file_location(
    "chip_smoke", {str(CHANGE / "chip_smoke.py")!r})
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from kind_tpu_sim_torch.ops.paged_attention import paged_attention
args = smoke.paged_decode_inputs()[-1]
call = lambda: paged_attention(*args)
us = [smoke.host_us(call, calls=200, rounds=1) for _ in range(11)]
print(json.dumps({{"paged_host_us": sorted(us)[5],
                  "paged_host_us_min": min(us)}}))
"""


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def run_tree(tree: Path) -> dict:
    """One profile_serving run and one host-time run in ``tree``."""
    env_cmd = {"cwd": tree, "capture_output": True, "text": True,
               "check": True, "timeout": 900}
    prof = _last_json(subprocess.run(
        [sys.executable, "-m", "kind_tpu_sim_torch.profile_serving"],
        **env_cmd).stdout)
    host = _last_json(subprocess.run(
        [sys.executable, "-c", HOST_TIME], **env_cmd).stdout)
    paged = {name: ms for name, ms in prof["kernels"].items()
             if "paged_attention" in name}
    return {**{key: prof[key] for key in KEYS[:5]},
            "paged_ms": sum(paged.values()), **host, "paged_kernels": paged}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the other checkout")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", help="also write every JSON line here")
    args = ap.parse_args(argv)
    trees = {"base": Path(args.base).resolve(), "change": CHANGE}
    order = [name for _ in range(args.pairs)
             for name in ("base", "change", "change", "base")][:2 * args.pairs]
    runs = {"base": [], "change": []}
    lines = []
    for i, name in enumerate(order):
        res = {"run": i, "tree": name, **run_tree(trees[name])}
        runs[name].append(res)
        lines.append(json.dumps(res))
        print(lines[-1], flush=True)
    summary = {name: {key: float(np.median([r[key] for r in rs]))
                      for key in KEYS} for name, rs in runs.items()}
    summary["runs_each"] = args.pairs
    lines.append(json.dumps({"medians": summary}))
    print(lines[-1])
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
