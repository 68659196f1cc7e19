"""Command line of the PyTorch port.

    python -m kind_tpu_sim_torch create [tpu|rocm|nvidia] [--accelerator A]
        [--topology T] [--num-slices N] [--capacity-mode plugin|patch]
        [--skip-plugin] [--gpu-workers N] [--gpus-per-node N]
        [--timing-json F] [--registry-port P] [--cluster-name NAME]
        [--runtime auto|docker|podman|fake] [-v]
    python -m kind_tpu_sim_torch delete|status [--json] [--runtime R] [-v]
    python -m kind_tpu_sim_torch load --image-name IMAGE [--runtime R] [-v]
    python -m kind_tpu_sim_torch chaos fail|heal|kill-node|start-node
        [--node NAME | --worker N] [--devices ID,...] [--accelerator A]
        [--topology T] [--num-slices N] [--runtime R] [-v]
    python -m kind_tpu_sim_torch train-smoke [--steps N] [--batch B]
        [--checkpoint-dir DIR] [--json] [--device cuda|cpu]
    python -m kind_tpu_sim_torch profile [--out DIR] [--json]
        [--device cuda|cpu]
    python -m kind_tpu_sim_torch slice-smoke [--topology T]
        [--accelerator A] [--ring-tokens N] [--num-slices N] [--serving]
        [--json] [--device cuda|cpu] [--backend gloo|nccl]
    python -m kind_tpu_sim_torch torch-smoke [--chips N] [--topology T]
        [--repeat N] [--json] [--device cuda|cpu] [--backend gloo|nccl]
    python -m kind_tpu_sim_torch manifests torch-multihost [--topology T]
        [--accelerator A] [--num-slices N] [--out FILE]
    python -m kind_tpu_sim_torch fleet run|trace [--engine serving|sim]
        [--disagg P:D [--disagg-tier ici|dcn] [--disagg-dtype bf16|int8]
        [--calibration PATH]]
        [--seed N] [--replicas N] [--policy P] [--rps R] [--requests N]
        [--process P] [--deadline-s S] [--ttft-slo S] [--e2e-slo S]
        [--itl-slo S] [--shared-prefix-frac F] [--prefix-groups N]
        [--autoscale] [--max-replicas N] [--tick-s S] [--eval-every-s S]
        [--health] [--overload] [--tenancy [--no-tenant-isolation]]
        [--audit-frac F] [--sched [--sched-policy ici|binpack|spread]
        [--train N]] [--no-event-core] [--profile] [--trace-file F]
        [--save-trace F] [--out F] [--json] [--device cuda|cpu]
    python -m kind_tpu_sim_torch fleet calibrate --bench PATH [--out PATH]
        [--json]
    python -m kind_tpu_sim_torch fleet|globe tune [--budget N]
        [--tune-seed N] [--chaos-budget N] [--tune-workers N]
        [--spec-out F] [--replay-spec F] [fleet: --ratios P:D,... --sdc
        --zoo --tenancy] [the run flags of the workload] [--out F] [--json]
    python -m kind_tpu_sim_torch chaos run [--scenario NAME|all]
        [--include-slow] [--seed N] [--list] [--json] [--device cuda|cpu]
    python -m kind_tpu_sim_torch chaos soak [--iterations N] [--seed N]
        [--include-slow] [--json] [--device cuda|cpu]
    python -m kind_tpu_sim_torch chaos fuzz [--budget N] [--seed N]
        [--max-faults N] [--inject-invariant-bug] [--emit-repros DIR]
        [--json]
    python -m kind_tpu_sim_torch analysis replay [--scenario NAME]
        [--seed N] [--runs N] [--inject-entropy-bug] [--json]
    python -m kind_tpu_sim_torch globe run|trace [--seed N] [--zones N]
        [--cells-per-zone N] [--replicas N] [--policy P] [--rps R]
        [--requests N] [--process P] [--diurnal-period-s S] [--no-sched]
        [--autoscale] [--spot-budget N] [--spill-headroom F] [--overload]
        [--tenancy] [--tick-s S] [--no-event-core] [--max-virtual-s S]
        [--shards N] [--trace-file F] [--save-trace F] [--out F] [--json]
    python -m kind_tpu_sim_torch sched run|trace [--seed N] [--policy P]
        [--gangs N] [--pods A:T,...] [--no-preemption] [--no-defrag]
        [--manifest FILE] [--events] [--out F] [--json]
    python -m kind_tpu_sim_torch train run|plan [--seed N] [--gangs N]
        [--ising N] [--steps N] [--cadence N] [--elastic]
        [--manifest FILE] [--serving-rps R] [--requests N] [--replicas N]
        [--pods A:T,...] [--mtbf-s S] [--step-s S] [--no-event-core]
        [--out F] [--json]
    python -m kind_tpu_sim_torch health knobs|demo [--seed N]
        [--components N] [--samples N] [--json]

``train-smoke`` is the counterpart of ``python -m kind_tpu_sim
train-smoke`` (``kind_tpu_sim/cli.py:run_train_smoke``): the training
stack proved with no cluster -- the data pipeline feeds the train step
and the loss must fall; with ``--checkpoint-dir`` also the
checkpoint/resume round trip, whose resumed loss trajectory must match
the uninterrupted one. It runs on the CUDA card unless ``--device cpu``
is given, and raises without a card.

``profile`` is the counterpart of ``python -m kind_tpu_sim profile``
(``kind_tpu_sim/cli.py:run_profile``): one flagship loss step traced
with ``torch.profiler`` (``profiling.profile_flagship``, the tiny
``ModelConfig()`` at batch 2), its Chrome trace written under ``--out``
and its top ops printed -- the card's kernels where the trace has them,
host operations otherwise.

``slice-smoke`` is the counterpart of ``python -m kind_tpu_sim
slice-smoke`` (``kind_tpu_sim/cli.py:run_slice_smoke``): a simulated
multi-host slice launched on this machine (one process per simulated
host, one rank per chip, ``parallel/multihost.py``) runs the cross-host
collectives; ``--ring-tokens`` adds the long-context ring over every
rank, ``--num-slices`` launches a multislice job, ``--serving`` adds the
serving reports. The ranks run on ``--device`` (the card unless ``cpu``
is given) over ``--backend`` (gloo unless the caller names nccl, which
takes one rank a card).

``torch-smoke`` is the counterpart of ``python -m kind_tpu_sim
jax-smoke`` (``kind_tpu_sim/cli.py:run_jax_smoke``): the collectives
suite (``parallel/collectives.run_all`` over ``slice_mesh`` of
``--topology``) submitted ``--repeat`` times to one persistent worker
(``utils/worker_pool.py``) whose world of ``--chips`` ranks over
``--backend`` on ``--device`` comes up once; the report has the
reference's keys, the first run being the cold bring-up. It prints
``TORCH SMOKE OK`` or ``TORCH SMOKE FAILED`` and exits 0 or 1.

``manifests torch-multihost`` is the counterpart of ``python -m
kind_tpu_sim manifests jax-multihost`` (``run_manifests``): the
Services and StatefulSets of a ``torch.distributed`` world a slice over
GPU nodes (``manifests.torch_multihost_manifest``), printed or written
to ``--out``.

``fleet`` is the counterpart of ``python -m kind_tpu_sim fleet``
(``kind_tpu_sim/cli.py:run_fleet``): a fleet under a seeded open-loop
trace on a virtual clock (``fleet/``), its JSON report the reference's.
Its default engine is ``serving`` (the reference's is ``sim``): real
serving engines (the reference's tiny model, weights from
``torch.Generator`` seed 0, four slots of 128 positions each) on
``--device``. ``--engine sim`` runs the analytic replicas, which do no
device work and refuse ``--device``; ``--disagg P:D`` (sim only) splits
them into prefill and decode pools priced from ``--calibration`` (the
H100's calibration by default), with ``--disagg-tier`` and
``--disagg-dtype``.
``--health``, ``--overload``, ``--tenancy`` and ``--audit-frac`` turn on
the fleet's control layers as the reference's flags do; ``--sched``
places the replicas as gangs of the cluster scheduler and ``--train N``
adds N training gangs under them; ``--no-event-core`` runs the plain
per-tick loop (the same report) and ``--profile`` adds the cProfile
section (``profiling.profile_fleet_run``). ``fleet trace`` prints or
saves the trace alone. ``fleet calibrate --bench PATH`` derives the cost
model's calibration from a bench artifact (``bench.py --model-only``),
writes it to ``--out`` (default: the H100's file), prints each phase's
error and exits 1 while any error is over 0.15. ``--zoo`` (sim only)
serves the default three-model zoo: every request names a model,
replicas keep one model warm and a cold admission pays a modeled weight
load; ``--generations G1,G2`` cycles generation names over the replica
ids, each replica priced from its generation's calibration. The port
registers one generation, ``h100``, and a zoo without ``--generations``
takes it; another name raises the reference's "unknown generation".
``fleet tune`` is the reference's seeded search (``tune/``): candidates
of the fleet design space (``--zoo``: generations and model placement
from the port's registry; ``--sdc``: the audit fraction; ``--ratios``:
the disagg pool ratios) screened on a short trace, survivors run on the
whole trace, the Pareto front of chip-seconds against goodput and
attainment and its knee the winner, with ``--chaos-budget`` fault
schedules re-scoring the finalists; every candidate is an analytic
fleet priced from the calibration, so it refuses ``--device``.
``--tune-workers N`` scores candidates in N cold worker processes (the
same report), ``--spec-out`` writes the winner's spec and
``--replay-spec`` re-scores one. It prints ``TUNE OK`` or ``TUNE
FAILED`` (or the JSON report) and exits 0 or 1.

``create``, ``delete``, ``load``, ``status`` and ``chaos fail | heal |
kill-node | start-node`` are the reference's cluster layer
(``config.py``, ``runtime.py``, ``registry.py``, ``cluster.py``,
``plugin.py``): a kind cluster whose workers advertise simulated
accelerators. ``create nvidia`` makes the ``nvidia.com/gpu`` nodes the
port's GPU pods select (``hardware-type: gpu``, tolerating
``gpu=true:NoSchedule``). It needs docker or podman, ``kind`` and
``kubectl`` and fails naming a missing one (exit 1); ``--runtime fake``
runs over a dry-run control plane (``fakes.py``) that records every
command, printed to stderr with ``-v``.

``chaos run`` is the counterpart of ``python -m kind_tpu_sim chaos run``
(``run_chaos_engine``) for the ported scenarios (``chaos.py``): the
three that drive device work, ``preempt-train``,
``serving-slot-failure`` and ``fleet-preemption`` (slow, on
``--device``), and twenty-five that do no device work: the three
control-plane ones over the fake runtime (``flaky-exec``,
``device-flap``, ``node-flap``), fifteen
analytic ones (``disagg-pool-loss``, ``zoo-swap-storm`` and the thirteen
virtual-clock scenarios of the fleet's control layers, the scheduler and
the training tenancy), the four globe scenarios (``globe-zone-loss``,
``globe-herd-failover``, ``globe-dcn-degrade``, ``train-globe-spot``)
and the three cold worker grids (``worker-crash-grid``,
``worker-hang-grid``, ``gray-straggler-grid``), which run subprocess
workers on the wall clock. Without
``--scenario`` it lists them; ``all`` runs the fast ones, and the slow
ones too with ``--include-slow``. It prints ``CHAOS RUN OK`` or ``CHAOS
RUN FAILED`` and exits 0 or 1: on the H100's calibration
``zoo-swap-storm`` fails its p99 bound at seed 0, so ``all`` exits 1.
``--list`` prints the scenario registry (``scenarios/registry.py``; a
scenario that drives device work is tagged ``[device]`` where the
reference tags ``[jax]``, and its JSON rows keep the reference's
``needs_jax`` key).

``chaos fuzz`` is the reference's seeded campaign (``scenarios/``):
``--budget`` composed scenarios of fuzz stream ``--seed``, each run
checked against the universal invariants, violations shrunk to minimal
repro specs (``--emit-repros DIR`` writes them); ``--inject-invariant-bug``
plants the self-test's broken invariant, which the campaign must find and
shrink. Its report is the reference's for the same calibration and
generation registry; on the H100's, seed 1 finds two ``recovery``
violations by the numbers and exits 1. ``chaos soak`` runs
``--iterations`` scenarios drawn, with their seeds, from ``--seed``
over the registry's pool (the slow ones with ``--include-slow``), the
reference's (scenario, seed) stream.

``analysis replay`` is the reference's replay checker
(``analysis/replaycheck.py``): ``--scenario`` runs twice under one seed
and bisects any divergence to the first differing event; without it the
targets are listed; they are the reference's, the ``tune`` search
included. ``analysis lint | contract | knobs`` are refused, naming their
queue item.

``globe run | trace`` is the counterpart of ``python -m kind_tpu_sim
globe`` (``run_globe``): zones of analytic cells (each a ``FleetSim``,
scheduler-backed unless ``--no-sched``) behind the global front door on
one virtual clock, with ``--autoscale``, ``--spot-budget`` (the global
planner), ``--overload`` and ``--tenancy``; ``trace`` prints or saves
(``--save-trace``) the per-zone traces, and ``--trace-file`` replays one.
``--shards N`` (or ``KIND_TPU_SIM_GLOBE_SHARDS``) above 1 runs the cells
in N cold worker processes (``globe/shard.py``), with the same report.
Its output is the reference's. ``globe tune`` is the tuner over the
globe's design space (zones, cells, replicas, spill headroom), with
``fleet tune``'s tune flags.

``sched run | trace``, ``train run | plan`` and ``health knobs | demo``
are the reference's commands (``run_sched``, ``run_train``,
``run_health``) on the port's scheduler, training tenancy and detector:
the seeded scheduler simulation per placement policy (``--manifest``
also schedules a manifest's TPU workloads at t=0, read with the port's
own YAML reader; ``--events`` prints kubernetes Events), training gangs
under a serving fleet (``--manifest`` takes the gangs from a manifest)
and the checkpoint-cadence table, and the detector's resolved knobs and
its seeded straggler demo. Their JSON is the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import shutil
import sys
import time
from typing import Optional, Sequence

from kind_tpu_sim_torch import config
from kind_tpu_sim_torch import topology as topo

# torch and the models load inside the commands that drive a device, so
# the host-only commands (the simulators, the tuner, the cluster layer)
# start without them


def _add_tune_args(parser, target: str) -> None:
    """The ``tune`` action's flags, shared by the fleet and globe
    subparsers (the reference's, ``kind_tpu_sim/cli.py:_add_tune_args``)."""
    parser.add_argument(
        "--budget", type=int, default=None,
        help="tune: candidates to draw and screen (default: "
             "KIND_TPU_SIM_TUNE_BUDGET or 16)")
    parser.add_argument(
        "--tune-seed", type=int, default=None,
        help="tune: search-stream seed (default: "
             "KIND_TPU_SIM_TUNE_SEED or 0); distinct from --seed, "
             "which stays the workload seed")
    parser.add_argument(
        "--chaos-budget", type=int, default=None,
        help="tune: re-score finalists under this many fuzzer-drawn "
             "fault schedules and prefer all-schedule survivors "
             "(default: KIND_TPU_SIM_TUNE_CHAOS_BUDGET or 0 = off)")
    parser.add_argument(
        "--tune-workers", type=int, default=0,
        help="tune: evaluate candidates across this many cold worker "
             "processes (0 = in-process; the search trace is "
             "byte-identical either way)")
    parser.add_argument(
        "--spec-out", default=None,
        help="tune: write the winner's runnable sorted-keys JSON "
             "spec to this file (replay it with --replay-spec)")
    parser.add_argument(
        "--replay-spec", default=None, metavar="PATH",
        help="tune: skip the search and re-score this winner spec "
             "standalone (prints the metrics row)")
    if target == "fleet":
        parser.add_argument(
            "--ratios", default=None, metavar="P:D,...",
            help="tune: restrict the search space to these disagg "
                 "pool ratios at the --policy placement (e.g. "
                 "1:3,2:2,3:1); default searches the full fleet "
                 "design space")
        parser.add_argument(
            "--sdc", action="store_true",
            help="tune: search the integrity design space "
                 "(audit_frac x replicas x policy), scored against "
                 "dedicated sdc_chip storms when --chaos-budget > 0; "
                 "survival demands zero uncontained corrupted "
                 "responses")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m kind_tpu_sim_torch",
        description="PyTorch + CUDA port of kind_tpu_sim's model path")
    sub = parser.add_subparsers(dest="command", required=True)

    # the cluster layer's flags (the reference's ``common`` parent)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--registry-port", type=int, default=5000)
    common.add_argument("--cluster-name", default="kind-tpu-sim")
    common.add_argument(
        "--runtime", choices=["auto", "docker", "podman", "fake"],
        default="auto",
        help="container runtime; 'fake' records commands without a daemon")
    common.add_argument("-v", "--verbose", action="store_true")

    create = sub.add_parser(
        "create", parents=[common],
        help=("create a simulated accelerator cluster (nvidia: the "
              "nvidia.com/gpu nodes the port's GPU pods run on)"))
    create.add_argument("vendor", nargs="?", choices=list(config.VENDORS),
                        default="tpu")
    create.add_argument("--accelerator", default=topo.DEFAULT_ACCELERATOR,
                        choices=sorted(topo.ACCELERATORS),
                        help="TPU generation to simulate")
    create.add_argument("--topology", default=topo.DEFAULT_TOPOLOGY,
                        help="TPU slice topology, e.g. 4x4 (v5e) or 2x2x4 "
                             "(v4)")
    create.add_argument(
        "--num-slices", type=int, default=1,
        help=("simulate a TPU multislice job: N identical ICI slices "
              "joined over DCN (one set of kind workers per slice; pods "
              "get MEGASCALE_* env from the device plugin)"))
    create.add_argument(
        "--capacity-mode", choices=["plugin", "patch"], default="plugin",
        help=("plugin: durable capacity from the device plugin (default); "
              "patch: the source system's one-shot node-status patch"))
    create.add_argument(
        "--skip-plugin", action="store_true",
        help="skip the device-plugin build/deploy (patch mode only)")
    create.add_argument("--gpu-workers", type=int, default=2,
                        help="worker count for rocm/nvidia clusters")
    create.add_argument("--gpus-per-node", type=int, default=2,
                        help="fake GPUs per worker for rocm/nvidia clusters")
    create.add_argument("--timing-json", default=None,
                        help="write create-pipeline phase timings to this "
                             "file")

    sub.add_parser("delete", parents=[common],
                   help="tear down cluster and registry")

    load = sub.add_parser("load", parents=[common],
                          help="side-load an image into the cluster")
    load.add_argument("--image-name", required=True)

    status = sub.add_parser(
        "status", parents=[common],
        help="show simulated capacity and pod Ready latency")
    status.add_argument("--json", action="store_true", dest="as_json")

    train = sub.add_parser(
        "train-smoke",
        help=("no-cluster training proof: packed and prefetched input "
              "pipeline -> train step; optional checkpoint/resume round "
              "trip"))
    train.add_argument("--steps", type=int, default=30)
    train.add_argument("--batch", type=int, default=8)
    train.add_argument(
        "--checkpoint-dir", default=None,
        help=("also run the checkpoint/resume round trip: train half the "
              "steps, save, resume, and verify the resumed trajectory "
              "matches the uninterrupted one"))
    train.add_argument("--json", action="store_true", dest="as_json")
    train.add_argument("--device", default="cuda",
                       help="torch device to run on (default: cuda)")

    profile = sub.add_parser(
        "profile",
        help=("trace one flagship-model step with torch.profiler and "
              "print the top device ops"))
    profile.add_argument("--out", default="tpu-sim-trace",
                         help="trace output directory (Chrome trace)")
    profile.add_argument("--json", action="store_true", dest="as_json")
    profile.add_argument("--device", default="cuda",
                         help="torch device to run on (default: cuda)")

    smoke = sub.add_parser(
        "slice-smoke",
        help=("no-cluster multi-host proof: launch a local multi-host "
              "slice (one process per simulated host, one rank per chip) "
              "and run cross-host collectives"))
    smoke.add_argument("--topology", default="2x2x2")
    smoke.add_argument("--accelerator", default="tpu-v4-podslice",
                       choices=sorted(topo.ACCELERATORS))
    smoke.add_argument(
        "--ring-tokens", type=int, default=0,
        help=("also run the long-context ring-attention smoke over the "
              "whole slice at this many tokens (e.g. 32768)"))
    smoke.add_argument(
        "--num-slices", type=int, default=1,
        help=("launch a simulated multislice job: one process per host "
              "per slice, each slice its own world with the MEGASCALE_* "
              "cross-slice contract"))
    smoke.add_argument(
        "--serving", action="store_true",
        help=("also run the serving reports: the engines' contract "
              "(mixed greedy and sampled against the single-sequence "
              "decoder) and speculative decoding's greedy exactness"))
    smoke.add_argument("--json", action="store_true", dest="as_json")
    smoke.add_argument("--device", default="cuda",
                       help="torch device the ranks run on (default: cuda)")
    smoke.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                       help="torch.distributed backend (default: gloo)")

    tsmoke = sub.add_parser(
        "torch-smoke",
        help=("no-cluster warm-path smoke: run the collectives suite on "
              "one persistent worker and its live torch.distributed world "
              "(utils/worker_pool) and report cold bring-up against warm "
              "resubmission timings"))
    tsmoke.add_argument("--chips", type=int, default=8,
                        help="ranks of the worker's world")
    tsmoke.add_argument("--topology", default="2x4")
    tsmoke.add_argument("--repeat", type=int, default=3,
                        help="total suite runs (first is the cold bring-up)")
    tsmoke.add_argument("--json", action="store_true", dest="as_json")
    tsmoke.add_argument("--device", default="cuda",
                        help="torch device the ranks run on (default: cuda)")
    tsmoke.add_argument("--backend", default="gloo",
                        choices=("gloo", "nccl"),
                        help="torch.distributed backend (default: gloo)")

    man = sub.add_parser(
        "manifests",
        help="print a topology-derived workload manifest (no cluster "
             "needed)")
    man.add_argument("which", choices=["torch-multihost"])
    man.add_argument("--topology", default=topo.DEFAULT_TOPOLOGY)
    man.add_argument("--accelerator", default=topo.DEFAULT_ACCELERATOR,
                     choices=sorted(topo.ACCELERATORS))
    man.add_argument("--num-slices", type=int, default=1,
                     help="one torch.distributed world per slice")
    man.add_argument("--out", default=None,
                     help="write to this file instead of stdout")

    fl = sub.add_parser(
        "fleet",
        help=("a fleet of real serving engines or analytic replicas under "
              "seeded open-loop traffic with SLO-aware routing, on a "
              "virtual clock"))
    fl.add_argument("action", choices=["run", "trace", "calibrate", "tune"])
    fl.add_argument("--seed", type=int, default=None,
                    help="workload seed (default: KIND_TPU_SIM_FLEET_SEED "
                         "or 0)")
    fl.add_argument("--replicas", type=int, default=2)
    fl.add_argument("--policy", default="round-robin",
                    choices=["round-robin", "least-outstanding",
                             "prefix-affinity"])
    fl.add_argument("--rps", type=float, default=100.0,
                    help="mean arrival rate (requests per virtual second)")
    fl.add_argument("--requests", type=int, default=200)
    fl.add_argument("--process", default="poisson",
                    choices=["poisson", "bursty", "diurnal"])
    fl.add_argument("--engine", default="serving", choices=["sim", "serving"],
                    help=("serving (the default, unlike the reference's "
                          "sim, since the port's commands serve real "
                          "engines): ServingEngine replicas on --device; "
                          "sim: the analytic replicas, no device work"))
    fl.add_argument("--deadline-s", type=float, default=None,
                    help="per-request e2e budget (virtual s)")
    fl.add_argument("--ttft-slo", type=float, default=0.5)
    fl.add_argument("--e2e-slo", type=float, default=2.0)
    fl.add_argument("--itl-slo", type=float, default=None)
    fl.add_argument("--shared-prefix-frac", type=float, default=0.0,
                    help="fraction of requests in shared-prefix groups")
    fl.add_argument("--prefix-groups", type=int, default=4)
    fl.add_argument("--autoscale", action="store_true",
                    help="queue/SLO-driven autoscaling (--replicas is the "
                         "floor)")
    fl.add_argument("--max-replicas", type=int, default=8)
    fl.add_argument("--tick-s", type=float, default=None,
                    help="virtual scheduling quantum (default: "
                         "KIND_TPU_SIM_FLEET_TICK_S or 0.01)")
    fl.add_argument("--eval-every-s", type=float, default=None,
                    help="autoscaler evaluation cadence in virtual seconds")
    fl.add_argument("--trace-file", default=None,
                    help="replay this JSONL trace instead of generating one")
    fl.add_argument("--save-trace", default=None,
                    help="also write the generated trace to this JSONL file")
    fl.add_argument("--out", default=None,
                    help="write the full JSON report to this file")
    fl.add_argument("--json", action="store_true", dest="as_json")
    fl.add_argument("--device", default=None,
                    help="torch device the serving engines run on (default: "
                         "cuda); refused with --engine sim")
    fl.add_argument("--health", action="store_true",
                    help="the gray-failure detector: latency-aware routing, "
                         "slow-replica quarantine and probe restore; the "
                         "report gains a 'health' section")
    fl.add_argument("--overload", action="store_true",
                    help="overload containment: budgeted client retries, "
                         "hedged requests (the first completion wins, the "
                         "loser is cancelled), per-replica circuit breakers "
                         "and the brownout ladder; the report gains an "
                         "'overload' section")
    fl.add_argument("--tenancy", action="store_true",
                    help="multi-tenancy: the three-tenant traffic model, "
                         "per-tenant quotas and deficit-round-robin "
                         "queuing; the report gains a 'tenancy' section")
    fl.add_argument("--no-tenant-isolation", action="store_true",
                    help="with --tenancy: keep the tenant traffic but "
                         "serve it FCFS without quotas")
    fl.add_argument("--audit-frac", type=float, default=None,
                    metavar="FRAC",
                    help="execute this share of served requests again on a "
                         "second replica and compare the streams (the "
                         "integrity audit lane); default 0")
    fl.add_argument("--sched", action="store_true",
                    help="place replicas through the topology-aware cluster "
                         "scheduler: scale-up time to routable = queue wait "
                         "+ placement + warm-up; enables node, link and "
                         "domain chaos; the report gains a 'scheduler' "
                         "section")
    fl.add_argument("--sched-policy", default="ici",
                    choices=["binpack", "spread", "ici"],
                    help="placement scoring policy when --sched is set")
    fl.add_argument("--train", type=int, default=0, metavar="N",
                    help="co-schedule N LLM training gangs under the "
                         "serving fleet (requires --sched): analytic gangs "
                         "at priority -10 with checkpointed preemption and "
                         "a zero-lost-step ledger; the report gains a "
                         "'training' section")
    fl.add_argument("--no-event-core", action="store_true",
                    help="run the plain per-tick loop instead of the event "
                         "core (the same report; default: "
                         "KIND_TPU_SIM_FLEET_EVENT_CORE or on)")
    fl.add_argument("--profile", action="store_true",
                    help="run under cProfile and add a 'profile' section: "
                         "wall seconds, events/s, events and self time by "
                         "event lane, the top functions")
    fl.add_argument("--disagg", default=None, metavar="P:D",
                    help="with --engine sim: P prefill replicas feed D decode "
                         "replicas over a modeled KV transfer; replaces "
                         "--replicas with P+D and prices both pools from "
                         "the calibration")
    fl.add_argument("--disagg-tier", default=None, choices=["ici", "dcn"],
                    help="the KV transfer's interconnect tier (default: "
                         "KIND_TPU_SIM_DISAGG_TIER or ici)")
    fl.add_argument("--disagg-dtype", default=None, choices=["bf16", "int8"],
                    help="the KV cache's dtype, pricing the transfer and "
                         "decode's bandwidth (default: "
                         "KIND_TPU_SIM_DISAGG_DTYPE or bf16)")
    fl.add_argument("--calibration", default=None, metavar="PATH",
                    help="the cost model's calibration JSON for --disagg "
                         "(default: KIND_TPU_SIM_CALIBRATION or "
                         "kind_tpu_sim_torch/calibration/h100.json)")
    fl.add_argument("--bench", default=None, metavar="PATH",
                    help="fleet calibrate's input: a bench artifact with "
                         "the model block's roofline keys")
    fl.add_argument("--zoo", action="store_true",
                    help="with --engine sim: serve the default three-model "
                         "zoo: every request targets a model, replicas "
                         "hold one model's weights warm, cold routes pay a "
                         "modeled weight load on the swap lane, and routing "
                         "is warm-first; defaults --generations to the "
                         "default generation (h100); knobs "
                         "KIND_TPU_SIM_ZOO_*; the report gains a 'zoo' "
                         "section")
    fl.add_argument("--generations", default=None, metavar="G1,G2",
                    help="accelerator generations cycled over replica ids, "
                         "each replica priced from its generation's "
                         "calibration (registered: h100); under --sched the "
                         "one generation is the gangs' accelerator label's")
    _add_tune_args(fl, "fleet")

    gl = sub.add_parser(
        "globe",
        help=(
            "multi-cell / multi-zone fleet-of-fleets simulator: "
            "per-zone seeded demand (follow-the-sun diurnal phase "
            "offsets) through a global anycast-style front door "
            "over N cells (each a full fleet sim, optionally "
            "scheduler-backed), with bounded cross-cell spill and "
            "a global spot-capacity planner — same seed, "
            "byte-identical report (docs/GLOBE.md)"
        ),
    )
    gl.add_argument("action", choices=["run", "trace", "tune"])
    gl.add_argument(
        "--seed", type=int, default=None,
        help="workload seed (default: KIND_TPU_SIM_GLOBE_SEED or 0)")
    gl.add_argument(
        "--zones", type=int, default=3,
        help="zones (correlated failure domains), named zone-a..")
    gl.add_argument("--cells-per-zone", type=int, default=1)
    gl.add_argument("--replicas", type=int, default=2,
                    help="replicas per cell")
    gl.add_argument(
        "--policy", default="least-outstanding",
        choices=["round-robin", "least-outstanding",
                 "prefix-affinity"],
        help="per-cell router policy")
    gl.add_argument(
        "--rps", type=float, default=40.0,
        help="mean arrival rate per zone (requests/virtual s)")
    gl.add_argument("--requests", type=int, default=200,
                    help="requests per zone")
    gl.add_argument(
        "--process", default="poisson",
        choices=["poisson", "bursty", "diurnal"],
        help="per-zone arrival process; diurnal zones peak "
             "follow-the-sun (staggered phase offsets)")
    gl.add_argument(
        "--diurnal-period-s", type=float, default=20.0,
        help="one compressed day (diurnal process)")
    gl.add_argument(
        "--no-sched", action="store_true",
        help="plain fleets instead of scheduler-backed cells")
    gl.add_argument(
        "--autoscale", action="store_true",
        help="per-cell autoscalers (--replicas becomes each "
             "cell's reserved floor)")
    gl.add_argument(
        "--spot-budget", type=int, default=None,
        help="enable the global capacity planner with this many "
             "spot replicas shared across all cells "
             "(implies --autoscale)")
    gl.add_argument(
        "--spill-headroom", type=float, default=0.5,
        help="extra load fraction a cell accepts from cross-cell "
             "spill before the front door refuses (the herd bound)")
    gl.add_argument(
        "--overload", action="store_true",
        help="enable overload containment (docs/OVERLOAD.md): "
             "per-origin client retry budgets and cross-cell "
             "hedging at the front door, per-cell circuit "
             "breakers, breaker+brownout inside every cell; knobs "
             "KIND_TPU_SIM_OVERLOAD_*")
    gl.add_argument(
        "--tenancy", action="store_true",
        help="enable serving multi-tenancy (docs/TENANCY.md): "
             "per-zone heavy-tailed tenant traffic, quotas charged "
             "once at the global front door, weighted-fair queuing "
             "+ KV budgets inside every cell, per-(origin, tenant) "
             "retry/hedge budgets under --overload; report gains a "
             "'tenancy' section")
    gl.add_argument(
        "--tick-s", type=float, default=None,
        help="virtual scheduling quantum "
             "(default: KIND_TPU_SIM_FLEET_TICK_S or 0.01)")
    gl.add_argument(
        "--no-event-core", action="store_true",
        help="force the lockstep per-tick loop instead of the "
             "event-heap core (byte-identical, just slower; "
             "default: KIND_TPU_SIM_FLEET_EVENT_CORE or on)")
    gl.add_argument(
        "--max-virtual-s", type=float, default=600.0,
        help="virtual-time runaway backstop")
    gl.add_argument(
        "--shards", type=int, default=None,
        help="partition the cells across this many worker "
             "processes (byte-identical report; default: "
             "KIND_TPU_SIM_GLOBE_SHARDS or 0 = single-process)")
    gl.add_argument(
        "--trace-file", default=None,
        help="replay this JSONL globe trace instead of generating")
    gl.add_argument(
        "--save-trace", default=None,
        help="also write the generated per-zone traces to this "
             "JSONL file (origin zone rides on each line)")
    gl.add_argument(
        "--out", default=None,
        help="write the full JSON report to this file")
    gl.add_argument("--json", action="store_true", dest="as_json")
    _add_tune_args(gl, "globe")

    sd = sub.add_parser(
        "sched",
        help=(
            "deterministic topology-aware TPU slice scheduler sim: "
            "gang placement of a seeded slice-request workload onto "
            "a simulated node inventory, with binpack/spread/ICI "
            "scoring, priority preemption, and defrag — same seed, "
            "byte-identical event log (docs/SCHED.md)"
        ),
    )
    sd.add_argument("action", choices=["run", "trace"])
    sd.add_argument(
        "--seed", type=int, default=None,
        help="workload seed (default: KIND_TPU_SIM_SCHED_SEED or 0)")
    sd.add_argument(
        "--policy", default="binpack,spread,ici",
        help="comma-separated placement policies to run "
             "(binpack, spread, ici); one report section each")
    sd.add_argument(
        "--gangs", type=int, default=24,
        help="slice requests in the seeded workload")
    sd.add_argument(
        "--pods", default="tpu-v5-lite-podslice:4x8,"
                          "tpu-v5-lite-podslice:4x8",
        help="inventory as comma-separated accelerator:topology "
             "pairs, one ICI domain each")
    sd.add_argument(
        "--no-preemption", action="store_true",
        help="disable priority preemption")
    sd.add_argument(
        "--no-defrag", action="store_true",
        help="disable the defragmentation pass")
    sd.add_argument(
        "--manifest", default=None,
        help="also schedule the TPU workloads parsed from this "
             "kubernetes manifest (e.g. "
             "pods/tpu-serving-deployment.yaml) at t=0")
    sd.add_argument(
        "--events", action="store_true",
        help="run: print the full event log as JSON lines "
             "(kubernetes Event objects)")
    sd.add_argument(
        "--out", default=None,
        help="write the full JSON report to this file")
    sd.add_argument("--json", action="store_true", dest="as_json")

    tr = sub.add_parser(
        "train",
        help=(
            "training as a fleet tenant (docs/TRAINING.md): run = "
            "co-scheduled training gangs (LLM and/or Ising sweeps) "
            "under a serving fleet on the cluster scheduler, with "
            "checkpoint economics and a zero-lost-step progress "
            "ledger — same seed, byte-identical report; plan = the "
            "checkpoint-cadence economics table (Young-Daly "
            "optimum vs alternatives)"
        ),
    )
    tr.add_argument("action", choices=["run", "plan"])
    tr.add_argument(
        "--seed", type=int, default=None,
        help="serving workload seed (default: "
             "KIND_TPU_SIM_FLEET_SEED or 0)")
    tr.add_argument(
        "--gangs", type=int, default=1,
        help="LLM training gangs (GSPMD data x model mesh over "
             "each gang's ICI block)")
    tr.add_argument(
        "--ising", type=int, default=0,
        help="additional Monte-Carlo Ising sweep gangs "
             "(all-throughput, sub-host, collective-free)")
    tr.add_argument(
        "--steps", type=int, default=80,
        help="training steps per gang")
    tr.add_argument(
        "--cadence", type=int, default=None,
        help="checkpoint cadence in steps (default: "
             "KIND_TPU_SIM_TRAIN_CKPT_EVERY; 0 = the Young-Daly "
             "optimum for the gang's step time)")
    tr.add_argument(
        "--elastic", action="store_true",
        help="elastic gangs: grow onto scavenged free inventory "
             "via checkpointed repartition, shrink (never abort) "
             "on reclaim")
    tr.add_argument(
        "--manifest", default=None,
        help="parse the training gangs from this kubernetes "
             "manifest (e.g. pods/tpu-batch-train-job.yaml: a "
             "StatefulSet is ONE gang at its annotated priority) "
             "instead of synthesizing them")
    tr.add_argument("--serving-rps", type=float, default=40.0,
                    help="serving traffic riding along (req/s)")
    tr.add_argument("--requests", type=int, default=150,
                    help="serving requests in the trace")
    tr.add_argument("--replicas", type=int, default=2,
                    help="serving replicas (priority 10, above "
                         "every training gang)")
    tr.add_argument(
        "--pods", default="tpu-v5-lite-podslice:4x8,"
                          "tpu-v5-lite-podslice:4x8",
        help="inventory as comma-separated accelerator:topology "
             "pairs, one ICI domain each")
    tr.add_argument(
        "--mtbf-s", type=float, default=None,
        help="assumed preemption MTBF for plan / auto cadence "
             "(default: KIND_TPU_SIM_TRAIN_MTBF_S)")
    tr.add_argument(
        "--step-s", type=float, default=None,
        help="plan: per-step time override (default: derived from "
             "the default gang's mesh via the ring model)")
    tr.add_argument(
        "--no-event-core", action="store_true",
        help="force the plain per-tick loop (byte-identical, "
             "slower)")
    tr.add_argument("--out", default=None,
                    help="write the full JSON report to this file")
    tr.add_argument("--json", action="store_true", dest="as_json")

    he = sub.add_parser(
        "health",
        help=(
            "gray-failure detection layer (docs/HEALTH.md): print "
            "the resolved detector knobs, or run a seeded synthetic "
            "straggler through the phi-accrual detector "
            "(quarantine -> probe -> restore) — deterministic, no "
            "cluster needed"
        ),
    )
    he.add_argument("action", choices=["knobs", "demo"])
    he.add_argument(
        "--seed", type=int, default=None,
        help="fault-plan seed for 'demo' (default: "
             "KIND_TPU_SIM_CHAOS_SEED or 0)")
    he.add_argument("--components", type=int, default=4)
    he.add_argument("--samples", type=int, default=120)
    he.add_argument("--json", action="store_true", dest="as_json")

    ch = sub.add_parser(
        "chaos", parents=[common],
        help=("fault injection: the manual levers (fail, heal, kill-node, "
              "start-node) against a cluster, the seeded scenarios that "
              "drive the engines, the trainer, the fleet and the control "
              "plane through their recovery paths (run, soak), and the "
              "seeded fuzzer that composes fault schedules (fuzz)"))
    ch.add_argument("action", choices=["fail", "heal", "kill-node",
                                       "start-node", "run", "soak", "fuzz"])
    ch.add_argument("--node", default=None,
                    help="target node container name")
    ch.add_argument("--worker", type=int, default=None,
                    help="target worker by id (alternative to --node)")
    ch.add_argument("--devices", default="",
                    help="comma-separated device IDs for 'fail' (default: "
                         "all)")
    ch.add_argument("--topology", default=topo.DEFAULT_TOPOLOGY)
    ch.add_argument("--accelerator", default=topo.DEFAULT_ACCELERATOR,
                    choices=sorted(topo.ACCELERATORS))
    ch.add_argument("--num-slices", type=int, default=1,
                    help="match the create-time multislice shape so "
                         "--worker range checks cover every slice's nodes")
    ch.add_argument("--iterations", type=int, default=10,
                    help="seeded scenario runs for 'soak'")
    ch.add_argument("--scenario", default=None,
                    help="named scenario, or 'all'; omit to list them")
    ch.add_argument("--seed", type=int, default=None,
                    help="fault-plan seed (default: KIND_TPU_SIM_CHAOS_SEED "
                         "or 0; fuzz: KIND_TPU_SIM_FUZZ_SEED or 0)")
    ch.add_argument("--include-slow", action="store_true",
                    help="run all / soak may pick the slow scenarios (the "
                         "three that drive device work)")
    ch.add_argument("--list", action="store_true", dest="list_scenarios",
                    help="print the scenario registry (with --json: one "
                         "sorted-keys row per scenario) and exit")
    ch.add_argument("--budget", type=int, default=None,
                    help="composed scenarios one 'fuzz' campaign draws "
                         "(default: KIND_TPU_SIM_FUZZ_BUDGET)")
    ch.add_argument("--max-faults", type=int, default=None,
                    help="max concurrent fault kinds per drawn scenario "
                         "(default: KIND_TPU_SIM_FUZZ_MAX_FAULTS)")
    ch.add_argument("--inject-invariant-bug", action="store_true",
                    help="fuzz self-test: also check the deliberately "
                         "broken invariant; exit 0 iff the fuzzer finds AND "
                         "shrinks it")
    ch.add_argument("--emit-repros", default=None, metavar="DIR",
                    help="write each shrunk violation as a pinned spec file "
                         "under DIR")
    ch.add_argument("--json", action="store_true", dest="as_json")
    ch.add_argument("--device", default="cuda",
                    help="torch device the scenarios run on (default: cuda)")

    an = sub.add_parser(
        "analysis",
        help=("determinism tooling: replay = run a target twice under one "
              "seed and bisect any divergence to the first differing "
              "event (lint, contract and knobs are not ported yet)"))
    an.add_argument("action", choices=["lint", "knobs", "replay", "contract"])
    an.add_argument("paths", nargs="*", help=argparse.SUPPRESS)
    an.add_argument("--scenario", default=None,
                    help="replay target for 'replay' (omit to list targets)")
    an.add_argument("--seed", type=int, default=None,
                    help="replay seed (default: KIND_TPU_SIM_CHAOS_SEED or 0)")
    an.add_argument("--runs", type=int, default=2,
                    help="replay run count (divergence is judged against "
                         "run 0)")
    an.add_argument("--inject-entropy-bug", action="store_true",
                    dest="inject",
                    help="deliberately perturb every run after the first "
                         "(bisector self-test: the report must name the "
                         "first divergent event)")
    an.add_argument("--json", action="store_true", dest="as_json")
    return parser


def smoke_config() -> "tf.ModelConfig":
    """The reference's train-smoke model (bf16 activations)."""
    from kind_tpu_sim_torch.models import transformer as tf

    return tf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                          d_ff=64, max_seq=16)


def run_train_smoke(args: argparse.Namespace) -> int:
    """Data pipeline in, loss down; optionally the checkpoint/resume
    contract too."""
    if args.steps < 10:
        raise SystemExit(
            "train-smoke needs --steps >= 10 (the ok-check compares the "
            "first five losses against the last five)")
    import numpy as np
    import torch

    from kind_tpu_sim_torch import data
    from kind_tpu_sim_torch.device import resolve
    from kind_tpu_sim_torch.models import checkpoint as ckpt
    from kind_tpu_sim_torch.models import transformer as tf

    dev = resolve(args.device)
    cfg = smoke_config()
    step, init = tf.make_train_step(cfg, learning_rate=1e-2, device=dev)
    state = init(torch.Generator(device=dev).manual_seed(0))
    losses = []
    t0 = time.monotonic()
    with data.input_pipeline(cfg, batch=args.batch, steps=args.steps,
                             device=dev) as pipe:
        for tokens in pipe:
            state, loss = step(state, tokens)
            losses.append(float(loss))  # waits for the step
    elapsed = time.monotonic() - t0
    head = float(np.mean(losses[:5]))
    tail = float(np.mean(losses[-5:]))
    report = {
        "steps": len(losses),
        "loss_first5": round(head, 4),
        "loss_last5": round(tail, 4),
        "tokens_per_s": round(
            args.batch * cfg.max_seq * len(losses) / elapsed),
        "ok": bool(tail < head),
    }

    if args.checkpoint_dir:
        # a self-contained proof: stale checkpoints from an earlier run
        # would resume past the requested steps or mix two runs
        straight_dir = args.checkpoint_dir + "-straight"
        for d in (args.checkpoint_dir, straight_dir):
            shutil.rmtree(d, ignore_errors=True)
        half = max(1, args.steps // 2)
        _, a = ckpt.train_with_checkpointing(
            cfg, args.checkpoint_dir, total_steps=half,
            checkpoint_every=half, batch=args.batch, device=dev)
        _, b = ckpt.train_with_checkpointing(
            cfg, args.checkpoint_dir, total_steps=args.steps,
            checkpoint_every=half, batch=args.batch, device=dev)
        resumed = {**a, **b}
        _, straight = ckpt.train_with_checkpointing(
            cfg, straight_dir, total_steps=args.steps,
            checkpoint_every=args.steps, batch=args.batch, device=dev)
        drift = max(abs(resumed[i] - straight[i]) for i in range(args.steps))
        report["resume_max_loss_drift"] = drift
        report["resume_ok"] = bool(drift < 1e-4)
        report["ok"] = report["ok"] and report["resume_ok"]

    if args.as_json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(f"train-smoke: {report['steps']} steps, loss "
              f"{report['loss_first5']} -> {report['loss_last5']}, "
              f"{report['tokens_per_s']} tok/s on {dev}")
        if "resume_ok" in report:
            print(f"checkpoint/resume drift "
                  f"{report['resume_max_loss_drift']:.2e} "
                  f"{'OK' if report['resume_ok'] else 'FAILED'}")
        print("TRAIN SMOKE " + ("OK" if report["ok"] else "FAILED"))
    return 0 if report["ok"] else 1


def run_profile(args: argparse.Namespace) -> int:
    from kind_tpu_sim_torch import profiling

    report = profiling.profile_flagship(args.out, device=args.device)
    if args.as_json:
        print(json.dumps(report, sort_keys=True))
        return 0
    print(f"model {report['model']}: one step in "
          f"{report['wall_s']}s on {report['device']}, trace in "
          f"{report['log_dir']}")
    summary = report["summary"]
    scope = "device" if summary["device_tracks"] else "host"
    print(f"top {scope} ops:")
    for op in summary["top_ops"]:
        print(f"  {op['total_us']:>12.1f} us  x{op['count']:<4} "
              f"{op['name']}")
    return 0


def run_slice_smoke(args: argparse.Namespace) -> int:
    from kind_tpu_sim_torch.parallel import mesh, multihost

    if args.ring_tokens:
        # fail fast: a token count the ranks cannot split would crash
        # every worker only after the whole slice has met
        chips = mesh.make_slice(accelerator=args.accelerator,
                                topology=args.topology).num_chips
        if args.ring_tokens % chips:
            raise ValueError(
                f"--ring-tokens={args.ring_tokens} must be divisible "
                f"by the slice's {chips} chips")
    if args.num_slices > 1:
        if args.ring_tokens:
            raise SystemExit(
                "--ring-tokens is a single-slice smoke; drop it or "
                "run without --num-slices")
        per_slice = multihost.launch_local_multislice(
            num_slices=args.num_slices, topology=args.topology,
            accelerator=args.accelerator, device=args.device,
            backend=args.backend)
        reports = [dict(rep, slice=sid)
                   for sid, reps in enumerate(per_slice) for rep in reps]
    else:
        reports = multihost.launch_local_slice(
            topology=args.topology, accelerator=args.accelerator,
            ring_tokens=args.ring_tokens, device=args.device,
            backend=args.backend)
    ok = all(r["ok"] for r in reports)
    serving_rep = spec_rep = None
    if args.serving:
        from kind_tpu_sim_torch.models import serving, speculative

        serving_rep = serving.serving_report(device=args.device)
        spec_rep = speculative.speculative_report(device=args.device)
        engines_rep = serving.engines_report(device=args.device)
        serving_rep["engines"] = engines_rep
        ok = (ok and serving_rep["ok"] and spec_rep["ok"]
              and engines_rep["ok"])
    if args.as_json:
        out = {"ok": ok, "workers": reports}
        if serving_rep is not None:
            out["serving"] = serving_rep
            out["speculative"] = spec_rep
        print(json.dumps(out, sort_keys=True))
    else:
        for rank, rep in enumerate(reports):
            ring = ""
            if "slice" in rep:
                ring = f" [slice {rep['slice']}]"
            if "ring_tokens" in rep:
                ring = (f", ring {rep['ring_tokens']} tokens in "
                        f"{rep['ring_seconds']}s "
                        f"{'OK' if rep['ring_ok'] else 'FAILED'}")
            print(f"worker {rank}: {rep['local_devices']} local / "
                  f"{rep['global_devices']} global devices, "
                  f"psum {rep['psum_total']} "
                  f"(want {rep['psum_expected']}) "
                  f"{'OK' if rep['ok'] else 'FAILED'}{ring}")
        if serving_rep is not None:
            print(f"serving: {serving_rep['requests']} requests over "
                  f"{serving_rep['slots']} slots, greedy-exact "
                  f"{'OK' if serving_rep['greedy_exact'] else 'FAILED'}")
            print(f"speculative: greedy-exact "
                  f"{'OK' if spec_rep['greedy_exact'] else 'FAILED'}")
            eng_rep = serving_rep["engines"]
            print(f"engine matrix ({', '.join(eng_rep['engines'])}): "
                  "identical streams "
                  f"{'OK' if eng_rep['ok'] else 'FAILED'}")
        print("SLICE SMOKE " + ("OK" if ok else "FAILED"))
    return 0 if ok else 1


def run_torch_smoke(args: argparse.Namespace) -> int:
    """Warm-path smoke: one persistent worker, the collectives suite
    submitted ``--repeat`` times. The first run pays the worker's
    warm-up (torch's import and the world's bring-up); the rest measure
    the warm path the pool exists for: the same processes and process
    groups. ``ok`` also needs every run answered by the first's
    worker."""
    from kind_tpu_sim_torch.utils import worker_pool as wp

    t0 = time.monotonic()
    runs = []
    with wp.WorkerPool(world=args.chips, backend=args.backend,
                       device=args.device) as pool:
        first = pool.submit("collectives_suite", topology=args.topology,
                            timeout=300)
        cold_s = time.monotonic() - t0
        ok = bool(first["ok"])
        for _ in range(max(0, args.repeat - 1)):
            t1 = time.monotonic()
            rep = pool.submit("collectives_suite", topology=args.topology,
                              timeout=120)
            runs.append(round(time.monotonic() - t1, 4))
            ok = (ok and bool(rep["ok"])
                  and rep["worker_pid"] == first["worker_pid"])
        hello = pool.bringup()
    report = {
        "ok": ok,
        "devices": first.get("devices"),
        "worker_pid": first.get("worker_pid"),
        "worker_warm_s": hello.get("warm_s"),
        "cold_suite_s": round(cold_s, 3),
        "warm_suite_s": runs,
        "collectives": {k: v.get("ok") for k, v in first.items()
                        if isinstance(v, dict) and "ok" in v},
    }
    if args.as_json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(f"worker {report['worker_pid']}: {report['devices']} "
              f"devices ({args.backend} on {args.device}), warm-up "
              f"{report['worker_warm_s']}s, cold suite "
              f"{report['cold_suite_s']}s, warm {report['warm_suite_s']}")
        print("TORCH SMOKE " + ("OK" if ok else "FAILED"))
    return 0 if ok else 1


def run_manifests(args: argparse.Namespace) -> int:
    from kind_tpu_sim_torch import manifests

    text = manifests.torch_multihost_manifest(
        args.accelerator, args.topology, num_slices=args.num_slices)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text)
        print(f"wrote {args.out}")
    else:
        print(text, end="")
    return 0


def serving_fleet_config() -> tuple:
    """(model config, serving config) of the reference's engine fleet:
    the tiny model (bf16 activations) in 4 slots of 128 positions, at
    most 64 requests queued an engine."""
    from kind_tpu_sim_torch.models import transformer as tf
    from kind_tpu_sim_torch.models.serving import ServingConfig

    cfg = tf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                         d_ff=64, max_seq=128)
    return cfg, ServingConfig(max_slots=4, max_len=128, chunk=8,
                              max_queue=64)


def fleet_tenancy(args: argparse.Namespace):
    """The ``TenancyConfig`` of ``--tenancy`` (the stock three tenants,
    unisolated under ``--no-tenant-isolation``), or None."""
    from kind_tpu_sim_torch import fleet

    if args.no_tenant_isolation and not args.tenancy:
        raise SystemExit("--no-tenant-isolation needs --tenancy")
    if not args.tenancy:
        return None
    tenancy = fleet.default_tenancy()
    if args.no_tenant_isolation:
        tenancy = dataclasses.replace(tenancy, isolation=False)
    return tenancy


def fleet_zoo(args: argparse.Namespace):
    """(the ``ZooConfig`` of ``--zoo``, the generations of
    ``--generations``): the default zoo or None, and the names or None
    (a name the registry lacks exits with the reference's "unknown
    generation"); a zoo without ``--generations`` takes the default
    generation, the one each of its models fits."""
    from kind_tpu_sim_torch import fleet

    zoo = fleet.default_zoo() if args.zoo else None
    generations = None
    if args.generations:
        generations = tuple(g.strip() for g in args.generations.split(",")
                            if g.strip())
        for gen in generations:
            try:
                fleet.resolve_generation(gen)
            except ValueError as exc:
                raise SystemExit(str(exc)) from None
    elif zoo is not None:
        generations = (fleet.DEFAULT_GENERATION,)
    return zoo, generations


def fleet_trace(args: argparse.Namespace, seed: int) -> list:
    """The trace ``fleet`` serves: ``--trace-file``'s, else generated
    from the flags and ``seed``."""
    from kind_tpu_sim_torch import fleet

    tenancy = fleet_tenancy(args)
    if args.trace_file:
        return fleet.load_trace(args.trace_file)
    return fleet.generate_trace(fleet.WorkloadSpec(
        process=args.process, rps=args.rps, n_requests=args.requests,
        shared_prefix_frac=args.shared_prefix_frac,
        prefix_groups=args.prefix_groups, deadline_s=args.deadline_s,
        tenancy=tenancy, zoo=fleet_zoo(args)[0]), seed)


def fleet_training_config(args: argparse.Namespace):
    """``--train N``: N ``llm{i}`` gangs of 2x8 chips (a row of two
    hosts, which tiles beside the serving replicas' whole hosts on the
    default 4x8 inventory), 80 steps each; None without it."""
    from kind_tpu_sim_torch import fleet

    if not args.train:
        return None
    if not args.sched:
        raise SystemExit(
            "--train needs --sched: training gangs are scheduler-placed "
            "workloads")
    return fleet.TrainingConfig(gangs=tuple(
        fleet.TrainingGangConfig(name=f"llm{i}", topology="2x8",
                                 total_steps=80)
        for i in range(args.train)))


def fleet_disagg(args: argparse.Namespace):
    """The ``DisaggConfig`` of ``--disagg P:D`` (with ``--disagg-tier``
    and ``--disagg-dtype``), or None."""
    from kind_tpu_sim_torch import fleet

    if not args.disagg:
        return None
    if args.sched:
        raise SystemExit("--disagg is incompatible with --sched (phased "
                         "pools pin their own placements)")
    if args.engine == "serving":
        raise SystemExit("--disagg needs the analytic sim engine (serving "
                         "replicas have no phase split yet)")
    return fleet.DisaggConfig.parse(args.disagg, tier=args.disagg_tier,
                                    dtype=args.disagg_dtype)


def fleet_config(args: argparse.Namespace):
    """The ``FleetConfig`` of ``fleet run``'s flags (the detector with its
    defaults under ``--health``; ``--disagg``'s pools in place of
    ``--replicas``; ``--zoo`` on the analytic replicas only)."""
    from kind_tpu_sim_torch import fleet

    zoo, generations = fleet_zoo(args)
    if zoo is not None:
        if args.disagg:
            raise SystemExit("--zoo does not compose with --disagg "
                             "(phase pools price off the anchor)")
        if args.engine == "serving":
            raise SystemExit("--zoo needs the analytic sim engine "
                             "(calibrated zoo replicas)")
    disagg = fleet_disagg(args)
    replicas = args.replicas
    if disagg is not None:
        replicas = disagg.prefill_replicas + disagg.decode_replicas
    return fleet.FleetConfig(
        replicas=replicas, policy=args.policy, tick_s=args.tick_s,
        autoscale=args.autoscale, eval_every_s=args.eval_every_s,
        slo=fleet.SloPolicy(ttft_s=args.ttft_slo, e2e_s=args.e2e_slo,
                            itl_s=args.itl_slo),
        autoscaler=fleet.AutoscalerConfig(min_replicas=replicas,
                                          max_replicas=args.max_replicas),
        sched=(fleet.FleetSchedConfig(policy=args.sched_policy)
               if args.sched else None),
        health=fleet.DetectorConfig.from_env() if args.health else None,
        overload=fleet.OverloadConfig() if args.overload else None,
        training=fleet_training_config(args), disagg=disagg,
        tenancy=fleet_tenancy(args), zoo=zoo, generations=generations,
        audit_frac=args.audit_frac,
        event_core=False if args.no_event_core else None)


def fleet_calibrate(args: argparse.Namespace) -> int:
    """``fleet calibrate --bench PATH [--out PATH] [--json]``: the cost
    model's calibration from a bench artifact, written to ``--out``
    (default: the H100's file), each phase's error printed; exit 1 while
    any error is over the simulator's 0.15."""
    import pathlib

    from kind_tpu_sim_torch.fleet import costmodel

    if not args.bench:
        raise SystemExit(
            "fleet calibrate requires --bench BENCH.json (a `python -m "
            "kind_tpu_sim_torch.bench --model-only` artifact with the "
            "roofline keys)")
    repo = pathlib.Path(__file__).resolve().parents[1]
    bench_path = next(
        (q for q in (pathlib.Path(args.bench), repo / args.bench,
                     repo / "bench_history" / args.bench)
         if q.is_file()), None)
    if bench_path is None:
        raise SystemExit(
            f"bench artifact {args.bench!r} not found (looked in cwd, "
            f"{repo} and {repo / 'bench_history'})")
    with open(bench_path, encoding="utf-8") as fh:
        bench = json.load(fh)
    cal = costmodel.calibrate(bench)
    out_path = args.out or str(costmodel.DEFAULT_CALIBRATION)
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(cal, fh, indent=1, sort_keys=True)
        fh.write("\n")
    errors = costmodel.CostModel(cal).errors()
    if args.as_json:
        print(json.dumps(cal, sort_keys=True))
    else:
        print(f"calibration: {cal['model']} on {cal['chip']} "
              f"(schema {cal['schema']}) -> {out_path}")
        for phase in sorted(errors):
            print(f"  {phase}: error_frac {errors[phase]}")
    return 0 if max(errors.values()) <= costmodel.MAX_ERROR_FRAC else 1


def _tune_output(report: dict, args: argparse.Namespace) -> int:
    """Shared ``fleet tune`` / ``globe tune`` output: the report file,
    the winner spec file, JSON or the human summary ending ``TUNE OK``
    or ``TUNE FAILED``; exit 0 or 1."""
    from kind_tpu_sim_torch import tune

    text = json.dumps(report, sort_keys=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    if args.spec_out:
        spec_text = tune.winner_spec_text(report)
        if spec_text is None:
            print("no winner to write", file=sys.stderr)
        else:
            with open(args.spec_out, "w", encoding="utf-8") as fh:
                fh.write(spec_text + "\n")
            print(f"winner spec -> {args.spec_out}")
    if args.as_json:
        print(text)
    else:
        front = report["pareto"]["front"]
        print(f"tune[{report['target']}]: "
              f"{report['distinct_candidates']} candidate(s) from "
              f"budget {report['budget']}, seed {report['seed']}, "
              f"{report['evaluations']} evaluation(s)")
        print(f"  finalists {report['finalists']}  "
              f"pareto front {len(front)} point(s)")
        for p in front:
            print(f"    #{p['index']}: cost {p['cost_chip_s']} "
                  f"chip-s  goodput {p['goodput_tok_s']} tok/s  "
                  f"attainment {p['attainment']}")
        if "chaos" in report:
            ch = report["chaos"]
            print(f"  chaos: {ch['budget']} schedule(s), front "
                  f"survivors {ch['front_survivors']}")
        winner = report.get("winner")
        if winner is not None:
            cand = json.dumps(winner["candidate"], sort_keys=True)
            print(f"  winner #{winner['index']}: {cand}")
        print("TUNE " + ("OK" if report["ok"] else "FAILED"))
    return 0 if report["ok"] else 1


def _replay_tune_spec(path: str) -> int:
    from kind_tpu_sim_torch import tune

    with open(path, "r", encoding="utf-8") as fh:
        spec = json.load(fh)
    metrics = tune.replay(spec)
    print(json.dumps(metrics, sort_keys=True))
    return 0 if metrics.get("ok") else 1


def fleet_tune(args: argparse.Namespace) -> int:
    """``fleet tune``: seeded successive-halving search over the fleet
    design space (``--zoo``: the generation and placement space of the
    port's registry; ``--sdc``: the audit space; ``--ratios``: the
    disagg ratios) against this workload and SLO, on analytic fleets
    priced from the calibration. The report is the same across runs and
    ``--tune-workers`` counts of one tune seed."""
    from kind_tpu_sim_torch import fleet, tune

    if args.device is not None:
        raise SystemExit(
            "fleet tune scores analytic fleets, which do no device work: "
            "drop --device")
    if args.replay_spec:
        return _replay_tune_spec(args.replay_spec)
    seed = fleet.resolve_seed(args.seed)
    tenancy = fleet.default_tenancy() if args.tenancy else None
    zoo = fleet.default_zoo() if args.zoo else None
    workload = fleet.WorkloadSpec(
        process=args.process, rps=args.rps,
        n_requests=args.requests,
        shared_prefix_frac=args.shared_prefix_frac,
        prefix_groups=args.prefix_groups,
        deadline_s=args.deadline_s,
        tenancy=tenancy, zoo=zoo)
    slo = fleet.SloPolicy(ttft_s=args.ttft_slo,
                          e2e_s=args.e2e_slo,
                          itl_s=args.itl_slo)
    if args.zoo:
        space = tune.zoo_space()
    elif args.sdc:
        space = tune.sdc_space()
    elif args.ratios:
        space = tune.ratio_space(
            tuple(args.ratios.split(",")), policy=args.policy)
    else:
        space = tune.default_fleet_space()
    report = tune.tune(
        space, workload, slo, seed=args.tune_seed,
        budget=args.budget, workers=args.tune_workers,
        chaos_budget=args.chaos_budget, workload_seed=seed)
    return _tune_output(report, args)


def globe_tune(args: argparse.Namespace) -> int:
    """``globe tune``: seeded successive-halving search over the global
    design space (zones, cells, replicas, spill headroom) against this
    workload."""
    from kind_tpu_sim_torch import globe, tune

    if args.replay_spec:
        return _replay_tune_spec(args.replay_spec)
    seed = globe.resolve_seed(args.seed)
    workload = globe.GlobeWorkloadSpec(
        process=args.process, rps=args.rps,
        n_per_zone=args.requests,
        diurnal_period_s=args.diurnal_period_s)
    slo = globe.GlobeConfig().slo
    space = tune.default_globe_space()
    report = tune.tune(
        space, workload, slo, seed=args.tune_seed,
        budget=args.budget, workers=args.tune_workers,
        chaos_budget=args.chaos_budget, workload_seed=seed,
        max_virtual_s=args.max_virtual_s)
    return _tune_output(report, args)


def run_fleet(args: argparse.Namespace) -> int:
    """``fleet run`` / ``fleet trace`` / ``fleet calibrate``. A run's JSON
    report (sorted keys) is the same for two runs of one seed."""
    from kind_tpu_sim_torch import fleet

    if args.action == "calibrate":
        return fleet_calibrate(args)
    if args.action == "tune":
        return fleet_tune(args)
    if args.engine == "sim" and args.device is not None:
        raise SystemExit(
            "--engine sim runs the analytic replicas, which do no device "
            "work: drop --device")
    seed = fleet.resolve_seed(args.seed)
    trace = fleet_trace(args, seed)
    if args.save_trace:
        fleet.save_trace(args.save_trace, trace)
    if args.action == "trace":
        if not args.save_trace:
            for req in trace:
                print(json.dumps(req.as_dict(), sort_keys=True))
        else:
            print(f"wrote {len(trace)} requests to {args.save_trace}")
        return 0
    fc = fleet_config(args)
    replicas = fc.replicas
    if args.engine == "sim":
        dev = None
        cal = None
        if fc.disagg is not None and args.calibration:
            cal = fleet.load_calibration(args.calibration)
        sim = fleet.FleetSim(fc, trace, calibration=cal)
    else:
        import torch

        from kind_tpu_sim_torch.device import resolve
        from kind_tpu_sim_torch.models import transformer as tf

        dev = resolve(args.device or "cuda")
        cfg, sc = serving_fleet_config()
        bad = [r for r in trace
               if max(r.prompt) >= cfg.vocab_size
               or len(r.prompt) + r.max_new > sc.max_len]
        if bad:
            raise SystemExit(
                f"{len(bad)} trace request(s) exceed the serving engine's "
                f"vocab={cfg.vocab_size}/max_len={sc.max_len} envelope; "
                "regenerate the trace within it")
        params = tf.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        sim = fleet.engine_fleet(fc, trace, params, cfg, sc, device=dev)
    profile = None
    if args.profile:
        from kind_tpu_sim_torch import profiling

        profile = profiling.profile_fleet_run(sim)
        report = profile.pop("report")
    else:
        report = sim.run()
    report["seed"] = seed
    report["engine"] = args.engine
    if profile is not None:
        # wall-clock extras, present only under --profile
        report["profile"] = profile
    text = json.dumps(report, sort_keys=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    if args.as_json:
        print(text)
    else:
        slo = report["slo"]
        where = f" on {dev}" if dev is not None else ""
        print(f"fleet: {report['requests']} requests, {args.policy} over "
              f"{replicas} replica(s), seed {seed}, engine "
              f"{args.engine}{where}")
        if "disagg" in report:
            d = report["disagg"]
            kv = d["kv"]
            errs = d["calibration_errors"]
            worst = max(errs.values()) if errs else None
            print(f"  disagg: {d['config']['prefill_replicas']}P:"
                  f"{d['config']['decode_replicas']}D "
                  f"({d['config']['dtype']}, {kv['tier']})  kv handoffs "
                  f"{kv['handoffs']}  {kv['bytes_total']} B in "
                  f"{kv['transfer_s_total']}s  worst calibration error "
                  f"{worst}")
        print(f"  attainment {slo['attainment']}  goodput "
              f"{slo.get('goodput_tok_s')} tok/s  throughput "
              f"{slo.get('throughput_tok_s')} tok/s")
        ttft, e2e = slo["ttft"], slo["e2e"]
        if ttft.get("count"):
            print(f"  ttft p50/p90/p99 {ttft['p50_s']}/{ttft['p90_s']}/"
                  f"{ttft['p99_s']} s  e2e p99 {e2e['p99_s']} s")
        print(f"  shed {slo['shed']}  deadline_exceeded "
              f"{slo['deadline_exceeded']}  requeues "
              f"{report['router']['requeues']}")
        if "autoscaler" in report:
            a = report["autoscaler"]
            print(f"  autoscaler: +{a['scale_ups']}/-{a['scale_downs']} "
                  f"(warmup {a['warmup_s']}s)")
        if "overload" in report:
            o = report["overload"]["counters"]
            print(f"  overload: retries {o.get('retries_scheduled', 0)} "
                  f"(suppressed {o.get('retries_suppressed', 0)})  hedges "
                  f"{o.get('hedges_issued', 0)} (wins "
                  f"{o.get('hedge_wins', 0)}, cancelled "
                  f"{o.get('hedge_cancels', 0)})  brownout level "
                  f"{report['overload']['brownout']['level']}")
        if "scheduler" in report:
            s = report["scheduler"]
            ttr = s["time_to_routable"]
            print(f"  scheduler ({s['policy']}): time-to-routable mean/max "
                  f"{ttr['mean_s']}/{ttr['max_s']} s over {ttr['count']} "
                  f"placement(s) (flat warmup {s['flat_warmup_s']}s)")
        if "health" in report:
            h = report["health"]["counters"]
            print(f"  health: suspicions {h.get('suspicions', 0)}  "
                  f"quarantines {h.get('quarantines', 0)}  restores "
                  f"{h.get('restores', 0)}  probes "
                  f"{h.get('probe_dispatches', 0)}")
        if "tenancy" in report:
            ten = report["tenancy"]
            sheds = sum(t["quota_shed"] + t["token_shed"]
                        for t in ten["tenants"].values())
            fq = report["router"].get("fair_queue", {})
            print(f"  tenancy: {len(ten['tenants'])} tenant(s)  isolation "
                  f"{ten['isolation']}  quota/token sheds {sheds}  drr "
                  f"rounds {fq.get('rounds', 0)}")
            for name in sorted(ten["tenants"]):
                t = ten["tenants"][name]
                e2e = ten["slo"].get(name, {}).get("e2e", {})
                p99 = e2e.get("p99_s") if e2e.get("count") else None
                print(f"    {name} ({t['qos']}): admitted {t['admitted']}  "
                      f"shed {t['quota_shed'] + t['token_shed']}  e2e p99 "
                      f"{p99} s")
        if "integrity" in report:
            c = report["integrity"]["counters"]
            print(f"  integrity: audits {c.get('audits', 0)}  copies "
                  f"{c.get('audit_copies', 0)}  mismatches "
                  f"{c.get('audit_mismatches', 0)}  quarantined "
                  f"{len(report['integrity']['detections'])}")
        if "training" in report:
            t = report["training"]
            print(f"  training: {len(t['gangs'])} gang(s)  all_done "
                  f"{t['all_done']}  ledger_ok {t['ledger_ok']}  lost "
                  f"{t['lost_steps']}  checkpoints {t['checkpoint_writes']}")
        if "profile" in report:
            p = report["profile"]
            print(f"  profile: {p['wall_s']}s wall  {p['events_per_s']} "
                  "events/s")
            for name, lane in sorted(p["lanes"].items(),
                                     key=lambda kv: -kv[1]["self_s"]):
                if lane["events"] or lane["self_s"]:
                    print(f"    lane {name}: {lane['events']} event(s)  "
                          f"self {lane['self_s']}s")
            for row in p["top_functions"][:5]:
                print(f"    hot {row['function']}  cum "
                      f"{row['cumulative_s']}s  self {row['self_s']}s  "
                      f"x{row['calls']}")
        if args.out:
            print(f"  report -> {args.out}")
        print("FLEET RUN " + ("OK" if report["ok"] else "FAILED"))
    return 0 if report["ok"] else 1


def run_chaos(args: argparse.Namespace) -> int:
    """``chaos run``: the scenarios on ``--device``; ``chaos soak``:
    seeded runs drawn from the registry's pool; ``chaos fuzz``: the
    seeded campaign."""
    from kind_tpu_sim_torch import chaos
    from kind_tpu_sim_torch.scenarios import registry

    if args.list_scenarios:
        rows = registry.listing()
        if args.as_json:
            print(json.dumps(rows, sort_keys=True))
        else:
            for row in rows:
                tags = "".join(
                    f" [{t}]" for t, on in
                    (("slow", row["slow"]), ("device", row["needs_jax"]),
                     ("replay", row["replayable"]))
                    if on)
                print(f"  {row['name']:<24} {row['description']}"
                      f"{tags}")
        return 0
    if args.action == "fuzz":
        return run_chaos_fuzz(args)
    if args.action == "soak":
        report = chaos.soak(iterations=args.iterations, seed=args.seed,
                            include_slow=args.include_slow,
                            device=args.device)
        if args.as_json:
            print(json.dumps(report, sort_keys=True))
        else:
            for run in report["runs"]:
                print(f"  {run['scenario']:<24} seed={run['seed']:<12}"
                      f" {'OK' if run['ok'] else 'FAILED'}")
            print(f"CHAOS SOAK ({report['iterations']} runs, seed "
                  f"{report['seed']}) "
                  + ("OK" if report["ok"] else
                     f"FAILED ({report['failures']} failures)"))
        return 0 if report["ok"] else 1
    if not args.scenario:
        print("available scenarios (chaos run --scenario NAME):")
        for row in registry.listing():
            tag = " [slow]" if row["slow"] else ""
            print(f"  {row['name']:<24} {row['description']}{tag}")
        return 0
    if args.scenario == "all":
        names = chaos.scenario_names(include_slow=args.include_slow)
    elif args.scenario in chaos.SCENARIOS:
        names = [args.scenario]
    else:
        raise SystemExit(
            f"unknown scenario {args.scenario!r}; the port runs "
            f"{', '.join(sorted(chaos.SCENARIOS))} (the simulator's other "
            "scenarios: python -m kind_tpu_sim chaos run)")
    reports = [chaos.run_scenario(n, seed=args.seed, device=args.device)
               for n in names]
    ok = all(r["ok"] for r in reports)
    if args.as_json:
        out = reports[0] if len(reports) == 1 else {
            "ok": ok, "scenarios": reports}
        print(json.dumps(out, sort_keys=True))
    else:
        for rep in reports:
            events = ", ".join(
                f"{k}={v}" for k, v in
                sorted(rep.get("recovery_events", {}).items())) or "-"
            print(f"  {rep['scenario']:<24} seed={rep['seed']} "
                  f"{'OK' if rep['ok'] else 'FAILED'}  [{events}]")
        print("CHAOS RUN " + ("OK" if ok else "FAILED"))
    return 0 if ok else 1


def run_chaos_fuzz(args: argparse.Namespace) -> int:
    """``chaos fuzz``: the seeded campaign. Composed multi-layer fault
    schedules, every run checked against the universal invariant set,
    violations shrunk to minimal repro specs; the report is a pure
    function of (budget, seed, max-faults) and the reference's for the
    same calibration and generation registry."""
    import os

    from kind_tpu_sim_torch.analysis import knobs
    from kind_tpu_sim_torch.scenarios import fuzz as fuzz_mod

    budget = (args.budget if args.budget is not None
              else knobs.get(knobs.FUZZ_BUDGET))
    max_faults = (args.max_faults if args.max_faults is not None
                  else knobs.get(knobs.FUZZ_MAX_FAULTS))
    seed = (args.seed if args.seed is not None
            else knobs.get(knobs.FUZZ_SEED))
    report = fuzz_mod.fuzz(
        budget=budget, seed=seed, max_faults=max_faults,
        inject_bug=args.inject_invariant_bug)
    if args.emit_repros and report["shrunk"]:
        os.makedirs(args.emit_repros, exist_ok=True)
        for repro in report["shrunk"]:
            path = os.path.join(args.emit_repros,
                                repro["spec"]["name"] + ".json")
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(repro, fh, sort_keys=True, indent=1)
                fh.write("\n")
            print(f"pinned repro: {path}", file=sys.stderr)
    if args.as_json:
        print(json.dumps(report, sort_keys=True))
    else:
        for run in report["runs"]:
            mark = "OK" if run["ok"] else "VIOLATION"
            kinds = ",".join(run["fault_kinds"]) or "-"
            print(f"  {run['name']:<16} {run['topology']:<6} "
                  f"{kinds:<48} {mark}")
            for v in run["violations"]:
                print(f"      {v['invariant']}: {v['detail']}")
        for repro in report["shrunk"]:
            print(f"  shrunk {repro['source']} -> "
                  f"{repro['spec']['name']} "
                  f"({len(repro['spec']['faults'])} faults, "
                  f"{repro['shrink_steps']} steps)")
        verdict = "OK" if report["ok"] else "FAILED"
        print(f"CHAOS FUZZ (budget {budget}, seed {seed}) {verdict}")
    return 0 if report["ok"] else 1


def run_analysis(args: argparse.Namespace) -> int:
    """``analysis replay``: run a target twice (``--runs``) under one
    seed and bisect any divergence of the event streams to the first
    differing event; without ``--scenario`` it lists the targets. The
    reference's ``lint``, ``contract`` and ``knobs`` are refused."""
    from kind_tpu_sim_torch.analysis import replaycheck

    if args.action != "replay":
        raise SystemExit(
            f"analysis {args.action} belongs to the reference's static "
            "linters and knob registry (ROADMAP Queue A item 6), which the "
            f"port does not carry yet (python -m kind_tpu_sim analysis "
            f"{args.action})")
    if not args.scenario:
        targets = replaycheck.list_targets()
        if args.as_json:
            print(json.dumps({"targets": targets}, sort_keys=True))
        else:
            print("replay targets (analysis replay --scenario NAME):")
            for t in targets:
                tag = ("[slow]" if t["slow"] else "") + (
                    "[injectable]" if t["injectable"] else "")
                print(f"  {t['name']:<28} {t['description']}"
                      + (f" {tag}" if tag else ""))
        return 0
    report = replaycheck.replay(args.scenario, seed=args.seed,
                                runs=args.runs, inject=args.inject)
    if args.as_json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(f"replay {report['target']}: seed {report['seed']}, "
              f"{report['runs']} runs, {report['events']} events, "
              f"digest {report['stream_digest'][:16]}")
        div = report.get("divergence")
        if div is not None:
            print(f"  FIRST DIVERGENT EVENT: #{div['index']} "
                  f"(stream {div['stream']}, run 0 vs run "
                  f"{report['diverged_run']})")
            for ctx in div["context"]:
                print("    shared: "
                      + json.dumps(ctx, sort_keys=True)[:120])
            print("    run 0:  " + json.dumps(
                div["a"], sort_keys=True)[:240])
            print("    run N:  " + json.dumps(
                div["b"], sort_keys=True)[:240])
        print("ANALYSIS REPLAY "
              + ("OK" if report["ok"] else "DIVERGED"))
    return 0 if report["ok"] else 1


def run_train(args: argparse.Namespace) -> int:
    """`train run` / `train plan`: the training-tenant simulator
    (docs/TRAINING.md). `run` co-schedules training gangs under a
    serving fleet on the cluster scheduler and reports throughput,
    checkpoint overhead, and the zero-lost-step ledger verdict;
    `plan` prints the checkpoint-cadence economics (write cost vs
    expected lost work under the assumed preemption MTBF)."""
    import dataclasses as _dc

    from kind_tpu_sim_torch import fleet
    from kind_tpu_sim_torch.fleet import training as tr_mod

    if args.action == "plan":
        gang = fleet.TrainingGangConfig(
            name="plan", total_steps=max(1, args.steps))
        step_s = (args.step_s if args.step_s is not None
                  else fleet.step_time_s(gang, gang.topology))
        write_s = tr_mod.resolve_ckpt_write_s()
        mtbf = tr_mod.resolve_mtbf_s(args.mtbf_s)
        opt = fleet.optimal_cadence_steps(step_s, write_s, mtbf)
        rows = sorted({1, max(1, opt // 4), opt,
                       max(1, opt * 4), max(1, args.steps)})
        report = {
            "step_s": round(step_s, 9),
            "checkpoint_write_s": write_s,
            "mtbf_s": mtbf,
            "optimal_cadence_steps": opt,
            "mesh": fleet.gang_mesh(gang.accelerator,
                                    gang.topology, gang.kind),
            "cadences": {
                str(c): fleet.expected_overhead(step_s, c,
                                                write_s, mtbf)
                for c in rows},
        }
        text = json.dumps(report, sort_keys=True)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as fh:
                fh.write(text + "\n")
        if args.as_json:
            print(text)
        else:
            print(f"train plan: step {report['step_s']}s, "
                  f"write {write_s}s, MTBF {mtbf}s -> optimal "
                  f"cadence {opt} step(s)")
            for c in rows:
                eo = report["cadences"][str(c)]
                mark = " <-- optimal" if c == opt else ""
                print(f"  every {c:>4}: write {eo['write_frac']}"
                      f"  lost {eo['lost_frac']}  total "
                      f"{eo['total_frac']}{mark}")
        return 0

    seed = fleet.resolve_seed(args.seed)
    cadence = args.cadence
    gangs = []
    if args.manifest:
        with open(args.manifest, encoding="utf-8") as fh:
            parsed = fleet.gangs_from_manifest(fh.read())
        if not parsed:
            raise SystemExit(
                f"{args.manifest}: no TPU training workloads "
                "found (need a google.com/tpu limit)")
        for g in parsed:
            gangs.append(_dc.replace(
                g, total_steps=args.steps,
                checkpoint_every=cadence,
                elastic=args.elastic))
    else:
        for i in range(args.gangs):
            gangs.append(fleet.TrainingGangConfig(
                name=f"llm{i}", total_steps=args.steps,
                checkpoint_every=cadence, elastic=args.elastic))
        for i in range(args.ising):
            gangs.append(fleet.ising_gang(
                f"ising{i}", total_steps=args.steps,
                checkpoint_every=cadence))
    pods = tuple(tuple(p.split(":", 1))
                 for p in args.pods.split(","))
    tc = fleet.TrainingConfig(gangs=tuple(gangs),
                              scavenge=args.elastic)
    spec = fleet.WorkloadSpec(
        process="poisson", rps=args.serving_rps,
        n_requests=args.requests, prompt_len=(8, 24),
        max_new=(4, 12))
    trace = fleet.generate_trace(spec, seed)
    fc = fleet.FleetConfig(
        replicas=args.replicas, policy="least-outstanding",
        slo=fleet.SloPolicy(ttft_s=1.0, e2e_s=5.0),
        sched=fleet.FleetSchedConfig(pods=pods), training=tc,
        event_core=(False if args.no_event_core else None))
    report = fleet.FleetSim(fc, trace).run()
    report["seed"] = seed
    text = json.dumps(report, sort_keys=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    if args.as_json:
        print(text)
    else:
        t = report["training"]
        print(f"train: {len(t['gangs'])} gang(s) under "
              f"{args.replicas} serving replica(s), seed {seed}")
        for name, g in t["gangs"].items():
            line = (f"  {name} [{g['config']['kind']}] "
                    f"{g['state']} {g['unique_steps']}/"
                    f"{g['config']['total_steps']} steps")
            if "work_per_s" in g:
                line += (f"  {g['work_per_s']} "
                         f"{g['work_unit']}/s")
            line += (f"  ckpt_overhead {g['overhead_frac']}"
                     f"  lost {g['lost_steps']}")
            print(line)
        print(f"  ledger_ok {t['ledger_ok']}  evictions "
              f"{t['evictions']}  checkpoints "
              f"{t['checkpoint_writes']}  serving attainment "
              f"{report['slo']['attainment']}")
        if args.out:
            print(f"  report -> {args.out}")
        print("TRAIN RUN " + ("OK" if report["ok"] else "FAILED"))
    return 0 if report["ok"] else 1


def run_sched(args: argparse.Namespace) -> int:
    """`sched run` / `sched trace`: the deterministic scheduler sim
    (docs/SCHED.md). The report is sorted-keys JSON of pure
    virtual-clock state — two runs of the same seed+config are
    byte-identical, the reproducibility contract `--seed` promises."""
    from kind_tpu_sim_torch import sched as sched_mod

    seed = sched_mod.resolve_seed(args.seed)
    pods = []
    for part in args.pods.split(","):
        part = part.strip()
        if not part:
            continue
        acc, _, topology = part.partition(":")
        if not topology:
            raise ValueError(
                f"malformed --pods entry {part!r} "
                "(want accelerator:topology)")
        pods.append((acc, topology))
    workload = sched_mod.SchedWorkloadSpec(n_gangs=args.gangs)
    if args.action == "trace":
        for req in sched_mod.generate_gangs(workload, seed):
            print(json.dumps(req.as_dict(), sort_keys=True))
        return 0
    policies = [p.strip() for p in args.policy.split(",")
                if p.strip()]
    manifest_gangs = []
    if args.manifest:
        with open(args.manifest, "r", encoding="utf-8") as fh:
            manifest_gangs = sched_mod.slice_requests_from_yaml(
                fh.read())
    sections = {}
    for policy in policies:
        cfg = sched_mod.SchedSimConfig(
            pods=tuple(pods),
            sched=sched_mod.SchedConfig(
                policy=policy,
                preemption=not args.no_preemption,
                defrag=not args.no_defrag),
            workload=workload)
        if manifest_gangs:
            # manifest workloads submit at t=0, ahead of the seeded
            # stream — the kube manifests drive the same sim
            inv = sched_mod.build_inventory(list(cfg.pods))
            pre = sched_mod.ClusterScheduler(inv, cfg.sched)
            for req in manifest_gangs:
                pre.submit(req, 0.0)
            pre.step(0.0)
            sections[f"{policy}:manifest"] = pre.report()
        sections[policy] = sched_mod.run_sched_sim(cfg, seed)
    ok = all(s.get("ok", True) for s in sections.values())
    report = {"seed": seed, "pods": [list(p) for p in pods],
              "policies": sections, "ok": ok}
    text = json.dumps(report, sort_keys=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    if args.events:
        for policy in policies:
            for ev in sections[policy]["events"]:
                print(json.dumps(sched_mod.k8s_event(ev),
                                 sort_keys=True))
        return 0 if ok else 1
    if args.as_json:
        print(text)
    else:
        for policy in policies:
            sec = sections[policy]
            ttr = sec["time_to_routable"]
            counts = sec["event_counts"]
            print(f"  {policy:<10} gangs {sec['scheduled']}/"
                  f"{sec['gangs']}  ttr mean/max "
                  f"{ttr['mean_s']}/{ttr['max_s']} s  "
                  f"preemptions {counts.get('Preempted', 0)}  "
                  f"migrations {counts.get('Migrated', 0)}  "
                  f"failed-attempts "
                  f"{sec['sched_counters'].get('failed_scheduling', 0)}")
            man = sections.get(f"{policy}:manifest")
            if man is not None:
                mcounts = man["event_counts"]
                total = len(man["bound"]) + len(man["pending"])
                print(f"  {policy:<10} manifest gangs "
                      f"{len(man['bound'])}/{total} bound at t=0  "
                      f"scheduled {mcounts.get('Scheduled', 0)}  "
                      f"failed-attempts "
                      f"{mcounts.get('FailedScheduling', 0)}")
        if args.out:
            print(f"  report -> {args.out}")
        print(f"SCHED RUN (seed {seed}) "
              + ("OK" if ok else "FAILED"))
    return 0 if ok else 1


def run_globe(args: argparse.Namespace) -> int:
    """``globe run`` / ``globe trace``: the fleet-of-fleets simulator.
    Per-zone seeded traffic through the global front door over cells
    stepped in lockstep on one virtual clock, or with ``--shards N``
    (or KIND_TPU_SIM_GLOBE_SHARDS) above 1 across N cold worker
    processes, with the same report; the JSON report (sorted keys) is
    the same for two runs of one seed and config. ``globe tune`` is
    refused."""
    from kind_tpu_sim_torch import globe
    from kind_tpu_sim_torch.fleet.tenancy import default_tenancy

    if args.action == "tune":
        return globe_tune(args)
    seed = globe.resolve_seed(args.seed)
    if args.zones < 1 or args.zones > 26:
        raise SystemExit("--zones must be in [1, 26]")
    zones = tuple(f"zone-{chr(ord('a') + i)}"
                  for i in range(args.zones))
    planner = (globe.PlannerConfig(spot_budget=args.spot_budget)
               if args.spot_budget is not None else None)
    cfg = globe.GlobeConfig(
        zones=zones,
        cells_per_zone=args.cells_per_zone,
        replicas_per_cell=args.replicas,
        policy=args.policy,
        tick_s=args.tick_s,
        max_virtual_s=args.max_virtual_s,
        sched=not args.no_sched,
        autoscale=bool(args.autoscale
                       or args.spot_budget is not None),
        frontdoor=globe.FrontDoorConfig(
            spill_headroom=args.spill_headroom),
        planner=planner,
        overload=(globe.OverloadConfig()
                  if args.overload else None),
        tenancy=(default_tenancy()
                 if args.tenancy else None),
        workload=globe.GlobeWorkloadSpec(
            process=args.process, rps=args.rps,
            n_per_zone=args.requests,
            diurnal_period_s=args.diurnal_period_s),
        event_core=(False if args.no_event_core else None))
    if args.trace_file:
        traces = globe.load_globe_trace(args.trace_file)
    else:
        traces = globe.generate_globe_traces(cfg, seed)
    if args.save_trace:
        globe.save_globe_trace(args.save_trace, traces)
    if args.action == "trace":
        if not args.save_trace:
            for zone in sorted(traces):
                for req in traces[zone]:
                    d = req.as_dict()
                    d["origin"] = zone
                    print(json.dumps(d, sort_keys=True))
        else:
            n = sum(len(t) for t in traces.values())
            print(f"wrote {n} requests ({len(traces)} zones) to "
                  f"{args.save_trace}")
        return 0

    n_shards = globe.resolve_shards(args.shards)
    if n_shards > 1:
        sim = globe.ShardedGlobeSim(cfg, traces=traces, seed=seed,
                                    shards=n_shards)
    else:
        sim = globe.GlobeSim(cfg, traces=traces, seed=seed)
    report = sim.run()
    text = json.dumps(report, sort_keys=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    if args.as_json:
        print(text)
    else:
        slo = report["global_slo"]
        print(f"globe: {report['requests']} requests over "
              f"{len(cfg.zones)} zone(s) x "
              f"{cfg.cells_per_zone} cell(s), seed {seed}")
        print(f"  global attainment {slo['attainment']}  "
              f"goodput {slo.get('goodput_tok_s')} tok/s  "
              f"shed {slo['shed']}")
        fd = report["frontdoor"]
        print(f"  front door: routed {fd['routed']}  "
              f"spilled {fd['spilled']}  "
              f"affinity hits {fd['affinity_hits']}  "
              f"served-in-origin-zone "
              f"{report['served_in_origin_zone']}")
        for zone in cfg.zones:
            z = report["zones"][zone]
            ttft = z["slo"]["ttft"]
            print(f"  {zone}: {z['requests']} req  "
                  f"spilled-out {z['spilled_out']}  "
                  f"attainment {z['slo']['attainment']}  "
                  f"ttft p99 {ttft.get('p99_s')} s")
        if "tenancy" in report:
            ten = report["tenancy"]
            sheds = sum(t["quota_shed"] + t["token_shed"]
                        for t in ten["tenants"].values())
            print(f"  tenancy: {len(ten['tenants'])} tenant(s)  "
                  f"isolation {ten['isolation']}  "
                  f"front-door quota/token sheds {sheds}")
        if "planner" in report:
            p = report["planner"]
            print(f"  planner: spot budget {p['spot_budget']} "
                  f"(left {p['budget_left']})  grants "
                  f"{sum(1 for e in p['events'] if e['action'] == 'grant')}  "
                  f"reclaims "
                  f"{sum(1 for e in p['events'] if e['action'] == 'reclaim')}")
        if args.out:
            print(f"  report -> {args.out}")
        print("GLOBE RUN " + ("OK" if report["ok"] else "FAILED"))
    return 0 if report["ok"] else 1


def run_health(args: argparse.Namespace) -> int:
    """`health knobs` / `health demo`: the gray-failure detector
    surface (docs/HEALTH.md). knobs prints the resolved
    KIND_TPU_SIM_HEALTH_* configuration; demo runs a seeded
    synthetic straggler through the phi-accrual detector and asserts
    the full quarantine -> probe -> restore round-trip — same seed,
    byte-identical report."""
    from kind_tpu_sim_torch import health

    if args.action == "knobs":
        cfg = health.DetectorConfig.from_env()
        if args.as_json:
            print(json.dumps(cfg.as_dict(), sort_keys=True))
        else:
            for key, value in sorted(cfg.as_dict().items()):
                print(f"  {key:<20} {value}")
        return 0
    from kind_tpu_sim_torch.chaos import resolve_seed

    report = health.detection_demo(
        seed=resolve_seed(args.seed), components=args.components,
        samples=args.samples)
    if args.as_json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(f"health demo: {args.components} components, "
              f"{args.samples} samples, straggler "
              f"{report['straggler']} x{report['factor']}")
        for ev in report["events"]:
            extra = ""
            if "phi" in ev:
                extra = f" (phi {ev['phi']})"
            print(f"  t={ev['at_s']:<6} {ev['component']:<10} "
                  f"{ev['transition']}{extra}")
        print("HEALTH DEMO " + ("OK" if report["ok"] else "FAILED"))
    return 0 if report["ok"] else 1


# ---------------------------------------------------------------------
# the cluster layer: create, delete, load, status and the chaos levers


def config_from_args(args: argparse.Namespace):
    """The ``SimConfig`` of a cluster command's flags."""
    kwargs = dict(
        registry_port=args.registry_port,
        cluster_name=args.cluster_name,
        runtime=args.runtime,
        verbose=args.verbose,
    )
    if args.command == "create":
        kwargs.update(
            vendor=args.vendor,
            accelerator=args.accelerator,
            tpu_topology=args.topology,
            num_slices=args.num_slices,
            capacity_mode=args.capacity_mode,
            gpu_workers=args.gpu_workers,
            gpus_per_node=args.gpus_per_node,
        )
    elif args.command == "chaos":
        kwargs.update(
            accelerator=args.accelerator,
            tpu_topology=args.topology,
            num_slices=args.num_slices,
        )
    if getattr(args, "image_name", None):
        kwargs["image_name"] = args.image_name
    return config.SimConfig(**kwargs)


class Simulator:
    """Wires the cluster layers together for one command (the
    reference's ``kind_tpu_sim/cli.py:Simulator``). Without ``--runtime
    fake`` it needs ``kind`` and ``kubectl`` on the PATH and raises
    naming the one that is missing; it never falls back to the fake
    runtime."""

    def __init__(self, cfg, executor=None):
        from kind_tpu_sim_torch.cluster import ClusterManager
        from kind_tpu_sim_torch.metrics import PhaseTimer
        from kind_tpu_sim_torch.plugin import PluginManager
        from kind_tpu_sim_torch.registry import LocalRegistry
        from kind_tpu_sim_torch.runtime import (detect_runtime,
                                                required_binaries)
        from kind_tpu_sim_torch.utils.shell import SystemExecutor

        self.cfg = cfg
        if executor is None:
            if cfg.runtime == "fake":
                from kind_tpu_sim_torch.fakes import dry_run_executor

                executor = dry_run_executor(cfg)
            else:
                executor = SystemExecutor()
        self.executor = executor
        for binary in required_binaries(cfg.runtime):
            if not executor.have(binary):
                raise RuntimeError(
                    f"required binary {binary!r} not found on PATH")
        self.runtime = detect_runtime(executor, prefer=cfg.runtime)
        if cfg.runtime != "fake":
            self.runtime.configure_environment()
        self.registry = LocalRegistry(cfg, self.runtime)
        self.cluster = ClusterManager(cfg, self.runtime, self.registry)
        self.plugin = PluginManager(cfg, self.runtime, self.registry,
                                    self.cluster)
        self.timer = PhaseTimer()

    def create(self, skip_plugin: bool = False) -> None:
        cfg = self.cfg
        if skip_plugin and cfg.capacity_mode != "patch":
            raise RuntimeError(
                "--skip-plugin leaves no capacity source; "
                "use --capacity-mode=patch with it")
        with self.timer.phase("registry"):
            self.registry.start()
        with self.timer.phase("cluster-create"):
            self.cluster.create()
        if not skip_plugin:
            with self.timer.phase("plugin-build"):
                image = self.plugin.build(cfg.vendor)
            with self.timer.phase("plugin-deploy"):
                self.plugin.deploy(cfg.vendor, image)
        if cfg.vendor == "tpu":
            s = cfg.slice
            prefix = (f"{cfg.num_slices} x " if cfg.num_slices > 1
                      else "")
            _cluster_log.info(
                "simulated %s%s slice%s ready: topology %s, %d workers"
                " x %d google.com/tpu", prefix, s.accelerator_type,
                "s" if cfg.num_slices > 1 else "",
                topo.format_topology(s.dims), cfg.workers,
                s.chips_per_host)
        print(f"Simulated {cfg.vendor} kind cluster is ready "
              f"('{cfg.cluster_name}')")
        print("create pipeline timing:")
        print(self.timer.report())

    def delete(self) -> None:
        self.cluster.delete()
        self.registry.delete()

    def load(self) -> None:
        self.cluster.load_image(self.cfg.image_name)

    def chaos(self, action: str, node: Optional[str] = None,
              worker: Optional[int] = None,
              devices: Optional[Sequence[str]] = None) -> None:
        from kind_tpu_sim_torch.chaos import ChaosManager

        mgr = ChaosManager(self.cfg, self.runtime, self.cluster)
        target = mgr.resolve_node(node, worker)
        if action == "fail":
            mgr.fail_devices(target, list(devices or []))
        elif action == "heal":
            mgr.heal(target)
        elif action == "kill-node":
            mgr.kill_node(target)
        elif action == "start-node":
            mgr.start_node(target)

    def status(self, as_json: bool = False) -> dict:
        from kind_tpu_sim_torch.metrics import ready_latency_summary
        from kind_tpu_sim_torch.runtime import kubectl

        nodes_json = kubectl(self.executor, "get", "nodes", "-o",
                             "json").stdout
        pods_json = kubectl(self.executor, "get", "pods", "-A", "-o",
                            "json").stdout
        nodes = json.loads(nodes_json).get("items", [])
        report: dict = {"cluster": self.cfg.cluster_name, "nodes": []}
        for node in nodes:
            meta = node.get("metadata", {})
            labels = meta.get("labels", {})
            capacity = node.get("status", {}).get("capacity", {})
            report["nodes"].append({
                "name": meta.get("name"),
                "accelerators": {
                    k: v for k, v in capacity.items()
                    if k in config.RESOURCE_BY_VENDOR.values()
                },
                "topology": labels.get(topo.LABEL_TOPOLOGY),
                "worker-id": labels.get(topo.LABEL_WORKER_ID),
                "host-coord": labels.get(topo.LABEL_HOST_COORD),
            })
        report["ready_latency"] = ready_latency_summary(pods_json)
        if as_json:
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            for entry in report["nodes"]:
                accel = ", ".join(
                    f"{k}={v}" for k, v in entry["accelerators"].items()
                ) or "-"
                extra = ""
                if entry["worker-id"] is not None:
                    extra = (f"  worker={entry['worker-id']} "
                             f"coord={entry['host-coord']} "
                             f"topo={entry['topology']}")
                print(f"{entry['name']}: {accel}{extra}")
            lat = report["ready_latency"]
            if lat.get("count"):
                print(f"pod schedule-to-Ready: p50={lat['p50_s']}s "
                      f"max={lat['max_s']}s over {lat['count']} pods")
        return report


_cluster_log = logging.getLogger("kind-tpu-sim-torch")


def run_cluster(args: argparse.Namespace) -> int:
    """``create | delete | load | status`` and ``chaos fail | heal |
    kill-node | start-node``: the cluster layer over docker or podman,
    kind and kubectl, or over the fake runtime's recorded command stream
    (``--runtime fake``; with ``-v`` the stream is printed to stderr).
    A failed command, a missing binary or a bad flag logs the error and
    exits 1."""
    from kind_tpu_sim_torch.utils.shell import CommandError, FakeExecutor

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s")
    try:
        cfg = config_from_args(args)
        sim = Simulator(cfg)
        if args.command == "create":
            sim.create(skip_plugin=args.skip_plugin)
            if args.timing_json:
                with open(args.timing_json, "w", encoding="utf-8") as fh:
                    json.dump(sim.timer.as_dict(), fh, indent=2,
                              sort_keys=True)
        elif args.command == "delete":
            sim.delete()
        elif args.command == "load":
            sim.load()
        elif args.command == "status":
            sim.status(as_json=args.as_json)
        elif args.command == "chaos":
            sim.chaos(args.action, node=args.node, worker=args.worker,
                      devices=[d for d in args.devices.split(",") if d])
        if isinstance(sim.executor, FakeExecutor) and cfg.verbose:
            print("-- fake runtime command stream --", file=sys.stderr)
            for cmd in sim.executor.commands():
                print(f"  {cmd}", file=sys.stderr)
        return 0
    except (CommandError, RuntimeError, ValueError, TimeoutError) as exc:
        _cluster_log.error("%s", exc)
        return 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command in ("create", "delete", "load", "status") or (
            args.command == "chaos"
            and args.action not in ("run", "soak", "fuzz")):
        return run_cluster(args)
    if args.command == "fleet":
        return run_fleet(args)
    if args.command == "chaos":
        return run_chaos(args)
    if args.command == "globe":
        return run_globe(args)
    if args.command == "sched":
        return run_sched(args)
    if args.command == "train":
        return run_train(args)
    if args.command == "health":
        return run_health(args)
    if args.command == "analysis":
        return run_analysis(args)
    if args.command == "profile":
        return run_profile(args)
    if args.command == "slice-smoke":
        return run_slice_smoke(args)
    if args.command == "torch-smoke":
        return run_torch_smoke(args)
    if args.command == "manifests":
        return run_manifests(args)
    return run_train_smoke(args)
