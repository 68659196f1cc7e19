"""Command line of the PyTorch port.

    python -m kind_tpu_sim_torch train-smoke [--steps N] [--batch B]
        [--checkpoint-dir DIR] [--json] [--device cuda|cpu]
    python -m kind_tpu_sim_torch profile [--out DIR] [--json]
        [--device cuda|cpu]
    python -m kind_tpu_sim_torch slice-smoke [--topology T]
        [--accelerator A] [--ring-tokens N] [--num-slices N] [--serving]
        [--json] [--device cuda|cpu] [--backend gloo|nccl]

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
"""

from __future__ import annotations

import argparse
import json
import shutil
import time
from typing import Optional, Sequence

import numpy as np
import torch

from kind_tpu_sim_torch import data
from kind_tpu_sim_torch.device import resolve
from kind_tpu_sim_torch.models import checkpoint as ckpt
from kind_tpu_sim_torch.models import transformer as tf
from kind_tpu_sim_torch.parallel import mesh


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m kind_tpu_sim_torch",
        description="PyTorch + CUDA port of kind_tpu_sim's model path")
    sub = parser.add_subparsers(dest="command", required=True)
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
                       choices=sorted(mesh.ACCELERATORS))
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
    return parser


def smoke_config() -> tf.ModelConfig:
    """The reference's train-smoke model (bf16 activations)."""
    return tf.ModelConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                          d_ff=64, max_seq=16)


def run_train_smoke(args: argparse.Namespace) -> int:
    """Data pipeline in, loss down; optionally the checkpoint/resume
    contract too."""
    if args.steps < 10:
        raise SystemExit(
            "train-smoke needs --steps >= 10 (the ok-check compares the "
            "first five losses against the last five)")
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
    from kind_tpu_sim_torch.parallel import multihost

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


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "profile":
        return run_profile(args)
    if args.command == "slice-smoke":
        return run_slice_smoke(args)
    return run_train_smoke(args)
