"""Command line of the PyTorch port.

    python -m kind_tpu_sim_torch train-smoke [--steps N] [--batch B]
        [--checkpoint-dir DIR] [--json] [--device cuda|cpu]

``train-smoke`` is the counterpart of ``python -m kind_tpu_sim
train-smoke`` (``kind_tpu_sim/cli.py:run_train_smoke``): the training
stack proved with no cluster -- the data pipeline feeds the train step
and the loss must fall; with ``--checkpoint-dir`` also the
checkpoint/resume round trip, whose resumed loss trajectory must match
the uninterrupted one. It runs on the CUDA card unless ``--device cpu``
is given, and raises without a card.
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


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return run_train_smoke(args)  # the one command so far
