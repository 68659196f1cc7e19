"""Where the time of the flagship training step goes on the card.

    python3 -m kind_tpu_sim_torch.profile_train [--out FILE]

Trains the flagship workload — ``bench_config_large`` with
``flash=True`` (d_model 2048, 16 query heads over 4 KV heads, head_dim
128, 8 layers, d_ff 8192, 32768-token vocab; bf16 activations over
fp32 parameters), random parameters from ``torch.Generator`` seed 0,
AdamW at lr 1e-2 (``make_train_step``), batches of 8 sequences of 1025
tokens from ``sample_batch`` (seed 1), so flash trains on 1024
positions as the reference bench does (``bench.py:398-482``). One
warm-up step, then ``STEPS`` (5) timed steps, then one step traced with
``torch.profiler``. Prints one JSON object:

* ``step_wall_ms`` (median, and every step's) and ``train_tok_per_s``
  (8 x 1024 trained positions over the median step) -- host clock
  around each step, ending in a synchronize;
* ``losses`` of the timed steps and ``peak_mem_gib`` -- the most
  device memory allocated during them;
* ``device_busy_ms`` and ``device_busy_share`` of the traced step (the
  sum of its kernel times on one stream over its wall time), and
  ``by_group`` / ``kernels`` -- device time by kernel group (the flash
  forward, dq and dk/dv kernels, bf16 GEMMs, fp32 GEMMs, the optimizer,
  the rest) and by kernel name, largest first.

Run it on the card (it raises without one).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from kind_tpu_sim_torch.models import transformer as tf

BATCH, SEQ = 8, 1025
STEPS = 5  # timed steps after the warm-up
LEARNING_RATE = 1e-2
# kernel name fragments -> group, first match wins
GROUPS = (("flash_fwd_tc_kernel", "flash forward"),
          ("flash_fwd_kernel", "flash forward"),
          ("flash_bwd_dq_tc_kernel", "flash dq"),
          ("flash_bwd_dq_kernel", "flash dq"),
          ("flash_bwd_dkv_tc_kernel", "flash dk/dv"),
          ("flash_bwd_dkv_kernel", "flash dk/dv"),
          ("adam", "optimizer (AdamW)"),
          ("multi_tensor", "optimizer (AdamW)"))


def flagship_config() -> tf.ModelConfig:
    return dataclasses.replace(tf.bench_config_large(), flash=True)


def flagship_state(cfg: tf.ModelConfig):
    """(step_fn, state): AdamW at lr 1e-2 over fp32 parameters drawn
    from ``torch.Generator`` seed 0, on the card."""
    step, init = tf.make_train_step(cfg, learning_rate=LEARNING_RATE,
                                    device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    return step, init(gen)


def flagship_batches(cfg: tf.ModelConfig, n: int):
    """``n`` batches of BATCH x SEQ tokens on the card from
    ``sample_batch`` with a generator seeded 1."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    return [tf.sample_batch(gen, cfg, BATCH, SEQ, device="cuda")
            for _ in range(n)]


def group_of(name: str) -> str:
    low = name.lower()
    for frag, group in GROUPS:
        if frag in low:
            return group
    # the fp32 products (TF32 off) run as cuBLAS/CUTLASS SIMT sgemms; in
    # this bf16-activation model they are the readout's
    if "sgemm" in low or "f32f32" in low:
        return "fp32 GEMMs (readout)"
    if "gemm" in low or "xmma" in low or "nvjet" in low or "cutlass" in low:
        return "bf16 GEMMs"
    return "other"


def timed_steps(step, state, batches):
    """Run one step per batch; returns (state, wall ms of each step,
    losses)."""
    walls, losses = [], []
    for tokens in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return state, walls, losses


def profile_step(step, state, tokens) -> dict:
    """Trace one train step: device busy time and time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # a record_function range (the optimizer's "Optimizer.step#...")
    # also shows on the device under its host name and would count its
    # kernels twice
    host_names = {ev.key for ev in events
                  if ev.device_type != torch.autograd.DeviceType.CUDA}
    kernels = {}
    for ev in events:
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if (ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0
                and ev.key not in host_names):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
    groups = {}
    for name, ms in kernels.items():
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:20]
    return {"traced_step_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "kernels": dict(top)}


def run() -> dict:
    cfg = flagship_config()
    step, state = flagship_state(cfg)
    batches = flagship_batches(cfg, STEPS + 2)
    state, _, _ = timed_steps(step, state, batches[:1])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    state, walls, losses = timed_steps(step, state, batches[1:STEPS + 1])
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(walls))
    return {"device": torch.cuda.get_device_name(0),
            "batch": BATCH, "trained_positions": SEQ - 1, "steps": STEPS,
            "step_wall_ms": median, "step_wall_ms_each": walls,
            "train_tok_per_s": BATCH * (SEQ - 1) / (median / 1e3),
            "losses": losses, "peak_mem_gib": peak / 2**30,
            **profile_step(step, state, batches[-1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    text = json.dumps(run())
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
