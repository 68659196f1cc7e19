"""Device-level tracing and profiling of the port's model path.

Counterpart of ``kind_tpu_sim/profiling.py`` on ``torch.profiler``:

* ``stopwatch`` / ``record_section`` -- the bench's section accountant;
* ``trace(log_dir)`` -- trace a code region (CPU activity, plus CUDA
  activity where a card is present) into a Chrome trace,
  ``*.trace.json.gz``;
* ``annotation(name)`` -- a named range on the trace timeline;
* ``capture(fn, *args)`` -- warm, then trace exactly one call, which ends
  in ``torch.cuda.synchronize()`` on a card;
* ``summarize(log_dir)`` -- a top-ops table read from the newest Chrome
  trace's raw events (``key_averages`` builds the profiler's event tree,
  seconds for each 10,000 operations), preferring the device's own
  events (kernels, memcpy and memset) where the trace has them;
* ``device_busy(fn)`` -- one traced call's device time (kernels, memcpy
  and memset) over its wall time, the busy share of a call;
* ``profile_flagship()`` -- one traced flagship loss step, the workload
  of the ``profile`` command.

The reference's ``profile_fleet_run`` profiles the fleet simulator with
cProfile. The simulator is a layer the port does not rewrite, so it has
no counterpart here.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import pathlib
import socket
import threading
import time
from typing import Any, Dict, List, MutableMapping

import torch

from kind_tpu_sim_torch.device import resolve

_SECTION_LOCK = threading.Lock()
# Chrome-trace categories of work the card itself did
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host-trace categories that are not operations: Python frames and the
# profiler's own span over the whole trace
_NOT_OPS = ("python_function", "Trace")


@contextlib.contextmanager
def stopwatch(name: str, store: MutableMapping, ndigits: int = 1):
    """Record a section's wall seconds into ``store[name]``: thread-safe,
    and a failing section still reports how long it burned."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        elapsed = round(time.monotonic() - t0, ndigits)
        with _SECTION_LOCK:
            store[name] = elapsed


def record_section(name: str, seconds: float, store: MutableMapping,
                   ndigits: int = 3) -> None:
    """Thread-safe store of an externally measured section time."""
    with _SECTION_LOCK:
        store[name] = round(seconds, ndigits)


def synchronize() -> None:
    """Wait for the card, where this process has started CUDA."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the region, the directory created up
    front; the Chrome trace lands in it as ``*.trace.json.gz``."""
    from torch.profiler import ProfilerActivity, profile

    path = pathlib.Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(
        path / f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
               ".trace.json.gz"))


def annotation(name: str):
    """Named region that shows up on the trace timeline."""
    return torch.profiler.record_function(name)


def capture(fn, *args, log_dir, warmup: int = 1,
            label: str = "captured-step") -> Dict[str, Any]:
    """Run ``fn(*args)`` once under the tracer (after ``warmup`` untraced
    calls, so kernel builds and allocator growth stay off the timeline);
    returns a report."""
    for _ in range(max(0, warmup)):
        fn(*args)
        synchronize()
    t0 = time.monotonic()
    with trace(log_dir) as path:
        with annotation(label):
            fn(*args)
            synchronize()
    elapsed = time.monotonic() - t0
    return {
        "log_dir": str(path),
        "wall_s": round(elapsed, 4),
        "trace_files": [os.path.basename(p) for p in _trace_files(path)],
    }


def device_busy(fn, *args) -> Dict[str, float]:
    """Trace one call of ``fn(*args)``, ending in a synchronize, and
    return its wall (``wall_ms``), the card's busy time in it
    (``busy_ms``: the kernels', memcpys' and memsets' durations, one
    stream, so they do not overlap) and the share of the wall that is
    busy (``busy_pct``). Reads the profiler's raw events."""
    from torch.profiler import ProfilerActivity, profile

    synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(ev.duration_ns() / 1e6
               for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == torch.autograd.DeviceType.CUDA
               and not ev.is_user_annotation())
    return {"wall_ms": round(wall, 3), "busy_ms": round(busy, 3),
            "busy_pct": round(100.0 * busy / wall, 1)}


def _trace_files(log_dir) -> List[str]:
    return sorted(
        glob.glob(str(pathlib.Path(log_dir) / "**" / "*.trace.json.gz"),
                  recursive=True),
        key=os.path.getmtime,
    )


def summarize(log_dir, top: int = 10) -> Dict[str, Any]:
    """Top ops by total duration from the newest Chrome trace.

    Prefers the device's events (kernels, memcpy, memset) where the
    trace has them; a host-only trace falls back to every host event
    but Python frames. Durations are microseconds.
    """
    files = _trace_files(log_dir)
    if not files:
        raise FileNotFoundError(f"no trace under {log_dir}")
    with gzip.open(files[-1], "rt") as fh:
        events = json.load(fh).get("traceEvents", [])

    def aggregate(device_only: bool) -> Dict[str, List[float]]:
        totals: Dict[str, List[float]] = {}
        for ev in events:
            if ev.get("ph") != "X" or not ev.get("dur"):
                continue
            cat = ev.get("cat", "")
            if device_only:
                if cat not in DEVICE_CATEGORIES:
                    continue
            elif cat in _NOT_OPS or cat in DEVICE_CATEGORIES:
                continue
            bucket = totals.setdefault(ev.get("name", ""), [0.0, 0])
            bucket[0] += ev["dur"]
            bucket[1] += 1
        return totals

    totals = aggregate(True)
    use_device = bool(totals)
    if not use_device:
        totals = aggregate(False)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "trace_file": files[-1],
        "device_tracks": use_device,
        "top_ops": [
            {"name": name, "total_us": round(total, 1), "count": count}
            for name, (total, count) in ranked
        ],
    }


def profile_flagship(log_dir, cfg=None, batch: int = 2, top: int = 10,
                     device="cuda") -> Dict[str, Any]:
    """Trace one flagship forward+loss step (no gradient, as the
    reference traces its jitted ``loss_fn``) and summarize it."""
    from kind_tpu_sim_torch.models import transformer as tf

    dev = resolve(device)
    cfg = cfg or tf.ModelConfig()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    tokens = tf.sample_batch(torch.Generator(device=dev).manual_seed(1),
                             cfg, batch, cfg.max_seq, device=dev)

    @torch.no_grad()
    def step(p, t):
        return tf.loss_fn(p, t, cfg)

    report = capture(step, params, tokens, log_dir=log_dir,
                     label="flagship-loss-step")
    report["summary"] = summarize(log_dir, top=top)
    report["model"] = f"d{cfg.d_model}xL{cfg.n_layers}"
    report["device"] = (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu")
    return report
