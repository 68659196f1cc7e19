"""Start a world of ranks on this host: the port's counterpart of the
reference's virtual devices.

The JAX package runs its meshes on 8 virtual CPU devices in one
process. ``torch.distributed`` runs one process per rank, so
``spawn(fn, world, backend=...)`` starts ``world`` processes with the
``spawn`` start method, joins them into one process group, runs
``fn(*args)`` in each and returns rank 0's result:

* the rendezvous is a ``file://`` store in a fresh temporary directory,
  so concurrent callers (test workers) never share one;
* each rank runs with one intra-op thread;
* ``timeout_s`` bounds the process group's collectives and the whole
  call: a rank that raises has its exception re-raised here (with the
  rank's traceback as a note), a rank that dies fails the call, and a
  world still running at the deadline is killed and fails it;
* ``rendezvous=(init_method, first_rank, world_size)`` joins the
  ranks into a larger world instead (``tcp://host:port``, the ranks
  first_rank.. of it), as each simulated host of a slice does
  (``parallel/multihost.py``);
* the caller names the backend (``gloo`` or ``nccl``); nothing picks
  one. ``device="cuda"`` with ``nccl`` gives rank r card r; with
  ``gloo`` every rank uses the card it is given (several ranks may
  share one card).

``process_group(backend, ...)`` makes the calling process a world of
one, for a mesh of one rank (NCCL on a single card).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue as _queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


# the device the ranks of this process were started for (``spawn``)
_RANK_DEVICE = torch.device("cpu")


def rank_device() -> torch.device:
    """The device ``spawn`` gave this rank (rank r's card under NCCL);
    the host outside a spawned rank."""
    return _RANK_DEVICE


def _rank_main(fn, args: Tuple, rank: int, world: int, store: str,
               backend: str, device: str, timeout_s: float, results,
               rendezvous=None) -> None:
    global _RANK_DEVICE
    torch.set_num_threads(1)
    local = rank
    init_method = f"file://{store}"
    if rendezvous is not None:
        init_method, first, world = rendezvous
        rank = first + local
    try:
        if backend == "nccl":
            _RANK_DEVICE = torch.device("cuda", local)
        elif device.startswith("cuda"):
            _RANK_DEVICE = torch.device("cuda", torch.device(device).index
                                        or 0)
        if _RANK_DEVICE.type == "cuda":
            torch.cuda.set_device(_RANK_DEVICE)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(*args)
        dist.barrier()
        # pickled to bytes here: the queue's own pickler would hand
        # tensors over as shared memory that dies with this process
        results.put((local, "ok",
                     pickle.dumps(out if local == 0 else None), ""))
    except BaseException as exc:  # handed to the parent, raised there
        text = traceback.format_exc()
        try:
            payload = pickle.dumps(exc)
        except Exception:
            payload = pickle.dumps(RuntimeError(f"{type(exc).__name__}: {exc}"))
        results.put((local, "error", payload, text))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable[..., Any], world: int, *args, backend: str,
          device: str = "cpu", timeout_s: float = 120.0,
          rendezvous: Optional[Tuple[str, int, int]] = None) -> Any:
    """Run ``fn(*args)`` on ``world`` ranks of a fresh process group and
    return rank 0's result. ``fn`` must be importable by name (a
    module-level function). Raises the first failing rank's exception,
    or RuntimeError when a rank dies or the deadline passes. With
    ``rendezvous`` the ``world`` ranks started here are ranks
    ``first_rank..`` of a world of ``world_size`` joined at
    ``init_method``; the result is that of the first of them."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl'; got {backend!r}")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="kts-world-")
    results = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, rank, world,
                               os.path.join(tmp, "store"), backend, device,
                               timeout_s, results, rendezvous), daemon=True)
             for rank in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        done, out, failed = set(), None, None
        while len(done) < world:
            while not results.empty():
                rank, status, payload, text = results.get()
                value = pickle.loads(payload)
                done.add(rank)
                if status == "error" and failed is None:
                    if hasattr(value, "add_note"):
                        value.add_note(f"rank {rank} of {world}:\n{text}")
                    failed = value
                    # a rank that died takes the blame for its peers'
                    # broken collectives: give its exit a moment to show
                    grace = time.monotonic() + 1.0
                elif rank == 0:
                    out = value
            dead = [r for r, p in enumerate(procs)
                    if r not in done and p.exitcode is not None]
            if dead and results.empty():
                raise RuntimeError(
                    f"rank {dead[0]} of {world} died (exit code "
                    f"{procs[dead[0]].exitcode}) before reporting")
            if failed is not None and time.monotonic() > grace:
                raise failed
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"world of {world} ranks still running after "
                    f"{timeout_s} s; killed")
            time.sleep(0.02)
        if failed is not None:
            raise failed
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        with contextlib.suppress(_queue.Empty, OSError):
            results.close()
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def process_group(backend: str, timeout_s: float = 300.0):
    """Make this process a world of one rank for the block (NCCL on the
    current card, or gloo), then tear the group down."""
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world already exists here")
    tmp = tempfile.mkdtemp(prefix="kts-world-")
    try:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
