"""Persistent workers over a length-prefixed JSON protocol: the port's
counterpart of ``kind_tpu_sim/utils/worker_pool.py``.

The reference keeps long-lived JAX workers so that ``import jax``, the
backend's start and XLA's compiles are paid once per session, and
submits jobs to them over a length-prefixed JSON protocol on each
worker's stdin and stdout. Here a warm worker pays ``import torch`` and
the bring-up of a world of ``world`` ranks once; every later job runs in
that same live world, on the same processes and process groups.

Protocol (both directions, the reference's): a 4-byte big-endian
length, then a UTF-8 JSON object. The worker's first frame is a hello
with its pid (a warm worker adds the seconds its warm-up took,
``warm_s``, and what it brought up); every later frame answers one
request, in order::

    request:  {"id": 3, "job": "collectives_suite", "kwargs": {...}}
    response: {"id": 3, "ok": true, "result": {...}, "elapsed_s": 0.04}

The worker writes frames to its original stdout and points file
descriptor 1 at stderr first, so a stray print cannot corrupt the
framing.

Two temperatures, as in the reference:

* warm (``WorkerPool``; ``--world`` given, ``KIND_TPU_SIM_POOL_WARM``
  on): the worker process is rank 0, and it starts ``world - 1`` rank
  processes (the ``spawn`` start method) that join it over a
  ``file://`` store and then wait for jobs on a queue of their own, all
  before its hello. A job of ``RANK_JOBS`` (``collectives_suite``) is
  handed to every rank and run by all of them together; the other jobs
  run in the worker alone. A mesh is made once per topology and kept,
  so a resubmission starts no process and no process group. If the
  world fails to come up, the hello carries the error and every rank
  job fails with it.
* cold (``run_grid``, ``run_cells``): a bare protocol loop. It imports
  the standard library and this module alone (no torch, no world, no
  CUDA), so it reaches its hello in a fraction of a second; ``call`` /
  ``call_batch`` import the target's module and nothing more. The
  simulator's grids run host functions in such workers.

Failure contract (the reference's): a job that raises returns ``ok:
false`` and surfaces as ``JobError``, the worker stays up; a worker
that dies mid-job is started again and the job retried once, and a
second death raises ``WorkerCrash`` with the worker's stderr tail; a
job past its deadline kills the worker and raises ``TimeoutError``
without a retry. A warm worker's rank processes end with it: at its
shutdown, or when they see their parent gone. ``start_heartbeat``
respawns a dead idle worker before its next job.

Injected faults (``KIND_TPU_SIM_CHAOS_FAULT``, read by the worker):
``crash@N`` exits on receiving request N (1-based), ``hang@N:S`` sleeps
S seconds before answering it, ``slow@N:S`` stalls S seconds before
answering every request from the Nth on (a gray straggler: alive,
correct, slow) and ``flaky@K:S`` stalls S seconds before every Kth
request. A respawned worker's environment lacks the variable, so an
injected fault is transient. :func:`run_grid` fans one job out per
worker environment; :func:`run_cells` schedules grid cells over cold
workers with requeue, respawn, probes, quarantine, speculative tail
re-dispatch and batching.

Bulk payloads (``KIND_TPU_SIM_POOL_SHM``, on unless set off): the parent
creates two shared-memory segments for each worker, one a direction,
and hands the worker their names (``KIND_TPU_SIM_POOL_SHM_SEGS``). A
payload of at least ``SHM_MIN_BYTES`` travels as raw bytes in the
segment behind a ``{"shm_len": N}`` control frame; a smaller one, or one
larger than the segment, or any payload with the knob off, goes in-band.
Requests and answers alternate on a worker, so one segment a direction
needs no lock. The parent owns both segments and unlinks them when it
kills or closes the worker, so a worker that crashes or hangs leaves
none behind. The worker attaches a segment only when a bulk payload
first travels through it (a grid cell's worker never does, and starts as
fast as without the transport), and detaches its attachments from its
resource tracker, which would otherwise unlink them at its exit.
:class:`PoolWorker` and :func:`pool_child_env` are the one-worker
surface that the sharded globe (``globe/shard.py``) drives with its
own session protocol.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pathlib
import queue
import selectors
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

log = logging.getLogger("kind-tpu-sim-torch")

# A frame bigger than this is protocol corruption, not data.
MAX_FRAME_BYTES = 64 * 1024 * 1024

# the bulk transport's segments: each this size, and the least payload
# that goes through one
POOL_SHM_BYTES = 32 * 1024 * 1024
SHM_MIN_BYTES = 64 * 1024

# The knobs this module reads itself, by name: a cold worker imports
# nothing of the fleet package (``fleet/knobs.py`` registers the names
# with their types and defaults). A bool reads "", "0", "false" and "no"
# as off, as every knob does.
WARM_ENV = "KIND_TPU_SIM_POOL_WARM"
CHAOS_FAULT_ENV = "KIND_TPU_SIM_CHAOS_FAULT"
SHM_ENV = "KIND_TPU_SIM_POOL_SHM"
SHM_SEGS_ENV = "KIND_TPU_SIM_POOL_SHM_SEGS"

_PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[2]
# a cold worker's command line
_COLD_ARGS = ("-m", "kind_tpu_sim_torch.utils.worker_pool", "--serve")


class JobError(RuntimeError):
    """The job raised inside the worker (the worker itself is healthy)."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback


class WorkerCrash(RuntimeError):
    """The worker process died before answering."""


class WorkerCancelled(RuntimeError):
    """The caller cancelled a pending read (a grid finished through a
    speculative copy while a straggler still held the original
    dispatch): not a worker failure."""


class FrameError(RuntimeError):
    """A length prefix that no frame can have: protocol corruption."""


# ---------------------------------------------------------------------
# framing: one parser for both sides of the pipe


def frame_length(header: bytes) -> int:
    """Decode and validate a 4-byte big-endian frame header."""
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME_BYTES:
        raise FrameError(f"implausible frame length {length}")
    return length


def write_frame(stream, obj) -> None:
    payload = json.dumps(obj, sort_keys=True).encode("utf-8")
    stream.write(struct.pack(">I", len(payload)) + payload)
    stream.flush()


def read_frame(stream):
    """Blocking frame read from a binary stream; None on clean EOF."""
    header = stream.read(4)
    if not header:
        return None
    if len(header) < 4:
        raise EOFError("truncated frame header")
    try:
        length = frame_length(header)
    except FrameError as exc:
        raise EOFError(str(exc)) from exc
    payload = b""
    while len(payload) < length:
        chunk = stream.read(length - len(payload))
        if not chunk:
            raise EOFError("truncated frame payload")
        payload += chunk
    return json.loads(payload.decode("utf-8"))


def _try_parse(buf: bytes):
    """(frame, rest) if ``buf`` holds a complete frame, else (None,
    buf). On the parent's side corruption is a WorkerCrash: a worker
    talking garbage is one dying mid-frame."""
    if len(buf) < 4:
        return None, buf
    try:
        length = frame_length(buf[:4])
    except FrameError as exc:
        raise WorkerCrash(str(exc)) from exc
    if len(buf) < 4 + length:
        return None, buf
    return json.loads(buf[4:4 + length].decode("utf-8")), buf[4 + length:]


# ---------------------------------------------------------------------
# jobs


# the meshes of this rank's world, one per topology, made at the first
# job that asks for it (every rank makes them in the same order)
_MESHES: Dict[str, object] = {}


def _slice_mesh(topology: str):
    from kind_tpu_sim_torch.parallel import mesh

    if topology not in _MESHES:
        _MESHES[topology] = mesh.slice_mesh(
            mesh.make_slice(topology=topology))
    return _MESHES[topology]


def _job_ping() -> dict:
    return {"pid": os.getpid()}


def _job_collectives_suite(topology: str = "2x4") -> dict:
    """``collectives.run_all`` over the slice mesh of ``topology``, on
    every rank of the world; rank 0's report."""
    import torch.distributed as dist

    from kind_tpu_sim_torch.parallel import collectives

    report = collectives.run_all(_slice_mesh(topology))
    report["devices"] = dist.get_world_size()
    report["worker_pid"] = os.getpid()
    return report


def _job_call(target: str, kwargs: Optional[dict] = None):
    """``module.path:attr`` resolved and called in the worker: how a grid
    runs its cells without a job of its own."""
    import importlib

    mod_name, _, attr_path = target.partition(":")
    if not attr_path:
        raise ValueError(f"target {target!r} must be 'module:attr'")
    obj = importlib.import_module(mod_name)
    for attr in attr_path.split("."):
        obj = getattr(obj, attr)
    return obj(**(kwargs or {}))


def _job_call_batch(target: str, kwargs_list: Sequence[dict]) -> list:
    """N calls in one round trip; each the same pure function of its
    kwargs as a lone ``call``, so results are position-equal to N
    single dispatches."""
    return [_job_call(target, kw) for kw in kwargs_list]


def _job_crash(code: int = 13) -> None:
    """Die without answering: the crash-recovery paths' chaos hook."""
    os._exit(code)


def _job_hang(seconds: float = 3600.0) -> dict:
    """Wedge without answering for ``seconds``: the deadline-kill path's
    chaos hook (the parent must time out and kill, never wait it out)."""
    time.sleep(seconds)
    return {"slept_s": seconds}


# jobs every rank of the world runs together, and jobs of the worker alone
RANK_JOBS = {"collectives_suite": _job_collectives_suite}
JOBS = {"ping": _job_ping, "call": _job_call, "call_batch": _job_call_batch,
        "crash": _job_crash, "hang": _job_hang, **RANK_JOBS}


def _run_cold(job: str, kwargs: dict):
    """A job in a cold worker, which has no world to run a rank job on."""
    if job in RANK_JOBS:
        raise RuntimeError(f"{job} runs on a world of ranks; a cold worker "
                           "has none")
    return JOBS[job](**kwargs)


def _knob_on(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() not in ("", "0", "false", "no")


def _attach_shm(name: str):
    """A parent-owned segment attached by name, or None when it cannot be
    (the pipe framing is always a complete fallback). The attachment is
    taken off this process's resource tracker: the parent owns the
    segment's lifetime, and a tracked attachment would be unlinked a
    second time at this process's exit."""
    if not name:
        return None
    try:
        from multiprocessing import resource_tracker, shared_memory

        seg = shared_memory.SharedMemory(name=name)
        try:
            resource_tracker.unregister(seg._name, "shared_memory")
        except Exception:
            pass
        return seg
    except Exception:
        return None


def _encode(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode("utf-8")


def _attacher(name: str):
    """The worker's side of one segment: a function that attaches it at
    its first call and then returns it (None without one). A worker
    asks only when a bulk payload travels, so one that never carries
    any (a grid cell's) starts no resource tracker and comes up as fast
    as without the transport."""
    held = []

    def segment():
        if not held:
            held.append(_attach_shm(name))
        return held[0]

    return segment


def _send_payload(stream, payload: bytes, segment) -> None:
    """One frame's payload to ``stream``: through the segment that
    ``segment()`` gives (asked only for a bulk payload) behind a
    ``shm_len`` control frame when there is one and the payload fits,
    else in-band."""
    seg = segment() if len(payload) >= SHM_MIN_BYTES else None
    if seg is not None and len(payload) <= seg.size:
        seg.buf[:len(payload)] = payload
        payload = _encode({"shm_len": len(payload)})
    stream.write(struct.pack(">I", len(payload)) + payload)
    stream.flush()


def _from_segment(frame, segment):
    """A bulk frame's payload read from the segment that ``segment()``
    gives; any other frame as is."""
    if isinstance(frame, dict) and "shm_len" in frame:
        seg = segment()
        if seg is not None:
            return json.loads(
                bytes(seg.buf[:frame["shm_len"]]).decode("utf-8"))
    return frame


def _parse_fault(spec: Optional[str]):
    """A ``KIND_TPU_SIM_CHAOS_FAULT`` spec -> (kind, request_no, param),
    or None. ``crash@2`` exits on receiving request 2, ``hang@1:30``
    sleeps 30 s before answering request 1, ``slow@1:0.5`` stalls 0.5 s
    before answering every request from the 1st on, ``flaky@3:0.5``
    stalls 0.5 s before every 3rd request. A malformed spec is ignored:
    a chaos knob must never break a healthy worker."""
    if not spec or "@" not in spec:
        return None
    kind, _, rest = spec.partition("@")
    at, _, param = rest.partition(":")
    try:
        return kind, int(at), float(param or 0.0)
    except ValueError:
        return None


def _rank_loop(init_method: str, rank: int, world: int, backend: str,
               device: str, timeout_s: float, jobs, results,
               parent: int) -> None:
    """A rank process of the worker's world: join it, then run each job
    the worker hands over until it says stop or is gone."""
    import torch.distributed as dist

    from kind_tpu_sim_torch.parallel import launch

    launch.join_world(init_method, rank, world, rank, backend, device,
                      timeout_s)
    try:
        while True:
            try:
                item = jobs.get(timeout=1.0)
            except queue.Empty:
                if os.getppid() != parent:
                    return
                continue
            if item is None:
                return
            job, kwargs = item
            try:
                RANK_JOBS[job](**kwargs)
                results.put((rank, None))
            except Exception as exc:  # handed to rank 0, raised there
                results.put((rank, f"{type(exc).__name__}: {exc}"[:2000]))
    finally:
        dist.destroy_process_group()


class _World:
    """The worker's world: this process is rank 0 of ``size`` ranks over
    ``backend`` on ``device``; the other ranks are processes it starts
    once (``up``) and stops at ``close``."""

    def __init__(self, size: int, backend: str, device: str,
                 timeout_s: float):
        self.size, self.backend, self.device = size, backend, device
        self.timeout_s = timeout_s
        self._procs: Optional[list] = None
        self._jobs: list = []
        self._results = None
        self._tmp: Optional[str] = None
        self._error: Optional[str] = None

    def up(self) -> dict:
        """Bring the world up (once); what it is."""
        import torch
        import torch.distributed as dist

        from kind_tpu_sim_torch.parallel import launch

        if self._error is not None:
            raise RuntimeError(f"the world did not come up: {self._error}")
        if self._procs is None:
            import torch.multiprocessing as mp

            ctx = mp.get_context("spawn")
            self._tmp = tempfile.mkdtemp(prefix="kts-pool-")
            init_method = f"file://{os.path.join(self._tmp, 'store')}"
            self._results = ctx.Queue()
            self._jobs = [ctx.Queue() for _ in range(self.size - 1)]
            self._procs = [
                ctx.Process(target=_rank_loop, daemon=True, args=(
                    init_method, rank, self.size, self.backend,
                    self.device, self.timeout_s, self._jobs[rank - 1],
                    self._results, os.getpid()))
                for rank in range(1, self.size)]
            for p in self._procs:
                p.start()
            try:
                launch.join_world(init_method, 0, self.size, 0, self.backend,
                                  self.device, self.timeout_s)
            except Exception as exc:
                self._error = f"{type(exc).__name__}: {exc}"[:500]
                raise
        return {"devices": dist.get_world_size(),
                "backend": dist.get_backend(),
                "device": str(launch.rank_device()),
                "torch_version": torch.__version__}

    def run(self, job: str, kwargs: dict):
        if job not in RANK_JOBS:
            return JOBS[job](**kwargs)
        self.up()
        for q in self._jobs:
            q.put((job, kwargs))
        try:
            result = RANK_JOBS[job](**kwargs)
        finally:
            errors = self._collect()
        if errors:
            raise RuntimeError("; ".join(
                f"rank {rank}: {err}" for rank, err in sorted(errors)))
        return result

    def _collect(self) -> list:
        """Every other rank's outcome of the job in flight: (rank, error)
        for each that failed; a rank that does not answer in time, or
        died, is one."""
        errors, waiting = [], set(range(1, self.size))
        deadline = time.monotonic() + self.timeout_s
        while waiting:
            try:
                rank, err = self._results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r in waiting
                        if not self._procs[r - 1].is_alive()]
                late = time.monotonic() > deadline
                for r in (sorted(waiting) if late else dead):
                    errors.append((r, "died" if r in dead else
                                   f"no answer in {self.timeout_s} s"))
                    waiting.discard(r)
                continue
            waiting.discard(rank)
            if err is not None:
                errors.append((rank, err))
        return errors

    def close(self) -> None:
        import torch.distributed as dist

        if self._procs is None:
            return
        for q in self._jobs:
            q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self._tmp, ignore_errors=True)
        self._procs = None


def _serve(argv=None) -> int:
    """Worker main loop: hello, then answer requests until EOF or a
    shutdown request. With ``--world`` (and the warm knob on, as the pool
    sets it) the worker brings its world up before the hello; without,
    it is cold."""
    import traceback

    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true", required=True)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None)
    ap.add_argument("--timeout", type=float, default=None)
    args = ap.parse_args(argv)
    warm = _knob_on(WARM_ENV) or args.world is not None
    if warm and None in (args.world, args.backend, args.device,
                         args.timeout):
        ap.error("a warm worker brings up a world: give --world, "
                 "--backend, --device and --timeout")

    # the protocol on the ORIGINAL stdout; fd 1 (and the rank processes,
    # which inherit it) to stderr
    proto_fd = os.dup(1)
    os.dup2(2, 1)
    out = os.fdopen(proto_fd, "wb")
    inp = sys.stdin.buffer

    # the bulk transport: the parent's segments, one a direction, each
    # attached at the first bulk payload it carries
    in_name, _, out_name = os.environ.get(SHM_SEGS_ENV, "").partition(":")
    shm_in, shm_out = _attacher(in_name), _attacher(out_name)

    world = (_World(args.world, args.backend, args.device, args.timeout)
             if warm else None)
    run = world.run if world is not None else _run_cold
    hello = {"hello": True, "pid": os.getpid()}
    try:
        if world is not None:
            t0 = time.monotonic()
            try:
                hello.update(world.up())
                hello["warm_s"] = round(time.monotonic() - t0, 3)
            except Exception as exc:  # surfaced to the parent, not fatal
                hello["warm_error"] = f"{type(exc).__name__}: {exc}"[:500]
        write_frame(out, hello)
        fault = _parse_fault(os.environ.get(CHAOS_FAULT_ENV))
        req_no = 0
        while True:
            try:
                req = _from_segment(read_frame(inp), shm_in)
            except EOFError:
                return 1
            if req is None or req.get("op") == "shutdown":
                return 0
            req_no += 1
            if fault is not None:
                kind, at, param = fault
                if req_no == at:
                    if kind == "crash":
                        os._exit(int(param) or 13)
                    if kind == "hang":
                        time.sleep(param or 3600.0)
                if kind == "slow" and req_no >= at:
                    # a gray straggler: alive and correct, every job from
                    # request ``at`` on stalled
                    time.sleep(param)
                if kind == "flaky" and at > 0 and req_no % at == 0:
                    time.sleep(param)
            resp = {"id": req.get("id")}
            t0 = time.monotonic()
            try:
                resp["result"] = run(req["job"], req.get("kwargs") or {})
                resp["ok"] = True
            except Exception as exc:
                resp["ok"] = False
                resp["error"] = f"{type(exc).__name__}: {exc}"[:2000]
                resp["traceback"] = traceback.format_exc()[-2000:]
            resp["elapsed_s"] = round(time.monotonic() - t0, 6)
            _send_payload(out, _encode(resp), shm_out)
    finally:
        if world is not None:
            world.close()


# ---------------------------------------------------------------------
# parent side


def _pool_child_env(extra_env: Optional[Dict[str, str]] = None,
                    warm: bool = True) -> Dict[str, str]:
    """A worker's environment: this process's, ``extra_env`` over it, the
    package on ``PYTHONPATH`` and the warm knob set."""
    env = dict(os.environ)
    env.update(extra_env or {})
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_PACKAGE_ROOT), env.get("PYTHONPATH")) if p)
    env[WARM_ENV] = "1" if warm else "0"
    return env


def simulated_slice_env(chips: int = 8) -> Dict[str, str]:
    """The environment of a cold worker that simulates one host of a
    slice for a grid cell: the card hidden, since a grid cell is a host
    function. (The reference's pins JAX to its CPU backend with ``chips``
    virtual devices; a port cell holds no device, whatever the host's
    ``chips``.)"""
    return {"CUDA_VISIBLE_DEVICES": ""}


class _WorkerProc:
    """One protocol worker process, its read buffer, its stderr log (a
    temporary file unless ``stderr_path`` names one) and, with the bulk
    transport on, its two shared-memory segments. ``cmd`` is the
    worker's command line: a cold worker's unless given."""

    def __init__(self, env: Dict[str, str],
                 stderr_path: Optional[pathlib.Path] = None,
                 cmd: Optional[List[str]] = None):
        self._buf = b""
        self.hello: Optional[dict] = None
        self.spawned_at = time.monotonic()
        # the parent creates (and later unlinks) both segments and hands
        # the worker their names: a worker never owns one
        self._shm_in = self._shm_out = None
        if _knob_on(SHM_ENV, default=True):
            try:
                from multiprocessing import shared_memory

                self._shm_in = shared_memory.SharedMemory(
                    create=True, size=POOL_SHM_BYTES)
                self._shm_out = shared_memory.SharedMemory(
                    create=True, size=POOL_SHM_BYTES)
                env = dict(env)
                env[SHM_SEGS_ENV] = (
                    f"{self._shm_in.name}:{self._shm_out.name}")
            except Exception:  # no /dev/shm: the pipe alone
                self._close_shm()
        if stderr_path is None:
            fd, name = tempfile.mkstemp(prefix="kts-worker-", suffix=".err")
            self.stderr_path = pathlib.Path(name)
            self._stderr_file = os.fdopen(fd, "wb")
            self._own_stderr = True
        else:
            self.stderr_path = stderr_path
            self._stderr_file = open(stderr_path, "wb")
            self._own_stderr = False
        self.proc = subprocess.Popen(
            cmd or [sys.executable, *_COLD_ARGS], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self._stderr_file, env=env)

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stderr_tail(self, n: int = 2000) -> str:
        try:
            self._stderr_file.flush()
            return self.stderr_path.read_text(errors="replace")[-n:]
        except (OSError, ValueError):
            # ValueError: the file was closed by kill()
            return ""

    def read_frame(self, deadline: float, cancel=None):
        """One frame from the worker's stdout, or raise: WorkerCrash on
        EOF or death, TimeoutError past ``deadline``, WorkerCancelled
        once ``cancel`` (a threading.Event) is set."""
        if self.proc.stdout.closed:  # killed: its pipes went with it
            raise WorkerCrash(f"worker {self.pid} was killed")
        fd = self.proc.stdout.fileno()
        sel = selectors.DefaultSelector()
        sel.register(self.proc.stdout, selectors.EVENT_READ)
        poll_s = 1.0 if cancel is None else 0.05
        try:
            while True:
                frame, self._buf = _try_parse(self._buf)
                if frame is not None:
                    return _from_segment(frame, lambda: self._shm_out)
                if cancel is not None and cancel.is_set():
                    raise WorkerCancelled(
                        f"read from worker {self.pid} cancelled")
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise TimeoutError(
                        f"worker {self.pid} gave no answer in time")
                if not sel.select(timeout=min(remain, poll_s)):
                    if not self.alive():
                        raise WorkerCrash(
                            f"worker {self.pid} exited "
                            f"(rc={self.proc.returncode}): "
                            f"{self.stderr_tail()}")
                    continue
                data = os.read(fd, 65536)
                if not data:
                    raise WorkerCrash(
                        f"worker {self.pid} closed its pipe "
                        f"(rc={self.proc.poll()}): {self.stderr_tail()}")
                self._buf += data
        finally:
            sel.close()

    def ensure_ready(self, deadline: float) -> dict:
        if self.hello is None:
            self.hello = self.read_frame(deadline)
        return self.hello

    def send(self, req: dict) -> None:
        """One request to the worker: a bulk one through the
        parent-to-worker segment, any other in-band."""
        try:
            _send_payload(self.proc.stdin, _encode(req),
                          lambda: self._shm_in)
        except (BrokenPipeError, OSError, ValueError) as exc:
            # ValueError: the pipe was closed by kill()
            raise WorkerCrash(f"worker {self.pid} pipe closed: {exc}; "
                              f"{self.stderr_tail()}") from exc

    def request(self, req: dict, deadline: float, cancel=None) -> dict:
        self.ensure_ready(deadline)
        self.send(req)
        return self.read_frame(deadline, cancel=cancel)

    def kill(self) -> None:
        if self.alive():
            self.proc.kill()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:  # pragma: no cover
            pass
        self.close_files()

    def shutdown(self, grace_s: float = 30.0) -> None:
        """Ask the worker to stop (a warm one stops its ranks first), then
        make sure it has."""
        try:
            if self.alive():
                write_frame(self.proc.stdin, {"op": "shutdown"})
                self.proc.stdin.close()
                self.proc.wait(timeout=grace_s)
        except (OSError, subprocess.TimeoutExpired):
            pass
        self.kill()

    def close_files(self) -> None:
        self._close_shm()
        for f in (self.proc.stdin, self.proc.stdout, self._stderr_file):
            try:
                f.close()
            except OSError:
                pass
        if self._own_stderr:
            try:
                self.stderr_path.unlink()
            except OSError:
                pass

    def _close_shm(self) -> None:
        for seg in (self._shm_in, self._shm_out):
            if seg is None:
                continue
            for step in (seg.close, seg.unlink):
                try:
                    step()
                except Exception:
                    pass
        self._shm_in = self._shm_out = None


# the one-worker surface a driver with its own session protocol builds on
# (the sharded globe, ``globe/shard.py``)
PoolWorker = _WorkerProc
pool_child_env = _pool_child_env


class WorkerPool:
    """One warm protocol worker (the reference pool's default size) with
    its world of ``world`` ranks over ``backend`` on ``device`` (the card
    unless the caller asks for the CPU; without a card this raises). It
    brings its world up before its hello. Jobs run one at a time, in the
    order submitted. ``health`` (a ``health.FailureDetector``) gets the
    heartbeat's liveness probes as component ``pool-0``."""

    def __init__(self, *, world: int, backend: str, device: str = "cuda",
                 job_timeout: float = 300.0, health=None):
        from kind_tpu_sim_torch.device import resolve

        resolve(device)  # no card raises, unless the caller asks for the CPU
        if backend not in ("gloo", "nccl"):
            raise ValueError(
                f"backend must be 'gloo' or 'nccl'; got {backend!r}")
        if world < 1:
            raise ValueError(f"a world needs at least one rank; got {world}")
        self._cmd = [sys.executable, *_COLD_ARGS, "--world", str(world),
                     "--backend", backend, "--device", str(device),
                     "--timeout", str(job_timeout)]
        self._env = _pool_child_env(warm=True)
        self._timeout = job_timeout
        self._health = health
        # held for a whole job: the heartbeat leaves a busy worker to the
        # job's own crash handling
        self._lock = threading.Lock()
        self._next_id = 0
        self._closed = False
        self.respawns = 0
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._proc: Optional[_WorkerProc] = _WorkerProc(self._env,
                                                        cmd=self._cmd)

    def submit(self, job: str, *, timeout: Optional[float] = None,
               **kwargs):
        """Run ``job`` in the worker and return its result. A worker that
        dies is started again and the job retried once; one past its
        deadline is killed and the job not retried."""
        with self._lock:
            if self._closed:
                raise RuntimeError("pool is closed")
            self._next_id += 1
            req = {"id": self._next_id, "job": job, "kwargs": kwargs}
            retries = 1
            while True:
                if self._proc is None or not self._proc.alive():
                    self._respawn()
                proc = self._proc
                try:
                    resp = proc.request(
                        req, time.monotonic() + (timeout or self._timeout))
                except WorkerCrash:
                    proc.kill()
                    self._proc = None
                    if retries > 0:
                        retries -= 1
                        log.warning("pool worker died; starting it again "
                                    "and retrying job %s once", job)
                        continue
                    raise
                except TimeoutError:
                    # a wedged worker is useless: kill it, but do not run
                    # the job again (that would double the wait)
                    from kind_tpu_sim_torch import metrics

                    proc.kill()
                    self._proc = None
                    metrics.recovery_log().record(
                        "worker_hang_killed", slot=0, job=job)
                    raise
                break
        if not resp.get("ok"):
            raise JobError(resp.get("error", "job failed"),
                           resp.get("traceback", ""))
        return resp.get("result")

    def worker_pids(self) -> List[int]:
        return [self._proc.pid] if self._proc is not None else []

    def bringup(self, timeout: float = 120.0) -> dict:
        """The worker's hello: its pid, the measured ``warm_s`` (torch's
        import and the world's bring-up) and the world's size."""
        info = dict(self.submit("ping", timeout=timeout))
        info.update(self._proc.hello)
        return info

    # -- health -------------------------------------------------------

    def check_health(self) -> List[dict]:
        """One liveness row per slot (this pool has one): pid, alive,
        busy, uptime. The heartbeat's observable."""
        proc = self._proc
        return [{
            "slot": 0,
            "pid": proc.pid if proc is not None else None,
            "alive": bool(proc is not None and proc.alive()),
            "busy": self._lock.locked(),
            "uptime_s": (round(time.monotonic() - proc.spawned_at, 3)
                         if proc is not None else None),
        }]

    def start_heartbeat(self, interval_s: float = 5.0) -> None:
        """A background liveness sweep every ``interval_s``: a dead idle
        worker is started again at once (not at its next job), so a pool
        that sat through a kill is warm before the next submission. A
        busy worker is left to its job, whose crash path owns it."""
        if self._hb_thread is not None:
            return
        self._hb_stop.clear()

        def sweep() -> None:
            while not self._hb_stop.wait(interval_s):
                if not self._lock.acquire(blocking=False):
                    continue
                try:
                    if self._closed:
                        return
                    alive = self._proc is not None and self._proc.alive()
                    if self._health is not None:
                        self._health.record_probe(
                            "pool-0", ok=alive, now=time.monotonic())
                    if alive:
                        continue
                    self._respawn(reason="heartbeat")
                    if self._health is not None:
                        self._health.restore("pool-0", time.monotonic(),
                                             reason="respawned")
                finally:
                    self._lock.release()

        self._hb_thread = threading.Thread(
            target=sweep, name="kts-pool-heartbeat", daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        if self._hb_thread is None:
            return
        self._hb_stop.set()
        self._hb_thread.join(timeout=5)
        self._hb_thread = None

    def _respawn(self, reason: str = "crash") -> None:
        """A new worker in the old one's place (the caller holds the
        lock). A respawn heals: the injected fault, if any, applies to
        the first worker only, so recovery converges."""
        from kind_tpu_sim_torch import metrics

        if self._proc is not None:
            self._proc.kill()
        self.respawns += 1
        env = dict(self._env)
        env.pop(CHAOS_FAULT_ENV, None)
        self._proc = _WorkerProc(env, cmd=self._cmd)
        metrics.recovery_log().record(
            "worker_respawn", slot=0, reason=reason, pid=self._proc.pid)

    def close(self) -> None:
        self.stop_heartbeat()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._proc is not None:
                self._proc.shutdown()

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------
# cold grids


def run_grid(worker_envs: Sequence[Dict[str, str]], target: str,
             timeout: float,
             kwargs_list: Optional[Sequence[dict]] = None,
             max_respawns: int = 0,
             detector=None) -> List:
    """One cold worker per environment in ``worker_envs`` runs ``target``
    (a ``module:attr`` callable, with ``kwargs_list[i]`` for worker i);
    the results in spawn order. A worker that crashes raises
    RuntimeError with its stderr tail (the rest are killed); workers
    still running at the deadline raise TimeoutError.

    ``max_respawns`` > 0 heals: a worker that dies before answering is
    started again (its environment, the injected fault stripped) and its
    job resent, up to that many times a worker; the results equal a
    fault-free run's, each job being a pure function of its environment
    and kwargs. ``detector`` (a ``health.FailureDetector``) observes each
    worker's reported job time as component ``grid-worker-<i>``."""
    from kind_tpu_sim_torch import metrics

    def send_job(proc: _WorkerProc, worker: int) -> None:
        proc.send({
            "id": worker, "job": "call",
            "kwargs": {
                "target": target,
                "kwargs": kwargs_list[worker] if kwargs_list else {},
            },
        })

    procs: List[_WorkerProc] = []
    with tempfile.TemporaryDirectory() as logdir:
        logs = pathlib.Path(logdir)
        try:
            for worker, extra in enumerate(worker_envs):
                env = _pool_child_env(extra, warm=False)
                procs.append(_WorkerProc(
                    env, stderr_path=logs / f"worker-{worker}.err"))
            deadline = time.monotonic() + timeout
            for worker, proc in enumerate(procs):
                try:
                    send_job(proc, worker)
                except WorkerCrash:
                    raise RuntimeError(
                        f"slice worker {worker} crashed at spawn "
                        f"(rc={proc.proc.poll()}):\n{proc.stderr_tail()}")
            results: List = [None] * len(procs)
            pending = set(range(len(procs)))
            respawns_left = [max_respawns] * len(procs)
            while pending:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"slice workers {sorted(pending)} still running "
                        f"after {timeout}s")
                for worker in sorted(pending):
                    proc = procs[worker]
                    try:
                        frame = proc.read_frame(
                            min(deadline, time.monotonic() + 0.25))
                    except TimeoutError:
                        continue
                    except WorkerCrash:
                        rc = proc.proc.poll()
                        if respawns_left[worker] <= 0:
                            raise RuntimeError(
                                f"slice worker {worker} crashed "
                                f"(rc={rc}):\n{proc.stderr_tail()}")
                        respawns_left[worker] -= 1
                        proc.kill()
                        env = _pool_child_env(worker_envs[worker], warm=False)
                        env.pop(CHAOS_FAULT_ENV, None)
                        retry_no = max_respawns - respawns_left[worker]
                        fresh = _WorkerProc(
                            env, stderr_path=logs
                            / f"worker-{worker}-r{retry_no}.err")
                        procs[worker] = fresh
                        metrics.recovery_log().record(
                            "grid_worker_respawn", worker=worker, rc=rc,
                            retry=retry_no)
                        log.warning(
                            "grid worker %d died (rc=%s); respawning and "
                            "resending its job (%d/%d)", worker, rc,
                            retry_no, max_respawns)
                        try:
                            send_job(fresh, worker)
                        except WorkerCrash:
                            raise RuntimeError(
                                f"slice worker {worker} crashed at respawn "
                                f"(rc={fresh.proc.poll()}):\n"
                                f"{fresh.stderr_tail()}")
                        continue
                    if frame.get("hello"):
                        continue  # the cold hello precedes the result
                    if not frame.get("ok"):
                        raise RuntimeError(
                            f"slice worker {worker} job failed: "
                            f"{frame.get('error')}\n"
                            f"{frame.get('traceback', '')[-1000:]}")
                    if (detector is not None
                            and frame.get("elapsed_s") is not None):
                        detector.observe(f"grid-worker-{worker}",
                                         float(frame["elapsed_s"]),
                                         now=time.monotonic())
                    results[worker] = frame.get("result")
                    pending.discard(worker)
            return results
        finally:
            for proc in procs:
                proc.kill()


def run_cells(worker_envs: Sequence[Dict[str, str]], target: str,
              cells: Sequence[dict], timeout: float,
              cell_timeout: Optional[float] = None,
              max_respawns: int = 1,
              fault: Optional[tuple] = None,
              detect: bool = False,
              health_cfg=None,
              batch: int = 1):
    """Grid cells over cold workers, each worker pulling the next
    unclaimed cell, so the grid drains at the survivors' speed when a
    worker dies.

    A worker that crashes or hangs mid-cell has that cell requeued, for a
    survivor or for the worker's own respawn while it has budget (the
    injected fault stripped: a chaos fault is transient). A hang is
    caught by ``cell_timeout`` and the wedged worker killed. Results are
    indexed by cell, so a faulted run returns what the fault-free run
    returns (each cell is a pure function of its kwargs). A cell whose
    job raises fails the whole run (retrying would re-raise).

    ``fault``: ("crash" | "hang", cell_index[, seconds]) sends a crash or
    hang job in that cell's place on its first dispatch, once;
    ("straggler" | "flaky", worker_index, stall_s) plants ``slow@1:S`` /
    ``flaky@2:S`` in that worker's environment (alive, correct, slow).

    ``detect=True`` turns the gray-failure layer on (``health.py``,
    thresholds from ``health_cfg`` or the ``KIND_TPU_SIM_HEALTH_*``
    knobs): each worker is probed (a ping bounded by ``probe_timeout_s``)
    before it may pull cells, and a failed probe quarantines it until a
    respawn (budget permitting) replaces and restores it; cell service
    times feed the phi-accrual detector, and a worker it quarantines
    stops pulling cells and is respawned while budget remains; once the
    queue is empty, the oldest tail cell still in flight past
    ``spec_age_ratio`` x the expected service time gets one speculative
    copy on an idle worker, the first result winning.

    ``batch`` > 1 sends up to that many cells a round trip
    (``call_batch``), results position-equal; a crashed batch requeues
    every unfinished member. Under ``fault`` or ``detect`` batching is
    off: a planted fault targets a request.

    Returns ``(results, stats)``: results in cell order; stats with the
    requeue, respawn, fault, probe, quarantine and speculation counts,
    ``makespan_s`` (first dispatch to last completion) and, with
    ``detect``, the detector's transitions (no wall times). The events
    go to ``metrics.recovery_log()`` and ``metrics.health_board()``.
    """
    from kind_tpu_sim_torch import metrics

    detector = None
    hcfg = None
    if detect:
        from kind_tpu_sim_torch import health as health_mod

        hcfg = health_cfg or health_mod.DetectorConfig.from_env()
        detector = health_mod.FailureDetector(hcfg)

    gray_fault = (fault if fault is not None
                  and fault[0] in ("straggler", "flaky") else None)
    cell_fault = fault if gray_fault is None else None
    if fault is not None or detect:
        batch = 1
    batch = max(1, int(batch))

    deadline = time.monotonic() + timeout
    cond = threading.Condition()
    all_done = threading.Event()
    todo: List[int] = list(range(len(cells)))
    inflight: set = set()
    dispatch_t: Dict[int, float] = {}
    spec_extra: Dict[int, int] = {}
    fatal: List[BaseException] = []
    results: List = [None] * len(cells)
    ok: List[bool] = [False] * len(cells)
    done_count = [0]
    span = [None, None]  # first dispatch, last completion
    stats = {"workers": len(worker_envs), "requeues": 0,
             "respawns": 0, "faults_injected": 0,
             "probes": 0, "probe_failures": 0,
             "quarantines": 0, "speculative": 0}
    fault_budget = [1 if cell_fault else 0]

    def next_cells() -> Optional[List[int]]:
        with cond:
            while True:
                if fatal or time.monotonic() > deadline:
                    return None
                if todo:
                    picked = todo[:batch]
                    del todo[:len(picked)]
                    now = time.monotonic()
                    for idx in picked:
                        inflight.add(idx)
                        dispatch_t.setdefault(idx, now)
                    if span[0] is None:
                        span[0] = now
                    return picked
                if not inflight:
                    return None
                if detector is not None:
                    idx = _pick_speculative()
                    if idx is not None:
                        return [idx]
                cond.wait(0.05)

    def _pick_speculative() -> Optional[int]:
        # the caller holds cond: the oldest tail cell in flight, once
        # past spec_age_ratio x the expected service time, earns ONE
        # speculative copy
        expected = detector.expected_s()
        if expected is None:
            return None
        now = time.monotonic()
        for idx in sorted(inflight, key=lambda i: dispatch_t.get(i, now)):
            if ok[idx] or spec_extra.get(idx, 0) >= 1:
                continue
            age = now - dispatch_t.get(idx, now)
            if age > hcfg.spec_age_ratio * expected:
                spec_extra[idx] = spec_extra.get(idx, 0) + 1
                stats["speculative"] += 1
                metrics.health_board().incr("speculative_redispatch")
                metrics.recovery_log().record(
                    "cell_speculated", cell=idx, age_s=round(age, 3))
                return idx
        return None

    def finish(idx: int, success: bool) -> None:
        with cond:
            inflight.discard(idx)
            if success:
                if not ok[idx]:
                    ok[idx] = True
                    done_count[0] += 1
                    span[1] = time.monotonic()
                    if done_count[0] == len(cells):
                        all_done.set()
            elif not ok[idx] and idx not in todo:
                todo.insert(0, idx)
                stats["requeues"] += 1
            cond.notify_all()

    def probe(proc: _WorkerProc, comp: str) -> bool:
        """A bounded ping before the worker may pull cells; its round
        trip is not a service-time sample (pings and cells are different
        distributions): the verdict is binary."""
        stats["probes"] += 1
        try:
            proc.request({"id": -1, "job": "ping"},
                         time.monotonic() + hcfg.probe_timeout_s)
        except (WorkerCrash, TimeoutError):
            stats["probe_failures"] += 1
            if detector.record_probe(
                    comp, ok=False, now=time.monotonic()) == "quarantined":
                stats["quarantines"] += 1
            return False
        detector.record_probe(comp, ok=True, now=time.monotonic())
        return True

    def respawn(env: Dict[str, str], proc: _WorkerProc,
                worker: int) -> _WorkerProc:
        proc.kill()
        with cond:
            stats["respawns"] += 1
        env.pop(CHAOS_FAULT_ENV, None)
        fresh = _WorkerProc(env)
        metrics.recovery_log().record(
            "cell_worker_respawn", worker=worker, pid=fresh.pid)
        return fresh

    def _drive_batch(proc: _WorkerProc, worker: int,
                     idxs: List[int]) -> str:
        """One batched dispatch (no fault, no detection): "ok", "crash"
        (requeued; the caller may respawn) or "stop" (a job error or a
        cancellation)."""
        cell_deadline = deadline
        if cell_timeout is not None:
            cell_deadline = min(
                deadline, time.monotonic() + cell_timeout * len(idxs))
        req = {"id": idxs[0], "job": "call_batch",
               "kwargs": {"target": target,
                          "kwargs_list": [dict(cells[i]) for i in idxs]}}
        try:
            resp = proc.request(req, cell_deadline, cancel=all_done)
        except WorkerCancelled:
            proc.kill()
            return "stop"
        except (WorkerCrash, TimeoutError) as exc:
            for idx in idxs:
                finish(idx, False)
            metrics.recovery_log().record(
                "cell_requeued", cell=idxs[0], worker=worker,
                cause=type(exc).__name__, batch=len(idxs))
            proc.kill()
            return "crash"
        if not resp.get("ok"):
            with cond:
                fatal.append(RuntimeError(
                    f"cells {idxs} failed on worker {worker}: "
                    f"{resp.get('error')}\n"
                    f"{resp.get('traceback', '')[-1000:]}"))
                cond.notify_all()
            return "stop"
        for pos, idx in enumerate(idxs):
            results[idx] = resp["result"][pos]
            finish(idx, True)
        return "ok"

    def drive(worker: int) -> None:
        env = _pool_child_env(worker_envs[worker], warm=False)
        if (gray_fault is not None
                and gray_fault[1] % len(worker_envs) == worker):
            stall = float(gray_fault[2] if len(gray_fault) > 2 else 1.0)
            env[CHAOS_FAULT_ENV] = (
                f"slow@1:{stall}" if gray_fault[0] == "straggler"
                else f"flaky@2:{stall}")
            with cond:
                stats["faults_injected"] += 1
            metrics.recovery_log().record(
                "fault_injected", kind=gray_fault[0], worker=worker)
        proc = _WorkerProc(env)
        comp = f"worker-{worker}"
        respawns_left = max_respawns
        try:
            if detector is not None:
                healthy = probe(proc, comp)
                while not healthy:
                    if respawns_left <= 0:
                        return  # quarantined for good; the others drain
                    respawns_left -= 1
                    proc = respawn(dict(env), proc, worker)
                    healthy = probe(proc, comp)
                    if healthy:
                        detector.restore(comp, time.monotonic(),
                                         reason="respawned")
            while True:
                idxs = next_cells()
                if idxs is None:
                    return
                if len(idxs) > 1:
                    status = _drive_batch(proc, worker, idxs)
                    if status == "ok":
                        continue
                    if status == "crash":
                        if respawns_left <= 0:
                            return  # the survivors drain the requeue
                        respawns_left -= 1
                        proc = respawn(dict(env), proc, worker)
                        continue
                    return
                idx = idxs[0]
                cell_deadline = deadline
                if cell_timeout is not None:
                    cell_deadline = min(deadline,
                                        time.monotonic() + cell_timeout)
                req = {"id": idx, "job": "call",
                       "kwargs": {"target": target,
                                  "kwargs": dict(cells[idx])}}
                if cell_fault is not None and idx == cell_fault[1]:
                    with cond:
                        inject = fault_budget[0] > 0
                        if inject:
                            fault_budget[0] -= 1
                            stats["faults_injected"] += 1
                    if inject:
                        if cell_fault[0] == "crash":
                            req = {"id": idx, "job": "crash", "kwargs": {}}
                        elif cell_fault[0] == "hang":
                            req = {"id": idx, "job": "hang",
                                   "kwargs": {"seconds": float(
                                       cell_fault[2] if len(cell_fault) > 2
                                       else 3600.0)}}
                        metrics.recovery_log().record(
                            "fault_injected", kind=cell_fault[0], cell=idx,
                            worker=worker)
                t0 = time.monotonic()
                try:
                    resp = proc.request(req, cell_deadline, cancel=all_done)
                except WorkerCancelled:
                    # the grid finished through a speculative copy while
                    # this worker still held its cell
                    proc.kill()
                    return
                except (WorkerCrash, TimeoutError) as exc:
                    finish(idx, False)
                    metrics.recovery_log().record(
                        "cell_requeued", cell=idx, worker=worker,
                        cause=type(exc).__name__)
                    proc.kill()
                    if respawns_left <= 0:
                        return  # the survivors drain the requeued cell
                    respawns_left -= 1
                    proc = respawn(dict(env), proc, worker)
                    continue
                if not resp.get("ok"):
                    with cond:
                        fatal.append(RuntimeError(
                            f"cell {idx} failed on worker {worker}: "
                            f"{resp.get('error')}\n"
                            f"{resp.get('traceback', '')[-1000:]}"))
                        cond.notify_all()
                    return
                results[idx] = resp.get("result")
                finish(idx, True)
                if detector is not None:
                    transition = detector.observe(
                        comp, time.monotonic() - t0, now=time.monotonic())
                    if transition == "quarantined":
                        with cond:
                            stats["quarantines"] += 1
                        proc.kill()
                        if respawns_left <= 0:
                            return  # rebalanced away for good
                        respawns_left -= 1
                        proc = respawn(dict(env), proc, worker)
                        if not probe(proc, comp):
                            return
                        detector.restore(comp, time.monotonic(),
                                         reason="respawned")
        finally:
            proc.kill()
            with cond:
                cond.notify_all()

    threads = [threading.Thread(target=drive, args=(w,),
                                name=f"kts-cells-{w}", daemon=True)
               for w in range(len(worker_envs))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=max(0.0, deadline - time.monotonic()) + 10.0)
    if span[0] is not None and span[1] is not None:
        stats["makespan_s"] = round(span[1] - span[0], 6)
    if detector is not None:
        # transitions only (no wall times): the shape a scenario's report
        # embeds stays the same from run to run
        stats["detection"] = [
            {"component": e["component"], "transition": e["transition"]}
            for e in detector.events]
    if fatal:
        raise fatal[0]
    missing = [i for i, done in enumerate(ok) if not done]
    if missing:
        raise TimeoutError(
            f"cells {missing} unfinished after {timeout}s "
            f"(requeues={stats['requeues']}, "
            f"respawns={stats['respawns']})")
    return results, stats


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--serve" in argv:
        return _serve(argv)
    print("usage: python -m kind_tpu_sim_torch.utils.worker_pool --serve "
          "[--world N --backend B --device D --timeout S]", file=sys.stderr)
    return 2


if __name__ == "__main__":
    # through the imported module, so the ranks unpickle its functions
    from kind_tpu_sim_torch.utils import worker_pool

    sys.exit(worker_pool.main())
