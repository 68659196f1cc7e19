"""Persistent worker with a live ``torch.distributed`` world: the port's
counterpart of ``kind_tpu_sim/utils/worker_pool.py``, as far as the
``torch-smoke`` command needs it.

The reference keeps long-lived JAX workers so that ``import jax``, the
backend's start and XLA's compiles are paid once per session, and
submits jobs to them over a length-prefixed JSON protocol on each
worker's stdin and stdout. Here a worker pays ``import torch`` and the
bring-up of a world of ``world`` ranks once; every later job runs in
that same live world, on the same processes and process groups.

Protocol (both directions, the reference's): a 4-byte big-endian
length, then a UTF-8 JSON object. The worker's first frame is a hello
with its pid, the seconds its warm-up took (``warm_s``) and what it
brought up; every later frame answers one request, in order::

    request:  {"id": 3, "job": "collectives_suite", "kwargs": {...}}
    response: {"id": 3, "ok": true, "result": {...}, "elapsed_s": 0.04}

The worker writes frames to its original stdout and points file
descriptor 1 at stderr first, so a stray print cannot corrupt the
framing.

The world: the worker process is rank 0, and it starts ``world - 1``
rank processes (the ``spawn`` start method) that join it over a
``file://`` store and then wait for jobs on a queue of their own.
A job of ``RANK_JOBS`` (``collectives_suite``) is handed to every rank
and run by all of them together; ``ping`` runs in the worker alone. A
mesh is made once per topology and kept, so a resubmission starts no
process and no process group. The worker brings its world up before its
hello (the reference's warm start; its cold start serves the simulator's
grids, which the port does not carry); if the world fails to come up,
the hello carries the error and every rank job fails with it.

Failure contract (the reference's): a job that raises returns ``ok:
false`` and surfaces as ``JobError``, the worker stays up; a worker
that dies mid-job is started again and the job retried once, and a
second death raises ``WorkerCrash`` with the worker's stderr tail; a
job past its deadline kills the worker and raises ``TimeoutError``
without a retry. The rank processes end with the worker: at its
shutdown, or when they see their parent gone.

Not ported, because they feed the simulator's chaos engine, which the
port does not carry: the reference's cold grids (``run_grid``,
``run_cells``), its heartbeat, its shared-memory transport and its
injected faults.
"""

from __future__ import annotations

import argparse
import json
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
from typing import Dict, List, Optional

# A frame bigger than this is protocol corruption, not data.
MAX_FRAME_BYTES = 64 * 1024 * 1024

_PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[2]


class JobError(RuntimeError):
    """The job raised inside the worker (the worker itself is healthy)."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback


class WorkerCrash(RuntimeError):
    """The worker process died before answering."""


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


# jobs every rank of the world runs together, and jobs of the worker alone
RANK_JOBS = {"collectives_suite": _job_collectives_suite}
JOBS = {"ping": _job_ping, **RANK_JOBS}


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
    shutdown request."""
    import traceback

    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", required=True)
    ap.add_argument("--timeout", type=float, required=True)
    args = ap.parse_args(argv)

    # the protocol on the ORIGINAL stdout; fd 1 (and the rank processes,
    # which inherit it) to stderr
    proto_fd = os.dup(1)
    os.dup2(2, 1)
    out = os.fdopen(proto_fd, "wb")
    inp = sys.stdin.buffer

    world = _World(args.world, args.backend, args.device, args.timeout)
    hello = {"hello": True, "pid": os.getpid()}
    try:
        t0 = time.monotonic()
        try:
            hello.update(world.up())
            hello["warm_s"] = round(time.monotonic() - t0, 3)
        except Exception as exc:  # surfaced to the parent, not fatal
            hello["warm_error"] = f"{type(exc).__name__}: {exc}"[:500]
        write_frame(out, hello)
        while True:
            try:
                req = read_frame(inp)
            except EOFError:
                return 1
            if req is None or req.get("op") == "shutdown":
                return 0
            resp = {"id": req.get("id")}
            t0 = time.monotonic()
            try:
                resp["result"] = world.run(req["job"],
                                           req.get("kwargs") or {})
                resp["ok"] = True
            except Exception as exc:
                resp["ok"] = False
                resp["error"] = f"{type(exc).__name__}: {exc}"[:2000]
                resp["traceback"] = traceback.format_exc()[-2000:]
            resp["elapsed_s"] = round(time.monotonic() - t0, 6)
            write_frame(out, resp)
    finally:
        world.close()


# ---------------------------------------------------------------------
# parent side


class _WorkerProc:
    """One protocol worker process, its read buffer and its stderr log."""

    def __init__(self, cmd: List[str], env: Dict[str, str]):
        self._buf = b""
        self.hello: Optional[dict] = None
        fd, name = tempfile.mkstemp(prefix="kts-worker-", suffix=".err")
        self.stderr_path = pathlib.Path(name)
        self._stderr_file = os.fdopen(fd, "wb")
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._stderr_file, env=env)

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

    def read_frame(self, deadline: float):
        """One frame from the worker's stdout, or raise: WorkerCrash on
        EOF or death, TimeoutError past ``deadline``."""
        fd = self.proc.stdout.fileno()
        sel = selectors.DefaultSelector()
        sel.register(self.proc.stdout, selectors.EVENT_READ)
        try:
            while True:
                frame, self._buf = _try_parse(self._buf)
                if frame is not None:
                    return frame
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise TimeoutError(
                        f"worker {self.pid} gave no answer in time")
                if not sel.select(timeout=min(remain, 1.0)):
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

    def request(self, req: dict, deadline: float) -> dict:
        if self.hello is None:
            self.hello = self.read_frame(deadline)
        try:
            write_frame(self.proc.stdin, req)
        except (BrokenPipeError, OSError) as exc:
            raise WorkerCrash(f"worker {self.pid} pipe closed: {exc}; "
                              f"{self.stderr_tail()}") from exc
        return self.read_frame(deadline)

    def kill(self) -> None:
        if self.alive():
            self.proc.kill()
        self.proc.wait(timeout=10)
        self.close_files()

    def shutdown(self, grace_s: float = 30.0) -> None:
        """Ask the worker to stop (it stops its ranks first), then make
        sure it has."""
        try:
            if self.alive():
                write_frame(self.proc.stdin, {"op": "shutdown"})
                self.proc.stdin.close()
                self.proc.wait(timeout=grace_s)
        except (OSError, subprocess.TimeoutExpired):
            pass
        self.kill()

    def close_files(self) -> None:
        for f in (self.proc.stdin, self.proc.stdout, self._stderr_file):
            try:
                f.close()
            except OSError:
                pass
        try:
            self.stderr_path.unlink()
        except OSError:
            pass


class WorkerPool:
    """One protocol worker (the reference pool's default size) with its
    world of ``world`` ranks over ``backend`` on ``device`` (the card
    unless the caller asks for the CPU; without a card this raises).
    The worker is started warm: it brings its world up before its hello.
    Jobs run one at a time, in the order submitted."""

    def __init__(self, *, world: int, backend: str, device: str = "cuda",
                 job_timeout: float = 300.0):
        from kind_tpu_sim_torch.device import resolve

        resolve(device)  # no card raises, unless the caller asks for the CPU
        if backend not in ("gloo", "nccl"):
            raise ValueError(
                f"backend must be 'gloo' or 'nccl'; got {backend!r}")
        if world < 1:
            raise ValueError(f"a world needs at least one rank; got {world}")
        self._cmd = [sys.executable, "-m", "kind_tpu_sim_torch.utils."
                     "worker_pool", "--serve", "--world", str(world),
                     "--backend", backend, "--device", str(device),
                     "--timeout", str(job_timeout)]
        self._env = dict(os.environ)
        self._env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(_PACKAGE_ROOT), os.environ.get("PYTHONPATH"))
            if p)
        self._timeout = job_timeout
        self._lock = threading.Lock()
        self._next_id = 0
        self._closed = False
        self.respawns = 0
        self._proc: Optional[_WorkerProc] = _WorkerProc(self._cmd, self._env)

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
                        continue
                    raise
                except TimeoutError:
                    # a wedged worker is useless: kill it, but do not run
                    # the job again (that would double the wait)
                    proc.kill()
                    self._proc = None
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

    def _respawn(self) -> None:
        if self._proc is not None:
            self._proc.kill()
        self.respawns += 1
        self._proc = _WorkerProc(self._cmd, self._env)

    def close(self) -> None:
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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--serve" in argv:
        return _serve(argv)
    print("usage: python -m kind_tpu_sim_torch.utils.worker_pool --serve "
          "--world N --backend B --device D --timeout S", file=sys.stderr)
    return 2


if __name__ == "__main__":
    # through the imported module, so the ranks unpickle its functions
    from kind_tpu_sim_torch.utils import worker_pool

    sys.exit(worker_pool.main())
