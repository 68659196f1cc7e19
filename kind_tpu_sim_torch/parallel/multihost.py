"""The multi-host slice, in PyTorch: identity from the environment, the
cross-host smokes, and local launchers for one slice and for several.

Counterpart of ``kind_tpu_sim/parallel/multihost.py``. There one JAX
process a simulated host holds the host's chips as XLA devices; here a
device is a rank (one process each, ``parallel/mesh.py``), so a
simulated host is a process that starts one rank a chip into a world of
hosts x chips ranks, configured only by the environment the device
plugin injects (``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``,
``TPU_CHIPS_PER_HOST_BOUNDS``, ``TPU_SIM_COORDINATOR_PORT``, and
``MEGASCALE_*`` in a multislice job). Host h's chip c is rank h * chips
+ c, and the ranks meet at ``tcp://<first hostname>:<port>``. A
single-host identity, or none, skips the cross-host rendezvous: that
host's ranks form their own world.

A worker's report has the reference's keys: ``process_index`` is the
host's worker id, ``process_count`` the number of hosts,
``local_devices`` its chips and ``global_devices`` the world's ranks.
``launch_local_slice`` and ``launch_local_multislice`` start one host
process per simulated host on this machine and read each host's report
from a file of its own (a stray print cannot corrupt it); bind
failures, rendezvous timeouts and crashed workers are relaunched with
fresh ports, a job that failed is not.

The caller names the device and the backend (``gloo`` by default, as
the reference's workers use gloo; NCCL takes one rank a card).

:func:`grid_cell_probe` and :func:`scatter_grid_cells` fan independent
grid cells out over cold workers (``utils/worker_pool.run_cells``), the
simulator's worker-grid chaos scenarios' work unit. A cold worker that
runs ``grid_cell_probe`` imports this module, so the module imports no
torch: the functions that need torch import it themselves. A cold worker
reaches its hello and its first cell in a fraction of a second instead
of paying torch's import (seconds), which would pass a grid's deadlines
(``worker-hang-grid``'s 3 s a cell, the straggler grid's 0.8 s probe)
and skew the detector's service-time baseline.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Tuple

from kind_tpu_sim_torch.topology import DEFAULT_COORDINATOR_PORT

log = logging.getLogger("kind-tpu-sim-torch")

_PACKAGE_ROOT = Path(__file__).resolve().parents[2]
_BIND_ERRORS = ("address already in use", "failed to bind",
                "eaddrinuse", "bind failed")


@dataclasses.dataclass
class HostIdentity:
    worker_id: int
    hostnames: List[str]
    coordinator_port: int = DEFAULT_COORDINATOR_PORT

    @property
    def num_processes(self) -> int:
        return len(self.hostnames)

    @property
    def coordinator_address(self) -> str:
        return f"{self.hostnames[0]}:{self.coordinator_port}"


def identity_from_env(environ=None) -> Optional[HostIdentity]:
    """The plugin-injected worker identity; None if not present."""
    env = os.environ if environ is None else environ
    hostnames = [
        h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h
    ]
    worker_id_raw = env.get("TPU_WORKER_ID")
    if not hostnames or worker_id_raw is None:
        return None
    try:
        worker_id = int(worker_id_raw)
    except ValueError:
        return None
    if not 0 <= worker_id < len(hostnames):
        return None
    port_raw = env.get("TPU_SIM_COORDINATOR_PORT",
                       str(DEFAULT_COORDINATOR_PORT))
    try:
        port = int(port_raw)
    except ValueError:
        port = DEFAULT_COORDINATOR_PORT
    return HostIdentity(worker_id=worker_id, hostnames=hostnames,
                        coordinator_port=port)


def _chips_from_env(environ=None) -> int:
    env = os.environ if environ is None else environ
    bounds = env.get("TPU_CHIPS_PER_HOST_BOUNDS", "1,1,1")
    chips = 1
    for dim in bounds.split(","):
        chips *= int(dim)
    return max(1, chips)


def rendezvous(identity: Optional[HostIdentity],
               chips: int) -> Optional[Tuple[str, int, int]]:
    """(init method, this host's first rank, world size) of the
    cross-host world; None for a single host (or no identity)."""
    if identity is None or identity.num_processes == 1:
        return None
    return (f"tcp://{identity.coordinator_address}",
            identity.worker_id * chips, identity.num_processes * chips)


def initialize_from_env(environ=None, local_rank: int = 0,
                        backend: str = "gloo",
                        timeout_s: float = 300.0) -> HostIdentity:
    """``torch.distributed.init_process_group`` of this process as chip
    ``local_rank`` of its host, from the simulated identity. A
    single-host identity, or none, skips it and returns a one-process
    identity, so the same program runs on one host or a slice."""
    import datetime

    import torch.distributed as dist

    identity = identity_from_env(environ)
    world = rendezvous(identity, _chips_from_env(environ))
    if world is None:
        log.info("single-process mode (no multi-host identity in env)")
        return identity or HostIdentity(worker_id=0, hostnames=["localhost"])
    init_method, first, size = world
    log.info("initializing torch.distributed: rank %d/%d, coordinator %s",
             first + local_rank, size, identity.coordinator_address)
    dist.init_process_group(
        backend, init_method=init_method, rank=first + local_rank,
        world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
    return identity


def _device() -> "torch.device":  # noqa: F821
    from kind_tpu_sim_torch.parallel import launch

    return launch.rank_device()


def global_device_report(environ=None) -> dict:
    """What a worker reports of its place: the reference's keys (a
    device is a rank)."""
    import torch.distributed as dist

    identity = identity_from_env(environ)
    return {
        "process_index": 0 if identity is None else identity.worker_id,
        "process_count": 1 if identity is None else identity.num_processes,
        "local_devices": _chips_from_env(environ),
        "global_devices": dist.get_world_size(),
    }


def slice_smoke(environ=None) -> dict:
    """Cross-host collective proof over the ('host', 'chip') mesh of
    the world, called on every rank: a global sum to which every chip
    of host i gives i + 1 (it must cross the hosts), and a rotation of
    those values over 'host' (point to point between hosts). Returns
    this rank's host's report (every chip of it the same)."""
    import torch
    import torch.distributed as dist

    from kind_tpu_sim_torch.parallel import tp
    from kind_tpu_sim_torch.parallel.mesh import Mesh

    local = _chips_from_env(environ)
    n_proc = dist.get_world_size() // local
    mesh = Mesh((n_proc, local), ("host", "chip"))
    me = mesh.coords["host"]
    x = torch.full((1,), float(me + 1), device=_device())
    total_t = x.clone()
    dist.all_reduce(total_t)
    total = float(total_t[0])
    want_total = local * n_proc * (n_proc + 1) / 2

    host = tp.axis(mesh, "host")
    got_t = x if n_proc == 1 else tp.start_exchange(
        x, host.ranks[(me + 1) % n_proc], host.ranks[(me - 1) % n_proc]
    ).wait()
    got = set(tp.all_gather(got_t, tp.axis(mesh, "chip"), 0).tolist())
    want_rot = float((me - 1) % n_proc + 1)
    return {
        "psum_total": total,
        "psum_expected": want_total,
        "ppermute_got": sorted(got),
        "ppermute_expected": want_rot,
        "ok": abs(total - want_total) < 1e-6 and got == {want_rot},
    }


def ring_long_context_smoke(total_tokens: int = 32768,
                            head_dim: int = 64) -> dict:
    """Long-context proof over the whole world: ring attention on a
    sequence split over every rank (so the K/V hops cross the hosts),
    called on every rank. Checked analytically: with k = 0 every causal
    softmax is uniform, so for v[s] = s the output at position i is
    mean(0..i) = i / 2 exactly."""
    import torch
    import torch.distributed as dist

    from kind_tpu_sim_torch.parallel import tp
    from kind_tpu_sim_torch.parallel.mesh import Mesh
    from kind_tpu_sim_torch.parallel.ring_attention import ring_attention

    n = dist.get_world_size()
    if total_tokens % n:
        raise ValueError(f"{total_tokens} tokens not divisible by "
                         f"{n} devices")
    mesh = Mesh((n,), ("seq",))
    t_local = total_tokens // n
    dev = _device()
    pos = (mesh.coords["seq"] * t_local
           + torch.arange(t_local, device=dev, dtype=torch.float32))
    zeros = torch.zeros((1, t_local, 1, head_dim), device=dev)
    v = pos[None, :, None, None].expand(1, t_local, 1, head_dim).contiguous()
    dist.barrier()
    t0 = time.monotonic()
    with torch.no_grad():
        out = ring_attention(zeros, zeros, v, mesh, axis_name="seq",
                             causal=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()
    elapsed = time.monotonic() - t0
    want = pos / 2.0
    rel = ((out[0, :, 0, 0] - want).abs()
           / torch.clamp(want, min=1.0)).max()
    max_rel = float(tp.all_reduce(rel[None], tp.axis(mesh, "seq"),
                                  "max")[0])
    return {
        "ring_tokens": total_tokens,
        "ring_devices": int(n),
        "ring_seconds": round(elapsed, 3),
        "ring_max_rel_err": max_rel,
        "ring_ok": max_rel < 1e-5,
    }


def _worker_report() -> dict:
    """One rank of a simulated worker, driven by the environment
    contract alone; returns its host's report."""
    report = global_device_report()
    report.update(slice_smoke())
    # the cross-slice identity, echoed so the launcher can check that
    # the contract reached the worker
    for key in ("MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID"):
        if key in os.environ:
            report[key.lower()] = os.environ[key]
    ring_tokens = int(os.environ.get("TPU_SIM_RING_TOKENS", "0"))
    if ring_tokens:
        report.update(ring_long_context_smoke(ring_tokens))
        report["ok"] = report["ok"] and report["ring_ok"]
    return report


def _host_main(argv=None) -> int:
    """A simulated host: one rank a chip, joined into the slice's world
    (``rendezvous``), each running ``_worker_report``. The outcome goes
    to ``--report`` as JSON: ``{"report": ...}``, ``{"crashed": ...}``
    (a rank died) or ``{"failed": ...}`` (a rank raised)."""
    from kind_tpu_sim_torch.parallel import launch

    parser = argparse.ArgumentParser()
    parser.add_argument("--report", required=True)
    parser.add_argument("--device", required=True)
    parser.add_argument("--backend", required=True)
    parser.add_argument("--timeout", type=float, required=True)
    args = parser.parse_args(argv)
    chips = _chips_from_env()
    try:
        out = {"report": launch.spawn(
            _worker_report, chips, backend=args.backend, device=args.device,
            timeout_s=args.timeout,
            rendezvous=rendezvous(identity_from_env(), chips))}
    except Exception as exc:  # the host's outcome, handed to the launcher
        kind = "crashed" if " died " in str(exc) else "failed"
        out = {kind: f"{type(exc).__name__}: {exc}"}
    tmp = args.report + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(out, fh)
    os.replace(tmp, args.report)
    return 0


def _pick_ports(n: int) -> List[int]:
    """n distinct ephemeral ports: all sockets bound at once before any
    closes, so one call never gets the same port twice. The race with
    other processes between close and use remains; the launchers retry
    with fresh ports when a launch dies of a bind failure."""
    import socket

    socks = []
    try:
        for _ in range(n):
            sock = socket.socket()
            sock.bind(("127.0.0.1", 0))
            socks.append(sock)
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def _with_launch_retry(thunk, attempts: int):
    """Run a launch, retrying the transient failures: a bind failure,
    a rendezvous timeout (what a port collision can turn into) and a
    crashed worker (the whole world dies with it, so the unit of
    recovery is a clean relaunch). A worker whose job failed is
    deterministic and is not retried. Each retry is recorded as
    ``slice_relaunch`` in ``metrics.recovery_log()``."""
    from kind_tpu_sim_torch import metrics

    attempts = max(1, attempts)
    for attempt in range(attempts):
        try:
            return thunk()
        except (RuntimeError, TimeoutError) as exc:
            msg = str(exc).lower()
            retryable = (isinstance(exc, TimeoutError)
                         or any(pat in msg for pat in _BIND_ERRORS)
                         or ("crashed" in msg
                             and "job failed" not in msg))
            if not retryable or attempt == attempts - 1:
                raise
            metrics.recovery_log().record(
                "slice_relaunch", attempt=attempt + 1,
                cause=str(exc).splitlines()[0][:120])
            log.warning("slice launch attempt %d failed (%s); "
                        "relaunching", attempt + 1,
                        str(exc).splitlines()[0])
    raise AssertionError("unreachable")


def _tail(path: Path, n: int = 2000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def _launch_grid(worker_envs: List[dict], timeout: float, device: str,
                 backend: str) -> List[dict]:
    """One host process per env dict (each carrying the whole identity,
    its rendezvous port included), all at once; their reports in
    order. A host that exits without a report, or whose rank died,
    raises RuntimeError "crashed"; one whose rank raised, "job failed";
    hosts still running at the deadline are killed and raise
    TimeoutError."""
    tmp = Path(tempfile.mkdtemp(prefix="kts-slice-"))
    pythonpath = os.pathsep.join(
        p for p in (str(_PACKAGE_ROOT), os.environ.get("PYTHONPATH")) if p)
    procs = []
    try:
        for i, env in enumerate(worker_envs):
            full = {**os.environ, **env, "PYTHONPATH": pythonpath}
            with open(tmp / f"worker{i}.log", "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "kind_tpu_sim_torch.parallel.multihost",
                     "--report", str(tmp / f"worker{i}.json"),
                     "--device", device, "--backend", backend,
                     "--timeout", str(timeout)],
                    env=full, stdout=out, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            for i, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    raise RuntimeError(
                        f"slice worker {i} crashed (rc={p.returncode}):\n"
                        + _tail(tmp / f"worker{i}.log"))
            if time.monotonic() > deadline:
                pending = [i for i, p in enumerate(procs)
                           if p.poll() is None]
                raise TimeoutError(
                    f"slice workers {pending} still running after "
                    f"{timeout} s")
            time.sleep(0.05)
        reports = []
        for i, p in enumerate(procs):
            path = tmp / f"worker{i}.json"
            if p.returncode or not path.is_file():
                raise RuntimeError(
                    f"slice worker {i} crashed (rc={p.returncode}, no "
                    "report):\n" + _tail(tmp / f"worker{i}.log"))
            out = json.loads(path.read_text())
            if "crashed" in out:
                raise RuntimeError(f"slice worker {i} crashed: "
                                   f"{out['crashed']}")
            if "failed" in out:
                raise RuntimeError(f"slice worker {i} job failed: "
                                   f"{out['failed']}")
            reports.append(out["report"])
        return reports
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for f in tmp.iterdir():
            f.unlink()
        tmp.rmdir()


def _launch_once(s, timeout: float, device: str, backend: str,
                 ring_tokens: int = 0) -> List[dict]:
    port = _pick_ports(1)[0]
    n = s.num_hosts
    worker_envs = []
    for worker in range(n):
        env = dict(s.worker_env(worker, hostnames=["127.0.0.1"] * n))
        env["TPU_SIM_COORDINATOR_PORT"] = str(port)
        if ring_tokens:
            env["TPU_SIM_RING_TOKENS"] = str(ring_tokens)
        worker_envs.append(env)
    return _launch_grid(worker_envs, timeout, device, backend)


def launch_local_slice(topology: str = "2x2x2",
                       accelerator: str = "tpu-v4-podslice",
                       timeout: float = 300.0, attempts: int = 2,
                       ring_tokens: int = 0, device: str = "cuda",
                       backend: str = "gloo") -> List[dict]:
    """A whole simulated multi-host slice on this machine: one host
    process per simulated host, configured only through the plugin's
    environment contract, meeting over loopback, one rank a chip on
    ``device``. Returns each host's report (a failed check arrives as
    ``ok: False``; an exception means a worker crashed or the
    rendezvous timed out)."""
    from kind_tpu_sim_torch.device import resolve
    from kind_tpu_sim_torch.parallel import mesh

    resolve(device)  # no card raises, unless the caller asks for the CPU
    s = mesh.make_slice(accelerator=accelerator, topology=topology)
    return _with_launch_retry(
        lambda: _launch_once(s, timeout, device, backend,
                             ring_tokens=ring_tokens), attempts)


def launch_local_multislice(num_slices: int = 2, topology: str = "2x4",
                            accelerator: str = "tpu-v5-lite-podslice",
                            timeout: float = 300.0, attempts: int = 2,
                            device: str = "cuda",
                            backend: str = "gloo") -> List[List[dict]]:
    """A whole simulated multislice job on this machine: one host
    process per host per slice, each slice its own world on its own
    loopback port, every worker carrying the MEGASCALE_* contract.
    Returns the reports grouped by slice; raises if a worker crashes, a
    slice's world is the wrong size, or a worker's cross-slice identity
    is not its slice's."""
    from kind_tpu_sim_torch.device import resolve
    from kind_tpu_sim_torch.parallel import mesh

    resolve(device)  # no card raises, unless the caller asks for the CPU
    ms = mesh.make_multislice(num_slices, accelerator=accelerator,
                              topology=topology)
    h = ms.slice_topo.num_hosts

    def build_envs() -> List[dict]:
        ports = _pick_ports(num_slices)
        envs = []
        for sid in range(num_slices):
            for worker in range(h):
                env = dict(ms.worker_env(
                    sid, worker, hostnames=["127.0.0.1"] * h))
                env["TPU_SIM_COORDINATOR_PORT"] = str(ports[sid])
                envs.append(env)
        return envs

    flat = _with_launch_retry(
        lambda: _launch_grid(build_envs(), timeout, device, backend),
        attempts)
    per_slice = [flat[sid * h:(sid + 1) * h] for sid in range(num_slices)]
    chips = ms.slice_topo.num_chips
    for sid, reports in enumerate(per_slice):
        for rep in reports:
            if not rep.get("ok"):
                raise RuntimeError(f"slice {sid} worker failed: {rep}")
            if rep.get("global_devices") != chips:
                raise RuntimeError(
                    f"slice {sid} world has {rep.get('global_devices')} "
                    f"devices, wanted {chips} (slices must stay separate "
                    "worlds)")
            if rep.get("megascale_slice_id") != str(sid):
                raise RuntimeError(
                    f"slice {sid} worker carries megascale id "
                    f"{rep.get('megascale_slice_id')!r}")
            if rep.get("megascale_num_slices") != str(num_slices):
                raise RuntimeError(
                    f"bad MEGASCALE_NUM_SLICES in slice {sid}: "
                    f"{rep.get('megascale_num_slices')!r}")
    return per_slice


def grid_cell_probe(cell: int = 0, payload: int = 0,
                    spin: int = 0, sleep_s: float = 0.0) -> dict:
    """One deterministic grid cell, a pure function of (cell, payload):
    the work unit ``scatter_grid_cells``' recovery contract is held
    against (a faulted run returns exactly the fault-free results).
    ``spin`` burns a little CPU to widen a crash window without sleeping;
    ``sleep_s`` gives the cell a known service time for the gray-failure
    scenarios' makespans (it does not change the value)."""
    value = (cell * 2654435761 + payload * 97 + 12345) % (2 ** 32)
    for _ in range(max(0, spin)):
        value = (value * 6364136223846793005 + 1442695040888963407) \
            % (2 ** 64)
    if sleep_s > 0:
        time.sleep(sleep_s)
    return {"cell": cell, "payload": payload, "value": value}


def scatter_grid_cells(cells: List[dict],
                       target: str = (
                           "kind_tpu_sim_torch.parallel.multihost:"
                           "grid_cell_probe"),
                       workers: int = 2,
                       timeout: float = 120.0,
                       cell_timeout: Optional[float] = None,
                       chips: int = 1,
                       fault: Optional[tuple] = None,
                       max_respawns: int = 1,
                       detect: bool = False,
                       health_cfg=None):
    """Independent grid cells over ``workers`` cold simulated-slice
    workers with dead-worker recovery (``worker_pool.run_cells`` carries
    the scheduling; this adds the simulated host's environment and each
    worker's index as ``TPU_SIM_GRID_WORKER``).

    ``fault`` = ("crash" | "hang", cell_index[, seconds]) kills or wedges
    whichever worker draws that cell, once; ("straggler" | "flaky",
    worker_index, stall_s) makes that worker answer correctly but
    slowly. ``detect=True`` turns on probes, straggler quarantine and
    speculative tail re-dispatch (thresholds from ``health_cfg``).
    Returns (results, stats); results are cell-indexed and equal to a
    fault-free run's."""
    from kind_tpu_sim_torch.utils import worker_pool

    envs = []
    for w in range(workers):
        env = dict(worker_pool.simulated_slice_env(chips))
        env["TPU_SIM_GRID_WORKER"] = str(w)
        envs.append(env)
    return worker_pool.run_cells(
        envs, target, cells, timeout=timeout, cell_timeout=cell_timeout,
        max_respawns=max_respawns, fault=fault, detect=detect,
        health_cfg=health_cfg)


if __name__ == "__main__":
    # through the imported module, so the ranks unpickle its functions
    from kind_tpu_sim_torch.parallel import multihost

    raise SystemExit(multihost._host_main())
