"""The port's worker pool (kind_tpu_sim_torch/utils/worker_pool.py) and
its ``torch-smoke`` command against the reference's (utils/worker_pool.py,
``jax-smoke``), on the CPU host.

* the frame protocol writes the reference's bytes, reads the reference's
  frames, and refuses a truncated or implausible frame as the
  reference's does;
* ``torch-smoke --device cpu --backend gloo --chips 4 --topology 2x2
  --repeat 3 --json`` is ``ok`` with 4 devices, every warm run under the
  cold one (``tests/test_warm_path.py``'s bar), and the reference's
  report keys (read from ``run_jax_smoke``'s source);
* a pool's worker answers every resubmission from the same process and
  the same rank processes, its suite equal to the JAX package's
  ``collectives.run_all`` on the same topology over virtual devices, key
  for key; a job that raises leaves the worker up, and a worker that
  dies mid-job is started again and the job retried.
"""

import ast
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest

from kind_tpu_sim.utils import worker_pool as ref
from kind_tpu_sim_torch.utils import worker_pool as wp

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAMES = ({"id": 3, "job": "collectives_suite",
           "kwargs": {"topology": "2x2"}},
          {"hello": True, "pid": 7, "warm_s": 1.25}, [1, "two", None], {})


@pytest.mark.parametrize("obj", FRAMES)
def test_frames_equal_the_reference(obj):
    ours, theirs = io.BytesIO(), io.BytesIO()
    wp.write_frame(ours, obj)
    ref.write_frame(theirs, obj)
    assert ours.getvalue() == theirs.getvalue()
    for reader in (wp.read_frame, ref.read_frame):
        assert reader(io.BytesIO(ours.getvalue())) == obj
    assert wp._try_parse(ours.getvalue() + b"\x00") == (obj, b"\x00")


def test_truncated_frames_raise_as_the_reference():
    buf = io.BytesIO()
    wp.write_frame(buf, FRAMES[0])
    whole = buf.getvalue()
    huge = (wp.MAX_FRAME_BYTES + 1).to_bytes(4, "big")
    for cut, msg in ((whole[:2], "truncated frame header"),
                     (whole[:-1], "truncated frame payload"),
                     (huge, "implausible frame length")):
        for reader in (wp.read_frame, ref.read_frame):
            with pytest.raises(EOFError, match=msg):
                reader(io.BytesIO(cut))
    assert wp.read_frame(io.BytesIO(b"")) is None
    assert wp._try_parse(whole[:-1]) == (None, whole[:-1])
    with pytest.raises(wp.WorkerCrash, match="implausible"):
        wp._try_parse(huge)


def _reference_report_keys():
    tree = ast.parse((ROOT / "kind_tpu_sim" / "cli.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_jax_smoke")
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "report"):
            return {k.value for k in node.value.keys}
    raise AssertionError("run_jax_smoke builds no report")


def test_torch_smoke_cli_on_gloo_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "kind_tpu_sim_torch", "torch-smoke",
         "--device", "cpu", "--backend", "gloo", "--chips", "4",
         "--topology", "2x2", "--repeat", "3", "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(report) == _reference_report_keys()
    assert report["ok"] is True and report["devices"] == 4
    assert report["collectives"] == {"psum": True, "ppermute": True,
                                     "all_gather": True}
    assert len(report["warm_suite_s"]) == 2
    assert all(w < report["cold_suite_s"] for w in report["warm_suite_s"])
    assert 0 < report["worker_warm_s"] < report["cold_suite_s"]
    assert isinstance(report["worker_pid"], int)


def _children(pid):
    """The pids whose parent is ``pid``."""
    out = set()
    for stat in pathlib.Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.add(int(stat.parent.name))
    return out


@pytest.fixture(scope="module")
def pool():
    with wp.WorkerPool(world=4, backend="gloo", device="cpu") as p:
        yield p


def test_resubmission_reuses_the_worker_and_its_world(pool):
    first = pool.submit("collectives_suite", topology="2x2")
    (pid,) = pool.worker_pids()
    ranks = _children(pid)
    for _ in range(2):
        again = pool.submit("collectives_suite", topology="2x2")
        assert again == first
        assert pool.worker_pids() == [pid]
        assert _children(pid) == ranks
    assert first["worker_pid"] == pid and first["devices"] == 4
    assert pool.submit("ping") == {"pid": pid}
    hello = pool.bringup()
    assert hello["pid"] == pid and hello["devices"] == 4
    assert hello["backend"] == "gloo" and hello["warm_s"] > 0
    assert pool.respawns == 0


def test_suite_equals_the_reference_run_all(pool):
    from kind_tpu_sim import topology as T
    from kind_tpu_sim.parallel import collectives as jcoll
    from kind_tpu_sim.parallel import mesh as jmesh

    got = pool.submit("collectives_suite", topology="2x2")
    want = jcoll.run_all(jmesh.slice_mesh(T.make_slice(topology="2x2")))
    assert {k: v for k, v in got.items()
            if k not in ("devices", "worker_pid")} == want


def test_a_failing_job_leaves_the_worker_up(pool):
    (pid,) = pool.worker_pids()
    with pytest.raises(wp.JobError, match="need 8 devices, have 4"):
        pool.submit("collectives_suite", topology="2x4")
    with pytest.raises(wp.JobError, match="KeyError"):
        pool.submit("no_such_job")
    assert pool.worker_pids() == [pid]
    assert pool.submit("collectives_suite", topology="2x2")["ok"] is True


def test_pool_refuses_an_unnamed_backend():
    with pytest.raises(ValueError, match="backend"):
        wp.WorkerPool(world=1, backend="mpi", device="cpu")
    with pytest.raises(TypeError, match="backend"):
        wp.WorkerPool(world=1, device="cpu")


def test_worker_speaks_only_frames_on_stdout():
    """A bare worker: its first frame is the hello, prints of its own
    (the world's bring-up) go to stderr, and EOF ends it."""
    proc = subprocess.run(
        [sys.executable, "-m", "kind_tpu_sim_torch.utils.worker_pool",
         "--serve", "--world", "1", "--backend", "gloo", "--device", "cpu",
         "--timeout", "60"],
        cwd=ROOT, input=b"", capture_output=True, timeout=60,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    stream = io.BytesIO(proc.stdout)
    hello = wp.read_frame(stream)
    assert hello["hello"] is True and hello["devices"] == 1
    assert wp.read_frame(stream) is None
    assert proc.returncode == 0, proc.stderr[-2000:]  # a clean EOF


def test_a_dead_worker_is_started_again_and_the_job_retried():
    """The reference's failure contract: a worker that dies (killed here
    between jobs, so the next request meets a dead pipe) is started
    again, with its world, and the job answered."""
    import signal

    with wp.WorkerPool(world=2, backend="gloo", device="cpu") as pool:
        (pid,) = pool.worker_pids()
        os.kill(pid, signal.SIGKILL)
        rep = pool.submit("collectives_suite", topology="1x2")
        assert rep["ok"] is True and rep["devices"] == 2
        assert rep["worker_pid"] != pid and pool.respawns == 1
