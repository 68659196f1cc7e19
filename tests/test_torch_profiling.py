"""The port's profiling layer (kind_tpu_sim_torch/profiling.py) on the CPU:
the counterparts of tests/test_profiling.py. Trace capture with
torch.profiler, the raw-event summary, the flagship step and the
``profile`` command."""

import json
import re

import pytest
import torch

from kind_tpu_sim_torch import cli, profiling

PYTHON_FRAME = re.compile(r"\.py\(\d+\)|^<built-in|^\$")


def test_capture_and_summarize(tmp_path):
    def f(a, b):
        return torch.tanh(a @ b).sum()

    a = torch.ones((64, 64))
    report = profiling.capture(f, a, a, log_dir=tmp_path, label="unit-step")
    assert report["wall_s"] > 0
    assert report["trace_files"], "no trace written"
    assert all(n.endswith(".trace.json.gz") for n in report["trace_files"])

    summary = profiling.summarize(tmp_path, top=5)
    assert summary["top_ops"], "empty op table"
    assert len(summary["top_ops"]) <= 5
    assert summary["device_tracks"] is False  # a CPU trace
    # the annotation region must appear on the timeline
    all_names = [op["name"]
                 for op in profiling.summarize(tmp_path, top=100)["top_ops"]]
    assert "unit-step" in all_names, all_names
    assert "aten::mm" in all_names
    for op in summary["top_ops"]:
        assert op["total_us"] > 0 and op["count"] >= 1
    assert not any(PYTHON_FRAME.search(n) for n in all_names), (
        "python frames leaked into the op table")


def test_summarize_reads_device_events_first(tmp_path):
    """A trace with the card's events ranks those alone: kernels and
    copies, never the host's operations or Python frames."""
    import gzip

    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 900.0},
        {"ph": "X", "cat": "python_function", "name": "x.py(3): f",
         "dur": 5000.0},
        {"ph": "X", "cat": "kernel", "name": "sm90_gemm", "dur": 40.0},
        {"ph": "X", "cat": "kernel", "name": "sm90_gemm", "dur": 60.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 7.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step",
         "dur": 800.0},
    ]
    with gzip.open(tmp_path / "h.1.trace.json.gz", "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    s = profiling.summarize(tmp_path)
    assert s["device_tracks"] is True
    assert s["top_ops"] == [
        {"name": "sm90_gemm", "total_us": 100.0, "count": 2},
        {"name": "Memcpy HtoD", "total_us": 7.0, "count": 1}]


def test_summarize_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.summarize(tmp_path / "nothing")


def test_profile_flagship(tmp_path):
    report = profiling.profile_flagship(tmp_path, device="cpu")
    assert report["model"] == "d128xL2"
    assert report["device"] == "cpu"
    assert report["summary"]["top_ops"]


def test_cli_profile_json(tmp_path, capsys):
    rc = cli.main(["profile", "--out", str(tmp_path), "--json",
                   "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["summary"]["top_ops"]
    assert out["model"] == "d128xL2"


def test_stopwatch_records_a_failing_section():
    store = {}
    with pytest.raises(ZeroDivisionError):
        with profiling.stopwatch("boom", store):
            1 / 0
    assert "boom" in store
    profiling.record_section("ext", 1.23456, store)
    assert store["ext"] == 1.235


def test_profile_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.profile_flagship(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["profile", "--out", str(tmp_path)])
