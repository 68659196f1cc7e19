"""PyTorch port parity: the analytic serving cost model.

The port's ``fleet/costmodel.py`` against the JAX package's
``fleet/costmodel.py``: ``calibrate`` on the H100's bench artifact
(``kind_tpu_sim_torch/calibration/bench_h100.json``, which gives the
committed ``h100.json`` byte for byte) and on one of the reference's own
TPU artifacts (``bench_history/BENCH_LOCAL_r05_run4.json``, only as
input: no TPU number enters the port), the refusals of a partial
artifact, the loader and its knob, and ``CostModel``'s prices and
``errors()`` over both calibrations. Pure float arithmetic on both
sides, so the tolerance is exact.
"""

import copy
import json
import pathlib
import re

import pytest

from kind_tpu_sim.fleet import costmodel as jcost
from kind_tpu_sim_torch import bench as pbench
from kind_tpu_sim_torch.fleet import costmodel as pcost

REPO = pathlib.Path(__file__).resolve().parents[1]
H100_BENCH = REPO / "kind_tpu_sim_torch" / "calibration" / "bench_h100.json"
H100 = REPO / "kind_tpu_sim_torch" / "calibration" / "h100.json"
R05_BENCH = REPO / "bench_history" / "BENCH_LOCAL_r05_run4.json"
ARTIFACTS = {"h100": H100_BENCH, "r05": R05_BENCH}


def _bench(name):
    return json.loads(ARTIFACTS[name].read_text())


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_calibrate_matches_the_reference(name):
    got = pcost.calibrate(_bench(name))
    want = jcost.calibrate(_bench(name))
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_the_h100_file_is_the_calibration_of_its_bench():
    text = json.dumps(pcost.calibrate(_bench("h100")), indent=1,
                      sort_keys=True) + "\n"
    assert text == H100.read_text()
    # the port prices from the card's file by default, never a TPU's
    assert pcost.DEFAULT_CALIBRATION == H100
    cal = pcost.load_calibration()
    assert cal["chip"] == "h100-sxm" and cal["backend"] == "gpu"
    # prefill misses the simulator's 0.15 bar on the card's numbers
    assert pcost.CostModel(cal).errors()["prefill"] == 0.243129
    assert max(pcost.CostModel(cal).errors().values()) > pcost.MAX_ERROR_FRAC


def test_the_required_keys_are_one_definition():
    assert pbench.REQUIRED_MODEL_KEYS is pcost.REQUIRED_MODEL_KEYS
    assert pbench.REQUIRED_ROOFLINE_KEYS is pcost.REQUIRED_ROOFLINE_KEYS
    assert pcost.REQUIRED_MODEL_KEYS == jcost.REQUIRED_MODEL_KEYS
    assert pcost.REQUIRED_ROOFLINE_KEYS == jcost.REQUIRED_ROOFLINE_KEYS
    assert pcost.CALIBRATION_SCHEMA == jcost.CALIBRATION_SCHEMA
    assert pcost.DTYPE_BYTES == jcost.DTYPE_BYTES


def _partials():
    bench = _bench("h100")
    no_model = {k: v for k, v in bench.items() if k != "model"}
    no_fwd = copy.deepcopy(bench)
    del no_fwd["model"]["fwd_tokens_per_s"]
    no_roof = copy.deepcopy(bench)
    del no_roof["model"]["decode_roofline"]["achieved_gbps"]
    del no_roof["model"]["decode_int8_roofline"]["kv_mb"]
    no_serving = copy.deepcopy(bench)
    del no_serving["model"]["serving"]
    return {"no model": no_model, "no fwd": no_fwd,
            "no roofline keys": no_roof, "no serving": no_serving}


@pytest.mark.parametrize("name", sorted(_partials()))
def test_a_partial_artifact_is_refused_like_the_reference(name):
    bench = _partials()[name]
    with pytest.raises(ValueError) as want:
        jcost.calibrate(copy.deepcopy(bench))
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        pcost.calibrate(bench)


@pytest.mark.parametrize("model", ["d2048xL8-gqa4", "d1024xL2", "d64xL1-gqa2",
                                   "d2048xL8-gqa"])
def test_geometry_and_kv_bytes_match_the_reference(model):
    try:
        want = jcost.parse_geometry(model)
    except ValueError as exc:
        with pytest.raises(ValueError, match=re.escape(str(exc))):
            pcost.parse_geometry(model)
        return
    assert pcost.parse_geometry(model) == want
    for dtype in ("bf16", "int8"):
        assert (pcost.kv_bytes_per_token(want, dtype)
                == jcost.kv_bytes_per_token(want, dtype))
    with pytest.raises(ValueError, match="unknown dtype"):
        pcost.kv_bytes_per_token(want, "fp8")


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_cost_model_prices_match_the_reference(name):
    cal = jcost.calibrate(_bench(name))
    got, want = pcost.CostModel(cal), jcost.CostModel(cal)
    assert got.errors() == want.errors()
    for dtype in ("bf16", "int8"):
        for prompt in (0, 1, 37, 1024, 8191):
            assert got.kv_bytes(prompt, dtype) == want.kv_bytes(prompt, dtype)
            assert (got.prefill_s(prompt, 4, dtype)
                    == want.prefill_s(prompt, 4, dtype))
            for batch in (1, 3, 8):
                assert (got.decode_step_s(prompt, batch, dtype)
                        == want.decode_step_s(prompt, batch, dtype))
                for gen in (0, 1, 128):
                    assert (got.request_cost(prompt, gen, batch, dtype)
                            .as_dict()
                            == want.request_cost(prompt, gen, batch, dtype)
                            .as_dict())


def test_the_loader_reads_the_knob_and_refuses_a_stale_schema(
        monkeypatch, tmp_path):
    r05 = tmp_path / "r05.json"
    r05.write_text(json.dumps(jcost.calibrate(_bench("r05"))))
    monkeypatch.setenv("KIND_TPU_SIM_CALIBRATION", str(r05))
    assert pcost.load_calibration() == jcost.load_calibration()
    assert pcost.load_calibration(str(H100)) == jcost.load_calibration(
        str(H100))
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"schema": 0}))
    with pytest.raises(ValueError, match="schema 0"):
        pcost.load_calibration(str(stale))
