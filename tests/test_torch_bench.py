"""The port's bench (kind_tpu_sim_torch/bench.py) against the reference's
model block (bench.py), on the CPU.

* ``headline_numbers`` and ``emit_result``'s last line equal the
  reference's on the same dicts;
* ``model_throughput(device="cpu")`` gives the key set of the
  reference's branch for a host without a TPU, run live beside it;
* ``measure_engine`` on tiny engines gives the reference's entry keys
  (read from the reference's source) and only its phase labels;
* the required-key lists equal the simulator's ``costmodel``'s, and the
  checked-in H100 calibration is ``costmodel.calibrate`` of the checked-in
  bench artifact.
"""

import ast
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from kind_tpu_sim.fleet import costmodel
from kind_tpu_sim_torch import bench as pbench
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.models import transformer as ptf
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
CALIBRATION = ROOT / "kind_tpu_sim_torch" / "calibration"


@pytest.fixture(scope="module")
def rbench():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MODELS = (
    {"train_mfu_pct": 43.5, "decode_tokens_per_s": 18951,
     "serving": {"wall_tokens_per_s": 615, "device_tokens_per_s": 1736},
     "serving_longprompt": {"short_e2e_p50_s": 1.504},
     "fwdbwd_4k_error": "x" * 500, "ring": [1, 2, 3]},
    {"fwd_tokens_per_s": 1, "fwd_mfu_pct": 2.5, "train_variant": "flash",
     "decode_roofline": {"roof_frac": 0.1}, "serving_paged": {
         "wall_tokens_per_s": 3, "phases": {}}, "decode_error": "boom"},
    {},
)


@pytest.mark.parametrize("model", MODELS + (None,))
def test_headline_numbers_equal_the_reference(rbench, model):
    assert pbench.headline_numbers(model) == rbench.headline_numbers(model)


def test_emit_result_last_line_equals_the_reference(rbench, tmp_path,
                                                    capsys):
    out = {"metric": "m", "value": 1.5, "unit": "s", "vs_baseline": None,
           "mode": "model-only", "model": MODELS[0],
           "extras": {"big": "x" * 50_000}}
    extra = {"status": "ok", "headline": pbench.headline_numbers(MODELS[0])}
    lines = {}
    for name, mod in (("port", pbench), ("ref", rbench)):
        mod.emit_result(out, str(tmp_path / "full.json"), extra)
        lines[name] = capsys.readouterr().out.strip().splitlines()
        assert json.loads((tmp_path / "full.json").read_text()) == out
    assert lines["port"] == lines["ref"]
    assert json.loads(lines["port"][0]) == out
    assert json.loads(lines["port"][-1])["full"] == "full.json"


def test_cpu_model_throughput_has_the_reference_keys(rbench):
    port = pbench.model_throughput(device="cpu")
    ref = rbench.model_throughput()
    assert not [k for k in port if k.endswith("_error") or k == "error"]
    assert sorted(port) == sorted(ref)
    assert port["backend"] == ref["backend"] == "cpu"
    assert port["model"] == ref["model"] == "d128xL2"
    assert set(pbench.SECTION_S) == set(rbench.SECTION_S)


def test_model_throughput_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbench.model_throughput()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbench.main(["--model-only", "--out", "unused.json"])


def _reference_measure_engine():
    """The reference's measure_engine and _PHASE_ATTRS, read from its
    source (they are closures inside model_throughput)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fns = {n.name: n for n in ast.walk(tree)
           if isinstance(n, ast.FunctionDef)}
    keys = set()
    for node in ast.walk(fns["measure_engine"]):
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            if (isinstance(target, ast.Name) and target.id == "entry"
                    and isinstance(node.value, ast.Dict)):
                keys |= {k.value for k in node.value.keys}
            elif (isinstance(target, ast.Subscript)
                  and getattr(target.value, "id", "") == "entry"):
                keys.add(target.slice.value)
    labels = {"activate_host"}
    for node in ast.walk(fns["model_throughput"]):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "_PHASE_ATTRS"):
            labels |= {pair.elts[1].value for pair in node.value.elts}
    return keys, labels


CFG = ptf.ModelConfig(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=64, max_seq=64, dtype="float32")
SPEC_ONLY = {"draft_k", "spec_windows", "verify_steps", "tokens_per_window"}
DECODE_ONLY = {"decode_rows_computed", "decode_occupancy_pct"}
ENGINES = {
    "dense": (pserving.ServingEngine,
              dict(max_slots=2, max_len=64, chunk=8), DECODE_ONLY),
    "dense_chunked": (pserving.ServingEngine,
                      dict(max_slots=2, max_len=64, chunk=8,
                           prefill_chunk=8), DECODE_ONLY),
    "paged": (pserving.PagedServingEngine,
              dict(max_slots=2, max_len=64, chunk=8, paged_blocks=12,
                   block_size=8, paged_width=8), DECODE_ONLY),
    "speculative": (pserving.SpeculativeServingEngine,
                    dict(max_slots=2, max_len=64, speculative_k=2,
                         spec_windows=2), SPEC_ONLY),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_measure_engine_gives_the_reference_entry(name):
    ref_keys, ref_labels = _reference_measure_engine()
    engine_cls, knobs, conditional = ENGINES[name]
    params = ptf.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    eng = engine_cls(params, CFG, pserving.ServingConfig(**knobs),
                     device="cpu")
    rng = np.random.RandomState(0)
    tokens_h = rng.randint(0, CFG.vocab_size, (1, 64))
    reqs = [pserving.Request(f"r{i}", tokens_h[0, :12 + 3 * i].tolist(),
                             6 + 2 * i) for i in range(4)]
    result = {}
    entry = pbench.measure_engine(result, name, eng, reqs, tokens_h,
                                  null_dt=1e-6, null_ok=True,
                                  warm_lens=(16,))
    assert result[name] is entry
    want = ref_keys - (SPEC_ONLY | DECODE_ONLY) | conditional
    assert set(entry) == want
    assert entry["requests"] == 4 and entry["slots"] == 2
    assert entry["generated_tokens"] == sum(r.max_new for r in reqs)
    labels = set(entry["phases"])
    assert labels <= ref_labels, labels - ref_labels
    round_label = ("verify_scan" if name == "speculative"
                   else "decode_chunk")
    assert {round_label, "prefill", "first_readback", "retire_fetch",
            "activate_host"} <= labels
    assert entry["phases"]["activate_host"]["n"] == 4
    assert entry["dispatches"] == sum(
        p["n"] for lbl, p in entry["phases"].items()
        if lbl not in pbench._NON_DISPATCH_PHASES)
    assert pbench.SECTION_S[name] >= 0


def test_required_keys_equal_the_simulators():
    assert pbench.REQUIRED_MODEL_KEYS == costmodel.REQUIRED_MODEL_KEYS
    assert pbench.REQUIRED_ROOFLINE_KEYS == costmodel.REQUIRED_ROOFLINE_KEYS


def _artifact():
    return json.loads((CALIBRATION / "bench_h100.json").read_text())


def test_h100_artifact_is_a_clean_card_capture():
    art = _artifact()
    assert art["status"] == "ok" and art["mode"] == "model-only"
    model = art["model"]
    assert model["backend"] == "gpu"
    assert model["chip"] == "h100-sxm"
    assert art["device"] == "NVIDIA H100 80GB HBM3"
    assert all(k in model for k in pbench.REQUIRED_MODEL_KEYS)
    for roof in ("decode_roofline", "decode_int8_roofline"):
        assert all(k in model[roof] for k in pbench.REQUIRED_ROOFLINE_KEYS)
        assert 0 < model[roof]["roof_frac"] <= 1.05
    for k, v in model.items():
        if k.endswith("_mfu_pct"):
            assert 0 < v <= 100, (k, v)
    assert not [k for k in model if k.endswith("_error")]


def test_h100_calibration_is_calibrate_of_the_artifact():
    cal = costmodel.calibrate(_artifact())
    assert cal == json.loads((CALIBRATION / "h100.json").read_text())
    model = costmodel.CostModel(calibration=cal)
    prefill = [model.prefill_s(n) for n in (0, 1, 128, 1024, 4096)]
    assert prefill == sorted(prefill) and prefill[-1] > prefill[0]
    for dtype in ("bf16", "int8"):
        decode = [model.decode_s(n, 1024, batch=8, dtype=dtype)
                  for n in (0, 1, 64, 512)]
        assert decode == sorted(decode) and decode[-1] > decode[0]
        steps = [model.decode_step_s(c, batch=8, dtype=dtype)
                 for c in (0, 256, 1024, 4096)]
        assert steps == sorted(steps) and steps[-1] > steps[0]


# ---------------------------------------------------------------------
# the entries after the serving matrix: paged_tier_micro,
# serving_realistic, speculative


def _tree():
    return ast.parse((ROOT / "bench.py").read_text())


def _fn(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _reference_tier_micro_keys():
    """paged_tier_micro's keys, its f-string keys expanded over the
    tiers its loop names."""
    fn = _fn(_tree(), "paged_tier_micro")
    tiers = next(
        [elt.elts[0].value for elt in node.iter.elts]
        for node in ast.walk(fn) if isinstance(node, ast.For)
        and isinstance(node.iter, ast.Tuple))
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.AnnAssign) and node.target.id == "out":
            keys |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Assign)
              and isinstance(node.targets[0], ast.Subscript)
              and getattr(node.targets[0].value, "id", "") == "out"):
            sl = node.targets[0].slice
            if isinstance(sl, ast.Constant):
                keys.add(sl.value)
            else:
                template = "".join(
                    p.value if isinstance(p, ast.Constant) else "{}"
                    for p in sl.values)
                keys |= {template.format(t) for t in tiers}
    return keys


def _reference_realistic_keys():
    """The keys run_realistic adds to measure_engine's entry."""
    fn = _fn(_tree(), "run_realistic")
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "update"
                and getattr(node.func.value, "id", "") == "entry"):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("run_realistic updates no entry")


def _reference_speculative_keys():
    """The solo speculative entry's keys (its literal and the
    conditional device_tokens_per_s)."""
    fn = _fn(_tree(), "model_throughput")
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "entry"
                and isinstance(node.value, ast.Dict)
                and any(getattr(k, "value", "") == "draft_k"
                        for k in node.value.keys)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no speculative entry")


def _reference_realistic_stream(key, tokens_h, vocab):
    """The reference's realistic stream, built by its own statements
    (``run_realistic``'s, from the RandomState(7) draw to the head
    ordering) over the reference's Request."""
    from kind_tpu_sim.models import serving as jserving

    fn = _fn(_tree(), "run_realistic")
    body = fn.body
    start = next(i for i, n in enumerate(body) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "rng")
    stop = next(i for i, n in enumerate(body) if isinstance(n, ast.For)
                and getattr(n.target, "id", "") == "rs")
    code = compile(ast.Module(body=body[start:stop + 1], type_ignores=[]),
                   "bench.py", "exec")
    ns = {"np": np, "serving": jserving, "key": key, "tokens_h": tokens_h,
          "cfg": type("Cfg", (), {"vocab_size": vocab})}
    exec(code, ns)
    return ns["fixed"]


def test_full_size_realistic_stream_is_the_references():
    from kind_tpu_sim_torch import profile_serving as ps

    vocab = 32768
    tokens_h = np.random.RandomState(3).randint(0, vocab, (8, 1024))
    want = _reference_realistic_stream("serving_realistic", tokens_h, vocab)
    got = ps.realistic_requests(vocab, base=tokens_h[0],
                                key="serving_realistic",
                                **pbench.REALISTIC_SIZES)
    assert len(got) == len(want) == 64
    assert [r.request_id for r in got] == [r.request_id for r in want]
    assert [r.prompt for r in got] == [r.prompt for r in want]
    assert [r.cache_prefix for r in got] == [r.cache_prefix for r in want]
    assert {r.max_new for r in got} == {r.max_new for r in want} == {512}
    assert sorted({len(r.prompt) for r in got}) == [224, 1024, 1120, 1152,
                                                    2048, 3072]
    order = [r.request_id for r in got]
    for f in range(8):
        head = order.index(f"serving_realisticf{f}h")
        for m in range(2):
            assert order.index(f"serving_realisticf{f}m{m}") > head


def test_bench_flagship_knob(monkeypatch):
    monkeypatch.delenv("BENCH_FLAGSHIP", raising=False)
    assert pbench.bench_model_config(True) == ptf.bench_config_large()
    monkeypatch.setenv("BENCH_FLAGSHIP", "d1024")
    assert pbench.bench_model_config(True) == ptf.bench_config()
    assert pbench.bench_model_config(False) == ptf.ModelConfig()
    monkeypatch.setenv("BENCH_FLAGSHIP", "large")
    assert pbench.bench_model_config(True) == ptf.bench_config_large()


@pytest.mark.parametrize("on_card", [True, False])
def test_bench_depth_knob(on_card, monkeypatch):
    monkeypatch.delenv("BENCH_FLAGSHIP", raising=False)
    full = pbench.bench_model_config(on_card)
    cut = pbench.bench_model_config(on_card, n_layers=2)
    assert cut.n_layers == 2
    assert dataclasses.replace(cut, n_layers=full.n_layers) == full
    assert pbench.bench_model_config(on_card, n_layers=None) == full
    with pytest.raises(ValueError):
        pbench.bench_model_config(on_card, n_layers=0)


def _serving_params(cfg):
    from kind_tpu_sim_torch.models import decode as pdecode

    params = ptf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return pdecode.serving_params(params, cfg)


def test_paged_tier_micro_on_the_cpu():
    sp = _serving_params(CFG)
    out = pbench.paged_tier_micro(sp, CFG, slots=2, blk=8, chunk=4, N=3,
                                  ctx0=28)
    assert set(out) == _reference_tier_micro_keys()
    assert out["slots"] == 2 and out["context"] == 28
    assert out["chunk"] == 4 and out["chained_chunks"] == 3
    assert out["table_width"] == 8 and out["pool_blocks"] == 1 + 2 * 5
    assert out["gather_over_kernel"] > 0
    with pytest.raises(ValueError, match="whole number"):
        pbench.paged_tier_micro(sp, CFG, slots=2, blk=8, chunk=4, N=3,
                                ctx0=27)


def test_speculative_entry_on_the_cpu():
    sp = _serving_params(CFG)
    tokens = torch.as_tensor(
        np.random.RandomState(2).randint(0, CFG.vocab_size, (2, 300)))
    out = pbench.run_speculative(sp, CFG, tokens, spec_new=12)
    assert set(out) == _reference_speculative_keys() - {"device_tokens_per_s"}
    assert out["draft_k"] == 4 and 1 <= out["verify_steps"] <= 11
    assert out["tokens_per_step"] >= 1.0
