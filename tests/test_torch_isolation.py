"""The PyTorch port stands alone and never falls back.

* No file of ``kind_tpu_sim_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of ``kind_tpu_sim`` (the JAX package is the
  reference, not a dependency); the package imports with ``jax``
  blocked.
* Entry points run on the CUDA card unless the caller asks for the
  CPU: without a card they raise instead of carrying on on the CPU,
  for int8 and MoE configs too.
* The kernel build raises when ``nvcc`` is missing, and
  ``chip_smoke.py`` exits non-zero with no result line when there is no
  card or no package beside it.
"""

import ast
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kind_tpu_sim_torch import bench as pbench
from kind_tpu_sim_torch import cli
from kind_tpu_sim_torch import data as pdata
from kind_tpu_sim_torch import device as pdevice
from kind_tpu_sim_torch.models import checkpoint as pckpt
from kind_tpu_sim_torch.models import decode as pdecode
from kind_tpu_sim_torch.models import quant as pquant
from kind_tpu_sim_torch.models import serving as pserving
from kind_tpu_sim_torch.models import speculative as pspec
from kind_tpu_sim_torch.models import transformer as ptf
from kind_tpu_sim_torch.ops import _build
from kind_tpu_sim_torch.ops import flash_attention as fa
from kind_tpu_sim_torch.ops import int8_matmul as i8
from kind_tpu_sim_torch.ops import toolchain as tc
from kind_tpu_sim_torch.utils import worker_pool as pwp
from kind_tpu_sim_torch.weights import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kind_tpu_sim_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
CFG = ptf.ModelConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=1,
                      d_ff=32, max_seq=32, dtype="float32")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "kind_tpu_sim"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_yaml(path):
    """The card's machine has no PyYAML: the port reads and writes its
    manifests with ``kind_tpu_sim_torch/yamlsubset.py``."""
    bad = [n for n in _imports(path) if n.split(".")[0] == "yaml"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_manifest_face_works_with_yaml_blocked():
    code = "\n".join([
        "import sys",
        "sys.modules['yaml'] = None",
        "from kind_tpu_sim_torch import fleet, sched",
        "text = open('pods/tpu-serving-deployment.yaml').read()",
        "reqs = sched.slice_requests_from_yaml(text)",
        "assert [r.name for r in reqs] == [",
        "    f'tpu-sim-serving-{i}' for i in range(3)], reqs",
        "back = sched.slice_requests_from_yaml(sched.to_pod_manifest(reqs[0]))",
        "assert back == reqs[:1], back",
        "gangs = fleet.gangs_from_manifest(",
        "    open('pods/tpu-batch-train-job.yaml').read())",
        "assert [g.priority for g in gangs] == [-10], gangs",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_guard_tells_the_port_from_the_jax_package():
    assert _forbidden("kind_tpu_sim.models.serving")
    assert _forbidden("jax.numpy")
    assert not _forbidden("kind_tpu_sim_torch.models.serving")


def test_package_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT_FILES if p.parent != ROOT)
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",
        "sys.modules['kind_tpu_sim'] = None",
        f"for name in {[m.removesuffix('.__init__') for m in modules]!r}:",
        "    importlib.import_module(name)",
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in"
        " sys.modules.items() if v is not None)",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_card(monkeypatch):
    """This host as one without a CUDA device, whatever it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_a_card_raise(no_card, tmp_path):
    params = ptf.init_params(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserving.PagedServingEngine(
            params, CFG, pserving.ServingConfig(paged_blocks=4,
                                                paged_kernel=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserving.ServingEngine(params, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptf.init_params(CFG)
    moe = dataclasses.replace(CFG, n_experts=2, int8_kv=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptf.init_params(moe)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdecode.init_cache(moe, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserving.ServingEngine(pquant.quantize_params(params, moe), moe)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdecode.greedy_generate(params, CFG, [[1, 2, 3]], 2)
    spec = pserving.ServingConfig(speculative_k=2, paged_blocks=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserving.PagedSpeculativeServingEngine(params, CFG, spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserving.SpeculativeServingEngine(
            params, CFG, pserving.ServingConfig(speculative_k=2),
            (params, CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pspec.speculative_generate(params, CFG, [[1, 2, 3]], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pspec.draft_model_generate(params, CFG, params, CFG, [[1, 2, 3]], 2)
    for report in (pspec.speculative_report, pserving.engines_report,
                   pserving.serving_report):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            report()
    tree = {"embed": params["embed"].numpy(),
            "final_norm": params["final_norm"].numpy(),
            "blocks": [{k: v.numpy() for k, v in b.items()}
                       for b in params["blocks"]]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(tree, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptf.make_train_step(CFG)
    _, init_state = ptf.make_train_step(CFG, device="cpu")
    assert init_state(params)["params"]["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptf.sample_batch(torch.Generator(), CFG, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.toolchain_smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdata.input_pipeline(CFG, 2, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pckpt.train_with_checkpointing(CFG, tmp_path / "ckpt", total_steps=1,
                                       checkpoint_every=1)
    assert not (tmp_path / "ckpt").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train-smoke"])
    # the warm-path smoke and its pool, and the bench (whose entries,
    # paged_tier_micro, serving_realistic and speculative among them,
    # run where its model lives)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["torch-smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pwp.WorkerPool(world=1, backend="gloo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbench.model_throughput()
    assert tc.toolchain_smoke(device="cpu")["ok"]
    assert pdevice.resolve("cpu").type == "cpu"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())


def test_build_failure_raises_with_the_compiler_output(monkeypatch,
                                                       tmp_path):
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="no such target"):
        _build.build()


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    x = torch.zeros(8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tc.matmul(x, x.T.contiguous())
    with pytest.raises(ValueError, match="unsupported device"):
        tc.rms_norm(x, x[0])
    with pytest.raises(ValueError, match="unsupported device"):
        tc.softmax(x)
    a = torch.zeros(8, 16, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        i8.int8_matmul(a, a.t())


def _run_smoke(cwd, home):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(home),
           "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _result_lines(stdout):
    lines = []
    for line in stdout.splitlines():
        try:
            lines.append(json.loads(line))
        except ValueError:
            continue
    return [obj for obj in lines if isinstance(obj, dict)
            and ("ok" in obj or "kernels" in obj)]


def test_chip_smoke_fails_without_a_card(tmp_path):
    out = _run_smoke(ROOT, tmp_path)
    assert out.returncode != 0
    assert not _result_lines(out.stdout)
    assert "CUDA" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    out = _run_smoke(alone, tmp_path)
    assert out.returncode != 0
    assert not _result_lines(out.stdout)
