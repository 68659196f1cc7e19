"""The port's manifests (kind_tpu_sim_torch/manifests.py) and GPU pods
against the reference's (kind_tpu_sim/manifests.py, pods/), on the CPU.

* ``torch_multihost_manifest`` for the default slice, a 4x8, a v4
  2x2x4 and two slices parses, passes the reference's
  ``manifest_lint``, and equals ``jax_multihost_manifest`` on the same
  slice in replicas, devices a pod, the coordinator, selectors and slice
  pinning (``google.com/tpu`` -> ``nvidia.com/gpu``, the TPU node label
  and taint -> the GPU ones are the only differences);
* each committed pod file equals its generator, and the CLI prints or
  writes the multi-host one;
* each payload imports only the standard library and ``torch``;
* the payloads run as scripts: with ``--device cpu`` the gate pod on 2
  gloo ranks and the multi-host payload as 2 replicas x 2 ranks over
  127.0.0.1 pass; without it every payload fails at the device gate,
  naming this host's 0 devices against its allocation.
"""

import ast
import io
import os
import re
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import yaml

from kind_tpu_sim import manifest_lint
from kind_tpu_sim import manifests as ref
from kind_tpu_sim import topology as topo
from kind_tpu_sim.config import SimConfig
from kind_tpu_sim_torch import cli
from kind_tpu_sim_torch import manifests as man

ROOT = Path(__file__).resolve().parents[1]
SLICES = {
    "default": ("tpu-v5-lite-podslice", "4x4", 1),
    "4x8": ("tpu-v5-lite-podslice", "4x8", 1),
    "v4 2x2x4": ("tpu-v4-podslice", "2x2x4", 1),
    "two slices": ("tpu-v5-lite-podslice", "4x4", 2),
}
PODS = {
    "torch-gpu-pod.yaml": man.torch_gpu_pod,
    "cuda-kernel-pod.yaml": man.cuda_kernel_pod,
    "torch-multihost.yaml": man.torch_multihost_manifest,
}
PAYLOADS = {"gate": man.gate_payload, "multihost": man.multihost_payload,
            "kernel": man.kernel_payload}


def _reference_worlds(accelerator, topology, num_slices):
    """The reference's documents, (Service, StatefulSet) a slice: its
    multislice text joins the slices without a document marker, so each
    slice's world is rendered alone."""
    cfg = SimConfig(vendor="tpu", accelerator=accelerator,
                    tpu_topology=topology, num_slices=num_slices)
    if num_slices == 1:
        return [list(yaml.safe_load_all(ref.jax_multihost_manifest(cfg)))]
    return [list(yaml.safe_load_all(ref._jax_world_manifest(
        cfg, name=f"jax-tpu-s{sid}", service=f"tpu-sim-s{sid}",
        extra_selector={topo.LABEL_SLICE_ID: str(sid)},
        slice_note=f"{sid}/{num_slices}"))) for sid in range(num_slices)]


def _split(statefulset, resource, hardware):
    """(the StatefulSet without its container and tolerations, the
    hardware label taken out of its node selector; its container; its
    tolerations; the pod's device limit)."""
    spec = statefulset["spec"]["template"]["spec"]
    (ctr,) = spec.pop("containers")
    tolerations = spec.pop("tolerations")
    assert spec["nodeSelector"].pop("hardware-type") == hardware
    return statefulset, ctr, tolerations, ctr["resources"]["limits"][resource]


@pytest.mark.parametrize("name", sorted(SLICES))
def test_multihost_manifest_equals_the_reference_on_the_slice(name):
    accelerator, topology, num_slices = SLICES[name]
    text = man.torch_multihost_manifest(accelerator, topology, num_slices)
    assert manifest_lint.validate_yaml(text) == []
    docs = list(yaml.safe_load_all(text))
    assert [d["kind"] for d in docs] == ["Service", "StatefulSet"] * num_slices
    for sid, want in enumerate(_reference_worlds(accelerator, topology,
                                                 num_slices)):
        service, statefulset = docs[2 * sid:2 * sid + 2]
        assert service == want[0]
        got, ctr, tolerations, gpus = _split(statefulset, "nvidia.com/gpu",
                                             "gpu")
        exp, exp_ctr, exp_tolerations, tpus = _split(
            want[1], "google.com/tpu", "tpu")
        assert got == exp  # replicas, names, affinity, slice pinning
        assert gpus == tpus
        assert tolerations == ref._taint_toleration("nvidia")
        assert exp_tolerations == ref._taint_toleration("tpu")
        env = {e["name"]: e for e in ctr["env"]}
        exp_env = {e["name"]: e["value"] for e in exp_ctr["env"]}
        assert env["TPU_SIM_REPLICAS"]["value"] == exp_env["TPU_SIM_REPLICAS"]
        coordinator = re.search(r'coordinator = "([^"]+)"',
                                exp_ctr["args"][0])[1]
        assert env["TPU_SIM_COORDINATOR"]["value"] == coordinator
        assert env["TPU_SIM_GPUS"]["value"] == str(gpus)
        assert env["POD_NAME"]["valueFrom"] == {
            "fieldRef": {"fieldPath": "metadata.name"}}
        assert ctr["args"][0] == man._shell("torch_multihost.py",
                                            man.multihost_payload())
    if num_slices > 1:
        # the reference's joined text reads as fewer documents: each
        # slice's StatefulSet merges into the next slice's Service
        cfg = SimConfig(vendor="tpu", num_slices=num_slices)
        assert len(list(yaml.safe_load_all(
            ref.jax_multihost_manifest(cfg)))) < 2 * num_slices


def test_gpu_selector_and_toleration_are_the_source_systems():
    assert man._node_selector() == ref._node_selector("nvidia")
    assert man._taint_toleration() == ref._taint_toleration("nvidia")
    assert man.GPUS_PER_NODE == SimConfig().gpus_per_node
    assert man.LABEL_SLICE_ID == topo.LABEL_SLICE_ID
    assert man.RESOURCE_GPU == "nvidia.com/gpu"
    for make in (man.torch_gpu_pod, man.cuda_kernel_pod):
        (pod,) = yaml.safe_load_all(make())
        assert pod["spec"]["nodeSelector"] == ref._node_selector("nvidia")
        assert pod["spec"]["tolerations"] == ref._taint_toleration("nvidia")
        (ctr,) = pod["spec"]["containers"]
        assert ctr["image"] == man.GPU_IMAGE
        limit = ctr["resources"]["limits"]["nvidia.com/gpu"]
        assert ctr["env"] == [{"name": "TPU_SIM_GPUS", "value": str(limit)}]
        assert "pip install" not in ctr["args"][0]


@pytest.mark.parametrize("name", sorted(PODS))
def test_committed_pod_equals_its_generator(name):
    assert (ROOT / "pods" / name).read_text() == PODS[name]()
    assert manifest_lint.validate_yaml(PODS[name]()) == []


def test_manifests_cli_prints_and_writes(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        assert cli.main(["manifests", "torch-multihost"]) == 0
    assert out.getvalue() == (ROOT / "pods" / "torch-multihost.yaml"
                              ).read_text()
    path = tmp_path / "two.yaml"
    with redirect_stdout(io.StringIO()):
        assert cli.main(["manifests", "torch-multihost", "--topology",
                         "2x2x4", "--accelerator", "tpu-v4-podslice",
                         "--num-slices", "2", "--out", str(path)]) == 0
    assert path.read_text() == man.torch_multihost_manifest(
        "tpu-v4-podslice", "2x2x4", 2)


@pytest.mark.parametrize("value", [
    "true", "No", "null", "8476", "1e-4", "", "a: b", "- x", "#x", "x #y",
    "nvcr.io/nvidia/pytorch:24.08-py3", "plain-word", "None", "-c",
    'say "hi"', "tab\there", 3, True, False, 0])
def test_yaml_scalars_read_back(value):
    obj = {"k": value, "list": [value, {"in": value}], "empty": {}}
    assert yaml.safe_load(man.to_yaml(obj)) == obj


def test_yaml_block_literal_reads_back():
    text = "line one\n\n    indented: yes\n'quoted' # not a comment\n"
    obj = {"args": [text], "nested": {"script": text}}
    assert yaml.safe_load(man.to_yaml(obj)) == obj
    for bad in ("no final\nnewline", " starts with a space\n",
                "two newlines\n\n"):
        with pytest.raises(ValueError, match="block literal"):
            man.to_yaml({"x": bad})


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_payload_imports_only_stdlib_and_torch(name):
    tree = ast.parse(PAYLOADS[name]())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert "torch" in mods
    assert mods - {"torch"} <= sys.stdlib_module_names, mods


def _write(tmp_path, name):
    path = tmp_path / f"{name}.py"
    path.write_text(PAYLOADS[name]())
    return path


def _run(path, env, *argv):
    full = {k: v for k, v in os.environ.items()
            if k != "CUDA_VISIBLE_DEVICES"}
    return subprocess.run([sys.executable, str(path), *argv],
                          env={**full, **env}, capture_output=True,
                          text=True, timeout=120)


def test_gate_payload_on_two_gloo_ranks(tmp_path):
    res = _run(_write(tmp_path, "gate"), {"TPU_SIM_GPUS": "2"},
               "--device", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "DEVICES OK: 2" in res.stdout
    assert "PLATFORM OK: cpu" in res.stdout
    assert "PSUM OK: 3.0 over 2 ranks" in res.stdout


def test_multihost_payload_as_two_replicas_of_two_ranks(tmp_path):
    path = _write(tmp_path, "multihost")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]

    def replica(ordinal):
        return _run(path, {"POD_NAME": f"jax-tpu-{ordinal}",
                           "TPU_SIM_REPLICAS": "2", "TPU_SIM_GPUS": "2",
                           "TPU_SIM_COORDINATOR": f"127.0.0.1:{port}"},
                    "--device", "cpu")

    with ThreadPoolExecutor(2) as pool:
        results = list(pool.map(replica, (0, 1)))
    for ordinal, res in enumerate(results):
        assert res.returncode == 0, res.stderr[-3000:]
        assert f"process {ordinal} of 2" in res.stdout
        assert "global devices: 4 local: 2" in res.stdout
        assert "PLATFORM OK: cpu" in res.stdout
        assert "GLOBAL PSUM OK: 10.0 over 4 ranks" in res.stdout


@pytest.mark.parametrize("name,allocated", [("gate", 2), ("multihost", 2),
                                            ("kernel", 1)])
def test_payload_without_the_cpu_request_fails_at_the_gate(tmp_path, name,
                                                           allocated):
    env = {"TPU_SIM_GPUS": str(allocated), "POD_NAME": "jax-tpu-0",
           "TPU_SIM_REPLICAS": "1", "TPU_SIM_COORDINATOR": "127.0.0.1:1"}
    res = _run(_write(tmp_path, name), env)
    assert res.returncode != 0
    assert (f"DEVICE GATE FAILED: torch.cuda.device_count() is 0, the pod "
            f"was allocated {allocated} GPUs") in res.stderr
    assert "PSUM OK" not in res.stdout and "KERNEL OK" not in res.stdout


def test_visible_devices_must_name_the_allocation(tmp_path):
    res = _run(_write(tmp_path, "gate"),
               {"TPU_SIM_GPUS": "2", "CUDA_VISIBLE_DEVICES": "0"},
               "--device", "cpu")
    assert res.returncode != 0
    assert ("CUDA_VISIBLE_DEVICES names 1 GPUs, the pod was allocated 2"
            in res.stderr)
