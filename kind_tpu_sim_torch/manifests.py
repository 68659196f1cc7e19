"""Workload manifests of the PyTorch port: the GPU pods and the
multi-host ``torch.distributed`` world.

Counterpart of ``kind_tpu_sim/manifests.py:jax_multihost_manifest`` and
of the JAX pods ``pods/jax-tpu-pod.yaml`` and ``pods/pallas-pod.yaml``.
Manifests are built as Python structures and rendered by ``to_yaml``, a
small emitter of the subset they use (maps, lists, strings, integers,
booleans, block literals for the payloads), so nothing here needs
PyYAML. The committed pod files are these generators' output:

* ``torch_gpu_pod`` -> ``pods/torch-gpu-pod.yaml``: the device gate
  (``torch.cuda.device_count()`` must equal the GPUs the pod was given)
  and an all-reduce over them, NCCL, one rank a GPU;
* ``torch_multihost_manifest`` -> ``pods/torch-multihost.yaml``: one
  headless Service and one StatefulSet a slice, each pod one NCCL rank a
  local GPU in a ``tcp://<coordinator>:8476`` world; replicas, GPUs a
  pod, the coordinator's DNS name and port come from the slice
  contract of the port's ``topology.py``, as the reference's come from
  its topology module;
* ``cuda_kernel_pod`` -> ``pods/cuda-kernel-pod.yaml``: an inline CUDA C
  128 x 128 fp32 product built with ``nvcc`` for the card's capability,
  loaded through ctypes and checked against ``torch.matmul``.

Each pod runs a Python payload (``gate_payload``, ``multihost_payload``,
``kernel_payload``: the source of a script that imports only the
standard library and ``torch``, since a pod's image holds no repository)
written to a file and run there. Everything a payload reads of its pod
comes from the environment the manifest sets -- the GPUs allocated
(``TPU_SIM_GPUS``, the pod's ``nvidia.com/gpu`` limit), and for the
multi-host world the pod's name (``POD_NAME``, whose StatefulSet ordinal
is the process index), the replica count (``TPU_SIM_REPLICAS``) and the
coordinator (``TPU_SIM_COORDINATOR``) -- so outside a pod a payload runs
as a plain script with that environment, which the caller may set. A
payload runs on the card; ``--device cpu`` (which no pod passes) runs
its ranks as gloo ranks on the CPU and skips the CUDA device count,
and nothing else. The kernel pod has no CPU mode: its kernel needs a
card.

The pods take the source system's GPU node selector (``hardware-type:
gpu``) and toleration (``gpu=true:NoSchedule``), as
``pods/nvidia-gpu-test-pod.yaml`` does: the labels and taint that
``create nvidia`` (``cluster.py``) puts on its workers, beside their
patched ``nvidia.com/gpu`` capacity.

The cluster half (the port's copy of ``kind_tpu_sim/manifests.py``'s)
renders what the cluster layer applies: the kind ``Cluster`` config,
the local-registry ``ConfigMap``, the nodes' containerd ``hosts.toml``
and the device-plugin DaemonSets of the three vendors. These are
written by ``yamlsubset.dump``, byte for byte what
the reference's PyYAML dumper writes (multi-line strings as literal
blocks).
"""

from __future__ import annotations

import json
import re
import textwrap
from typing import Dict, List, Optional

from kind_tpu_sim_torch import topology as topo
from kind_tpu_sim_torch import yamlsubset
from kind_tpu_sim_torch.config import RESOURCE_BY_VENDOR, SimConfig

# one public CUDA PyTorch image that carries nvcc
GPU_IMAGE = "nvcr.io/nvidia/pytorch:24.08-py3"
RESOURCE_GPU = "nvidia.com/gpu"
LABEL_HARDWARE_TYPE = "hardware-type"       # the source system's selector key
LABEL_SLICE_ID = "kind-tpu-sim.dev/slice-id"  # a multislice world's nodes
# the simulated GPU node's devices (the reference's SimConfig.gpus_per_node)
GPUS_PER_NODE = 2
# the shared library the kernel pod builds, in its build directory
KERNEL_LIBRARY = "cuda_kernel_pod.so"
KERNEL_POD_ATOL = 1e-4  # pods/pallas-pod.yaml's np.allclose(atol=1e-4)


# Kubelet's device-plugin registration directory; the plugin DaemonSet
# must mount it to reach kubelet.sock (cf. kind-gpu-sim.sh:321-328).
KUBELET_DP_DIR = "/var/lib/kubelet/device-plugins"

PLUGIN_APP_LABEL = "tpu-sim-device-plugin"
PLUGIN_NAMESPACE = "kube-system"

# Host directory for simulator runtime state; the chaos subcommand
# writes device IDs into UNHEALTHY_FILE on a node to fail them.
SIM_STATE_DIR = "/var/run/tpu-sim"
UNHEALTHY_FILE = SIM_STATE_DIR + "/unhealthy"


# ---------------------------------------------------------------------
# YAML: the subset the manifests use

_PLAIN = re.compile(r"^[A-Za-z_./][A-Za-z0-9_./-]*$")
# plain words YAML 1.1 readers take for booleans or null
_RESERVED = {"y", "n", "yes", "no", "true", "false", "on", "off", "null"}


def _scalar(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, str):
        if _PLAIN.match(value) and value.lower() not in _RESERVED:
            return value
        return json.dumps(value)  # a JSON string is a YAML quoted scalar
    raise TypeError(f"cannot render {type(value).__name__} {value!r}")


def _block(text: str, indent: int) -> str:
    """A multi-line string as a literal block (``|``) at ``indent``."""
    if not text.endswith("\n") or text.endswith("\n\n") or text[0] in " \n":
        raise ValueError("a block literal must end in exactly one newline "
                         "and start with no space")
    pad = " " * indent
    return "|\n" + "".join(pad + line + "\n" if line else "\n"
                           for line in text[:-1].split("\n"))


def _value(value, indent: int) -> str:
    """What follows ``key:`` or ``-`` on its line, with the lines
    under it."""
    if isinstance(value, str) and "\n" in value:
        return " " + _block(value, indent)
    if isinstance(value, dict) and value:
        return "\n" + _lines(value, indent)
    if isinstance(value, list) and value:
        return "\n" + _lines(value, indent)
    if isinstance(value, (dict, list)):
        return " {}\n" if isinstance(value, dict) else " []\n"
    return " " + _scalar(value) + "\n"


def _lines(obj, indent: int) -> str:
    pad = " " * indent
    out = []
    if isinstance(obj, dict):
        for key, value in obj.items():
            out.append(f"{pad}{_scalar(key)}:{_value(value, indent + 2)}")
    else:
        for item in obj:
            if isinstance(item, dict) and item:
                # the first key on the dash's line, the rest under it
                body = _lines(item, indent + 2)
                out.append(f"{pad}- {body[indent + 2:]}")
            elif isinstance(item, list) and item:
                raise TypeError("nested lists are not rendered")
            else:
                out.append(f"{pad}-{_value(item, indent + 2)}")
    return "".join(out)


def to_yaml(obj) -> str:
    """One YAML document of ``obj`` (maps keep their order)."""
    return _lines(obj, 0)


# ---------------------------------------------------------------------
# the payloads

# the device gate every payload runs first (the counterpart of
# pods/jax-tpu-pod.yaml:58-65)
_GATE = '''
def allocated_gpus():
    """The GPUs this pod was given: its nvidia.com/gpu limit, which the
    manifest writes into TPU_SIM_GPUS; CUDA_VISIBLE_DEVICES, where it is
    set, must name as many."""
    limit = int(os.environ["TPU_SIM_GPUS"])
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        named = len([d for d in visible.split(",") if d.strip()])
        if named != limit:
            sys.exit(f"DEVICE GATE FAILED: CUDA_VISIBLE_DEVICES names "
                     f"{named} GPUs, the pod was allocated {limit}")
    return limit


def device_gate(allocated, device):
    """torch.cuda.device_count() must equal the allocation; on the CPU
    (asked for with --device cpu) only that count is not checked."""
    if device == "cpu":
        print("DEVICES OK:", allocated, "gloo ranks on the CPU (asked "
              "for; the CUDA device count is not checked)", flush=True)
        return
    n = torch.cuda.device_count()
    if n != allocated:
        sys.exit(f"DEVICE GATE FAILED: torch.cuda.device_count() is {n}, "
                 f"the pod was allocated {allocated} GPUs (nvidia.com/gpu)")
    print("DEVICES OK:", n, flush=True)


def platform(device, local_rank=0):
    return torch.cuda.get_device_name(local_rank) if device == "cuda" \\
        else "cpu"


def join(device, local_rank, init_method, rank, world):
    """This process as rank `rank` of `world`: NCCL on its GPU, or gloo
    on the CPU."""
    if device == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo", init_method=init_method,
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=300))
    return torch.device("cuda", local_rank) if device == "cuda" \\
        else torch.device("cpu")


def device_arg():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs gloo ranks on the CPU (never in a pod)")
    return ap.parse_args().device
'''

_HEADER = '''import argparse
import datetime
import os
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
'''


def gate_payload() -> str:
    """The device-gate pod's script: the gate, then an all-reduce over
    the allocated GPUs (one rank each; rank r holds r + 1, the sum must
    be n(n+1)/2). Prints DEVICES OK, PLATFORM OK and PSUM OK."""
    return ('"""Device gate and all-reduce over the GPUs this pod was '
            'given."""\n' + _HEADER + _GATE + '''

def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_main(rank, world, device, init_method):
    dev = join(device, rank, init_method, rank, world)
    x = torch.tensor([float(rank + 1)], device=dev)
    dist.all_reduce(x)
    want = world * (world + 1) / 2
    if float(x[0]) != want:
        sys.exit(f"PSUM FAILED: {float(x[0])} != {want}")
    if rank == 0:
        print("PSUM OK:", float(x[0]), "over", world, "ranks", flush=True)
    dist.destroy_process_group()


def main():
    device = device_arg()
    allocated = allocated_gpus()
    print("allocated GPUs:", allocated, flush=True)
    device_gate(allocated, device)
    print("PLATFORM OK:", platform(device), flush=True)
    mp.spawn(rank_main, nprocs=allocated, join=True, args=(
        allocated, device, f"tcp://127.0.0.1:{free_port()}"))


if __name__ == "__main__":
    main()
''')


def multihost_payload() -> str:
    """A multi-host world's pod script: one rank a local GPU joins the
    world of every replica at the coordinator; the world's size is
    counted by an all-reduce and must be GPUs x replicas; then the
    reference's global psum (each rank holds its global index + 1).
    Prints DEVICES OK, PLATFORM OK and GLOBAL PSUM OK."""
    return ('"""One host of a multi-host torch.distributed world."""\n'
            + _HEADER + _GATE + '''

def rank_main(local_rank, ordinal, local, replicas, device, coordinator):
    rank = ordinal * local + local_rank
    dev = join(device, local_rank, f"tcp://{coordinator}", rank,
               local * replicas)
    ones = torch.ones(1, device=dev)
    dist.all_reduce(ones)
    n = int(ones[0])
    if local_rank == 0:
        print("global devices:", n, "local:", local, flush=True)
    if n != local * replicas:
        sys.exit(f"WORLD FAILED: {n} ranks joined, want {local} x "
                 f"{replicas}")
    if local_rank == 0:
        print("PLATFORM OK:", platform(device, local_rank), flush=True)
    x = torch.tensor([float(rank + 1)], device=dev)
    dist.all_reduce(x)
    expected = n * (n + 1) / 2
    if float(x[0]) != expected:
        sys.exit(f"GLOBAL PSUM FAILED: {float(x[0])} != {expected}")
    if local_rank == 0:
        print("GLOBAL PSUM OK:", float(x[0]), "over", n, "ranks",
              flush=True)
    dist.destroy_process_group()


def main():
    device = device_arg()
    ordinal = int(os.environ["POD_NAME"].rsplit("-", 1)[-1])
    replicas = int(os.environ["TPU_SIM_REPLICAS"])
    coordinator = os.environ["TPU_SIM_COORDINATOR"]
    local = allocated_gpus()
    print("process", ordinal, "of", replicas, "coordinator", coordinator,
          flush=True)
    device_gate(local, device)
    mp.spawn(rank_main, nprocs=local, join=True, args=(
        ordinal, local, replicas, device, coordinator))


if __name__ == "__main__":
    main()
''')


# the kernel pod's inline kernel: C = A B for n x n fp32 in 16 x 16
# shared-memory tiles (the counterpart of pods/pallas-pod.yaml:28-35)
_KERNEL_SOURCE = r'''
#include <cuda_runtime.h>

__global__ void pod_matmul_kernel(const float* a, const float* b, float* c,
                                  int n) {
  __shared__ float as[16][16];
  __shared__ float bs[16][16];
  int row = blockIdx.y * 16 + threadIdx.y;
  int col = blockIdx.x * 16 + threadIdx.x;
  float acc = 0.f;
  for (int t = 0; t < n; t += 16) {
    as[threadIdx.y][threadIdx.x] = a[row * n + t + threadIdx.x];
    bs[threadIdx.y][threadIdx.x] = b[(t + threadIdx.y) * n + col];
    __syncthreads();
    for (int k = 0; k < 16; ++k) acc += as[threadIdx.y][k] * bs[k][threadIdx.x];
    __syncthreads();
  }
  c[row * n + col] = acc;
}

extern "C" int pod_matmul(const float* a, const float* b, float* c, int n,
                          void* stream) {
  if (n <= 0 || n % 16) return (int)cudaErrorInvalidValue;
  dim3 block(16, 16), grid(n / 16, n / 16);
  pod_matmul_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a, b, c, n);
  return (int)cudaGetLastError();
}
'''


def kernel_payload() -> str:
    """The kernel pod's script: the device gate, then the inline kernel
    built by nvcc for the card's capability into ``--build-dir``,
    loaded through ctypes, run on a 128 x 128 fp32 product and checked
    against ``torch.matmul`` (TF32 off) at atol 1e-4. Prints DEVICES OK,
    PLATFORM OK and CUDA KERNEL OK (with max_abs_err, build_s, arch and
    the kernel's launches)."""
    return ('"""Build an inline CUDA kernel and check it against '
            'torch.matmul."""\n' + _HEADER + textwrap.dedent('''\
import ctypes
import shutil
import subprocess
import time
from pathlib import Path
''') + f'''
KERNEL_SOURCE = r\'\'\'{_KERNEL_SOURCE}\'\'\'
LIBRARY = {KERNEL_LIBRARY!r}
ATOL = {KERNEL_POD_ATOL!r}
''' + _GATE + '''

def nvcc():
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        sys.exit("CUDA KERNEL FAILED: nvcc not found")
    return found


def build(build_dir):
    """nvcc for the capability the card reports; (library, seconds,
    arch)."""
    major, minor = torch.cuda.get_device_capability()
    arch = f"{major}{minor}" + ("a" if major >= 9 else "")
    build_dir.mkdir(parents=True, exist_ok=True)
    src = build_dir / "cuda_kernel_pod.cu"
    src.write_text(KERNEL_SOURCE)
    lib = build_dir / LIBRARY
    t0 = time.perf_counter()
    res = subprocess.run(
        [nvcc(), "-gencode", f"arch=compute_{arch},code=sm_{arch}", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"CUDA KERNEL FAILED: nvcc exited {res.returncode}:\\n"
                 f"{res.stdout}{res.stderr}")
    return lib, time.perf_counter() - t0, f"sm_{arch}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--build-dir", default="/tmp/cuda-kernel-pod")
    args = ap.parse_args()
    device_gate(allocated_gpus(), "cuda")
    print("PLATFORM OK:", platform("cuda"), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_path, build_s, arch = build(Path(args.build_dir))
    fn = ctypes.CDLL(str(lib_path)).pod_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((128, 128), generator=gen, device="cuda")
    b = torch.randn((128, 128), generator=gen, device="cuda")
    c = torch.empty_like(a)
    rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), 128,
            torch.cuda.current_stream().cuda_stream)
    launches = 1
    if rc:
        sys.exit(f"CUDA KERNEL FAILED: launch returned CUDA error {rc}")
    torch.cuda.synchronize()
    want = torch.matmul(a, b)
    err = float((c - want).abs().max())
    if not torch.allclose(c, want, atol=ATOL):
        sys.exit(f"CUDA KERNEL FAILED: max_abs_err {err} (atol {ATOL})")
    print(f"CUDA KERNEL OK: 128x128 fp32 product matches torch.matmul "
          f"(atol {ATOL}); max_abs_err={err!r} build_s={build_s:.3f} "
          f"arch={arch} launches={launches}", flush=True)


if __name__ == "__main__":
    main()
''')


def _shell(script: str, payload: str) -> str:
    """The container's ``sh -c`` program: write the payload to a file
    (its ranks are started with the spawn method, which imports the main
    module by path), run it, then stay up for the logs."""
    return (f"set -e\ncat > /tmp/{script} <<'PYEOF'\n{payload}PYEOF\n"
            f"python3 /tmp/{script}\nsleep 3600\n")


# ---------------------------------------------------------------------
# the objects


def _node_selector() -> Dict[str, str]:
    return {LABEL_HARDWARE_TYPE: "gpu"}


def _taint_toleration() -> List[Dict[str, str]]:
    # the source system's taint: gpu=true:NoSchedule
    return [{"key": "gpu", "operator": "Equal", "value": "true",
             "effect": "NoSchedule"}]


def _pod(name: str, container: str, script: str, payload: str,
         gpus: int) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name},
        "spec": {
            "restartPolicy": "Never",
            "containers": [{
                "name": container,
                "image": GPU_IMAGE,
                "command": ["sh", "-c"],
                "args": [_shell(script, payload)],
                "env": [{"name": "TPU_SIM_GPUS", "value": str(gpus)}],
                "resources": {"limits": {RESOURCE_GPU: gpus}},
            }],
            "nodeSelector": _node_selector(),
            "tolerations": _taint_toleration(),
        },
    }


def torch_gpu_pod(gpus: int = GPUS_PER_NODE) -> str:
    """``pods/torch-gpu-pod.yaml``: the device gate and an all-reduce
    over every GPU of a simulated GPU node."""
    header = (
        "# PyTorch device gate + collective smoke on one GPU node: the\n"
        "# H100 counterpart of pods/jax-tpu-pod.yaml.\n"
        f"# Requests {gpus} GPUs; torch.cuda.device_count() must equal them\n"
        "# (TPU_SIM_GPUS, and CUDA_VISIBLE_DEVICES where it is set), or\n"
        "# the pod exits non-zero naming both counts. Then an all-reduce\n"
        "# over the allocated GPUs, NCCL, one rank each.\n"
        "# GENERATED by kind_tpu_sim_torch.manifests.torch_gpu_pod.\n"
        "# CI greps for \"DEVICES OK\", \"PLATFORM OK\" and \"PSUM OK\".\n")
    return header + to_yaml(_pod("torch-gpu-test", "torch",
                                 "torch_gpu_gate.py", gate_payload(), gpus))


def cuda_kernel_pod() -> str:
    """``pods/cuda-kernel-pod.yaml``: the kernel-toolchain smoke."""
    header = (
        "# CUDA kernel-toolchain smoke: the H100 counterpart of\n"
        "# pods/pallas-pod.yaml. An inline CUDA C 128x128 fp32 product,\n"
        "# built by nvcc for the capability the card reports (sm_90a on\n"
        "# an H100), loaded through ctypes and checked against\n"
        "# torch.matmul (atol 1e-4).\n"
        "# GENERATED by kind_tpu_sim_torch.manifests.cuda_kernel_pod.\n"
        "# CI greps for \"CUDA KERNEL OK\".\n")
    return header + to_yaml(_pod("cuda-kernel-test", "cuda-kernel-test",
                                 "cuda_kernel_pod.py", kernel_payload(), 1))


def _world_names(hostnames: List[str]):
    """(StatefulSet, Service, coordinator host) of a world whose pods
    carry ``hostnames`` (``<name>-<i>.<service>.<domain>``)."""
    host = hostnames[0]
    pod, service = host.split(".")[:2]
    return pod.rsplit("-", 1)[0], service, host


def _torch_world_manifest(s: topo.SliceTopology, hostnames: List[str],
                          extra_selector: Dict[str, str],
                          slice_note: Optional[str], regen: str) -> str:
    name, service, host = _world_names(hostnames)
    replicas = s.num_hosts
    chips = s.chips_per_host
    port = topo.DEFAULT_COORDINATOR_PORT
    service_doc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": service},
        "spec": {
            "clusterIP": "None",
            "selector": {"app": name},
            "ports": [{"name": "coordinator", "port": port}],
        },
    }
    statefulset = {
        "apiVersion": "apps/v1",
        "kind": "StatefulSet",
        "metadata": {"name": name},
        "spec": {
            "serviceName": service,
            "replicas": replicas,
            "podManagementPolicy": "Parallel",
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    "affinity": {"podAntiAffinity": {
                        "requiredDuringSchedulingIgnoredDuringExecution": [{
                            "labelSelector": {"matchLabels": {"app": name}},
                            "topologyKey": "kubernetes.io/hostname"}]}},
                    "nodeSelector": {**_node_selector(), **extra_selector},
                    "tolerations": _taint_toleration(),
                    "containers": [{
                        "name": "torch",
                        "image": GPU_IMAGE,
                        "command": ["sh", "-c"],
                        "args": [_shell("torch_multihost.py",
                                        multihost_payload())],
                        "env": [
                            {"name": "TPU_SIM_REPLICAS",
                             "value": str(replicas)},
                            {"name": "TPU_SIM_GPUS", "value": str(chips)},
                            {"name": "TPU_SIM_COORDINATOR",
                             "value": f"{host}:{port}"},
                            {"name": "POD_NAME", "valueFrom": {"fieldRef": {
                                "fieldPath": "metadata.name"}}},
                        ],
                        "resources": {"limits": {RESOURCE_GPU: chips}},
                    }],
                },
            },
        },
    }
    what = (f"slice {slice_note}" if slice_note
            else "the whole simulated slice")
    header = (
        f"# Multi-host torch.distributed over {what}: the GPU\n"
        "# counterpart of pods/jax-multihost.yaml.\n"
        "# GENERATED by kind_tpu_sim_torch.manifests.torch_multihost_manifest\n"
        f"# for {s.accelerator_type} topology "
        f"{topo.format_topology(s.dims)} "
        f"({replicas} hosts x {chips} GPUs).\n"
        f"# Regenerate: python -m kind_tpu_sim_torch manifests {regen}\n"
        f"# CI greps for \"GLOBAL PSUM OK\" on {name}-0.\n")
    return header + to_yaml(service_doc) + "---\n" + to_yaml(statefulset)


def torch_multihost_manifest(accelerator: str = topo.DEFAULT_ACCELERATOR,
                             topology: str = topo.DEFAULT_TOPOLOGY,
                             num_slices: int = 1) -> str:
    """Services and StatefulSets of a multi-host ``torch.distributed``
    world from the slice contract: a host of the slice is a GPU node
    running one pod with a GPU per chip. ``num_slices > 1`` renders one
    Service and StatefulSet per slice, each its own world pinned to its
    slice's nodes by the slice-id label, the documents separated by
    ``---`` (the reference joins its slices' documents with a bare
    newline, so a YAML reader merges each slice's StatefulSet into the
    next slice's Service)."""
    ms = topo.make_multislice(num_slices, accelerator=accelerator,
                              topology=topology)
    s = ms.slice_topo
    regen = (f"torch-multihost --accelerator={accelerator} "
             f"--topology={topo.format_topology(s.dims)}")
    if num_slices == 1:
        return _torch_world_manifest(s, ms.hostnames(), {}, None, regen)
    regen += f" --num-slices={num_slices}"
    return "---\n".join(
        _torch_world_manifest(s, ms.slice_hostnames(sid),
                              {LABEL_SLICE_ID: str(sid)},
                              f"{sid}/{num_slices}", regen)
        for sid in range(num_slices))


# ---------------------------------------------------------------------
# the cluster half: what create applies


def kind_cluster_config(cfg: SimConfig) -> str:
    """kind Cluster config: 1 control-plane + N workers + registry mirror.

    Mirror patch matches the source system's containerdConfigPatches
    (kind-gpu-sim.sh:89-92); worker count is derived from the simulated
    slice instead of being hardcoded (:93-97).
    """
    doc = {
        "kind": "Cluster",
        "apiVersion": "kind.x-k8s.io/v1alpha4",
        "containerdConfigPatches": [
            (
                '[plugins."io.containerd.grpc.v1.cri".registry.mirrors.'
                f'"localhost:{cfg.registry_port}"]\n'
                f'  endpoint = ["http://{cfg.registry_name}:5000"]\n'
            )
        ],
        "nodes": [{"role": "control-plane"}]
        + [{"role": "worker"} for _ in range(cfg.workers)],
    }
    return yamlsubset.dump(doc)


def registry_configmap(cfg: SimConfig) -> str:
    """Standard local-registry-hosting ConfigMap (kind-gpu-sim.sh:131-141)."""
    doc = {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {
            "name": "local-registry-hosting",
            "namespace": "kube-public",
        },
        "data": {
            "localRegistryHosting.v1": (
                f'host: "localhost:{cfg.registry_port}"\n'
                'help: "https://kind.sigs.k8s.io/docs/user/local-registry/"\n'
            ),
        },
    }
    return yamlsubset.dump(doc)


def containerd_hosts_toml(cfg: SimConfig) -> str:
    """Per-node registry mirror config (kind-gpu-sim.sh:122-125)."""
    return (
        f'[host."http://{cfg.registry_name}:5000"]\n'
        '  capabilities = ["pull", "resolve"]\n'
    )


def _vendor_toleration(vendor: str) -> List[Dict[str, str]]:
    if vendor == "tpu":
        return [
            {
                "key": topo.TAINT_KEY,
                "operator": "Equal",
                "value": topo.TAINT_VALUE,
                "effect": topo.TAINT_EFFECT,
            }
        ]
    # reference taint: gpu=true:NoSchedule (kind-gpu-sim.sh:110)
    return [
        {
            "key": "gpu",
            "operator": "Equal",
            "value": "true",
            "effect": "NoSchedule",
        }
    ]


def _vendor_node_selector(vendor: str) -> Dict[str, str]:
    return {
        topo.LABEL_HARDWARE_TYPE: "tpu" if vendor == "tpu" else "gpu"
    }


def tpu_plugin_daemonset(cfg: SimConfig, image: str) -> str:
    """DaemonSet for the in-repo fake TPU device plugin.

    Structure follows the reference's NVIDIA deploy (kind-gpu-sim.sh:291-329)
    — node selector + toleration + privileged + kubelet socket-dir mount —
    but the image is our native C++ plugin and its behavior is driven by
    the slice-topology env block rather than FAIL_ON_INIT_ERROR.
    """
    s = cfg.slice
    # Slice-global identity shared by every worker; the plugin derives
    # the per-node TPU_WORKER_ID from NODE_NAME (plugin/src/
    # device_plugin.cc WorkerIdFromNodeName).
    w0 = s.worker_env(0)
    env = [
        {"name": "TPU_SIM_CHIPS", "value": str(s.chips_per_host)},
        {"name": "TPU_SIM_RESOURCE", "value": RESOURCE_BY_VENDOR["tpu"]},
        {"name": "TPU_SIM_ACCELERATOR", "value": s.spec.gke_type},
        {"name": "TPU_SIM_TOPOLOGY", "value": topo.format_topology(s.dims)},
        {
            "name": "TPU_SIM_ACCELERATOR_TYPE",
            "value": w0["TPU_ACCELERATOR_TYPE"],
        },
        {
            "name": "TPU_SIM_CHIPS_PER_HOST_BOUNDS",
            "value": w0["TPU_CHIPS_PER_HOST_BOUNDS"],
        },
        {"name": "TPU_SIM_HOST_BOUNDS", "value": w0["TPU_HOST_BOUNDS"]},
        {"name": "TPU_SIM_HOSTNAMES", "value": w0["TPU_WORKER_HOSTNAMES"]},
        {"name": "TPU_SIM_UNHEALTHY_FILE", "value": UNHEALTHY_FILE},
        {
            "name": "NODE_NAME",
            "valueFrom": {"fieldRef": {"fieldPath": "spec.nodeName"}},
        },
    ]
    if cfg.num_slices > 1:
        # Multislice: the plugin decomposes the node's global worker
        # index into (slice, local worker) and injects the MEGASCALE_*
        # cross-slice contract at Allocate. Hostnames become the full
        # cross-slice list; the plugin narrows to this slice's window.
        ms = cfg.multislice
        all_hosts = ms.hostnames()
        env = [e for e in env if e.get("name") != "TPU_SIM_HOSTNAMES"]
        env.extend([
            {"name": "TPU_SIM_HOSTNAMES",
             "value": ",".join(all_hosts)},
            {"name": "TPU_SIM_NUM_SLICES",
             "value": str(ms.num_slices)},
            {"name": "TPU_SIM_HOSTS_PER_SLICE",
             "value": str(s.num_hosts)},
            {"name": "TPU_SIM_MEGASCALE_COORDINATOR",
             "value": ms.megascale_env(0)[
                 "MEGASCALE_COORDINATOR_ADDRESS"]},
        ])
    doc = {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": {
            "name": "tpu-sim-device-plugin",
            "namespace": PLUGIN_NAMESPACE,
            "labels": {"app": PLUGIN_APP_LABEL},
        },
        "spec": {
            "selector": {"matchLabels": {"app": PLUGIN_APP_LABEL}},
            "template": {
                "metadata": {"labels": {"app": PLUGIN_APP_LABEL}},
                "spec": {
                    "nodeSelector": _vendor_node_selector("tpu"),
                    "tolerations": _vendor_toleration("tpu"),
                    "priorityClassName": "system-node-critical",
                    "containers": [
                        {
                            "name": "tpu-device-plugin",
                            "image": image,
                            "imagePullPolicy": "IfNotPresent",
                            "securityContext": {"privileged": True},
                            "env": env,
                            "volumeMounts": [
                                {
                                    "name": "device-plugin",
                                    "mountPath": KUBELET_DP_DIR,
                                },
                                {
                                    "name": "sim-state",
                                    "mountPath": SIM_STATE_DIR,
                                },
                            ],
                        }
                    ],
                    "volumes": [
                        {
                            "name": "device-plugin",
                            "hostPath": {
                                "path": KUBELET_DP_DIR,
                                "type": "DirectoryOrCreate",
                            },
                        },
                        {
                            "name": "sim-state",
                            "hostPath": {
                                "path": SIM_STATE_DIR,
                                "type": "DirectoryOrCreate",
                            },
                        },
                    ],
                },
            },
        },
    }
    return yamlsubset.dump(doc)


def gpu_plugin_daemonset(cfg: SimConfig, vendor: str, image: str) -> str:
    """ROCm/NVIDIA vendor-plugin DaemonSets (parity with :242-336)."""
    if vendor == "rocm":
        name = "amdgpu-device-plugin-daemonset"
        app = "amdgpu-device-plugin"
        container: Dict[str, object] = {
            "name": "amdgpu-dp-ds",
            "image": image,
            "imagePullPolicy": "IfNotPresent",
            "securityContext": {"privileged": True},
        }
        volumes: Optional[List[Dict[str, object]]] = None
    elif vendor == "nvidia":
        name = "nvidia-device-plugin-daemonset"
        app = "nvidia-device-plugin"
        container = {
            "name": "nvidia-device-plugin-ctr",
            "image": image,
            "securityContext": {"privileged": True},
            # lets the real plugin start with no NVML/GPU present
            # (kind-gpu-sim.sh:318-320)
            "env": [{"name": "FAIL_ON_INIT_ERROR", "value": "false"}],
            "volumeMounts": [
                {"name": "device-plugin", "mountPath": KUBELET_DP_DIR}
            ],
        }
        volumes = [
            {
                "name": "device-plugin",
                "hostPath": {
                    "path": KUBELET_DP_DIR,
                    "type": "DirectoryOrCreate",
                },
            }
        ]
    else:
        raise ValueError(f"no vendor plugin DaemonSet for {vendor!r}")

    pod_spec: Dict[str, object] = {
        "nodeSelector": _vendor_node_selector(vendor),
        "tolerations": _vendor_toleration(vendor),
        "containers": [container],
    }
    if vendor == "nvidia":
        pod_spec["volumes"] = volumes
    doc = {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": {"name": name, "namespace": PLUGIN_NAMESPACE},
        "spec": {
            "selector": {"matchLabels": {"app": app}},
            "template": {
                "metadata": {"labels": {"app": app}},
                "spec": pod_spec,
            },
        },
    }
    return yamlsubset.dump(doc)


def plugin_app_label(vendor: str) -> str:
    return {
        "tpu": PLUGIN_APP_LABEL,
        "rocm": "amdgpu-device-plugin",
        "nvidia": "nvidia-device-plugin",
    }[vendor]
