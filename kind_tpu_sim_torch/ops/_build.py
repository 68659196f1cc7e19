"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together) and linked into one shared library
under ``build/kind_tpu_sim_torch/`` at the repository root. The library
exposes a plain C interface and is loaded with ``ctypes``; pointers and
the stream cross as ``c_void_p``. It is built at first use and rebuilt
whenever a source (or the flags) change: the file name carries a hash
of both. A missing ``nvcc`` or a failed build raises with the
compiler's output — there is no fallback.

Four kernels come in two routes each (``matmul``, the flash forward,
the flash backward's dq and dk/dv): ``TENSOR_CORES`` (wgmma fed by TMA)
and ``CUDA_CORES`` (the first versions, kept for fp32 and for what TMA
cannot describe); the exact int8 product has three (``ops/int8_matmul.py``:
wgmma, gemv, dp4a). The wrappers choose one from the inputs alone,
before the launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kind_tpu_sim_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# per-kernel registers, shared memory and spills, kept in the build log
PTXAS_VERBOSE = ("-Xptxas", "-v")
TENSOR_CORES = "tensor_cores"
CUDA_CORES = "cuda_cores"
ROUTES = (TENSOR_CORES, CUDA_CORES)


def sources() -> list:
    return sorted(SOURCE_DIR.glob("*.cu"))


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, else PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of kind_tpu_sim_torch cannot be built")
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    digest.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SOURCE_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkind_tpu_sim_torch_{digest.hexdigest()[:16]}.so"


def _run(cmds: Sequence[Sequence[str]]) -> str:
    """Run compiler commands concurrently; raise with every output if
    any fails. Returns the combined output."""
    procs = [subprocess.Popen(list(cmd), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs, failed = [], False
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outputs.append(f"$ {' '.join(cmd)}\n{out}")
        failed = failed or proc.returncode != 0
    log = "\n".join(outputs)
    if failed:
        raise RuntimeError(f"CUDA kernel build failed:\n{log}")
    return log


def build() -> Path:
    """The shared library for the current sources, compiling it if it
    is not built yet. The compiler log sits beside it (``.log``)."""
    lib = library_path()
    if lib.exists():
        return lib
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        log = _run([[compiler, *NVCC_FLAGS, *PTXAS_VERBOSE, "-c", str(src),
                     "-o", str(obj)]
                    for src, obj in zip(sources(), objs)])
        staged = Path(tmp) / lib.name
        log += "\n" + _run([[compiler, *NVCC_FLAGS, "-shared", "-o",
                             str(staged), *map(str, objs)]])
        lib.with_suffix(".log").write_text(log)
        os.replace(staged, lib)  # atomic: a reader never sees a partial .so
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))


@functools.lru_cache(maxsize=None)
def function(name: str, argtypes: tuple):
    """A C entry point of the library with its argument types declared
    (``c_void_p`` for every pointer and the stream) and an int result:
    the CUDA error code of the launch."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a failure: a CUDA error code
    (> 0), or a tensor map the driver refused to encode (-CUresult)."""
    if err > 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if err < 0:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused a "
                           f"tensor map (CUresult {-err})")
