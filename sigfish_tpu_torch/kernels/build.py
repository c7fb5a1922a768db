"""Build and load the port's CUDA kernels.

Each kernel is one source under sigfish_tpu_torch/csrc/ with a plain C
entry, compiled by nvcc for Hopper into a shared library under the
checkout's build/ directory (git-ignored) at first use, and loaded with
ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and flags, so a rebuilt
source never loads a stale library. Never --use_fast_math: the kernels
are held bit for bit to their plain PyTorch versions. Nothing here runs
at import; a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import concurrent.futures as _fut
import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# one source csrc/<name>.cu per kernel
KERNELS = ("wavefront", "alu_peak", "events", "polya", "gap_dtw", "banded_dtw", "scan")


def nvcc_path() -> str:
    p = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(p):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return p


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{h}.so")


def build(name: str) -> tuple[str, str]:
    """Compile csrc/<name>.cu unless its library exists; returns (path,
    the compiler's report: ptxas' registers, shared memory and spills),
    the report kept beside the library for later loads."""
    so = library_path(name)
    report = f"{so}.log"
    if os.path.exists(so):
        with open(report) as f:
            return so, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{r.stdout}\n{r.stderr}")
    with open(report, "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, so)
    return so, r.stdout + r.stderr


def build_all() -> dict[str, str]:
    """Build every kernel, one nvcc per source, all started together.
    Returns each kernel's compiler report."""
    with _fut.ThreadPoolExecutor(max_workers=len(KERNELS)) as ex:
        futs = {n: ex.submit(build, n) for n in KERNELS}
        return {n: f.result()[1] for n, f in futs.items()}


def sass(name: str) -> str | None:
    """The SASS of csrc/<name>.cu's library (built if needed), as
    `cuobjdump -sass` prints it; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    r = subprocess.run([tool, "-sass", build(name)[0]], capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed for {name}:\n{r.stderr}")
    return r.stdout


def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and load it; the caller declares
    its C entry's argument types."""
    return ctypes.CDLL(build(name)[0])
