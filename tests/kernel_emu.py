"""The port's warp-level CUDA kernels (csrc/gap_dtw.cu, csrc/banded_dtw.cu,
csrc/scan.cu) built for the CPU: each source as written, with its
launches (and the trainer kernels' dynamic shared memory and one inline
PTX line) rewritten for tests/cuda_emu/cuda_runtime.h (a stand-in runtime
whose blocks are std::threads, every warp in lockstep at its shuffles and
ballots), compiled with g++ and bound with the wrappers' own argument
types. Shared by tests/test_torch_train_emulated.py,
tests/test_torch_train.py and tests/test_torch_scan_emulated.py."""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

import pytest

from sigfish_tpu_torch.ops import sdtw_scan as ss
from sigfish_tpu_torch.ops import train_dtw as td

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "sigfish_tpu_torch", "csrc")

# (pattern, replacement) for the emulation: launches, dynamic shared
# memory, the SM id's inline PTX
LAUNCH = (r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), [^>]+>>>\(", r"emu_launch(\2, \3, \4, \1, ")
REWRITES = (
    LAUNCH,
    (r"extern __shared__ float smem\[\];", "float* smem = (float*)emu_smem;"),
    (r"asm volatile\(.*\);", "s = 0;"),
)

# each source's rewrites (every one must match) and its C entry's
# declaration
KERNEL_REWRITES = {"gap_dtw": REWRITES, "banded_dtw": REWRITES, "scan": (LAUNCH,)}
DECLARE = {"gap_dtw": lambda lib: td._declare(lib, "gap_dtw"),
           "banded_dtw": lambda lib: td._declare(lib, "banded_dtw"),
           "scan": ss._declare}


def emulated_source(name: str, extra=(), prelude: str = "") -> str:
    """csrc/<name>.cu rewritten by its KERNEL_REWRITES and then extra's (pattern,
    replacement) pairs, each of which must match; prelude goes after the
    includes."""
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        src = f.read()
    for pat, rep in (*KERNEL_REWRITES[name], *extra):
        src, k = re.subn(pat, rep, src)
        assert k, f"{name}.cu: nothing matches {pat!r}"
    if prelude:
        src = src.replace("\nnamespace {", f"\n{prelude}\nnamespace {{", 1)
    return src


def build(out_dir, name: str, extra=(), prelude: str = "", tag: str = "") -> ctypes.CDLL:
    """The emulated library of csrc/<name>.cu in out_dir (a pathlib.Path),
    its C entry declared as the wrapper declares it; skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the kernels' CPU emulation")
    src, so = out_dir / f"{name}{tag}.cpp", out_dir / f"{name}{tag}.so"
    src.write_text(emulated_source(name, extra, prelude))
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I",
                        os.path.join(HERE, "cuda_emu"), "-o", str(so), str(src)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return DECLARE[name](ctypes.CDLL(str(so)))
