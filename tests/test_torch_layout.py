"""The port's layout helpers (sigfish_tpu_torch/ops/layout.py) against
their JAX-package counterparts, its copies of the JAX-free host modules
against their originals, and the port's independence from JAX: it
imports with jax blocked, loads no module of sigfish_tpu, and no file of
it imports either."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from sigfish_tpu.ops import candidates_dev as jcd
from sigfish_tpu.ops import sdtw as jsdtw
from sigfish_tpu.ops import sdtw_pallas as jpal
from sigfish_tpu_torch.ops import layout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sigfish_tpu_torch")


def _tracks(rng):
    sizes = rng.integers(0, 300, size=int(rng.integers(1, 6)))
    return [rng.standard_normal(int(s)).astype(np.float32) for s in sizes]


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.atleast_1d(x), np.atleast_1d(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8))


def test_constants_equal():
    assert layout.PAD == jpal.PAD and layout.BIG == jpal.BIG
    assert layout.WF_ALIGN == jpal.WF_TD


@pytest.mark.parametrize("seed", range(4))
def test_pad_tracks_and_column_maps(seed):
    rng = np.random.default_rng(seed)
    tracks = _tracks(rng)
    for ckpt, align in ((512, 1), (64, 48), (32, 250)):
        got = layout.pad_tracks(tracks, ckpt=ckpt, align=align)
        _assert_same(got, jsdtw.pad_tracks(tracks, ckpt=ckpt, align=align))
        ref, _, offs = got
        sizes = [t.size for t in tracks]
        for ts in (None, sizes):
            _assert_same(
                layout.build_column_maps(offs, ref.shape[0], track_sizes=ts),
                jcd.build_column_maps(offs, ref.shape[0], track_sizes=ts),
            )


@pytest.mark.parametrize("seed", range(3))
def test_query_batch_and_wavefront_inputs(seed):
    rng = np.random.default_rng(100 + seed)
    W = int(rng.integers(8, 64))
    qlist = [rng.standard_normal(int(n)).astype(np.float32)
             for n in rng.integers(0, W + 1, size=7)]
    for pad_q in (None, 64, 128):
        got = layout.make_query_batch(qlist, pad_q=pad_q)
        _assert_same(got, jsdtw.make_query_batch(qlist, pad_q=pad_q))
    qb, qlens, _ = layout.make_query_batch(qlist, pad_q=64)
    _assert_same(
        layout.shift_queries_for_clip(qb, qlens, W - 1),
        jpal.shift_queries_for_clip(qb, qlens, W - 1),
    )
    ref, reset, _ = layout.pad_tracks(_tracks(rng), ckpt=64, align=W)
    for Q, td in ((64, 32), (128, 256)):
        _assert_same(
            layout.prepare_wavefront_inputs(ref, reset, Q, td=td),
            jpal.prepare_wavefront_inputs(ref, reset, Q, td=td),
        )
    # the default rounding is the JAX package's default tile
    _assert_same(
        layout.prepare_wavefront_inputs(ref, reset, 64),
        jpal.prepare_wavefront_inputs(ref, reset, 64),
    )


def test_unpack_top5():
    rng = np.random.default_rng(5)
    for k in (5, 3):
        ts = rng.standard_normal((6, k)).astype(np.float32)
        tp = rng.integers(-1, 1 << 30, size=(6, k)).astype(np.int32)
        packed = np.concatenate([ts, tp.view(np.float32)], axis=1)
        got = layout.unpack_top5(packed, k=k)
        _assert_same(got, jcd.unpack_top5(packed, k=k))
        _assert_same(got, (ts, tp))


_MODULES = [
    "sigfish_tpu_torch",
    "sigfish_tpu_torch.cli",
    "sigfish_tpu_torch.convert",
    "sigfish_tpu_torch.eval",
    "sigfish_tpu_torch.io.blow5",
    "sigfish_tpu_torch.io.blow5_idx",
    "sigfish_tpu_torch.io.fasta",
    "sigfish_tpu_torch.kernels.build",
    "sigfish_tpu_torch.models.derive_models",
    "sigfish_tpu_torch.models.export_tsv",
    "sigfish_tpu_torch.models.genref",
    "sigfish_tpu_torch.models.pore_model",
    "sigfish_tpu_torch.models.train_model",
    "sigfish_tpu_torch.native",
    "sigfish_tpu_torch.ops.alu_peak",
    "sigfish_tpu_torch.ops.candidates",
    "sigfish_tpu_torch.ops.candidates_dev",
    "sigfish_tpu_torch.ops.chunked_ref",
    "sigfish_tpu_torch.ops.events",
    "sigfish_tpu_torch.ops.events_device",
    "sigfish_tpu_torch.ops.jnn",
    "sigfish_tpu_torch.ops.jnn_device",
    "sigfish_tpu_torch.ops.layout",
    "sigfish_tpu_torch.ops.sdtw_ref",
    "sigfish_tpu_torch.ops.sdtw_scan",
    "sigfish_tpu_torch.ops.sdtw_wavefront",
    "sigfish_tpu_torch.ops.train_dtw",
    "sigfish_tpu_torch.output",
    "sigfish_tpu_torch.parallel",
    "sigfish_tpu_torch.parallel.distributed",
    "sigfish_tpu_torch.parallel.shard",
    "sigfish_tpu_torch.runtime.pipeline",
    "sigfish_tpu_torch.scripts",
    "sigfish_tpu_torch.scripts.bench_alu_peak",
    "sigfish_tpu_torch.scripts.bench_carry",
    "sigfish_tpu_torch.scripts.bench_scan",
    "sigfish_tpu_torch.scripts.bench_train_dtw",
    "sigfish_tpu_torch.scripts.peak_memory",
    "sigfish_tpu_torch.scripts.timing",
    "sigfish_tpu_torch.utils",
]


# the JAX package's host modules the port keeps as its own copies, equal
# apart from their import lines (native/ differs on purpose: it builds
# into build/ and without libdeflate/zstd where their headers are absent)
_COPIES = [
    "eval.py", "output.py", "io/blow5.py", "io/blow5_idx.py", "io/fasta.py",
    "models/derive_models.py", "models/export_tsv.py", "models/genref.py",
    "models/pore_model.py", "ops/candidates.py", "ops/events.py",
    "ops/jnn.py", "ops/sdtw_ref.py", "utils/__init__.py", "utils/log.py", "utils/timers.py",
]


@pytest.mark.parametrize("rel", _COPIES)
def test_host_copy_equals_its_original(rel):
    imports = re.compile(r"^\s*(from\s+\S+\s+import\b|import\s)")

    def body(pkg):
        with open(os.path.join(REPO, pkg, rel)) as fh:
            return [ln for ln in fh.read().splitlines() if not imports.match(ln)]

    assert body("sigfish_tpu_torch") == body("sigfish_tpu")


def test_modules_listed_cover_the_package():
    found = set()
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                found.add(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    missing = found - set(_MODULES) - {"sigfish_tpu_torch.io", "sigfish_tpu_torch.kernels",
                                        "sigfish_tpu_torch.models", "sigfish_tpu_torch.ops",
                                        "sigfish_tpu_torch.runtime", "sigfish_tpu_torch.utils.log",
                                        "sigfish_tpu_torch.utils.timers"}
    assert not missing, f"add to _MODULES: {sorted(missing)}"


def test_imports_with_jax_blocked():
    """Every module imports in a process where `import jax` fails, and
    no module of sigfish_tpu gets loaded."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'sigfish_tpu' or k.startswith('sigfish_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_sources_import_no_jax_and_no_jax_package():
    """No file of the package, nor chip_smoke.py, imports jax or sigfish_tpu."""
    bad = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+sigfish_tpu\b(?!_torch)|"
        r"from\s+sigfish_tpu\b(?!_torch))",
        re.M,
    )
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    hits = []
    for p in paths:
        with open(p) as fh:
            for m in bad.finditer(fh.read()):
                hits.append(f"{os.path.relpath(p, REPO)}: {m.group(0).strip()}")
    assert not hits, hits
