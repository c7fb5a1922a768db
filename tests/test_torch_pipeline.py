"""The port's slice as a whole: the R9 DNA dtw main path of
sigfish_tpu_torch on the CPU (the kernel's plain PyTorch version) gives
PAF byte-identical to sigfish_tpu's, through the library and the CLI.

Workload: a synthetic two-strand reference and pore-model reads drawn
from it (the pattern of tests/test_chunked_ref.py), in several batches,
with short reads that take the clipped-read path.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 64           # -q: small, so the JAX kernel's interpret mode stays quick
BATCH = 8        # -K: several batches
N_BASES = 1500


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """A FASTA of two contigs and a BLOW5 of 20 reads: 16 full-length,
    4 clipped, every third drawn from the reverse strand."""
    from sigfish_tpu_torch.io.blow5 import Slow5Record, Slow5Writer
    from sigfish_tpu_torch.models.genref import _seq_bytes, kmer_ranks, reverse_complement
    from sigfish_tpu_torch.models.pore_model import MODEL_ID_DNA_R9, load_builtin_model

    d = tmp_path_factory.mktemp("torch_pipeline")
    rng = np.random.default_rng(11)
    model = load_builtin_model(MODEL_ID_DNA_R9)
    k = model.kmer_size
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, N_BASES))
    fa = d / "ref.fa"
    fa.write_text(f">synth1\n{seq[:900]}\n>synth2\n{seq[900:]}\n")

    def signal_from(src, start, n_events):
        sub = src[start : start + n_events + k - 1]
        levels = model.level_mean[kmer_ranks(_seq_bytes(sub), k, warn_non_acgt=False)]
        dwells = rng.integers(9, 15, size=levels.size)
        pa = np.repeat(levels, dwells).astype(np.float64)
        pa += rng.normal(0.0, 1.2, pa.size)
        raw = np.rint(pa * 8192.0 / 1400.0 - 10.0)
        return np.clip(raw, -32000, 32000).astype(np.int16)

    bl = d / "reads.blow5"
    with Slow5Writer(str(bl), header_data=None) as w:
        for i in range(20):
            # every fifth read is short: 50 + 30 events < prefix + query
            n_ev = 80 if i % 5 == 4 else 200
            src = seq[:900] if i % 3 else reverse_complement(seq[:900])
            start = int(rng.integers(0, 850 - n_ev))
            w.write_record(
                Slow5Record(
                    read_id=f"r{i}", read_group=0, digitisation=8192.0,
                    offset=10.0, range=1400.0, sampling_rate=4000.0,
                    raw_signal=signal_from(src, start, n_ev),
                )
            )
    return str(fa), str(bl)


def _run_port(fa, bl, **kw) -> str:
    from sigfish_tpu_torch.runtime.pipeline import Core, Options, run_dtw

    core = Core(fa, bl, Options(query_size=W, batch_size=BATCH, num_thread=2,
                                device="cpu", **kw))
    out = io.StringIO()
    run_dtw(core, out)
    core.close()
    return out.getvalue()


def _run_jax(fa, bl, engine) -> str:
    from sigfish_tpu.runtime.pipeline import Core, Options, run_dtw

    core = Core(fa, bl, Options(query_size=W, batch_size=BATCH, num_thread=2,
                                engine=engine))
    out = io.StringIO()
    run_dtw(core, out)
    core.close()
    return out.getvalue()


@pytest.fixture(scope="module")
def port_paf(workload):
    return _run_port(*workload)


@pytest.mark.parametrize("engine", ["native", "pallas"])
def test_port_paf_matches_jax(workload, port_paf, engine):
    """PAF byte-identical to the JAX package's native engine and its
    Pallas wavefront engine (interpret mode), clipped reads included."""
    want = _run_jax(*workload, engine)
    lines = port_paf.splitlines()
    assert len(lines) >= 18, port_paf
    assert {"r4", "r9"} <= {ln.split("\t")[0] for ln in lines}  # clipped reads mapped
    assert {ln.split("\t")[4] for ln in lines} == {"+", "-"}
    assert port_paf == want


def test_port_cli_paf_matches_library(workload, port_paf, tmp_path):
    """`python -m sigfish_tpu_torch.cli dtw ... --device cpu` writes the
    same bytes as the library run."""
    fa, bl = workload
    out = tmp_path / "out.paf"
    r = subprocess.run(
        [sys.executable, "-m", "sigfish_tpu_torch.cli", "dtw", fa, bl,
         "-q", str(W), "-K", str(BATCH), "-t", "2", "--device", "cpu",
         "-o", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert out.read_text() == port_paf
    assert "total entries: 20" in r.stderr


def test_port_state_from_jax_core(workload, port_paf):
    """A Core fed the JAX package's arrays through core_state_from_numpy
    maps the same bytes."""
    from sigfish_tpu.runtime.pipeline import Core as JCore, Options as JOptions
    from sigfish_tpu_torch.convert import core_state_from_numpy

    fa, bl = workload
    j = JCore(fa, bl, JOptions(query_size=W, num_thread=1, engine="native"))
    state = core_state_from_numpy(
        j.model.level_mean, j.model.level_stdv, j.kmer_size, j.ref_cat, j.reset,
        j.track_offsets, j.track_sizes, j.track_meta,
    )
    j.close()
    from sigfish_tpu_torch.runtime.pipeline import Core, Options, run_dtw

    core = Core(fa, bl, Options(query_size=W, batch_size=BATCH, num_thread=2,
                                device="cpu"), state=state)
    out = io.StringIO()
    run_dtw(core, out)
    core.close()
    assert out.getvalue() == port_paf


def test_port_device_chunk_split(workload, port_paf, monkeypatch):
    """Batches wider than DEVICE_CHUNK are split into sub-launches with
    the same result."""
    from sigfish_tpu_torch.runtime.pipeline import Core

    monkeypatch.setattr(Core, "DEVICE_CHUNK", 32)
    fa, bl = workload
    from sigfish_tpu_torch.runtime.pipeline import Options, run_dtw

    core = Core(fa, bl, Options(query_size=W, batch_size=128, num_thread=2, device="cpu"))
    out = io.StringIO()
    run_dtw(core, out)
    core.close()
    assert out.getvalue() == port_paf
