"""The port's default direct-RNA run (`dtw --rna -q 500 -p -1`) on the CPU
(the kernel's plain PyTorch version at Q=512) against sigfish_tpu: PAF
byte-identical to its Pallas wavefront engine (interpret mode) and its
native engine, through the library and the CLI, with --rna and with the
header's experiment_type rna alone, and from a state carried across; the
polyA autodetect read by read; the plain wavefront at Q=512 bitwise.

Workload: chip_smoke.py's direct-RNA generator at a small size, 10
transcripts of 600-1,400 bases (both sides of gen_ref's min(750, L-4))
and 40 reads in several batches, among them clipped reads (fewer than
500 events past the polyA) and reads without adaptor and polyA, whose
query start falls back to event 50 (prefix fail).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNA = dict(rna=True, query_size=500, prefix_size=-1)
BATCH = 16       # -K: three batches
N_TX = 10
N_READS = 40
SEED = 7


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def workload(smoke, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rna")
    return smoke.make_rna_workload(str(d), N_TX, N_READS, SEED, tx_len=(600, 1_400))


def _run_port(fa, bl, state=None, **kw):
    from sigfish_tpu_torch.runtime.pipeline import Core, Options, run_dtw

    core = Core(fa, bl, Options(batch_size=BATCH, num_thread=2, device="cpu", **kw), state=state)
    out = io.StringIO()
    run_dtw(core, out)
    core.close()
    return out.getvalue(), core


def _run_jax(fa, bl, engine):
    from sigfish_tpu.runtime.pipeline import Core, Options, run_dtw

    core = Core(fa, bl, Options(batch_size=BATCH, num_thread=2, engine=engine, **RNA))
    out = io.StringIO()
    run_dtw(core, out)
    core.close()
    return out.getvalue(), core


@pytest.fixture(scope="module")
def port_run(workload):
    fa, bl, _ = workload
    return _run_port(fa, bl, **RNA)


def test_rna_workload_has_every_kind_of_read(smoke, workload, port_run):
    """Clipped reads, prefix-fail reads, forward-only 3'-end tracks at
    Q=512, and the reads mapped over their origin."""
    _, _, truth = workload
    paf, core = port_run
    assert core.total_reads == N_READS
    assert core.prefix_fail >= 1 and core.too_short >= 1
    assert core.pad_q == 512
    assert core.routes["oneshot"] >= 3 and core.routes["clip_pass"] >= 1
    assert core.routes["chunked"] == 0
    assert {s for _, s in core.track_meta} == {"+"}
    assert len(core.track_meta) == N_TX
    assert min(core.ref.ref_lengths) < 750 == max(core.ref.ref_lengths)
    assert max(core.ref.ref_st_offset) > 0  # 3'-end tracks of the longer transcripts
    assert smoke.overlap_share(paf, truth) >= 0.95


@pytest.mark.parametrize("engine", ["native", "pallas"])
def test_port_rna_paf_matches_jax(workload, port_run, engine):
    """PAF and counters byte-identical to the JAX package's native engine
    and its Pallas wavefront engine (interpret mode)."""
    fa, bl, _ = workload
    paf, core = port_run
    want, jcore = _run_jax(fa, bl, engine)
    assert len(paf.splitlines()) >= N_READS - 2
    assert paf == want
    for c in ("total_reads", "prefix_fail", "ignored", "too_short"):
        assert getattr(core, c) == getattr(jcore, c), c


def test_port_rna_header_autodetect(workload, port_run):
    """Without --rna, the header's experiment_type rna sets it: the same
    bytes."""
    fa, bl, _ = workload
    paf, core = _run_port(fa, bl, query_size=500, prefix_size=-1)
    assert core.opt.rna
    assert paf == port_run[0]


def _run_cli(fa, bl, out, *flags):
    return subprocess.run(
        [sys.executable, "-m", "sigfish_tpu_torch.cli", "dtw", fa, bl, *flags,
         "-q", "500", "-K", str(BATCH), "-t", "2", "--device", "cpu", "-o", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )


def test_port_rna_cli_matches_library(workload, port_run, tmp_path):
    """`python -m sigfish_tpu_torch.cli dtw ... --rna -q 500 -p -1
    --device cpu` writes the library run's bytes and counters."""
    fa, bl, _ = workload
    out = tmp_path / "out.paf"
    r = _run_cli(fa, bl, out, "--rna", "-p", "-1")
    assert r.returncode == 0, r.stderr
    assert out.read_text() == port_run[0]
    core = port_run[1]
    assert f"total entries: {N_READS}\tprefix fail: {core.prefix_fail}" in r.stderr
    assert "RNA R9 nucleotide model loaded" in r.stderr


def test_port_rna_cli_header_autodetect(workload, tmp_path):
    """Without --rna the CLI keeps the reference's rule (-p -1 is refused
    as DNA's), and at its default -p 50 the header's experiment_type rna
    makes it an RNA run: the bytes of the JAX package's native engine."""
    from sigfish_tpu.runtime.pipeline import Core, Options, run_dtw

    fa, bl, _ = workload
    out = tmp_path / "out.paf"
    r = _run_cli(fa, bl, out, "-p", "-1")
    assert r.returncode == 2 and "DNA does not support auto query start" in r.stderr
    r = _run_cli(fa, bl, out)
    assert r.returncode == 0, r.stderr
    assert "RNA R9 nucleotide model loaded" in r.stderr
    core = Core(fa, bl, Options(batch_size=BATCH, num_thread=2, engine="native", query_size=500))
    want = io.StringIO()
    run_dtw(core, want)
    core.close()
    assert core.opt.rna
    assert out.read_text() == want.getvalue() != ""


def test_port_rna_state_from_jax_core(workload, port_run):
    """A Core fed the JAX package's arrays and its contigs' track
    offsets through core_state_from_numpy maps the same bytes."""
    from sigfish_tpu.runtime.pipeline import Core as JCore, Options as JOptions
    from sigfish_tpu_torch.convert import core_state_from_numpy

    fa, bl, _ = workload
    j = JCore(fa, bl, JOptions(num_thread=1, engine="native", **RNA))
    state = core_state_from_numpy(
        j.model.level_mean, j.model.level_stdv, j.kmer_size, j.ref_cat, j.reset,
        j.track_offsets, j.track_sizes, j.track_meta, j.ref.ref_st_offset,
    )
    j.close()
    paf, core = _run_port(fa, bl, state=state, **RNA)
    assert paf == port_run[0]
    assert core.ref.ref_st_offset == port_run[1].ref.ref_st_offset
    assert core.ref.ref_lengths == port_run[1].ref.ref_lengths


@pytest.mark.parametrize("rna", [True, False])
def test_port_rna_state_without_offsets_raises(workload, port_run, rna):
    """An RNA Core fed a state without its contigs' offsets raises (every
    position would be short by its contig's offset), whether --rna or the
    header's experiment_type rna made the run RNA."""
    from sigfish_tpu_torch.runtime.pipeline import Core, Options

    fa, bl, _ = workload
    state = dataclasses.replace(port_run[1].state, ref_st_offset=None)
    with pytest.raises(ValueError, match="ref_st_offset"):
        Core(fa, bl, Options(device="cpu", query_size=500, prefix_size=-1, rna=rna), state=state)


def test_port_rna_forced_chunks_match_oneshot(workload, port_run):
    """The chunked route at Q=512 (the carry chain with its clip fold),
    forced through small segments: the one-shot route's bytes."""
    fa, bl, _ = workload
    paf, core = _run_port(fa, bl, ref_chunk=3_000, **RNA)
    assert core.routes["chunked"] > 0 and core.routes["oneshot"] == 0
    assert core.routes["clip_fold"] > 0
    assert paf == port_run[0]


def test_detect_polya_end_matches_jax(workload):
    """The port's polyA autodetect equals the JAX package's, read by
    read, failures (-1) included."""
    from sigfish_tpu.ops import jnn as j_jnn
    from sigfish_tpu_torch.io.blow5 import Slow5File
    from sigfish_tpu_torch.ops import jnn as t_jnn

    _, bl, _ = workload
    got = []
    with Slow5File(bl) as f:
        for rec in f:
            pa = rec.to_pa()
            py = t_jnn.detect_polya_end(rec.raw_signal, pa, pore=t_jnn.PORE_R9)
            assert py == j_jnn.detect_polya_end(rec.raw_signal, pa, pore=j_jnn.PORE_R9)
            got.append(py)
    assert len(got) == N_READS and -1 in got and sum(p > 0 for p in got) >= N_READS - 4


def test_prefix_path_equals_exact_path(workload):
    """The prefix-bounded host path (polyA first, then the first event
    at or after it inside a safe prefix) gives the exact full-signal
    path's query window, query and counters, read by read."""
    from sigfish_tpu_torch.runtime import pipeline as tp

    fa, bl, _ = workload
    core = tp.Core(fa, bl, tp.Options(num_thread=1, device="cpu", **RNA))
    blobs = core.sf.read_batch(N_READS, 1 << 40)
    fast = 0
    for blob in blobs:
        a = tp._prepare_read(core, blob)
        b = tp._normalise_single(core, tp._event_single(core, tp._parse_single(core, blob)))
        assert not a.skip and not b.skip
        assert (a.qstart, a.qend, a.skip, a.flag_prefix_fail, a.flag_too_short) == (
            b.qstart, b.qend, b.skip, b.flag_prefix_fail, b.flag_too_short)
        assert np.array_equal(a.query, b.query)
        np.testing.assert_array_equal(a.query[::-1], b.event_mean[b.qstart : b.qend])
        fast += a.n_events < b.n_events
    assert fast >= 4  # the prefix path served some reads
    core.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_q512_bitwise_vs_pallas_interpret(seed):
    """wavefront_plain at Q=512, lane 499, with start lanes of clipped
    reads up to 475 (qlen 25), equals sdtw_pallas.sdtw_wavefront in
    interpret mode bit for bit."""
    import jax.numpy as jnp

    from sigfish_tpu.ops.sdtw_pallas import sdtw_wavefront as jax_wavefront
    from sigfish_tpu_torch.ops import layout
    from sigfish_tpu_torch.ops import sdtw_wavefront as wf

    W, Q, td = 500, 512, 128
    rng = np.random.default_rng(seed)
    tracks = [rng.standard_normal(int(s)).astype(np.float32) for s in rng.integers(300, 750, 3)]
    ref, reset, _ = layout.pad_tracks(tracks, ckpt=td, align=W)
    qlens = [W, 25, W, 320, W - 1, W, int(rng.integers(26, W))]
    qb, qlens, _ = layout.make_query_batch(
        [rng.standard_normal(n).astype(np.float32) for n in qlens], pad_q=Q)
    qb, fs = layout.shift_queries_for_clip(qb, qlens, W - 1)
    ypad, rspad, _ = layout.prepare_wavefront_inputs(ref, reset, Q, td=td)
    assert fs.max() == W - 25
    want = jax_wavefront(
        jnp.asarray(qb), jnp.asarray(ypad), jnp.asarray(rspad), lane=W - 1, td=td,
        start_lanes=jnp.asarray(fs), interpret=True,
    )
    got = wf.sdtw_wavefront(torch.from_numpy(qb), torch.from_numpy(ypad), torch.from_numpy(rspad),
                            W - 1, start_lanes=torch.from_numpy(fs))
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
