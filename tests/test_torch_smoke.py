"""chip_smoke.py's workloads, checked on the CPU: what the card run
relies on without being able to see it."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest

from sigfish_tpu_torch.ops.layout import prepare_wavefront_inputs
from sigfish_tpu_torch.runtime import pipeline as pl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke_core(smoke, tmp_path_factory):
    """A CPU Core over the first 30 reads of the phase-4 workload (the
    reference does not depend on the read count: it is drawn first)."""
    d = tmp_path_factory.mktemp("smoke")
    fa, bl, _ = smoke.make_workload(str(d), smoke.N_BASES, 30, smoke.SEED)
    core = pl.Core(fa, bl, pl.Options(query_size=smoke.W, prefix_size=smoke.PREFIX,
                                      num_thread=1, device="cpu"))
    yield core
    core.close()


def test_smoke_workload_clips_one_read_in_ten(smoke, smoke_core):
    """The short reads (i % 10 == 9) really are clipped, qlen < W, so
    the card run's clipped-read checks see clipped reads; the others
    are full-length."""
    blobs = smoke_core.sf.read_batch(64, 1 << 40)
    qlens = [pl._prepare_read(smoke_core, b).query.size for b in blobs]
    assert len(qlens) == 30
    for i, n in enumerate(qlens):
        if i % 10 == 9:
            assert 100 <= n < smoke.W, (i, n)
        else:
            assert n == smoke.W, (i, n)


def test_bench_reference_is_chip_smokes(smoke_core):
    """The ALU probe's bench times the wavefront over chip_smoke.py's
    phase-4 reference: the same buffers as the pipeline builds from its
    FASTA."""
    from sigfish_tpu_torch.scripts import bench_alu_peak

    want = prepare_wavefront_inputs(smoke_core.ref_cat, smoke_core.reset, smoke_core.pad_q)
    ypad, rspad, D = bench_alu_peak.smoke_reference()
    assert D == want[2] == 60_672
    np.testing.assert_array_equal(ypad, want[0])
    np.testing.assert_array_equal(rspad, want[1])


@pytest.mark.parametrize("chem", ["r10", "rna004"])
def test_phase8_chemistries_are_detected(smoke, tmp_path, chem):
    """Phase 8's R10 and RNA004 workloads: the header's kit selects the
    chemistry and its 9-mer model, the R10 reads are clipped one in ten,
    and RNA004's polyA scan finds the polyA of every read drawn with an
    adaptor and a polyA (its wider adaptor threshold may also take a
    stretch of a read drawn without them, i % 20 == 4, for one)."""
    from sigfish_tpu_torch.ops import jnn

    if chem == "r10":
        fa, bl, _ = smoke.make_workload(str(tmp_path), smoke.N_BASES, 20, smoke.SEED + 8, r10=True)
        kw, flag = dict(query_size=smoke.W, prefix_size=smoke.PREFIX), jnn.PORE_R10
    else:
        fa, bl, _ = smoke.make_rna_workload(str(tmp_path), 4, 24, smoke.SEED + 7, rna004=True)
        kw, flag = dict(smoke.RNA_OPT), jnn.PORE_RNA004
    core = pl.Core(fa, bl, pl.Options(num_thread=1, device="cpu", **kw))
    assert core.pore_flag == flag and core.state.model.kmer_size == 9
    works = [pl._prepare_read(core, b) for b in core.sf.read_batch(64, 1 << 40)]
    core.close()
    if chem == "r10":
        assert [w.flag_too_short for w in works] == [i % 10 == 9 for i in range(20)]
    else:
        assert not any(w.flag_prefix_fail for i, w in enumerate(works) if i % 20 != 4)
        assert sum(w.flag_too_short for w in works) >= 2


def test_ptxas_table_reads_each_entry(smoke):
    """Phase 9's ptxas report: each kernel entry of an nvcc -Xptxas -v
    log by its kernel's name, with its registers, static shared memory
    and spill bytes (0 where the log gives none)."""
    report = "\n".join([
        "ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__fb09b1dd_9_events_cu_45365bfd"
        "13prefix_kernelEPKsPKiPKfS5_iiPdS6_S6_S6_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 58 registers, used 1 barriers, 32768 bytes smem, 424 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__53e5aa53_8_polya_cu_sf_polya"
        "12polya_kernelEPKsPKiPKfS5_iifiiiiiiifPi' for 'sm_90a'",
        "    8 bytes stack frame, 12 bytes spill stores, 28 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 436 bytes cmem[0]",
    ])
    assert smoke.ptxas_table(report) == [
        dict(entry="prefix_kernel", registers=58, smem=32768, spill_stores=0, spill_loads=0),
        dict(entry="polya_kernel", registers=40, smem=0, spill_stores=12, spill_loads=28),
    ]


def test_phase10_mesh_workloads(smoke, tmp_path):
    """Phase 10's choices: its ring run's one contig gives 2 tracks, fewer
    than MESH_RING's TP, so the Core takes ring mode, and the first
    N10_READS reads hold clipped ones (i % 10 == 9); over phase 6's E.
    coli layout the auto rule gives ring_n_sub > 1; the tracks runs have
    at least TP tracks (phase 7: 160)."""
    import math

    from sigfish_tpu_torch.ops.chunked_ref import DIAG_TILE
    from sigfish_tpu_torch.parallel import ring_shape

    fa, bl, _ = smoke.make_workload(str(tmp_path), 2_000, 20, smoke.SEED + 6)
    core = pl.Core(fa, bl, pl.Options(query_size=smoke.W, prefix_size=smoke.PREFIX, num_thread=1,
                                      device="cpu", mesh=smoke.MESH_RING))
    n_dp, n_tp = (int(x) for x in smoke.MESH_RING.split("x"))
    assert len(core.track_sizes) == 2 < n_tp and core.mesh_mode == "ring"
    assert [len(row) for row in core.mesh] == [n_dp * n_tp]
    works = [pl._prepare_read(core, b) for b in core.sf.read_batch(64, 1 << 40)]
    core.close()
    assert [w.flag_too_short for w in works] == [i % 10 == 9 for i in range(20)]
    assert smoke.N10_READS >= 10 and smoke.N10_READS == smoke.BATCH
    # E. coli: both strands of 4,641,647 events, each aligned to W, then
    # to the 512-column ckpt
    n_ev = -(-(smoke.ECOLI_BASES - 5) // smoke.W) * smoke.W
    R = -(-2 * n_ev // 512) * 512
    assert R == 9_283_584
    Rs, n_sub = ring_shape(R + 256, n_dp * n_tp, math.lcm(512, smoke.W, DIAG_TILE))
    assert n_sub > 1 and Rs % n_sub == 0
    for mesh in (smoke.MESH_DNA, smoke.MESH_RNA):
        assert int(mesh.split("x")[1]) <= 2 <= smoke.N7_TX


def test_phase11_hosts_workloads(smoke, tmp_path):
    """Phase 11's runs are phase 4's and phase 7's: dtw_argv gives the
    CLI the options run_port passes (-K, -t, -p 50 -q 250; --rna -q 500
    -p -1), so the cluster's output can be held to those phases' PAFs;
    and stripe() picks the lines of the records whose index is I mod N,
    in file order, as `--shard I/N` maps them (a 16-read phase-4
    workload on the CPU)."""
    from port_runs import run_port

    from sigfish_tpu_torch import cli

    p = cli.make_dtw_parser()
    a = p.parse_args(smoke.dtw_argv("r.fa", "r.blow5"))
    assert (a.genome, a.reads, a.batchsize, a.threads, a.prefix, a.query_size, a.rna) == (
        "r.fa", "r.blow5", smoke.BATCH, smoke.THREADS, smoke.PREFIX, smoke.W, False)
    a = p.parse_args(smoke.dtw_argv("t.fa", "t.blow5", rna=True))
    assert (a.batchsize, a.threads, a.rna, a.query_size, a.prefix) == (
        smoke.BATCH, smoke.THREADS, True, smoke.RNA_OPT["query_size"],
        smoke.RNA_OPT["prefix_size"])
    assert a.device == "cuda" and a.hosts is None and smoke.HOSTS == 2
    fa, bl, _ = smoke.make_workload(str(tmp_path), 600, 16, smoke.SEED + 11)
    full, _ = run_port(fa, bl, prefix_size=smoke.PREFIX, query_size=smoke.W)
    stripes = []
    for i in range(smoke.HOSTS):
        out = tmp_path / f"s{i}.paf"
        assert cli.main(["dtw", fa, bl, "--device", "cpu", "-K", "4", "--shard",
                         f"{i}/{smoke.HOSTS}", "-o", str(out)]) == 0
        stripes.append(out.read_text())
        assert stripes[-1] == smoke.stripe(full, i, smoke.HOSTS) != ""
    assert sorted("".join(stripes).splitlines()) == sorted(full.splitlines())


def test_phase12_training_workloads(smoke, tmp_path):
    """Phase 12 trains on phase 4's first 256 and phase 7's first 512
    reads at 4 (fit_model), 3 (fit_model_banded) and 2 (finetune)
    iterations, and checks the card against the CPU over 16 reads at 2.
    Its truth PAFs come from write_truth_paf, whose lines are the ones
    phase 8 wrote for eval, and the trainer's loaders read them back as
    the reads' true windows: a DNA read's 6-mers with 10 bases of pad on
    each side, an RNA read's walk of 5-mers (clipped reads included)."""
    from sigfish_tpu_torch.io.fasta import read_fasta
    from sigfish_tpu_torch.models import train_model as tm

    assert (smoke.N12_DNA_READS, smoke.N12_RNA_READS) == (256, 512)
    assert (smoke.ITERS12_DNA, smoke.ITERS12_RNA, smoke.ITERS12_FINETUNE) == (4, 3, 2)
    assert (smoke.N12_CPU_READS, smoke.ITERS12_CPU) == (16, 2)
    assert smoke.N12_DNA_READS <= smoke.N_READS and smoke.N12_RNA_READS <= smoke.N7_READS
    fa, bl, truth = smoke.make_workload(str(tmp_path), smoke.N_BASES, 12, smoke.SEED)
    ids = [f"read{i:05d}" for i in range(10)]
    paf = tmp_path / "dna.paf"
    smoke.write_truth_paf(str(paf), truth, {smoke.contig_of(truth): smoke.N_BASES}, ids)
    lines = paf.read_text().splitlines()
    contig, strand, lo, hi = truth["read00003"]
    assert lines[3] == (f"read00003\t0\t0\t0\t{strand}\t{contig}\t{smoke.N_BASES}\t{lo}\t{hi}"
                        "\t0\t0\t60\ttp:A:P")
    cases = tm.load_cases(bl, fa, str(paf), rna=False, k=6)
    assert [c.read_id for c in cases] == ids
    for c in cases:
        lo, hi = truth[c.read_id][2:]
        assert c.kmers.size == min(hi + 10, smoke.N_BASES) - max(lo - 10, 0) - 5

    d7 = tmp_path / "rna"
    d7.mkdir()
    fa, bl, truth = smoke.make_rna_workload(str(d7), 4, 12, smoke.SEED + 7, tx_len=(600, 900))
    lengths = {n: len(s) for n, s in read_fasta(fa)}
    paf = d7 / "rna.paf"
    smoke.write_truth_paf(str(paf), truth, lengths, ids)
    cases = tm.load_cases_trimmed_rna(bl, fa, str(paf), k=5)
    assert [c.read_id for c in cases] == ids
    for i, c in enumerate(cases):
        name, _, ts, te = truth[c.read_id]
        assert c.tid == name and te == lengths[name]
        assert c.kmers.size == te - ts - 4 == min(te - 4, 240 if i % 10 == 9 else 560)
