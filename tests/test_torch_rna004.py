"""The port's RNA004 direct-RNA runs on the CPU (the kernel's plain
PyTorch version) against sigfish_tpu: the chemistry from the BLOW5
header's sequencing_kit (*rna004*) or from --pore rna004, with its 9-mer
model and its polyA scan parameters, PAF byte-identical to the JAX
package's native engine and its Pallas wavefront engine (interpret
mode); the polyA autodetect with RNA004's parameters read by read.

Workload: chip_smoke.py's direct-RNA generator at a small size from the
RNA004 9-mer table: 6 transcripts of 450-800 bases and 30 reads at -q 250
-p -1 in two batches; reads walk 400 levels of a transcript's 3' end,
one in ten only 150 (clipped), one in twenty without adaptor and polyA
(prefix fail).
"""

from __future__ import annotations

import pytest
from port_runs import BATCH, load_smoke, run_jax, run_port

N_READS = 30
RNA004 = dict(rna=True, query_size=250, prefix_size=-1)
KITLESS_RNA = [{"experiment_type": "rna"}]


@pytest.fixture(scope="module")
def smoke():
    return load_smoke()


@pytest.fixture(scope="module")
def rna004(smoke, tmp_path_factory):
    """(fasta, blow5 with the RNA004 kit, blow5 of the same reads with
    experiment_type rna alone, truth)."""
    kw = dict(tx_len=(450, 800), walks=(400, 150), rna004=True)
    d = tmp_path_factory.mktemp("torch_rna004")
    fa, bl, truth = smoke.make_rna_workload(str(d), 6, N_READS, 11, **kw)
    d2 = tmp_path_factory.mktemp("torch_rna004_kitless")
    _, bl2, _ = smoke.make_rna_workload(str(d2), 6, N_READS, 11, header=KITLESS_RNA, **kw)
    return fa, bl, bl2, truth


@pytest.fixture(scope="module")
def rna004_run(rna004):
    return run_port(rna004[0], rna004[1], **RNA004)


@pytest.mark.parametrize("engine", ["native", "pallas"])
def test_rna004_header_autodetect_matches_jax(smoke, rna004, rna004_run, engine):
    """The kit sqk-rna004 makes the run RNA004 (its 9-mer model and its
    polyA scan) in both packages: the same bytes and counters."""
    from sigfish_tpu_torch.ops import jnn

    fa, bl, _, truth = rna004
    got, core = rna004_run
    want, jcore = run_jax(fa, bl, engine, **RNA004)
    assert core.pore_flag == jnn.PORE_RNA004 and core.state.model.kmer_size == 9
    assert core.too_short >= 2 and core.prefix_fail >= 1
    assert got == want
    for c in ("total_reads", "prefix_fail", "ignored", "too_short"):
        assert getattr(core, c) == getattr(jcore, c), c
    assert smoke.overlap_share(got, truth) >= 0.8


def test_rna004_by_pore_flag(rna004, rna004_run, tmp_path):
    """--pore rna004 over a header without a kit: the autodetected run's
    bytes, through the library, and through the CLI without --rna
    (rna004 implies it, and so allows -p -1)."""
    from sigfish_tpu_torch import cli

    fa, _, bl2, _ = rna004
    assert run_port(fa, bl2, pore="rna004", **RNA004)[0] == rna004_run[0]
    out = tmp_path / "out.paf"
    argv = ["dtw", fa, bl2, "--pore", "rna004", "-q", "250", "-p", "-1", "-K", str(BATCH),
            "-t", "2", "--device", "cpu", "-o", str(out)]
    assert cli.main(argv) == 0
    assert out.read_text() == rna004_run[0]


def test_rna004_polya_matches_jax(rna004):
    """The polyA autodetect with RNA004's parameters equals the JAX
    package's, read by read, failures (-1) included."""
    from sigfish_tpu.ops import jnn as j_jnn
    from sigfish_tpu_torch.io.blow5 import Slow5File
    from sigfish_tpu_torch.ops import jnn as t_jnn

    got = []
    with Slow5File(rna004[1]) as f:
        for rec in f:
            pa = rec.to_pa()
            py = t_jnn.detect_polya_end(rec.raw_signal, pa, pore=t_jnn.PORE_RNA004)
            assert py == j_jnn.detect_polya_end(rec.raw_signal, pa, pore=j_jnn.PORE_RNA004)
            got.append(py)
    assert len(got) == N_READS and -1 in got and sum(p > 0 for p in got) >= N_READS - 4
