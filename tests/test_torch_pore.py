"""The port's R10 DNA runs on the CPU (the kernel's plain PyTorch
version) against sigfish_tpu: the chemistry from the BLOW5 header's
sequencing_kit (*114* is R10) or from --pore r10, PAF byte-identical to
the JAX package's native engine and its Pallas wavefront engine
(interpret mode); the copied 9-mer tables equal the JAX package's; a
header naming R10 RNA raises the reference's error; a 9-mer state
carried from a JAX Core maps the same bytes. RNA004 is in
tests/test_torch_rna004.py (the JAX kernel's interpret mode compiles
once per shape, ~20-35 s, so each file keeps one).

Workload: chip_smoke.py's DNA generator at a small size from the R10
9-mer table: a 2,000-base contig (both strands) and 30 reads at -p 50
-q 250 in two batches, one in ten clipped.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
from port_runs import BATCH, REPO, load_smoke, run_jax, run_port

N_READS = 30


@pytest.fixture(scope="module")
def smoke():
    return load_smoke()


@pytest.fixture(scope="module")
def r10(smoke, tmp_path_factory):
    """(fasta, blow5 with the R10 kit, blow5 of the same reads without a
    kit, truth)."""
    d = tmp_path_factory.mktemp("torch_r10")
    fa, bl, truth = smoke.make_workload(str(d), 2_000, N_READS, 10, r10=True)
    d2 = tmp_path_factory.mktemp("torch_r10_kitless")
    _, bl2, _ = smoke.make_workload(str(d2), 2_000, N_READS, 10, r10=True,
                                    header=smoke.DNA_HEADER)
    return fa, bl, bl2, truth


@pytest.fixture(scope="module")
def r10_run(r10):
    return run_port(r10[0], r10[1])


def test_copied_9mer_tables_equal_the_originals():
    for name in ("r10.4_dna_9mer.npz", "rna004_rna_9mer.npz"):
        paths = [os.path.join(REPO, pkg, "models", "data", name)
                 for pkg in ("sigfish_tpu", "sigfish_tpu_torch")]
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read(), name
    from sigfish_tpu.models import pore_model as jpm
    from sigfish_tpu_torch.models import pore_model as tpm

    for mid in (tpm.MODEL_ID_DNA_R10, tpm.MODEL_ID_RNA_RNA004):
        got, want = tpm.load_builtin_model(mid), jpm.load_builtin_model(mid)
        assert got.kmer_size == want.kmer_size == 9
        np.testing.assert_array_equal(got.level_mean, want.level_mean)
        np.testing.assert_array_equal(got.level_stdv, want.level_stdv)


@pytest.mark.parametrize("engine", ["native", "pallas"])
def test_r10_header_autodetect_matches_jax(smoke, r10, r10_run, engine):
    """The kit sqk-lsk114 makes the run R10 (the 9-mer DNA model) in both
    packages: the same bytes and counters, clipped reads included."""
    from sigfish_tpu_torch.ops import jnn

    fa, bl, _, truth = r10
    got, core = r10_run
    want, jcore = run_jax(fa, bl, engine)
    assert core.pore_flag == jnn.PORE_R10 and core.state.model.kmer_size == 9
    assert core.too_short >= 2
    assert got == want
    for c in ("total_reads", "prefix_fail", "ignored", "too_short"):
        assert getattr(core, c) == getattr(jcore, c), c
    assert smoke.overlap_share(got, truth) >= 0.9


def test_r10_by_pore_flag(r10, r10_run, tmp_path):
    """--pore r10 over a header without a kit: the autodetected run's
    bytes, through the library and the CLI."""
    from sigfish_tpu_torch import cli

    fa, _, bl2, _ = r10
    assert run_port(fa, bl2, pore="r10")[0] == r10_run[0]
    out = tmp_path / "out.paf"
    argv = ["dtw", fa, bl2, "--pore", "r10", "-K", str(BATCH), "-t", "2", "--device", "cpu",
            "-o", str(out)]
    assert cli.main(argv) == 0
    assert out.read_text() == r10_run[0]


def test_pore_flag_is_each_cores_own(r10):
    """The chemistry is the Core's, from --pore or its own file's header:
    one Options reused after an R10 file leaves a kitless file R9."""
    from sigfish_tpu_torch.ops import jnn
    from sigfish_tpu_torch.runtime.pipeline import Core, Options

    fa, bl, bl2, _ = r10
    opt = Options(device="cpu", num_thread=1)
    flags = []
    for path in (bl, bl2):
        core = Core(fa, path, opt)
        flags.append((core.pore_flag, core.state.model.kmer_size))
        core.close()
    assert flags == [(jnn.PORE_R10, 9), (jnn.PORE_R9, 6)]
    assert not hasattr(opt, "pore_flag")


def test_r10_rna_header_raises_the_reference_error(smoke, tmp_path):
    """A header naming an R10 kit on RNA data stops both packages with
    the reference's message."""
    from sigfish_tpu.runtime.pipeline import Core as JCore, Options as JOptions
    from sigfish_tpu_torch.runtime.pipeline import Core, Options

    header = [{"experiment_type": "rna", "sequencing_kit": "sqk-lsk114"}]
    fa, bl, _ = smoke.make_rna_workload(str(tmp_path), 2, 2, 12, tx_len=(300, 400),
                                        header=header)
    msgs = []
    for make in (lambda: Core(fa, bl, Options(device="cpu")),
                 lambda: JCore(fa, bl, JOptions(engine="native"))):
        with pytest.raises(SystemExit) as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "R10 RNA data does not exist! But header indicates R10 RNA."


def test_r10_state_from_jax_core(r10, r10_run):
    """A Core fed a JAX Core's 9-mer arrays through core_state_from_numpy
    (k carried with the model) maps the same bytes."""
    from sigfish_tpu.runtime.pipeline import Core as JCore, Options as JOptions
    from sigfish_tpu_torch.convert import core_state_from_numpy

    fa, bl, _, _ = r10
    j = JCore(fa, bl, JOptions(num_thread=1, engine="native"))
    assert j.kmer_size == 9
    state = core_state_from_numpy(
        j.model.level_mean, j.model.level_stdv, j.kmer_size, j.ref_cat, j.reset,
        j.track_offsets, j.track_sizes, j.track_meta,
    )
    j.close()
    paf, core = run_port(fa, bl, state=state)
    assert state.model.kmer_size == 9
    assert paf == r10_run[0]
