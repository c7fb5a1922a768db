"""The port's --full-ref on the CPU (the kernel's plain PyTorch version)
against sigfish_tpu: whole transcripts as tracks, with --rna -q 100 -p -1
and its clipped reads, byte-identical to the JAX package's native engine
and its Pallas wavefront engine (interpret mode), through the library
and the CLI; a state carried from a JAX Core built with --full-ref maps
the same bytes. The other RNA flags are in tests/test_torch_std.py.

Workload: tests/test_torch_std.py's: 6 transcripts of 300-600 bases, 30
reads in two batches, one in ten clipped, one in twenty prefix fail.
"""

from __future__ import annotations

import pytest
from port_runs import BATCH, load_smoke, run_jax, run_port

N_TX = 6
N_READS = 30
SEED = 9
W = 100
FULL = dict(rna=True, query_size=W, prefix_size=-1, full_ref=True)


@pytest.fixture(scope="module")
def smoke():
    return load_smoke()


@pytest.fixture(scope="module")
def workload(smoke, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_full_ref")
    return smoke.make_rna_workload(str(d), N_TX, N_READS, SEED, tx_len=(300, 600),
                                   walks=(150, 70))


@pytest.fixture(scope="module")
def port_run(workload):
    fa, bl, _ = workload
    return run_port(fa, bl, **FULL)


@pytest.mark.parametrize("engine", ["native", "pallas"])
def test_full_ref_matches_jax(workload, port_run, engine):
    """Bytes and counters equal the JAX package's."""
    fa, bl, _ = workload
    got, core = port_run
    want, jcore = run_jax(fa, bl, engine, **FULL)
    assert len(got.splitlines()) == N_READS - core.ignored >= N_READS - 2
    assert got == want
    for c in ("total_reads", "prefix_fail", "ignored", "too_short"):
        assert getattr(core, c) == getattr(jcore, c), c


def test_full_ref_tracks_are_whole_transcripts(smoke, workload, port_run):
    """Each track is its transcript from the first base (no offset), the
    clipped reads took the clip pass, and the reads map over their
    origin."""
    _, _, truth = workload
    paf, core = port_run
    assert core.ref.ref_st_offset == [0] * N_TX
    assert [n + 4 for n in core.ref.ref_lengths] == core.ref.ref_seq_lengths
    assert core.too_short >= 2 and core.routes["clip_pass"] >= 1
    assert smoke.overlap_share(paf, truth) >= 0.9


def test_full_ref_cli_matches_library(workload, port_run, tmp_path):
    from sigfish_tpu_torch import cli

    fa, bl, _ = workload
    out = tmp_path / "out.paf"
    argv = ["dtw", fa, bl, "--rna", "--full-ref", "-q", str(W), "-p", "-1", "-K", str(BATCH),
            "-t", "2", "--device", "cpu", "-o", str(out)]
    assert cli.main(argv) == 0
    assert out.read_text() == port_run[0]


def test_state_from_jax_full_ref_core(workload, port_run):
    """A Core fed a JAX Core's --full-ref arrays and offsets through
    core_state_from_numpy maps the same bytes."""
    from sigfish_tpu.runtime.pipeline import Core as JCore, Options as JOptions
    from sigfish_tpu_torch.convert import core_state_from_numpy

    fa, bl, _ = workload
    j = JCore(fa, bl, JOptions(engine="native", **FULL))
    state = core_state_from_numpy(
        j.model.level_mean, j.model.level_stdv, j.kmer_size, j.ref_cat, j.reset,
        j.track_offsets, j.track_sizes, j.track_meta, j.ref.ref_st_offset,
    )
    j.close()
    assert run_port(fa, bl, state=state, **FULL)[0] == port_run[0]
