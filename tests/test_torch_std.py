"""The port's direct-RNA flags on the CPU (the kernel's plain PyTorch
version) against sigfish_tpu: --dtw-std (the kernel's std instance, the
corners gathered on the device), --invert -p 0 (the reference's 3'-end
events reversed, the query not) and --from-end -p 0 (5'-end tracks, the
query window counted from the read's last event), byte-identical to the
JAX package's native engine and its Pallas wavefront engine (interpret
mode), clipped and prefix-fail reads included, through the library and
the CLI; the chunked route's std corners (CornerFold over a forced
ref_chunk) equal the one-shot corners bit for bit and never run a host
DP. --full-ref is in tests/test_torch_full_ref.py: the JAX kernel's
interpret mode compiles once per shape (~15-30 s), so each file keeps
two shapes.

Workload: chip_smoke.py's direct-RNA generator at a small size, 6
transcripts of 300-600 bases and 30 reads in two batches at -q 100:
reads walk 150 levels of a transcript's 3' end (about 200 events past
the polyA), one in ten only 70 (fewer than 100 events: clipped with
-p -1), one in twenty without adaptor and polyA (prefix fail).
"""

from __future__ import annotations

import numpy as np
import pytest
from port_runs import BATCH, load_smoke, run_jax, run_port

N_TX = 6
N_READS = 30
SEED = 9
W = 100

FLAGS = {
    "dtw_std": dict(dtw_std=True, prefix_size=-1),
    "invert": dict(invert=True, prefix_size=0),
    "from_end": dict(from_end=True, prefix_size=0),
}
CLI = {"dtw_std": ["--dtw-std", "-p", "-1"], "invert": ["--invert", "-p", "0"],
       "from_end": ["--from-end", "-p", "0"]}
STD = FLAGS["dtw_std"]
RNA = dict(rna=True, query_size=W)


@pytest.fixture(scope="module")
def smoke():
    return load_smoke()


@pytest.fixture(scope="module")
def workload(smoke, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_std")
    return smoke.make_rna_workload(str(d), N_TX, N_READS, SEED, tx_len=(300, 600),
                                   walks=(150, 70))


@pytest.fixture(scope="module")
def port_runs(workload):
    fa, bl, _ = workload
    return {name: run_port(fa, bl, **RNA, **kw) for name, kw in FLAGS.items()}


@pytest.mark.parametrize("engine", ["native", "pallas"])
@pytest.mark.parametrize("name", sorted(FLAGS))
def test_rna_flags_match_jax(workload, port_runs, name, engine):
    """Bytes and counters of each flag equal the JAX package's."""
    fa, bl, _ = workload
    got, core = port_runs[name]
    want, jcore = run_jax(fa, bl, engine, **RNA, **FLAGS[name])
    assert len(got.splitlines()) == N_READS - core.ignored >= N_READS - 2
    assert got == want
    for c in ("total_reads", "prefix_fail", "ignored", "too_short"):
        assert getattr(core, c) == getattr(jcore, c), c


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_rna_flags_cli_matches_library(workload, port_runs, tmp_path, name):
    """`python -m sigfish_tpu_torch.cli dtw ... --rna -q 100 <flag>
    --device cpu` writes the library run's bytes."""
    from sigfish_tpu_torch import cli

    fa, bl, _ = workload
    out = tmp_path / "out.paf"
    argv = ["dtw", fa, bl, "--rna", "-q", str(W), *CLI[name], "-K", str(BATCH), "-t", "2",
            "--device", "cpu", "-o", str(out)]
    assert cli.main(argv) == 0
    assert out.read_text() == port_runs[name][0]


def test_invert_and_from_end_shape_the_reference(workload, port_runs):
    """--invert's tracks are the default 3'-end tracks reversed (each
    z-scored in its own order); --from-end's start at each transcript's
    5' end, with no offset."""
    fa, bl, _ = workload
    plain = run_port(fa, bl, **RNA, prefix_size=0)[1]
    inv, fe = port_runs["invert"][1], port_runs["from_end"][1]
    assert inv.track_sizes == plain.track_sizes == fe.track_sizes
    assert max(plain.ref.ref_st_offset) > 0 and fe.ref.ref_st_offset == [0] * N_TX
    for t, (lo, n) in enumerate(zip(plain.track_offsets, plain.track_sizes)):
        np.testing.assert_allclose(inv.ref_cat[lo : lo + n], plain.ref_cat[lo : lo + n][::-1],
                                   rtol=0, atol=1e-5)
        if plain.ref.ref_st_offset[t]:  # truncated: the 5' end differs from the 3' end
            assert not np.allclose(fe.ref_cat[lo : lo + n], plain.ref_cat[lo : lo + n])


def test_std_exercises_its_path(smoke, workload, port_runs):
    """One-shot std launches with clipped and prefix-fail reads and no
    clip pass; each read ends at a track's last column (the corner), and
    most map over their origin."""
    _, _, truth = workload
    paf, core = port_runs["dtw_std"]
    assert core.too_short >= 2 and core.prefix_fail >= 1
    assert core.routes == {"oneshot": 2, "clip_pass": 0, "chunked": 0, "clip_fold": 0,
                           "mesh_tracks": 0, "ring": 0}
    lengths = dict(zip(core.ref.ref_names, core.ref.ref_lengths))
    offsets = dict(zip(core.ref.ref_names, core.ref.ref_st_offset))
    for ln in paf.splitlines():
        f = ln.split("\t")
        assert int(f[8]) == offsets[f[5]] + lengths[f[5]] - 1
    assert smoke.overlap_share(paf, truth) >= 0.7


def test_std_corner_fold_equals_oneshot_corners(workload, port_runs, monkeypatch):
    """--dtw-std through a forced ref_chunk: the carry chain (std, with
    the clipped reads' start lanes) and CornerFold give the one-shot
    route's corners bit for bit, batch by batch, and the run the one-shot
    route's bytes -- with the host's std DP made to raise, so no corner
    is computed on the host."""
    from sigfish_tpu_torch import native
    from sigfish_tpu_torch.runtime import pipeline as tp

    fa, bl, _ = workload

    def refuse(*a, **k):
        raise AssertionError("a std corner was computed on the host")

    monkeypatch.setattr(native, "std_lastrow", refuse)
    paf, core = run_port(fa, bl, ref_chunk=300, **RNA, **STD)
    assert core.routes["chunked"] == 2 and core.routes["oneshot"] == 0
    assert paf == port_runs["dtw_std"][0]

    core = tp.Core(fa, bl, tp.Options(device="cpu", ref_chunk=300, **RNA, **STD))
    Ds = core._chunk_inputs(core.pad_q)[0].shape[2]
    assert np.unique(core.std_corner_diags // Ds).size >= 2  # corners in several segments
    blobs = core.sf.read_batch(N_READS, 1 << 40)
    works = [tp._prepare_read(core, b) for b in blobs]
    qlist = [w.query for w in works if not w.skip]
    qb, qlens, _ = tp.make_query_batch(qlist, pad_q=core.pad_q)
    assert (qlens < W).sum() >= 2
    chunked = core.sdtw_std_corners_collect(core.sdtw_std_corners_submit(qb, qlens))
    one = core.sdtw_std_corners_collect(
        core.sdtw_std_corners_submit(qb, qlens, force_oneshot=True))
    assert chunked.shape == (len(qlist), N_TX)
    np.testing.assert_array_equal(chunked.view(np.int32), one.view(np.int32))
    assert core.routes == {"oneshot": 1, "clip_pass": 0, "chunked": 1, "clip_fold": 0,
                           "mesh_tracks": 0, "ring": 0}
    core.close()


def test_std_device_chunk_split(workload, port_runs, monkeypatch):
    """--dtw-std batches wider than DEVICE_CHUNK go to the device in
    sub-launches, on both routes, with the same bytes."""
    from sigfish_tpu_torch.runtime.pipeline import Core

    monkeypatch.setattr(Core, "DEVICE_CHUNK", 8)
    fa, bl, _ = workload
    for ref_chunk, route in ((0, "oneshot"), (300, "chunked")):
        paf, core = run_port(fa, bl, ref_chunk=ref_chunk, **RNA, **STD)
        assert core.routes[route] > 2
        assert paf == port_runs["dtw_std"][0]
