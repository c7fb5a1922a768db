"""Direct-RNA --mesh runs of the port on the CPU against sigfish_tpu's
Core(engine="pallas", mesh=...) (interpret mode, tests/conftest.py's 8
CPU devices) and against the port's single-device run, byte for byte:
`--rna -p -1` in tracks mode, --dtw-std over the mesh's layout (its
corners on the grid's first device) and --host-stages device (the
eventizer's and polyA scan's plain versions on the first device).

Workload: chip_smoke.py's direct-RNA generator at a small size, 8
transcripts (8 tracks, so 2x2 is tracks mode), 24 reads whose walks of
120 levels (30 for one read in ten, which -q 64 then clips) follow a
short adaptor and the polyA, so the plain eventizer's sample loops stay
short; one read in twenty has neither and falls back to event 50.
"""

from __future__ import annotations

import pytest

from port_runs import load_smoke, run_jax, run_port

RNA = dict(rna=True, query_size=64, prefix_size=-1, batch_size=32)
N_TX = 8
N_READS = 24


@pytest.fixture(scope="module")
def rna(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh_rna")
    fa, bl, _ = load_smoke().make_rna_workload(
        str(d), N_TX, N_READS, 23, tx_len=(600, 1_400), walks=(120, 30), adaptor=(3_000, 4_000))
    return fa, bl


@pytest.mark.parametrize("kw", [{}, dict(dtw_std=True), dict(host_stages="device")])
def test_rna_mesh_matches_jax_and_single(rna, kw):
    got, core = run_port(*rna, mesh="2x2", **RNA, **kw)
    assert core.mesh_mode == "tracks"
    if kw.get("dtw_std"):
        assert core.routes["oneshot"] >= 1 and core.routes["mesh_tracks"] == 0
    else:
        assert core.routes["mesh_tracks"] == 1
    if not kw:
        assert core.too_short >= 1 and core.prefix_fail >= 1
    single, _ = run_port(*rna, **RNA, **kw)
    want, jcore = run_jax(*rna, "pallas", mesh="2x2", **RNA, **kw)
    assert jcore.mesh_mode == "tracks"
    assert len(got.splitlines()) >= N_READS - 3
    assert got == want == single
