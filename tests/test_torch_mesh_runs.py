"""Whole --mesh runs of the port on the CPU (DP*TP "cpu" shards, the
kernels' plain versions) against sigfish_tpu's Core(engine="pallas",
mesh=...) over tests/conftest.py's 8 CPU devices (its Pallas wavefront
in interpret mode) and against the port's single-device run: PAF and
SAM byte-identical, through the library and the CLI.

R9 DNA over one contig (two tracks): tracks mode under 2x2, ring mode
under 1x4 (fewer tracks than TP), with the auto sub-chunk rule and with
a forced ref_chunk, whose clipped reads then take the chunked route
(ClipFold) on the grid's first device. -p 210 -q 64 clips the short
reads (about 240-275 events). The ring runs its batch in 32 microbatches
of 2 rows, each a plain carry sweep of the shard, so the reference is
kept at 600 bases and --ckpt at 64.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from port_runs import REPO, load_smoke, run_jax, run_port

DNA = dict(query_size=64, prefix_size=210, ckpt=64, batch_size=32)
N_BASES = 600
N_READS = 24


@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh_dna")
    fa, bl, _ = load_smoke().make_workload(str(d), N_BASES, N_READS, 41)
    return fa, bl


@pytest.fixture(scope="module")
def single(dna):
    out, core = run_port(*dna, **DNA)
    assert core.too_short >= 2, "the workload must clip reads"
    assert len(out.splitlines()) >= N_READS - 2
    return out


@pytest.mark.parametrize("mesh,kw,mode", [
    ("2x2", {}, "tracks"),
    ("1x4", {}, "ring"),
    ("1x4", dict(ref_chunk=128), "ring"),
    ("2x2", dict(sam=True), "tracks"),
])
def test_dna_mesh_matches_jax_and_single(dna, single, mesh, kw, mode):
    got, core = run_port(*dna, mesh=mesh, **DNA, **kw)
    assert core.mesh_mode == mode and core.routes["mesh_tracks" if mode == "tracks" else "ring"] == 1
    if mode == "ring":
        assert core.ring_n_sub == (3 if kw else 1)
        # the ring's clipped reads: one sub-batch on the first device,
        # chunked when ref_chunk forces it
        assert core.routes["chunked" if kw else "oneshot"] == 1
    want, jcore = run_jax(*dna, "pallas", mesh=mesh, **DNA, **kw)
    assert jcore.mesh_mode == mode
    assert got == want
    if not kw.get("sam"):
        assert got == single


def test_mesh_cli_matches_library(dna, single, tmp_path):
    """`python -m sigfish_tpu_torch.cli dtw ... --device cpu --mesh 2x2`
    writes the single-device bytes."""
    fa, bl = dna
    out = tmp_path / "out.paf"
    r = subprocess.run(
        [sys.executable, "-m", "sigfish_tpu_torch.cli", "dtw", fa, bl, "-q", "64", "-p", "210",
         "--ckpt", "64", "-K", "32", "-t", "2", "--device", "cpu", "--mesh", "2x2",
         "-o", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr
    assert out.read_text() == single
    assert f"total entries: {N_READS}" in r.stderr


def test_mesh_devices_and_malformed_mesh(dna):
    """An explicit device list, the JAX Core's errors for a malformed
    --mesh and too few devices, and a 1x1 mesh as one device."""
    from sigfish_tpu_torch.runtime.pipeline import Core, Options

    fa, bl = dna
    core = Core(fa, bl, Options(device="cpu", mesh="2x1", mesh_devices=["cpu"] * 3, **DNA))
    assert core.mesh_mode == "tracks" and len(core.mesh) == 2
    core.close()
    for bad in ("2", "2x", "x2", "2x2x1", "axb"):
        with pytest.raises(ValueError):
            Core(fa, bl, Options(device="cpu", mesh=bad, **DNA))
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        Core(fa, bl, Options(device="cpu", mesh="1x4", mesh_devices=["cpu"] * 3, **DNA))
    core = Core(fa, bl, Options(device="cpu", mesh="1x1", **DNA))
    assert core.mesh is None
    core.close()
