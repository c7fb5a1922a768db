"""The generator and the roofline's arithmetic: the same seed makes the
same bytes, `zlib` and `raw` files hold the same signals, and the cells
counted for the roofline leave the mapper's padding out."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from benchmark import traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(cfg: str, tr: str, **ref):
    c = json.load(open(os.path.join(BENCH, "configs", cfg + ".json")))
    t = json.load(open(os.path.join(BENCH, "traffic", tr + ".json")))
    c["reference"].update(ref)
    t["reads"] = 30
    return c, t


def _digest(path: str) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_same_seed_same_bytes(tmp_path):
    c, t = _load("sequin_r9_rna", "zlib", count=4)
    seed = 2**31 + 5
    a = traffic.generate(c, t, seed, str(tmp_path / "a"))
    b = traffic.generate(c, t, seed, str(tmp_path / "b"))
    d = traffic.generate(c, t, seed + 1, str(tmp_path / "c"))
    assert _digest(a["blow5"]) == _digest(b["blow5"]) and _digest(a["fasta"]) == _digest(b["fasta"])
    assert _digest(a["blow5"]) != _digest(d["blow5"])


def test_zlib_and_raw_hold_the_same_signals(tmp_path):
    from sigfish_tpu_torch.io.blow5 import Slow5File

    seed = 77
    sigs = {}
    for tr in ("zlib", "raw"):
        c, t = _load("ecoli_r9_dna", tr, bases=4000)
        data = traffic.generate(c, t, seed, str(tmp_path / tr))
        with Slow5File(data["blow5"]) as sf:
            assert sf.rec_press == t["record_press"] and sf.sig_press == "svb-zd"
            recs = list(sf)
        assert [r.read_id for r in recs] == [r["read_id"] for r in data["reads"]]
        assert all(np.array_equal(r.raw_signal, g["raw"]) for r, g in zip(recs, data["reads"]))
        sigs[tr] = [r.raw_signal for r in recs]
    assert all(np.array_equal(a, b) for a, b in zip(sigs["zlib"], sigs["raw"]))


def test_read_kinds_follow_the_index(tmp_path):
    c, t = _load("sequin_r9_rna", "zlib", count=4)
    data = traffic.generate(c, t, 3, str(tmp_path))
    mix = t["rna"]
    for i, r in enumerate(data["reads"]):
        assert r["short"] == (i % mix["short_every"] == mix["short_at"])
        assert r["no_adaptor"] == (i % mix["no_adaptor_every"] == mix["no_adaptor_at"])


def test_dna_lengths_follow_the_mix(tmp_path):
    """DNA reads' levels: log-normal with the mix's mean, never under its
    least or over the genome's room; marked short below `clipped_below`."""
    _, t = _load("ecoli_r9_dna", "zlib")
    mix = t["dna"]
    n = traffic.dna_lengths(mix, 200_000, np.random.default_rng(2**33 + 1), 50_000)
    assert n.min() >= mix["bases"]["min"] and n.max() <= 50_000
    assert abs(n.mean() / mix["bases"]["mean"] - 1) < 0.02
    assert abs(np.log(n).std() - mix["bases"]["sigma_ln"]) < 0.02

    c, t = _load("ecoli_r9_dna", "zlib", bases=6000)
    t["dna"] = dict(mix, bases=dict(mix["bases"], mean=400))
    data = traffic.generate(c, t, 5, str(tmp_path))
    lo, hi = mix["dwell"]
    assert any(r["short"] for r in data["reads"]) and not all(r["short"] for r in data["reads"])
    for r in data["reads"]:
        cut = mix["clipped_below"] * (hi - 1 if r["short"] else lo)
        assert (r["raw"].size < cut) if r["short"] else (r["raw"].size >= cut)


def test_roofline_cells_leave_padding_out(tmp_path):
    """The work counted is each live record's query length times the real
    columns: less than the mapper's padded layout (Q rounded to 128, tracks
    aligned to the window), and the same in every pass that had the record."""
    import importlib.util

    from benchmark import run
    from benchmark.reference import tracks
    from sigfish_tpu_torch.ops.layout import pad_tracks

    c, t = _load("sequin_r9_rna", "zlib", count=4)
    data = traffic.generate(c, t, 11, str(tmp_path))
    passes = [dict(fed=30), dict(fed=12)]
    qlens, cols = run.sdtw_work(data, c, passes)
    trk = tracks.make_tracks(data["contigs"], "r9", True, 500)["tracks"]
    assert cols == sum(x.size for _, _, x in trk)
    ref, _, _ = pad_tracks([x for _, _, x in trk], ckpt=512, align=500)
    assert cols < ref.size
    assert len(qlens) <= 42 and all(25 <= q <= 500 for q in qlens)
    assert max(qlens) == 500 and min(qlens) < 500  # clipped reads count their own length
    spec = importlib.util.spec_from_file_location("m", os.path.join(BENCH, "metrics", "sdtw_roofline_pct.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ctx = type("C", (), dict(trace={"range_kernel_s": {"sdtw_submit": 1.0}}, issue_rate=1.0,
                             sdtw_qlens=qlens, ref_columns=cols))
    ops = cols * sum(4 * (q - 1) + 2 for q in qlens)
    assert mod.read(ctx) == 100.0 * ops
    assert ops < 4 * ref.size * 512 * len(qlens)
