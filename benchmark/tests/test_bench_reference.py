"""The plain reference held to sigfish_tpu_torch on the CPU at small sizes:
stage by stage (events, z-score, adaptor, polyA end, the DP) and whole
runs (every PAF line), DNA on the one-shot and the chunked route and
direct RNA with -p -1. The test may import the port; the reference may not."""

from __future__ import annotations

import io
import json
import os

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.reference import host, mapper, sdtw

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cell(name: str, **ref) -> tuple[dict, dict]:
    cfg = json.load(open(os.path.join(BENCH, "configs", name + ".json")))
    tr = json.load(open(os.path.join(BENCH, "traffic", "zlib.json")))
    cfg["reference"].update(ref)
    cfg["mapper"]["num_thread"] = 2
    return cfg, tr


@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    cfg, tr = _cell("ecoli_r9_dna", bases=5000)
    tr["reads"] = 40
    return cfg, traffic.generate(cfg, tr, 2**31 + 99, str(tmp_path_factory.mktemp("dna")))


@pytest.fixture(scope="module")
def rna(tmp_path_factory):
    cfg, tr = _cell("sequin_r9_rna", count=5)
    tr["reads"] = 40
    return cfg, traffic.generate(cfg, tr, 4_000_000_007, str(tmp_path_factory.mktemp("rna")))


def _port_lines(cfg: dict, data: dict, **over) -> dict:
    from sigfish_tpu_torch.runtime import pipeline as pl

    m = dict(cfg["mapper"], **over)
    opt = pl.Options(rna=m["rna"], prefix_size=m["prefix_size"], query_size=m["query_size"],
                     num_thread=m["num_thread"], batch_size=m["batch_size"],
                     ref_chunk=m["ref_chunk"], device="cpu")
    core = pl.Core(data["fasta"], data["blow5"], opt)
    out = io.StringIO()
    pl.run_dtw(core, out)
    core.close()
    return {line.split("\t")[0]: line for line in out.getvalue().splitlines(keepends=True)}


@pytest.mark.parametrize("which", ["dna", "rna"])
def test_events_and_zscore_bitwise(which, dna, rna):
    from sigfish_tpu_torch import native
    from sigfish_tpu_torch.io.blow5 import Slow5Record
    from sigfish_tpu_torch.ops.events import detect_events, get_events

    cfg, data = dna if which == "dna" else rna
    reads = data["reads"][:12]
    pas = [host.to_pa(r["raw"], r["digitisation"], r["offset"], r["range"]) for r in reads]
    ours = host.detect_events(pas, cfg["mapper"]["rna"])
    for r, pa, ev in zip(reads, pas, ours):
        rec = Slow5Record(read_id=r["read_id"], read_group=0, digitisation=r["digitisation"],
                          offset=r["offset"], range=r["range"], sampling_rate=4000.0,
                          raw_signal=r["raw"])
        assert np.array_equal(rec.to_pa(), pa)
        for et in (get_events(pa, rna=cfg["mapper"]["rna"]), detect_events(pa, rna=cfg["mapper"]["rna"])):
            assert np.array_equal(et.start.astype(np.int64), ev.start)
            assert np.array_equal(et.length, ev.length) and np.array_equal(et.mean, ev.mean)
        x = ev.mean[50:300].copy()
        y = x.copy()
        assert native.zscore_inplace(y)
        assert np.array_equal(host.zscore(x), y)


@pytest.mark.parametrize("which", ["dna", "rna"])
def test_events_of_a_head_are_the_whole_signals(which, dna, rna):
    """The events that detect_events returns for a head of a signal are
    the whole signal's first events, bit for bit, at every head length."""
    cfg, data = dna if which == "dna" else rna
    r = max(data["reads"][:6], key=lambda r: r["raw"].size)
    pa = host.to_pa(r["raw"], r["digitisation"], r["offset"], r["range"])
    whole = host.detect_events([pa], cfg["mapper"]["rna"])[0]
    cuts = list(range(20, 3000, 7))
    got = host.detect_events([pa[:c] for c in cuts], cfg["mapper"]["rna"], [True] * len(cuts))
    assert max(ev.start.size for ev in got) > 50
    for ev in got:
        n = ev.start.size
        for f in ("start", "length", "mean"):
            assert np.array_equal(getattr(ev, f), getattr(whole, f)[:n])


@pytest.mark.parametrize("which", ["dna", "rna"])
@pytest.mark.parametrize("head", [64, 700, 4096])
def test_queries_from_heads_are_the_whole_signals(which, head, dna, rna, monkeypatch):
    """Queries eventized over growing heads of the signals (few samples
    first, so most reads take several rounds) are those of the whole
    signals: the same reads ignored, the same window, the same bits."""
    cfg, data = dna if which == "dna" else rna
    m = cfg["mapper"]
    reads = data["reads"]
    monkeypatch.setattr(host, "HEAD", 10**9)
    whole = host.queries(reads, m["rna"], m["prefix_size"], m["query_size"])
    monkeypatch.setattr(host, "HEAD", head)
    got = host.queries(reads, m["rna"], m["prefix_size"], m["query_size"])
    assert sum(not q.skip for q in whole) >= len(reads) // 2
    for a, b in zip(whole, got):
        assert a.skip == b.skip
        if a.skip:
            continue
        assert (a.qstart, a.qend) == (b.qstart, b.qend)
        assert np.array_equal(a.query, b.query)
        for f in ("start", "length", "mean"):
            assert np.array_equal(getattr(a.events, f)[: a.qend], getattr(b.events, f)[: b.qend])


def test_polya_end_read_by_read(rna):
    from sigfish_tpu_torch.ops import jnn

    _, data = rna
    for r in data["reads"]:
        pa = host.to_pa(r["raw"], r["digitisation"], r["offset"], r["range"])
        assert host.adaptor(r["raw"]) == jnn.find_adaptor(r["raw"])
        assert host.polya_end(r["raw"], pa) == jnn.detect_polya_end(r["raw"], pa)


def test_dp_is_the_sequential_dp():
    from sigfish_tpu_torch.ops.sdtw_ref import subsequence_cost

    rng = np.random.default_rng(3)
    y = rng.standard_normal(700).astype(np.float32)
    qs = [(y[40:140] + 0.2 * rng.standard_normal(100)).astype(np.float32),
          rng.standard_normal(37).astype(np.float32)]
    rows, _ = sdtw.last_rows(qs, [y], device="cpu")
    for q, row in zip(qs, rows):
        full = subsequence_cost(q, y)
        assert np.array_equal(full[-1], row[0])
        assert np.array_equal(sdtw.cost_matrix(q, y[:300]), subsequence_cost(q, y[:300]))


@pytest.mark.parametrize("chunk,warm", [(400, 150), (400, 3), (333, 1)])
def test_chunks_and_their_repair_are_exact(chunk, warm):
    """Chunks whose warm-up is long enough, and chunks so short of one that
    most are swept again, give the one-chunk rows bit for bit."""
    rng = np.random.default_rng(chunk + warm)
    tracks = [rng.standard_normal(1900).astype(np.float32), rng.standard_normal(1234).astype(np.float32)]
    qs = [(tracks[b % 2][100 * b : 100 * b + 2 * n : 2] + 0.3 * rng.standard_normal(n)).astype(np.float32)
          for b, n in enumerate((48, 64, 31, 64))]
    whole, redone0 = sdtw.last_rows(qs, tracks, device="cpu", chunk=10**6)
    got, redone = sdtw.last_rows(qs, tracks, device="cpu", chunk=chunk, warm=warm)
    assert redone0 == 0
    assert all(np.array_equal(a, b) for x, y in zip(whole, got) for a, b in zip(x, y))
    if warm < 5:
        assert redone > 0


def test_dna_paf_one_shot(dna):
    cfg, data = dna
    ours, info = mapper.map_reads(data["reads"], data["contigs"], cfg["mapper"], device="cpu")
    port = _port_lines(cfg, data)
    assert info["live"] == len(data["reads"])
    assert all(port.get(r["read_id"]) == ours[r["read_id"]] for r in data["reads"])


def test_dna_paf_chunked_route(dna, monkeypatch):
    """The port's chunked route (forced) and the reference in many chunks."""
    cfg, data = dna
    monkeypatch.setattr(sdtw, "last_rows", _small_chunks(sdtw.last_rows))
    ours, _ = mapper.map_reads(data["reads"], data["contigs"], cfg["mapper"], device="cpu")
    port = _port_lines(cfg, data, ref_chunk=2000)
    assert all(port.get(r["read_id"]) == ours[r["read_id"]] for r in data["reads"])


def _small_chunks(fn):
    def wrapper(queries, tracks, **kw):
        return fn(queries, tracks, **dict(kw, chunk=900, warm=300))
    return wrapper


def test_rna_paf(rna):
    cfg, data = rna
    ours, info = mapper.map_reads(data["reads"], data["contigs"], cfg["mapper"], device="cpu")
    port = _port_lines(cfg, data)
    assert any(r["no_adaptor"] for r in data["reads"]) and any(r["short"] for r in data["reads"])
    assert all(port.get(r["read_id"]) == ours[r["read_id"]] for r in data["reads"])


@pytest.mark.gpu
def test_dp_on_the_card_is_the_cpu_dp():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    tracks = [rng.standard_normal(5000).astype(np.float32)]
    qs = [rng.standard_normal(n).astype(np.float32) for n in (250, 120)]
    a, _ = sdtw.last_rows(qs, tracks, device="cpu", chunk=1500, warm=500)
    b, _ = sdtw.last_rows(qs, tracks, device="cuda", chunk=1500, warm=500)
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))
