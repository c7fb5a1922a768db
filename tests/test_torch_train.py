"""The port's pore-model tools on the CPU against sigfish_tpu's: the
trainer's two E-step DPs (the plain versions of csrc/gap_dtw.cu and
csrc/banded_dtw.cu) against the JAX numpy functions, the finetune E-step
(the plain wavefront plus the native backtrack) against subsequence_cost
+ subsequence_path, whole EM runs (tables np.array_equal, stderr lines
equal), derive_9mer and write_tsv.

Workloads: chip_smoke.py's generators at a small size (tests/port_runs.py),
truth PAFs written by its write_truth_paf, as its phase 12 does.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from sigfish_tpu.models import derive_models as jdm
from sigfish_tpu.models import export_tsv as jex
from sigfish_tpu.models import pore_model as jpm
from sigfish_tpu.models import train_model as jtm
from sigfish_tpu.ops import sdtw_ref as jref
from sigfish_tpu_torch.io.fasta import read_fasta
from sigfish_tpu_torch.models import derive_models as tdm
from sigfish_tpu_torch.models import export_tsv as tex
from sigfish_tpu_torch.models import pore_model as tpm
from sigfish_tpu_torch.models import train_model as ttm
from sigfish_tpu_torch.ops import train_dtw as td

from port_runs import load_smoke

SEED = 13


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _ragged(rng, sizes, clip=None):
    out = []
    for s in sizes:
        v = rng.standard_normal(int(s)).astype(np.float32)
        out.append(v if clip is None else np.clip(v, -clip, clip))
    return out


# (gap_up, gap_left): fit_model's annealed gaps at frac 0, 0.5 and 1, and
# the verbose diagnostic's defaults
@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0, "diagnostic"])
def test_gap_sdtw_plain_matches_jax(frac):
    gu, gl = (0.6, 0.2) if frac == "diagnostic" else (0.8 - 0.3 * frac, 0.3 - 0.15 * frac)
    rng = np.random.default_rng(SEED)
    rows = _ragged(rng, (1, 6, 47, 140, 96, 2))
    cols = _ragged(rng, (9, 1, 60, 170, 80, 33), clip=3.5)
    end, end_cost, paths = td.gap_pairs(rows, cols, gu, gl, "cpu")
    for b, (x, y) in enumerate(zip(rows, cols)):
        cost = jtm._subsequence_cost_gap(x, y, gu, gl)
        e = int(cost[-1].argmin())
        px, py = jtm._backtrack_gap(cost, x, y, e, np.float32(gu), np.float32(gl))
        assert end[b] == e
        assert _bits(end_cost[b]) == _bits(cost[-1, e])
        assert np.array_equal(paths[b][0], px) and np.array_equal(paths[b][1], py)
        assert paths[b][0].dtype == px.dtype == np.int64


def _small_ints(rng, sizes):
    """Values from {0, 1, 2}: with gaps exact in binary, up, diag and left
    (and the end candidates) tie often."""
    return [rng.integers(0, 3, int(s)).astype(np.float32) for s in sizes]


# gaps exact in binary, and fit_model's annealed start
@pytest.mark.parametrize("gaps", [(0.5, 0.25), (0.8, 0.3)])
def test_gap_sdtw_plain_ties_match_jax(gaps):
    """Tie-heavy cases: the walk's order (diag, then left, then up) and
    the last row's first argmin, bitwise against the JAX functions."""
    gu, gl = gaps
    rng = np.random.default_rng(SEED + 1)
    rows = _small_ints(rng, (40, 1, 33, 70, 9, 64))
    cols = _small_ints(rng, (50, 12, 1, 30, 80, 64))
    end, end_cost, paths = td.gap_pairs(rows, cols, gu, gl, "cpu")
    for b, (x, y) in enumerate(zip(rows, cols)):
        cost = jtm._subsequence_cost_gap(x, y, gu, gl)
        e = int(cost[-1].argmin())
        px, py = jtm._backtrack_gap(cost, x, y, e, np.float32(gu), np.float32(gl))
        assert end[b] == e
        assert _bits(end_cost[b]) == _bits(cost[-1, e])
        assert np.array_equal(paths[b][0], px) and np.array_equal(paths[b][1], py)


# (rows n, columns m, band, end_slack) per case
BANDED = {
    "n<m": ([40, 90, 7], [70, 160, 30], [4, 9, 1], 12),
    "n>m": ([120, 64, 30], [45, 20, 9], [12, 6, 3], 10),
    "slack>=m": ([50, 8, 90], [20, 5, 60], [5, 1, 9], 60),
    "clipped both edges": ([80, 150, 33], [80, 150, 33], [100, 200, 50], 5),
    # rows' bands (at least end_slack + 8 = 9 either side) that do not
    # overlap from one row to the next where m / n > 19
    "m>=4n band 1-2": ([12, 5, 9], [60, 130, 250], [1, 2, 1], 1),
    "n>=4m": ([90, 160, 41], [20, 35, 10], [1, 2, 3], 2),
}


@pytest.mark.parametrize("kind", list(BANDED))
def test_banded_dtw_plain_matches_jax(kind):
    ns, ms, bands, slack = BANDED[kind]
    rng = np.random.default_rng(SEED + len(kind))
    evs, lvls = _ragged(rng, ns, clip=4.0), _ragged(rng, ms)
    paths = td.banded_pairs(evs, lvls, bands, slack, "cpu")
    for b in range(len(ns)):
        px, py = jtm._banded_anchored_dtw(evs[b], lvls[b], bands[b], slack)
        assert np.array_equal(paths[b][0], px) and np.array_equal(paths[b][1], py)
        assert paths[b][0].dtype == px.dtype == np.int64


@pytest.mark.parametrize("kind", list(BANDED))
def test_banded_dtw_plain_ties_match_jax(kind):
    """BANDED's shapes on tie-heavy inputs: the pointers' order (diag,
    then up, then left, each only if strictly less) and the end's list
    order, bitwise against the JAX function."""
    ns, ms, bands, slack = BANDED[kind]
    rng = np.random.default_rng(SEED + 2 * len(kind))
    evs, lvls = _small_ints(rng, ns), _small_ints(rng, ms)
    paths = td.banded_pairs(evs, lvls, bands, slack, "cpu")
    for b in range(len(ns)):
        px, py = jtm._banded_anchored_dtw(evs[b], lvls[b], bands[b], slack)
        assert np.array_equal(paths[b][0], px) and np.array_equal(paths[b][1], py)


# the banded kernel's source with a log of each stripe's swept steps T and
# the stride S it gives a stripe's pointer words, for the emulation
_NOTE_PRELUDE = r"""
#include <mutex>
static std::mutex emu_note_mu;
static std::vector<long long> emu_note_log;
static void emu_note(long long b, long long g, long long T, long long S) {
  std::lock_guard<std::mutex> hold(emu_note_mu);
  emu_note_log.insert(emu_note_log.end(), {b, g, T, S});
}
extern "C" long long emu_notes(long long* out, long long cap) {
  std::lock_guard<std::mutex> hold(emu_note_mu);
  const long long k = (long long)emu_note_log.size();
  for (long long q = 0; q < k && q < cap; ++q) out[q] = emu_note_log[q];
  emu_note_log.clear();
  return k;
}
"""
_NOTE_STRIPES = ((r"(const int T = bd\.hi\(min\(n - 1, i0 \+ 31\)\) - J0 \+ 31;)",
                  r"\1 if (lane == 0) emu_note(b, g, T, S);"),)


@pytest.fixture(scope="module")
def banded_noted(tmp_path_factory):
    import ctypes

    from kernel_emu import build

    lib = build(tmp_path_factory.mktemp("emu"), "banded_dtw", _NOTE_STRIPES, _NOTE_PRELUDE,
                "_noted")
    lib.emu_notes.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.emu_notes.restype = ctypes.c_longlong
    return lib


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_banded_pointer_words_hold_every_stripe(banded_noted, seed):
    """The banded wrapper's pointer words, against the kernel's own
    stripes: csrc/banded_dtw.cu run in the CPU emulation (tests/
    kernel_emu.py) logs each 32-row stripe's swept steps and its stride;
    every stripe's steps fit its stride and the case's stripes the words
    the wrapper gave a case, and the outputs equal the plain version's; at
    random shapes, bands and slacks, with extreme n / m ratios among
    them."""
    rng = np.random.default_rng(seed)
    ns = np.concatenate([rng.integers(1, 30, 4), rng.integers(200, 600, 3),
                         rng.integers(1, 300, 5)])
    ms = np.concatenate([rng.integers(300, 800, 4), rng.integers(1, 20, 3),
                         rng.integers(1, 300, 5)])
    bands = rng.integers(0, 60, ns.size)
    bands[::4] = 0
    slack = int(rng.integers(1, 40))
    ev, n = td.pack(_ragged(rng, ns), "cpu")
    lvl, m = td.pack(_ragged(rng, ms), "cpu")
    band = torch.from_numpy(bands.astype(np.int32))
    args, got, _ = td._banded_args(ev, lvl, n, m, band, slack, 0.5, 0.25, warps=2)
    td._run(banded_noted.sf_banded_dtw, args, None, "banded_dtw")
    notes = np.zeros(4 * 1_000, np.int64)
    k = banded_noted.emu_notes(notes.ctypes.data, notes.size)
    b, g, T, S = notes[:k].reshape(-1, 4).T
    case_words = args[12]
    assert sorted(zip(b.tolist(), g.tolist())) == [(c, q) for c in range(ns.size)
                                                  for q in range(-(-int(ns[c]) // 32))]
    assert (T <= S).all() and ((g + 1) * S <= case_words).all()
    assert all(torch.equal(u, v) for u, v in zip(got, td.banded_dtw_plain(ev, lvl, n, m, band,
                                                                           slack)))


def test_empty_cases_leave_the_others_alone():
    """An empty case (no rows or no columns) gets end -1 and no path; the
    other cases of the batch come out as they do alone."""
    rng = np.random.default_rng(SEED)
    rows = _ragged(rng, (30, 0, 25, 12))
    cols = _ragged(rng, (40, 10, 0, 16))
    end, end_cost, paths = td.gap_pairs(rows, cols, 0.8, 0.3, "cpu")
    assert list(end[1:3]) == [-1, -1] and list(end_cost[1:3]) == [0.0, 0.0]
    assert all(p[0].size == 0 for p in paths[1:3])
    for b in (0, 3):
        e1, c1, p1 = td.gap_pairs([rows[b]], [cols[b]], 0.8, 0.3, "cpu")
        assert end[b] == e1[0] and _bits(end_cost[b]) == _bits(c1[0])
        assert all(np.array_equal(u, v) for u, v in zip(paths[b], p1[0]))
    bp = td.banded_pairs(rows, cols, [3, 3, 3, 3], 8, "cpu")
    assert all(p[0].size == 0 for p in bp[1:3])
    for b in (0, 3):
        alone = td.banded_pairs([rows[b]], [cols[b]], [3], 8, "cpu")[0]
        assert all(np.array_equal(u, v) for u, v in zip(bp[b], alone))


def test_kernel_wrappers_reject_bad_input():
    x, n = td.pack([np.zeros(4, np.float32)], "cpu")
    with pytest.raises(ValueError):
        td.gap_sdtw(x, x, n + 1, n, 0.8, 0.3)      # n past the padded rows
    with pytest.raises(ValueError):
        td.banded_dtw(x, x, n, n, torch.zeros(1, dtype=torch.int32), 0)  # no end candidate


def test_finetune_estep_matches_sdtw_ref():
    """The plain wavefront over the batch's distinct tracks, each window's
    end read from its own columns and the native backtrack give
    subsequence_path(subsequence_cost(q, lvl), argmin) window by window;
    windows share tracks, and the shorter queries ride start lanes."""
    rng = np.random.default_rng(SEED)
    levels = rng.standard_normal(1024)
    kms = [rng.integers(0, 1024, int(s)) for s in (120, 75, 160)]
    windows = [(rng.standard_normal(int(n)).astype(np.float32), kms[t])
               for n, t in ((60, 0), (25, 1), (60, 2), (1, 0), (44, 1), (37, 0))]
    paths = ttm._inference_paths(levels, windows, "cpu")
    for (q, km), (px, py) in zip(windows, paths):
        lvl = jtm._zscore(levels[km]).astype(np.float32)
        cost = jref.subsequence_cost(q, lvl)
        wx, wy = jref.subsequence_path(cost, int(cost[-1].argmin()))
        assert np.array_equal(px, wx) and np.array_equal(py, wy)


@pytest.fixture(scope="module")
def smoke():
    return load_smoke()


def _stderr_lines(capsys) -> list[str]:
    return capsys.readouterr().err.splitlines()


def test_fit_model_matches_jax(smoke, tmp_path, capsys):
    """R9 DNA 6-mer: 10 reads (one clipped) at 3 iterations with the
    verbose diagnostic: the table and every [train] line equal."""
    fa, bl, truth = smoke.make_workload(str(tmp_path), 3_000, 10, SEED)
    paf = str(tmp_path / "truth.paf")
    smoke.write_truth_paf(paf, truth, {smoke.contig_of(truth): 3_000})
    want = jtm.fit_model(jtm.load_cases(bl, fa, paf, rna=False, k=6), k=6, iters=3)
    jlog = _stderr_lines(capsys)
    got = ttm.fit_model(ttm.load_cases(bl, fa, paf, rna=False, k=6), k=6, iters=3, device="cpu")
    assert _stderr_lines(capsys) == jlog and len(jlog) == 3
    assert got.kmer_size == want.kmer_size == 6
    assert np.array_equal(got.level_mean, want.level_mean)
    assert np.array_equal(got.level_stdv, want.level_stdv)


def test_fit_model_banded_and_finetune_match_jax(smoke, tmp_path, capsys):
    """R9 RNA 5-mer, trimmed cases over 3 transcripts: fit_model_banded at
    3 iterations, then finetune_inference_matched at 2 over the windows
    main builds: both level vectors and every line equal."""
    fa, bl, truth = smoke.make_rna_workload(str(tmp_path), 3, 6, SEED, tx_len=(250, 450),
                                            walks=(200, 100))
    lengths = {name: len(seq) for name, seq in read_fasta(fa)}
    paf = str(tmp_path / "truth.paf")
    smoke.write_truth_paf(paf, truth, lengths)
    jc = jtm.load_cases_trimmed_rna(bl, fa, paf, k=5)
    jl = jtm.fit_model_banded(jc, k=5, iters=3)
    contigs = dict(read_fasta(fa))
    jw = []
    for c in jc:  # sigfish_tpu's main, inline there
        seq = contigs[c.tid]
        L = len(seq)
        ref_len = min(750, L + 1 - 5)
        km = jtm.kmer_ranks(jtm._seq_bytes(seq[L - ref_len - 4:]), 5, warn_non_acgt=False)
        jw.append((jtm._zscore(c.event_mean[-500:]).astype(np.float32),
                   km[:ref_len].astype(np.int64)))
    jf = jtm.finetune_inference_matched(jl, jw, k=5, iters=2)
    jlog = _stderr_lines(capsys)

    tc = ttm.load_cases_trimmed_rna(bl, fa, paf, k=5)
    tl = ttm.fit_model_banded(tc, k=5, iters=3, device="cpu")
    tw = ttm.inference_windows(tc, fa)
    assert all(np.array_equal(a, c) and np.array_equal(b, d) for (a, b), (c, d) in zip(tw, jw))
    timings = []
    tf = ttm.finetune_inference_matched(tl, tw, k=5, iters=2, device="cpu", timings=timings)
    assert _stderr_lines(capsys) == jlog and len(jlog) == 5
    assert np.array_equal(tl, jl) and np.array_equal(tf, jf)
    assert [t["iter"] for t in timings] == [0, 1]
    assert all(t["launches"] == 0 and t["estep_device_s"] == 0.0 for t in timings)


def test_main_writes_both_tables(smoke, tmp_path, monkeypatch, capsys):
    """main --ref-dir DIR --device cpu reads the reference's file names
    and writes the DNA and RNA tables through save_builtin_model into the
    data directory (redirected here: the committed tables stay)."""
    ref = tmp_path / "ref"
    ref.mkdir()
    fa, bl, truth = smoke.make_workload(str(tmp_path), 2_000, 2, SEED)
    os.replace(fa, ref / "nCoV-2019.reference.fasta")
    os.replace(bl, ref / "sp1_dna.blow5")
    smoke.write_truth_paf(str(ref / "sp1_dna.minimap2.paf"), truth, {smoke.contig_of(truth): 2_000})
    fa, bl, truth = smoke.make_rna_workload(str(tmp_path), 2, 2, SEED, tx_len=(250, 300),
                                            walks=(120, 100))
    lengths = {name: len(seq) for name, seq in read_fasta(fa)}
    os.replace(fa, ref / "rnasequin_sequences_2.4.fa")
    os.replace(bl, ref / "sequin_rna.blow5")
    smoke.write_truth_paf(str(ref / "sequin_rna.minimap2.paf"), truth, lengths)
    data = tmp_path / "data"
    monkeypatch.setattr(tpm, "_DATA_DIR", str(data))
    ttm.main(["--ref-dir", str(ref), "--device", "cpu"])
    err = capsys.readouterr().err
    assert "[train] 2 DNA training reads" in err and "[train] 2 RNA training reads" in err
    for mid, k in ((tpm.MODEL_ID_DNA_R9, 6), (tpm.MODEL_ID_RNA_R9, 5)):
        m = tpm.load_builtin_model(mid)
        assert m.kmer_size == k and np.isfinite(m.level_mean).all()
    assert sorted(os.listdir(data)) == ["r9.4_dna_6mer.npz", "r9.4_rna_5mer.npz"]


@pytest.mark.parametrize("mid", [jpm.MODEL_ID_DNA_R9, jpm.MODEL_ID_RNA_R9])
def test_derive_9mer_matches_jax(mid):
    got = tdm.derive_9mer(tpm.load_builtin_model(mid))
    want = jdm.derive_9mer(jpm.load_builtin_model(mid))
    assert got.kmer_size == want.kmer_size == 9
    assert np.array_equal(got.level_mean, want.level_mean)
    assert np.array_equal(got.level_stdv, want.level_stdv)


@pytest.mark.parametrize("mid", [jpm.MODEL_ID_DNA_R9, jpm.MODEL_ID_RNA_R9, jpm.MODEL_ID_DNA_R10])
def test_write_tsv_bytes_match_jax(mid, tmp_path):
    m = tpm.load_builtin_model(mid)
    tex.write_tsv(str(tmp_path / "port.tsv"), m.kmer_size, m.level_mean, m.level_stdv)
    jm = jpm.load_builtin_model(mid)
    jex.write_tsv(str(tmp_path / "jax.tsv"), jm.kmer_size, jm.level_mean, jm.level_stdv)
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
