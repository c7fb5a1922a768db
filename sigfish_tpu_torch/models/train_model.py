"""Learn pore k-mer level tables from raw signals + truth alignments (EM),
with each iteration's E-step on the card.

The counterpart of sigfish_tpu/models/train_model.py, which learned the
r9 DNA and RNA tables both packages ship (models/data/). The EM is the
same: the E-step aligns every read's event means to the expected levels
of its true reference window, the M-step fits a weighted ridge
regression of the aligned event z-levels on k-mer features with a
per-read affine + drift recalibration and count-shrunk per-k-mer
residuals. What changes is where the E-step runs. The JAX package aligns
one read at a time in numpy on the host; here each iteration first
aligns all reads in one batched call on `device`, then runs the host
loop over the reads in the JAX package's order:

  fit_model                   ops/train_dtw.gap_sdtw (csrc/gap_dtw.cu)
  fit_model_banded            ops/train_dtw.banded_dtw (csrc/banded_dtw.cu)
  finetune_inference_matched  ops/sdtw_wavefront.sdtw_wavefront, the
                              mapper's own kernel (csrc/wavefront.cu),
                              then the native backtrack on the host

Batching is exact: within an iteration the levels are fixed and each
read's dwell rate is its own, so aligning every read first changes no
input of any alignment. The host parts (features, z-scores, the case
loaders, the IRLS recalibration, np.add.at and the M-step's normal
equations in f64) are the JAX package's, unchanged, so the tables come
out bit for bit the same.

Run:  python -m sigfish_tpu_torch.models.train_model --ref-dir DIR [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np
import torch

from ..io.blow5 import Slow5File
from ..io.fasta import read_fasta
from ..models.genref import kmer_ranks, reverse_complement, _seq_bytes
from ..models.pore_model import (
    MODEL_ID_DNA_R9,
    MODEL_ID_RNA_R9,
    PoreModel,
    save_builtin_model,
)
from .. import native
from ..ops import layout, sdtw_wavefront as wfm, train_dtw
from ..ops.events import get_events
from ..ops.sdtw_ref import subsequence_cost, subsequence_path

# one E-step call holds at most this many padded DP cells on the card
ESTEP_CELLS = 1 << 29
# the finetune E-step's query width (the kernel's widest) and batch
FINETUNE_Q = 512
FINETUNE_BATCH = 512


def _build_features(k: int) -> np.ndarray:
    """Feature matrix X (4^k, F): position-base one-hots, adjacent-pair
    one-hots, and central-triple one-hots."""
    n = 4 ** k
    ranks = np.arange(n, dtype=np.int64)
    bases = np.stack(
        [(ranks >> (2 * (k - 1 - i))) & 3 for i in range(k)], axis=1
    )  # (n, k) first base most significant
    feats = []
    for i in range(k):
        oh = np.zeros((n, 4), dtype=np.float32)
        oh[np.arange(n), bases[:, i]] = 1.0
        feats.append(oh)
    for i in range(k - 1):
        pair = bases[:, i] * 4 + bases[:, i + 1]
        oh = np.zeros((n, 16), dtype=np.float32)
        oh[np.arange(n), pair] = 1.0
        feats.append(oh)
    # central triple(s): the pore's strongest interaction is among the
    # central bases
    mid = (k - 3) // 2
    for i in (mid, mid + 1) if k >= 4 else (0,):
        if i + 2 < k:
            tri = bases[:, i] * 16 + bases[:, i + 1] * 4 + bases[:, i + 2]
            oh = np.zeros((n, 64), dtype=np.float32)
            oh[np.arange(n), tri] = 1.0
            feats.append(oh)
    # sliding 4-mer windows: captures most of the pore's context response
    for i in range(k - 3):
        quad = (
            bases[:, i] * 64 + bases[:, i + 1] * 16 + bases[:, i + 2] * 4 + bases[:, i + 3]
        )
        oh = np.zeros((n, 256), dtype=np.float32)
        oh[np.arange(n), quad] = 1.0
        feats.append(oh)
    return np.concatenate(feats, axis=1)


def _zscore(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    s = x.std()
    return (x - x.mean()) / (s if s > 0 else 1.0)


class ReadCase:
    """One training read: event means + its true reference k-mer window."""

    def __init__(self, read_id, event_mean, event_length, kmer_seq, pad_events):
        self.read_id = read_id
        self.event_mean = event_mean  # full-read event means (signal order
        #                               for DNA; reversed for RNA)
        self.event_length = event_length  # samples per event (same order)
        self.kmers = kmer_seq  # k-mer ranks of the true window, event order
        self.pad = pad_events
        self.rate = None  # events per kmer, refined each EM iteration


def load_cases(
    blow5_path: str,
    fasta_path: str,
    truth_paf: str,
    rna: bool,
    k: int,
    pad_bases: int = 10,
) -> list[ReadCase]:
    contigs = {name: seq for name, seq in read_fasta(fasta_path)}
    truth: dict[str, tuple] = {}
    with open(truth_paf) as fp:
        for line in fp:
            f = line.rstrip("\n").split("\t")
            if not f or not f[0]:
                continue
            tp = "P"
            for tag in f[12:]:
                if tag.startswith("tp:A:"):
                    tp = tag[-1]
            if tp != "P" or f[0] in truth:
                continue  # primary mapping only, first wins
            truth[f[0]] = (f[5], f[4], int(f[7]), int(f[8]))

    cases: list[ReadCase] = []
    sf = Slow5File(blow5_path)
    for rec in sf:
        t = truth.get(rec.read_id)
        if t is None:
            continue
        tid, strand, ts, te = t
        seq = contigs[tid]
        lo = max(0, ts - pad_bases)
        hi = min(len(seq), te + pad_bases)
        window = seq[lo:hi]
        if strand == "-":
            window = reverse_complement(window)
        kmers = kmer_ranks(_seq_bytes(window), k, warn_non_acgt=False)
        et = get_events(rec.to_pa(), rna=rna)
        ev = et.mean.astype(np.float64)
        el = et.length.astype(np.float64)
        if rna:
            ev = ev[::-1].copy()  # signal is 3'->5'; align in 5'->3'
            el = el[::-1].copy()
        cases.append(
            ReadCase(rec.read_id, ev, el, kmers.astype(np.int64), pad_bases)
        )
    sf.close()
    return cases


def _interp_pairs(case: ReadCase, margin_frac: float = 0.12):
    """Iteration-0 alignment: linearly map the central event span onto the
    k-mer window (skipping an adaptor-sized margin at both event ends)."""
    ne = case.event_mean.size
    nk = case.kmers.size
    m = int(ne * margin_frac)
    ev_idx = np.arange(m, ne - m)
    if ev_idx.size < 8:
        ev_idx = np.arange(ne)
    pos = np.linspace(0, nk - 1, ev_idx.size).round().astype(np.int64)
    return ev_idx, pos


class _Clock:
    """Per-iteration timings of a trainer run, appended to `timings` when
    the caller passes a list: seconds (the iteration's wall time),
    estep_s (wall time of its batched E-step calls, uploads and the
    copies back included), estep_device_s (the span of that work on the
    device's stream, CUDA events; 0 on the CPU) and launches (the
    E-step kernels launched)."""

    def __init__(self, timings, device):
        self.timings = timings
        self.cuda = torch.device(device).type == "cuda"

    def _launches(self):
        return wfm.sdtw_wavefront.launches + train_dtw.gap_sdtw.launches + \
            train_dtw.banded_dtw.launches

    def start(self, it):
        if self.timings is not None:
            self.rec = dict(iter=it, seconds=0.0, estep_s=0.0, estep_device_s=0.0, launches=0)
            self.t0, self.n0 = time.perf_counter(), self._launches()

    @contextlib.contextmanager
    def estep(self):
        if self.timings is None:
            yield
            return
        t0 = time.perf_counter()
        if self.cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        yield
        if self.cuda:
            ev1.record()
            ev1.synchronize()
            self.rec["estep_device_s"] += ev0.elapsed_time(ev1) / 1e3
        self.rec["estep_s"] += time.perf_counter() - t0

    def stop(self):
        if self.timings is not None:
            self.rec["seconds"] = time.perf_counter() - self.t0
            self.rec["launches"] = self._launches() - self.n0
            self.timings.append(self.rec)


def _batches(sizes: list[tuple[int, int]]):
    """Consecutive index ranges of cases whose padded (rows, columns) DP
    fits ESTEP_CELLS (one case at least)."""
    lo = 0
    while lo < len(sizes):
        hi, N, M = lo, 1, 1
        while hi < len(sizes):
            n2, m2 = max(N, sizes[hi][0]), max(M, sizes[hi][1])
            if hi > lo and (hi + 1 - lo) * n2 * m2 > ESTEP_CELLS:
                break
            N, M, hi = n2, m2, hi + 1
        yield lo, hi
        lo = hi


def _dtw_inputs(case: ReadCase, levels: np.ndarray):
    """_dtw_pairs' inputs of one case: the dwell-expanded window levels
    (query axis), the read's clipped event z-levels and the expansion's
    row -> k-mer map."""
    ev = _zscore(case.event_mean).astype(np.float32)
    ev = np.clip(ev, -3.5, 3.5)
    nk = case.kmers.size
    # fractional dwell expansion: stretch the kmer sequence to the
    # expected events/base so the optimal path is near-diagonal; the rate
    # is re-estimated from the previous iteration's alignment span
    if case.rate is None:
        rate = max(1.0, case.event_mean.size * 0.76 / nk)
    else:
        rate = case.rate
    n_exp = int(round(nk * rate))
    km_exp = np.minimum((np.arange(n_exp) / rate).astype(np.int64), nk - 1)
    lvl = _zscore(levels[case.kmers]).astype(np.float32)[km_exp]
    return lvl, ev, km_exp


def _dtw_pairs(
    cases: list[ReadCase],
    levels: np.ndarray,
    gap_up: float = 0.6,
    gap_left: float = 0.2,
    device="cuda",
):
    """E-step of every case: gap-penalized subsequence-DTW of the
    dwell-expanded window levels (query axis) against the read's events
    (free start/end on the event axis), batched on device. Returns one
    (py, pos, cost per column) per case and re-estimates each case's
    rate from its alignment span, as the JAX package's per-read
    _dtw_pairs does."""
    ins = [_dtw_inputs(c, levels) for c in cases]
    out = []
    for lo, hi in _batches([(lvl.size, ev.size) for lvl, ev, _ in ins]):
        _, end_cost, paths = train_dtw.gap_pairs(
            [lvl for lvl, _, _ in ins[lo:hi]], [ev for _, ev, _ in ins[lo:hi]],
            gap_up, gap_left, device,
        )
        for case, (_, _, km_exp), ec, (px, py) in zip(cases[lo:hi], ins[lo:hi], end_cost, paths):
            # px: expanded-window rows -> kmer positions; py: event indices
            pos = km_exp[px]
            span = py.max() - py.min() + 1
            kspan = pos.max() - pos.min() + 1
            new_rate = span / max(kspan, 1)
            case.rate = float(np.clip(new_rate, 1.0, 6.0))
            out.append((py, pos, float(ec) / max(span, 1)))
    return out


def fit_model(
    cases: list[ReadCase],
    k: int,
    iters: int = 20,
    ridge: float = 3.0,
    resid_shrink: float = 2.0,
    verbose: bool = True,
    device="cuda",
    timings: list | None = None,
) -> PoreModel:
    n_kmer = 4 ** k
    X = _build_features(k)
    F = X.shape[1]
    clock = _Clock(timings, device)

    levels = np.zeros(n_kmer, dtype=np.float64)
    for it in range(iters):
        clock.start(it)
        # anneal the gap penalties: strict early (prevents contraction),
        # relaxed late (lets true dwell variance through)
        frac = min(1.0, it / max(iters - 4, 1))
        gap_up = 0.8 - 0.3 * frac
        gap_left = 0.3 - 0.15 * frac
        rows_k = []
        rows_t = []
        rows_w = []
        if it > 0:
            with clock.estep():
                pairs = _dtw_pairs(cases, levels, gap_up, gap_left, device)
        for ci, case in enumerate(cases):
            if it == 0:
                ev_idx, pos = _interp_pairs(case)
            else:
                ev_idx, pos = pairs[ci][:2]
            ev_z = np.clip(_zscore(case.event_mean), -3.5, 3.5)[ev_idx]
            kr = case.kmers[pos]
            # weight by sqrt(dwell): longer events have less mean noise
            wgt = np.sqrt(case.event_length[ev_idx])
            wgt /= wgt.mean()
            # per-read recalibration against the current model: scale,
            # shift and a linear time-drift term (nanopore baselines
            # wander along a read; z-scoring removes only shift/scale)
            if it > 0:
                lv = levels[kr]
                tau = (ev_idx - ev_idx.mean()) / max(ev_idx.std(), 1.0)
                A = np.stack([lv, np.ones_like(lv), tau], axis=1)
                keep = np.ones(lv.size, dtype=bool)
                a, b, c = 1.0, 0.0, 0.0
                for _ in range(3):  # robust IRLS: trim outlier pairs
                    coef, *_ = np.linalg.lstsq(
                        A[keep] * wgt[keep, None], ev_z[keep] * wgt[keep], rcond=None
                    )
                    a, b, c = (float(v) for v in coef)
                    if abs(a) < 1e-3:
                        a, b, c = 1.0, 0.0, 0.0
                        break
                    r = ev_z - (a * lv + b + c * tau)
                    sd = r[keep].std()
                    keep = np.abs(r) < 2.5 * sd
                t = (ev_z - b - c * tau) / a
                kr = kr[keep]
                t = t[keep]
                wgt = wgt[keep]
            else:
                t = ev_z
            rows_k.append(kr)
            rows_t.append(t)
            rows_w.append(wgt)
        kr = np.concatenate(rows_k)
        tt = np.concatenate(rows_t)
        ww = np.concatenate(rows_w)

        # M-step: weighted ridge regression on k-mer features
        Xo = X[kr] * ww[:, None]
        XtX = Xo.T @ (X[kr]) + ridge * np.eye(F, dtype=np.float64)
        Xty = Xo.T @ tt
        wcoef = np.linalg.solve(XtX, Xty)
        pred = X @ wcoef

        # per-kmer shrunk residuals (weighted)
        resid_sum = np.zeros(n_kmer)
        resid_cnt = np.zeros(n_kmer)
        np.add.at(resid_sum, kr, ww * (tt - pred[kr]))
        np.add.at(resid_cnt, kr, ww)
        shrink = resid_cnt / (resid_cnt + resid_shrink)
        with np.errstate(invalid="ignore"):
            resid = np.where(resid_cnt > 0, resid_sum / np.maximum(resid_cnt, 1e-9), 0.0)
        new_levels = pred + shrink * resid
        new_levels = _zscore(new_levels)

        delta = np.abs(new_levels - levels).mean() if it else np.inf
        levels = new_levels
        if verbose:
            align_cost = 0.0
            if it > 0:
                # diagnostic only: _dtw_pairs re-estimates case.rate as a
                # side effect, which would make verbose runs train
                # differently -- snapshot and restore
                saved_rates = [c.rate for c in cases]
                with clock.estep():
                    align_cost = np.mean([p[2] for p in _dtw_pairs(cases, levels, device=device)])
                for c, r in zip(cases, saved_rates):
                    c.rate = r
            sys.stderr.write(
                f"[train] iter {it}: obs={tt.size} mean|dlvl|={delta:.4f} "
                f"cost/col={align_cost:.4f}\n"
            )
        clock.stop()

    # present in a pA-like scale for readability (mean 100, sd 10)
    out = (levels * 10.0 + 100.0).astype(np.float32)
    return PoreModel(
        kmer_size=k,
        level_mean=out,
        level_stdv=np.full(n_kmer, 2.0, dtype=np.float32),
    )


def load_cases_trimmed_rna(
    blow5_path: str, fasta_path: str, truth_paf: str, k: int
) -> list[ReadCase]:
    """RNA cases with adaptor+polyA trimmed via the production
    detect_query_start, so the reversed event array is transcript-only
    and BOTH endpoints anchor to the truth window (the polyA boundary is
    the transcript 3' end; the read end is where basecalling started)."""
    from ..ops.jnn import detect_query_start

    contigs = {name: seq for name, seq in read_fasta(fasta_path)}
    truth: dict[str, tuple] = {}
    with open(truth_paf) as fp:
        for line in fp:
            f = line.rstrip("\n").split("\t")
            if not f or not f[0] or f[0] in truth:
                continue
            truth[f[0]] = (f[5], int(f[7]), int(f[8]))
    cases: list[ReadCase] = []
    sf = Slow5File(blow5_path)
    for rec in sf:
        t = truth.get(rec.read_id)
        if t is None:
            continue
        tid, ts, te = t
        pa = rec.to_pa()
        et = get_events(pa, rna=True)
        qs = detect_query_start(rec.raw_signal, pa, et.start)
        if qs < 0:
            qs = 50
        ev = et.mean[qs:].astype(np.float64)[::-1].copy()
        el = et.length[qs:].astype(np.float64)[::-1].copy()
        seq = contigs[tid]
        km = kmer_ranks(_seq_bytes(seq[ts:te]), k, warn_non_acgt=False)
        c = ReadCase(rec.read_id, ev, el, km.astype(np.int64), 0)
        c.tid = tid
        cases.append(c)
    sf.close()
    return cases


def _banded_pairs(cases, levels, band_frac, end_slack, device):
    """fit_model_banded's E-step of every case, batched on device: one
    (ev_idx, pos) per case."""
    ins = []
    for c in cases:
        ev_z = np.clip(_zscore(c.event_mean), -4, 4)
        nk = c.kmers.size
        n = ev_z.size
        km_exp = np.minimum((np.arange(n) * nk) // n, nk - 1)
        lvl = _zscore(levels[c.kmers])[km_exp]
        ins.append((ev_z.astype(np.float32), lvl.astype(np.float32), int(band_frac * n), km_exp))
    out = []
    for lo, hi in _batches([(ev.size, lvl.size) for ev, lvl, _, _ in ins]):
        part = ins[lo:hi]
        paths = train_dtw.banded_pairs([p[0] for p in part], [p[1] for p in part],
                                       [p[2] for p in part], end_slack, device)
        out += [(ev_idx, km_exp[pos_e]) for (ev_idx, pos_e), (_, _, _, km_exp) in zip(paths, part)]
    return out


def fit_model_banded(
    cases: list[ReadCase],
    k: int,
    iters: int = 9,
    ridge: float = 2.0,
    resid_shrink: float = 1.0,
    band_frac: float = 0.10,
    end_slack: int = 60,
    drift: bool = True,
    verbose: bool = True,
    device="cuda",
    timings: list | None = None,
) -> np.ndarray:
    """EM with a dwell-expanded, banded, endpoint-anchored E-step and a
    per-read affine+drift recalibration; observations collapsed to
    per-base weighted means. Both read endpoints anchor to the truth
    window (trimmed RNA cases), so the alignment cannot contract the way
    free subsequence DTW does under a weak model."""
    n_kmer = 4 ** k
    X = _build_features(k)
    F = X.shape[1]
    clock = _Clock(timings, device)
    levels = np.zeros(n_kmer)
    for it in range(iters):
        clock.start(it)
        rows_k, rows_t, rows_w = [], [], []
        if it > 0:
            with clock.estep():
                pairs = _banded_pairs(cases, levels, band_frac, end_slack, device)
        for ci, c in enumerate(cases):
            ev_z = np.clip(_zscore(c.event_mean), -4, 4)
            nk = c.kmers.size
            n = ev_z.size
            if it == 0:
                pos = np.minimum((np.arange(n) * nk) // n, nk - 1)
                ev_idx = np.arange(n)
            else:
                ev_idx, pos = pairs[ci]
            kr = c.kmers[pos]
            t = ev_z[ev_idx]
            w = np.sqrt(c.event_length[ev_idx])
            w /= w.mean()
            if it > 0:
                lv = levels[kr]
                if drift:
                    tau = (ev_idx - ev_idx.mean()) / max(ev_idx.std(), 1.0)
                    A = np.stack([lv, np.ones_like(lv), tau], 1)
                else:
                    A = np.stack([lv, np.ones_like(lv)], 1)
                keep = np.ones(lv.size, bool)
                a, b, cd = 1.0, 0.0, 0.0
                for _ in range(3):
                    coef, *_ = np.linalg.lstsq(
                        A[keep] * w[keep, None], t[keep] * w[keep], rcond=None
                    )
                    a, b = float(coef[0]), float(coef[1])
                    cd = float(coef[2]) if drift else 0.0
                    if abs(a) < 1e-3:
                        a, b, cd = 1.0, 0.0, 0.0
                        break
                    r = t - (a * lv + b + (cd * tau if drift else 0.0))
                    keep = np.abs(r) < 2.5 * max(r[keep].std(), 1e-9)
                t = (t - b - (cd * tau if drift else 0.0)) / a
            # collapse to per-kmer-position weighted means
            su = np.zeros(nk)
            wsum = np.zeros(nk)
            np.add.at(su, pos, w * t)
            np.add.at(wsum, pos, w)
            m = wsum > 0
            rows_k.append(c.kmers[m])
            rows_t.append(su[m] / wsum[m])
            rows_w.append(np.sqrt(wsum[m]))
        kr = np.concatenate(rows_k)
        tt = np.concatenate(rows_t)
        ww = np.concatenate(rows_w)
        Xo = X[kr] * ww[:, None]
        wcoef = np.linalg.solve(
            Xo.T @ X[kr] + ridge * np.eye(F, dtype=np.float64), Xo.T @ tt
        )
        pred = X @ wcoef
        rs = np.zeros(n_kmer)
        rc = np.zeros(n_kmer)
        np.add.at(rs, kr, ww * (tt - pred[kr]))
        np.add.at(rc, kr, ww)
        levels = _zscore(
            pred
            + rc / (rc + resid_shrink)
            * np.where(rc > 0, rs / np.maximum(rc, 1e-9), 0.0)
        )
        if verbose:
            sys.stderr.write(f"[train-banded] iter {it}: obs={tt.size}\n")
        clock.stop()
    return levels


def _inference_paths(levels, contig_windows, device):
    """finetune_inference_matched's E-step, batched: every window's query
    against its contig's z-scored track through the mapper's wavefront
    kernel, the windows of a batch over one concatenated layout of their
    distinct tracks (pad_tracks' resets keep tracks apart) and shorter
    queries shifted onto the emitted lane with start lanes, as the mapper
    sends its clipped reads. Each window's end column is the first
    argmin of its own columns of the last row; its path is the native
    backtrack over columns 0..end, which recomputes exactly the cells
    subsequence_cost gives there. One (px, py) per window."""
    out = []
    for lo in range(0, len(contig_windows), FINETUNE_BATCH):
        part = contig_windows[lo:lo + FINETUNE_BATCH]
        track_of, tracks, which = {}, [], []
        for _, km in part:
            key = km.tobytes()
            if key not in track_of:
                track_of[key] = len(tracks)
                tracks.append(_zscore(levels[km]).astype(np.float32))
            which.append(track_of[key])
        qs = [q.astype(np.float32) for q, _ in part]
        if max(q.size for q in qs) > FINETUNE_Q:
            raise ValueError(f"finetune: a query of {max(q.size for q in qs)} events exceeds "
                             f"the wavefront kernel's {FINETUNE_Q} rows")
        ref, reset, offsets = layout.pad_tracks(tracks)
        ypad, rspad, _ = layout.prepare_wavefront_inputs(ref, reset, FINETUNE_Q)
        qb, qlens, _ = layout.make_query_batch(qs, pad_q=FINETUNE_Q)
        lane = int(qlens.max()) - 1
        qb, start_lanes = layout.shift_queries_for_clip(qb, qlens, lane)
        scores = wfm.sdtw_wavefront(
            *(torch.from_numpy(a).to(device) for a in (qb, ypad, rspad)), lane,
            start_lanes=torch.from_numpy(start_lanes).to(device),
        )
        # each window's own columns of row qlen-1: scores[b, col + lane]
        width = max(t.size for t in tracks)
        cols = np.array([offsets[t] for t in which])[:, None] + lane + np.arange(width)[None, :]
        cols = np.minimum(cols, scores.shape[1] - 1)
        rows = torch.gather(scores, 1, torch.from_numpy(cols).to(scores.device)).cpu().numpy()
        for q, t, row in zip(qs, which, rows):
            lvl = tracks[t]
            endj = int(row[: lvl.size].argmin())
            path = native.subsequence_backtrack(q, lvl[: endj + 1], endj)
            if path is None:  # no native library: the same path in numpy
                path = subsequence_path(subsequence_cost(q, lvl[: endj + 1]), endj)
            out.append(path)
    return out


def finetune_inference_matched(
    levels: np.ndarray,
    contig_windows: list[tuple[np.ndarray, np.ndarray]],
    k: int,
    iters: int = 4,
    query_size: int = 500,
    ridge: float = 2.0,
    resid_shrink: float = 1.0,
    damp: float = 0.5,
    verbose: bool = True,
    device="cuda",
    timings: list | None = None,
) -> np.ndarray:
    """Final EM stage with the E-step matched to the *inference* geometry.

    The banded/anchored E-step (fit_model) learns from full-read
    alignments, but the mapper scores a fixed-size query slice against
    the 3'-truncated reference track with free start/end (subsequence
    DTW, sigfish.c:828-992). Re-aligning exactly that way and refitting
    sharpens the levels where the inference DP actually reads them --
    this stage took the RNA model from 5/8 to 8/8 correct on the test.sh
    gate.

    contig_windows[i] = (query events z (<=query_size, inference slice,
    already reversed), true-contig truncated kmer ranks) per case; a
    query may hold at most FINETUNE_Q events.
    """
    n_kmer = 4 ** k
    X = _build_features(k)
    F = X.shape[1]
    clock = _Clock(timings, device)
    levels = _zscore(levels.copy())
    for it in range(iters):
        clock.start(it)
        rows_k, rows_t, rows_w = [], [], []
        with clock.estep():
            paths = _inference_paths(levels, contig_windows, device)
        for (q, km), (px, py) in zip(contig_windows, paths):
            nk = km.size
            su = np.zeros(nk)
            cnt = np.zeros(nk)
            np.add.at(su, py, q[px].astype(np.float64))
            np.add.at(cnt, py, 1.0)
            m = cnt > 0
            rows_k.append(km[m])
            rows_t.append(su[m] / cnt[m])
            rows_w.append(np.sqrt(cnt[m]))
        kr = np.concatenate(rows_k)
        tt = np.concatenate(rows_t)
        ww = np.concatenate(rows_w)
        Xo = X[kr] * ww[:, None]
        wcoef = np.linalg.solve(
            Xo.T @ X[kr] + ridge * np.eye(F, dtype=np.float64), Xo.T @ tt
        )
        pred = X @ wcoef
        rs = np.zeros(n_kmer)
        rc = np.zeros(n_kmer)
        np.add.at(rs, kr, ww * (tt - pred[kr]))
        np.add.at(rc, kr, ww)
        new = _zscore(
            pred
            + rc / (rc + resid_shrink)
            * np.where(rc > 0, rs / np.maximum(rc, 1e-9), 0.0)
        )
        levels = _zscore((1.0 - damp) * levels + damp * new)
        if verbose:
            sys.stderr.write(f"[finetune] iter {it}: obs={tt.size}\n")
        clock.stop()
    return levels


def inference_windows(cases: list[ReadCase], fasta_path: str, k: int = 5,
                      query_size: int = 500) -> list[tuple[np.ndarray, np.ndarray]]:
    """The finetune stage's (query, k-mer ranks) windows of trimmed RNA
    cases, as the JAX package's main builds them: each read's last
    query_size events z-scored (the inference slice, already reversed),
    against the last min(750, L - k + 1) k-mers of its contig, the
    3'-end track gen_ref builds for RNA."""
    contigs = {n: s for n, s in read_fasta(fasta_path)}
    windows = []
    for c in cases:
        q = _zscore(c.event_mean[-query_size:]).astype(np.float32)
        seq = contigs[c.tid]
        L = len(seq)
        ref_len = min(750, L + 1 - k)
        start = L - ref_len - (k - 1)
        km = kmer_ranks(_seq_bytes(seq[start:]), k, warn_non_acgt=False)[:ref_len]
        windows.append((q, km.astype(np.int64)))
    return windows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m sigfish_tpu_torch.models.train_model",
        description="Retrain the builtin r9 DNA 6-mer and RNA 5-mer tables from sigfish's "
                    "test data and overwrite them in models/data/.",
    )
    ap.add_argument("--ref-dir", required=True,
                    help="sigfish's test data: sp1_dna.blow5, nCoV-2019.reference.fasta, "
                         "sp1_dna.minimap2.paf, sequin_rna.blow5, rnasequin_sequences_2.4.fa "
                         "and sequin_rna.minimap2.paf")
    ap.add_argument("--device", default="cuda",
                    help="where the E-step runs (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    ref_dir, device = args.ref_dir, args.device
    sys.stderr.write("=== DNA r9 6-mer from sp1_dna ===\n")
    dna_cases = load_cases(
        f"{ref_dir}/sp1_dna.blow5",
        f"{ref_dir}/nCoV-2019.reference.fasta",
        f"{ref_dir}/sp1_dna.minimap2.paf",
        rna=False,
        k=6,
    )
    sys.stderr.write(f"[train] {len(dna_cases)} DNA training reads\n")
    dna_model = fit_model(dna_cases, k=6, device=device)
    p = save_builtin_model(MODEL_ID_DNA_R9, dna_model)
    sys.stderr.write(f"[train] wrote {p}\n")

    sys.stderr.write("=== RNA r9 5-mer from sequin_rna ===\n")
    rna_fasta = f"{ref_dir}/rnasequin_sequences_2.4.fa"
    rna_cases = load_cases_trimmed_rna(
        f"{ref_dir}/sequin_rna.blow5",
        rna_fasta,
        f"{ref_dir}/sequin_rna.minimap2.paf",
        k=5,
    )
    sys.stderr.write(f"[train] {len(rna_cases)} RNA training reads\n")
    levels = fit_model_banded(rna_cases, k=5, device=device)

    # final stage: E-step matched to the inference geometry (query slice
    # vs 3'-truncated track, free start/end)
    levels = finetune_inference_matched(levels, inference_windows(rna_cases, rna_fasta),
                                        k=5, device=device)
    rna_model = PoreModel(
        kmer_size=5,
        level_mean=(levels * 10.0 + 100.0).astype(np.float32),
        level_stdv=np.full(1024, 2.0, dtype=np.float32),
    )
    p = save_builtin_model(MODEL_ID_RNA_R9, rna_model)
    sys.stderr.write(f"[train] wrote {p}\n")


if __name__ == "__main__":
    main()
