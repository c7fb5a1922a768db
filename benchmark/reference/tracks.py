"""The plain reference's event tracks: each contig's expected pore-model
levels, z-scored (sigfish src/genref.c, src/ref.h).

The k-mer tables in data/ are copies of the mapper's builtin R9 tables
(level means of each k-mer, the first base most significant). DNA maps
to every contig's forward track and its reverse complement's; direct RNA
to each transcript's 3' end, min(1.5 q, L + 1 - k) k-mers, which starts
L - that - (k - 1) bases in.
"""

from __future__ import annotations

import os

import numpy as np

from .host import zscore

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TABLES = {("r9", False): "r9.4_dna_6mer.npz", ("r9", True): "r9.4_rna_5mer.npz"}

_RANK = np.zeros(256, np.int64)
for _b, _r in zip(b"ACGTacgt", (0, 1, 2, 3, 0, 1, 2, 3)):
    _RANK[_b] = _r
_COMP = np.full(256, ord("T"), np.uint8)
for _b, _c in zip(b"ACGTacgt", b"TGCATGCA"):
    _COMP[_b] = _c


def levels(pore: str, rna: bool) -> tuple[np.ndarray, int]:
    """(level mean of each k-mer rank, k) of a builtin table."""
    z = np.load(os.path.join(_DATA, TABLES[(pore, rna)]))
    return z["level_mean"].astype(np.float32), int(z["kmer_size"])


def kmer_ranks(seq: bytes, k: int) -> np.ndarray:
    """Rank of each k-mer, the first base most significant; a base that
    is not ACGT ranks as A (ref.h:13-41)."""
    r = _RANK[np.frombuffer(seq, np.uint8)]
    n = r.size + 1 - k
    acc = np.zeros(max(n, 0), np.int64)
    for i in range(k):
        acc = acc * 4 + r[i : i + n]
    return acc


def reverse_complement(seq: bytes) -> bytes:
    """ref.h:69-76: a base that is not ACGT complements to T."""
    return _COMP[np.frombuffer(seq, np.uint8)][::-1].tobytes()


def make_tracks(contigs: list[tuple[str, str]], pore: str, rna: bool, qsize: int) -> dict:
    """The reference tracks in the mapper's order (contig by contig, + then
    - for DNA): a list of (contig index, strand, float32 levels), and per
    contig its name, length in bases, track length and start offset."""
    lv, k = levels(pore, rna)
    tracks, names, lengths, tlens, offsets = [], [], [], [], []
    for cid, (name, seq) in enumerate(contigs):
        s = seq.encode("ascii")
        L = len(s)
        n = L + 1 - k if not rna else min(int(qsize * 1.5), L + 1 - k)
        off = 0
        if rna:
            off = L - n - (k - 1)
            tracks.append((cid, "+", zscore(lv[kmer_ranks(s[off:], k)[:n]])))
        else:
            tracks.append((cid, "+", zscore(lv[kmer_ranks(s, k)[:n]])))
            tracks.append((cid, "-", zscore(lv[kmer_ranks(reverse_complement(s), k)[:n]])))
        names.append(name)
        lengths.append(L)
        tlens.append(n)
        offsets.append(off)
    return dict(tracks=tracks, names=names, lengths=lengths, track_lengths=tlens,
                offsets=offsets)
