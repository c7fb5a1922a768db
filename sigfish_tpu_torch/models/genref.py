"""Reference synthesis: FASTA -> per-contig expected event-level tracks.

ref: sigfish src/genref.c, src/ref.h.

Semantics preserved:
  - k-mer rank: first base most significant, 2-bit packed; non-ACGT ranks
    as A with a warning (ref.h:13-41).
  - reverse complement maps non-ACGT to 'T' (ref.h:43-76) -- note the
    asymmetry: 'N' on the forward strand ranks as A, but becomes 'T' (rank
    3) on the reverse track. Preserved exactly.
  - DNA / --full-ref: track length = L+1-k over the full contig; DNA also
    gets a reverse-complement track (genref.c:129,148-164).
  - RNA default: track truncated to min(1.5*query_size, L+1-k) events
    taken from the 3' end, recording ref_st_offset = L - ref_len - (k-1)
    for output-coordinate restoration (genref.c:133-136,184-198). With
    --from-end the 5' end is used instead and offset stays 0
    (genref.c:186-188).
  - --invert RNA: the *reference* events are written reversed from the 3'
    end (genref.c:166-181; reference marks this untested).
  - each track z-scored independently, population variance, float32
    (genref.c:23-47,210-218).

All of it vectorized numpy; k passes of shift-add build the rank array.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.fasta import read_fasta
from ..utils import log_warning, log_verbose
from .pore_model import PoreModel

_RANK_LUT = np.zeros(256, dtype=np.uint32)  # non-ACGT -> 0 (A)
for _b, _r in (("A", 0), ("a", 0), ("C", 1), ("c", 1), ("G", 2), ("g", 2), ("T", 3), ("t", 3)):
    _RANK_LUT[ord(_b)] = _r

_ACGT_MASK = np.zeros(256, dtype=bool)
for _b in "ACGTacgt":
    _ACGT_MASK[ord(_b)] = True

_COMP_LUT = np.full(256, ord("T"), dtype=np.uint8)  # default case -> 'T' (ref.h:62-64)
for _b, _c in (("A", "T"), ("a", "T"), ("C", "G"), ("c", "G"), ("G", "C"), ("g", "C"), ("T", "A"), ("t", "A")):
    _COMP_LUT[ord(_b)] = ord(_c)


def _seq_bytes(seq: str) -> np.ndarray:
    return np.frombuffer(seq.encode("ascii"), dtype=np.uint8)


def reverse_complement(seq: str) -> str:
    """ref: ref.h:69-76 (non-ACGT complements to 'T')."""
    b = _seq_bytes(seq)
    return _COMP_LUT[b][::-1].tobytes().decode("ascii")


def kmer_ranks(seq_bytes: np.ndarray, k: int, warn_non_acgt: bool = True) -> np.ndarray:
    """Rank of every k-mer start position; length len(seq)+1-k.

    ref: get_kmer_rank ref.h:30-41 (first base most significant).
    """
    n = seq_bytes.size + 1 - k
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    if warn_non_acgt:
        bad = ~_ACGT_MASK[seq_bytes]
        if bad.any():
            log_warning(
                f"{int(bad.sum())} non-ACGT bases found; ranked as A"
            )
    r = _RANK_LUT[seq_bytes]
    acc = np.zeros(n, dtype=np.uint32)
    for i in range(k):
        acc = (acc << np.uint32(2)) + r[i : i + n]
    return acc


def zscore_f32(x: np.ndarray) -> np.ndarray:
    """Population z-score in float32. ref: normalise genref.c:23-47.

    Uses the native sequential-f32 accumulator when built: the reference
    accumulates mean/var in a scalar f32 chain, and numpy's pairwise
    summation rounds differently on long tracks (visible as %.2f-level
    DP score drift on the 29,898-event nCoV track)."""
    from .. import native

    x = np.ascontiguousarray(x, np.float32)
    out = x.copy()
    if native.zscore_inplace(out):
        return out
    m = np.float32(x.mean(dtype=np.float32))
    v = np.float32(np.mean((x - m) * (x - m), dtype=np.float32))
    s = np.float32(np.sqrt(v))
    return (x - m) / s


@dataclass
class RefSynth:
    """Synthesized reference. ref: refsynth_t sigfish.h:90-99."""

    num_ref: int = 0
    ref_names: list[str] = field(default_factory=list)
    ref_lengths: list[int] = field(default_factory=list)        # event-track lengths
    ref_seq_lengths: list[int] = field(default_factory=list)    # FASTA base lengths
    ref_st_offset: list[int] = field(default_factory=list)
    forward: list[np.ndarray] = field(default_factory=list)     # float32 tracks
    reverse: list[np.ndarray] | None = None                     # DNA only


def gen_ref(
    fasta_path: str,
    model: PoreModel,
    rna: bool = False,
    full_ref: bool = False,
    from_end: bool = False,
    invert: bool = False,
    query_size: int = 250,
) -> RefSynth:
    """ref: gen_ref genref.c:86-241."""
    k = model.kmer_size
    levels = model.level_mean
    ref = RefSynth()
    ref.reverse = None if rna else []

    for name, seq in read_fasta(fasta_path):
        L = len(seq)
        if not rna or full_ref:
            ref_len = L + 1 - k
        else:
            rlen_heu = int(query_size * 1.5)
            ref_len = min(rlen_heu, L + 1 - k)
            log_verbose(
                f"Only {ref_len} bases of {L} bases in reference sequence will be used"
            ) if ref_len < L + 1 - k else None
        if ref_len <= 0:
            log_warning(f"contig {name} shorter than k; skipped track is empty")
            ref_len = max(ref_len, 0)

        st_offset = 0
        sb = _seq_bytes(seq)

        if not rna:
            ranks = kmer_ranks(sb, k)
            fwd = levels[ranks[:ref_len]].copy()
            rc = _seq_bytes(reverse_complement(seq))
            ranks_rc = kmer_ranks(rc, k, warn_non_acgt=False)
            rev = levels[ranks_rc[:ref_len]].copy()
        else:
            rev = None
            if invert:
                # ref genref.c:166-181 ("not tested recently" upstream)
                start = L - ref_len - (k - 1)
                sub = sb[start:]
                ranks = kmer_ranks(sub, k)[:ref_len]
                fwd = levels[ranks][::-1].copy()
            else:
                if from_end:
                    start = 0  # 5' end of the reference (genref.c:186-188)
                else:
                    start = L - ref_len - (k - 1)
                    st_offset = start
                sub = sb[start:]
                ranks = kmer_ranks(sub, k)[:ref_len]
                fwd = levels[ranks].copy()

        fwd = zscore_f32(fwd) if ref_len > 0 else fwd.astype(np.float32)
        if rev is not None:
            rev = zscore_f32(rev) if ref_len > 0 else rev.astype(np.float32)
            ref.reverse.append(rev)

        ref.ref_names.append(name)
        ref.ref_lengths.append(ref_len)
        ref.ref_seq_lengths.append(L)
        ref.ref_st_offset.append(st_offset)
        ref.forward.append(fwd)
        ref.num_ref += 1

    return ref
