"""PAF / SAM output formatting with printf parity.

ref: sigfish src/sigfish.c:628-826 (paf_str, sam_str, r2qevent_map_to_ss,
aln_to_str), src/dtw_main.c:118-123 (SAM header).

Quirks preserved on purpose:
  - the `query_size` used in the residue formula and the SAM cigar is
    qend-1-qstart (one less than the aligned event count): aln_to_str
    computes it from the *inclusive* end event index (sigfish.c:800-807).
  - d2 prints as `inf` when fewer than two candidates exist
    (sigfish.c:655; C printf %.2f of INFINITY).
  - rounding is C round() (half away from zero), not banker's.
  - SAM si: swaps ref start/end for RNA (sigfish.c:782-785).
"""

from __future__ import annotations

import math

import numpy as np


class DegenerateAlignment(Exception):
    """An alignment state on which the C reference aborts (assert).

    Raised by the ss-tag builder for maps the reference's asserts at
    sigfish.c:669,677,693 + the f5c-derived move-string invariants
    reject; callers degrade gracefully instead of crashing the run.
    """


def _c_round(x: float) -> int:
    return int(math.copysign(math.floor(abs(x) + 0.5), x))


def _c_round_i32(x: float) -> int:
    """(int)round(x) with x86-64 cast semantics: nan/inf/out-of-range
    doubles convert to INT_MIN (cvttsd2si "integer indefinite"). The
    reference hits this when query_size == 0 makes residue inf
    (sigfish.c:635 with qend-1 == qstart)."""
    if math.isnan(x) or math.isinf(x):
        return -2147483648
    r = math.copysign(math.floor(abs(x) + 0.5), x)
    if not -2147483648.0 <= r <= 2147483647.0:
        return -2147483648
    return int(r)


def _fmt_f2(x: float) -> str:
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    if math.isnan(x):
        return "nan" if not math.copysign(1, x) < 0 else "-nan"
    return f"{x:.2f}"


def paf_line(
    read_id: str,
    len_raw_signal: int,
    start_raw_idx: int,
    end_raw_idx: int,
    strand: str,
    rname: str,
    rlength: int,
    pos_st: int,
    pos_end: int,
    score: float,
    score2: float,
    mapq: int,
    query_size: int,
) -> str:
    """ref: paf_str sigfish.c:628-660.

    residue/block_len are FLOAT (f32) arithmetic in the reference
    (sigfish.c:634-635): emulate the exact op order
    block_len - (score*block_len)/query_size in np.float32, including
    query_size == 0 -> inf -> (int)round wrap (see _c_round_i32).
    """
    with np.errstate(divide="ignore", invalid="ignore"):
        block_len = np.float32(pos_end - pos_st)
        residue = block_len - np.float32(score) * block_len / np.float32(
            query_size
        )
    return (
        f"{read_id}\t{len_raw_signal}\t{start_raw_idx}\t{end_raw_idx}\t"
        f"{strand}\t{rname}\t{rlength}\t{pos_st}\t{pos_end}\t"
        f"{_c_round_i32(float(residue))}\t{_c_round_i32(float(block_len))}\t{mapq}\t"
        f"tp:A:P\td1:f:{_fmt_f2(score)}\td2:f:{_fmt_f2(score2)}\n"
    )


def r2qevent_map_to_ss(
    r2q_map: np.ndarray,
    qstart: int,
    event_start: np.ndarray,
    event_length: np.ndarray,
    rna: bool,
) -> str:
    """Move-string (f5c-resquiggle style) from the ref->query-event map.

    ref: r2qevent_map_to_ss sigfish.c:663-768. `r2q_map` is int32
    (n_kmers, 2) of (first,last) query-event per reference position, -1
    for deletions; mutated like the reference (RNA double mirror).
    """
    m = r2q_map.copy()
    n_kmers = m.shape[0]

    if rna:
        end = int(m[n_kmers - 1, 1])
        if end == -1:
            # Degenerate map (last reference position unmatched). The C
            # binary aborts here (assert at sigfish.c:669); we degrade
            # gracefully per the robustness contract (PARITY.md).
            raise DegenerateAlignment("RNA r2q map ends in a deletion")
        real = m[:, 0] != -1
        m[real, 0] = end - m[real, 0]
        m[real, 1] = end - m[real, 1]

    real = m[:, 0] != -1
    m[real] += qstart

    if rna:
        m = m[::-1].copy()
        m = m[:, ::-1].copy()

    parts: list[str] = []
    ci = 0
    d = 0
    ff = True
    for j in range(n_kmers):
        s_ev = int(m[j, 0])
        e_ev = int(m[j, 1])
        if s_ev == -1:
            if not ff:
                d += 1
            continue
        sig_start = int(event_start[s_ev])
        if ff:
            ff = False
        sig_end = int(event_start[e_ev]) + int(np.float32(event_length[e_ev]))
        if d > 0:
            parts.append(f"{d}D")
            d = 0
        if j == 0:
            ci = sig_start
        mi = sig_start - ci
        ci += mi
        if mi < 0:
            raise DegenerateAlignment("non-monotonic signal coordinates")
        if mi:
            parts.append(f"{mi}I")
        mi = sig_end - sig_start
        ci += mi
        if mi < 0:
            raise DegenerateAlignment("non-monotonic signal coordinates")
        if mi:
            parts.append(f"{mi},")
    return "".join(parts)


def sam_line(
    read_id: str,
    strand: str,
    rname: str,
    pos_st: int,
    pos_end: int,
    mapq: int,
    qlen: int,
    start_raw_idx: int,
    end_raw_idx: int,
    qstart: int,
    r2q_map: np.ndarray,
    event_start: np.ndarray,
    event_length: np.ndarray,
    rna: bool,
) -> str:
    """ref: sam_str sigfish.c:770-794."""
    flag = 0 if strand == "+" else 16
    post_st = pos_end if rna else pos_st
    post_end = pos_st if rna else pos_end
    try:
        ss = r2qevent_map_to_ss(r2q_map, qstart, event_start, event_length, rna)
    except DegenerateAlignment as e:
        # The C binary aborts on these maps; emit the line with an empty
        # ss tag instead (PARITY.md "Robustness beyond the reference").
        from .utils.log import log_warning

        log_warning(f"degenerate alignment for {read_id}: {e}; ss tag omitted")
        ss = ""
    return (
        f"{read_id}\t{flag}\t{rname}\t{pos_st + 1}\t{mapq}\t"
        f"{qlen}M\t*\t0\t0\t*\t*\t"
        f"si:Z:{start_raw_idx},{end_raw_idx},{post_st},{post_end}\t"
        f"ss:Z:{ss}\n"
    )


def sam_header(ref_names: list[str], ref_lengths: list[int], version: str) -> str:
    """ref: sam_hdr_wr dtw_main.c:118-123 (LN is the *event track* length,
    a reference quirk preserved)."""
    lines = [f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(ref_names, ref_lengths)]
    lines.append(f"@PG\tID:sigfish\tPN:sigfish\tVN:{version}\n")
    return "".join(lines)
