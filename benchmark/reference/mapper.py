"""The plain reference mapper: a read's raw samples and the contigs in,
its PAF line (or none) out, in sigfish's semantics.

It imports nothing of the mapper under test and takes nothing it made:
the signals and sequences come from the benchmark's generator, the k-mer
tables from data/.
"""

from __future__ import annotations

import numpy as np
import torch

from . import host, paf, sdtw, tracks


def map_reads(reads: list[dict], contigs: list[tuple[str, str]], cfg: dict,
              device: str = "cuda", dtype=torch.float32) -> tuple[dict, dict]:
    """{read id: its PAF line, or None where the read is ignored or maps
    nowhere} for `reads` (dicts with read_id, raw, digitisation, offset,
    range), and counts of what was done. cfg: the configuration's
    `mapper` section (rna, prefix_size, query_size, pore). dtype: the
    DP's precision (float32; a lower one is the control)."""
    rna, qsize = cfg["rna"], cfg["query_size"]
    qs = host.queries(reads, rna, cfg["prefix_size"], qsize)
    ref = tracks.make_tracks(contigs, cfg["pore"], rna, qsize)
    live = [i for i, q in enumerate(qs) if not q.skip]
    out = {r["read_id"]: None for r in reads}
    redone = 0
    if live:
        rows, redone = sdtw.last_rows([qs[i].query for i in live], [t for _, _, t in ref["tracks"]],
                                      device=device, dtype=dtype)
        for i, row in zip(live, rows):
            out[reads[i]["read_id"]] = _line(reads[i], qs[i], row, ref)
    return out, dict(reads=len(reads), live=len(live), redone_chunks=redone)


def _line(read: dict, q: host.Query, rows: list[np.ndarray], ref: dict) -> str | None:
    qlen = q.query.size
    scores, where = [], []
    for t, row in enumerate(rows):
        mins, args = paf.window_minima(row, qlen)
        scores.append(mins)
        where.extend((t, int(a)) for a in args)
    scores = np.concatenate(scores).astype(np.float32)
    best, d2 = paf.best_two(scores)
    d1 = float(scores[best])
    if d1 >= 1e37:
        return None
    if d2 >= 1e37:
        d2 = float("inf")
    t, pos_end = where[best]
    cid, strand, track = ref["tracks"][t]
    pos_st = sdtw.path_start(q.query, track, pos_end)
    if strand == "-":
        rlen = ref["track_lengths"][cid]
        pos_st, pos_end = rlen - pos_end, rlen - pos_st
    off = ref["offsets"][cid]
    ev = q.events
    last = q.qend - 1
    return paf.paf_line(
        read["read_id"], int(read["raw"].size), int(ev.start[q.qstart]),
        int(ev.start[last]) + int(np.float32(ev.length[last])), strand, ref["names"][cid],
        ref["lengths"][cid], pos_st + off, pos_end + off, d1, d2, last - q.qstart,
    )
