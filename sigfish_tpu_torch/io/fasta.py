"""FASTA reader (multi-line, gzip-transparent).

ref: sigfish uses klib kseq (src/genref.c:18-19, src/kseq.h) to stream
contigs; here a simple buffered parser returning (name, sequence) pairs.
Sequence case and non-ACGT bases are preserved -- downstream k-mer ranking
handles them exactly like the reference (ref src/ref.h:13-41).
"""

from __future__ import annotations

import gzip
from typing import Iterator, Tuple


def _open_maybe_gz(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, seq). Name is the first whitespace-delimited token,
    matching kseq semantics (seq->name.s). FASTQ input is accepted the
    way kseq accepts it: after the '+' separator, quality bytes are
    consumed until their length reaches the sequence length (kseq.h
    ks_getuntil loop) -- quality lines starting with '@' or '>' are NOT
    record boundaries."""
    name = None
    chunks: list[str] = []
    seq_len = 0
    qual_left = 0
    with _open_maybe_gz(path) as fp:
        for line in fp:
            line = line.rstrip("\r\n")
            if qual_left > 0:
                qual_left -= len(line)
                continue
            if not line:
                continue
            if line.startswith(">") or line.startswith("@"):
                if name is not None:
                    yield name, "".join(chunks)
                toks = line[1:].split()
                name = toks[0] if toks else ""  # '> ' yields an empty name
                chunks = []
            elif line.startswith("+") and name is not None and chunks:
                # FASTQ quality section follows, same byte count as seq
                seq_len = sum(len(c) for c in chunks)
                qual_left = seq_len
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)
