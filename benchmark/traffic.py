"""The benchmark's one input generator: a configuration's contigs and a
traffic mix's reads, drawn from a seed, written as the FASTA and the
BLOW5 file that the mapper reads, and kept in memory for the reference.

Reads are walks through the pore model's levels (the R9 tables of
reference/data/), held each level for a random dwell, with Gaussian noise,
quantised to 16-bit ADC counts (digitisation 8192, offset 10, range 1400).
A DNA read starts anywhere on either strand of a contig, and its length
in bases (one level a base) is log-normal with the mix's mean and sigma;
reads under `clipped_below` levels are marked short (their queries are
clipped). A direct-RNA read is an adaptor stretch, a polyA stretch, then
a transcript's 3' end walked towards 5'; which RNA reads are short or
lack an adaptor follows from the read's index, the same for every seed.
The seed decides the sequences, the lengths, where each read comes from
and its dwells.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .blow5 import Writer
from .reference.tracks import kmer_ranks, levels, reverse_complement

DIGITISATION, OFFSET, RANGE = 8192.0, 10.0, 1400.0


def _bases(rng: np.random.Generator, n: int) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes().decode("ascii")


def _adc(pa: np.ndarray) -> np.ndarray:
    """pA (float32) to ADC counts, rounded and clamped to 16 bits."""
    x = np.rint(pa * np.float32(DIGITISATION / RANGE) - np.float32(OFFSET))
    return np.clip(x, -32000, 32000).astype(np.int16)


def contigs(ref: dict, rng: np.random.Generator) -> list[tuple[str, str]]:
    """The configuration's contigs: `genome` of `bases` random bases, or
    `transcripts`, `count` of them with lengths uniform in `length`."""
    if ref["kind"] == "genome":
        return [(ref["name"], _bases(rng, ref["bases"]))]
    lo, hi = ref["length"]
    return [(f"tx{j:03d}", _bases(rng, int(rng.integers(lo, hi)))) for j in range(ref["count"])]


def _signals(levels: list[np.ndarray], mix: dict, rng, lead: list[np.ndarray] | None = None) -> list[np.ndarray]:
    """Each read's ADC samples: its levels held for dwells drawn from
    mix["dwell"], plus noise of sd mix["noise_pa"], after its `lead`
    samples (pA) where given. The draws are made for all reads at once."""
    n_lv = np.array([lv.size for lv in levels])
    dwell = rng.integers(*mix["dwell"], size=int(n_lv.sum()))
    pa = np.repeat(np.concatenate(levels), dwell)
    pa += np.float32(mix["noise_pa"]) * rng.standard_normal(pa.size, dtype=np.float32)
    ends = np.cumsum(np.add.reduceat(dwell, np.concatenate([[0], np.cumsum(n_lv)[:-1]])))
    body = np.split(_adc(pa), ends[:-1])
    if lead is None:
        return body
    return [np.concatenate([_adc(a), b]) for a, b in zip(lead, body)]


def dna_lengths(mix: dict, n: int, rng, most: int) -> np.ndarray:
    """Each read's levels: log-normal with mean mix["bases"]["mean"] and
    sigma mix["bases"]["sigma_ln"] of the log, rounded, at least
    mix["bases"]["min"] and at most `most`."""
    b = mix["bases"]
    mu = np.log(b["mean"]) - 0.5 * b["sigma_ln"] ** 2
    return np.clip(np.rint(rng.lognormal(mu, b["sigma_ln"], n)).astype(np.int64), b["min"], most)


def dna_reads(seqs: list[tuple[str, str]], mix: dict, n: int, rng) -> list[dict]:
    lv, k = levels("r9", False)
    s = seqs[0][1].encode("ascii")
    rc = reverse_complement(s)
    n_lv = dna_lengths(mix, n, rng, len(s) - k)
    short = n_lv < mix["clipped_below"]
    minus = rng.random(n) < 0.5
    at = rng.integers(0, len(s) - n_lv - k + 2)  # s[at : at + n_lv + k - 1] fits
    lev = [lv[kmer_ranks((rc if m else s)[a : a + c + k - 1], k)] for m, a, c in zip(minus, at, n_lv)]
    return [dict(read_id=f"read{i:05d}", raw=raw, short=bool(short[i]), no_adaptor=False)
            for i, raw in enumerate(_signals(lev, mix, rng))]


def rna_reads(seqs: list[tuple[str, str]], mix: dict, n: int, rng) -> list[dict]:
    lv, k = levels("r9", True)
    idx = np.arange(n)
    short = idx % mix["short_every"] == mix["short_at"]
    bare = idx % mix["no_adaptor_every"] == mix["no_adaptor_at"]
    pick = rng.integers(len(seqs), size=n)
    lev = []
    for j, sh in zip(pick, short):
        seq = seqs[j][1]
        n_kmer = len(seq) + 1 - k
        walk = min(n_kmer, mix["short_levels"] if sh else mix["levels"])
        lev.append(lv[kmer_ranks(seq[n_kmer - walk :].encode("ascii"), k)][::-1])
    n_ad = np.where(bare, 0, rng.integers(*mix["adaptor"], size=n))
    n_pa = np.where(bare, 0, rng.integers(*mix["polya"], size=n))
    z = rng.standard_normal(int((n_ad + n_pa).sum()), dtype=np.float32)
    cut = np.cumsum(np.stack([n_ad, n_pa], 1).ravel())[:-1]
    parts = np.split(z, cut)
    (am, asd), (pm, psd) = mix["adaptor_pa"], mix["polya_pa"]
    am, asd, pm, psd = (np.float32(v) for v in (am, asd, pm, psd))
    lead = [np.concatenate([am + asd * parts[2 * i], pm + psd * parts[2 * i + 1]]) for i in range(n)]
    return [dict(read_id=f"read{i:05d}", raw=raw, short=bool(short[i]), no_adaptor=bool(bare[i]))
            for i, raw in enumerate(_signals(lev, mix, rng, lead))]


def generate(config: dict, traffic: dict, seed: int, out_dir: str) -> dict:
    """Write out_dir/ref.fa and out_dir/reads.blow5 for one seed. Returns
    the paths, the contigs and the reads (read_id, raw, digitisation,
    offset, range, short, no_adaptor), in file order."""
    rng = np.random.default_rng(seed & (2**64 - 1))  # any whole number, negative too
    seqs = contigs(config["reference"], rng)
    rna = config["mapper"]["rna"]
    mix = traffic["rna" if rna else "dna"]
    reads = (rna_reads if rna else dna_reads)(seqs, mix, traffic["reads"], rng)
    os.makedirs(out_dir, exist_ok=True)
    fa = os.path.join(out_dir, "ref.fa")
    with open(fa, "w") as f:
        for name, seq in seqs:
            f.write(f">{name}\n")
            f.writelines(seq[o : o + 80] + "\n" for o in range(0, len(seq), 80))
    bl = os.path.join(out_dir, "reads.blow5")
    w = Writer(bl, config["header"], traffic["record_press"], traffic["signal_press"])
    def record(r: dict) -> bytes:
        return w.wrap(w.body(r["read_id"], r["raw"], DIGITISATION, OFFSET, RANGE, mix["sampling_rate"]))

    try:
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            for r, blob in zip(reads, pool.map(record, reads)):
                r.update(digitisation=DIGITISATION, offset=OFFSET, range=RANGE)
                w.append(blob)
    finally:
        w.close()
    return dict(fasta=fa, blow5=bl, contigs=seqs, reads=reads)
