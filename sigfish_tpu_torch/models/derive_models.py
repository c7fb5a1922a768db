"""Derive 9-mer tables (DNA R10, RNA004) from the trained r9 tables.

The upstream 9-mer builtin tables (src/model.h blobs) are unavailable in
this environment (stripped + no egress), and the in-repo test data
contains no R10/RNA004 reads to learn from. These derived tables make
the chemistries *runnable* out of the box: a 9-mer's level is the mean
of its sliding r9 k-mer levels (4 x 6-mers for DNA, 5 x 5-mers for RNA)
-- the standard compositional approximation. Relative level structure is
preserved (all consumers z-score, genref.c:210-218), but accuracy on
real R10/RNA004 data is unvalidated; use --kmer-model with a real ONT
table when one is available.

Run: python -m sigfish_tpu.models.derive_models
"""

from __future__ import annotations

import sys

import numpy as np

from .pore_model import (
    MODEL_ID_DNA_R10,
    MODEL_ID_DNA_R9,
    MODEL_ID_RNA_R9,
    MODEL_ID_RNA_RNA004,
    PoreModel,
    load_builtin_model,
    save_builtin_model,
)


def derive_9mer(base: PoreModel) -> PoreModel:
    k = base.kmer_size
    n9 = 4 ** 9
    nwin = 9 - k + 1
    ranks9 = np.arange(n9, dtype=np.int64)
    acc = np.zeros(n9, dtype=np.float64)
    mask = (1 << (2 * k)) - 1
    for w in range(nwin):
        # k-mer starting at position w inside the 9-mer (first base most
        # significant): shift right by 2*(9-k-w) and mask
        sub = (ranks9 >> (2 * (9 - k - w))) & mask
        acc += base.level_mean.astype(np.float64)[sub]
    lvl = (acc / nwin).astype(np.float32)
    return PoreModel(
        kmer_size=9,
        level_mean=lvl,
        level_stdv=np.full(n9, 2.0, dtype=np.float32),
    )


def main() -> None:
    dna = load_builtin_model(MODEL_ID_DNA_R9)
    p = save_builtin_model(MODEL_ID_DNA_R10, derive_9mer(dna))
    sys.stderr.write(f"wrote {p}\n")
    rna = load_builtin_model(MODEL_ID_RNA_R9)
    p = save_builtin_model(MODEL_ID_RNA_RNA004, derive_9mer(rna))
    sys.stderr.write(f"wrote {p}\n")


if __name__ == "__main__":
    main()
