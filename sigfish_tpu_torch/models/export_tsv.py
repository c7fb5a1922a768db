"""Export the builtin trained models as nanopolish-style TSVs.

Usable as `--kmer-model` input for both this package and the C
reference's read_model() (src/model.c:38-120, sequential rank order with
a `#k` size header) -- the basis of the oracle parity harness
(scripts/parity_oracle.sh).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .pore_model import (
    MODEL_ID_DNA_R9,
    MODEL_ID_DNA_R10,
    MODEL_ID_RNA_R9,
    MODEL_ID_RNA_RNA004,
    load_builtin_model,
)

_BASES = "ACGT"


def write_tsv(path: str, kmer_size: int, level_mean, level_stdv) -> None:
    with open(path, "w") as f:
        f.write(f"#k\t{kmer_size}\n")
        for r in range(4 ** kmer_size):
            km = "".join(
                _BASES[(r >> (2 * (kmer_size - 1 - i))) & 3]
                for i in range(kmer_size)
            )
            sd = float(level_stdv[r])
            if sd <= 0:
                sd = 1.0
            f.write(f"{km}\t{float(level_mean[r]):.9g}\t{sd:.9g}\t0.0\t0.0\n")


def main(out_dir: str = "/tmp/sigfish_models") -> None:
    os.makedirs(out_dir, exist_ok=True)
    for mid, name in (
        (MODEL_ID_DNA_R9, "r9.4_dna_6mer"),
        (MODEL_ID_RNA_R9, "r9.4_rna_5mer"),
        (MODEL_ID_DNA_R10, "r10.4_dna_9mer"),
        (MODEL_ID_RNA_RNA004, "rna004_rna_9mer"),
    ):
        m = load_builtin_model(mid)
        p = os.path.join(out_dir, f"{name}.tsv")
        write_tsv(p, m.kmer_size, m.level_mean, m.level_stdv)
        sys.stderr.write(f"wrote {p}\n")


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))
