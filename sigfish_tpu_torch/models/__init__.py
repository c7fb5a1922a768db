from .pore_model import (
    PoreModel,
    load_builtin_model,
    read_model_tsv,
    write_model_tsv,
    MODEL_ID_DNA_R9,
    MODEL_ID_RNA_R9,
    MODEL_ID_DNA_R10,
    MODEL_ID_RNA_RNA004,
)
from .genref import RefSynth, gen_ref, kmer_ranks, reverse_complement
