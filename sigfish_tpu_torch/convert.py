"""Static state carried across from the JAX package.

A `Core` holds two things that play the part of a model's weights and
state: the pore model (k-mer level table) and the synthesized reference
laid out as one concatenated, window-aligned track (values, reset flags,
track offsets and sizes, and which contig and strand each track is).
`core_state_from_numpy` builds the port's `CoreState` from those arrays as
a `sigfish_tpu` `Core` holds them (`model.level_mean`, `model.level_stdv`,
`kmer_size`, `ref_cat`, `reset`, `track_offsets`, `track_sizes`,
`track_meta`), so both packages can be fed identical state; the port's
`Core` takes such a state in place of building its own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .models.pore_model import PoreModel


@dataclass
class CoreState:
    """The pore model and the concatenated reference track layout."""

    model: PoreModel
    ref_cat: np.ndarray                 # (R,) f32 concatenated tracks, PAD between
    reset: np.ndarray                   # (R,) bool, True at each segment's first column
    offsets: np.ndarray                 # (T+1,) i64 track starts, then the total
    track_sizes: list[int]              # (T,) real (unpadded) track lengths
    track_meta: list[tuple[int, str]]   # (T,) (contig id, strand)


def core_state_from_numpy(
    level_mean: np.ndarray,
    level_stdv: np.ndarray,
    kmer_size: int,
    ref_cat: np.ndarray,
    reset: np.ndarray,
    offsets: np.ndarray,
    track_sizes: list[int],
    track_meta: list[tuple[int, str]],
) -> CoreState:
    """Copy the arrays into a CoreState, checking that they agree."""
    k = int(kmer_size)
    level_mean = np.array(level_mean, dtype=np.float32)
    level_stdv = np.array(level_stdv, dtype=np.float32)
    if level_mean.shape != (4**k,) or level_stdv.shape != (4**k,):
        raise ValueError(
            f"pore model: want ({4**k},) level tables for k={k}, got "
            f"{level_mean.shape} and {level_stdv.shape}"
        )
    ref_cat = np.array(ref_cat, dtype=np.float32)
    reset = np.array(reset, dtype=bool)
    offsets = np.array(offsets, dtype=np.int64)
    sizes = [int(s) for s in track_sizes]
    meta = [(int(rid), str(strand)) for rid, strand in track_meta]
    T = len(sizes)
    if ref_cat.ndim != 1 or reset.shape != ref_cat.shape:
        raise ValueError(
            f"reference: want ref_cat, reset (R,); got {ref_cat.shape}, {reset.shape}"
        )
    if offsets.shape != (T + 1,) or len(meta) != T:
        raise ValueError(
            f"tracks: {T} sizes, {len(meta)} meta entries and "
            f"{offsets.shape[0]} offsets (want T+1)"
        )
    if any(offsets[t] + sizes[t] > offsets[t + 1] for t in range(T)):
        raise ValueError("tracks: a track overruns the next track's offset")
    if offsets[-1] > ref_cat.shape[0]:
        raise ValueError("tracks: offsets run past the reference array")
    return CoreState(
        model=PoreModel(kmer_size=k, level_mean=level_mean, level_stdv=level_stdv),
        ref_cat=ref_cat,
        reset=reset,
        offsets=offsets,
        track_sizes=sizes,
        track_meta=meta,
    )
