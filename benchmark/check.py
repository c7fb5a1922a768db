"""Whether the timed path's answers are right: a sample of the reads that
the window finished, drawn from the seed, mapped again by the plain
reference (reference/), and every line the mapper wrote for them in any
pass compared with the reference's, byte for byte.

Two numbers are compared, each with its limit:
- wrong_lines: (sampled read, pass) pairs whose PAF line differs from the
  reference's, a missing or an extra line included. The DP is exact in
  float32 on both sides, so the limit is 0.
- lost_reads: records handed to the mapper that it did not count as
  processed. Limit 0.
"""

from __future__ import annotations

import numpy as np

SAMPLE = 24     # reads a run checks
KIND_MIN = 3    # at least this many of each kind of read (short, no adaptor)
LIMITS = {"wrong_lines": 0, "lost_reads": 0}


def sample(reads: list[dict], n_done: int, seed: int, k: int = SAMPLE) -> list[int]:
    """Indices of k reads among the first n_done (file order), drawn from
    the seed: the longest one, at least KIND_MIN of each kind the traffic
    has, the rest from all."""
    rng = np.random.default_rng([seed & (2**64 - 1), 7])
    pool = np.arange(n_done)
    pick = {int(max(pool, key=lambda i: reads[i]["raw"].size))} if n_done else set()
    for kind in ("short", "no_adaptor"):
        have = [i for i in pool if reads[i][kind]]
        if have:
            pick.update(int(i) for i in rng.choice(have, min(KIND_MIN, len(have)), replace=False))
    rest = [i for i in pool if i not in pick]
    need = min(k - len(pick), len(rest))
    if need > 0:
        pick.update(int(i) for i in rng.choice(rest, need, replace=False))
    return sorted(pick)


def lines_by_read(text: str) -> dict[str, str]:
    out = {}
    for line in text.splitlines(keepends=True):
        out[line.split("\t", 1)[0]] = line
    return out


def judge(reads: list[dict], picked: list[int], expect: dict, passes: list[dict]) -> dict:
    """The compared numbers. passes: each pass's PAF text, the records it
    was handed (`fed`, the file's first ones) and the records it counted
    (`done`); expect: the reference's line (or None) of each picked read."""
    wrong = 0
    for p in passes:
        got = lines_by_read(p["text"])
        for i in picked:
            if i < p["fed"]:
                rid = reads[i]["read_id"]
                wrong += got.get(rid) != expect[rid]
    lost = sum(p["fed"] - p["done"] for p in passes)
    return {"wrong_lines": wrong, "lost_reads": lost}


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
