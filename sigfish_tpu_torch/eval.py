"""`eval` subtool: PAF-vs-PAF mapping accuracy.

ref: sigfish src/eval.c. Output text matches print_compare_stat
(eval.c:329-357) byte-for-byte given the same inputs:
  - truthset hashed by read id, multiple mappings per read kept
  - a test record is correct iff some truth mapping of the same read has
    the same target name and strand AND min(|dstart|, |dend|) < 100
    (THRESHOLD eval.c:218); --tid-only skips the coordinate check
  - --secondary no restricts comparison to same tp:A tag
  - mapq must be 0..60 (the reference asserts; we raise)
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field

THRESHOLD = 100

_ATOI_RE = re.compile(r"[ \t\n\r\f\v]*([+-]?[0-9]*)")


def _atoi(s: str) -> int:
    """C atoi semantics (eval.c uses atoi throughout parse_paf_rec):
    optional whitespace + sign, then the longest digit prefix; anything
    else (including a trailing ``.5`` or junk) is ignored; no digits -> 0.
    """
    d = _ATOI_RE.match(s).group(1)
    return int(d) if d.strip("+-") else 0


@dataclass
class PafRec:
    rid: str
    qlen: int
    query_start: int
    query_end: int
    strand: int  # 0='+', 1='-'
    tid: str
    tlen: int
    target_start: int
    target_end: int
    mapq: int
    tp: str = "P"


def parse_paf_rec(line: str) -> PafRec:
    """ref: parse_paf_rec eval.c:80-152.

    Tokenization mirrors ``strtok(buffer, "\\t\\r\\n")``: runs of
    delimiters collapse (empty columns are skipped), and every numeric
    column is read with C atoi (tolerates floats / trailing junk).
    """
    f = [t for t in re.split(r"[\t\r\n]+", line) if t]
    if len(f) < 12:
        raise ValueError(f"bad PAF line: {line!r}")
    strand = 0 if f[4] == "+" else 1 if f[4] == "-" else None
    if strand is None:
        raise ValueError(f"bad strand in PAF line: {line!r}")
    tp = "P"
    for tag in f[12:]:
        if tag == "tp:A:P":
            tp = "P"
        elif tag == "tp:A:S":
            tp = "S"
    return PafRec(
        rid=f[0],
        qlen=_atoi(f[1]),
        query_start=_atoi(f[2]),
        query_end=_atoi(f[3]),
        strand=strand,
        tid=f[5],
        tlen=_atoi(f[6]),
        target_start=_atoi(f[7]),
        target_end=_atoi(f[8]),
        mapq=_atoi(f[11]),
        tp=tp,
    )


@dataclass
class EvalStat:
    truth_rec: int = 0
    test_rec: int = 0
    truth_mapped: int = 0
    test_mapped: int = 0
    correct: int = 0
    incorrect: int = 0
    only_in_b: int = 0
    mapq_correct: list[int] = field(default_factory=lambda: [0] * 61)
    mapq_incorrect: list[int] = field(default_factory=lambda: [0] * 61)


def is_correct_overlap(a: PafRec, b: PafRec, tid_only: bool = False) -> bool:
    """ref: eval.c:219-242."""
    if a.tid != b.tid or a.strand != b.strand:
        return False
    if tid_only:
        return True
    diff_st = abs(a.target_start - b.target_start)
    diff_end = abs(a.target_end - b.target_end)
    return min(diff_st, diff_end) < THRESHOLD


def get_truth(fp) -> tuple[dict[str, list[PafRec]], EvalStat]:
    stat = EvalStat()
    truth: dict[str, list[PafRec]] = {}
    for line in fp:
        if not line.strip():
            continue
        paf = parse_paf_rec(line)
        truth.setdefault(paf.rid, []).append(paf)
        stat.truth_rec += 1
    stat.truth_mapped = len(truth)
    return truth, stat


def parse_eval(fp, truth: dict[str, list[PafRec]], stat: EvalStat, sec: bool = True, tid_only: bool = False) -> None:
    total = 0
    for line in fp:
        if not line.strip():
            continue
        paf = parse_paf_rec(line)
        entries = truth.get(paf.rid)
        if entries is None:
            stat.only_in_b += 1
        else:
            ret = False
            for t in entries:
                if sec or t.tp == paf.tp:
                    if is_correct_overlap(t, paf, tid_only):
                        ret = True
                        break
            if not (0 <= paf.mapq <= 60):
                raise ValueError(f"mapq {paf.mapq} out of [0,60] for {paf.rid}")
            if ret:
                stat.correct += 1
                stat.mapq_correct[paf.mapq] += 1
            else:
                stat.incorrect += 1
                stat.mapq_incorrect[paf.mapq] += 1
        total += 1
    stat.test_rec = total
    stat.test_mapped = total
    sys.stderr.write(f"Total mappings in testset: {total}\n")


def print_compare_stat(stat: EvalStat, out=sys.stdout) -> None:
    """ref: print_compare_stat eval.c:329-357 (exact text)."""
    tm = float(stat.truth_mapped) if stat.truth_mapped else float("nan")
    sm = float(stat.test_mapped) if stat.test_mapped else float("nan")
    out.write(
        "\nComparison between truthset and testset\n"
        f"mapped_truthset\t{stat.truth_mapped}\n"
        f"mapped_testset\t{stat.test_mapped} ({stat.test_mapped / tm * 100:.2f}%)\n"
        f"correct\t{stat.correct} ({stat.correct / sm * 100:.2f}%)\n"
        f"incorrect\t{stat.incorrect} ({stat.incorrect / sm * 100:.2f}%)\n"
        f"only_in_testset\t{stat.only_in_b}\n"
    )
    out.write("\n#mapq\tcorrect\tincorrect\n")
    for i in range(60, -1, -1):
        c = stat.mapq_correct[i]
        ic = stat.mapq_incorrect[i]
        if not (c == 0 and ic == 0):
            out.write(f"{i}\t{c}\t{ic}\n")


def eval_main(truth_path: str, test_path: str, sec: bool = True, tid_only: bool = False, out=sys.stdout) -> EvalStat:
    with open(truth_path) as fp:
        truth, stat = get_truth(fp)
    with open(test_path) as fp:
        parse_eval(fp, truth, stat, sec=sec, tid_only=tid_only)
    print_compare_stat(stat, out)
    return stat
