"""The plain reference's host stages: picoamps, events, the direct-RNA
polyA end and the z-scored query window of each read.

Frozen NumPy restatements of sigfish's C (src/events.c, src/jnn.c,
src/sigfish.c:317-505), the semantics that the mapper under test keeps.
Every float operation is in the C order and precision: the running sums
that the C keeps in one float are `np.cumsum(..., dtype=np.float32)`,
which adds in sequence, so no step here depends on a library's summation
order. The peak detector, a state machine over samples, runs for a whole
set of reads at once, one sample a step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# detector parameters, events.c:47-58
DNA_EVENTS = dict(w1=3, w2=6, t1=1.4, t2=9.0, peak=0.2)
RNA_EVENTS = dict(w1=7, w2=14, t1=2.5, t2=9.0, peak=1.0)

# jnnv2 adaptor finder (jnn.h:85-99) and jnn polyA scan (jnn.h:53-73), R9
ADAPTOR = dict(window=2000, std_scale=0.5, seg_dist=1500, hi=200000, lo=2000)
POLYA = dict(corrector=50, seg_dist=200, window=250, stall_len=1.0, error=30)

FLT_MAX = np.float32(np.finfo(np.float32).max)
HEAD = 4096  # samples of a signal eventized first (queries)


def seq_sum(x: np.ndarray) -> np.float32:
    """A float32 sum taken in order, one rounding an add, as C's loop."""
    return np.cumsum(x, dtype=np.float32)[-1] if x.size else np.float32(0.0)


def to_pa(raw: np.ndarray, digitisation: float, offset: float, rng: float) -> np.ndarray:
    """ADC counts to picoamps in float32, sigfish.c:344-347."""
    unit = np.float32(rng) / np.float32(digitisation)
    return (raw.astype(np.float32) + np.float32(offset)) * unit


def zscore(x: np.ndarray) -> np.ndarray:
    """Population z-score with float32 sums in order (sigfish.c:483-502,
    genref.c:23-47)."""
    x = np.asarray(x, np.float32)
    n = np.float32(x.size)
    mean = np.float32(seq_sum(x) / n)
    dev = x - mean
    var = np.float32(seq_sum(dev * dev) / n)
    stdv = np.float32(np.sqrt(np.float64(var)))
    return (x - mean) / stdv


@dataclass
class Events:
    start: np.ndarray   # int64 first sample of each event
    length: np.ndarray  # float32 samples
    mean: np.ndarray    # float32 pA


def _prefix_sums(pa: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sums and sums of squares before each sample, in float64 over the
    float32 samples and their float32 squares (events.c:297-307)."""
    sums = np.zeros(pa.size + 1, np.float64)
    sumsqs = np.zeros(pa.size + 1, np.float64)
    np.cumsum(pa.astype(np.float64), out=sums[1:])
    np.cumsum((pa * pa).astype(np.float64), out=sumsqs[1:])
    return sums, sumsqs


def _tstat(sums: np.ndarray, sumsqs: np.ndarray, n: int, w: int) -> np.ndarray:
    """The windowed Welch t-statistic with the C's float/double mix
    (events.c:319-368); zero at the edges."""
    out = np.zeros(n, np.float32)
    if n < 2 * w or w < 2:
        return out
    i = np.arange(w, n - w + 1)
    wf, wd = np.float32(w), np.float64(np.float32(w))
    sum1 = sums[i] - sums[i - w]
    sumsq1 = sumsqs[i] - sumsqs[i - w]
    sum2 = (sums[i + w] - sums[i]).astype(np.float32)
    sumsq2 = (sumsqs[i + w] - sumsqs[i]).astype(np.float32)
    mean1 = (sum1 / wd).astype(np.float32)
    mean2 = sum2 / wf
    var = ((sumsq1 / wd) - (mean1 * mean1).astype(np.float64)
           + (sumsq2 / wf).astype(np.float64) - (mean2 * mean2).astype(np.float64)
           ).astype(np.float32)
    var = np.maximum(var, np.float32(np.finfo(np.float32).tiny))
    out[w : n - w + 1] = (np.abs((mean2 - mean1).astype(np.float64))
                          / np.sqrt((var / wf).astype(np.float64))).astype(np.float32)
    return out


def _peaks(tstats: list[tuple[np.ndarray, np.ndarray]], p: dict, steps: list[int]) -> list[np.ndarray]:
    """The coupled short/long peak detector (events.c:375-447) over many
    reads at once: step i runs the short detector, then the long one, on
    every read r with steps[r] > i. Returns each read's peaks in the
    order they were committed."""
    B = len(tstats)
    lens = np.array(steps, np.int64)
    N = int(lens.max(initial=0))
    sig = [np.zeros((N, B), np.float32), np.zeros((N, B), np.float32)]
    for r, (a, b) in enumerate(tstats):
        sig[0][: lens[r], r] = a[: lens[r]]
        sig[1][: lens[r], r] = b[: lens[r]]
    thr = (np.float32(p["t1"]), np.float32(p["t2"]))
    half = (p["w1"] // 2, p["w2"] // 2)
    height = np.float32(p["peak"])
    masked = [np.zeros(B, np.int64), np.zeros(B, np.int64)]
    pos = [np.full(B, -1, np.int64), np.full(B, -1, np.int64)]
    val = [np.full(B, FLT_MAX), np.full(B, FLT_MAX)]
    valid = [np.zeros(B, bool), np.zeros(B, bool)]
    cap = 64
    out = np.zeros((B, cap), np.int64)
    cnt = np.zeros(B, np.int64)
    rows = np.arange(B)
    for i in range(N):
        live = lens > i
        for k in (0, 1):
            cv = sig[k][i]
            on = live & (masked[k] < i)
            free = pos[k] == -1
            a = on & free
            lower = cv < val[k]
            a2 = a & ~lower & ((cv - val[k]) > height)
            b = on & ~free
            b1 = b & (cv > val[k])
            take = (a & lower) | a2 | b1
            val[k] = np.where(take, cv, val[k])
            pos[k] = np.where(a2 | b1, i, pos[k])
            if k == 0:
                reset = b & (val[0] > thr[0])
                if reset.any():
                    masked[1] = np.where(reset, pos[0] + p["w1"], masked[1])
                    pos[1] = np.where(reset, -1, pos[1])
                    val[1] = np.where(reset, FLT_MAX, val[1])
                    valid[1] = valid[1] & ~reset
            valid[k] = valid[k] | (b & ((val[k] - cv) > height) & (val[k] > thr[k]))
            fire = b & valid[k] & ((i - pos[k]) > half[k])
            if fire.any():
                r = rows[fire]
                if int(cnt[r].max()) >= cap:
                    out = np.concatenate([out, np.zeros((B, cap), np.int64)], axis=1)
                    cap *= 2
                out[r, cnt[r]] = pos[k][r]
                cnt[r] += 1
                pos[k] = np.where(fire, -1, pos[k])
                val[k] = np.where(fire, cv, val[k])
                valid[k] = valid[k] & ~fire
    return [out[r, : cnt[r]] for r in range(B)]


def _events(peaks: np.ndarray, sums: np.ndarray, sumsqs: np.ndarray, n: int) -> Events:
    """Events between the peaks in (0, n), events.c:461-508."""
    peaks = peaks[(peaks > 0) & (peaks < n)]
    bounds = np.concatenate([[0], peaks, [n]]).astype(np.int64)
    starts, ends = bounds[:-1], bounds[1:]
    length = (ends - starts).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = (sums[ends] - sums[starts]).astype(np.float32) / length
    return Events(start=starts, length=length, mean=mean.astype(np.float32))


def detect_events(signals: list[np.ndarray], rna: bool, heads: list[bool] | None = None) -> list[Events]:
    """Each pA signal's event table (events.c:510-554), no trimming.

    A signal marked in `heads` is the head of a longer one. Its detector
    stops w2 samples before the head's end, up to where both t-statistics
    are the whole signal's, so its peaks are the first that the whole
    signal's detector commits, in the same order; it returns only the
    events that end at one of them, each the whole signal's."""
    p = RNA_EVENTS if rna else DNA_EVENTS
    heads = heads or [False] * len(signals)
    pre, ts = [], []
    for pa in signals:
        sums, sumsqs = _prefix_sums(pa)
        pre.append((sums, sumsqs))
        ts.append((_tstat(sums, sumsqs, pa.size, p["w1"]), _tstat(sums, sumsqs, pa.size, p["w2"])))
    steps = [max(pa.size - p["w2"], 0) if h else pa.size for pa, h in zip(signals, heads)]
    peaks = _peaks(ts, p, steps)
    out = []
    for pk, (s, q), pa, h in zip(peaks, pre, signals, heads):
        ev = _events(pk, s, q, pa.size)
        if h:
            n = ev.start.size - 1
            ev = Events(start=ev.start[:n], length=ev.length[:n], mean=ev.mean[:n])
        out.append(ev)
    return out


def adaptor(raw: np.ndarray) -> tuple[int, int]:
    """jnnv2 (jnn.c:100-180) on the raw samples: the clamp to [0, 1200],
    the rolling mean as one float running sum, the threshold mean - std *
    scale over it, segments merged within seg_dist and kept by length.
    (-1, -1) when the read is no longer than the window, (0, 0) when no
    segment qualifies."""
    p = ADAPTOR
    w, n = p["window"], raw.size
    if n <= w:
        return (-1, -1)
    c = np.clip(raw.astype(np.float32), np.float32(0.0), np.float32(1200.0))
    tn = n - w
    # tt -= c[i-1]; tt += c[i+w-1]: one float running sum, in order
    steps = np.empty(w + 2 * (tn - 1), np.float32)
    steps[:w] = c[:w]
    steps[w::2] = -c[: tn - 1]
    steps[w + 1 :: 2] = c[w : w + tn - 1]
    run = np.cumsum(steps, dtype=np.float32)
    t = np.concatenate([run[w - 1 : w], run[w + 1 :: 2]]) / np.float32(w)
    mn = np.float32(seq_sum(t) / np.float32(tn))
    std = np.sqrt(np.float32(seq_sum((t - mn) * (t - mn)) / np.float32(tn)))
    bot = float(np.float32(mn - std * np.float32(p["std_scale"])))
    segs: list[list[int]] = []
    begin, start, end = False, 0, 0
    for j, v in enumerate(t.tolist()):
        if v < bot and not begin:
            start, begin = j, True
        elif v < bot:
            end = j
        elif v > bot and begin:
            if segs and start - segs[-1][1] < p["seg_dist"]:
                segs[-1][1] = end
            else:
                segs.append([start, end])
            start, end, begin = 0, 0, False
    for a, b in segs:
        if p["lo"] <= b - a <= p["hi"]:
            return (a + w // 2 - 1, b + w // 2 - 1)
    return (0, 0)


def polya_segment(sig: np.ndarray, top: float, bot: float) -> tuple[int, int]:
    """The first in-band run of jnn_core (jnn.c:191-279) over a clamped
    pA signal, or (-1, -1). The scan stops once that run is final: a
    later run can only change it by merging, which needs a run that
    starts within seg_dist of its end."""
    p = POLYA
    inr = ((sig < top) & (sig > bot)).tolist()
    prev, err, prev_err, c, w, start = False, 0, 0, 0, p["corrector"], 0
    segs: list[list[int]] = []
    for i, ok in enumerate(inr):
        if ok:
            if not prev:
                start, prev = i, True
            c += 1
            w += 1
            prev_err = 0
            if c >= p["window"] and c >= w and not c % w:
                err -= 1
        elif prev and err < p["error"]:
            c += 1
            err += 1
            prev_err += 1
            if c >= p["window"] and c >= w and not c % w:
                err -= 1
        elif prev and (c >= p["window"] or (not segs and c >= p["window"] * p["stall_len"])):
            end = i - prev_err
            prev = False
            if segs and start - segs[-1][1] < p["seg_dist"]:
                segs[-1][1] = end
            else:
                segs.append([start, end])
            c, err, prev_err = 0, 0, 0
        elif prev:
            prev, c, err, prev_err = False, 0, 0, 0
        if segs and (len(segs) >= 2 or (i >= segs[0][1] + p["seg_dist"]
                                         and (not prev or start >= segs[0][1] + p["seg_dist"]))):
            break
    return tuple(segs[0]) if segs else (-1, -1)


def polya_end(raw: np.ndarray, pa: np.ndarray) -> int:
    """The raw sample at which the polyA tail ends (sigfish.c:380-404):
    the adaptor, its mean current m, the polyA band (m + 30) +- 20; -1
    when either is not found."""
    ax, ay = adaptor(raw)
    if ay <= 0:
        return -1
    m = float(seq_sum(pa[ax:ay]) / np.float32(ay - ax))
    tail = np.clip(pa[ay:].astype(np.float64), 0.0, 1200.0)
    _, py = polya_segment(tail, m + 30 + 20, m + 30 - 20)
    return py + ay if py > 0 else -1


@dataclass
class Query:
    """A read's query window: events [qstart, qend) z-scored (reversed
    for RNA), or skip when the read is ignored."""

    skip: bool
    qstart: int = 0
    qend: int = 0
    query: np.ndarray | None = None
    events: Events | None = None


def queries(reads: list[dict], rna: bool, prefix: int, qsize: int) -> list[Query]:
    """Each read's query (sigfish.c:424-505): from event `prefix`, or with
    prefix -1 from the first event at or after the polyA end (event 50
    where that fails), qsize events or as many as there are; a read with
    fewer than start + 25 events, or no samples, is ignored.

    Events are detected over a head of each signal (HEAD samples, four
    times more each round), until the head's events reach the query's
    end or the head is the whole signal: the answer is the whole
    signal's, without eventizing samples past the query."""
    starts = {}
    if prefix < 0:
        for i, r in enumerate(reads):
            if r["raw"].size:
                py = polya_end(r["raw"], to_pa(r["raw"], r["digitisation"], r["offset"], r["range"]))
                starts[i] = py
    out: list[Query | None] = [None] * len(reads)
    todo = [i for i, r in enumerate(reads) if r["raw"].size]
    for i, r in enumerate(reads):
        if not r["raw"].size:
            out[i] = Query(skip=True)
    size = HEAD
    while todo:
        pas = [to_pa(reads[i]["raw"][:size], reads[i]["digitisation"], reads[i]["offset"], reads[i]["range"])
               for i in todo]
        heads = [reads[i]["raw"].size > size for i in todo]
        evs = detect_events(pas, rna, heads)
        later = []
        for i, ev, head in zip(todo, evs, heads):
            n = ev.start.size
            start = prefix
            if prefix < 0:
                py = starts[i]
                ge = np.nonzero(ev.start >= py)[0] if py >= 0 else np.zeros(0, np.int64)
                start = int(ge[0]) if ge.size else (50 if py < 0 or not head else None)
            if head and (start is None or start + max(qsize, 25) > n):
                later.append(i)  # the head ends before the query does
                continue
            if n == 0 or start + 25 > n:
                out[i] = Query(skip=True)
                continue
            end = min(start + qsize, n)
            q = zscore(ev.mean[start:end])
            out[i] = Query(skip=False, qstart=start, qend=end,
                           query=q[::-1].copy() if rna else q, events=ev)
        todo, size = later, 4 * size
    return out
