"""The port's batched polyA autodetect (`--host-stages device` with RNA
-p -1, sigfish_tpu_torch/ops/jnn_device.py) on the CPU, where polya_end
runs its plain PyTorch passes: against sigfish_tpu.ops.jnn_device.
polya_end_batch on the CPU backend, bit for bit, for R9 and RNA004
parameters; its P2 statistics and fused multiply-adds against the
reference's rounding; and whole direct-RNA runs (`--rna -q 500 -p -1`,
R9 and RNA004) with --host-stages device byte-identical to sigfish_tpu's
device mode and to the port's host mode.

Reads: chip_smoke.py's direct-RNA generator with shorter adaptors and
walks (at most ~20k samples, as the plain passes are Python loops over
samples), and the degraded reads of sigfish_tpu's device polyA test: pure
noise (the adaptor scan fails), a signal no longer than the rolling
window, a short polyA, and an empty signal; and chip_smoke.edge_polya_
batch, the card kernel's ragged edges (reads of 0, 1 and window - 1 to
window + 1 samples, no adaptor, the shortest tails after the polyA, a
read of S samples, S = 8,292 not a multiple of the ring's 256-step tile,
B = 37). A read whose answer differs from the host scan (ops/jnn.
detect_polya_end, which carries the band in f64) is printed with both
answers.
"""

from __future__ import annotations

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from port_runs import load_smoke, run_jax, run_port
from sigfish_tpu.ops import jnn_device as j_pa
from sigfish_tpu_torch.io.blow5 import Slow5File
from sigfish_tpu_torch.ops import jnn
from sigfish_tpu_torch.ops import jnn_device as pa

RNA = dict(rna=True, query_size=500, prefix_size=-1)
SMALL = dict(tx_len=(600, 1_400), walks=(300, 150), adaptor=(5_000, 6_500))
DIGI, OFF, RANGE = 8192.0, 10.0, 1400.0


def _degraded(rng):
    """sigfish_tpu's degraded polyA shapes, shortened: adaptor + polyA +
    tail in pA, a noise read, n <= window, a short polyA, empty."""

    def synth(n_ad, n_pa, n_tail):
        x = np.concatenate([rng.normal(40.0, 2.0, n_ad), rng.normal(108.0, 2.0, n_pa),
                            rng.normal(90.0, 14.0, n_tail)])
        return np.clip(np.rint(x * DIGI / RANGE - OFF), -32000, 32000).astype(np.int16)

    return [
        synth(6000, 3000, 6000),
        rng.integers(-100, 1300, 12_000).astype(np.int16),
        np.full(1500, 300, np.int16),
        synth(8000, 400, 6000),
        np.zeros(0, np.int16),
        synth(2500, 2600, 5000),
    ]


@pytest.fixture(scope="module", params=[(jnn.PORE_R9, "fuzz"), (jnn.PORE_RNA004, "fuzz"),
                                        (jnn.PORE_R9, "edges"), (jnn.PORE_RNA004, "edges")],
                ids=["r9", "rna004", "r9-edges", "rna004-edges"])
def polya_case(request, tmp_path_factory):
    """(pore, read ids, signals, numpy batch) of chip_smoke's RNA reads
    for the chemistry plus the degraded reads, or of its edge batch."""
    pore, kind = request.param
    if kind == "edges":
        batch = load_smoke().edge_polya_batch(4)
        sigs = [row[:n] for row, n in zip(batch[0], batch[1])]
        return pore, [f"edge{i}" for i in range(len(sigs))], sigs, batch
    d = tmp_path_factory.mktemp("polya")
    _, bl, _ = load_smoke().make_rna_workload(str(d), 4, 16, 21, rna004=pore == jnn.PORE_RNA004,
                                              **SMALL)
    with Slow5File(bl) as sf:
        recs = list(sf)
    ids = [r.read_id for r in recs] + [f"degraded{i}" for i in range(6)]
    sigs = [r.raw_signal for r in recs] + _degraded(np.random.default_rng(5))
    B = len(sigs)
    S = 1024
    while S < max(s.size for s in sigs):
        S *= 2
    sig = np.zeros((B, S), np.int16)
    ns = np.zeros(B, np.int32)
    for b, s in enumerate(sigs):
        sig[b, : s.size] = s
        ns[b] = s.size
    return pore, ids, sigs, (sig, ns, np.full(B, DIGI), np.full(B, OFF), np.full(B, RANGE))


def test_plain_polya_bitwise_vs_jax(polya_case):
    """polya_end_batch(device="cpu") equals sigfish_tpu's polya_end_batch
    read by read; reads where the host scan answers otherwise are printed."""
    pore, ids, sigs, batch = polya_case
    assert batch[0].shape[1] <= 32_768
    got = pa.polya_end_batch(*batch, pore, device="cpu")
    want = j_pa.polya_end_batch(*batch, pore=pore)
    assert got.tolist() == want.tolist()
    unit = np.float32(RANGE) / np.float32(DIGI)
    for rid, s, g, off in zip(ids, sigs, got, batch[3]):
        host = -1 if s.size == 0 else jnn.detect_polya_end(
            s, (s.astype(np.float32) + np.float32(off)) * unit, pore=pore)
        if host != g:
            print(f"polyA end of {rid}: device {g}, host scan {host}")
    if ids[0] == "edge0":  # no longer than the window + 1, or no adaptor: -1
        assert (got >= 0).sum() >= 12 and (got[:7] < 0).all()
    else:
        assert (got >= 0).sum() >= 12 and (got[-6:] < 0).sum() >= 3


def test_plain_polya_rows_independent(polya_case):
    """A read's answer does not hang on its batch: the batch's two halves,
    each alone (a shorter plane), give the whole batch's answers. The card
    kernel walks the union of a warp's rows, so its lanes must not
    interact either."""
    pore, _, _, batch = polya_case
    got = pa.polya_end_batch(*batch, pore, device="cpu")
    h = batch[0].shape[0] // 2
    for rows in (slice(0, h), slice(h, None)):
        part = tuple(a[rows] for a in batch)
        n_max = int(part[1].max())
        part = (part[0][:, : max(n_max, 1)],) + part[1:]
        assert pa.polya_end_batch(*part, pore, device="cpu").tolist() == got[rows].tolist()


def _exact_f32(x: Fraction) -> np.float32:
    """x rounded to the nearest f32, ties to even."""
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.int32)) & 1))
    return np.float32(best)


def test_fma32_rounds_once():
    """fma32 is a * b + c rounded once to f32, against exact rationals,
    on random operands and on f64 sums that land on an f32 midpoint."""
    rng = np.random.default_rng(3)
    a = (rng.standard_normal(3000) * 10.0 ** rng.integers(-3, 4, 3000)).astype(np.float32)
    b = (rng.standard_normal(3000) * 10.0 ** rng.integers(-3, 4, 3000)).astype(np.float32)
    c = (rng.standard_normal(3000) * 10.0 ** rng.integers(-6, 8, 3000)).astype(np.float32)
    # c = 1 + 2^-24 * k with a * b a tiny nudge: the f64 sum rounds onto
    # the f32 midpoint 1 + 2^-24, where rounding twice goes wrong
    a[:8] = np.float32(2.0 ** -40)
    b[:8] = np.float32(1.0 + 2.0 ** -20)
    c[:8] = np.float32(1.0)
    got = pa.fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(a.size):
        x = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        assert got[i] == _exact_f32(x), i


def test_p2_stats_follow_the_reference_rounding():
    """mean_std_bot equals the reference's P2 as XLA's CPU backend
    compiles it (_seq_mean_std inside a jit, then mean - std * scale),
    bit for bit, at both chemistries' scales."""
    rng = np.random.default_rng(11)
    S, B = 3000, 64
    x = (rng.random((S, B)) * 1200).astype(np.float32)
    valid = rng.random((S, B)) < 0.9
    count = np.maximum(valid.sum(0), 1).astype(np.int32)
    for scale in (0.5, 0.7):
        f = jax.jit(lambda x, v, c, sc=np.float32(scale): (
            lambda m, s: (m, s, m - s * sc))(*j_pa._seq_mean_std(x, v, c, True)))
        want = [np.asarray(w) for w in f(x, valid, count)]
        got = pa.mean_std_bot(torch.from_numpy(x), torch.from_numpy(valid),
                              torch.from_numpy(count.astype(np.float32)), scale)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy().view(np.int32), w.view(np.int32)), scale


@pytest.mark.parametrize("rna004", [False, True], ids=["r9", "rna004"])
def test_host_stages_device_rna_byte_identical(tmp_path, rna004):
    """`--rna -q 500 -p -1` with host_stages="device", device="cpu": the
    same bytes and prefix-fail count as sigfish_tpu's --host-stages device
    (native engine) and as the port's host mode."""
    fa, bl, _ = load_smoke().make_rna_workload(str(tmp_path), 6, 22, 11, rna004=rna004,
                                               tx_len=(600, 1_400), walks=(400, 200),
                                               adaptor=(6_500, 8_000))
    got, core = run_port(fa, bl, host_stages="device", batch_size=32, **RNA)
    want_j, jcore = run_jax(fa, bl, "native", host_stages="device", batch_size=32, **RNA)
    want_h, hcore = run_port(fa, bl, batch_size=32, **RNA)
    assert got == want_j == want_h and len(got.splitlines()) >= 18
    assert core.prefix_fail == jcore.prefix_fail == hcore.prefix_fail >= 1
    assert core.too_short == hcore.too_short
