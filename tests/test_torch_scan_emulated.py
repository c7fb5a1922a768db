"""The scan engine's CUDA kernel (csrc/scan.cu) run on the CPU, its
source as written, against its plain PyTorch version bit for bit.

There is no card here, so the source is built with g++ against
tests/cuda_emu/cuda_runtime.h (tests/kernel_emu.py), a stand-in runtime
whose blocks are std::threads with every warp in lockstep at its
shuffles and ballots. The wrapper's own row pick (last_rows) feeds it.
One-shot and carry, std, tracks with resets, clipped rows and a qlen-0
row, at every Q the kernel is built for; and a read's columns split
into pieces, a warp each, at piece counts the test sets through a
rewrite of the build (emu_pieces; the source has no such knob). The
card runs the same kernel in tests/test_torch_gpu.py.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from sigfish_tpu_torch.ops import layout
from sigfish_tpu_torch.ops import sdtw_scan as ss
from sigfish_tpu_torch.scripts.bench_scan import pieces

from kernel_emu import PIECES, PIECES_PRELUDE, build


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return build(tmp_path_factory.mktemp("emu_scan"), "scan", extra=(PIECES,),
                 prelude=PIECES_PRELUDE)


def _pieces(lib, K: int) -> None:
    """Set the emulated build's piece count (0: the source's rule)."""
    ctypes.c_int.in_dll(lib, "emu_pieces").value = K


def _launch(lib, q, oh, ref, reset, std, init):
    B, Q = q.shape
    R = ref.shape[0]
    out = torch.empty((B, R), dtype=torch.float32)
    final = torch.empty((B, Q), dtype=torch.float32)
    rows = ss.last_rows(oh)
    err = lib.sf_sdtw_scan(q.data_ptr(), rows.data_ptr(), ref.data_ptr(), reset.data_ptr(),
                           None if init is None else init.data_ptr(), out.data_ptr(),
                           final.data_ptr(), B, Q, R, int(std), None)
    assert err == 0
    return out, final


def _same(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("std", [False, True])
@pytest.mark.parametrize("Q", [32, 64, 128, 256, 384, 512])
def test_scan_kernel_emulated_bitwise_vs_plain(emu, Q, std, carry):
    """7 reads (5 warps of one block and 2 of the next): full-length,
    clipped and qlen 0, over three tracks' resets; with carry=True from
    a random carry column (values near the rows' own), each output and
    the final column bitwise."""
    rng = np.random.default_rng(Q + 2 * std + carry)
    W = max(Q - 6, 25)
    tracks = [rng.standard_normal(int(s)).astype(np.float32) for s in (90, 33, 120)]
    ref, reset, _ = layout.pad_tracks(tracks, ckpt=32, align=W)
    ref, reset = ref[:330], reset[:330]
    qlens = rng.integers(1, W + 1, size=7)
    qlens[0], qlens[-1] = W, 0
    qb, _, oh = layout.make_query_batch(
        [rng.standard_normal(int(n)).astype(np.float32) for n in qlens], pad_q=Q)
    args = [torch.from_numpy(a) for a in (qb, oh, ref, reset)]
    init = (torch.from_numpy(rng.uniform(0, 60, qb.shape).astype(np.float32))
            if carry else None)
    got = _launch(emu, *args, std, init)
    want = ss.scan_plain(*args, std=std, init=init)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("std", [False, True])
def test_scan_kernel_emulated_chain_is_the_one_shot(emu, std):
    """Three uneven segments chained through the kernel's final column
    give its one-shot rows bit for bit."""
    rng = np.random.default_rng(5)
    tracks = [rng.standard_normal(int(s)).astype(np.float32) for s in (200, 150)]
    ref, reset, _ = layout.pad_tracks(tracks, ckpt=32, align=250)
    qb, _, oh = layout.make_query_batch(
        [rng.standard_normal(int(n)).astype(np.float32) for n in (250, 97, 250)], pad_q=256)
    q, o, y, r = (torch.from_numpy(a) for a in (qb, oh, ref, reset))
    whole, final = _launch(emu, q, o, y, r, std, None)
    init, parts = None, []
    for a, b in ((0, 1), (1, 260), (260, y.shape[0])):
        lr, init = _launch(emu, q, o, y[a:b], r[a:b], std, init)
        parts.append(lr)
    assert _same(torch.cat(parts, 1), whole) and _same(init, final)


def test_scan_kernel_entry_refuses_bad_shapes(emu):
    """Q not a multiple of 32 or not built, or a negative size: the entry
    returns cudaErrorInvalidValue (1) and launches nothing."""
    for B, Q, R in ((2, 48, 10), (2, 32 * 3, 10), (-1, 64, 10), (2, 64, -1)):
        assert emu.sf_sdtw_scan(None, None, None, None, None, None, None, B, Q, R, 0, None) == 1
    assert emu.sf_sdtw_scan(None, None, None, None, None, None, None, 0, 64, 10, 0, None) == 0


def _tracks(seed, R, resets, B, Q, W=None):
    """(queries, one-hot, ref, reset) with reset flags at the given
    columns: B reads, full-length, clipped and the last of qlen 0."""
    rng = np.random.default_rng(seed)
    W = W or Q - 3
    ref = rng.standard_normal(R).astype(np.float32)
    reset = np.zeros(R, bool)
    reset[list(resets)] = True
    qlens = rng.integers(1, W + 1, size=B)
    qlens[0], qlens[-1] = W, 0
    qb, _, oh = layout.make_query_batch(
        [rng.standard_normal(int(n)).astype(np.float32) for n in qlens], pad_q=Q)
    return [torch.from_numpy(a) for a in (qb, oh, ref, reset)]


# resets 0, 37, 38, 150, 151, 290 over 300 columns: at K=4 the range
# [75, 150) holds none (piece 0 runs on to 150) and pieces are 150, 140
# and 10 columns, at K=3 and 5 other splits; at K=2 a piece starts inside
# the second range
RESETS = (0, 37, 38, 150, 151, 290)


@pytest.mark.parametrize("K", [2, 3, 4, 5])
@pytest.mark.parametrize("std", [False, True])
def test_scan_kernel_emulated_pieces_bitwise_vs_plain(emu, K, std):
    """A read's columns split at resets into pieces of uneven length, one
    of K ranges holding no reset: every output and the final column
    bitwise to the plain version, one-shot and from a carry column (the
    first piece starts from it, column 0 a reset or not), B=6 reads over
    K pieces (not a multiple of a block's 4 warps)."""
    q, oh, y, r = _tracks(K + 10 * std, 300, RESETS, 6, 64)
    have = pieces(type("L", (), {"sf_sdtw_scan_pieces": staticmethod(lambda B, R: K)}),
                  r.numpy(), 6)
    assert len(have) > 1 and all(r[a] for a, _ in have[1:])
    rng = np.random.default_rng(K)
    init = torch.from_numpy(rng.uniform(0, 60, q.shape).astype(np.float32))
    _pieces(emu, K)
    try:
        for r_ in (r, torch.cat([r[:1] & False, r[1:]])):
            for c0 in (None, init):
                got = _launch(emu, q, oh, y, r_, std, c0)
                want = ss.scan_plain(q, oh, y, r_, std=std, init=c0)
                assert _same(got[0], want[0]) and _same(got[1], want[1]), (bool(r_[0]), c0 is None)
    finally:
        _pieces(emu, 0)


@pytest.mark.parametrize("std", [False, True])
def test_scan_kernel_emulated_scores_equal_for_every_piece_count(emu, std):
    """The same launch at every piece count from 1 to 12 (and the
    source's own rule): the rows and the final column bit for bit the
    same, and the plain version's; with std a reset inside each piece."""
    q, oh, y, r = _tracks(3 + std, 260, (0, 40, 41, 97, 130, 131, 200, 250), 5, 128)
    want = ss.scan_plain(q, oh, y, r, std=std)
    try:
        for K in range(13):
            _pieces(emu, K)
            got = _launch(emu, q, oh, y, r, std, None)
            assert _same(got[0], want[0]) and _same(got[1], want[1]), K
    finally:
        _pieces(emu, 0)


@pytest.mark.parametrize("R", [0, 1, 20])
@pytest.mark.parametrize("K", [1, 2])
def test_scan_kernel_emulated_shorter_than_the_fill(emu, R, K):
    """R under the pipeline's 31 steps of fill (and R = 0, 1): one-shot,
    std and from a carry column, bitwise; with R = 0 the final column is
    the carry it started from."""
    q, oh, y, r = _tracks(R + K, R, [0] if R else [], 5, 64)
    init = torch.from_numpy(np.random.default_rng(R).uniform(0, 60, q.shape).astype(np.float32))
    _pieces(emu, K)
    try:
        for std, c0 in ((False, None), (True, None), (False, init), (True, init)):
            got = _launch(emu, q, oh, y, r, std, c0)
            want = ss.scan_plain(q, oh, y, r, std=std, init=c0)
            assert _same(got[0], want[0]) and _same(got[1], want[1]), (std, c0 is None)
    finally:
        _pieces(emu, 0)


def test_scan_kernel_emulated_chain_over_pieces(emu):
    """Segments chained through the final column, each split into three
    pieces: the one-shot rows and final column bit for bit."""
    q, oh, y, r = _tracks(9, 300, RESETS, 3, 64)
    whole = ss.scan_plain(q, oh, y, r)
    _pieces(emu, 3)
    try:
        init, parts = None, []
        for a, b in ((0, 120), (120, 151), (151, 300)):
            lr, init = _launch(emu, q, oh, y[a:b], r[a:b], False, init)
            parts.append(lr)
    finally:
        _pieces(emu, 0)
    assert _same(torch.cat(parts, 1), whole[0]) and _same(init, whole[1])


def test_scan_pieces_rule(emu):
    """The source's piece count: about 2,048 warps over the batch, no
    piece under 1,024 columns, at least one; phase 13's launches (B=512
    over R=60,416 and 160,256) take 4."""
    rule = emu.sf_sdtw_scan_pieces
    assert rule(512, 60_416) == 4 and rule(512, 160_256) == 4
    assert rule(64, 160_256) == 32 and rule(64, 20_000) == 19
    assert rule(4096, 10**6) == 1 and rule(1, 500) == 1 and rule(7, 0) == 1
