"""The scan engine's CUDA kernel (csrc/scan.cu) run on the CPU, its
source as written, against its plain PyTorch version bit for bit.

There is no card here, so the source is built with g++ against
tests/cuda_emu/cuda_runtime.h (tests/kernel_emu.py), a stand-in runtime
whose blocks are std::threads with every warp in lockstep at its
shuffles. The wrapper's own row pick (last_rows) feeds it. One-shot and
carry, std, tracks with resets, clipped rows and a qlen-0 row, at every
Q the kernel is built for; the card runs the same kernel in
tests/test_torch_gpu.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigfish_tpu_torch.ops import layout
from sigfish_tpu_torch.ops import sdtw_scan as ss

from kernel_emu import build


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return build(tmp_path_factory.mktemp("emu_scan"), "scan")


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
