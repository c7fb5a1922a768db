"""The trainer's CUDA kernels (csrc/gap_dtw.cu, csrc/banded_dtw.cu) run on
the CPU, their source as written, against their plain PyTorch versions.

There is no card here, so each source is built with g++ against
tests/cuda_emu/cuda_runtime.h, a stand-in runtime whose blocks are
std::threads with every warp in lockstep at its shuffles and ballots (see
its note). The wrappers' own argument functions (_gap_args, _banded_args)
size the buffers, so a sizing fault shows here too. Small ragged batches,
values from a few integers where ties matter, several stripes a case, and
1 to 4 warps a case (the stripes' pipeline between warps); every output
bitwise. The card runs the same kernels in tests/test_torch_gpu.py;
tests/kernel_emu.py builds them here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigfish_tpu_torch.ops import train_dtw as td

from kernel_emu import build


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    out = tmp_path_factory.mktemp("emu")
    return {name: build(out, name) for name in ("gap_dtw", "banded_dtw")}


def _same(a, b) -> bool:
    return all(u.dtype == v.dtype and u.shape == v.shape
               and torch.equal(u.contiguous().view(torch.uint8), v.contiguous().view(torch.uint8))
               for u, v in zip(a, b))


def _values(rng, sizes, ints):
    if ints:
        return [rng.integers(0, 3, int(s)).astype(np.float32) for s in sizes]
    return [np.clip(rng.standard_normal(int(s)), -3.5, 3.5).astype(np.float32) for s in sizes]


# (warps a case, tie-heavy): several 256-row stripes a case, more stripes
# than a block's row buffers (warps + 1), and cases shorter than one run of
# 8 rows, whose stripe starts above row 0
@pytest.mark.parametrize("warps,ints", [(1, True), (3, True), (2, False), (4, False)])
def test_gap_kernel_emulated_bitwise_vs_plain(emu, warps, ints):
    if ints:  # big enough that left and up tie below the diagonal on the paths
        batches = []
        for seed in (0, 4):
            rng = np.random.default_rng(seed)
            batches.append((_values(rng, (700, 200, 120), True),
                            _values(rng, (300, 250, 90), True)))
    else:
        rng = np.random.default_rng(10 + warps)
        batches = [(_values(rng, (1_300, 150, 64, 1, 40, 0, 97), False),
                    _values(rng, (50, 33, 20, 1, 9, 45, 30), False)),
                   (_values(rng, (1, 5, 8, 32), False), _values(rng, (40, 3, 17, 60), False))]
    for rows_, cols_ in batches:
        x, n = td.pack(rows_, "cpu")
        y, m = td.pack(cols_, "cpu")
        for gaps in ((0.5, 0.25), (0.8, 0.3)):
            args, got, _ = td._gap_args(x, y, n, m, *gaps, warps=warps)
            td._run(emu["gap_dtw"].sf_gap_dtw, args, None, "gap_sdtw")
            assert _same(got, td.gap_sdtw_plain(x, y, n, m, *gaps))


def test_gap_kernel_emulated_flags_lengths_past_the_padding(emu):
    """On the card the gap wrapper does not bring the lengths to the host:
    the kernel gives a case whose n or m lies outside the padding end -1,
    end cost NaN and no path, and the other cases their plain results."""
    rng = np.random.default_rng(3)
    x, n = td.pack(_values(rng, (40, 30, 20, 25), False), "cpu")
    y, m = td.pack(_values(rng, (50, 35, 10, 28), False), "cpu")
    bad_n, bad_m = n.clone(), m.clone()
    bad_n[1], bad_m[2] = x.shape[1] + 1, -1
    args, got, _ = td._gap_args(x, y, bad_n, bad_m, 0.5, 0.25, warps=1)
    td._run(emu["gap_dtw"].sf_gap_dtw, args, None, "gap_sdtw")
    want = td.gap_sdtw_plain(x, y, n, m, 0.5, 0.25)
    end, end_cost, px, py, plen = got
    for b in (1, 2):
        assert end[b] == -1 and torch.isnan(end_cost[b]) and plen[b] == 0
        assert bool((px[b] == -1).all()) and bool((py[b] == -1).all())
    keep = torch.tensor([0, 3])
    assert _same([t[keep] for t in got], [t[keep] for t in want])


# (warps a case, kind): tie-heavy; rows' bands that do not overlap (m / n
# past 2 * (end_slack + 8) + 1) and tall cases; normals over many stripes
@pytest.mark.parametrize("warps,kind", [(1, "ties"), (3, "ties"), (2, "nonoverlap"),
                                        (4, "normal")])
def test_banded_kernel_emulated_bitwise_vs_plain(emu, warps, kind):
    rng = np.random.default_rng(warps)
    ns, ms, bands, slack = {
        "ties": ([70, 66, 1, 0, 40], [64, 70, 9, 5, 90], [5, 6, 1, 2, 3], 4),
        "nonoverlap": ([5, 9, 200, 3], [130, 250, 40, 90], [1, 2, 1, 1], 1),
        "normal": ([300, 140, 33], [280, 150, 60], [30, 9, 4], 12),
    }[kind]
    ints = kind != "normal"
    ev, n = td.pack(_values(rng, ns, ints), "cpu")
    lvl, m = td.pack(_values(rng, ms, ints), "cpu")
    band = torch.tensor(bands, dtype=torch.int32)
    args, got, _ = td._banded_args(ev, lvl, n, m, band, slack, 0.5, 0.25, warps=warps)
    td._run(emu["banded_dtw"].sf_banded_dtw, args, None, "banded_dtw")
    assert _same(got, td.banded_dtw_plain(ev, lvl, n, m, band, slack))


def test_kernels_emulated_with_scratch_buffers(emu, monkeypatch):
    """A case's buffers past the shared memory a block may take go to a
    device scratch (any n, m and band): both kernels through it, with the
    limit set to nothing, against the plain versions."""
    monkeypatch.setattr(td, "SMEM_CASE_BYTES", 0)
    rng = np.random.default_rng(9)
    x, n = td.pack(_values(rng, (150, 40, 0), True), "cpu")
    y, m = td.pack(_values(rng, (80, 77, 5), True), "cpu")
    args, got, hold = td._gap_args(x, y, n, m, 0.5, 0.25, warps=2)
    assert hold[3] is not None
    td._run(emu["gap_dtw"].sf_gap_dtw, args, None, "gap_sdtw")
    assert _same(got, td.gap_sdtw_plain(x, y, n, m, 0.5, 0.25))
    band = torch.tensor([10, 3, 2], dtype=torch.int32)
    args, got, hold = td._banded_args(x, y, n, m, band, 6, 0.5, 0.25, warps=2)
    assert hold[3] is not None
    td._run(emu["banded_dtw"].sf_banded_dtw, args, None, "banded_dtw")
    assert _same(got, td.banded_dtw_plain(x, y, n, m, band, 6))
