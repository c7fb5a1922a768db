"""The carry mode of the wavefront kernel (csrc/wavefront.cu) run on the
CPU, its source as written, against the plain PyTorch version bit for
bit: the flag-free body (sf_wavefront_carry_noflag) at each width it is
built for, with start lanes in both warps, and a chain that mixes it with
the flag-aware instance (sf_wavefront_carry) segment by segment, as the
chunked route does.

There is no card here, so the source is built with g++ against
tests/cuda_emu/cuda_runtime.h (tests/kernel_emu.py), a stand-in runtime
whose blocks are std::threads with every warp in lockstep at its
shuffles, and its mbarriers atomic words. The card runs the same kernel
in tests/test_torch_gpu.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigfish_tpu_torch.ops import sdtw_wavefront as wf
from sigfish_tpu_torch.ops.chunked_ref import flag_free_segments

from kernel_emu import build

W = 200
Q = 256


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return build(tmp_path_factory.mktemp("emu_wavefront"), "wavefront")


def _carry(lib, q, y, r, sl, state, warps, noflag, lane=W - 1):
    """One carry launch of the emulated library: the flag-free body, or
    the flag-aware instance; (scores, a1, a2, ywin, rswin)."""
    B, Qq = q.shape
    D = y.shape[1]
    y, r = y.contiguous(), r.contiguous()
    out = torch.empty((B, D))
    st_in = [t.contiguous() for t in state]
    st_out = [torch.empty_like(t) for t in st_in]
    slp = None if sl is None else sl.data_ptr()
    if noflag:
        err = lib.sf_wavefront_carry_noflag(
            q.data_ptr(), y.data_ptr(), slp, *(t.data_ptr() for t in st_in[:3]), out.data_ptr(),
            *(t.data_ptr() for t in st_out), B, Qq, D, lane, warps, None)
    else:
        err = lib.sf_wavefront_carry(
            q.data_ptr(), y.data_ptr(), r.data_ptr(), slp, *(t.data_ptr() for t in st_in),
            out.data_ptr(), *(t.data_ptr() for t in st_out), B, Qq, D, lane, 0, warps, None)
    assert err == 0
    return (out, *st_out)


def _bits(t):
    return t.numpy().view(np.int32)


def _assert_equal(got, want, sl, what):
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]), err_msg=f"scores, {what}")
    masks = wf.carry_state_mask(sl, *got[1].shape)
    for name, g, w, m in zip(("a1", "a2", "ywin", "rswin"), got[1:], want[1:], masks):
        np.testing.assert_array_equal(_bits(g)[m.numpy()], _bits(w)[m.numpy()],
                                      err_msg=f"{name}, {what}")


# start lanes of each width the flag-free body is built for (2 warps a
# read, 1, 2 or 4 rows a lane): 0, and rows in the lower and the upper
# warp of every nonzero residue mod the rows a lane, W - 1 among them
LANES = {(W, Q): (0, 3, 130, 132, 199),
         (100, 128): (0, 3, 66, 65, 99),
         (60, 64): (0, 3, 40, 59)}


@pytest.mark.parametrize("Wq,Qq", list(LANES))
def test_noflag_kernel_emulated_chain_bitwise(emu, Wq, Qq):
    """The flag-free body at 2 warps chained over segments of 1, 36 and
    38 diagonals (ending inside a group of four and a tile): scores
    bitwise equal to the plain carry chain's and the state under
    carry_state_mask, with start lanes and without."""
    assert wf.noflag_built(Qq, 2)
    rng = np.random.default_rng(Qq)
    lanes = LANES[Wq, Qq]
    B = len(lanes)
    q = torch.from_numpy(rng.standard_normal((B, Qq)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((1, 75)).astype(np.float32))
    r = torch.zeros((1, 75))
    for sl in (None, torch.tensor(lanes, dtype=torch.int32)):
        st_k = st_p = wf.carry_fresh_state(B, Qq, "cpu")
        for lo, hi in ((0, 1), (1, 37), (37, 75)):
            got = _carry(emu, q, y[:, lo:hi], r[:, lo:hi], sl, st_k, 2, noflag=True, lane=Wq - 1)
            want = wf.wavefront_plain(q, y[:, lo:hi], r[:, lo:hi], Wq - 1, sl, False, *st_p)
            _assert_equal(got, want, sl, f"Q={Qq}, start lanes {sl is not None}, [{lo}, {hi})")
            st_k, st_p = got[1:], want[1:]


def test_kernel_emulated_chain_mixing_bodies(emu):
    """The chunked route's chain at 2 warps: each segment that
    flag_free_segments clears runs the flag-free body, the others the
    flag-aware instance, over a reference with resets at a segment's
    first diagonal and near another's end; the same bits as one plain
    carry chain, and as one plain pass over the whole reference."""
    rng = np.random.default_rng(11)
    Ds, S = 64, 7
    sl = torch.tensor(LANES[W, Q], dtype=torch.int32)
    B = sl.numel()
    q = torch.from_numpy(rng.standard_normal((B, Q)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((S, 1, Ds)).astype(np.float32))
    r = torch.zeros((S, 1, Ds))
    r[2, 0, 0] = 1.0   # segment 2's first diagonal; 3-5 see it in their window
    r[6, 0, 60] = 1.0  # near the last segment's end
    free = flag_free_segments(r.numpy(), Q).tolist()
    assert free == [True, True, False, False, False, False, False]
    st_k = st_p = wf.carry_fresh_state(B, Q, "cpu")
    parts = []
    for s in range(S):
        got = _carry(emu, q, y[s], r[s], sl, st_k, 2, noflag=free[s])
        want = wf.wavefront_plain(q, y[s], r[s], W - 1, sl, False, *st_p)
        _assert_equal(got, want, sl, f"segment {s}, flag-free {free[s]}")
        st_k, st_p = got[1:], want[1:]
        parts.append(got[0])
    one = wf.wavefront_plain(q, y.reshape(1, S * Ds), r.reshape(1, S * Ds), W - 1, sl)
    np.testing.assert_array_equal(_bits(torch.cat(parts, dim=1)), _bits(one))


def test_noflag_kernel_entry_refuses_shapes_not_built(emu):
    """The flag-free entry returns cudaErrorInvalidValue for a warp count
    or width it has no instance of, and for a lane outside Q."""
    q = torch.zeros((2, Q))
    y = torch.zeros((1, 8))
    st = wf.carry_fresh_state(2, Q, "cpu")
    outs = [torch.empty((2, 8))] + [torch.empty_like(t) for t in st]

    def call(Qx, lane, warps):
        return emu.sf_wavefront_carry_noflag(
            q.data_ptr(), y.data_ptr(), None, *(t.data_ptr() for t in st[:3]),
            *(t.data_ptr() for t in outs), 2, Qx, 8, lane, warps, None)

    assert all(call(Q, W - 1, w) == 1 for w in (1, 4, 8))
    assert call(384, W - 1, 2) == 1 and call(Q, Q, 2) == 1
    assert wf.noflag_built(Q, 2) and not any(wf.noflag_built(Q, w) for w in (1, 4, 8))
