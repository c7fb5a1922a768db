"""The port's candidate reduction (sigfish_tpu_torch/ops/candidates_dev.py)
against the JAX package's device_window_top5 / device_topk_candidates:
the packed (B, 2k) buffers must be bitwise equal, ties included -- the
first minimum wins inside a window, the latest window wins across
windows. Scores are small integers, so ties are everywhere."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sigfish_tpu.ops.candidates_dev import device_topk_candidates, device_window_top5
from sigfish_tpu_torch.ops import layout
from sigfish_tpu_torch.ops.candidates_dev import topk_candidates, window_top5


def _layout(rng, W):
    sizes = rng.integers(1, 5 * W, size=int(rng.integers(2, 6)))
    tracks = [np.zeros(int(s), np.float32) for s in sizes]
    ref, _, offs = layout.pad_tracks(tracks, ckpt=64, align=W)
    R = ref.shape[0]
    u, valid = layout.build_column_maps(offs, R, track_sizes=[int(s) for s in sizes])
    return R, u, valid


def _scores(rng, B, D):
    sc = rng.integers(0, 12, size=(B, D)).astype(np.float32)
    sc[0] = 7.0                        # one row of ties only
    sc[1, ::3] = 0.0                   # equal minima in many windows
    sc[2] = np.float32(3.0e38)         # no candidate at all
    return sc


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k", [5, 3])
def test_window_top5_bitwise(seed, k):
    rng = np.random.default_rng(seed)
    W = int(rng.integers(4, 24))
    R, _, valid = _layout(rng, W)
    D = R + 64
    sc = _scores(rng, 9, D)
    B = sc.shape[0]
    want = device_window_top5(
        jnp.asarray(sc), jnp.full((B,), W, jnp.int32), jnp.asarray(valid), R,
        W=W, k=k, reindex=True, pack=True,
    )
    got = window_top5(torch.from_numpy(sc), torch.from_numpy(valid), R, W,
                      k=k, reindex=True, pack=True)
    assert got.shape == (B, 2 * k)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the unpacked form agrees with the packed one
    ts, tp = window_top5(torch.from_numpy(sc), torch.from_numpy(valid), R, W, k=k)
    gs, gp = layout.unpack_top5(got.numpy(), k=k)
    np.testing.assert_array_equal(ts.numpy(), gs)
    np.testing.assert_array_equal(tp.numpy(), gp)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("reindex", [True, False])
def test_topk_candidates_bitwise(seed, reindex):
    rng = np.random.default_rng(50 + seed)
    W = int(rng.integers(6, 24))
    R, u, valid = _layout(rng, W)
    D = R + 64
    sc = _scores(rng, 9, D)
    B = sc.shape[0]
    qlens = rng.integers(1, W + 1, size=B).astype(np.int32)
    qlens[3] = W
    qlens[4] = 1
    want = device_topk_candidates(
        jnp.asarray(sc), jnp.asarray(qlens), jnp.asarray(u), jnp.asarray(valid),
        R, W=W, k=5, reindex=reindex, pack=True,
    )
    got = topk_candidates(
        torch.from_numpy(sc), torch.from_numpy(qlens), torch.from_numpy(u),
        torch.from_numpy(valid), R, k=5, reindex=reindex, pack=True,
    )
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_topk_candidates_full_width_matches_window_top5():
    """At qlen == W the per-read windows are the uniform ones."""
    rng = np.random.default_rng(9)
    W = 16
    R, u, valid = _layout(rng, W)
    sc = _scores(rng, 6, R + 64)
    qlens = np.full(6, W, np.int32)
    a = window_top5(torch.from_numpy(sc), torch.from_numpy(valid), R, W, pack=True)
    b = topk_candidates(torch.from_numpy(sc), torch.from_numpy(qlens),
                        torch.from_numpy(u), torch.from_numpy(valid), R, pack=True)
    np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))
