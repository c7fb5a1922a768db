"""The port's wavefront sDTW (sigfish_tpu_torch/ops/sdtw_wavefront.py)
against the JAX package's Pallas kernel in interpret mode, bit for bit:
the plain PyTorch version runs the same f32 operations in the same
order, and min is exact, so the tolerance is 0.

On the CPU the wrapper runs the plain version. The CUDA kernel is held
to that version on the card (tests/test_torch_gpu.py, and chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sigfish_tpu.ops.sdtw_pallas import sdtw_wavefront as jax_wavefront
from sigfish_tpu_torch.ops import layout
from sigfish_tpu_torch.ops import sdtw_wavefront as wf


def _case(seed, W=32, Q=64, td=64):
    """Random multi-track layout with resets and a batch mixing
    full-length and clipped reads, laid out as the pipeline does."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(20, 260, size=int(rng.integers(2, 5)))
    tracks = [rng.standard_normal(int(s)).astype(np.float32) for s in sizes]
    ref, reset, _ = layout.pad_tracks(tracks, ckpt=td, align=W)
    qlens = [W, 11, W - 5, W, 1, W, int(rng.integers(2, W))]
    qlist = [rng.standard_normal(n).astype(np.float32) for n in qlens]
    qb, qlens, _ = layout.make_query_batch(qlist, pad_q=Q)
    qb_k, fs = layout.shift_queries_for_clip(qb, qlens, W - 1)
    ypad, rspad, _ = layout.prepare_wavefront_inputs(ref, reset, Q, td=td)
    return qb_k, fs, ypad, rspad, W - 1, td


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("std", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_bitwise_vs_pallas_interpret(seed, std):
    qb, fs, ypad, rspad, lane, td = _case(seed)
    want = jax_wavefront(
        jnp.asarray(qb), jnp.asarray(ypad), jnp.asarray(rspad), lane=lane,
        td=td, start_lanes=jnp.asarray(fs), std=std, interpret=True,
    )
    before = wf.sdtw_wavefront.launches
    got = wf.sdtw_wavefront(
        torch.from_numpy(qb), torch.from_numpy(ypad), torch.from_numpy(rspad),
        lane, start_lanes=torch.from_numpy(fs), std=std,
    )
    assert wf.sdtw_wavefront.launches == before  # CPU: no kernel launch
    assert got.shape == (qb.shape[0], ypad.shape[1]) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_plain_without_start_lanes_bitwise():
    """start_lanes=None is every read free-starting at lane 0."""
    qb, _, ypad, rspad, lane, td = _case(7)
    want = jax_wavefront(
        jnp.asarray(qb), jnp.asarray(ypad), jnp.asarray(rspad), lane=lane,
        td=td, interpret=True,
    )
    got = wf.sdtw_wavefront(
        torch.from_numpy(qb), torch.from_numpy(ypad), torch.from_numpy(rspad), lane
    )
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_wrapper_rejects_bad_inputs():
    qb, fs, ypad, rspad, lane, _ = _case(3)
    q, y, r = (torch.from_numpy(a) for a in (qb, ypad, rspad))
    with pytest.raises(ValueError):
        wf.sdtw_wavefront(q, y, r, lane=qb.shape[1])
    with pytest.raises(TypeError):
        wf.sdtw_wavefront(q.double(), y, r, lane)
    with pytest.raises(ValueError):
        wf.sdtw_wavefront(q, y[0], r[0], lane)
