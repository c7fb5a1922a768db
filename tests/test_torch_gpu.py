"""The port's CUDA kernels on the card, each held bit for bit to its
plain PyTorch version. Every test here carries the `gpu` marker and
skips without a CUDA device. The card's machine has no jax, so run
these without the repository's conftest:

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigfish_tpu_torch.ops import layout
from sigfish_tpu_torch.ops import sdtw_wavefront as wf


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the wavefront kernel runs only on the card")
    return torch.device("cuda")


def _case(seed, W, Q):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(50, 900, size=4)
    tracks = [rng.standard_normal(int(s)).astype(np.float32) for s in sizes]
    ref, reset, _ = layout.pad_tracks(tracks, ckpt=512, align=W)
    qlens = rng.integers(1, W + 1, size=40)
    qlens[::3] = W
    qlist = [rng.standard_normal(int(n)).astype(np.float32) for n in qlens]
    qb, qlens, _ = layout.make_query_batch(qlist, pad_q=Q)
    qb_k, fs = layout.shift_queries_for_clip(qb, qlens, W - 1)
    ypad, rspad, _ = layout.prepare_wavefront_inputs(ref, reset, Q)
    return qb_k, fs, ypad, rspad, W - 1


@pytest.mark.gpu
@pytest.mark.parametrize("W,Q", [(100, 128), (250, 256), (300, 384), (500, 512)])
@pytest.mark.parametrize("std", [False, True])
def test_wavefront_kernel_bitwise_vs_plain(cuda_device, W, Q, std):
    """Every Q the pipeline pads to, clipped reads and std included; the
    launch is counted once."""
    qb, fs, ypad, rspad, lane = _case(W + Q, W, Q)
    q, y, r, sl = (torch.from_numpy(a).to(cuda_device) for a in (qb, ypad, rspad, fs))
    before = wf.sdtw_wavefront.launches
    got = wf.sdtw_wavefront(q, y, r, lane, start_lanes=sl, std=std)
    torch.cuda.synchronize()
    assert wf.sdtw_wavefront.launches == before + 1
    want = wf.wavefront_plain(q, y, r, lane, sl, std)
    assert torch.equal(got.view(torch.int32).cpu(), want.view(torch.int32).cpu())


@pytest.mark.gpu
def test_wavefront_kernel_refuses_unbuilt_width(cuda_device):
    """A CUDA tensor never falls back to the plain version."""
    q = torch.zeros((4, 96), device=cuda_device)
    y = torch.zeros((1, 512), device=cuda_device)
    with pytest.raises(ValueError, match="kernel takes"):
        wf.sdtw_wavefront(q, y, y.clone(), 50)
