"""The port's ALU-rate probe (ops/alu_peak.py) against the JAX package's
peak_kernel (scripts/bench_vpu_peak.py:101-158).

That kernel is nested in the script's main() and timed through the TPU
profiler, so it cannot be called here. The plain probe is held, mode by
mode and bit for bit, to a numpy transcription of its body at small
`iters`, cited line by line below. The CUDA kernel is held to the plain
probe on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sigfish_tpu_torch.ops import alu_peak as ap

B = 8


def _peak_body_numpy(x: np.ndarray, mode: str, iters: int) -> np.ndarray:
    """bench_vpu_peak.py's peak_kernel for one grid step (o_ref = x_ref
    at g == 0, :107-109), with pltpu.roll(v, 1, axis=1) as np.roll."""
    CH = 4                                                        # :99
    a = [x + np.float32(i) for i in range(CH)]                    # :111
    b = x * np.float32(0.5)                                       # :112
    mask = x > np.float32(0.5)                                    # :113-115
    for _ in range(iters):                                        # :116
        if mode == "add":                                         # :121-124
            for c in range(0, CH, 2):
                a[c] = a[c] + a[c + 1]
                a[c + 1] = a[c + 1] + a[c]
        elif mode == "min":                                       # :125-128
            for c in range(0, CH, 2):
                a[c] = np.minimum(a[c], a[c + 1])
                a[c + 1] = np.minimum(a[c + 1], a[c])
        elif mode == "select":                                    # :129-132
            for c in range(0, CH, 2):
                a[c] = np.where(mask, a[c + 1], a[c])
                a[c + 1] = np.where(mask, a[c], a[c + 1])
        elif mode == "roll":                                      # :133-134
            a = [np.roll(v, 1, axis=1) for v in a]
        else:                                                     # :135-152
            n_ch = 1 if mode == "mix" else 2
            for c in range(n_ch):
                a1, b2 = a[2 * c], a[2 * c + 1]
                up = np.roll(a1, 1, axis=1)
                ld = np.where(mask, b, np.minimum(a1, b2))
                local = np.abs(a1 - b)
                anew = local + np.minimum(up, ld)
                anew = np.where(mask, local, anew)
                a[2 * c], a[2 * c + 1] = anew, up
    acc = a[0]                                                    # :155-158
    for v in a[1:]:
        acc = acc + v
    return acc


@pytest.mark.parametrize("iters", [0, 1, 7, 40])
@pytest.mark.parametrize("mode", ap.MODES)
def test_plain_probe_bitwise_vs_jax_body(mode, iters):
    x = np.random.default_rng(iters).random((B, ap.Q), np.float32)
    want = _peak_body_numpy(x, mode, iters)
    before = ap.alu_peak.launches
    got = ap.alu_peak(torch.from_numpy(x), mode, iters)
    assert ap.alu_peak.launches == before  # CPU: the plain version, no launch
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, ap.Q)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_op_count_table():
    """CH = 4 ops per value and iteration for the single-op modes, the
    wavefront step's 8 for mix and 16 for mix2 (bench_vpu_peak.py:187)."""
    assert ap.MODES == ("add", "min", "select", "roll", "mix", "mix2")
    assert ap.OPS_PER_ITER == {"add": 4, "min": 4, "select": 4, "roll": 4, "mix": 8, "mix2": 16}
    assert ap.op_count("mix", 512, 64) == 512 * 256 * 64 * 8
    assert ap.op_count("mix2", 2, 3, q=32) == 2 * 32 * 3 * 16


def test_gops_arithmetic():
    """Gop/s = B * Q * iters * ops per iteration / seconds / 1e9, as the
    JAX script computes it (bench_vpu_peak.py:188)."""
    assert ap.gops("add", 512, 1000, 1e-3) == pytest.approx(512 * 256 * 1000 * 4 / 1e-3 / 1e9)
    assert ap.gops("mix2", 512, 1000, 2e-3) == pytest.approx(2 * ap.gops("mix", 512, 1000, 2e-3))
    # 1 ms per launch of 4096 mix iterations at (512, 256) is 4.29 Top/s
    assert ap.gops("mix", 512, 4096, 1e-3) == pytest.approx(4294.967296)


def test_step_count_matches_the_wavefront_cell():
    """A mix step is one wavefront DP cell: mix does one per value and
    iteration, mix2 two. Its 8 JAX-unit ops are the cell's 7 arithmetic
    operations (sdtw_wavefront.OPS_PER_CELL) plus the roll."""
    from sigfish_tpu_torch.ops.sdtw_wavefront import OPS_PER_CELL

    assert OPS_PER_CELL == 7
    assert ap.STEPS_PER_ITER == {"mix": 1, "mix2": 2}
    for mode in ap.STEPS_PER_ITER:
        assert ap.OPS_PER_ITER[mode] == (OPS_PER_CELL + 1) * ap.STEPS_PER_ITER[mode]
    assert ap.step_count("mix2", 512, 10) == 2 * ap.step_count("mix", 512, 10) == 2 * 512 * 256 * 10


def test_probe_refuses_bad_input():
    x = torch.zeros((4, ap.Q))
    with pytest.raises(ValueError, match="mode"):
        ap.alu_peak(x, "fma", 1)
    with pytest.raises(ValueError, match="float32"):
        ap.alu_peak(torch.zeros((4, 128)), "add", 1)
    with pytest.raises(ValueError, match="iters"):
        ap.alu_peak(x, "add", -1)


def test_bench_needs_a_card(monkeypatch):
    """The bench fails without a card: no CPU fallback."""
    from sigfish_tpu_torch.scripts import bench_alu_peak

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_alu_peak.main([])
