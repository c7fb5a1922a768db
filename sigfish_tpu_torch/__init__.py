"""sigfish_tpu_torch: the PyTorch/CUDA port of sigfish-tpu.

Maps raw nanopore current signals (S/BLOW5) to a reference FASTA without
basecalling, using subsequence DTW in event space, on one NVIDIA Hopper
GPU (H100, sm_90a).

Layout:
  - host (numpy / C++): BLOW5 decode, pA conversion, event segmentation,
    adaptor/polyA detection, backtrack, output formatting -- the
    package's own copies of the JAX package's host modules
  - device (PyTorch + hand-written CUDA): the batched anti-diagonal
    wavefront sDTW kernel (csrc/wavefront.cu) and the window top-5
    candidate reduction as torch ops

The package imports torch and numpy only: never jax, never sigfish_tpu.
Its entry points run on the GPU unless the caller passes device="cpu",
which routes every kernel wrapper to its plain PyTorch version.
"""

__version__ = "0.2.0"  # capability parity with sigfish 0.2.0 (SAM @PG VN)

SIGFISH_TPU_VERSION = __version__
