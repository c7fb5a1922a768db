"""The benchmark of sigfish_tpu_torch, the PyTorch and CUDA mapper: run.py
runs one cell (a configuration under a traffic mix) and prints its
metrics; reference/ is the plain mapper that decides `correct`."""
