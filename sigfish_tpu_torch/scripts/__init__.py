"""Measurement scripts of the port, run as `python -m sigfish_tpu_torch.scripts.<name>`."""
