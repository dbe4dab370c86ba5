"""Benchmarks of the port, run as modules (``python -m
cedarsim_tpu_torch.benchmarks.<name>``)."""
