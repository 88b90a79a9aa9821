"""Experiments of the port: counterparts of the JAX package's scripts/ of
the same names, run as `python -m tpunerf_torch.scripts.<name>`."""
