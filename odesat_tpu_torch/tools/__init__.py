"""Measurement tools of the port, run as ``python -m odesat_tpu_torch.tools.<name>``."""
