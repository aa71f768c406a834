"""Measurement tools of the port (run as ``python -m regard3d_tpu_torch.tools.<name>``)."""
