"""Measurement tools of the port (``python -m xiaoicesing_io_tpu_torch.tools.<name>``)."""
