"""Runnable examples of the port (``python -m blades_tpu_torch.examples.<name>``)."""
