"""Command-line tools of the port (``python -m tossctr_tpu_torch.tools.<name>``)."""
