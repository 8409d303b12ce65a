"""Diagnostic scripts of the port, run as
``python -m falcon_unzip_tpu_torch.scripts.<name>``."""
