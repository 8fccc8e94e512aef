"""Entry points of the port, run as ``python -m vfi_tpu_torch.cli.<name>``."""
