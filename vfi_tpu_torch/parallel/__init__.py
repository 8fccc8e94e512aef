"""Data parallelism over processes under ``torch.distributed`` (counterpart of
``vfi_tpu/parallel``): :mod:`vfi_tpu_torch.parallel.mesh`."""
