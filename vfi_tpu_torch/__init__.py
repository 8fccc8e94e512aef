"""vfi_tpu_torch — the PyTorch/CUDA port of vfi_tpu for NVIDIA Hopper.

Module paths and class names mirror ``vfi_tpu`` so each counterpart is easy to
find.  Public functions keep vfi_tpu's layouts (videos ``[B, T, H, W, C]`` in
[-1, 1]; sepconv operands NHWC / kernels-last); modules compute in NCHW
internally.  The package imports ``torch`` only.

Serving entry point: :class:`vfi_tpu_torch.api.VideoInpainter`.  Command-line
entry points: ``python -m vfi_tpu_torch.cli.predict``, ``.compute_quant_results``
and ``.train``.
"""
