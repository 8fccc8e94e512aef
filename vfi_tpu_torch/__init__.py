"""vfi_tpu_torch — the PyTorch/CUDA port of vfi_tpu for NVIDIA Hopper.

Module paths and class names mirror ``vfi_tpu`` so each counterpart is easy to
find.  Public functions keep vfi_tpu's layouts (videos ``[B, T, H, W, C]`` in
[-1, 1]; sepconv operands NHWC / kernels-last); modules compute in NCHW
internally.  The package imports ``torch`` only.

Serving entry point: :class:`vfi_tpu_torch.api.VideoInpainter`.  Command-line
entry points, each ``python -m vfi_tpu_torch.cli.<name>``: ``predict``,
``compute_quant_results`` and ``train``; ``import_torch_checkpoint`` (a
reference snapshot into the port's layout) and ``summarize_quant_results``
(tables and plots of results.npz files); and the figure and animation tools
on predict's PNGs and results.npz files (host code, PIL; matplotlib, imageio
or OpenCV where a figure or video needs one): ``animate_qual_results``,
``generate_comparison_videos``, ``compare_visual_results``,
``compare_intermediate_preds``, ``generate_unified_boxplot_fig`` and
``paper_figures``.
"""
