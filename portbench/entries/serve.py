"""Serving: closed-loop clients, threads of this process, each sending uint8
requests to one ``vfi_tpu_torch.api.VideoInpainter`` and waiting for the
uint8 reply before sending the next.

Traffic keys: ``clients``; ``batch`` clips per request of ``K`` preceding
and ``F`` following frames, asking for ``T``; ``distinct`` requests per
client, made from the seed in set-up and sent in turn; ``warmup`` requests
per client in set-up; ``quantize`` (``none`` or ``int8_static``: scales
calibrated in set-up on ``calib_clips`` clips, which a float cell's int8 control
calibrates on too); ``check_requests``, the
requests that the check recomputes; ``trace_seconds``, the traced window.
"""

from __future__ import annotations

import contextlib
import gc
import os
import random
import sys
import threading
import time

import numpy as np
import torch

from .. import inputs
from .. import trace as tracing
from ..counts import bounds, flops
from ..counts.peaks import peak
from ..judge import checks, serve_numbers
from ..reference.layers import calibrate, set_precision

QUANTIZE = {"none": None, "int8_static": "2"}


@contextlib.contextmanager
def _int8_env(mode):
    """``VFI_INT8`` as the port's ``create_model`` reads it, for the construction only."""
    saved = os.environ.pop("VFI_INT8", None)
    if mode is not None:
        os.environ["VFI_INT8"] = mode
    try:
        yield
    finally:
        os.environ.pop("VFI_INT8", None)
        if saved is not None:
            os.environ["VFI_INT8"] = saved


def _model_space(u8: np.ndarray, device) -> torch.Tensor:
    """uint8 frames (RGB or one channel) -> the model's float32 [-1, 1] input, BGR."""
    x = torch.from_numpy(u8).to(device).float() / 255.0
    if x.shape[-1] == 3:
        x = x.flip(-1)
    return x * 2.0 - 1.0


@torch.no_grad()
def reference_values(model, pre: np.ndarray, fol: np.ndarray, T: int, device) -> np.ndarray:
    """The reference's served frames before rounding: ``clip((pred+1)/2, 0, 1) * 255``, RGB, float64."""
    dtype = next(model.parameters()).dtype
    pred = model(T, _model_space(pre, device).to(dtype), _model_space(fol, device).to(dtype))["pred"]
    v = (torch.clamp((pred.double() + 1.0) / 2.0, 0.0, 1.0) * 255.0)
    if v.shape[-1] == 3:
        v = v.flip(-1)
    return v.cpu().numpy()


class ReferenceInpainter:
    """The reference in the program's place (the control of an int8 cell)."""

    def __init__(self, model, device):
        self.model, self.device = model, device

    def inpaint(self, pre, fol, T):
        return np.round(reference_values(self.model, pre, fol, T, self.device)).astype(np.uint8)


def reference_model(cfg: dict, weights: dict, device, precision: str = "float32", calib=None, T: int = 0):
    """The plain reference on ``device`` in float32 (TF32 off), its convs in
    ``precision``, or all of it in ``bfloat16``: the yardstick of
    ``rms_vs_bf16``.  An int precision is calibrated on ``calib`` as the
    program's is, on activations in the configuration's dtype: each scale is
    one element's ``|x|``, which float32 and bf16 activations round apart."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = flops.generator(cfg).to(device)
    model.load_state_dict({k: v.float() for k, v in weights.items()})
    if precision == "bfloat16":
        return model.to(torch.bfloat16).eval()
    set_precision(model, precision)
    if precision in ("int8", "int4"):
        model.to(getattr(torch, cfg["dtype"]))
        with calibrate(model):
            reference_values(model, *calib, T, device)
        model.float()
    return model.eval()


def make_requests(cfg: dict, traffic: dict, gen: torch.Generator, device):
    """(requests[client][i] = (preceding, following) uint8 arrays, calibration clips)."""
    H, W = cfg["image_size"]
    C = cfg["model_kwargs"]["c_dim"]
    B, K, T, F = traffic["batch"], traffic["K"], traffic["T"], traffic["F"]
    n = traffic["clients"] * traffic["distinct"]
    n_cal = traffic.get("calib_clips", 0)
    clips = inputs.videos(n * B + n_cal, K + T + F, H, W, C, gen, device).cpu().numpy()
    split = lambda a: (np.ascontiguousarray(a[:, :K]), np.ascontiguousarray(a[:, K + T:]))  # noqa: E731
    reqs = [[split(clips[(c * traffic["distinct"] + i) * B:(c * traffic["distinct"] + i + 1) * B])
             for i in range(traffic["distinct"])] for c in range(traffic["clients"])]
    return reqs, split(clips[n * B:])


def program(cfg: dict, traffic: dict, weights: dict, device, calib, quantize: str):
    """The system under test: a VideoInpainter, int8 scales calibrated where asked."""
    from vfi_tpu_torch.api import VideoInpainter
    from vfi_tpu_torch.nn import quant

    dtype = getattr(torch, cfg["dtype"])
    mode = QUANTIZE[quantize]
    with _int8_env(mode):
        ip = VideoInpainter({"class": cfg["model_class"], "kwargs": cfg["model_kwargs"]},
                            {k: v.to(dtype) for k, v in weights.items()}, device=device, dtype=dtype)
    if mode == "2":
        with quant.calibrate(ip.model):
            ip.inpaint(*calib, traffic["T"])
    return ip


def _clients(infer, reqs, T, until, spans: bool, records: list, counts: list):
    """Run every client until ``until`` (perf_counter seconds) or ``counts[c]``
    requests; each completion is ``(client, request, sent, done, output or None)``."""
    barrier = threading.Barrier(len(reqs))

    def loop(c):
        barrier.wait()
        i = 0
        while (until is None or time.perf_counter() < until) and (counts is None or i < counts[c]):
            pre, fol = reqs[c][i % len(reqs[c])]
            sent = time.perf_counter()
            try:
                with (torch.profiler.record_function("portbench.request") if spans else contextlib.nullcontext()):
                    out = infer(pre, fol, T)
            except Exception as e:  # a failed request counts as missing; the run goes on
                print(f"portbench: request failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
                out = None
            records.append((c, i % len(reqs[c]), sent, time.perf_counter(), out))
            i += 1

    threads = [threading.Thread(target=loop, args=(c,)) for c in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def run(cell, seed: int, seconds: int, trace: bool, device, hooks=None, control=None, check_only=False) -> dict:
    """One run; ``control`` (the correctness control) puts the program's
    ``int8_static`` path (``"program_int8"``) or the reference in int4
    (``"reference_int4"``) in the program's place; ``hooks["inpaint"]``
    wraps the served call (the tests' planted faults).  ``check_only`` is
    for the training entry's sake: serving needs its window to check."""
    from ..bench import process_age_s

    cfg, traffic = cell.config, cell.traffic
    T, B = traffic["T"], traffic["batch"]
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        shapes = flops.generator(cfg)
    weights = {k: v.to(getattr(torch, cfg["dtype"])) for k, v in
               inputs.weights(shapes, gen, device, cfg["model_kwargs"]["ks"]).items()}
    reqs, calib = make_requests(cfg, traffic, gen, device)
    quantize = traffic.get("quantize", "none")
    if control == "reference_int4":
        ip = ReferenceInpainter(reference_model(cfg, weights, device, "int4", calib, T), device)
    else:
        ip = program(cfg, traffic, weights, device, calib, "int8_static" if control == "program_int8" else quantize)
    infer = ip.inpaint if hooks is None or "inpaint" not in hooks else hooks["inpaint"](ip.inpaint)
    # One request alone first: the port builds its kernels at their first
    # launch, and two threads building one library race on its file.
    _clients(infer, reqs[:1], T, None, False, [], [1])
    _clients(infer, reqs, T, None, False, [], [traffic["warmup"]] * traffic["clients"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age_s()

    records: list = []
    window = min(seconds, traffic["trace_seconds"]) if trace else seconds
    spans = tracing.layer_spans(ip.model) if trace and control is None else contextlib.nullcontext()
    with tracing.profiled(trace) as prof, spans:
        with torch.profiler.record_function(tracing.WINDOW):
            _clients(infer, reqs, T, time.perf_counter() + window, trace, records, None)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ok = [r for r in records if r[4] is not None]
    first, last = min(r[2] for r in records), max(r[3] for r in records)
    lat = np.array([(r[3] - r[2]) * 1e3 if r[4] is not None else np.inf for r in records])
    out = {"attempted": len(records), "failed": len(records) - len(ok), "memory_peak_bytes": memory_peak,
           "setup_s": setup_s,
           "e2e": {"serve_frames_per_s": len(ok) * B * T / (last - first),
                   "serve_p90_ms": float(np.percentile(lat, 90)), "setup_s": setup_s}}

    rnd = random.Random(seed)
    sample = rnd.sample(ok, min(traffic["check_requests"], len(ok)))
    checked = [(reqs[c][i], o) for c, i, _, _, o in sample]
    del ip, infer, records, ok, sample
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if trace:
        out["trace"] = tracing.Trace(prof)
        out["counts"] = _counts(cfg, traffic, out["attempted"] - out["failed"], device)
    precision = "int8" if quantize == "int8_static" else "float32"
    ref = reference_model(cfg, weights, device, precision, calib, T)
    want = [reference_values(ref, pre, fol, T, device) for (pre, fol), _ in checked]
    del ref
    bf16 = None
    if "rms_vs_bf16" in cell.limits:
        # The yardstick: the reference run in bfloat16 against the float32 one.
        base = want
        if precision != "float32":
            ref = reference_model(cfg, weights, device)
            base = [reference_values(ref, pre, fol, T, device) for (pre, fol), _ in checked]
            del ref
        yard = reference_model(cfg, weights, device, "bfloat16")
        bf16 = [(reference_values(yard, pre, fol, T, device), b) for ((pre, fol), _), b in zip(checked, base)]
        del yard
    out["readings"] = serve_numbers([(o, w) for (_, o), w in zip(checked, want)], bf16)
    out["checks"] = checks(out["readings"], cell.limits)
    return out


def _counts(cfg: dict, traffic: dict, requests: int, device) -> dict:
    """The work of the traced requests, from the reference at their shapes."""
    pk = peak(torch.cuda.get_device_name(device)) if device.type == "cuda" else None
    if pk is None:
        return {"requests": requests}
    B, K, T, F = traffic["batch"], traffic["K"], traffic["T"], traffic["F"]
    work = flops.serve(cfg, B, K, T, F)
    elem = torch.tensor([], dtype=getattr(torch, cfg["dtype"])).element_size()
    int8 = traffic.get("quantize", "none") != "none"
    dense = work.flops - (work.conv_flops if int8 else 0.0) + work.sepconv_flops
    per = dense / (pk.bf16 if elem == 2 else pk.f32) + (work.conv_flops / pk.int8 if int8 else 0.0)
    counts = {"requests": requests, "at_peak_s": per * requests,
              "sepconv_bound_s": requests * sum(bounds.sepconv_fwd_s(*s, elem, pk) for s in work.sepconv)}
    if int8:
        counts["qconv_bound_s"] = requests * sum(bounds.qconv_s(*c, elem, elem, pk) for c in work.conv_calls)
    return counts
