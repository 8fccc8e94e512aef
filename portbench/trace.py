"""The traced run: ``torch.profiler`` over the window, and what the per-layer
metrics read from it.

The benchmark opens its own spans (``record_function``): ``portbench.window``
around the whole window, one per request or step, and one around each call
of a layer it times (``portbench.sepconv`` around ``ops.sepconv.sepconv`` as
``nn/kernelnet`` calls it; ``portbench.qconv`` around each ``QConv``
forward).  A span's device time is that of every kernel launched inside it,
the profiler's link from a launch to its kernel; an autograd node's the
same (``SepConvBackward``).  Nothing here names a kernel.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
from typing import Callable, Optional

import torch
from torch.autograd import DeviceType

WINDOW = "portbench.window"
HOST = "host code outside CUDA calls"


@contextlib.contextmanager
def profiled(enabled: bool):
    """A CPU and CUDA profile when ``enabled``, else nothing."""
    if not enabled:
        yield None
        return
    from torch._C._profiler import _ExperimentalConfig

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # The profiler records host events of the thread that starts it alone,
    # unless asked for all: the serving clients are threads of their own.
    with torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False,
                                experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof


class _Launch(torch.autograd.Function):
    """A host op around a call: the profiler links a kernel to the innermost
    op open at its launch, and a span of ``record_function`` is none, so a
    kernel that the port launches through ctypes outside any op (the int8
    conv; sepconv launches inside its own autograd Function) is linked here."""

    @staticmethod
    def forward(ctx, fn, *args):
        return fn(*args)


@contextlib.contextmanager
def layer_spans(model=None):
    """``portbench.sepconv`` around each sepconv call of the port's kernel net
    and, where ``model`` has int8 convs, ``portbench.qconv`` around each one's
    forward, its kernel's launch inside an op."""
    from vfi_tpu_torch.nn import kernelnet, quant

    orig, orig_qconv = kernelnet.sepconv, quant.qconv_int8

    def sepconv(*args, **kwargs):
        with torch.profiler.record_function("portbench.sepconv"):
            return orig(*args, **kwargs)

    local = threading.local()

    def pre(m, args):
        local.rf = torch.profiler.record_function("portbench.qconv")
        local.rf.__enter__()

    def post(m, args, out):
        local.rf.__exit__(None, None, None)

    kernelnet.sepconv = sepconv
    quant.qconv_int8 = lambda *args: _Launch.apply(orig_qconv, *args)
    convs = quant.qconvs(model).values() if model is not None else ()
    hooks = [h for m in convs for h in (m.register_forward_pre_hook(pre), m.register_forward_hook(post))]
    try:
        yield
    finally:
        kernelnet.sepconv, quant.qconv_int8 = orig, orig_qconv
        for h in hooks:
            h.remove()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _device_us(e) -> float:
    return sum(k.duration for k in e.kernels) + sum(_device_us(c) for c in e.cpu_children)


class Trace:
    """The events of one profile, in microseconds of the profiler's clock."""

    def __init__(self, prof):
        events = prof.events()
        self.cpu = [e for e in events if e.device_type == DeviceType.CPU]
        # A host span that launched work also shows on the device's timeline
        # under its own name (a user annotation): it is no device operation.
        host_names = {e.name for e in self.cpu}
        self.dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in host_names
                    and not getattr(e, "is_user_annotation", False)]
        windows = [e for e in self.cpu if e.name == WINDOW]
        if not windows:
            raise RuntimeError(f"the profile holds no {WINDOW} span")
        self.t0, self.t1 = windows[0].time_range.start, windows[0].time_range.end
        inside = [(max(e.time_range.start, self.t0), min(e.time_range.end, self.t1)) for e in self.dev]
        self.busy = _merge([(s, e) for s, e in inside if e > s])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def device_s(self, match: Callable[[str], bool]) -> Optional[float]:
        """Device seconds of the kernels launched inside the outermost CPU
        events whose name ``match``es, within the window; None if there is none."""
        total, found = 0.0, False
        for e in self.cpu:
            if not match(e.name) or not self.t0 <= e.time_range.start <= self.t1:
                continue
            parent, nested = e.cpu_parent, False
            while parent is not None:
                if match(parent.name):
                    nested = True
                    break
                parent = parent.cpu_parent
            if not nested:
                found = True
                total += _device_us(e)
        return total / 1e6 if found else None

    def span_s(self, name: str) -> Optional[float]:
        return self.device_s(lambda n: n == name)

    def memcpy_s(self) -> float:
        return sum(min(e.time_range.end, self.t1) - max(e.time_range.start, self.t0)
                   for e in self.dev if "memcpy" in e.name.lower() and e.time_range.end > self.t0
                   and e.time_range.start < self.t1) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing: the innermost host event open at
        the gap's start under the benchmark's own span, on the thread that
        opened it last."""
        by_name: dict = {}
        for e in self.dev:
            if self.t0 <= e.time_range.start <= self.t1:
                by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        starts = sorted((e.time_range.start, i) for i, e in enumerate(self.cpu))
        keys = [s for s, _ in starts]
        labelled = []
        for length, t in gaps:
            best = None
            for _, i in starts[: bisect.bisect_right(keys, t)]:
                e = self.cpu[i]
                if e.time_range.end > t and (best is None or e.time_range.start >= best.time_range.start):
                    best = e
            labelled.append([_label(best), length / 1e6])
        return {"device_ops": [[n[:64], s] for n, s in ops], "idle_gaps": labelled}


def _label(e) -> str:
    if e is None:
        return HOST
    outer = e
    while outer.cpu_parent is not None:
        outer = outer.cpu_parent
    top = outer.name.replace("portbench.", "")
    return f"{top}:{HOST if e is outer else e.name}"
