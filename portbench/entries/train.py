"""Training: ``TAIEnvironment.train_step(state, K, T, F, targets)`` as the
port's train CLI calls it, on batches kept resident on the card as its
device cache keeps them, each step taking the first K+T+F frames.

Traffic keys: ``batch``; ``K``, ``T``, ``F``, each ``[lo, hi]``: a cycle
visits every (K, T, F) of their product once, in an order drawn from the
seed (stratified sampling of the train CLI's ``--sample_KTF``); ``resident``
batches of hi K+T+F frames, used in turn, their clips' contrast rising
over each batch from ``contrast[0]`` to ``contrast[1]`` (so that a step on
part of the batch shows in its loss); ``print_freq``, the steps between
reads of the loss terms; ``trace_steps``, the traced window.  Set-up runs
one whole cycle, its first three steps checked; the window runs whole
cycles, as many as come nearest to ``--seconds``.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import math
import time

import torch

from .. import inputs
from .. import trace as tracing
from ..counts import bounds, flops
from ..counts.peaks import peak
from ..judge import checks, train_numbers
from ..reference import train as ref_train
from ..reference.layers import set_precision

CHECKED_STEPS = 3


def triples(traffic: dict) -> list:
    return list(itertools.product(*(range(traffic[k][0], traffic[k][1] + 1) for k in ("K", "T", "F"))))


def cycles(traffic: dict, seed: int):
    """Every triple once per cycle, each cycle in its own order drawn from ``seed``."""
    order = torch.Generator().manual_seed(seed)
    every = triples(traffic)
    while True:
        yield [every[i] for i in torch.randperm(len(every), generator=order).tolist()]


def _hyper(cfg: dict) -> ref_train.Hyper:
    t = cfg["train"]
    return ref_train.Hyper(t["lr"], t["beta1"], t["alpha"], t["beta"])


class Program:
    """The system under test: the port's training environment and state."""

    def __init__(self, cfg: dict, traffic: dict, gw: dict, dw: dict, device, hooks=None):
        from vfi_tpu_torch.models.registry import create_model
        from vfi_tpu_torch.train.environments import create_training_environment, mean_terms
        from vfi_tpu_torch.utils.config import TrainConfig

        t = cfg["train"]
        tc = TrainConfig(K=traffic["K"][1], T=traffic["T"][1], F=traffic["F"][1], lr=t["lr"], beta1=t["beta1"],
                         alpha=t["alpha"], beta=t["beta"], df_dim=t["df_dim"], Ip=t["Ip"],
                         disc_window_size=t["disc_window_size"], train_dtype=cfg["train_dtype"])
        self.env = create_training_environment(create_model({"class": cfg["model_class"],
                                                             "kwargs": cfg["model_kwargs"]}), tc)
        self.state = self.env.init_state(tuple(cfg["image_size"]), device=device)
        self.state.generator.load_state_dict(gw)
        self.state.discriminator.load_state_dict(dw)
        self._mean_terms = mean_terms
        self.call = self.env.train_step if not hooks or "train_step" not in hooks else \
            hooks["train_step"](self.env.train_step)
        self.beta1 = t["beta1"]

    def step(self, K, T, F, targets):
        self.state, self.terms = self.call(self.state, K, T, F, targets)

    def losses(self) -> dict:
        t = self._mean_terms(self.terms)
        return {"G": t["G_loss"], "D": t["D_fake"] + t["D_real"]}

    def leaves(self):
        s = self.state
        for prefix, net, opt in (("G.", s.generator, s.g_opt), ("D.", s.discriminator, s.d_opt)):
            for name, p in net.named_parameters():
                yield prefix + name, p, opt.state.get(p, {}).get("exp_avg")

    def free(self):
        del self.env, self.state, self.call, self.terms


class Reference:
    """The plain reference's step, in float32 (TF32 off), its convs in
    ``precision``, or all of it in ``bfloat16``: the yardstick of the first
    gradient's gaps."""

    def __init__(self, cfg: dict, gw: dict, dw: dict, device, precision: str = "float32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.G, self.D = flops.generator(cfg).to(device), flops.discriminator(cfg).to(device)
        self.G.load_state_dict(gw)
        self.D.load_state_dict(dw)
        self.dtype = torch.float32
        if precision == "fp8":
            ref_train.set_fp8(self.G, self.D)
        elif precision == "bfloat16":
            self.dtype = torch.bfloat16
            self.G.to(self.dtype)
            self.D.to(self.dtype)
        else:
            set_precision(self.G, precision)
        self.hp = _hyper(cfg)
        self.window = cfg["train"]["disc_window_size"]
        self.opt_g, self.opt_d = ref_train.Adam(self.G.parameters(), self.hp), ref_train.Adam(self.D.parameters(), self.hp)
        self.beta1 = self.hp.beta1

    def step(self, K, T, F, targets):
        self.terms, _, _ = ref_train.train_step(self.G, self.D, self.opt_g, self.opt_d, K, T, F,
                                                targets.to(self.dtype), self.hp, self.window)

    def losses(self) -> dict:
        t = {k: float(v) for k, v in self.terms.items()}
        return {"G": t["G_loss"], "D": t["D_fake"] + t["D_real"]}

    def leaves(self):
        for prefix, net, opt in (("G.", self.G, self.opt_g), ("D.", self.D, self.opt_d)):
            m = dict(zip(map(id, opt.params), opt.m))
            for name, p in net.named_parameters():
                yield prefix + name, p, m[id(p)] if opt.t else None

    def free(self):
        del self.G, self.D, self.opt_g, self.opt_d


def checked_steps(side, first: list, data: list, start: dict) -> dict:
    """Steps 1-3 of ``side`` with its readings: each step's losses, the
    first gradient's norm per leaf (Adam's first moment after step 1 over
    1 - beta1) and each leaf's change after step 3 from ``start``."""
    readings = {"losses": []}
    for s, (K, T, F) in enumerate(first[:CHECKED_STEPS]):
        side.step(K, T, F, data[s % len(data)][:, : K + T + F])
        readings["losses"].append(side.losses())
        if s == 0:
            readings["grad"] = {n: (0.0 if m is None else float(m.norm()) / (1 - side.beta1))
                                for n, _, m in side.leaves()}
    readings["update"] = {n: float((p.detach().float() - start[n]).norm()) for n, p, _ in side.leaves()}
    return readings


def run(cell, seed: int, seconds: int, trace: bool, device, hooks=None, control=None, check_only=False) -> dict:
    """One run; ``control="reference_fp8"`` puts the reference with fp8 conv
    operands in the program's place; ``hooks["train_step"]`` wraps the
    environment's step (the tests' planted faults); ``check_only`` stops
    after the three checked steps and compares them."""
    from ..bench import process_age_s

    cfg, traffic = cell.config, cell.traffic
    H, W = cfg["image_size"]
    C = cfg["model_kwargs"]["c_dim"]
    B = traffic["batch"]
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        gs, ds = flops.generator(cfg), flops.discriminator(cfg)
    gw = inputs.weights(gs, gen, device, cfg["model_kwargs"]["ks"])
    dw = inputs.weights(ds, gen, device)
    frames = traffic["K"][1] + traffic["T"][1] + traffic["F"][1]
    data = [inputs.to_model(inputs.videos(B, frames, H, W, C, gen, device, traffic.get("contrast")))
            for _ in range(traffic["resident"])]
    start = {f"G.{k}": v for k, v in gw.items()} | {f"D.{k}": v for k, v in dw.items()}

    side = Reference(cfg, gw, dw, device, "fp8") if control == "reference_fp8" else \
        Program(cfg, traffic, gw, dw, device, hooks)
    order = cycles(traffic, seed)
    first = next(order)
    prog_readings = checked_steps(side, first, data, start)
    if check_only:
        side.free()
        del side
        out = {"attempted": CHECKED_STEPS, "failed": 0, "e2e": {}}
        _check(out, cfg, gw, dw, device, first, data, start, prog_readings, cell)
        return out
    for s, (K, T, F) in enumerate(first[CHECKED_STEPS:], CHECKED_STEPS):
        side.step(K, T, F, data[s % len(data)][:, : K + T + F])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age_s()

    steps, done, failed, traced = 0, [], 0, []
    spans = tracing.layer_spans() if trace and control is None else contextlib.nullcontext()
    with tracing.profiled(trace) as prof, spans:
        with torch.profiler.record_function(tracing.WINDOW):
            t0 = time.perf_counter()
            for cycle in order:
                c0 = time.perf_counter()
                for K, T, F in (cycle[: traffic["trace_steps"]] if trace else cycle):
                    with torch.profiler.record_function("portbench.step") if trace else contextlib.nullcontext():
                        side.step(K, T, F, data[steps % len(data)][:, : K + T + F])
                    steps += 1
                    traced.append((K, T, F))
                    if steps % traffic["print_freq"] == 0:
                        done.append(side.losses())
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                now = time.perf_counter()
                if trace or now - t0 + (now - c0) / 2 >= seconds:
                    break
            window_s = time.perf_counter() - t0
    failed = sum(1 for d in done if not all(map(math.isfinite, d.values())))
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    side.free()
    del side
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    out = {"attempted": steps, "failed": failed, "memory_peak_bytes": memory_peak, "setup_s": setup_s,
           "e2e": {"train_ms_per_step": window_s * 1e3 / steps, "setup_s": setup_s}}
    if trace:
        out["trace"] = tracing.Trace(prof)
        out["counts"] = _counts(cfg, B, traced, device, traffic)
    _check(out, cfg, gw, dw, device, first, data, start, prog_readings, cell)
    return out


def _check(out, cfg, gw, dw, device, first, data, start, prog_readings, cell) -> None:
    """The reference's three steps, and the first of the reference in bfloat16
    (the yardstick); ``out``'s readings and checks."""
    ref = Reference(cfg, gw, dw, device)
    ref_readings = checked_steps(ref, first, data, start)
    ref.free()
    yard = Reference(cfg, gw, dw, device, "bfloat16")
    yard_readings = checked_steps(yard, first[:1], data, start)
    yard.free()
    out["readings"] = train_numbers(prog_readings, ref_readings, yard_readings)
    out["checks"] = checks(out["readings"], cell.limits)
    out["steps"] = {"program": prog_readings, "reference": ref_readings, "yardstick": yard_readings}


def _counts(cfg: dict, B: int, traced: list, device, traffic: dict) -> dict:
    """The work of the traced steps, from the reference at their shapes."""
    pk = peak(torch.cuda.get_device_name(device)) if device.type == "cuda" else None
    if pk is None:
        return {"steps": len(traced)}
    elem = 2 if cfg["train_dtype"] == "bfloat16" else 4
    rate = pk.bf16 if elem == 2 else pk.f32
    at_peak = sepconv = 0.0
    works = {}
    for ktf in traced:
        if ktf not in works:
            works[ktf] = flops.train(cfg, B, *ktf)
        w = works[ktf]
        at_peak += (w.flops + w.sepconv_flops) / rate
        sepconv += sum(bounds.sepconv_fwd_s(*s, elem, pk) + bounds.sepconv_bwd_vh_s(*s, elem, pk)
                       + bounds.sepconv_bwd_x_s(*s, elem, pk) for s in w.sepconv)
    return {"steps": len(traced), "at_peak_s": at_peak, "sepconv_bound_s": sepconv}
