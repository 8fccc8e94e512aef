"""Batch inference + PNG dump (counterpart of vfi_tpu's ``cli/predict.py``).

    python -m vfi_tpu_torch.cli.predict --K 5 --T 5 --F 5 --c_dim 1 --image_size 128 \\
        --model_key TAI_gray --name kth_bi-TAI --checkpoints_dir checkpoints \\
        --test_video_list_path list.txt --qual_result_root qual [--device cpu]

Reads the generator of the snapshot ``<checkpoints_dir>/<name>/<snapshot_file_name>``
(``utils/checkpoint.py``; ``scripts/convert_checkpoint_torch.py`` converts a
vfi_tpu snapshot) and writes per-clip folders under --qual_result_root with
the reference layout (predict.py:59-120): gt_preceding_<t>.png,
gt_middle_<t>.png, pred_middle_<t>.png, gt_following_<t>.png (+
pred_middle_forward/backward and interp_net_outputs_1/2 with
--intermediate_preds).  Padding added for the network is cropped off before
saving (predict.py:69-95).

Runs on ``--device`` (default ``cuda``; without a GPU the CPU must be asked
for).  ``--dtype float32`` turns TF32 off for matmuls and cuDNN, so float32
means float32; ``main`` puts both settings back as it found them when it
returns or raises.  Up to ``VFI_INFLIGHT`` batches (default 2) are in flight: a
batch's outputs are quantized to uint8 on the device and copied to pinned
host memory without blocking, and a CUDA event marks the copy; the batch's
PNGs are written once that event has passed, while later batches run.
Depth 1 is the synchronous loop.  ``main`` returns the run's counts and
times (clips, batches, loop, forward and host seconds).

``--quantize int8`` / ``int8_dynamic`` serve the int8 convs of
``nn/quant.py`` (static calibrated / per-call scales), as vfi_tpu's CLI
does: static scales are calibrated on the first ``--calib_clips`` clips, from
zero, at the serving dtype; then, unless ``--validate_quant 0``, the first
clips (4 by default, at most one batch) go through the quantized model at the
serving batch shape and through an unquantized float32 copy of the snapshot
(TF32 off), and a PSNR drop against the ground truth beyond
``--quant_tol_db`` (or, with ``--disjoint_clips``, an agreement under 30 dB)
exits with ``validate_quant REFUSED`` unless ``--force_quant``.  The
validation clips are among the calibration clips, as in vfi_tpu.

Several processes are launched by torchrun, one rank per card
(``parallel/mesh.py``; vfi_tpu splits each batch over the devices of one
process):

    torchrun --nproc_per_node N -m vfi_tpu_torch.cli.predict ...

Each rank predicts the clips ``rank::N`` of the list at ``--batch_size`` and
writes their folders (PNG paths come from the clip labels, so the ranks'
trees together are one process's tree), padding its own ragged final batch.
Under ``--quantize int8`` rank 0 calibrates and sends the scales to every
rank, and rank 0 runs the ``--validate_quant`` gate and sends its verdict,
so that every rank refuses or goes on.  The progress and closing lines are
each rank's, prefixed with it; rank 0 adds the total.
``cli.compute_quant_results`` then scores the whole tree in one process.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from collections import deque

import numpy as np
import torch

from ..api import resolve_device
from ..data.datasets import ContiguousVideoClipDataset, DisjointVideoClipDataset, batch_iterator
from ..data.prefetch import Prefetcher
from ..models.registry import create_model
from ..nn import quant
from ..ops.image import BGR_LUMA, frames_from_uint8
from ..ops.metrics import psnr, quantize_uint8, ssim
from ..parallel.mesh import allgather_rows, broadcast_, broadcast_object, init_distributed, is_main, rank, shutdown, \
    world_size
from ..train.environments import create_eval_environment
from ..utils import checkpoint as ckpt
from ..utils.config import TrainConfig, build_test_parser, listopt, parse_args
from ..utils.png import write_png

# --intermediate_preds: the model output written under each PNG prefix.
INTERMEDIATE_PREDS = (
    ("pred_forward", "pred_middle_forward"),
    ("pred_backward", "pred_middle_backward"),
    ("interp_net_outputs_1", "interp_net_outputs_1"),
    ("interp_net_outputs_2", "interp_net_outputs_2"),
)


def to_uint8(frames: torch.Tensor) -> torch.Tensor:
    """[-1, 1] frames -> uint8, the reference's PNG encoding (clamp, scale,
    round in float32) wherever the frames are; channels stay BGR."""
    return quantize_uint8(frames).to(torch.uint8)


def save_video_frames(frames_u8: np.ndarray, dest: str, prefix: str, start_t: int, H: int, W: int):
    """Write uint8 BGR [T, Hp, Wp, C] frames as RGB PNGs, cropping off padding (predict.py:103-120)."""
    os.makedirs(dest, exist_ok=True)
    if frames_u8.shape[-1] == 3:
        frames_u8 = frames_u8[..., ::-1]  # BGR -> RGB for PNG
    for i, frame in enumerate(frames_u8):
        write_png(os.path.join(dest, f"{prefix}_{start_t + i:04d}.png"), frame[:H, :W])


def main(argv=None) -> dict:
    opt = parse_args(build_test_parser(), argv, allow_unknown=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if opt.dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        return _predict(opt)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _predict(opt) -> dict:
    device = resolve_device(opt.device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    groups = init_distributed(device)
    try:
        return _serve(opt, device, groups)
    finally:
        shutdown(groups)


def _serve(opt, device, groups) -> dict:
    """The predictions of one rank (of one process without ``groups``)."""
    cuda = device.type == "cuda"
    main, world, shard = is_main(), world_size(), rank()
    dgroup, hgroup = (groups.device, groups.host) if groups is not None else (None, None)
    say = print if main else (lambda *args, **kwargs: None)
    tag = f"[rank {shard}] " if groups is not None else ""
    if main:
        listopt(opt)
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    say(f"device {device}, dtype {opt.dtype}, TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    if opt.disjoint_clips:
        ds = DisjointVideoClipDataset(
            opt.c_dim, opt.test_video_list_path, opt.K, opt.F, opt.image_size, opt.padding_size, opt.data_root,
            emit_uint8=opt.device_normalize,
        )
    else:
        ds = ContiguousVideoClipDataset(
            opt.c_dim, opt.test_video_list_path, opt.K + opt.T + opt.F, False, False,
            opt.image_size, False, opt.padding_size, opt.data_root,
            emit_uint8=opt.device_normalize,
        )
    say(f"# testing videos = {len(ds)}")

    validate_n = opt.validate_quant if opt.validate_quant is not None else (4 if opt.quantize != "none" else 0)
    model_fp = None
    if opt.quantize == "none":
        model = create_model(opt.model_key)  # VFI_INT8, where set, as in vfi_tpu
    else:  # --quantize decides, and the gate's reference model is float
        saved_int8 = os.environ.pop("VFI_INT8", None)
        try:
            model = quant.quantize_convs(create_model(opt.model_key), static=opt.quantize == "int8")
            if validate_n > 0 and main:
                model_fp = create_model(opt.model_key)
        finally:
            if saved_int8 is not None:
                os.environ["VFI_INT8"] = saved_int8
    env = create_eval_environment(model, TrainConfig(K=opt.K, T=opt.T, F=opt.F))
    if env.needs_snapshot:
        # Snapshots hold the whole training state; serving needs the generator.
        payload, _ = ckpt.load_snapshot(os.path.join(opt.checkpoints_dir, opt.name), opt.snapshot_file_name)
        model.load_state_dict(payload["generator"])
        if model_fp is not None:
            model_fp.load_state_dict(payload["generator"])
        del payload
    model.to(device=device, dtype=dtype).eval()

    def host_normalize(u8: np.ndarray) -> np.ndarray:
        """uint8 BGR -> the dataset's float pipeline ([-1,1], gray if c_dim=1);
        used under --device_normalize for the calibration and validation
        clips' float copies and the GT PNG writes."""
        x = u8.astype(np.float32) / 255.0
        if opt.c_dim == 1:
            x = (x @ np.asarray(BGR_LUMA, np.float32))[..., None]
        return x * 2.0 - 1.0

    K, T, F = opt.K, opt.T, opt.F
    H, W = opt.image_size
    keys = ["pred"] + [k for k, _ in INTERMEDIATE_PREDS if opt.intermediate_preds]

    def to_model(x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(x).to(device)
        # --device_normalize: uint8 crossed the host->device boundary; normalize here
        return frames_from_uint8(t, opt.c_dim, dtype=dtype) if opt.device_normalize else t.to(dtype)

    def context(clips: np.ndarray):
        """The preceding and following frames of stacked clips."""
        return clips[:, :K], (clips[:, K:] if opt.disjoint_clips else clips[:, K + T:])

    if opt.quantize == "int8" and env.needs_snapshot:
        # Static scales: the running max of each conv's |input| over the first
        # clips, from zero, in the serving dtype (nn/quant.py); on rank 0, and
        # sent from there to every rank.
        if main:
            n_cal = max(1, min(opt.calib_clips, len(ds)))
            cal = np.stack([ds[i]["targets"] for i in range(n_cal)])
            if opt.device_normalize:
                cal = host_normalize(cal)
            cp, cf = (torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype) for a in context(cal))
            with quant.calibrate(model):
                env.forward_test(T, cp, cf)
            del cal, cp, cf
            print(f"int8 activation scales calibrated on {n_cal} clips")
        amax = list(quant.act_amax_state(model).values())
        broadcast_(amax, dgroup)
        digest = hashlib.sha256(torch.stack(amax).float().cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"{tag}int8 activation scales sha256 {digest}", flush=True)
    if opt.quantize != "none" and validate_n > 0 and env.needs_snapshot and len(ds) > 0:
        verdict = None
        if main:
            verdict = _validate_quant(opt, ds, env, model_fp, device, validate_n, host_normalize, to_model, context)
        ok, detail = broadcast_object(verdict, hgroup)
        if groups is not None:
            print(f"{tag}validate_quant verdict of rank 0: {'passed' if ok else 'failed'}", flush=True)
        if not ok and not opt.force_quant:
            sys.exit(f"validate_quant REFUSED this checkpoint for {opt.quantize} "
                     f"serving: {detail}. Re-run with --force_quant to override, "
                     f"--quant_tol_db to widen the gate, or --validate_quant 0 "
                     f"to skip validation.")
        if not ok:
            say(f"validate_quant FAILED ({detail}) — proceeding (--force_quant)")
    del model_fp

    n_done = 0
    times = {"wait_data_s": 0.0, "write_s": 0.0, "wait_device_s": 0.0, "normalize_s": 0.0}
    forward_spans = []  # (start, end) CUDA events, or host seconds on the CPU

    def fetch(out: dict, n_real: int):
        """Start the copy of a batch's real rows, quantized on the device, to
        the host; returns the host tensors and the event that marks the copy."""
        host = {}
        for key in keys:
            if key not in out:
                continue
            u8 = to_uint8(out[key][:n_real])
            if cuda:
                host[key] = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
                host[key].copy_(u8, non_blocking=True)
            else:
                host[key] = u8
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return host, event

    def write_batch(host, event, targets, clip_labels):
        """Wait for one dispatched batch's copy and write its PNGs.  Called
        from the in-flight drain below."""
        nonlocal n_done
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        times["wait_device_s"] += time.perf_counter() - t0
        out = {k: v.numpy() for k, v in host.items()}
        if opt.device_normalize:
            # GT writes need the float pipeline's gray/[-1,1] encoding
            t1 = time.perf_counter()
            targets = host_normalize(targets)
            times["normalize_s"] += time.perf_counter() - t1

        gt = to_uint8(torch.from_numpy(targets)).numpy()
        for b, label in enumerate(clip_labels):
            dest = os.path.join(opt.qual_result_root, label)
            save_video_frames(gt[b, :K], dest, "gt_preceding", 0, H, W)
            save_video_frames(out["pred"][b], dest, "pred_middle", K, H, W)
            if not opt.disjoint_clips:
                save_video_frames(gt[b, K : K + T], dest, "gt_middle", K, H, W)
            save_video_frames(gt[b, -F:], dest, "gt_following", K + T, H, W)
            for key, prefix in INTERMEDIATE_PREDS:
                if key in out:
                    save_video_frames(out[key][b], dest, prefix, K, H, W)
        n_done += len(clip_labels)
        times["write_s"] += time.perf_counter() - t0
        print(f"{tag}processed {n_done}/{n_mine} clips", flush=True)

    n_mine = len(range(shard, len(ds), world))
    batches = Prefetcher(batch_iterator(ds, opt.batch_size, False, False, num_shards=world, shard_index=shard,
                                        num_workers=opt.num_threads), depth=2)
    depth = max(1, int(os.environ.get("VFI_INFLIGHT", "2")))
    inflight = deque()
    n_batch = 0
    prof = None
    trace_path = None

    def stop_trace():
        nonlocal prof
        prof.stop()
        os.makedirs(opt.profile_dir, exist_ok=True)
        prof.export_chrome_trace(trace_path)
        prof = None
        print(f"profiler trace written to {trace_path}")

    t_loop0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        times["wait_data_s"] += time.perf_counter() - t0
        if batch is None:
            break
        # Serving observability: trace a window of prediction batches (same
        # semantics as the train CLI's --profile_steps).
        n_batch += 1
        if opt.profile_steps is not None and main:
            start, stop = opt.profile_steps
            if n_batch == start:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if cuda:
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
                trace_path = os.path.join(opt.profile_dir, f"predict_batches_{start}-{stop}.pt.trace.json")
            elif n_batch == stop and prof is not None:
                # Drain (and so wait for) the in-flight batches before closing
                # the trace, so that the traced batches' device work lands in it.
                while inflight:
                    write_batch(*inflight.popleft())
                stop_trace()
        targets = batch["targets"]
        preceding = to_model(targets[:, :K])
        following = to_model(targets[:, -F:])
        n_real = len(targets)
        if n_real < opt.batch_size and not opt.no_pad_final_batch:
            # One batch shape for the whole run: pad the ragged final batch by
            # repeating the last clip.  write_batch writes the real clips only.
            pad = opt.batch_size - n_real
            preceding = torch.cat([preceding, preceding[-1:].expand(pad, *preceding.shape[1:])])
            following = torch.cat([following, following[-1:].expand(pad, *following.shape[1:])])
            print(f"{tag}padded final batch {n_real} -> {opt.batch_size} "
                  "(one batch shape; --no_pad_final_batch disables)", flush=True)
        if cuda:
            span = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            span[0].record()
            out = env.forward_test(T, preceding, following)
            span[1].record()
            forward_spans.append(span)
        else:
            t0 = time.perf_counter()
            out = env.forward_test(T, preceding, following)
            forward_spans.append(time.perf_counter() - t0)
        inflight.append((*fetch(out, n_real), targets, batch["clip_label"]))
        del out, preceding, following
        while len(inflight) >= depth:
            write_batch(*inflight.popleft())
    while inflight:
        write_batch(*inflight.popleft())
    dt_loop = time.perf_counter() - t_loop0
    forward_s = sum(s[0].elapsed_time(s[1]) / 1e3 if cuda else s for s in forward_spans)
    if n_done:
        print(f"{tag}predicted {n_done} clips in {dt_loop:.2f} s "
              f"({n_done / dt_loop:.2f} clips/s, inflight={depth})", flush=True)
        print(f"{tag}forward {forward_s:.2f} s ({forward_s / dt_loop:.1%} of the loop) on {device}; host: waiting for "
              f"data {times['wait_data_s']:.2f} s, writing PNGs {times['write_s']:.2f} s (of which waiting for "
              f"the device {times['wait_device_s']:.2f} s, normalizing GT frames {times['normalize_s']:.2f} s)",
              flush=True)
    if prof is not None:  # STOP batch never reached (short dataset) — close the trace
        stop_trace()
    if groups is not None:
        total = int(allgather_rows(np.asarray([[n_done]], np.float32), hgroup).sum())
        say(f"all {world} ranks: {total} of {len(ds)} clips predicted", flush=True)
    print(f"{tag}predictions written to", opt.qual_result_root)
    return dict(clips=n_done, batches=n_batch, inflight=depth, loop_s=dt_loop, forward_s=forward_s,
                trace=trace_path, rank=shard, world=world, **times)


def _validate_quant(opt, ds, env, model_fp, device, validate_n, host_normalize, to_model, context) -> tuple:
    """vfi_tpu's --validate_quant gate: the first clips through the quantized
    model (padded to the serving batch) and through ``model_fp``, the
    unquantized float32 model, with TF32 off.  Returns (passed, why not): the
    caller exits with ``validate_quant REFUSED`` when it failed, unless
    --force_quant."""
    K, T = opt.K, opt.T
    n_val = min(validate_n, len(ds), opt.batch_size)
    val = np.stack([ds[i]["targets"] for i in range(n_val)])
    val_f = host_normalize(val) if opt.device_normalize else val
    vq = val
    if n_val < opt.batch_size:
        vq = np.concatenate([vq, np.repeat(vq[-1:], opt.batch_size - n_val, axis=0)])
    pq, fq = (to_model(np.ascontiguousarray(a)) for a in context(vq))
    pred_q = env.forward_test(T, pq, fq)["pred"][:n_val].float()
    del pq, fq

    env_fp = create_eval_environment(model_fp.to(device=device, dtype=torch.float32).eval(),
                                     TrainConfig(K=K, T=T, F=opt.F))
    pf, ff = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in context(val_f))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        pred_fp = env_fp.forward_test(T, pf, ff)["pred"].float()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del env_fp, pf, ff

    q_u8, fp_u8 = quantize_uint8(pred_q), quantize_uint8(pred_fp)
    agree = float(psnr(q_u8, fp_u8, clamp=100.0).mean())
    if opt.disjoint_clips:
        print(f"validate_quant ({n_val} clips): quantized-vs-f32 prediction "
              f"agreement {agree:.2f} dB (no GT middles for metric deltas)")
        ok = agree >= 30.0
        detail = f"agreement {agree:.2f} dB < 30 dB"
    else:
        gt_u8 = quantize_uint8(torch.from_numpy(np.ascontiguousarray(val_f[:, K:K + T], np.float32)).to(device))
        psnr_q = float(psnr(q_u8, gt_u8, clamp=100.0).mean())
        psnr_fp = float(psnr(fp_u8, gt_u8, clamp=100.0).mean())
        ssim_q = float(ssim(q_u8, gt_u8).mean())
        ssim_fp = float(ssim(fp_u8, gt_u8).mean())
        print(f"validate_quant ({n_val} clips): PSNR f32 {psnr_fp:.3f} -> "
              f"quantized {psnr_q:.3f} dB (delta {psnr_q - psnr_fp:+.3f}); "
              f"SSIM {ssim_fp:.4f} -> {ssim_q:.4f} "
              f"(delta {ssim_q - ssim_fp:+.4f}); agreement {agree:.2f} dB")
        ok = psnr_q - psnr_fp >= -opt.quant_tol_db
        detail = f"PSNR drop {psnr_fp - psnr_q:.3f} dB > tolerance {opt.quant_tol_db} dB"
    return ok, detail


if __name__ == "__main__":
    main()
