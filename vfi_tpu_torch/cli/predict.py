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
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np
import torch

from ..api import resolve_device
from ..data.datasets import ContiguousVideoClipDataset, DisjointVideoClipDataset, batch_iterator
from ..data.prefetch import Prefetcher
from ..models.registry import create_model
from ..ops.image import BGR_LUMA, frames_from_uint8
from ..ops.metrics import quantize_uint8
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
    listopt(opt)
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
    cuda = device.type == "cuda"
    if cuda and device.index is None and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} GPUs visible: prediction over several GPUs is not ported yet "
            "(ROADMAP.md queue 1 item 9); pick one with --device cuda:N")
    if cuda and device.index is not None:
        torch.cuda.set_device(device)
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    print(f"device {device}, dtype {opt.dtype}, TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
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
    print(f"# testing videos = {len(ds)}")

    model = create_model(opt.model_key)
    env = create_eval_environment(model, TrainConfig(K=opt.K, T=opt.T, F=opt.F))
    if env.needs_snapshot:
        # Snapshots hold the whole training state; serving needs the generator.
        payload, _ = ckpt.load_snapshot(os.path.join(opt.checkpoints_dir, opt.name), opt.snapshot_file_name)
        model.load_state_dict(payload["generator"])
        del payload
    model.to(device=device, dtype=dtype).eval()

    def host_normalize(u8: np.ndarray) -> np.ndarray:
        """uint8 BGR -> the dataset's float pipeline ([-1,1], gray if c_dim=1);
        used under --device_normalize for the GT PNG writes."""
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
        print(f"processed {n_done}/{len(ds)} clips", flush=True)

    batches = Prefetcher(batch_iterator(ds, opt.batch_size, False, False, num_workers=opt.num_threads), depth=2)
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
        if opt.profile_steps is not None:
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
            print(f"padded final batch {n_real} -> {opt.batch_size} "
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
        print(f"predicted {n_done} clips in {dt_loop:.2f} s "
              f"({n_done / dt_loop:.2f} clips/s, inflight={depth})", flush=True)
        print(f"forward {forward_s:.2f} s ({forward_s / dt_loop:.1%} of the loop) on {device}; host: waiting for "
              f"data {times['wait_data_s']:.2f} s, writing PNGs {times['write_s']:.2f} s (of which waiting for "
              f"the device {times['wait_device_s']:.2f} s, normalizing GT frames {times['normalize_s']:.2f} s)",
              flush=True)
    if prof is not None:  # STOP batch never reached (short dataset) — close the trace
        stop_trace()
    print("predictions written to", opt.qual_result_root)
    return dict(clips=n_done, batches=n_batch, inflight=depth, loop_s=dt_loop, forward_s=forward_s,
                trace=trace_path, **times)


if __name__ == "__main__":
    main()
