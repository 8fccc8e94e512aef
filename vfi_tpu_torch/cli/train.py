"""Training entry point (counterpart of vfi_tpu's ``cli/train.py``), one process.

    python -m vfi_tpu_torch.cli.train @exp_args/default_args/KTH/train.txt @exp_args/extra_args/KTH/bi-TAI.txt

The flags, the printed lines, the ``--log_json`` events (``resume``, ``iter``,
``save``, ``val``, ``best``, ``done``), the snapshots under
``<checkpoints_dir>/<name>/`` (``model_latest.ckpt``, ``model_%08d.ckpt``,
``model_best.ckpt`` on the val set's summed SSIM) and the TensorBoard tags are
vfi_tpu's.  Where it differs:

  * ``--device`` (default ``cuda``; without a GPU the CPU must be asked for).
    ``--train_dtype float32`` turns TF32 off for matmuls and cuDNN; ``main``
    puts both settings back as it found them when it returns or raises.
  * ``--sample_KTF`` runs the static step at each sampled (K, T, F) on the
    batch's first K+T+F frames.  vfi_tpu pads every step to the largest
    lengths only so that XLA compiles one program; its padded step equals
    the static one.
  * Python's ``random`` (the training set's crops and flips) is seeded from
    ``--seed`` before the prefetch thread starts; vfi_tpu seeds it after its
    thread has drawn the first batches, so those race.
  * Without a snapshot, the weights are a fresh xavier init drawn under
    ``torch.manual_seed(--seed)``: vfi_tpu's distribution, not its values.
  * Several processes are launched by torchrun, one rank per card, as
    PyTorch does (``parallel/mesh.py``; vfi_tpu runs one process per host
    over its devices):

        torchrun --nproc_per_node N -m vfi_tpu_torch.cli.train ...

    Each rank reads its own shard of the videolist, ``--batch_size`` is per
    rank (the global batch is N times it), every update averages its
    gradients over the ranks, and every rank holds the same weights and
    optimizer state (broadcast from rank 0 after the init or the resume).
    Rank 0 alone prints, writes ``train_opt.txt``, TensorBoard, ``--log_json``
    and snapshots, and decides whether to resume; the printed terms are the
    means over the ranks, and each validation sweep gathers every rank's
    rows before the best-snapshot decision.  ``--mesh_shape`` must be (N,)
    or (N, 1).
  * The writer is ``torch.utils.tensorboard``'s, where tensorboard imports;
    the PSNR-curve images need matplotlib too, and are left out without it.
  * ms/it leaves out the time of the ``train_vis`` grid's forward, as vfi_tpu
    leaves out snapshots and validation: it stays a step-time series.
  * Each ``iter`` event also holds ``lr``, the learning rate of that
    iteration's generator update (Super SloMo's decays with the step).

``main`` returns the run's counts and host seconds: waiting for the
prefetcher, copying and normalising batches, dispatching the steps (which
includes any wait for the device inside a step), the sync at each print, the
``train_vis`` grids, and each validation sweep; and the ms/it of each print
window, on every rank.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import time

import numpy as np
import torch

from ..api import resolve_device
from ..data.datasets import ContiguousVideoClipDataset, batch_iterator
from ..data.prefetch import Prefetcher
from ..models.registry import create_model
from ..ops.image import frames_from_uint8
from ..parallel.mesh import (allgather_rows, broadcast_object, init_distributed, is_main, make_mesh, rank,
                             replicate_state, shutdown, world_size)
from ..train.environments import create_eval_environment, create_training_environment, mean_terms
from ..utils import checkpoint as ckpt
from ..utils.config import TrainConfig, build_train_parser, listopt, parse_args
from ..utils.visuals import draw_err_plot, visual_grid


def make_writer(log_dir: str):
    """A TensorBoard writer, or None where tensorboard is not installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=log_dir)


def prediction_grid(eval_env, seq: np.ndarray, K: int, T: int, device) -> np.ndarray:
    """The TensorBoard grid of one batch's predictions: ``seq`` [B, K+T+F, H,
    W, C] in [-1, 1], context frames bordered green, middle frames red."""
    pre, fol = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (seq[:, :K], seq[:, K + T:]))
    pred = eval_env.forward_test(T, pre, fol)["pred"].float().cpu().numpy()
    vis = {"pred_vis_seq": np.concatenate([seq[:, :K], pred, seq[:, K + T:]], axis=1), "target_vis_seq": seq}
    return visual_grid(vis, K, T)


def compute_errors(eval_env, loader, K: int, T: int, F: int, device, group=None):
    """A validation sweep: per-video PSNR/SSIM/L2 curves ``[N, T]`` (numpy).
    With a (gloo) process ``group``, each rank sweeps its own shard and the
    curves of every rank are gathered, in rank order, on every rank; a rank
    with an empty shard contributes no row and still joins the gather."""
    psnrs, ssims, l2s = [], [], []
    for batch in loader:
        m = eval_env.eval_metrics(K, T, F, batch["targets"], device=device)
        psnrs.append(m["psnr"].cpu().numpy())
        ssims.append(m["ssim"].cpu().numpy())
        l2s.append(m["l2"].cpu().numpy())
    out = tuple(np.concatenate(x) if x else np.zeros((0, T), np.float32) for x in (psnrs, ssims, l2s))
    return out if group is None else tuple(allgather_rows(a, group) for a in out)


def main(argv=None) -> dict:
    opt = parse_args(build_train_parser(), argv)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if opt.train_dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(opt)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _train(opt) -> dict:
    device = resolve_device(opt.device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    groups = init_distributed(device)
    try:
        return _run(opt, device, groups)
    finally:
        shutdown(groups)


def _run(opt, device, groups) -> dict:
    """The training run of one rank (of one process without ``groups``)."""
    cuda = device.type == "cuda"
    main, world, shard = is_main(), world_size(), rank()
    dgroup, hgroup = (groups.device, groups.host) if groups is not None else (None, None)
    say = print if main else (lambda *args, **kwargs: None)
    if groups is not None:
        say(f"data parallel: mesh (data, model) = {make_mesh(opt.mesh_shape)}, --batch_size {opt.batch_size} per "
            f"rank, global batch {opt.batch_size * world}", flush=True)

    expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
    if main:
        os.makedirs(expr_dir, exist_ok=True)
        listopt(opt)
        with open(os.path.join(expr_dir, "train_opt.txt"), "w") as f:
            listopt(opt, f)
    say(f"device {device}, train_dtype {opt.train_dtype}, TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    writer, log_fh, train_iter, prof = None, None, None, None
    try:
        if main:
            tb_dir = os.path.join(opt.tensorboard_dir, opt.name)
            os.makedirs(tb_dir, exist_ok=True)
            writer = make_writer(tb_dir)
        plots = importlib.util.find_spec("matplotlib") is not None
        if writer and not plots:
            print("matplotlib is not installed: TensorBoard gets no PSNR-curve images")
        if writer:
            rows = "\n".join(f"{k} | {v}" for k, v in sorted(vars(opt).items()))
            writer.add_text("args", "Key | Value\n--- | ---\n" + rows)
        if opt.log_json and main:
            log_fh = open(opt.log_json, "a", buffering=1)

        def log_json(**event):
            if log_fh is not None:
                log_fh.write(json.dumps({"time": time.time(), **event}) + "\n")

        random.seed(opt.seed)  # the training set's crop and flip draws, before the prefetch thread starts
        train_ds = ContiguousVideoClipDataset(
            opt.c_dim, opt.train_video_list_path, opt.K + opt.T + opt.F, not opt.no_backwards, not opt.no_flip,
            opt.image_size, True, opt.padding_size, opt.data_root, emit_uint8=opt.device_normalize,
        )
        train_iter = Prefetcher(batch_iterator(train_ds, opt.batch_size, not opt.serial_batches, True,
                                               seed=opt.seed, num_shards=world, shard_index=shard, loop=True,
                                               num_workers=opt.num_threads), depth=2)
        say(f"# training videos = {len(train_ds)}")

        def val_loader(path, t_mid, k, f):
            if path is None:
                return None
            return ContiguousVideoClipDataset(opt.c_dim, path, k + t_mid + f, False, False, opt.image_size, False,
                                              opt.padding_size, opt.data_root)

        val_sets = {
            "val": (val_loader(opt.val_video_list_path, opt.T, opt.K, opt.F), opt.K, opt.T, opt.F),
            "val_alt_T": (val_loader(opt.val_video_list_alt_T_path, opt.alt_T, opt.K, opt.F), opt.K, opt.alt_T,
                          opt.F),
            "val_alt_K_F": (val_loader(opt.val_video_list_alt_K_F_path, opt.T, opt.alt_K, opt.alt_F), opt.alt_K,
                            opt.T, opt.alt_F),
        }
        vis_sets = {
            "val": val_loader(opt.vis_video_list_path, opt.T, opt.K, opt.F),
            "val_alt_T": val_loader(opt.vis_video_list_alt_T_path, opt.alt_T, opt.K, opt.F),
            "val_alt_K_F": val_loader(opt.vis_video_list_alt_K_F_path, opt.T, opt.alt_K, opt.alt_F),
        }

        torch.manual_seed(opt.seed)  # the fresh init of a run without a snapshot
        model = create_model(opt.model_key)
        if opt.remat and hasattr(model, "mcnet"):
            model.mcnet.remat = True
        cfg = TrainConfig.from_opt(opt)
        env = create_training_environment(model, cfg, dgroup)

        def prep_targets(host: np.ndarray) -> torch.Tensor:
            """A host batch on the device as [-1, 1] float32 frames; under
            --device_normalize uint8 crosses and is normalised there."""
            t = torch.from_numpy(np.ascontiguousarray(host))
            t = t.pin_memory().to(device, non_blocking=True) if cuda else t
            return frames_from_uint8(t, opt.c_dim) if opt.device_normalize else t

        # The first batch sizes the state, as in vfi_tpu; drawing it keeps the
        # batch sequence in step with vfi_tpu's.
        sample = next(train_iter)
        dev_cache, host_cache = None, None
        if opt.device_cache:
            host_cache = [next(train_iter) for _ in range(opt.device_cache)]
            dev_cache = [prep_targets(b["targets"]) for b in host_cache]
            mb = sum(t.numel() * t.element_size() for t in dev_cache) / 1e6
            say(f"device cache: {len(dev_cache)} batches resident (~{mb:.0f} MB/device)")
        H, W = sample["targets"].shape[2:4]
        state = env.init_state((H, W), device=device, seed=opt.seed)
        del sample
        n_params = sum(p.numel() for p in state.generator.parameters())
        say(f"# generator params = {n_params / 1e6:.2f}M")

        total_updates = 0
        best_sum_psnr, best_sum_ssim = 0.0, 0.0
        # Rank 0's snapshot decides for every rank, which may not see rank 0's
        # files: ranks that ran different numbers of steps would deadlock.
        if broadcast_object(main and ckpt.has_snapshot(expr_dir, "model_latest.ckpt"), hgroup):
            counters = None
            if main:
                print("Loading latest snapshot...")
                state, counters = ckpt.load_snapshot(expr_dir, "model_latest.ckpt", state)
            counters = broadcast_object(counters, hgroup)
            total_updates = int(counters["updates"])
            best_sum_psnr = float(counters["sum_avg_psnr_err"])
            best_sum_ssim = float(counters["sum_avg_ssim_err"])
            log_json(event="resume", iter=total_updates, sum_psnr=best_sum_psnr, sum_ssim=best_sum_ssim)
        replicate_state(state, groups)  # rank 0's weights, optimizer state and random generator on every rank
        eval_env = create_eval_environment(state.generator, cfg)  # the generator as it trains

        rng = np.random.RandomState(opt.seed)
        times = {"wait_data_s": 0.0, "prep_s": 0.0, "step_s": 0.0, "sync_s": 0.0, "vis_s": 0.0}
        val_s, ms_per_it, iters, trace_path = [], [], 0, None
        t_start = time.time()
        while total_updates < opt.max_iter:
            if opt.profile_steps is not None and main:
                start, stop = opt.profile_steps
                if total_updates + 1 == start:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if cuda:
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    prof = torch.profiler.profile(activities=activities)
                    prof.start()
                    trace_path = os.path.join(opt.profile_dir, f"train_steps_{start}-{stop}.pt.trace.json")
                elif total_updates + 1 == stop and prof is not None:
                    trace_path = _stop_trace(prof, trace_path, cuda)
                    prof = None

            t0 = time.perf_counter()
            if dev_cache is not None:
                ci = total_updates % len(dev_cache)
                batch, cached = host_cache[ci], dev_cache[ci]  # the host copy feeds only the TB grid
            else:
                batch, cached = next(train_iter), None
            t1 = time.perf_counter()
            K, T, F = env.sample_ktf(rng, opt.sample_KTF)
            if cached is not None:
                targets = cached if cached.shape[1] == K + T + F else cached[:, : K + T + F]
            else:
                targets = prep_targets(batch["targets"][:, : K + T + F])
            t2 = time.perf_counter()
            state, errors = env.train_step(state, K, T, F, targets)
            t3 = time.perf_counter()
            times["wait_data_s"] += t1 - t0
            times["prep_s"] += t2 - t1
            times["step_s"] += t3 - t2
            total_updates += 1
            iters += 1

            if total_updates % opt.print_freq == 0:
                t4 = time.perf_counter()
                errors = mean_terms(errors, dgroup)  # waits for the device; every rank's mean
                times["sync_s"] += time.perf_counter() - t4
                dt = (time.time() - t_start) / opt.print_freq
                t_start = time.time()
                ms_per_it.append(dt * 1000)
                msg = " ".join(f"{k}: {v:.4f}" for k, v in sorted(errors.items()))
                say(f"iter {total_updates} ({dt * 1000:.0f} ms/it) {msg}", flush=True)
                log_json(event="iter", iter=total_updates, ms_per_it=dt * 1000, K=K, T=T, F=F,
                         lr=state.g_opt.param_groups[0]["lr"], **errors)
                if writer:
                    t_vis = time.time()
                    for k, v in errors.items():
                        writer.add_scalar(f"loss/{k}", v, total_updates)
                    writer.add_scalar("time_per_item", dt, total_updates)
                    seq = batch["targets"][:, : K + T + F]
                    if opt.device_normalize:
                        seq = prep_targets(seq).cpu().numpy()
                    writer.add_image("train_vis", prediction_grid(eval_env, seq, K, T, device).transpose(2, 0, 1),
                                     total_updates)
                    times["vis_s"] += time.time() - t_vis
                    t_start += time.time() - t_vis  # keep ms/it a step-time series

            if total_updates % opt.save_latest_freq == 0 and main:
                counters = {"updates": total_updates, "sum_avg_psnr_err": best_sum_psnr,
                            "sum_avg_ssim_err": best_sum_ssim}
                t_save = time.time()
                ckpt.save_snapshot(expr_dir, "model_latest.ckpt", state, counters)
                ckpt.save_snapshot(expr_dir, f"model_{total_updates:08d}.ckpt", state, counters)
                log_json(event="save", iter=total_updates, seconds=time.time() - t_save)
                t_start += time.time() - t_save  # keep ms/it a step-time series

            if total_updates % opt.validate_freq == 0:
                t_val = time.time()
                for tag, (ds, k, t_mid, f) in val_sets.items():
                    if ds is None:
                        continue
                    loader = batch_iterator(ds, opt.batch_size, False, False, num_shards=world, shard_index=shard)
                    psnr_c, ssim_c, _ = compute_errors(eval_env, loader, k, t_mid, f, device, hgroup)
                    if writer:
                        writer.add_scalar(f"{tag}/avg_psnr", float(psnr_c.mean()), total_updates)
                        writer.add_scalar(f"{tag}/avg_ssim", float(ssim_c.mean()), total_updates)
                        if plots:
                            writer.add_image(f"{tag}/psnr_curve", draw_err_plot(psnr_c, "PSNR").transpose(2, 0, 1),
                                             total_updates)
                        vis_ds = vis_sets.get(tag)
                        if vis_ds is not None and len(vis_ds) > 0:
                            seq = next(batch_iterator(vis_ds, min(opt.batch_size, len(vis_ds)), False, False))
                            grid = prediction_grid(eval_env, seq["targets"], k, t_mid, device)
                            writer.add_image(f"samples/{tag}", grid.transpose(2, 0, 1), total_updates)
                    say(f"[{tag}] iter {total_updates}: psnr {psnr_c.mean():.3f} ssim {ssim_c.mean():.4f}")
                    log_json(event="val", tag=tag, iter=total_updates, psnr=float(psnr_c.mean()),
                             ssim=float(ssim_c.mean()), videos=len(psnr_c))
                    if tag == "val":
                        sum_psnr = float(psnr_c.mean(axis=0).sum())
                        sum_ssim = float(ssim_c.mean(axis=0).sum())
                        if sum_ssim > best_sum_ssim:  # the same on every rank: the rows are global
                            best_sum_psnr, best_sum_ssim = sum_psnr, sum_ssim
                            if main:
                                ckpt.save_snapshot(expr_dir, "model_best.ckpt", state,
                                                   {"updates": total_updates, "sum_avg_psnr_err": sum_psnr,
                                                    "sum_avg_ssim_err": sum_ssim})
                                print(f"new best (sum ssim {sum_ssim:.4f}) -> model_best.ckpt")
                                log_json(event="best", iter=total_updates, sum_psnr=sum_psnr, sum_ssim=sum_ssim)
                val_s.append(time.time() - t_val)
                t_start += val_s[-1]  # keep ms/it a step-time series

        if prof is not None:  # the STOP iteration was never reached
            trace_path = _stop_trace(prof, trace_path, cuda)
            prof = None
        say("training done")
        log_json(event="done", iter=total_updates)
        return dict(iters=iters, updates=total_updates, val_s=val_s, trace=trace_path, tensorboard=writer is not None,
                    rank=shard, world=world, ms_per_it=ms_per_it, **times)
    finally:
        if prof is not None:
            prof.stop()
        if train_iter is not None:
            train_iter.close()
        if writer is not None:
            writer.close()
        if log_fh is not None:
            log_fh.close()


def _stop_trace(prof, trace_path: str, cuda: bool) -> str:
    if cuda:
        torch.cuda.synchronize()  # the traced steps' device work lands in the trace
    prof.stop()
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    print(f"profiler trace written to {trace_path}")
    return trace_path


if __name__ == "__main__":
    main()
