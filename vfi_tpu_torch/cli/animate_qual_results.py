"""Per-clip GIF generation (counterpart of vfi_tpu's
``cli/animate_qual_results.py``, the reference's animate_qual_results.py).

    python -m vfi_tpu_torch.cli.animate_qual_results QUAL_ROOT [--create_gt_gif] [--num_workers N]

Writes ``pred_final.gif`` (and ``gt.gif``) into every clip folder ``--depth``
levels below QUAL_ROOT.  Needs PIL and imageio; runs on the host.  With more
than one worker and clip the folders are shared out over a
``multiprocessing`` pool of spawned processes (a forked child of a process
that has loaded torch's threads is unsafe); a worker imports only this module
and ``eval/animate.py``.
"""

import argparse
import multiprocessing

from ..eval.animate import animate_clip_folder


def _job(args):
    path, fps, create_gt = args
    animate_clip_folder(path, fps=fps, create_gt_gif=create_gt)


def main(argv=None):
    # eval/quant imports torch; here, and not at the top, so the pool's workers do not.
    from ..eval.quant import get_folder_paths_at_depth

    p = argparse.ArgumentParser()
    p.add_argument("qual_results_root", type=str)
    p.add_argument("--depth", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=multiprocessing.cpu_count())
    p.add_argument("--fps", type=int, default=3)
    p.add_argument("--create_gt_gif", action="store_true")
    p.add_argument("--high_quality", action="store_true", help="accepted for CLI parity (no-op)")
    args = p.parse_args(argv)

    roots = get_folder_paths_at_depth(args.qual_results_root, args.depth)
    if not roots:
        print("Failed to find any qualitative results. Quitting...")
        return
    print("Now animating qualitative results...")
    jobs = [(r, args.fps, args.create_gt_gif) for r in roots]
    if args.num_workers > 1 and len(jobs) > 1:
        with multiprocessing.get_context("spawn").Pool(args.num_workers) as pool:
            list(pool.imap_unordered(_job, jobs))
    else:
        for j in jobs:
            _job(j)
    print("Done animating qualitative results.")


if __name__ == "__main__":
    main()
