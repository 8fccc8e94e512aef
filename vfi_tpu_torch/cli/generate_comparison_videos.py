"""Stacked labeled GIFs comparing several experiments on the same clips
(counterpart of vfi_tpu's ``cli/generate_comparison_videos.py``, the
reference's generate_comparison_videos.py).

    python -m vfi_tpu_torch.cli.generate_comparison_videos --results_root R --exp_names A B \\
        --clip_names CLIP --save_root OUT

Reads ``R/images/<exp>/<clip>/*.png``; needs PIL and imageio.
"""

import argparse
import os

from PIL import Image

from ..eval.animate import files_matching, labeled_stack_frame, write_gif


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--results_root", type=str, required=True)
    p.add_argument("--exp_names", type=str, nargs="+", required=True)
    p.add_argument("--exp_labels", type=str, nargs="+", default=None)
    p.add_argument("--clip_names", type=str, nargs="+", required=True)
    p.add_argument("--save_root", type=str, required=True)
    p.add_argument("--fps", type=int, default=3)
    args = p.parse_args(argv)

    labels = args.exp_labels or args.exp_names
    assert len(labels) == len(args.exp_names)
    os.makedirs(args.save_root, exist_ok=True)

    for clip in args.clip_names:
        clip_dirs = [os.path.join(args.results_root, "images", e, clip) for e in args.exp_names]
        first = clip_dirs[0]
        sections = [
            (r"gt_preceding_[0-9]+\.png", "lime", "gt"),
            (r"pred_middle_[0-9]+\.png", "red", "pred"),
            (r"gt_following_[0-9]+\.png", "lime", "gt"),
        ]
        out_frames = []
        for pattern, color, kind in sections:
            names = [os.path.basename(f) for f in files_matching(first, pattern)]
            for name in names:
                if kind == "gt":
                    frames = [Image.open(os.path.join(first, name))] * len(clip_dirs)
                else:
                    frames = [Image.open(os.path.join(d, name)) for d in clip_dirs]
                out_frames.append(labeled_stack_frame(frames, labels, color))
        write_gif(out_frames, os.path.join(args.save_root, f"{clip}.gif"), args.fps)
        print(f"wrote {clip}.gif")


if __name__ == "__main__":
    main()
