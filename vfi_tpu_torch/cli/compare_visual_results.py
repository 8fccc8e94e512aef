"""Side-by-side model comparison figures and videos (counterpart of
vfi_tpu's ``cli/compare_visual_results.py``).

    python -m vfi_tpu_torch.cli.compare_visual_results --results_root R --dataset_name D \\
        --clip_names CLIP --exp_names A B --total_num_frames 15 --dest_path OUT [--video_type mp4] [--no_pdf]

Reference: compare_visual_results.py — same flag surface and artifact set:
  * create_pdfs (:160-274): per-clip PDF grid, one row per experiment plus a
    ground-truth row, one column per --frame_indexes entry, yellow borders on
    generated middle frames / green on context, optional zoom-region redraw +
    zoom-window inset per clip.
  * create_pdfs_one_middle_frame (:277-381): the paper's compact 3-method ×
    1-middle-frame layout with mandatory zoom crops (--pdf_one_middle_frame).
  * create_video (:23-158): stacked labeled comparison video across clips in
    gif/mp4/mp4-uncomp/images/images-uncomp formats.

As in vfi_tpu, PDFs are rendered with the cm-precise matplotlib canvas of
``eval/figures.py`` in place of fpdf, and videos with imageio (gif) / cv2
(mp4) in place of ffmpeg: same artifacts, same CLI.  The PDFs need
matplotlib, gif imageio and mp4 OpenCV, each imported where it is used (an
``ImportError`` naming the package where it is missing); ``images`` and
``images-uncomp`` need PIL alone.  Labels use DejaVu Sans where that font
file exists, else PIL's default font.
"""

import argparse
import os
import shutil
from glob import glob
from warnings import warn

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from ..eval.figures import GREEN, ORANGE, YELLOW, PdfCanvas, in2cm, text_width_cm, write_video

_FONT_PATH = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"


def _font(size):
    try:
        return ImageFont.truetype(_FONT_PATH, size)
    except OSError:
        return ImageFont.load_default()


def _text_width_px(font, text):
    l, t, r, b = font.getbbox(text)
    return r - l


def _ktf_from_dir(images_root):
    K = len(glob(os.path.join(images_root, "gt_preceding_*")))
    T = len(glob(os.path.join(images_root, "gt_middle_*")))
    F = len(glob(os.path.join(images_root, "gt_following_*")))
    return K, T, F


def _sequence_paths(images_root, middle_prefix):
    """Combined frame list gt_preceding + <middle_prefix> + gt_following."""
    K, T, F = _ktf_from_dir(images_root)
    names = (
        [f"gt_preceding_{t:04d}.png" for t in range(K)]
        + [f"{middle_prefix}_{t:04d}.png" for t in range(K, K + T)]
        + [f"gt_following_{t:04d}.png" for t in range(K + T, K + T + F)]
    )
    return [os.path.join(images_root, n) for n in names], K, T, F


def _draw_frame_with_zoom(pdf, image_path, x_cm, y_cm, fw, fh, bw, color,
                          zoom_region, zoom_window_position):
    pdf.add_image(image_path, x_cm, y_cm, fw, fh, b_cm=bw, color=color)
    if zoom_region is not None and zoom_window_position is not None:
        # Redraw the zoomed region in place with an orange border, then draw
        # the magnified crop at the in-frame window position (ref :212-232).
        zx = x_cm + zoom_region[0] * fw
        zy = y_cm + zoom_region[1] * fh
        pdf.add_cropped_image(image_path, zoom_region, zx, zy,
                              (zoom_region[2] - zoom_region[0]) * fw,
                              (zoom_region[3] - zoom_region[1]) * fh, b_cm=bw, color=ORANGE)
        wx = x_cm + zoom_window_position[0] * fw
        wy = y_cm + zoom_window_position[1] * fh
        pdf.add_cropped_image(image_path, zoom_region, wx, wy,
                              (zoom_window_position[2] - zoom_window_position[0]) * fw,
                              (zoom_window_position[3] - zoom_window_position[1]) * fh,
                              b_cm=bw, color=ORANGE)


def create_pdfs(clip_names, dataset_name, dest_path, exp_names, model_labels, results_root,
                frame_indexes, fw, fh, bw, spacing, font_pt, label_frame_width,
                zoom_regions, zoom_window_positions):
    max_text_cm = max(text_width_cm(lbl, font_pt) for lbl in model_labels + ["Ground truth"])
    fig_w = max_text_cm + label_frame_width + len(frame_indexes) * (2 * bw + fw + spacing) - spacing
    fig_h = (len(exp_names) + 1) * (2 * bw + fh + spacing) - spacing

    for zoom_region, zoom_window_position, clip_name in zip(zoom_regions, zoom_window_positions, clip_names):
        pdf = PdfCanvas(fig_w, fig_h)
        rows = list(zip(exp_names, model_labels)) + [("__GT__", "Ground truth")]
        for i, (exp_name, model_label) in enumerate(rows):
            is_gt = exp_name == "__GT__"
            images_root = os.path.join(results_root, dataset_name, "images",
                                       exp_names[-1] if is_gt else exp_name, clip_name)
            if not os.path.isdir(images_root):
                warn(f"Could not find image folder {images_root}; skipping row")
                continue
            y_label = i * (fh + 2 * bw + spacing) + (fh + 2 * bw - 0.7 * in2cm(font_pt / 72)) / 2
            pdf.add_text(model_label, max_text_cm - text_width_cm(model_label, font_pt), y_label, font_pt)

            paths, K, T, F = _sequence_paths(images_root, "gt_middle" if is_gt else "pred_middle")
            if max(frame_indexes) >= K + T + F:
                continue
            for j, frame_index in enumerate(frame_indexes):
                x = max_text_cm + label_frame_width + bw + j * (fw + 2 * bw + spacing)
                y = bw + i * (fh + 2 * bw + spacing)
                color = GREEN if is_gt else (YELLOW if K <= frame_index < K + T else GREEN)
                _draw_frame_with_zoom(pdf, paths[frame_index], x, y, fw, fh, bw, color,
                                      zoom_region, zoom_window_position)
        out = os.path.join(dest_path, f"{clip_name}.pdf")
        pdf.save(out)
        print(f"wrote {out}")


def create_pdfs_one_middle_frame(clip_names, dataset_name, dest_path, exp_names, model_labels,
                                 results_root, frame_indexes, fw, fh, bw, spacing, font_pt,
                                 label_frame_width, zoom_regions, zoom_window_positions):
    """The paper's compact layout (ref :277-381): a column of 3 ground-truth
    frames on the left, and a 2x2 grid of zoomed middle-frame crops (3 methods
    + GT) with labels underneath on the right."""
    assert len(frame_indexes) == 3, "--pdf_one_middle_frame depicts exactly three frames"
    assert len(exp_names) == 3 and len(model_labels) == 3, "--pdf_one_middle_frame compares exactly three methods"

    max_text_cm = max(text_width_cm(lbl, font_pt) for lbl in ["Ground truth"] + model_labels)

    for zoom_region, zoom_window_position, clip_name in zip(zoom_regions, zoom_window_positions, clip_names):
        if zoom_region is None or zoom_window_position is None:
            raise ValueError("--pdf_one_middle_frame requires --pdf_zoom_region and --pdf_zoom_window_position")

        crop_w = (zoom_window_position[2] - zoom_window_position[0]) * fw
        crop_h = (zoom_window_position[3] - zoom_window_position[1]) * fh
        col_a_w = 2 * bw + fw
        col_b_w = max(max_text_cm, 2 * bw + crop_w)
        row_a_h = 2 * bw + fh
        row_b_h = 2 * bw + crop_h + spacing + 0.91 * in2cm(font_pt / 72)
        fig_w = col_a_w + 2 * col_b_w + 2 * spacing
        fig_h = 3 * row_a_h + 2 * spacing
        row_b_spacing = (fig_h - 2 * row_b_h) / 3

        pdf = PdfCanvas(fig_w, fig_h)
        images_root = None
        for i, (exp_name, model_label) in enumerate(zip(exp_names + ["GT"], model_labels + ["Ground truth"])):
            label_w = text_width_cm(model_label, font_pt)
            x = col_a_w + spacing if i % 2 == 0 else col_a_w + col_b_w + 2 * spacing
            y = (i // 2) * row_b_h + (i // 2 + 1) * row_b_spacing
            pdf.add_text(model_label, x + (col_b_w - label_w) / 2, y + 2 * bw + crop_h + spacing, font_pt)

            images_root = os.path.join(results_root, dataset_name, "images",
                                       exp_name if exp_name != "GT" else exp_names[0], clip_name)
            if not os.path.isdir(images_root):
                warn(f"Could not find image folder {images_root}")
                continue
            mid = frame_indexes[1]
            middle_path = os.path.join(
                images_root, f"pred_middle_{mid:04d}.png" if exp_name != "GT" else f"gt_middle_{mid:04d}.png")
            if not os.path.isfile(middle_path):
                warn(f"Failed to find frame at {middle_path}, skipping")
                continue
            x_img = x + (col_b_w - 2 * bw - crop_w) / 2 + bw
            pdf.add_cropped_image(middle_path, zoom_region, x_img, y + bw, crop_w, crop_h,
                                  b_cm=bw, color=ORANGE)

        # Full ground-truth frames down the left column.
        paths, K, T, F = _sequence_paths(images_root, "gt_middle")
        if max(frame_indexes) >= K + T + F:
            continue
        for j, frame_index in enumerate(frame_indexes):
            y = bw + j * (fh + 2 * bw + spacing)
            is_mid = frame_index == frame_indexes[1]
            pdf.add_image(paths[frame_index], bw, y, fw, fh, b_cm=bw,
                          color=YELLOW if is_mid else GREEN)
            if is_mid:
                pdf.add_cropped_image(paths[frame_index], zoom_region,
                                      bw + zoom_region[0] * fw, y + zoom_region[1] * fh,
                                      (zoom_region[2] - zoom_region[0]) * fw,
                                      (zoom_region[3] - zoom_region[1]) * fh,
                                      b_cm=bw, color=ORANGE)
        out = os.path.join(dest_path, f"{clip_name}.pdf")
        pdf.save(out)
        print(f"wrote {out}")


def _compose_video_frame(t, clip_names, dataset_name, exp_names, model_labels, results_root,
                         frame_w, frame_h, border, padding, label_pad, max_label_w,
                         label_font, small_font):
    """One composited canvas for time step t (ref save_video_frame :74-157)."""
    n_rows = len(model_labels) + 1
    canvas_w = max_label_w + label_pad + len(clip_names) * frame_w \
        + 2 * len(clip_names) * border + (len(clip_names) - 1) * padding
    canvas_h = n_rows * frame_h + 2 * n_rows * border + len(model_labels) * padding
    canvas = Image.new("RGB", (canvas_w, canvas_h), color=(255, 255, 255))
    draw = ImageDraw.Draw(canvas)
    draw.text((0, 0), f"Frame {t:02d}", fill=0, font=small_font)
    for l, label in enumerate(model_labels + ["Ground truth"]):
        draw.text((0, l * (2 * border + padding + frame_h) + frame_h // 2), label, font=label_font, fill=0)

    rows = [(e, ("gt_preceding_%04d.png", "pred_middle_%04d.png", "gt_following_%04d.png"))
            for e in exp_names]
    rows.append((exp_names[-1], ("gt_preceding_%04d.png", "gt_middle_%04d.png", "gt_following_%04d.png")))
    for e, (exp_name, templates) in enumerate(rows):
        for c, clip_name in enumerate(clip_names):
            images_root = os.path.join(results_root, dataset_name, "images", exp_name, clip_name)
            frame, frame_name = None, None
            for tmpl in templates:
                path = os.path.join(images_root, tmpl % t)
                if os.path.isfile(path):
                    frame, frame_name = Image.open(path).convert("RGB"), tmpl % t
                    break
            if frame is None:
                warn(f"Could not find valid frame for time step {t} in {images_root}")
                continue
            frame = frame.resize((frame_w, frame_h))
            x0 = max_label_w + label_pad + border + c * (2 * border + padding + frame_w)
            y0 = border + e * (2 * border + padding + frame_h)
            border_color = (255, 215, 0) if "middle" in frame_name else (0, 215, 0)
            draw.rectangle([x0 - border, y0 - border, x0 + frame_w + border - 1, y0 + frame_h + border - 1],
                           fill=border_color)
            canvas.paste(frame, (x0, y0))
    return np.asarray(canvas)


def create_video(clip_names, dataset_name, dest_path, exp_names, model_labels, results_root,
                 total_num_frames, video_type):
    assert video_type in ("gif", "mp4", "mp4-uncomp", "images", "images-uncomp")
    frame_w, frame_h, border, padding, label_pad, fps = 320, 240, 4, 4, 20, 3
    label_font, small_font = _font(40), _font(30)
    max_label_w = max(_text_width_px(label_font, lbl) for lbl in model_labels + ["Ground truth"])

    frames = [
        _compose_video_frame(t, clip_names, dataset_name, exp_names, model_labels, results_root,
                             frame_w, frame_h, border, padding, label_pad, max_label_w,
                             label_font, small_font)
        for t in range(total_num_frames)
    ]
    if video_type == "images":
        for t, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(dest_path, f"{t:02d}.jpg"))
    elif video_type == "images-uncomp":
        out_dir = os.path.join(dest_path, "video_frames")
        if os.path.isdir(out_dir):
            shutil.rmtree(out_dir)
        os.makedirs(out_dir)
        for t, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(out_dir, f"{t:02d}.png"))
    elif video_type == "gif":
        write_video(frames, os.path.join(dest_path, "video.gif"), fps, "gif")
    else:
        write_video(frames, os.path.join(dest_path, "video.mp4"), fps, video_type)
    print(f"wrote {video_type} output to {dest_path}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--results_root", type=str, default="results")
    parser.add_argument("--dataset_name", type=str, required=True)
    parser.add_argument("--total_num_frames", type=int, default=None)
    parser.add_argument("--clip_names", type=str, nargs="+", required=True)
    parser.add_argument("--exp_names", type=str, nargs="+", required=True)
    parser.add_argument("--model_labels", type=str, nargs="+", default=None)
    parser.add_argument("--dest_path", type=str, required=True)
    parser.add_argument("--video_type", type=str, default=None,
                        choices=["gif", "mp4", "mp4-uncomp", "images", "images-uncomp"])
    parser.add_argument("--no_pdf", action="store_true")
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--frame_indexes", type=int, nargs="+", default=None)
    parser.add_argument("--pdf_frame_width", type=float, default=1.2)
    parser.add_argument("--pdf_frame_height", type=float, default=0.9)
    parser.add_argument("--pdf_border_width", type=float, default=0.04)
    parser.add_argument("--pdf_spacing", type=float, default=0.05)
    parser.add_argument("--pdf_font_size", type=int, default=8)
    parser.add_argument("--pdf_label_frame_width", type=float, default=0.5)
    parser.add_argument("--pdf_zoom_region", type=float, nargs=4, action="append", default=None)
    parser.add_argument("--pdf_zoom_window_position", type=float, nargs=4, action="append", default=None)
    parser.add_argument("--pdf_one_middle_frame", action="store_true")
    args = parser.parse_args(argv)

    if args.frame_indexes and args.total_num_frames:
        warn("Setting both --frame_indexes and --total_num_frames may result in unexpected behavior")
    if not args.frame_indexes and not args.total_num_frames:
        raise ValueError("Must specify either --frame_indexes or --total_num_frames")
    if args.frame_indexes is not None:
        args.total_num_frames = len(args.frame_indexes)
    else:
        args.frame_indexes = list(range(args.total_num_frames))

    if (args.pdf_zoom_region is None) ^ (args.pdf_zoom_window_position is None):
        raise ValueError("pdf_zoom_region and pdf_zoom_window_position must be specified together or not at all")
    if args.pdf_zoom_region is None:
        args.pdf_zoom_region = [None] * len(args.clip_names)
        args.pdf_zoom_window_position = [None] * len(args.clip_names)
    if len(args.pdf_zoom_region) != len(args.clip_names):
        raise ValueError("Number of regions specified by --pdf_zoom_region must match number of clip_names")
    if len(args.pdf_zoom_window_position) == 1:
        args.pdf_zoom_window_position = [args.pdf_zoom_window_position[0]] * len(args.clip_names)
    elif len(args.pdf_zoom_window_position) != len(args.clip_names):
        raise ValueError("Number of positions specified by --pdf_zoom_window_position must be 1 or match clip_names")

    if args.model_labels is None:
        args.model_labels = args.exp_names
    assert len(args.model_labels) == len(args.exp_names)

    os.makedirs(args.dest_path, exist_ok=True)

    if not args.no_pdf:
        fn = create_pdfs_one_middle_frame if args.pdf_one_middle_frame else create_pdfs
        fn(args.clip_names, args.dataset_name, args.dest_path, args.exp_names, args.model_labels,
           args.results_root, args.frame_indexes, args.pdf_frame_width, args.pdf_frame_height,
           args.pdf_border_width, args.pdf_spacing, args.pdf_font_size, args.pdf_label_frame_width,
           args.pdf_zoom_region, args.pdf_zoom_window_position)
    if args.video_type is not None:
        create_video(args.clip_names, args.dataset_name, args.dest_path, args.exp_names,
                     args.model_labels, args.results_root, args.total_num_frames, args.video_type)


if __name__ == "__main__":
    main()
