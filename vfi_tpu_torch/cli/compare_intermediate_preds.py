"""PDFs of forward/backward predictions and pre-blend interpolation-net
outputs (counterpart of vfi_tpu's ``cli/compare_intermediate_preds.py``;
reference compare_intermediate_preds.py).  It reads the PNGs that
``python -m vfi_tpu_torch.cli.predict --intermediate_preds`` writes, and
needs matplotlib (an ``ImportError`` naming it where it is missing).

    python -m vfi_tpu_torch.cli.compare_intermediate_preds --results_root R --dataset_name D \\
        --clip_names CLIP --exp_names A B --ts 5 6 --dest_path OUT bidirectional_pred

Two subcommands, same as the reference:
  * bidirectional_pred (:141-208): per (clip, t) a grid with one row per
    experiment and columns Fwd / Bkwd / Final (cyan / purple / yellow
    borders), written to <dest_path>/<clip>/<t:02d>.pdf.
  * interp_net_pred (:14-138): per (clip, t) a 2-row-per-experiment layout
    showing before/after-adaptive-convolution pairs and the final blend.
"""

import argparse
import os
from warnings import warn

from ..eval.figures import CYAN, PURPLE, YELLOW, PdfCanvas, in2cm, text_width_cm


def _add(pdf, images_root, template, t, zoom_region, x, y, fw, fh, bw, color):
    path = os.path.join(images_root, template % t)
    if not os.path.isfile(path):
        warn(f"missing {path}")
        return
    if zoom_region is None:
        pdf.add_image(path, x, y, fw, fh, b_cm=bw, color=color)
    else:
        pdf.add_cropped_image(path, zoom_region, x, y, fw, fh, b_cm=bw, color=color)


def generate_bidirectional_pred_pdf(results_root, dataset_name, clip_names, exp_names, model_labels,
                                    dest_path, ts, fw, fh, bw, spacing, font_pt, label_frame_width,
                                    zoom_regions):
    max_text_cm = max(text_width_cm(lbl, font_pt) for lbl in model_labels)
    fig_w = max_text_cm + label_frame_width + 3 * (2 * bw + fw + spacing) - spacing
    fig_h = len(exp_names) * (fh + 2 * bw + spacing) + spacing + 0.7 * in2cm(font_pt / 72)

    templates = ["pred_middle_forward_%04d.png", "pred_middle_backward_%04d.png", "pred_middle_%04d.png"]
    colors = [CYAN, PURPLE, YELLOW]
    bottom_labels = ["Fwd", "Bkwd", "Final"]

    for zoom_region, clip_name in zip(zoom_regions, clip_names):
        for t in ts:
            pdf = PdfCanvas(fig_w, fig_h)
            y_bot = len(exp_names) * (fh + 2 * bw + spacing) + spacing
            for j, text in enumerate(bottom_labels):
                x = (fw + 2 * bw - text_width_cm(text, font_pt)) / 2 + max_text_cm + label_frame_width \
                    + j * (fw + 2 * bw + spacing)
                pdf.add_text(text, x, y_bot, font_pt)
            for i, (exp_name, model_label) in enumerate(zip(exp_names, model_labels)):
                y_off = (fh + 2 * bw - 0.7 * in2cm(font_pt / 72)) / 2
                y_lbl = i * (fh + 2 * bw + spacing) + y_off
                pdf.add_text(model_label, max_text_cm - text_width_cm(model_label, font_pt), y_lbl, font_pt)
                images_root = os.path.join(results_root, dataset_name, "images", exp_name, clip_name)
                if not os.path.isdir(images_root):
                    warn(f"Could not find image folder {images_root}")
                    continue
                for j, (template, color) in enumerate(zip(templates, colors)):
                    x = max_text_cm + label_frame_width + bw + j * (fw + 2 * bw + spacing)
                    y = bw + i * (fh + 2 * bw + spacing)
                    _add(pdf, images_root, template, t, zoom_region, x, y, fw, fh, bw, color)
            out = os.path.join(dest_path, clip_name, f"{t:02d}.pdf")
            pdf.save(out)
            print(f"wrote {out}")


def generate_interp_net_pred_pdf(results_root, dataset_name, clip_names, exp_names, model_labels,
                                 dest_path, ts, fw, fh, bw, spacing, font_pt, label_frame_width,
                                 zoom_regions):
    max_text_cm = max(text_width_cm(lbl, font_pt) for lbl in model_labels)
    fig_w = max_text_cm + label_frame_width + 3 * (2 * bw + fw + spacing) - spacing
    row_pitch = 2 * fh + 4 * bw + 6 * spacing
    fig_h = len(exp_names) * row_pitch - 4 * spacing + 2.11 * in2cm(font_pt / 72)

    bottom_labels = [("Before", "adpt. conv."), ("After", "adpt. conv."), ("Final", "prediction")]

    for zoom_region, clip_name in zip(zoom_regions, clip_names):
        for t in ts:
            pdf = PdfCanvas(fig_w, fig_h)
            for j, (text_0, text_1) in enumerate(bottom_labels):
                y0 = len(exp_names) * row_pitch - 3 * spacing
                for k, text in enumerate((text_0, text_1)):
                    x = (fw + 2 * bw - text_width_cm(text, font_pt)) / 2 + max_text_cm \
                        + label_frame_width + j * (fw + 2 * bw + spacing)
                    pdf.add_text(text, x, y0 + k * in2cm(font_pt / 72), font_pt)

            for i, (exp_name, model_label) in enumerate(zip(exp_names, model_labels)):
                y_off = (2 * fh + 4 * bw + spacing - 0.7 * in2cm(font_pt / 72)) / 2
                pdf.add_text(model_label, max_text_cm - text_width_cm(model_label, font_pt),
                             i * row_pitch + y_off, font_pt)
                images_root = os.path.join(results_root, dataset_name, "images", exp_name, clip_name)
                if not os.path.isdir(images_root):
                    warn(f"Could not find image folder {images_root}")
                    continue
                x_col = lambda j: max_text_cm + label_frame_width + bw + j * (fw + 2 * bw + spacing)
                y_top = bw + 2 * i * (fh + 2 * bw + 3 * spacing)
                y_bot = bw + (2 * i + 1) * (fh + 2 * bw + 3 * spacing) - 2 * spacing
                # Column 0: raw forward/backward predictions (before adaptive conv).
                _add(pdf, images_root, "pred_middle_forward_%04d.png", t, zoom_region,
                     x_col(0), y_top, fw, fh, bw, CYAN)
                _add(pdf, images_root, "pred_middle_backward_%04d.png", t, zoom_region,
                     x_col(0), y_bot, fw, fh, bw, PURPLE)
                # Column 1: interpolation-net outputs (after adaptive conv).
                _add(pdf, images_root, "interp_net_outputs_1_%04d.png", t, zoom_region,
                     x_col(1), y_top, fw, fh, bw, CYAN)
                _add(pdf, images_root, "interp_net_outputs_2_%04d.png", t, zoom_region,
                     x_col(1), y_bot, fw, fh, bw, PURPLE)
                # Column 2: final blended prediction, vertically centered.
                y_mid = y_bot - (fh + 2 * bw + spacing) / 2
                _add(pdf, images_root, "pred_middle_%04d.png", t, zoom_region,
                     x_col(2), y_mid, fw, fh, bw, YELLOW)
            out = os.path.join(dest_path, clip_name, f"{t:02d}.pdf")
            pdf.save(out)
            print(f"wrote {out}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--results_root", type=str, default="results")
    parser.add_argument("--dataset_name", type=str, required=True)
    parser.add_argument("--clip_names", type=str, nargs="+", required=True)
    parser.add_argument("--exp_names", type=str, nargs="+", required=True)
    parser.add_argument("--model_labels", type=str, nargs="+", default=None)
    parser.add_argument("--dest_path", type=str, required=True)
    parser.add_argument("--ts", type=int, nargs="+", required=True)
    parser.add_argument("--pdf_frame_width", type=float, default=1.73)
    parser.add_argument("--pdf_frame_height", type=float, default=1.73)
    parser.add_argument("--pdf_border_width", type=float, default=0.05)
    parser.add_argument("--pdf_spacing", type=float, default=0.07)
    parser.add_argument("--pdf_font_size", type=int, default=10)
    parser.add_argument("--pdf_label_frame_width", type=float, default=0.25)
    parser.add_argument("--pdf_zoom_region", type=float, nargs=4, action="append", default=None)
    subparsers = parser.add_subparsers(dest="command")
    subparsers.add_parser("bidirectional_pred")
    subparsers.add_parser("interp_net_pred")
    args = parser.parse_args(argv)

    if args.pdf_zoom_region is None:
        args.pdf_zoom_region = [None] * len(args.clip_names)
    if len(args.pdf_zoom_region) != len(args.clip_names):
        raise ValueError("Number of regions specified by --pdf_zoom_region must match number of clip_names")
    if args.model_labels is None:
        args.model_labels = args.exp_names
    assert len(args.model_labels) == len(args.exp_names)

    fn = {"bidirectional_pred": generate_bidirectional_pred_pdf,
          "interp_net_pred": generate_interp_net_pred_pdf}.get(args.command)
    if fn is None:
        parser.error("missing subcommand (bidirectional_pred | interp_net_pred)")
    fn(args.results_root, args.dataset_name, args.clip_names, args.exp_names, args.model_labels,
       args.dest_path, args.ts, args.pdf_frame_width, args.pdf_frame_height, args.pdf_border_width,
       args.pdf_spacing, args.pdf_font_size, args.pdf_label_frame_width, args.pdf_zoom_region)


if __name__ == "__main__":
    main()
