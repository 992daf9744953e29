"""Standalone scan/prediction visualizer (``lt-visualize-torch``), the
port's counterpart of ``lidar_transfer_tpu/visualize.py``.

It walks a KITTI-format sequence, range-projects each scan and renders
range / remission / semantic-label views; a ``--predictions`` dir
(semantic-kitti layout: <pred>/sequences/<seq>/predictions/*.label) adds a
predictions row and a disagreement row. The default mode writes one PNG
panel per scan plus a bird's-eye-view rendering through
``matplotlib.pyplot`` (``ImportError`` where matplotlib is absent);
``--html OUT.html`` writes the standalone WebGL viewer of
``webviewer.export_html`` and needs no matplotlib; ``--interactive`` hands
off to vispy when it is importable and exits 2 with a message when not.

The projections (``ops/projection``: ``mask_classes``, ``range_project``,
``reverse_project``) and the viewers' metrics run on ``--device``: the card
unless ``--device cpu`` is given; without a CUDA device it exits 2.

Flags mirror the reference: -d/--dataset, -c/--config, -s/--sequence,
-p/--predictions, -i/--ignore_semantics, -o/--offset; new: --out, --frames,
--bev-radius, --interactive, --html, --html-max-points, --device.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("lt-visualize-torch")
    p.add_argument("--dataset", "-d", type=str, required=True,
                   help="Dataset root (KITTI layout).")
    p.add_argument("--config", "-c", type=str, default=None,
                   help="Tool config yaml (color map / ignore classes).")
    p.add_argument("--sequence", "-s", type=str, default="00")
    p.add_argument("--predictions", "-p", type=str, default=None,
                   help="Predictions root with sequences/<s>/predictions/.")
    p.add_argument("--ignore_semantics", "-i", action="store_true",
                   help="Visualize without labels.")
    p.add_argument("--offset", "-o", type=int, default=0,
                   help="First scan index.")
    p.add_argument("--frames", "-n", type=int, default=1,
                   help="Number of scans to render (default 1; -1 = all).")
    p.add_argument("--out", type=str, default="viz/",
                   help="Output directory for PNG panels.")
    p.add_argument("--bev-radius", type=float, default=50.0,
                   help="Bird's-eye-view half-extent in meters.")
    p.add_argument("--interactive", action="store_true",
                   help="Open a vispy window instead of writing PNGs "
                        "(requires vispy + a display).")
    p.add_argument("--html", type=str, default=None, metavar="OUT.html",
                   help="Write a standalone interactive WebGL viewer "
                        "(linked 3D views + image rows + n/b/q/1/2/3 "
                        "keys) covering --frames scans; runs in any "
                        "browser, no display/vispy needed.")
    p.add_argument("--html-max-points", type=int, default=300_000,
                   help="Per-cloud point cap embedded in --html.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device of the projections and metrics "
                        "(default cuda; cpu only when asked for).")
    return p


def _predictions_files(root: str, sequence: str) -> list[str]:
    pred_dir = os.path.join(root, "sequences", sequence, "predictions")
    if not os.path.isdir(pred_dir):
        raise FileNotFoundError(f"no predictions dir at {pred_dir}")
    names = [os.path.join(pred_dir, f) for f in os.listdir(pred_dir)
             if f.endswith(".label")]
    names.sort()
    return names


def render_panel(out_file: str, scan_rows: list[tuple[str, "object"]],
                 bev: "object" = None, title: str = "") -> None:
    """Write one stacked panel: labeled image rows + optional BEV pane."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_rows = len(scan_rows) + (1 if bev is not None else 0)
    heights = [1.0] * len(scan_rows) + ([6.0] if bev is not None else [])
    fig, axes = plt.subplots(
        n_rows, 1, figsize=(14, 1.1 * len(scan_rows) +
                            (7 if bev is not None else 0)),
        gridspec_kw={"height_ratios": heights}, squeeze=False)
    axes = axes[:, 0]
    for ax, (name, img) in zip(axes, scan_rows):
        ax.imshow(img, aspect="auto", interpolation="nearest")
        ax.set_ylabel(name, rotation=0, ha="right", va="center", fontsize=9)
        ax.set_xticks([])
        ax.set_yticks([])
    if bev is not None:
        ax = axes[-1]
        ax.imshow(bev, interpolation="nearest")
        ax.set_ylabel("bev", rotation=0, ha="right", va="center", fontsize=9)
        ax.set_xticks([])
        ax.set_yticks([])
    if title:
        fig.suptitle(title, fontsize=10)
    fig.tight_layout()
    fig.savefig(out_file, dpi=110)
    plt.close(fig)


def bev_image(points, colors, radius: float, size: int = 700):
    """Top-down orthographic point rendering -> (size, size, 3) uint8.

    The offline stand-in for the reference's 3D turntable view
    (laserscanvis.py:287-300): z-ordered splat of the cloud onto the
    ground plane, colored like the 3D view (semantic colors, or height
    when semantics are off).
    """
    import numpy as np

    img = np.zeros((size, size, 3), np.uint8)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    keep = (np.abs(x) < radius) & (np.abs(y) < radius)
    x, y, z, c = x[keep], y[keep], z[keep], colors[keep]
    order = np.argsort(z)                       # low first; high overwrites
    x, y, c = x[order], y[order], c[order]
    px = ((x + radius) / (2 * radius) * (size - 1)).astype(np.int64)
    py = ((radius - y) / (2 * radius) * (size - 1)).astype(np.int64)
    img[py, px] = c
    return img


def _project(P, spec, sba, pts, rem, lbl, capacity, classes, dev):
    """Pad one scan to ``capacity`` on ``dev`` and range-project it at
    ``spec`` with ``classes`` masked; -> (RangeImage, padded points,
    remissions, masked valid) as tensors on ``dev``."""
    import torch

    from lidar_transfer_tpu_torch.datasets import kitti

    p, r, l, m = (torch.as_tensor(a, device=dev)
                  for a in kitti.pad_points(pts, rem, lbl, capacity))
    m = P.mask_classes(l, m, classes)
    ri = P.range_project(p, r, l, m, H=spec.H, W=spec.W,
                         fov_up_deg=spec.fov_up,
                         fov_down_deg=spec.fov_down, beam_angles=sba)
    return ri, p, r, m


def _project_predictions(P, spec, sba, p, r, m, pred, capacity):
    """The padded scan ``p, r, m`` projected with the predicted labels."""
    import numpy as np
    import torch

    pp = torch.as_tensor(np.pad(pred.astype(np.int32),
                                (0, capacity - pred.size)), device=p.device)
    return P.range_project(p, r, pp, m, H=spec.H, W=spec.W,
                           fov_up_deg=spec.fov_up,
                           fov_down_deg=spec.fov_down, beam_angles=sba)


def _make_payload_loader(cfg, spec, seq, pred_files, capacity, sba,
                         show_label, dev):
    """Shared frame loader for the vispy and HTML viewers.

    ≡ the reference visualize.py:185-232 feeding LaserScanVis — range
    projection + labels on ``dev`` (the z-buffer kernel on the card);
    with --predictions the predicted labels form the second row set and
    the diff canvas, and the title carries IoU/Acc (compare_scans on gt
    vs prediction, the confusion kernel on the card).
    """
    import types

    import numpy as np

    from lidar_transfer_tpu_torch.datasets import kitti
    from lidar_transfer_tpu_torch.interactive import frame_payload
    from lidar_transfer_tpu_torch.ops import projection as P

    def load_payload(idx: int) -> dict:
        pts, rem, lbl = (seq.read(idx) if show_label else
                         (*kitti.read_scan_file(seq.scan_files[idx]), None))
        if lbl is None:
            lbl = np.zeros(pts.shape[0], np.int32)
        ri, p, r, m = _project(P, spec, sba, pts, rem, lbl, capacity,
                               cfg.ignore_classes if show_label else (), dev)
        virtual = None
        if pred_files is not None and idx < len(pred_files):
            pred = kitti.read_label_file(pred_files[idx], pts.shape[0])
            rp = _project_predictions(P, spec, sba, p, r, m, pred, capacity)
            back = P.reverse_project(ri, fov_up_deg=spec.fov_up,
                                     fov_down_deg=spec.fov_down)
            virtual = types.SimpleNamespace(
                range=ri.range, remission=ri.remission, label=rp.label,
                points=back, mask=ri.mask)
        return frame_payload(ri, cfg, virtual=virtual, source_points=pts,
                             source_labels=lbl if show_label else None)

    return load_payload


def _run_interactive(args, cfg, spec, seq, pred_files, capacity, sba,
                     show_label, dev) -> int:
    """lt-visualize --interactive: vispy viewer over the sequence."""
    from lidar_transfer_tpu_torch.interactive import InteractiveViewer

    load_payload = _make_payload_loader(cfg, spec, seq, pred_files,
                                        capacity, sba, show_label, dev)
    viewer = InteractiveViewer(len(seq), load_payload,
                               title=f"{spec.name} seq {args.sequence}",
                               start=args.offset)
    viewer.run()
    return 0


def _run_html(args, cfg, spec, seq, pred_files, capacity, sba, show_label,
              n: int, dev) -> int:
    """lt-visualize --html: standalone WebGL viewer over --frames scans."""
    from lidar_transfer_tpu_torch.webviewer import export_html

    load_payload = _make_payload_loader(cfg, spec, seq, pred_files,
                                        capacity, sba, show_label, dev)
    frames = [(f"{args.sequence}_{args.offset + k:06d}",
               load_payload(args.offset + k)) for k in range(n)]
    out = export_html(frames, args.html,
                      title=f"{spec.name} seq {args.sequence}",
                      max_points=args.html_max_points)
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB, "
          f"{len(frames)} frames)")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: lt-visualize-torch runs on the card (pass "
              "--device cpu to run on the CPU)", file=sys.stderr)
        return 2

    from lidar_transfer_tpu_torch.config import SensorSpec, TransferConfig
    from lidar_transfer_tpu_torch.datasets import kitti
    from lidar_transfer_tpu_torch.datasets.kitti import KittiSequence
    from lidar_transfer_tpu_torch.ops import projection as P
    from lidar_transfer_tpu_torch.utils.images import (get_mpl_colormap,
                                                       label_image_rgb,
                                                       range_image_rgb)

    cfg = (TransferConfig.from_yaml(args.config) if args.config
           else TransferConfig())
    spec = SensorSpec.from_yaml(os.path.join(args.dataset, "config.yaml"))
    show_label = not args.ignore_semantics

    print("*" * 60)
    print(f"Scanner {spec.name}: {spec.H} x {spec.W} "
          f"fov [{spec.fov_up}, {spec.fov_down}]")
    print(f"Predictions: {args.predictions}")
    print("*" * 60)

    seq = KittiSequence.open(args.dataset, args.sequence,
                             require_labels=show_label)
    pred_files = (_predictions_files(args.predictions, args.sequence)
                  if args.predictions else None)
    if pred_files is not None and len(pred_files) != len(seq):
        print(f"WARNING: {len(pred_files)} predictions vs "
              f"{len(seq)} scans")

    n = (len(seq) - args.offset if args.frames < 0
         else min(args.frames, len(seq) - args.offset))
    capacity = kitti.scan_capacity(
        max(os.path.getsize(f) // 16 for f in seq.scan_files))
    sba = (torch.as_tensor(np.asarray(spec.beam_angles),  # radians
                           dtype=torch.float32, device=dev)
           if spec.beam_angles is not None else None)

    if args.interactive:
        # real vispy handoff (interactive.InteractiveViewer); an explicit
        # error when vispy/display are absent — NOT a silent PNG fallback
        try:
            import vispy  # noqa: F401
        except ImportError:
            print("ERROR: --interactive needs vispy (pip install vispy "
                  "pyqt5) and a display; this host has neither. "
                  "Offline PNG export (the default mode) is the headless "
                  "path.", file=sys.stderr)
            return 2
        return _run_interactive(args, cfg, spec, seq, pred_files,
                                capacity, sba, show_label, dev)

    if args.html:
        return _run_html(args, cfg, spec, seq, pred_files, capacity, sba,
                         show_label, n, dev)

    os.makedirs(args.out, exist_ok=True)
    viridis = get_mpl_colormap("viridis")

    for k in range(n):
        idx = args.offset + k
        pts, rem, lbl = (seq.read(idx) if show_label else
                         (*kitti.read_scan_file(seq.scan_files[idx]),
                          None))
        if lbl is None:
            lbl = np.zeros(pts.shape[0], np.int32)
        ri, p, r, m = _project(P, spec, sba, pts, rem, lbl, capacity,
                               cfg.ignore_classes if show_label else (), dev)
        ri_label = ri.label.cpu().numpy()
        ri_mask = ri.mask.cpu().numpy()

        rows = [("range", range_image_rgb(ri.range.cpu().numpy())),
                ("remission",
                 viridis[(np.clip(ri.remission.cpu().numpy(), 0, 1) * 255
                          ).astype(np.uint8)])]
        point_colors = None
        if show_label:
            rows.append(("labels", label_image_rgb(ri_label, cfg)))
            lut = label_image_rgb(np.arange(260), cfg)
            point_colors = lut[np.clip(lbl, 0, 259)]
        else:
            hcol = np.clip((pts[:, 2] + 3.0) / 6.0, 0, 1)
            point_colors = viridis[(hcol * 255).astype(np.uint8)]

        title = f"{spec.name} seq {args.sequence} scan {idx:06d}"
        if pred_files is not None and idx < len(pred_files):
            pred = kitti.read_label_file(pred_files[idx], pts.shape[0])
            pred_img = _project_predictions(
                P, spec, sba, p, r, m, pred, capacity).label.cpu().numpy()
            rows.append(("pred", label_image_rgb(pred_img, cfg)))
            diff = (pred_img != ri_label) & ri_mask
            rows.append(("diff", (np.stack([diff] * 3, -1) * 255
                                  ).astype(np.uint8)))
            agree = 1.0 - diff.sum() / max(int(ri_mask.sum()), 1)
            title += f"  pred-agreement {agree:.3f}"

        bev = bev_image(pts, point_colors, args.bev_radius)
        out_file = os.path.join(args.out, f"{args.sequence}_{idx:06d}.png")
        render_panel(out_file, rows, bev=bev, title=title)
        print(f"wrote {out_file}")

    return 0


if __name__ == "__main__":
    sys.exit(main())
