"""Per-class point histograms across datasets.

Counterpart of ``lidar_transfer_tpu/experiments/compare_datasets.py`` (the
``lt-compare-datasets`` command, here ``lt-compare-datasets-torch``), numpy
only: exact per-class counts (a bincount over every .label file), returned
as structured data, with an optional plot.
"""

from __future__ import annotations

import json
import os
import sys
import warnings

import numpy as np


def class_histogram(dataset: str, sequences=("00",),
                    max_label: int = 260) -> dict[int, int]:
    """Total per-class point counts across the sequences' label files
    (labels/ read directly: no poses or calibration needed)."""
    from lidar_transfer_tpu_torch.datasets import kitti

    counts = np.zeros((max_label,), np.int64)
    unknown = 0
    for s in sequences:
        lbl_dir = os.path.join(dataset, "sequences", s, "labels")
        files = sorted(os.path.join(lbl_dir, f)
                       for f in os.listdir(lbl_dir)
                       if f.endswith(".label"))
        if not files:
            raise FileNotFoundError(f"no .label files under {lbl_dir}")
        for f in files:
            lbl = kitti.read_label_file(f)
            # drop ids >= max_label (clipping would fold them into the
            # top class)
            known = lbl < max_label
            counts += np.bincount(lbl[known], minlength=max_label)
            unknown += int((~known).sum())
    if unknown:
        warnings.warn(f"{unknown} points carried label ids >= {max_label} "
                      "and were excluded from the histogram")
    return {int(c): int(n) for c, n in enumerate(counts) if n > 0}


def compare_datasets(datasets: dict[str, str], sequences=("00",),
                     out_dir: str | None = None,
                     labels: dict[int, str] | None = None) -> dict:
    """{name: root} -> per-dataset class histograms (+ JSON / SVG plot)."""
    from lidar_transfer_tpu_torch.config import SEMANTICKITTI_LABELS

    labels = labels or SEMANTICKITTI_LABELS
    result = {name: class_histogram(root, sequences)
              for name, root in datasets.items()}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "class_histograms.json"),
                  "w") as f:
            json.dump(result, f, indent=2)
        _plot(result, labels, os.path.join(out_dir,
                                           "class_histograms.svg"))
    return result


def _plot(result: dict, labels: dict[int, str], out_file: str) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"matplotlib unavailable - skipping plot {out_file}")
        return

    all_classes = sorted({c for h in result.values() for c in h})
    names = list(result)
    x = np.arange(len(all_classes))
    width = 0.8 / max(len(names), 1)
    fig, ax = plt.subplots(figsize=(max(8, 0.45 * len(all_classes)), 5))
    for k, name in enumerate(names):
        h = result[name]
        ax.bar(x + k * width, [h.get(c, 0) for c in all_classes], width,
               label=name)
    ax.set_yscale("log")
    ax.set_xticks(x + 0.4 - width / 2,
                  [labels.get(c, str(c)) for c in all_classes],
                  rotation=75, fontsize=7)
    ax.set_ylabel("points")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_file)
    plt.close(fig)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser("lt-compare-datasets-torch")
    p.add_argument("datasets", nargs="+",
                   help="name=path pairs, e.g. real=/data/kitti "
                        "fake=output/")
    p.add_argument("--sequences", "-s", nargs="+", default=["00"])
    p.add_argument("--out", default="compare_out/")
    args = p.parse_args(argv)

    ds = dict(pair.split("=", 1) for pair in args.datasets)
    result = compare_datasets(ds, sequences=tuple(args.sequences),
                              out_dir=args.out)
    for name, hist in result.items():
        print(f"{name}: {sum(hist.values())} points, {len(hist)} classes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
