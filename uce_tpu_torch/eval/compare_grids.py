"""Side-by-side comparison grids (evalscripts/make-compare-images.py;
uce_tpu/eval/compare_grids.py).

Any list of folders is paneled per case into one PNG: ``num_samples`` rows
by one column per folder, each panel the image itself. uce_tpu draws the
grid as a matplotlib figure with the labels as column titles; here the
panels are tiled without text (no matplotlib) and the labels are printed
in column order.
"""

from __future__ import annotations

import os
import re

import numpy as np

from uce_tpu_torch.utils.imaging import load_image, save_png

# the figure's background where a panel is smaller than its cell
BACKGROUND = 255


def tile(panels: list[list[np.ndarray]]) -> np.ndarray:
    """Rows of uint8 [H, W, 3] panels -> one image, each panel at the top
    left of a cell as large as the largest panel."""
    h = max(p.shape[0] for row in panels for p in row)
    w = max(p.shape[1] for row in panels for p in row)
    grid = np.full((h * len(panels), w * len(panels[0]), 3), BACKGROUND, np.uint8)
    for r, row in enumerate(panels):
        for c, p in enumerate(row):
            grid[r * h:r * h + p.shape[0], c * w:c * w + p.shape[1]] = p
    return grid


def make_grids(folders: list[str], labels: list[str] | None, save_path: str,
               num_samples: int = 1, from_case: int = 0,
               till_case: int = 1_000_000) -> int:
    """One ``{case}.png`` per case of the first folder within [from_case,
    till_case] whose images exist in every folder; returns how many."""
    labels = labels or [os.path.basename(f.rstrip("/")) for f in folders]
    os.makedirs(save_path, exist_ok=True)
    cases = set()
    for name in os.listdir(folders[0]):
        m = re.match(r"(\d+)_(\d+)\.png", name)
        if m and from_case <= int(m.group(1)) <= till_case:
            cases.add(int(m.group(1)))
    n = 0
    for case in sorted(cases):
        paths = [[os.path.join(folder, f"{case}_{row}.png") for folder in folders]
                 for row in range(num_samples)]
        if not all(os.path.exists(p) for row in paths for p in row):
            continue
        save_png(tile([[load_image(p) for p in row] for row in paths]),
                 os.path.join(save_path, f"{case}.png"))
        n += 1
    return n


def register_cli(sub) -> None:
    p = sub.add_parser("eval-compare", help="side-by-side grids across model variants")
    p.add_argument("--folders", type=str, nargs="+", required=True)
    p.add_argument("--labels", type=str, nargs="+", default=None)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1_000_000)
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    n = make_grids(args.folders, args.labels, args.save_path,
                   num_samples=args.num_samples, from_case=args.from_case,
                   till_case=args.till_case)
    labels = args.labels or [os.path.basename(f.rstrip("/")) for f in args.folders]
    print(f"columns: {', '.join(labels)}")
    print(f"wrote {n} comparison grids to {args.save_path}")
    return 0
