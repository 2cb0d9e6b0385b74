"""Post-hoc CLIP attribute classification (evalscripts/CLIP_classify.py;
uce_tpu/eval/clip_classify.py).

A folder of ``{case}_{num}.png`` images and ``--attributes`` -> per-case
mean attribute ratios, merged into the prompts CSV where one is given, and
written as the CSV that uce_tpu's pandas code writes (``to_csv(index=False)``
of ``prompts.merge(means, on="case_number", how="left")``), without pandas.
Images go through the CLIP model in batches; the PNGs are read with the
port's zlib decoder (8-bit RGB, filter 0: what ``generate`` writes). A
batch holds images of one size: a folder of mixed sizes is classified at
each image's own size (uce_tpu resizes stragglers to the first image's size
with PIL first).
"""

from __future__ import annotations

import csv
import os
import re

import numpy as np

from uce_tpu_torch.eval.generate import PANDAS_NA_STRINGS
from uce_tpu_torch.utils.imaging import decode_png


def sorted_nicely(names):
    """Natural sort (reference ``CLIP_classify.py:10-13``)."""
    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]

    return sorted(names, key=key)


def _pandas_column(cells: list[str]) -> list:
    """One column of a CSV as ``pandas.read_csv`` types it: int, float (an
    int column with an NA too), or text; NA cells become None."""
    values = [None if c in PANDAS_NA_STRINGS else c for c in cells]
    present = [v for v in values if v is not None]
    for cast in (int, float):
        try:
            parsed = [cast(v) for v in present]
        except ValueError:
            continue
        if cast is int and len(present) < len(values):
            cast = float  # pandas stores an int column with NAs as float64
        return [None if v is None else cast(v) for v in values]
    return values


def _read_csv_columns(path: str) -> tuple[list[str], list[list]]:
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    columns = [_pandas_column([r[j] if j < len(r) else "" for r in body])
               for j in range(len(header))]
    return header, [list(r) for r in zip(*columns)] if body else []


def _cell(v) -> str:
    """A value as pandas' to_csv writes it: NA empty, floats by repr."""
    if v is None or (isinstance(v, float) and v != v):
        return ""
    return repr(v) if isinstance(v, float) else str(v)


def classify_folder(clip_model, image_folder: str, attributes: list[str],
                    prompts_path: str | None = None, save_path: str | None = None,
                    from_case: int = 0, till_case: int = 1_000_000,
                    batch_size: int = 32) -> tuple[list[str], list[list]]:
    """Returns (header, rows) of the CSV (rows of Python values, None for
    NA) and writes it to ``save_path`` when given."""
    names = sorted_nicely([n for n in os.listdir(image_folder) if n.endswith(".png")])
    votes: dict[int, list[np.ndarray]] = {}
    batch, meta = [], []

    def flush():
        if not batch:
            return
        pred = clip_model.classify(np.stack(batch), attributes)
        for case, p in zip(meta, pred):
            one_hot = np.zeros(len(attributes))
            one_hot[int(p)] = 1.0
            votes.setdefault(case, []).append(one_hot)
        batch.clear()
        meta.clear()

    for name in names:
        m = re.match(r"(\d+)_(\d+)\.png", name)
        if not m:
            continue
        case = int(m.group(1))
        if not from_case <= case <= till_case:
            continue
        with open(os.path.join(image_folder, name), "rb") as f:
            img = decode_png(f.read())
        if batch and img.shape != batch[0].shape:
            flush()
        batch.append(img)
        meta.append(case)
        if len(batch) >= batch_size:
            flush()
    flush()
    if not votes:
        raise FileNotFoundError(f"no case images found in {image_folder}")

    bias_cols = [f"{a.replace(' ', '_')}_bias" for a in attributes]
    means = {case: [float(x) for x in np.sum(v, axis=0) / len(v)]
             for case, v in votes.items()}
    if prompts_path:
        # a left merge: every prompts row, NA where the case has no images
        header, prompt_rows = _read_csv_columns(prompts_path)
        col = header.index("case_number")
        header = header + bias_cols
        rows = [r + means.get(r[col], [None] * len(attributes)) for r in prompt_rows]
    else:
        header = ["case_number"] + bias_cols
        rows = [[case] + means[case] for case in sorted(means)]
    if save_path:
        with open(save_path, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(header)
            w.writerows([_cell(v) for v in r] for r in rows)
    return header, rows


def register_cli(sub, add_device_flag) -> None:
    p = sub.add_parser("eval-clip-classify", help="zero-shot attribute ratios per case")
    p.add_argument("--image_folder", type=str, required=True)
    p.add_argument("--attributes", type=str, default="a man,a woman",
                   help="comma-separated candidate labels")
    p.add_argument("--prompts_path", type=str, default=None)
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--clip_model_id", type=str, default="openai/clip-vit-base-patch32")
    add_device_flag(p)
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1_000_000)
    p.add_argument("--column_name", type=str, default="gender")
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    from uce_tpu_torch.cli.main import resolve_device
    from uce_tpu_torch.models.clip import CLIPModel

    clip_model = CLIPModel.from_pretrained(args.clip_model_id,
                                           device=resolve_device(args.device))
    attributes = [a.strip() for a in args.attributes.split(",")]
    save_path = args.save_path or (
        args.image_folder.rstrip("/") + f"_{args.column_name}_classify.csv")
    _, rows = classify_folder(clip_model, args.image_folder, attributes,
                              prompts_path=args.prompts_path, save_path=save_path,
                              from_case=args.from_case, till_case=args.till_case)
    print(f"wrote {save_path} ({len(rows)} cases)")
    return 0
