"""ResNet-50 top-k ImageNet classification (evalscripts/imageclassify.py;
uce_tpu/eval/imageclassify.py).

Object-erasure accuracy: classify ``{case}_{num}.png`` images, one CSV row
per image with its top-k ``category/index/scores_top{k}``, an inner merge
with the prompts CSV, and ``correct`` where it has ``label_idx``
(imagenet_prompts.csv). A default save path is always derived (the
reference's ``name_`` NameError without ``--save_path``,
imageclassify.py:27-28, is not copied).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from uce_tpu_torch.eval import table
from uce_tpu_torch.eval.lpips import read_weights
from uce_tpu_torch.models.vision_backbones import (
    convert_resnet50,
    params_to,
    preprocess_imagenet,
    resnet50_logits,
)
from uce_tpu_torch.utils.imaging import load_image, stack_uniform


def load_resnet_weights(path: str, device="cuda") -> dict:
    return params_to(convert_resnet50(read_weights(path)), device)


def classify_folder(
    params: dict,
    image_folder: str,
    prompts_path: str | None = None,
    save_path: str | None = None,
    topk: int = 5,
    batch_size: int = 16,
    from_case: int = 0,
    till_case: int = 1_000_000,
    categories: list[str] | None = None,
    device="cuda",
) -> tuple[list[str], list[list]]:
    """The reference's CSV (imageclassify.py:80-87): per image
    ``case_number, num`` and ``category_top{i}, index_top{i},
    scores_top{i}`` for i = 1..topk, merged with the prompts CSV.
    ``categories`` maps a class index to its name (the index as text
    without it). The softmax and the top-k run on the host in numpy, as in
    uce_tpu. Returns (header, rows)."""
    header = ["case_number", "num"] + [
        f"{col}_top{i + 1}" for i in range(topk)
        for col in ("category", "index", "scores")]
    rows, batch, meta = [], [], []

    def flush():
        if not batch:
            return
        with torch.inference_mode():
            logits = resnet50_logits(params, preprocess_imagenet(
                stack_uniform(batch), device=device)).cpu().numpy()
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        top = np.argsort(-probs, axis=-1)[:, :topk]
        for (case, num), t, p in zip(meta, top, probs):
            row = [case, num]
            for i in range(topk):
                idx = int(t[i])
                row += [categories[idx] if categories else str(idx), idx, float(p[idx])]
            rows.append(row)
        batch.clear()
        meta.clear()

    for name in sorted(n for n in os.listdir(image_folder) if n.endswith(".png")):
        m = re.match(r"(\d+)_(\d+)\.png", name)
        if not m:
            continue
        case, num = int(m.group(1)), int(m.group(2))
        if not from_case <= case <= till_case:
            continue
        batch.append(load_image(os.path.join(image_folder, name)))
        meta.append((case, num))
        if len(batch) >= batch_size:
            flush()
    flush()
    if not rows:
        raise FileNotFoundError(f"no case images in {image_folder}")

    result = header, rows
    if prompts_path:
        result = table.merge(table.read_csv(prompts_path), result, "case_number", "inner")
        if "label_idx" in result[0]:
            header, rows = result
            hits = [table.column(result, f"index_top{i + 1}") for i in range(topk)]
            labels = table.column(result, "label_idx")
            rows = [r + [any(h[j] == labels[j] for h in hits)] for j, r in enumerate(rows)]
            result = header + ["correct"], rows
    if save_path:
        table.write_csv(save_path, *result)
    return result


def register_cli(sub, add_device_flag) -> None:
    p = sub.add_parser("eval-imageclassify",
                       help="ResNet-50 top-k classification of case images")
    p.add_argument("--image_folder", type=str, required=True)
    p.add_argument("--weights", type=str, required=True,
                   help="local torchvision resnet50 state dict (.pth/.safetensors)")
    p.add_argument("--prompts_path", type=str, default=None)
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--labels_path", type=str, default=None,
                   help="text file with one ImageNet category name per line (the "
                        "reference reads torchvision metadata)")
    add_device_flag(p)
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1_000_000)
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    from uce_tpu_torch.cli.main import resolve_device

    device = resolve_device(args.device)
    params = load_resnet_weights(args.weights, device)
    save_path = args.save_path or (args.image_folder.rstrip("/") + "_classification.csv")
    categories = None
    if args.labels_path:
        with open(args.labels_path) as f:
            categories = [line.strip() for line in f]
    header, rows = classify_folder(
        params, args.image_folder, prompts_path=args.prompts_path, save_path=save_path,
        topk=args.topk, from_case=args.from_case, till_case=args.till_case,
        categories=categories, device=device)
    if "correct" in header:
        correct = table.column((header, rows), "correct")
        print(f"top-{args.topk} accuracy: {np.mean(correct):.4f}")
    print(f"wrote {save_path} ({len(rows)} rows)")
    return 0
