"""Mean CLIP score of generated images against their prompts
(evalscripts/mean_clip.py as a CLI; uce_tpu/eval/clip_score.py).

For each prompts-CSV row, the scaled cosine similarity (``logits_per_image``)
of ``{case}_{num}.png`` with the row's caption; missing images are
skipped; the mean over all scored images.
"""

from __future__ import annotations

import os

import numpy as np

from uce_tpu_torch.eval import table
from uce_tpu_torch.utils.imaging import case_image_path, load_image


def mean_clip_score(clip_model, image_folder: str, prompts_path: str,
                    num_samples: int = 1, from_case: int = 0,
                    till_case: int = 1_000_000, batch_size: int = 16) -> float:
    """The embeddings are normalized and scored on the host in numpy, as in
    uce_tpu."""
    prompts = table.read_csv(prompts_path)
    scores: list[float] = []
    batch_imgs, batch_prompts = [], []

    def flush():
        if not batch_imgs:
            return
        img_e = clip_model.embed_images(np.stack(batch_imgs)).float().cpu().numpy()
        txt_e = clip_model.embed_texts(batch_prompts).float().cpu().numpy()
        img_e = img_e / np.linalg.norm(img_e, axis=-1, keepdims=True)
        txt_e = txt_e / np.linalg.norm(txt_e, axis=-1, keepdims=True)
        scores.extend(((img_e * txt_e).sum(-1) * clip_model.logit_scale).tolist())
        batch_imgs.clear()
        batch_prompts.clear()

    for case, prompt in zip(table.column(prompts, "case_number"),
                            table.column(prompts, "prompt")):
        if not from_case <= case <= till_case:
            continue
        for num in range(num_samples):
            path = case_image_path(image_folder, case, num)
            if not os.path.exists(path):
                continue  # the reference skips missing files (mean_clip.py:41-52)
            batch_imgs.append(load_image(path))
            batch_prompts.append("nan" if prompt is None else str(prompt))
            if len(batch_imgs) >= batch_size:
                flush()
    flush()
    if not scores:
        raise FileNotFoundError(f"no scored images under {image_folder}")
    return float(np.mean(scores))


def register_cli(sub, add_device_flag) -> None:
    p = sub.add_parser("eval-clip-score", help="mean CLIP similarity of images vs captions")
    p.add_argument("--image_folder", type=str, required=True)
    p.add_argument("--prompts_path", type=str, required=True)
    p.add_argument("--clip_model_id", type=str, default="openai/clip-vit-base-patch32")
    add_device_flag(p)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1_000_000)
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    from uce_tpu_torch.cli.main import resolve_device
    from uce_tpu_torch.models.clip import CLIPModel

    clip_model = CLIPModel.from_pretrained(args.clip_model_id,
                                           device=resolve_device(args.device))
    score = mean_clip_score(clip_model, args.image_folder, args.prompts_path,
                            num_samples=args.num_samples, from_case=args.from_case,
                            till_case=args.till_case)
    print(f"mean CLIP score: {score}")
    return 0
