"""Gatys VGG-19 Gram-matrix style/content loss (evalscripts/styleloss.py;
uce_tpu/eval/styleloss.py).

Sequential conv naming as the reference assembles its model
(styleloss.py:113-170): conv_1..conv_5 are the first five Conv2d layers,
with the loss taps on the conv outputs; content layer conv_4, style layers
conv_1..conv_5; weights style 1e6, content 1 (:174). Per-case means ->
``{folder}_styleloss.csv`` through ``lpips.eval_folders``' pair protocol.
"""

from __future__ import annotations

import torch

from uce_tpu_torch.eval import lpips, table
from uce_tpu_torch.models.vision_backbones import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    convert_vgg19,
    normalize,
    params_to,
    resize_bilinear,
    to_unit,
    vgg19_features,
)

STYLE_LAYERS = (0, 1, 2, 3, 4)  # conv_1..conv_5
CONTENT_LAYER = 3  # conv_4
STYLE_WEIGHT = 1e6
CONTENT_WEIGHT = 1.0


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> normalized Gram [B, C, C] (styleloss.py:49-60). The
    reference normalizes by C*H*W per image; the batch here is independent
    images and stays out of the normalizer."""
    b, c, h, w = feat.shape
    f = feat.reshape(b, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (h * w * c)


def style_content_loss(params: dict, image: torch.Tensor, style_ref: torch.Tensor,
                       content_ref: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(style_loss, content_loss) per batch element."""
    taps_img = vgg19_features(params, image, num_convs=5)
    taps_style = vgg19_features(params, style_ref, num_convs=5)
    # the eval passes the original image as both references: one forward
    taps_content = (taps_style if content_ref is style_ref
                    else vgg19_features(params, content_ref, num_convs=5))
    style = 0.0
    for i in STYLE_LAYERS:
        g_img, g_ref = gram_matrix(taps_img[i]), gram_matrix(taps_style[i])
        style = style + ((g_img - g_ref) ** 2).mean(dim=(1, 2))
    content = ((taps_img[CONTENT_LAYER] - taps_content[CONTENT_LAYER]) ** 2
               ).mean(dim=(1, 2, 3))
    return STYLE_WEIGHT * style, CONTENT_WEIGHT * content


def batch_prep(size: int, device="cuda"):
    """uint8 [N, H, W, 3] -> ImageNet-normalized [N, 3, size, size]."""
    def prep(raw):
        x = resize_bilinear(to_unit(raw, device), (size, size))
        return normalize(x, IMAGENET_MEAN, IMAGENET_STD)

    return prep


def eval_folders(params: dict, original_path: str, edited_path: str,
                 prompts_path: str | None = None, save_path: str | None = None,
                 image_size: int = 512, device="cuda") -> tuple[list[str], list[list]]:
    """Style/content loss of the edited images against the originals (the
    original is both the style and the content reference, the interference
    protocol), then ``total_loss`` = style + content per case."""
    header, rows = lpips.eval_folders(
        None, original_path, edited_path, prompts_path=prompts_path,
        image_size=image_size,
        distance_fn=lambda ref, img: style_content_loss(params, img, ref, ref),
        loss_column=("style_loss", "content_loss"),
        prep_fn=batch_prep(image_size, device), batch=8, device=device)
    s, c = header.index("style_loss"), header.index("content_loss")
    header = header + ["total_loss"]
    rows = [r + [None if r[s] is None or r[c] is None else r[s] + r[c]] for r in rows]
    if save_path:
        table.write_csv(save_path, header, rows)
    return header, rows


def load_vgg_weights(path: str, device="cuda") -> dict:
    return params_to(convert_vgg19(lpips.read_weights(path)), device)


def register_cli(sub, add_device_flag) -> None:
    p = sub.add_parser("eval-styleloss",
                       help="VGG19 Gram style/content loss between folders")
    p.add_argument("--original_path", type=str, required=True)
    p.add_argument("--edited_path", type=str, required=True)
    p.add_argument("--weights", type=str, required=True,
                   help="local VGG19 state dict (.pth/.safetensors)")
    p.add_argument("--prompts_path", type=str, default=None)
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--image_size", type=int, default=512,
                   help="reference: 512 on GPU, 128 on CPU")
    add_device_flag(p)
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    from uce_tpu_torch.cli.main import resolve_device

    device = resolve_device(args.device)
    params = load_vgg_weights(args.weights, device)
    save_path = args.save_path or (args.edited_path.rstrip("/") + "_styleloss.csv")
    _, rows = eval_folders(params, args.original_path, args.edited_path,
                           prompts_path=args.prompts_path, save_path=save_path,
                           image_size=args.image_size, device=device)
    print(f"wrote {save_path} ({len(rows)} cases)")
    return 0
