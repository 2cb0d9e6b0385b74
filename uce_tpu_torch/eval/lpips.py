"""LPIPS perceptual distance, AlexNet variant (evalscripts/lpips_eval.py;
uce_tpu/eval/lpips.py), and the pair-folder protocol that the style loss
shares.

Protocol: pair ``{case}_{num}.png`` across an original-model folder and an
edited-model folder, resize to 64² and map to [-1, 1] (lpips_eval.py:22-33,
51); per-case means, merged into the prompts CSV (a left merge on
case_number), written as uce_tpu's ``to_csv(index=False)`` writes them.

Weights: one file holding the lpips package's state dict (the lins as
``lin{i}.model.1.weight`` or ``lins.{i}.model.1.weight``, 1x1 convs) and
torchvision's AlexNet features, bare or under ``net.``; ``.pth`` through
``torch.load(weights_only=True)``, ``.safetensors`` through the port's own
reader.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from uce_tpu_torch.eval import table
from uce_tpu_torch.models.hf_loader import read_safetensors
from uce_tpu_torch.models.vision_backbones import (
    ALEXNET_CHANNELS,
    alexnet_features,
    convert_alexnet,
    init_alexnet_state_dict,
    params_to,
    resize_bilinear,
    to_unit,
)
from uce_tpu_torch.utils.imaging import load_image, stack_uniform

# the lpips package's scaling layer
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


def read_weights(path: str) -> dict:
    """A state dict from a ``.safetensors`` or a torch ``.pth``/``.pt`` file."""
    if path.endswith(".safetensors"):
        # torchvision's BatchNorm counters are int64: no model reads them
        return read_safetensors(path, keys=lambda k: not k.endswith("num_batches_tracked"))
    return torch.load(path, map_location="cpu", weights_only=True)


def load_lpips_weights(path: str, device="cuda") -> dict:
    """{AlexNet state dict + lin weights} from a file -> params on ``device``."""
    sd = read_weights(path)
    net_sd = {k.split("net.", 1)[1]: v for k, v in sd.items() if k.startswith("net.")}
    alex = convert_alexnet(net_sd if net_sd else sd)
    lins = []
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in sd:
                lins.append(sd[key].detach().to(torch.float32).reshape(-1))
                break
        else:
            raise KeyError(f"missing LPIPS linear weight lin{i}")
    return params_to({"alex": alex, "lins": lins}, device)


def init_lpips_state_dict(rng: np.random.Generator) -> dict[str, np.ndarray]:
    """Random weights in the lpips package's layout (``net.`` AlexNet
    features, non-negative lins [1, C, 1, 1]) at the published widths."""
    sd = {"net." + k: v for k, v in init_alexnet_state_dict(rng).items()}
    for i, c in enumerate(ALEXNET_CHANNELS):
        sd[f"lin{i}.model.1.weight"] = np.abs(
            rng.standard_normal((1, c, 1, 1)) * 0.1).astype(np.float32)
    return sd


def lpips_distance(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y [B, 3, H, W] in [-1, 1] -> LPIPS distance [B]."""
    shift = torch.tensor(LPIPS_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(LPIPS_SCALE, device=x.device).view(1, 3, 1, 1)
    fx = alexnet_features(params["alex"], (x - shift) / scale)
    fy = alexnet_features(params["alex"], (y - shift) / scale)
    total = 0.0
    for tap_x, tap_y, lin in zip(fx, fy, params["lins"]):
        nx = tap_x * torch.rsqrt((tap_x ** 2).sum(1, keepdim=True) + 1e-10)
        ny = tap_y * torch.rsqrt((tap_y ** 2).sum(1, keepdim=True) + 1e-10)
        diff = (nx - ny) ** 2
        total = total + (diff * lin.view(1, -1, 1, 1)).sum(1).mean(dim=(1, 2))
    return total


def batch_prep(size: int, device="cuda"):
    """uint8 [N, H, W, 3] -> [N, 3, size, size] in [-1, 1] on ``device``."""
    def prep(raw):
        return (resize_bilinear(to_unit(raw, device), (size, size)) - 0.5) * 2.0

    return prep


def eval_folders(
    params: dict,
    original_path: str,
    edited_path: str,
    prompts_path: str | None = None,
    save_path: str | None = None,
    image_size: int = 64,
    distance_fn=None,
    loss_column="lpips_loss",
    prep_fn=None,
    batch: int = 16,
    device="cuda",
) -> tuple[list[str], list[list]]:
    """Per-case mean distances between paired case images: the pair-folder
    protocol that the style loss shares. Returns the CSV's (header, rows).

    ``distance_fn(orig, edited)`` overrides the metric and may return a
    tuple of per-pair tensors for a tuple ``loss_column``; the default is
    LPIPS with ``params``. ``prep_fn`` overrides the uint8 -> model-input
    step. The CSV (lpips_eval.py:66-90): the prompts CSV with the per-case
    mean column(s) appended, or case_number and the column(s)."""
    if distance_fn is None:
        distance_fn = lambda a, b: lpips_distance(params, a, b)
    columns = (loss_column,) if isinstance(loss_column, str) else tuple(loss_column)

    pairs: list[tuple[int, str, str]] = []
    for name in sorted(n for n in os.listdir(original_path) if n.endswith(".png")):
        edited_file = os.path.join(edited_path, name)
        if not os.path.exists(edited_file):
            continue  # the reference skips missing pairs (lpips_eval.py:74-83)
        try:
            case = int(name.split("_")[0])
        except ValueError:
            continue
        pairs.append((case, os.path.join(original_path, name), edited_file))

    cases: dict[int, list[tuple]] = {}
    prep = prep_fn if prep_fn is not None else batch_prep(image_size, device)
    with torch.inference_mode():
        for i in range(0, len(pairs), batch):
            chunk = pairs[i:i + batch]
            a = prep(stack_uniform([load_image(p) for _, p, _ in chunk]))
            b = prep(stack_uniform([load_image(p) for _, _, p in chunk]))
            out = distance_fn(a, b)
            outs = [o.float().cpu().numpy() for o in
                    (out if isinstance(out, tuple) else (out,))]
            for j, (case, _, _) in enumerate(chunk):
                cases.setdefault(case, []).append(tuple(float(o[j]) for o in outs))
    if not cases:
        raise FileNotFoundError("no paired case images found")

    means = ["case_number", *columns], [
        [c, *(float(np.mean([v[k] for v in vals])) for k in range(len(columns)))]
        for c, vals in sorted(cases.items())]
    if prompts_path:
        means = table.merge(table.read_csv(prompts_path), means, "case_number", "left")
    if save_path:
        table.write_csv(save_path, *means)
    return means


def register_cli(sub, add_device_flag) -> None:
    p = sub.add_parser("eval-lpips", help="LPIPS distance between original/edited folders")
    p.add_argument("--original_path", type=str, required=True)
    p.add_argument("--edited_path", type=str, required=True)
    p.add_argument("--weights", type=str, required=True,
                   help="local LPIPS+AlexNet state dict (.pth/.safetensors)")
    p.add_argument("--prompts_path", type=str, default=None)
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--image_size", type=int, default=64)
    add_device_flag(p)
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    from uce_tpu_torch.cli.main import resolve_device

    device = resolve_device(args.device)
    params = load_lpips_weights(args.weights, device)
    save_path = args.save_path or (args.edited_path.rstrip("/") + "_lpipsloss.csv")
    result = eval_folders(params, args.original_path, args.edited_path,
                          prompts_path=args.prompts_path, save_path=save_path,
                          image_size=args.image_size, device=device)
    losses = [v for v in table.column(result, "lpips_loss") if v is not None]
    print(f"wrote {save_path} ({len(result[1])} cases, mean {np.mean(losses):.4f})")
    return 0
