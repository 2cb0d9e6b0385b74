"""DreamSim perceptual distance (evalscripts/dreamsim_eval.py;
uce_tpu/eval/dreamsim.py).

The pairing protocol of LPIPS (``lpips.eval_folders`` at 224²), writing
``{folder}_dreamloss.csv``. The model is the ViT ensemble of a file written
by tools/convert_dreamsim.py: timm-format tensors under ``<model>/<key>``
and header metadata ``models`` (a comma list) and, per model,
``<model>.num_heads``, ``<model>.mean`` and ``<model>.std``. Per backbone:
its own normalization, the CLS embedding, L2-normalized; the backbones
concatenated and normalized again; the distance is 1 - cosine similarity
(dreamsim's PerceptualModel with feat_type=cls). uce_tpu's route through
the ``dreamsim`` package has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from uce_tpu_torch.eval import lpips, table
from uce_tpu_torch.models.hf_loader import read_safetensors, read_safetensors_metadata
from uce_tpu_torch.models.vision_backbones import (
    convert_vit_timm,
    normalize,
    params_to,
    vit_cls_embed,
)
from uce_tpu_torch.ops.solver import full_fp32


def _floats(text: str) -> tuple[float, ...]:
    return tuple(float(v) for v in text.split(","))


def load_dreamsim(weights_path: str, device="cuda"):
    """distance_fn(a, b) over [-1, 1] NCHW batches on ``device`` -> [B]."""
    tensors = read_safetensors(weights_path)
    meta = read_safetensors_metadata(weights_path)
    models = [m for m in meta.get("models", "").split(",") if m]
    if not models:
        raise ValueError(f"{weights_path} has no 'models' metadata: produce it with "
                         "tools/convert_dreamsim.py")
    backbones = []
    for m in models:
        sd = {k[len(m) + 1:]: v for k, v in tensors.items() if k.startswith(m + "/")}
        backbones.append((params_to(convert_vit_timm(sd), device),
                          int(meta[f"{m}.num_heads"]), _floats(meta[f"{m}.mean"]),
                          _floats(meta[f"{m}.std"])))

    def embed(img01):
        parts = []
        for params, heads, mean, std in backbones:
            e = vit_cls_embed(params, normalize(img01, mean, std), heads)
            parts.append(e / torch.linalg.vector_norm(e, dim=-1, keepdim=True))
        e = torch.cat(parts, dim=-1)
        return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)

    def distance_fn(a, b):
        # fp32 as in uce_tpu: torch's default lets cuDNN take TF32 for convs
        with full_fp32():
            return 1.0 - (embed((a + 1) / 2) * embed((b + 1) / 2)).sum(-1)

    return distance_fn


def eval_folders(distance_fn, original_path, edited_path, prompts_path=None,
                 save_path=None, image_size=224, device="cuda"):
    return lpips.eval_folders(None, original_path, edited_path,
                              prompts_path=prompts_path, save_path=save_path,
                              image_size=image_size, distance_fn=distance_fn,
                              loss_column="dream_loss", device=device)


def register_cli(sub, add_device_flag) -> None:
    p = sub.add_parser("eval-dreamsim",
                       help="DreamSim distance between original/edited folders")
    p.add_argument("--original_path", type=str, required=True)
    p.add_argument("--edited_path", type=str, required=True)
    p.add_argument("--prompts_path", type=str, default=None)
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--cache_dir", type=str, default=None,
                   help="unused: the dreamsim package route is not part of the port")
    p.add_argument("--weights", "--jax_weights", dest="weights", type=str, default=None,
                   help="converted DreamSim ensemble safetensors "
                        "(tools/convert_dreamsim.py); --jax_weights is an alias")
    p.add_argument("--image_size", type=int, default=224)
    add_device_flag(p)
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    from uce_tpu_torch.cli.main import resolve_device

    if not args.weights:
        raise ImportError(
            "eval-dreamsim needs --weights FILE, the ensemble converted once by "
            "tools/convert_dreamsim.py (the 'dreamsim' package route is not part of "
            "the port)")
    device = resolve_device(args.device)
    distance_fn = load_dreamsim(args.weights, device)
    save_path = args.save_path or (args.edited_path.rstrip("/") + "_dreamloss.csv")
    result = eval_folders(distance_fn, args.original_path, args.edited_path,
                          prompts_path=args.prompts_path, save_path=save_path,
                          image_size=args.image_size, device=device)
    losses = [v for v in table.column(result, "dream_loss") if v is not None]
    print(f"wrote {save_path} ({len(result[1])} cases, mean {np.mean(losses):.4f})")
    return 0
