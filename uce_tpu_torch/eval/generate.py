"""Batch image generation over a prompts CSV (evalscripts/generate-images-sd.py).

CSV columns ``case_number, prompt, evaluation_seed`` -> PNGs named
``{case}_{num}.png``, ``--from_case/--till_case`` resume windows, optional
UCE safetensors overlay.
"""

from __future__ import annotations

import csv

import torch

from uce_tpu_torch.diffusion.pipeline import SDPipeline
from uce_tpu_torch.diffusion.sampler import FastConfig
from uce_tpu_torch.utils.imaging import case_window, save_case_images, uce_output_folder

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# The strings that pandas.read_csv reads as NA by default (pandas'
# STR_NA_VALUES). uce_tpu reads the prompts CSV with pandas and passes
# str(prompt), so such a prompt reaches its pipeline as the text "nan";
# this reader does the same without pandas.
PANDAS_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def read_prompts_csv(path: str) -> list[dict]:
    """Rows ``{case_number, prompt, evaluation_seed}`` of a prompts CSV, as
    uce_tpu's pandas reading yields them (an NA prompt becomes "nan")."""
    with open(path, newline="", encoding="utf-8") as f:
        return [{"case_number": int(r["case_number"]),
                 "prompt": "nan" if r["prompt"] in PANDAS_NA_STRINGS else r["prompt"],
                 "evaluation_seed": int(r["evaluation_seed"])}
                for r in csv.DictReader(f)]


def generate_images(
    model_name: str,
    prompts_path: str,
    save_path: str,
    uce_model_path: str | None = None,
    device: str = "cuda",
    guidance_scale: float = 7.5,
    image_size: int = 512,
    ddim_steps: int = 50,
    num_samples: int = 1,
    from_case: int = 0,
    till_case: int = 1_000_000,
    dtype: str = "bfloat16",
    scheduler: str | None = None,
    batch_rows: int = 1,
    exp_name: str | None = None,
    fast: str | None = None,
) -> int:
    """Returns the number of generated cases. ``batch_rows`` rows (each
    with its own seed) share one batched denoise. ``fast`` is a
    ``FastConfig.from_spec`` spec (CFG window, DeepCache), opt-in beyond the
    reference protocol."""
    fast_cfg = FastConfig.from_spec(fast) if fast else None
    pipe = SDPipeline.from_pretrained(model_name, dtype=DTYPES[str(dtype)],
                                      device=device)
    if uce_model_path:
        pipe.load_uce_edits(uce_model_path)
    folder = uce_output_folder(save_path, uce_model_path, exp_name)
    rows = case_window(read_prompts_csv(prompts_path), from_case, till_case)
    step = max(batch_rows, 1)
    for i in range(0, len(rows), step):
        chunk = rows[i:i + step]
        images = pipe([r["prompt"] for r in chunk],
                      num_inference_steps=ddim_steps,
                      guidance_scale=guidance_scale,
                      num_images_per_prompt=num_samples,
                      seed=[r["evaluation_seed"] for r in chunk],
                      height=image_size, width=image_size, scheduler=scheduler,
                      fast=fast_cfg)
        for j, r in enumerate(chunk):
            save_case_images(images[j * num_samples:(j + 1) * num_samples],
                             folder, r["case_number"])
    return len(rows)


def register_cli(sub, add_device_flag) -> None:
    p = sub.add_parser("generate", help="CSV prompts -> PNG images (eval protocol)")
    p.add_argument("--model_id", "--model_name", dest="model_name", type=str,
                   required=True, help="local HF snapshot directory")
    p.add_argument("--prompts_path", type=str, required=True)
    p.add_argument("--save_path", type=str, default="../uce_results/")
    p.add_argument("--uce_model_path", type=str, default=None,
                   help="UCE safetensors overlay")
    p.add_argument("--exp_name", type=str, default=None,
                   help="output folder name (defaults to the UCE artifact "
                        "name or 'original')")
    add_device_flag(p)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--num_inference_steps", "--ddim_steps", dest="ddim_steps",
                   type=int, default=50)
    p.add_argument("--num_images_per_prompt", "--num_samples", dest="num_samples",
                   type=int, default=1)
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1_000_000)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    p.add_argument("--scheduler", choices=["ddim", "pndm", "lms", "euler"],
                   default=None, help="override the model's scheduler type "
                   "(its hyperparameters, e.g. v-prediction, carry over)")
    p.add_argument("--batch_rows", type=int, default=1,
                   help="fuse N CSV rows into one batched denoise")
    p.add_argument("--fast", type=str, default=None, metavar="SPEC",
                   help="beyond-protocol accelerations, e.g. "
                        "'cfg_interval=3:25,cache=2,level=1' (CFG only inside "
                        "the call window; DeepCache reuses the deep UNet "
                        "feature between every N-th call); omit for the exact "
                        "reference protocol")
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    from uce_tpu_torch.cli.main import resolve_device

    n = generate_images(
        args.model_name, args.prompts_path, args.save_path,
        uce_model_path=args.uce_model_path, device=resolve_device(args.device),
        guidance_scale=args.guidance_scale, image_size=args.image_size,
        ddim_steps=args.ddim_steps, num_samples=args.num_samples,
        from_case=args.from_case, till_case=args.till_case, dtype=args.dtype,
        scheduler=args.scheduler, batch_rows=args.batch_rows,
        exp_name=args.exp_name, fast=args.fast)
    print(f"generated {n} cases")
    return 0
