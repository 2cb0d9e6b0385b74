"""Comparison-baseline generators: concept algebra, debias-VL and SLD
(uce_tpu/eval/baselines.py).

The CLIs keep the reference scripts' surfaces (``evalscripts/
concept_algebra.py``, ``debiasing_vl.py``, ``sld-generate-images.py``):
folders ``{model_name}`` and ``SLD_{type}_{concept}``, and SLD's hard-coded
case filter as the optional ``--cases``. All three run ``SDPipeline`` with a
guidance mode; every CSV row is one pipeline call of ``--num_samples``
images.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from uce_tpu_torch.diffusion.guidance import (
    DEBIAS_VL_DEFAULT_PROFESSIONS,
    SLDConfig,
    build_gender_pairs,
    debias_vl_calibration,
)
from uce_tpu_torch.diffusion.pipeline import SDPipeline
from uce_tpu_torch.edit.embeddings import tokenize_batch
from uce_tpu_torch.eval.generate import DTYPES, read_prompts_csv
from uce_tpu_torch.models import clip_text
from uce_tpu_torch.utils.imaging import save_case_images


def _iter_cases(prompts_path: str, from_case: int, till_case: int, cases=None):
    for row in read_prompts_csv(prompts_path):
        case = row["case_number"]
        if cases is not None and case not in cases:
            continue
        if from_case <= case <= till_case:
            yield row


def _model_folder(save_path: str, model_name: str) -> str:
    folder = os.path.join(
        save_path, model_name.replace("diffusers-", "").replace(".pt", ""))
    os.makedirs(folder, exist_ok=True)
    return folder


def generate_concept_algebra(
    pipe, prompts_path, concepts_to_project, save_path, model_name="original",
    guidance_scale=7.5, image_size=512, ddim_steps=100, num_samples=10,
    from_case=0, till_case=1_000_000,
) -> int:
    folder = _model_folder(save_path, model_name)
    n = 0
    for row in _iter_cases(prompts_path, from_case, till_case):
        images = pipe(
            row["prompt"], num_inference_steps=ddim_steps,
            guidance_scale=guidance_scale, num_images_per_prompt=num_samples,
            seed=row["evaluation_seed"], height=image_size, width=image_size,
            scheduler="lms",  # the reference uses LMSDiscrete (:24)
            mode="concept_algebra", concepts_to_project=concepts_to_project)
        save_case_images(images, folder, row["case_number"])
        n += 1
    return n


def debias_vl_projection(pipe, debias_concepts, lam: float = 500.0) -> np.ndarray:
    """The calibration projection from the pipeline's own text encoder: the
    normalized embeddings at the EOS position, taken as the largest token
    id (``argmax(ids)``, as the reference does, debiasing_vl.py:69-79)."""
    prompts, pairs = build_gender_pairs(debias_concepts)
    ids, _ = tokenize_batch(pipe.tokenizer, prompts,
                            pipe.text_config.max_position_embeddings)
    with torch.inference_mode():
        last_hidden, _, _ = clip_text.encode_tokens(
            pipe.text_params, torch.as_tensor(ids, device=pipe.device), pipe.text_config)
    eos_idx = ids.argmax(-1)
    embeds = last_hidden.float().cpu().numpy()[np.arange(len(prompts)), eos_idx]
    embeds = embeds / np.linalg.norm(embeds, axis=-1, keepdims=True)
    return debias_vl_calibration(embeds, pairs, lam)


def generate_debias_vl(
    pipe, prompts_path, debias_concepts, save_path, model_name="original",
    guidance_scale=7.5, image_size=512, ddim_steps=100, num_samples=10,
    from_case=0, till_case=1_000_000, lam=500.0,
) -> int:
    if getattr(pipe, "is_sdxl", False):
        # the projection is built from encoder 1 (768 wide); SDXL's context
        # is 2048 wide
        raise ValueError(
            "debias-vl supports SD 1.x/2.x pipelines only (the reference "
            "implementation is single-encoder, debiasing_vl.py:69-79); "
            "got an SDXL pipeline")
    proj = debias_vl_projection(pipe, debias_concepts, lam)
    folder = _model_folder(save_path, model_name)
    n = 0
    for row in _iter_cases(prompts_path, from_case, till_case):
        images = pipe(
            row["prompt"], num_inference_steps=ddim_steps,
            guidance_scale=guidance_scale, num_images_per_prompt=num_samples,
            seed=row["evaluation_seed"], height=image_size, width=image_size,
            scheduler="lms", mode="debias_vl", debias_projection=proj)
        save_case_images(images, folder, row["case_number"])
        n += 1
    return n


def generate_sld(
    pipe, prompts_path, save_path, sld_concept=None, sld_type="Medium",
    guidance_scale=7.5, image_size=512, ddim_steps=50, num_samples=1,
    from_case=0, till_case=1_000_000, cases=None,
) -> int:
    folder = os.path.join(save_path, f"SLD_{sld_type}_{sld_concept}")
    os.makedirs(folder, exist_ok=True)
    cfg = SLDConfig.preset(sld_type)
    n = 0
    for row in _iter_cases(prompts_path, from_case, till_case, cases):
        images = pipe(
            row["prompt"], num_inference_steps=ddim_steps,
            guidance_scale=guidance_scale, num_images_per_prompt=num_samples,
            seed=row["evaluation_seed"], height=image_size, width=image_size,
            mode="sld", safety_concept=sld_concept, sld_config=cfg)
        save_case_images(images, folder, row["case_number"])
        n += 1
    return n


def _common_flags(p, add_device_flag, default_steps: int) -> None:
    p.add_argument("--model_name", type=str, required=True,
                   help="local HF snapshot directory")
    p.add_argument("--prompts_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    add_device_flag(p)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ddim_steps", type=int, default=default_steps)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1_000_000)
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")


def _make_pipe(args) -> SDPipeline:
    from uce_tpu_torch.cli.main import resolve_device

    return SDPipeline.from_pretrained(args.model_name, dtype=DTYPES[args.dtype],
                                      device=resolve_device(args.device))


def register_cli(sub, add_device_flag) -> None:
    p = sub.add_parser("concept-algebra",
                       help="score-space projection baseline generator")
    _common_flags(p, add_device_flag, 100)
    p.add_argument("--concepts_to_project", type=str,
                   default="a man,a woman,a person")
    p.set_defaults(func=_cmd_ca)

    p = sub.add_parser("debias-vl",
                       help="prompt-embedding calibration baseline generator")
    _common_flags(p, add_device_flag, 100)
    p.add_argument("--debias_concepts", type=str, default="")
    p.set_defaults(func=_cmd_dvl)

    p = sub.add_parser("sld-generate", help="Safe Latent Diffusion baseline generator")
    _common_flags(p, add_device_flag, 50)
    p.add_argument("--sld_concept", type=str, default=None)
    p.add_argument("--sld_type", choices=["Weak", "Medium", "Max"], default="Medium")
    p.add_argument("--cases", type=int, nargs="*", default=None,
                   help="restrict to these case numbers (the reference "
                        "hard-codes [0, 38, 51])")
    p.set_defaults(func=_cmd_sld)


def _model_name(args) -> str:
    return os.path.basename(args.model_name.rstrip("/"))


def _cmd_ca(args) -> int:
    concepts = [c.strip() for c in args.concepts_to_project.split(",")]
    if len(concepts) != 3:
        raise SystemExit("Error: Must provide 3 comma-separated concepts")
    n = generate_concept_algebra(
        _make_pipe(args), args.prompts_path, concepts, args.save_path,
        model_name=_model_name(args), guidance_scale=args.guidance_scale,
        image_size=args.image_size, ddim_steps=args.ddim_steps,
        num_samples=args.num_samples, from_case=args.from_case,
        till_case=args.till_case)
    print(f"generated {n} cases")
    return 0


def _cmd_dvl(args) -> int:
    concepts = [c.strip() for c in args.debias_concepts.split(",")]
    if concepts == [""]:
        print("Using default train list")
        concepts = DEBIAS_VL_DEFAULT_PROFESSIONS
    n = generate_debias_vl(
        _make_pipe(args), args.prompts_path, concepts, args.save_path,
        model_name=_model_name(args), guidance_scale=args.guidance_scale,
        image_size=args.image_size, ddim_steps=args.ddim_steps,
        num_samples=args.num_samples, from_case=args.from_case,
        till_case=args.till_case)
    print(f"generated {n} cases")
    return 0


def _cmd_sld(args) -> int:
    n = generate_sld(
        _make_pipe(args), args.prompts_path, args.save_path,
        sld_concept=args.sld_concept, sld_type=args.sld_type,
        guidance_scale=args.guidance_scale, image_size=args.image_size,
        ddim_steps=args.ddim_steps, num_samples=args.num_samples,
        from_case=args.from_case, till_case=args.till_case, cases=args.cases)
    print(f"generated {n} cases")
    return 0
