"""CLI of the port: ``python -m uce_tpu_torch <edit-sd|edit-sdxl|edit-flux|
edit-hidream|debias-sd|generate|generate-flux|generate-hidream|serve|
sld-generate|concept-algebra|debias-vl|eval-clip-classify|eval-lpips|
eval-styleloss|eval-imageclassify|eval-clip-score|eval-nudenet|eval-dreamsim|
eval-compare|info> ...`` with the flag names of the uce_tpu CLI (and of the
reference scripts): every uce subcommand has its counterpart here.

``--device`` defaults to ``cuda``; ``cpu`` runs only when asked for. A run
that asks for cuda where there is none fails rather than use the CPU.
"""

from __future__ import annotations

import argparse
import sys

import torch

from uce_tpu_torch.utils.prompts import resolve_edit_request


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but torch finds no "
                           "CUDA device (pass --device cpu to run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported --device {name!r} (cuda or cpu)")
    return device


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")


def _add_edit_flags(p: argparse.ArgumentParser, default_model: str) -> None:
    p.add_argument("--edit_concepts", type=str, required=True,
                   help="concepts to erase, separated by ;")
    p.add_argument("--guide_concepts", type=str, default=None,
                   help="concepts to guide the erased concepts towards, ;-separated")
    p.add_argument("--preserve_concepts", type=str, default=None,
                   help="concepts to preserve, ;-separated")
    p.add_argument("--concept_type", choices=["art", "object"], required=True)
    p.add_argument("--model_id", type=str, default=default_model,
                   help="local HF snapshot directory of the model")
    _add_device_flag(p)
    p.add_argument("--erase_scale", type=float, default=1.0)
    p.add_argument("--preserve_scale", type=float, default=1.0)
    p.add_argument("--lamb", type=float, default=0.5)
    p.add_argument("--expand_prompts", choices=["true", "false"], default="false")
    p.add_argument("--save_dir", type=str, default="../uce_models")
    p.add_argument("--exp_name", type=str, default="uce_test")
    p.add_argument("--method", choices=["collapsed", "general", "pallas"],
                   default="collapsed",
                   help="collapsed: single edit-matrix via Cholesky; "
                        "general: per-layer batched solve; pallas: fused "
                        "Newton-Schulz kernel + fp32 refinement")
    p.add_argument("--apply_on", choices=["device", "host"],
                   default="device",
                   help="where the stacked W@E multiply runs; 'host' avoids "
                        "weight round-trips on slow host<->device links")


def cmd_edit_sd(args) -> int:
    from uce_tpu_torch.edit import sd as edit_sd

    device = resolve_device(args.device)
    edits, guides, preserves = resolve_edit_request(
        args.edit_concepts, args.guide_concepts, args.preserve_concepts,
        args.concept_type, args.expand_prompts == "true")
    print(f"\n\nErasing: {edits}\n")
    print(f"Guiding: {guides}\n")
    print(f"Preserving: {preserves}\n")
    res = edit_sd.load_resources(args.model_id, family=args.family, device=device)
    edit_sd.run_erase(res, edits, guides, preserves,
                      erase_scale=args.erase_scale, preserve_scale=args.preserve_scale,
                      lamb=args.lamb, save_dir=args.save_dir, exp_name=args.exp_name,
                      method=args.method, apply_on=args.apply_on)
    return 0


def build_parser() -> argparse.ArgumentParser:
    from uce_tpu_torch.cli import (debias_cmd, edit_cmds, flux_gen_cmd, hidream_gen_cmd,
                                   info_cmd, serve_cmd)
    from uce_tpu_torch.eval import (baselines, clip_classify, clip_score, compare_grids,
                                    dreamsim, generate, imageclassify, lpips, nudenet,
                                    styleloss)

    parser = argparse.ArgumentParser(
        prog="python -m uce_tpu_torch",
        description="Unified Concept Editing on PyTorch/CUDA (SD v1.x/v2.x, SDXL, "
                    "FLUX.1, HiDream-I1)")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("edit-sd", help="closed-form erase for SD v1.x/v2.x")
    _add_edit_flags(p, "CompVis/stable-diffusion-v1-4")
    p.set_defaults(func=cmd_edit_sd, family="sd")
    p = sub.add_parser("edit-sdxl", help="closed-form erase for SDXL")
    _add_edit_flags(p, "stabilityai/stable-diffusion-xl-base-1.0")
    p.set_defaults(func=cmd_edit_sd, family="sdxl")
    edit_cmds.register_cli(sub, _add_edit_flags)
    debias_cmd.register_cli(sub, _add_device_flag)
    generate.register_cli(sub, _add_device_flag)
    flux_gen_cmd.register_cli(sub, _add_device_flag)
    hidream_gen_cmd.register_cli(sub, _add_device_flag)
    serve_cmd.register_cli(sub, _add_device_flag)
    baselines.register_cli(sub, _add_device_flag)
    clip_classify.register_cli(sub, _add_device_flag)
    lpips.register_cli(sub, _add_device_flag)
    styleloss.register_cli(sub, _add_device_flag)
    imageclassify.register_cli(sub, _add_device_flag)
    clip_score.register_cli(sub, _add_device_flag)
    nudenet.register_cli(sub, _add_device_flag)
    dreamsim.register_cli(sub, _add_device_flag)
    compare_grids.register_cli(sub)
    info_cmd.register_cli(sub)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
