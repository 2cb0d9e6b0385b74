"""``python -m uce_tpu_torch debias-sd``: iterative debiasing through the
generate -> CLIP-classify -> re-solve loop (reference:
trainscripts/uce_sd_debias.py's CLI; uce_tpu/cli/debias_cmd.py)."""

from __future__ import annotations


def register_cli(sub, add_device_flag) -> None:
    p = sub.add_parser("debias-sd",
                       help="iterative debiasing via generate->classify loop")
    p.add_argument("--edit_concepts", type=str, required=True)
    p.add_argument("--debias_concepts", type=str, required=True,
                   help="attributes to debias across, ;-separated")
    p.add_argument("--preserve_concepts", type=str, default=None)
    p.add_argument("--model_id", type=str, default="CompVis/stable-diffusion-v1-4",
                   help="local HF snapshot directory")
    p.add_argument("--clip_model_id", type=str,
                   default="openai/clip-vit-base-patch32",
                   help="local CLIP snapshot directory for classification")
    add_device_flag(p)
    p.add_argument("--edit_scale", type=float, default=1.0)
    p.add_argument("--preserve_scale", type=float, default=1.0)
    p.add_argument("--lamb", type=float, default=0.5)
    p.add_argument("--save_dir", type=str, default="../uce_models")
    p.add_argument("--exp_name", type=str, default="uce_test")
    p.add_argument("--desired_ratios", type=float, nargs="+", default=[0.5, 0.5])
    p.add_argument("--max_iterations", type=int, default=30)
    p.add_argument("--max_diff", type=float, default=0.05)
    p.add_argument("--step_size", type=float, default=0.1,
                   help="accepted for reference-CLI compatibility (the reference "
                        "never uses it)")
    p.add_argument("--num_images_per_prompt", type=int, default=10)
    p.add_argument("--num_inference_steps", type=int, default=20)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--snapshot_every", type=int, default=None,
                   help="save intermediate safetensors every N iterations")
    p.add_argument("--telemetry_path", type=str, default=None,
                   help="CSV to record per-iteration observed/ratio values")
    p.add_argument("--mesh", type=str, default=None, metavar="SPEC",
                   help="multi-device mesh, 'data=N[,model=M]': the measurement "
                        "images run on the data ranks, the UNet split over the model "
                        "ranks; the re-solve and the classifier stay on rank 0")
    p.add_argument("--fast", type=str, default=None, metavar="SPEC",
                   help="beyond-protocol fast path for the measurement "
                        "generations, e.g. 'cfg_interval=3:25,cache=2' (the "
                        "controller reads CLIP ratios, not pixels; opt-in)")
    p.add_argument("--device_resident", choices=["true", "false"], default="true",
                   help="keep the per-iteration re-solve and weight swap on the "
                        "card (bit-identical to the host path); 'false' takes "
                        "the host solve and re-upload path")
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    import torch

    from uce_tpu_torch.cli.main import resolve_device
    from uce_tpu_torch.diffusion.pipeline import SDPipeline
    from uce_tpu_torch.diffusion.sampler import FastConfig
    from uce_tpu_torch.utils.prompts import parse_concepts

    edit_concepts = parse_concepts(args.edit_concepts)
    debias_concepts = parse_concepts(args.debias_concepts)
    preserve_concepts = (parse_concepts(args.preserve_concepts)
                         if args.preserve_concepts else [])
    if len(debias_concepts) != len(args.desired_ratios):
        raise SystemExit(
            "Error! The length of debias concepts and their corresponding "
            "desired ratios do not match.")
    fast = FastConfig.from_spec(args.fast) if args.fast else None
    device = resolve_device(args.device)

    print(f"\n\nEditing: {edit_concepts}\n")
    print(f"Debias Across: {debias_concepts}\n")
    print(f"Preserving: {preserve_concepts}\n")

    pipe = SDPipeline.from_pretrained(args.model_id, dtype=torch.bfloat16,
                                      device=device)
    if args.mesh:
        from uce_tpu_torch.parallel.mesh import mesh_from_spec

        pipe.apply_mesh(mesh_from_spec(args.mesh, devices=device))
    try:
        _run(args, pipe, edit_concepts, debias_concepts, preserve_concepts, fast, device)
    finally:
        pipe.apply_mesh(None)  # stops the mesh's ranks (a no-op without one)
    return 0


def _run(args, pipe, edit_concepts, debias_concepts, preserve_concepts, fast, device):
    from uce_tpu_torch.edit.debias import DebiasSettings, run_debias
    from uce_tpu_torch.models.clip import CLIPModel

    clip_model = CLIPModel.from_pretrained(args.clip_model_id, device=device)
    settings = DebiasSettings(
        desired_ratios=args.desired_ratios, max_iterations=args.max_iterations,
        max_diff=args.max_diff, num_images_per_prompt=args.num_images_per_prompt,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, edit_scale=args.edit_scale,
        preserve_scale=args.preserve_scale, lamb=args.lamb)
    run_debias(pipe, clip_model, edit_concepts, debias_concepts, preserve_concepts,
               settings=settings, save_dir=args.save_dir, exp_name=args.exp_name,
               image_size=args.image_size, snapshot_every=args.snapshot_every,
               telemetry_path=args.telemetry_path, fast=fast,
               device_resident=args.device_resident == "true")
