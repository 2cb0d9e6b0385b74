"""``python -m uce_tpu_torch generate-flux``: FLUX.1 batch generation over a
prompts CSV (uce_tpu/cli/flux_gen_cmd.py; the eval protocol's
{case}_{num}.png naming and case windows; schnell's defaults of 4 steps and
guidance 0, as notebooks/inference_flux.ipynb)."""

from __future__ import annotations

# The options of uce_tpu's generate-flux that this port does not take yet,
# each with the ROADMAP queue 1 item that holds it.
NOT_PORTED = {
    "quantize": "--quantize (the DiT in w8/int8) is not ported yet (ROADMAP queue 1 "
                "item 17)",
    "staged": "--staged (encode, free the encoders, then load the DiT) is not "
              "ported yet (ROADMAP queue 1 item 17)",
    "mesh": "--mesh is not ported yet (ROADMAP queue 1 item 4; one GPU for now)",
}


def register_cli(sub, add_device_flag) -> None:
    p = sub.add_parser("generate-flux", help="FLUX.1 CSV prompts -> PNG images")
    p.add_argument("--model_name", type=str, required=True,
                   help="local FLUX snapshot directory")
    p.add_argument("--prompts_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--uce_model_path", type=str, default=None)
    add_device_flag(p)
    p.add_argument("--guidance_scale", type=float, default=0.0)
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--num_inference_steps", type=int, default=4)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--max_sequence_length", type=int, default=None)
    p.add_argument("--quantize", type=str, default=None, choices=["w8", "int8"],
                   help="not ported yet")
    p.add_argument("--staged", action="store_true", help="not ported yet")
    p.add_argument("--mesh", type=str, default=None, metavar="SPEC",
                   help="not ported yet")
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1_000_000)
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    from uce_tpu_torch.cli.main import resolve_device
    from uce_tpu_torch.diffusion.pipeline_flux import FluxPipeline
    from uce_tpu_torch.eval.generate import read_prompts_csv
    from uce_tpu_torch.utils.imaging import case_window, save_case_images, uce_output_folder

    for flag, why in NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(why)
    pipe = FluxPipeline.from_pretrained(args.model_name,
                                        max_sequence_length=args.max_sequence_length,
                                        device=resolve_device(args.device))
    if args.uce_model_path:
        pipe.load_uce_edits(args.uce_model_path)
    folder = uce_output_folder(args.save_path, args.uce_model_path)
    rows = case_window(read_prompts_csv(args.prompts_path), args.from_case,
                       args.till_case)
    for row in rows:
        images = pipe(row["prompt"], num_inference_steps=args.num_inference_steps,
                      guidance_scale=args.guidance_scale,
                      num_images_per_prompt=args.num_samples,
                      seed=row["evaluation_seed"], height=args.image_size,
                      width=args.image_size)
        save_case_images(images, folder, row["case_number"])
    print(f"generated {len(rows)} cases")
    return 0
