"""``python -m uce_tpu_torch generate-flux``: FLUX.1 batch generation over a
prompts CSV (uce_tpu/cli/flux_gen_cmd.py; the eval protocol's
{case}_{num}.png naming and case windows; schnell's defaults of 4 steps and
guidance 0, as notebooks/inference_flux.ipynb).

``--quantize w8|int8`` quantizes the DiT as it loads; ``--staged`` encodes
every row first, keeps the embeddings on the host, frees the encoders and
then loads the DiT. ``--mesh data=N[,model=M]`` runs the denoise and decode
on a mesh of processes (``FluxPipeline.apply_mesh``; a staged DiT is laid
out when it loads)."""

from __future__ import annotations


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
                   help="quantize the DiT as it loads: w8 = weight-only int8 (half "
                        "the weight memory), int8 = W8A8")
    p.add_argument("--staged", action="store_true",
                   help="encode every prompt first, free the T5 and CLIP encoders, "
                        "then load the DiT into the freed memory")
    p.add_argument("--mesh", type=str, default=None, metavar="SPEC",
                   help="multi-device mesh 'data=N[,model=M]': the image batch over N "
                        "data groups, the DiT tensor-parallel over M devices (one "
                        "process per rank)")
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1_000_000)
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    from uce_tpu_torch.cli.main import resolve_device
    from uce_tpu_torch.diffusion.pipeline_flux import FluxPipeline
    from uce_tpu_torch.eval.generate import read_prompts_csv
    from uce_tpu_torch.parallel.mesh import mesh_from_spec
    from uce_tpu_torch.utils.imaging import case_window, save_case_images, uce_output_folder

    device = resolve_device(args.device)
    pipe = FluxPipeline.from_pretrained(args.model_name,
                                        max_sequence_length=args.max_sequence_length,
                                        staged=args.staged, quantize=args.quantize,
                                        device=device)
    if args.uce_model_path:
        pipe.load_uce_edits(args.uce_model_path)
    if args.mesh:
        pipe.apply_mesh(mesh_from_spec(args.mesh, devices=device))
    folder = uce_output_folder(args.save_path, args.uce_model_path)
    rows = case_window(read_prompts_csv(args.prompts_path), args.from_case,
                       args.till_case)
    kw = dict(num_inference_steps=args.num_inference_steps,
              guidance_scale=args.guidance_scale, num_images_per_prompt=args.num_samples,
              height=args.image_size, width=args.image_size)
    try:
        if args.staged:
            # phase 1: every row's embeddings, kept on the host while the DiT
            # takes the card's memory
            embeds = [tuple(t.cpu() for t in pipe.encode_prompts([row["prompt"]]
                                                                 * args.num_samples))
                      for row in rows]
            pipe.free_encoders()
            for row, (t5_embeds, pooled) in zip(rows, embeds):
                images = pipe.generate_from_embeddings(t5_embeds, pooled, n_prompts=1,
                                                       seed=row["evaluation_seed"], **kw)
                save_case_images(images, folder, row["case_number"])
        else:
            for row in rows:
                images = pipe(row["prompt"], seed=row["evaluation_seed"], **kw)
                save_case_images(images, folder, row["case_number"])
    finally:
        pipe.apply_mesh(None)
    print(f"generated {len(rows)} cases")
    return 0
