"""``python -m uce_tpu_torch generate-hidream``: HiDream-I1 batch generation
over a prompts CSV (uce_tpu/cli/hidream_gen_cmd.py; the eval protocol's
{case}_{num}.png naming and case windows; HiDream-I1-Full's 50 steps,
guidance 5.0 and 128 text tokens, as trainscripts/uce_hidream_edit.py).

``--staged`` encodes every row first (the unconditional batch once), keeps
the embeddings on the host, frees the encoders and then loads the DiT: the
way HiDream-I1-Full fits one 80 GB card in bf16 (52 GB of fp32 encoders,
then 34 GB of DiT). ``--quantize w8|int8`` quantizes the DiT as it loads
(about 17 GB in w8: the whole pipeline fits unstaged). ``--mesh
data=N[,model=M]`` runs the denoise and decode on a mesh of processes
(``HiDreamPipeline.apply_mesh``; the encoders stay on the calling process,
and a staged DiT is laid out when it loads)."""

from __future__ import annotations


def register_cli(sub, add_device_flag) -> None:
    p = sub.add_parser("generate-hidream", help="HiDream-I1 CSV prompts -> PNG images")
    p.add_argument("--model_name", type=str, required=True,
                   help="local HiDream snapshot directory")
    p.add_argument("--llama_path", type=str, default=None,
                   help="local Llama-3.1-8B-Instruct snapshot (default: "
                        "<model_name>/text_encoder_4)")
    p.add_argument("--prompts_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--uce_model_path", type=str, default=None)
    add_device_flag(p)
    p.add_argument("--guidance_scale", type=float, default=5.0)
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--max_sequence_length", type=int, default=128)
    p.add_argument("--quantize", type=str, default=None, choices=["w8", "int8"],
                   help="quantize the MoE DiT as it loads: w8 = weight-only int8 "
                        "(half the weight memory), int8 = W8A8")
    p.add_argument("--staged", action="store_true",
                   help="encode every prompt with the four encoders first, free "
                        "them, then load the DiT into the freed memory")
    p.add_argument("--mesh", type=str, default=None, metavar="SPEC",
                   help="multi-device mesh 'data=N[,model=M]': the image batch over N "
                        "data groups, the DiT tensor- and expert-parallel over M "
                        "devices (one process per rank)")
    p.add_argument("--fast", type=str, default=None, metavar="SPEC",
                   help="CFG-interval window 'cfg_interval=lo:hi': the DiT runs the "
                        "cond rows alone outside it; cache=N is UNet-only and refused")
    p.add_argument("--from_case", type=int, default=0)
    p.add_argument("--till_case", type=int, default=1_000_000)
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    from uce_tpu_torch.cli.main import resolve_device
    from uce_tpu_torch.diffusion.pipeline_hidream import HiDreamPipeline, cfg_embeddings
    from uce_tpu_torch.diffusion.sampler import FastConfig
    from uce_tpu_torch.eval.generate import read_prompts_csv
    from uce_tpu_torch.parallel.mesh import mesh_from_spec
    from uce_tpu_torch.utils.imaging import case_window, save_case_images, uce_output_folder

    fast = None
    if args.fast:
        # checked before the encoders load: a bad spec fails in a second
        fast = FastConfig.from_spec(args.fast)
        if fast.cache_interval != 1:
            raise SystemExit("generate-hidream --fast supports cfg_interval only (a "
                             "DiT has no deep UNet levels to cache)")
    device = resolve_device(args.device)
    pipe = HiDreamPipeline.from_pretrained(
        args.model_name, llama_dir=args.llama_path,
        max_sequence_length=args.max_sequence_length, staged=args.staged,
        quantize=args.quantize, device=device)
    if args.uce_model_path:
        pipe.load_uce_edits(args.uce_model_path)
    if args.mesh:
        pipe.apply_mesh(mesh_from_spec(args.mesh, devices=device))
    folder = uce_output_folder(args.save_path, args.uce_model_path)
    rows = case_window(read_prompts_csv(args.prompts_path), args.from_case,
                       args.till_case)
    do_cfg = args.guidance_scale > 1.0
    kw = dict(num_inference_steps=args.num_inference_steps,
              guidance_scale=args.guidance_scale, num_images_per_prompt=args.num_samples,
              height=args.image_size, width=args.image_size, fast=fast)

    try:
        if args.staged:
            # phase 1: every row's embeddings, the unconditional batch encoded
            # once; kept on the host while the DiT takes the card's memory
            n = args.num_samples
            uncond = pipe.encode_prompts([""] * n) if do_cfg else None
            embeds = []
            for row in rows:
                e = pipe.encode_prompts([row["prompt"]] * n)
                e = cfg_embeddings(uncond, e) if do_cfg else e
                embeds.append(tuple(t.cpu() for t in e))
            del uncond
            pipe.free_encoders()
            for row, e in zip(rows, embeds):
                images = pipe.generate_from_embeddings(*e, do_cfg=do_cfg, n_prompts=1,
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
