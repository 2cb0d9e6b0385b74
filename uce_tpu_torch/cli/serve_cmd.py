"""``python -m uce_tpu_torch serve``: generation server over a Unix socket
(uce_tpu/cli/serve_cmd.py).

Loads an SDPipeline (``--family sd``), a FluxPipeline (``--family flux``) or
a HiDreamPipeline (``--family hidream``, its Llama from ``--llama_dir`` or
the snapshot's ``text_encoder_4``) once, quantizes it (``--quantize
int8|w8``: the SD UNet and VAE after the load; a DiT as it loads, since a
full-size bf16 DiT may not fit beside its encoders, as HiDream-I1-Full's
does not on one 80 GB card), overlays a UCE edit, lays it out on a mesh of
processes (``--mesh data=N[,model=M]``: each batch's denoise and decode are
sharded, the encoders and the queue stay here), warms every batch size of
the ladder, and serves JSON-line requests with dynamic batching
(``uce_tpu_torch/serving/``). The reference has no
serving path: its eval scripts reload the pipeline per process
(evalscripts/generate-images-sd.py:13-15).

Client example::

    python -m uce_tpu_torch serve --model_id /models/sd14 --socket uce.sock &
    python -c "from uce_tpu_torch.serving.socket_api import request; \\
        print(request('uce.sock', {'prompt': 'a cat', 'seed': 7, \\
                                   'save_path': 'cat.png'}))"
"""

from __future__ import annotations

import json
import os
import tempfile


def register_cli(sub, add_device_flag) -> None:
    p = sub.add_parser(
        "serve", help="generation server with dynamic batching (Unix socket)")
    p.add_argument("--model_id", type=str, required=True,
                   help="local HF snapshot directory")
    p.add_argument("--family", type=str, default="sd",
                   choices=["sd", "flux", "hidream"],
                   help="pipeline family")
    p.add_argument("--llama_dir", type=str, default=None,
                   help="Llama snapshot for --family hidream (default: "
                        "<model_id>/text_encoder_4)")
    p.add_argument("--socket", type=str,
                   default=os.path.join(tempfile.gettempdir(), "uce.sock"))
    p.add_argument("--uce_model_path", type=str, default=None,
                   help="safetensors edit overlay to serve")
    p.add_argument("--quantize", type=str, default=None,
                   choices=["w8", "int8"],
                   help="quantize the UNet and VAE (sd) or the DiT (flux, hidream; "
                        "as it loads): int8 = W8A8 (int8 products; on the UNet "
                        "also the int8-QK^T attention kernel), w8 = weight-only "
                        "int8 (half the weight memory)")
    p.add_argument("--batch_size", type=int, default=4,
                   help="serving batch (requests pad into it)")
    p.add_argument("--batch_sizes", type=str, default=None,
                   help="comma-separated LADDER of batch sizes (e.g. "
                        "'1,2,4,8'): each gathered batch runs the smallest "
                        "size that fits, so low-rate traffic avoids paying "
                        "full-batch device time; warmup runs every rung "
                        "(overrides --batch_size)")
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--scheduler", type=str, default=None)
    p.add_argument("--max_wait_ms", type=float, default=50.0,
                   help="max linger for batch fill once a request arrives")
    p.add_argument("--pin_rung", action="store_true",
                   help="always run the TOP batch rung: one batch shape "
                        "serves all traffic, restoring bit-reproducible "
                        "outputs per (prompt, seed) under a --batch_sizes "
                        "ladder (costs the low-rate latency win)")
    p.add_argument("--fast", type=str, default=None, metavar="SPEC",
                   help="beyond-protocol accelerations, e.g. "
                        "'cfg_interval=3:25,cache=2,level=1' (CFG only inside "
                        "the call window; DeepCache reuses the deep UNet "
                        "feature between every N-th call)")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the warmup batches")
    p.add_argument("--bench", type=str, default=None, metavar="RATES",
                   help="instead of serving a socket, run a synthetic "
                        "Poisson load at these comma-separated request/s "
                        "rates (e.g. '0.5,1,2') and print one JSON report "
                        "line per rate (serving/loadgen.py)")
    p.add_argument("--bench_requests", type=int, default=24,
                   help="requests per --bench rate")
    p.add_argument("--mesh", type=str, default=None, metavar="SPEC",
                   help="multi-device mesh 'data=N[,model=M]': each batch over N data "
                        "groups, the denoiser tensor-parallel over M devices (one "
                        "process per rank)")
    add_device_flag(p)
    p.set_defaults(func=_cmd)


def _cmd(args) -> int:
    from uce_tpu_torch.cli.main import resolve_device
    from uce_tpu_torch.parallel.mesh import mesh_from_spec

    device = resolve_device(args.device)
    if args.family == "flux":
        from uce_tpu_torch.diffusion.pipeline_flux import FluxPipeline

        pipe = FluxPipeline.from_pretrained(args.model_id, quantize=args.quantize,
                                            device=device)
    elif args.family == "hidream":
        from uce_tpu_torch.diffusion.pipeline_hidream import HiDreamPipeline

        pipe = HiDreamPipeline.from_pretrained(args.model_id, llama_dir=args.llama_dir,
                                               quantize=args.quantize, device=device)
    else:
        from uce_tpu_torch.diffusion.pipeline import SDPipeline

        pipe = SDPipeline.from_pretrained(args.model_id, device=device)
        if args.quantize:
            pipe.quantize_weights(args.quantize)
    if args.uce_model_path:
        pipe.load_uce_edits(args.uce_model_path)
    if args.mesh:
        pipe.apply_mesh(mesh_from_spec(args.mesh, devices=device))
    try:
        return _serve(pipe, args)
    finally:
        pipe.apply_mesh(None)


def _serve(pipe, args) -> int:
    from uce_tpu_torch.serving.server import GenerationServer, ServerConfig
    from uce_tpu_torch.serving.socket_api import SocketFrontend

    batch_sizes = tuple(
        int(s) for s in args.batch_sizes.split(",") if s.strip()
    ) if args.batch_sizes else ()
    cfg = ServerConfig(
        batch_size=args.batch_size,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        height=args.image_size, width=args.image_size,
        scheduler=args.scheduler, max_wait_ms=args.max_wait_ms,
        warmup=not args.no_warmup,
        batch_sizes=batch_sizes,
        pin_rung=args.pin_rung,
        fast=args.fast,
    )
    if args.bench:
        from uce_tpu_torch.serving.loadgen import run_load

        rates = [float(r) for r in args.bench.split(",") if r.strip()]
        with GenerationServer(pipe, cfg) as server:
            for rate in rates:
                report = run_load(server, rate, args.bench_requests)
                print(json.dumps(report.json()), flush=True)
        return 0

    # Bind the socket BEFORE the warmup: an occupied socket path fails in
    # milliseconds instead of after the warm-up batches, and clients can
    # queue on the endpoint while warmup runs.
    server = GenerationServer(pipe, cfg)
    frontend = SocketFrontend(server, args.socket)
    try:
        server.start()
        print(f"uce serve: listening on {args.socket} "
              f"(batches={list(server.batch_sizes)}, "
              f"{cfg.height}x{cfg.width}, "
              f"steps={cfg.num_inference_steps})", flush=True)
        frontend.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        frontend.close()
        server.close()
    return 0
