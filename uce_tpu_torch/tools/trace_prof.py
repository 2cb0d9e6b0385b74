"""Device-time profile of the port's UNet forward and VAE decode on one CUDA
card, on the kernel path (the bf16 models' own route: the conv3x3 and
group_norm_act kernels, channels_last), on the library path
(``ops.kernels.route`` switching those two off: every conv and GroupNorm
the library call, NCHW) and W8A8-quantized
(``serve --quantize int8``, on both paths), via torch.profiler.

    python -m uce_tpu_torch.tools.trace_prof [--model sd14|sd21|sdxl|flux|hidream]
        [--batch 4] [--runs 5]

The model at full width with seeded random weights in bf16 (drawn on the
card), at its image size: SD 1.4 (the default) 64x64 latents, SD 2.1
96x96, SDXL 128x128 with random pooled text and 1024x1024 time ids, and a
random 77-token context; the W8A8 path for SD 1.4 only. For each path and model: 3 warm-up calls, the
median host wall time of 5 unprofiled calls (each ended by a synchronize),
then ``--runs`` profiled calls: device time per call (the sum of the CUDA
kernel, memcpy and memset events), the idle share 1 - device / wall, the
time by category, the top kernels and the group_norm_act kernels by name
(device time and launches per call), and the kernel path's group_norm_act
calls by the schedule its planner picks. Last, each conv3x3 shape of the
kernel path alone (CUDA events, median of 10): calls per forward, the
kernel's time and achieved TFLOP/s beside cuDNN's (channels_last) on the
same inputs, the kernel that ``plan`` picks, its blocks and K splits.

``--model flux`` profiles FLUX.1-schnell instead: one DiT forward at
1024x1024 (the packed 128x128 latents and 256 random T5 tokens, batch
``--batch``, t = 1) with its joint attention on the d=128 kernel and on
the plain version (``route`` switching sd_attention off), and the 16-channel VAE decode at 1024x1024 on the
library and the kernel paths, each reported as above. ``--model hidream``
does the same for HiDream-I1-Full: one MoE DiT forward at 1024x1024 (batch
``--batch``, 2 for one prompt under CFG; 128 random T5 tokens and 48
random 128-token Llama streams, t = 1000) and the same VAE decode.

    python -m uce_tpu_torch.tools.trace_prof --gn [--batch 8]

prints only the group_norm_act table: the kernel's and F.group_norm's
device time per call (torch.profiler, 20 calls each) at each GroupNorm
shape of the UNet and the VAE decode, beside the bytes bound.

    python -m uce_tpu_torch.tools.trace_prof --solve [--runs 5]

profiles the Newton-Schulz chain (``newton_schulz_inverse``) instead, at the
main path's art erase (5 edit, 3 preserve concepts) and at 100 concepts,
d = 768: its launches in order, device time by kernel, and the gaps
between one launch's end and the next one's start.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
import time

import numpy as np
import torch

from uce_tpu_torch.diffusion.pipeline_flux import make_img_ids
from uce_tpu_torch.models import flux, hidream, quantize, unet, vae
from uce_tpu_torch.ops.kernels import conv3x3, group_norm, route, uce_solve
from uce_tpu_torch.utils.torch_rng import DeviceNormalRng

# --model: (UNet config, latent size, context width, pooled text width)
MODELS = {"sd14": (unet.SD14_UNET_CONFIG, 64, 768, None),
          "sd21": (unet.SD21_UNET_CONFIG, 96, 1024, None),
          "sdxl": (unet.SDXL_UNET_CONFIG, 128, 2048, 1280)}

# The two paths: the kernels switched off on each (``route``).
PATHS = (("library", ("conv3x3", "group_norm_act")), ("kernels", ()))

# First matching pattern names a kernel's category.
CATEGORIES = [
    ("sd_attention_qk8 kernel", r"sd_attention_qk8"),
    ("sd_attention kernel", r"sd_attention"),
    ("int8 GEMMs (torch._int_mm)", r"gemm_s8|s8s8|imma"),
    ("conv3x3 kernels", r"conv3x3_(wgmma|mma)_kernel|split_reduce_kernel"),
    ("group_norm_act kernels", r"gn_\w+_kernel"),
    ("cuDNN layout transposes", r"nchwToNhwc|nhwcToNchw"),
    ("convolutions (library)", r"conv|xmma|implicit|fprop|dgrad|winograd"),
    ("GroupNorm (library)", r"GroupNorm|group_norm|RowwiseMoments|ComputeFused"),
    ("GEMMs", r"gemm|cutlass|sm90_|ampere|cublas|nvjet"),
    ("softmax / LayerNorm", r"softmax|LayerNorm|layer_norm"),
    ("copies and casts", r"copy|Copy|cat|Cat|memcpy|Memcpy|memset|Memset"),
    ("elementwise", r"elementwise|vectorized|Elementwise|unrolled"),
]


def category(name: str) -> str:
    for label, pattern in CATEGORIES:
        if re.search(pattern, name):
            return label
    return "other"


def profile(fn, runs: int) -> dict:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - start) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    by_name, count = collections.Counter(), collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += (evt.time_range.end - evt.time_range.start) / 1e3
            count[evt.name] += 1
    device = sum(by_name.values()) / runs
    wall = float(np.median(walls))
    by_cat = collections.Counter()
    for name, ms in by_name.items():
        by_cat[category(name)] += ms / runs
    gn = [(n, ms / runs, count[n] / runs) for n, ms in by_name.most_common()
          if category(n) == "group_norm_act kernels"]
    return {"wall_ms": wall, "device_ms": device, "by_cat": by_cat,
            "top": [(n, ms / runs) for n, ms in by_name.most_common(8)], "gn": gn}


def report(what: str, r: dict) -> None:
    idle = 1.0 - r["device_ms"] / r["wall_ms"] if r["wall_ms"] else float("nan")
    print(f"[{what}] wall {r['wall_ms']:.2f} ms (median of 5, unprofiled), device "
          f"{r['device_ms']:.2f} ms per call, idle share {idle:.3f}")
    if not r["device_ms"]:
        print(f"[{what}] the profiler recorded no device events")
        return
    for label, ms in r["by_cat"].most_common():
        print(f"[{what}]   {label}: {ms:.3f} ms ({ms / r['device_ms']:.1%})")
    for name, ms in r["top"]:
        print(f"[{what}]   top: {ms:.3f} ms {name[:110]}")
    for name, ms, launches in r["gn"]:
        print(f"[{what}]   group_norm_act: {ms:.4f} ms in {launches:g} launches per "
              f"call ({ms / launches * 1e3:.2f} us each) {name[:80]}")


def conv_shapes(fn) -> collections.Counter:
    """(x shape, cout) -> calls of the conv3x3 kernel wrapper in fn()."""
    seen = collections.Counter()
    launch = conv3x3.conv3x3

    def spy(x, w, bias=None):
        seen[(tuple(x.shape), w.shape[0])] += 1
        return launch(x, w, bias)

    conv3x3.conv3x3 = spy
    try:
        fn()
    finally:
        conv3x3.conv3x3 = launch
    return seen


def median_ms(fn) -> float:
    """CUDA events around one call, median of 10 after 2 warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(10):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def conv_table(what: str, seen: collections.Counter) -> None:
    gen = torch.Generator("cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    total_ms = total_lib_ms = total_flops = 0.0
    by_level = collections.defaultdict(lambda: [0.0, 0.0])  # H: flops, ms
    for (shape, cout), calls in sorted(seen.items()):
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        w = torch.randn(cout, 3, 3, shape[3], device="cuda", generator=gen).bfloat16()
        bias = torch.zeros(cout, device="cuda", dtype=torch.bfloat16)
        ms = median_ms(lambda: conv3x3.conv3x3(x, w, bias))
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last memory, as the models
        w_oihw = w.permute(0, 3, 1, 2)
        lib_ms = median_ms(lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, bias,
                                                              padding=1))
        m = shape[0] * shape[1] * shape[2]
        flops = 2.0 * m * cout * 9 * shape[3]
        total_ms += calls * ms
        total_lib_ms += calls * lib_ms
        total_flops += calls * flops
        by_level[shape[1]][0] += calls * flops
        by_level[shape[1]][1] += calls * ms
        p = conv3x3.plan(*shape, cout, sms)
        print(f"[{what}] conv3x3 {shape}->{cout} x{calls}: {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s; cuDNN {lib_ms:.4f} ms, "
              f"{flops / lib_ms / 1e9:.1f} TFLOP/s; {p.variant}, "
              f"{p.m_tiles * p.n_tiles * p.splits} blocks, {p.splits} K splits")
    for level, (flops, ms) in sorted(by_level.items()):
        print(f"[{what}] conv3x3 at {level}x{level}: {flops / 1e9:.1f} GFLOP in "
              f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")
    print(f"[{what}] conv3x3 total {total_ms:.3f} ms for {total_flops / 1e9:.1f} "
          f"GFLOP ({total_flops / total_ms / 1e9:.1f} TFLOP/s); cuDNN "
          f"{total_lib_ms:.3f} ms ({total_flops / total_lib_ms / 1e9:.1f} TFLOP/s)")


def gn_shapes(fn) -> collections.Counter:
    """(x shape, groups, eps, act) -> calls of the group_norm_act wrapper in
    fn() on the kernel path."""
    seen = collections.Counter()
    launch = group_norm.group_norm_act

    def spy(x, scale, bias, groups=32, eps=1e-5, act="none"):
        seen[(tuple(x.shape), groups, eps, act)] += 1
        return launch(x, scale, bias, groups, eps, act)

    group_norm.group_norm_act = spy
    try:
        fn()
    finally:
        group_norm.group_norm_act = launch
    return seen


def gn_table(what: str, seen: collections.Counter, calls: int = 20) -> None:
    """Device time per call of the group_norm_act kernel(s) and of
    F.group_norm + F.silu (channels_last) at each shape in ``seen``, from one
    profiled run of ``calls`` calls of each, beside the bytes bound (one read
    of x, one write of y), weighted by the calls per forward."""
    gen = torch.Generator("cuda").manual_seed(2)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    plan = getattr(group_norm, "plan", None)
    totals = np.zeros(3)
    for (shape, groups, eps, act), n in sorted(seen.items()):
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        scale = torch.randn(shape[3], device="cuda", generator=gen)
        bias = torch.randn(shape[3], device="cuda", generator=gen)
        x_nchw = x.permute(0, 3, 1, 2)
        s16, b16 = scale.bfloat16(), bias.bfloat16()
        kernel = lambda: group_norm.group_norm_act(x, scale, bias, groups, eps, act)
        lib = lambda: (torch.nn.functional.silu if act == "silu" else (lambda t: t))(
            torch.nn.functional.group_norm(x_nchw, groups, s16, b16, eps))
        for fn in (kernel, lib):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                kernel()
            torch.cuda.synchronize()
            for _ in range(calls):
                lib()
            torch.cuda.synchronize()
        ours, theirs, launches = 0.0, 0.0, 0
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = (evt.time_range.end - evt.time_range.start) / calls
            if re.search(r"gn_\w+_kernel", evt.name):
                ours += us
                launches += 1
            else:
                theirs += us
        bound_us = 4.0 * x.numel() / 3.35e12 * 1e6
        totals += n * np.array([ours, theirs, bound_us])
        how = plan(shape, groups) if plan else None
        sched = (f"{how.schedule}, slab {how.slab}, cluster {how.cluster}, "
                 f"{how.blocks} blocks" if how else "three kernels")
        print(f"[{what}] group_norm_act {shape} {act} x{n}: kernel {ours:.2f} us "
              f"device per call ({launches / calls:g} launches), F.group_norm"
              f"{'+F.silu' if act == 'silu' else ''} {theirs:.2f} us, bound "
              f"{bound_us:.2f} us ({sched})")
    print(f"[{what}] group_norm_act per forward: kernel {totals[0] / 1e3:.4f} ms, "
          f"library {totals[1] / 1e3:.4f} ms, bound {totals[2] / 1e3:.4f} ms")


def solve_chain(ke: int, kp: int, d: int, runs: int) -> None:
    """Kernel events of newton_schulz_inverse in launch order: device time
    by kernel (mean over ``runs`` profiled calls), and the medians over the
    calls of the span from the first start to the last end, of the kernel
    time and of the gaps between launches."""
    gen = torch.Generator("cuda").manual_seed(0)
    args = (torch.randn(ke, d, device="cuda", generator=gen),
            torch.randn(kp, d, device="cuda", generator=gen), 1.3, 0.7, 0.5)
    for _ in range(3):
        uce_solve.newton_schulz_inverse(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            uce_solve.newton_schulz_inverse(*args)
            torch.cuda.synchronize()
    evts = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    what = f"solve {(ke, kp, d)}"
    if not evts:
        print(f"[{what}] the profiler recorded no device events")
        return
    per = len(evts) // runs  # every call launches the same chain
    chains = [evts[i * per:(i + 1) * per] for i in range(runs)]
    by_name = collections.Counter()
    spans, busy, gaps, each = [], [], [], []
    for chain in chains:
        for start, end, name in chain:
            short = re.sub(r"\(.*", "", name.split("::")[-1]) or name
            by_name[short] += (end - start) / 1e3 / len(chains)
        spans.append((chain[-1][1] - chain[0][0]) / 1e3)
        busy.append(sum(end - start for start, end, _ in chain) / 1e3)
        g = [b[0] - a[1] for a, b in zip(chain, chain[1:])]
        gaps.append(sum(g) / 1e3)
        each += g
    span, gap = float(np.median(spans)), float(np.median(gaps))
    print(f"[{what}] {len(chains)} chains of {len(chains[0])} device events, medians: "
          f"span {span:.4f} ms, kernels {np.median(busy):.4f} ms, gaps {gap:.4f} ms "
          f"({gap / span:.1%} of the span); a gap {np.median(each):.2f} us (median), "
          f"{np.percentile(each, 99):.2f} us (99th percentile)")
    for name, ms in by_name.most_common():
        print(f"[{what}]   {ms:.4f} ms {name[:100]}")


def dit_profile(model: str, batch: int, runs: int) -> None:
    """FLUX.1-schnell's or HiDream-I1-Full's DiT forward (attention on "auto"
    and "plain") and the 16-channel VAE decode (library and kernel paths)
    at 1024x1024."""
    gen = torch.Generator("cuda").manual_seed(0)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=gen).bfloat16()
    img_ids = make_img_ids(128, 128)
    if model == "flux":
        cfg = flux.SCHNELL_CONFIG
        params = flux.init_state_dict(cfg, seed=0, device="cuda")
        lat, t5_embeds, pooled = rand(batch, 64 * 64, 64), rand(batch, 256, 4096), rand(
            batch, 768)
        t, txt_ids = torch.ones(batch, device="cuda"), np.zeros((256, 3))
        forward = lambda: flux.apply(params, lat, t5_embeds, pooled, t, img_ids, txt_ids,
                                     cfg)
    else:
        cfg = hidream.I1_FULL_CONFIG
        params = hidream.init_state_dict(cfg, seed=0, device="cuda")
        lat, t5_embeds, pooled = rand(batch, 64 * 64, 64), rand(batch, 128, 4096), rand(
            batch, 2048)
        llama = rand(len(cfg.llama_layers), batch, 128, 4096)
        t = torch.full((batch,), 1000.0, device="cuda")
        forward = lambda: hidream.apply(params, lat, t5_embeds, llama, pooled, t, img_ids,
                                        cfg)
    rng = DeviceNormalRng(1, "cuda", torch.bfloat16)
    vparams = unet.load_params(vae.init_state_dict(vae.FLUX_VAE_CONFIG, rng),
                               torch.bfloat16, "cuda")
    dec_lat = rand(1, 16, 128, 128)
    with torch.inference_mode():
        for attn, off in (("kernel", ()), ("plain", ("sd_attention",))):
            with route(off):
                report(f"{model} dit attention {attn} batch {batch}",
                       profile(forward, runs))
        del params
        torch.cuda.empty_cache()
        for path, off in PATHS:
            with route(off):
                report(f"{model} vae {path} batch 1", profile(
                    lambda: vae.decode(vparams, dec_lat, vae.FLUX_VAE_CONFIG), runs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(MODELS) + ["flux", "hidream"], default="sd14")
    ap.add_argument("--batch", type=int, default=4, help="UNet batch (2 x prompts)")
    ap.add_argument("--runs", type=int, default=5, help="profiled calls per model")
    ap.add_argument("--solve", action="store_true",
                    help="profile the Newton-Schulz chain instead")
    ap.add_argument("--gn", action="store_true",
                    help="only the group_norm_act table: each shape of the UNet "
                         "and the VAE against F.group_norm")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_prof: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}; torch {torch.__version__}")
    if args.solve:
        for ke, kp in ((5, 3), (100, 0)):
            solve_chain(ke, kp, 768, args.runs)
        print(f"[card] {card}")
        return 0
    if args.model in ("flux", "hidream"):
        dit_profile(args.model, args.batch, args.runs)
        print(f"[card] {card}")
        return 0
    ucfg, n, width, pooled = MODELS[args.model]
    rng = DeviceNormalRng(0, "cuda", torch.bfloat16)
    uparams = unet.load_params(unet.init_state_dict(ucfg, rng), torch.bfloat16, "cuda")
    vparams = unet.load_params(vae.init_state_dict(vae.SD_VAE_CONFIG, rng),
                               torch.bfloat16, "cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(args.batch, 4, n, n, device="cuda", generator=gen).bfloat16()
    ctx = torch.randn(args.batch, 77, width, device="cuda", generator=gen).bfloat16()
    lat = torch.randn(1, 4, n, n, device="cuda", generator=gen).bfloat16()
    added = None if pooled is None else {
        "text_embeds": torch.randn(args.batch, pooled, device="cuda",
                                   generator=gen).bfloat16(),
        "time_ids": torch.tensor([8.0 * n, 8.0 * n, 0, 0, 8.0 * n, 8.0 * n],
                                 device="cuda").expand(args.batch, 6)}

    def unet_call(params):
        return lambda: unet.apply(params, x, 981.0, ctx, ucfg, added_cond=added)

    params = {"": (uparams, vparams)}
    if args.model == "sd14":  # W8A8 is ported for SD 1.4 only
        params["int8 "] = (quantize.quantize_params(uparams, quantize.UNET_SKIP, "int8"),
                           quantize.quantize_params(vparams, quantize.VAE_SKIP, "int8"))
    with torch.inference_mode():
        if args.gn:
            gn_table(f"unet batch {args.batch}", gn_shapes(
                unet_call(uparams)))
            gn_table("vae batch 1", gn_shapes(
                lambda: vae.decode(vparams, lat, vae.SD_VAE_CONFIG)))
            print(f"[card] {card}")
            return 0
        for weights, (up, vp) in params.items():
            for path, off in PATHS:
                with route(off):
                    report(f"{args.model} unet {weights}{path} batch {args.batch}",
                           profile(unet_call(up), args.runs))
                    report(f"{args.model} vae {weights}{path} batch 1", profile(
                        lambda: vae.decode(vp, lat, vae.SD_VAE_CONFIG), args.runs))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for what, fn in ((f"unet kernels batch {args.batch}", unet_call(uparams)),
                         ("vae kernels batch 1", lambda: vae.decode(
                             vparams, lat, vae.SD_VAE_CONFIG))):
            calls = collections.Counter()
            for (shape, groups, _, _), n in gn_shapes(fn).items():
                calls[group_norm.plan(shape, groups, sms).schedule] += n
            print(f"[{what}] group_norm_act calls per call: {calls['resident']} "
                  f"resident (one launch each), {calls['stream']} streaming (three "
                  "launches each)")
        conv_table(f"unet batch {args.batch}", conv_shapes(
            unet_call(uparams)))
        conv_table("vae batch 1", conv_shapes(
            lambda: vae.decode(vparams, lat, vae.SD_VAE_CONFIG)))
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
