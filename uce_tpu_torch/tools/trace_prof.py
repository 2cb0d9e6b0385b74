"""Device-time profile of the port's SD 1.4 UNet forward and VAE decode on
one CUDA card, on the library path and on the kernel path
(UCE_CONV_IMPL=UCE_GN_IMPL=pallas), via torch.profiler.

    python -m uce_tpu_torch.tools.trace_prof [--batch 4] [--runs 5]

SD 1.4 at full width with seeded random weights in bf16, 64x64 latents and
a random 77-token context. For each path and model: 3 warm-up calls, the
median host wall time of 5 unprofiled calls (each ended by a synchronize),
then ``--runs`` profiled calls: device time per call (the sum of the CUDA
kernel, memcpy and memset events), the idle share 1 - device / wall, the
time by category and the top kernels. Last, each conv3x3 shape of the
kernel path alone (CUDA events, median of 10): calls per forward, time,
achieved TFLOP/s and blocks launched.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from uce_tpu_torch.models import unet, vae
from uce_tpu_torch.models.layers import KERNEL_IMPL, KERNEL_VARS
from uce_tpu_torch.ops.kernels import conv3x3

# First matching pattern names a kernel's category.
CATEGORIES = [
    ("sd_attention kernel", r"sd_attention"),
    ("conv3x3 kernel", r"conv3x3_kernel"),
    ("group_norm_act kernels", r"gn_(partial|fold|apply)_kernel"),
    ("cuDNN layout transposes", r"nchwToNhwc|nhwcToNchw"),
    ("convolutions (library)", r"conv|xmma|implicit|fprop|dgrad|winograd"),
    ("GroupNorm (library)", r"GroupNorm|group_norm|RowwiseMoments|ComputeFused"),
    ("GEMMs", r"gemm|cutlass|sm90_|ampere|cublas"),
    ("softmax / LayerNorm", r"softmax|LayerNorm|layer_norm"),
    ("copies and casts", r"copy|Copy|cat|Cat|memcpy|Memcpy|memset|Memset"),
    ("elementwise", r"elementwise|vectorized|Elementwise|unrolled"),
]


def select_path(kernels: bool) -> None:
    """Set (kernel path) or clear both kernel variables."""
    for k in KERNEL_VARS:
        if kernels:
            os.environ[k] = KERNEL_IMPL
        else:
            os.environ.pop(k, None)


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
    by_name = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += (evt.time_range.end - evt.time_range.start) / 1e3
    device = sum(by_name.values()) / runs
    wall = float(np.median(walls))
    by_cat = collections.Counter()
    for name, ms in by_name.items():
        by_cat[category(name)] += ms / runs
    return {"wall_ms": wall, "device_ms": device, "by_cat": by_cat,
            "top": [(n, ms / runs) for n, ms in by_name.most_common(8)]}


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


def conv_shapes(fn) -> collections.Counter:
    """(x shape, cout) -> calls of the conv3x3 kernel wrapper in fn()."""
    seen = collections.Counter()
    launch = conv3x3.conv3x3

    def spy(x, w, bias=None):
        seen[(tuple(x.shape), w.shape[0])] += 1
        return launch(x, w, bias)

    conv3x3.conv3x3 = spy
    select_path(True)
    try:
        fn()
    finally:
        conv3x3.conv3x3 = launch
    return seen


def conv_table(what: str, seen: collections.Counter) -> None:
    gen = torch.Generator("cuda").manual_seed(1)
    total_ms = total_flops = 0.0
    for (shape, cout), calls in sorted(seen.items()):
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        w = torch.randn(cout, 3, 3, shape[3], device="cuda", generator=gen).bfloat16()
        bias = torch.zeros(cout, device="cuda", dtype=torch.bfloat16)
        for _ in range(2):
            conv3x3.conv3x3(x, w, bias)
        times = []
        for _ in range(10):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            conv3x3.conv3x3(x, w, bias)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = float(np.median(times))
        m = shape[0] * shape[1] * shape[2]
        flops = 2.0 * m * cout * 9 * shape[3]
        total_ms += calls * ms
        total_flops += calls * flops
        blocks = -(-m // 128) * -(-cout // 128)
        print(f"[{what}] conv3x3 {shape}->{cout} x{calls}: {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {blocks} blocks")
    print(f"[{what}] conv3x3 total {total_ms:.3f} ms for {total_flops / 1e9:.1f} "
          f"GFLOP ({total_flops / total_ms / 1e9:.1f} TFLOP/s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4, help="UNet batch (2 x prompts)")
    ap.add_argument("--runs", type=int, default=5, help="profiled calls per model")
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
    rng = np.random.default_rng(0)
    uparams = unet.load_params(unet.init_state_dict(unet.SD14_UNET_CONFIG, rng),
                               torch.bfloat16, "cuda")
    vparams = unet.load_params(vae.init_state_dict(vae.SD_VAE_CONFIG, rng),
                               torch.bfloat16, "cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(args.batch, 4, 64, 64, device="cuda", generator=gen).bfloat16()
    ctx = torch.randn(args.batch, 77, 768, device="cuda", generator=gen).bfloat16()
    lat = torch.randn(1, 4, 64, 64, device="cuda", generator=gen).bfloat16()
    with torch.inference_mode():
        for path in ("library", "kernels"):
            select_path(path == "kernels")
            report(f"unet {path} batch {args.batch}", profile(
                lambda: unet.apply(uparams, x, 981.0, ctx, unet.SD14_UNET_CONFIG),
                args.runs))
            report(f"vae {path} batch 1", profile(
                lambda: vae.decode(vparams, lat, vae.SD_VAE_CONFIG), args.runs))
        conv_table(f"unet batch {args.batch}", conv_shapes(
            lambda: unet.apply(uparams, x, 981.0, ctx, unet.SD14_UNET_CONFIG)))
        conv_table("vae batch 1", conv_shapes(
            lambda: vae.decode(vparams, lat, vae.SD_VAE_CONFIG)))
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
