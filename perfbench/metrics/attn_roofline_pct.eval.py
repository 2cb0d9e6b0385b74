"""attn_roofline_pct.eval: the least time the H100 could take for the
traced window's long self-attention, over the device time of the
attention kernels in the trace, in %.

Counted attention: each call of the reference's attention in one image's
work (on meta tensors) that is self-attention at 1,024 queries or more,
the calls the port sends to its kernels: the UNet's at 64x64 and 32x32
latents and the VAE's mid block. Per call, FLOP are
4 B H Sq Skv D (Q K^T and P V) and bytes are Q, K, V and O once in bf16,
2 B H D (2 Sq + 2 Skv); the least time is the larger of FLOP over the
bf16 peak and bytes over the memory bandwidth. Attention kernels: the
port's ``sd_attention*`` kernels and the d=512 split merge, and a
library's fused attention (flash, fmha, efficient attention)."""

from perfbench.core.trace import device_seconds
from perfbench.core.work import PEAK_BYTES, PEAK_FLOPS, attention_calls

KERNELS = (r"sd_attention", r"\bmerge_kernel\b", r"flash", r"fmha", r"efficient_attention")
MIN_QUERIES = 1024


def least_seconds(shape) -> float:
    b, h, sq, skv, d = shape
    flops = 4.0 * b * h * sq * skv * d
    nbytes = 2.0 * b * h * d * (2 * sq + 2 * skv)
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def read(ctx):
    trace, images = ctx["trace"], ctx["record"].get("traced_images")
    if not trace or not images:
        return None
    seconds = device_seconds(trace, KERNELS)
    if seconds <= 0:
        return None
    per_image = sum(least_seconds(s) * n for s, n in attention_calls(ctx["work"])
                    if s[2] == s[3] and s[2] >= MIN_QUERIES)
    return 100.0 * per_image * images / seconds
