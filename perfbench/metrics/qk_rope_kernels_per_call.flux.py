"""qk_rope_kernels_per_call.flux: the median, over the window's DiT forwards
that the profiler did not see, of the qk_norm_rope kernel launches of one
forward (the ``qk_norm_rope`` attr of the program's ``pipe.model`` span):
57 when the q/k RMSNorm and RoPE of every one of the 19 double-stream and
38 single-stream blocks take the kernel, fewer when some take the plain
version. A program whose spans lack the attr gives None."""

import statistics

from perfbench.core.spans import MIN_SAMPLES, measured, program_spans


def value(spans):
    counts = [s["qk_norm_rope"] for s in measured(spans)
              if s["name"] == "pipe.model" and "qk_norm_rope" in s]
    return statistics.median(counts) if len(counts) >= MIN_SAMPLES else None


def read(ctx):
    return value(program_spans())
