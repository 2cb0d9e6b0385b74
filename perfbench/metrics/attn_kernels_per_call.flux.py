"""attn_kernels_per_call.flux: the median, over the window's DiT forwards
that the profiler did not see, of the bf16 sd_attention kernel launches of
one forward (the ``sd_attention`` attr of the program's ``pipe.model``
span): 57 when every joint attention of the 19 double-stream and 38
single-stream blocks takes the kernel, fewer when some fall back. A
program whose spans lack the attr gives None."""

import statistics

from perfbench.core.spans import MIN_SAMPLES, measured, program_spans


def value(spans):
    counts = [s["sd_attention"] for s in measured(spans)
              if s["name"] == "pipe.model" and "sd_attention" in s]
    return statistics.median(counts) if len(counts) >= MIN_SAMPLES else None


def read(ctx):
    return value(program_spans())
