"""conv_gn_kernels_per_call.eval: the median, over the window's denoiser
calls that the profiler did not see, of the conv3x3 and group_norm_act
kernel launches of one call (the ``conv3x3`` and ``group_norm_act`` attrs
of the program's ``pipe.model`` span): how many of the UNet's convs and
GroupNorms take the hand-written kernels. A program whose spans lack the
attrs gives None."""

import statistics

from perfbench.core.spans import MIN_SAMPLES, measured, program_spans


def value(spans):
    counts = [s["conv3x3"] + s["group_norm_act"] for s in measured(spans)
              if s["name"] == "pipe.model" and "conv3x3" in s and "group_norm_act" in s]
    return statistics.median(counts) if len(counts) >= MIN_SAMPLES else None


def read(ctx):
    return value(program_spans())
