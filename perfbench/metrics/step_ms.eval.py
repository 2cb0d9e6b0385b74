"""step_ms.eval: the median stream time of one call's guidance combine and
scheduler step (the program's ``pipe.step`` span), in ms, on the device's
clock, over the window's calls that the profiler did not see."""

from perfbench.core.spans import median_ms, program_spans


def value(spans):
    return median_ms(spans, "pipe.step", "stream_s")


def read(ctx):
    return value(program_spans())
