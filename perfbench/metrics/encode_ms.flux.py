"""encode_ms.flux: the median stream time of one call's prompt encode (the
program's ``pipe.encode`` span: T5-XXL and CLIP-L over each image's copy
of the prompt), in ms, on the device's clock, over the window's calls that
the profiler did not see.

One encode a call, and a traced run's window holds about a dozen calls
past the profiled ones, so the median needs 5 encodes, as
``decode_ms.eval`` needs 5 decodes."""

from perfbench.core.spans import median_ms, program_spans

LEAST = 5


def value(spans):
    return median_ms(spans, "pipe.encode", "stream_s", LEAST)


def read(ctx):
    return value(program_spans())
