"""decode_ms.eval: the median stream time of one VAE decode of a call's
images (the program's ``pipe.decode`` span), in ms, on the device's clock,
over the window's calls that the profiler did not see.

One decode a call: a traced run's window holds 8 or 9 calls past the
profiled one (the profiler's start and stop take ~15 s of the 51), so the
median needs 5 decodes where the other readers need 10 samples; the
decodes of one run lie within 2% of each other."""

from perfbench.core.spans import median_ms, program_spans

LEAST = 5


def value(spans):
    return median_ms(spans, "pipe.decode", "stream_s", LEAST)


def read(ctx):
    return value(program_spans())
