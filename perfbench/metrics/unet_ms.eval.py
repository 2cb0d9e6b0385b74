"""unet_ms.eval: the median stream time of one denoiser call (the
program's ``pipe.model`` span: the UNet forward over the guidance
branches), in ms, on the device's clock (CUDA events), over the window's
calls that the profiler did not see."""

from perfbench.core.spans import median_ms, program_spans


def value(spans):
    return median_ms(spans, "pipe.model", "stream_s")


def read(ctx):
    return value(program_spans())
