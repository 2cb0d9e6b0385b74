"""unet_dispatch_ms.eval: the median host time of one denoiser call (the
program's ``pipe.model`` span), in ms: the host enqueueing one UNet
forward, over the window's calls that the profiler did not see. Below
``unet_ms.eval`` the card sets the pace; near it, the host does, or waits
for a full launch queue."""

from perfbench.core.spans import median_ms, program_spans


def value(spans):
    return median_ms(spans, "pipe.model", "host_s")


def read(ctx):
    return value(program_spans())
