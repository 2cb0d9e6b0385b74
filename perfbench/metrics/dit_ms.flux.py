"""dit_ms.flux: the median stream time of one DiT forward at batch 2 (the
program's ``pipe.model`` span in ``FluxPipeline``), in ms, on the device's
clock (CUDA events), over the window's calls that the profiler did not
see: ``unet_ms.eval``'s reader."""

from perfbench.core.harness import load

_reader = load("metrics", "unet_ms.eval")
value, read = _reader.value, _reader.read
