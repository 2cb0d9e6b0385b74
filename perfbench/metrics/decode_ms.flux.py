"""decode_ms.flux: the median stream time of one call's VAE decode (the
program's ``pipe.decode`` span: the unpack, the scale and shift and two
1024x1024 decodes of the 16-channel VAE), in ms, on the device's clock,
over the window's calls that the profiler did not see:
``decode_ms.eval``'s reader (5 decodes are enough)."""

from perfbench.core.harness import load

_reader = load("metrics", "decode_ms.eval")
value, read = _reader.value, _reader.read
