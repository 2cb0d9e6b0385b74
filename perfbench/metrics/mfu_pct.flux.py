"""mfu_pct.flux: the model FLOP of the images the traced calls completed,
over the traced window, as a share of the H100's dense bf16 peak, in %:
``mfu_pct.eval``'s formula, with the FLOP of one image counted on the FLUX
reference's models on meta tensors (4 DiT forwards, one VAE decode, one
T5 and one CLIP encode)."""

from perfbench.core.harness import load

read = load("metrics", "mfu_pct.eval").read
