"""attn_roofline_pct.flux: the least time the H100 could take for the
traced images' long self-attention (each DiT forward's 57 joint
attentions over 256 text and 4,096 image positions at d=128, and the VAE
mid block's at 16,384 positions and d=512), over the device time of the
attention kernels in the trace, in %: ``attn_roofline_pct.eval``'s
formula and kernels, read here from the FLUX reference's work."""

from perfbench.core.harness import load

read = load("metrics", "attn_roofline_pct.eval").read
