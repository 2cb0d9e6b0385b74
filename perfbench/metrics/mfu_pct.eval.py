"""mfu_pct.eval: the model FLOP of the images the traced calls completed,
over the traced window, as a share of the H100's dense bf16 peak, in %.

FLOP per image: every model call of one image (text encoders, each
guided denoiser call, the VAE decode) counted on the reference's models on
meta tensors by ``torch.utils.flop_counter`` (matrix products and
convolutions, 2 per multiply-add). The count is of the model, so it does
not change with the kernels that compute it."""

from perfbench.core.work import PEAK_FLOPS, flops_per_image


def read(ctx):
    trace, rec = ctx["trace"], ctx["record"]
    if not trace or not trace["device"] or not rec.get("traced_images"):
        return None
    flops = flops_per_image(ctx["work"]) * rec["traced_images"]
    return 100.0 * flops / trace["window_s"] / PEAK_FLOPS
