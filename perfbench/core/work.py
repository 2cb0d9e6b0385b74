"""The work of one image, counted on the reference's models run on meta
tensors: matrix-product and convolution FLOP (torch.utils.flop_counter,
2 per multiply-add, elementwise work not counted), and the attention
calls with their shapes. The count reads the same work whatever
implements it.

Peaks: NVIDIA H100 SXM5's published dense bf16 rate and HBM3 bandwidth
(data sheet, 700 W).
"""

from __future__ import annotations

import contextlib
import functools

from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import sd as sd_ref

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def flops_per_image(work) -> float:
    total = 0.0
    for _, fn, times in work:
        with FlopCounterMode(display=False) as counter:
            fn()
        total += counter.get_total_flops() * times
    return total


@contextlib.contextmanager
def recording_attention(calls: list):
    """Record (B, H, Sq, Skv, D) of each call of the reference's attention."""
    plain = sd_ref.attention

    @functools.wraps(plain)
    def spy(q, k, v, scale):
        calls.append((*q.shape[:3], k.shape[2], q.shape[3]))
        return plain(q, k, v, scale)

    sd_ref.attention = spy
    try:
        yield calls
    finally:
        sd_ref.attention = plain


def attention_calls(work) -> list[tuple[tuple, int]]:
    """[(shape, calls per image)] of every attention call of one image."""
    out = []
    for _, fn, times in work:
        with recording_attention([]) as calls:
            fn()
        out += [(c, times) for c in calls]
    return out


