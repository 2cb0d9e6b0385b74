"""HiDream-I1-Full at its published widths, on meta tensors (shapes only,
no weights): the DiT's state-dict contract against uce_tpu's, the joint
attention calls that route to the sd_attention kernel at
head dim 128 per DiT forward (chip_smoke.py's expected launches), the
Llama-3.1-8B encoder's hidden-state stack, and the memory arithmetic that
makes ``--staged`` necessary on one 80 GB card."""

import collections

import numpy as np
import pytest
import torch

from tests.test_torch_sdxl_sd21_shapes import _ShapeRng
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.diffusion import pipeline_flux
from uce_tpu_torch.models import clip_text, hidream, llama, t5
from uce_tpu_torch.ops import attention
from uce_tpu_torch.ops.kernels import sd_attention as port_sdk

META = dict(device="meta", dtype=torch.bfloat16)
TEXT_TOKENS = 128  # max_sequence_length of T5 and Llama
CARD_BYTES = 80e9


def _params(shapes):
    return {k: torch.empty(s, **META) for k, s in shapes.items()}


def _dit_attention_calls(size: int, batch: int) -> collections.Counter:
    """(q shape, routed to the kernel) of every attention call of one DiT
    forward at ``size``^2 pixels."""
    cfg = hidream.I1_FULL_CONFIG
    calls = collections.Counter()

    def attn_spy(q, k, v, **kw):
        routed = attention.routes_to_kernel(q.shape, k.shape, torch.bfloat16, "cuda")
        calls[(tuple(q.shape), routed)] += 1
        return torch.empty(q.shape, device="meta", dtype=q.dtype)

    lh = size // 8
    s_img = (lh // 2) ** 2
    n_ll = cfg.num_layers + cfg.num_single_layers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hidream, "dot_product_attention", attn_spy)
        out = hidream.apply(
            _params(hidream.state_dict_shapes(cfg)),
            torch.empty(batch, s_img, 4 * cfg.in_channels, **META),
            torch.empty(batch, TEXT_TOKENS, cfg.caption_channels[0], **META),
            torch.empty(n_ll, batch, TEXT_TOKENS, cfg.caption_channels[1], **META),
            torch.empty(batch, cfg.text_emb_dim, **META), torch.empty(batch, device="meta"),
            pipeline_flux.make_img_ids(lh, lh), cfg)
    assert tuple(out.shape) == (batch, s_img, 4 * cfg.out_channels)
    return calls


def test_dit_state_dict_matches_uce_tpu_at_full_width():
    """Every key and shape of uce_tpu's init_state_dict at HiDream-I1-Full's
    widths (drawn as shapes only): 17.1 B parameters, 34.2 GB in bf16."""
    from uce_tpu.models import hidream as jhd

    cfg = hidream.I1_FULL_CONFIG
    jcfg = jhd.HiDreamConfig.from_hf(cfg.to_hf())
    want = {k: tuple(v.shape) for k, v in jhd.init_state_dict(jcfg, _ShapeRng()).items()}
    shapes = hidream.state_dict_shapes(cfg)
    assert shapes == want
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert 17.09e9 < n < 17.11e9
    assert len([k for k in shapes if k.startswith("caption_projection")]) == 49
    assert shapes["caption_projection.48.linear.weight"] == (2560, 4096)
    assert shapes["double_stream_blocks.0.block.ff_i.experts.3.w2.weight"] == (2560, 6912)


@pytest.mark.parametrize("size,batch,seq", [(1024, 2, 4480), (1024, 1, 4480),
                                            (512, 2, 1408)])
def test_dit_forward_routes_48_calls_to_the_d128_kernel(size, batch, seq):
    """16 double-stream and 32 single-stream blocks: 48 joint attentions per
    forward over the packed image, the T5 and Llama carry and the block's
    own Llama stream (4096 + 128 + 128 + 128 at 1024^2), each long
    mask-free self-attention at head dim 128, so each takes the kernel; at
    CFG batch 2 the pair goes in one launch."""
    calls = _dit_attention_calls(size, batch)
    assert dict(calls) == {((batch, 20, seq, 128), True): 48}
    assert port_sdk.supported_shape((batch, 20, seq, 128), (batch, 20, seq, 128),
                                    torch.bfloat16)


def test_generate_launches_per_image():
    """One image of generate-hidream at 1024^2, 2 steps under CFG: 2 DiT
    forwards at batch 2, 96 d=128 launches."""
    calls = _dit_attention_calls(1024, 2)
    assert 2 * sum(n for (_, routed), n in calls.items() if routed) == 96


def test_llama_encoder_stack_at_full_width(monkeypatch):
    """Llama-3.1-8B at T=128: 33 hidden states of [B, 128, 4096]; its
    attention is plain masked softmax, never the attention entry point."""
    cfg = llama.LLAMA31_8B_CONFIG
    monkeypatch.setattr(port_sdk, "sd_attention",
                        lambda *a, **k: pytest.fail("the Llama reached the kernel"))
    params = llama.convert_hf_state_dict(_params(llama.state_dict_shapes(cfg)), cfg)
    ids = torch.zeros(2, TEXT_TOKENS, dtype=torch.long, device="meta")
    out = llama.encode_tokens(params, ids, torch.ones_like(ids), cfg)
    assert tuple(out.shape) == (33, 2, TEXT_TOKENS, 4096)


def test_staged_load_is_needed_on_one_card():
    """The encoders in fp32 (as uce_tpu loads them) and the DiT in bf16 do
    not fit 80 GB together; each phase of the staged load does."""
    count = lambda shapes: sum(int(np.prod(s)) for s in shapes.values())
    clip_l = dict(clip_text.init_state_dict(clip_text.SD14_TEXT_CONFIG, _ShapeRng()))
    big_g = dict(clip_text.init_state_dict(clip_text.SDXL_TEXT2_CONFIG, _ShapeRng()))
    clips = sum(int(np.prod(v.shape)) for v in (*clip_l.values(), *big_g.values()))
    encoders = 4 * (count(llama.state_dict_shapes(llama.LLAMA31_8B_CONFIG))
                    + count(t5.state_dict_shapes(t5.T5_XXL_CONFIG)) + clips)
    dit = 2 * count(hidream.state_dict_shapes(hidream.I1_FULL_CONFIG))
    assert 52.0e9 < encoders < 52.6e9 and 34.1e9 < dit < 34.3e9
    assert encoders + dit > CARD_BYTES > max(encoders, dit) + 20e9
