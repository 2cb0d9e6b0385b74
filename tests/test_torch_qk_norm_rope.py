"""FLUX's per-head q/k RMSNorm + RoPE op (uce_tpu_torch/ops/kernels/
qk_norm_rope.py) on the CPU: its plain version against the composition the
DiT ran before (``_rms`` on each ``_heads`` view, ``torch.cat``,
``apply_rope``) and against uce_tpu's ``_rms``/``apply_rope``, the wrapper's
input checks, the routing, ``flux.apply`` against tests/torch_flux_mirror.py,
the 57 calls of a full-width forward (meta tensors), the launch counter in
the ``pipe.model`` span and the benchmark's reader of it, and HiDream's
forward, which never calls the op. The kernel itself runs on the card only
(tests/test_torch_qk_norm_rope_card.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.diffusion import pipeline_flux
from uce_tpu_torch.models import flux, hidream
from uce_tpu_torch.ops import kernels
from uce_tpu_torch.ops.kernels import qk_norm_rope as qk

DH = 128
AXES = (16, 56, 56)  # FLUX.1's, summing to the head dim
# (batch, heads, T5 rows, image rows as a side of the packed grid, one
# segment): a double-stream block, a single-stream block (the joined
# sequence), a rank's local heads of a wider model (4 of 24)
LAYOUTS = {"double": (2, 3, 3, (3, 4), False), "single": (2, 3, 3, (3, 4), True),
           "local_heads": (1, 4, 5, (2, 4), False)}


def _ids(s_txt, grid):
    return np.concatenate([np.zeros((s_txt, 3)),
                           pipeline_flux.make_img_ids(2 * grid[0], 2 * grid[1])])


def _inputs(layout, dtype, seed=0):
    b, h, s_txt, grid, joined = LAYOUTS[layout]
    s_img = grid[0] * grid[1]
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g)
    segments = []
    for s in ([s_txt + s_img] if joined else [s_txt, s_img]):
        segments.append(((rnd(b, s, h * DH) * 2 + 0.3).to(dtype),
                         (rnd(b, s, h * DH) * 2 - 0.3).to(dtype),
                         (1 + 0.2 * rnd(DH)).to(dtype), (1 + 0.2 * rnd(DH)).to(dtype)))
    cos, sin = flux.rope_freqs(_ids(s_txt, grid), AXES)
    return segments, cos, sin


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_version_is_the_blocks_composition(layout, dtype):
    """Bit for bit what the DiT blocks computed before the op: ``_rms`` on
    each segment's ``_heads`` view, the segments joined along S (text
    first), then ``apply_rope`` on q and k."""
    segments, cos, sin = _inputs(layout, dtype)
    got_q, got_k = qk.qk_norm_rope_reference(segments, cos, sin)
    for i, got in ((0, got_q), (1, got_k)):
        parts = [flux._rms(flux._heads(seg[i], DH), seg[2 + i]) for seg in segments]
        want = flux.apply_rope(torch.cat(parts, dim=2), cos, sin)
        assert got.dtype == dtype
        assert torch.equal(got, want)
    b, h = segments[0][0].shape[0], segments[0][0].shape[2] // DH
    assert got_q.shape == (b, h, cos.shape[0], DH)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_version_matches_uce_tpu(layout):
    """uce_tpu's ``_rms`` per segment, concatenation and ``apply_rope``, in
    fp32, within the module tolerance of test_torch_flux_model.py."""
    import jax.numpy as jnp

    from uce_tpu.models import flux as jflux

    b, h, s_txt, grid, _ = LAYOUTS[layout]
    segments, cos, sin = _inputs(layout, torch.float32, seed=1)
    jcos, jsin = jflux.rope_freqs(_ids(s_txt, grid), AXES)
    got = qk.qk_norm_rope_reference(segments, cos, sin)
    for i in (0, 1):
        parts = [jflux._rms(jflux._heads(jnp.asarray(seg[i].numpy()), h),
                            jnp.asarray(seg[2 + i].numpy())) for seg in segments]
        want = jflux.apply_rope(jnp.concatenate(parts, axis=2), jcos, jsin)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def _bad(case):
    segments, cos, sin = _inputs("double", torch.bfloat16)
    (q0, k0, qs0, ks0), (q1, k1, qs1, ks1) = segments
    head_dim = DH
    if case == "fp32 source":
        q1 = q1.float()
    elif case == "fp32 scale":
        ks0 = ks0.float()
    elif case == "head dim":
        head_dim = 64
    elif case == "width":
        q1, k1 = q1[..., :DH + 8].contiguous(), k1[..., :DH + 8].contiguous()
    elif case == "q and k rows":
        k1 = k1[:, :-1].contiguous()
    elif case == "batch":
        q0, k0 = q0[:1].contiguous(), k0[:1].contiguous()
    elif case == "non-contiguous source":
        q1 = q1.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "table rows":
        cos = cos[:-1].contiguous()
    elif case == "three segments":
        return [segments[0]] * 3, cos, sin, head_dim
    return [(q0, k0, qs0, ks0), (q1, k1, qs1, ks1)], cos, sin, head_dim


@pytest.mark.parametrize("case", ["fp32 source", "fp32 scale", "head dim", "width",
                                  "q and k rows", "batch", "non-contiguous source",
                                  "table rows", "three segments"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    segments, cos, sin, head_dim = _bad(case)
    with pytest.raises(ValueError, match="qk_norm_rope"):
        qk.qk_norm_rope(segments, cos, sin, head_dim)


def test_wrapper_on_a_cpu_tensor_runs_the_plain_version():
    segments, cos, sin = _inputs("double", torch.bfloat16)
    before = kernels.launches()
    got = qk.qk_norm_rope(segments, cos, sin)
    want = qk.qk_norm_rope_reference(segments, cos, sin)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.launches() == before


@pytest.mark.parametrize("dtype,device,head_dim,kernel", [
    (torch.bfloat16, "cuda", 128, True), (torch.float32, "cuda", 128, False),
    (torch.float16, "cuda", 128, False), (torch.bfloat16, "cpu", 128, False),
    (torch.bfloat16, "meta", 128, False), (torch.bfloat16, "cuda", 64, False)])
def test_routing(dtype, device, head_dim, kernel):
    """bf16 activations on the card at head dim 128 take the kernel; fp32
    activations and CPU tensors the plain version, as does every call while
    ``ops.kernels.route`` switches the kernel off."""
    assert qk.routes_to_kernel(dtype, device, head_dim) is kernel
    with kernels.route(("qk_norm_rope",)):
        assert not qk.routes_to_kernel(dtype, device, head_dim)
    with kernels.route(("sd_attention", "conv3x3", "group_norm_act")):
        assert qk.routes_to_kernel(dtype, device, head_dim) is kernel


def _dit(dh, heads=2, axes=AXES, **kw):
    return flux.FluxConfig(in_channels=16, num_layers=1, num_single_layers=2,
                           attention_head_dim=dh, num_attention_heads=heads,
                           joint_attention_dim=16, pooled_projection_dim=24,
                           axes_dims_rope=axes, **kw)


def _numpy_state_dict(cfg, seed):
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in flux.state_dict_shapes(cfg).items():
        if len(shape) == 1 and key.endswith(".weight"):  # the q/k norm scales
            sd[key] = (1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        else:  # N(0, 1/fan_in) weights, N(0, 0.01) biases
            std = shape[1] ** -0.5 if len(shape) == 2 else 0.1
            sd[key] = (std * rng.standard_normal(shape)).astype(np.float32)
    return sd


def _forward_inputs(cfg, seed, s_txt=5, grid=(3, 4)):
    rng = np.random.default_rng(seed)
    b, s_img = 2, grid[0] * grid[1]
    return (rng.standard_normal((b, s_img, cfg.in_channels)).astype(np.float32),
            rng.standard_normal((b, s_txt, cfg.joint_attention_dim)).astype(np.float32),
            rng.standard_normal((b, cfg.pooled_projection_dim)).astype(np.float32),
            np.array([0.7, 0.3], np.float32),
            pipeline_flux.make_img_ids(2 * grid[0], 2 * grid[1]), np.zeros((s_txt, 3)))


@pytest.mark.parametrize("cfg", [_dit(8, 4, (4, 2, 2)), _dit(DH),
                                 _dit(DH, guidance_embeds=True)],
                         ids=["d8", "d128", "d128_guidance"])
def test_flux_apply_matches_the_mirror(cfg):
    """The port's DiT, its q/k through the op's plain version, against the
    independent eager mirror on the same weights (fp32, the whole-network
    tolerance of test_flux_model.py)."""
    from tests import torch_flux_mirror as mirror

    sd = _numpy_state_dict(cfg, 7)
    lat, t5e, pooled, t, img_ids, txt_ids = _forward_inputs(cfg, 8)
    g = np.array([3.5, 2.0], np.float32) if cfg.guidance_embeds else None
    tg = None if g is None else torch.as_tensor(g)
    got = flux.apply({k: torch.as_tensor(v) for k, v in sd.items()}, torch.as_tensor(lat),
                     torch.as_tensor(t5e), torch.as_tensor(pooled), torch.as_tensor(t),
                     img_ids, txt_ids, cfg, guidance=tg)
    want = mirror.flux_forward(sd, torch.as_tensor(lat), torch.as_tensor(t5e),
                               torch.as_tensor(pooled), torch.as_tensor(t), img_ids,
                               txt_ids, cfg, guidance=tg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4, atol=3e-4)


def _counting(monkeypatch, name, calls):
    fn = getattr(qk, name)

    def spy(segments, cos, sin, head_dim=DH, eps=qk.EPS):
        calls.append((name, [tuple(seg[0].shape) for seg in segments]))
        return fn(segments, cos, sin, head_dim, eps)
    monkeypatch.setattr(qk, name, spy)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_flux_apply_calls_the_op_once_a_block(monkeypatch, dtype):
    """One call a block: the double block's with its text and image
    segments, each single block's with the joined sequence; on the CPU the
    plain version, and through the kernel's wrapper (here running its plain
    version) where the route says so, with the same result bit for bit."""
    cfg = _dit(DH)
    params = {k: torch.as_tensor(v).to(dtype) for k, v in _numpy_state_dict(cfg, 3).items()}
    lat, t5e, pooled, t, img_ids, txt_ids = _forward_inputs(cfg, 4)
    args = (params, torch.as_tensor(lat).to(dtype), torch.as_tensor(t5e).to(dtype),
            torch.as_tensor(pooled).to(dtype), torch.as_tensor(t), img_ids, txt_ids, cfg)
    calls = []
    for name in ("qk_norm_rope", "qk_norm_rope_reference"):
        _counting(monkeypatch, name, calls)
    plain = flux.apply(*args)
    width = cfg.inner_dim
    assert calls == [("qk_norm_rope_reference", [(2, 5, width), (2, 12, width)])] + [
        ("qk_norm_rope_reference", [(2, 17, width)])] * 2
    if dtype == torch.bfloat16:
        calls.clear()
        monkeypatch.setattr(qk, "routes_to_kernel", lambda *a: True)
        routed = flux.apply(*args)
        assert [c[0] for c in calls] == ["qk_norm_rope", "qk_norm_rope_reference"] * 3
        assert torch.equal(routed, plain)


def test_full_width_forward_makes_57_calls(monkeypatch):
    """FLUX.1-schnell at 1024^2 and batch 2 on meta tensors: 19 calls with
    the 256 T5 rows and the 4096 image rows, 38 with the joined 4352, every
    one at a shape the kernel takes in bf16 on the card; the attention gets
    q and k [2, 24, 4352, 128]."""
    cfg = flux.SCHNELL_CONFIG
    meta = dict(device="meta", dtype=torch.bfloat16)
    segs, attn = [], []

    def spy(segments, cos, sin, head_dim=DH, eps=qk.EPS):
        segs.append(tuple(tuple(s[0].shape) for s in segments))
        assert qk.routes_to_kernel(segments[0][0].dtype, "cuda", head_dim)
        b, _, width = segments[0][0].shape
        out = torch.empty(b, width // head_dim, cos.shape[0], head_dim, **meta)
        return out, out

    def attn_spy(q, k, v, **kw):
        attn.append((tuple(q.shape), tuple(k.shape)))
        return torch.empty(q.shape, **meta)
    monkeypatch.setattr(qk, "qk_norm_rope_reference", spy)
    monkeypatch.setattr(flux, "dot_product_attention", attn_spy)
    params = {k: torch.empty(s, **meta) for k, s in flux.state_dict_shapes(cfg).items()}
    flux.apply(params, torch.empty(2, 4096, cfg.in_channels, **meta),
               torch.empty(2, 256, cfg.joint_attention_dim, **meta),
               torch.empty(2, cfg.pooled_projection_dim, **meta),
               torch.empty(2, device="meta"), pipeline_flux.make_img_ids(128, 128),
               np.zeros((256, 3)), cfg)
    assert segs == [((2, 256, 3072), (2, 4096, 3072))] * 19 + [((2, 4352, 3072),)] * 38
    assert attn == [((2, 24, 4352, 128),) * 2] * 57


def test_model_span_carries_the_launches():
    """``pipe.model``'s attrs count the op's kernel launches inside it."""
    from uce_tpu_torch.diffusion.sampler import model_span
    from uce_tpu_torch.utils import observability

    assert "qk_norm_rope" in kernels.KERNELS
    with model_span(torch.device("cpu"), 0):
        kernels.count("qk_norm_rope", n=57)
    span = observability.spans()[-1]
    assert span["name"] == "pipe.model" and span["qk_norm_rope"] == 57
    assert span["sd_attention"] == 0


def _spans(n_calls, per_call=57, attr=True):
    """A warm-up call, a profiled one, then the rest, 4 DiT forwards each."""
    out = []
    for c in range(n_calls):
        call_id = len(out) + 1
        out.append({"name": "pipe.call", "id": call_id, "parent": None,
                    "start_ns": c * 10**9, "profiled": c == 1, "warmup": c == 0})
        for i in range(4):
            span = {"name": "pipe.model", "id": len(out) + 1, "parent": call_id,
                    "start_ns": c * 10**9 + i, "profiled": c == 1, "call": i}
            if attr:
                span["qk_norm_rope"] = per_call
            out.append(span)
    return out


def test_benchmark_reader():
    """``qk_rope_kernels_per_call.flux`` reads the median attr of the
    measured DiT forwards; None without 10 of them or without the attr (a
    program that does not count the kernel)."""
    from perfbench.core import harness

    read = harness.load("metrics", "qk_rope_kernels_per_call.flux").value
    assert read(_spans(6)) == 57
    assert read(_spans(6, per_call=19)) == 19
    assert read(_spans(4)) is None  # 8 measured forwards
    assert read(_spans(6, attr=False)) is None


def test_hidream_never_calls_the_op(monkeypatch):
    """HiDream's q/k norm runs over the whole width before the heads split:
    its forward makes no call of either version."""
    from tests.test_torch_hidream_model import TINY as HD_TINY

    fail = lambda *a, **k: pytest.fail("HiDream called qk_norm_rope")
    monkeypatch.setattr(qk, "qk_norm_rope", fail)
    monkeypatch.setattr(qk, "qk_norm_rope_reference", fail)
    cfg = hidream.HiDreamConfig(**HD_TINY)
    sd = hidream.init_state_dict(cfg, seed=0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    lat_side = 4
    s_img = (lat_side // cfg.patch_size) ** 2
    rnd = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    out = hidream.apply(sd, rnd(2, s_img, cfg.in_channels * cfg.patch_size ** 2),
                        rnd(2, 3, cfg.caption_channels[0]),
                        rnd(len(cfg.llama_layers), 2, 3, cfg.caption_channels[1]),
                        rnd(2, cfg.text_emb_dim), torch.tensor([500.0, 200.0]),
                        pipeline_flux.make_img_ids(lat_side, lat_side), cfg)
    assert torch.isfinite(out).all()

