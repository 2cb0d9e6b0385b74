"""The port's fast mode (uce_tpu_torch/diffusion/sampler.py FastConfig and
``denoise(fast=)``, DeepCache in models/unet.py, SDPipeline(fast=)) against
uce_tpu's on the same seeded inputs and weights (fp32; the tolerances of
tests/test_torch_unet_vae.py for the UNet, 1e-4 for whole denoising runs,
1 uint8 level for images), and its exactness claims within the port: a
no-op config and a full-window config reproduce ``denoise`` without a
FastConfig bit for bit,
and a same-step deep feature fed back reproduces the full forward."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.diffusion import sampler as jsampler, schedulers as jsched
from uce_tpu.models import unet as junet
from uce_tpu_torch.diffusion import sampler, schedulers
from uce_tpu_torch.diffusion.sampler import FastConfig
from uce_tpu_torch.models import unet as tunet
from uce_tpu_torch.models.convert import nested_to_state_dict

TINY3 = dict(block_out_channels=(8, 16, 16),
             down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                               "DownBlock2D"),
             up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
             layers_per_block=1, cross_attention_dim=32, attention_head_dim=2,
             norm_num_groups=4)
# SD 1.4's four-level topology at 1/40 width: cache levels 1, 2 and 3
TINY4 = dict(block_out_channels=(8, 16, 32, 32), layers_per_block=2,
             cross_attention_dim=32, attention_head_dim=2, norm_num_groups=4)
# SDXL's three-level text_time topology
TINY_XL = dict(block_out_channels=(8, 16, 16),
               down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                                 "CrossAttnDownBlock2D"),
               up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
               layers_per_block=1, cross_attention_dim=32, attention_head_dim=2,
               transformer_layers_per_block=(1, 1, 2), use_linear_projection=True,
               norm_num_groups=4, addition_embed_type="text_time",
               addition_time_embed_dim=2, projection_class_embeddings_input_dim=20)
UNET_TOL = dict(rtol=2e-4, atol=2e-4)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _models(cfg_kw, seed=0):
    jcfg, tcfg = junet.UNetConfig(**cfg_kw), tunet.UNetConfig(**cfg_kw)
    jparams = junet.nest_state_dict(
        junet.init_state_dict(jcfg, np.random.default_rng(seed), scale=0.1))
    return jcfg, tcfg, jparams, nested_to_state_dict(jparams)


def _jit_unet(jcfg, **static):
    """uce_tpu's UNet forward, jitted with the config and the static keywords
    (cache level, return_deep) closed over."""
    return jax.jit(lambda p, x, t, c, **kw: junet.apply(p, x, t, c, jcfg, **static, **kw))


def _added_cond(rng, batch):
    return {"text_embeds": rng.standard_normal((batch, 8)).astype(np.float32),
            "time_ids": np.tile(np.float32([32, 32, 0, 0, 32, 32]), (batch, 1))}


# ------------------------------------------------------------ FastConfig
SPECS = ["", "cache=2", "cfg_interval=5:40", "cfg_interval=3:25,cache=2",
         "cfg_interval=5:40,cache=3,level=2", " cache = 4 , level=1 ,",
         "cfg_interval=0:0,cache=2", "cfg_interval=60:80", "cfg_interval=0:51",
         "bogus=1", "cfg_interval=5", "cfg_interval=:4", "cache=0", "level=0",
         "cfg_interval=4:2", "cfg_interval=-1:5", "cache=x"]


@pytest.mark.parametrize("spec", SPECS)
def test_fastconfig_matches_uce_tpu(spec):
    """from_spec's result or error text, is_noop, and segments at several
    call counts, against uce_tpu's FastConfig."""
    try:
        want = jsampler.FastConfig.from_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            FastConfig.from_spec(spec)
        assert str(got.value) == str(e)
        return
    got = FastConfig.from_spec(spec)
    assert (got.cfg_interval, got.cache_interval, got.cache_level) == (
        want.cfg_interval, want.cache_interval, want.cache_level)
    assert got.is_noop == want.is_noop
    for total in (0, 1, 6, 20, 50, 51):
        assert got.segments(total) == want.segments(total), total


@pytest.mark.parametrize("kw", [dict(cache_interval=0), dict(cache_level=0),
                                dict(cache_level=-1), dict(cfg_interval=(3, 1)),
                                dict(cfg_interval=(-1, 5))])
def test_fastconfig_validation_matches_uce_tpu(kw):
    with pytest.raises(ValueError) as want:
        jsampler.FastConfig(**kw)
    with pytest.raises(ValueError) as got:
        FastConfig(**kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- UNet DeepCache
@pytest.mark.parametrize("topology,cache_level", [("tiny3", 1), ("tiny3", 2),
                                                  ("xl", 2)])
def test_deepcache_apply_matches_uce_tpu(topology, cache_level):
    """return_deep's (eps, deep) and the shallow path on a deep feature
    against uce_tpu, and deep_feature_shape (NCHW here, NHWC there)."""
    cfg_kw = {"tiny3": TINY3, "tiny4": TINY4, "xl": TINY_XL}[topology]
    jcfg, tcfg, jparams, tparams = _models(cfg_kw, seed=3)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = (rng.standard_normal((2, 7, 32)) * 0.5).astype(np.float32)
    t = np.array([123.0, 801.0], np.float32)
    ac = _added_cond(rng, 2) if topology == "xl" else None
    jac = None if ac is None else {k: jnp.asarray(v) for k, v in ac.items()}
    tac = None if ac is None else {k: torch.from_numpy(v) for k, v in ac.items()}
    j_eps, j_deep = _jit_unet(jcfg, return_deep=True, cache_level=cache_level)(
        jparams, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), added_cond=jac)
    t_eps, t_deep = tunet.apply(tparams, _nchw(x), torch.from_numpy(t),
                                torch.from_numpy(ctx), tcfg, added_cond=tac,
                                return_deep=True, cache_level=cache_level)
    np.testing.assert_allclose(_nhwc(t_eps), np.asarray(j_eps), **UNET_TOL)
    np.testing.assert_allclose(_nhwc(t_deep), np.asarray(j_deep), **UNET_TOL)
    shape = tunet.deep_feature_shape(tcfg, 2, 8, 8, cache_level)
    jshape = junet.deep_feature_shape(jcfg, 2, 8, 8, cache_level)
    assert tuple(t_deep.shape) == shape == (jshape[0], jshape[3], jshape[1], jshape[2])
    # the shallow path on another deep feature (the same for both)
    deep = (rng.standard_normal(jshape) * 0.5).astype(np.float32)
    want = _jit_unet(jcfg, cache_level=cache_level)(
        jparams, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), added_cond=jac,
        deep_feature=jnp.asarray(deep))
    got = tunet.apply(tparams, _nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                      tcfg, added_cond=tac, deep_feature=_nchw(deep),
                      cache_level=cache_level)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **UNET_TOL)


@pytest.mark.parametrize("topology,cache_level", [("tiny3", 2), ("tiny4", 3),
                                                  ("xl", 1)])
def test_same_step_deep_feedback_reproduces_full(topology, cache_level):
    """Within the port: the full forward, return_deep's eps and the shallow
    path fed the same step's deep feature are bitwise equal; a wrong deep
    feature is not."""
    cfg_kw = {"tiny3": TINY3, "tiny4": TINY4, "xl": TINY_XL}[topology]
    _, tcfg, _, tparams = _models(cfg_kw, seed=1)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    ctx = torch.from_numpy((rng.standard_normal((2, 7, 32)) * 0.5).astype(np.float32))
    ac = ({k: torch.from_numpy(v) for k, v in _added_cond(rng, 2).items()}
          if topology == "xl" else None)
    run = lambda **kw: tunet.apply(tparams, x, 17.0, ctx, tcfg, added_cond=ac,
                                   cache_level=cache_level, **kw)
    full = run()
    eps, deep = run(return_deep=True)
    assert torch.equal(full, eps)
    assert torch.equal(full, run(deep_feature=deep))
    assert (full - run(deep_feature=deep * 1.5)).abs().max() > 1e-6


def test_cache_level_bounds_raise():
    _, tcfg, _, tparams = _models(TINY3)
    x, ctx = torch.zeros(1, 4, 16, 16), torch.zeros(1, 7, 32)
    with pytest.raises(ValueError, match=r"cache_level must be in \[1, 2\]"):
        tunet.apply(tparams, x, 1.0, ctx, tcfg, return_deep=True, cache_level=3)
    with pytest.raises(ValueError, match="exclusive"):
        tunet.apply(tparams, x, 1.0, ctx, tcfg, return_deep=True,
                    deep_feature=torch.zeros(1, 16, 16, 16))


# ------------------------------------------------------ denoise(fast=)
def _denoise_inputs(steps, kind, batch=2, hw=8, seed=3):
    jcfg, tcfg, jparams, tparams = _models(TINY3, seed=seed)
    rng = np.random.default_rng(seed + 1)
    lat = rng.standard_normal((batch, hw, hw, 4)).astype(np.float32)
    ctx = (rng.standard_normal((2 * batch, 8, 32)) * 0.5).astype(np.float32)
    jplan = {"ddim": jsched.ddim_plan, "pndm": jsched.pndm_plan}[kind](steps)
    tplan = {"ddim": schedulers.ddim_plan, "pndm": schedulers.pndm_plan}[kind](steps)
    return (jcfg, tcfg, jparams, tparams, lat, ctx, jplan, tplan, batch)


def _torch_model(tparams, tcfg, ctx, batch, fast, calls=None):
    """denoise's model over the port's UNet; ``calls`` records (cond_only,
    cached, want_deep, the deep feature taken or returned)."""
    def model(li, t, cond_only, deep=None, want_deep=False):
        c = ctx[batch:] if cond_only else ctx
        out = tunet.apply(tparams, li, t, c, tcfg, deep_feature=deep,
                          return_deep=want_deep, cache_level=fast.cache_level)
        if calls is not None:
            calls.append((cond_only, deep is not None, want_deep,
                          out[1] if want_deep else deep))
        return out
    return model


def _cfg(dtype):
    """CFG at 7.5, the eps rounded to the latents' ``dtype`` (as the SD
    pipeline's guidance rounds it)."""
    return lambda e: sampler.cfg_combine(e.float(), 7.5).to(dtype)


@pytest.mark.parametrize("fast,kind", [
    (FastConfig(cache_interval=3, cache_level=2), "ddim"),
    (FastConfig(cfg_interval=(1, 3), cache_interval=2), "ddim"),
    (FastConfig(cfg_interval=(1, 4)), "pndm")], ids=str)
def test_denoise_fast_matches_uce_tpu(fast, kind):
    """Four scheduler steps (PNDM: five calls): DeepCache alone, inside a
    CFG window (cond-only calls before and after it, the cache crossing the
    guided -> cond boundary), and a window alone, within 1e-4 of uce_tpu's
    denoise_fast on the same weights."""
    (jcfg, tcfg, jparams, tparams, lat, ctx, jplan, tplan,
     batch) = _denoise_inputs(4, kind)
    jctx = jnp.asarray(ctx)
    jfast = jsampler.FastConfig(cfg_interval=fast.cfg_interval,
                                cache_interval=fast.cache_interval,
                                cache_level=fast.cache_level)

    @functools.cache
    def forward(want_deep):
        return _jit_unet(jcfg, return_deep=want_deep, cache_level=fast.cache_level)

    def jfactory(cond_only, cached, want_deep):
        c = jctx[batch:] if cond_only else jctx
        if cached:
            return lambda li, t, d: forward(False)(jparams, li, t, c, deep_feature=d)
        return lambda li, t: forward(want_deep)(jparams, li, t, c)

    want = np.asarray(jsampler.denoise_fast(jfactory, jplan, jnp.asarray(lat),
                                            guidance_scale=7.5, fast=jfast))
    got = sampler.denoise(tplan, _nchw(lat),
                          _torch_model(tparams, tcfg, torch.from_numpy(ctx), batch, fast),
                          num_branches=2, guidance=_cfg(torch.float32), fast=fast)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fast,kind,dtype", [
    (FastConfig(), "pndm", torch.float32),
    (FastConfig(cfg_interval=(0, 4)), "pndm", torch.bfloat16),
    (FastConfig(cfg_interval=(0, 99), cache_interval=1), "ddim", torch.bfloat16)],
    ids=str)
def test_noop_and_full_window_are_bitwise_denoise(fast, kind, dtype):
    """A no-op config and a CFG window spanning every call (cache 1) run
    denoise's arithmetic cast for cast: bitwise equal latents, fp32 and
    bf16 (three steps; PNDM's four calls)."""
    _, tcfg, _, tparams, lat, ctx, _, tplan, batch = _denoise_inputs(3, kind, batch=1)
    params = {k: v.to(dtype) for k, v in tparams.items()}
    c = torch.from_numpy(ctx).to(dtype)
    x = _nchw(lat).to(dtype)
    exact = sampler.denoise(
        tplan, x, lambda li, t, cond_only: tunet.apply(params, li, t, c, tcfg),
        num_branches=2, guidance=_cfg(dtype))
    got = sampler.denoise(tplan, x, _torch_model(params, tcfg, c, batch, fast),
                          num_branches=2, guidance=_cfg(dtype), fast=fast)
    assert got.dtype == exact.dtype == dtype
    assert torch.equal(got, exact)


def test_boundary_keeps_cond_half_and_forces_full_steps():
    """cfg_interval=(1,3), cache 2, six DDIM calls: segments (0,1) cond,
    (1,3) guided, (3,6) cond. Call 1 enters the guided segment with no
    valid cache and runs in full although 1 % 2 != 0; call 3 crosses the
    guided -> cond boundary onto the cond half of call 2's deep feature."""
    fast = FastConfig(cfg_interval=(1, 3), cache_interval=2)
    _, tcfg, _, tparams, lat, ctx, _, tplan, batch = _denoise_inputs(6, "ddim")
    calls = []
    sampler.denoise(tplan, _nchw(lat),
                    _torch_model(tparams, tcfg, torch.from_numpy(ctx), batch, fast, calls),
                    num_branches=2, guidance=_cfg(torch.float32), fast=fast)
    kinds = [(cond_only, "cached" if cached else "full") for cond_only, cached, _, _ in calls]
    assert kinds == [(True, "full"), (False, "full"), (False, "full"),
                     (True, "cached"), (True, "full"), (True, "cached")]
    deep_2, deep_at_3 = calls[2][3], calls[3][3]
    assert deep_2.shape[0] == 2 * batch and deep_at_3.shape[0] == batch
    assert torch.equal(deep_at_3, deep_2[batch:])
    assert all(want_deep for _, cached, want_deep, _ in calls if not cached)


def test_deep_feature_keeps_the_models_dtype():
    """The deep feature is whatever the full step returns (a bf16 model's
    feature stays bf16 under fp32 latents), and the cached steps get it."""
    fast = FastConfig(cache_interval=2)
    _, tcfg, _, tparams, lat, ctx, _, tplan, batch = _denoise_inputs(4, "ddim", batch=1)
    params = {k: v.to(torch.bfloat16) for k, v in tparams.items()}
    c = torch.from_numpy(ctx).to(torch.bfloat16)
    calls = []

    inner = _torch_model(params, tcfg, c, batch, fast, calls)

    def model(li, t, cond_only, deep=None, want_deep=False):
        out = inner(li.to(torch.bfloat16), t, cond_only, deep=deep, want_deep=want_deep)
        return (out[0].float(), out[1]) if want_deep else out.float()

    out = sampler.denoise(tplan, _nchw(lat), model, num_branches=2,
                          guidance=_cfg(torch.float32), fast=fast)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    cached_deeps = [d for _, cached, _, d in calls if cached]
    assert cached_deeps and all(d.dtype == torch.bfloat16 for d in cached_deeps)


# ---------------------------------------------------- the pipelines
@pytest.fixture(scope="module")
def sd_pipes(tmp_path_factory):
    from tests.snapshot import make_sd_snapshot
    from uce_tpu.diffusion.pipeline import SDPipeline as JaxPipeline
    from uce_tpu_torch.diffusion.pipeline import SDPipeline

    snap = make_sd_snapshot(tmp_path_factory.mktemp("torch_fast_sd"))
    return (JaxPipeline.from_pretrained(snap, dtype=jnp.float32),
            SDPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu"))


@pytest.fixture(scope="module")
def sdxl_pipes(tmp_path_factory):
    from tests.test_sdxl_pipeline import make_sdxl_snapshot
    from uce_tpu.diffusion.pipeline import SDPipeline as JaxPipeline
    from uce_tpu_torch.diffusion.pipeline import SDPipeline

    snap = make_sdxl_snapshot(tmp_path_factory.mktemp("torch_fast_sdxl"))
    return (JaxPipeline.from_pretrained(snap, dtype=jnp.float32),
            SDPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("spec", ["cfg_interval=1:3,cache=2"])
def test_pipeline_fast_matches_uce_tpu(sd_pipes, spec):
    """SDPipeline(fast=) on the tiny SD snapshot, 5 PNDM steps, two prompts
    with two images each: within 1 uint8 level of uce_tpu's, and not the
    exact images."""
    from uce_tpu.diffusion.sampler import FastConfig as JaxFast

    jpipe, pipe = sd_pipes
    kw = dict(num_inference_steps=5, guidance_scale=7.5, seed=[3, 9],
              num_images_per_prompt=2, height=32, width=32)
    prompts = ["a cat riding a bicycle", "a photo of a dog"]
    want = np.asarray(jpipe(prompts, fast=JaxFast.from_spec(spec), **kw))
    got = pipe(prompts, fast=FastConfig.from_spec(spec), **kw)
    assert got.shape == want.shape == (4, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != pipe(prompts, **kw)).any()


def test_pipeline_noop_and_full_window_equal_exact(sd_pipes):
    _, pipe = sd_pipes
    kw = dict(num_inference_steps=4, seed=[5], height=32, width=32)
    exact = pipe(["a cat"], **kw)
    calls = 5  # PNDM: 4 steps, 5 scheduler calls
    for fast in (FastConfig(), FastConfig(cfg_interval=(0, calls))):
        np.testing.assert_array_equal(pipe(["a cat"], fast=fast, **kw), exact)


def test_pipeline_fast_rejects_other_modes(sd_pipes):
    _, pipe = sd_pipes
    with pytest.raises(ValueError, match="fast modes support only cfg"):
        pipe(["a cat"], num_inference_steps=2, height=32, width=32, mode="sld",
             fast=FastConfig(cache_interval=2))
    with pytest.raises(ValueError, match="fast modes support only cfg"):
        pipe(["a cat"], num_inference_steps=2, height=32, width=32,
             mode="concept_algebra", concepts_to_project=["a", "b", "c"],
             fast=FastConfig(cache_interval=2))
    with pytest.raises(ValueError, match="unknown mode"):
        pipe(["a cat"], num_inference_steps=2, height=32, width=32, mode="pag")


@pytest.mark.parametrize("spec", ["cfg_interval=1:2,cache=2"])
def test_sdxl_fast_matches_uce_tpu(sdxl_pipes, spec):
    """Tiny SDXL, 3 Euler steps with a negative prompt: the cond-only calls
    take the cond half of the context and of the added conditioning."""
    from uce_tpu.diffusion.sampler import FastConfig as JaxFast

    jpipe, pipe = sdxl_pipes
    kw = dict(num_inference_steps=3, guidance_scale=7.5, seed=5, height=32,
              width=32, scheduler="euler", negative_prompt="blurry")
    want = np.asarray(jpipe("a cat riding a bicycle", fast=JaxFast.from_spec(spec), **kw))
    got = pipe("a cat riding a bicycle", fast=FastConfig.from_spec(spec), **kw)
    assert got.shape == want.shape == (1, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert want.std() > 0


def test_generate_cli_fast(sd_pipes, tmp_path):
    """``generate --fast`` writes the images SDPipeline(fast=) gives."""
    import csv

    from tests.snapshot import make_sd_snapshot
    from uce_tpu_torch.cli.main import main as cli_main
    from uce_tpu_torch.utils.imaging import decode_png

    _, pipe = sd_pipes
    snap = make_sd_snapshot(tmp_path / "snap")
    csv_path = tmp_path / "prompts.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed"])
        w.writerow([4, "a cat", 7])
    spec = "cfg_interval=1:3,cache=2"
    rc = cli_main(["generate", "--model_id", snap, "--prompts_path", str(csv_path),
                   "--save_path", str(tmp_path / "out"), "--image_size", "32",
                   "--num_inference_steps", "4", "--dtype", "float32",
                   "--fast", spec, "--device", "cpu"])
    assert rc == 0
    img = decode_png((tmp_path / "out" / "original" / "4_0.png").read_bytes())
    want = pipe(["a cat"], num_inference_steps=4, seed=[7], height=32, width=32,
                fast=FastConfig.from_spec(spec))[0]
    np.testing.assert_array_equal(img, want)


# ------------------------------------- kernel launches of a shallow forward
def _shallow_calls(cfg, size, ctx_width, added):
    """conv3x3, group_norm_act and kernel-routed attention calls of one
    full-width shallow forward (cache level 1) on the kernel path, run on
    meta tensors (shapes only)."""
    import collections

    from tests.test_torch_sdxl_sd21_shapes import _ShapeRng
    from uce_tpu_torch.models import layers
    from uce_tpu_torch.ops import attention

    meta = dict(device="meta", dtype=torch.bfloat16)
    convs, norms, attns = (collections.Counter() for _ in range(3))

    def conv_spy(x, w, bias=None):
        convs["mma" if x.shape[-1] == 4 else "wgmma"] += 1
        return torch.empty((*x.shape[:3], w.shape[0]), device="meta", dtype=x.dtype)

    def gn_spy(x, scale, bias, groups=32, eps=1e-5, act="none"):
        norms[tuple(x.shape)] += 1
        return torch.empty(x.shape, device="meta", dtype=x.dtype)

    def attn_spy(q, k, v, **kw):
        if attention.routes_to_kernel(q.shape, k.shape, torch.bfloat16, "cuda"):
            attns[tuple(q.shape[1:])] += 1
        return torch.empty(q.shape, device="meta", dtype=q.dtype)

    params = {k: torch.empty(v.shape, **meta)
              for k, v in tunet.init_state_dict(cfg, _ShapeRng()).items()}
    added_cond = None if added is None else {
        "text_embeds": torch.empty(2, added, **meta),
        "time_ids": torch.empty(2, 6, device="meta")}
    deep = torch.empty(tunet.deep_feature_shape(cfg, 2, size, size), **meta)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.conv_kernel, "conv3x3", conv_spy)
        mp.setattr(layers.gn_kernel, "group_norm_act", gn_spy)
        mp.setattr(tunet, "dot_product_attention", attn_spy)
        out = tunet.apply(params, torch.empty(2, 4, size, size, **meta), 981.0,
                          torch.empty(2, 77, ctx_width, **meta), cfg,
                          added_cond=added_cond, deep_feature=deep)
    assert tuple(out.shape) == (2, 4, size, size)
    return convs, norms, attns


# chip_smoke.py's expected launches per shallow UNet forward (cache level 1)
@pytest.mark.parametrize("model,convs,norms,attns", [
    ("sd14", {"wgmma": 11, "mma": 1}, 16, {(8, 4096, 40): 5}),
    ("sdxl", {"wgmma": 11, "mma": 1}, 11, {}),
])
def test_shallow_forward_launches(model, convs, norms, attns):
    """The shallow path runs only the full-resolution level: conv_in, its
    down block's resnets (and transformers), its up block and conv_out."""
    cfg, size, ctx, added = {"sd14": (tunet.SD14_UNET_CONFIG, 64, 768, None),
                             "sdxl": (tunet.SDXL_UNET_CONFIG, 128, 2048, 1280)}[model]
    got_convs, got_norms, got_attns = _shallow_calls(cfg, size, ctx, added)
    assert dict(got_convs) == convs
    assert sum(got_norms.values()) == norms
    assert dict(got_attns) == attns
    assert all(s[1] == s[2] == size for s in got_norms)  # full resolution only
