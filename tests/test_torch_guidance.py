"""The port's guidance modes (uce_tpu_torch/diffusion/guidance.py, the
stateful ``sampler.denoise`` and ``SDPipeline(mode=...)``) against uce_tpu:
the combines on seeded numpy eps over several calls, the SLD warmup by call
index under PNDM, the debias-VL calibration, and every mode of the tiny SD
pipeline (images within 1 uint8 level, the bar of
tests/test_pipeline_parity.py); SDXL's added conditioning for 3 and 5
branches."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.snapshot import make_sd_snapshot
from uce_tpu.diffusion import guidance as jg
from uce_tpu.diffusion import sampler as jsampler
from uce_tpu.diffusion import schedulers as jsched
from uce_tpu_torch.diffusion import guidance as tg
from uce_tpu_torch.diffusion import sampler as tsampler
from uce_tpu_torch.diffusion import schedulers as tsched


def _branches(rng, n, shape=(2, 4, 6, 6)):
    return np.concatenate([rng.standard_normal(shape).astype(np.float32)
                           for _ in range(n)])


def test_concept_algebra_combine_matches_uce_tpu(rng):
    """fp32 eps: the whole-batch projection, within fp32 round-off of the
    sums' order."""
    for _ in range(3):
        eps = _branches(rng, 5)
        want = np.asarray(jg.concept_algebra_combine(jnp.asarray(eps), 7.5))
        got = tg.concept_algebra_combine(torch.from_numpy(eps), 7.5)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the projection spans the sample batch: one sample's output moves with
    # another sample's p1 - p0
    eps = _branches(rng, 5)
    moved = eps.copy()
    moved[2 * 3 + 1] += 1.0  # p1 of sample 1
    a = tg.concept_algebra_combine(torch.from_numpy(eps), 7.5)[0]
    b = tg.concept_algebra_combine(torch.from_numpy(moved), 7.5)[0]
    assert not torch.equal(a, b)


def test_concept_algebra_combine_bf16_dtypes(rng):
    """bf16 branches: the projection in fp32, the projected text rounded to
    bf16, the combined eps fp32 (the guidance scale is an fp32 scalar), as
    uce_tpu computes it."""
    eps = _branches(rng, 5)
    e16 = torch.from_numpy(eps).bfloat16()
    got = tg.concept_algebra_combine(e16, 7.5)
    want = np.asarray(jg.concept_algebra_combine(
        jnp.asarray(e16.float().numpy(), jnp.bfloat16), jnp.float32(7.5)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    # one bf16 rounding of the projected text may differ (2^-8 relative),
    # scaled by the guidance scale
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=7.5 * 2 ** -7 * 4)


@pytest.mark.parametrize("preset", ["Medium", "Max", "Weak"])
def test_sld_combine_matches_uce_tpu_over_calls(rng, preset):
    """The momentum carried over 14 calls (warmup 10, 0 and 15): eps and
    momentum at every call."""
    jcfg, tcfg = jg.SLDConfig.preset(preset), tg.SLDConfig.preset(preset)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    shape = (1, 4, 6, 6)
    jm, tm = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    for i in range(14):
        eps = _branches(rng, 3, shape) * 0.05  # |text - safety| near the threshold
        jeps, jm = jg.sld_combine(jnp.asarray(eps), jnp.float32(7.5), jnp.asarray(i),
                                  jm, jcfg)
        teps, tm = tg.sld_combine(torch.from_numpy(eps), 7.5, i, tm, tcfg)
        np.testing.assert_allclose(teps.numpy(), np.asarray(jeps), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-7)
    assert float(tm.abs().max()) > 0 or preset == "Weak"


def test_sld_combine_bf16_keeps_fp32_momentum(rng):
    shape = (1, 4, 6, 6)
    eps = torch.from_numpy(_branches(rng, 3, shape) * 0.05).bfloat16()
    cfg = tg.SLDConfig.preset("Max")
    out, mom = tg.sld_combine(eps, 7.5, 0, torch.zeros(shape), cfg)
    assert out.dtype == torch.float32 and mom.dtype == torch.float32
    jout, jmom = jg.sld_combine(jnp.asarray(eps.float().numpy(), jnp.bfloat16),
                                jnp.float32(7.5), jnp.asarray(0),
                                jnp.zeros(shape, jnp.float32), jg.SLDConfig.preset("Max"))
    np.testing.assert_allclose(mom.numpy(), np.asarray(jmom), rtol=0, atol=2e-3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=2e-2)


@pytest.mark.parametrize("warmup", [3, 6])
def test_sld_warmup_counts_pndm_calls(warmup):
    """The stateful denoise on a PNDM plan (5 steps, 6 calls): the warmup
    gate reads the call index, as uce_tpu's scan does. The model is an
    elementwise function of the latents, the branch and t, so the NHWC and
    NCHW layouts give the same numbers."""
    b = 2
    w = np.linspace(0.5, 1.5, 3 * b).astype(np.float32)[:, None, None, None]
    lat = np.random.default_rng(3).standard_normal((b, 4, 4, 3)).astype(np.float32)
    jplan = jsched.pndm_plan(5)
    tplan = tsched.pndm_plan(5)
    assert jplan.num_calls == tplan.num_calls == 6

    def jmodel(x, t):
        return jnp.tanh(x * w + t / 1000.0)

    def tmodel(x, t):
        return torch.tanh(x * torch.from_numpy(w) + t / 1000.0)

    cfg_kw = dict(sld_guidance_scale=1000.0, sld_warmup_steps=warmup,
                  sld_threshold=0.01, sld_momentum_scale=0.3, sld_mom_beta=0.4)
    jcfg, tcfg = jg.SLDConfig(**cfg_kw), tg.SLDConfig(**cfg_kw)
    want = np.asarray(jsampler.denoise(
        jmodel, jplan, jnp.asarray(lat),
        guidance_fn=lambda e, i, m: jg.sld_combine(e, jnp.float32(7.5), i, m, jcfg),
        num_branches=3, guidance_state=jnp.zeros(lat.shape, jnp.float32)))
    got = tsampler.denoise(
        tmodel, tplan, torch.from_numpy(lat),
        guidance_fn=lambda e, i, m: tg.sld_combine(e, 7.5, i, m, tcfg),
        num_branches=3, guidance_state=torch.zeros(lat.shape))
    # fp32 round-off of tanh and PNDM's four-call history over six calls
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    never = tsampler.denoise(
        tmodel, tplan, torch.from_numpy(lat),
        guidance_fn=lambda e, i, m: tg.sld_combine(
            e, 7.5, i, m, dataclasses.replace(tcfg, sld_warmup_steps=6)),
        num_branches=3, guidance_state=torch.zeros(lat.shape))
    assert (warmup == 6) == torch.equal(got, never)


def test_debias_vl_calibration_matches_uce_tpu(rng):
    embeds = rng.standard_normal((6, 12)).astype(np.float32)
    embeds /= np.linalg.norm(embeds, axis=-1, keepdims=True)
    pairs = [[0, 1], [2, 3], [4, 5]]
    want = jg.debias_vl_calibration(embeds, pairs, 500.0)
    got = tg.debias_vl_calibration(embeds, pairs, 500.0)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tg.debias_vl_pair_matrix(embeds[0], embeds[1]),
                                  jg.debias_vl_pair_matrix(embeds[0], embeds[1]))
    with pytest.raises(ValueError, match="at least one concept pair"):
        tg.debias_vl_calibration(embeds, [], 500.0)
    assert tg.build_gender_pairs(["Doctor", "Bus Driver"]) == jg.build_gender_pairs(
        ["Doctor", "Bus Driver"])
    assert tg.DEBIAS_VL_DEFAULT_PROFESSIONS == jg.DEBIAS_VL_DEFAULT_PROFESSIONS
    assert len(tg.DEBIAS_VL_DEFAULT_PROFESSIONS) == 80
    assert tg.DEFAULT_SAFETY_CONCEPT == jg.DEFAULT_SAFETY_CONCEPT


@pytest.fixture(scope="module")
def sd_pipes(tmp_path_factory):
    from uce_tpu.diffusion.pipeline import SDPipeline as JaxPipeline
    from uce_tpu_torch.diffusion.pipeline import SDPipeline

    snap = make_sd_snapshot(tmp_path_factory.mktemp("torch_guidance_snap"))
    return (JaxPipeline.from_pretrained(str(snap), dtype=jnp.float32),
            SDPipeline.from_pretrained(str(snap), dtype=torch.float32, device="cpu"))


def _projection(d: int) -> np.ndarray:
    v = np.random.default_rng(4).standard_normal((2, d)) / np.sqrt(d)
    return np.eye(d) - 0.5 * np.outer(v[0], v[1])


MODES = [
    ("concept_algebra", {"concepts_to_project": ["a man", "a woman", "a person"]},
     {"scheduler": "lms"}),
    ("sld", {"safety_concept": "violence", "sld_config": {"sld_warmup_steps": 2,
                                                           "sld_guidance_scale": 5000.0,
                                                           "sld_threshold": 1.0}}, {}),
    ("debias_vl", {"debias_projection": "P"}, {"scheduler": "lms"}),
]


@pytest.mark.parametrize("mode,kwargs,extra", MODES)
def test_pipeline_mode_matches_uce_tpu(sd_pipes, mode, kwargs, extra):
    """Two prompts x 2 images (the concept-algebra projection spans all
    four), 3 PNDM or LMS steps (SLD with the Max preset's scale and gate
    and a warmup of 2 of the 4 calls): images within 1 uint8 level of
    uce_tpu's, and unlike the cfg images."""
    jpipe, pipe = sd_pipes
    d = pipe.text_config.hidden_size
    jkw, tkw = dict(kwargs), dict(kwargs)
    if "sld_config" in kwargs:
        jkw["sld_config"] = jg.SLDConfig(**kwargs["sld_config"])
        tkw["sld_config"] = tg.SLDConfig(**kwargs["sld_config"])
    if "debias_projection" in kwargs:
        jkw["debias_projection"] = tkw["debias_projection"] = _projection(d)
    kw = dict(num_inference_steps=3, seed=[3, 9], num_images_per_prompt=2,
              height=32, width=32, guidance_scale=7.5)
    kw.update(extra)
    prompts = ["a doctor", "a cat riding a bicycle"]
    want = np.asarray(jpipe(prompts, mode=mode, **jkw, **kw))
    got = pipe(prompts, mode=mode, **tkw, **kw)
    assert got.shape == want.shape == (4, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != pipe(prompts, **kw)).any()


def test_debias_vl_identity_and_fast(sd_pipes):
    """P = I is the cfg run bit for bit; debias_vl takes fast mode, matching
    uce_tpu's fast debias_vl within 1 level."""
    jpipe, pipe = sd_pipes
    d = pipe.text_config.hidden_size
    kw = dict(num_inference_steps=3, seed=[5], height=32, width=32, scheduler="lms")
    np.testing.assert_array_equal(
        pipe(["a nurse"], mode="debias_vl", debias_projection=np.eye(d), **kw),
        pipe(["a nurse"], **kw))
    fast = tsampler.FastConfig(cfg_interval=(1, 3))
    got = pipe(["a nurse"], mode="debias_vl", debias_projection=_projection(d),
               fast=fast, **kw)
    want = np.asarray(jpipe(["a nurse"], mode="debias_vl",
                            debias_projection=_projection(d),
                            fast=jsampler.FastConfig(cfg_interval=(1, 3)), **kw))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    with pytest.raises(ValueError, match="debias_projection"):
        pipe(["a nurse"], mode="debias_vl", **kw)
    with pytest.raises(ValueError, match="exactly 3"):
        pipe(["a nurse"], mode="concept_algebra", concepts_to_project=["a", "b"], **kw)


@pytest.mark.parametrize("n_branches", [2, 3, 5])
def test_sdxl_added_cond_branches(n_branches):
    """SDXL: the extra branches reuse the cond pooled vector; time_ids tiled
    to n_branches x batch (uce_tpu's ``_sdxl_added_cond``)."""
    from uce_tpu.diffusion.pipeline import SDPipeline as JaxPipeline
    from uce_tpu_torch.diffusion.pipeline import SDPipeline

    rng = np.random.default_rng(1)
    cond, uncond = (rng.standard_normal((2, 8)).astype(np.float32) for _ in range(2))
    want = JaxPipeline._sdxl_added_cond(None, jnp.asarray(cond), jnp.asarray(uncond), 2,
                                        96, 64, n_branches)
    pipe = SDPipeline.__new__(SDPipeline)
    pipe.device = torch.device("cpu")
    got = pipe._sdxl_added_cond(torch.from_numpy(cond), torch.from_numpy(uncond), 96, 64,
                                n_branches)
    for key in ("text_embeds", "time_ids"):
        assert tuple(got[key].shape) == np.asarray(want[key]).shape
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
