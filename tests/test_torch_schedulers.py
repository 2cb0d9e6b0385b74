"""The port's PNDM plan, denoise loop and latent draws against uce_tpu."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_goldens import GOLDEN_PATH
from uce_tpu.diffusion import sampler as jsampler, schedulers as jsched
from uce_tpu.utils import torch_rng as jrng
from uce_tpu_torch.diffusion import sampler as tsampler, schedulers as tsched
from uce_tpu_torch.utils import torch_rng as trng


def test_pndm_matches_golden():
    """tests/test_goldens.py's constant-eps 6-step PNDM trajectory."""
    rng = np.random.default_rng(12345)
    for shape in ((10, 64), (10, 64), (5, 64), (24, 64), (1, 16, 16, 4), (1, 8, 32)):
        rng.standard_normal(shape)
    eps = torch.from_numpy(rng.standard_normal((1, 4, 4, 2)).astype(np.float32))
    plan = tsched.pndm_plan(6)
    assert plan.num_calls == jsched.make_plan("pndm", 6).num_calls == 7
    lat = eps * plan.init_noise_sigma
    carry = plan.init_carry(lat)
    for i in range(plan.num_calls):
        lat, carry = plan.step(eps, i, lat, carry)
    np.testing.assert_allclose(lat.numpy(), np.load(GOLDEN_PATH)["sched_pndm"],
                               rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("steps", [1, 2, 5, 50])
def test_pndm_tables_match_uce_tpu(steps):
    cfg = {"_class_name": "PNDMScheduler", "steps_offset": 1,
           "skip_prk_steps": True, "set_alpha_to_one": False}
    j, t = jsched.plan_from_hf(cfg, steps), tsched.plan_from_hf(cfg, steps)
    assert t.num_calls == j.num_calls
    np.testing.assert_array_equal(t.timesteps, np.asarray(j.timesteps))
    for key in j.tables:
        np.testing.assert_array_equal(t.tables[key], np.asarray(j.tables[key]))
    np.testing.assert_array_equal(tsched._leading_timesteps(1000, steps),
                                  jsched._leading_timesteps(1000, steps))
    np.testing.assert_array_equal(tsched.make_betas(), jsched.make_betas())


@pytest.mark.parametrize("cls", ["DDIMScheduler", "LMSDiscreteScheduler",
                                 "EulerDiscreteScheduler"])
def test_unported_schedulers_raise(cls):
    with pytest.raises(NotImplementedError, match="not ported"):
        tsched.plan_from_hf({"_class_name": cls}, 10)


def test_prk_warmup_rejected():
    with pytest.raises(ValueError, match="skip_prk_steps"):
        tsched.plan_from_hf({"_class_name": "PNDMScheduler",
                             "skip_prk_steps": False}, 10)


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_denoise_matches_uce_tpu(pred):
    """A toy model that depends on the latents and t, with CFG over two
    branches; 8 PNDM steps in fp32."""
    rng = np.random.default_rng(0)
    lat0 = rng.standard_normal((2, 4, 6, 6)).astype(np.float32)  # NCHW
    w = rng.standard_normal((4, 4)).astype(np.float32) * 0.3
    bias = rng.standard_normal((4, 4, 6, 6)).astype(np.float32) * 0.1
    cfg = {"_class_name": "PNDMScheduler", "prediction_type": pred}

    def jmodel(x, t):  # NCHW in jax, same arithmetic as the torch model
        return (jnp.einsum("bchw,cd->bdhw", x, jnp.asarray(w))
                * jnp.cos(t / 300.0) + jnp.asarray(bias))

    def tmodel(x, t):
        return (torch.einsum("bchw,cd->bdhw", x, torch.from_numpy(w))
                * float(np.cos(np.float32(t) / np.float32(300.0)))
                + torch.from_numpy(bias))

    want = np.asarray(jsampler.denoise(
        jmodel, jsched.plan_from_hf(cfg, 8), jnp.asarray(lat0),
        guidance_fn=lambda e: jsampler.cfg_combine(e, 7.5)))
    got = tsampler.denoise(
        tmodel, tsched.plan_from_hf(cfg, 8), torch.from_numpy(lat0),
        guidance_fn=lambda e: tsampler.cfg_combine(e, 7.5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,n_prompts,per_prompt", [
    (42, 1, 1), (7, 2, 3), ([3, 11], 2, 1), ([5, 6, 9], 3, 2)])
def test_draw_prompt_latents_bit_exact(seed, n_prompts, per_prompt):
    want = jrng.draw_prompt_latents((8, 6, 4), seed, n_prompts, per_prompt)
    got = trng.draw_prompt_latents((8, 6, 4), seed, n_prompts, per_prompt)
    assert tuple(got.shape) == (n_prompts * per_prompt, 4, 8, 6)  # NCHW
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
