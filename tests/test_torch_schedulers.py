"""The port's scheduler plans (DDIM, PNDM, LMS, Euler), denoise loop and
latent draws against uce_tpu."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_goldens import GOLDEN_PATH
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.diffusion import sampler as jsampler, schedulers as jsched
from uce_tpu.utils import torch_rng as jrng
from uce_tpu_torch.diffusion import sampler as tsampler, schedulers as tsched
from uce_tpu_torch.utils import torch_rng as trng


def _goldens_eps():
    """tests/test_goldens.py's constant eps (after its earlier draws)."""
    rng = np.random.default_rng(12345)
    for shape in ((10, 64), (10, 64), (5, 64), (24, 64), (1, 16, 16, 4), (1, 8, 32)):
        rng.standard_normal(shape)
    return torch.from_numpy(rng.standard_normal((1, 4, 4, 2)).astype(np.float32))


def test_pndm_matches_golden():
    """tests/test_goldens.py's constant-eps 6-step PNDM trajectory."""
    eps = _goldens_eps()
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


NEW_SCHEDULERS = ["DDIMScheduler", "LMSDiscreteScheduler", "EulerDiscreteScheduler"]


@pytest.mark.parametrize("cls", ["FlowMatchEulerDiscreteScheduler"])
def test_unported_schedulers_raise(cls):
    """FlowMatchEuler (FLUX) is ported: its plan is uce_tpu's; a scheduler
    class that neither package has raises in both, with uce_tpu's error."""
    want = jsched.plan_from_hf({"_class_name": cls}, 10)
    got = tsched.plan_from_hf({"_class_name": cls}, 10)
    assert got.kind == want.kind == "flow_euler"
    np.testing.assert_array_equal(got.tables["sigmas"], np.asarray(want.tables["sigmas"]))
    for plan_from_hf in (tsched.plan_from_hf, jsched.plan_from_hf):
        with pytest.raises(ValueError, match="unsupported scheduler class"):
            plan_from_hf({"_class_name": "DPMSolverMultistepScheduler"}, 10)


@pytest.mark.parametrize("name,planner", [("ddim", tsched.ddim_plan),
                                          ("lms", tsched.lms_plan),
                                          ("euler", tsched.euler_plan)])
def test_new_schedulers_match_golden(name, planner):
    """tests/test_goldens.py's constant-eps 6-step trajectories."""
    eps = _goldens_eps()
    plan = planner(6)
    lat = eps * plan.init_noise_sigma
    carry = plan.init_carry(lat)
    for i in range(plan.num_calls):
        lat, carry = plan.step(eps, i, lat, carry)
    np.testing.assert_allclose(lat.numpy(), np.load(GOLDEN_PATH)[f"sched_{name}"],
                               rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("steps", [1, 7, 50])
@pytest.mark.parametrize("cls", NEW_SCHEDULERS)
def test_new_plan_tables_match_uce_tpu(cls, steps):
    """Timesteps, init_noise_sigma and every table equal uce_tpu's exactly
    (the diffusers SD 2.x / SDXL configs' keys)."""
    cfg = {"_class_name": cls, "steps_offset": 1, "set_alpha_to_one": False,
           "prediction_type": "v_prediction", "timestep_spacing": "leading"}
    j, t = jsched.plan_from_hf(cfg, steps), tsched.plan_from_hf(cfg, steps)
    assert (t.kind, t.num_calls, t.history_slots, t.prediction_type) == (
        j.kind, j.num_calls, j.history_slots, j.prediction_type)
    assert t.init_noise_sigma == j.init_noise_sigma
    np.testing.assert_array_equal(t.timesteps, np.asarray(j.timesteps))
    assert t.tables.keys() == j.tables.keys()
    for key in j.tables:
        np.testing.assert_array_equal(t.tables[key], np.asarray(j.tables[key]))


@pytest.mark.parametrize("first", [1, 41, 81, 121])
def test_lms_coeffs_match_uce_tpu_at_every_step_count(first):
    """The port integrates LMS's Lagrange bases by Gauss-Legendre, uce_tpu
    by scipy's adaptive quadrature: equal fp32 tables at 1-160 steps."""
    for steps in range(first, first + 40):
        np.testing.assert_array_equal(
            tsched.lms_plan(steps).tables["coeffs"],
            np.asarray(jsched.lms_plan(steps).tables["coeffs"]), err_msg=str(steps))


def test_lms_plan_needs_no_scipy(monkeypatch):
    """The port imports torch, numpy and the stdlib only."""
    want = np.asarray(jsched.lms_plan(7).tables["coeffs"])  # scipy's quadrature
    for name in ("scipy", "scipy.integrate"):
        monkeypatch.setitem(sys.modules, name, None)
    np.testing.assert_array_equal(tsched.lms_plan(7).tables["coeffs"], want)


@pytest.mark.parametrize("spacing", ["linspace", "trailing"])
def test_euler_spacings_match_uce_tpu(spacing):
    j = jsched.euler_plan(9, timestep_spacing=spacing)
    t = tsched.euler_plan(9, timestep_spacing=spacing)
    assert t.init_noise_sigma == j.init_noise_sigma
    np.testing.assert_array_equal(t.timesteps, np.asarray(j.timesteps))
    np.testing.assert_array_equal(t.tables["sigmas"], np.asarray(j.tables["sigmas"]))


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("cls", NEW_SCHEDULERS)
def test_steps_match_uce_tpu(cls, pred):
    """Five calls of each step function (the LMS history filling up), and
    scale_model_input, within 1e-6 of uce_tpu's on the same inputs."""
    cfg = {"_class_name": cls, "prediction_type": pred, "set_alpha_to_one": False}
    j, t = jsched.plan_from_hf(cfg, 10), tsched.plan_from_hf(cfg, 10)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 5, 5)).astype(np.float32)
    jx, jc = jnp.asarray(x), j.init_carry(x.shape)
    tx, tc = torch.from_numpy(x), t.init_carry(torch.from_numpy(x))
    for i in range(5):
        out = rng.standard_normal(x.shape).astype(np.float32)
        np.testing.assert_allclose(t.scale_model_input(tx, i).numpy(),
                                   np.asarray(j.scale_model_input(jx, i)),
                                   rtol=1e-6, atol=1e-6)
        jx, jc = j.step(jnp.asarray(out), i, jx, jc)
        tx, tc = t.step(torch.from_numpy(out), i, tx, tc)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)


def test_scale_model_input_keeps_the_dtype():
    plan = tsched.euler_plan(5)
    x = torch.ones(1, 4, 2, 2, dtype=torch.bfloat16)
    assert plan.scale_model_input(x, 0).dtype == torch.bfloat16
    assert tsched.ddim_plan(5).scale_model_input(x, 0) is x


def test_plan_from_hf_as_keeps_the_model_hyperparameters():
    """A scheduler override changes the type only: SD 2.1's v-prediction,
    betas and offset carry over, as in uce_tpu."""
    cfg = {"_class_name": "DDIMScheduler", "prediction_type": "v_prediction",
           "beta_start": 0.001, "beta_end": 0.02, "beta_schedule": "linear",
           "num_train_timesteps": 500, "steps_offset": 0, "set_alpha_to_one": False}
    for name in ("ddim", "pndm", "lms", "euler"):
        t, j = tsched.plan_from_hf_as(name, cfg, 8), jsched.plan_from_hf_as(name, cfg, 8)
        assert t.kind == j.kind and t.prediction_type == "v_prediction"
        np.testing.assert_array_equal(t.timesteps, np.asarray(j.timesteps))
        for key in j.tables:
            np.testing.assert_array_equal(t.tables[key], np.asarray(j.tables[key]))


def test_ddim_class_defaults():
    """diffusers' DDIM class default set_alpha_to_one=True applies to a
    config without the key; clip_sample=true is refused, as in uce_tpu."""
    t = tsched.plan_from_hf({"_class_name": "DDIMScheduler"}, 10)
    assert t.tables["alpha_prev"][-1] == np.float32(1.0)
    j = jsched.plan_from_hf({"_class_name": "DDIMScheduler"}, 10)
    np.testing.assert_array_equal(t.tables["alpha_prev"], np.asarray(j.tables["alpha_prev"]))
    with pytest.raises(ValueError, match="clip_sample"):
        tsched.plan_from_hf({"_class_name": "DDIMScheduler", "clip_sample": True}, 10)
    with pytest.raises(ValueError, match="interpolation_type"):
        tsched.plan_from_hf({"_class_name": "EulerDiscreteScheduler",
                             "interpolation_type": "log_linear"}, 10)


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

    def tmodel(x, t, cond_only):
        return (torch.einsum("bchw,cd->bdhw", x, torch.from_numpy(w))
                * float(np.cos(np.float32(t) / np.float32(300.0)))
                + torch.from_numpy(bias))

    want = np.asarray(jsampler.denoise(
        jmodel, jsched.plan_from_hf(cfg, 8), jnp.asarray(lat0),
        guidance_fn=lambda e: jsampler.cfg_combine(e, 7.5)))
    got = tsampler.denoise(
        tsched.plan_from_hf(cfg, 8), torch.from_numpy(lat0), tmodel, num_branches=2,
        guidance=lambda e: tsampler.cfg_combine(e, 7.5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("cls", NEW_SCHEDULERS)
def test_denoise_new_schedulers_match_uce_tpu(cls, pred):
    """The same toy model under CFG through 6 calls of DDIM, LMS and Euler:
    init_noise_sigma on the latents and scale_model_input on each call's
    input, as uce_tpu's scan body applies them."""
    rng = np.random.default_rng(1)
    lat0 = rng.standard_normal((1, 4, 6, 6)).astype(np.float32)
    w = rng.standard_normal((4, 4)).astype(np.float32) * 0.3
    bias = rng.standard_normal((2, 4, 6, 6)).astype(np.float32) * 0.1
    cfg = {"_class_name": cls, "prediction_type": pred, "set_alpha_to_one": False}

    def jmodel(x, t):
        return (jnp.einsum("bchw,cd->bdhw", x, jnp.asarray(w))
                * jnp.cos(t / 300.0) + jnp.asarray(bias))

    def tmodel(x, t, cond_only):
        return (torch.einsum("bchw,cd->bdhw", x, torch.from_numpy(w))
                * float(np.cos(np.float32(t) / np.float32(300.0)))
                + torch.from_numpy(bias))

    want = np.asarray(jsampler.denoise(
        jmodel, jsched.plan_from_hf(cfg, 6), jnp.asarray(lat0),
        guidance_fn=lambda e: jsampler.cfg_combine(e, 7.5)))
    got = tsampler.denoise(
        tsched.plan_from_hf(cfg, 6), torch.from_numpy(lat0), tmodel, num_branches=2,
        guidance=lambda e: tsampler.cfg_combine(e, 7.5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,n_prompts,per_prompt", [
    (42, 1, 1), (7, 2, 3), ([3, 11], 2, 1), ([5, 6, 9], 3, 2)])
def test_draw_prompt_latents_bit_exact(seed, n_prompts, per_prompt):
    want = jrng.draw_prompt_latents((8, 6, 4), seed, n_prompts, per_prompt)
    got = trng.draw_prompt_latents((8, 6, 4), seed, n_prompts, per_prompt)
    assert tuple(got.shape) == (n_prompts * per_prompt, 4, 8, 6)  # NCHW
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
