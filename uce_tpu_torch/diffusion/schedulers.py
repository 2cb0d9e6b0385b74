"""Diffusion schedulers as host-built plans plus a per-call step function.

A plan holds static numpy tables (per-call timesteps, alphas, sigmas,
multistep coefficients) built once; the sampler walks it with a Python loop
and carries the multistep state itself. Ported: DDIM, PNDM (PLMS,
``skip_prk_steps``; SD v1.x's scheduler), LMSDiscrete and EulerDiscrete
(SDXL's), each with epsilon or v-prediction, and FlowMatchEuler (FLUX's,
velocity prediction, with static or dynamic shifting). Defaults are
diffusers' (scaled_linear betas 0.00085..0.012, leading timestep spacing,
steps_offset=1).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping

import numpy as np
import torch

logger = logging.getLogger(__name__)

SCHEDULER_CLASS_FOR_NAME = {
    "ddim": "DDIMScheduler",
    "pndm": "PNDMScheduler",
    "plms": "PNDMScheduler",
    "lms": "LMSDiscreteScheduler",
    "euler": "EulerDiscreteScheduler",
    "flow_euler": "FlowMatchEulerDiscreteScheduler",
}


def make_betas(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
               beta_schedule="scaled_linear") -> np.ndarray:
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float64) ** 2
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    raise ValueError(f"unsupported beta_schedule: {beta_schedule}")


def _leading_timesteps(num_train, num_steps, steps_offset=1) -> np.ndarray:
    """diffusers 'leading' spacing: (arange(S) * (N//S)).round()[::-1] + offset."""
    ratio = num_train // num_steps
    return (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64) + steps_offset


@dataclasses.dataclass
class Plan:
    """Static tables for one (scheduler, num_steps) pair.

    kind: "ddim", "pndm", "lms", "euler" or "flow_euler" (selects the step
    function).
    num_calls: number of model evaluations (== len(timesteps)).
    timesteps: [num_calls] float32 values fed to the UNet.
    init_noise_sigma: multiply the initial gaussian latents by this.
    history_slots: multistep state slots (3 eps + 1 held sample for PNDM,
    ``order`` derivatives for LMS).
    """

    kind: str
    num_calls: int
    timesteps: np.ndarray
    init_noise_sigma: float
    tables: dict
    history_slots: int = 0
    prediction_type: str = "epsilon"

    def init_carry(self, sample: torch.Tensor) -> list:
        return [torch.zeros_like(sample, dtype=torch.float32)
                for _ in range(self.history_slots)]

    def scale_model_input(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """The UNet's input at call i: x / sqrt(sigma^2 + 1) for the sigma
        schedulers, computed in fp32 and returned in x's dtype."""
        if self.kind in ("lms", "euler"):
            sigma = np.float32(self.tables["sigmas"][i])
            return (x.float() / float(np.sqrt(sigma * sigma + np.float32(1)))).to(x.dtype)
        return x

    def step(self, eps, i: int, sample, carry):
        return _STEP_FNS[self.kind](self, eps, i, sample, carry)


def _to_eps_alpha(plan: Plan, model_output, i: int, sample):
    """v_prediction -> epsilon at the call's alpha: sqrt(a) v + sqrt(1-a) x."""
    if plan.prediction_type != "v_prediction":
        return model_output
    a_t = plan.tables["alpha_t"][i]
    return float(np.sqrt(a_t)) * model_output + float(np.sqrt(1 - a_t)) * sample


def _sigma_derivative(plan: Plan, model_output, i: int, sample):
    """The derivative of a sigma-space step: the model output itself for
    epsilon; for v-prediction (x - pred_x0) / sigma with pred_x0 =
    -sigma v / sqrt(sigma^2 + 1) + x / (sigma^2 + 1) (diffusers'
    EulerDiscrete/LMSDiscrete)."""
    if plan.prediction_type != "v_prediction":
        return model_output
    sigma = np.float32(plan.tables["sigmas"][i])
    s2 = sigma * sigma + np.float32(1)
    pred_x0 = (model_output * float(-sigma / np.sqrt(s2)) + sample / float(s2))
    return (sample - pred_x0) / float(sigma)


def ddim_plan(num_steps: int, num_train_timesteps=1000, beta_start=0.00085,
              beta_end=0.012, beta_schedule="scaled_linear", steps_offset=1,
              set_alpha_to_one=False, prediction_type="epsilon") -> Plan:
    betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
    acp = np.cumprod(1.0 - betas)
    ts = _leading_timesteps(num_train_timesteps, num_steps, steps_offset)
    prev = ts - num_train_timesteps // num_steps
    final_alpha = 1.0 if set_alpha_to_one else acp[0]
    # both ends clipped: with num_steps == num_train_timesteps the leading
    # timestep is num_train_timesteps, one past the end of acp
    alpha_t = acp[np.clip(ts, 0, num_train_timesteps - 1)]
    alpha_prev = np.where(
        prev >= 0, acp[np.clip(prev, 0, num_train_timesteps - 1)], final_alpha)
    return Plan(kind="ddim", num_calls=num_steps, timesteps=ts.astype(np.float32),
                init_noise_sigma=1.0,
                tables={"alpha_t": alpha_t.astype(np.float32),
                        "alpha_prev": alpha_prev.astype(np.float32)},
                prediction_type=prediction_type)


def _ddim_step(plan: Plan, eps, i: int, sample, carry):
    eps = _to_eps_alpha(plan, eps, i, sample)
    a_t = plan.tables["alpha_t"][i]
    a_prev = plan.tables["alpha_prev"][i]
    x0 = (sample - float(np.sqrt(np.float32(1) - a_t)) * eps) / float(np.sqrt(a_t))
    prev = (float(np.sqrt(a_prev)) * x0
            + float(np.sqrt(np.float32(1) - a_prev)) * eps)
    return prev, carry


def pndm_plan(num_steps: int, num_train_timesteps=1000, beta_start=0.00085,
              beta_end=0.012, beta_schedule="scaled_linear",
              steps_offset=1, set_alpha_to_one=False,
              prediction_type="epsilon") -> Plan:
    betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
    acp = np.cumprod(1.0 - betas)
    ratio = num_train_timesteps // num_steps
    base = (np.arange(num_steps) * ratio).round().astype(np.int64) + steps_offset
    # PLMS call sequence: descending with the second timestep repeated
    # (Heun-style warmup corrector on the first interval).
    seq = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
    n_calls = len(seq)  # num_steps + 1

    # Per-call effective (t, t_prev): call 1 re-steps the first interval.
    t_eff = seq.copy()
    t_prev = seq - ratio
    if n_calls >= 2:
        t_eff[1] = seq[1] + ratio
        t_prev[1] = seq[1]

    final_alpha = 1.0 if set_alpha_to_one else acp[0]
    alpha_t = acp[np.clip(t_eff, 0, num_train_timesteps - 1)]
    alpha_prev = np.where(
        t_prev >= 0, acp[np.clip(t_prev, 0, num_train_timesteps - 1)], final_alpha)

    # Adams-Bashforth coefficients over [eps_new, h1, h2, h3]
    coeffs = np.zeros((n_calls, 4))
    for i in range(n_calls):
        coeffs[i] = ([1, 0, 0, 0], [0.5, 0.5, 0, 0], [1.5, -0.5, 0, 0],
                     [23 / 12, -16 / 12, 5 / 12, 0],
                     [55 / 24, -59 / 24, 37 / 24, -9 / 24])[min(i, 4)]
    append = np.ones(n_calls, bool)
    use_held = np.zeros(n_calls, bool)
    if n_calls >= 2:
        append[1] = False   # the corrector call does not extend the history
        use_held[1] = True  # it restarts from the held sample
    return Plan(
        kind="pndm",
        num_calls=n_calls,
        timesteps=seq.astype(np.float32),
        init_noise_sigma=1.0,
        tables={
            "alpha_t": alpha_t.astype(np.float32),
            "alpha_prev": alpha_prev.astype(np.float32),
            "coeffs": coeffs.astype(np.float32),
            "append": append,
            "use_held": use_held,
        },
        history_slots=4,
        prediction_type=prediction_type,
    )


def _pndm_step(plan: Plan, eps, i: int, sample, carry):
    """One PLMS call. carry = [h1, h2, h3, held]; the history stores raw
    model outputs and the v->eps conversion applies once to their
    combination (diffusers step_plms)."""
    t = plan.tables
    h1, h2, h3, held = carry
    if t["use_held"][i]:
        sample = held
    c0, c1, c2, c3 = (float(c) for c in t["coeffs"][i])
    out_eff = c0 * eps + c1 * h1 + c2 * h2 + c3 * h3
    eps_eff = _to_eps_alpha(plan, out_eff, i, sample)

    a_t, a_prev = t["alpha_t"][i], t["alpha_prev"][i]
    b_t, b_prev = np.float32(1) - a_t, np.float32(1) - a_prev
    sample_coeff = float(np.sqrt(a_prev / a_t))
    denom = float(a_t * np.sqrt(b_prev) + np.sqrt(a_t * b_t * a_prev))
    prev = sample_coeff * sample - float(a_prev - a_t) * eps_eff / denom

    if t["append"][i]:
        h1, h2, h3 = eps, h1, h2
    if i == 0:
        held = sample
    return prev, [h1, h2, h3, held]


def lms_plan(num_steps: int, num_train_timesteps=1000, beta_start=0.00085,
             beta_end=0.012, beta_schedule="scaled_linear", order=4,
             prediction_type="epsilon") -> Plan:
    """LMSDiscrete (k-diffusion linear multistep, order 4): linspace
    timesteps, sigmas interpolated from the training schedule, and each
    step's Lagrange-basis integrals. Each basis is a polynomial of degree
    below ``order``, which n-point Gauss-Legendre with 2n >= order
    integrates exactly."""
    betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
    acp = np.cumprod(1.0 - betas)
    sig_all = np.sqrt((1 - acp) / acp)
    t_float = np.linspace(0, num_train_timesteps - 1, num_steps,
                          dtype=np.float64)[::-1]
    sigmas = np.interp(t_float, np.arange(num_train_timesteps), sig_all)
    sigmas = np.concatenate([sigmas, [0.0]])
    nodes, weights = np.polynomial.legendre.leggauss((order + 1) // 2)

    def lms_coeff(o, t, j):
        a, b = sigmas[t], sigmas[t + 1]
        tau = 0.5 * (b - a) * nodes + 0.5 * (a + b)
        prod = np.ones_like(tau)
        for k in range(o):
            if k != j:
                prod = prod * (tau - sigmas[t - k]) / (sigmas[t - j] - sigmas[t - k])
        return 0.5 * (b - a) * float(np.dot(weights, prod))

    coeffs = np.zeros((num_steps, order))
    for t in range(num_steps):
        for j in range(min(t + 1, order)):
            coeffs[t, j] = lms_coeff(min(t + 1, order), t, j)
    return Plan(kind="lms", num_calls=num_steps,
                timesteps=t_float.astype(np.float32),
                init_noise_sigma=float(sigmas.max()),
                tables={"sigmas": sigmas.astype(np.float32),
                        "coeffs": coeffs.astype(np.float32)},
                history_slots=order, prediction_type=prediction_type)


def _lms_step(plan: Plan, eps, i: int, sample, carry):
    """carry = the last ``order`` derivatives, newest first."""
    hist = [_sigma_derivative(plan, eps, i, sample)] + carry[:-1]
    delta = sum(float(c) * h for c, h in zip(plan.tables["coeffs"][i], hist))
    return sample + delta, hist


def euler_plan(num_steps: int, num_train_timesteps=1000, beta_start=0.00085,
               beta_end=0.012, beta_schedule="scaled_linear",
               timestep_spacing="leading", steps_offset=1,
               prediction_type="epsilon") -> Plan:
    """EulerDiscrete: sigmas interpolated at the spaced timesteps; the
    initial noise is sqrt(sigma_max^2 + 1) for leading spacing, sigma_max
    for linspace and trailing (diffusers)."""
    betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
    acp = np.cumprod(1.0 - betas)
    sig_all = np.sqrt((1 - acp) / acp)
    if timestep_spacing == "linspace":
        t_float = np.linspace(0, num_train_timesteps - 1, num_steps,
                              dtype=np.float64)[::-1].copy()
    elif timestep_spacing == "leading":
        t_float = _leading_timesteps(num_train_timesteps, num_steps,
                                     steps_offset).astype(np.float64)
    elif timestep_spacing == "trailing":
        t_float = np.arange(num_train_timesteps, 0,
                            -num_train_timesteps / num_steps).round() - 1
    else:
        raise ValueError(f"unsupported timestep_spacing: {timestep_spacing}")
    sigmas = np.interp(t_float, np.arange(num_train_timesteps), sig_all)
    sigmas = np.concatenate([sigmas, [0.0]])
    init = (sigmas.max() if timestep_spacing in ("linspace", "trailing")
            else np.sqrt(sigmas.max() ** 2 + 1))
    return Plan(kind="euler", num_calls=num_steps,
                timesteps=t_float.astype(np.float32), init_noise_sigma=float(init),
                tables={"sigmas": sigmas.astype(np.float32)},
                prediction_type=prediction_type)


def _euler_step(plan: Plan, eps, i: int, sample, carry):
    sigmas = plan.tables["sigmas"]
    d = _sigma_derivative(plan, eps, i, sample)
    return sample + float(sigmas[i + 1] - sigmas[i]) * d, carry


def flow_match_euler_plan(num_steps: int, num_train_timesteps=1000,
                          shift: float = 1.0, use_dynamic_shifting=False,
                          mu: float | None = None) -> Plan:
    """FlowMatchEulerDiscrete (FLUX): sigmas linear from 1 to 1/num_steps,
    shifted statically by ``shift`` or, with ``use_dynamic_shifting`` and a
    ``mu`` (``pipeline_flux.compute_shift_mu``), by exp(mu); timesteps are
    sigma * num_train_timesteps."""
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    if use_dynamic_shifting and mu is not None:
        sigmas = np.exp(mu) / (np.exp(mu) + (1 / sigmas - 1))
    else:
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    timesteps = sigmas * num_train_timesteps
    sigmas = np.concatenate([sigmas, [0.0]])
    return Plan(kind="flow_euler", num_calls=num_steps,
                timesteps=timesteps.astype(np.float32), init_noise_sigma=1.0,
                tables={"sigmas": sigmas.astype(np.float32)})


def _flow_euler_step(plan: Plan, v, i: int, sample, carry):
    sigmas = plan.tables["sigmas"]
    return sample + float(sigmas[i + 1] - sigmas[i]) * v, carry


_STEP_FNS = {"ddim": _ddim_step, "pndm": _pndm_step, "lms": _lms_step,
             "euler": _euler_step, "flow_euler": _flow_euler_step}


def _reject_unsupported_hf_options(cfg: Mapping, cls: str) -> None:
    """Fail loudly on diffusers options that change the step math but are
    not implemented (SD-family configs pass untouched)."""
    pred = cfg.get("prediction_type", "epsilon")
    if pred not in ("epsilon", "v_prediction"):
        raise ValueError(
            f"prediction_type {pred!r} is not implemented (epsilon / "
            "v_prediction only); stepping it as epsilon would produce noise")
    if cfg.get("trained_betas") is not None:
        raise ValueError("trained_betas tables are not supported; plans "
                         "derive betas from beta_schedule")
    if cfg.get("thresholding", False):
        raise ValueError("dynamic thresholding is not implemented")
    if cfg.get("use_karras_sigmas", False):
        raise ValueError("use_karras_sigmas is not implemented "
                         "(linear-interpolated sigma tables only)")
    if cls == "DDIMScheduler" and cfg.get("clip_sample", False):
        # a missing key means False here: SD configs switched to DDIM come
        # from PNDM configs, where diffusers' DDIM class default (True)
        # would be a trap
        raise ValueError(
            "DDIM clip_sample=true (per-step x0 clamping) is not implemented; "
            "this module follows the SD convention clip_sample=false")
    if cls == "PNDMScheduler" and not cfg.get("skip_prk_steps", True):
        raise ValueError(
            "PNDM with Runge-Kutta warmup (skip_prk_steps=false) is not "
            "implemented — only the PLMS path SD uses")
    if cls == "EulerDiscreteScheduler" and \
            cfg.get("interpolation_type", "linear") != "linear":
        raise ValueError("EulerDiscrete interpolation_type "
                         f"{cfg['interpolation_type']!r} is not implemented")


def plan_from_hf(cfg: Mapping, num_steps: int, mu: float | None = None) -> Plan:
    """Build a plan from a diffusers scheduler_config.json dict.

    ``mu``: the resolution-dependent shift exponent of FlowMatchEuler configs
    with ``use_dynamic_shifting`` (``pipeline_flux.compute_shift_mu`` of the
    packed sequence length); other classes ignore it. A dynamic-shifting
    config without a ``mu`` takes the static shift, with a warning."""
    cls = cfg.get("_class_name", "PNDMScheduler")
    _reject_unsupported_hf_options(cfg, cls)
    common = dict(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
        prediction_type=cfg.get("prediction_type", "epsilon"))
    if cls == "PNDMScheduler":
        return pndm_plan(num_steps, steps_offset=cfg.get("steps_offset", 1),
                         set_alpha_to_one=cfg.get("set_alpha_to_one", False),
                         **common)
    if cls == "DDIMScheduler":
        # diffusers' DDIMScheduler class default for set_alpha_to_one is
        # True (SD configs carry an explicit False)
        return ddim_plan(num_steps, steps_offset=cfg.get("steps_offset", 1),
                         set_alpha_to_one=cfg.get("set_alpha_to_one", True),
                         **common)
    if cls == "LMSDiscreteScheduler":
        return lms_plan(num_steps, **common)
    if cls == "EulerDiscreteScheduler":
        return euler_plan(num_steps,
                          timestep_spacing=cfg.get("timestep_spacing", "leading"),
                          steps_offset=cfg.get("steps_offset", 1), **common)
    if cls == "FlowMatchEulerDiscreteScheduler":
        use_dyn = cfg.get("use_dynamic_shifting", False)
        if use_dyn and mu is None:
            logger.warning(
                "scheduler config requests use_dynamic_shifting but no mu was "
                "provided; using the static shift=%s schedule (pass "
                "mu=compute_shift_mu(seq_len, ...))", cfg.get("shift", 1.0))
        return flow_match_euler_plan(
            num_steps, num_train_timesteps=cfg.get("num_train_timesteps", 1000),
            shift=cfg.get("shift", 1.0), use_dynamic_shifting=use_dyn, mu=mu)
    raise ValueError(f"unsupported scheduler class: {cls}")


def plan_from_hf_as(name: str, cfg: Mapping, num_steps: int) -> Plan:
    """A plan of the requested scheduler type with the model's scheduler
    hyperparameters (prediction_type, betas, ...)."""
    cls = SCHEDULER_CLASS_FOR_NAME.get(name, name)
    return plan_from_hf(dict(cfg, _class_name=cls), num_steps)
