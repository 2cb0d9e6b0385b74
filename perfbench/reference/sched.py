"""Plain samplers as diffusers defines them: PNDM's PLMS steps (SD v1's
scheduler, ``skip_prk_steps``) and EulerDiscrete with leading spacing.
Tables in float64."""

from __future__ import annotations

import numpy as np


def alphas_cumprod(cfg) -> np.ndarray:
    betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5,
                        cfg["num_train_timesteps"], dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def pndm(cfg, steps: int, model, x):
    """PLMS: ``steps`` + 1 model calls (the first interval re-stepped).
    ``model(x, t)`` gives the guided noise prediction."""
    acp = alphas_cumprod(cfg)
    ratio = cfg["num_train_timesteps"] // steps
    ts = np.arange(steps) * ratio + cfg["steps_offset"]
    ts = np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1]
    ets, held = [], None
    for n, t in enumerate(ts):
        eps = model(x, float(t))
        prev = t - ratio
        if n == 1:
            prev, t = t, t + ratio
        else:
            ets = ets[-3:] + [eps]
        if n == 0:
            held = x
        elif n == 1:
            eps, x = (eps + ets[-1]) / 2, held
        elif len(ets) == 2:
            eps = (3 * ets[-1] - ets[-2]) / 2
        elif len(ets) == 3:
            eps = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
        elif len(ets) == 4:
            eps = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3] - 9 * ets[-4]) / 24
        a_t = acp[t]
        a_prev = acp[prev] if prev >= 0 else acp[0]
        denom = a_t * (1 - a_prev) ** 0.5 + (a_t * (1 - a_t) * a_prev) ** 0.5
        x = (a_prev / a_t) ** 0.5 * x - (a_prev - a_t) / denom * eps
    return x


def euler(cfg, steps: int, model, x):
    """EulerDiscrete, epsilon prediction, leading spacing: x starts as
    x * sqrt(sigma_max^2 + 1), each call sees x / sqrt(sigma^2 + 1)."""
    acp = alphas_cumprod(cfg)
    ratio = cfg["num_train_timesteps"] // steps
    ts = (np.arange(steps) * ratio).round()[::-1] + cfg["steps_offset"]
    sig = np.interp(ts, np.arange(len(acp)), ((1 - acp) / acp) ** 0.5)
    sig = np.append(sig, 0.0)
    x = x * float((sig.max() ** 2 + 1) ** 0.5)
    for i, t in enumerate(ts):
        eps = model(x / float((sig[i] ** 2 + 1) ** 0.5), float(t))
        x = x + float(sig[i + 1] - sig[i]) * eps
    return x

