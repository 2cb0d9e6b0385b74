"""The denoising loop of every pipeline (SD, FLUX, HiDream): per plan call
one batched model call over the guidance branches (CFG's two, a baseline's
three or five, or one), the guidance combine, and the scheduler's
table-driven step. Each call is a ``pipe.model`` span, with the launches of
the call's conv3x3, group_norm_act, sd_attention and qk_norm_rope kernels
as its attrs (``ops/kernels``), and its combine and step a ``pipe.step``
span (``utils/observability``). ``FastConfig`` adds uce_tpu's opt-in fast
mode: CFG only inside a window of calls, and DeepCache's reuse of the deep
UNet feature."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from uce_tpu_torch.diffusion.schedulers import Plan
from uce_tpu_torch.ops import kernels
from uce_tpu_torch.utils.observability import span


@contextlib.contextmanager
def model_span(device, call: int):
    """The ``pipe.model`` span of denoiser call ``call``; once it is left,
    its attrs count the launches of the models' kernels made inside
    (``kernels.KERNELS``)."""
    before = kernels.launches()
    with span("pipe.model", device, call=call) as s:
        yield
    after = kernels.launches()
    s.attrs.update({k: after[k] - before[k] for k in kernels.KERNELS})


def cfg_combine(eps_branches: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    """Classifier-free guidance over [uncond; cond] stacking."""
    eps_u, eps_c = eps_branches.chunk(2, dim=0)
    return eps_u + guidance_scale * (eps_c - eps_u)


@dataclasses.dataclass(frozen=True)
class FastConfig:
    """Opt-in inference accelerations beyond the reference protocol (50
    steps, CFG at every step), never on by default.

    cfg_interval: ``(lo, hi)``: classifier-free guidance only for scheduler
        calls ``lo <= i < hi``; outside the window only the cond branch runs
        (half the UNet batch). ``None``: CFG everywhere.
    cache_interval: DeepCache N (arXiv:2312.00858): the deep UNet levels run
        every N-th call and their output feature is reused in between,
        where only the shallow path runs. 1: no caching (exact).
    cache_level: how many full-resolution levels stay live on cached calls
        (``models/unet.deep_feature_shape``).
    """

    cfg_interval: tuple | None = None
    cache_interval: int = 1
    cache_level: int = 1

    def __post_init__(self):
        if self.cache_interval < 1:
            raise ValueError("cache_interval must be >= 1")
        if self.cache_level < 1:
            # the per-model upper bound is checked in the UNet's apply()
            raise ValueError("cache_level must be >= 1")
        if self.cfg_interval is not None:
            lo, hi = self.cfg_interval
            if lo < 0 or hi < lo:
                raise ValueError("cfg_interval must satisfy 0 <= lo <= hi")

    @property
    def is_noop(self) -> bool:
        return self.cfg_interval is None and self.cache_interval == 1

    def segments(self, total: int) -> list:
        """Split ``total`` scheduler calls into up to three segments
        ``(start, end, cond_only)``: cond-only before the CFG window, guided
        inside it, cond-only after (``lo``/``hi`` clamped into ``[0,
        total]``; empty segments dropped)."""
        if self.cfg_interval is None:
            return [(0, total, False)]
        lo = min(max(int(self.cfg_interval[0]), 0), total)
        hi = min(max(int(self.cfg_interval[1]), lo), total)
        return [s for s in ((0, lo, True), (lo, hi, False), (hi, total, True))
                if s[1] > s[0]]

    @classmethod
    def from_spec(cls, spec: str) -> "FastConfig":
        """Parse the CLI spec ``cfg_interval=lo:hi,cache=N,level=L``; every
        key is optional, an unknown key raises."""
        kw = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            key, val = key.strip(), val.strip()
            if key == "cfg_interval":
                lo, colon, hi = val.partition(":")
                if not colon or not lo.strip() or not hi.strip():
                    raise ValueError(
                        f"cfg_interval wants 'lo:hi' (got {val!r}), "
                        "e.g. cfg_interval=5:30")
                kw["cfg_interval"] = (int(lo), int(hi))
            elif key == "cache":
                kw["cache_interval"] = int(val)
            elif key == "level":
                kw["cache_level"] = int(val)
            else:
                raise ValueError(
                    f"unknown --fast key {key!r} "
                    "(expected cfg_interval=lo:hi, cache=N, level=L)")
        return cls(**kw)


def denoise(
    plan: Plan,
    latents: torch.Tensor,
    model: Callable,
    *,
    num_branches: int = 1,
    guidance: Callable | None = None,
    guidance_state=None,
    fast: FastConfig | None = None,
) -> torch.Tensor:
    """Run every call of ``plan`` on ``latents``, the raw unit gaussians
    (``init_noise_sigma`` applied here); each call's model input is
    ``num_branches`` copies of the latents scaled by
    ``plan.scale_model_input``.

    model(lat_in, t, cond_only) -> the model output of each branch at
    timestep ``t`` (the closure carries the conditioning; ``cond_only``:
    only the last branch runs, outside a CFG window). Under DeepCache
    (``fast.cache_interval > 1``) the loop also calls ``model(lat_in, t,
    cond_only, want_deep=True) -> (out, deep)`` for a full forward that
    returns its deep feature, and ``model(lat_in, t, cond_only, deep=deep)``
    for the shallow path on a cached one.
    guidance: ``out -> eps`` over the branches (stateless), or, when
    ``guidance_state`` is given, ``(out, i, state) -> (eps, state)`` with
    ``i`` the index of the plan's call (SLD's momentum and warmup); None:
    the model output is the step's input. A one-branch call takes its
    output as it is. The loop casts nothing before the step: the guidance
    gives the eps in the dtype it is rounded to; the scheduler arithmetic
    and its history run in fp32 whatever the latents' dtype.
    fast: the CFG window splits the calls into up to three segments
    (cond-only at one branch, guided, cond-only); within a segment call
    ``i`` runs the full model where ``i % cache_interval == 0`` and the
    shallow path on the cached deep feature otherwise. The cache keeps its
    cond half across a guided -> cond boundary; a segment entered without a
    valid cache (the first, and a guided one, whose uncond half has none)
    runs its first call in full. The deep feature keeps the dtype the model
    gives it. With ``cache_interval == 1`` and a window over every call,
    every call is as without ``fast``, bit for bit.
    """
    lat = latents * plan.init_noise_sigma
    hist = plan.init_carry(lat)
    state = guidance_state
    bsz = lat.shape[0]
    n_cache = fast.cache_interval if fast is not None else 1
    segments = (fast.segments(plan.num_calls) if fast is not None
                else [(0, plan.num_calls, False)])
    deep = None
    for start, end, cond_only in segments:
        branches = 1 if cond_only else num_branches
        if deep is not None and deep.shape[0] == 2 * bsz and cond_only:
            deep = deep[bsz:]  # guided -> cond: keep the cond half
        else:
            deep = None  # no valid cache: the segment's first call is full
        for i in range(start, end):
            with model_span(lat.device, i):
                lat_in = lat if branches == 1 else torch.cat([lat] * branches)
                lat_in = plan.scale_model_input(lat_in, i)
                t = float(plan.timesteps[i])
                if n_cache == 1:
                    out = model(lat_in, t, cond_only)
                elif deep is None or i % n_cache == 0:
                    out, deep = model(lat_in, t, cond_only, want_deep=True)
                else:
                    out = model(lat_in, t, cond_only, deep=deep)
            with span("pipe.step", lat.device, call=i):
                if branches == 1 or guidance is None:
                    eps = out
                elif guidance_state is None:
                    eps = guidance(out)
                else:
                    eps, state = guidance(out, i, state)
                new_lat, hist = plan.step(eps.float(), i, lat.float(), hist)
                lat = new_lat.to(lat.dtype)
    return lat
