"""Denoising loop: one batched model call over the guidance branches (CFG's
two, or a baseline's three or five), the guidance combine, and the
scheduler's table-driven step, per plan call; each call is a ``pipe.model``
span, with the conv3x3, group_norm_act and sd_attention kernel launches of
the call as its ``conv3x3``, ``group_norm_act`` and ``sd_attention`` attrs,
and its combine and step a ``pipe.step`` span (``utils/observability``).
``denoise_fast`` adds uce_tpu's opt-in fast mode (``FastConfig``): CFG only
inside a window of calls, and DeepCache's reuse of the deep UNet feature."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from uce_tpu_torch.diffusion.schedulers import Plan
from uce_tpu_torch.models.layers import kernel_launches
from uce_tpu_torch.utils.observability import span


@contextlib.contextmanager
def model_span(device, call: int):
    """The ``pipe.model`` span of denoiser call ``call``; once it is left,
    its attrs count the kernel launches made inside (``kernel_launches``)."""
    before = kernel_launches()
    with span("pipe.model", device, call=call) as s:
        yield
    s.attrs.update({k: n - before[k] for k, n in kernel_launches().items()})


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
    model_fn: Callable[[torch.Tensor, float], torch.Tensor],
    plan: Plan,
    latents: torch.Tensor,
    *,
    guidance_fn: Callable[..., torch.Tensor],
    num_branches: int = 2,
    guidance_state=None,
) -> torch.Tensor:
    """Run every call of ``plan`` with ``num_branches`` guidance branches.

    model_fn(latents_in [num_branches*B, C, H, W], t) -> eps of each branch
    (the closure carries the text context and any added conditioning).
    guidance_fn: ``eps_branches -> eps`` (stateless), or, when
    ``guidance_state`` is given, ``(eps_branches, i, state) -> (eps,
    state)`` with ``i`` the index of the plan's call (SLD's momentum and
    warmup). ``latents`` are the raw unit gaussians (init_noise_sigma
    applied here); each call's UNet input is scaled by
    ``plan.scale_model_input``. The scheduler arithmetic and its history run
    in fp32 whatever the latents' dtype.
    """
    lat = latents * plan.init_noise_sigma
    hist = plan.init_carry(lat)
    state = guidance_state
    for i in range(plan.num_calls):
        with model_span(lat.device, i):
            lat_in = plan.scale_model_input(torch.cat([lat] * num_branches), i)
            eps_branches = model_fn(lat_in, float(plan.timesteps[i]))
        with span("pipe.step", lat.device, call=i):
            if guidance_state is None:
                eps = guidance_fn(eps_branches)
            else:
                eps, state = guidance_fn(eps_branches, i, state)
            eps = eps.to(lat.dtype)
            new_lat, hist = plan.step(eps.float(), i, lat.float(), hist)
            lat = new_lat.to(lat.dtype)
    return lat


def denoise_fast(
    model_factory: Callable[[bool, bool, bool], Callable],
    plan: Plan,
    latents: torch.Tensor,
    *,
    guidance_scale: float,
    fast: FastConfig,
) -> torch.Tensor:
    """``denoise`` under CFG with the FastConfig accelerations.

    ``model_factory(cond_only, cached, want_deep)`` returns the model
    closure of one variant, batched over [uncond; cond] unless
    ``cond_only``:

    * ``cached=False, want_deep=False``: ``f(lat_in, t) -> eps``
    * ``cached=False, want_deep=True``:  ``f(lat_in, t) -> (eps, deep)``
    * ``cached=True``:                   ``f(lat_in, t, deep) -> eps``

    The CFG window splits the calls into up to three segments (cond-only at
    batch B, guided at 2B, cond-only at B); within a segment call ``i`` runs
    the full UNet where ``i % cache_interval == 0`` and the shallow path on
    the cached deep feature otherwise. The cache keeps its cond half across
    a guided -> cond boundary; a segment entered without a valid cache (the
    first, and a guided one, whose uncond half has none) runs its first call
    in full. The deep feature keeps the dtype the model gives it. With
    ``cache_interval == 1`` every call is the full forward, cast for cast
    as in ``denoise``: a full window reproduces it bit for bit.
    """
    lat = latents * plan.init_noise_sigma
    hist = plan.init_carry(lat)
    bsz = lat.shape[0]
    n_cache = fast.cache_interval
    deep = None
    for seg_start, seg_end, cond_only in fast.segments(plan.num_calls):
        if cond_only:
            def guidance(e):
                return e
        else:
            def guidance(e):
                return cfg_combine(e.float(), guidance_scale)
        if n_cache == 1:
            f_full = model_factory(cond_only, False, False)
        else:
            f_deep = model_factory(cond_only, False, True)
            f_cached = model_factory(cond_only, True, False)
            if deep is not None and deep.shape[0] == 2 * bsz and cond_only:
                deep = deep[bsz:]  # guided -> cond: keep the cond half
            else:
                deep = None  # no valid cache: the segment's first call is full
        for i in range(seg_start, seg_end):
            with model_span(lat.device, i):
                lat_in = lat if cond_only else torch.cat([lat, lat])
                lat_in = plan.scale_model_input(lat_in, i)
                t = float(plan.timesteps[i])
                if n_cache == 1:
                    eps = f_full(lat_in, t)
                elif deep is None or i % n_cache == 0:
                    eps, deep = f_deep(lat_in, t)
                else:
                    eps = f_cached(lat_in, t, deep)
            with span("pipe.step", lat.device, call=i):
                eps = guidance(eps).to(lat.dtype)
                new_lat, hist = plan.step(eps.float(), i, lat.float(), hist)
                lat = new_lat.to(lat.dtype)
    return lat
