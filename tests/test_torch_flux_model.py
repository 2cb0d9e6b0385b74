"""The port's FLUX.1 joint transformer (uce_tpu_torch/models/flux.py)
against uce_tpu's on the same seeded weights (uce_tpu's init_params carried
across by models/convert.py::flux_params): the RoPE tables and rotation, and
the whole forward without and with the guidance embedding (FLUX.1-dev).
fp32 tolerances of tests/test_unet_cross_impl.py (rtol = atol = 2e-4 for a
module, 3e-4 for a whole network)."""

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.models import convert, flux as tflux
from uce_tpu_torch.ops import kernels

TINY = dict(in_channels=16, num_layers=1, num_single_layers=2, attention_head_dim=8,
            num_attention_heads=4, joint_attention_dim=16, pooled_projection_dim=24,
            axes_dims_rope=(4, 2, 2))


def _ids(s_txt, lh, lw):
    from uce_tpu.diffusion.pipeline_flux import make_img_ids

    return make_img_ids(lh, lw), np.zeros((s_txt, 3))


@pytest.mark.parametrize("axes", [(4, 2, 2), (16, 56, 56)])
def test_rope_freqs_and_apply_rope_match_uce_tpu(axes):
    import jax.numpy as jnp

    from uce_tpu.models import flux as jflux

    img_ids, txt_ids = _ids(3, 6, 8)
    ids = np.concatenate([txt_ids, img_ids])
    jcos, jsin = jflux.rope_freqs(ids, axes)
    tcos, tsin = tflux.rope_freqs(ids, axes)
    assert tcos.dtype == torch.float32 and tcos.shape == (ids.shape[0], sum(axes))
    np.testing.assert_array_equal(tcos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(tsin.numpy(), np.asarray(jsin))
    x = np.random.default_rng(0).standard_normal((2, 3, ids.shape[0], sum(axes)))
    x = x.astype(np.float32)
    want = np.asarray(jflux.apply_rope(jnp.asarray(x), jcos, jsin))
    got = tflux.apply_rope(torch.as_tensor(x), tcos, tsin)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # a rotation per pair: norms are kept
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), np.linalg.norm(x, axis=-1),
                               rtol=1e-5)


@pytest.mark.parametrize("guidance_embeds", [False, True], ids=["schnell", "dev"])
def test_apply_matches_uce_tpu(guidance_embeds):
    import jax.numpy as jnp

    from uce_tpu.models import flux as jflux

    jcfg = jflux.FluxConfig(**TINY, guidance_embeds=guidance_embeds)
    tcfg = tflux.FluxConfig(**TINY, guidance_embeds=guidance_embeds)
    jparams = jflux.init_params(jcfg, 0, scale=0.3)
    tparams = convert.flux_params(jparams, tcfg)
    assert {k: tuple(v.shape) for k, v in tparams.items()} == tflux.state_dict_shapes(tcfg)
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, 12, 16)).astype(np.float32)
    t5e = rng.standard_normal((2, 5, 16)).astype(np.float32)
    pooled = rng.standard_normal((2, 24)).astype(np.float32)
    t = np.array([0.7, 0.3], np.float32)
    g = np.array([3.5, 2.0], np.float32) if guidance_embeds else None
    img_ids, txt_ids = _ids(5, 6, 8)
    want = np.asarray(jflux.apply(
        jparams, jnp.asarray(lat), jnp.asarray(t5e), jnp.asarray(pooled), jnp.asarray(t),
        img_ids, txt_ids, jcfg, guidance=None if g is None else jnp.asarray(g)))
    got = tflux.apply(tparams, torch.as_tensor(lat), torch.as_tensor(t5e),
                      torch.as_tensor(pooled), torch.as_tensor(t), img_ids, txt_ids, tcfg,
                      guidance=None if g is None else torch.as_tensor(g))
    assert got.shape == (2, 12, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
    # the attention kernel switched off is the same computation on the CPU
    with kernels.route(("sd_attention",)):
        plain = tflux.apply(tparams, torch.as_tensor(lat), torch.as_tensor(t5e),
                            torch.as_tensor(pooled), torch.as_tensor(t), img_ids, txt_ids,
                            tcfg, guidance=None if g is None else torch.as_tensor(g))
    assert torch.equal(plain, got)


def test_config_and_init_state_dict_contract():
    """FluxConfig reads and writes diffusers' config.json as uce_tpu reads it;
    init_state_dict writes uce_tpu's key contract, drawn on the device asked
    for, seeded."""
    from uce_tpu.models import flux as jflux

    cfg = tflux.FluxConfig(**TINY)
    hf = cfg.to_hf()
    assert tflux.FluxConfig.from_hf(hf) == cfg
    jcfg = jflux.FluxConfig.from_hf(hf)
    assert {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__} == cfg.__dict__
    want = jflux.init_state_dict(jcfg, np.random.default_rng(0))
    sd = tflux.init_state_dict(cfg, seed=1, device="cpu", dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: v.shape for k, v in want.items()}
    assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in sd.values())
    assert torch.equal(sd["proj_out.weight"], tflux.init_state_dict(
        cfg, seed=1, device="cpu", dtype=torch.float32)["proj_out.weight"])
    full = tflux.SCHNELL_CONFIG
    n_params = sum(int(np.prod(s)) for s in tflux.state_dict_shapes(full).values())
    assert 11.8e9 < n_params < 12.0e9  # FLUX.1's ~11.9 B parameters


def test_rope_tables_built_once_per_ids():
    """A generation asks for the same RoPE tables at every forward: they are
    built once per (ids, axes, theta, device), and other ids get their own;
    tables built in inference mode still serve a forward under autograd."""
    from uce_tpu_torch.diffusion.pipeline_flux import make_img_ids

    ids = np.concatenate([np.zeros((3, 3)), make_img_ids(4, 6)])
    with torch.inference_mode():
        cos, sin = tflux.rope_freqs(ids, (4, 6, 6))
    again = tflux.rope_freqs(ids.copy(), [4, 6, 6])
    assert again[0] is cos and again[1] is sin
    other = tflux.rope_freqs(np.concatenate([np.zeros((3, 3)), make_img_ids(6, 4)]), (4, 6, 6))
    assert other[0] is not cos and not torch.equal(other[0], cos)
    angle = ids[5, 1] * 1.0 / (10000.0 ** (2 / 6))  # axis 1, second frequency
    assert cos[5, 6] == torch.tensor(np.cos(angle), dtype=torch.float32)
    x = torch.randn(1, 2, len(ids), 16, requires_grad=True)
    tflux.apply_rope(x, cos, sin).sum().backward()
    assert x.grad is not None
