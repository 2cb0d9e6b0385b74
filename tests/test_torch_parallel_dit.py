"""The port's tensor and expert parallelism for the DiTs (``mesh.flux_layout``,
``mesh.hidream_layout``, ``FluxPipeline.apply_mesh``,
``HiDreamPipeline.apply_mesh``) against uce_tpu's ``shard_flux_params`` and
``shard_hidream_params`` (tests/conftest.py's 8 virtual CPU devices, a 4x2
mesh, as tests/test_parallel.py runs them) and against the port's own
single-rank forwards.

The port's ranks are spawned gloo processes, one torch thread each, meeting
through a file store under the test's tmp_path. Tolerances: a model=2
forward holds the single-rank one at rtol = atol = 2e-5 in fp32 and in w8
(the bar of uce_tpu's test_tensor_parallel_flux_matches_replicated /
_w8_matches_unsharded; only the order of the row-parallel sums differs),
at relative L2 1e-2 in bf16 (the partial sums round to bf16 before their
sum), and uce_tpu's sharded forward at the port's cross-implementation bar
for a whole DiT (rtol = atol = 3e-4, tests/test_torch_flux_model.py)."""

import re

import numpy as np
import torch

from tests.torch_dist_helpers import param_bytes
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.diffusion import pipeline_flux as tpf, pipeline_hidream as tph
from uce_tpu_torch.models import convert, flux as tflux, hidream as thd
from uce_tpu_torch.models import quantize as tquantize
from uce_tpu_torch.parallel import mesh as tmesh, workers

FLUX = dict(in_channels=16, num_layers=2, num_single_layers=2, attention_head_dim=8,
            num_attention_heads=4, joint_attention_dim=16, pooled_projection_dim=24,
            guidance_embeds=False, axes_dims_rope=(4, 2, 2))
# two routed experts: one on each rank at model=2 (uce_tpu's expert axis
# must divide by the model axis)
HIDREAM = dict(patch_size=2, in_channels=4, out_channels=4, num_layers=1,
               num_single_layers=1, attention_head_dim=8, num_attention_heads=4,
               caption_channels=(16, 16), text_emb_dim=20, num_routed_experts=2,
               num_activated_experts=1, axes_dims_rope=(4, 2, 2), llama_layers=(0, 1),
               ffn_multiple_of=8)


def _mesh(tmp_path, n_data, n_model):
    return tmesh.make_mesh(n_data, n_model, devices="cpu", store_dir=str(tmp_path))


def _max_diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_sharded_keys(jparams, shard_fn) -> set:
    import jax

    from uce_tpu.parallel import mesh as jmesh

    placed = shard_fn(jparams, jmesh.make_mesh(n_data=4, n_model=2))
    return {".".join(str(p.key) for p in path)
            for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]
            if any(axis is not None for axis in leaf.sharding.spec)}


def _jax_path(key: str) -> str:
    """A port DiT key -> the path of its uce_tpu leaf (layer-stacked,
    experts stacked, HiDream's shared experts named ``shared``)."""
    key = re.sub(r"^(\w+_blocks)\.\d+\.(block\.)?", r"\1.", key)
    key = re.sub(r"\.experts\.\d+\.", ".experts.", key)
    return key.replace(".shared_experts.", ".shared.")


def _check_layout(family, params, config, want, single_rows):
    layout = tmesh.layout_fn(family, config, 2)
    got = {_jax_path(k) for k, v in params.items() if layout(k, v) is not None}
    assert got == want
    sizes = []
    for n_model in (1, 2, 4):
        mesh = tmesh.make_mesh(1, n_model, devices="cpu")
        lay = tmesh.layout_fn(family, config, n_model)
        parts = [tmesh.shard_params(params, lay, r) for r in range(n_model)]
        for k, v in params.items():
            held = [p.get(k) for p in parts]
            assert torch.equal(tmesh.unshard_value(held, lay(k, v)), v), k
        sizes.append(param_bytes(parts[0]))
        assert mesh.shape == {"data": 1, "model": n_model}
    assert sizes[0] == param_bytes(params) and sizes[0] > sizes[1] > sizes[2]
    key, rows = single_rows
    assert layout(key, params[key]).runs[1] == rows


def test_flux_layout_matches_uce_tpu_and_reassembles():
    """A key is sharded exactly where uce_tpu's spec_for shards its leaf; the
    ranks' slices (the single blocks' proj_out rows as [attn of rank r; mlp
    of rank r]) put back together give every tensor bit for bit; a rank's
    bytes fall as the model axis grows."""
    from uce_tpu.models import flux as jflux
    from uce_tpu.parallel import mesh as jmesh

    jparams = jflux.init_params(jflux.FluxConfig(**FLUX), 0, scale=0.1)
    cfg = tflux.FluxConfig(**FLUX)
    params = convert.flux_params(jparams, cfg)
    want = _jax_sharded_keys(jparams, jmesh.shard_flux_params)
    # rank 1 of 2: heads 2-3 (columns 16:32), then its MLP half (32 + 64:128)
    _check_layout("flux", params, cfg, want,
                  ("single_transformer_blocks.0.proj_out.weight", ((16, 32), (96, 160))))


def test_hidream_layout_matches_uce_tpu_and_reassembles():
    """As for FLUX; a routed expert lives whole on one rank (expert 0 on
    rank 0, expert 1 on rank 1 of 2), the q/k RMSNorm scales stay whole."""
    from uce_tpu.models import hidream as jhd
    from uce_tpu.parallel import mesh as jmesh

    jparams = jhd.init_params(jhd.HiDreamConfig(**HIDREAM), 0, scale=0.1)
    cfg = thd.HiDreamConfig(**HIDREAM)
    params = convert.hidream_params(jparams, cfg)
    want = _jax_sharded_keys(jparams, jmesh.shard_hidream_params)
    _check_layout("hidream", params, cfg, want,
                  ("double_stream_blocks.0.block.attn1.to_out.weight", ((16, 32),)))
    rank1 = tmesh.shard_hidream_params(params, tmesh.make_mesh(1, 2, devices="cpu"), 1, cfg)
    experts = {k.split(".experts.")[1][0] for k in rank1 if ".experts." in k}
    assert experts == {"1"}
    q = "single_stream_blocks.0.block.attn1.q_rms_norm.weight"
    assert torch.equal(rank1[q], params[q])


def _flux_inputs():
    from uce_tpu.diffusion.pipeline_flux import make_img_ids

    rng = np.random.default_rng(0)
    b, s_img, s_txt = 4, 16, 8
    arrays = {"latents": rng.standard_normal((b, s_img, 16)),
              "t5": rng.standard_normal((b, s_txt, 16)),
              "pooled": rng.standard_normal((b, 24)),
              "timesteps": np.full((b,), 0.5)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return arrays, make_img_ids(8, 8), np.zeros((s_txt, 3))


def test_flux_tensor_parallel_matches_single_and_uce_tpu(tmp_path):
    """FLUX at model=2 in fp32, w8 and bf16 against the single-rank forward,
    and in fp32 and w8 against uce_tpu's shard_flux_params forward."""
    import jax
    import jax.numpy as jnp

    from uce_tpu.models import flux as jflux, quantize as jquantize
    from uce_tpu.parallel import mesh as jmesh

    jcfg, cfg = jflux.FluxConfig(**FLUX), tflux.FluxConfig(**FLUX)
    jparams = jflux.init_params(jcfg, 0, scale=0.1)
    jw8 = jquantize.quantize_params(jparams, jquantize.FLUX_SKIP, mode="w8")
    arrays, img_ids, txt_ids = _flux_inputs()
    mesh = jmesh.make_mesh(n_data=4, n_model=2)
    want = {}
    for mode, jp in (("fp32", jparams), ("w8", jw8)):
        fwd = jax.jit(lambda p, lat, t5, po: jflux.apply(
            p, lat, t5, po, jnp.asarray(arrays["timesteps"]), img_ids, txt_ids, jcfg))
        with mesh:
            want[mode] = np.asarray(fwd(jmesh.shard_flux_params(jp, mesh),
                                        *(jmesh.shard_batch(jnp.asarray(arrays[k]), mesh)
                                          for k in ("latents", "t5", "pooled"))))
    params = convert.flux_params(jparams, cfg)
    slots = {"fp32": params,
             "w8": tquantize.quantize_params(params, tquantize.FLUX_SKIP, "w8"),
             "bf16": {k: v.to(torch.bfloat16) for k, v in params.items()}}
    spec = {"dit_config": cfg, "img_ids": img_ids, "txt_ids": txt_ids}
    layout = tmesh.layout_fn("flux", cfg, 2)
    got, single = {}, {}
    workers.start(_mesh(tmp_path, 1, 2))
    try:
        for mode, p in slots.items():
            dtype = torch.bfloat16 if mode == "bf16" else torch.float32
            batch = {k: (torch.from_numpy(v).to(dtype), None) for k, v in arrays.items()}
            single[mode] = tpf.denoiser_forward(
                {"dit": p}, spec, {k: v for k, (v, _) in batch.items()})
            local = workers.send_params("dit", p.items(), layout)
            got[mode] = workers.run(tpf.denoiser_forward, spec, batch, {"dit": local})[0]
    finally:
        workers.stop()
    for mode in ("fp32", "w8"):
        np.testing.assert_allclose(got[mode].numpy(), single[mode].numpy(),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got[mode].numpy(), want[mode], rtol=3e-4, atol=3e-4)
    assert _rel_l2(got["bf16"].float(), single["bf16"].float()) <= 1e-2


def test_flux_staged_apply_mesh_defers_the_shard(tmp_path):
    """apply_mesh on a staged pipeline lays nothing out until the DiT loads
    (after the encoders are freed); then rank 0 holds its heads only, and
    the images equal the single-rank pipeline's within 1 uint8 level;
    apply_mesh(None) gives the DiT back whole."""
    from tests.snapshot import make_flux_snapshot

    snap = make_flux_snapshot(tmp_path / "snap")
    kw = dict(num_inference_steps=2, height=16, width=16, seed=[3, 4])
    load = dict(dtype=torch.float32, max_sequence_length=16, device="cpu")
    want = tpf.FluxPipeline.from_pretrained(snap, **load)(["a cat", "a dog"], **kw)
    pipe = tpf.FluxPipeline.from_pretrained(snap, staged=True, **load)
    pipe.apply_mesh(_mesh(tmp_path, 1, 2))
    try:
        assert pipe.transformer_params is None and not workers.holds("dit")
        t5, pooled = pipe.encode_prompts(["a cat", "a dog"])
        pipe.free_encoders()
        got = pipe.generate_from_embeddings(t5, pooled, **kw)
        assert workers.holds("dit")
        heads = pipe.transformer_params["transformer_blocks.0.attn.to_q.weight"]
        assert heads.shape[0] == pipe.transformer_config.inner_dim // 2
    finally:
        pipe.apply_mesh(None)
    assert got.shape == want.shape and _max_diff(got, want) <= 1
    whole = pipe.transformer_params["transformer_blocks.0.attn.to_q.weight"]
    assert whole.shape[0] == pipe.transformer_config.inner_dim


def test_hidream_tensor_parallel_matches_single_and_uce_tpu(tmp_path):
    """HiDream at model=2: attention and SwiGLUs split by heads and columns,
    a routed expert on each rank, the full-width q/k RMSNorm's
    sum of squares reduced over the group (trap 4); against the single-rank
    forward and uce_tpu's shard_hidream_params forward."""
    import jax
    import jax.numpy as jnp

    from uce_tpu.diffusion.pipeline_flux import make_img_ids
    from uce_tpu.models import hidream as jhd
    from uce_tpu.parallel import mesh as jmesh

    jcfg, cfg = jhd.HiDreamConfig(**HIDREAM), thd.HiDreamConfig(**HIDREAM)
    jparams = jhd.init_params(jcfg, 0, scale=0.1)
    rng = np.random.default_rng(0)
    arrays = {"latents": rng.standard_normal((4, 16, 16)),
              "t5": rng.standard_normal((4, 6, 16)),
              "llama": rng.standard_normal((2, 4, 5, 16)),
              "pooled": rng.standard_normal((4, 20)),
              "timesteps": np.full((4,), 500.0)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    img_ids = make_img_ids(8, 8)
    mesh = jmesh.make_mesh(n_data=4, n_model=2)
    with mesh:
        want = np.asarray(jax.jit(lambda p, x, t5, ll, po: jhd.apply(
            p, x, t5, ll, po, jnp.asarray(arrays["timesteps"]), img_ids, jcfg))(
            jmesh.shard_hidream_params(jparams, mesh),
            jmesh.shard_batch(jnp.asarray(arrays["latents"]), mesh),
            jmesh.shard_batch(jnp.asarray(arrays["t5"]), mesh),
            jax.device_put(jnp.asarray(arrays["llama"]), jmesh.replicated(mesh)),
            jmesh.shard_batch(jnp.asarray(arrays["pooled"]), mesh)))
    params = convert.hidream_params(jparams, cfg)
    spec = {"dit_config": cfg, "img_ids": img_ids}
    batch = {k: (torch.from_numpy(v), None) for k, v in arrays.items()}
    single = tph.denoiser_forward({"dit": params}, spec,
                                  {k: v for k, (v, _) in batch.items()})
    workers.start(_mesh(tmp_path, 1, 2))
    try:
        local = workers.send_params("dit", params.items(),
                                    tmesh.layout_fn("hidream", cfg, 2))
        assert sum(".experts.0.w1." in k for k in local) == 2  # both blocks' expert 0
        assert not any(".experts.1." in k for k in local)
        got = workers.run(tph.denoiser_forward, spec, batch, {"dit": local})[0]
    finally:
        workers.stop()
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


def test_hidream_pipeline_mesh_matches_single(tmp_path):
    """HiDreamPipeline.apply_mesh at data=2,model=2 under CFG with 3 prompts:
    the padding lands inside each CFG branch; the images are the
    single-rank pipeline's within 1 uint8 level (uce_tpu's bar for its
    test_hidream_pipeline_apply_mesh_matches_single)."""
    from tests.snapshot import make_hidream_snapshot

    snap = make_hidream_snapshot(tmp_path / "snap")
    kw = dict(num_inference_steps=2, guidance_scale=5.0, height=16, width=16,
              seed=[1, 2, 3])
    pipe = tph.HiDreamPipeline.from_pretrained(snap, dtype=torch.float32,
                                               max_sequence_length=16, device="cpu")
    base = pipe(["a", "b", "c"], **kw)
    pipe.apply_mesh(_mesh(tmp_path, 2, 2))
    try:
        got = pipe(["a", "b", "c"], **kw)
    finally:
        pipe.apply_mesh(None)
    assert got.shape == base.shape and _max_diff(got, base) <= 1
