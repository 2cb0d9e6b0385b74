"""The port's FLUX pipeline (uce_tpu_torch/diffusion/pipeline_flux.py, the
flow-match plan, the VAE's shift_factor) against uce_tpu's: the latent
packing, the position ids, the dynamic-shift mu, the FlowMatchEuler plans,
and whole generations from tests/snapshot.py's tiny FLUX snapshot in fp32
at 16x16, 2 steps, within 1 uint8 level of uce_tpu's images (the bar of
tests/test_pipeline_parity.py), also with a UCE edit overlay and with
per-prompt seeds, and with the DiT quantized as it loads (w8, int8); the
staged load equal to the whole one, with the edits and quantization asked
for before it deferred to it. And the generate-flux CLI's file contract,
with --staged and --quantize. FLUX.1's VAE, which has no post_quant_conv,
loads and decodes as a decode through an exact identity conv; each call
records the SD pipeline's spans."""

import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.diffusion import pipeline_flux as tpf, schedulers as tsched
from uce_tpu_torch.models.hf_loader import read_safetensors
from uce_tpu_torch.models import vae as tvae

GEN = dict(num_inference_steps=2, height=16, width=16)


def _max_diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def test_pack_unpack_roundtrip_and_channel_major_order():
    """The port packs NCHW latents as uce_tpu packs the same latents NHWC:
    packed[k] = lat[c, py, px] at k = c*4 + py*2 + px (channel-major)."""
    import jax.numpy as jnp

    from uce_tpu.diffusion import pipeline_flux as jpf

    lat = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 4, 8, 12)),
                          dtype=torch.float32)
    packed = tpf.pack_latents(lat)
    assert packed.shape == (2, 4 * 6, 16)
    want = np.asarray(jpf.pack_latents(jnp.asarray(lat.permute(0, 2, 3, 1).numpy())))
    np.testing.assert_array_equal(packed.numpy(), want)
    assert torch.equal(tpf.unpack_latents(packed, 8, 12), lat)
    one = torch.zeros(1, 3, 2, 2)
    for c in range(3):
        for py in range(2):
            for px in range(2):
                one[0, c, py, px] = c * 100 + py * 10 + px
    got = tpf.pack_latents(one)[0, 0]
    for k in range(12):
        c, rem = divmod(k, 4)
        py, px = divmod(rem, 2)
        assert got[k] == c * 100 + py * 10 + px


def test_img_ids_and_shift_mu_match_uce_tpu():
    from uce_tpu.diffusion import pipeline_flux as jpf

    for h, w in [(8, 12), (128, 128)]:
        np.testing.assert_array_equal(tpf.make_img_ids(h, w), jpf.make_img_ids(h, w))
    for seq in (256, 1024, 4096, 64):
        assert tpf.compute_shift_mu(seq) == jpf.compute_shift_mu(seq)
    assert abs(tpf.compute_shift_mu(4096) - 1.15) < 1e-9


@pytest.mark.parametrize("steps,shift,dyn,mu", [(4, 1.0, False, None), (2, 3.0, False, None),
                                                (28, 1.0, True, 1.15), (50, 1.0, True, 0.6)])
def test_flow_match_euler_plan_matches_uce_tpu(steps, shift, dyn, mu):
    from uce_tpu.diffusion import schedulers as jsched

    want = jsched.flow_match_euler_plan(steps, shift=shift, use_dynamic_shifting=dyn, mu=mu)
    got = tsched.flow_match_euler_plan(steps, shift=shift, use_dynamic_shifting=dyn, mu=mu)
    assert got.kind == want.kind == "flow_euler" and got.num_calls == want.num_calls
    np.testing.assert_array_equal(got.timesteps, np.asarray(want.timesteps))
    np.testing.assert_array_equal(got.tables["sigmas"], np.asarray(want.tables["sigmas"]))
    cfg = {"_class_name": "FlowMatchEulerDiscreteScheduler", "shift": shift,
           "use_dynamic_shifting": dyn}
    via_hf = tsched.plan_from_hf(cfg, steps, mu=mu)
    np.testing.assert_array_equal(via_hf.tables["sigmas"],
                                  np.asarray(jsched.plan_from_hf(cfg, steps, mu=mu)
                                             .tables["sigmas"]))
    # one step: x + (sigma_{i+1} - sigma_i) * v
    x, v = torch.ones(3), torch.full((3,), 2.0)
    out, _ = got.step(v, 0, x, [])
    sig = got.tables["sigmas"]
    assert torch.equal(out, x + float(sig[1] - sig[0]) * v)


def test_vae_shift_factor_read_as_uce_tpu():
    from uce_tpu.models import vae as jvae

    hf = dict(tvae.SD_VAE_CONFIG.to_hf(), latent_channels=16, scaling_factor=0.3611,
              shift_factor=0.1159)
    got = tvae.VAEConfig.from_hf(hf)
    assert (got.shift_factor, got.scaling_factor, got.latent_channels) == (0.1159, 0.3611, 16)
    assert got.shift_factor == jvae.VAEConfig.from_hf(hf).shift_factor
    assert tvae.VAEConfig.from_hf(dict(hf, shift_factor=None)).shift_factor == 0.0
    assert tvae.SD_VAE_CONFIG.shift_factor == 0.0


def test_vae_config_reads_use_post_quant_conv():
    """diffusers' default (true) where the key is absent, as in every SD VAE;
    FLUX.1's published VAE sets it false and has no such weight."""
    hf = {k: v for k, v in tvae.SD_VAE_CONFIG.to_hf().items() if k != "use_post_quant_conv"}
    assert tvae.VAEConfig.from_hf(hf).use_post_quant_conv
    assert tvae.VAEConfig.from_hf(tvae.SD_VAE_CONFIG.to_hf()).use_post_quant_conv
    assert not tvae.VAEConfig.from_hf(tvae.FLUX_VAE_CONFIG.to_hf()).use_post_quant_conv
    sd_layout = tvae.VAEConfig(block_out_channels=(8, 16), norm_num_groups=4)
    assert "post_quant_conv.weight" in tvae.init_state_dict(sd_layout,
                                                            np.random.default_rng(0))


def _with_identity_conv(params: dict, lc: int) -> dict:
    """``params`` with a post_quant_conv that changes nothing (identity
    weight, zero bias: exact in fp32)."""
    return {**params, "post_quant_conv.weight": torch.eye(lc)[:, :, None, None],
            "post_quant_conv.bias": torch.zeros(lc)}


def test_flux_vae_without_post_quant_conv_loads_and_decodes(tmp_path):
    """A FLUX.1-layout VAE snapshot (``use_post_quant_conv: false``, no such
    weight) loads as ``FluxPipeline.from_pretrained`` loads it and decodes
    bit for bit as the same weights with an identity post_quant_conv."""
    from uce_tpu_torch.models import unet as tunet
    from uce_tpu_torch.models.hf_loader import load_json, load_state_dict, save_safetensors

    cfg = tvae.VAEConfig(latent_channels=16, block_out_channels=(8, 16), layers_per_block=1,
                         norm_num_groups=4, scaling_factor=0.3611, shift_factor=0.1159,
                         use_post_quant_conv=False)
    sd = tvae.init_state_dict(cfg, np.random.default_rng(3), scale=0.1)
    assert not any(k.startswith("post_quant_conv") for k in sd)
    os.makedirs(tmp_path / "vae")
    with open(tmp_path / "vae" / "config.json", "w") as f:
        json.dump(cfg.to_hf(), f)
    save_safetensors({k: torch.as_tensor(v) for k, v in sd.items()},
                     str(tmp_path / "vae" / "diffusion_pytorch_model.safetensors"))
    got_cfg = tvae.VAEConfig.from_hf(load_json(str(tmp_path / "vae" / "config.json")))
    params = tunet.load_params(load_state_dict(str(tmp_path), "vae"), torch.float32, "cpu")
    assert got_cfg == cfg and "post_quant_conv.weight" not in params
    z = torch.as_tensor(np.random.default_rng(4).standard_normal((2, 16, 8, 8)),
                        dtype=torch.float32)
    got = tvae.decode(params, z, got_cfg)
    assert got.shape == (2, 3, 16, 16)
    with_conv = tvae.VAEConfig(**{**vars(cfg), "use_post_quant_conv": True})
    assert torch.equal(got, tvae.decode(_with_identity_conv(params, 16), z, with_conv))


def test_flux_pipeline_decodes_a_vae_without_post_quant_conv(flux_snap, pipes, tmp_path):
    """The tiny snapshot with its VAE in FLUX.1's layout: the same images as
    its VAE with an identity post_quant_conv."""
    from uce_tpu_torch.models.hf_loader import save_safetensors

    snap = str(tmp_path / "snap")
    shutil.copytree(flux_snap, snap)
    vae_dir = os.path.join(snap, "vae")
    with open(os.path.join(vae_dir, "config.json")) as f:
        hf = json.load(f)
    with open(os.path.join(vae_dir, "config.json"), "w") as f:
        json.dump(dict(hf, use_post_quant_conv=False), f)
    weights = os.path.join(vae_dir, "diffusion_pytorch_model.safetensors")
    save_safetensors({k: v for k, v in read_safetensors(weights).items()
                      if not k.startswith("post_quant_conv")}, weights)
    bare = tpf.FluxPipeline.from_pretrained(snap, dtype=torch.float32, max_sequence_length=16,
                                            device="cpu")
    assert not bare.vae_config.use_post_quant_conv
    assert "post_quant_conv.weight" not in bare.vae_params
    identity = pipes[1]
    saved = identity.vae_params
    identity.vae_params = _with_identity_conv(bare.vae_params,
                                              identity.vae_config.latent_channels)
    try:
        want = identity("a cat on mars", **GEN, seed=4)
    finally:
        identity.vae_params = saved
    np.testing.assert_array_equal(bare("a cat on mars", **GEN, seed=4), want)


def test_flux_call_records_the_pipeline_spans(pipes, monkeypatch):
    """A ``pipe.call`` (batch, steps) holds ``pipe.encode``, a ``pipe.model``
    and a ``pipe.step`` per Euler step, ``pipe.decode`` and ``pipe.readback``;
    each ``pipe.model`` counts the attention kernel's launches of its DiT
    forward (here the plain version, made to count as the kernel does)."""
    from uce_tpu_torch.models import flux as tflux
    from uce_tpu_torch.ops import kernels
    from uce_tpu_torch.utils import observability

    attend = tflux.dot_product_attention

    def counted(*args, **kwargs):
        kernels.count("sd_attention")
        return attend(*args, **kwargs)
    monkeypatch.setattr(tflux, "dot_product_attention", counted)
    tpipe = pipes[1]
    done = observability.spans()
    mark = done[-1]["id"] if done else 0
    tpipe(["a cat"], **dict(GEN, num_inference_steps=3), seed=[2], num_images_per_prompt=2)
    got = [s for s in observability.spans() if s["id"] > mark]
    (call,) = [s for s in got if s["name"] == "pipe.call"]
    assert call["batch"] == 2 and call["steps"] == 3 and call["parent"] is None
    inside = [s for s in got if s["parent"] == call["id"]]
    assert [s["name"] for s in inside] == (["pipe.encode"] + ["pipe.model", "pipe.step"] * 3
                                          + ["pipe.decode", "pipe.readback"])
    models = [s for s in inside if s["name"] == "pipe.model"]
    blocks = tpipe.transformer_config.num_layers + tpipe.transformer_config.num_single_layers
    assert [s["sd_attention"] for s in models] == [blocks] * 3
    assert all(s["conv3x3"] == s["group_norm_act"] == 0 for s in models)
    assert [s["call"] for s in models] == [0, 1, 2]
    assert [s["call"] for s in inside if s["name"] == "pipe.step"] == [0, 1, 2]
    starts = [s["start_ns"] for s in inside]
    assert starts == sorted(starts) and all(s["end_ns"] <= call["end_ns"] for s in inside)


@pytest.fixture(scope="module")
def flux_snap(tmp_path_factory):
    from tests.snapshot import make_flux_snapshot

    return make_flux_snapshot(tmp_path_factory.mktemp("torch_flux_pipe_snap"))


@pytest.fixture(scope="module")
def pipes(flux_snap):
    import jax.numpy as jnp

    from uce_tpu.diffusion.pipeline_flux import FluxPipeline as JaxFlux

    jpipe = JaxFlux.from_pretrained(flux_snap, dtype=jnp.float32, max_sequence_length=16)
    tpipe = tpf.FluxPipeline.from_pretrained(flux_snap, dtype=torch.float32,
                                             max_sequence_length=16, device="cpu")
    return jpipe, tpipe


@pytest.fixture(scope="module")
def edit_path(tmp_path_factory):
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    path = str(tmp_path_factory.mktemp("torch_flux_edit") / "edit.safetensors")
    save_file({"context_embedder.weight":
               (rng.standard_normal((32, 16)) * 0.3).astype(np.float32),
               "unrelated.weight": np.zeros((2, 2), np.float32)}, path)
    return path


@pytest.mark.parametrize("prompts,seed,per_prompt", [
    ("a cat on mars", 4, 1),
    (["a cat", "a dog"], [3, 9], 2)], ids=["int_seed", "list_seeds"])
def test_from_pretrained_images_match_uce_tpu(pipes, prompts, seed, per_prompt):
    jpipe, tpipe = pipes
    kw = dict(GEN, seed=seed, num_images_per_prompt=per_prompt)
    want = np.asarray(jpipe(prompts, **kw))
    got = tpipe(prompts, **kw)
    n = per_prompt * (1 if isinstance(prompts, str) else len(prompts))
    assert got.shape == want.shape == (n, 16, 16, 3) and got.dtype == np.uint8
    assert _max_diff(got, want) <= 1
    if per_prompt > 1:  # per-prompt generators advance across samples
        assert (got[0] != got[1]).any()
        solo = tpipe("a dog", **dict(GEN, seed=[9], num_images_per_prompt=2))
        np.testing.assert_array_equal(solo, got[2:])


def test_edit_overlay_changes_images_as_in_uce_tpu(flux_snap, edit_path, capsys):
    import jax.numpy as jnp

    from uce_tpu.diffusion.pipeline_flux import FluxPipeline as JaxFlux

    kw = dict(GEN, seed=9)
    jpipe = JaxFlux.from_pretrained(flux_snap, dtype=jnp.float32, max_sequence_length=16)
    tpipe = tpf.FluxPipeline.from_pretrained(flux_snap, dtype=torch.float32,
                                             max_sequence_length=16, device="cpu")
    base = tpipe("van gogh style", **kw)
    jpipe.load_uce_edits(edit_path)
    tpipe.load_uce_edits(edit_path)
    assert "skipped unknown key unrelated.weight" in capsys.readouterr().out
    got = tpipe("van gogh style", **kw)
    assert _max_diff(got, jpipe("van gogh style", **kw)) <= 1
    assert (got != base).any()
    assert tpipe.transformer_params["context_embedder.weight"].shape == (32, 16)


def test_edit_of_the_wrong_shape_raises(pipes, tmp_path):
    from uce_tpu_torch.models.hf_loader import save_safetensors

    path = str(tmp_path / "bad.safetensors")
    save_safetensors({"context_embedder.weight": torch.zeros(16, 32)}, path)
    with pytest.raises(ValueError, match="model expects"):
        pipes[1].load_uce_edits(path)


def test_generate_from_embeddings_validates_rows(pipes):
    tpipe = pipes[1]
    t5, pooled = tpipe.encode_prompts(["a cat", "a dog", "a fox"])
    assert t5.shape == (3, 16, 16) and pooled.shape == (3, 24)
    with pytest.raises(ValueError, match="pre-expanded"):
        tpipe.generate_from_embeddings(t5, pooled, num_images_per_prompt=2, **GEN)
    with pytest.raises(ValueError, match="pre-expanded"):
        tpipe.generate_from_embeddings(t5, pooled[:2], **GEN)
    with pytest.raises(ValueError, match="multiples of 4"):
        tpipe.generate_from_embeddings(t5, pooled, num_inference_steps=1, height=18,
                                       width=16)


@pytest.mark.parametrize("mode", ["w8", "int8"])
def test_quantized_load_matches_uce_tpu(flux_snap, mode):
    """from_pretrained(quantize=): the DiT quantized tensor by tensor as it
    loads (FLUX_SKIP), its images within 1 uint8 level of uce_tpu's
    host-side quantized pipeline (fp32); the encoders and VAE stay float."""
    import jax.numpy as jnp

    from uce_tpu.diffusion.pipeline_flux import FluxPipeline as JaxFlux
    from uce_tpu_torch.ops import quant

    jpipe = JaxFlux.from_pretrained(flux_snap, dtype=jnp.float32, max_sequence_length=16,
                                    quantize=mode)
    tpipe = tpf.FluxPipeline.from_pretrained(flux_snap, dtype=torch.float32,
                                             max_sequence_length=16, quantize=mode,
                                             device="cpu")
    tp = tpipe.transformer_params
    is_q = quant.is_quantized if mode == "int8" else quant.is_weight_only
    assert is_q(tp["transformer_blocks.0.attn.to_q.weight"])
    assert not is_q(tp["context_embedder.weight"]) and not is_q(tp["proj_out.weight"])
    kw = dict(GEN, seed=4)
    got = tpipe("a cat on mars", **kw)
    assert _max_diff(got, np.asarray(jpipe("a cat on mars", **kw))) <= 1


def test_staged_matches_eager_and_defers_edits_and_quantize(flux_snap, pipes, edit_path):
    """from_pretrained(staged=True): encode, free_encoders, then the DiT loads
    on the first generate_from_embeddings call: the whole load's images bit
    for bit. Edits and quantize_weights asked for before the DiT exists apply
    at its load, and the edit targets stay float (FLUX_SKIP)."""
    from uce_tpu_torch.ops import quant

    load = dict(dtype=torch.float32, max_sequence_length=16, device="cpu")
    kw = dict(GEN, seed=4)
    pipe = tpf.FluxPipeline.from_pretrained(flux_snap, staged=True, **load)
    assert pipe.transformer_params is None
    t5, pooled = pipe.encode_prompts(["a cat"])
    pipe.free_encoders()
    with pytest.raises(RuntimeError, match="freed"):
        pipe.encode_prompts(["a dog"])
    np.testing.assert_array_equal(pipe.generate_from_embeddings(t5, pooled, **kw),
                                  pipes[1]("a cat", **kw))

    pipe = tpf.FluxPipeline.from_pretrained(flux_snap, staged=True, **load)
    pipe.load_uce_edits(edit_path)
    pipe.quantize_weights("w8")
    assert pipe.pending_edits == [edit_path] and pipe.pending_quantize == "w8"
    t5, pooled = pipe.encode_prompts(["a cat"])
    pipe.free_encoders()
    got = pipe.generate_from_embeddings(t5, pooled, **kw)
    tp = pipe.transformer_params
    assert pipe.pending_edits == []
    assert quant.is_weight_only(tp["single_transformer_blocks.0.proj_out.weight"])
    assert torch.equal(tp["context_embedder.weight"],
                       read_safetensors(edit_path)["context_embedder.weight"])
    whole = tpf.FluxPipeline.from_pretrained(flux_snap, quantize="w8", **load)
    whole.load_uce_edits(edit_path)
    np.testing.assert_array_equal(got, whole("a cat", **kw))
    with pytest.raises(ValueError, match="mode"):
        pipe.quantize_weights("int4")


def test_generate_flux_cli(flux_snap, edit_path, tmp_path):
    """``generate-flux`` writes {case}_{num}.png under the edit's stem for
    the CSV's case window, with the pipeline's images, also with --staged
    (the same images) and --quantize (the quantized pipeline's); --mesh, not
    taken yet, exits with its ROADMAP item."""
    from uce_tpu_torch.cli.main import main
    from uce_tpu_torch.utils.imaging import decode_png

    csv_path = tmp_path / "prompts.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed"])
        w.writerows([[0, "a cat", 5], [1, "a dog", 6], [2, "a fox", 7]])
    base = ["generate-flux", "--model_name", flux_snap, "--prompts_path", str(csv_path),
            "--save_path", str(tmp_path / "out"), "--uce_model_path", edit_path,
            "--image_size", "16", "--num_inference_steps", "2", "--device", "cpu"]
    assert main(base + ["--till_case", "1", "--num_samples", "2"]) == 0
    folder = tmp_path / "out" / "edit"
    assert sorted(os.listdir(folder)) == ["0_0.png", "0_1.png", "1_0.png", "1_1.png"]
    pipe = tpf.FluxPipeline.from_pretrained(flux_snap, dtype=torch.bfloat16, device="cpu")
    pipe.load_uce_edits(edit_path)
    want = pipe("a dog", num_inference_steps=2, seed=6, num_images_per_prompt=2,
                height=16, width=16)
    for num in range(2):
        img = decode_png((folder / f"1_{num}.png").read_bytes())
        np.testing.assert_array_equal(img, want[num])
    one = base + ["--from_case", "1", "--till_case", "1", "--num_samples", "2"]
    assert main([*one, "--staged", "--save_path", str(tmp_path / "staged")]) == 0
    for num in range(2):
        img = decode_png((tmp_path / "staged" / "edit" / f"1_{num}.png").read_bytes())
        np.testing.assert_array_equal(img, want[num])
    assert main([*one, "--quantize", "int8", "--save_path", str(tmp_path / "q")]) == 0
    qpipe = tpf.FluxPipeline.from_pretrained(flux_snap, quantize="int8", device="cpu")
    qpipe.load_uce_edits(edit_path)
    want = qpipe("a dog", num_inference_steps=2, seed=6, num_images_per_prompt=2,
                 height=16, width=16)
    for num in range(2):
        img = decode_png((tmp_path / "q" / "edit" / f"1_{num}.png").read_bytes())
        np.testing.assert_array_equal(img, want[num])
    assert main(base + ["--till_case", "1", "--num_samples", "2", "--mesh", "data=2",
                        "--save_path", str(tmp_path / "mesh")]) == 0
    for name in sorted(os.listdir(folder)):
        np.testing.assert_array_equal(
            decode_png((tmp_path / "mesh" / "edit" / name).read_bytes()),
            decode_png((folder / name).read_bytes()))
