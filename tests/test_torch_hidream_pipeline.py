"""The port's HiDream-I1 pipeline (uce_tpu_torch/diffusion/pipeline_hidream.py)
against uce_tpu's: the pixel-major latent packing, whole generations from
tests/snapshot.py's tiny HiDream snapshot in fp32 at 16x16, 2 steps, CFG
5.0, within 1 uint8 level of uce_tpu's images (the bar of
tests/test_pipeline_parity.py), also with a UCE edit overlay; the staged
load equal to the whole one; the CFG window; the staged load with the DiT
quantized as it loads (w8) against uce_tpu's; and the generate-hidream CLI
with --staged and --quantize."""

import csv
import os

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.diffusion import pipeline_hidream as tph
from uce_tpu_torch.diffusion.sampler import FastConfig
from uce_tpu_torch.models.hf_loader import save_safetensors

GEN = dict(num_inference_steps=2, guidance_scale=5.0, height=16, width=16)


def _max_diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def test_pack_unpack_roundtrip_and_pixel_major_order():
    """The port packs NCHW latents as uce_tpu packs the same latents NHWC:
    packed[k] = lat[py, px, c] at k = (py*2 + px)*C + c (pixel-major, not
    FLUX's channel-major order)."""
    import jax.numpy as jnp

    from uce_tpu.diffusion import pipeline_hidream as jph

    lat = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 4, 8, 12)),
                          dtype=torch.float32)
    packed = tph.pack_latents(lat)
    assert packed.shape == (2, 4 * 6, 16)
    want = np.asarray(jph.pack_latents(jnp.asarray(lat.permute(0, 2, 3, 1).numpy())))
    np.testing.assert_array_equal(packed.numpy(), want)
    assert torch.equal(tph.unpack_latents(packed, 8, 12), lat)
    one = torch.zeros(1, 3, 2, 2)
    for c in range(3):
        for py in range(2):
            for px in range(2):
                one[0, c, py, px] = c * 100 + py * 10 + px
    got = tph.pack_latents(one)[0, 0]
    for k in range(12):
        pix, c = divmod(k, 3)
        py, px = divmod(pix, 2)
        assert got[k] == c * 100 + py * 10 + px


@pytest.fixture(scope="module")
def hd_snap(tmp_path_factory):
    from tests.snapshot import make_hidream_snapshot

    return make_hidream_snapshot(tmp_path_factory.mktemp("torch_hidream_pipe_snap"))


@pytest.fixture(scope="module")
def tpipe(hd_snap):
    return tph.HiDreamPipeline.from_pretrained(hd_snap, dtype=torch.float32,
                                               max_sequence_length=16, device="cpu")


@pytest.fixture(scope="module")
def edit_path(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = str(tmp_path_factory.mktemp("torch_hidream_edit") / "edit.safetensors")
    save_safetensors({f"caption_projection.{i}.linear.weight":
                      torch.as_tensor(rng.standard_normal((32, 16)) * 0.3,
                                      dtype=torch.float32) for i in (0, 2)}
                     | {"unrelated.weight": torch.zeros(2, 2)}, path)
    return path


def test_images_match_uce_tpu_with_and_without_edit(hd_snap, tpipe, edit_path, capsys):
    import jax.numpy as jnp

    from uce_tpu.diffusion.pipeline_hidream import HiDreamPipeline as JaxHiDream

    jpipe = JaxHiDream.from_pretrained(hd_snap, dtype=jnp.float32, max_sequence_length=16)
    kw = dict(GEN, seed=4, num_images_per_prompt=2)
    want = np.asarray(jpipe("van gogh style", **kw))
    got = tpipe("van gogh style", **kw)
    assert got.shape == want.shape == (2, 16, 16, 3) and got.dtype == np.uint8
    assert _max_diff(got, want) <= 1
    assert (got[0] != got[1]).any()

    edited = tph.HiDreamPipeline.from_pretrained(hd_snap, dtype=torch.float32,
                                                 max_sequence_length=16, device="cpu")
    jpipe.load_uce_edits(edit_path)
    edited.load_uce_edits(edit_path)
    assert "skipped unknown key unrelated.weight" in capsys.readouterr().out
    got_e = edited("van gogh style", **kw)
    assert _max_diff(got_e, np.asarray(jpipe("van gogh style", **kw))) <= 1
    assert (got_e != got).any()


def test_edit_overlay_index_and_shape_errors(hd_snap, tmp_path):
    """Index n_llama is the T5 projection; a larger index (another
    config's artifact) or another shape raises."""
    pipe = tph.HiDreamPipeline.from_pretrained(hd_snap, dtype=torch.float32,
                                               max_sequence_length=16, device="cpu")
    t5_key = "caption_projection.2.linear.weight"  # 2 llama streams, then T5
    path = str(tmp_path / "t5.safetensors")
    save_safetensors({t5_key: torch.ones(32, 16)}, path)
    pipe.load_uce_edits(path)
    assert torch.equal(pipe.transformer_params[t5_key], torch.ones(32, 16))
    for key, shape, match in [("caption_projection.3.linear.weight", (32, 16), "exceeds"),
                              ("caption_projection.0.linear.weight", (16, 32), "shape")]:
        save_safetensors({key: torch.zeros(shape)}, path)
        with pytest.raises(ValueError, match=match):
            pipe.load_uce_edits(path)


def test_staged_equals_whole_load(hd_snap, tpipe, edit_path):
    """from_pretrained(staged=True): encode, free_encoders, then the DiT
    loads on the first generate_from_embeddings call, with the pending
    edit applied then: the whole load's images, bit for bit."""
    whole = tph.HiDreamPipeline.from_pretrained(hd_snap, dtype=torch.float32,
                                                max_sequence_length=16, device="cpu")
    whole.load_uce_edits(edit_path)
    want = whole("a cat", **GEN, seed=3)
    pipe = tph.HiDreamPipeline.from_pretrained(hd_snap, dtype=torch.float32,
                                               max_sequence_length=16, staged=True,
                                               device="cpu")
    assert pipe.transformer_params is None
    pipe.load_uce_edits(edit_path)
    assert pipe.transformer_params is None and pipe.pending_edits == [edit_path]
    embeds = tph.cfg_embeddings(pipe.encode_prompts([""]), pipe.encode_prompts(["a cat"]))
    pipe.free_encoders()
    with pytest.raises(RuntimeError, match="freed"):
        pipe.encode_prompts(["a dog"])
    got = pipe.generate_from_embeddings(*(e.cpu() for e in embeds), do_cfg=True, **GEN,
                                        seed=3)
    np.testing.assert_array_equal(got, want)
    assert pipe.pending_edits == [] and pipe.transformer_params is not None
    t5, llama, pooled = embeds
    assert t5.shape == (2, 16, 16) and llama.shape == (2, 2, 16, 16)
    assert pooled.shape == (2, 36)
    with pytest.raises(ValueError, match="pre-expanded"):
        pipe.generate_from_embeddings(t5, llama, pooled[:1], do_cfg=True, **GEN)
    with pytest.raises(ValueError, match="multiples of 4"):
        pipe.generate_from_embeddings(t5, llama, pooled, do_cfg=True,
                                      **dict(GEN, height=18))


def test_fast_cfg_window(tpipe):
    """A window over every call equals the exact run bit for bit; a window
    over call 1 only (call 0 on the cond rows alone) differs; cache=N
    raises; without CFG fast is ignored."""
    kw = dict(GEN, seed=3)
    base = tpipe("a cat", **kw)
    np.testing.assert_array_equal(
        tpipe("a cat", fast=FastConfig(cfg_interval=(0, 100)), **kw), base)
    fast = tpipe("a cat", fast=FastConfig(cfg_interval=(1, 2)), **kw)
    assert fast.shape == base.shape and (fast != base).any()
    with pytest.raises(ValueError, match="cfg_interval only"):
        tpipe("a cat", fast=FastConfig(cache_interval=2), **kw)
    no_cfg = dict(kw, guidance_scale=1.0)
    np.testing.assert_array_equal(
        tpipe("a cat", fast=FastConfig(cfg_interval=(0, 1)), **no_cfg),
        tpipe("a cat", **no_cfg))


@pytest.mark.parametrize("fast", [None, FastConfig(cfg_interval=(1, 2))], ids=str)
def test_pipeline_spans(tpipe, fast):
    """One call records a ``pipe.model`` and a ``pipe.step`` span for each
    of the plan's calls (with the DiT's kernel launches as the model span's
    attrs), with and without a CFG window, then one ``pipe.decode`` and one
    ``pipe.readback``."""
    from uce_tpu_torch.ops import kernels
    from uce_tpu_torch.utils import observability

    done = observability.spans()
    mark = done[-1]["id"] if done else 0
    tpipe("a cat", **dict(GEN, num_inference_steps=3), seed=3, fast=fast)
    got = [s for s in observability.spans() if s["id"] > mark]
    assert [s["name"] for s in got] == (["pipe.model", "pipe.step"] * 3
                                        + ["pipe.decode", "pipe.readback"])
    models = [s for s in got if s["name"] == "pipe.model"]
    assert [s["call"] for s in models] == [0, 1, 2]
    assert [s["call"] for s in got if s["name"] == "pipe.step"] == [0, 1, 2]
    assert all(s[k] == 0 for s in models for k in kernels.KERNELS)  # CPU: plain
    starts = [s["start_ns"] for s in got]
    assert starts == sorted(starts)


def test_quantize_and_mesh_raise_with_their_items(hd_snap, tpipe):
    """An unknown quantization mode raises, at load and after it; apply_mesh
    refuses a mesh without a data axis and one whose rank 0 is not the
    pipeline's device, before it starts any process, and None is a no-op
    without a mesh."""
    import types

    from uce_tpu_torch.parallel import mesh as tmesh, workers

    with pytest.raises(ValueError, match="mode"):
        tph.HiDreamPipeline.from_pretrained(hd_snap, quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tpipe.quantize_weights("int4")
    with pytest.raises(ValueError, match="data"):
        tpipe.apply_mesh(types.SimpleNamespace(shape={"model": 2}))
    with pytest.raises(ValueError, match="rank 0"):
        tpipe.apply_mesh(tmesh.make_mesh(2, 1, devices=["cuda:0", "cuda:1"]))
    tpipe.apply_mesh(None)
    assert tpipe.mesh is None and workers.session() is None


def test_staged_w8_matches_uce_tpu(hd_snap, edit_path):
    """tests/test_hidream_pipeline.py::test_staged_w8_close_to_eager's path
    on both packages (fp32, no CFG): the staged DiT quantized w8 as it loads
    (per layer and per routed expert), the caption projections and the MoE
    router float, a pending edit applied at the load; images within 1 uint8
    level of uce_tpu's."""
    import jax.numpy as jnp

    from uce_tpu.diffusion.pipeline_hidream import HiDreamPipeline as JaxHiDream
    from uce_tpu_torch.ops import quant

    kw = dict(num_inference_steps=2, guidance_scale=0.0, seed=3, height=16, width=16)
    images = []
    for pipe in (JaxHiDream.from_pretrained(hd_snap, dtype=jnp.float32,
                                            max_sequence_length=16, staged=True,
                                            quantize="w8"),
                 tph.HiDreamPipeline.from_pretrained(hd_snap, dtype=torch.float32,
                                                     max_sequence_length=16, staged=True,
                                                     quantize="w8", device="cpu")):
        pipe.load_uce_edits(edit_path)
        embeds = pipe.encode_prompts(["a cat"])
        pipe.free_encoders()
        images.append(np.asarray(pipe.generate_from_embeddings(*embeds, **kw)))
    tp = pipe.transformer_params
    assert quant.is_weight_only(tp["double_stream_blocks.0.block.attn1.to_q.weight"])
    assert quant.is_weight_only(tp["double_stream_blocks.0.block.ff_i.experts.0.w2.weight"])
    for key in ("caption_projection.0.linear.weight",
                "double_stream_blocks.0.block.ff_i.gate.weight"):
        assert not quant.is_weight_only(tp[key])
    assert images[1].shape == (1, 16, 16, 3) and _max_diff(*images) <= 1


def test_generate_hidream_cli_staged(hd_snap, tpipe, edit_path, tmp_path):
    """``generate-hidream --staged`` writes {case}_{num}.png under the
    edit's stem for the CSV's case window, with the pipeline's images, also
    with --quantize int8 (the quantized pipeline's) and with --mesh model=2
    (two spawned CPU ranks, the DiT laid out as it loads after the encoders
    are freed). The CLI runs in bf16, where each rank's row-parallel partial
    product rounds to bf16 before the sum and CFG 5.0 scales the difference:
    the mesh's images are within 3 uint8 levels of the single-rank ones,
    0.5 on average (measured: 2 and 0.30). --fast cache=N is refused."""
    from uce_tpu_torch.cli.main import main
    from uce_tpu_torch.utils.imaging import decode_png

    csv_path = tmp_path / "prompts.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed"])
        w.writerows([[0, "a cat", 5], [1, "a dog", 6], [2, "a fox", 7]])
    base = ["generate-hidream", "--model_name", hd_snap, "--prompts_path", str(csv_path),
            "--save_path", str(tmp_path / "out"), "--uce_model_path", edit_path,
            "--image_size", "16", "--num_inference_steps", "2", "--max_sequence_length",
            "16", "--device", "cpu"]
    assert main(base + ["--till_case", "1", "--num_samples", "2", "--staged"]) == 0
    folder = tmp_path / "out" / "edit"
    assert sorted(os.listdir(folder)) == ["0_0.png", "0_1.png", "1_0.png", "1_1.png"]
    pipe = tph.HiDreamPipeline.from_pretrained(hd_snap, max_sequence_length=16,
                                               device="cpu")
    pipe.load_uce_edits(edit_path)
    want = pipe("a dog", num_inference_steps=2, seed=6, num_images_per_prompt=2,
                height=16, width=16)
    for num in range(2):
        img = decode_png((folder / f"1_{num}.png").read_bytes())
        np.testing.assert_array_equal(img, want[num])
    assert main(base + ["--from_case", "1", "--till_case", "1", "--staged", "--quantize",
                        "int8", "--save_path", str(tmp_path / "q")]) == 0
    qpipe = tph.HiDreamPipeline.from_pretrained(hd_snap, max_sequence_length=16,
                                                quantize="int8", device="cpu")
    qpipe.load_uce_edits(edit_path)
    img = decode_png((tmp_path / "q" / "edit" / "1_0.png").read_bytes())
    np.testing.assert_array_equal(img, qpipe("a dog", num_inference_steps=2, seed=6,
                                             height=16, width=16)[0])
    assert main(base + ["--till_case", "1", "--num_samples", "2", "--staged", "--mesh",
                        "model=2", "--save_path", str(tmp_path / "mesh")]) == 0
    for name in sorted(os.listdir(folder)):
        diff = np.abs(decode_png((tmp_path / "mesh" / "edit" / name).read_bytes())
                      .astype(np.int32) - decode_png((folder / name).read_bytes()))
        assert diff.max() <= 3 and diff.mean() <= 0.5, name
    with pytest.raises(SystemExit, match="cfg_interval only"):
        main(base + ["--fast", "cache=2"])
