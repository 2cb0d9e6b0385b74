"""The port's library entry points run on the card unless the caller asks for
the CPU: their device defaults are ``cuda``, never a silent CPU run."""

import dataclasses
import inspect

import pytest
import torch

from uce_tpu_torch.diffusion.pipeline import SDPipeline
from uce_tpu_torch.edit import embeddings, sd
from uce_tpu_torch.models import unet


def test_pipeline_device_defaults_to_cuda():
    field = {f.name: f for f in dataclasses.fields(SDPipeline)}["device"]
    assert field.default == torch.device("cuda")
    default = inspect.signature(SDPipeline.from_pretrained).parameters["device"]
    assert default.default == "cuda"


@pytest.mark.parametrize("fn", [embeddings.encode_concepts_sd,
                                embeddings.stack_embeds, sd.load_text_encoder,
                                sd.load_resources, sd.erase_from_embeddings,
                                unet.load_params, embeddings.encode_concepts_sdxl])
def test_edit_device_defaults_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_load_params_on_the_cpu_when_asked():
    params = unet.load_params({"w": [[1.0, 2.0]]}, dtype=torch.bfloat16, device="cpu")
    assert params["w"].device.type == "cpu" and params["w"].dtype == torch.bfloat16


def test_stack_embeds_on_the_cpu_when_asked():
    embeds = {"a": torch.ones(4), "b": torch.zeros(4)}
    got = embeddings.stack_embeds(embeds, ["b", "a"], device="cpu")
    assert got.device.type == "cpu" and got.tolist() == [[0.0] * 4, [1.0] * 4]
    empty = embeddings.stack_embeds(embeds, [], device="cpu")
    assert tuple(empty.shape) == (0, 4) and empty.device.type == "cpu"


def test_load_resources_family_defaults_to_sd():
    assert inspect.signature(sd.load_resources).parameters["family"].default == "sd"
    with pytest.raises(ValueError, match="unknown family"):
        sd.load_resources("unused", family="flux", device="cpu")


@pytest.fixture(scope="module")
def sdxl_snap(tmp_path_factory):
    from tests.test_sdxl_pipeline import make_sdxl_snapshot

    return make_sdxl_snapshot(tmp_path_factory.mktemp("defaults_sdxl"))


def test_second_encoder_loads_on_the_device_asked(sdxl_snap):
    res = sd.load_resources(sdxl_snap, family="sdxl", device="cpu")
    pipe = SDPipeline.from_pretrained(sdxl_snap, dtype=torch.float32, device="cpu")
    for params in (res.text_params_2, pipe.text_params_2):
        assert params["text_projection"].device.type == "cpu"
        assert all(t.device.type == "cpu" for t in params["layers"][0].values())
    assert res.tokenizer_2 is not None


def test_second_encoder_does_not_fall_back_to_the_cpu(sdxl_snap, monkeypatch):
    """The default device is cuda: without a card the load fails rather than
    run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        sd.load_resources(sdxl_snap, family="sdxl")


def test_clip_model_device_defaults_to_cuda():
    from uce_tpu_torch.models.clip import CLIPModel, preprocess_images

    field = {f.name: f for f in dataclasses.fields(CLIPModel)}["device"]
    assert field.default == torch.device("cuda")
    for fn in (CLIPModel.from_pretrained, preprocess_images):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("command", ["debias-sd", "eval-clip-classify"])
def test_new_clis_default_to_cuda_and_do_not_fall_back(command, monkeypatch, tmp_path):
    from uce_tpu_torch.cli.main import build_parser, main

    argv = {"debias-sd": ["--edit_concepts", "doctor", "--debias_concepts", "male; female",
                          "--model_id", str(tmp_path)],
            "eval-clip-classify": ["--image_folder", str(tmp_path)]}[command]
    assert build_parser().parse_args([command, *argv]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([command, *argv, "--clip_model_id", str(tmp_path)])


def test_debias_runs_on_the_embeddings_device():
    """The debias solvers put their stacks where the concept embeddings
    are (the pipeline's device, cuda by default); CPU embeddings keep them
    on the CPU."""
    from uce_tpu_torch.edit.debias import (DebiasSettings, DeviceDebiasApplier,
                                           make_collapsed_solver)

    targets = {"a.attn2.to_k.weight": torch.ones(3, 4)}
    embeds = {c: torch.arange(4.0) + i for i, c in enumerate(("doctor", "male", "female"))}
    args = (targets, embeds, ["doctor"], ["male", "female"], [], DebiasSettings())
    applier = DeviceDebiasApplier(*args, {"a.attn2.to_k.weight": torch.ones(3, 4)})
    assert applier.w_cat.device.type == "cpu"
    assert applier.solve([[0.5, -0.5]]).device.type == "cpu"
    assert make_collapsed_solver(*args)([[0.5, -0.5]])["a.attn2.to_k.weight"].device.type == "cpu"


def test_flux_entry_points_default_to_cuda():
    """FLUX's library entry points: the pipeline (its device field and
    from_pretrained), the edit's resources and solve, the T5 loader, and
    the random-weight draws of the DiT and T5."""
    from uce_tpu_torch.diffusion.pipeline_flux import FluxPipeline
    from uce_tpu_torch.edit import flux as edit_flux
    from uce_tpu_torch.models import flux, t5

    field = {f.name: f for f in dataclasses.fields(FluxPipeline)}["device"]
    assert field.default == torch.device("cuda")
    field = {f.name: f for f in dataclasses.fields(edit_flux.FluxEditResources)}["device"]
    assert field.default == torch.device("cuda")
    for fn in (FluxPipeline.from_pretrained, edit_flux.load_resources,
               edit_flux.load_t5_encoder, edit_flux.erase_from_embeddings,
               flux.init_state_dict, t5.init_state_dict):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


@pytest.mark.parametrize("command", ["edit-flux", "generate-flux"])
def test_flux_clis_default_to_cuda_and_do_not_fall_back(command, monkeypatch, tmp_path):
    from uce_tpu_torch.cli.main import build_parser, main

    argv = {"edit-flux": ["--edit_concepts", "a", "--concept_type", "art",
                          "--model_id", str(tmp_path)],
            "generate-flux": ["--model_name", str(tmp_path), "--prompts_path",
                              str(tmp_path / "p.csv"), "--save_path", str(tmp_path)]}[command]
    assert build_parser().parse_args([command, *argv]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([command, *argv])


def test_hidream_entry_points_default_to_cuda():
    """HiDream's library entry points: the pipeline (its device field and
    from_pretrained), the edit's resources and solve, the Llama loader, and
    the random-weight draws of the DiT and the Llama."""
    from uce_tpu_torch.diffusion.pipeline_hidream import HiDreamPipeline, load_transformer
    from uce_tpu_torch.edit import hidream as edit_hd
    from uce_tpu_torch.models import hidream, llama

    for cls in (HiDreamPipeline, edit_hd.HiDreamEditResources):
        field = {f.name: f for f in dataclasses.fields(cls)}["device"]
        assert field.default == torch.device("cuda"), cls
    for fn in (HiDreamPipeline.from_pretrained, load_transformer, edit_hd.load_resources,
               edit_hd.load_llama_encoder, edit_hd.erase_from_embeddings,
               hidream.init_state_dict, llama.init_state_dict):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


@pytest.mark.parametrize("command", ["edit-hidream", "generate-hidream"])
def test_hidream_clis_default_to_cuda_and_do_not_fall_back(command, monkeypatch, tmp_path):
    from uce_tpu_torch.cli.main import build_parser, main

    argv = {"edit-hidream": ["--edit_concepts", "a", "--concept_type", "art",
                             "--model_id", str(tmp_path)],
            "generate-hidream": ["--model_name", str(tmp_path), "--prompts_path",
                                 str(tmp_path / "p.csv"), "--save_path",
                                 str(tmp_path)]}[command]
    assert build_parser().parse_args([command, *argv]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([command, *argv])


def test_eval_entry_points_default_to_cuda():
    """The eval metrics' library entry points: the weight loaders, the
    preprocessing and the folder runs."""
    from uce_tpu_torch.eval import imageclassify, lpips, styleloss
    from uce_tpu_torch.models import vision_backbones

    for fn in (lpips.load_lpips_weights, lpips.eval_folders, lpips.batch_prep,
               styleloss.load_vgg_weights, styleloss.eval_folders, styleloss.batch_prep,
               imageclassify.load_resnet_weights, imageclassify.classify_folder,
               vision_backbones.preprocess_imagenet):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


@pytest.mark.parametrize("command", ["sld-generate", "concept-algebra", "debias-vl",
                                     "eval-lpips", "eval-styleloss", "eval-imageclassify",
                                     "eval-clip-score"])
def test_baseline_and_eval_clis_default_to_cuda_and_do_not_fall_back(
        command, monkeypatch, tmp_path):
    from uce_tpu_torch.cli.main import build_parser, main

    weights = str(tmp_path / "w.pth")
    folders = ["--original_path", str(tmp_path), "--edited_path", str(tmp_path),
               "--weights", weights]
    argv = {"eval-lpips": folders, "eval-styleloss": folders,
            "eval-imageclassify": ["--image_folder", str(tmp_path), "--weights", weights],
            "eval-clip-score": ["--image_folder", str(tmp_path), "--prompts_path",
                                str(tmp_path / "p.csv"), "--clip_model_id", str(tmp_path)]
            }.get(command, ["--model_name", str(tmp_path), "--prompts_path",
                            str(tmp_path / "p.csv"), "--save_path", str(tmp_path)])
    assert build_parser().parse_args([command, *argv]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([command, *argv])
