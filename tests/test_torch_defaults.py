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
                                unet.load_params])
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
