"""eval-dreamsim on the port against uce_tpu: the ViT's CLS embedding, the
ensemble's distance from a tools/convert_dreamsim.py-format file and the
pair-folder CSV, on a tiny ViT (depth 2, dim 32, patch 8, 32² input) in
fp32. Tolerances: embeddings and distances 1e-5 (fp32 round-off of two
blocks), the CSV's numbers 1e-5 relative."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.eval import dreamsim as jdreamsim
from uce_tpu.models import vision_backbones as jvb
from uce_tpu_torch.eval import dreamsim
from uce_tpu_torch.models import vision_backbones as vb
from uce_tpu_torch.models.hf_loader import save_safetensors
from uce_tpu_torch.utils.imaging import save_png

# tools/convert_dreamsim.py's per-family normalizations
NORMS = {"dino_vitb16": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
         "clip_vitb16": ((0.48145466, 0.4578275, 0.40821073),
                         (0.26862954, 0.26130258, 0.27577711))}


def test_init_and_cls_embed_match_uce_tpu():
    sd = vb.init_vit_timm(np.random.default_rng(1))
    want_sd = jvb.init_vit_timm(np.random.default_rng(1))
    assert sd.keys() == want_sd.keys()
    assert all(np.array_equal(sd[k], want_sd[k]) for k in sd)
    x = np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = jax.jit(jvb.vit_cls_embed, static_argnums=2)(jvb.convert_vit_timm(sd),
                                                        jnp.asarray(x), 2)
    params = vb.convert_vit_timm(sd)
    assert len(params["blocks"]) == 2
    got = vb.vit_cls_embed(params, torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Two backbones with different head counts, as the converter writes
    them: ``<model>/<key>`` tensors and the models/num_heads/mean/std
    metadata."""
    tensors, meta = {}, {}
    for i, (name, (mean, std)) in enumerate(NORMS.items()):
        heads = 2 + 2 * i
        sd = vb.init_vit_timm(np.random.default_rng(10 + i), heads=heads)
        tensors.update({f"{name}/{k}": v for k, v in sd.items()})
        meta[f"{name}.num_heads"] = str(heads)
        meta[f"{name}.mean"] = ",".join(map(str, mean))
        meta[f"{name}.std"] = ",".join(map(str, std))
    meta["models"] = ",".join(NORMS)
    path = tmp_path_factory.mktemp("torch_dreamsim") / "ensemble.safetensors"
    save_safetensors(tensors, str(path), metadata=meta)
    return str(path)


def test_distance_matches_uce_tpu(weights):
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want = jdreamsim.load_dreamsim_jax(weights)(a, b)
    fn = dreamsim.load_dreamsim(weights, "cpu")
    nchw = lambda z: torch.from_numpy(z).permute(0, 3, 1, 2)
    got = fn(nchw(a), nchw(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(fn(nchw(a), nchw(a)).abs().max()) <= 1e-6


def _folders(root):
    rng = np.random.default_rng(4)
    for name in ("orig", "edit"):
        for case, num in ((0, 0), (0, 1), (2, 0), (5, 0)):
            if name == "edit" and case == 5:
                continue  # an unpaired image is skipped
            save_png(rng.integers(0, 256, (40, 40, 3), np.uint8),
                     str(root / name / f"{case}_{num}.png"))
    prompts = root / "prompts.csv"
    prompts.write_text("case_number,prompt,evaluation_seed\n0,a,1\n1,b,2\n2,c,3\n")
    return str(root / "orig"), str(root / "edit"), str(prompts)


def test_eval_folders_csv_matches_uce_tpu(weights, tmp_path):
    orig, edit, prompts = _folders(tmp_path)
    got_path, want_path = tmp_path / "port.csv", tmp_path / "ref.csv"
    dreamsim.eval_folders(dreamsim.load_dreamsim(weights, "cpu"), orig, edit,
                          prompts_path=prompts, save_path=str(got_path), image_size=32,
                          device="cpu")
    jdreamsim.eval_folders(jdreamsim.load_dreamsim_jax(weights), orig, edit,
                           prompts_path=prompts, save_path=str(want_path), image_size=32)
    got, want = (list(csv.reader(open(p))) for p in (got_path, want_path))
    assert got[0] == want[0] == ["case_number", "prompt", "evaluation_seed", "dream_loss"]
    assert len(got) == len(want) == 4
    for g, w in zip(got[1:], want[1:]):
        assert g[:3] == w[:3] and (g[3] == "") == (w[3] == "")
        if w[3]:
            np.testing.assert_allclose(float(g[3]), float(w[3]), rtol=1e-5)


def test_cli_default_name_and_alias(weights, tmp_path, capsys):
    from uce_tpu_torch.cli.main import main as cli_main

    orig, _, _ = _folders(tmp_path)
    rc = cli_main(["eval-dreamsim", "--original_path", orig, "--edited_path", orig + "/",
                   "--jax_weights", weights, "--image_size", "32", "--device", "cpu"])
    assert rc == 0
    rows = list(csv.reader(open(orig + "_dreamloss.csv")))
    assert rows[0] == ["case_number", "dream_loss"] and len(rows) == 4
    assert all(abs(float(r[1])) <= 1e-6 for r in rows[1:])
    assert "_dreamloss.csv (3 cases" in capsys.readouterr().out
    with pytest.raises(ImportError, match="--weights"):
        cli_main(["eval-dreamsim", "--original_path", orig, "--edited_path", orig,
                  "--device", "cpu"])
