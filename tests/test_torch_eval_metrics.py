"""The port's eval metrics (eval-lpips, eval-styleloss, eval-imageclassify,
eval-clip-score) against uce_tpu's on the same PNG folders and weight
files: the CSVs' columns in order, their text cells, and their numbers
within fp32 tolerance; LPIPS of a folder against itself is exactly 0."""

import csv

import numpy as np
import pytest
import torch

from tests.snapshot import make_clip_snapshot
from uce_tpu.utils.imaging import save_png as pil_save_png
from uce_tpu_torch.eval import clip_score, imageclassify, lpips, styleloss, table
from uce_tpu_torch.models import vision_backbones as tvb
from uce_tpu_torch.utils.imaging import case_image_path, save_png

# fp32 forwards of the same weights in two frameworks (conv sums in another
# order): the cross-impl bars of tests/test_vision_cross_impl.py
RTOL, ATOL = 1e-4, 1e-6


def _smooth(rng, h, w):
    base = rng.integers(0, 256, (4, 4, 3)).astype(np.float32)
    ys, xs = np.linspace(0, 3, h), np.linspace(0, 3, w)
    y0, x0 = np.minimum(ys.astype(int), 2), np.minimum(xs.astype(int), 2)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    img = (base[y0][:, x0] * (1 - fy) * (1 - fx) + base[y0 + 1][:, x0] * fy * (1 - fx)
           + base[y0][:, x0 + 1] * (1 - fy) * fx + base[y0 + 1][:, x0 + 1] * fy * fx)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """Two folders of case images (cases 0, 2, 5, two images each; the
    edited folder lacks 5_1 and has a stray file), PIL-written (uce_tpu's
    writer) in one and port-written in the other; a prompts CSV with a
    case without images and label_idx; weights as .pth files."""
    root = tmp_path_factory.mktemp("torch_eval_metrics")
    rng = np.random.default_rng(0)
    orig, edit = root / "original", root / "edited"
    for case in (0, 2, 5):
        for num in (0, 1):
            pil_save_png(_smooth(rng, 48, 48), case_image_path(str(orig), case, num))
            if (case, num) != (5, 1):
                save_png(_smooth(rng, 48, 48), case_image_path(str(edit), case, num))
    save_png(np.zeros((8, 8, 3), np.uint8), str(edit / "x_notes.png"))
    prompts = root / "prompts.csv"
    with open(prompts, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed", "label_idx"])
        w.writerows([[5, "a church", 3, 497], [0, "a dog", 1, 207], [9, "no images", 4, 1],
                     [2, "NA", 2, 0]])
    wrng = np.random.default_rng(1)
    weights = {}
    for name, sd in (("lpips", lpips.init_lpips_state_dict(wrng)),
                     ("vgg", {k: v for k, v in tvb.init_vgg19_state_dict(wrng).items()
                              if int(k.split(".")[1]) <= 10}),
                     ("resnet", tvb.init_resnet50_state_dict(wrng))):
        weights[name] = str(root / f"{name}.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, weights[name])
    return str(orig), str(edit), str(prompts), weights


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _same_csv(got_path, want_path, float_cols):
    got, want = _read(got_path), _read(want_path)
    assert got[0] == want[0]  # the columns, in order
    assert len(got) == len(want)
    for g_row, w_row in zip(got[1:], want[1:]):
        for name, g, w in zip(want[0], g_row, w_row):
            if name in float_cols and w != "":
                np.testing.assert_allclose(float(g), float(w), rtol=RTOL, atol=ATOL,
                                           err_msg=name)
            else:
                assert g == w, (name, g, w)
    return got


@pytest.mark.parametrize("with_prompts", [False, True])
def test_lpips_csv_matches_uce_tpu(rig, tmp_path, with_prompts):
    from uce_tpu.eval import lpips as jlpips

    orig, edit, prompts, weights = rig
    kw = dict(prompts_path=prompts if with_prompts else None)
    jlpips.eval_folders(jlpips.load_lpips_weights(weights["lpips"]), orig, edit,
                        save_path=str(tmp_path / "want.csv"), **kw)
    params = lpips.load_lpips_weights(weights["lpips"], device="cpu")
    lpips.eval_folders(params, orig, edit, save_path=str(tmp_path / "got.csv"),
                       device="cpu", **kw)
    got = _same_csv(tmp_path / "got.csv", tmp_path / "want.csv", {"lpips_loss"})
    assert len(got) == (5 if with_prompts else 4)
    header, rows = lpips.eval_folders(params, orig, orig, device="cpu")
    assert header == ["case_number", "lpips_loss"]
    assert [r[1] for r in rows] == [0.0, 0.0, 0.0]


def test_lpips_weight_layouts(rig, tmp_path):
    """``lins.{i}`` keys and a bare AlexNet state dict (no ``net.``) load to
    the same params, from .pth and from .safetensors."""
    from uce_tpu_torch.models.hf_loader import save_safetensors

    sd = torch.load(rig[3]["lpips"], weights_only=True)
    other = {(k[len("net."):] if k.startswith("net.") else k.replace("lin", "lins.")): v
             for k, v in sd.items()}
    path = str(tmp_path / "lpips.safetensors")
    save_safetensors(other, path)
    a = lpips.load_lpips_weights(rig[3]["lpips"], device="cpu")
    b = lpips.load_lpips_weights(path, device="cpu")
    for x, y in zip(a["lins"], b["lins"]):
        assert torch.equal(x, y)
    assert torch.equal(a["alex"]["conv4"]["weight"], b["alex"]["conv4"]["weight"])
    save_safetensors({k: v for k, v in other.items() if not k.startswith("lins.0")}, path)
    with pytest.raises(KeyError, match="lin0"):
        lpips.load_lpips_weights(path, device="cpu")


def test_styleloss_csv_matches_uce_tpu(rig, tmp_path):
    from uce_tpu.eval import styleloss as jstyle

    orig, edit, prompts, weights = rig
    jstyle.eval_folders(jstyle.load_vgg_weights(weights["vgg"]), orig, edit,
                        prompts_path=prompts, save_path=str(tmp_path / "want.csv"),
                        image_size=64)
    params = styleloss.load_vgg_weights(weights["vgg"], device="cpu")
    header, _ = styleloss.eval_folders(params, orig, edit, prompts_path=prompts,
                                       save_path=str(tmp_path / "got.csv"),
                                       image_size=64, device="cpu")
    assert header[-3:] == ["style_loss", "content_loss", "total_loss"]
    _same_csv(tmp_path / "got.csv", tmp_path / "want.csv",
              {"style_loss", "content_loss", "total_loss"})


def test_imageclassify_csv_matches_uce_tpu(rig, tmp_path):
    """The inner merge keeps the prompts' row order (5, 0, 2; 9 has no
    images), one row per image; ``correct`` from label_idx; category names
    from a labels file."""
    from uce_tpu.eval import imageclassify as jic

    _, edit, prompts, weights = rig
    labels = [f"class {i}" for i in range(1000)]
    kw = dict(prompts_path=prompts, topk=3, categories=labels)
    # uce_tpu in one batch (one jit compile), the port in batches of 2
    jic.classify_folder(jic.load_resnet_weights(weights["resnet"]), edit,
                        save_path=str(tmp_path / "want.csv"), batch_size=16, **kw)
    params = imageclassify.load_resnet_weights(weights["resnet"], device="cpu")
    header, rows = imageclassify.classify_folder(
        params, edit, save_path=str(tmp_path / "got.csv"), batch_size=2, device="cpu",
        **kw)
    got = _same_csv(tmp_path / "got.csv", tmp_path / "want.csv",
                    {f"scores_top{i}" for i in (1, 2, 3)})
    assert header[-1] == "correct" and len(rows) == 5
    assert [r[0] for r in got[1:]] == ["5", "0", "0", "2", "2"]
    no_prompts = imageclassify.classify_folder(params, edit, topk=2, device="cpu")
    assert no_prompts[0] == ["case_number", "num", "category_top1", "index_top1",
                             "scores_top1", "category_top2", "index_top2", "scores_top2"]


def test_clip_score_matches_uce_tpu(rig, tmp_path):
    from uce_tpu.eval.clip_score import mean_clip_score as jscore
    from uce_tpu.models.clip import CLIPModel as JaxClip
    from uce_tpu_torch.models.clip import CLIPModel

    orig, _, prompts, _ = rig
    snap = make_clip_snapshot(tmp_path / "clip")
    want = jscore(JaxClip.from_pretrained(snap), orig, prompts, num_samples=3,
                  batch_size=8)
    got = clip_score.mean_clip_score(CLIPModel.from_pretrained(snap, device="cpu"), orig,
                                     prompts, num_samples=3, batch_size=4)
    assert got == pytest.approx(want, rel=1e-5)
    with pytest.raises(FileNotFoundError, match="no scored images"):
        clip_score.mean_clip_score(None, str(tmp_path), prompts)


def test_table_merge_matches_pandas():
    import pandas as pd

    left = (["case_number", "x"], [[3, "a"], [1, "b"], [7, "c"], [1, "d"]])
    right = (["case_number", "n", "v"], [[1, 0, 0.5], [3, 1, 0.25], [1, 2, 1.5]])
    for how in ("left", "inner"):
        want = pd.DataFrame(left[1], columns=left[0]).merge(
            pd.DataFrame(right[1], columns=right[0]), on="case_number", how=how)
        header, rows = table.merge(left, right, "case_number", how)
        assert header == list(want.columns)
        assert [[table.cell(v) for v in r] for r in rows] == [
            ["" if pd.isna(v) else table.cell(v) for v in r]
            for r in want.astype(object).values.tolist()]
