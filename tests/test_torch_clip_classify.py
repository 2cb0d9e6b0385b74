"""``eval-clip-classify`` (uce_tpu_torch/eval/clip_classify.py) against
uce_tpu's pandas code: the same CSV, byte for byte, from a folder of PNGs
classified by the tiny CLIP snapshot of tests/snapshot.py, with and without
a prompts CSV to merge into."""

import csv

import numpy as np
import pytest

from tests.snapshot import make_clip_snapshot
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.eval import clip_classify
from uce_tpu_torch.utils.imaging import case_image_path, save_png

ATTRIBUTES = ["nfu", "nxy", "wao"]


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_clip_classify")
    clip_snap = make_clip_snapshot(root / "clip")
    folder = root / "images"
    rng = np.random.default_rng(0)
    # cases 0, 2, 3 and 10 with 1-3 images each (smooth random images, so
    # the tiny CLIP's votes vary); case 5 has none; a stray file is skipped
    for case, n in ((0, 3), (2, 2), (3, 1), (10, 3)):
        for num in range(n):
            base = rng.integers(0, 256, (4, 4, 3)).astype(np.uint8)
            save_png(np.kron(base, np.ones((8, 8, 1), np.uint8)),
                     case_image_path(str(folder), case, num))
    (folder / "notes.png").write_bytes(b"")
    prompts = root / "prompts.csv"
    with open(prompts, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed", "scale", "note"])
        w.writerows([[0, "a doctor, smiling", 11, 7.5, "NA"], [2, 'say "hi"', 12, "", "x"],
                     [3, "nan", 13, 1.25, ""], [5, "no images", 14, 3, "y"],
                     [10, "a nurse", 15, 2, "z"]])
    return clip_snap, str(folder), str(prompts)


@pytest.mark.parametrize("with_prompts", [False, True])
def test_csv_matches_uce_tpu(rig, tmp_path, with_prompts):
    from uce_tpu.eval.clip_classify import classify_folder as jclassify
    from uce_tpu.models.clip import CLIPModel as JaxClip
    from uce_tpu_torch.models.clip import CLIPModel

    clip_snap, folder, prompts = rig
    kw = dict(prompts_path=prompts if with_prompts else None, from_case=0,
              till_case=10, batch_size=4)
    jclassify(JaxClip.from_pretrained(clip_snap), folder, ATTRIBUTES,
              save_path=str(tmp_path / "want.csv"), **kw)
    header, rows = clip_classify.classify_folder(
        CLIPModel.from_pretrained(clip_snap, device="cpu"), folder, ATTRIBUTES,
        save_path=str(tmp_path / "got.csv"), **kw)
    want = (tmp_path / "want.csv").read_text()
    assert (tmp_path / "got.csv").read_text() == want
    assert header[-3:] == ["nfu_bias", "nxy_bias", "wao_bias"]
    assert len(rows) == (5 if with_prompts else 4)
    for r in rows:
        if r[-1] is not None:
            assert sum(r[-3:]) == pytest.approx(1.0)  # one vote per image


def test_cli_writes_the_csv(rig, tmp_path, capsys):
    from uce_tpu_torch.cli.main import main as cli_main

    clip_snap, folder, _ = rig
    out = tmp_path / "out.csv"
    assert cli_main(["eval-clip-classify", "--image_folder", folder, "--attributes",
                     "nfu, nxy", "--clip_model_id", clip_snap, "--save_path", str(out),
                     "--till_case", "3", "--device", "cpu"]) == 0
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["case_number", "nfu_bias", "nxy_bias"]
    assert [r[0] for r in rows[1:]] == ["0", "2", "3"]
    assert all(float(r[1]) + float(r[2]) == 1.0 for r in rows[1:])
    assert "wrote" in capsys.readouterr().out


def test_empty_folder_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no case images"):
        clip_classify.classify_folder(None, str(tmp_path), ["a", "b"])
