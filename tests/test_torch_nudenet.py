"""eval-nudenet on the port against uce_tpu: the port's converter on a
hand-encoded ONNX file against tools/convert_nudenet.py, then the port's
NudeDetector (CPU) against JaxNudeDetector on the same images, and the
labelled CSVs byte for byte, at tiny detector widths (320 input, the
converter's)."""

import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from tests.test_yolo import _onnx_bytes
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.eval import nudenet as jnudenet
from uce_tpu.models import yolo as jyolo
from uce_tpu_torch.eval import nudenet
from uce_tpu_torch.models.hf_loader import read_safetensors, read_safetensors_metadata
from uce_tpu_torch.tools import convert_nudenet

TINY = dict(widths=(4, 8, 16, 16, 32), depths=(1, 1, 1, 1), nc=18)
THRESHOLD = 0.5
# image sizes per case: 320² takes the letterbox's identity resize (the
# canvases equal), 200x320 a real resize (within one uint8 level)
SIZES = {0: (320, 320), 1: (320, 320), 2: (200, 320), 4: (320, 320)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_nudenet")
    onnx = root / "320n.onnx"
    onnx.write_bytes(_onnx_bytes(jyolo.init_yolo_state(seed=5, **TINY)))
    ref, port = root / "ref.safetensors", root / "port.safetensors"
    proc = subprocess.run([sys.executable, "tools/convert_nudenet.py", "--onnx", str(onnx),
                           "--out", str(ref)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert convert_nudenet.main(["--onnx", str(onnx), "--out", str(port)]) == 0
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(6)
    for case, hw in SIZES.items():
        Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(images / f"{case}_0.png")
    prompts = root / "prompts.csv"
    prompts.write_text("case_number,prompt,evaluation_seed,nudity_percentage\n"
                       "0,a,1,12.5\n1,b,2,\n2,c,3,0.0\n3,no image,4,1.0\n4,e,5,33.3\n")
    return {"onnx": onnx, "ref": ref, "port": port, "images": images, "prompts": prompts}


@pytest.fixture(scope="module")
def detectors(files):
    return (jnudenet.JaxNudeDetector(str(files["ref"]), score_threshold=0.0),
            nudenet.NudeDetector(str(files["port"]), score_threshold=0.0, device="cpu"))


def test_converter_writes_uce_tpus_file(files):
    got, want = read_safetensors(str(files["port"])), read_safetensors(str(files["ref"]))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].equal(want[k]), k
    assert (read_safetensors_metadata(str(files["port"]))
            == read_safetensors_metadata(str(files["ref"])))
    bad = files["onnx"].parent / "bad.onnx"
    bad.write_bytes(_onnx_bytes(jyolo.init_yolo_state(seed=5, **dict(TINY, nc=5))))
    assert convert_nudenet.main(["--onnx", str(bad), "--out", str(bad) + ".st"]) == 1


def test_detector_matches_uce_tpus(files, detectors):
    """The raw output on the same canvases (fp32 tolerance), and every
    detection's class, score and box, per image and batched."""
    jdet, det = detectors
    assert det.labels == jdet.labels and det.size == jdet.size == 320
    paths = [str(files["images"] / f"{c}_0.png") for c in SIZES]
    canvases = np.stack([jyolo.letterbox(np.asarray(Image.open(p).convert("RGB")), 320)[0]
                         for p in paths])
    np.testing.assert_allclose(det.raw(canvases), np.asarray(jdet._infer(canvases)),
                               rtol=1e-4, atol=1e-4)
    got, want = det.detect_batch(paths), jdet.detect_batch(paths)
    for g, single in zip(got, [det.detect(p) for p in paths]):  # batch 4 against 1
        assert [d["class"] for d in g] == [d["class"] for d in single]
        np.testing.assert_allclose([d["score"] for d in g], [d["score"] for d in single],
                                   rtol=1e-5)
    for case, g, w in zip(SIZES, got, want):
        assert [d["class"] for d in g] == [d["class"] for d in w], case
        np.testing.assert_allclose([d["score"] for d in g], [d["score"] for d in w],
                                   atol=1e-4 if SIZES[case] == (320, 320) else 2e-2)
        if SIZES[case] == (320, 320):
            assert [d["box"] for d in g] == [d["box"] for d in w]


def test_label_folder_csv_equals_uce_tpus(files, detectors, tmp_path):
    """The CSV written by the port equals uce_tpu's pandas one byte for byte
    (a missing image, an NA cell, the strict threshold); no detection of
    either side scores within their difference of the threshold."""
    jdet, det = detectors
    paths = [str(files["images"] / f"{c}_0.png") for c in SIZES]
    scores = [(d["score"], w["score"]) for g, wl in zip(det.detect_batch(paths),
                                                       jdet.detect_batch(paths))
              for d, w in zip(g, wl)]
    margin = min(abs(s - THRESHOLD) for s, _ in scores)
    assert margin > max(abs(s - w) for s, w in scores), margin
    got, want = tmp_path / "port.csv", tmp_path / "ref.csv"
    result = nudenet.label_folder(det, str(files["images"]), str(files["prompts"]),
                                  save_path=str(got), threshold=THRESHOLD)
    df = jnudenet.label_folder(jdet.detect, str(files["images"]), str(files["prompts"]),
                               save_path=str(want), threshold=THRESHOLD)
    assert got.read_text() == want.read_text()
    labels = [r[-1] for r in result[1]]
    assert labels == df["NudeNet_label"].tolist()
    assert labels[3] == "" and any(labels) and "-" in "".join(labels)


def test_label_folder_reads_both_schemas(files, tmp_path):
    """A nudenet 2.x detector ({label, probability}) and a 3.x one, as
    per-path callables, give uce_tpu's CSV."""
    def v2(path):
        return [{"label": "FACE_MALE", "probability": 0.7}, {"label": "FEET_COVERED",
                                                             "probability": 0.3}]

    def v3(path):
        return [{"class": "BELLY_EXPOSED", "score": 0.3}, {"class": "FACE_FEMALE",
                                                          "score": 0.3 + 1e-9}]

    for detect in (v2, v3):
        got, want = tmp_path / "port.csv", tmp_path / "ref.csv"
        nudenet.label_folder(detect, str(files["images"]), str(files["prompts"]),
                             save_path=str(got), threshold=0.3, num_samples=2)
        jnudenet.label_folder(detect, str(files["images"]), str(files["prompts"]),
                              save_path=str(want), threshold=0.3, num_samples=2)
        assert got.read_text() == want.read_text()


def test_cli_default_name_and_jax_weights_alias(files, detectors, capsys):
    from uce_tpu_torch.cli.main import main as cli_main

    folder = files["images"]
    rc = cli_main(["eval-nudenet", "--image_folder", str(folder) + "/", "--prompts_path",
                   str(files["prompts"]), "--jax_weights", str(files["port"]),
                   "--threshold", str(THRESHOLD), "--device", "cpu"])
    assert rc == 0
    out = folder / f"images_NudeClasses_{int(THRESHOLD * 100)}.csv"
    assert f"wrote {str(folder)}/images_NudeClasses_50.csv" in capsys.readouterr().out
    want = nudenet.label_folder(detectors[1], str(folder), str(files["prompts"]),
                                threshold=THRESHOLD)
    assert [r[-1] for r in want[1]] == [line.rsplit(",", 1)[-1] for line in
                                        out.read_text().splitlines()[1:]]
    out.unlink()
    with pytest.raises(ImportError, match="--weights"):
        cli_main(["eval-nudenet", "--image_folder", str(folder), "--device", "cpu"])
