"""Whole runs of each cell at tiny widths on the CPU (float32, the kernels'
plain versions): the harness without its look for a chip. A sound run is
correct; a run with the timed path broken underneath is not, for each
fault a cell can have (the cells run on one chip, so there is no exchange
between chips to leave out); the control (the port's W8A8 path) reads far
from the reference. The control at the cells' own sizes runs on the card.
"""

import numpy as np
import pytest
import torch

from perfbench.core import harness
from perfbench.tests import tiny

CELLS = {"sd14-eval-b8": dict(steps=3),
         # batches wait to fill, so every batch has its last half to leave out
         "sd14-serve-poisson": dict(steps=3, drain_s=120, max_wait_ms=2000,
                                    arrivals={"process": "poisson", "rate": 8.0,
                                              "order_seed": 0})}
SECONDS = {"sd14-eval-b8": 0.1, "sd14-serve-poisson": 1.0}


def _run(cell, tmp_path, seed=5, **kw):
    return tiny.run(cell, seed=seed, seconds=SECONDS[cell], workdir=str(tmp_path),
                    **dict(CELLS[cell], **kw))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell, tmp_path):
    out = _run(cell, tmp_path, trace=True)
    assert out["correct"], out["checks"]
    # float32 on both sides: the port's rounding to uint8 alone (1/4 level on average)
    assert out["checks"]["image_gap_worst"]["value"] < 0.3
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert list(out["checks"]) == ["images_checked", "failed", "image_gap_worst"]


def _unchanged_step(monkeypatch):
    from uce_tpu_torch.diffusion import schedulers
    monkeypatch.setattr(schedulers.Plan, "step", lambda self, eps, i, x, carry: (x, carry))


def _patch_images(monkeypatch, change):
    """Change the uint8 images where the pipeline produces them."""
    from uce_tpu_torch.diffusion import pipeline

    made = pipeline.decoded_images

    def changed(*args, **kwargs):
        return change(made(*args, **kwargs))
    monkeypatch.setattr(pipeline, "decoded_images", changed)


def _half_batch(monkeypatch):
    """Only the first half of each batch is computed; the rest repeat it."""
    def half(images):
        n = (len(images) + 1) // 2
        return np.concatenate([images[:n], images[:len(images) - n]])
    _patch_images(monkeypatch, half)


def _altered(monkeypatch):
    _patch_images(monkeypatch, lambda images: np.clip(images.astype(np.int16) + 40, 0, 255)
                  .astype(np.uint8))


def _mixed_up(monkeypatch):
    """Each request of a batch gets its neighbour's image."""
    _patch_images(monkeypatch, lambda images: np.roll(images, 1, axis=0))


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch,
          "altered_answer": _altered, "mixed_up_answers": _mixed_up}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_path_is_not_correct(cell, fault, tmp_path, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(cell, tmp_path)
    assert not out["correct"], out["checks"]


def test_the_control_reads_far_from_the_reference(tmp_path):
    files = tiny.cell_files("sd14-eval-b8", **CELLS["sd14-eval-b8"])
    sound = harness.run_cell(files, 5, 0.1, False, torch.device("cpu"), str(tmp_path), 0.0)
    control = harness.run_cell(files, 5, 0.1, False, torch.device("cpu"), str(tmp_path), 0.0,
                               control=True)
    gap = control["checks"]["image_gap_worst"]["value"]
    assert gap > 0.5 and gap > 3 * sound["checks"]["image_gap_worst"]["value"]


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(w["name"] for w in harness.read_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]))
def test_on_the_card_the_control_fails_and_the_program_passes(cell, card, tmp_path):
    """At the cell's own sizes, one seed: the program within its limit, the
    control past it (perfbench/probe.py reads many seeds)."""
    files = harness.cell_files(harness.read_json(harness.ROOT / "BENCHMARK.json"), cell)
    seconds = 20.0 if "serve" in cell else 5.0
    sound = harness.run_cell(files, 2 ** 31 + 7, seconds, False, card, str(tmp_path), 0.0)
    control = harness.run_cell(files, 2 ** 31 + 7, seconds, False, card, str(tmp_path), 0.0,
                               control=True)
    assert sound["correct"], sound["checks"]
    assert not control["correct"], control["checks"]
