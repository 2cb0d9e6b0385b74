"""Debias-loop telemetry: one CSV row per (iteration, edit concept) with
the observed attribute ratios and the controller's ratio update (the
reference only showed a tqdm postfix). A copy of uce_tpu's
``DebiasTelemetry``."""

from __future__ import annotations

import csv
import os


class DebiasTelemetry:
    """Per-iteration CSV telemetry for the debias loop."""

    def __init__(self, path: str, edit_concepts, debias_concepts):
        self.path = path
        self.edit_concepts = list(edit_concepts)
        self.debias_concepts = list(debias_concepts)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["iteration", "concept"]
                       + [f"observed_{a}" for a in self.debias_concepts]
                       + [f"ratio_{a}" for a in self.debias_concepts])

    def record(self, iteration: int, observed, ratios) -> None:
        with open(self.path, "a", newline="") as f:
            w = csv.writer(f)
            for ci, concept in enumerate(self.edit_concepts):
                w.writerow([iteration, concept]
                           + [f"{v:.4f}" for v in observed[ci]]
                           + [f"{v:.4f}" for v in ratios[ci]])
