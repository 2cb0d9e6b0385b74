"""The comparison that decides ``correct``: each checked answer of the
system against the reference's answer to the same job, and every request
answered.

An image's gap is the mean absolute difference of its uint8 values from
the reference's image in the same levels (not rounded); the worst checked
image is held to the cell's limit (``limits/<cell>.json``, with the
readings it was set from).
"""

from __future__ import annotations

import numpy as np


def image_gaps(got, want) -> list[float]:
    return [float(np.abs(g.astype(np.float32) - w).mean()) for g, w in zip(got, want)]


def checks(gaps: list[float], failed: int, answered: int, limits: dict) -> dict:
    """``answered`` answers came back; ``limits["checked"]`` of them (all,
    where fewer came) were checked, with these ``gaps``."""
    worst = max(gaps) if gaps else None
    due = min(limits["checked"], answered)
    return {"images_checked": {"value": len(gaps), "limit": due,
                               "ok": len(gaps) == due >= 1},
            "failed": {"value": failed, "limit": 0, "ok": failed == 0},
            "image_gap_worst": {"value": worst, "limit": limits["image_gap"],
                                "ok": worst is not None and worst <= limits["image_gap"]}}
