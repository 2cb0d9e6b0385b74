"""Convert NudeNet's ONNX detector into the safetensors file that
``eval-nudenet --weights`` reads (the port's counterpart of
tools/convert_nudenet.py, which writes the same layout).

    python -m uce_tpu_torch.tools.convert_nudenet --onnx 320n.onnx \\
        --out nudenet_320n.safetensors

It reads the graph initializers with ``utils/onnx_lite.py`` (no ``onnx``
package), keeps the named ``model.*`` parameters, checks their names
against the fused-YOLOv8 layout of ``models/yolo.py`` (an export of another
architecture fails here, not as wrong detections), and writes one file with
the class labels and the input size in its header metadata. The ``onnx``
and ``nudenet`` packages are not used: ``--onnx`` is required.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from uce_tpu_torch.models.hf_loader import save_safetensors
from uce_tpu_torch.models.yolo import NUDENET_LABELS, validate_state
from uce_tpu_torch.utils.onnx_lite import read_initializers


def convert(onnx_path: str, out: str, labels=NUDENET_LABELS) -> dict[str, np.ndarray]:
    """Write ``out`` from ``onnx_path``; returns the parameters written."""
    init = read_initializers(onnx_path)
    # exports may carry anonymous constants (anchors, strides, shapes) that
    # the decode derives itself
    params = {k: np.array(v, np.float32) for k, v in init.items()
              if k.startswith("model.") and v.ndim >= 1}
    validate_state(params)
    nc = int(params["model.22.cv3.2.2.bias"].shape[0])
    if len(labels) != nc:
        raise ValueError(f"label list ({len(labels)}) does not match the head's class "
                         f"count ({nc}): refusing to write a mislabeled checkpoint")
    save_safetensors(params, out, metadata={
        "labels": ",".join(labels), "source": os.path.basename(onnx_path),
        "input_size": "320"})
    return params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--onnx", type=str, required=True,
                    help="path to the detector ONNX (nudenet's 320n.onnx)")
    ap.add_argument("--out", type=str, required=True)
    args = ap.parse_args(argv)
    try:
        params = convert(args.onnx, args.out)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    total = sum(v.size for v in params.values())
    nc = params["model.22.cv3.2.2.bias"].shape[0]
    print(f"wrote {args.out}: {len(params)} tensors, {total / 1e6:.1f} M params, "
          f"{nc} classes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
