"""``info``: a report of the environment the port runs in (versions, CUDA
devices, nvcc, which kernel libraries are built for the current sources,
and where the eval weights come from). It builds nothing and needs no
card: on a machine without one it says so and exits 0."""

from __future__ import annotations

import shutil
import sys

# the eval weight files that a converter writes (the other eval commands
# read torchvision/lpips state dicts as they are)
CONVERTED_WEIGHTS = (
    ("eval-nudenet --weights", "nudenet_320n.safetensors",
     "python -m uce_tpu_torch.tools.convert_nudenet --onnx 320n.onnx --out FILE "
     "(or tools/convert_nudenet.py)"),
    ("eval-dreamsim --weights", "dreamsim_ensemble.safetensors",
     "tools/convert_dreamsim.py, where the dreamsim package is installed"),
)


def register_cli(sub) -> None:
    p = sub.add_parser("info", help="environment and capability diagnostics")
    p.add_argument("--device", type=str, default=None,
                   help="accepted as uce takes it; info reports every device")
    p.set_defaults(func=_cmd)


def kernel_libraries() -> list[tuple[str, str | None]]:
    """(library, path of its build for the current sources or None) for each
    csrc/*.cu (one library per source)."""
    from uce_tpu_torch.ops.kernels._build import CSRC, library_path

    out = []
    for src in sorted(CSRC.glob("*.cu")):
        path = library_path(src.stem, (src.name,))
        out.append((src.stem, str(path) if path.exists() else None))
    return out


def _cmd(args) -> int:
    import torch

    import uce_tpu_torch
    from uce_tpu_torch.ops.kernels._build import BUILD_ROOT

    print(f"uce-tpu-torch {uce_tpu_torch.__version__}  python {sys.version.split()[0]}")
    print(f"torch {torch.__version__}  CUDA build {torch.version.cuda}")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        print(f"CUDA available: {n} device(s)")
        for i in range(n):
            prop = torch.cuda.get_device_properties(i)
            print(f"  cuda:{i} {prop.name}  {prop.total_memory / 2 ** 30:.1f} GiB  "
                  f"sm_{prop.major}{prop.minor}  {prop.multi_processor_count} SMs")
    else:
        print("CUDA available: no (every command needs --device cpu here)")
    nvcc = shutil.which("nvcc")
    print(f"nvcc: {nvcc or 'not on PATH'}")
    print(f"kernel libraries (built for the current sources under {BUILD_ROOT}; "
          "a missing one is built at first use):")
    for name, path in kernel_libraries():
        print(f"  {name}: {'built ' + path if path else 'not built'}")
    print("converted eval weights:")
    for command, name, how in CONVERTED_WEIGHTS:
        print(f"  {command} {name}: written by {how}")
    return 0
