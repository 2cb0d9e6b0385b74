"""Run one benchmark cell once and print its result as the last line:

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds the port (``uce_tpu_torch``). The
kernel caches go to fixed directories inside the checkout, so only the
first run of a checkout builds: the port's own ``build/uce_tpu_torch/``,
and ``build/perfbench/`` for Triton, torch extensions and the CUDA JIT.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))

from perfbench.core.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
