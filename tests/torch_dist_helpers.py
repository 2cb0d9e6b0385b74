"""Functions that the spawned ranks of tests/test_torch_parallel*.py run
(``workers.run`` pickles them by reference, so a rank imports this module,
never a test module: no rank imports jax), and what those tests share."""

import sys

from uce_tpu_torch.ops import quant
from uce_tpu_torch.parallel import workers


def row_qlinear(params, spec, batch):
    """A row-parallel W8A8 projection on each rank: its slice of the input
    width (``spec["runs"]``, per model rank) and of the int8 payload; the
    activation's int8 payload and scale that the rank quantizes with, and
    the projection's output."""
    s, e = spec["runs"][workers.tp_rank()]
    x = batch["x"][..., s:e]
    qw = {quant.QKEY: batch["q"][:, s:e], "scale": batch["scale"]}
    xq, xs = quant._quant_act(x, (-1,), workers.model_all_reduce)
    y = quant.qlinear(x, qw, batch["bias"], reduce=workers.model_all_reduce)
    return xq, xs, y


def imports_jax(params, spec, batch):
    """Whether this rank's process has imported jax."""
    return "jax" in sys.modules


def fail_off_controller(params, spec, batch):
    """Raises on every rank but the controller, which then waits in a
    model-group sum for them."""
    import torch

    if workers.session().rank != 0:
        raise RuntimeError("a rank fails")
    return workers.model_all_reduce(torch.ones(1))


def param_bytes(params) -> int:
    """Bytes of the tensors in flat params (quantized weights included)."""
    return sum(t.numel() * t.element_size()
               for v in params.values() for t in (v.values() if isinstance(v, dict) else (v,)))
