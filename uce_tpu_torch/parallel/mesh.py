"""Device mesh and tensor-parallel layouts of the port (uce_tpu/parallel/mesh.py).

A mesh is ``n_data x n_model`` ranks, one process each (``workers.py``), in
uce_tpu's ``reshape(n_data, n_model)`` order: rank ``d * n_model + m``
holds data slice ``d`` of the image batch and model shard ``m`` of the
denoiser. The axes are uce_tpu's:

  * ``data``  -- prompts / images: each data group denoises and decodes
    its slice of the batch, with no collective;
  * ``model`` -- tensor parallelism over attention heads and FFN columns
    (HiDream's routed experts: expert parallelism), one ``all_reduce``
    over the group at each row-parallel projection.

Backends are chosen by a written rule, never after a failure: one CUDA
device per rank takes NCCL; CPU ranks, and two or more ranks on one CUDA
device (only an explicit ``devices`` list asks for that), take gloo.

The shard maps give, for each key of a flat diffusers state dict, its
``Split`` (the runs of one dim each model rank holds), its ``Owner`` (the
one rank that holds a routed expert whole) or ``None`` (replicated). A key
is sharded exactly where uce_tpu's ``spec_for`` shards its leaf; a
replicated vector that meets a sharded activation (the UNet's GEGLU bias,
HiDream's q/k RMSNorm scales) is sliced by the forward itself. Heads are
sharded whole; a head count that the model axis does not divide splits
unevenly (SD 2.1's 5 heads at ``model=2``: 3 + 2), as XLA's resharding
lets uce_tpu run it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data x n_model`` ranks; ``devices[rank]`` is rank's device.
    ``store_dir`` is where the process group's rendezvous file is made
    (a new temporary directory in it; the system's by default)."""

    n_data: int
    n_model: int
    devices: tuple
    store_dir: str | None = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    def coords(self, rank: int) -> tuple[int, int]:
        """(data index, model index) of ``rank``."""
        return divmod(rank, self.n_model)

    @property
    def backend(self) -> str:
        return backend_for(self.devices)


def backend_for(devices) -> str:
    """NCCL for one CUDA device per rank; gloo for CPU ranks and for ranks
    that share a CUDA device."""
    kinds = {torch.device(d).type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds == {"cuda"}:
        return "nccl" if len(set(devices)) == len(devices) else "gloo"
    raise ValueError(f"a mesh's devices must be all CPU or all CUDA, got {sorted(kinds)}")


def canonical_device(d) -> torch.device:
    """``d`` as a torch.device, a bare ``cuda`` as ``cuda:0``."""
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def visible_devices(kind="cuda", count: int = 1) -> list[torch.device]:
    """Every visible CUDA device, or ``count`` CPU ranks (the CPU has as
    many as a mesh asks for)."""
    if torch.device(kind).type == "cuda":
        n = torch.cuda.device_count()
        if not n:
            raise RuntimeError("a CUDA mesh was asked for but torch finds no CUDA "
                               "device (pass devices='cpu' for CPU ranks)")
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")] * count


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None,
              store_dir: str | None = None) -> Mesh:
    """An ``n_data x n_model`` mesh over ``devices``: a list (ranks in
    order; a CUDA device listed twice puts two ranks on it), or a device
    kind: ``"cuda"`` (the default) for every visible card, ``"cpu"`` for as
    many CPU ranks as the shape asks (``n_data=None`` means 1 there).
    ``n_data=None`` takes all remaining devices."""
    if n_model < 1:
        raise ValueError("--mesh model=M must be >= 1 (1 = no tensor parallelism)")
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = visible_devices(devices or "cuda", (n_data or 1) * n_model)
    devices = tuple(canonical_device(d) for d in devices)
    n = len(devices)
    if n_data is None:
        n_data = n // n_model
    if n_data < 1 or n_data * n_model != n:
        raise ValueError(f"{n_data}x{n_model} mesh != {n} devices")
    backend_for(devices)
    return Mesh(n_data, n_model, devices, store_dir)


def mesh_from_spec(spec: str, devices=None, store_dir: str | None = None) -> Mesh:
    """Parse the CLI mesh spec ``data=N[,model=M]`` into a Mesh.

    ``data=0`` (or omitting data) means "all remaining devices": e.g. on
    an 8-device host ``model=2`` gives a 4x2 mesh."""
    n_data: int | None = None
    n_model = 1
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if key == "data":
            if int(val) < 0:
                raise ValueError("--mesh data=N must be >= 0 (0 = all remaining devices)")
            n_data = int(val) or None
        elif key == "model":
            n_model = int(val)
            if n_model < 1:
                raise ValueError("--mesh model=M must be >= 1 (1 = no tensor parallelism)")
        else:
            raise ValueError(f"unknown --mesh key {key!r} (expected data=N, model=M)")
    return make_mesh(n_data=n_data, n_model=n_model, devices=devices, store_dir=store_dir)


def check_rank0(mesh: Mesh, device) -> None:
    """Rank 0 is the calling process: its device must be the pipeline's."""
    if mesh.devices[0] != canonical_device(device):
        raise ValueError(f"the mesh's rank 0 runs on {mesh.devices[0]}, the "
                         f"pipeline's device is {device}")


def require_data_axis(mesh) -> None:
    """Generation shards the batch over a 'data' axis; a mesh without one
    is refused before any weight is laid out."""
    if "data" not in dict(mesh.shape):
        raise ValueError("mesh needs a 'data' axis (make_mesh/mesh_from_spec create "
                         "one; for pure tensor parallelism use data=1)")


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------

def pad_batch(x: torch.Tensor, n_data: int, axis: int = 0) -> torch.Tensor:
    """Pad ``axis`` to a multiple of ``n_data`` by repeating the last slice
    (the padding rows are computed and discarded by the caller)."""
    size = x.shape[axis]
    pad = (-size) % n_data
    if not pad:
        return x
    return torch.cat([x] + [x.narrow(axis, size - 1, 1)] * pad, dim=axis)


def pad_batch_branched(x: torch.Tensor, n_data: int, n_branches: int,
                       axis: int = 0) -> torch.Tensor:
    """``pad_batch`` per guidance branch: ``x`` stacks ``n_branches``
    branches along ``axis`` ([uncond; cond; ...]); each pads on its own, so
    the padding lands inside every branch and the stacking survives the
    shard."""
    if n_branches == 1:
        return pad_batch(x, n_data, axis)
    return torch.cat([pad_batch(p, n_data, axis) for p in x.chunk(n_branches, dim=axis)],
                     dim=axis)


def data_shard(x: torch.Tensor, n_data: int, index: int, n_branches: int = 1,
               axis: int = 0) -> torch.Tensor:
    """Data group ``index``'s rows of a batch padded by ``pad_batch_branched``:
    its contiguous slice of every branch, the branches stacked as before."""
    parts = []
    for branch in x.chunk(n_branches, dim=axis):
        rows = branch.shape[axis] // n_data
        parts.append(branch.narrow(axis, index * rows, rows))
    return parts[0] if n_branches == 1 else torch.cat(parts, dim=axis)


# ---------------------------------------------------------------------------
# tensor-parallel layouts
# ---------------------------------------------------------------------------

def split_range(n: int, rank: int, size: int) -> tuple[int, int]:
    """Rank's [start, stop) of ``n`` items split over ``size`` ranks in
    contiguous blocks, the first ``n % size`` one larger (``array_split``)."""
    q, r = divmod(n, size)
    start = rank * q + min(rank, r)
    return start, start + q + (rank < r)


@dataclasses.dataclass(frozen=True)
class Split:
    """Dim ``dim`` of a weight (0: output rows, with its bias; 1: input
    columns) is sharded: model rank r holds the runs ``runs[r]`` of it,
    concatenated in that order."""

    dim: int
    runs: tuple


@dataclasses.dataclass(frozen=True)
class Owner:
    """The whole tensor lives on model rank ``rank`` alone (a routed expert)."""

    rank: int


def _runs(n: int, size: int, unit: int = 1, offsets=(0,)) -> tuple:
    """Per rank, its block of ``n`` units of ``unit`` rows at each offset."""
    out = []
    for r in range(size):
        s, e = split_range(n, r, size)
        out.append(tuple((o + s * unit, o + e * unit) for o in offsets))
    return tuple(out)


def _check_heads(heads: int, size: int, what: str) -> None:
    if heads < size:
        raise ValueError(f"{what}: model={size} exceeds its {heads} attention heads")


def unet_heads(key: str, config) -> int:
    """The head count of the attention block that ``key`` belongs to."""
    n = len(config.block_out_channels)
    m = re.match(r"(down_blocks|up_blocks)\.(\d+)\.", key)
    if m is None:  # the mid block
        return config.heads(n - 1)
    bi = int(m.group(2))
    return config.heads(bi if m.group(1) == "down_blocks" else n - 1 - bi)


def unet_layout(key: str, shape: tuple, config, n_model: int):
    """uce_tpu's UNet rules on a flat key: 2-D attention ``to_q/to_k/to_v``
    weights column-parallel by whole heads, ``to_out.0`` row-parallel; the
    GEGLU ``ff.net.0.proj`` column-parallel with each rank's rows taken
    from both halves ``[h | gate]`` alike, ``ff.net.2`` row-parallel. Convs,
    norms, biases and time embeddings are replicated."""
    parts = key.split(".")
    if n_model == 1 or parts[-1] != "weight" or len(shape) != 2:
        return None
    if any(p in ("to_q", "to_k", "to_v", "to_out") for p in parts):
        heads = unet_heads(key, config)
        _check_heads(heads, n_model, key)
        dim = 1 if "to_out" in parts else 0
        return Split(dim, _runs(heads, n_model, shape[dim] // heads))
    if "ff" in parts:
        if "proj" in parts:
            hidden = shape[0] // 2
            return Split(0, _runs(hidden, n_model, offsets=(0, hidden)))
        return Split(1, _runs(shape[1], n_model))
    return None


_FLUX_COL = ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
             "proj_mlp")
_FLUX_ROW = ("to_out", "to_add_out", "proj_out")


def flux_layout(key: str, shape: tuple, config, n_model: int):
    """uce_tpu's FLUX rules on a flat key (blocks only): q/k/v and the
    context ``add_*_proj`` column-parallel by heads (weight and bias), the
    ``ff``/``ff_context`` ``net.0.proj`` and ``proj_mlp`` column-parallel;
    ``to_out.0``, ``to_add_out``, ``net.2`` row-parallel and the single
    blocks' ``proj_out`` row-parallel over ``cat([attn, mlp])``: rank r's
    input rows are its heads' attention columns, then its MLP block (their
    biases replicated, added once after the reduce). AdaLN, norms and the
    embedders are replicated."""
    parts = key.split(".")
    if n_model == 1 or parts[0] not in ("transformer_blocks", "single_transformer_blocks"):
        return None
    rest = parts[2:]
    if any(p.startswith("norm") for p in rest):
        return None
    heads, dh = config.num_attention_heads, config.attention_head_dim
    ff = "ff" in rest or "ff_context" in rest
    if any(p in _FLUX_COL for p in rest) or (ff and "proj" in rest):
        if ff or "proj_mlp" in rest:
            return Split(0, _runs(shape[0], n_model))
        _check_heads(heads, n_model, key)
        return Split(0, _runs(heads, n_model, dh))
    if any(p in _FLUX_ROW for p in rest) or (ff and "2" in rest):
        if rest[-1] != "weight":
            return None
        if ff:
            return Split(1, _runs(shape[1], n_model))
        _check_heads(heads, n_model, key)
        attn = _runs(heads, n_model, dh)
        if "proj_out" not in rest:
            return Split(1, attn)
        inner = heads * dh
        mlp = _runs(shape[1] - inner, n_model, offsets=(inner,))
        return Split(1, tuple(a + m for a, m in zip(attn, mlp)))
    return None


_HIDREAM_COL = ("to_q", "to_k", "to_v", "to_q_t", "to_k_t", "to_v_t")
_HIDREAM_ROW = ("to_out", "to_out_t")


def expert_owner(expert: int, n_experts: int, n_model: int) -> int:
    """The model rank that holds routed expert ``expert`` (contiguous blocks
    of experts per rank)."""
    return next(r for r in range(n_model)
                if split_range(n_experts, r, n_model)[1] > expert)


def hidream_layout(key: str, shape: tuple, config, n_model: int):
    """uce_tpu's HiDream rules on a flat key (blocks only): attention q/k/v
    of both streams column-parallel by heads (weight and bias), ``to_out``
    and ``to_out_t`` row-parallel; SwiGLU ``w1``/``w3`` column-parallel,
    ``w2`` row-parallel (shared experts, the text FFN); each routed expert
    whole on one rank (expert parallelism). The q/k RMSNorm scales, AdaLN
    and the MoE gate are replicated."""
    parts = key.split(".")
    if n_model == 1 or parts[0] not in ("double_stream_blocks", "single_stream_blocks"):
        return None
    rest = parts[2:]
    if any(p.startswith(("q_rms", "k_rms", "adaLN")) for p in rest):
        return None
    if "experts" in rest:
        expert = int(rest[rest.index("experts") + 1])
        return Owner(expert_owner(expert, config.num_routed_experts, n_model))
    heads, dh = config.num_attention_heads, config.attention_head_dim
    weight = rest[-1] == "weight"
    if any(p in _HIDREAM_COL for p in rest):
        _check_heads(heads, n_model, key)
        return Split(0, _runs(heads, n_model, dh))
    if "w1" in rest or "w3" in rest:
        return Split(0, _runs(shape[0], n_model))
    if any(p in _HIDREAM_ROW for p in rest):
        _check_heads(heads, n_model, key)
        return Split(1, _runs(heads, n_model, dh)) if weight else None
    if "w2" in rest:
        return Split(1, _runs(shape[1], n_model)) if weight else None
    return None


LAYOUTS = {"unet": unet_layout, "flux": flux_layout, "hidream": hidream_layout}


def shape_of(v) -> tuple:
    """A float weight's shape, or a quantized weight's payload's."""
    if isinstance(v, Mapping):
        return tuple(next(t for k, t in v.items() if k != "scale").shape)
    return tuple(v.shape)


def layout_fn(family: str, config, n_model: int) -> Callable:
    """``fn(key, value) -> Split | Owner | None`` for ``family``'s params."""
    rule = LAYOUTS[family]
    return lambda key, v: rule(key, shape_of(v), config, n_model)


def _take(t: torch.Tensor, dim: int, runs) -> torch.Tensor:
    """A new tensor of ``t``'s runs along ``dim`` (never a view: the full
    tensor can be freed)."""
    parts = [t.narrow(dim, s, e - s) for s, e in runs]
    return torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0].clone()


def shard_value(v, layout, rank: int):
    """Model rank ``rank``'s part of one value under ``layout`` (None where
    it holds none of it). A quantized weight's payload follows the layout;
    its per-output-channel scale follows row splits and stays whole under
    column splits."""
    if layout is None:
        return v
    if isinstance(layout, Owner):
        return v if layout.rank == rank else None
    runs = layout.runs[rank]
    if isinstance(v, Mapping):
        return {k: (t if k == "scale" and layout.dim != 0 else _take(t, layout.dim, runs))
                for k, t in v.items()}
    return _take(v, layout.dim, runs)


def unshard_value(parts: list, layout):
    """Inverse of ``shard_value``: the model ranks' parts, in rank order ->
    the whole value."""
    if layout is None:
        return parts[0]
    if isinstance(layout, Owner):
        return parts[layout.rank]
    if isinstance(parts[0], Mapping):
        return {k: (parts[0][k] if k == "scale" and layout.dim != 0
                    else unshard_value([p[k] for p in parts], layout))
                for k in parts[0]}
    full = max(e for runs in layout.runs for _, e in runs)
    shape = list(parts[0].shape)
    shape[layout.dim] = full
    out = parts[0].new_empty(shape)
    for part, runs in zip(parts, layout.runs):
        offset = 0
        for s, e in runs:
            out.narrow(layout.dim, s, e - s).copy_(part.narrow(layout.dim, offset, e - s))
            offset += e - s
    return out


def shard_params(params: Mapping, layout: Callable, rank: int) -> dict:
    """Model rank ``rank``'s slices of flat params (keys it does not hold,
    other ranks' experts, are absent)."""
    out = {}
    for key, v in params.items():
        part = shard_value(v, layout(key, v), rank)
        if part is not None:
            out[key] = part
    return out


def shard_unet_params(params: Mapping, mesh: Mesh, rank: int, config) -> dict:
    """Model rank ``rank``'s slices of a UNet's flat params (``unet_layout``)."""
    return shard_params(params, layout_fn("unet", config, mesh.n_model), rank)


def shard_flux_params(params: Mapping, mesh: Mesh, rank: int, config) -> dict:
    """Model rank ``rank``'s slices of a FLUX DiT's flat params (``flux_layout``)."""
    return shard_params(params, layout_fn("flux", config, mesh.n_model), rank)


def shard_hidream_params(params: Mapping, mesh: Mesh, rank: int, config) -> dict:
    """Model rank ``rank``'s slices of a HiDream DiT's flat params
    (``hidream_layout``; a rank holds only its own routed experts)."""
    return shard_params(params, layout_fn("hidream", config, mesh.n_model), rank)
