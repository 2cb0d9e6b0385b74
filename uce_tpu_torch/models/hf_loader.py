"""HF snapshot reading and safetensors I/O without the safetensors package.

A safetensors file is an 8-byte little-endian header length N, N bytes of
JSON (``{name: {"dtype", "shape", "data_offsets": [begin, end]}}``, plus an
optional ``__metadata__``), then the raw little-endian tensor bytes.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Callable, Iterable, Iterator, Mapping

import numpy as np
import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def iter_safetensors(model_dir: str, subfolder: str | None = None) -> Iterable[str]:
    """All .safetensors shard paths under a snapshot (sub)directory."""
    root = os.path.join(model_dir, subfolder) if subfolder else model_dir
    if not os.path.isdir(root):
        raise FileNotFoundError(f"model directory not found: {root}")
    names = sorted(n for n in os.listdir(root) if n.endswith(".safetensors"))
    if not names:
        raise FileNotFoundError(f"no .safetensors files in {root}")
    return [os.path.join(root, n) for n in names]


def iter_safetensors_file(path: str, keys: Callable[[str], bool] | None = None,
                          reuse: bool = False) -> Iterator[tuple[str, torch.Tensor]]:
    """(name, CPU tensor) of one file (optionally filtered by name), one
    tensor at a time, each read from the file into its own buffer. With
    ``reuse``, every tensor is read into one buffer (pinned where CUDA is
    available) and is a view of it that the next one overwrites: for a
    caller that copies each tensor away before taking the next."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        entries = [(name, info) for name, info in header.items()
                   if name != "__metadata__" and (keys is None or keys(name))]
        staging = None
        if reuse and entries:
            size = max(end - begin for _, info in entries
                       for begin, end in [info["data_offsets"]])
            staging = torch.empty(size, dtype=torch.uint8,
                                  pin_memory=torch.cuda.is_available())
        for name, info in entries:
            dtype = _DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: unsupported dtype {info['dtype']}")
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            if end == begin:
                yield name, torch.empty(shape, dtype=dtype)
                continue
            buf = (staging[:end - begin] if staging is not None
                   else torch.empty(end - begin, dtype=torch.uint8))
            f.seek(8 + n + begin)
            if f.readinto(buf.numpy()) != end - begin:
                raise ValueError(f"{path}: {name} runs past the end of the file")
            yield name, buf.view(dtype).reshape(shape)


def read_safetensors(path: str, keys: Callable[[str], bool] | None = None
                     ) -> dict[str, torch.Tensor]:
    """Read the tensors of one file (optionally filtered by name) on the CPU."""
    return dict(iter_safetensors_file(path, keys))


def read_safetensors_metadata(path: str) -> dict[str, str]:
    """The header's ``__metadata__`` string map of one file ({} if none)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return dict(json.loads(f.read(n)).get("__metadata__") or {})


def load_state_dict(
    model_dir: str,
    subfolder: str | None = None,
    *,
    keys: Callable[[str], bool] | None = None,
    dtype: torch.dtype | None = None,
    device=None,
    transform: Callable[[str, torch.Tensor], object] | None = None,
) -> dict[str, object]:
    """All tensors of a snapshot (sub)directory, optionally filtered, cast
    and placed: each tensor goes to ``device`` (and is cast there) as soon as
    it is read, so no more than one tensor at a time is held on the host.
    ``transform(key, tensor)``, given, replaces each cast tensor before the
    next is read (a quantizing load never holds the whole float model)."""
    out: dict[str, object] = {}
    # a tensor bound for another device is copied there at once, so one
    # buffer serves every read
    reuse = device is not None and torch.device(device).type != "cpu"
    for path in iter_safetensors(model_dir, subfolder):
        for k, t in iter_safetensors_file(path, keys, reuse=reuse):
            if device is not None:
                t = t.to(device)
            t = t.to(dtype) if dtype is not None else t
            out[k] = transform(k, t) if transform is not None else t
    return out


def save_safetensors(tensors: Mapping[str, object], path: str,
                     metadata: Mapping[str, str] | None = None) -> None:
    """Write a flat name -> tensor (or numpy array) dict as safetensors: the
    header from the shapes (and the ``metadata`` strings, if given), then one
    tensor at a time, each brought to the host only while it is written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    as_tensor = lambda t: (torch.from_numpy(np.ascontiguousarray(t))
                           if isinstance(t, np.ndarray) else t.detach())
    header, offset = {}, 0
    for name in sorted(tensors):
        t = as_tensor(tensors[name])
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in sorted(tensors):
            t = as_tensor(tensors[name]).to("cpu").contiguous()
            raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            f.write(raw.numpy())
