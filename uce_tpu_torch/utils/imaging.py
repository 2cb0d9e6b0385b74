"""PNG I/O with zlib only, and the {case}_{num}.png naming convention of the
reference eval scripts (evalscripts/generate-images-sd.py)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def encode_png(array: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    h, w, _ = array.shape
    raw = b"".join(b"\x00" + array[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes written by ``encode_png`` -> uint8 [H, W, 3]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, ctype, interlace) != (8, 2, 0):
                raise ValueError("only 8-bit RGB, non-interlaced PNGs are read")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("only filter-0 rows are read")
    return rows[:, 1:].reshape(h, w, 3).copy()


def save_png(array: np.ndarray, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(array, np.uint8)))


def case_image_path(folder: str, case_number, num: int) -> str:
    return os.path.join(folder, f"{case_number}_{num}.png")


def uce_output_folder(save_path: str, uce_model_path: str | None = None,
                      exp_name: str | None = None) -> str:
    """Edited models write under the safetensors stem, unedited under
    'original' (created on return)."""
    folder = os.path.join(
        save_path,
        exp_name if exp_name else
        (os.path.basename(uce_model_path).replace(".safetensors", "")
         if uce_model_path else "original"))
    os.makedirs(folder, exist_ok=True)
    return folder


def case_window(rows, from_case: int, till_case: int) -> list:
    """Rows (dicts with an int ``case_number``) within the inclusive
    [from_case, till_case] resume window."""
    return [r for r in rows if from_case <= r["case_number"] <= till_case]


def save_case_images(images: np.ndarray, folder: str, case_number) -> None:
    for num in range(images.shape[0]):
        save_png(images[num], case_image_path(folder, case_number, num))
