"""PNG I/O with zlib only (the port writes 8-bit RGB with filter 0 and reads
what PIL writes), eval-folder stacking, and the {case}_{num}.png naming
convention of the reference eval scripts (evalscripts/generate-images-sd.py)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

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


# channels per pixel of each 8-bit colour type: gray, RGB, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) of
    a non-interlaced image's decompressed scanlines."""
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # a running sum of each channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):  # each byte needs the one reconstructed before it
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[x - bpp] if x >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3], as PIL's ``Image.open(f).convert("RGB")``
    gives it: 8-bit gray, RGB, gray + alpha or RGBA, non-interlaced, any
    filter per row; gray is repeated into the three channels and alpha
    dropped."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, w, h, ctype = 8, b"", None, None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or ctype not in _CHANNELS or interlace:
                raise ValueError("only 8-bit gray, RGB, gray+alpha and RGBA "
                                 "non-interlaced PNGs are read")
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + n
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    pixels = _unfilter(raw, h, w * bpp, bpp).reshape(h, w, bpp)
    if bpp <= 2:  # gray (+ alpha)
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def load_image(path: str) -> np.ndarray:
    """A PNG file -> uint8 [H, W, 3] (``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def stack_uniform(images: list[np.ndarray]) -> np.ndarray:
    """np.stack of an eval folder's images, which may mix sizes (re-runs with
    another --image_size into the same directory): an image of another size
    than the first is resized to the first's by antialiased bilinear
    resampling on uint8, PIL's ``resize(..., Image.BILINEAR)`` within one
    level, as uce_tpu does it with PIL. A folder of one size is a plain
    np.stack."""
    h, w = images[0].shape[:2]
    if all(im.shape[:2] == (h, w) for im in images):
        return np.stack(images)
    return np.stack([im if im.shape[:2] == (h, w) else resize_uint8(im, (h, w))
                     for im in images])


def resize_uint8(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [*size, 3] by antialiased bilinear
    resampling on the host: PIL's ``resize(..., Image.BILINEAR)`` within one
    level."""
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=tuple(size), mode="bilinear", antialias=True,
                      align_corners=False)
    return y[0].permute(1, 2, 0).numpy()


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
