"""The port's PNG reader (uce_tpu_torch/utils/imaging.py::decode_png) on the
PNGs that uce_tpu's ``save_png`` (PIL) writes and on one written with each
filter type by hand: equal to ``np.asarray(Image.open(p).convert("RGB"))``,
byte for byte. And ``stack_uniform`` against PIL's bilinear resize."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.utils.imaging import save_png as pil_save_png
from uce_tpu_torch.utils import imaging

CHANNELS = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
COLOR_TYPE = {"L": 0, "RGB": 2, "LA": 4, "RGBA": 6}


def _images():
    """A smooth gradient (PIL picks Sub and Paeth rows), noise (None, Sub,
    Up, Paeth) and a product pattern, at odd sizes."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:64, 0:48]
    yield "gradient", np.stack([x * 5, y * 4, (x + y) * 2], -1).astype(np.uint8)
    yield "noise", rng.integers(0, 256, (37, 29, 3), dtype=np.uint8)
    yield "pattern", np.stack([(x * y) % 256, (x * x + y) % 256, abs(x - y) * 3],
                              -1).astype(np.uint8)


def _filters(data: bytes) -> set:
    pos, idat, w, h, bpp = 8, b"", 0, 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", body[:10])
            bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = zlib.decompress(idat)
    return {raw[r * (1 + w * bpp)] for r in range(h)}


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_reads_what_pil_writes(tmp_path, mode):
    seen = set()
    for name, img in _images():
        arr = np.asarray(Image.fromarray(img).convert(mode))
        path = str(tmp_path / f"{name}_{mode}.png")
        if mode == "RGB":
            pil_save_png(arr, path)  # uce_tpu's writer
        else:
            Image.fromarray(arr).save(path)
        data = open(path, "rb").read()
        seen |= _filters(data)
        want = np.asarray(Image.open(path).convert("RGB"))
        got = imaging.decode_png(data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(imaging.load_image(path), want)
    assert {1, 2, 4} <= seen  # PIL's adaptive filtering


def _filter_row(ftype: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> bytes:
    """The PNG encoder's side of one filter (the spec's definitions)."""
    r, p = row.astype(np.int64), prior.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(r)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = p
    elif ftype == 3:
        pred = (left + p) // 2
    else:
        pa, pb, pc = abs(p - upleft), abs(left - upleft), abs(left + p - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, p, upleft))
    return bytes([ftype]) + ((r - pred) % 256).astype(np.uint8).tobytes()


def _encode(img: np.ndarray, mode: str, filters) -> bytes:
    h, w = img.shape[:2]
    bpp = CHANNELS[mode]
    flat = img.reshape(h, w * bpp)
    prior = np.zeros(w * bpp, np.uint8)
    raw = b""
    for y in range(h):
        raw += _filter_row(filters[y % len(filters)], flat[y], prior, bpp)
        prior = flat[y]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[mode], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (3, 4, 1, 0, 2)])
def test_each_filter_type(mode, filters):
    """Every row in one filter (or rows cycling through all five), checked
    against PIL's reading of the same bytes."""
    _, img = list(_images())[1]
    arr = np.asarray(Image.fromarray(img).convert(mode)).reshape(
        img.shape[0], img.shape[1], CHANNELS[mode])
    data = _encode(arr, mode, filters)
    assert _filters(data) == set(filters)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(imaging.decode_png(data), want)


def test_round_trip_and_rejects():
    _, img = next(_images())
    np.testing.assert_array_equal(imaging.decode_png(imaging.encode_png(img)), img)
    with pytest.raises(ValueError, match="not a PNG"):
        imaging.decode_png(b"GIF89a" + bytes(10))
    buf = io.BytesIO()
    Image.fromarray(img).convert("P").save(buf, format="PNG")  # palette
    with pytest.raises(ValueError, match="only 8-bit"):
        imaging.decode_png(buf.getvalue())


@pytest.mark.parametrize("size", [(32, 32), (64, 48), (512, 512), (20, 90)])
def test_stack_uniform_matches_pil_bilinear(size):
    """A folder of mixed sizes: stragglers resized to the first image's size
    within one uint8 level of PIL's BILINEAR resize (uce_tpu's
    ``stack_uniform``), the first image untouched; one size: np.stack."""
    rng = np.random.default_rng(5)
    first = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
    other = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
    got = imaging.stack_uniform([first, other, first])
    want = np.asarray(Image.fromarray(other).resize((40, 48), Image.BILINEAR))
    assert got.shape == (3, 48, 40, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[0], first)
    assert np.abs(got[1].astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(imaging.stack_uniform([first, first]),
                                  np.stack([first, first]))
