"""8-bit PNG reading and writing with the standard library only (``zlib``,
``struct``) and numpy: the port's stand-in for ``imageio.v2``, which the
card's machine does not have.

:func:`imread` reads non-interlaced 8-bit RGB (colour type 2) and RGBA
(colour type 6) PNGs with any of the five row filters, as PNG writers
such as Pillow mix them row by row. None (0), Sub (1) and Up (2) rows are
undone a row at a time with numpy (Sub is a prefix sum modulo 256 over
each channel); as soon as an Average (3) or Paeth (4) row appears, whose
bytes depend on the reconstructed byte to their left, the image is
reconstructed along anti-diagonals instead: pixel (y, x) needs only (y,
x - 1), (y - 1, x) and (y - 1, x - 1), so every pixel of a diagonal is
reconstructed at once, h + w - 1 numpy steps for the whole image. Any
other PNG raises ``ValueError`` naming what it found. A file that is not a
PNG (the JPEGs of a real 360 capture) goes to ``imageio`` where it can be
imported, and otherwise raises with the file's name.

:func:`imwrite` writes RGB or RGBA with the Up filter on every row but
the first (None), so that its own files take the fast path on reading;
given per-row ``filters``, it writes any mix of the five, as other
writers do.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {2: 3, 6: 4}
_COLOUR_NAMES = {0: "greyscale", 2: "RGB", 3: "palette",
                 4: "greyscale with alpha", 6: "RGBA"}
# zlib level of the writer: the fixtures are smooth renders, which level 6
# packs barely better than level 1 at several times the time
COMPRESS_LEVEL = 1


def _chunks(data: bytes, name):
    """(type, payload) of every chunk after the signature."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if pos + 12 + n > len(data):
            raise ValueError(f"{name}: PNG chunk {kind!r} runs past the end")
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{name}: PNG without an IEND chunk")


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays: whichever of left ``a``, up
    ``b`` and up-left ``c`` is nearest ``a + b - c`` (ties: a, b, c)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Rows of None, Sub and Up only, one row at a time. ``filt`` is (h, w,
    c) uint8; uint8 arithmetic wraps modulo 256 as the filters do."""
    out = np.empty_like(filt)
    prior = np.zeros_like(filt[0])
    for y, kind in enumerate(types):
        row = filt[y]
        if kind == 1:
            row = np.cumsum(row, axis=0, dtype=np.uint8)
        elif kind == 2:
            row = row + prior
        out[y] = row
        prior = out[y]
    return out


def _unfilter_diagonals(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Any mix of the five filters, along anti-diagonals. ``recon`` carries
    a zero row above and a zero column left of the image, the PNG's
    out-of-image bytes."""
    h, w, c = filt.shape
    recon = np.zeros((h + 1, w + 1, c), np.int16)
    f = filt.astype(np.int16)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a = recon[y + 1, x]  # left
        b = recon[y, x + 1]  # up
        cc = recon[y, x]  # up-left
        kind = types[y][:, None]
        pred = np.where(kind == 1, a, 0)
        pred = np.where(kind == 2, b, pred)
        pred = np.where(kind == 3, (a + b) >> 1, pred)
        pred = np.where(kind == 4, _paeth(a, b, cc), pred)
        recon[y + 1, x + 1] = (f[y, x] + pred) & 0xFF
    return recon[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """An 8-bit RGB or RGBA PNG as a (h, w, 3 | 4) uint8 array."""
    name = str(path)
    data = Path(path).read_bytes()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(
            f"{name}: PNG colour type {colour} "
            f"({_COLOUR_NAMES.get(colour, 'unknown')}); only RGB (2) and "
            "RGBA (6) are read")
    if depth != 8:
        raise ValueError(f"{name}: PNG bit depth {depth}; only 8 is read")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG (Adam7); only "
                         "non-interlaced files are read")
    if compression or filter_method:
        raise ValueError(f"{name}: PNG compression method {compression}, "
                         f"filter method {filter_method}; only 0 is defined")
    c = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{name}: {raw.size} bytes of image data for a "
                         f"{w}x{h} {_COLOUR_NAMES[colour]} PNG")
    rows = raw.reshape(h, 1 + w * c)
    types = rows[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"{name}: PNG row filter {int(types.max())}; the "
                         "filters are 0-4")
    filt = rows[:, 1:].reshape(h, w, c)
    if types.max(initial=0) <= 2:
        return _unfilter_rows(filt, types)
    return _unfilter_diagonals(filt, types)


def imread(path) -> np.ndarray:
    """An image file as a uint8 array: PNGs through :func:`read_png`, any
    other format through ``imageio`` where it can be imported."""
    with open(path, "rb") as fh:
        head = fh.read(len(SIGNATURE))
    if head == SIGNATURE:
        return read_png(path)
    try:
        import imageio.v2 as imageio
    except ImportError:
        raise ValueError(
            f"{path}: not a PNG, and imageio, which reads other formats, "
            "is not installed") from None
    return np.asarray(imageio.imread(path))


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def _predictors(x: np.ndarray) -> tuple:
    """The five filters' predictions of every byte of an int16 (h, w, c)
    image from its raw neighbours (zero outside the image)."""
    left, up, up_left = (np.zeros_like(x) for _ in range(3))
    left[:, 1:] = x[:, :-1]
    up[1:] = x[:-1]
    up_left[1:, 1:] = x[:-1, :-1]
    return (np.zeros_like(x), left, up, (left + up) >> 1,
            _paeth(left, up, up_left))


def imwrite(path, img: np.ndarray, filters=None) -> None:
    """Write a (h, w, 3 | 4) uint8 array as an 8-bit RGB or RGBA PNG. Row
    ``y`` takes filter ``filters[y]`` (0-4), by default None on row 0 and
    Up on every other row."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"{path}: imwrite takes (h, w, 3 | 4) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w, c = img.shape
    rows = np.empty((h, 1 + w * c), np.uint8)
    if filters is None:
        flat = img.reshape(h, w * c)
        rows[0, 0], rows[0, 1:] = 0, flat[0]
        rows[1:, 0] = 2
        np.subtract(flat[1:], flat[:-1], out=rows[1:, 1:])
    else:
        filters = np.asarray(filters)
        if filters.shape != (h,) or filters.min() < 0 or filters.max() > 4:
            raise ValueError(f"{path}: filters must be {h} values in 0-4")
        x = img.astype(np.int16)
        pred = np.stack(_predictors(x))[filters, np.arange(h)]
        rows[:, 0] = filters
        rows[:, 1:] = ((x - pred) & 0xFF).reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    Path(path).write_bytes(
        SIGNATURE + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), COMPRESS_LEVEL))
        + _chunk(b"IEND", b""))
