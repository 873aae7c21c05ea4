"""The port's PNG codec (``nerfacc_tpu_torch/datasets/image_io.py``)
against imageio, which writes and reads PNGs through Pillow here.

Every comparison is bit for bit: a PNG stores 8-bit values losslessly, so
the port must read what imageio wrote, and imageio what the port wrote,
exactly. Pillow picks a row filter per row (a 48x48 RGBA image of the
procedural kind carries Sub, Up and Paeth rows), and the port's writer
writes any given mix of the five, so both reconstruction paths are read:
None / Sub / Up row by row, and the anti-diagonal path that Average and
Paeth rows take.
"""

import struct
import sys
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from nerfacc_tpu_torch.datasets import image_io


def _filters(path) -> set:
    """The row filter bytes of a non-interlaced 8-bit RGB(A) PNG."""
    data = open(path, "rb").read()
    header, idat = None, b""
    for kind, payload in image_io._chunks(data, str(path)):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat += payload
    w, h, _, colour = header[:4]
    stride = 1 + w * {2: 3, 6: 4}[colour]
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


def _image(kind: str, c: int, h: int = 48, w: int = 48) -> np.ndarray:
    """A seeded test image: uniform noise, or a smooth render-like field
    with noise in its lower half."""
    rng = np.random.RandomState(7 + c)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, c)).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    smooth = np.stack([128 + 100 * np.sin(x / 5 + y / 7),
                       128 + 90 * np.cos(x / 3), 4.0 * y, 255 - 3.0 * x],
                      -1)[..., :c]
    smooth[h // 2:] += rng.randint(-20, 21, (h - h // 2, w, c))
    return np.clip(smooth, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_reads_imageio_pngs_bit_equal(tmp_path, kind, c):
    img = _image(kind, c)
    path = tmp_path / "a.png"
    imageio.imwrite(path, img)
    got = image_io.imread(path)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, imageio.imread(path))
    if kind == "smooth" and c == 4:
        # Pillow's adaptive filters: Sub, Up and Paeth rows in one file
        assert {1, 2, 4} <= _filters(path), _filters(path)


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("rows", ["all five", "paeth", "average",
                                  "sub and up"])
def test_reads_every_row_filter(tmp_path, rows, c):
    img = _image("smooth", c, h=20, w=17)
    filters = {"all five": np.arange(20) % 5, "paeth": np.full(20, 4),
               "average": np.full(20, 3),
               "sub and up": 1 + np.arange(20) % 2}[rows]
    path = tmp_path / "f.png"
    image_io.imwrite(path, img, filters=filters)
    assert _filters(path) == set(filters.tolist())
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(image_io.imread(path), img)


@pytest.mark.parametrize("c", [3, 4])
def test_imageio_reads_the_ports_pngs_bit_equal(tmp_path, c):
    img = _image("noise", c, h=33, w=21)
    path = tmp_path / "p.png"
    image_io.imwrite(path, img)
    # the port's own writer: None on row 0, Up after it
    assert _filters(path) == {0, 2}
    back = imageio.imread(path)
    assert back.shape == img.shape
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(image_io.imread(path), img)


def _png(path, w, h, depth, colour, interlace=0, payload=b""):
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    path.write_bytes(image_io.SIGNATURE + image_io._chunk(b"IHDR", header)
                     + image_io._chunk(b"IDAT", zlib.compress(payload))
                     + image_io._chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,colour,interlace,match", [
    (16, 2, 0, "bit depth 16"),
    (8, 3, 0, "colour type 3 \\(palette\\)"),
    (8, 6, 1, "interlaced"),
    (8, 0, 0, "colour type 0 \\(greyscale\\)"),
])
def test_unsupported_pngs_raise(tmp_path, depth, colour, interlace, match):
    path = tmp_path / "bad.png"
    _png(path, 4, 4, depth, colour, interlace, b"\x00" * 64)
    with pytest.raises(ValueError, match=match):
        image_io.imread(path)


def test_malformed_pngs_raise(tmp_path):
    path = tmp_path / "short.png"
    _png(path, 4, 4, 8, 2, payload=b"\x00" * 10)
    with pytest.raises(ValueError, match="bytes of image data"):
        image_io.imread(path)
    img = _image("noise", 3, 4, 4)
    rows = np.concatenate([np.full((4, 1), 5, np.uint8),
                           img.reshape(4, 12)], axis=1)
    _png(path, 4, 4, 8, 2, payload=rows.tobytes())
    with pytest.raises(ValueError, match="row filter 5"):
        image_io.imread(path)
    with pytest.raises(ValueError, match="uint8"):
        image_io.imwrite(path, img.astype(np.float32))


def test_other_formats_go_to_imageio_or_raise(tmp_path, monkeypatch):
    img = _image("smooth", 3, 16, 16)
    path = tmp_path / "view.jpg"
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(image_io.imread(path), imageio.imread(path))
    # without imageio: the file's name in the error
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ValueError, match="view.jpg: not a PNG"):
        image_io.imread(path)
