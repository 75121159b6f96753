"""Port parity for io/image_io.py: the PNG reader and writer built on zlib
and numpy against the JAX package's PIL path.

Bars, all exact:
- the port's read_image equals the JAX package's on PNGs PIL writes: RGB,
  8- and 16-bit grey, RGBA, palette, grey+alpha (PIL's adaptive filtering
  writes rows of filter types 1, 2 and 4 among them);
- on PNGs built here with every row of one filter type, for each of the
  five (None, Sub, Up, Average, Paeth; Average appears only this way), and
  with a mix of types by row, in every colour type at bit depths 8 and 16:
  the port decodes the image that was encoded, as PIL does;
- PIL reads the port's write_image output bit for bit;
- read_depth / write_depth round trips equal the JAX package's, clipping
  included;
- interlaced (Adam7) PNGs and bit depths 1, 2 and 4 (grey and palette),
  built here and written by PIL, and JPEGs PIL writes, read as the JAX
  package reads them;
- a bit depth or interlace method the standard does not have raises
  ValueError, and a JPEG without PIL raises ImportError naming it.
"""

import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from open3d_tpu.io import image_io as jio
from open3d_tpu_torch.io import image_io as tio

RNG = np.random.default_rng(0)


def _smooth(h, w, ch, hi=256, dtype=np.uint8):
    """A smooth gradient with noise: adaptive filtering picks mixed rows."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = xx * 1.7 + yy * 0.9
    img = np.stack([(base * (k + 1) + RNG.normal(0, 3, base.shape)) % hi for k in range(ch)], -1)
    return img[..., 0].astype(dtype) if ch == 1 else img.astype(dtype)


def _pil_images():
    rgb = _smooth(40, 52, 3)
    return {
        "RGB": Image.fromarray(rgb),
        "L": Image.fromarray(_smooth(40, 52, 1)),
        "I;16": Image.fromarray(_smooth(40, 52, 1, 60000, np.int32), mode="I").convert("I;16"),
        "RGBA": Image.fromarray(_smooth(40, 52, 4)),
        "P": Image.fromarray(rgb).convert("P"),
        "LA": Image.fromarray(_smooth(40, 52, 2), mode="LA"),
    }


def _filter_types(path) -> set:
    data = open(path, "rb").read()
    idat = b"".join(body for kind, body in tio._chunks(data) if kind == b"IDAT")
    w, h, depth, ctype = struct.unpack(">IIBB", dict(tio._chunks(data))[b"IHDR"][:10])
    stride = 1 + w * tio._CHANNELS[ctype] * depth // 8
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, stride)[:, 0].tolist())


@pytest.mark.parametrize("mode", ["RGB", "L", "I;16", "RGBA", "P", "LA"])
def test_reads_what_pil_writes(tmp_path, mode):
    p = str(tmp_path / "a.png")
    _pil_images()[mode].save(p)
    want, got = jio.read_image(p), tio.read_image(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pil_files_use_sub_up_and_paeth(tmp_path):
    seen = set()
    for mode, img in _pil_images().items():
        p = str(tmp_path / f"{mode.replace(';', '')}.png")
        img.save(p)
        seen |= _filter_types(p)
    assert {1, 2, 4} <= seen, seen


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _pack(img: np.ndarray, depth: int):
    """The (h, row bytes) raw bytes of an (h, w, ch) image and the bytes a
    pixel the filters step by (samples below 8 bits packed, highest first)."""
    h, w, ch = img.shape
    if depth == 16:
        return img.astype(">u2").view(np.uint8).reshape(h, -1).astype(np.int32), 2 * ch
    if depth == 8:
        return img.astype(np.uint8).reshape(h, -1).astype(np.int32), ch
    per = 8 // depth
    v = np.concatenate([img[..., 0], np.zeros((h, -w % per), img.dtype)], 1).astype(np.int32)
    shifts = 8 - depth * (1 + np.arange(per))
    return (v.reshape(h, -1, per) << shifts).sum(-1), 1


def _filtered(raw: np.ndarray, bpp: int, ftypes) -> bytes:
    """Scanlines with filter type ftypes[r % len] on row r (the spec's
    filters applied to the raw bytes, row by row)."""
    rows = []
    for r in range(raw.shape[0]):
        x = raw[r]
        up = raw[r - 1] if r else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1, 4: _paeth(left, up, upleft)}
        f = ftypes[r % len(ftypes)]
        rows.append(bytes([f]) + ((x - pred[f]) % 256).astype(np.uint8).tobytes())
    return b"".join(rows)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _encode(img: np.ndarray, ctype: int, depth: int, ftypes, palette=None,
            interlace: int = 0) -> bytes:
    """A PNG of `img` (h, w, ch) with the given filter type per row; with
    interlace=1 the seven Adam7 passes, each filtered on its own."""
    h, w = img.shape[:2]
    if interlace == 1:
        passes = [img[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7 if x0 < w and y0 < h]
    else:
        passes = [img]
    data = b"".join(_filtered(*_pack(p, depth), ftypes) for p in passes)
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))]
    if palette is not None:
        chunks.append((b"PLTE", palette.astype(np.uint8).tobytes()))
    chunks += [(b"IDAT", zlib.compress(data)), (b"IEND", b"")]
    return tio._SIGNATURE + b"".join(tio._chunk(k, b) for k, b in chunks)


# (colour type, bit depth, samples a pixel)
FORMATS = [(0, 8, 1), (0, 16, 1), (2, 8, 3), (2, 16, 3), (3, 8, 1), (4, 8, 2), (4, 16, 2),
           (6, 8, 4), (6, 16, 4)]


@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mix"])
@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f"ct{f[0]}-{f[1]}bit")
def test_decodes_every_filter_type(tmp_path, fmt, filters):
    ctype, depth, ch = fmt
    h, w = 13, 17
    hi = 1 << depth
    img = RNG.integers(0, hi, (h, w, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    img[4:9] = (np.arange(w)[None, :, None] * (hi // 32)).astype(img.dtype)  # smooth rows
    palette = None
    if ctype == 3:
        palette = RNG.integers(0, 256, (256, 3))
    ftypes = (RNG.integers(0, 5, h) if filters == "mix" else np.full(h, int(filters))).tolist()
    p = tmp_path / "f.png"
    p.write_bytes(_encode(img, ctype, depth, ftypes, palette))
    got = tio.read_image(str(p))
    np.testing.assert_array_equal(got, jio.read_image(str(p)))
    # and it is the image that was encoded
    px = (img >> 8).astype(np.uint8) if depth == 16 else img
    if ctype == 0:
        want = img[..., 0]
    elif ctype == 3:
        want = palette.astype(np.uint8)[img[..., 0]]
    else:
        want = np.repeat(px[..., :1], 3, -1) if ctype == 4 else px[..., :3]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,dtype", [((21, 34), np.uint8), ((21, 34), np.uint16),
                                         ((21, 34, 2), np.uint8), ((21, 34, 3), np.uint8),
                                         ((21, 34, 4), np.uint8)])
def test_pil_reads_the_writer_bit_for_bit(tmp_path, shape, dtype):
    img = RNG.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)
    p = str(tmp_path / "w.png")
    tio.write_image(p, img)
    back = np.asarray(Image.open(p))
    assert back.dtype == img.dtype or (dtype == np.uint16 and back.dtype.kind == "u")
    np.testing.assert_array_equal(back.astype(dtype), img)
    np.testing.assert_array_equal(tio.read_image(p), jio.read_image(p))


def test_depth_round_trips_equal_the_reference(tmp_path):
    depth = RNG.uniform(-0.5, 15.0, (24, 31)).astype(np.float32)  # clips below 0, above 13.1 m
    depth[3:5] = 0.0
    for scale in (1000.0, 5000.0):
        a, b = str(tmp_path / "port.png"), str(tmp_path / "ref.png")
        tio.write_depth(a, depth, scale)
        jio.write_depth(b, depth, scale)
        for p in (a, b):
            np.testing.assert_array_equal(tio.read_depth(p, scale), jio.read_depth(p, scale))
        np.testing.assert_array_equal(tio.read_image(a), tio.read_image(b))


def test_interlaced_low_bit_depth_and_jpeg_raise(tmp_path, monkeypatch):
    """What the standard does not have raises ValueError; a JPEG without
    PIL raises ImportError naming it."""
    img = RNG.integers(0, 8, (8, 8, 1)).astype(np.uint8)
    p = tmp_path / "i.png"
    p.write_bytes(_encode(img, 0, 8, [0], interlace=2))
    with pytest.raises(ValueError, match="interlace method 2"):
        tio.read_image(str(p))
    p.write_bytes(_encode(img, 2, 4, [0]))  # RGB has no 4-bit samples
    with pytest.raises(ValueError, match="bit depth 4"):
        tio.read_image(str(p))
    p.write_bytes(_encode(img, 0, 8, [0], interlace=1)[:-40] + _encode(img, 0, 8, [0])[-12:])
    with pytest.raises(ValueError):  # truncated image data
        tio.read_image(str(p))
    Image.fromarray(RNG.integers(0, 256, (8, 8, 3)).astype(np.uint8)).save(str(tmp_path / "c.jpg"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        tio.read_image(str(tmp_path / "c.jpg"))
    with pytest.raises(ValueError):
        tio.write_image(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))


LOW_AND_ALL = [(0, 1, 1), (0, 2, 1), (0, 4, 1), (3, 1, 1), (3, 2, 1), (3, 4, 1)] + FORMATS


@pytest.mark.parametrize("interlace", [0, 1], ids=["flat", "adam7"])
@pytest.mark.parametrize("fmt", LOW_AND_ALL, ids=lambda f: f"ct{f[0]}-{f[1]}bit")
def test_decodes_low_bit_depths_and_adam7(tmp_path, fmt, interlace):
    """Every colour type and bit depth, flat and interlaced, at a size whose
    passes are all partial (11 x 13), rows of every filter type."""
    ctype, depth, ch = fmt
    img = RNG.integers(0, 1 << depth, (11, 13, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    palette = RNG.integers(0, 256, (1 << min(depth, 8), 3)) if ctype == 3 else None
    p = tmp_path / "a.png"
    p.write_bytes(_encode(img, ctype, depth, [0, 1, 2, 3, 4], palette, interlace))
    want = jio.read_image(str(p))
    got = tio.read_image(str(p))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_reads_low_bit_depths_pil_writes(tmp_path, bits):
    grey = Image.fromarray(_smooth(40, 52, 1) > 100)  # mode "1": a 1-bit grey PNG
    pal = Image.fromarray(_smooth(40, 52, 3)).quantize(1 << bits)
    for name, img, kw in (("g", grey, {}), ("p", pal, {"bits": bits})):
        p = str(tmp_path / f"{name}.png")
        img.save(p, **kw)
        assert tio._chunks(open(p, "rb").read()).__next__()[1][8] == (1 if name == "g" else bits)
        np.testing.assert_array_equal(tio.read_image(p), jio.read_image(p))


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_reads_jpeg_as_the_reference(tmp_path, mode):
    img = _smooth(40, 52, 3 if mode == "RGB" else 1)
    p = str(tmp_path / "c.jpg")
    Image.fromarray(img).save(p, quality=90)
    got, want = tio.read_image(p), jio.read_image(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
