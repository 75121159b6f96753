"""Image IO (port of open3d_tpu/io/image_io.py): colour images and the
16-bit depth PNGs of the TUM and Redwood datasets.

The JAX package reads and writes through PIL. The port reads and writes
PNG without an imaging library: it parses the PNG chunks (IHDR, PLTE,
IDAT), inflates the image data with zlib and undoes the row filters in
numpy. Every other format (JPEG among them) it reads through PIL, imported
at call time, as the JAX package does; without PIL that raises
ImportError. What it returns is what the JAX package's PIL path returns:

- uint16 (H, W) for 16-bit greyscale (depth);
- uint8 (H, W) for 8-bit greyscale, and for 2- and 4-bit greyscale
  scaled to 0-255 (PIL's "L");
- uint8 (H, W, 3) for everything else: RGB as it is, a palette expanded,
  1-bit greyscale as 0 or 255 (PIL's "1"), greyscale+alpha as grey in
  three channels, alpha dropped (PIL's `convert("RGB")`), 16-bit samples
  of colour types cut to their high byte as PIL does.

Every colour type (0 grey, 2 RGB, 3 palette, 4 grey+alpha, 6 RGBA) at
every bit depth the PNG standard allows it (1, 2, 4, 8 and 16 for grey,
1-8 for a palette, 8 and 16 for the rest) is read, interlaced (Adam7) or
not. Samples below 8 bits are unpacked after the filters are undone, with
one byte a pixel for the filters, as the standard says. An Adam7 image is
seven reduced images, each filtered and decoded on its own, then put in
place by strided assignment.

Undoing the filters. Average and Paeth predict a byte from its left
neighbour, which is itself reconstructed, so a row cannot be undone in one
vectorised step; a loop over pixels costs about a second a 640x480 frame.
Pixel (r, c) needs only (r, c-1), (r-1, c) and (r-1, c-1), which lie on
the anti-diagonals r + c - 1 and r + c - 2. So the image is swept one
anti-diagonal at a time (W + H - 1 steps), each step one set of numpy
operations over every pixel on it, each row's filter type picked per
pixel. The bytes are first laid out skewed, one anti-diagonal a row, so
that each step reads and writes contiguous runs. A PNG whose rows are all
unfiltered (what `write_image` writes) skips the sweep.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG ends before IEND")


def _skewed(buf: np.ndarray, h: int, w: int) -> np.ndarray:
    """The (h, w, bpp) view of a (h + w + 1, h + 1, bpp) buffer in which
    pixel (r, c) sits at [r + c + 2, r + 1]."""
    bpp = buf.shape[2]
    s = buf.itemsize
    return np.lib.stride_tricks.as_strided(
        buf.reshape(-1)[(2 * (h + 1) + 1) * bpp:], shape=(h, w, bpp),
        strides=((h + 2) * bpp * s, (h + 1) * bpp * s, s))


def _unfilter(scan: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (h, 1 + w * bpp) scanlines -> (h, w, bpp)
    bytes (PNG spec section 9: None, Sub, Up, Average, Paeth)."""
    ftype = scan[:, 0]
    filt = scan[:, 1:].reshape(h, w, bpp)
    if not ftype.any():
        return filt
    if int(ftype.max()) > 4:
        raise ValueError(f"PNG row filter type {int(ftype.max())} does not exist")
    # skewed layout: pixel (r, c) at [r + c + 2, r + 1], so anti-diagonal k
    # is row k + 2, its left and up neighbours lie in row k + 1 and its
    # up-left one in row k, each a contiguous run; row 0 and column 0 stay
    # zero, the padding the filters read outside the image
    x_sk = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    _skewed(x_sk, h, w)[...] = filt
    rec = np.zeros_like(x_sk)
    # per filter type: a 0/1 factor per row, and how many rows up to each
    # row have it (a step computes only the predictors its rows use)
    use = [(ftype == f).reshape(h, 1).astype(np.int16) for f in (1, 2, 3, 4)]
    before = [np.concatenate([[0], np.cumsum(u)]).tolist() for u in use]
    for k in range(h + w - 1):
        r0, r1 = max(0, k - w + 1), min(h - 1, k) + 1
        a = rec[k + 1, r0 + 1:r1 + 1]  # left
        b = rec[k + 1, r0:r1]  # up
        out = x_sk[k + 2, r0 + 1:r1 + 1].copy()
        if before[0][r1] > before[0][r0]:
            out += a * use[0][r0:r1]
        if before[1][r1] > before[1][r0]:
            out += b * use[1][r0:r1]
        if before[2][r1] > before[2][r0]:
            out += ((a + b) >> 1) * use[2][r0:r1]
        if before[3][r1] > before[3][r0]:
            c = rec[k, r0:r1]  # up-left
            bc, ac = b - c, a - c
            pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(ac + bc)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            out += paeth * use[3][r0:r1]
        rec[k + 2, r0 + 1:r1 + 1] = out & 0xFF
    return _skewed(rec, h, w).astype(np.uint8)


# bit depths the PNG standard allows each colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _samples(raw: np.ndarray, h: int, w: int, ch: int, depth: int) -> np.ndarray:
    """The (h, w, ch) sample values (uint16 for 16 bits, else uint8, not
    scaled) of one image's filtered scanlines `raw`, h * (1 + row bytes)."""
    row = (w * ch * depth + 7) // 8
    if raw.size != h * (1 + row):
        raise ValueError(f"PNG data holds {raw.size} bytes, not {h * (1 + row)}")
    if depth >= 8:
        bpp = ch * depth // 8
        px = _unfilter(raw.reshape(h, 1 + row), h, w, bpp)
        if depth == 16:
            px = px.reshape(h, w, ch, 2)
            return (px[..., 0].astype(np.uint16) << 8) | px[..., 1]
        return px
    # below 8 bits (one sample a pixel): the filters run on bytes, one a step
    packed = _unfilter(raw.reshape(h, 1 + row), h, row, 1)[..., 0]
    per = 8 // depth
    shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)  # first sample highest
    vals = (packed[..., None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, row * per)[:, :w, None]


def _adam7(raw: np.ndarray, h: int, w: int, ch: int, depth: int) -> np.ndarray:
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no scanlines, not even filter bytes
        n = ph * (1 + (pw * ch * depth + 7) // 8)
        out[y0::dy, x0::dx] = _samples(raw[pos:pos + n], ph, pw, ch, depth)
        pos += n
    if pos != raw.size:
        raise ValueError(f"interlaced PNG data holds {raw.size} bytes, not {pos}")
    return out


def _decode_png(data: bytes, what: str = "image") -> np.ndarray:
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{what}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{what}: PNG colour type {ctype} does not exist")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{what}: PNG bit depth {depth} does not exist for colour type {ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"{what}: PNG interlace method {interlace} does not exist")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    try:
        px = (_adam7 if interlace else _samples)(raw, h, w, ch, depth)
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None
    if depth == 16:
        if ctype == 0:
            return px[..., 0]
        px = (px >> 8).astype(np.uint8)  # colour types: the high byte, as PIL keeps
    if ctype == 0:
        if depth == 1:
            return np.repeat(px * np.uint8(255), 3, axis=-1)  # PIL's "1", as RGB
        return px[..., 0] * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{what}: palette PNG without PLTE")
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette
        return table[px[..., 0]]
    if ctype == 4:
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _decode_pil(data: bytes, what: str) -> np.ndarray:
    """Any format PIL reads, returned as the JAX package's read_image does."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{what}: this file is not a PNG, and reading it needs PIL "
                          "(Pillow), which is not installed") from e
    img = Image.open(io.BytesIO(data))
    if img.mode in ("I", "I;16", "I;16B"):
        return np.asarray(img, dtype=np.uint16)
    if img.mode == "L":
        return np.asarray(img, dtype=np.uint8)
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


def decode_image(data: bytes, what: str = "image") -> np.ndarray:
    """An encoded image's pixels, as `read_image` returns a file's: PNG by
    the port's decoder, any other format through PIL."""
    if data[:8] == _SIGNATURE:
        return _decode_png(data, what)
    return _decode_pil(data, what)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _encode_png(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth = 0, 16
        raw = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8 and (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (2, 3, 4))):
        ctype = 0 if img.ndim == 2 else {2: 4, 3: 2, 4: 6}[img.shape[2]]
        depth = 8
        raw = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"write_image: cannot write a {img.dtype} image of shape {img.shape} "
                         "as PNG (uint16 (H, W), or uint8 (H, W) / (H, W, 2|3|4))")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), raw], axis=1)  # filter type 0
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def read_image(path: str) -> np.ndarray:
    """uint8 (H, W, 3) colour or uint16/uint8 (H, W) greyscale/depth."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_image(data, path)


def write_image(path: str, img: np.ndarray) -> None:
    """A PNG of unfiltered rows: uint16 (H, W) as 16-bit grey, uint8 (H, W)
    as 8-bit grey, (H, W, 2|3|4) uint8 as grey+alpha, RGB or RGBA."""
    data = _encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def read_depth(path: str, depth_scale: float = 1000.0) -> np.ndarray:
    """Metric float32 depth from a 16-bit PNG (TUM scale 5000, Redwood 1000)."""
    return read_image(path).astype(np.float32) / depth_scale


def write_depth(path: str, depth: np.ndarray, depth_scale: float = 1000.0) -> None:
    d = np.clip(np.asarray(depth, np.float64) * depth_scale, 0, 65535).astype(np.uint16)
    write_image(path, d)
