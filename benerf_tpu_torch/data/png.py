"""8-bit PNG reading and writing on the standard library.

The port reads and writes every .png through this module (the scene
loaders, the synthetic writer, eval images and video frames), so a machine
without imageio runs the whole port. Reading handles gray, gray + alpha,
RGB and RGBA images at bit depth 8, non-interlaced, and undoes all five
filter types (None, Sub, Up, Average, Paeth). Anything else (palette
images, 16-bit samples, interlacing) raises ValueError instead of being
misread. Writing stores gray, RGB or RGBA uint8 images with filter 0 on
every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (no palette type 3)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def _paeth_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for x in range(len(line)):
        a = line[x - bpp] if x >= bpp else 0
        b = prior[x]
        c = prior[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        line[x] = (line[x] + pred) & 0xFF


def _average_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for x in range(len(line)):
        a = line[x - bpp] if x >= bpp else 0
        line[x] = (line[x] + ((a + prior[x]) >> 1)) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Reconstructed scanlines, (height, stride) uint8."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            rec = line
        elif ftype == 1:  # Sub: a running sum along each sample of a pixel
            rec = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            rec = line + prior
        elif ftype == 3:
            buf = bytearray(line.tobytes())
            _average_row(buf, prior.tobytes(), bpp)
            rec = np.frombuffer(bytes(buf), np.uint8)
        elif ftype == 4:
            buf = bytearray(line.tobytes())
            _paeth_row(buf, prior.tobytes(), bpp)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = rec
        prior = out[y]
    return out


def decode(data: bytes) -> np.ndarray:
    """8-bit PNG bytes -> (H, W) or (H, W, C) uint8 array."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or comp != 0 or filt != 0:
        raise ValueError(f"unsupported PNG header {header} (palette images "
                         "are not supported)")
    if interlace:
        raise ValueError("interlaced PNG files are not supported")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported (8 only)")
    nch = _CHANNELS[ctype]
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * nch, nch)
    img = rows.reshape(height, width, nch)
    return img[..., 0] if nch == 1 else img


def encode(img) -> bytes:
    """(H, W), (H, W, 1), (H, W, 2), (H, W, 3) or (H, W, 4) uint8 -> PNG
    bytes (gray, gray + alpha, RGB, RGBA), filter 0 on every row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"png.encode takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"png.encode: unsupported image shape {img.shape}")
    height, width, nch = img.shape
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(height, width * nch)],
                          axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, _COLOR_TYPE[nch], 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def read(path: str) -> np.ndarray:
    """Read a .png with `decode`; other formats through imageio (a lazy
    import: ImportError where it is not installed)."""
    if path.lower().endswith(".png"):
        with open(path, "rb") as f:
            return decode(f.read())
    try:
        from imageio.v3 import imread
    except ImportError as e:
        raise ImportError(f"reading {path!r} needs imageio, which is not "
                          "installed; only .png files are read without it") from e
    return np.asarray(imread(path))


def write(path: str, img) -> None:
    """Write a uint8 image as a PNG file (see `encode`)."""
    data = encode(img)
    with open(path, "wb") as f:
        f.write(data)
