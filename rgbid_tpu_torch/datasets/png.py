"""PNG files in host numpy, on the standard library's ``zlib``.

The TUM and live readers (``tum.py``, ``live.py``) read their frames with
``read_color`` and ``read_unchanged``, which take ``cv2.imread``'s two
flag semantics, and the smoke and the tests write frames with ``write``
(grey u8, RGB u8 and grey u16, one filter type for every row, None by
default).
The port never imports OpenCV.

What is read: 8-bit grey, RGB and RGBA and 16-bit grey (big-endian on
disk, native ``uint16`` here), non-interlaced, with any of the five row
filters. Anything else (interlaced images, bit depths below 8, palette,
grey with alpha, 16-bit colour, a ``tRNS`` chunk) raises ValueError: the
reader refuses an image it would not read as cv2 does, where cv2 reads
them (and other formats, such as JPEG). A file that is damaged or not
written to its end (shorter than its chunks say, a CRC that does not
match, no ``IEND``, a zlib stream that does not end, a filter byte above
4) raises OSError, where ``cv2.imread`` returns None: ``live.py`` takes
an OSError for a PNG that its writer has not finished and retries it.

Unfiltering: None, Sub and Up are vectorised in numpy (Sub as a running
sum mod 256 along the row with a stride of the pixel size, Up along the
column). Avg and Paeth read the finished pixel to their left, so a row is
sequential: they run in the port's native library
(``native/png_unfilter.cpp``, built by ``g++`` at first use, the GIL
released during the call) whenever ``native.toolchain()`` is not None,
as ``place_recognition.hamming_distances`` chooses. The numpy oracle
(``unfilter_numpy``) runs them over the anti-diagonals of a run of such
rows, where every pixel's left, upper and upper-left neighbours are
already final; it is the path where there is no toolchain, and the tests
hold the two equal.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# (colour type, bit depth) -> channels, for what the reader reads.
_LAYOUTS = {(0, 8): 1, (2, 8): 3, (6, 8): 4, (0, 16): 1}
_COLOR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}


class Header(NamedTuple):
    width: int
    height: int
    bit_depth: int
    color_type: int
    channels: int


def _corrupt(path, why: str) -> OSError:
    return OSError(f"{path}: not a complete PNG file ({why})")


def _chunks(data: bytes, path) -> Tuple[Header, bytes]:
    """Walk the chunks; check every CRC; return the header and the joined
    IDAT payload. Raises OSError for a damaged or unfinished file and
    ValueError for a PNG this reader does not read."""
    if len(data) < len(SIGNATURE):
        raise _corrupt(path, f"{len(data)} bytes")
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (only PNG is read)")
    pos, header, idat, seen_end = 8, None, [], False
    while pos < len(data):
        if pos + 8 > len(data):
            raise _corrupt(path, f"chunk header cut at byte {pos}")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if n > 0x7FFFFFFF:
            raise _corrupt(path, f"chunk length {n}")
        end = pos + 8 + n
        if end + 4 > len(data):
            raise _corrupt(path, f"{kind!r} chunk cut at byte {len(data)} of {end + 4}")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + body) != crc:
            raise _corrupt(path, f"CRC of the {kind!r} chunk at byte {pos}")
        if header is None and kind != b"IHDR":
            raise _corrupt(path, f"first chunk is {kind!r}, not IHDR")
        if kind == b"IHDR":
            header = _header(body, path)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            raise ValueError(f"{path}: a tRNS (transparency) chunk is not read")
        elif kind == b"IEND":
            seen_end = True
            break
        pos = end + 4
    if not seen_end:
        raise _corrupt(path, "no IEND chunk")
    if not idat:
        raise _corrupt(path, "no IDAT chunk")
    return header, b"".join(idat)


def _header(body: bytes, path) -> Header:
    if len(body) != 13:
        raise _corrupt(path, f"IHDR of {len(body)} bytes")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    if w == 0 or h == 0 or comp != 0 or filt != 0 or interlace > 1:
        raise _corrupt(path, f"IHDR {w}x{h}, compression {comp}, filter {filt}, "
                             f"interlace {interlace}")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not read")
    if (ctype, depth) not in _LAYOUTS:
        raise ValueError(
            f"{path}: {depth}-bit {_COLOR_NAMES.get(ctype, f'colour type {ctype}')} is not "
            f"read (8-bit grey, RGB or RGBA, or 16-bit grey)")
    return Header(w, h, depth, ctype, _LAYOUTS[ctype, depth])


def _inflate(payload: bytes, size: int, path) -> np.ndarray:
    d = zlib.decompressobj()
    try:
        raw = d.decompress(payload)
    except zlib.error as e:
        raise _corrupt(path, f"zlib: {e}") from e
    if not d.eof:
        raise _corrupt(path, "the zlib stream does not end")
    if len(raw) < size:
        raise _corrupt(path, f"image data of {len(raw)} bytes, {size} expected")
    return np.frombuffer(raw, np.uint8, count=size)


# ---------------------------------------------------------------------------
# Unfiltering


def unfilter_numpy(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered rows -> (h, stride) bytes, in numpy: runs
    of None, Sub and Up rows vectorised, runs of Avg and Paeth rows over
    their anti-diagonals. Filter bytes must be 0-4."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    w = stride // bpp
    ft = raw[:, 0]
    filt = raw[:, 1:].reshape(h, w, bpp)
    out = np.empty((h, w, bpp), np.uint8)
    prev = np.zeros((w, bpp), np.uint8)
    k = 0
    while k < h:
        kind = 3 if ft[k] >= 3 else int(ft[k])
        e = k + 1
        while e < h and (3 if ft[e] >= 3 else int(ft[e])) == kind:
            e += 1
        f = filt[k:e]
        if kind == 0:
            out[k:e] = f
        elif kind == 1:
            np.cumsum(f, axis=1, dtype=np.uint8, out=out[k:e])
        elif kind == 2:
            np.cumsum(f, axis=0, dtype=np.uint8, out=out[k:e])
            out[k:e] += prev
        else:
            out[k:e] = _unfilter_sequential(f, ft[k:e], prev)
        prev = out[e - 1]
        k = e
    return out.reshape(h, stride)


def _unfilter_sequential(f: np.ndarray, ft: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """A run of Avg (3) and Paeth (4) rows ``f`` (m, w, bpp) below the
    finished row ``prev``: the pixels of one anti-diagonal (row + column
    constant) depend only on earlier diagonals, so each diagonal is one
    vector step."""
    m, w, bpp = f.shape
    # E[r + 1, c + 1] is output pixel (r, c); row 0 is prev, column 0 zeros.
    E = np.zeros((m + 1, w + 1, bpp), np.int32)
    E[0, 1:] = prev
    paeth_row = (ft == 4)
    for d in range(m + w - 1):
        r = np.arange(max(0, d - w + 1), min(m - 1, d) + 1)
        c = d - r
        a = E[r + 1, c]
        b = E[r, c + 1]
        cc = E[r, c]
        avg = (a + b) >> 1
        pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
        pae = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        pred = np.where(paeth_row[r][:, None], pae, avg)
        E[r + 1, c + 1] = (f[r, c].astype(np.int32) + pred) & 0xFF
    return E[1:, 1:].astype(np.uint8)


def unfilter(raw: np.ndarray, bpp: int, native: Optional[bool] = None) -> np.ndarray:
    """(h, 1 + stride) filtered rows -> (h, stride) bytes. ``native`` None
    takes the native library where ``native.toolchain()`` finds a compiler
    (a failed build raises), else numpy; True or False forces one."""
    from .. import native as _native

    if native is None:
        native = _native.toolchain() is not None
    if native:
        return _native.png_unfilter(raw, raw.shape[1] - 1, bpp)
    return unfilter_numpy(raw, bpp)


# ---------------------------------------------------------------------------
# Reading


def decode(data: bytes, path="<bytes>", native: Optional[bool] = None) -> np.ndarray:
    """PNG bytes -> the stored array: (H, W) for grey, (H, W, 3) RGB or
    (H, W, 4) RGBA, in the file's channel order; uint8, or uint16 for
    16-bit grey."""
    hd, payload = _chunks(data, path)
    bps = hd.bit_depth // 8
    bpp = hd.channels * bps
    stride = hd.width * bpp
    raw = _inflate(payload, hd.height * (stride + 1), path).reshape(hd.height, stride + 1)
    bad = np.flatnonzero(raw[:, 0] > 4)
    if len(bad):
        raise _corrupt(path, f"row {bad[0]} has filter type {raw[bad[0], 0]}")
    img = unfilter(raw, bpp, native)
    if bps == 2:
        return img.view(">u2").astype(np.uint16).reshape(hd.height, hd.width)
    if hd.channels == 1:
        return img.reshape(hd.height, hd.width)
    return img.reshape(hd.height, hd.width, hd.channels)


def read_unchanged(path, native: Optional[bool] = None) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: the stored array, so a
    16-bit depth PNG comes back (H, W) uint16. Colour comes in the file's
    order (RGB, RGBA), where cv2 gives BGR(A). OSError where cv2 returns
    None for a missing, damaged or unfinished file."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, path, native)


def read_color(path, native: Optional[bool] = None) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_COLOR)`` followed by BGR -> RGB: (H, W,
    3) uint8. Grey is copied into three channels, alpha is dropped, and a
    16-bit grey image keeps its high byte (as cv2 does)."""
    img = read_unchanged(path, native)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


# ---------------------------------------------------------------------------
# Writing


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(body: np.ndarray, bpp: int, filt: int) -> np.ndarray:
    """(h, stride) image bytes -> the same rows under PNG filter ``filt``
    (0-4), each from the unfiltered neighbours, so every row at once."""
    x = body.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if filt == 0:
        pred = np.zeros_like(x)
    elif filt == 1:
        pred = left
    elif filt == 2:
        pred = up
    elif filt == 3:
        pred = (left + up) >> 1
    elif filt == 4:
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"PNG filter types are 0-4, got {filt}")
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode(img: np.ndarray, level: int = 1, filt: int = 0) -> bytes:
    """(H, W) uint8 or uint16 grey, or (H, W, 3) uint8 RGB -> PNG bytes, every
    row with filter ``filt`` (0, None, by default), at zlib ``level``."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        ctype, depth, bpp, body = 0, 8, 1, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth, bpp, body = 2, 8, 3, img.reshape(img.shape[0], -1)
    elif img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth, bpp, body = 0, 16, 2, img.astype(">u2").view(np.uint8)
    else:
        raise ValueError(f"encode writes (H, W) uint8 / uint16 or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.empty((h, 1 + body.shape[1]), np.uint8)
    rows[:, 0] = filt
    # Filter 0 (None) stores the bytes as they are.
    rows[:, 1:] = body if filt == 0 else _filter_rows(body, bpp, filt)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write(path, img: np.ndarray, level: int = 1, filt: int = 0) -> None:
    """Write ``encode(img, level, filt)`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode(img, level, filt))
