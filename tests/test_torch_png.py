"""The port's PNG codec (``rgbid_tpu_torch/datasets/png.py``) against
OpenCV: ``read_color`` equals ``cv2.imread(IMREAD_COLOR)`` followed by
BGR -> RGB, and ``read_unchanged`` equals ``cv2.imread(IMREAD_UNCHANGED)``
(with the channels in the file's order), bit for bit, for every colour
type the reader reads, every row filter cv2 can be made to write, and
widths 1, 3, 160 and 641; the native and numpy unfilters equal each
other; damaged files raise OSError, unread variants ValueError; the
port's encoder reads back through cv2 bit for bit."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from rgbid_tpu_torch import native
from rgbid_tpu_torch.datasets import png

FILTERS = {
    "none": cv2.IMWRITE_PNG_FILTER_NONE,
    "sub": cv2.IMWRITE_PNG_FILTER_SUB,
    "up": cv2.IMWRITE_PNG_FILTER_UP,
    "avg": cv2.IMWRITE_PNG_FILTER_AVG,
    "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
    "all": cv2.IMWRITE_PNG_ALL_FILTERS,
}
WIDTHS = (1, 3, 160, 641)
NEEDS_GXX = pytest.mark.skipif(native.toolchain() is None, reason="no g++ for the native unfilter")


def _image(kind: str, w: int, seed: int) -> np.ndarray:
    """A test image as cv2 takes it (BGR order for colour): half noise, half
    a smooth ramp, so that the adaptive filter choice takes every filter."""
    rng = np.random.default_rng(seed)
    h = 9 if w < 100 else 60
    ramp = np.add.outer(np.arange(h) * 5, np.arange(w) * 3)
    if kind == "grey16":
        img = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        img[h // 2:] = (ramp[h // 2:] * 37 % 65536).astype(np.uint16)
        return img
    ch = {"grey8": 1, "rgb8": 3, "rgba8": 4}[kind]
    img = rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
    img[h // 2:] = (ramp[h // 2:, :, None] * np.arange(1, ch + 1) % 256).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


def _unchanged_ref(path) -> np.ndarray:
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if ref.ndim == 3:
        ref = ref[..., [2, 1, 0, 3][: ref.shape[2]]]
    return ref


@pytest.mark.parametrize("kind", ["grey8", "rgb8", "rgba8", "grey16"])
@pytest.mark.parametrize("filt", list(FILTERS))
def test_decoder_equals_cv2_imread(kind, filt, tmp_path):
    """Exact equality, both entry points, every width, both unfilters."""
    for w in WIDTHS:
        path = tmp_path / f"{kind}_{filt}_{w}.png"
        assert cv2.imwrite(str(path), _image(kind, w, w), [cv2.IMWRITE_PNG_FILTER, FILTERS[filt]])
        want_u = _unchanged_ref(path)
        want_c = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        for nat in ([False, True] if native.toolchain() else [False]):
            got_u = png.read_unchanged(path, native=nat)
            assert got_u.dtype == want_u.dtype and got_u.shape == want_u.shape
            np.testing.assert_array_equal(got_u, want_u)
            got_c = png.read_color(path, native=nat)
            assert got_c.dtype == np.uint8 and got_c.shape == want_c.shape
            np.testing.assert_array_equal(got_c, want_c)


def _filtered_rows(h: int, stride: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (h, 1 + stride)).astype(np.uint8)
    # Runs of each filter type, and isolated rows between them.
    raw[:, 0] = np.resize([0, 1, 1, 2, 2, 2, 3, 4, 4, 3, 1, 4, 0, 2, 3, 3, 4], h)
    return raw


@NEEDS_GXX
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_native_and_numpy_unfilters_agree(bpp):
    """Every filter type in runs and alone, widths 1 to 641 pixels: equal."""
    for w in (1, 2, 5, 64, 641):
        raw = _filtered_rows(23, w * bpp, seed=w + bpp)
        np.testing.assert_array_equal(png.unfilter(raw, bpp, native=True),
                                      png.unfilter_numpy(raw, bpp))


def test_unfilter_choice_follows_toolchain(monkeypatch):
    """With no compiler the numpy oracle runs and nothing is built."""
    raw = _filtered_rows(6, 12, seed=0)
    monkeypatch.setattr(native, "toolchain", lambda: None)
    monkeypatch.setattr(native, "load", lambda: pytest.fail("native library loaded"))
    np.testing.assert_array_equal(png.unfilter(raw, 3), png.unfilter_numpy(raw, 3))


@pytest.fixture()
def good_png(tmp_path):
    path = tmp_path / "good.png"
    cv2.imwrite(str(path), _image("rgb8", 40, 1))
    return path, path.read_bytes()


def _chunk_offsets(data: bytes):
    pos, out = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        out[kind] = (pos, n)
        pos += 12 + n
    return out


def test_truncated_files_raise_oserror(good_png, tmp_path):
    _, data = good_png
    offsets = _chunk_offsets(data)
    idat, n = offsets[b"IDAT"]
    cuts = [0, 4, 8, 20, 33, idat + 10, idat + 8 + n // 2, idat + 8 + n + 2, len(data) - 12,
            len(data) - 1]
    for cut in cuts:
        bad = tmp_path / f"cut{cut}.png"
        bad.write_bytes(data[:cut])
        assert cv2.imread(str(bad), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(OSError):
            png.read_unchanged(bad)
        with pytest.raises(OSError):
            png.read_color(bad)


def test_bad_crc_missing_iend_and_zlib_errors_raise_oserror(good_png, tmp_path):
    _, data = good_png
    offsets = _chunk_offsets(data)
    idat, n = offsets[b"IDAT"]
    cases = {}
    b = bytearray(data)
    b[idat + 8 + n] ^= 0x5A  # IDAT's CRC
    cases["idat_crc"] = bytes(b)
    b = bytearray(data)
    b[8 + 8 + 3] ^= 0x01  # a byte of IHDR's body
    cases["ihdr_body"] = bytes(b)
    cases["no_iend"] = data[: offsets[b"IEND"][0]]
    # A zlib stream that is corrupt, under a CRC that matches it.
    body = bytearray(data[idat + 8:idat + 8 + n])
    body[2] ^= 0xFF
    body[3] ^= 0xFF
    kind = b"IDAT"
    chunk = struct.pack(">I", n) + kind + bytes(body) + struct.pack(">I", zlib.crc32(kind + bytes(body)))
    cases["zlib"] = data[:idat] + chunk + data[idat + 12 + n:]
    for name, blob in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(blob)
        assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None, name
        with pytest.raises(OSError):
            png.read_unchanged(path)


def test_missing_file_raises_oserror(tmp_path):
    with pytest.raises(FileNotFoundError):
        png.read_color(tmp_path / "absent.png")


def _adam7_png(rgb: np.ndarray) -> bytes:
    """An interlaced (Adam7) 8-bit RGB PNG of ``rgb``, every row filter 0."""
    h, w, _ = rgb.shape
    rows = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                           (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = rgb[y0::dy, x0::dx]
        if sub.size:
            rows += b"".join(b"\0" + r.tobytes() for r in sub)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def test_unread_variants_raise_valueerror(tmp_path):
    """Interlaced, 1-bit, palette and 16-bit colour PNGs (all of which cv2
    reads) are refused, not misread."""
    from PIL import Image

    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (12, 10, 3)).astype(np.uint8)
    cases = {}
    p = tmp_path / "interlaced.png"
    p.write_bytes(_adam7_png(rgb))
    cases["interlaced"] = p
    p = tmp_path / "onebit.png"
    Image.fromarray(rgb[..., 0] > 127).save(p)
    cases["1-bit"] = p
    p = tmp_path / "palette.png"
    Image.fromarray(rgb).convert("P").save(p)
    cases["palette"] = p
    p = tmp_path / "rgb16.png"
    cv2.imwrite(str(p), (rgb.astype(np.uint16) * 257))
    cases["16-bit"] = p
    for name, path in cases.items():
        assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is not None, name
        with pytest.raises(ValueError):
            png.read_unchanged(path)
    # cv2 reads the hand-made interlaced file as the image it holds.
    np.testing.assert_array_equal(cv2.imread(str(cases["interlaced"]))[..., ::-1], rgb)
    p = tmp_path / "not.png"
    cv2.imwrite(str(tmp_path / "not.jpg"), rgb)
    p.write_bytes((tmp_path / "not.jpg").read_bytes())
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_color(p)


@pytest.mark.parametrize("kind", ["grey8", "rgb8", "grey16"])
def test_encoder_round_trips_through_cv2(kind, tmp_path):
    """The port's encoder, with each of the five filter types on every row,
    reads back through cv2 and through the port's decoder bit for bit."""
    for w in WIDTHS:
        img = _image(kind, w, 7 + w)
        if kind == "rgb8":
            img = img[..., ::-1].copy()  # the port writes RGB
        for filt in range(5):
            path = tmp_path / f"{kind}_{w}_{filt}.png"
            png.write(path, img, filt=filt)
            np.testing.assert_array_equal(_unchanged_ref(path), img)
            np.testing.assert_array_equal(png.read_unchanged(path), img)
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4), np.uint8), filt=5)
