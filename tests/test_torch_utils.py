"""The port's ``utils`` (PNG codec, PSNR/SSIM, conversions, logger) against
the JAX package's ``utils`` on the same numpy-seeded inputs."""

import logging
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from ntire2022_esr_tpu.utils import image as jimg
from ntire2022_esr_tpu.utils import metrics as jmetrics
from ntire2022_esr_tpu_torch.utils import image as pimg
from ntire2022_esr_tpu_torch.utils import logger as plogger
from ntire2022_esr_tpu_torch.utils import metrics as pmetrics

FILTERS = {
    "default": None,
    "none": cv2.IMWRITE_PNG_FILTER_NONE,
    "sub": cv2.IMWRITE_PNG_FILTER_SUB,
    "up": cv2.IMWRITE_PNG_FILTER_UP,
    "avg": cv2.IMWRITE_PNG_FILTER_AVG,
    "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
    "all": cv2.IMWRITE_PNG_ALL_FILTERS,
}
# odd sizes; the smooth image makes adaptive filtering choose a mix
SHAPES = {"gray": (33, 41), "rgb": (17, 23, 3), "rgba": (19, 13, 4), "row": (1, 9, 3),
          "column": (11, 1, 3)}


def _image(rng, shape, smooth):
    if not smooth:
        return rng.randint(0, 256, shape).astype(np.uint8)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = 120 + 50 * np.sin(xx / 3.0) + 40 * np.cos(yy / 5.0)
    if len(shape) == 3:
        base = base[..., None] + 10 * np.arange(shape[2])
    return np.clip(base + rng.randint(-3, 4, shape), 0, 255).astype(np.uint8)


def _cv2_write(path, img, flt):
    """What JAX ``imsave`` writes (BGR order on disk made RGB again), with
    a chosen PNG row filter; 4-channel arrays are written as RGBA files."""
    params = [] if flt is None else [cv2.IMWRITE_PNG_FILTER, flt]
    arr = img[:, :, [2, 1, 0, 3][:img.shape[2]]] if img.ndim == 3 else img
    assert cv2.imwrite(path, arr, params)


def _filter_counts(path):
    with open(path, "rb") as fh:
        data = fh.read()
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + length])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    w, h, _, color, *_ = header
    ch = {0: 1, 2: 3, 6: 4}[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w * ch + 1)
    return np.bincount(raw[:, 0], minlength=5)


@pytest.mark.parametrize("flt", list(FILTERS))
@pytest.mark.parametrize("kind", list(SHAPES))
def test_png_reads_what_cv2_writes(tmp_path, rng, kind, flt):
    img = _image(rng, SHAPES[kind], smooth=True)
    path = str(tmp_path / "a.png")
    _cv2_write(path, img, FILTERS[flt])
    out = pimg.imread_uint(path)
    np.testing.assert_array_equal(out, jimg.imread_uint(path))
    expect = np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img[:, :, :3]
    np.testing.assert_array_equal(out, expect)
    assert out.dtype == np.uint8


def test_png_avg_and_paeth_rows_are_exercised(tmp_path, rng):
    """The cases above reach every row filter of the decoder's C helper:
    cv2's files of Avg and Paeth rows as well as of Sub and Up rows."""
    img = _image(rng, SHAPES["rgb"], smooth=True)
    for flt, row_type in (("avg", 3), ("paeth", 4), ("sub", 1), ("up", 2)):
        path = str(tmp_path / f"{flt}.png")
        _cv2_write(path, img, FILTERS[flt])
        counts = _filter_counts(path)
        assert counts[row_type] > 0, (flt, counts)


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "hw1", "row"])
def test_png_written_by_port_reads_in_cv2(tmp_path, rng, kind):
    shape = {"gray": (33, 41), "rgb": (17, 23, 3), "rgba": (19, 13, 4), "hw1": (15, 7, 1),
             "row": (1, 9, 3)}[kind]
    img = _image(rng, shape, smooth=False)
    path = str(tmp_path / "a.png")
    pimg.imsave(img, path)
    jpath = str(tmp_path / "j.png")
    jimg.imsave(img, jpath)
    np.testing.assert_array_equal(jimg.imread_uint(path), jimg.imread_uint(jpath))
    np.testing.assert_array_equal(pimg.imread_uint(path), jimg.imread_uint(path))
    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    sq = np.squeeze(img)
    np.testing.assert_array_equal(raw, sq[:, :, [2, 1, 0]] if sq.ndim == 3 else sq)


def test_png_gray_as_one_channel(tmp_path, rng):
    img = _image(rng, (9, 14), smooth=False)
    path = str(tmp_path / "g.png")
    pimg.imsave(img, path)
    np.testing.assert_array_equal(pimg.imread_uint(path, n_channels=1),
                                  jimg.imread_uint(path, n_channels=1))


def _filter_rows(img, ftypes):
    """PNG's five row filters applied to uint8 (H, W, C) ``img``, one type
    a row, byte by byte as the specification states them."""
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = np.zeros_like(rows)
    for r in range(h):
        for i in range(w * ch):
            a = rows[r, i - ch] if i >= ch else 0
            b = rows[r - 1, i] if r else 0
            c = rows[r - 1, i - ch] if r and i >= ch else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[ftypes[r]]
            out[r, i] = (rows[r, i] - pred) % 256
    return out.astype(np.uint8)


def _png_bytes(img, ftypes):
    """A PNG file of ``img`` whose rows carry the filters ``ftypes``."""
    h, w, ch = img.shape
    raw = np.concatenate([np.asarray(ftypes, np.uint8)[:, None], _filter_rows(img, ftypes)], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[ch], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + pimg._chunk(b"IHDR", header)
            + pimg._chunk(b"IDAT", zlib.compress(raw.tobytes())) + pimg._chunk(b"IEND", b""))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _pack(img, depth):
    """(H, W, 1) samples of ``depth`` bits -> (H, row bytes, 1), the first
    sample in the high bits of a byte, each row padded to whole bytes."""
    if depth == 8:
        return img
    h, w, _ = img.shape
    bits = (img[:, :, :1] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, w * depth).astype(np.uint8), axis=1)[:, :, None]


def _png_file(img, color, depth=8, interlace=0, chunks=()):
    """A PNG file of ``img`` (samples, or palette indexes for colour type 3)
    written by the specification: Adam7's passes where ``interlace``, each
    filtered by its own rows, the five filters in turn, then ``chunks``
    (kind, body) before IDAT."""
    h, w, _ = img.shape
    raw = []
    for k, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace else ((0, 0, 1, 1),)):
        rows = _pack(img[y0::dy, x0::dx], depth)
        if rows.size == 0:
            continue
        ftypes = ((np.arange(rows.shape[0]) + k) % 5).astype(np.uint8)
        raw.append(np.concatenate([ftypes[:, None], _filter_rows(rows, ftypes)], 1).reshape(-1))
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + pimg._chunk(b"IHDR", header)
            + b"".join(pimg._chunk(kind, body) for kind, body in chunks)
            + pimg._chunk(b"IDAT", zlib.compress(np.concatenate(raw).tobytes()))
            + pimg._chunk(b"IEND", b""))


def _cv2_unchanged_rgb(path):
    """cv2's ``IMREAD_UNCHANGED`` in RGB(A) order."""
    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if raw.ndim == 2:
        return raw[:, :, None]
    return raw[:, :, [2, 1, 0, 3][:raw.shape[2]]]


def _check_against_cv2(path, want):
    """The decode equals ``want`` and cv2's ``IMREAD_UNCHANGED``; the reads
    equal JAX's ``imread_uint`` in colour and in gray."""
    with open(path, "rb") as fh:
        got = pimg.png_decode(fh.read())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _cv2_unchanged_rgb(path))
    for n in (3, 1):
        np.testing.assert_array_equal(pimg.imread_uint(path, n), jimg.imread_uint(path, n))


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("trns", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_png_palette_matches_cv2(tmp_path, rng, depth, trns, interlace):
    """Colour type 3: the indexes looked up in PLTE, RGB, or RGBA with
    tRNS's alpha (entries past it opaque), as cv2 reads them; at every
    palette depth, plain and Adam7-interlaced."""
    n = min(2 ** depth, 200)
    plte = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    idx = rng.randint(0, n, (19, 13, 1)).astype(np.uint8)
    chunks = [(b"PLTE", plte.tobytes())]
    want = plte[idx[:, :, 0]]
    if trns:
        alpha = rng.randint(0, 256, max(1, n // 2)).astype(np.uint8)
        chunks.append((b"tRNS", alpha.tobytes()))
        full = np.full(n, 255, np.uint8)
        full[:alpha.size] = alpha
        want = np.concatenate([want, full[idx[:, :, 0]][:, :, None]], axis=2)
    path = str(tmp_path / "p.png")
    with open(path, "wb") as fh:
        fh.write(_png_file(idx, 3, depth, interlace, chunks))
    _check_against_cv2(path, want)


@pytest.mark.parametrize("shape", [(19, 13), (3, 9), (1, 1), (8, 2)])
@pytest.mark.parametrize("ch", [1, 3, 4])
def test_png_adam7_matches_cv2(tmp_path, rng, ch, shape):
    """Adam7-interlaced gray, RGB and RGBA with all five filters, at sizes
    with empty passes (1x1 has only the first)."""
    img = rng.randint(0, 256, shape + (ch,)).astype(np.uint8)
    path = str(tmp_path / "i.png")
    with open(path, "wb") as fh:
        fh.write(_png_file(img, {1: 0, 3: 2, 4: 6}[ch], interlace=1))
    _check_against_cv2(path, img)


def test_png_palette_errors():
    """A palette image without PLTE, or with an index past it, raises."""
    idx = np.full((4, 4, 1), 3, np.uint8)
    with pytest.raises(ValueError, match="no PLTE"):
        pimg.png_decode(_png_file(idx, 3))
    with pytest.raises(ValueError, match="entry 3 of a 2-entry palette"):
        pimg.png_decode(_png_file(idx, 3, chunks=[(b"PLTE", bytes(6))]))


@pytest.mark.parametrize("ch", [1, 3, 4])
@pytest.mark.parametrize("filters", ["none", "sub", "up", "avg", "paeth", "mixed"])
def test_c_unfilter_matches_wavefront_and_zlib_reference(rng, filters, ch):
    """The C helper undoes each filter and any mix of them, bit-equal to the
    wavefront (its plain version) and to the image the file was made of."""
    h, w = 23, 17
    img = _image(rng, (h, w, ch) if ch > 1 else (h, w), smooth=True).reshape(h, w, ch)
    types = {"none": 0, "sub": 1, "up": 2, "avg": 3, "paeth": 4}
    ftypes = (rng.randint(0, 5, h) if filters == "mixed"
              else np.full(h, types[filters])).astype(np.uint8)
    np.testing.assert_array_equal(pimg.png_decode(_png_bytes(img, ftypes)), img)
    rows = _filter_rows(img, ftypes).reshape(h, w, ch)
    np.testing.assert_array_equal(pimg._unfilter_c(ftypes, rows), img)
    np.testing.assert_array_equal(pimg._unfilter_wavefront(ftypes, rows), img)


def test_c_unfilter_on_noise_and_strided_rows(rng):
    """Uniform noise, one and two pixel wide images, and rows read in place
    from the inflated buffer (a row stride of W*C + 1)."""
    for ch in (1, 3, 4):
        for h, w in ((9, 1), (1, 2), (31, 29)):
            raw = rng.randint(0, 256, (h, 1 + w * ch)).astype(np.uint8)
            raw[:, 0] = rng.randint(0, 5, h)
            ftypes, rows = raw[:, 0], raw[:, 1:].reshape(h, w, ch)
            np.testing.assert_array_equal(pimg._unfilter_c(ftypes, rows),
                                          pimg._unfilter_wavefront(ftypes, rows))
    bad = np.array([4, 7], np.uint8)
    with pytest.raises(ValueError, match="row 1 has filter type 7"):
        pimg._unfilter_c(bad, np.zeros((2, 3, 3), np.uint8))


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray"])
def test_png_gray_read_matches_cv2(tmp_path, rng, kind):
    """``imread_uint(n_channels=1)`` of a colour file equals cv2's
    ``IMREAD_GRAYSCALE`` (alpha ignored), on files the port's codec wrote
    (RGB) and files cv2 wrote (RGBA, with mixed filters)."""
    shape = {"rgb": (37, 29, 3), "rgba": (21, 33, 4), "gray": (13, 11)}[kind]
    img = _image(rng, shape, smooth=False)
    path = str(tmp_path / "c.png")
    if kind == "rgba":
        _cv2_write(path, img, FILTERS["all"])
    else:
        pimg.imsave(img, path)
    out = pimg.imread_uint(path, n_channels=1)
    assert out.shape == shape[:2] + (1,) and out.dtype == np.uint8
    np.testing.assert_array_equal(out[:, :, 0], cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(out, jimg.imread_uint(path, n_channels=1))


def test_png_errors(tmp_path, rng):
    with pytest.raises(FileNotFoundError):
        pimg.imread_uint(str(tmp_path / "missing.png"))
    path = str(tmp_path / "a.png")
    pimg.imsave(_image(rng, (5, 6, 3), smooth=False), path)
    data = bytearray(open(path, "rb").read())
    with pytest.raises(ValueError, match="not a PNG"):
        pimg.png_decode(b"BM" + bytes(data[2:]))
    data[40] ^= 0xFF  # inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        pimg.png_decode(bytes(data))
    deep = str(tmp_path / "d.png")
    cv2.imwrite(deep, rng.randint(0, 65536, (4, 5, 3)).astype(np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        pimg.imread_uint(deep)
    with pytest.raises(TypeError):
        pimg.png_encode(np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="only PNG"):
        pimg.imsave(np.zeros((3, 3), np.uint8), str(tmp_path / "a.bmp"))


def _pair(rng, shape):
    a = rng.randint(0, 256, shape).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.randint(-20, 21, shape), 0, 255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("border", [0, 4])
@pytest.mark.parametrize("shape", [(48, 52, 3), (40, 37), (33, 45, 1)])
def test_psnr_ssim_match_jax(rng, shape, border):
    a, b = _pair(rng, shape)
    assert abs(pmetrics.calculate_psnr(a, b, border) - jmetrics.calculate_psnr(a, b, border)) < 1e-9
    assert abs(pmetrics.calculate_ssim(a, b, border) - jmetrics.calculate_ssim(a, b, border)) < 1e-9
    assert pmetrics.calculate_psnr(a, a, border) == float("inf")
    assert abs(pmetrics.calculate_ssim(a, a, border) - 1.0) < 1e-12


def test_metrics_reject_mismatched_shapes(rng):
    a, b = _pair(rng, (20, 20, 3))
    for fn in (pmetrics.calculate_psnr, pmetrics.calculate_ssim):
        with pytest.raises(ValueError, match="same dimensions"):
            fn(a, b[:-1])
    with pytest.raises(ValueError, match="Wrong input"):
        pmetrics.calculate_ssim(np.zeros((20, 20, 2)), np.zeros((20, 20, 2)))


def test_gaussian_kernel_is_opencvs():
    # OpenCV's exp is its own, so the last bit may differ
    np.testing.assert_allclose(pmetrics.gaussian_kernel(11, 1.5),
                               cv2.getGaussianKernel(11, 1.5)[:, 0], rtol=1e-15, atol=0)


def test_conversions_bit_identical(rng):
    u = rng.randint(0, 256, (21, 23, 3)).astype(np.uint8)
    for dr in (1.0, 255.0):
        np.testing.assert_array_equal(pimg.uint2nhwc(u, dr), jimg.uint2nhwc(u, dr))
        np.testing.assert_array_equal(pimg.uint2nhwc(u[..., 0], dr), jimg.uint2nhwc(u[..., 0], dr))
    # outputs on and off the round-half ties, out of range, and f16
    y = (rng.randint(-40, 600, (1, 9, 11, 3)) / 2.0).astype(np.float32)
    y[0, 0, :3, 0] = [0.5, 1.5, 2.5]
    for dr in (1.0, 255.0):
        v = y * (dr / 255.0)
        np.testing.assert_array_equal(pimg.nhwc2uint(v, dr), jimg.nhwc2uint(v, dr))
        np.testing.assert_array_equal(pimg.nhwc2uint(v.astype(np.float16), dr),
                                      jimg.nhwc2uint(v.astype(np.float16), dr))
    assert list(pimg.nhwc2uint(np.array([0.5, 1.5, 2.5], np.float32), 255.0)) == [0, 2, 2]
    for s in (2, 3, 4):
        np.testing.assert_array_equal(pimg.modcrop(u, s), jimg.modcrop(u, s))
    np.testing.assert_array_equal(pimg.shave(u, 3), jimg.shave(u, 3))


@pytest.mark.parametrize("mode", range(8))
def test_augment_modes_match_jax(rng, mode):
    u = rng.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    out = pimg.augment_img(u, mode)
    np.testing.assert_array_equal(out, jimg.augment_img(u, mode))
    np.testing.assert_array_equal(pimg.inverse_augment_img(out, mode), u)


def test_logger_info_is_idempotent(tmp_path):
    name = "torch-utils-logger-test"
    path = str(tmp_path / "x.log")
    log = logging.getLogger(name)
    log.propagate = False  # pytest's capture handlers sit on the root logger
    plogger.logger_info(name, log_path=path)
    plogger.logger_info(name, log_path=path)
    assert len(log.handlers) == 2
    log.info("hello")
    for h in log.handlers:
        h.flush()
    assert "hello" in open(path).read()
    assert len(plogger.timestamp()) == len("261016-221500")
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()
    assert os.path.exists(path)
