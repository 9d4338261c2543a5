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


# -- the reference helpers of utils/image.py, utils/logger.py, the resize,
# -- harness.data.discover_pairs, the registry's ids and the per-layer MACs

def test_single_uint_converters_match_jax(rng):
    u = rng.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    f = (rng.rand(5, 7, 3) * 1.4 - 0.2).astype(np.float32)
    u16 = rng.randint(0, 65536, (4, 6)).astype(np.uint16)
    for name, arg in (("uint2single", u), ("uint2single1", u[None]), ("single2uint", f),
                      ("uint162single", u16), ("single2uint16", f), ("single2nhwc", f),
                      ("single2nhwc", f[..., 0]), ("nhwc2single", f[None]),
                      ("nhwc2single3", f[None, ..., :1])):
        ours, theirs = getattr(pimg, name)(arg), getattr(jimg, name)(arg)
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, name
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    # a tensor is taken as its values
    import torch
    np.testing.assert_array_equal(pimg.nhwc2single(torch.from_numpy(f[None])),
                                  jimg.nhwc2single(f[None]))


@pytest.mark.parametrize("shape,out_type", [((1, 4, 5, 3), np.uint8), ((4, 3, 3, 3), np.uint8),
                                            ((5, 3, 2, 3), np.float32), ((4, 4), np.uint8),
                                            ((6, 5), np.float32)])
def test_tensor2img_matches_jax(rng, shape, out_type):
    arr = (rng.rand(*shape) * 1.4 - 0.2).astype(np.float32)
    ours = pimg.tensor2img(arr, out_type=out_type, min_max=(-0.1, 1.1))
    theirs = jimg.tensor2img(arr, out_type=out_type, min_max=(-0.1, 1.1))
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(TypeError):
        pimg.tensor2img(np.zeros((2, 2, 2, 2, 2), np.float32))


def test_image_grid_matches_jax(rng):
    batch = rng.rand(5, 3, 4, 2).astype(np.float32)
    for nrow, padding in ((2, 2), (3, 0), (5, 1)):
        np.testing.assert_array_equal(pimg._image_grid(batch, nrow, padding),
                                      jimg._image_grid(batch, nrow, padding))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_ycbcr_matches_jax(rng, dtype):
    img = rng.randint(0, 256, (6, 5, 3)).astype(np.uint8)
    if dtype == np.float32:
        img = img.astype(np.float32) / 255.0
    for ours, theirs in ((pimg.rgb2ycbcr(img, True), jimg.rgb2ycbcr(img, True)),
                         (pimg.rgb2ycbcr(img, False), jimg.rgb2ycbcr(img, False)),
                         (pimg.bgr2ycbcr(img, True), jimg.bgr2ycbcr(img, True)),
                         (pimg.bgr2ycbcr(img, False), jimg.bgr2ycbcr(img, False)),
                         (pimg.ycbcr2rgb(img), jimg.ycbcr2rgb(img))):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def test_channel_convert_matches_cv2_and_jax(rng):
    """The gray step is OpenCV's ``BGR2GRAY``: on uint8 its 15-bit fixed
    point, equal for all 2**24 colours; on float32 within one f32 ulp of
    the result (OpenCV's own order of the three products and sums)."""
    v = np.arange(1 << 24, dtype=np.uint32)
    every = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    every = every.reshape(4096, 4096, 3)
    np.testing.assert_array_equal(pimg.bgr2gray(every), cv2.cvtColor(every, cv2.COLOR_BGR2GRAY))
    u = rng.randint(0, 256, (7, 9, 3)).astype(np.uint8)
    f = rng.rand(7, 9, 3).astype(np.float32)
    for imgs in ([u], [f, f[::-1]]):
        for tar in ("gray", "y", "RGB"):
            ours, theirs = pimg.channel_convert(3, tar, imgs), jimg.channel_convert(3, tar, imgs)
            assert len(ours) == len(theirs)
            for a, b in zip(ours, theirs):
                assert a.shape == b.shape and a.dtype == b.dtype
                np.testing.assert_allclose(a, b, rtol=2.0 ** -23, atol=0)
    assert pimg.channel_convert(3, "RGB", [u]) == [u]
    gray = [u[..., 0], u[..., :1]]
    for a, b in zip(pimg.channel_convert(1, "RGB", gray), jimg.channel_convert(1, "RGB", gray)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", range(8))
def test_augment_variants_match_jax(rng, mode):
    import torch

    img = rng.rand(3, 5, 2).astype(np.float32)
    np.testing.assert_array_equal(pimg.augment_img_np3(img, mode), jimg.augment_img_np3(img, mode))
    arr = rng.rand(2, 3, 5, 3).astype(np.float32)
    want = jimg.augment_img_nhwc(arr, mode)
    np.testing.assert_array_equal(pimg.augment_img_nhwc(arr, mode), want)
    np.testing.assert_array_equal(pimg.augment_img_nhwc(arr[0], mode), jimg.augment_img_nhwc(
        arr[0], mode))
    t = pimg.augment_img_nhwc(torch.from_numpy(arr), mode)
    assert isinstance(t, torch.Tensor) and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), want)
    with pytest.raises(ValueError):
        pimg.augment_img_np3(img, 8)


def test_augment_imgs_matches_jax(rng):
    import random

    imgs = [rng.rand(3, 5, 2).astype(np.float32), rng.rand(3, 5, 1).astype(np.float32)]
    for seed in range(8):
        for hflip, rot in ((True, True), (False, True), (True, False)):
            ours = pimg.augment_imgs(imgs, hflip, rot, rng=random.Random(seed))
            theirs = jimg.augment_imgs(imgs, hflip, rot, rng=random.Random(seed))
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)


def test_read_img_matches_cv2(tmp_path, rng):
    """BGR float32 in [0, 1] as JAX's ``read_img`` (``cv2.imread``) gives
    it, for RGB, RGBA (alpha dropped) and gray files."""
    for kind in ("rgb", "rgba", "gray"):
        img = _image(rng, SHAPES[kind], smooth=False)
        path = str(tmp_path / f"{kind}.png")
        _cv2_write(path, img, None)
        ours, theirs = pimg.read_img(path), jimg.read_img(path)
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(FileNotFoundError):
        pimg.read_img(str(tmp_path / "missing.png"))


def test_directory_helpers(tmp_path):
    a, b = str(tmp_path / "p"), str(tmp_path / "q")
    pimg.mkdirs([a, b])
    pimg.mkdirs(str(tmp_path / "r"))
    assert all(os.path.isdir(d) for d in (a, b, str(tmp_path / "r")))
    (tmp_path / "p" / "f").write_text("keep")
    pimg.mkdir_and_rename(a)
    assert os.path.isdir(a) and not os.path.exists(os.path.join(a, "f"))
    archived = [d for d in os.listdir(tmp_path) if d.startswith("p_archived_")]
    assert len(archived) == 1 and os.path.exists(os.path.join(tmp_path, archived[0], "f"))
    assert len(pimg.get_timestamp()) == len(jimg.get_timestamp()) == len("261016-221500")


def test_imshow_imports_matplotlib_when_called(monkeypatch):
    """No matplotlib import until the call; there it draws (here on the
    non-interactive backend), and it raises where matplotlib is missing."""
    import sys

    import matplotlib

    matplotlib.use("Agg")
    pimg.imshow(np.zeros((4, 5, 1), np.float32), title="t", cbar=True)
    import matplotlib.pyplot as plt

    plt.close("all")
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError):
        pimg.imshow(np.zeros((4, 5), np.float32))


def test_logger_print_tee(tmp_path, capsys):
    import sys

    path = str(tmp_path / "tee.log")
    tee = plogger.logger_print(path)
    old = sys.stdout
    sys.stdout = tee
    try:
        print("hello tee")
        tee.flush()
    finally:
        sys.stdout = old
        tee.close()
    assert open(path).read() == "hello tee\n"
    assert "hello tee" in capsys.readouterr().out


def test_discover_pairs_matches_jax(tmp_path):
    from ntire2022_esr_tpu.harness import data as jdata
    from ntire2022_esr_tpu_torch.harness import data as pdata

    for sub in ("LR", "HR"):
        os.makedirs(tmp_path / sub)
        for name in ("b.png", "a.PNG", "c.bmp", "notes.txt", "d.jpg"):
            (tmp_path / sub / name).write_bytes(b"0")
    pairs = pdata.discover_pairs(str(tmp_path))
    assert pairs == jdata.discover_pairs(str(tmp_path))
    assert [os.path.basename(lr) for lr, _ in pairs] == ["a.PNG", "b.png", "c.bmp", "d.jpg"]
    (tmp_path / "HR" / "e.png").write_bytes(b"0")
    with pytest.raises(ValueError, match="count mismatch"):
        pdata.discover_pairs(str(tmp_path))


def test_available_ids_match_jax():
    from ntire2022_esr_tpu.harness import registry as jregistry
    from ntire2022_esr_tpu_torch.harness import registry as pregistry

    ids = pregistry.available_ids()
    assert ids == jregistry.available_ids() and len(ids) == 42
    assert [s.model_id for s in pregistry.all_specs()] == ids
    assert [s.name for s in pregistry.all_specs()] == [s.name for s in jregistry.all_specs()]


def test_imresize_matlab_matches_goldens_and_jax():
    """The numpy form (f64) and the tensor form (two f32 products) against
    the reference's ``imresize`` (tests/goldens/resize_matlab.npz) and the
    JAX package's functions, HWC and NHWC."""
    import torch

    from ntire2022_esr_tpu.ops import resize as jresize
    from ntire2022_esr_tpu_torch.ops import resize as presize

    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "resize_matlab.npz"))
    img = g["input"]
    for scale, key in ((0.25, "np_0_25"), (0.5, "np_0_5"), (2.0, "np_2_0"), (4.0, "np_4_0")):
        ours = presize.imresize_matlab_np(img, scale)
        assert ours.shape == g[key].shape and ours.dtype == np.float32
        np.testing.assert_allclose(ours, g[key], atol=2e-6)
        np.testing.assert_array_equal(ours, jresize.imresize_matlab_np(img, scale))
        t = presize.imresize_matlab(torch.from_numpy(img.astype(np.float32)), scale).numpy()
        np.testing.assert_allclose(t, g[key], atol=2e-6)
        np.testing.assert_allclose(t, np.asarray(jresize.imresize_matlab(img.astype(np.float32),
                                                                         scale)), atol=1e-6)
    for scale, key in ((0.25, "t_0_25"), (4.0, "t_4_0")):
        np.testing.assert_allclose(presize.imresize_matlab_np(img, scale), g[key], atol=2e-6)
    batch = np.stack([img, img[::-1]]).astype(np.float32)
    nhwc = presize.imresize_matlab(torch.from_numpy(batch), 0.5).numpy()
    assert nhwc.shape == (2, 19, 27, 3)
    np.testing.assert_allclose(nhwc[1], presize.imresize_matlab_np(img[::-1], 0.5), atol=1e-6)
    gray = presize.imresize_matlab_np(img[..., 0], 0.5)
    np.testing.assert_array_equal(gray, jresize.imresize_matlab_np(img[..., 0], 0.5))


@pytest.mark.parametrize("mid", [4, 18])
def test_per_layer_macs_match_jax(mid):
    """The rows of RLFN and of BSRN (whose pointwise convs are linears) at
    16x16: the same MACs in the same order, the same labels (the weight's
    parameter name, ``<activation>`` or ``<attention/matmul>``) and kinds;
    a conv's label string whole (its shape part too), a matmul's name and
    contracted size (its output shape is the aten op's, which folds the
    batch axes, not the JAX einsum's)."""
    from collections import Counter

    from ntire2022_esr_tpu.harness import registry as jregistry
    from ntire2022_esr_tpu.harness import summary as jsummary
    from ntire2022_esr_tpu_torch.harness import registry as pregistry
    from ntire2022_esr_tpu_torch.harness import summary as psummary

    apply, params, *_ = jregistry.build_model(mid, apply_load_transform=False)
    ref = jsummary.per_layer_macs(apply, params, (16, 16))
    model = pregistry.build_model(mid, device="cpu")[0]
    rows = psummary.per_layer_macs(model, (16, 16))
    assert [r[0] for r in rows] == [r[0] for r in ref]

    def key(rs):
        return Counter((m, lab if kind == "conv" else lab.split(" -> ")[0], kind)
                       for m, lab, kind in rs)

    assert key(rows) == key(ref)
    assert sum(1 for _, lab, _ in rows if lab.startswith("<")) == sum(
        1 for _, lab, _ in ref if lab.startswith("<"))
    report = psummary.per_layer_report(model, (16, 16), top=3)
    assert report.splitlines()[1].endswith(rows[0][1]) and len(report.splitlines()) == 4


def test_per_layer_macs_follow_w8_and_storage_casts():
    """Under w8 a conv's weight reaches the contraction through the
    dequant's multiply, and under fasthi16 its input through a cast: the
    rows keep the parameter names of the f32 parity count."""
    import torch

    from ntire2022_esr_tpu_torch import config
    from ntire2022_esr_tpu_torch.harness import registry as pregistry
    from ntire2022_esr_tpu_torch.harness import summary as psummary

    want = psummary.per_layer_macs(pregistry.build_model(4, device="cpu")[0], (16, 16))
    prev = config.weights_int8()
    try:
        config.set_weights_int8(True)
        w8 = pregistry.build_model(4, device="cpu")[0]
    finally:
        config.set_weights_int8(prev)
    assert w8.B1.c1_r.weight.dtype == torch.int8
    assert psummary.per_layer_macs(w8, (16, 16)) == want
    with config.numerics_mode("fasthi16"):
        assert psummary.per_layer_macs(w8, (16, 16)) == want
