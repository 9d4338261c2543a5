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
    """The cases above reach both of the decoder's paths: files of Avg and
    Paeth rows (the wavefront) and of None/Sub/Up rows (row by row)."""
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
