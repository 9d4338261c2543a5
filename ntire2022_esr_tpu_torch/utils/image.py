"""Host-side image I/O and uint8 <-> float conversions, NHWC (counterpart of
``ntire2022_esr_tpu/utils/image.py``).

Images are read and written by the PNG codec in this module, built on
``zlib`` and ``struct``: it reads 8-bit gray, RGB and RGBA images and
palette images of 1, 2, 4 or 8 bits, plain or Adam7-interlaced, with all
five row filters, and writes 8-bit gray and RGB. It is the only codec; no
image library is needed. The row filters are undone
by a host C helper (``csrc/png_unfilter.c``, compiled at first use): Avg
and Paeth rows depend on the byte to their left, so numpy cannot undo them
a row at a time. Its plain version is :func:`_unfilter_wavefront`.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from ntire2022_esr_tpu_torch.ops.kernels import build

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (gray, RGB, palette index, RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}
_PALETTE = 3
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_FILTER_UP = 2


def _unfilter_wavefront(ftypes: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Undo any mix of the five filters.

    Pixel (r, c) needs (r, c-1), (r-1, c) and (r-1, c-1), so step ``t``
    reconstructs every pixel with ``r + c == t`` at once. In the padded
    (H+1, W+1) image flattened by pixel, those pixels lie ``W`` apart, so
    each step works on strided views: H + W - 1 steps of a few array
    operations instead of H * W scalar ones.
    """
    h, w, ch = rows.shape
    raw = np.zeros((h + 1, w + 1, ch), np.int16)
    raw[1:, 1:] = rows
    out = np.zeros_like(raw)
    raw = raw.reshape(-1, ch)
    flat = out.reshape(-1, ch)
    ft = ftypes.astype(np.int16)[:, None]
    for t in range(h + w - 1):
        r0, r1 = max(0, t - w + 1), min(h - 1, t)
        i0 = r0 * w + w + 2 + t  # flat index of pixel (r0, t - r0) in the padded image
        cur = slice(i0, i0 + (r1 - r0) * w + 1, w)
        a = flat[i0 - 1:cur.stop - 1:w]          # left
        b = flat[i0 - w - 1:cur.stop - w - 1:w]  # up
        c = flat[i0 - w - 2:cur.stop - w - 2:w]  # up-left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ft[r0:r1 + 1]
        pred = np.where(f == 4, paeth, np.where(f == 3, (a + b) >> 1,
                        np.where(f == 2, b, np.where(f == 1, a, 0))))
        flat[cur] = (raw[cur] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def _unfilter_c(ftypes: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Undo any mix of the five filters, a row at a time, in
    ``csrc/png_unfilter.c``. ``rows`` is (H, W, C) uint8 whose pixels and
    channels are contiguous within a row (a row stride of its own is fine)."""
    h, w, ch = rows.shape
    packed = all(n == 1 or st == want for n, st, want in zip((w, ch), rows.strides[1:], (ch, 1)))
    if rows.dtype != np.uint8 or not packed or ftypes.shape != (h,):
        raise ValueError("rows must be (H, W, C) uint8, contiguous within each row")
    ftypes = np.ascontiguousarray(ftypes, np.uint8)
    out = np.empty((h, w, ch), np.uint8)
    lib = build.load_host("png_unfilter")
    fn = lib.png_unfilter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    fn.restype = ctypes.c_int
    bad = fn(ftypes.ctypes.data, rows.ctypes.data, rows.strides[0], out.ctypes.data, h, w * ch, ch)
    if bad < 0:
        raise ValueError(f"png_unfilter refused {ch} bytes a pixel or ran out of memory")
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {int(ftypes[bad - 1])} (above 4)")
    return out


def _samples(block: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """One (sub)image's filtered rows (filter byte first) -> (H, W, C) uint8
    samples; samples of 1, 2 or 4 bits are unpacked, first sample in the
    high bits."""
    h = block.shape[0]
    ftypes, rows = block[:, 0], block[:, 1:]
    if depth == 8:
        return _unfilter_c(ftypes, rows.reshape(h, w, ch))
    packed = _unfilter_c(ftypes, rows.reshape(h, -1, 1)).reshape(h, -1)
    bits = np.unpackbits(packed, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[:, :, None]


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, C): C = 1 for gray, 3 for RGB and 4 for
    RGBA; a palette image comes out RGB, or RGBA where it has a tRNS chunk,
    as ``cv2.imread(IMREAD_UNCHANGED)`` reads it (in RGB order). A tRNS
    colour key of a gray or RGB image is ignored."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat, plte, trns = 8, None, [], None, None
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG file has no IHDR or no IDAT chunk")
    w, h, depth, color, _, _, interlace = header
    depths = (1, 2, 4, 8) if color == _PALETTE else (8,)
    if depth not in depths or color not in _CHANNELS or interlace not in (0, 1):
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace} (8-bit gray/RGB/RGBA or a palette only)")
    if color == _PALETTE and plte is None:
        raise ValueError("PNG palette image has no PLTE chunk")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = np.empty((h, w, ch), np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no bytes, not even filter bytes
        n = ph * ((pw * ch * depth + 7) // 8 + 1)
        if pos + n > raw.size:
            break
        img[y0::dy, x0::dx] = _samples(raw[pos:pos + n].reshape(ph, -1), pw, ch, depth)
        pos += n
    if pos != raw.size:
        raise ValueError("PNG image data does not match its header")
    if color == _PALETTE:
        idx = img[:, :, 0]
        if idx.max() >= len(plte):
            raise ValueError(f"PNG pixel indexes entry {int(idx.max())} of a "
                             f"{len(plte)}-entry palette")
        if trns is None:
            return plte[idx]
        alpha = np.full(len(plte), 255, np.uint8)
        alpha[:len(trns)] = trns[:len(plte)]
        return np.concatenate([plte, alpha[:, None]], axis=1)[idx]
    return img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def png_encode(img: np.ndarray, level: int = 1) -> bytes:
    """uint8 (H, W) gray or (H, W, 3) RGB -> PNG bytes (every row Up-filtered)."""
    if img.dtype != np.uint8:
        raise TypeError(f"PNG writes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"PNG writes (H, W) gray or (H, W, 3) RGB, got {img.shape}")
    h, w, ch = img.shape
    rows = np.ascontiguousarray(img).reshape(h, w * ch)
    filtered = np.empty((h, w * ch + 1), np.uint8)
    filtered[:, 0] = _FILTER_UP
    filtered[:, 1:] = rows
    filtered[1:, 1:] -= rows[:-1]  # wraps mod 256
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), level)) + _chunk(b"IEND", b""))


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def to_gray(img: np.ndarray) -> np.ndarray:
    """RGB or RGBA uint8 (H, W, C) -> (H, W, 1) gray, alpha ignored, as
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` reads a colour PNG: libpng's
    conversion with its default weights in 15-bit fixed point,
    ``(9797 R + 19234 G + 3737 B) >> 15`` (0.299, 0.587, 0.114 truncated)."""
    r, g, b = (img[:, :, k].astype(np.uint32) for k in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)[:, :, None]


def imread_uint(path: str, n_channels: int = 3) -> np.ndarray:
    """Read a PNG as HxWx3 RGB uint8 (gray is repeated, alpha dropped), or
    as HxWx1 gray when ``n_channels == 1`` (a colour file through
    :func:`to_gray`)."""
    try:
        with open(path, "rb") as fh:
            img = png_decode(fh.read())
    except FileNotFoundError:
        raise FileNotFoundError(path) from None
    if n_channels == 1:
        return img if img.shape[2] == 1 else to_gray(img)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return img[:, :, :3]


def imsave(img: np.ndarray, path: str) -> None:
    """Save an RGB (or gray) uint8 image as PNG; channels past 3 are dropped."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only PNG is written")
    img = np.squeeze(img)
    if img.ndim == 3:
        img = img[:, :, :3]
    with open(path, "wb") as fh:
        fh.write(png_encode(img))


def uint2nhwc(img: np.ndarray, data_range: float = 1.0) -> np.ndarray:
    """uint8 HWC -> float32 NHWC scaled to [0, data_range]: u8 / (255/DR)."""
    if img.ndim == 2:
        img = np.expand_dims(img, axis=2)
    return (img.astype(np.float32) / (255.0 / data_range))[None]


def nhwc2uint(arr: np.ndarray, data_range: float = 1.0) -> np.ndarray:
    """float NHWC (or HWC) model output -> uint8 HWC: clamp to [0, DR],
    rescale to [0, 255], numpy's round half to even."""
    arr = np.squeeze(np.asarray(arr, dtype=np.float32))
    arr = np.clip(arr, 0, data_range) * (255.0 / data_range)
    return np.round(arr).astype(np.uint8)


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W down to multiples of ``scale``."""
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale, ...]


def shave(img: np.ndarray, border: int = 0) -> np.ndarray:
    h, w = img.shape[:2]
    return img[border : h - border, border : w - border]


# The 8 dihedral transforms of an image: mode -> (k, flip), k quarter turns
# of np.rot90 on (H, W), then upside down if ``flip``. The x8 ensemble
# applies the same table to NHWC tensors.
DIHEDRAL = {0: (0, False), 1: (1, True), 2: (0, True), 3: (3, False),
            4: (2, True), 5: (1, False), 6: (2, False), 7: (3, True)}
INVERSE_MODE = {0: 0, 1: 1, 2: 2, 3: 5, 4: 4, 5: 3, 6: 6, 7: 7}


def augment_img(img: np.ndarray, mode: int = 0) -> np.ndarray:
    """One of the 8 dihedral transforms of an HWC or HW array."""
    if mode not in DIHEDRAL:
        raise ValueError(f"mode must be in 0..7, got {mode}")
    k, flip = DIHEDRAL[mode]
    img = np.rot90(img, k) if k else img
    return np.flipud(img) if flip else img


def inverse_augment_img(img: np.ndarray, mode: int = 0) -> np.ndarray:
    """Undo :func:`augment_img`."""
    return augment_img(img, INVERSE_MODE[mode])
