"""PNG encode and decode with the standard library (zlib, struct) and numpy.

The card's machine has no cv2 or imageio, so the port reads and writes
PNGs itself. ``decode_png`` reads what ``cv2.imread`` reads: every colour
type (0 grey, 2 RGB, 3 palette with ``PLTE`` and ``tRNS``, 4 grey+alpha,
6 RGBA), every bit depth the type allows (1/2/4/8/16), both interlace
methods (none, Adam7) and every row filter (0 None, 1 Sub, 2 Up,
3 Average, 4 Paeth). It returns the image as cv2 gives it, in RGB(A)
order: ``decode_png(data)`` as ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``
and ``decode_png(data, color=True)`` as ``cv2.imread(path)``
(``IMREAD_COLOR``). ``encode_png`` writes unfiltered rows of RGB, RGBA or
8-bit greyscale.

Row filters are undone without a Python loop over bytes: None, Sub and Up
rows one row at a time with numpy, and each run of Average and Paeth rows
along its anti-diagonals. A byte of such a row needs the reconstructed
bytes to its left, above and above-left, which all lie on earlier
diagonals, so a run of n rows of P pixels takes n + P - 1 numpy steps.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel in the file
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 RGB or RGBA, or (H, W) uint8 greyscale -> PNG
    bytes (filter 0 on every row)."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4) or img.dtype != np.uint8:
        raise ValueError(f"need (H, W) or (H, W, 3|4) uint8, got {img.shape} {img.dtype}")
    H, W, C = img.shape
    raw = np.zeros((H, 1 + C * W), np.uint8)
    raw[:, 1:] = img.reshape(H, C * W)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, {1: 0, 3: 2, 4: 6}[C], 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _wavefront(raw: np.ndarray, prev: np.ndarray, paeth: np.ndarray) -> np.ndarray:
    """Undo Average (paeth False) and Paeth (True) on a run of n rows of P
    pixels of bpp bytes: raw (n, P, bpp) and prev, the reconstructed row
    above the run (P, bpp). Row i's pixel p is step i + p + 2 of a skewed
    array K[t, i + 1] (row 0: the row above; two zero pixels on the left),
    so its left, upper and upper-left neighbours are K[t - 1, i + 1],
    K[t - 1, i] and K[t - 2, i]. One step a diagonal, in place in
    preallocated scratch, the Paeth choice made by arithmetic on masks
    (numpy's masked selection costs several times a ufunc call here)."""
    n, P, bpp = raw.shape
    T = n + P + 2
    K = np.zeros((T, n + 1, bpp), np.int16)
    K[1 : P + 1, 0] = prev
    i = np.arange(n)[:, None]
    t = i + np.arange(P)[None, :] + 2
    R = np.zeros((T, n, bpp), np.int16)
    R[t, i] = raw
    mixed = bool(paeth.any()) and not bool(paeth.all())
    avg = (~paeth[:, None]).astype(np.int16)
    U, V, PA, PB, PC = (np.empty((n, bpp), np.int16) for _ in range(5))
    M1, M2 = np.empty((n, bpp), bool), np.empty((n, bpp), bool)
    for s in range(2, T):
        i0, i1 = max(0, s - P - 1), min(n, s - 1)  # rows whose pixel s - i - 2 exists
        m = i1 - i0
        a, b, c = K[s - 1, i0 + 1 : i1 + 1], K[s - 1, i0:i1], K[s - 2, i0:i1]
        u, v = U[:m], V[:m]
        if paeth[0] or mixed:
            pa, pb, pc, m1, m2 = PA[:m], PB[:m], PC[:m], M1[:m], M2[:m]
            np.subtract(a, c, out=u)  # p - b, with p = a + b - c
            np.subtract(b, c, out=v)  # p - a
            np.add(u, v, out=pc)  # p - c
            np.abs(pc, out=pc)
            np.abs(v, out=pa)
            np.abs(u, out=pb)
            np.less_equal(pa, pb, out=m1)
            np.less_equal(pa, pc, out=m2)
            np.logical_and(m1, m2, out=m1)  # a is nearest (ties: a, then b)
            np.less_equal(pb, pc, out=m2)
            np.greater(m2, m1, out=m2)  # b is nearest
            np.multiply(u, m1, out=u)
            np.multiply(v, m2, out=v)
            np.add(u, v, out=u)
            np.add(u, c, out=u)  # the prediction
            if mixed:  # Average rows of the run: (a + b) >> 1 in their place
                np.add(a, b, out=v)
                np.right_shift(v, 1, out=v)
                np.subtract(v, u, out=v)
                np.multiply(v, avg[i0:i1], out=v)
                np.add(u, v, out=u)
        else:
            np.add(a, b, out=u)
            np.right_shift(u, 1, out=u)
        dst = K[s, i0 + 1 : i1 + 1]
        np.add(R[s, i0:i1], u, out=dst)
        np.bitwise_and(dst, 0xFF, out=dst)
    return K[t, i + 1]


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + rowbytes) filtered rows -> (h, rowbytes) uint8
    reconstructed bytes; bpp = bytes a pixel (at least 1)."""
    h, rb = raw.shape[0], raw.shape[1] - 1
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        y = int(np.argmax(ftype > 4))
        raise ValueError(f"unknown PNG row filter {ftype[y]} on row {y}")
    P = -(-rb // bpp)
    data = np.zeros((h, P * bpp), np.int16)  # whole pixels: a ragged tail byte is padded
    data[:, :rb] = raw[:, 1:]
    data = data.reshape(h, P, bpp)
    out = np.zeros((h, P, bpp), np.int16)
    prev = np.zeros((P, bpp), np.int16)
    y = 0
    while y < h:
        f = ftype[y]
        if f >= 3:  # a run of Average / Paeth rows
            e = y
            while e < h and ftype[e] >= 3:
                e += 1
            out[y:e] = _wavefront(data[y:e], prev, ftype[y:e] == 4)
            y = e
        else:
            if f == 0:
                out[y] = data[y]
            elif f == 1:  # Sub: a running sum of each byte lane along the row
                out[y] = np.cumsum(data[y], axis=0) & 0xFF
            else:  # Up
                out[y] = (data[y] + prev) & 0xFF
            y += 1
        prev = out[y - 1]
    return out.reshape(h, P * bpp)[:, :rb].astype(np.uint8)


def _samples(rows: np.ndarray, w: int, spp: int, depth: int) -> np.ndarray:
    """(h, rowbytes) reconstructed bytes -> (h, w, spp) samples, uint8 or
    uint16 (16-bit, big-endian in the file); low depths unpacked MSB first."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, : w * spp].reshape(h, w, spp)
    if depth == 16:
        v = rows[:, : 2 * w * spp].astype(np.uint16)
        return ((v[:, 0::2] << 8) | v[:, 1::2]).reshape(h, w, spp)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    v = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return v.reshape(h, -1)[:, : w * spp].reshape(h, w, spp).astype(np.uint8)


def _header(data: bytes) -> tuple[tuple, bytes | None, bytes | None, bytes]:
    """Check the signature and every chunk's CRC; returns (IHDR fields,
    PLTE, tRNS, the concatenated IDAT data)."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {tag!r}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = body
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    return hdr, plte, trns, b"".join(idat)


def decode_png(data: bytes, color: bool = False) -> np.ndarray:
    """PNG bytes -> the image as ``cv2.imread`` gives it, in RGB(A) order.

    ``color=False`` (``IMREAD_UNCHANGED``): grey (H, W); RGB (H, W, 3), or
    (H, W, 4) with a ``tRNS`` key colour as alpha (0 on the key, the
    maximum elsewhere); palette expanded to (H, W, 3), or (H, W, 4) with
    ``tRNS`` alphas; grey+alpha as (H, W, 4) (g, g, g, a); RGBA (H, W, 4).
    uint16 at bit depth 16, else uint8; grey at depth 1/2/4 scaled to
    0..255. ``color=True`` (``IMREAD_COLOR``): (H, W, 3) uint8 RGB, grey
    repeated, alpha and ``tRNS`` dropped, 16-bit samples cut to their
    high byte."""
    (W, H, depth, ctype, comp, filt, interlace), plte, trns, idat = _header(data)
    if ctype not in _SAMPLES or depth not in _DEPTHS[ctype]:
        raise ValueError(f"invalid PNG: colour type {ctype} at bit depth {depth}")
    if comp != 0 or filt != 0 or interlace not in (0, 1):
        raise ValueError(f"invalid PNG: compression {comp}, filter {filt}, interlace {interlace}")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG without PLTE")
    spp = _SAMPLES[ctype]
    bits = depth * spp
    stream = np.frombuffer(zlib.decompress(idat), np.uint8)
    img = np.zeros((H, W, spp), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        w, h = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if w <= 0 or h <= 0:
            continue
        rb = -(-w * bits // 8)
        raw = stream[pos : pos + h * (1 + rb)]
        if raw.size != h * (1 + rb):
            raise ValueError("PNG image data is truncated")
        pos += h * (1 + rb)
        rows = _unfilter(raw.reshape(h, 1 + rb), max(1, bits // 8))
        img[y0::dy, x0::dx] = _samples(rows, w, spp, depth)
    if ctype == 3:
        idx = img[..., 0]
        pal = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        if idx.max(initial=0) >= len(pal):
            raise ValueError("palette index past the PLTE entries")
        rgb = pal[idx]
        if trns is None or color:
            return rgb
        alpha = np.full(len(pal), 255, np.uint8)
        alpha[: min(len(trns), len(pal))] = np.frombuffer(trns, np.uint8)[: len(pal)]
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
    if depth < 8:  # grey at 1/2/4 bits, scaled to 0..255
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if color:
        if depth == 16:
            img = (img >> 8).astype(np.uint8)
        return np.repeat(img[..., :1], 3, axis=-1) if ctype in (0, 4) else img[..., :3]
    top = np.iinfo(img.dtype).max
    if ctype == 0:
        return img[..., 0]
    if ctype == 4:
        return np.concatenate([np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], axis=-1)
    if ctype == 2 and trns is not None:
        key = np.array(struct.unpack(">HHH", trns[:6]), np.uint16)
        if depth == 8:
            key = key & 0xFF
        alpha = np.where((img == key.astype(img.dtype)).all(-1), 0, top).astype(img.dtype)
        return np.concatenate([img, alpha[..., None]], axis=-1)
    return img
