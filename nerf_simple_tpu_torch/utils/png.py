"""8-bit PNG encode and decode with the standard library (zlib, struct).

The card's machine has no cv2 or imageio, so the port reads and writes
PNGs itself. ``decode_png`` takes what image writers produce for 8-bit
truecolour images: RGB or RGBA, non-interlaced, every row filter of the
PNG specification (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth).
``encode_png`` writes unfiltered rows.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type -> channels (RGB, RGBA)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 RGB or RGBA -> PNG bytes (filter 0 on every row)."""
    if img.ndim != 3 or img.shape[2] not in (3, 4) or img.dtype != np.uint8:
        raise ValueError(f"need (H, W, 3|4) uint8, got {img.shape} {img.dtype}")
    H, W, C = img.shape
    raw = np.zeros((H, 1 + C * W), np.uint8)
    raw[:, 1:] = img.reshape(H, C * W)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2 if C == 3 else 6, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter_sequential(ftype: int, line: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) in place: each byte needs the one
    reconstructed ``bpp`` bytes before it."""
    for x in range(len(line)):
        a = line[x - bpp] if x >= bpp else 0
        b = prior[x]
        if ftype == 3:
            line[x] = (line[x] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[x] = (line[x] + pred) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) or (H, W, 4) uint8, as stored. Checks the
    signature and every chunk's CRC; raises on what it does not take
    (other bit depths, palettes, greyscale, interlacing)."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {tag!r}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"only 8-bit non-interlaced RGB/RGBA PNGs (got depth {depth}, "
            f"colour type {ctype}, interlace {interlace})"
        )
    C = _CHANNELS[ctype]
    stride = C * W
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + stride)
    out = np.empty((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            rec = line
        elif ftype == 1:  # Sub: a running sum of each channel along the row
            rec = np.cumsum(line.reshape(W, C).astype(np.uint64), axis=0).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            rec = line + prior
        elif ftype in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_sequential(int(ftype), buf, prior.tobytes(), C)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {ftype} on row {y}")
        out[y] = rec
        prior = out[y]
    return out.reshape(H, W, C)
