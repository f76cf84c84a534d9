"""Time the PNG reader on the host CPU: an 800x800 RGBA image (lego's
size) whose every row uses one row filter, Paeth by default.

    python -m nerf_simple_tpu_torch.probes.png_reader [--filter 4] [--before OLD_PNG_PY]

Prints one JSON line: the best of ``--reps`` decodes in seconds, and
with ``--before`` (the path of another version of ``utils/png.py``, for
instance ``git show <commit>:nerf_simple_tpu_torch/utils/png.py``) that
version's time on the same bytes. Both decodes must return the image
written. These are host-CPU times: they say nothing of the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import platform
import struct
import time
import zlib

import numpy as np

from nerf_simple_tpu_torch.utils.png import decode_png


def filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """(H, W, C) uint8 -> PNG bytes with every row filtered by `ftype`
    (the predictors read the original bytes, so all rows at once)."""
    H, W, C = img.shape
    x = img.reshape(H, W * C).astype(np.int64)
    up = np.vstack([np.zeros((1, W * C), np.int64), x[:-1]])
    a = np.hstack([np.zeros((H, C), np.int64), x[:, :-C]])
    c = np.hstack([np.zeros((H, C), np.int64), up[:, :-C]])
    if ftype == 4:
        p = a + up - c
        pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
    else:
        pred = [np.zeros_like(x), a, up, (a + up) // 2][ftype]
    rows = np.hstack([np.full((H, 1), ftype, np.int64), (x - pred) % 256]).astype(np.uint8)

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, {3: 2, 4: 6}[C], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def best_of(fn, data: bytes, img: np.ndarray, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(data)
        times.append(time.perf_counter() - t0)
        if not np.array_equal(out, img):
            raise RuntimeError("decode does not return the image written")
    return min(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filter", type=int, default=4, choices=range(5))
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--before", help="path of another version of utils/png.py to time beside")
    args = ap.parse_args()
    img = (np.random.default_rng(0).uniform(0, 1, (args.size, args.size, 4)) ** 2 * 255).astype(np.uint8)
    data = filtered_png(img, args.filter)
    res = {"image": f"{args.size}x{args.size} RGBA, filter {args.filter} on every row",
           "host": platform.processor() or platform.machine(),
           "decode_s": best_of(decode_png, data, img, args.reps)}
    if args.before:
        spec = importlib.util.spec_from_file_location("png_before", args.before)
        old = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(old)
        res["before_decode_s"] = best_of(old.decode_png, data, img, args.reps)
        res["speedup"] = res["before_decode_s"] / res["decode_s"]
    print(json.dumps(res))


if __name__ == "__main__":
    main()
