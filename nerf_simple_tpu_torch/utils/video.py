"""Video writers without cv2 or imageio, for the orbit video.

``open_video`` takes ``ffmpeg`` from PATH when there is one and pipes raw
RGB frames to it: ``<stem>.mp4`` in the ``mpeg4`` codec (MPEG-4 Part 2,
what cv2's ``mp4v`` fourcc writes). Without ffmpeg it writes an
uncompressed RGB AVI (``<stem>.avi``: 24-bit DIB frames, with an idx1
index) with ``struct``. It prints which writer it chose. ``read_avi``
reads such an AVI back.
"""

from __future__ import annotations

import shutil
import struct
import subprocess

import numpy as np


class _FfmpegWriter:
    def __init__(self, ffmpeg: str, path: str, W: int, H: int, fps: int):
        self.path = path
        cmd = [ffmpeg, "-y", "-loglevel", "error", "-f", "rawvideo", "-pix_fmt", "rgb24",
               "-s", f"{W}x{H}", "-r", str(fps), "-i", "-",
               "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",  # yuv420p needs even sides
               "-c:v", "mpeg4", "-q:v", "2", "-pix_fmt", "yuv420p", path]
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)

    def write(self, frame: np.ndarray) -> None:
        self._proc.stdin.write(np.ascontiguousarray(frame).tobytes())

    def close(self) -> None:
        self._proc.stdin.close()
        if self._proc.wait() != 0:
            raise RuntimeError(f"ffmpeg failed writing {self.path} (exit {self._proc.returncode})")


def _chunk_header(fourcc: bytes, size: int) -> bytes:
    return fourcc + struct.pack("<I", size)


class AviWriter:
    """Uncompressed RGB AVI: bottom-up BGR rows padded to 4 bytes, one
    ``00db`` chunk a frame. The counts and sizes in the headers are
    written at ``close``."""

    def __init__(self, path: str, W: int, H: int, fps: int):
        self.path, self.W, self.H, self.fps = path, W, H, fps
        self.row = (3 * W + 3) // 4 * 4
        self.frame_bytes = self.row * H
        self.n = 0
        self._fh = open(path, "wb")
        self._fh.write(self._headers())

    def _headers(self) -> bytes:
        W, H, n, fb = self.W, self.H, self.n, self.frame_bytes
        avih = struct.pack("<14I", 1_000_000 // self.fps, fb * self.fps, 0, 0x10, n, 0, 1, fb,
                           W, H, 0, 0, 0, 0)
        strh = (b"vids" + b"DIB " + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, 1, self.fps, 0, n, fb,
                                                -1, 0) + struct.pack("<4h", 0, 0, W, H))
        strf = struct.pack("<IiiHHIIiiII", 40, W, H, 1, 24, 0, fb, 0, 0, 0, 0)
        strl = (b"strl" + _chunk_header(b"strh", len(strh)) + strh
                + _chunk_header(b"strf", len(strf)) + strf)
        hdrl = (b"hdrl" + _chunk_header(b"avih", len(avih)) + avih
                + _chunk_header(b"LIST", len(strl)) + strl)
        movi_size = 4 + n * (8 + fb)
        riff_size = 4 + 8 + len(hdrl) + 8 + movi_size + 8 + 16 * n
        return (_chunk_header(b"RIFF", riff_size) + b"AVI " + _chunk_header(b"LIST", len(hdrl))
                + hdrl + _chunk_header(b"LIST", movi_size) + b"movi")

    def write(self, frame: np.ndarray) -> None:
        if frame.shape != (self.H, self.W, 3) or frame.dtype != np.uint8:
            raise ValueError(f"need ({self.H}, {self.W}, 3) uint8, got {frame.shape} {frame.dtype}")
        rows = np.zeros((self.H, self.row), np.uint8)
        rows[:, : 3 * self.W] = frame[::-1, :, ::-1].reshape(self.H, 3 * self.W)
        self._fh.write(_chunk_header(b"00db", self.frame_bytes) + rows.tobytes())
        self.n += 1

    def close(self) -> None:  # idx1 offsets count from the 'movi' fourcc
        idx = b"".join(b"00db" + struct.pack("<III", 0x10, 4 + i * (8 + self.frame_bytes),
                                             self.frame_bytes) for i in range(self.n))
        self._fh.write(_chunk_header(b"idx1", len(idx)) + idx)
        self._fh.seek(0)
        self._fh.write(self._headers())
        self._fh.close()


def open_video(stem: str, W: int, H: int, fps: int = 15):
    """A writer of (H, W, 3) uint8 RGB frames at ``fps``: ``.write(frame)``,
    ``.close()``, ``.path``. ffmpeg (mpeg4 .mp4) when on PATH, else an
    uncompressed RGB .avi."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg:
        print(f"video writer: ffmpeg ({ffmpeg}), codec mpeg4 -> {stem}.mp4")
        return _FfmpegWriter(ffmpeg, stem + ".mp4", W, H, fps)
    print(f"video writer: no ffmpeg on PATH, uncompressed RGB AVI -> {stem}.avi")
    return AviWriter(stem + ".avi", W, H, fps)


def read_avi(path: str) -> tuple[np.ndarray, int]:
    """An uncompressed 24-bit AVI (as ``AviWriter`` writes it) -> ((n, H,
    W, 3) uint8 RGB frames, fps)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI")
    W = H = fps = None
    frames = []

    def walk(lo: int, hi: int) -> None:
        nonlocal W, H, fps
        pos = lo
        while pos + 8 <= hi:
            tag, (size,) = data[pos : pos + 4], struct.unpack("<I", data[pos + 4 : pos + 8])
            body = pos + 8
            if tag == b"LIST":
                walk(body + 4, body + size)
            elif tag == b"strh":
                fps = struct.unpack("<I", data[body + 24 : body + 28])[0]
            elif tag == b"strf":
                _, W, H, _, bits, comp = struct.unpack("<IiiHHI", data[body : body + 20])
                if bits != 24 or comp != 0 or H <= 0:
                    raise ValueError(f"{path}: only bottom-up 24-bit uncompressed frames")
            elif tag in (b"00db", b"00dc"):
                row = (3 * W + 3) // 4 * 4
                rows = np.frombuffer(data[body : body + row * H], np.uint8).reshape(H, row)
                frames.append(rows[::-1, : 3 * W].reshape(H, W, 3)[:, :, ::-1])
            pos = body + size + (size & 1)

    walk(12, len(data))
    return np.stack(frames) if frames else np.zeros((0, H or 0, W or 0, 3), np.uint8), fps
