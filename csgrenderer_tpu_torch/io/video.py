"""Minimal dependency-free animation writer (GIF89a).

A copy of ``csgrenderer_tpu/io/video.py`` (numpy only): the same frames
give the same bytes.

The reference presents frames to a swapchain; our headless equivalent for
the animated configs is a frame-sequence writer. PNG sequences come from
io/image.py; this adds a single-file animation via an uncompressed-friendly
GIF encoder (LZW with clear-code resets, web-safe 216-color palette + grays)
— adequate for previews/goldens without ffmpeg.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_PAL = None


def _palette() -> np.ndarray:
    """216 web-safe colors + 40 grays = 256 entries, [256, 3] uint8."""
    global _PAL
    if _PAL is None:
        levels = np.array([0, 51, 102, 153, 204, 255], np.uint8)
        web = np.array(
            [(r, g, b) for r in levels for g in levels for b in levels],
            np.uint8,
        )
        grays = np.linspace(6, 249, 40).astype(np.uint8)
        grays = np.stack([grays] * 3, axis=1)
        _PAL = np.concatenate([web, grays], axis=0)
    return _PAL


def _quantize(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> palette indices (web-safe rounding; grays to gray ramp)."""
    q = ((img.astype(np.int32) + 25) // 51).clip(0, 5)
    idx = (q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]).astype(np.uint8)
    # route near-gray pixels to the finer gray ramp
    mx = img.max(axis=-1).astype(np.int32)
    mn = img.min(axis=-1).astype(np.int32)
    grayish = (mx - mn) < 12
    g = img.mean(axis=-1)
    gidx = (216 + ((g - 6.0) / (243.0 / 39.0)).clip(0, 39)).astype(np.uint8)
    return np.where(grayish, gidx, idx)


def _lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF LZW with an immediate clear-code strategy (valid, simple)."""
    clear = 1 << min_code_size
    end = clear + 1
    out = bytearray()
    bitbuf = 0
    bitcnt = 0

    def emit(code, size):
        nonlocal bitbuf, bitcnt
        bitbuf |= code << bitcnt
        bitcnt += size
        while bitcnt >= 8:
            out.append(bitbuf & 0xFF)
            bitbuf >>= 8
            bitcnt -= 8

    code_size = min_code_size + 1
    emit(clear, code_size)
    # Simplest valid scheme: emit every pixel as a literal. The decoder's
    # dictionary grows by one entry per received code after the first, from
    # 258 entries; it widens codes at 512, so reset with a clear code safely
    # before 512 - 258 = 254 codes accumulate.
    count = 0
    for v in indices.ravel():
        emit(int(v), code_size)
        count += 1
        if count == 250:
            emit(clear, code_size)
            count = 0
    emit(end, code_size)
    if bitcnt:
        out.append(bitbuf & 0xFF)
    return bytes(out)


def write_gif(path, frames, fps: float = 12.0, loop: bool = True) -> None:
    """Write [H, W, 3]-uint8 frames as an animated GIF."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    delay_cs = max(2, int(round(100.0 / fps)))

    buf = bytearray()
    buf += b"GIF89a"
    buf += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)  # global 256-color table
    buf += _palette().tobytes()
    if loop:
        buf += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        if f.shape[:2] != (h, w):
            raise ValueError("frame size mismatch")
        buf += b"\x21\xf9\x04\x04" + struct.pack("<H", delay_cs) + b"\x00\x00"
        buf += b"\x2c" + struct.pack("<HHHH", 0, 0, w, h) + b"\x00"
        data = _lzw_encode(_quantize(f))
        buf += bytes([8])  # LZW min code size
        for i in range(0, len(data), 255):
            chunk = data[i : i + 255]
            buf += bytes([len(chunk)]) + chunk
        buf += b"\x00"
    buf += b"\x3b"
    Path(path).write_bytes(bytes(buf))
