"""Image IO: PNG/PPM writers (dependency-free) + golden-image comparison.

Copied from ``csgrenderer_tpu/io/image.py`` (numpy only). The PNG encoder
is a minimal valid RGB8 writer over ``zlib``.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path, image_uint8: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array as an RGB8 PNG."""
    img = np.asarray(image_uint8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # RGB8
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    payload = (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", header)
        + _png_chunk(b"IDAT", zlib.compress(raw, 6))
        + _png_chunk(b"IEND", b"")
    )
    Path(path).write_bytes(payload)


def read_png(path) -> np.ndarray:
    """Minimal reader for PNGs written by ``write_png`` (RGB8, non-interlaced)."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", chunk[:10])
            if depth != 8 or ctype != 2:
                raise ValueError("only RGB8 supported")
        elif tag == b"IDAT":
            idat += chunk
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    rows = []
    prev = np.zeros(w * 3, np.uint8)
    for y in range(h):
        row = raw[y * stride : (y + 1) * stride]
        filt, body = row[0], np.frombuffer(row[1:], np.uint8).copy()
        if filt == 0:
            pass
        elif filt == 2:  # Up
            body = (body.astype(np.uint16) + prev).astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        prev = body
        rows.append(body)
    return np.stack(rows).reshape(h, w, 3)


def write_ppm(path, image_uint8: np.ndarray) -> None:
    img = np.asarray(image_uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error over [0,1]-scaled images (golden tolerance
    metric from BASELINE.json: <= 1e-3)."""
    a = np.asarray(a)
    b = np.asarray(b)
    a = a.astype(np.float64) / 255.0 if a.dtype == np.uint8 else a.astype(np.float64)
    b = b.astype(np.float64) / 255.0 if b.dtype == np.uint8 else b.astype(np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))
