"""Minimal PNG codec (numpy + zlib): 8-bit, non-interlaced images.

Replaces OpenCV for the package's image IO and keeps its conventions:
images are (H, W, 3) uint8 in **BGR** channel order, ``read_png`` drops an
alpha channel and expands grayscale and palette images to three channels.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type → samples per pixel (8-bit depth only)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(filename: str, image) -> None:
    """Write an (H, W, 3) BGR (or (H, W) gray) uint8 image as PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = img.astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
        img = img[..., ::-1]                       # BGR → RGB
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(filename, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (spec section 9)."""
    raw = np.frombuffer(data, np.uint8).reshape(h, row_bytes + 1)
    out = np.zeros((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        kind, cur = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = cur.copy()
        elif kind == 1:      # Sub: running sum along each channel, mod 256
            row = (np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint32)
                   .astype(np.uint8).reshape(-1))
        elif kind == 2:      # Up
            row = cur + prev
        elif kind in (3, 4):  # Average / Paeth: sequential along the row
            row = bytearray(cur.tobytes())
            up = prev.tobytes()
            for i in range(row_bytes):
                a = row[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    row[i] = (row[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
            row = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = row
        prev = row
    return out


def read_png(filename: str) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG as an (H, W, 3) BGR uint8 array.

    Raises ``ValueError`` for a file that is not such a PNG.
    """
    with open(filename, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{filename}: not a PNG file")
    pos, idat, palette, header = len(_SIGNATURE), [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{filename}: missing IHDR")
    w, h, depth, color_type, _comp, _filt, interlace = header
    if depth != 8 or interlace != 0 or color_type not in _CHANNELS:
        raise ValueError(f"{filename}: only 8-bit non-interlaced PNGs are "
                         f"supported (depth {depth}, color type {color_type},"
                         f" interlace {interlace})")
    ch = _CHANNELS[color_type]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if color_type == 3:
        if palette is None:
            raise ValueError(f"{filename}: palette image without PLTE")
        rgb = palette[px[..., 0]]
    elif ch <= 2:                                  # gray (+ alpha)
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:                                          # RGB (+ alpha)
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])   # RGB → BGR
