"""PNG reader and writer in numpy, the standard library's zlib and a few
lines of host C.

The datasets the drivers read ship PNG frames: 8-bit grey (KITTI odometry,
EuRoC MAV), 8-bit RGB or RGBA (TUM RGB-D `rgb/`) and 16-bit grey (TUM
`depth/`, depth x DepthMapFactor). The JAX package reads them through PIL
(`orb_slam2_detailed_comments_tpu/io/datasets.py:17-32`); this package
has its own codec, so it needs no imaging library on any machine.

`read_png` decodes exactly those formats, non-interlaced, with any of the
five row filters; anything else (palette, grey + alpha, interlace, other
bit depths) raises ValueError naming the file, so a wrong image is never
returned. The row filters are undone by `csrc/png_unfilter.c`, which is
compiled with the system's C compiler at the first read (`_library`):
Average and Paeth rows, which libpng and PIL write into most files,
decode serially along each row. `to_gray` converts RGB(A) to grey as PIL's
`convert("L")` does, bit for bit. `write_png` writes 8-bit grey, 8-bit
RGB and 16-bit grey, choosing each row's filter among all five as libpng
does by default.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (grey, RGB, RGBA); the bit depths read are 8, and 16 for grey
_CHANNELS = {0: 1, 2: 3, 6: 4}
_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "png_unfilter.c"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
_CFLAGS = ("-O2", "-shared", "-fPIC", "-std=c99")


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRCs checked."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG ends before its IEND chunk")


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays (PNG spec, section 9.4)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


_lib = None
_LIB_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    """csrc/png_unfilter.c, compiled at first use with the system's C
    compiler ($CC, else cc or gcc) into the git-ignored build/host/ and
    loaded. The file name carries a hash of the source and flags, and a
    build goes through a temporary file, so processes that build at once
    neither clash nor load half a library."""
    global _lib
    with _LIB_LOCK:
        if _lib is not None:
            return _lib
        src = _SOURCE.read_bytes()
        digest = hashlib.sha256(" ".join(_CFLAGS).encode() + src).hexdigest()[:16]
        so = _BUILD_DIR / f"libpng_unfilter_{digest}.so"
        if not so.exists():
            cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
            if not cc:
                raise RuntimeError("io/png.py needs a C compiler (cc, gcc or $CC) to build "
                                   f"{_SOURCE.name}")
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            res = subprocess.run([cc, *_CFLAGS, "-o", str(tmp), str(_SOURCE)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{cc} failed on {_SOURCE.name} ({res.returncode}):\n"
                                   f"{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_void_p]
        lib.png_unfilter.restype = ctypes.c_int
        _lib = lib
        return _lib


def _unfilter(rows: np.ndarray, bpp: int, path: str) -> np.ndarray:
    """Undo the row filters. rows: (H, 1 + stride) uint8, each row's filter
    type and its filtered bytes. Returns (H, stride) uint8."""
    rows = np.ascontiguousarray(rows)
    H, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((H, stride), np.uint8)
    bad = _library().png_unfilter(rows.ctypes.data, H, stride, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"{path}: unknown PNG row filter {int(rows[bad - 1, 0])}")
    return out


def _image_rows(path: str):
    """(W, H, depth, channels, rows) of a PNG file: its header, checked, and
    its decompressed rows, (H, 1 + W * bytes a pixel) uint8 with each row's
    filter type first."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or (depth == 16 and ctype != 0):
        raise ValueError(f"{path}: unsupported PNG format (colour type {ctype}, "
                         f"{depth}-bit); read are 8-bit grey, RGB, RGBA and 16-bit grey")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown PNG compression or filter method")
    channels = _CHANNELS[ctype]
    stride = W * channels * depth // 8
    try:
        buf = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    if len(buf) < H * (stride + 1):
        raise ValueError(f"{path}: PNG image data too short")
    rows = np.frombuffer(buf, np.uint8, H * (stride + 1)).reshape(H, stride + 1)
    return W, H, depth, channels, rows


def row_filters(path: str) -> np.ndarray:
    """(5,) count of the file's rows by filter type: None, Sub, Up, Average,
    Paeth."""
    rows = _image_rows(path)[-1]
    return np.bincount(rows[:, 0], minlength=5)[:5]


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file: (H, W) uint8 grey, (H, W) uint16 grey,
    (H, W, 3) uint8 RGB or (H, W, 4) uint8 RGBA. Raises ValueError for any
    other format, an interlaced file or a corrupt one."""
    W, H, depth, channels, rows = _image_rows(path)
    pix = _unfilter(rows, channels * depth // 8, path)
    if depth == 16:
        return pix.view(">u2").reshape(H, W).astype(np.uint16)
    return pix.reshape((H, W, channels) if channels > 1 else (H, W))


def to_gray(img: np.ndarray) -> np.ndarray:
    """An RGB or RGBA uint8 image as grey, as PIL's convert("L") computes it
    (ITU-R 601-2 luma in PIL's integer form; alpha ignored). A 2-D image is
    returned as it is."""
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


# |v| of each byte read as a signed one
_ABS_SIGNED = np.minimum(np.arange(256), 256 - np.arange(256)).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write (H, W) uint8 as 8-bit grey, (H, W, 3) uint8 as 8-bit RGB or
    (H, W) uint16 as 16-bit grey. Each row takes the filter among None,
    Sub, Up, Average and Paeth with the least sum of absolute signed bytes
    (libpng's default heuristic), so the files carry the mix of filters
    that other writers' files do."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        ctype, depth, raw = 0, 8, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth, raw = 2, 8, img.reshape(img.shape[0], -1)
    elif img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth = 0, 16
        raw = np.ascontiguousarray(img.astype(">u2")).view(np.uint8).reshape(img.shape[0], -1)
    else:
        raise ValueError(f"{path}: write_png takes (H, W) uint8 or uint16 or (H, W, 3) uint8, "
                         f"not {img.shape} {img.dtype}")
    H, W = img.shape[:2]
    bpp = raw.shape[1] // W
    x = raw.astype(np.int16)
    a = np.zeros_like(x)            # the byte left, the byte up, up and left
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    cands = (np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - _paeth(a, b, c)])
             & 0xFF).astype(np.uint8)                      # (5, H, stride)
    cost = _ABS_SIGNED[cands].sum(-1, dtype=np.uint32)
    best = cost.argmin(0)                                  # (H,)
    rows = cands[best, np.arange(H)]
    payload = np.concatenate([best.astype(np.uint8)[:, None], rows], 1).tobytes()
    with open(path, "wb") as fh:
        fh.write(SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(payload, level)))
        fh.write(_chunk(b"IEND", b""))
