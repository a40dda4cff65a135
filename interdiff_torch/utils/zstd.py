"""Decompress one zstd frame (RFC 8878) through the system's ``libzstd``.

The JAX package's orbax saves compress every OCDBT manifest, b-tree node
and zarr chunk with zstd (`utils/ocdbt.py`).  Python 3.12 has no zstd
module, so this binds the shared library with ``ctypes`` and drives its
streaming decoder (``ZSTD_decompressStream``): OCDBT writes its frames
without the content size, so the output grows until the frame ends.

The library is found by ``ctypes.util.find_library("zstd")`` (or by its
soname, ``libzstd.so.1``).  A missing library raises a `RuntimeError` that
names it; nothing falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

LIBRARY = "libzstd.so.1"
_lib: Optional[ctypes.CDLL] = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _candidates():
    found = ctypes.util.find_library("zstd")
    return [found, LIBRARY] if found else [LIBRARY]


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    errors = []
    for name in _candidates():
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError as e:
            errors.append(f"{name}: {e}")
    else:
        raise RuntimeError(
            f"the zstd library ({LIBRARY}) is not installed or not found "
            f"({'; '.join(errors)}); it is needed to read orbax saves")
    lib.ZSTD_createDCtx.restype = ctypes.c_void_p
    lib.ZSTD_createDCtx.argtypes = []
    lib.ZSTD_freeDCtx.restype = ctypes.c_size_t
    lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_decompressStream.restype = ctypes.c_size_t
    lib.ZSTD_decompressStream.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
        ctypes.POINTER(_InBuffer)]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    _lib = lib
    return lib


def decompress(frame: bytes, size_hint: int = 0,
               max_size: int = 1 << 34) -> bytes:
    """The bytes of the one zstd frame ``frame``.  ``size_hint`` sizes the
    first output buffer (the exact size, where the caller knows it, costs
    no copy); the output may not exceed ``max_size``.  Raises `ValueError`
    on a corrupt or truncated frame and on bytes after its end."""
    lib = _load()
    src = ctypes.create_string_buffer(bytes(frame), len(frame))
    inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(frame), 0)
    cap = max(size_hint, 4 * len(frame), 1 << 12)
    dst = ctypes.create_string_buffer(cap)
    outb = _OutBuffer(ctypes.cast(dst, ctypes.c_void_p), cap, 0)
    ctx = lib.ZSTD_createDCtx()
    if not ctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        while True:
            ret = lib.ZSTD_decompressStream(ctx, ctypes.byref(outb),
                                            ctypes.byref(inb))
            if lib.ZSTD_isError(ret):
                raise ValueError("corrupt zstd frame: "
                                 + lib.ZSTD_getErrorName(ret).decode())
            if ret == 0:  # the frame is decoded and flushed
                break
            if outb.pos < outb.size and inb.pos == inb.size:
                raise ValueError("truncated zstd frame")
            if outb.pos == outb.size:
                if cap >= max_size:
                    raise ValueError(f"zstd frame larger than {max_size} "
                                     "bytes")
                cap = min(2 * cap, max_size)
                grown = ctypes.create_string_buffer(cap)
                ctypes.memmove(grown, dst, outb.pos)
                dst = grown
                outb.dst = ctypes.cast(dst, ctypes.c_void_p)
                outb.size = cap
    finally:
        lib.ZSTD_freeDCtx(ctx)
    if inb.pos != inb.size:
        raise ValueError(f"{inb.size - inb.pos} bytes after the zstd frame")
    return dst.raw[:outb.pos]
