"""zstd frames through the system's libzstd, bound with ctypes.

The port's zstd codec: `compress`, `decompress`, a stream writer for the
Beast dumper, and `ZstdError`.  It stands where readsb_tpu uses the
`zstandard` package (state blobs, the Beast dump, `&binCraft&zstd`),
which the port does not import.  `libzstd.so.1` is loaded by that soname
at first use; where it is absent every call raises RuntimeError naming it.

The frames are zstd's standard format, so either codec reads the other's
output.  `compress` writes the content size into the frame header, as
`zstandard.ZstdCompressor.compress` does; the stream writer's frame has
none, and `decompress` streams such a frame.
"""

from __future__ import annotations

import ctypes
import threading

LIBRARY = "libzstd.so.1"

# zstd.h
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2
_C_COMPRESSION_LEVEL = 100  # ZSTD_c_compressionLevel
_E_CONTINUE = 0  # ZSTD_e_continue
_E_END = 2  # ZSTD_e_end


class ZstdError(Exception):
    """A frame that libzstd cannot compress or decompress."""


class _InBuffer(ctypes.Structure):  # ZSTD_inBuffer
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):  # ZSTD_outBuffer
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_lib = None
_lock = threading.Lock()


def _load():
    """The library, loaded and declared on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(LIBRARY)
            except OSError as e:
                raise RuntimeError(f"{LIBRARY} not found: the zstd codec is unavailable "
                                   f"on this host ({e})") from None
            size_t, vp = ctypes.c_size_t, ctypes.c_void_p
            for name, res, args in (
                ("ZSTD_compressBound", size_t, [size_t]),
                ("ZSTD_compress", size_t, [vp, size_t, vp, size_t, ctypes.c_int]),
                ("ZSTD_decompress", size_t, [vp, size_t, vp, size_t]),
                ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [vp, size_t]),
                ("ZSTD_isError", ctypes.c_uint, [size_t]),
                ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                ("ZSTD_createCCtx", vp, []),
                ("ZSTD_freeCCtx", size_t, [vp]),
                ("ZSTD_CCtx_setParameter", size_t, [vp, ctypes.c_int, ctypes.c_int]),
                ("ZSTD_compressStream2", size_t,
                 [vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer), ctypes.c_int]),
                ("ZSTD_CStreamOutSize", size_t, []),
                ("ZSTD_createDCtx", vp, []),
                ("ZSTD_freeDCtx", size_t, [vp]),
                ("ZSTD_decompressStream", size_t,
                 [vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)]),
                ("ZSTD_DStreamOutSize", size_t, []),
            ):
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
        return _lib


def available() -> bool:
    """Whether libzstd.so.1 loads on this host."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ZstdError(f"{what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def compress(data: bytes, level: int = 3) -> bytes:
    """One zstd frame holding `data`, its content size in the header."""
    lib = _load()
    data = bytes(data)
    cap = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(cap)
    n = _check(lib, lib.ZSTD_compress(dst, cap, data, len(data), level), "compress")
    return dst.raw[:n]


def decompress(data: bytes) -> bytes:
    """The content of a zstd frame; one without a content size is streamed."""
    lib = _load()
    data = bytes(data)
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _CONTENTSIZE_ERROR:
        raise ZstdError("decompress: not a zstd frame")
    if size != _CONTENTSIZE_UNKNOWN:
        dst = ctypes.create_string_buffer(max(size, 1))
        n = _check(lib, lib.ZSTD_decompress(dst, size, data, len(data)), "decompress")
        return dst.raw[:n]
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx")
    try:
        src = ctypes.create_string_buffer(data, len(data))
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        step = lib.ZSTD_DStreamOutSize()
        dst = ctypes.create_string_buffer(step)
        out = []
        while True:
            outb = _OutBuffer(ctypes.cast(dst, ctypes.c_void_p), step, 0)
            hint = _check(lib, lib.ZSTD_decompressStream(dctx, outb, inb), "decompress")
            out.append(dst.raw[: outb.pos])
            if hint == 0 and inb.pos == inb.size:
                return b"".join(out)
            if inb.pos == inb.size and outb.pos < step:
                raise ZstdError("decompress: truncated frame")
    finally:
        lib.ZSTD_freeDCtx(dctx)


class StreamWriter:
    """A zstd frame written to `fh` as it grows: ZSTD_e_continue on each
    write, ZSTD_e_end on close, which then closes `fh`."""

    def __init__(self, fh, level: int = 3):
        self._lib = _load()
        self._fh = fh
        self._cctx = self._lib.ZSTD_createCCtx()
        if not self._cctx:
            raise MemoryError("ZSTD_createCCtx")
        _check(self._lib, self._lib.ZSTD_CCtx_setParameter(
            self._cctx, _C_COMPRESSION_LEVEL, level), "level")
        self._step = self._lib.ZSTD_CStreamOutSize()
        self._dst = ctypes.create_string_buffer(self._step)

    def _drive(self, data: bytes, mode: int) -> None:
        lib = self._lib
        src = ctypes.create_string_buffer(data, len(data))
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        while True:
            outb = _OutBuffer(ctypes.cast(self._dst, ctypes.c_void_p), self._step, 0)
            left = _check(lib, lib.ZSTD_compressStream2(self._cctx, outb, inb, mode), "compress")
            if outb.pos:
                self._fh.write(self._dst.raw[: outb.pos])
            if mode == _E_END and left == 0:
                return
            if mode == _E_CONTINUE and inb.pos == inb.size:
                return

    def write(self, data: bytes) -> int:
        self._drive(bytes(data), _E_CONTINUE)
        return len(data)

    def close(self) -> None:
        if self._cctx is None:
            return
        try:
            self._drive(b"", _E_END)
        finally:
            self._lib.ZSTD_freeCCtx(self._cctx)
            self._cctx = None
            self._fh.close()
