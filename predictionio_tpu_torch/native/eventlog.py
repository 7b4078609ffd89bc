"""Python binding of the C++ event journal, with a pure-Python framing.

The port of `predictionio_tpu/native/eventlog.py`. The binding and the
Python framing write the same CRC-framed format,

    [u32 magic 0x50494F45][u32 payload_len][u32 crc32(payload)][payload]

little-endian, so a journal written by either, in either package, reads
back through both. Appends take an exclusive flock (several processes
may append to one journal); scans stop cleanly at a torn tail.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import struct
import zlib
from pathlib import Path
from typing import Iterator, List, Tuple

from predictionio_tpu_torch import native

MAGIC = 0x50494F45
_HEADER = struct.Struct("<III")


def framed_size(payloads: List[bytes]) -> int:
    """Journal bytes the framed payloads occupy (header + body per
    frame): the exact end offset of an `append_many` blob from its
    start."""
    return sum(_HEADER.size + len(p) for p in payloads)


class EventLog:
    """Append to and scan one journal file."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lib = native.load("eventlog")
        if self._lib is not None:
            self._lib.el_append.restype = ctypes.c_longlong
            self._lib.el_append.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong]
            self._lib.el_append_blob.restype = ctypes.c_longlong
            self._lib.el_append_blob.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong]
            self._lib.el_index.restype = ctypes.c_longlong
            self._lib.el_index.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong]
            self._lib.el_truncate.restype = ctypes.c_int
            self._lib.el_truncate.argtypes = [ctypes.c_char_p]

    @property
    def uses_native(self) -> bool:
        return self._lib is not None

    # -- append -------------------------------------------------------------
    def append(self, payload: bytes) -> int:
        """Append one frame; returns its start offset."""
        if self._lib is not None:
            off = self._lib.el_append(self.path.encode(), payload,
                                      len(payload))
            if off < 0:
                raise IOError(f"el_append failed for {self.path}")
            return int(off)
        return self._py_append_raw(_HEADER.pack(
            MAGIC, len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload)

    def append_many(self, payloads: List[bytes]) -> Tuple[int, int]:
        """Bulk append: the frames are built here and written as ONE blob
        under a single lock and fsync. Returns the blob's (start, end)
        byte range."""
        if not payloads:
            size = (Path(self.path).stat().st_size
                    if Path(self.path).exists() else 0)
            return size, size
        parts = []
        pack, crc = _HEADER.pack, zlib.crc32
        for p in payloads:
            parts.append(pack(MAGIC, len(p), crc(p) & 0xFFFFFFFF))
            parts.append(p)
        blob = b"".join(parts)
        if self._lib is not None:
            off = self._lib.el_append_blob(self.path.encode(), blob,
                                           len(blob))
            if off < 0:
                raise IOError(f"el_append_blob failed for {self.path}")
            return int(off), int(off) + len(blob)
        off = self._py_append_raw(blob)
        return off, off + len(blob)

    def _py_append_raw(self, blob: bytes) -> int:
        # the C path's locked_append: flock so concurrent writers (native
        # or Python) serialize, unbuffered so a failed write rolls back
        # to the frame boundary (a torn frame mid-file would hide every
        # later append from readers, which stop at the first bad frame)
        with open(self.path, "ab", buffering=0) as f:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            try:
                off = os.lseek(f.fileno(), 0, os.SEEK_END)
                try:
                    view = memoryview(blob)
                    written = 0
                    while written < len(blob):   # write(2) may be short
                        n = f.write(view[written:])
                        if not n:
                            raise OSError("short write")
                        written += n
                    os.fsync(f.fileno())
                except OSError:
                    try:
                        os.truncate(self.path, off)
                    except OSError:
                        pass
                    raise
            finally:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)
        return off

    # -- scan ---------------------------------------------------------------
    def payloads(self) -> Iterator[bytes]:
        """All valid payloads in append order (a torn tail is ignored)."""
        if not Path(self.path).exists():
            return
        if self._lib is None:
            for payload, _end in self.scan_from(0):
                yield payload
            return
        cap = 1024
        while True:
            offs = (ctypes.c_longlong * cap)()
            lens = (ctypes.c_longlong * cap)()
            n = self._lib.el_index(self.path.encode(), offs, lens, cap)
            if n < 0:
                raise IOError(f"el_index failed for {self.path}")
            if n < cap:
                break
            cap *= 4   # journal longer than the index buffer: retry
        with open(self.path, "rb") as f:
            for i in range(n):
                f.seek(offs[i])
                yield f.read(lens[i])

    def scan_from(self, start: int) -> Iterator[Tuple[bytes, int]]:
        """(payload, end offset after the frame) pairs from byte `start`
        (a frame boundary), so that an incremental reader resumes at the
        tail. Stops at the first invalid or torn frame."""
        if not Path(self.path).exists():
            return
        with open(self.path, "rb") as f:
            f.seek(start)
            pos = start
            while True:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    return
                magic, length, crc = _HEADER.unpack(header)
                if magic != MAGIC or length > (1 << 30):
                    return
                payload = f.read(length)
                if len(payload) < length or \
                        zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    return
                pos += _HEADER.size + length
                yield payload, pos

    def truncate(self) -> None:
        if self._lib is not None:
            if self._lib.el_truncate(self.path.encode()) != 0:
                raise IOError(f"el_truncate failed for {self.path}")
            return
        with open(self.path, "wb"):
            pass
