"""Blob integrity envelope of stored model blobs.

The wrap/unwrap half of `predictionio_tpu/data/integrity.py`, so that a
model blob either package writes into a shared store carries the same
checksummed envelope (little-endian):

    offset  size  field
    0       4     magic  b"PIOB"
    4       1     format version (1)
    5       1     digest algo (1=CRC32, 2=SHA-256)
    6       8     payload length (uint64)
    14      D     digest (4 bytes for CRC32, 32 for SHA-256)
    14+D    N     payload

Blobs that do not start with the magic pass through unchanged (stores
written before the envelope existed). `unwrap` reads either digest,
since another writer of the store may choose CRC32.

`atomic_write_bytes` is how the file-backed drivers and the prepared-data
cache write a file whole: a unique temporary file, fsync, rename, fsync
of the directory, so a crash leaves the old content or the new one,
never a torn file.
"""

from __future__ import annotations

import hashlib
import os
import struct
import uuid
import zlib
from pathlib import Path
from typing import Union

from predictionio_tpu_torch.data.storage.base import StorageError

BLOB_MAGIC = b"PIOB"
FORMAT_VERSION = 1
ALGO_CRC32 = 1
ALGO_SHA256 = 2
_HEADER = struct.Struct("<4sBBQ")  # magic, version, algo, payload length
_DIGEST_SIZE = {ALGO_CRC32: 4, ALGO_SHA256: 32}


class CorruptBlobError(StorageError):
    """An enveloped blob failed its integrity check (torn/corrupt)."""


def _digest(payload: bytes, algo: int) -> bytes:
    if algo == ALGO_CRC32:
        return struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
    if algo == ALGO_SHA256:
        return hashlib.sha256(payload).digest()
    raise CorruptBlobError(f"unknown digest algo {algo}")


def wrap(payload: bytes) -> bytes:
    """Wrap `payload` in a SHA-256 envelope, as the JAX package's sqlite
    driver does."""
    header = _HEADER.pack(BLOB_MAGIC, FORMAT_VERSION, ALGO_SHA256,
                          len(payload))
    return header + _digest(payload, ALGO_SHA256) + payload


def unwrap(blob: bytes) -> bytes:
    """The payload of an enveloped blob, its digest verified; other
    blobs unchanged. Raises `CorruptBlobError` on any structural or
    digest mismatch."""
    if blob[:4] != BLOB_MAGIC:
        return blob
    if len(blob) < _HEADER.size:
        raise CorruptBlobError("truncated envelope header")
    _, version, algo, length = _HEADER.unpack_from(blob)
    if version != FORMAT_VERSION:
        raise CorruptBlobError(f"unsupported envelope version {version}")
    dsize = _DIGEST_SIZE.get(algo)
    if dsize is None:
        raise CorruptBlobError(f"unknown digest algo {algo}")
    body_start = _HEADER.size + dsize
    if len(blob) != body_start + length:
        raise CorruptBlobError(
            f"length mismatch: header says {length}, "
            f"have {len(blob) - body_start}")
    payload = blob[body_start:]
    if _digest(payload, algo) != blob[_HEADER.size:body_start]:
        raise CorruptBlobError("digest mismatch")
    return payload


def atomic_write_bytes(path: Union[str, Path], data: bytes) -> None:
    """Crash-safe write: unique tmp -> fsync -> rename -> fsync(dir)."""
    path = Path(path)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{uuid.uuid4().hex}.tmp")
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise
    try:
        fd = os.open(str(path.parent), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
