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
never a torn file. `verify` is the non-raising check the fsck sweeps
run; `quarantine_file` moves a bad blob into `.quarantine/` beside it
with a `.reason` sidecar, and `purge_tmp_siblings` clears the leftover
temporary files of interrupted writes.
"""

from __future__ import annotations

import hashlib
import os
import struct
import uuid
import zlib
from pathlib import Path
from typing import Optional, Tuple, Union

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


def wrap(payload: bytes, algo: int = ALGO_SHA256) -> bytes:
    """Wrap `payload` in an envelope: SHA-256 by default, as the JAX
    package's sqlite driver does; CRC32 for the ingest service's column
    blocks, as the JAX protocol frames them."""
    header = _HEADER.pack(BLOB_MAGIC, FORMAT_VERSION, algo, len(payload))
    return header + _digest(payload, algo) + payload


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


def verify(blob: bytes) -> Tuple[bool, str]:
    """Non-raising integrity check: (ok, reason). A blob without the
    envelope verifies as "legacy"."""
    if blob[:4] != BLOB_MAGIC:
        return True, "legacy"
    try:
        unwrap(blob)
    except CorruptBlobError as exc:
        return False, str(exc)
    return True, "ok"


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
    _fsync_dir(path.parent)


def _fsync_dir(dirpath: Path) -> None:
    try:
        fd = os.open(str(dirpath), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def purge_tmp_siblings(path: Path) -> int:
    """Remove leftover `<name>.*.tmp` files beside `path`; the count."""
    removed = 0
    try:
        siblings = list(path.parent.glob(path.name + ".*.tmp"))
    except OSError:
        return 0
    for tmp in siblings:
        try:
            tmp.unlink()
            removed += 1
        except OSError:
            pass
    return removed


def quarantine_file(path: Path, reason: str,
                    quarantine_dir: Optional[Path] = None) -> Path:
    """Move `path` into a `.quarantine/` directory beside it, with a
    `.reason` sidecar; returns where it went."""
    qdir = quarantine_dir or (path.parent / ".quarantine")
    qdir.mkdir(parents=True, exist_ok=True)
    dest = qdir / path.name
    if dest.exists():
        dest = qdir / f"{path.name}.{uuid.uuid4().hex[:8]}"
    os.replace(path, dest)
    atomic_write_bytes(dest.with_name(dest.name + ".reason"),
                       (reason + "\n").encode("utf-8"))
    _fsync_dir(qdir)
    return dest
