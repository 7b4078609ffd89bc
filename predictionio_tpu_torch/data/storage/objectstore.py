"""Remote object-store model drivers ("OBJECTSTORE", "S3", "HDFS" types).

The port of `predictionio_tpu/data/storage/objectstore.py`; reference `storage/s3/.../S3Models.scala:101` (AWS SDK blob
put/get/delete under bucket + base path) and
`storage/hdfs/.../HDFSModels.scala:63` (Hadoop FS read/write of model
blobs). Both exist so trained models survive the loss of the training
host. Here one driver covers every remote filesystem through fsspec URLs:

  PIO_STORAGE_SOURCES_<N>_TYPE=OBJECTSTORE
  PIO_STORAGE_SOURCES_<N>_URL=s3://bucket/prefix   (or gs://, hdfs://,
                                                    memory://, file:///...)

plus reference-shaped aliases:

  TYPE=S3    with BUCKET_NAME (+ optional BASE_PATH)  -> s3://bucket/path
  TYPE=HDFS  with PATH                                -> the path verbatim

The `memory://` scheme (fsspec built-in) is the in-process fake backend
the contract tests run against; real s3/gs/hdfs need the matching fsspec
implementation package installed, and the driver surfaces a clear error
if it is absent.
"""

from __future__ import annotations

from typing import List, Optional

from predictionio_tpu_torch.data import integrity
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Model, StorageError


class ObjectStoreStorageClient:
    def __init__(self, config: Optional[dict] = None):
        try:
            import fsspec
        except ImportError as e:  # pragma: no cover - env dependent
            raise StorageError(
                "OBJECTSTORE storage requires fsspec, which is not "
                "installed") from e
        self.config = dict(config or {})
        url = self._url(self.config)
        try:
            self.fs, self.root = fsspec.core.url_to_fs(url)
        except (ImportError, ValueError) as e:
            raise StorageError(
                f"Cannot open object store URL {url!r}: {e}") from e
        self.root = self.root.rstrip("/")

    @staticmethod
    def _url(cfg: dict) -> str:
        url = cfg.get("URL") or cfg.get("url")
        if url:
            return url
        # reference-shaped S3 config (S3Models.scala: bucket + base path)
        bucket = cfg.get("BUCKET_NAME") or cfg.get("bucket_name")
        if bucket:
            path = (cfg.get("BASE_PATH") or cfg.get("base_path") or "").strip("/")
            return f"s3://{bucket}/{path}" if path else f"s3://{bucket}"
        # reference-shaped HDFS config (HDFSModels.scala: a Hadoop path)
        path = cfg.get("PATH") or cfg.get("path")
        if path:
            return path
        raise StorageError(
            "OBJECTSTORE source needs PIO_STORAGE_SOURCES_<N>_URL (or "
            "BUCKET_NAME for S3 / PATH for HDFS)")


class ObjectStoreModels(base.Models):
    """Model blobs as objects `<root>/pio_model_<id>`."""

    def __init__(self, client: ObjectStoreStorageClient):
        self.c = client
        try:
            self.c.fs.makedirs(self.c.root, exist_ok=True)
        except Exception:
            # flat namespaces (s3) have no directories to create
            pass

    def _key(self, mid: str) -> str:
        from urllib.parse import quote
        # injective escaping: distinct ids must never collide on one key
        return f"{self.c.root}/pio_model_{quote(mid, safe='')}"

    def insert(self, m: Model) -> None:
        # object stores commit a PUT atomically on close; the envelope
        # still detects any partially-replicated / bit-rotted object
        with self.c.fs.open(self._key(m.id), "wb") as f:
            f.write(integrity.wrap(m.models))

    def get(self, mid: str) -> Optional[Model]:
        key = self._key(mid)
        if not self.c.fs.exists(key):
            return None
        with self.c.fs.open(key, "rb") as f:
            return Model(mid, integrity.unwrap(f.read()))

    def delete(self, mid: str) -> None:
        key = self._key(mid)
        if self.c.fs.exists(key):
            self.c.fs.rm(key)

    def fsck(self, repair: bool = False) -> List[dict]:
        """Verify every `pio_model_*` object; corrupt ones move under
        `<root>/.quarantine/` with a `.reason` sidecar object."""
        fs, root = self.c.fs, self.c.root
        findings: List[dict] = []
        try:
            keys = sorted(k for k in fs.ls(root, detail=False)
                          if k.rsplit("/", 1)[-1].startswith("pio_model_"))
        except FileNotFoundError:
            return findings
        for key in keys:
            try:
                with fs.open(key, "rb") as f:
                    ok, reason = integrity.verify(f.read())
            except OSError as exc:
                ok, reason = False, f"unreadable: {exc}"
            if ok:
                continue
            finding = {"kind": "corrupt_blob", "path": key,
                       "reason": reason, "action": "none"}
            if repair:
                name = key.rsplit("/", 1)[-1]
                dest = f"{root}/.quarantine/{name}"
                try:
                    fs.makedirs(f"{root}/.quarantine", exist_ok=True)
                except Exception:
                    pass  # flat namespaces (s3) have no directories
                fs.mv(key, dest)
                with fs.open(dest + ".reason", "wb") as f:
                    f.write((reason + "\n").encode())
                finding["action"] = f"quarantined -> {dest}"
            findings.append(finding)
        return findings
