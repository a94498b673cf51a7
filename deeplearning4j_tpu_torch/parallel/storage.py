"""Artifact storage + cluster config registry.

Port of ``deeplearning4j_tpu/parallel/storage.py``, the same on-disk
layout: a store written by either package reads in the other (the
registry's documents are ``<namespace>/<host>/<name>.json``, sorted-key
JSON).  Capability match of the reference's storage/config planes:

- S3/HDFS model & dataset IO (``aws/s3/reader/S3Downloader``, ``S3Uploader``,
  ``S3ModelSaver``, ``HdfsModelSaver``) → an ``ArtifactStore`` interface with
  a local-filesystem backend and a GCS backend gated on the google-cloud
  client (GCS plays the S3/HDFS role on Google Cloud).
- ZooKeeper config registration/retrieval (``ZooKeeperConfigurationRegister``
  /``ZookeeperConfigurationRetriever``) → ``ConfigRegistry``: namespaced
  key/value JSON documents in the artifact store, registered per host/job —
  on a cluster the process-group store + shared storage replace the
  ZooKeeper ensemble.
- EC2 provisioning (``Ec2BoxCreator``/``ClusterSetup``) lives in
  ``provision.py``, which renders the cloud commands.
"""

from __future__ import annotations

import json
import pickle
import shutil
from pathlib import Path
from typing import Any, Protocol


class ArtifactStore(Protocol):
    def put_bytes(self, key: str, data: bytes) -> None: ...
    def get_bytes(self, key: str) -> bytes: ...
    def exists(self, key: str) -> bool: ...
    def delete(self, key: str) -> None: ...
    def list(self, prefix: str = "") -> list[str]: ...


class LocalArtifactStore:
    """Directory-backed store (the reference's LocalFileUpdateSaver/
    DefaultModelSaver role)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        p = (self.root / key).resolve()
        if self.root.resolve() not in p.parents and p != self.root.resolve():
            raise ValueError(f"key escapes store root: {key}")
        return p

    def put_bytes(self, key: str, data: bytes) -> None:
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_bytes(data)
        tmp.replace(p)

    def get_bytes(self, key: str) -> bytes:
        return self._path(key).read_bytes()

    def exists(self, key: str) -> bool:
        return self._path(key).exists()

    def delete(self, key: str) -> None:
        p = self._path(key)
        if p.is_dir():
            shutil.rmtree(p)
        else:
            p.unlink(missing_ok=True)

    def list(self, prefix: str = "") -> list[str]:
        base = self.root
        return sorted(str(p.relative_to(base)) for p in base.rglob("*")
                      if p.is_file() and str(p.relative_to(base)).startswith(prefix)
                      and not p.name.endswith(".tmp"))


class GCSArtifactStore:
    """GCS backend (plays the reference's S3 role on Google Cloud).  Gated on
    the google-cloud-storage client being importable AND credentialed."""

    def __init__(self, bucket: str, prefix: str = ""):
        try:
            from google.cloud import storage  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "google-cloud-storage is not available in this environment; "
                "use LocalArtifactStore") from e
        self._bucket = storage.Client().bucket(bucket)
        self.prefix = prefix.rstrip("/")

    def _name(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def put_bytes(self, key: str, data: bytes) -> None:
        self._bucket.blob(self._name(key)).upload_from_string(data)

    def get_bytes(self, key: str) -> bytes:
        return self._bucket.blob(self._name(key)).download_as_bytes()

    def exists(self, key: str) -> bool:
        return self._bucket.blob(self._name(key)).exists()

    def delete(self, key: str) -> None:
        self._bucket.blob(self._name(key)).delete()

    def list(self, prefix: str = "") -> list[str]:
        full = self._name(prefix)
        skip = len(self.prefix) + 1 if self.prefix else 0
        return sorted(b.name[skip:] for b in self._bucket.list_blobs(prefix=full))


# --------------------------------------------------------------------------- typed helpers

def save_model(store: ArtifactStore, key: str, model: Any) -> None:
    store.put_bytes(key, pickle.dumps(model))


def load_model(store: ArtifactStore, key: str) -> Any:
    return pickle.loads(store.get_bytes(key))


class StoreModelSaver:
    """ModelSaver SPI over any ArtifactStore (S3ModelSaver/HdfsModelSaver
    parity)."""

    def __init__(self, store: ArtifactStore, key: str = "model.bin"):
        self.store = store
        self.key = key

    def save(self, model: Any) -> None:
        save_model(self.store, self.key, model)

    def load(self) -> Any:
        return load_model(self.store, self.key)


class ConfigRegistry:
    """Namespaced JSON config documents (ZooKeeper-role config plane)."""

    def __init__(self, store: ArtifactStore, namespace: str = "conf"):
        self.store = store
        self.namespace = namespace.strip("/")

    def _key(self, host: str, name: str) -> str:
        return f"{self.namespace}/{host}/{name}.json"

    def register(self, host: str, name: str, config: dict) -> None:
        self.store.put_bytes(self._key(host, name),
                             json.dumps(config, sort_keys=True).encode())

    def retrieve(self, host: str, name: str) -> dict:
        return json.loads(self.store.get_bytes(self._key(host, name)))

    def exists(self, host: str, name: str) -> bool:
        return self.store.exists(self._key(host, name))

    def unregister(self, host: str, name: str) -> None:
        self.store.delete(self._key(host, name))

    def hosts(self) -> list[str]:
        seen = set()
        for k in self.store.list(self.namespace + "/"):
            parts = k.split("/")
            if len(parts) >= 3:
                seen.add(parts[1])
        return sorted(seen)
