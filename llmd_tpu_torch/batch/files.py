"""Batch file store — the Batch Gateway's S3/FS object layer (copy of
``llmd_tpu/batch/files.py``: the same paths, metadata and validation).

Parity: reference `docs/architecture/advanced/batch/batch-gateway.md:11-87` — files
land under tenant-hashed paths (tenant isolation: a tenant id from the auth header
prefixes every object key, so one tenant can never address another's files), JSONL
inputs are validated line-by-line at ingest, and output/error files are written by
the processor at finalize.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import uuid
from dataclasses import dataclass
from typing import Iterator, Optional


def tenant_hash(tenant: str) -> str:
    return hashlib.sha256(tenant.encode()).hexdigest()[:16]


@dataclass
class FileMeta:
    id: str
    filename: str
    purpose: str
    bytes: int
    created_at: int
    tenant: str

    def to_openai(self) -> dict:
        return {
            "id": self.id, "object": "file", "bytes": self.bytes,
            "created_at": self.created_at, "filename": self.filename,
            "purpose": self.purpose,
        }


class FileStore:
    """FS-backed file objects under <root>/<tenant_hash>/<file_id>."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _dir(self, tenant: str) -> str:
        d = os.path.join(self.root, tenant_hash(tenant))
        os.makedirs(d, exist_ok=True)
        return d

    def _path(self, tenant: str, file_id: str) -> str:
        # file_id is server-generated (uuid hex); reject anything else so a
        # crafted id can't traverse out of the tenant directory
        if not file_id.startswith("file-") or "/" in file_id or ".." in file_id:
            raise KeyError(file_id)
        return os.path.join(self._dir(tenant), file_id)

    def put(self, tenant: str, filename: str, data: bytes, purpose: str = "batch") -> FileMeta:
        file_id = f"file-{uuid.uuid4().hex}"
        path = self._path(tenant, file_id)
        with open(path, "wb") as f:
            f.write(data)
        meta = FileMeta(id=file_id, filename=filename, purpose=purpose,
                        bytes=len(data), created_at=int(time.time()), tenant=tenant)
        with open(path + ".meta", "w") as f:
            json.dump(meta.__dict__, f)
        return meta

    def get_meta(self, tenant: str, file_id: str) -> Optional[FileMeta]:
        try:
            with open(self._path(tenant, file_id) + ".meta") as f:
                return FileMeta(**json.load(f))
        except (FileNotFoundError, KeyError):
            return None

    def get_content(self, tenant: str, file_id: str) -> Optional[bytes]:
        try:
            with open(self._path(tenant, file_id), "rb") as f:
                return f.read()
        except (FileNotFoundError, KeyError):
            return None

    def delete(self, tenant: str, file_id: str) -> bool:
        try:
            os.remove(self._path(tenant, file_id))
            os.remove(self._path(tenant, file_id) + ".meta")
            return True
        except (FileNotFoundError, KeyError):
            return False

    def list(self, tenant: str) -> list[FileMeta]:
        out = []
        d = self._dir(tenant)
        for name in sorted(os.listdir(d)):
            if name.endswith(".meta"):
                with open(os.path.join(d, name)) as f:
                    out.append(FileMeta(**json.load(f)))
        return out


def validate_batch_input(data: bytes, max_requests: int = 50_000
                         ) -> tuple[list[dict], list[str]]:
    """Parse + validate a batch JSONL input; returns (requests, errors).

    Each line: {"custom_id": str, "method": "POST", "url": "/v1/...", "body": {...}}
    (the OpenAI Batch input contract the gateway fronts).
    """
    reqs: list[dict] = []
    errors: list[str] = []
    seen_ids: set[str] = set()
    for i, line in enumerate(data.decode("utf-8", "replace").splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            errors.append(f"line {i + 1}: invalid JSON")
            continue
        cid = obj.get("custom_id")
        if not isinstance(cid, str) or not cid:
            errors.append(f"line {i + 1}: missing custom_id")
            continue
        if cid in seen_ids:
            errors.append(f"line {i + 1}: duplicate custom_id {cid!r}")
            continue
        if obj.get("method", "POST") != "POST":
            errors.append(f"line {i + 1}: only POST supported")
            continue
        if not isinstance(obj.get("body"), dict):
            errors.append(f"line {i + 1}: missing body")
            continue
        url = obj.get("url", "")
        if url not in ("/v1/completions", "/v1/chat/completions", "/v1/embeddings"):
            errors.append(f"line {i + 1}: unsupported url {url!r}")
            continue
        if len(reqs) >= max_requests:
            errors.append(f"too many requests (max {max_requests})")
            break
        seen_ids.add(cid)
        reqs.append(obj)
    return reqs, errors
