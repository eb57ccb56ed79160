"""Batch metadata store (SQLite) — the gateway's PostgreSQL-equivalent (copy
of ``llmd_tpu/batch/store.py``: the same table, rows and scans).

Parity: reference `batch-gateway.md:11-87` — batch rows survive gateway crashes;
the processor's startup *recovery scan* re-queues every batch left in a
non-terminal state, so an interrupted run resumes instead of stranding
(`batch-gateway.md:55-59`). SQLite keeps the property (durable, transactional)
without an external database; the store API is the seam where PostgreSQL would
slot in.
"""

from __future__ import annotations

import json
import sqlite3
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

# OpenAI Batch lifecycle
NON_TERMINAL = ("validating", "in_progress", "finalizing", "cancelling")
TERMINAL = ("completed", "failed", "expired", "cancelled")


@dataclass
class BatchRow:
    id: str
    tenant: str
    input_file_id: str
    endpoint: str
    completion_window: str
    status: str = "validating"
    created_at: int = field(default_factory=lambda: int(time.time()))
    model: str = ""          # extracted at ingest for per-model worker routing
    priority: int = 0        # SLO priority (queue ordering)
    total: int = 0
    completed: int = 0
    failed: int = 0
    output_file_id: Optional[str] = None
    error_file_id: Optional[str] = None
    errors: Optional[str] = None
    metadata: dict = field(default_factory=dict)

    def to_openai(self) -> dict:
        return {
            "id": self.id, "object": "batch", "endpoint": self.endpoint,
            "input_file_id": self.input_file_id,
            "completion_window": self.completion_window, "status": self.status,
            "created_at": self.created_at,
            "output_file_id": self.output_file_id,
            "error_file_id": self.error_file_id,
            "errors": json.loads(self.errors) if self.errors else None,
            "request_counts": {"total": self.total, "completed": self.completed,
                               "failed": self.failed},
            "metadata": self.metadata,
        }


class BatchStore:
    def __init__(self, path: str = ":memory:") -> None:
        self.db = sqlite3.connect(path, check_same_thread=False)
        self.db.execute(
            """CREATE TABLE IF NOT EXISTS batches (
                id TEXT PRIMARY KEY, tenant TEXT, input_file_id TEXT,
                endpoint TEXT, completion_window TEXT, status TEXT,
                created_at INTEGER, model TEXT, priority INTEGER,
                total INTEGER, completed INTEGER, failed INTEGER,
                output_file_id TEXT, error_file_id TEXT, errors TEXT,
                metadata TEXT)"""
        )
        self.db.commit()

    _COLS = ("id", "tenant", "input_file_id", "endpoint", "completion_window",
             "status", "created_at", "model", "priority", "total", "completed",
             "failed", "output_file_id", "error_file_id", "errors", "metadata")

    def create(self, tenant: str, input_file_id: str, endpoint: str,
               completion_window: str = "24h", metadata: Optional[dict] = None,
               priority: int = 0) -> BatchRow:
        row = BatchRow(
            id=f"batch_{uuid.uuid4().hex}", tenant=tenant,
            input_file_id=input_file_id, endpoint=endpoint,
            completion_window=completion_window, metadata=metadata or {},
            priority=priority,
        )
        self._write(row)
        return row

    def _write(self, row: BatchRow) -> None:
        vals = [getattr(row, c) for c in self._COLS]
        vals[-1] = json.dumps(row.metadata)
        self.db.execute(
            f"INSERT OR REPLACE INTO batches VALUES ({','.join('?' * len(self._COLS))})",
            vals,
        )
        self.db.commit()

    def update(self, row: BatchRow) -> None:
        self._write(row)

    def _from_row(self, r) -> BatchRow:
        d = dict(zip(self._COLS, r))
        d["metadata"] = json.loads(d["metadata"] or "{}")
        return BatchRow(**d)

    def get(self, batch_id: str, tenant: Optional[str] = None) -> Optional[BatchRow]:
        q = "SELECT * FROM batches WHERE id=?"
        args = [batch_id]
        if tenant is not None:  # tenant isolation at the metadata layer too
            q += " AND tenant=?"
            args.append(tenant)
        r = self.db.execute(q, args).fetchone()
        return self._from_row(r) if r else None

    def list(self, tenant: str, limit: int = 100) -> list[BatchRow]:
        rows = self.db.execute(
            "SELECT * FROM batches WHERE tenant=? ORDER BY created_at DESC LIMIT ?",
            (tenant, limit),
        ).fetchall()
        return [self._from_row(r) for r in rows]

    def recovery_scan(self) -> list[BatchRow]:
        """All non-terminal batches — re-queued by the processor at startup."""
        rows = self.db.execute(
            f"SELECT * FROM batches WHERE status IN ({','.join('?' * len(NON_TERMINAL))})",
            NON_TERMINAL,
        ).fetchall()
        return [self._from_row(r) for r in rows]

    def gc(self, older_than_s: float) -> int:
        """Delete terminal batches older than the retention window."""
        cutoff = int(time.time() - older_than_s)
        cur = self.db.execute(
            f"DELETE FROM batches WHERE status IN ({','.join('?' * len(TERMINAL))}) "
            "AND created_at < ?",
            (*TERMINAL, cutoff),
        )
        self.db.commit()
        return cur.rowcount
