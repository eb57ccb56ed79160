"""Engine side of the global KV plane: serving and consuming prefix pulls
(port of ``llmd_tpu/kvplane/pull.py``).

Both halves ride the existing P/D transfer wire (``disagg/transfer.py``):

- ``serve_prefix`` is the body of ``KVTransferSource.prefix_provider`` — a
  peer asked for a block-hash chain; stage whatever consecutive prefix of it
  is resident in the local prefix cache (two-phase: stage the gathers under
  the engine lock, drain bytes off it, like the P/D export path).
- ``pull_prefix_into`` is the puller: fetch the peer's resident prefix,
  inject it into the local cache (hash-chain verified), and notify so the
  peer frees the registration. Any failure returns 0 — the caller's
  admission ladder then falls through to the host/disk offload tier and
  finally plain re-prefill; a failed pull must never fail the request.

Either side may be a meshed engine: staging and inject read and write its
pool through ``engine.kv_pool`` (the tp planes gathered to rank 0, each
rank's planes scattered from rank 0's device), so the wire carries the one-card bytes.
"""

from __future__ import annotations

from typing import Optional, Sequence

from llmd_tpu_torch.disagg.transfer import (
    KVTransferParams,
    drain_staged,
    inject_into_engine,
    prefix_export_begin,
)

def serve_prefix(server, block_hashes: Sequence[int],
                 request_id: str) -> Optional[tuple]:
    """``prefix_provider`` body for an EngineServer: resolve + stage + drain
    the locally resident prefix of ``block_hashes``. Runs on the transfer
    source's serving thread (blocking is fine; only the dispatch phase takes
    the engine lock). Returns ``(hashes, token_chunks, blocks)`` or None."""
    staged = server.async_engine.run_locked(
        lambda: prefix_export_begin(
            server.engine, request_id, block_hashes,
            staging_pages=server.engine.cfg.offload_staging_blocks))
    if staged is None:
        return None
    blocks = drain_staged(staged.parts)
    return staged.hashes, staged.chunks, blocks


def pull_prefix_into(server, ktp: KVTransferParams, token_ids: list[int],
                     lora_id: Optional[str] = None,
                     mm_hashes: Sequence[bytes] = ()) -> tuple[int, str, bool]:
    """Pull the stamped prefix chain from the peer and commit it locally,
    verified against this prompt's chain under adapter ``lora_id`` and media
    ``mm_hashes``.

    Returns ``(blocks_injected, outcome, peer_released)`` with outcome one of
    ``hit`` / ``empty`` (peer served but nothing committed) / ``miss`` (peer
    holds none of the chain) / ``peer_dead`` / ``error`` (inject failed).
    ``peer_released`` False means the peer may still hold a registration under
    ``ktp.remote_request_id`` — the caller must release it on request retire.
    """
    try:
        pulled = server.transfer_client.pull_prefix(
            ktp.remote_host, ktp.remote_port, ktp.remote_request_id,
            ktp.block_hashes)
    except (OSError, ValueError):  # refused, reset, timed out, a torn frame
        return 0, "peer_dead", False
    if pulled is None:
        return 0, "miss", True  # peer registered nothing on a miss
    n, outcome = 0, "error"
    try:
        n = server.async_engine.run_locked(
            lambda: inject_into_engine(server.engine, pulled, token_ids, lora_id, mm_hashes))
        outcome = "hit" if n else "empty"
    except Exception:  # noqa: BLE001 — degrade to recompute
        pass  # the notify below still frees the peer
    released = bool(server.transfer_client.notify(
        ktp.remote_host, ktp.remote_port, ktp.remote_request_id))
    return n, outcome, released
