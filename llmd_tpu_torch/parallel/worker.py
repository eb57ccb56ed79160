"""A worker rank of a world (``parallel/launch.World`` starts it):

    python -m llmd_tpu_torch.parallel.worker --rank R --world-size N \\
        --init tcp://127.0.0.1:P --commands HOST:PORT --device cuda|cpu [--timeout S]

It reads the world's token (hex) from its stdin, joins rank 0's command
socket with it and the process group, then runs rank 0's commands in order until
``exit``: it builds the mesh and its engine shard, and runs each device op
rank 0 sends, with rank 0's host arrays, on its own shards (an adapter slot write,
the masked programs' tables and the KV pages rank 0 reads or writes among
them: the ops' order is rank 0's, so a worker's captured graphs and pool see
what rank 0's see). A worker's allocator never runs: rank 0 alone schedules,
so no evict hook fires here. It exits 1 when
a command fails (after answering rank 0 with the error where rank 0 waits
for an answer), when its command socket closes, or when its parent dies.
"""

from __future__ import annotations

import argparse
import datetime
import os
import pickle
import socket
import struct
import sys
import threading
import time
import traceback

import torch
import torch.distributed as dist

from llmd_tpu_torch.parallel.launch import backend_for, recv_msg, resolve, send_msg
from llmd_tpu_torch.parallel.mesh import RankMesh


class WorkerState:
    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.mesh = None
        self.engine = None

    def run(self, msg: tuple):
        """Run one command; returns (answer wanted, value)."""
        kind = msg[0]
        if kind == "op":
            with self.engine._on_stream():
                getattr(self.engine, "_op_" + msg[1])(**msg[2])
            return False, None
        if kind == "mesh":
            self.mesh = RankMesh.build(msg[1], self.device)
            return True, None
        if kind == "engine":
            from llmd_tpu_torch.engine.engine import LLMEngine

            spec = msg[1]
            self.engine = LLMEngine(spec["model_cfg"], spec["engine_cfg"],
                                    params=spec["params"], seed=spec["seed"],
                                    device=self.device, decode_graph=spec["decode_graph"],
                                    rank_mesh=self.mesh)
            self.engine._op_log = [] if spec.get("record_ops") else None
            return True, None
        if kind == "call":
            return True, resolve(msg[1])(self.mesh, **msg[2])
        if kind == "engine_call":
            return True, resolve(msg[1])(self.engine, **msg[2])
        if kind == "oplog":
            return True, self.engine._op_log
        if kind == "close":
            if self.engine is not None:
                self.engine.close()
            self.engine = None
            return False, None
        raise ValueError(f"unknown command {kind!r}")


def _orphan_watch(ppid: int) -> None:
    """Exit once the parent (rank 0's process) is gone."""
    while True:
        if os.getppid() != ppid:
            os._exit(3)
        time.sleep(0.5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--commands", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    threading.Thread(target=_orphan_watch, args=(os.getppid(),), daemon=True).start()
    if args.device == "cuda":
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    token = bytes.fromhex(sys.stdin.readline().strip())
    host, port = args.commands.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=args.timeout)
    sock.settimeout(None)
    sock.sendall(struct.pack("!I", args.rank) + token)
    dist.init_process_group(backend_for(args.device), init_method=args.init, rank=args.rank,
                            world_size=args.world_size,
                            timeout=datetime.timedelta(seconds=args.timeout))
    state = WorkerState(device)
    code = 0
    with torch.no_grad():
        while True:
            data = recv_msg(sock)
            if data is None:  # rank 0 went away without an exit
                code = 1
                break
            msg = pickle.loads(data)
            if msg[0] == "exit":
                break
            try:
                answer, value = state.run(msg)
            except Exception as e:  # noqa: BLE001 — the rank's boundary: report, exit
                traceback.print_exc()
                if msg[0] in ("mesh", "engine", "call", "engine_call", "oplog"):
                    send_msg(sock, pickle.dumps((False, f"{type(e).__name__}: {e}")))
                code = 1
                break
            if answer:
                send_msg(sock, pickle.dumps((True, value)))
    sock.close()
    if code:
        os._exit(code)  # peers blocked in a collective see the rank go
    if state.engine is not None:
        state.engine.close()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
