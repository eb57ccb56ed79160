"""Cross-process DP rank worker of the port (subprocess target for
``tests/test_torch_dp_group.py`` and ``chip_smoke.py``'s ``launch`` phase),
after ``tests/dp_rank_worker.py``.

One port engine server with a wave-synced loop against a (possibly remote)
coordinator: each OS process plays one pod of a multi-node wide-EP DP
deployment. Rank 0 is the leader and hosts the coordinator on the given rpc
port. It prints ``ENDPOINT host:port`` once serving and, on SIGTERM, stops
and prints ``STEPS <steps> <empty steps> <registered>`` of its loop.

    python tests/torch_dp_rank_worker.py --rank R --dp-size N --rpc-port P
        [--model NAME] [--engine JSON] [--seed S] [--cpu]

``--engine``: the rank engine's ``EngineConfig`` keywords as a JSON object
(default: the reference worker's small engine).
"""

import argparse
import json
import os
import signal
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llmd_tpu_torch.engine.config import EngineConfig  # noqa: E402
from llmd_tpu_torch.engine.dp_group import DPEngineGroup, DPGroupConfig  # noqa: E402
from llmd_tpu_torch.models import get_model_config  # noqa: E402

SMALL = dict(page_size=8, num_pages=64, max_model_len=128, max_batch_size=4, prefill_chunk=32)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--dp-size", type=int, default=2)
    ap.add_argument("--rpc-port", type=int, required=True)
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--engine", type=json.loads, default=SMALL)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()

    grp = DPEngineGroup(
        get_model_config(args.model), EngineConfig(**args.engine),
        DPGroupConfig(dp_size=args.dp_size, dp_size_local=1, dp_start_rank=args.rank,
                      dp_rpc_port=args.rpc_port, port_base=0),
        model_name=f"llmd-tpu/{args.model}", device="cpu" if args.cpu else None,
        seed=args.seed)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    grp.start()
    print(f"ENDPOINT {grp.endpoints()[0]}", flush=True)
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    grp.stop()
    ae = grp.servers[0].async_engine
    print(f"STEPS {ae.steps} {ae.empty_steps} {int(ae.registered)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
