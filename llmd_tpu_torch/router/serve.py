"""CLI: ``python -m llmd_tpu_torch.router.serve --config cfg.yaml --endpoints
a:8000,b:8000`` (port of ``llmd_tpu/router/serve.py``).

The no-Kubernetes standalone mode: static endpoints from ``--endpoints`` or an
``--endpoints-file`` (re-scanned when it changes); the config is the plugin
graph (``DEFAULT_CONFIG`` without ``--config``). Active-passive HA with
``--ha-lease-file PATH`` (co-located replicas, an flock lease) or
``--ha-k8s-lease NAME`` (a coordination.k8s.io Lease). The reference's gateway
and manifest flags are accepted by name and refused with the ROADMAP item that
brings them.
"""

from __future__ import annotations

import argparse
import asyncio
from typing import Optional, Sequence

DEFAULT_CONFIG = """
plugins:
  - name: prefix-producer
    type: approx-prefix-cache-producer
    params: {blockSize: 16}
  - name: inflight
    type: inflight-load-producer
  - name: prefix
    type: prefix-cache-scorer
  - name: queue
    type: queue-depth-scorer
  - name: kv-util
    type: kv-cache-utilization-scorer
  - name: no-hit-lru-scorer
    type: no-hit-lru-scorer
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: prefix, weight: 3}
      - {pluginRef: queue, weight: 2}
      - {pluginRef: kv-util, weight: 2}
      - {pluginRef: no-hit-lru-scorer, weight: 2}
"""

# flag -> the ROADMAP item that brings it
REFUSED_FLAGS = {
    "--extproc-port": "ROADMAP Queue A item 14 (k8s discovery, core/crds.py, extproc / "
                      "vllmgrpc; the card has no grpc)",
    "--extproc-failure-mode": "ROADMAP Queue A item 14 (k8s discovery, core/crds.py, "
                              "extproc / vllmgrpc; the card has no grpc)",
    "--vllmgrpc-port": "ROADMAP Queue A item 14 (k8s discovery, core/crds.py, extproc / "
                       "vllmgrpc; the card has no grpc)",
    "--manifests": "ROADMAP Queue A item 14 (k8s discovery, core/crds.py, extproc / "
                   "vllmgrpc; the card has no grpc)",
    "--k8s-discovery": "ROADMAP Queue A item 14 (k8s discovery, core/crds.py, extproc / "
                       "vllmgrpc; the card has no grpc)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m llmd_tpu_torch.router.serve")
    ap.add_argument("--config", default=None, help="FrameworkConfig YAML path")
    ap.add_argument("--endpoints", default=None, help="comma-separated addr list")
    ap.add_argument("--endpoints-file", default=None, help="file-discovery path")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--poll-interval", type=float, default=0.5)
    for flag, item in REFUSED_FLAGS.items():
        if flag == "--k8s-discovery":
            ap.add_argument(flag, action="store_true", help=f"not ported: {item}")
        else:
            ap.add_argument(flag, default=None, help=f"not ported: {item}")
    ap.add_argument("--ha-lease-file", default=None,
                    help="active-passive leader election via a local flock "
                         "lease (co-located replicas)")
    ap.add_argument("--ha-k8s-lease", default=None,
                    help="active-passive leader election via a "
                         "coordination.k8s.io Lease of this name")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, item in REFUSED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) not in (None, False):
            ap.exit(2, f"{flag} is not ported yet: {item}\n")
    if args.ha_lease_file and args.ha_k8s_lease:
        raise SystemExit("--ha-lease-file and --ha-k8s-lease are exclusive")

    from llmd_tpu_torch.core.config import FrameworkConfig
    from llmd_tpu_torch.core.endpoint import EndpointPool
    from llmd_tpu_torch.router.datalayer import add_static_endpoints
    from llmd_tpu_torch.router.discovery import FileSource
    from llmd_tpu_torch.router.plugins import known_plugin_types
    from llmd_tpu_torch.router.server import RouterServer

    if args.config:
        with open(args.config) as f:
            text = f.read()
    else:
        text = DEFAULT_CONFIG
    config = FrameworkConfig.from_yaml(text, known_types=known_plugin_types())

    pool = EndpointPool()
    sources = []
    if args.endpoints_file:
        sources.append(FileSource(pool, args.endpoints_file))
    if args.endpoints:
        add_static_endpoints(pool, args.endpoints.split(","))

    server = RouterServer(config, pool, host=args.host, port=args.port,
                          poll_interval_s=args.poll_interval)

    elector = None
    if args.ha_lease_file or args.ha_k8s_lease:
        from llmd_tpu_torch.router.ha import FileLease, K8sLease, LeaderElector, attach_ha

        lease = (FileLease(args.ha_lease_file) if args.ha_lease_file
                 else K8sLease(args.ha_k8s_lease))
        elector = LeaderElector(lease)
        attach_ha(server, elector)  # before start(): handlers bind at start

    async def run() -> None:
        await server.start()
        if elector is not None:
            await elector.start()
        for src in sources:
            await src.start()
        msg = f"llmd-tpu router on http://{server.address} ({len(pool)} endpoints)"
        if elector is not None:
            msg += f"; HA role={'leader' if elector.is_leader else 'standby'}"
        print(msg, flush=True)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
