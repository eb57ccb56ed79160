"""CLI: ``python -m llmd_tpu_torch.router.serve --config cfg.yaml --endpoints
a:8000,b:8000`` (port of ``llmd_tpu/router/serve.py``).

The no-Kubernetes standalone mode: static endpoints from ``--endpoints`` or an
``--endpoints-file`` (re-scanned when it changes); the config is the plugin
graph (``DEFAULT_CONFIG`` without ``--config``). Active-passive HA with
``--ha-lease-file PATH`` (co-located replicas, an flock lease) or
``--ha-k8s-lease NAME`` (a coordination.k8s.io Lease).

The gateway mode, as the reference serves it: ``--manifests FILE`` reads
InferencePool / InferenceObjective / InferenceModelRewrite /
VariantAutoscaling documents (objectives and rewrites go to the router);
``--k8s-discovery`` watches the pods of each InferencePool's selector;
``--extproc-port N`` serves the Envoy ext_proc EPP (FailOpen when any pool says
so, or ``--extproc-failure-mode``); ``--vllmgrpc-port N`` serves the vLLM gRPC
API. Both gRPC fronts run on the port's own wire (``router/grpc_wire.py``).
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

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m llmd_tpu_torch.router.serve")
    ap.add_argument("--config", default=None, help="FrameworkConfig YAML path")
    ap.add_argument("--endpoints", default=None, help="comma-separated addr list")
    ap.add_argument("--endpoints-file", default=None, help="file-discovery path")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--poll-interval", type=float, default=0.5)
    ap.add_argument("--extproc-port", type=int, default=None,
                    help="gateway mode: serve the Envoy ext_proc EPP gRPC here "
                         "(the HTTP port keeps serving /metrics and /health)")
    ap.add_argument("--extproc-failure-mode", default=None,
                    choices=["FailClose", "FailOpen"],
                    help="override the InferencePool failureMode for the "
                         "ext_proc EPP (no-kubernetes deployments have no "
                         "pool manifest to read it from)")
    ap.add_argument("--vllmgrpc-port", type=int, default=None,
                    help="serve the vLLM gRPC API (Generate/Embed) here — the "
                         "vllmgrpc-parser front, scheduled like HTTP traffic")
    ap.add_argument("--manifests", default=None,
                    help="InferencePool/InferenceObjective/InferenceModelRewrite/"
                         "VariantAutoscaling YAML (multi-doc)")
    ap.add_argument("--k8s-discovery", action="store_true",
                    help="discover endpoints by watching pods matching the "
                         "manifest InferencePool's selector/targetPorts")
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
    if args.ha_lease_file and args.ha_k8s_lease:
        raise SystemExit("--ha-lease-file and --ha-k8s-lease are exclusive")

    from llmd_tpu_torch.core.config import FrameworkConfig
    from llmd_tpu_torch.core.endpoint import EndpointPool
    from llmd_tpu_torch.router import discovery
    from llmd_tpu_torch.router.datalayer import add_static_endpoints
    from llmd_tpu_torch.router.plugins import known_plugin_types
    from llmd_tpu_torch.router.server import RouterServer

    if args.config:
        with open(args.config) as f:
            text = f.read()
    else:
        text = DEFAULT_CONFIG
    config = FrameworkConfig.from_yaml(text, known_types=known_plugin_types())

    manifests = None
    if args.manifests:
        from llmd_tpu_torch.core.crds import load_manifest_yaml

        with open(args.manifests) as f:
            manifests = load_manifest_yaml(f.read())

    pool = EndpointPool()
    sources = []
    if args.endpoints_file:
        sources.append(discovery.FileSource(pool, args.endpoints_file))
    if args.endpoints:
        add_static_endpoints(pool, args.endpoints.split(","))
    if args.k8s_discovery:
        if not manifests or not manifests.pools:
            raise SystemExit("--k8s-discovery needs --manifests with an InferencePool")
        # every InferencePool in the manifest gets its own watch (e.g. separate
        # prefill/decode pools); all feed the one EndpointPool
        for p in manifests.pools:
            sources.append(discovery.K8sWatchSource(pool, p.selector, p.target_ports,
                                                    namespace=p.namespace))

    server = RouterServer(
        config, pool, host=args.host, port=args.port,
        poll_interval_s=args.poll_interval,
        objectives=manifests.objectives_map() if manifests else None,
        model_rewrites=manifests.rewrites_map() if manifests else None,
    )

    elector = None
    if args.ha_lease_file or args.ha_k8s_lease:
        from llmd_tpu_torch.router.ha import FileLease, K8sLease, LeaderElector, attach_ha

        lease = (FileLease(args.ha_lease_file) if args.ha_lease_file
                 else K8sLease(args.ha_k8s_lease))
        elector = LeaderElector(lease)
        attach_ha(server, elector)  # before start(): handlers bind at start

    epp = vfront = None
    if args.extproc_port is not None:
        from llmd_tpu_torch.router.extproc import ExtProcEPP

        modes = ({p.failure_mode for p in manifests.pools}
                 if manifests and manifests.pools else set())
        if len(modes) > 1:
            print(f"warning: mixed failureModes {sorted(modes)}; "
                  "FailOpen wins for the shared EPP", flush=True)
        failure_mode = args.extproc_failure_mode or (
            "FailOpen" if "FailOpen" in modes else "FailClose")
        epp = ExtProcEPP(server, host=args.host, port=args.extproc_port,
                         failure_mode=failure_mode)
    if args.vllmgrpc_port is not None:
        from llmd_tpu_torch.router.vllmgrpc import VllmGrpcFront

        vfront = VllmGrpcFront(server, host=args.host, port=args.vllmgrpc_port)

    async def run() -> None:
        await server.start()
        if elector is not None:
            await elector.start()
        for src in sources:
            await src.start()
        discovered = (f"{len(pool)} endpoints"
                      if not args.k8s_discovery
                      else f"{len(pool)} endpoints at startup; k8s watch active "
                           f"({len(sources)} pool(s))")
        msg = f"llmd-tpu router on http://{server.address} ({discovered})"
        if epp is not None:
            await epp.start()
            msg += f"; ext-proc EPP on grpc://{epp.address} ({epp.failure_mode})"
        if vfront is not None:
            await vfront.start()
            msg += f"; vllm-grpc on grpc://{vfront.address}"
        if elector is not None:
            msg += f"; HA role={'leader' if elector.is_leader else 'standby'}"
        print(msg, flush=True)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
