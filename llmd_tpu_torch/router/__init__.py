"""The router (EPP): the scheduling brain in front of the engines (port of
``llmd_tpu/router``).

Request parsing -> flow control -> Filter -> Score -> Pick scheduling ->
endpoint choice, with the data layer feeding per-endpoint metrics and the KV
events feeding prefix affinity. It runs standalone (built-in HTTP proxy, file
discovery) or behind a gateway (the Envoy ext_proc EPP and the vLLM gRPC front
on the port's own gRPC wire, InferencePool manifests, the Kubernetes pod
watch), with the reference's plugin-config surface. It imports no torch: the
router is host code in front of port engines.
"""

from llmd_tpu_torch.router.plugins import (  # noqa: F401
    PLUGIN_REGISTRY,
    Admitter,
    DataProducer,
    Filter,
    Picker,
    Scorer,
    build_plugin,
    register_plugin,
)
from llmd_tpu_torch.router.scheduler import Scheduler, SchedulingResult  # noqa: F401

# register the plugin suites (importing them populates PLUGIN_REGISTRY)
from llmd_tpu_torch.router import filters_pickers, latency_plugins, scorers  # noqa: E402,F401
from llmd_tpu_torch.kv import plugins as _kv_plugins  # noqa: E402,F401
