"""Model-server metrics contract and engine-name mapping (copy of
``llmd_tpu/core/metrics_contract.py``).

The router scrapes an engine's Prometheus endpoint and maps engine-specific
metric names (vLLM, SGLang, trtllm, this project's engines) onto standard keys;
the port's tests and ``chip_smoke.py`` read a port engine's ``/metrics``
through the same mapping.
"""

from __future__ import annotations

import re
from typing import Iterable


class StdMetric:
    """Standard attribute keys written into Endpoint.attrs by the core-metrics-extractor."""

    QUEUED_REQUESTS = "total_queued_requests"
    RUNNING_REQUESTS = "total_running_requests"
    KV_UTILIZATION = "kv_cache_utilization"  # fraction [0,1]
    BLOCK_SIZE = "kv_block_size"  # tokens per KV block
    NUM_BLOCKS = "kv_num_blocks"  # total HBM KV blocks
    LORA_INFO = "lora_info"  # dict: max_lora, running, waiting
    WAITING_TOKENS = "waiting_tokens"  # for token-load-scorer


# engine-type → {standard key: (metric name, optional label name)}
# A label name means the value is carried on a labeled info-gauge (cache_config_info).
METRIC_MAPPINGS: dict[str, dict[str, tuple[str, str | None]]] = {
    "vllm": {
        StdMetric.QUEUED_REQUESTS: ("vllm:num_requests_waiting", None),
        StdMetric.RUNNING_REQUESTS: ("vllm:num_requests_running", None),
        StdMetric.KV_UTILIZATION: ("vllm:kv_cache_usage_perc", None),
        StdMetric.BLOCK_SIZE: ("vllm:cache_config_info", "block_size"),
        StdMetric.NUM_BLOCKS: ("vllm:cache_config_info", "num_gpu_blocks"),
    },
    "sglang": {
        StdMetric.QUEUED_REQUESTS: ("sglang:num_queue_reqs", None),
        StdMetric.RUNNING_REQUESTS: ("sglang:num_running_reqs", None),
        StdMetric.KV_UTILIZATION: ("sglang:token_usage", None),
        StdMetric.BLOCK_SIZE: ("sglang:cache_config_info", "page_size"),
        StdMetric.NUM_BLOCKS: ("sglang:cache_config_info", "num_pages"),
    },
    "trtllm-serve": {
        StdMetric.QUEUED_REQUESTS: ("trtllm_num_requests_waiting", None),
        StdMetric.RUNNING_REQUESTS: ("trtllm_num_requests_running", None),
        StdMetric.KV_UTILIZATION: ("trtllm_kv_cache_utilization", None),
        StdMetric.BLOCK_SIZE: ("trtllm_kv_cache_tokens_per_block", None),
        StdMetric.NUM_BLOCKS: ("trtllm_kv_cache_max_blocks", None),
    },
    # Our own TPU engine publishes the vLLM-compatible names so existing llm-d routers
    # and dashboards work unchanged, plus llmd_tpu:* duplicates.
    "llmd-tpu": {
        StdMetric.QUEUED_REQUESTS: ("vllm:num_requests_waiting", None),
        StdMetric.RUNNING_REQUESTS: ("vllm:num_requests_running", None),
        StdMetric.KV_UTILIZATION: ("vllm:kv_cache_usage_perc", None),
        StdMetric.BLOCK_SIZE: ("vllm:cache_config_info", "block_size"),
        StdMetric.NUM_BLOCKS: ("vllm:cache_config_info", "num_gpu_blocks"),
    },
}

LORA_METRIC = "vllm:lora_requests_info"

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^\s]+)"
)
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> list[tuple[str, dict[str, str], float]]:
    """Minimal Prometheus text-format parser: (name, labels, value) per sample."""
    out: list[tuple[str, dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        labels = dict(_LABEL_RE.findall(m.group("labels") or ""))
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        out.append((m.group("name"), labels, value))
    return out


def map_engine_metrics(engine_type: str, samples: Iterable[tuple[str, dict[str, str], float]]):
    """Map scraped samples to standard keys → values (core-metrics-extractor).

    LoRA info-gauge handling follows model-servers.md:64-75: value is a timestamp; the
    freshest sample's labels carry max_lora / running / waiting adapter lists.
    """
    mapping = METRIC_MAPPINGS.get(engine_type, METRIC_MAPPINGS["vllm"])
    by_metric: dict[str, list[tuple[dict[str, str], float]]] = {}
    for name, labels, value in samples:
        by_metric.setdefault(name, []).append((labels, value))

    out: dict[str, object] = {}
    for std_key, (metric_name, label_name) in mapping.items():
        rows = by_metric.get(metric_name)
        if not rows:
            continue
        if label_name is None:
            out[std_key] = rows[-1][1]
        else:
            for labels, _ in rows:
                if label_name in labels:
                    try:
                        out[std_key] = float(labels[label_name])
                    except ValueError:
                        pass
    lora_rows = by_metric.get(LORA_METRIC)
    if lora_rows:
        labels, _ = max(lora_rows, key=lambda r: r[1])  # latest timestamp wins
        out[StdMetric.LORA_INFO] = {
            "max_lora": int(float(labels.get("max_lora", "0") or 0)),
            "running": [a.strip() for a in labels.get("running_lora_adapters", "").split(",") if a.strip()],
            "waiting": [a.strip() for a in labels.get("waiting_lora_adapters", "").split(",") if a.strip()],
        }
    return out
