"""Filter -> Score -> Pick scheduler and its profile handlers (copy of
``llmd_tpu/router/scheduler.py``).

Each profile sums its scorers' weighted scores over the candidates its filters
keep, and its picker chooses. ``single-profile`` runs the ``default`` profile;
``disagg-profile-handler`` runs the decode profile first, then decides on the
uncached suffix (and the predictor's stamps, when a config has them) whether
to run the prefill profile and split the request.

The scheduler owns one ``random.Random`` (``seed``; a fresh seed by default)
and hands it to every plugin that draws, where the reference draws from the
global ``random`` module: the same seed gives the same draws in the same
order.
"""

from __future__ import annotations

import math
import os
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from llmd_tpu_torch.core.config import FrameworkConfig
from llmd_tpu_torch.core.endpoint import Endpoint, EndpointPool
from llmd_tpu_torch.core.request import InferenceRequest
from llmd_tpu_torch.router.plugins import (
    Admitter,
    DataProducer,
    Filter,
    Picker,
    Scorer,
    build_plugin,
)
from llmd_tpu_torch.obs.decisions import decisions_enabled
from llmd_tpu_torch.router.scorers import (
    STATE_PREDICTED,
    STATE_PREFIX_HITS,
    STATE_TOKEN_IDS,
    clamp_scores,
)


@dataclass
class ProfileRun:
    name: str
    endpoint: Optional[Endpoint]
    scores: dict[Endpoint, float] = field(default_factory=dict)
    # Decision-ledger capture (obs/decisions.py): {"filters": [[name, dropped]],
    # "candidates": n, "tie": n, "scorers": [(name, weight, {Endpoint: score})]}.
    # None whenever LLMD_DECISION_LEDGER is off — the detail path then
    # allocates nothing.
    detail: Optional[dict] = None


@dataclass
class SchedulingResult:
    """Primary endpoint + optional prefill endpoint (P/D) + per-profile detail."""

    endpoint: Optional[Endpoint]
    prefill_endpoint: Optional[Endpoint] = None
    profiles: dict[str, ProfileRun] = field(default_factory=dict)
    rejected: Optional[str] = None
    latency_s: float = 0.0
    # Candidates removed before any profile ran ({"excluded": n,
    # "resilience_dropped": n}); None when the decision ledger is off.
    pre_drops: Optional[dict] = None
    # Disagg decider outcome (docs/pd-disaggregation.md): decision, reason,
    # predicted TTFT deltas, priced kv_pull hop, and the chosen P/D pair.
    # None outside the disagg-profile-handler.
    pd: Optional[dict] = None


class Profile:
    def __init__(self, name: str, entries: list[tuple[Any, float]]) -> None:
        self.name = name
        self.filters: list[Filter] = []
        self.scorers: list[tuple[Scorer, float]] = []
        self.picker: Optional[Picker] = None
        for plugin, weight in entries:
            if hasattr(plugin, "filter"):
                self.filters.append(plugin)
            elif hasattr(plugin, "score"):
                self.scorers.append((plugin, weight))
            elif hasattr(plugin, "pick"):
                self.picker = plugin

    def run(self, req: InferenceRequest, endpoints: list[Endpoint],
            detail: bool = False) -> ProfileRun:
        cands = list(endpoints)
        drops: Optional[list] = [] if detail else None
        for f in self.filters:
            kept = f.filter(req, cands)
            if detail and len(kept) != len(cands):
                drops.append([type(f).__name__, len(cands) - len(kept)])
            cands = kept
            if not cands:
                det = ({"filters": drops, "candidates": 0, "tie": 0,
                        "scorers": []} if detail else None)
                return ProfileRun(self.name, None, detail=det)
        totals: dict[Endpoint, float] = {e: 0.0 for e in cands}
        per_scorer: Optional[list] = [] if detail else None
        for scorer, weight in self.scorers:
            scores = clamp_scores(scorer.score(req, cands), totals)
            for e, s in scores.items():
                totals[e] += weight * s
            if detail:
                per_scorer.append((type(scorer).__name__, weight, scores))
        picked = self.picker.pick(req, totals) if self.picker else None
        det = None
        if detail:
            mx = max(totals.values()) if totals else 0.0
            det = {
                "filters": drops,
                "candidates": len(totals),
                "tie": sum(1 for s in totals.values() if s >= mx - 1e-9),
                "scorers": per_scorer,
            }
        return ProfileRun(self.name, picked, totals, det)


class Scheduler:
    """Built from a FrameworkConfig; owns plugin instances and the shared context."""

    def __init__(self, config: FrameworkConfig, pool: EndpointPool,
                 ctx: Optional[dict[str, Any]] = None,
                 seed: Optional[int] = None) -> None:
        self.config = config
        self.pool = pool
        self.ctx = ctx if ctx is not None else {}
        self.rng = random.Random(seed)
        self.plugins: dict[str, Any] = {}
        for spec in config.plugins:
            plugin = build_plugin(spec.type, spec.params, self.ctx)
            if isinstance(getattr(plugin, "rng", None), random.Random):
                plugin.rng = self.rng
            self.plugins[spec.name] = plugin
        self.profiles: dict[str, Profile] = {}
        for prof in config.scheduling_profiles:
            entries = [(self.plugins[r.plugin_ref], r.weight) for r in prof.plugins]
            self.profiles[prof.name] = Profile(prof.name, entries)
        self.producers: list[DataProducer] = [
            p for p in self.plugins.values() if isinstance(p, DataProducer)
        ]
        self.admitters: list[Admitter] = [
            p for p in self.plugins.values() if isinstance(p, Admitter)
        ]
        self.handler = config.profile_handler
        # disagg decider params (docs/pd-disaggregation.md): the config's
        # uncachedSuffixThreshold wins; LLMD_PD_THRESHOLD_TOKENS is the env
        # fallback when the config leaves it unset. The kv_pull hop price
        # (base + per-block transfer cost) and the decision margin gate the
        # predictor comparison in _pd_decide.
        raw_fc = config.raw.get("disaggregation", {}) or {}
        self.pd_threshold_tokens = int(raw_fc.get(
            "uncachedSuffixThreshold",
            os.environ.get("LLMD_PD_THRESHOLD_TOKENS", "0") or 0))
        self.pd_kv_pull_base_ms = float(
            os.environ.get("LLMD_PD_KV_PULL_BASE_MS", "2.0"))
        self.pd_kv_pull_ms_per_block = float(
            os.environ.get("LLMD_PD_KV_PULL_MS_PER_BLOCK", "0.5"))
        self.pd_margin_ms = float(os.environ.get("LLMD_PD_MARGIN_MS", "0.0"))
        self.metrics = {"scheduled_total": 0, "rejected_total": 0,
                        "pd_splits_total": 0, "pd_aggregated_total": 0}
        # Resilience hook (router/resilience.py): filters breaker-open and
        # draining endpoints out of every pick. None = no filtering.
        self.endpoint_filter: Optional[Callable[[list[Endpoint]], list[Endpoint]]] = None
        # Decision-ledger switch, read once: when off, Profile.run skips all
        # detail capture and schedule() allocates nothing extra per request.
        self.record_decisions = decisions_enabled()

    # ------------------------------------------------------------------
    def schedule(self, req: InferenceRequest,
                 exclude: Optional[set[str]] = None) -> SchedulingResult:
        """Pick endpoint(s) for ``req``. ``exclude`` holds addresses already
        tried this request (retry re-pick, llm-d ``excluded_runner_ids``
        semantics) — they are removed BEFORE the resilience filter so the
        fail-open backstop cannot hand back an endpoint that just failed."""
        t0 = time.monotonic()
        endpoints = self.pool.list()
        n_pool = len(endpoints)
        if exclude:
            endpoints = [e for e in endpoints if e.address not in exclude]
        n_after_exclude = len(endpoints)
        if self.endpoint_filter is not None and endpoints:
            endpoints = self.endpoint_filter(endpoints)
        if not endpoints:
            return SchedulingResult(None, rejected="no endpoints")
        pre_drops = None
        if self.record_decisions:
            n_excluded = n_pool - n_after_exclude
            n_resilience = n_after_exclude - len(endpoints)
            if n_excluded or n_resilience:
                pre_drops = {"excluded": n_excluded,
                             "resilience_dropped": n_resilience}
        for p in self.producers:
            p.produce(req, endpoints)
        for a in self.admitters:
            ok, why = a.admit(req, endpoints)
            if not ok:
                self.metrics["rejected_total"] += 1
                return SchedulingResult(None, rejected=why or "admission rejected")

        if self.handler == "disagg-profile-handler":
            res = self._schedule_disagg(req, endpoints)
        else:
            res = self._schedule_single(req, endpoints)
        res.pre_drops = pre_drops

        if res.endpoint is not None:
            self.metrics["scheduled_total"] += 1
            for p in self.producers:
                p.pre_request(req, res.endpoint)
            nh = self.plugins.get("no-hit-lru-scorer")
            if nh is not None and hasattr(nh, "note_pick"):
                hits = req.state.get(STATE_PREFIX_HITS) or {}
                if not any(v > 0 for v in hits.values()):
                    nh.note_pick(res.endpoint)
        res.latency_s = time.monotonic() - t0
        return res

    def post_response(self, req: InferenceRequest, endpoint: Endpoint,
                      response_info: dict[str, Any]) -> None:
        for p in self.producers:
            p.post_response(req, endpoint, response_info)

    # ------------------------------------------------------------------
    def _profile(self, name: str) -> Optional[Profile]:
        return self.profiles.get(name)

    def _schedule_single(self, req, endpoints) -> SchedulingResult:
        prof = self._profile("default") or next(iter(self.profiles.values()), None)
        if prof is None:
            return SchedulingResult(None, rejected="no scheduling profile")
        run = prof.run(req, endpoints, detail=self.record_decisions)
        return SchedulingResult(run.endpoint, profiles={prof.name: run},
                                rejected=None if run.endpoint else "no endpoint passed filters")

    def _schedule_disagg(self, req, endpoints) -> SchedulingResult:
        """Decode profile first; predictor-gated decider; maybe prefill profile.

        Reference disaggregation/README.md:57-91: run decode profile → compute
        the uncached suffix on the chosen D endpoint → if large enough, run the
        prefill profile and consult the latency predictor: disaggregate only
        when predicted TTFT-on-P plus the priced kv_pull hop beats aggregated
        prefill on D. Short/cached prompts skip the hop before the prefill
        profile ever runs. The outcome (decision, reason, predicted deltas,
        chosen P/D pair) is stamped into ``result.pd`` for the decision ledger.
        """
        dec_prof = self._profile("decode") or self._profile("default")
        if dec_prof is None:
            return SchedulingResult(None, rejected="no decode profile")
        dec = dec_prof.run(req, endpoints, detail=self.record_decisions)
        if dec.endpoint is None:
            return SchedulingResult(None, rejected="no decode endpoint")
        result = SchedulingResult(dec.endpoint, profiles={dec_prof.name: dec})

        hits = req.state.get(STATE_PREFIX_HITS) or {}
        n_tokens = len(req.state.get(STATE_TOKEN_IDS) or req.prompt_text().encode())
        uncached = n_tokens - hits.get(dec.endpoint.address, 0)
        pre_prof = self._profile("prefill")
        if pre_prof is None:
            result.pd = self._pd_aggregated(req, dec.endpoint,
                                            "no_prefill_profile", uncached)
            return result
        if uncached < self.pd_threshold_tokens:
            # short uncached suffix: decode-only (aggregated), hop skipped
            result.pd = self._pd_aggregated(req, dec.endpoint,
                                            "short_uncached_suffix", uncached)
            return result
        pre = pre_prof.run(req, [e for e in endpoints if e != dec.endpoint] or endpoints,
                           detail=self.record_decisions)
        if pre.endpoint is None:
            result.pd = self._pd_aggregated(req, dec.endpoint,
                                            "no_prefill_endpoint", uncached)
            return result
        result.profiles[pre_prof.name] = pre
        result.pd = self._pd_decide(req, dec.endpoint, pre.endpoint, uncached)
        if result.pd["decision"] == "split":
            result.prefill_endpoint = pre.endpoint
            self.metrics["pd_splits_total"] += 1
        else:
            self.metrics["pd_aggregated_total"] += 1
        return result

    # ------------------------------------------------------------ pd decider
    def _pd_hop_ms(self, uncached: int) -> float:
        """Priced kv_pull hop: P→D transfer of the uncached suffix's blocks."""
        blocks = math.ceil(max(0, uncached) / 16)
        return self.pd_kv_pull_base_ms + self.pd_kv_pull_ms_per_block * blocks

    def _pd_aggregated(self, req, dec_ep, reason: str, uncached: int) -> dict:
        self.metrics["pd_aggregated_total"] += 1
        pd = {"decision": "aggregated", "reason": reason,
              "uncached_tokens": uncached,
              "hop_ms": round(self._pd_hop_ms(uncached), 3),
              "decode": dec_ep.address}
        pred = (req.state.get(STATE_PREDICTED) or {}).get(dec_ep.address)
        if pred is not None:
            pd["ttft_agg_ms"] = round(float(pred[0]), 3)
        return pd

    def _pd_decide(self, req, dec_ep, pre_ep, uncached: int) -> dict:
        """Split iff predicted TTFT on P + hop beats aggregated prefill on D.

        Without predictor stamps (no predicted-latency-producer in the config)
        the decider degrades to the legacy threshold-only behavior: past the
        uncached-suffix threshold, always split.
        """
        preds = req.state.get(STATE_PREDICTED) or {}
        dec_pred = preds.get(dec_ep.address)
        pre_pred = preds.get(pre_ep.address)
        hop_ms = self._pd_hop_ms(uncached)
        pd = {"uncached_tokens": uncached, "hop_ms": round(hop_ms, 3),
              "prefill": pre_ep.address, "decode": dec_ep.address}
        if dec_pred is None or pre_pred is None:
            pd.update(decision="split", reason="no_predictor")
            return pd
        ttft_agg = float(dec_pred[0])  # prefill runs on D, no hop
        ttft_split = float(pre_pred[0]) + hop_ms  # prefill on P, then pull
        split = ttft_split + self.pd_margin_ms < ttft_agg
        pd.update(
            decision="split" if split else "aggregated",
            reason="predicted_ttft" if split else "hop_not_worth_it",
            ttft_agg_ms=round(ttft_agg, 3),
            ttft_split_ms=round(ttft_split, 3),
            delta_ms=round(ttft_agg - ttft_split, 3))
        return pd
