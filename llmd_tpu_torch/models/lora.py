"""Multi-adapter LoRA: batched low-rank deltas on the attention path (port of
``llmd_tpu/models/lora.py``, which cites llm-d's dynamic-adapter contract,
``model-servers.md:55-75`` and ``adapter-rollout.md:11-31``).

- Every adapter lives in one fixed-shape bank per target, ``n_slots =
  max_adapters + 1`` slots wide. Loading an adapter writes one slot in place,
  so the step programs (and the decode program's captured CUDA graph, which
  holds the bank's address) never change as adapters come and go.
- Slot 0 is the permanent null adapter (B = 0): its rows get an exact zero
  delta, so they are bitwise the base model's. Every token carries its slot.
- Targets q/k/v/o. The delta of a token in slot s is
  ``(h @ A[s]) @ B[s] * alpha / r``.

The bank's layout follows the products the engine runs (:func:`apply_lora`),
not the reference's ``[L, S, Din, r]``: ``lora_A_<t>`` is ``[L, Din, S, r]``,
so one layer's bank is the dense shrink operand ``[Din, S·r]`` as a view,
and ``lora_B_<t>`` is the reference's ``[L, S, r, Dout]``, one layer's bank
being the dense expand operand ``[S·r, Dout]``. ``bank_from_reference``
converts the reference's arrays.

Under a tp mesh each rank holds its block of the bank
(``parallel/mesh.lora_bank_axes``): A of q/k/v whole and B of q/k/v split on
its output as the base weight is, so :func:`apply_lora` gives this rank's
heads' delta; B of wo whole and A of wo this rank's heads' rows, so
:func:`apply_lora` on this rank's head output gives a partial delta that
``forward_core`` adds to wo's partial sum before wo's all-reduce (by
linearity, the sum over ranks is the whole delta). The engine writes a slot
on every rank through its ``lora_write`` op (``engine/engine.py``).

:func:`make_adapter_weights` draws a test double from an explicit
``torch.Generator``: ``jax.random`` cannot be reproduced without jax, so a
port engine's default double for a name differs from the JAX engine's (the
weights, not their shapes or scales). Parity tests load the same arrays into
both engines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class LoRAConfig:
    max_adapters: int = 8  # vllm:lora_requests_info max_lora
    rank: int = 8
    alpha: float = 16.0

    @property
    def n_slots(self) -> int:
        return self.max_adapters + 1  # slot 0 = the null adapter

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


LORA_TARGETS = ("wq", "wk", "wv", "wo")


def lora_dims(model_cfg) -> tuple[dict[str, int], dict[str, int]]:
    """(input width, output width) of each target: wo's input is the
    concatenated head output, not the hidden width."""
    D, H, Hk, Dh = (model_cfg.hidden_size, model_cfg.num_heads, model_cfg.num_kv_heads,
                    model_cfg.head_dim)
    return ({"wq": D, "wk": D, "wv": D, "wo": H * Dh},
            {"wq": H * Dh, "wk": Hk * Dh, "wv": Hk * Dh, "wo": D})


def init_lora_params(model_cfg, lora_cfg: LoRAConfig,
                     device: "torch.device | str | None" = None) -> dict[str, torch.Tensor]:
    """The all-zero bank (every slot the null adapter), in the model dtype."""
    L, r, S = model_cfg.num_layers, lora_cfg.rank, lora_cfg.n_slots
    dims_in, dims_out = lora_dims(model_cfg)
    dt = model_cfg.torch_dtype
    p: dict[str, torch.Tensor] = {}
    for t in LORA_TARGETS:
        p[f"lora_A_{t}"] = torch.zeros((L, dims_in[t], S, r), dtype=dt, device=device)
        p[f"lora_B_{t}"] = torch.zeros((L, S, r, dims_out[t]), dtype=dt, device=device)
    return p


def bank_from_reference(name: str, a: torch.Tensor) -> torch.Tensor:
    """A reference bank array (``[L, S, Din, r]`` for A, ``[L, S, r, Dout]``
    for B) in this module's layout."""
    return a.permute(0, 2, 1, 3).contiguous() if name.startswith("lora_A_") else a


def make_adapter_weights(model_cfg, lora_cfg: LoRAConfig, generator: torch.Generator,
                         targets: tuple[str, ...] = LORA_TARGETS) -> dict[str, torch.Tensor]:
    """One adapter's weights, ``lora_A_<t> [L, Din, r]`` and ``lora_B_<t>
    [L, r, Dout]``, drawn on the generator's device: A a scaled normal (the
    reference's ``Din^-0.5``) and, for a test double that visibly changes
    outputs, B a normal times 0.05 (a trained LoRA starts at B = 0)."""
    L, r = model_cfg.num_layers, lora_cfg.rank
    dims_in, dims_out = lora_dims(model_cfg)
    dt, dev = model_cfg.torch_dtype, generator.device
    out = {}
    for t in targets:
        a = torch.randn((L, dims_in[t], r), generator=generator, device=dev)
        b = torch.randn((L, r, dims_out[t]), generator=generator, device=dev)
        out[f"lora_A_{t}"] = (a * dims_in[t] ** -0.5).to(dt)
        out[f"lora_B_{t}"] = (b * 0.05).to(dt)
    return out


def slot_mask(idx: torch.Tensor, n_slots: int, dtype: torch.dtype) -> torch.Tensor:
    """``[N, S]``: 1 at each token's slot, 0 elsewhere (no host read)."""
    return (idx.long()[:, None] == torch.arange(n_slots, device=idx.device)).to(dtype)


def apply_lora(h: torch.Tensor, A: torch.Tensor, B: torch.Tensor, mask: torch.Tensor,
               scale: float) -> torch.Tensor:
    """Per-token adapter delta as two dense products over the whole bank, no
    per-token gather of weights. h: ``[N, Din]``; A: one layer's bank ``[Din,
    S, r]``; B: ``[S, r, Dout]``; mask: :func:`slot_mask` of the tokens'
    slots. Returns ``[N, Dout]``.

    Shrink: ``h @ A [Din, S·r]`` gives every slot's ``r`` values for every
    token. Expand: each token keeps only its slot's block (the others are
    multiplied by exact zeros), times ``B [S·r, Dout]``, then by ``scale``:
    the sum over the other slots adds exact zeros, so each token's delta is
    its own slot's, and slot 0 (B = 0) gives an exact zero."""
    N = h.shape[0]
    Din, S, r = A.shape
    xa = (h @ A.reshape(Din, S * r)).view(N, S, r) * mask[:, :, None]
    return (xa.reshape(N, S * r) @ B.reshape(S * r, -1)) * scale


def apply_lora_ref(h: torch.Tensor, A: torch.Tensor, B: torch.Tensor, idx: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """The plain version, the reference's per-token gather: A ``[S, Din, r]``
    (the reference's layout), B ``[S, r, Dout]``, idx ``[N]``."""
    Ab, Bb = A[idx.long()], B[idx.long()]  # [N, Din, r], [N, r, Dout]
    xa = torch.einsum("nd,ndr->nr", h, Ab)
    return torch.einsum("nr,nrk->nk", xa, Bb) * scale


def adapter_digest(weights: dict) -> str:
    """The first 16 hex digits of sha256 over the sorted keys and each
    array's bytes as the caller gave them: numpy arrays as they are, a bf16
    tensor as its 16-bit integer view (the bytes of ``ml_dtypes``' bfloat16), any
    other tensor as its own bytes. A JAX engine and a port engine that load
    the same weights agree, so they publish the same block keys."""
    import hashlib

    digest = hashlib.sha256()
    for k in sorted(weights):
        w = weights[k]
        if isinstance(w, torch.Tensor):
            w = w.detach().cpu()
            w = (w.view(torch.int16) if w.dtype == torch.bfloat16 else w).contiguous().numpy()
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(np.asarray(w)).tobytes())
    return digest.hexdigest()[:16]


class LoRARegistry:
    """Name → slot mapping with an LRU of *inactive* adapters (a copy of the
    reference's). The engine owns the device bank; this class owns the
    naming, slot assignment and the metrics contract's fields
    (``vllm:lora_requests_info{max_lora, running_lora_adapters,
    waiting_lora_adapters}``)."""

    def __init__(self, max_adapters: int) -> None:
        self.max_adapters = max_adapters
        self.slots: dict[str, int] = {}  # name -> slot (1-based; 0 = null)
        self._free = list(range(max_adapters, 0, -1))
        self.running: dict[str, int] = {}  # name -> active request count
        self.waiting: dict[str, int] = {}
        self.on_evict = None  # callback(name) when an idle adapter is displaced

    def slot_of(self, name: Optional[str]) -> int:
        if name is None:
            return 0
        return self.slots.get(name, 0)

    def has(self, name: str) -> bool:
        return name in self.slots

    def assign(self, name: str) -> int:
        """Reserve a slot for a new adapter; raises when the bank is full."""
        if name in self.slots:
            return self.slots[name]
        if not self._free:
            # evict an idle adapter if any (the reference's simple policy)
            idle = next((n for n in self.slots
                         if not self.running.get(n) and not self.waiting.get(n)), None)
            if idle is None:
                raise RuntimeError(f"all {self.max_adapters} LoRA slots busy")
            self._free.append(self.slots.pop(idle))
            if self.on_evict is not None:
                self.on_evict(idle)
        slot = self._free.pop()
        self.slots[name] = slot
        return slot

    def remove(self, name: str) -> Optional[int]:
        slot = self.slots.pop(name, None)
        if slot is not None:
            self._free.append(slot)
            self.running.pop(name, None)
            self.waiting.pop(name, None)
        return slot

    # request lifecycle hooks (feed the metrics contract)
    def on_waiting(self, name: Optional[str]) -> None:
        if name:
            self.waiting[name] = self.waiting.get(name, 0) + 1

    def on_running(self, name: Optional[str]) -> None:
        if name:
            if self.waiting.get(name, 0) > 0:
                self.waiting[name] -= 1
            self.running[name] = self.running.get(name, 0) + 1

    def on_finished(self, name: Optional[str]) -> None:
        if name and self.running.get(name, 0) > 0:
            self.running[name] -= 1

    def metrics_info(self) -> dict:
        return {
            "max_lora": self.max_adapters,
            "running_lora_adapters": ",".join(
                sorted(n for n, c in self.running.items() if c > 0)),
            "waiting_lora_adapters": ",".join(
                sorted(n for n, c in self.waiting.items() if c > 0)),
        }
