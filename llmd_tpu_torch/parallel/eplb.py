"""EPLB — expert-parallel load balancing with redundant experts (copy of
``llmd_tpu/parallel/eplb.py``, numpy only).

The MoE weights' expert ("slot") dimension holds ``S >= E`` physical slots;
heavy experts get more than one. Slot order is placement: slots
``[r*S/ep : (r+1)*S/ep]`` belong to EP rank ``r`` (each rank of a mesh
regathers its own, ``engine/engine.py`` ``_op_eplb``). Rebalancing recomputes ``slot_to_expert`` from the
windowed loads and re-gathers the physical weights from the logical copy.

Algorithm (greedy):
1. every expert keeps >= 1 slot; the ``num_redundant_experts`` extra slots go
   one at a time to the expert with the highest per-replica load;
2. replica instances (load = expert_load / n_replicas) are placed onto EP
   ranks longest-processing-time-first, replicas of one expert spread across
   ranks.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class EPLBConfig:
    window_size: int = 1000        # engine steps of load stats retained
    step_interval: int = 3000      # engine steps between rebalances
    num_redundant_experts: int = 32


class ExpertLoadTracker:
    """Sliding window of per-layer per-expert routed-token counts."""

    def __init__(self, num_layers: int, num_experts: int, window_size: int) -> None:
        self.window: deque[np.ndarray] = deque(maxlen=window_size)
        self.num_layers = num_layers
        self.num_experts = num_experts

    def record(self, counts: np.ndarray) -> None:
        """counts: [L, E] tokens routed to each expert this step."""
        assert counts.shape == (self.num_layers, self.num_experts), counts.shape
        self.window.append(np.asarray(counts, np.int64))

    def loads(self) -> np.ndarray:
        """[L, E] windowed load, +1 smoothing so idle experts keep a floor."""
        if not self.window:
            return np.ones((self.num_layers, self.num_experts), np.int64)
        return np.sum(self.window, axis=0) + 1


def assign_replica_counts(loads: np.ndarray, num_slots: int) -> np.ndarray:
    """loads: [E] -> replica count per expert, sum == num_slots, each >= 1.

    Greedy: repeatedly give the next redundant slot to the expert whose
    per-replica load is currently highest.
    """
    E = loads.shape[0]
    if num_slots < E:
        raise ValueError(f"num_slots {num_slots} < num_experts {E}")
    counts = np.ones((E,), np.int64)
    loads = loads.astype(np.float64)
    for _ in range(num_slots - E):
        counts[np.argmax(loads / counts)] += 1
    return counts


def place_slots(loads: np.ndarray, replica_counts: np.ndarray, ep_size: int) -> np.ndarray:
    """LPT placement of replica instances onto EP ranks.

    Returns ``slot_to_expert`` [S] with S = sum(replica_counts); slots are laid
    out rank-major (slots of rank r are contiguous). Replicas of one expert land
    on distinct ranks while rank capacity allows.
    """
    S = int(replica_counts.sum())
    if S % ep_size != 0:
        raise ValueError(f"total slots {S} not divisible by ep_size {ep_size}")
    per_rank = S // ep_size
    inst = []  # (per-replica load, expert), heaviest first
    for e, c in enumerate(replica_counts):
        inst.extend([(loads[e] / c, e)] * int(c))
    inst.sort(key=lambda t: -t[0])

    rank_load = np.zeros((ep_size,), np.float64)
    rank_slots: list[list[int]] = [[] for _ in range(ep_size)]
    rank_has: list[set[int]] = [set() for _ in range(ep_size)]
    for load, e in inst:
        order = np.argsort(rank_load, kind="stable")
        # prefer the least-loaded rank that has room and no replica of e yet
        pick = next(
            (r for r in order if len(rank_slots[r]) < per_rank and e not in rank_has[r]),
            next(r for r in order if len(rank_slots[r]) < per_rank),
        )
        rank_slots[pick].append(e)
        rank_has[pick].add(e)
        rank_load[pick] += load
    return np.concatenate([np.asarray(s, np.int32) for s in rank_slots])


def rebalance(loads: np.ndarray, num_slots: int, ep_size: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-layer rebalance. loads: [L, E].

    Returns (slot_to_expert [L, S], replica_slots [L, E, R], replica_counts [L, E])
    where R = max replicas any expert got; ``replica_slots[l, e, i % counts[l, e]]``
    is a valid slot for expert e (unused tail entries repeat the first slot so any
    index is safe).
    """
    L, E = loads.shape
    s2e = np.zeros((L, num_slots), np.int32)
    counts = np.zeros((L, E), np.int32)
    for l in range(L):
        rc = assign_replica_counts(loads[l], num_slots)
        s2e[l] = place_slots(loads[l], rc, ep_size)
        counts[l] = rc
    R = int(counts.max())
    slots = np.zeros((L, E, R), np.int32)
    for l in range(L):
        for e in range(E):
            mine = np.nonzero(s2e[l] == e)[0]
            slots[l, e, : len(mine)] = mine
            slots[l, e, len(mine):] = mine[0]  # safe pad
    return s2e, slots, counts


def balance_ratio(loads: np.ndarray, slot_to_expert: np.ndarray,
                  replica_counts: np.ndarray, ep_size: int) -> float:
    """max/mean per-rank load under the placement (1.0 = perfect). loads: [E]."""
    S = slot_to_expert.shape[0]
    per_rank = S // ep_size
    per_slot = loads[slot_to_expert] / replica_counts[slot_to_expert]
    rank_loads = per_slot.reshape(ep_size, per_rank).sum(axis=1)
    return float(rank_loads.max() / max(rank_loads.mean(), 1e-9))
