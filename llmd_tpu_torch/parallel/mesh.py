"""The (dp, sp, ep, tp) rank mesh over ``torch.distributed`` (port of
``llmd_tpu/parallel/mesh.py``).

The reference builds one ``jax.sharding.Mesh`` over every device of one
process and lets GSPMD insert the collectives. PyTorch runs one process per
device, so the port's mesh is a :class:`RankMesh`: this process's rank, its
coordinates on the four axes, and one process group per axis (and per joint
group the forward needs). Ranks are laid out as the reference reshapes its
devices (``build_mesh``): ``(dp, sp, ep, tp)`` row-major, tp innermost, so
rank ``((d * sp + s) * ep + e) * tp + t`` sits at (d, s, e, t).

- ``tp``: attention heads, KV heads, the dense MLP and the vocabulary
  (Megatron column / row parallel, ``reduce("tp")`` after the row-parallel
  products, the logits gathered).
- ``ep``: MoE expert slots; the token exchange is ``ops/moe_dispatch``'s.
- ``sp``: a step's flat rows (with dp), and the ring prefill of
  ``ops/ring_attention``.
- ``dp``: a step's rows (``parallel/rows``: the flat programs' rows over the
  joint (dp, sp) index, the decode programs' slots over dp; each rank runs
  its own rows through every dense layer and attention), and the
  data-parallel rank frontends (``engine/dp_group``), whose slot ranges are
  the decode programs' dp blocks. Rows stay replicated over ep and tp.

:data:`DEFAULT_RULES` and :func:`param_logical_axes` are the reference's
logical axes (:func:`lora_param_logical_axes` the adapter bank's, and
:func:`lora_bank_axes` the same in the port's bank layout);
:func:`shard_params` keeps this rank's block of every leaf (the
reference's ``shard_pytree``). Fused gate+up leaves (``wi``, ``shared_wi``,
``moe_wi`` and their int8 leaves) shard their gate half and their up half
apart, so each rank keeps matching gate and up columns.

The collectives (``reduce``, ``gather``, ``all_to_all``, ``ring_shift``) are
identities on an axis of size 1, and on an empty tensor (every rank of the
group holds the same rows, so all of it skips alike); they run NCCL on CUDA
tensors, gloo on CPU tensors: the backend is the default process group's.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("dp", "sp", "ep", "tp")


@dataclass(frozen=True)
class MeshConfig:
    """Mesh axis sizes (copy of ``llmd_tpu/parallel/mesh.py::MeshConfig``)."""

    dp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.ep * self.tp * self.sp

    def axis_names(self) -> tuple[str, ...]:
        return AXES


def rank_coords(cfg: MeshConfig, rank: int) -> dict[str, int]:
    """Rank ``rank``'s index on each axis (tp innermost)."""
    out: dict[str, int] = {}
    for axis in reversed(AXES):
        n = getattr(cfg, axis)
        out[axis] = rank % n
        rank //= n
    return {a: out[a] for a in AXES}


def rank_of(cfg: MeshConfig, coords: dict[str, int]) -> int:
    r = 0
    for axis in AXES:
        r = r * getattr(cfg, axis) + coords[axis]
    return r


def axis_ranks(cfg: MeshConfig, rank: int, axes: Sequence[str]) -> list[int]:
    """The ranks that share every coordinate of ``rank`` off ``axes``, in
    rank order (row-major over ``axes``)."""
    c = rank_coords(cfg, rank)
    out = []
    for idx in itertools.product(*(range(getattr(cfg, a)) for a in axes)):
        out.append(rank_of(cfg, {**c, **dict(zip(axes, idx))}))
    return sorted(out)


# the groups a forward uses: one per axis, and dp x sp (the flat programs'
# row split, gathered back over the ranks of one ep and tp index)
GROUPS: tuple[tuple[str, ...], ...] = (("tp",), ("ep",), ("sp",), ("dp",), ("dp", "sp"))


class RankMesh:
    """This rank's place on the mesh and its process groups. ``world`` is
    the ``parallel/launch.World`` on rank 0 (it sends the command stream),
    None on the workers."""

    def __init__(self, cfg: MeshConfig, rank: int, device: torch.device,
                 groups: dict[tuple[str, ...], Any], world=None) -> None:
        self.cfg = cfg
        self.rank = rank
        self.device = device
        self.coords = rank_coords(cfg, rank)
        self._groups = groups
        self.world = world

    @classmethod
    def build(cls, cfg: MeshConfig, device: torch.device, world=None) -> "RankMesh":
        """Every rank of the default process group calls this with the same
        ``cfg``, in the same order (``new_group`` is collective). The group
        must hold exactly ``cfg.num_devices`` ranks."""
        n = cfg.num_devices
        have = dist.get_world_size() if dist.is_initialized() else 1
        if have < n:
            raise ValueError(f"need {n} devices for {cfg}, have {have}")
        if have != n:
            raise ValueError(f"a world of {have} ranks does not hold {cfg} ({n} ranks)")
        rank = dist.get_rank()
        groups: dict[tuple[str, ...], Any] = {}
        for axes in GROUPS:
            size = 1
            for a in axes:
                size *= getattr(cfg, a)
            if size == 1:
                continue
            seen = set()
            for r in range(n):  # every rank creates every group, in one order
                ranks = tuple(axis_ranks(cfg, r, axes))
                if ranks in seen:
                    continue
                seen.add(ranks)
                g = dist.new_group(list(ranks))
                if rank in ranks:
                    groups[axes] = g
        return cls(cfg, rank, device, groups, world)

    # ------------------------------------------------------------ layout
    def size(self, axes: "str | Sequence[str]") -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        out = 1
        for a in axes:
            out *= getattr(self.cfg, a)
        return out

    def index(self, axes: "str | Sequence[str]") -> int:
        """This rank's row-major index over ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * getattr(self.cfg, a) + self.coords[a]
        return i

    def group(self, axes: "str | Sequence[str]"):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._groups[axes]

    def ranks(self, axes: "str | Sequence[str]") -> list[int]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return axis_ranks(self.cfg, self.rank, axes)

    # ------------------------------------------------------- collectives
    def reduce(self, x: torch.Tensor, axes: "str | Sequence[str]") -> torch.Tensor:
        """Sum over ``axes`` (an all-reduce, in place on ``x``, which must be
        a tensor of the caller's own)."""
        if self.size(axes) == 1 or x.numel() == 0:
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=self.group(axes))
        return x

    def gather(self, x: torch.Tensor, axes: "str | Sequence[str]", dim: int = 0) -> torch.Tensor:
        """All-gather ``x`` over ``axes``, concatenated along ``dim`` in rank
        order."""
        n = self.size(axes)
        if n == 1:
            return x
        dim = dim % x.dim()
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
        if x.numel():
            _all_gather_single(out, xt, self.group(axes))
        return out.movedim(0, dim)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` into every rank's ``x``, in place (``x`` must be
        contiguous)."""
        if self.cfg.num_devices > 1:
            dist.broadcast(x, src=0)
        return x

    def scatter(self, out: torch.Tensor, parts: Optional[list[torch.Tensor]]) -> torch.Tensor:
        """Rank 0's ``parts[r]`` into rank r's ``out``, in place; ``parts``
        is None on every other rank."""
        if self.cfg.num_devices == 1:
            return out.copy_(parts[0])
        dist.scatter(out, parts, src=0)
        return out

    def all_to_all(self, x: torch.Tensor, axes: "str | Sequence[str]") -> torch.Tensor:
        """Equal-split all-to-all over ``axes``: block i of ``x`` (along dim
        0) goes to the group's i-th rank; block j of the result came from
        its j-th rank."""
        if self.size(axes) == 1 or x.numel() == 0:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group(axes))
        return out

    def ring_shift(self, tensors: Sequence[torch.Tensor], axis: str) -> list[torch.Tensor]:
        """Send each tensor to the next rank of the ring over ``axis`` and
        receive the previous rank's (one ``batch_isend_irecv``)."""
        n = self.size(axis)
        if n == 1:
            return list(tensors)
        ring = self.ranks(axis)
        i = ring.index(self.rank)
        nxt, prv = ring[(i + 1) % n], ring[(i - 1) % n]
        g = self.group(axis)
        outs, ops = [], []
        for t in tensors:
            t = t.contiguous()
            o = torch.empty_like(t)
            ops += [dist.P2POp(dist.isend, t, nxt, g), dist.P2POp(dist.irecv, o, prv, g)]
            outs.append(o)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs


def _all_gather_single(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


# ---------------------------------------------------------------- sharding
@dataclass(frozen=True)
class ShardingRules:
    """Logical axis name -> mesh axis (None: replicated)."""

    rules: tuple[tuple[str, Optional[str]], ...] = ()

    def spec(self, logical_axes: Sequence[Optional[str]]) -> tuple[Optional[str], ...]:
        m = dict(self.rules)
        return tuple(m.get(a) if a is not None else None for a in logical_axes)

    def replace(self, **over: Optional[str]) -> "ShardingRules":
        m = dict(self.rules)
        m.update(over)
        return ShardingRules(tuple(m.items()))


DEFAULT_RULES = ShardingRules(rules=(
    ("batch", "dp"),
    ("sequence", "sp"),
    ("vocab", "tp"),
    ("embed", None),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("mlp", "tp"),
    ("experts", "ep"),
    ("expert_mlp", "tp"),
    ("kv_pages", None),
    ("layers", None),
    ("lora_slots", None),
))

# leaves whose last axis is [gate | up]
FUSED_GATE_UP = ("wi", "shared_wi", "moe_wi")

# leaves every rank keeps whole whatever their axes: routing runs on every
# rank over every expert, so every rank makes the same choices
WHOLE = ("router",)

# the reference's quantizer contracts these logical axes (a scale keeps the rest)
_CONTRACT = {
    "wq": ("embed",), "wk": ("embed",), "wv": ("embed",), "wo": ("heads", "head_dim"),
    "wi": ("embed",), "wo_mlp": ("mlp",), "moe_wi": ("embed",), "moe_wo": ("expert_mlp",),
    "shared_wi": ("embed",), "shared_wo": ("mlp",),
}


def param_logical_axes(cfg) -> dict[str, tuple[Optional[str], ...]]:
    """Logical axis names per parameter leaf (copy of the reference's
    ``models/transformer.py::param_logical_axes``), plus the int8 leaves'
    (``<key>_q`` as ``<key>``; ``<key>_scale`` without the contracted axes;
    ``unembed_q`` / ``unembed_scale``), as the reference's quantizer returns
    them."""
    axes: dict[str, tuple[Optional[str], ...]] = {
        "embed": ("vocab", "embed"),
        "final_norm": ("embed",),
        "attn_norm": ("layers", "embed"),
        "mlp_norm": ("layers", "embed"),
    }
    if cfg.is_mla:
        axes |= {
            "mla_wq": ("layers", "embed", "heads", "head_dim"),
            "mla_wdkv": ("layers", "embed", None),
            "mla_wkr": ("layers", "embed", None),
            "mla_kv_norm": ("layers", None),
            "mla_wuk": ("layers", "heads", "head_dim", None),
            "mla_wuv": ("layers", "heads", None, "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
        }
    else:
        axes |= {
            "wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
        }
    if cfg.qk_norm:
        axes |= {"q_norm": ("layers", "head_dim"), "k_norm": ("layers", "head_dim")}
    if cfg.attn_bias:
        axes |= {
            "bq": ("layers", "heads", "head_dim"),
            "bk": ("layers", "kv_heads", "head_dim"),
            "bv": ("layers", "kv_heads", "head_dim"),
            "bo": ("layers", "embed"),
        }
    if cfg.is_moe:
        axes |= {
            "router": ("layers", "embed", "experts"),
            "moe_wi": ("layers", "experts", "embed", "expert_mlp"),
            "moe_wo": ("layers", "experts", "expert_mlp", "embed"),
        }
        if cfg.moe_num_shared_experts:
            axes |= {"shared_wi": ("layers", "embed", "mlp"),
                     "shared_wo": ("layers", "mlp", "embed")}
    else:
        axes |= {"wi": ("layers", "embed", "mlp"), "wo_mlp": ("layers", "mlp", "embed")}
    if not cfg.tie_embeddings:
        axes["unembed"] = ("embed", "vocab")
    for key, contract in _CONTRACT.items():
        if key in axes:
            axes[key + "_q"] = axes[key]
            axes[key + "_scale"] = tuple(a for a in axes[key] if a not in contract)
    axes["unembed_q"] = ("embed", "vocab")
    axes["unembed_scale"] = ("vocab",)
    return axes


LORA_TARGETS = ("wq", "wk", "wv", "wo")


def lora_param_logical_axes(cfg) -> dict[str, tuple[Optional[str], ...]]:
    """Logical axes of the adapter bank in the reference's layout (copy of
    ``llmd_tpu/models/lora.py::lora_param_logical_axes``): A ``[L, S, Din,
    r]``, B ``[L, S, r, Dout]``; slots replicated, B's output following the
    base weight's tp sharding."""
    axes: dict[str, tuple[Optional[str], ...]] = {}
    for t in LORA_TARGETS:
        axes[f"lora_A_{t}"] = ("layers", "lora_slots", "embed", None)
        axes[f"lora_B_{t}"] = ("layers", "lora_slots", None, "embed" if t == "wo" else "heads")
    return axes


def lora_bank_axes() -> dict[str, tuple[Optional[str], ...]]:
    """The bank's axes in the port's layout (``models/lora.py``: A ``[L, Din,
    S, r]``): the reference's, A's transposed, except A of ``wo``, whose
    input (the concatenated head output, tp-sharded in the port) is
    ``heads``: each rank keeps its heads' rows of A and adds ``(x_rank @
    A_rows) @ B`` to wo's partial sum before wo's all-reduce, the same
    function by linearity (the reference keeps A whole and GSPMD gathers
    the heads instead)."""
    axes = {}
    for name, (l, s, i, o) in lora_param_logical_axes(None).items():
        if name.startswith("lora_A_"):
            axes[name] = (l, "heads" if name == "lora_A_wo" else i, s, o)
        else:
            axes[name] = (l, s, i, o)
    return axes


def lora_adapter_block(name: str, w: torch.Tensor, mesh: "RankMesh",
                       rules: ShardingRules = DEFAULT_RULES) -> torch.Tensor:
    """This rank's block of one adapter's leaf ``name`` (``lora_A_<t> [L,
    Din, r]`` or ``lora_B_<t> [L, r, Dout]``, the bank's axes without the
    slot dim)."""
    axes = list(lora_bank_axes()[name])
    del axes[2 if name.startswith("lora_A_") else 1]
    return shard_block(name, w, rules.spec(axes), mesh)


def engine_rules(model_cfg, ep: int, eplb: bool) -> ShardingRules:
    """The sharding rules of an engine's params: the reference's, with the
    expert banks EP-pure (replicated over tp, as its sorted dispatch gathers
    them), and the logical banks whole on every ep rank under EPLB (each rank
    regathers its own physical slots from them) or when the experts do not
    divide ep (the einsum fallback)."""
    whole = eplb or (model_cfg.is_moe and model_cfg.moe_num_experts % ep != 0)
    return DEFAULT_RULES.replace(expert_mlp=None, experts=None if whole else "ep")


def shard_block(name: str, x: torch.Tensor, spec: Sequence[Optional[str]],
                mesh: RankMesh) -> torch.Tensor:
    """This rank's block of leaf ``name`` under ``spec`` (one mesh axis or
    None per dim). Raises when a sharded dim does not divide."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.size(axis) == 1:
            continue
        n, i = mesh.size(axis), mesh.index(axis)
        size = x.shape[dim]
        base = name.removesuffix("_q").removesuffix("_scale")
        fused = base in FUSED_GATE_UP and dim == x.dim() - 1
        halves = x.chunk(2, dim=dim) if fused else (x,)
        parts = []
        for h in halves:
            if h.shape[dim] % n:
                raise ValueError(f"param {name}: dim {dim} of size {size} does not divide "
                                 f"the {axis} axis ({n})")
            b = h.shape[dim] // n
            parts.append(h.narrow(dim, i * b, b))
        x = torch.cat(parts, dim=dim) if fused else parts[0]
    return x.contiguous()


def shard_params(params: dict[str, torch.Tensor], mesh: RankMesh,
                 axes: dict[str, Sequence[Optional[str]]],
                 rules: ShardingRules = DEFAULT_RULES) -> dict[str, torch.Tensor]:
    """This rank's block of every leaf (the reference's ``shard_pytree``);
    leaves without logical axes, and :data:`WHOLE`, stay whole."""
    return {name: shard_block(name, x, rules.spec(axes[name]), mesh)
            if name in axes and name not in WHOLE else x
            for name, x in params.items()}
