"""Multi-rank dry run of the full serving step over every mesh factorisation
(port of ``__graft_entry__.py``'s ``_factor_mesh``, ``_dryrun_one`` and
``dryrun_multichip``: the same factorisations, engine settings, variants,
assertions and printed lines; ``ci_gate`` stage ``dryrun-multichip-N``).

The reference runs its SPMD program over n simulated XLA devices on the
host. The port's counterpart is a world of n CPU rank processes
(``parallel/launch.World``, gloo), as its mesh tests run them: each mesh is
built on that one world and each engine runs its serving steps across the
ranks. NCCL across cards is ``chip_smoke.py``'s ``mesh`` phase.

Run: python -m llmd_tpu_torch.tools.dryrun [N]  (default 8; exit 0 = every
mesh served)
"""

from __future__ import annotations

import os
import sys
from dataclasses import replace

from llmd_tpu_torch.parallel.mesh import MeshConfig

ORDERS = (("dp", "ep", "tp", "sp"), ("dp", "ep", "sp", "tp"))


def factor_mesh(n: int, order: tuple = ("dp", "ep", "tp", "sp")) -> MeshConfig:
    """Split n devices into (dp, sp, ep, tp) by cycling powers of two over
    ``order`` — dp (rank) first so the wide-EP rank topology always exists,
    tp on the innermost (fastest-link) axis."""
    dims = {"dp": 1, "sp": 1, "ep": 1, "tp": 1}
    rem, i = n, 0
    while rem > 1:
        # largest power-of-two split first; odd n goes entirely to dp
        f = 2 if rem % 2 == 0 else rem
        dims[order[i % len(order)]] *= f
        rem //= f
        i += 1
    return MeshConfig(dp=dims["dp"], ep=dims["ep"], tp=dims["tp"], sp=dims["sp"])


def dryrun_one(mesh_cfg: MeshConfig, n_devices: int, world=None, quantize=None,
               kv_dtype=None, model: str = "tiny-moe") -> dict:
    """One engine on ``mesh_cfg`` over ``world`` (None when the mesh is one
    device): the sp ring-prefill solo request, then one request per DP rank.
    Returns each rank's greedy tokens."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.parallel.eplb import EPLBConfig

    # full wide-EP path: MoE + DBO micro-batching + EPLB redundant-expert
    # placement + dp_ranks rank schedulers sharing the one program (each
    # rank a router-visible endpoint; MoE all-to-all spans dp × ep).
    model_cfg = replace(get_model_config(model), moe_dbo=True)
    R = max(1, mesh_cfg.dp)
    eng_cfg = EngineConfig(
        page_size=8,
        num_pages=64 * R,
        max_model_len=128,
        max_batch_size=max(4, R * 2),
        prefill_chunk=16 * max(1, mesh_cfg.sp),
        decode_steps=2,
        mesh=mesh_cfg,
        dp_ranks=R,
        eplb=EPLBConfig(window_size=16, step_interval=4,
                        num_redundant_experts=max(4, mesh_cfg.ep)),
        quantize_weights=quantize,
        kv_cache_dtype=kv_dtype,
    )
    eng = LLMEngine(model_cfg, eng_cfg, device="cpu",
                    rank_mesh=world.mesh(mesh_cfg) if world is not None else None)
    try:
        if mesh_cfg.sp > 1:
            # a solo self-contained prefill first: the regime the
            # ring-attention program serves (the engine gates per step)
            eng.add_request("sp-solo", list(range(11, 11 + 24)),
                            SamplingParams(max_tokens=2, temperature=0.0))
            while eng.has_work():
                eng.step()
            assert eng.stats.n_ring_prefill_steps >= 1, (
                "sp>1 dryrun must exercise the ring-attention prefill program")
        # one request per DP rank: every rank queue feeds the shared wave step
        prompts = {r: list(range(3 + 7 * r, 30 + 7 * r)) for r in range(R)}
        for r, p in prompts.items():
            eng.add_request(f"rank{r}", p, SamplingParams(max_tokens=4, temperature=0.0),
                            rank=r)
        done: dict[str, list[int]] = {f"rank{r}": [] for r in range(R)}
        while eng.has_work():
            for out in eng.step():
                done[out.request_id].extend(out.new_token_ids)
        assert all(len(v) == 4 for v in done.values()), done
        attn_prov = f"attn={eng.attn_backend}"
        if model_cfg.is_moe:
            # wide-EP dispatch provenance: auto must resolve to the
            # token-sorted drop-free path on every mesh the dry run builds
            assert eng.moe_dispatch == "sorted", (
                eng.moe_dispatch, eng.moe_dispatch_fallback_reason)
            attn_prov += f", moe_dispatch={eng.moe_dispatch}"
        if eng.sp_attn_backend is not None:
            attn_prov += (f", sp_attn={eng.sp_attn_backend} "
                          f"[{eng.stats.n_ring_prefill_steps} ring prefill steps]")
        if quantize:
            attn_prov += f", weights={quantize}, moe={eng.moe_backend}"
        if kv_dtype:
            attn_prov += f", kv={eng.stats.kv_cache_dtype}"
    finally:
        eng.close()
    print(
        f"dryrun OK: mesh(dp={mesh_cfg.dp}, sp={mesh_cfg.sp}, "
        f"ep={mesh_cfg.ep}, tp={mesh_cfg.tp}) over {n_devices} devices, "
        f"model={model_cfg.name}, {R} rank engines sharing the EP all-to-all; "
        f"{attn_prov}; outputs: {done}", flush=True)
    return done


def dryrun_multichip(n_devices: int) -> list[dict]:
    """Run the FULL serving step (chunked prefill + fused multi-step decode)
    over an n-rank mesh with real dp/sp/ep/tp shardings — dp as wide-EP rank
    engines — on tiny shapes, for every distinct mesh factorisation of n over
    the two priority orders, plus the three variants (int8 weights; int8
    weights and an fp8 pool; tiny-mla-moe), one per distinct mesh, leftovers
    on the last. Returns one row per engine run."""
    import torch

    from llmd_tpu_torch.parallel.launch import World

    # one thread a rank: n ranks each on every core of the host ran 3x slower
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"  # the workers' (read at their start)
    world = None
    rows: list[dict] = []
    try:
        world = World.start(n_devices, "cpu") if n_devices > 1 else None
        seen = set()
        variants = [{"quantize": "int8"}, {"quantize": "int8", "kv_dtype": "fp8"},
                    # the wide-EP north-star stack: MLA latent KV + MoE expert
                    # banks sharing one program
                    {"model": "tiny-mla-moe"}]
        mesh_cfg = None

        def one(cfg: MeshConfig, **kw) -> None:
            done = dryrun_one(cfg, n_devices, world, **kw)
            rows.append({"mesh": (cfg.dp, cfg.sp, cfg.ep, cfg.tp), **kw, "outputs": done})

        for order in ORDERS:
            mesh_cfg = factor_mesh(n_devices, order)
            assert mesh_cfg.num_devices == n_devices, (mesh_cfg, n_devices)
            key = (mesh_cfg.dp, mesh_cfg.sp, mesh_cfg.ep, mesh_cfg.tp)
            if key in seen:
                continue
            seen.add(key)
            one(mesh_cfg)
            if variants:
                one(mesh_cfg, **variants.pop(0))
        while variants:  # n with a single distinct factorisation
            one(mesh_cfg, **variants.pop(0))
    finally:
        if world is not None:
            world.close()
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    dryrun_multichip(n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
