#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llmd_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--report PATH]

Phases, in order; each prints lines of numbers and any failure ends the run
with a non-zero exit (as does a run still going at ``DEADLINE_S``, with every
thread's stack on stderr):

1. device   the card's name and power limit (nvidia-smi); TF32 off.
2. build    nvcc builds every kernel source of the main paths from
            ``llmd_tpu_torch/csrc``, one nvcc per source, all started together
            (seconds and the ptxas register / shared-memory report);
            ``cuobjdump -sass`` must show every bf16 grouped-GEMM kernel
            (wgmma instance) and every bf16 K1 and K3 kernel (mma instances)
            on the tensor cores (HGMMA; HMMA for K1 and K3) fed by
            asynchronous copies (UTMALDG, TMA; LDGSTS, cp.async; UBLKCP), and
            ptxas must report no spill in K1's and K3's mma instances.
3. check    each kernel against its plain PyTorch version on the card, in
            float32 and bfloat16 (the bf16 kernel against the plain version in
            float32 on the same inputs, in bf16 rounding units, with controls
            that keep a bf16 accumulator and must read above the limit):
            K1 at llama-1b and moe-wide-sim heads (bf16 on the mma instance,
            f32 on the simt one; decode, mixed, a long context at small batch
            whose many KV splits include empty ones, a 512-token chunk at kv
            2048, a chunk of one query tile plus one token, kv lengths at
            exact split and page multiples); K2 (ragged grouped GEMM) and
            K4 (grouped GEMM) at moe-wide-sim widths, at decode, prefill and
            EPLB shapes, with dead rows, zero-row blocks and zero-count groups;
            K1 on moe-wide-mla's single-plane latent pool (bf16 on the mma
            instance) at the mixed shape, at decode, with a 512-token chunk,
            a chunk of one tile plus one token and split-multiple kv; K3 (MLA
            latent decode; bf16 on its mma instance) at its decode shape with
            idle rows, at B=4 over long contexts, at split-multiple kv and at
            B=1 over kv 1 and 17. K1 also at the speculative verify batch
            (64 sequences x 5 query tokens).
4. time     each kernel at the main path's shapes (CUDA events, median, the
            card held by a spin kernel while the host enqueues the calls),
            beside its bound, its plain version and one PyTorch library call;
            K1 at decode B=64, decode B=8 at kv 3072-5120, the mixed shape and
            the verify batch (64 x 5 tokens), and K1 on the latent pool at the
            mixed shape, each beside its simt instance on the same inputs; K3 at decode B=64+2 and at decode B=8
            over kv 3072-5120 beside its simt instance, with the split kernel
            and its merge timed apart; K2 and K4 for both launches of a layer
            (wi, wo) at decode and prefill.
5. engine   behind the port's HTTP server, random bf16 weights from a seed,
            greedy completions through the engine's defaults (the decode
            program captured into a CUDA graph and replayed, the reference's
            pipelined dispatch): llama-1b at full width (8 requests), then
            moe-wide-sim at full width and depth on the sorted dispatch (8
            requests), the einsum dispatch (4) and the sorted dispatch with EPLB
            (4), then moe-wide-mla at full width and depth on the sorted
            dispatch (8 requests). Each run zeroes every launch counter just
            before and reads it just after: each kernel of the path ran its
            count per layer of the forwards of its program (K1 once per layer
            of every forward, or of the unified ones only on MLA, where the
            decode program runs K3; K2 / K4 twice per layer of every forward,
            every launch on the bf16 wgmma instance; K1 and K3 on their mma
            instances), no plain version ran,
            the sorted path dropped nothing, EPLB re-placed its experts at
            least twice. A replayed graph counts its captured launches once
            per replay, so these checks hold unchanged.
6. graph    for each of those five runs, two engines of the same seed
            through ``generate``: the decode program replayed from its graph
            and the same program run eagerly (``decode_graph=False``). Greedy
            tokens, every kernel's launch count, the dropped copies and the
            EPLB rebalances must be equal, no plain version may run, and the
            graph engine captures once and replays once a call. Then
            ``tools/profile_engine.profile_batch`` profiles batch 8 in both
            modes; in each profiled window the K1/K3/K2/K4 launches that the
            wrappers' counters credit (a replay credits its capture's) must
            equal the launches of those kernels that the profiler saw on the
            device. Prints captures, replays, capture seconds, decode tok/s
            replayed and eager, host launch calls and device kernels per
            decode iteration and the device's busy share; replayed on
            llama-1b, the host makes 3 launch calls a decode call (one graph
            launch, two RNG-state fills), 0.75 an iteration at
            ``decode_steps`` 4, with the metric families on.
7. surface  the serving surface that llm-d's router drives
            (``phase_surface``): llama-1b at full width behind the port's
            server with the KV-event publisher; 12 concurrent requests
            (completions over a shared 512-token prefix, half streamed,
            chat, repeats), ``/metrics`` read through the port's metrics
            contract and held to ``EngineStats``, every streamed text held
            to its non-streamed twin, every prompt's full blocks in the KV
            events under the router's block keys with no ``seq`` gap,
            ``/drain`` / ``/health`` / admission codes, K1 all on ``mma``.
8. spec     speculative decoding (``phase_spec``): llama-1b at full width
            with and without ``spec_mode="ngram"`` (8 greedy requests of 64
            tokens on the bench's echo prompts): identical tokens in float32;
            in bf16 the identical share, the top-2 logit margin at the first
            divergence, drafted / accepted / rejected, accepted per verify
            step, K1's launches in the verify program and output tok/s in two
            turns; then moe-wide-mla at 2 layers in float32, identical too.
            Every window: each kernel once per layer of its programs'
            forwards, verify included, on its instance, no plain version.
9. structured  structured outputs (``phase_structured``): llama-1b behind
            the server with choice, regex, bounded-schema and logit_bias
            requests (half streamed, one chat): 100% conformance, 0
            violations, 400 for a malformed schema and regex; the masked
            decode program replayed = eager; host launch calls per iteration
            replayed: masked < 10, unmasked 3 / ``decode_steps``; one
            json-echo run with speculation (the constrained verify share).
10. forward one mixed unified batch through ``forward_core`` in float32, with
            the kernels and again with the plain versions passed as overrides:
            llama-1b, moe-wide-sim on both dispatch paths, and moe-wide-mla
            with a decode batch after it (K3) (logits held together, expert
            counts equal; K1, K3, K2 / K4 on their float32 simt instances).
11. int8    int8 weight-only weights (``quantize_weights="int8"``) at registry
            width through the captured, pipelined engine, replayed and eager:
            llama-1b (8 requests), moe-wide-sim sorted (8) and einsum (4),
            moe-wide-mla sorted (8). Tokens and launch counts replayed =
            eager; K1 (and K3 on MLA) once per layer of its program's
            forwards, all on mma; no K2 / K4 launch (int8 banks run plain
            products, as the reference gives them to XLA); no plain version.
            Then one float32 forward per model of the int8 weights against
            the dequantized weights ``q * s`` as plain float32 weights
            (max abs <= FORWARD_ATOL, argmax 100%).
12. loader  llama-1b's random bf16 params at full width written as an HF
            checkpoint (``testing/checkpoints``) under the gitignored
            ``checkpoints/``, loaded by ``models/hf_loader``: every leaf
            bit-equal, greedy tokens equal to the in-memory params'; the
            checkpoint is deleted after.
13. bench   ``llmd_tpu_torch.tools.bench`` at its default (llama-1b, int8, 64
            requests of ISL 256 / OSL 128, batch 64, ``decode_steps`` 32),
            then with ``--quantize none``, then bf16 with ``--spec-mode ngram
            --workload echo`` and with ``--workload json``; each JSON line
            printed on a ``bench:`` line. No capture in the measured window
            (``recompiles`` 0), K1 once per layer of every forward of the
            window (verify steps included), all on mma; no violation.
14. fp8     the float8_e4m3 pool (``kv_cache_dtype="fp8"``, ``phase_fp8``):
            K1 at llama-1b's decode, mixed, verify and long-context shapes,
            K1's latent mode at the mixed shape and a 512-token chunk, K3 at
            decode B=64 + 2 idle and B=1 over kv 1 and 17, each checked three
            ways: the bf16 q over the fp8 pool on ``mma_fp8`` bit-equal to
            the ``mma`` instance on the pool upcast to bf16; <= 1 bf16
            rounding unit against the plain version in float32, controls above
            1; a float32 q on ``simt_fp8`` within F32_ATOL. Each variant timed
            at the time phase's shapes beside its bf16 twin, in turns, its
            bound counting 1 byte a K/V element, SDPA over the K/V upcast in
            set-up as the library call. llama-1b and moe-wide-mla served over
            an fp8 pool (the engine phase's checks, every K1 / K3 launch on
            ``mma_fp8``) and replayed = eager; llama-1b in float32 on the
            kernels (``simt_fp8``) = the plain versions, token for token, and
            in bf16 the share of tokens the fp8 and bf16 pools give alike (not
            bounded); the bench with ``--quantize none --kv-dtype fp8``.

15. kvplane the KV data plane (``phase_kvplane``): two port servers in this
            process, P and D, the sidecar's two requests driven here over
            loopback (P: ``do_remote_decode``, ``max_tokens`` 1; D:
            ``do_remote_prefill`` with P's handle). llama-1b in float32, 8
            prompts of 256-1024 tokens x 32 greedy tokens, half the exports
            on the native transport and half on the python one: D's injected
            page bytes equal P's exports, ``cached_tokens`` = (len - 1) // 16
            x 16, tokens equal an aggregated engine's, every K1 launch on D
            on ``simt`` (one per layer of each forward), D's decode replayed
            from its graph, no plain version; the same in bf16 and over an
            fp8 pool (``mma`` / ``mma_fp8``; the identical token share
            reported, not bounded) and on moe-wide-mla at 2 layers in float32
            (K1's latent mode on P, K3 on D over the injected latent pages).
            Then the offload tiers: llama-1b float32 over a pool that holds
            one prompt set, a second set evicting the first to the CPU tier
            and on to FS, the first set again reloading (not recomputing)
            with the same tokens, K1 over the reloaded pages. Informational,
            beside the card: the staged export's D2H and the inject's H2D per
            512 KiB block against a pinned ``copy_``, a 64-block (32 MiB) pull
            on each transport against a host memcpy, demote and reload ms per
            block, TTFT aggregated against disaggregated.

16. lora    multi-adapter LoRA and the embed program (``phase_lora``):
            llama-1b at full width under ``LoRAConfig(max_adapters=8, rank=8)``,
            the serving settings, three adapters drawn from a seeded
            generator, 8 greedy requests (2 base, 2 per adapter, prompts of
            64-512 tokens, 32 tokens out). float32: kernels = plain versions
            in every row (K1 once per layer of every forward, on ``simt``),
            the base rows = an engine without LoRA, each adapter's rows = a
            batch of that adapter alone, and each adapter changes a token
            against the base model; bf16: the decode program replayed = eager
            with a fourth adapter loaded after the capture (K1 on ``mma``);
            speculation on = off in float32 on echo prompts under adapters;
            moe-wide-sim at 4 layers in float32 under adapters, kernels =
            plain (K2 twice per layer of every forward); behind the server in
            float32: the load / unload routes and codes, ``/v1/models``, the
            ``vllm:lora_requests_info`` line, the 404s, ``/v1/embeddings``
            within 1e-5 of the plain version with K1 once per layer per chunk
            and the adapter's vector apart from the base one. Informational:
            bf16 decode tok/s at batch 64, ISL 256 / OSL 128, with 4 adapters
            against none, ``profile_batch`` at batch 8 with and without LoRA,
            ``/v1/embeddings`` latency of one 512-token input (``lora:``
            lines).

17. vision  multimodal serving (``phase_vision``) at VL_FULL: llama-1b with
            the tower at CLIP ViT-L/14-336's published widths (hidden 1024,
            24 layers, 16 heads, MLP 4096, patch 14 at 336 px: 576 patches)
            and 576 media tokens an image (LLaVA-1.5's), built here with
            ``dataclasses.replace`` (not a registry entry). The f32 tower on
            the card against the CPU (4 images, TF32 off): max abs relative to
            the output's <= TOWER_REL, bf16 against f32 reported. Combined PD
            (the server's in-process tower), bf16 then f32: 8 chats of 1-2
            images beside 16-64 text bytes, 32 greedy tokens, half streamed:
            K1 once per layer of every forward (``mma`` / ``simt``), no plain
            version, the decode graph replayed, ``/render`` = the stream the
            engine admitted, its blocks keyed as the router keys them, a
            repeat cached, a new image behind the same text not; f32 tokens
            = an engine given the same rows through ``add_request``; of the
            four pairs of chats that differ only in their images, at least
            one gives other greedy tokens (each pair's are reported: at random
            init the greedy token may hold) and every pair moves the first
            token's f32 logits by more than IMAGE_LOGIT_MOVE. E/PD (a port encode worker on
            loopback, a towerless server, the sidecar's E step driven here):
            tokens = combined PD in f32. E/P/D in f32 (worker, P with
            ``do_remote_decode``, D with ``do_remote_prefill``): D injects
            blocks and reports cached tokens, its tokens = combined PD's, K1 on
            D over the pulled pages. Informational (``vision:`` lines): encode
            ms per image at batch 1 and 8 beside the tower's bound, TTFT p50
            of a one-image chat combined against E/PD, device kernels per
            unified step with and without media rows.

18. obs     the observability plane (``phase_obs``): llama-1b at full width
            and depth behind the port's server (page 16, 2048 pages, batch
            32, ``decode_steps`` 4, replayed and pipelined), the device
            plane's knobs OBS_ENV (a 1 s watchdog). 8 concurrent greedy
            completions of 64-512 tokens (32 out), a ``traceparent`` on half:
            every ``/debug/requests/{rid}`` timeline holds arrival ->
            admitted -> prefill_start -> prefill_end -> (chain_dispatch,
            decode)+ -> retired in order, the traced ones under the sent
            trace id; ``?status=finished`` lists all 8;
            ``request_phase_seconds`` counts 8 for prefill, decode_overlap and
            the residual and at most 8 for any phase; then one more
            completion with a ``traceparent``, served alone: ``step_duration``
            buckets carry exemplars of the served requests' trace ids, its
            among them. Then 8 rows of 300 tokens (the probes fire every
            64 decode dispatches) with ``/debug/profile?seconds=1`` taken
            while they decode: a non-empty Chrome trace holding K1's
            ``paged_attention_mma`` kernel events and the ``llmd.*`` phase
            ranges, and a second concurrent capture answered 409.
            ``step_duration{phase="attn"}`` has samples and no probe turned
            itself off; K1 launched once per layer of every forward plus
            once per probe run, all on ``mma``, no plain version. The HBM
            gauges equal ``torch.cuda.memory_stats`` / ``total_memory``
            read in-process (in use >= the pool and the weights);
            ``device_fabric_alive`` is 1. The engine lock held past the
            watchdog while a request is pending: ``/health`` 503
            ``engine_stalled``, then 200 and ``engine_recovered``.
            ``/v1/responses`` = ``/v1/chat/completions`` on the same
            message (greedy), and a conversation of two turns lists four
            items. ``profile_batch`` (batch 8, replayed, the recorder on):
            3 / ``decode_steps`` host launch calls a decode iteration.
            moe-wide-sim and moe-wide-mla at full width and depth (sorted
            dispatch, 8 rows of 300 tokens): every probe phase has samples,
            the attn probe ran K1 (K3 on MLA) on ``mma`` and the experts
            probe K2 on ``wgmma``, each once more per probe run than the
            forwards account for. Informational (``obs:`` lines, with the
            card): µs per ``flight.record``, per decode call's recording
            and per request lifecycle, ``record_function`` against the
            gate, bf16 decode tok/s at batch 64, ISL 256 / OSL 128 with the
            ledgers on and off (``LLMD_FLIGHT_MAX_EVENTS=0``,
            ``LLMD_DECISION_LEDGER=0``), the capture's seconds and bytes,
            the probes' times per layer beside the time phase's K1 rows.
            The phase's and the whole run's seconds close it.

19. launch  the engine's launch surface (``phase_launch``). The tuner first:
            ``tools/bench.py --quantize none --tune-attn --attn-tune-file T``
            in this process times K1's candidate plans at the bench's decode
            shape (64 rows over a 64-page table: ``bkv`` giving 1, 2, 4, 8, 16
            splits and the policy's plan), merges the winner into T and runs
            its window from T (``bench:`` line with ``attn_tune_hash`` equal
            to T's; each candidate's ms, the winner beside the policy's plan).
            K1 under T's plan at that shape against the plain version in
            float32: <= 1 bf16 rounding unit, controls above it. llama-1b bf16
            at the bench's shape built from T against one without it: launch
            counts equal, tokens identical when the winner is the policy's
            plan, else the identical share reported. The modes in float32
            (``generate``, graphs captured): llama-1b ``attn_impl="reference"``
            = ``"auto"`` with 0 K1 launches; moe-wide-mla at 2 layers likewise
            with 0 K1 and 0 K3 launches; moe-wide-sim at 4 layers
            ``moe_matmul="einsum"`` = ``"pallas"`` with 0 K2 / K4 launches on
            the sorted and the einsum dispatch (pallas all on simt). DP ranks
            on one card: a ``WideEPEngineGroup`` of 2 rank frontends over one
            llama-1b engine, f32 and bf16, 8 requests over both ports: f32
            tokens = a ``dp_ranks=1`` engine's, each rank's pages in its
            partition, each rank's KV events (ZMQ) its own prompts' blocks
            only, decode tok/s of both; a ``DPEngineGroup`` of 2 rank
            processes (rank 0 here with the coordinator, rank 1 ``python
            tests/torch_dp_rank_worker.py``): both serve, coordinator waves =
            the two loops' steps. Meanwhile a replica started as a pool
            launches one (``python -m llmd_tpu_torch.engine.serve --model
            llama-1b --port P --compile-cache-dir D`` + speculation,
            structured, chain-depth, ``--attn-tune-file T`` and
            ``--predictor-train-url`` of a loopback sink) compiles K1 into D;
            it serves 8 completions, the sink receives 8 rows with every
            feature column, its ``/metrics`` backend gauge carries T's hash;
            a relaunch on D compiles nothing (both start times printed).
            Last, with every engine of the phase closed or dropped and no
            cycle collection, ``torch.cuda.memory_allocated()`` is back at
            the phase's baseline. The phase's seconds close it.
20. mesh    the (dp, sp, ep, tp) mesh (``phase_mesh``). Every kernel against
            its plain version at one rank's shapes, full width: K1 at
            llama-1b's tp=2 and tp=4 heads at decode B=64 and mixed, over bf16
            and fp8 pools; K1's latent mode and K3 at moe-wide-mla's tp=2
            heads; K2 on an ep=2 receiver's bucketed rows (16 local slots, the
            pad rows on the sentinel slot); K4 over 16 groups; each timed in
            bf16 beside its bound, one PyTorch library call on the same inputs
            (SDPA for K1, K1-latent and K3; ``bmm`` for K2 / K4) and the
            one-card shape's time. Then a
            one-rank NCCL group: ``all_reduce``, ``all_gather`` and
            ``all_to_all_single`` captured in a CUDA graph, replayed = eager.
            Then the tp=2 splits on this card: one layer through
            ``forward_core`` as two ranks with the sharded adapter bank =
            the one-card forward (``lora_shard_check``), and
            a bf16 and an fp8 pool's two plane halves under the engine's
            ``pages_out`` / ``pages_in`` ops = the one-card bytes
            (``pages_split_check``), and a step's rows split over dp=2
            (``row_split_check``: llama-1b at full depth, one mixed
            unified step of 1024 rows with a chunk straddling the split, a
            verify-shaped step of 64 x 5 rows and one decode iteration at
            B=64, as two dp ranks through ``forward_core`` and the row plan;
            the ranks' pools byte-equal, each rank's K1 over its own rows,
            float32 hidden rows within 1e-5 of one card's and greedy tokens
            equal, bf16's equal share; rank 0's bf16 forward over its 512
            rows beside one card's over 1024), each with its seconds.
            With two cards or more, meshed engines as NCCL worlds of rank
            processes (``parallel/launch``): llama-1b tp=2, moe-wide-sim ep=2
            with EPLB, moe-wide-mla tp=2, llama-1b sp=2 with one 2048-token
            prompt on the ring, llama-1b dp=2 and sp=2 with 8 prompts (each
            step's rows split over the ranks), and the planes world (llama-1b with media
            rows at tp=2: an adapter, a ``logit_bias``, a ``guided_choice``
            and a media request, a second adapter loaded after the decode
            graphs' capture and a request under it, an offload reload, a
            tp=2 P exporting to a one-card D, and the times of ``pages_out``
            / ``pages_in`` of 48 pages and of a full mask plan's staging);
            float32 tokens = one card's and replayed = eager, bf16's
            identical share and decode tok/s beside one card's.
            With one card it prints ``mesh_world: not run, 1 device``.
21. router  the router (``phase_router``): the port's ``RouterServer``
            (``llmd_tpu_torch/router``, the README's precise-prefix config)
            in front of two llama-1b port engines at full depth (page 16,
            1,024 pages each, KV events on loopback). float32: 6 prefix
            groups of 3 greedy requests (512-token group prefix, distinct
            32-token suffix, 16 tokens out; a group's first alone, the other
            two together): every reply 200, each group on its first's engine
            with ``cached_tokens`` >= 512, the routed tokens equal a direct
            request to the engine the router named, ``/metrics`` counts 18
            scheduled, the index holds the groups' blocks, K1 launched behind
            the router (per instance). bf16: the router's hop (p50 of 32
            serial one-token requests, routed minus direct) and streamed TTFT
            p50 routed and direct, printed. The phase prints its seconds.
22. latency the latency plane, the P/D routing sidecar and the precise KV
            plane (``phase_latency``), in front of two llama-1b port engines
            (KV events, a transfer side channel, latency rows posted to the
            port's ``TrainingServer``). float32: a router with the four
            latency plugins (the producer in sidecar mode against the port's
            ``PredictionServer``) and ``LLMD_SLO_*`` set: 72 requests fit both
            regressors, the trainer refits, the prediction server reloads;
            the producer's fallbacks stop growing, routed tokens equal direct
            ones, a sheddable request no endpoint can serve in its SLO is
            refused as the reference refuses it, the SLO gauges and the
            calibration families carry samples. Then a router with the P/D
            profile and the producer, the decode engine behind the port's
            ``RoutingSidecar``: every decision predicted, the sidecar's legs
            and its fallback past a dead prefiller give aggregated serving's
            tokens. Then ``LLMD_KV_PLANE=precise`` over the external index in
            the port's RESP store: a prompt cached on one engine and routed to
            the other is stamped with a pull, injected and answered with the
            same tokens; K1 launched (its plain version never); the
            producer's predict round trip (p50, p99). bf16: the hop with the
            latency plugins and without them, the sidecar's P/D TTFT against
            the same legs driven by hand; one predictor fit over a full
            10,240-row window.
            The phase prints its seconds.
23. gateway the gateway fronts (``phase_gateway``): two llama-1b port engines
            (page 16, 1,024 pages each) as two pods on loopback (127.0.0.1 and
            127.0.0.2, one port), found by the port's ``K8sWatchSource``
            through a fake pods API written here on the port's ``HTTPServer``,
            the pool's selector and port taken from an InferencePool manifest
            (``core/crds.py``); the port's ``RouterServer`` behind the port's
            ``ExtProcEPP`` and ``VllmGrpcFront`` on the port's own gRPC wire
            (no grpc here). float32: an Envoy stand-in on the port's gRPC
            client sends 8 requests' headers and body phases (256-token
            prompts, 16 tokens out), reads ``x-gateway-destination-endpoint``,
            forwards to that engine and feeds the response phases back: every
            reply 200, the tokens equal a direct request to the named engine,
            ``/metrics`` counts 8 picks; pod-b DELETED leaves pod-a alone (two
            picks both there), re-ADDED brings it back; vLLM gRPC ``Generate``
            unary and streamed gives the direct tokens; health ``Check``
            answers SERVING; K1 launched behind the fronts. bf16: the ext_proc
            pick round trip (the body phase, and headers to pick) p50 / p99
            over 256 streams beside the HTTP front's hop (p50 of 32 one-token
            requests, routed minus direct), vLLM gRPC streamed TTFT p50 beside
            direct (16 fresh 512-token prompts each), printed with the card.
            The phase prints its seconds.
24. batch   the batch plane and the load harness (``phase_batch``): the port's
            ``RouterServer`` in front of two llama-1b port engines (page 16,
            1,024 pages each). float32: the port's ``BatchGateway`` (OpenAI
            Files + Batches API, SQLite store, files root) in front of the
            router takes a multipart/form-data upload of a 16-line JSONL (11
            completions, 4 chats, 128+16 tokens, and one line whose
            ``response_format`` the server's structured-output check refuses);
            the batch runs to ``completed`` with 15 lines in the output file,
            each line's tokens equal to a direct request's, and the refused
            line with its 400 in the error file; a second batch of 64 cancelled
            mid-run ends ``cancelled``; a third left ``in_progress`` by a
            stopped gateway is completed by a new gateway's recovery scan over
            the same store and files root; K1 launched behind the gateway.
            bf16: the port's ``AsyncProcessor`` sends 32 items through a
            ``PrometheusSaturationGate`` on an engine's
            ``vllm:num_requests_waiting``, all succeed; the load harness's
            ``compare_targets`` on ``shared-prefix`` (64 requests, 32 out,
            concurrency 8) between one engine directly and the router, its
            ``out_tok_per_s``, ``ttft_p50_ms`` and ``e2e_p90_ms`` printed with
            the card (not bounded); K1 launched. Then ``python -m
            llmd_tpu_torch.tools.chaos_check``, ``kv_plane_check`` and
            ``decision_check`` as concurrent subprocesses, each exit 0, their
            seconds printed. The phase prints its seconds.
25. tools   the port's tooling (``phase_tools``): ``python -m
            llmd_tpu_torch.tools.llmd_lint`` (every analyzer over the port:
            lock discipline, hot-path syncs, the env / metrics / events
            contracts) and ``validate_manifests`` over ``deploy/`` as
            subprocesses on the card's Python, each exit 0 (the lint's finding,
            allow and lock counts printed). Two llama-1b bf16 engines (LoRA on,
            1,024 pages each) behind the port's router: the rollout CLI loads an
            adapter written from seed 0 on both pods and shifts the base model
            to it over stages 0.1, 0.5, 1.0 with 8 probes each through
            ``/admin/model-rewrites``: exit 0, every stage at success 1.0, the
            successor pinned, K1 all on ``mma``; ``dump_flight`` renders one
            engine's request list and a rollout probe's
            timeline with its phase and decision ledgers from the router, and
            the same views from their ``--save`` files, byte-equal; with both
            engines drained a second rollout fails its first stage: exit 1,
            the rewrites read back as before. ``predictor_accuracy``'s
            offline mode on llama-1b at full width (the reference's four
            regimes 3 times, the artifact in a temporary directory): MAPE and
            skill against the mean baseline printed, K1 all on ``mma``. Then
            one engine's unified step and replayed decode iterations under
            ``torch.cuda.set_sync_debug_mode("warn")``: every sync site torch
            reports in ``llmd_tpu_torch/`` is printed, and one inside a
            function the lint holds hot without an ``allow[hot-host-sync]``
            fails the phase; then the same for a speculative engine's verify
            steps on echo prompts (a deliberate ``.item()`` after each run
            must be reported). The phase prints its seconds.
26. pool    the pool and autoscaling (``phase_pool``): the port's
            ``RouterServer`` (flow control on) over an empty pool, the port's
            ``PoolController`` in front of it (HPA, 1 to 2 replicas, a 1 s
            step) launching llama-1b replicas as processes
            (``ProcessReplicaLauncher`` over ``engine_argv`` with a snapshot
            store: bf16, random weights from seed 0, 1,024 pages, batch 64,
            ``decode_steps`` 4; 400 s to become ready). The floor's cold
            launch builds the kernel libraries into the fingerprint's
            ``compile_cache`` and reports ``cuda_paged_attention``. A bursty
            trace (60 s, 2 rps with 64 rps from 5 s to 45 s, 256-token
            prompts, 64 tokens out; at 32 rps one replica holds HPA's 16
            running and the pool flaps) replayed open loop through the router:
            every reply 200, no client 5xx; HPA's running-requests metric
            takes the pool to 2 with warm launches that build nothing, and a
            scaled-up replica serves; after the trace the pool is back at 1,
            each victim drained (``POST /drain``, then ``/health`` 503), out
            of discovery before its terminate, exit code -15. The survivor
            killed: the health sweep retires it (``replica_dead``) and a warm
            launch replaces it; 8 greedy prompts (text whose bytes are its
            token ids, every printable id raised by 100 so the byte
            tokenizer's text holds each token) give the same 32 tokens before
            and after. A ``DisaggPoolSet``: one ``--role prefill`` and one
            ``--role decode`` replica (KV-transfer side channels, the decode
            one behind the port's ``RoutingSidecar``), both warm, behind a
            router with the P/D profile: 4 prompts of 512 tokens split
            (``no_predictor``), 200 with 32 tokens each, D's injected blocks
            rise; the share of tokens equal to the aggregated replica's is
            printed, not bounded. The pool families on the routers (desired,
            ready, decisions by floor / hpa / replica_dead, warm starts by
            kind), then ``python -m llmd_tpu_torch.tools.slo_check`` and
            ``pd_check`` as subprocesses, both exit 0. Attainment, e2e p50 /
            p99, every launch's seconds and the phase's seconds are printed.
            The replicas are processes of their own: their kernel launches
            are not counted here.

It ends with a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. ``--report PATH`` also writes every phase's details (nvcc's register
report, per-check errors) as JSON. Without a CUDA device it exits 1 and prints
no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import functools
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from llmd_tpu_torch.tools.timing import cuda_ms  # spin-kernel-held CUDA-event timing

REPO = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, and FLOP/s by input type —
# bf16 on the tensor cores, float32 on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version, valid rows. float32: summation order and exp
# rounding only, max abs <= F32_ATOL. bfloat16: the kernel is held against the
# plain version run in float32 on the same bf16-rounded inputs, element by
# element in units of one bf16 rounding of the output
# (ops.paged_attention.bf16_rounding_units): float32 accumulation rounded once
# reads <= 1. Two controls must read above the limit (see check_attention).
F32_ATOL = 2e-5
BF16_UNITS = 1.0
# float32 forward through every layer, kernels vs plain versions: logits agree
# to summation order.
FORWARD_ATOL = 1e-3
# grouped GEMMs in float32: unit-scale outputs summed over D <= 1024 in another
# order than the plain version's cuBLAS product.
GEMM_F32_ATOL = 1e-4
# the whole run's limit, the kernels' build included
DEADLINE_S = 1140
H, HK, D, PS = 32, 8, 64, 16  # llama-1b attention: heads, kv heads, head dim, page
MOE = "moe-wide-sim"  # D 1024, 32 experts, top-4, expert FFN 512 (2Fe = 1024)
# moe-wide-mla's absorbed attention: 16 heads over one latent plane of width
# rank 128 + rope 32, scale (nope 32 + rope 32)^-0.5
MLA = "moe-wide-mla"
MLA_H, MLA_W, MLA_SCALE = 16, 160, 64 ** -0.5


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# Attention inputs at the main path's shapes
# --------------------------------------------------------------------------


def make_attention_case(q_lens, kv_lens, dtype, device, seed, pad_rows=0,
                        pad_seqs=0, heads=None, latent=False):
    """Random q and pool, page tables over a shuffled page pool; sequence b's
    queries are its last q_lens[b] tokens. ``pad_rows`` trailing query rows and
    ``pad_seqs`` trailing unused table rows mimic the engine's padded packing.
    ``heads``: (query heads, kv heads), llama-1b's by default. ``latent``:
    moe-wide-mla's single-plane latent pool instead, its 16 heads by default
    (``heads=(n, 1)``: n heads, one tensor-parallel rank's)."""
    nh, nk = heads or ((MLA_H, 1) if latent else (H, HK))
    width, planes = (MLA_W, 1) if latent else (D, 2 * nk)
    rng = np.random.default_rng(seed)
    q_lens, kv_lens = np.asarray(q_lens), np.asarray(kv_lens)
    nb = len(q_lens)
    B = nb + pad_seqs
    maxp = int(max(-(-kv_lens // PS)))
    need = -(-kv_lens // PS)
    P = int(need.sum()) + 8
    perm = rng.permutation(P)
    pts = np.full((B, maxp), -1, np.int32)
    o = 0
    for b in range(nb):
        pts[b, : need[b]] = perm[o : o + need[b]]
        o += need[b]
    N = int(q_lens.sum()) + pad_rows
    pos = np.full((N,), -1, np.int32)
    sids = np.zeros((N,), np.int32)
    cu = np.zeros((B + 1,), np.int32)
    off = 0
    for b in range(nb):
        ql, kl = int(q_lens[b]), int(kv_lens[b])
        pos[off : off + ql] = np.arange(kl - ql, kl)
        sids[off : off + ql] = b
        off += ql
        cu[b + 1] = off
    cu[nb + 1 :] = off
    lens = np.ones((B,), np.int32)
    lens[:nb] = kv_lens
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((N, nh, width), generator=g).to(device=device, dtype=dtype)
    pool = torch.randn((P, PS, planes, width), generator=g).to(device=device, dtype=dtype)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return dict(q=q, pool=pool, pts=t(pts), pos=t(pos), sids=t(sids),
                lens=t(lens), cu=t(cu), ns=t(np.array([nb], np.int32)),
                valid=off, q_lens=q_lens, kv_lens=kv_lens, H=nh, HK=nk,
                W=width, planes=planes, scale=MLA_SCALE if latent else D ** -0.5)


def run_attention(fn, c):
    return fn(c["q"], c["pool"], c["pts"], c["pos"], c["sids"], c["lens"],
              scale=c["scale"], cu_q_lens=c["cu"], num_seqs=c["ns"])


def decode_case(dtype, device, seed=1, heads=None, latent=False):
    rng = np.random.default_rng(seed)
    kv = rng.integers(128, 1025, 64)
    return make_attention_case(np.ones(64, int), kv, dtype, device, seed, heads=heads,
                               latent=latent)


def mixed_case(dtype, device, seed=2, heads=None, latent=False):
    """Three 128-token chunks (a fresh prompt, continuations at 1000 and
    2048), 32 decode rows, padding rows and unused table rows."""
    rng = np.random.default_rng(seed)
    q_lens = np.concatenate([[128, 128, 128], np.ones(32, int)])
    kv = np.concatenate([[128, 1000, 2048], rng.integers(1, 2049, 32)])
    return make_attention_case(q_lens, kv, dtype, device, seed, pad_rows=16,
                               pad_seqs=5, heads=heads, latent=latent)


def long_decode_case(dtype, device, seed=4, kv=None, latent=False):
    """Decode at small batch over long contexts (one query row each): B=8 at
    kv 3072-5120 from the seed (~67 MB of bf16 K/V, more than the 50 MB L2),
    or the given kv lengths."""
    rng = np.random.default_rng(seed)
    kv = rng.integers(3072, 5121, 8) if kv is None else np.asarray(kv)
    return make_attention_case(np.ones(len(kv), int), kv, dtype, device, seed, pad_rows=3,
                               pad_seqs=2, latent=latent)


def verify_case(dtype, device, seed=12):
    """The speculative verify batch: 64 sequences of 5 query tokens (the
    last token and a 4-token draft) at kv 128-1024, llama-1b heads."""
    rng = np.random.default_rng(seed)
    return make_attention_case(np.full(64, 5), rng.integers(128, 1025, 64), dtype, device,
                               seed)


def chunk_case(dtype, device, chunk, chunk_kv, seed, heads=None, latent=False):
    """One prefill chunk of ``chunk`` tokens at kv ``chunk_kv`` beside 8
    decode rows (kv 1-2048 from the seed), padding rows and unused table
    rows."""
    rng = np.random.default_rng(seed)
    q_lens = np.concatenate([[chunk], np.ones(8, int)])
    kv = np.concatenate([[chunk_kv], rng.integers(1, 2049, 8)])
    return make_attention_case(q_lens, kv, dtype, device, seed, pad_rows=5, pad_seqs=2,
                               heads=heads, latent=latent)


def attention_bound(c, dtype, pool_dtype=None):
    """(bound_ms, bound_by): each input byte read once, each output byte
    written once, KV only where this run's masks let it be read (one latent
    row per key on a single-plane pool; ``pool_dtype``'s bytes a K/V element
    when the pool is not q's type: 1 for fp8); flops of QK^T and PV over the
    keys each query attends, at q's type's peak."""
    elt = torch.finfo(dtype).bits // 8
    kv_elt = torch.finfo(pool_dtype or dtype).bits // 8
    q_lens, kv_lens, nh, W = c["q_lens"], c["kv_lens"], c["H"], c["W"]
    kv_bytes = int(kv_lens.sum()) * c["planes"] * W * kv_elt
    qo_bytes = 2 * int(q_lens.sum()) * nh * W * elt
    idx_bytes = 4 * (int((-(-kv_lens // PS)).sum()) + 2 * len(kv_lens) + 2)
    keys = sum(int(kl - ql + i + 1) for ql, kl in zip(q_lens, kv_lens) for i in range(ql))
    flops = 4 * nh * W * keys
    t_bytes = (kv_bytes + qo_bytes + idx_bytes) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_dense(c):
    """The same decode attention as one ``scaled_dot_product_attention`` call
    over K/V gathered dense (a yardstick only; the port never calls it)."""
    pool, pts, kv_lens = c["pool"], c["pts"].long(), c["kv_lens"]
    nh, nk, W = c["H"], c["HK"], c["W"]  # llama-1b's, or one tp rank's
    B = len(kv_lens)
    S = pts.shape[1] * PS
    kv = pool[pts[:B].clamp(min=0)].reshape(B, S, 2 * nk, W)
    k = kv[:, :, 0::2].transpose(1, 2).contiguous()  # [B, Hk, S, D]
    v = kv[:, :, 1::2].transpose(1, 2).contiguous()
    q = c["q"][: B].reshape(B, nh, 1, W)
    key_pos = torch.arange(S, device=pool.device)
    lens = torch.from_numpy(np.asarray(kv_lens)).to(pool.device)
    mask = (key_pos[None, :] < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
        return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
    except TypeError:  # torch without enable_gqa: expand heads in set-up
        k = k.repeat_interleave(nh // nk, dim=1)
        v = v.repeat_interleave(nh // nk, dim=1)
        return lambda: sdpa(q, k, v, attn_mask=mask)


def sdpa_packed(c):
    """The same mixed GQA attention as one ``scaled_dot_product_attention``
    call (a yardstick only; the port never calls it): K/V gathered dense per
    sequence [B, Hk, S, D], queries packed per sequence [B, H, Qmax, D] under
    a causal, length-limited mask, all in set-up; the call alone is timed.
    Rows with no key (padding, unused table rows) attend key 0 so the call
    stays finite."""
    pool, pts, q, nh, nk = c["pool"], c["pts"].long(), c["q"], c["H"], c["HK"]
    B, S, W = pts.shape[0], pts.shape[1] * PS, c["W"]
    cu = c["cu"].long()
    q_lens = cu[1:] - cu[:-1]
    j = torch.arange(int(q_lens.max()), device=q.device)
    rows = (cu[:-1, None] + j[None, :]).clamp(max=q.shape[0] - 1)  # [B, Qmax]
    qpos = torch.where(j[None, :] < q_lens[:, None], c["pos"].long()[rows], -1)
    key = torch.arange(S, device=q.device)
    mask = (key[None, None, :] <= qpos[..., None]) & (key < c["lens"].long()[:, None, None])
    mask[..., 0] |= ~mask.any(-1)
    mask = mask[:, None]  # [B, 1, Qmax, S]
    kv = pool[pts.clamp(min=0)].reshape(B, S, 2 * nk, W)
    k = kv[:, :, 0::2].transpose(1, 2).contiguous()  # [B, Hk, S, D]
    v = kv[:, :, 1::2].transpose(1, 2).contiguous()
    qq = q[rows].transpose(1, 2).contiguous()  # [B, H, Qmax, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(qq, k, v, attn_mask=mask, scale=c["scale"], enable_gqa=True)
        return lambda: sdpa(qq, k, v, attn_mask=mask, scale=c["scale"], enable_gqa=True)
    except TypeError:  # torch without enable_gqa: expand heads in set-up
        k = k.repeat_interleave(nh // nk, dim=1)
        v = v.repeat_interleave(nh // nk, dim=1)
        return lambda: sdpa(qq, k, v, attn_mask=mask, scale=c["scale"])


def sdpa_latent(c):
    """The same latent attention as one ``scaled_dot_product_attention`` call
    (a yardstick only; the port never calls it): the latent rows gathered
    dense per sequence, K = V broadcast to the heads, queries packed per
    sequence with a causal, length-limited mask. Gather and packing are
    timed with the call. Rows with no key (padding, idle) attend key 0 so
    the call stays finite."""
    pool, pts, q = c["pool"], c["pts"].long(), c["q"]
    B, S, W = pts.shape[0], pts.shape[1] * PS, c["W"]
    cu = c["cu"].long()
    q_lens = cu[1:] - cu[:-1]
    qmax = int(q_lens.max())
    j = torch.arange(qmax, device=q.device)
    rows = (cu[:-1, None] + j[None, :]).clamp(max=q.shape[0] - 1)  # [B, Qmax]
    live = j[None, :] < q_lens[:, None]
    qpos = torch.where(live, c["pos"].long()[rows], -1)
    key = torch.arange(S, device=q.device)
    mask = (key[None, None, :] <= qpos[..., None]) & (key < c["lens"].long()[:, None, None])
    mask[..., 0] |= ~mask.any(-1)
    mask = mask[:, None]  # [B, 1, Qmax, S]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call():
        kv = pool[pts.clamp(min=0)].reshape(B, 1, S, W).expand(B, c["H"], S, W)
        qq = q[rows].transpose(1, 2)  # [B, H, Qmax, W]
        return sdpa(qq, kv, kv, attn_mask=mask, scale=c["scale"])

    return call


def latent_decode_case(dtype, device, seed=3, kv=None, heads=MLA_H):
    """K3 at moe-wide-mla's decode shape: 64 sequences of 128-1024 resident
    latent rows from the seed plus two idle rows (kv_len 0), or the given kv
    lengths; one query row each, pages shuffled, -1 past each sequence.
    ``heads``: one tensor-parallel rank's (all 16 by default)."""
    rng = np.random.default_rng(seed)
    kv = (np.concatenate([rng.integers(128, 1025, 64), [0, 0]]) if kv is None
          else np.asarray(kv)).astype(np.int32)
    B = len(kv)
    need = -(-kv // PS)
    maxp = max(int(need.max()), 1)
    P = int(need.sum()) + 8
    perm = rng.permutation(P)
    pts = np.full((B, maxp), -1, np.int32)
    o = 0
    for b in range(B):
        pts[b, : need[b]] = perm[o : o + need[b]]
        o += need[b]
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, heads, MLA_W), generator=g).to(device=device, dtype=dtype)
    pool = torch.randn((P, PS, 1, MLA_W), generator=g).to(device=device, dtype=dtype)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    cu = np.arange(B + 1, dtype=np.int32)
    return dict(q=q, pool=pool, pts=t(pts), lens=t(kv), kv_lens=kv, q_lens=np.ones(B, int),
                pos=t(np.maximum(kv - 1, 0)), cu=t(cu), H=heads, W=MLA_W, scale=MLA_SCALE)


def run_latent_decode(decode, c):
    from llmd_tpu_torch.ops.mla_decode import mla_paged_attention_latent

    return mla_paged_attention_latent(c["q"], c["pool"], c["pts"], None, None, c["lens"],
                                      scale=c["scale"], decode=decode)


def latent_decode_bound(c, dtype, pool_dtype=None):
    """(bound_ms, bound_by) of K3: each resident latent row read once (one
    row serves every head; ``pool_dtype``'s bytes an element when the pool
    is not q's type), q, page-table entries, kv_lens read once, out written
    once; flops 4*H*W per key."""
    elt = torch.finfo(dtype).bits // 8
    kv_elt = torch.finfo(pool_dtype or dtype).bits // 8
    kv = c["kv_lens"]
    B = len(kv)
    nbytes = (int(kv.sum()) * MLA_W * kv_elt + 2 * B * c["H"] * MLA_W * elt
              + 4 * (int((-(-kv // PS)).sum()) + B))
    flops = 4 * c["H"] * MLA_W * int(kv.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# Grouped-GEMM inputs at moe-wide-sim widths
# --------------------------------------------------------------------------


def moe_widths() -> tuple[int, int, int]:
    """(hidden D, expert FFN Fe, top-k) of the MoE model."""
    from llmd_tpu_torch.models import get_model_config

    cfg = get_model_config(MOE)
    return cfg.hidden_size, cfg.moe_intermediate_size, cfg.moe_top_k


def _on(device, dtype, *ts):
    return [t.to(device=device, dtype=dtype) for t in ts]


def ragged_case(T: int, S: int, dtype, device, seed: int, dead_rows: bool = False) -> dict:
    """K2's inputs as the sorted dispatch builds them on the card: T tokens
    routed to k distinct of S slots at random, placed by the port's row plan
    at the kernel's block size, and the weights of a layer's two launches:
    wi [S, D, 2Fe] (input [nb, bc, D]) and wo [S, Fe, D] (input
    [nb, bc, Fe]). ``dead_rows`` fills the blocks' padding rows with random
    values (multiplied all the same) and empties every fifth block
    (block_rows 0: the kernel writes zeros)."""
    from llmd_tpu_torch.ops.moe_dispatch import dispatch_stage, pick_block_size

    Dm, Fe, k = moe_widths()
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    idx = torch.from_numpy(np.argsort(rng.random((T, S)), axis=1)[:, :k])
    bc = pick_block_size(T * k, S, pallas=True)
    xs, _, _, _, slot, rows = dispatch_stage(
        torch.randn((T, Dm), generator=g), idx, torch.ones((T, k)),
        torch.ones((T, 1), dtype=torch.int32), S, bc)
    nb = slot.shape[0]
    xb = xs.view(nb, bc, Dm)
    live_rows = (torch.arange(bc)[None, :] < rows[:, None])[..., None]  # [nb, bc, 1]
    h = torch.randn((nb, bc, Fe), generator=g)
    if dead_rows:
        xb = torch.where(live_rows, xb, torch.randn(xb.shape, generator=g))
        rows = rows.clone()
        rows[::5] = 0
    else:
        h = h * live_rows
    wi = torch.randn((S, Dm, 2 * Fe), generator=g) * Dm ** -0.5
    wo = torch.randn((S, Fe, Dm), generator=g) * Fe ** -0.5
    xb, h, wi, wo = _on(device, dtype, xb, h, wi, wo)
    return dict(launches=[("wi", xb, wi), ("wo", h, wo)], slot=slot.to(device),
                live=rows.to(device), shape=f"T={T} copies={T * k} S={S} bc={bc} nb={nb}")


def capacity_case(C: int, S: int, dtype, device, seed: int) -> dict:
    """K4's inputs as the capacity-einsum dispatch builds them: S slots of C
    rows, a random kept count per slot (every fourth slot 0: the kernel writes
    zeros), rows past the count zero."""
    Dm, Fe, _ = moe_widths()
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    counts = torch.from_numpy(rng.integers(1, C + 1, S).astype(np.int32))
    counts[::4] = 0
    live_rows = (torch.arange(C)[None, :] < counts[:, None])[..., None]
    x = torch.randn((S, C, Dm), generator=g) * live_rows
    h = torch.randn((S, C, Fe), generator=g) * live_rows
    wi = torch.randn((S, Dm, 2 * Fe), generator=g) * Dm ** -0.5
    wo = torch.randn((S, Fe, Dm), generator=g) * Fe ** -0.5
    x, h, wi, wo = _on(device, dtype, x, h, wi, wo)
    return dict(launches=[("wi", x, wi), ("wo", h, wo)], slot=torch.arange(S, device=device),
                live=counts.to(device), shape=f"S={S} C={C}")


def gemm_bound(x, w, slot, live, dtype, n_index: int) -> tuple[float, str, dict]:
    """(bound_ms, bound_by, counts) of one grouped-GEMM launch on this run's
    inputs: the live groups' activations and the distinct weight slots they
    hit are read once, every output element is written once, the index arrays
    read once; flops 2 * live rows * D * F (a live group is multiplied whole)."""
    elt = torch.finfo(dtype).bits // 8
    G, R, Dk = x.shape
    F = w.shape[2]
    alive = live > 0
    n_live = int(alive.sum())
    n_slots = int(torch.unique(slot[alive]).numel())
    nbytes = (n_live * R * Dk + n_slots * Dk * F + G * R * F) * elt + 4 * n_index * G
    flops = 2 * n_live * R * Dk * F
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, {"bytes": nbytes, "flops": flops,
                                           "weight_slots": n_slots, "live_groups": n_live}


def gemm_bf16_control(x, w_sel, live):
    """What a kernel with a bfloat16 accumulator returns: the product summed
    over D in 32-deep steps (the kernel's step), rounded to bfloat16 after
    every step. Only for showing that the bf16 check rejects such a kernel."""
    acc = torch.zeros((x.shape[0], x.shape[1], w_sel.shape[2]), device=x.device,
                      dtype=torch.bfloat16)
    for d0 in range(0, x.shape[2], 32):
        part = torch.bmm(x[:, :, d0:d0 + 32].float(), w_sel[:, d0:d0 + 32].float())
        acc = (acc.float() + part).to(torch.bfloat16)
    return acc * (live > 0).to(acc.dtype)[:, None, None]


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(smi.splitlines()[0] if smi else "nvidia-smi: no card listed")
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device_name={name!r} count={torch.cuda.device_count()}")
    return {"nvidia_smi": smi, "kind": name, "count": torch.cuda.device_count()}


def phase_build() -> dict:
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from llmd_tpu_torch.native.build import load
    from llmd_tpu_torch.ops import grouped_gemm as gg
    from llmd_tpu_torch.ops import mla_decode as md
    from llmd_tpu_torch.ops import paged_attention as pa

    builders = {"paged_attention": pa.build, "grouped_gemm": gg.build,
                "mla_decode": md.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {name: pool.submit(fn) for name, fn in builders.items()}
        seconds = {name: f.result() for name, f in futures.items()}
    wall = time.perf_counter() - t0
    out = {"wall_s": wall}
    for name in builders:
        built = load(name)
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"build: {name}.cu seconds={seconds[name]:.3f} lib={built.path.name}")
        for ln in ptxas:
            log(f"build:   {name} ptxas: {ln}")
        out[name] = {"seconds": seconds[name], "nvcc_log": built.log}
    log(f"build: wall_s={wall:.3f} (parallel)")
    out["grouped_gemm_sass"] = sass_check("grouped_gemm", "wgmma", ("HGMMA",))
    for lib in ("paged_attention", "mla_decode"):  # K1's and K3's mma instances
        out[f"{lib}_sass"] = sass_check(lib, f"{lib}_mma", ("HMMA", "HGMMA"))
        out[f"{lib}_mma_ptxas"] = ptxas_check(load(lib).log, f"{lib}_mma")
    return out


ASYNC_COPIES = ("UTMALDG", "LDGSTS", "UBLKCP")  # TMA, cp.async, bulk copy


def sass_check(lib: str, marker: str, tensor_ops: tuple) -> dict:
    """Per kernel function of ``csrc/<lib>.cu``'s library, the count of
    tensor-core (``tensor_ops``) and asynchronous-copy SASS instructions.
    Fails unless every kernel whose name holds ``marker`` (the bf16 instance)
    has both."""
    from llmd_tpu_torch.native.build import load, nvcc_path

    tool = shutil.which("cuobjdump") or str(Path(nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(load(lib).path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    ops = tensor_ops + ASYNC_COPIES
    funcs: dict = {}
    name = None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = dict.fromkeys(ops, 0)
        elif name is not None:
            for op in ops:
                funcs[name][op] += re.search(rf"\b{op}\b", ln) is not None
    tc = {n: v for n, v in funcs.items() if marker in n}
    for n, v in funcs.items():
        log(f"build:   {lib} sass: {n[:70]} " + " ".join(f"{k}={c}" for k, c in v.items()))
    if not tc or not all(any(v[op] for op in tensor_ops) and any(v[op] for op in ASYNC_COPIES)
                         for v in tc.values()):
        raise AssertionError(f"build: the bf16 {lib} kernels lack {'/'.join(tensor_ops)} "
                             f"or an asynchronous copy: {tc}")
    log(f"build: {lib} sass: {len(tc)} {marker} kernels, each with "
        f"{'/'.join(tensor_ops)} and {'/'.join(ASYNC_COPIES)}")
    return funcs


def ptxas_check(nvcc_log: str, marker: str) -> dict:
    """Registers and spill bytes of every kernel whose name holds ``marker``,
    from nvcc's ``-Xptxas -v`` report (empty when the library came from the
    build cache); fails on any spill."""
    out: dict = {}
    name = None
    for ln in nvcc_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            name = m.group(1)
        if name is None or marker not in name:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    for n, v in out.items():
        # template arguments: <D, QPK, planes> for K1, <D, H> for K3
        args = re.findall(r"Li(\d+)E", n)
        log(f"build:   {marker} ptxas: <{', '.join(args) if args else n}> "
            f"registers={v.get('registers')} spill_bytes={v.get('spill_bytes')}")
    spills = {n: v for n, v in out.items() if v.get("spill_bytes")}
    if spills:
        raise AssertionError(f"build: ptxas spills in the {marker} kernels: {spills}")
    return out


def bf16_accumulating_control(c):
    """What a kernel with a bfloat16 P·V accumulator returns on the valid rows:
    float32 scores and softmax as in the plain version, the normalised P·V sum
    rounded to bfloat16 after every 32-key tile (the kernel's tile). Only for
    showing that the bfloat16 check tells such a kernel from a sound one. A
    single-plane pool's row is both K and V."""
    q, pool, H, HK, W = c["q"], c["pool"], c["H"], c["HK"], c["W"]
    pts, pos, sids, lens = c["pts"].long(), c["pos"].long(), c["sids"].long(), c["lens"].long()
    S = pts.shape[1] * PS
    key = torch.arange(S, device=q.device)
    outs = []
    for c0 in range(0, c["valid"], 32):
        b = sids[c0:min(c0 + 32, c["valid"])]
        n = b.shape[0]
        pt = pts[b]
        kv = pool[pt.clamp(min=0)].reshape(n, S, c["planes"], W).float()
        kc, vc = (kv, kv) if c["planes"] == 1 else (kv[:, :, 0::2], kv[:, :, 1::2])
        s = torch.einsum("nkqd,nskd->nkqs", q[c0:c0 + n].float().reshape(n, HK, H // HK, W),
                         kc) * c["scale"]
        mask = ((pt[:, key // PS] >= 0) & (key[None] <= pos[c0:c0 + n, None])
                & (key[None] < lens[b][:, None]))
        p = torch.softmax(s.masked_fill(~mask[:, None, None], -1e30), dim=-1)
        T = -(-S // 32)
        pad = T * 32 - S  # zero keys fill the last tile
        vt = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
        part = torch.einsum("nkqtj,ntjkd->nkqtd",
                            torch.nn.functional.pad(p, (0, pad)).reshape(n, HK, H // HK, T, 32),
                            vt.reshape(n, T, 32, HK, W))
        acc = torch.zeros_like(part[:, :, :, 0], dtype=torch.bfloat16)
        for t in range(T):
            acc = (acc.float() + part[:, :, :, t]).to(torch.bfloat16)
        outs.append(acc.reshape(n, H, W))
    return torch.cat(outs)


def latent_decode_controls(c, q_scaled):
    """Two outputs K3's bfloat16 check must reject, from float32 scores and
    softmax of the pre-scaled q: the probabilities cast to bfloat16 before
    P·V, and P·V accumulated in bfloat16, rounded after every 16-key tile
    (the simt instance's tile at 16 heads; a model of an unsound kernel, not
    of the mma instance's 64-key stages). Valid (non-idle) rows only."""
    pts, kv_lens = c["pts"].long().clamp(min=0), c["lens"].long()
    B, S = pts.shape[0], pts.shape[1] * PS
    rows = c["pool"][pts].reshape(B, S, MLA_W).float()
    s = torch.einsum("bhd,bsd->bhs", q_scaled, rows)
    mask = torch.arange(S, device=rows.device)[None, :] < kv_lens[:, None]
    p = torch.softmax(s.masked_fill(~mask[:, None], float("-inf")), dim=-1)
    live = kv_lens > 0
    p_bf16 = torch.einsum("bhs,bsd->bhd", p.bfloat16().float(), rows)
    T = S // 16
    part = torch.einsum("bhtj,btjd->bhtd", p.reshape(B, c["H"], T, 16),
                        rows.reshape(B, T, 16, MLA_W))
    acc = torch.zeros_like(part[:, :, 0], dtype=torch.bfloat16)
    for t in range(T):
        acc = (acc.float() + part[:, :, t]).to(torch.bfloat16)
    return p_bf16[live], acc[live]


def check_attention(device, latent: bool = False, cases=None, name=None) -> dict:
    """K1. float32: kernel vs plain version, max abs error. bfloat16: kernel vs
    the plain version in float32 on the same (upcast) bf16 inputs, in bf16
    rounding units; beside it two controls on the same inputs that the check
    must reject: the plain version in bfloat16 (probabilities cast to bf16
    before P·V) and a bfloat16 P·V accumulator. llama-1b heads at decode, at
    the mixed shape, at decode over long contexts at B=4 (kv 3000-8192: many
    KV splits, some empty), with a 512-token chunk at kv 2048 and with a chunk
    of one query tile plus one token (17 tokens) beside decode rows, and at kv
    lengths that are exact multiples of the split and page lengths, and at
    the speculative verify batch (64 sequences of 5 query tokens);
    moe-wide-sim heads (H 16, Hk 4: four query heads per kv head) at decode.
    Each call must land on its instance: bf16 on mma, float32 on simt.
    ``latent``: K1's single-plane mode on moe-wide-mla's latent pool (16
    heads, width 160; the mma instance's tiles are 4 tokens x 16 heads) at
    the mixed shape, at decode, with a 512-token chunk at kv 2048, with a
    chunk of one tile plus one token (5 tokens) and at kv lengths that are
    exact multiples of the split and page lengths. ``cases`` ((label, make)
    pairs) and ``name``: other shapes (the mesh phase's rank shapes), each
    call landing on the instance ``ops.paged_attention._instance`` picks for
    it."""
    from llmd_tpu_torch.ops import paged_attention as pa
    from llmd_tpu_torch.ops.paged_attention import (
        bf16_rounding_units, paged_attention, paged_attention_ref)

    default = cases is None
    name = name or ("paged_attention_latent" if latent else "paged_attention")
    tq = pa.MMA_ROWS // (MLA_H if latent else H // HK)
    cases = cases or ((
        ("mixed", lambda dt: mixed_case(dt, device, latent=True)),
        ("decode", lambda dt: decode_case(dt, device, latent=True)),
        ("chunk512_kv2048", lambda dt: chunk_case(dt, device, 512, 2048, 7, latent=True)),
        ("chunk_tq_plus_1", lambda dt: chunk_case(dt, device, tq + 1, 900, 8, latent=True)),
        ("exact_multiples", lambda dt: long_decode_case(
            dt, device, 9, kv=[16, 64, 512, 1024, 2048, 4096], latent=True)),
    ) if latent else (
        ("decode", lambda dt: decode_case(dt, device)),
        ("mixed", lambda dt: mixed_case(dt, device)),
        ("verify", lambda dt: verify_case(dt, device)),
        ("moe_heads_decode", lambda dt: decode_case(dt, device, heads=(16, 4))),
        ("long_context_b4", lambda dt: long_decode_case(dt, device, 6,
                                                        kv=[3000, 4711, 6150, 8192])),
        ("chunk512_kv2048", lambda dt: chunk_case(dt, device, 512, 2048, 7)),
        ("chunk_tq_plus_1", lambda dt: chunk_case(dt, device, tq + 1, 900, 8)),
        # with 6 one-token rows over a 4096-key table the plan splits the keys
        # into 8 x 512: kv at whole pages, stages and splits
        ("exact_multiples", lambda dt: long_decode_case(dt, device, 9,
                                                        kv=[16, 64, 512, 1024, 2048, 4096])),
    ))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, make in cases:
            c = make(dtype)
            want = "mma" if dtype == torch.bfloat16 else "simt"
            if not default:
                want = pa._instance(dtype, c["planes"], c["W"], pa._check(
                    c["q"], c["pool"], c["pts"], c["lens"], c["cu"], c["ns"]),
                    c["pool"].dtype)
            before = dict(paged_attention.launches_by_instance)
            got = run_attention(paged_attention, c)
            torch.cuda.synchronize()
            instance = {k: v - before[k] for k, v in paged_attention.launches_by_instance.items()}
            c32 = dict(c, q=c["q"].float(), pool=c["pool"].float())
            ref = run_attention(paged_attention_ref, c32)
            torch.cuda.synchronize()
            v = c["valid"]
            err = (got[:v].float() - ref[:v]).abs().max().item()
            pad = got[v:].float().abs().max().item() if got.shape[0] > v else 0.0
            key = f"{label}_{str(dtype).split('.')[-1]}"
            row = {"max_abs_err": err, "pad_rows_max": pad, "tokens": int(c["q"].shape[0]),
                   "kv_tokens": int(c["kv_lens"].sum()), "instance": want}
            if want.startswith("mma"):
                plan = pa._plan(c["q"].shape[0], c["pts"].shape[0], c["pts"].shape[1], PS,
                                c["H"] // c["HK"], c["HK"], pa._num_sms(0))
                row["plan"] = dataclasses.asdict(plan)
            if dtype == torch.float32:
                row["atol"] = F32_ATOL
                ok = err <= F32_ATOL
                log(f"check: {name} {key} tokens={row['tokens']} "
                    f"max_abs_err={err:.3e} atol={F32_ATOL:.0e} pad_rows_max={pad:.1e}")
            else:
                units = bf16_rounding_units(got[:v], ref[:v])
                ctl_p = bf16_rounding_units(run_attention(paged_attention_ref, c)[:v], ref[:v])
                ctl_acc = bf16_rounding_units(bf16_accumulating_control(c), ref[:v])
                row.update(bf16_units=units, limit_units=BF16_UNITS,
                           control_p_bf16_units=ctl_p, control_acc_bf16_units=ctl_acc)
                ok = units <= BF16_UNITS < min(ctl_p, ctl_acc)
                log(f"check: {name} {key} tokens={row['tokens']} "
                    f"max_abs_err={err:.3e} bf16_units={units:.3f} (limit {BF16_UNITS}) "
                    f"controls: p_bf16={ctl_p:.1f} acc_bf16={ctl_acc:.1f} "
                    f"pad_rows_max={pad:.1e}")
            if want.startswith("mma"):
                log(f"check:   {name} {key} plan: {row['plan']}")
            out[key] = row
            if instance[want] != 1 or sum(instance.values()) != 1:
                raise AssertionError(f"{name} {key}: launched {instance}, expected one on "
                                     f"the {want} instance")
            if not (ok and pad == 0.0 and torch.isfinite(got).all()):
                raise AssertionError(f"{name} {key}: the check failed: {row}")
    if not default:
        return out
    # the exact-multiples case: kv at whole pages, stages and splits
    plan = out["exact_multiples_bfloat16"]["plan"]
    if plan["splits"] < 2 or any(k % PS or (k >= plan["split_keys"] and k % plan["split_keys"])
                                 for k in (16, 64, 512, 1024, 2048, 4096)):
        raise AssertionError(f"{name}: exact_multiples is not at split multiples: {plan}")
    return out


def check_mla_decode(device, heads: int = MLA_H, cases=None) -> dict:
    """K3, each case in float32 (simt instance) and bfloat16 (mma): at
    moe-wide-mla's decode shape (B 64 + 2 idle), at B=4 over kv 3000-8192
    (16 KV splits, the short sequences' later ones empty) plus an idle row,
    at kv lengths that are exact multiples of the page, the 64-key stage and
    the split, and at B=1 over kv 1 and over kv 17. The kernel pre-scales q
    and rounds it to its type as the reference does, so the float32 oracle is
    the plain version on that rounded q at scale 1. float32: max abs error.
    bfloat16: rounding units on the live rows, limit 1, with two controls
    above it (probabilities in bf16; a bf16 P·V accumulator per 16-key
    tile); at kv 1 the one key's weight is exactly 1, no rounding can show,
    and the output must be the latent row itself (error exactly 0). Idle rows
    (kv_len 0) must be exact zeros. Each call must land on its instance.
    ``heads``, ``cases`` ((label, seed, kv lengths)): one tensor-parallel
    rank's heads and other shapes (the mesh phase), each call on the instance
    ``ops.mla_decode._instance`` picks."""
    from llmd_tpu_torch.ops import mla_decode as md
    from llmd_tpu_torch.ops.mla_decode import mla_decode, mla_decode_ref
    from llmd_tpu_torch.ops.paged_attention import bf16_rounding_units

    multiples = [16, 64, 256, 512, 1024, 2048, 4096, 0]
    default = cases is None
    cases = cases or (
        ("decode", 3, None), ("long_context_b4", 6, [3000, 4711, 6150, 8192, 0]),
        ("exact_multiples", 9, multiples), ("b1_kv1", 10, [1]), ("b1_kv17", 11, [17]))
    out = {}
    for label, seed, kv in cases:
        for dtype in (torch.float32, torch.bfloat16):
            want = ("mma" if dtype == torch.bfloat16 else "simt") if default else \
                md._instance(dtype, heads, MLA_W)
            c = latent_decode_case(dtype, device, seed, kv, heads=heads)
            before = dict(mla_decode.launches_by_instance)
            got = run_latent_decode(mla_decode, c)
            torch.cuda.synchronize()
            instance = {k: v - before[k] for k, v in mla_decode.launches_by_instance.items()}
            q_scaled = (c["q"].float() * c["scale"]).to(dtype).float()
            ref = mla_decode_ref(q_scaled, c["pool"].float(), c["pts"].clamp(min=0),
                                 c["lens"], scale=1.0)
            torch.cuda.synchronize()
            live = c["lens"] > 0
            err = (got.float() - ref).abs().max().item()
            idle_exact = torch.count_nonzero(got[~live]).item() == 0
            key = f"{label}_{str(dtype).split('.')[-1]}"
            plan = md._plan(len(c["kv_lens"]), c["pts"].shape[1], PS, md._num_sms(0))
            row = {"max_abs_err": err, "idle_rows_exact_zero": idle_exact,
                   "sequences": int(live.sum()), "idle": int((~live).sum()),
                   "kv_tokens": int(c["kv_lens"].sum()), "instance": want,
                   "plan": dataclasses.asdict(plan)}
            if dtype == torch.float32:
                row["atol"] = F32_ATOL
                ok = err <= F32_ATOL
                note = f"atol={F32_ATOL:.0e}"
            elif int(c["kv_lens"].max()) <= 1:  # one key: the row itself, exactly
                row.update(exact=err == 0.0)
                ok = err == 0.0
                note = "one key: output must equal the latent row (error 0)"
            else:
                units = bf16_rounding_units(got[live], ref[live])
                ctl_p, ctl_acc = (bf16_rounding_units(x, ref[live])
                                  for x in latent_decode_controls(c, q_scaled))
                row.update(bf16_units=units, limit_units=BF16_UNITS,
                           control_p_bf16_units=ctl_p, control_acc_bf16_units=ctl_acc)
                ok = units <= BF16_UNITS < min(ctl_p, ctl_acc)
                note = (f"bf16_units={units:.3f} (limit {BF16_UNITS}) controls: "
                        f"p_bf16={ctl_p:.1f} acc_bf16={ctl_acc:.1f}")
            log(f"check: mla_decode {key} B={row['sequences']}+{row['idle']} idle "
                f"kv_tokens={row['kv_tokens']} max_abs_err={err:.3e} {note} "
                f"idle_rows_exact_zero={idle_exact} instance={want} splits={plan.splits}")
            out[key] = row
            if instance[want] != 1 or sum(instance.values()) != 1:
                raise AssertionError(f"mla_decode {key}: launched {instance}, expected one on "
                                     f"the {want} instance")
            if not (ok and idle_exact and torch.isfinite(got).all()):
                raise AssertionError(f"mla_decode {key}: the check failed: {row}")
    if not default:
        return out
    # kv at whole pages, stages and splits, and many splits with empty ones
    plan = out["exact_multiples_bfloat16"]["plan"]
    if plan["splits"] < 2 or any(k % PS or k % 64 or (k >= plan["split_keys"]
                                                     and k % plan["split_keys"])
                                 for k in multiples[2:]):
        raise AssertionError(f"mla_decode: exact_multiples is not at split multiples: {plan}")
    if out["long_context_b4_bfloat16"]["plan"]["splits"] < 8:
        raise AssertionError(f"mla_decode: long_context_b4 has too few splits: "
                             f"{out['long_context_b4_bfloat16']['plan']}")
    return out


def check_gemms(device, plans=None) -> dict:
    """K2 and K4 against their plain versions at moe-wide-sim widths, both
    launches of a layer (wi: D 1024 -> 2Fe 1024; wo: Fe 512 -> D 1024).
    float32: max abs error. bfloat16: in bf16 rounding units against the plain
    version in float32 on the same bf16 inputs, limit 1; a bf16-accumulating
    control must read above it. Zero-row blocks and zero-count groups must be
    exact zeros. ``plans``: other (name, cases) pairs, K2's or K4's (the
    mesh phase's rank shapes)."""
    from llmd_tpu_torch.ops.grouped_gemm import (
        grouped_gemm, grouped_gemm_ref, ragged_grouped_gemm, ragged_grouped_gemm_ref)
    from llmd_tpu_torch.ops.paged_attention import bf16_rounding_units

    fns = {"ragged_grouped_gemm": (ragged_grouped_gemm, ragged_grouped_gemm_ref),
           "grouped_gemm": (grouped_gemm, grouped_gemm_ref)}
    plans = [(name, *fns[name], cases) for name, cases in plans] if plans else (
        ("ragged_grouped_gemm", ragged_grouped_gemm, ragged_grouped_gemm_ref, (
            ("decode", lambda dt: ragged_case(32, 32, dt, device, 11)),
            ("prefill", lambda dt: ragged_case(2048, 32, dt, device, 12)),
            ("eplb", lambda dt: ragged_case(32, 64, dt, device, 13)),
            ("dead_rows", lambda dt: ragged_case(2048, 32, dt, device, 14, dead_rows=True)),
        )),
        ("grouped_gemm", grouped_gemm, grouped_gemm_ref, (
            ("decode", lambda dt: capacity_case(5, 32, dt, device, 21)),
            ("prefill", lambda dt: capacity_case(320, 32, dt, device, 22)),
        )),
    )
    out: dict = {}
    for name, kernel, plain, cases in plans:
        for label, make in cases:
            for dtype in (torch.float32, torch.bfloat16):
                c = make(dtype)
                slot, live = c["slot"], c["live"]
                index = (slot, live) if name == "ragged_grouped_gemm" else (live,)
                for which, x, w in c["launches"]:
                    got = kernel(x, w, *index)
                    torch.cuda.synchronize()
                    ref = plain(x.float(), w.float(), *index)
                    err = (got.float() - ref).abs().max().item()
                    zeros_ok = torch.count_nonzero(got[live == 0]).item() == 0
                    key = f"{label}_{which}_{str(dtype).split('.')[-1]}"
                    row = {"shape": c["shape"], "max_abs_err": err, "zero_groups_exact": zeros_ok}
                    if dtype == torch.float32:
                        row["atol"] = GEMM_F32_ATOL
                        ok = err <= GEMM_F32_ATOL
                        note = f"atol={GEMM_F32_ATOL:.0e}"
                    else:
                        units = bf16_rounding_units(got, ref)
                        ctl = bf16_rounding_units(
                            gemm_bf16_control(x, w.index_select(0, slot.long()), live), ref)
                        row.update(bf16_units=units, limit_units=BF16_UNITS,
                                   control_acc_bf16_units=ctl)
                        ok = units <= BF16_UNITS < ctl
                        note = (f"bf16_units={units:.3f} (limit {BF16_UNITS}) "
                                f"control acc_bf16={ctl:.1f}")
                    log(f"check: {name} {key} {c['shape']} max_abs_err={err:.3e} {note} "
                        f"zero_groups_exact={zeros_ok}")
                    out.setdefault(name, {})[key] = row
                    if not (ok and zeros_ok and torch.isfinite(got).all()):
                        raise AssertionError(f"{name} {key}: the check failed: {row}")
    return out


def time_attention(device, latent: bool = False) -> dict:
    """K1 in bf16 beside its bound, its plain version and the library call.
    llama-1b heads on the mma instance, each shape also timed on the simt
    instance on the same inputs (the kernel before the mma instance):
    ``decode`` B=64 (SDPA over K/V gathered dense), ``decode_b8`` (B=8 at kv
    3072-5120, more K/V than L2 holds) and ``mixed`` (SDPA over K/V gathered
    dense per sequence, queries packed per sequence under a causal mask)
    and ``verify`` (the speculative verify batch, 64 x 5 query tokens; SDPA
    as for mixed). With ``latent``, the single-plane instance at moe-wide-mla's mixed shape
    (SDPA over the latent gathered dense per sequence, K = V broadcast to the
    16 heads, queries packed per sequence under a causal mask)."""
    from llmd_tpu_torch.ops import paged_attention as pa

    dtype = torch.bfloat16
    if latent:
        c = mixed_case(dtype, device, latent=True)
        shapes = {"mixed": (c, sdpa_latent(c), (
            "mixed 3x128-token chunks (kv 128/1000/2048) + 32 decode rows bf16 "
            "(H16, one latent plane W160, ps16)"))}
    else:
        cases = {"decode": (decode_case(dtype, device), sdpa_dense,
                            "decode B=64 q_len=1 kv_len 128-1024 bf16 (H32 Hk8 D64 ps16)"),
                 "decode_b8": (long_decode_case(dtype, device), sdpa_dense,
                               "decode B=8 q_len=1 kv_len 3072-5120 bf16 (H32 Hk8 D64 ps16)"),
                 "mixed": (mixed_case(dtype, device), sdpa_packed,
                           "mixed 3x128-token chunks (kv 128/1000/2048) + 32 decode rows "
                           "bf16 (H32 Hk8 D64 ps16)"),
                 "verify": (verify_case(dtype, device), sdpa_packed,
                            "verify B=64 q_len=5 kv_len 128-1024 bf16 (H32 Hk8 D64 ps16)")}
        shapes = {k: (c, lib(c), shape) for k, (c, lib, shape) in cases.items()}
    name = "paged_attention_latent" if latent else "paged_attention"
    out = {}
    for label, (c, library, shape) in shapes.items():
        group = pa._check(c["q"], c["pool"], c["pts"], c["lens"], c["cu"], c["ns"])
        instance = pa._instance(dtype, c["planes"], c["W"], group)
        ms = cuda_ms(lambda: run_attention(pa.paged_attention, c))
        plain_ms = cuda_ms(lambda: run_attention(pa.paged_attention_ref, c), reps=5, inner=2)
        library_ms = cuda_ms(library)
        bound_ms, bound_by = attention_bound(c, dtype)
        row = {"shape": shape, "instance": instance, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
               "kv_tokens": int(c["kv_lens"].sum()), "query_tokens": int(c["q_lens"].sum())}
        extra = ""
        if instance == "mma":
            row["simt_ms"] = cuda_ms(lambda: pa._launch(
                c["q"], c["pool"], c["pts"], c["lens"], c["cu"], c["ns"], c["scale"], group,
                "simt"))
            row["plan"] = dataclasses.asdict(pa._plan(
                c["q"].shape[0], c["pts"].shape[0], c["pts"].shape[1], PS, group, c["HK"],
                pa._num_sms(0)))
            extra = f" simt_ms={row['simt_ms']:.4f} splits={row['plan']['splits']}"
        log(f"time: {name} {label} {shape.split(' bf16')[0]} bf16 instance={instance} "
            f"ms={ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) plain_ms={plain_ms:.4f} "
            f"library_ms(sdpa)={library_ms:.4f}{extra} roofline_share={bound_ms / ms:.3f}")
        out[label] = row
    return out


def device_ms_by_kernel(fn, calls: int = 20) -> dict:
    """Device milliseconds per call of ``fn`` by kernel name, from
    ``torch.profiler`` over ``calls`` calls (after a warm-up): a wrapper that
    launches two kernels (a split-KV kernel and its merge) shows each."""
    from torch.profiler import ProfilerActivity, profile

    from llmd_tpu_torch.tools.profile_engine import TRACE_MARGIN_S

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)  # no record of the calls falls outside the trace
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and "cuda" in str(getattr(e, "device_type", "")).lower():
            name = re.search(r"(\w+)\s*[<(]", e.key.replace("(anonymous namespace)::", ""))
            out[name.group(1) if name else e.key[:60]] = us / 1e3 / calls
    return out


def time_mla_decode(device) -> dict:
    """K3 in bf16 on the mma instance beside its bytes bound, its plain
    version, its simt instance on the same inputs and SDPA over the latent
    gathered dense (K = V broadcast to the 16 heads, gather included): at
    moe-wide-mla's decode shape (``decode``: B=64 + 2 idle, kv 128-1024) and
    at small batch over long contexts (``decode_b8``: B=8 at kv 3072-5120,
    where the keys are split 16 ways). The split kernel and its merge are
    also timed apart (torch.profiler, device time per call)."""
    from llmd_tpu_torch.ops import mla_decode as md

    dtype = torch.bfloat16
    rng = np.random.default_rng(4)
    shapes = {
        "decode": (latent_decode_case(dtype, device),
                   "decode B=64+2 idle kv_len 128-1024 bf16 (H16, latent W160, ps16)"),
        "decode_b8": (latent_decode_case(dtype, device, 4, rng.integers(3072, 5121, 8)),
                      "decode B=8 kv_len 3072-5120 bf16 (H16, latent W160, ps16)"),
    }
    out = {}
    for label, (c, shape) in shapes.items():
        pts = c["pts"].clamp(min=0)
        instance = md._instance(dtype, MLA_H, MLA_W)
        plan = md._plan(len(c["kv_lens"]), pts.shape[1], PS, md._num_sms(0))
        ms = cuda_ms(lambda: run_latent_decode(md.mla_decode, c))
        simt_ms = cuda_ms(lambda: md._launch(c["q"], c["pool"], pts, c["lens"], c["scale"],
                                              "simt"))
        plain_ms = cuda_ms(lambda: run_latent_decode(md.mla_decode_ref, c), reps=5, inner=2)
        library_ms = cuda_ms(sdpa_latent(c))
        bound_ms, bound_by = latent_decode_bound(c, dtype)
        parts = device_ms_by_kernel(lambda: run_latent_decode(md.mla_decode, c))
        row = {"shape": shape, "instance": instance, "ms": ms, "simt_ms": simt_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "kv_tokens": int(c["kv_lens"].sum()),
               "plan": dataclasses.asdict(plan), "device_ms_by_kernel": parts}
        log(f"time: mla_decode {label} {shape.split(' bf16')[0]} bf16 instance={instance} "
            f"ms={ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) plain_ms={plain_ms:.4f} "
            f"library_ms(sdpa dense)={library_ms:.4f} simt_ms={simt_ms:.4f} "
            f"splits={plan.splits} roofline_share={bound_ms / ms:.3f}")
        log(f"time:   mla_decode {label} profiler device ms per call: "
            + " ".join(f"{k}={v:.4f}" for k, v in parts.items()))
        out[label] = row
    return out


def time_gemms(device) -> dict:
    """K2 and K4 in bf16 at the decode and prefill shapes of moe-wide-sim
    (decode T=32 sequences, prefill T=2048 tokens), both launches of a layer
    (wi, D 1024 -> 2Fe 1024: keys ``decode`` / ``prefill``; wo, Fe 512 -> D
    1024: ``decode_wo`` / ``prefill_wo``), beside the bound, the plain version
    and one library call: ``torch.bmm`` over the weights gathered per block
    with ``index_select`` (gather included) for K2, ``torch.bmm`` for K4."""
    from llmd_tpu_torch.ops.grouped_gemm import (
        _instance, grouped_gemm, grouped_gemm_ref, ragged_grouped_gemm,
        ragged_grouped_gemm_ref)

    dtype = torch.bfloat16
    cases = (
        ("ragged_grouped_gemm", "decode", ragged_case(32, 32, dtype, device, 11)),
        ("ragged_grouped_gemm", "prefill", ragged_case(2048, 32, dtype, device, 12)),
        ("grouped_gemm", "decode", capacity_case(5, 32, dtype, device, 21)),
        ("grouped_gemm", "prefill", capacity_case(320, 32, dtype, device, 22)),
    )
    out: dict = {}
    for name, label, c in cases:
        slot, live = c["slot"], c["live"]
        for which, x, w in c["launches"]:
            if name == "ragged_grouped_gemm":
                slot_l = slot.long()
                ms = cuda_ms(lambda: ragged_grouped_gemm(x, w, slot, live))
                plain_ms = cuda_ms(lambda: ragged_grouped_gemm_ref(x, w, slot, live),
                                   reps=5, inner=2)
                library_ms = cuda_ms(lambda: torch.bmm(x, w.index_select(0, slot_l)))
                lib = "bmm over index_select-gathered weights, gather included"
                n_index = 2
            else:
                ms = cuda_ms(lambda: grouped_gemm(x, w, live))
                plain_ms = cuda_ms(lambda: grouped_gemm_ref(x, w, live), reps=5, inner=2)
                library_ms = cuda_ms(lambda: torch.bmm(x, w))
                lib = "bmm"
                n_index = 1
            bound_ms, bound_by, work = gemm_bound(x, w, slot, live, dtype, n_index)
            instance = _instance(dtype, x.shape[2], w.shape[2])
            row = {"shape": f"{c['shape']} {which} D={x.shape[2]} F={w.shape[2]} bf16",
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms, "library": lib,
                   "instance": instance, **work}
            log(f"time: {name} {label} {row['shape']} instance={instance} ms={ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by}) plain_ms={plain_ms:.4f} "
                f"library_ms({lib})={library_ms:.4f} roofline_share={bound_ms / ms:.3f}")
            key = label if which == "wi" else f"{label}_{which}"
            out.setdefault(name, {})[key] = row
    return out


def _post(url: str, body: dict, timeout: float = 600.0) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(url: str) -> tuple[int, dict]:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def counters() -> tuple[dict, dict]:
    """(kernel wrappers, plain versions) by name, each with its counter's
    attribute name."""
    from llmd_tpu_torch.ops import grouped_gemm as gg
    from llmd_tpu_torch.ops import mla_decode as md
    from llmd_tpu_torch.ops import paged_attention as pa

    kernels = {"paged_attention": (pa.paged_attention, "launches"),
               "mla_decode": (md.mla_decode, "launches"),
               "ragged_grouped_gemm": (gg.ragged_grouped_gemm, "launches"),
               "grouped_gemm": (gg.grouped_gemm, "launches")}
    plain = {"paged_attention_ref": (pa.paged_attention_ref, "calls"),
             "mla_decode_ref": (md.mla_decode_ref, "calls"),
             "ragged_grouped_gemm_ref": (gg.ragged_grouped_gemm_ref, "launches"),
             "grouped_gemm_ref": (gg.grouped_gemm_ref, "launches")}
    return kernels, plain


def instanced() -> dict:
    """The wrappers that count their launches per kernel instance: K1 and K3
    (``"mma"``, ``"simt"``), K2 and K4 (``"wgmma"``, ``"simt"``)."""
    from llmd_tpu_torch.tools.bench import kernel_wrappers

    return kernel_wrappers()


def instance_counts() -> dict:
    """Launches of K1, K3, K2 and K4 per kernel instance."""
    return {name: dict(fn.launches_by_instance) for name, fn in instanced().items()}


def zero_counts() -> None:
    for group in counters():
        for fn, attr in group.values():
            setattr(fn, attr, 0)
    for fn in instanced().values():
        fn.launches_by_instance = dict.fromkeys(fn.launches_by_instance, 0)


def read_counts() -> tuple[dict, dict]:
    return tuple({name: getattr(fn, attr) for name, (fn, attr) in group.items()}
                 for group in counters())


def phase_engine(device, card: str, model: str = "llama-1b", n_requests: int = 8,
                 max_tokens: int = 32, prompt_range=(64, 512), seed: int = 0,
                 engine_kw: "dict | None" = None,
                 per_layer: "dict | None" = None, label: str = "",
                 attn_instance: str = "mma") -> dict:
    """Serve ``n_requests`` greedy completions over HTTP. ``per_layer``: for
    each kernel of this path, (launches per layer and forward, the program
    whose forwards launch it: "all", "unified" or "decode"); every kernel's
    count must equal that times layers × that program's forwards (0 for
    kernels off the path), and no plain version may run. The served weights
    are bf16: every K2 / K4 launch must be on the wgmma instance and every K1
    and K3 launch on ``attn_instance`` (``"mma_fp8"`` over an fp8 pool)."""
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.engine import EngineStats
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.models import get_model_config

    cfg = get_model_config(model)
    kw = dict(page_size=PS, num_pages=2048, max_model_len=2048, max_batch_size=32,
              prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)
    kw.update(engine_kw or {})
    t0 = time.perf_counter()
    server = EngineServer(cfg, EngineConfig(**kw), host="127.0.0.1", port=0,
                          seed=seed, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    prompts = [bytes(rng.choice(letters, int(n))).decode()
               for n in rng.integers(prompt_range[0], prompt_range[1] + 1, n_requests)]
    server.start()
    try:
        base = f"http://{server.address}"
        assert _get(base + "/health") == (200, {"status": "ok"})
        # warm-up request (cuBLAS handles, allocator), not measured
        _post(base + "/v1/completions", {"prompt": "warm up", "max_tokens": 2,
                                         "temperature": 0})
        eng = server.engine
        eng.stats = EngineStats(attn_backend=eng.attn_backend, moe_backend=eng.moe_backend,
                                moe_dispatch=eng.moe_dispatch)
        zero_counts()
        results: list = [None] * n_requests

        def one(i: int) -> None:
            try:
                results[i] = _post(base + "/v1/completions", {
                    "model": server.model_name, "prompt": prompts[i],
                    "max_tokens": max_tokens, "temperature": 0})
            except Exception as e:  # noqa: BLE001 — reported below as a failed request
                results[i] = e

        t1 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(n_requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t1
        launches, plain_calls = read_counts()
        by_instance = instance_counts()
        st = eng.stats
    finally:
        server.stop()
    bad = [(i, r) for i, r in enumerate(results)
           if not (isinstance(r, tuple) and r[0] == 200)
           or not (r[1]["usage"]["completion_tokens"] == max_tokens
                   or r[1]["choices"][0]["finish_reason"] == "stop")]
    if bad:
        raise AssertionError(f"engine: failed requests {bad[:3]}")
    completion = sum(r[1]["usage"]["completion_tokens"] for r in results)
    prompt_toks = sum(r[1]["usage"]["prompt_tokens"] for r in results)
    per_layer = per_layer if per_layer is not None else {"paged_attention": (1, "all")}
    forwards = {"unified": st.n_unified_steps, "decode": st.n_decode_iterations,
                "all": st.n_unified_steps + st.n_decode_iterations}
    expect = {}
    for name in launches:
        n, program = per_layer.get(name, (0, "all"))
        expect[name] = n * cfg.num_layers * forwards[program]
    row = {
        "card": card, "model": model, "label": label, "requests": n_requests,
        "setup_s": setup_s,
        "wall_s": wall, "prompt_tokens": prompt_toks, "completion_tokens": completion,
        "output_tok_s": completion / wall,
        "prefill_tok_s": st.total_prefill_tokens / max(st.time_prefill_steps, 1e-9),
        "decode_tok_s": st.decode_tokens_fused / max(st.time_decode_steps, 1e-9),
        "unified_steps": st.n_unified_steps, "decode_calls": st.n_decode_calls,
        "decode_iterations": st.n_decode_iterations,
        "launches": launches, "expected_launches": expect, "plain_calls": plain_calls,
        "launches_by_instance": by_instance, "attn_backend": st.attn_backend,
        "moe_dispatch": st.moe_dispatch, "moe_backend": st.moe_backend,
        "moe_dropped_tokens": st.moe_dropped_tokens, "eplb_rebalances": st.eplb_rebalances,
        "engine_config": {k: repr(v) if k == "eplb" else v for k, v in kw.items()},
    }
    log(f"engine: {model} {label} on {card}: {n_requests} requests wall_s={wall:.3f} "
        f"prefill_tok_s={row['prefill_tok_s']:.1f} decode_tok_s={row['decode_tok_s']:.1f} "
        f"output_tok_s={row['output_tok_s']:.1f} unified_steps={st.n_unified_steps} "
        f"decode_calls={st.n_decode_calls} decode_iterations={st.n_decode_iterations}")
    log(f"engine:   launches={launches} plain_calls={plain_calls} "
        f"launches_by_instance={by_instance} "
        f"attn_backend={st.attn_backend!r} moe_dispatch={st.moe_dispatch!r} "
        f"moe_dropped_tokens={st.moe_dropped_tokens} eplb_rebalances={st.eplb_rebalances}")
    if device.type == "cuda":
        missing = [n for n, (v, _) in per_layer.items() if v and launches[n] == 0]
        if missing or any(plain_calls.values()):
            raise AssertionError(f"engine {label}: kernels {missing} never launched or "
                                 f"plain versions ran {plain_calls}: the path did not "
                                 "run its kernels")
        if launches != expect:
            raise AssertionError(f"engine {label}: launches {launches}, expected {expect} "
                                 f"({per_layer} per layer per forward)")
        # the served weights are bf16: every K1 / K3 / K2 / K4 launch on its bf16 instance
        want = {"paged_attention": attn_instance, "mla_decode": attn_instance,
                "ragged_grouped_gemm": "wgmma", "grouped_gemm": "wgmma"}
        off = {n: c for n, c in by_instance.items()
               if c != {k: (launches[n] if k == want[n] else 0) for k in c}}
        if off:
            raise AssertionError(f"engine {label}: launches {launches} not all on the "
                                 f"instances {want}: {off}")
    return row


def _served_run(device, cfg, kw: dict, prompts, max_tokens: int, seed: int,
                decode_graph: bool) -> dict:
    """One engine of ``cfg`` (random weights from ``seed``; ``kw`` its
    EngineConfig) through ``generate`` after a warm-up that captures its
    decode program (``decode_graph``) or runs it eagerly: greedy tokens,
    launch counts per kernel and instance, plain calls and the engine's
    counts over the measured call."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine

    eng = LLMEngine(cfg, EngineConfig(**kw), seed=seed, device=device,
                    decode_graph=decode_graph)
    eng.generate([[1, 2, 3]], SamplingParams(max_tokens=2 * kw["decode_steps"] + 2,
                                             temperature=0.0))  # capture / warm up
    st0 = dataclasses.replace(eng.stats)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompts, SamplingParams(max_tokens=max_tokens, temperature=0.0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    st = eng.stats
    run = {"tokens": out, "launches": launches, "plain_calls": plain_calls,
           "launches_by_instance": instance_counts(), "wall_s": wall,
           "decode_tok_s": (st.decode_tokens_fused - st0.decode_tokens_fused)
           / max(st.time_decode_steps - st0.time_decode_steps, 1e-9),
           "unified_steps": st.n_unified_steps - st0.n_unified_steps,
           "decode_iterations": st.n_decode_iterations - st0.n_decode_iterations,
           "decode_calls": st.n_decode_calls - st0.n_decode_calls,
           "chained_calls": st.n_chained_dispatches - st0.n_chained_dispatches,
           "replays": st.decode_graph_replays - st0.decode_graph_replays,
           "captures": st.decode_graph_captures, "capture_s": st.decode_graph_capture_s,
           "moe_dropped_tokens": st.moe_dropped_tokens - st0.moe_dropped_tokens,
           "eplb_rebalances": st.eplb_rebalances - st0.eplb_rebalances,
           "moe_backend": eng.moe_backend}
    del eng
    torch.cuda.empty_cache()
    return run


def phase_graph(device, card: str, model: str = "llama-1b", n_requests: int = 8,
                max_tokens: int = 32, seed: int = 0, engine_kw: "dict | None" = None,
                label: str = "") -> dict:
    """The decode program replayed from its CUDA graph against the same
    program run eagerly on the card: two engines of the same seed (same
    weights), the reference's pipelined dispatch on, the same greedy prompts
    through ``generate``. Tokens must be identical, and so must every
    kernel's launch count (the graph's: its captured launches times its
    replays) and, on MoE, the dropped copies and EPLB rebalances; no plain
    version may run. Then ``profile_engine`` profiles a batch of 8 in both
    modes: host launch calls and device kernels per decode iteration, and
    the K1/K3/K2/K4 launches that the wrappers' counters credit in the
    profiled window (under replay: the capture's launches once a replay)
    held against the launches of those kernels that the profiler saw run on
    the device."""
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.transformer import init_params
    from llmd_tpu_torch.tools.profile_engine import profile_batch

    cfg = get_model_config(model)
    kw = dict(page_size=PS, num_pages=2048, max_model_len=2048, max_batch_size=32,
              prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)
    kw.update(engine_kw or {})
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, n_requests)]
    runs = {mode: _served_run(device, cfg, kw, prompts, max_tokens, seed, mode == "graph")
            for mode in ("graph", "eager")}
    g, e = runs["graph"], runs["eager"]
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    prof = {mode: profile_batch(cfg, params, 8, 256, kw["decode_steps"], 5, 3, seed,
                                kw.get("moe_dispatch", "auto"), decode_graph=mode == "graph")
            for mode in ("graph", "eager")}
    del params
    torch.cuda.empty_cache()
    same = {"tokens": g["tokens"] == e["tokens"], "launches": g["launches"] == e["launches"],
            "launches_by_instance": g["launches_by_instance"] == e["launches_by_instance"],
            "moe_dropped_tokens": g["moe_dropped_tokens"] == e["moe_dropped_tokens"],
            "eplb_rebalances": g["eplb_rebalances"] == e["eplb_rebalances"]}
    row = {"card": card, "model": model, "label": label, "requests": n_requests,
           "same": same, "engine_config": {k: repr(v) for k, v in kw.items()},
           **{f"{m}_{k}": v for m, r in runs.items() for k, v in r.items() if k != "tokens"},
           **{f"profile_{m}": {k: v for k, v in r.items() if k not in (
               "top_kernels", "top_host_ops")} for m, r in prof.items()}}
    log(f"graph: {model} {label} on {card}: captures={g['captures']} "
        f"capture_s={g['capture_s']:.3f} replays={g['replays']} "
        f"decode_calls={g['decode_calls']} chained={g['chained_calls']} same={same} "
        f"plain_calls={g['plain_calls']}/{e['plain_calls']}")
    log(f"graph:   {model} {label} on {card}: decode_tok_s replayed={g['decode_tok_s']:.1f} "
        f"eager={e['decode_tok_s']:.1f}; "
        f"batch 8 profile: host_launch_calls/iter replayed="
        f"{prof['graph']['host_launch_calls_per_iteration']:.2f} eager="
        f"{prof['eager']['host_launch_calls_per_iteration']:.2f} "
        f"({prof['graph']['host_launch_calls']} / {prof['eager']['host_launch_calls']}), "
        f"device_kernels/iter replayed={prof['graph']['device_kernels_per_iteration']} "
        f"eager={prof['eager']['device_kernels_per_iteration']}, device_busy_share "
        f"replayed={prof['graph']['device_busy_share_profiled']} "
        f"eager={prof['eager']['device_busy_share_profiled']}, decode_tok_s replayed="
        f"{prof['graph']['decode_tok_s']:.1f} eager={prof['eager']['decode_tok_s']:.1f}")
    if not all(same.values()) or any(g["plain_calls"].values()) or any(
            e["plain_calls"].values()):
        raise AssertionError(f"graph {model} {label}: replayed and eager runs differ "
                             f"({same}) or plain versions ran ({g['plain_calls']}, "
                             f"{e['plain_calls']})")
    for mode, r in prof.items():
        counted, seen = r["kernel_launches_counted"], r["kernel_launches_on_device"]
        log(f"graph:   {model} {label} {mode} profile window: replays="
            f"{r['profiled_graph_replays']} launches counted={counted} on device={seen}")
        if counted != seen or not any(seen.values()) or (
                (r["profiled_graph_replays"] > 0) != (mode == "graph")):
            raise AssertionError(f"graph {model} {label} {mode}: the counters credit "
                                 f"{counted} launches, the device ran {seen} "
                                 f"({r['profiled_graph_replays']} replays)")
    if g["captures"] != 1 or g["replays"] != g["decode_calls"] or e["replays"] or e["captures"]:
        raise AssertionError(f"graph {model} {label}: {g['captures']} captures and "
                             f"{g['replays']} replays for {g['decode_calls']} calls "
                             f"(eager: {e['captures']} / {e['replays']})")
    return row


class IdTokenizer:
    """The surface phase's tokenizer: a prompt's text is its UTF-8 bytes (ids
    below 256, as the byte tokenizer's), and every id decodes to a character
    of its own (U+10000 + id), so a text holds its tokens one for one and a
    joined stream is held to a non-streamed text token for token."""

    bos_id, eos_id = 256, 257

    def __init__(self, vocab_size: int) -> None:
        self.vocab_size = vocab_size

    def encode(self, text: str, add_bos: bool = False) -> list:
        return ([self.bos_id] if add_bos else []) + list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return "".join(chr(0x10000 + i) for i in ids)


def _http(method: str, url: str, body: "dict | None" = None,
          headers: "dict | None" = None) -> tuple:
    """(status, headers, body bytes), error statuses included; an SSE body
    comes back as its ``data:`` payloads, ``[DONE]`` last."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        resp = urllib.request.urlopen(req, timeout=600)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()
    with resp:
        if resp.headers.get("Content-Type", "").startswith("text/event-stream"):
            events = [line[6:].strip() for line in resp if line.startswith(b"data: ")]
            return resp.status, dict(resp.headers), events
        return resp.status, dict(resp.headers), resp.read()


class _KVSubscriber:
    """A pyzmq SUB on ``kv@`` in a thread: every batch, decoded, in order."""

    def __init__(self, port: int) -> None:
        import zmq

        self._ctx = zmq.Context()
        self._sock = self._ctx.socket(zmq.SUB)
        self._sock.setsockopt(zmq.SUBSCRIBE, b"kv@")
        self._sock.connect(f"tcp://127.0.0.1:{port}")
        self.batches: list = []  # (topic, seq, events)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        time.sleep(0.3)  # slow joiner: the subscription reaches the publisher

    def _run(self) -> None:
        from llmd_tpu_torch.core.kv_events import decode_event_batch

        while not self._stop.is_set():
            if self._sock.poll(50):
                topic, payload = self._sock.recv_multipart()
                self.batches.append((topic.decode(), *decode_event_batch(payload)))

    def stop(self) -> None:
        time.sleep(0.2)  # the publisher's last flush (every 10 ms) lands
        self._stop.set()
        self._thread.join(timeout=10)
        self._sock.close(0)
        self._ctx.term()


def phase_surface(device, card: str, model: str = "llama-1b", seed: int = 0) -> dict:
    """The serving surface that llm-d's router drives, on the card: llama-1b
    at full width, bf16 weights, the engine phase's settings, the KV-event
    publisher on a free port.

    A SUB subscribes to ``kv@`` before any request. One request warms the
    512-token prefix into the cache and the decode graph up; ``/metrics`` is
    read. Then 12 requests concurrently: 8 completions of that prefix and a
    64-256-token tail (half streamed), 2 chat requests (one streamed) and 2
    repeats of earlier prompts (one streamed), 32 greedy tokens each.
    ``/metrics`` again, through the port's metrics contract: block size and
    count equal the engine's, both request gauges present, and the deltas of
    ``prefill_tokens`` and ``decode_tokens`` equal ``EngineStats``'s, that of
    ``prefix_cached_tokens`` the responses' ``cached_tokens`` (above 0).
    K1 ran once per layer of every forward, all on ``mma``, no plain version.
    Each streamed request is then sent alone, streamed and not: the joined
    stream equals the text (which holds one character a token). The KV
    events: every prompt's full blocks were stored under
    ``block_keys_for_tokens(prompt, page_size)``, and ``seq`` has no gap.
    ``/drain`` gives 200, then ``/health`` and ``/v1/completions`` 503, and
    ``{"enable": false}`` reopens both."""
    from llmd_tpu_torch.core.kv_events import BlockStored, block_keys_for_tokens
    from llmd_tpu_torch.core.metrics_contract import (
        StdMetric, map_engine_metrics, parse_prometheus)
    from llmd_tpu_torch.core.request import flatten_messages
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.models import get_model_config

    cfg = get_model_config(model)
    kw = dict(page_size=PS, num_pages=2048, max_model_len=2048, max_batch_size=32,
              prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)
    server = EngineServer(cfg, EngineConfig(**kw), host="127.0.0.1", port=0,
                          kv_events_port=0, tokenizer=IdTokenizer(cfg.vocab_size),
                          seed=seed, device=device)
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)

    def text(n: int) -> str:
        return bytes(rng.choice(letters, int(n))).decode()

    prefix = text(512)
    tails = [text(n) for n in rng.integers(64, 257, 9)]
    greedy = {"max_tokens": 32, "temperature": 0, "ignore_eos": True}
    chat = [[{"role": "system", "content": prefix}, {"role": "user", "content": tails[8]}],
            [{"role": "user", "content": tails[0]}]]
    wave = ([("/v1/completions", {"prompt": prefix + tails[i], "stream": i % 2 == 1})
             for i in range(8)]
            + [("/v1/chat/completions", {"messages": chat[0], "stream": False}),
               ("/v1/chat/completions", {"messages": chat[1], "stream": True}),
               ("/v1/completions", {"prompt": prefix + tails[0], "stream": False}),
               ("/v1/completions", {"prompt": prefix + tails[3], "stream": True})])
    server.start()
    sub = _KVSubscriber(server.kv_events_port)
    base = f"http://{server.address}"
    eng = server.engine
    try:
        def scrape() -> tuple:
            status, _, body = _http("GET", base + "/metrics")
            assert status == 200, status
            samples = parse_prometheus(body.decode())
            return map_engine_metrics("vllm", samples), {
                n: v for n, labels, v in samples if not labels}

        warm = prefix + text(40)
        assert _http("POST", base + "/v1/completions", {"prompt": warm, **greedy})[0] == 200
        std0, flat0 = scrape()
        st0 = dataclasses.replace(eng.stats)
        zero_counts()
        results: list = [None] * len(wave)

        def one(i: int) -> None:
            path, body = wave[i]
            try:
                results[i] = _http("POST", base + path, {**body, **greedy})
            except Exception as e:  # noqa: BLE001 — reported below as a failed request
                results[i] = e

        t1 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(wave))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t1
        launches, plain_calls = read_counts()
        by_instance = instance_counts()
        st = dataclasses.replace(eng.stats)
        std1, flat1 = scrape()
        bad = [(i, r) for i, r in enumerate(results)
               if not (isinstance(r, tuple) and r[0] == 200)]
        if bad:
            raise AssertionError(f"surface: failed requests {bad[:3]}")

        def answer(result, stream: bool, is_chat: bool) -> tuple:
            """(text, usage) of one response."""
            if not stream:
                payload = json.loads(result[2])
                c = payload["choices"][0]
                return (c["message"]["content"] if is_chat else c["text"]), payload["usage"]
            events = result[2]
            assert events[-1] == b"[DONE]", events[-1:]
            chunks = [json.loads(e) for e in events[:-1]]
            assert all(c["choices"][0]["finish_reason"] is None for c in chunks[:-1])
            assert chunks[-1]["choices"][0]["finish_reason"] == "length"
            return "".join(c["choices"][0]["delta"]["content"] if is_chat
                           else c["choices"][0]["text"] for c in chunks), chunks[-1]["usage"]

        answers = [answer(r, body["stream"], "messages" in body)
                   for r, (_, body) in zip(results, wave)]
        for (txt, usage), (_, body) in zip(answers, wave):
            if not (len(txt) == usage["completion_tokens"] == greedy["max_tokens"]):
                raise AssertionError(f"surface: {len(txt)} characters for "
                                     f"{usage['completion_tokens']} tokens ({body['stream']})")
        completion = sum(u["completion_tokens"] for _, u in answers)
        cached = sum(u["cached_tokens"] for _, u in answers)
        # each streamed request alone, streamed and not (the same batch and
        # cache state): the joined stream equals the text, token for token
        twins = []
        for i, (path, body) in enumerate(wave):
            if body["stream"]:
                pair = [answer(_http("POST", base + path, {**body, **greedy, "stream": flag}),
                               flag, "messages" in body) for flag in (True, False)]
                twins.append(pair[0] == pair[1])
        # drain: admission closes, /health says so, {"enable": false} reopens
        drain = _http("POST", base + "/drain?timeout_s=30")
        codes = {"drain": drain[0], "drain_status": json.loads(drain[2])["status"],
                 "health_draining": _http("GET", base + "/health")[0],
                 "completion_draining": _http("POST", base + "/v1/completions",
                                              {"prompt": "x", **greedy})[0],
                 "reopen": _http("POST", base + "/drain", {"enable": False})[0],
                 "health": _http("GET", base + "/health")[0],
                 "completion": _http("POST", base + "/v1/completions",
                                     {"prompt": "x", **greedy})[0]}
        renders = {}
        for path, body in [("/v1/completions", {"prompt": warm})] + wave:
            key = "messages" if "messages" in body else "prompt"
            want = IdTokenizer(0).encode(flatten_messages(body[key]) if key == "messages"
                                         else body[key])
            status, _, got = _http("POST", base + path + "/render", body)
            renders[json.dumps(body[key])] = want
            if status != 200 or json.loads(got)["prompt_token_ids"] != want:
                raise AssertionError(f"surface: render of {path} differs")
    finally:
        sub.stop()
        server.stop()
    topic = f"kv@{server.address}@{server.model_name}"
    seqs = [b[1] for b in sub.batches]
    stored = {h for _, _, evs in sub.batches for e in evs if isinstance(e, BlockStored)
              for h in e.block_hashes}
    missing = {p[:40]: n for p, ids in renders.items()
               if (n := sum(k not in stored for k in block_keys_for_tokens(ids, PS)))}
    forwards = (st.n_unified_steps - st0.n_unified_steps
                + st.n_decode_iterations - st0.n_decode_iterations)
    deltas = {
        "prefill_tokens": (flat1["llmd_tpu:prefill_tokens_total"]
                           - flat0["llmd_tpu:prefill_tokens_total"],
                           st.total_prefill_tokens - st0.total_prefill_tokens),
        "decode_tokens": (flat1["llmd_tpu:decode_tokens_total"]
                          - flat0["llmd_tpu:decode_tokens_total"],
                          st.total_decode_tokens - st0.total_decode_tokens),
        "prefix_cached_tokens": (flat1["llmd_tpu:engine_prefix_cached_tokens_total"]
                                 - flat0["llmd_tpu:engine_prefix_cached_tokens_total"],
                                 cached),
    }
    row = {"card": card, "model": model, "requests": len(wave), "wall_s": wall,
           "completion_tokens": completion, "output_tok_s": completion / wall,
           "metrics_before": std0, "metrics_after": std1, "deltas": deltas,
           "launches": launches, "plain_calls": plain_calls,
           "launches_by_instance": by_instance, "forwards": forwards,
           "twins_equal": twins, "codes": codes, "kv_batches": len(seqs),
           "kv_stored_blocks": len(stored), "kv_prompts_missing_blocks": missing,
           "engine_config": kw}
    log(f"surface: {model} on {card}: {len(wave)} requests wall_s={wall:.3f} "
        f"output_tok_s={completion / wall:.1f} completion_tokens={completion} "
        f"cached_tokens={cached} forwards={forwards}")
    log(f"surface:   metrics before={std0} after={std1} deltas (metric, engine)={deltas}")
    log(f"surface:   kv events: {len(seqs)} batches, seq {seqs[:1]}..{seqs[-1:]}, "
        f"{len(stored)} blocks stored, prompts missing blocks {missing}; "
        f"streamed = alone non-streamed {twins}; codes {codes}")
    log(f"surface:   launches={launches} plain_calls={plain_calls} "
        f"launches_by_instance={by_instance}")
    for std in (std0, std1):
        if (std.get(StdMetric.BLOCK_SIZE), std.get(StdMetric.NUM_BLOCKS)) != (
                PS, kw["num_pages"]) or not {StdMetric.QUEUED_REQUESTS,
                                             StdMetric.RUNNING_REQUESTS} <= std.keys():
            raise AssertionError(f"surface: /metrics maps to {std}")
    if any(m != e for m, e in deltas.values()) or deltas["prefix_cached_tokens"][0] <= 0:
        raise AssertionError(f"surface: metric deltas {deltas} (metric, engine)")
    if not all(twins) or len(twins) != 6:
        raise AssertionError(f"surface: streamed texts differ from non-streamed {twins}")
    if seqs != list(range(1, len(seqs) + 1)) or missing or not seqs or any(
            b[0] != topic for b in sub.batches):
        raise AssertionError(f"surface: KV events seq {seqs}, prompts missing blocks "
                             f"{missing}, topics {sorted({b[0] for b in sub.batches})}")
    if codes != {"drain": 200, "drain_status": "drained", "health_draining": 503,
                 "completion_draining": 503, "reopen": 200, "health": 200,
                 "completion": 200}:
        raise AssertionError(f"surface: drain codes {codes}")
    k1 = by_instance["paged_attention"]
    if (any(plain_calls.values()) or launches["paged_attention"] != cfg.num_layers * forwards
            or k1 != {**dict.fromkeys(k1, 0), "mma": launches["paged_attention"]}):
        raise AssertionError(f"surface: K1 launches {launches} ({k1}) for {forwards} "
                             f"forwards, plain calls {plain_calls}")
    return row


# --------------------------------------------------------------------------
# Speculative and structured decoding on the card
# --------------------------------------------------------------------------

SPEC_KW = dict(spec_mode="ngram", spec_tokens=4)


def echo_prompts(n: int, salt: int, vocab: int, isl: int = 128) -> list:
    """The reference bench's echo prompts (``bench.py --workload echo``): a
    period-3 pattern per request, repeated to ``isl``."""
    from llmd_tpu_torch.tools.bench import prompts

    return prompts(n, salt, vocab, isl, "echo")


def _spec_engine(device, cfg, spec: bool, seed: int = 0, **kw):
    """An engine of the engine phase's settings (random weights from
    ``seed``), speculation on or off, warmed up: its decode program is
    captured and, with speculation, a verify step has run."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine

    ecfg = dict(page_size=PS, num_pages=2048, max_model_len=2048, max_batch_size=32,
                prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)
    ecfg.update(kw, **(SPEC_KW if spec else {}))
    eng = LLMEngine(cfg, EngineConfig(**ecfg), seed=seed, device=device)
    eng.generate(echo_prompts(2, 1, cfg.vocab_size, 64),
                 SamplingParams(max_tokens=24, temperature=0.0))
    return eng


def _spec_window(eng, prompts, max_tokens: int) -> dict:
    """One ``generate`` of ``prompts`` with the counters zeroed just before
    and read just after: tokens, launches, and the engine's counts over it.
    ``verify_launches``: the launches made inside the engine's verify steps
    (each kernel's count read before and after every ``_step_spec_verify``,
    the differences summed), the verify program's share of the window."""
    from llmd_tpu_torch.core.request import SamplingParams

    st0 = dataclasses.replace(eng.stats)
    verify_launches = dict.fromkeys(read_counts()[0], 0)
    step = eng._step_spec_verify

    def counted_step(plan):
        before = read_counts()[0]
        step(plan)
        for name, n in read_counts()[0].items():
            verify_launches[name] += n - before[name]

    eng._step_spec_verify = counted_step  # the engine calls it through self
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = eng.generate(prompts, SamplingParams(max_tokens=max_tokens, temperature=0.0))
        torch.cuda.synchronize()
    finally:
        del eng._step_spec_verify
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    st = eng.stats
    d = {k: getattr(st, k) - getattr(st0, k) for k in (
        "n_unified_steps", "n_decode_iterations", "n_spec_verify_steps", "spec_drafted",
        "spec_accepted", "spec_rejected", "moe_dropped_tokens")}
    n_out = sum(len(v) for v in out.values())
    return {"tokens": out, "launches": launches, "plain_calls": plain_calls,
            "verify_launches": verify_launches,
            "launches_by_instance": instance_counts(), "wall_s": wall,
            "output_tok_s": n_out / wall, **d}


def _top2_margin(eng, prompt: list, generated: list) -> float:
    """The two top logits' margin of the token after ``prompt + generated``,
    from one unified forward of that sequence (the engine's weights and
    kernels, a scratch pool): how near a tie the divergence sat."""
    from llmd_tpu_torch.models.transformer import forward_core, init_cache, unembed

    cfg, dev = eng.model_cfg, eng.device
    ids = prompt + generated
    n = len(ids)
    pages = -(-n // PS)
    pool = init_cache(cfg, pages + 1, PS, device=dev)
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    with torch.no_grad():
        hidden, *_ = forward_core(cfg, eng.params, pool, t(ids), t(list(range(n))),
                                  t([0] * n), t([list(range(pages))]), t([n]),
                                  cu_q_lens=t([0, n]), num_seqs=t([1]),
                                  attn_impl=eng._attn["unified"],
                                  moe_dispatch_impl=eng._moe_dispatch_impl)
        top = torch.topk(unembed(cfg, eng.params, hidden[-1:]).float()[0], 2).values
    return float(top[0] - top[1])


def _check_spec_launches(label: str, cfg, run: dict, per: dict, instance: str,
                         spec: bool = True) -> dict:
    """Each kernel of the path launched its count per layer of its
    programs' forwards (``per``: kernel -> (launches per layer, programs)),
    all on ``instance`` (K2 / K4 on wgmma for bf16, simt for float32), no
    plain version; the launches measured inside the verify steps are each
    verify kernel's count per layer of the verify forwards."""
    forwards = {"unified": run["n_unified_steps"], "decode": run["n_decode_iterations"],
                "verify": run["n_spec_verify_steps"]}
    expect = {name: n * cfg.num_layers * sum(forwards[p] for p in progs)
              for name, (n, progs) in per.items()}
    expect_verify = {name: (n * cfg.num_layers * forwards["verify"] if "verify" in progs else 0)
                     for name, (n, progs) in per.items()}
    got = {name: run["launches"][name] for name in run["launches"]}
    got_verify = {name: run["verify_launches"][name] for name in per}
    off_path = {n: v for n, v in got.items() if n not in per and v}
    gemm_instance = "wgmma" if instance == "mma" else "simt"
    wrong = {n: by for n, by in run["launches_by_instance"].items()
             if by != {k: (got[n] if k == (gemm_instance if "gemm" in n else instance) else 0)
                       for k in by}}
    on_card = torch.cuda.is_available()  # on the CPU the plain versions run
    if on_card and (any(run["plain_calls"].values()) or off_path or wrong
                    or (run["n_spec_verify_steps"] > 0) != spec
                    or any(got[n] != v for n, v in expect.items())
                    or got_verify != expect_verify):
        raise AssertionError(f"spec {label}: launches {got} expected {expect}, in verify "
                             f"steps {got_verify} expected {expect_verify}, off-path "
                             f"{off_path}, instances {wrong}, plain calls "
                             f"{run['plain_calls']}, verify steps {run['n_spec_verify_steps']}")
    return {"expected": expect, "verify_launches": got_verify}


def phase_spec(device, card: str, seed: int = 0) -> dict:
    """Speculative decoding (``spec_mode="ngram"``, ``spec_tokens`` 4) on
    llama-1b at full width, random weights from the seed, the engine phase's
    settings: 8 concurrent greedy requests of 64 tokens on the reference
    bench's echo prompts, through ``generate``, with speculation and without.

    float32: the tokens must be identical (greedy acceptance is exact). bf16:
    the share of tokens equal to speculation-off's (the verify batch runs
    K1's mixed tiling and M = NT products where decode runs the decode
    program, so near-ties can flip), the margin of the two top logits at the
    first divergence, the spec counts, accepted per verify step, K1's
    launches in the verify program, and both engines' output tok/s in two
    turns (off, on, off, on; a turn's prompts are new, so no prefix hit).
    Then moe-wide-mla at 2 layers in float32 (K1's latent mode in the unified
    and verify programs, K3 in decode, K2 in every forward): identical tokens
    too. Every window's launches: each kernel once per layer of its
    programs' forwards (K2 twice), on its instance, no plain version."""
    from llmd_tpu_torch.models import get_model_config

    out: dict = {}
    llama = get_model_config("llama-1b")
    k1_all = {"paged_attention": (1, ("unified", "decode", "verify"))}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(llama, dtype=dtype)
        engs = {spec: _spec_engine(device, cfg, spec, seed) for spec in (False, True)}
        turns = []
        for salt in ((2,) if dtype == "float32" else (2, 3)):
            prompts = echo_prompts(8, salt, cfg.vocab_size)
            turns.append({spec: _spec_window(engs[spec], prompts, 64) for spec in (False, True)})
        instance = "simt" if dtype == "float32" else "mma"
        checks = _check_spec_launches(f"llama-1b {dtype}", cfg, turns[0][True], k1_all, instance)
        _check_spec_launches(f"llama-1b {dtype} off", cfg, turns[0][False], k1_all, instance,
                             spec=False)
        off, on = turns[0][False]["tokens"], turns[0][True]["tokens"]
        pairs = [(a, b) for rid in off for a, b in zip(off[rid], on[rid])]
        same = sum(a == b for a, b in pairs) / len(pairs)
        first = next(((rid, i) for rid in sorted(off) for i, (a, b) in
                      enumerate(zip(off[rid], on[rid])) if a != b), None)
        margin = None
        if first is not None:
            rid, i = first
            prompt = echo_prompts(8, 2, cfg.vocab_size)[int(rid.split("-")[1])]
            margin = _top2_margin(engs[False], prompt, off[rid][:i])
        r = turns[0][True]
        row = {"identical_share": same, "first_divergence": first, "top2_margin": margin,
               "verify_steps": r["n_spec_verify_steps"], "spec_drafted": r["spec_drafted"],
               "spec_accepted": r["spec_accepted"], "spec_rejected": r["spec_rejected"],
               "accepted_per_verify_step": r["spec_accepted"] / max(1, r["n_spec_verify_steps"]),
               "output_tok_s_turns": [(t[False]["output_tok_s"], t[True]["output_tok_s"])
                                      for t in turns],
               **checks, "launches_on": r["launches"], "launches_off": turns[0][False]["launches"]}
        log(f"spec: llama-1b {dtype} on {card}: identical_share={same:.4f} "
            f"first_divergence={first} top2_margin={margin} verify_steps="
            f"{row['verify_steps']} drafted={row['spec_drafted']} accepted="
            f"{row['spec_accepted']} rejected={row['spec_rejected']} accepted/verify_step="
            f"{row['accepted_per_verify_step']:.3f} launches in verify steps="
            f"{checks['verify_launches']} output_tok_s (off, on) turns="
            + ", ".join(f"({a:.1f}, {b:.1f})" for a, b in row["output_tok_s_turns"]))
        out[f"llama-1b_{dtype}"] = row
        if dtype == "float32" and on != off:
            raise AssertionError(f"spec: llama-1b float32 tokens differ with speculation "
                                 f"(first divergence {first})")
        del engs
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_model_config(MLA), dtype="float32", num_layers=2)
    runs = {spec: _spec_window(_spec_engine(device, cfg, spec, seed, moe_dispatch="sorted"),
                               echo_prompts(8, 2, cfg.vocab_size), 64) for spec in (False, True)}
    torch.cuda.empty_cache()
    per = {"paged_attention": (1, ("unified", "verify")), "mla_decode": (1, ("decode",)),
           "ragged_grouped_gemm": (2, ("unified", "decode", "verify"))}
    checks = _check_spec_launches("moe-wide-mla float32", cfg, runs[True], per, "simt")
    r = runs[True]
    out["moe-wide-mla_float32"] = row = {
        "identical": runs[True]["tokens"] == runs[False]["tokens"],
        "verify_steps": r["n_spec_verify_steps"], "spec_drafted": r["spec_drafted"],
        "spec_accepted": r["spec_accepted"], "spec_rejected": r["spec_rejected"],
        "moe_dropped_tokens": r["moe_dropped_tokens"], **checks, "launches_on": r["launches"]}
    log(f"spec: moe-wide-mla (2 layers) float32 on {card}: identical={row['identical']} "
        f"verify_steps={row['verify_steps']} drafted={row['spec_drafted']} accepted="
        f"{row['spec_accepted']} launches={r['launches']} in verify steps="
        f"{checks['verify_launches']}")
    if not row["identical"] or r["moe_dropped_tokens"]:
        raise AssertionError(f"spec: moe-wide-mla float32 tokens differ with speculation or "
                             f"the sorted path dropped copies: {row}")
    return out


STRUCT_CHOICES = ["red", "green", "blue"]
STRUCT_REGEX = r"[a-c]{3}-[0-9]{2}"
# a bounded schema (enum / boolean / maxLength / maxItems): its automaton is a
# DAG, so a random model is forced to finish
STRUCT_SCHEMA = {"type": "object",
                 "properties": {"name": {"type": "string", "maxLength": 8},
                                "count": {"enum": [0, 1, 2, 3]}, "ok": {"type": "boolean"},
                                "tags": {"type": "array", "items": {"enum": ["a", "b"]},
                                         "maxItems": 2}},
                 "required": ["name", "count", "ok", "tags"]}


def _conforms(kind: str, text: str, only: "str | None" = None) -> bool:
    """The output of a ``kind`` request keeps to its constraint (``only``:
    the one letter a bias request may emit)."""
    from llmd_tpu_torch.structured import validate_instance

    if kind == "choice":
        return text in STRUCT_CHOICES
    if kind == "regex":
        return re.fullmatch(STRUCT_REGEX, text) is not None
    if kind == "schema":
        try:
            return validate_instance(json.loads(text), STRUCT_SCHEMA)
        except ValueError:
            return False
    return bool(text) and set(text) == {only}


def _mask_cost(device, vocab: int, max_elems: int, batch: int = 64, seed: int = 0) -> dict:
    """Device ms of what a masked decode iteration adds to the plain one,
    at the bench's batch over ``vocab``-wide float32 logits: the plain
    program's ``sample_tokens``; the masked program's row index, bias-row
    gather from a ``MaskTables`` buffer, ``sample_tokens_biased`` and
    next-state gather (as ``decode_program`` runs them), and the gather and
    biased sample alone. Greedy rows; timed by ``cuda_ms``, eagerly."""
    from llmd_tpu_torch.engine.decode_program import MaskTables
    from llmd_tpu_torch.engine.sampling import sample_tokens, sample_tokens_biased

    g = torch.Generator(device=device).manual_seed(seed)
    tables = MaskTables.allocate(max_elems, vocab, device)
    tables.bias.normal_(generator=g)
    tables.next.random_(0, tables.bias.shape[0], generator=g)
    logits = torch.randn((batch, vocab), generator=g, device=device)
    base = torch.randint(0, tables.bias.shape[0] // 2, (batch,), generator=g, device=device,
                         dtype=torch.int32)
    st = torch.randint(0, 8, (batch,), generator=g, device=device, dtype=torch.int32)
    act = torch.ones((batch,), dtype=torch.bool, device=device)
    temp, top_k = torch.zeros((batch,), device=device), torch.zeros((batch,), dtype=torch.int32,
                                                                    device=device)
    top_p = torch.ones((batch,), device=device)
    rows = (base + st).long()
    bias = tables.bias[rows]

    def masked():
        r = (base + st).long()
        nxt = sample_tokens_biased(logits, tables.bias[r], g, temp, top_k, top_p)
        return torch.where(act, tables.next[r, nxt.long()], st)

    out = {"batch": batch, "vocab": vocab, "table_rows": tables.bias.shape[0],
           "sample_tokens_ms": cuda_ms(lambda: sample_tokens(logits, g, temp, top_k, top_p)),
           "masked_step_ms": cuda_ms(masked),
           "bias_gather_ms": cuda_ms(lambda: tables.bias[rows]),
           "sample_tokens_biased_ms": cuda_ms(
               lambda: sample_tokens_biased(logits, bias, g, temp, top_k, top_p))}
    out["masked_extra_ms"] = out["masked_step_ms"] - out["sample_tokens_ms"]
    del tables
    return out


def phase_structured(device, card: str, seed: int = 0) -> dict:
    """Structured outputs on the card: llama-1b at full width, bf16 weights
    from the seed, the engine phase's settings, behind the port's server
    (the byte tokenizer). 8 concurrent greedy requests: ``guided_choice``,
    ``guided_regex``, ``response_format`` ``json_schema`` (bounded), and a
    ``logit_bias`` of +100 on "a" and "b" that bans (-100) the one of them
    the same bias alone gives first, two of each, half streamed, one through
    chat. Every output conforms (the bias rows emit only the other letter)
    and ``structured_violations`` reads 0 in ``EngineStats`` and on
    ``/metrics``; a malformed schema and a malformed regex get 400; K1 once
    per layer of every forward, all on mma. At llama-1b's vocabulary the
    table gate allows G_pad x S_pad <= 256, so while the 70-state schema
    shares the batch with four other constraints the batch takes the
    unified degrade, as in the reference: the line says how many masked
    chain stagings and unified steps the wave took. Then the masked decode
    program replayed from its graph against the same program run eagerly
    (two engines, ``generate`` of constrained requests that fit the gate:
    choice, regex, a 30-character regex and a bias row): identical tokens and
    launch counts, one capture of the masked program, a replay a call. Then
    ``profile_engine.profile_batch`` at batch 8: the masked program replayed
    (every row under ``[ab]{100}``) makes fewer than 10 host launch calls per
    iteration (eager beside it), and the unmasked program replayed still
    makes 3 / ``decode_steps``.
    Then the device time a masked iteration adds to the sampler at batch 64
    (``_mask_cost``). Last, one json-echo run with speculation on: the share
    of verify steps that ran the masked verify program, accepted constrained
    drafts, no violation."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.transformer import init_params
    from llmd_tpu_torch.tools.bench import prompts as bench_prompts, workload_schema
    from llmd_tpu_torch.tools.profile_engine import profile_batch

    cfg = get_model_config("llama-1b")
    tok = ByteTokenizer()
    kw = dict(page_size=PS, num_pages=2048, max_model_len=2048, max_batch_size=32,
              prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)
    fmt = {"type": "json_schema", "json_schema": {"schema": STRUCT_SCHEMA}}
    greedy = {"max_tokens": 96, "temperature": 0}
    server = EngineServer(cfg, EngineConfig(**kw), host="127.0.0.1", port=0, seed=seed,
                          device=device)
    server.start()
    base = f"http://{server.address}"
    eng = server.engine
    out: dict = {}
    try:
        a, b = tok.encode("ab")
        probe = json.loads(_http("POST", base + "/v1/completions", {
            "prompt": "say something", "max_tokens": 4, "temperature": 0,
            "logit_bias": {str(a): 100, str(b): 100}})[2])["choices"][0]["text"]
        banned_id = a if probe[:1] == "a" else b
        only = "b" if banned_id == a else "a"
        bias = {"logit_bias": {str(a): 100, str(b): 100, str(banned_id): -100},
                "max_tokens": 24}
        wave = [("choice", "/v1/completions", {"prompt": "pick a color",
                                               "guided_choice": STRUCT_CHOICES}),
                ("choice", "/v1/completions", {"prompt": "pick one", "stream": True,
                                               "guided_choice": STRUCT_CHOICES}),
                ("regex", "/v1/completions", {"prompt": "emit a code",
                                              "guided_regex": STRUCT_REGEX}),
                ("regex", "/v1/completions", {"prompt": "a code please", "stream": True,
                                              "guided_regex": STRUCT_REGEX}),
                ("schema", "/v1/chat/completions", {
                    "messages": [{"role": "user", "content": "describe it as json"}],
                    "response_format": fmt}),
                ("schema", "/v1/completions", {"prompt": "json:", "stream": True,
                                               "response_format": fmt}),
                ("bias", "/v1/completions", {"prompt": "say something", **bias}),
                ("bias", "/v1/completions", {"prompt": "say something", "stream": True,
                                             **bias})]
        st0 = dataclasses.replace(eng.stats)
        masked0 = eng.programs.counters().get("decode_masked", (0, 0))[0]
        zero_counts()
        results: list = [None] * len(wave)

        def one(i: int) -> None:
            _, path, body = wave[i]
            try:
                results[i] = _http("POST", base + path, {**greedy, **body})
            except Exception as e:  # noqa: BLE001 — reported below as a failed request
                results[i] = e

        t1 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(wave))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t1
        launches, plain_calls = read_counts()
        by_instance = instance_counts()
        st = dataclasses.replace(eng.stats)
        masked = eng.programs.counters().get("decode_masked", (0, 0))[0] - masked0
        texts = []
        for (kind, path, body), r in zip(wave, results):
            if not (isinstance(r, tuple) and r[0] == 200):
                raise AssertionError(f"structured: {kind} failed: {r}")
            chat = path.endswith("chat/completions")
            if body.get("stream"):
                chunks = [json.loads(e) for e in r[2][:-1]]
                text = "".join(c["choices"][0]["delta"]["content"] if chat
                               else c["choices"][0]["text"] for c in chunks)
                pieces = len(chunks)
            else:
                c = json.loads(r[2])["choices"][0]
                text, pieces = (c["message"]["content"] if chat else c["text"]), 1
            texts.append((kind, bool(body.get("stream")), text, pieces,
                          _conforms(kind, text, only)))
        metrics = _http("GET", base + "/metrics")[2].decode()
        violations_metric = re.search(r"^llmd_tpu:structured_violations_total (\S+)$",
                                      metrics, re.M)
        bad_schema = _http("POST", base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "x"}], "response_format": {
                "type": "json_schema", "json_schema": {"schema": {"type": "wat"}}}})[0]
        bad_regex = _http("POST", base + "/v1/completions", {"prompt": "x",
                                                             "guided_regex": "(ab"})[0]
    finally:
        server.stop()
    forwards = (st.n_unified_steps - st0.n_unified_steps
                + st.n_decode_iterations - st0.n_decode_iterations)
    conform = sum(c for *_, c in texts) / len(texts)
    out["server"] = {
        "card": card, "requests": len(wave), "wall_s": wall, "conformance": conform,
        "texts": texts, "violations": st.structured_violations,
        "violations_metric": violations_metric and float(violations_metric.group(1)),
        "bad_schema_status": bad_schema, "bad_regex_status": bad_regex,
        "launches": launches, "plain_calls": plain_calls, "launches_by_instance": by_instance,
        "forwards": forwards, "masked_decode_calls": masked,
        "chain_stages": st.structured_chain_stages - st0.structured_chain_stages,
        "unified_steps": st.n_unified_steps - st0.n_unified_steps}
    log(f"structured: llama-1b bf16 on {card}: {len(wave)} requests wall_s={wall:.3f} "
        f"conformance={conform:.3f} violations={st.structured_violations} (metric "
        f"{out['server']['violations_metric']}) masked_decode_calls={masked} chain_stages="
        f"{out['server']['chain_stages']} bad_schema={bad_schema} bad_regex={bad_regex}")
    log(f"structured:   outputs {[(k, s, t[:48], n) for k, s, t, n, _ in texts]}")
    log(f"structured:   launches={launches} plain_calls={plain_calls} "
        f"launches_by_instance={by_instance} forwards={forwards}")
    k1 = by_instance["paged_attention"]
    launches_ok = device.type != "cuda" or not (
        any(plain_calls.values()) or launches["paged_attention"] != cfg.num_layers * forwards
        or k1 != {**dict.fromkeys(k1, 0), "mma": launches["paged_attention"]})
    if (conform != 1.0 or st.structured_violations or out["server"]["violations_metric"] != 0
            or bad_schema != 400 or bad_regex != 400 or not launches_ok
            or not all(n > 1 for _, s, _, n, _ in texts if s)):
        raise AssertionError(f"structured: the server run failed its checks: {out['server']}")

    # the masked decode program replayed against the same program run eagerly
    reqs = [(tok.encode("pick a color"), dict(guided_choice=STRUCT_CHOICES)),
            (tok.encode("emit a code"), dict(guided_regex=STRUCT_REGEX)),
            (tok.encode("say something"), dict(logit_bias={banned_id: -100.0})),
            (tok.encode("bits"), dict(guided_regex=r"[ab]{30}"))]
    runs = {}
    for graph in (True, False):
        e = LLMEngine(cfg, EngineConfig(**kw), seed=seed, device=device, decode_graph=graph,
                      tokenizer=tok)
        for i, (p, extra) in enumerate(reqs):
            e.add_request(f"r{i}", p, SamplingParams(
                max_tokens=64, temperature=0.0, stop_token_ids=(tok.eos_id,), **extra))
        zero_counts()
        got: dict = {}
        while e.has_work():
            for o in e.step():
                got.setdefault(o.request_id, []).extend(o.new_token_ids)
        runs[graph] = {"tokens": got, "launches": read_counts()[0],
                       "captures": e.compile_counts(), "replays": e.stats.decode_graph_replays,
                       "calls": e.stats.n_decode_calls, "chained": e.stats.n_chained_dispatches,
                       "masked_calls": e.programs.counters().get("decode_masked", (0, 0))[0],
                       "violations": e.stats.structured_violations}
        del e
        torch.cuda.empty_cache()
    g, e = runs[True], runs[False]
    out["graph"] = {k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in
                    (("replayed", g), ("eager", e))}
    out["graph"]["same_tokens"] = g["tokens"] == e["tokens"]
    log(f"structured:   masked chain replayed vs eager: same_tokens={g['tokens'] == e['tokens']} "
        f"launches same={g['launches'] == e['launches']} captures={g['captures']} "
        f"replays={g['replays']} calls={g['calls']} chained={g['chained']} masked_calls="
        f"{g['masked_calls']}")
    graphed = device.type != "cuda" or (g["captures"]["decode_masked"] == 1
                                        and g["replays"] == g["calls"])
    if (g["tokens"] != e["tokens"] or g["launches"] != e["launches"] or not graphed
            or g["masked_calls"] == 0 or g["chained"] == 0 or g["violations"] or e["violations"]):
        raise AssertionError(f"structured: masked chain replayed differs from eager: "
                             f"{out['graph']}")

    # host launch calls per decode iteration, masked and not
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    regex = {"guided_regex": "[ab]{100}"}
    prof = {name: profile_batch(cfg, params, 8, 256, kw["decode_steps"], 5, 3, seed,
                                decode_graph=graph, sampling=sampling, tokenizer=tok)
            for name, graph, sampling in (("masked_graph", True, regex),
                                          ("masked_eager", False, regex),
                                          ("plain_graph", True, None))}
    del params
    torch.cuda.empty_cache()
    keys = ("host_launch_calls_per_iteration", "device_kernels_per_iteration",
            "device_busy_share_profiled", "decode_tok_s", "masked_decode_calls",
            "host_launch_calls")
    out["profile"] = {n: {k: r[k] for k in keys} for n, r in prof.items()}
    log("structured:   batch 8 profile: " + "; ".join(
        f"{n} host_launch_calls/iter={r['host_launch_calls_per_iteration']:.2f} "
        f"device_kernels/iter={r['device_kernels_per_iteration']} decode_tok_s="
        f"{r['decode_tok_s']:.1f} masked_calls={r['masked_decode_calls']}"
        for n, r in prof.items()))
    mg, pg = prof["masked_graph"], prof["plain_graph"]
    if (mg["masked_decode_calls"] == 0 or mg["host_launch_calls_per_iteration"] >= 10
            or pg["host_launch_calls_per_iteration"] != 3 / kw["decode_steps"]
            or pg["masked_decode_calls"]):
        raise AssertionError(f"structured: host launch calls per iteration: masked "
                             f"{mg['host_launch_calls_per_iteration']} (limit 10), plain "
                             f"{pg['host_launch_calls_per_iteration']} (expected "
                             f"{3 / kw['decode_steps']})")

    out["mask_cost"] = mc = _mask_cost(device, cfg.vocab_size,
                                       EngineConfig(**kw).structured_table_max_elems)
    log(f"structured:   masked sampler cost at batch {mc['batch']} on {card}: "
        + " ".join(f"{k}={v:.4f}" for k, v in mc.items() if k.endswith("_ms")))

    # speculation on constrained rows: a json-echo run
    e = LLMEngine(cfg, EngineConfig(**kw, **SPEC_KW), seed=seed, device=device, tokenizer=tok)
    schema = workload_schema("json-echo", 128)
    sp = SamplingParams(max_tokens=128, temperature=0.0, ignore_eos=True, response_format={
        "type": "json_schema", "json_schema": {"schema": schema}})
    t0 = time.perf_counter()
    done = e.generate(bench_prompts(8, 2, cfg.vocab_size, 256, "json-echo", tok), sp)
    wall = time.perf_counter() - t0
    c = e.programs.counters()
    st = e.stats
    n_verify = c["verify"][0] + c["verify_masked"][0]
    out["json_echo_spec"] = row = {
        "verify_steps": n_verify, "masked_verify_steps": c["verify_masked"][0],
        "constrained_verify_share": c["verify_masked"][0] / max(1, n_verify),
        "spec_drafted_constrained": st.spec_drafted_constrained,
        "spec_accepted_constrained": st.spec_accepted_constrained,
        "violations": st.structured_violations, "wall_s": wall,
        "output_tok_s": sum(len(v) for v in done.values()) / wall}
    log(f"structured:   json-echo spec on {card}: verify_steps={n_verify} masked="
        f"{row['masked_verify_steps']} constrained_verify_share="
        f"{row['constrained_verify_share']:.3f} accepted/drafted constrained="
        f"{st.spec_accepted_constrained}/{st.spec_drafted_constrained} violations="
        f"{st.structured_violations} output_tok_s={row['output_tok_s']:.1f}")
    del e
    torch.cuda.empty_cache()
    if row["masked_verify_steps"] == 0 or row["spec_accepted_constrained"] == 0 or row[
            "violations"]:
        raise AssertionError(f"structured: json-echo speculation failed its checks: {row}")
    return out


def phase_forward_check(device, model: str = "llama-1b", seed: int = 0,
                        moe_dispatch: str = "sorted") -> dict:
    """One mixed unified batch (two decode rows over resident KV, a fresh
    prefill chunk, a second chunk of a longer prompt) through forward_core in
    float32, once with the kernels' wrappers and once with the plain versions
    passed as overrides (attention, and for a MoE model the expert GEMMs of
    the ``moe_dispatch`` path). An MLA model then runs a decode batch (one
    new token for each of the four sequences) through the decode program's
    attention, K3's adapter, or the same adapter over K3's plain version.
    Logits are held together; the expert counts (routing decisions) must be
    equal."""
    import dataclasses
    import functools

    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.transformer import (
        SORTED_DISPATCH, forward_core, init_cache, init_params, unembed)
    from llmd_tpu_torch.ops.grouped_gemm import (
        grouped_gemm, grouped_gemm_ref, ragged_grouped_gemm_ref)
    from llmd_tpu_torch.ops.mla_decode import mla_decode_ref, mla_paged_attention_latent
    from llmd_tpu_torch.ops.moe_dispatch import sorted_moe_local
    from llmd_tpu_torch.ops.paged_attention import paged_attention, paged_attention_ref

    cfg = dataclasses.replace(get_model_config(model), dtype="float32")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    rng = np.random.default_rng(seed)
    P = 96
    lens_a = [300, 90, 200]  # resident before the mixed step
    pages = {}
    free = iter(rng.permutation(P).tolist())

    def table(b, n_tok):
        pages.setdefault(b, [])
        while len(pages[b]) * PS < n_tok:
            pages[b].append(next(free))

    def batch(rows):
        """rows: (seq, tokens, start) → flat batch tensors."""
        toks, pos, sids, cu = [], [], [], [0]
        pts = np.full((len(rows), 2048 // PS), -1, np.int32)
        lens = np.zeros((len(rows),), np.int32)
        for i, (b, tk, start) in enumerate(rows):
            table(b, start + len(tk))
            toks += tk
            pos += list(range(start, start + len(tk)))
            sids += [i] * len(tk)
            cu.append(cu[-1] + len(tk))
            pts[i, : len(pages[b])] = pages[b]
            lens[i] = start + len(tk)
        t = lambda a, dt=np.int32: torch.from_numpy(np.asarray(a, dt)).to(device)  # noqa: E731
        return (t(toks), t(pos), t(sids), t(pts), t(lens), t(cu),
                t([len(rows)]), np.asarray(cu))

    seqs = {b: rng.integers(0, cfg.vocab_size, n + 1).tolist() for b, n in enumerate(lens_a)}
    first = [(0, seqs[0][:300], 0), (1, seqs[1][:90], 0), (2, seqs[2][:200], 0)]
    e_tok = rng.integers(0, cfg.vocab_size, 128).tolist()
    mixed = [(0, seqs[0][300:301], 300), (1, seqs[1][90:91], 90),
             (3, e_tok, 0), (2, seqs[2][200:201], 200)]
    nxt = rng.integers(0, cfg.vocab_size, 4).tolist()
    decode = [(0, nxt[:1], 301), (1, nxt[1:2], 91), (3, nxt[2:3], 128), (2, nxt[3:], 201)]
    steps = [(first, "unified"), (mixed, "unified")]
    if cfg.is_mla:
        steps.append((decode, "decode"))
    einsum = moe_dispatch == "einsum"
    impls = {
        "kernel": dict(attn_impl={"unified": paged_attention,
                                  "decode": mla_paged_attention_latent},
                       moe_dispatch_impl=None if einsum else SORTED_DISPATCH,
                       moe_matmul_impl=grouped_gemm),
        "plain": dict(attn_impl={"unified": paged_attention_ref,
                                 "decode": functools.partial(mla_paged_attention_latent,
                                                             decode=mla_decode_ref)},
                      moe_dispatch_impl=None if einsum else functools.partial(
                          sorted_moe_local, gemm=ragged_grouped_gemm_ref),
                      moe_matmul_impl=grouped_gemm_ref),
    }
    out, counts, runs = {}, {}, {}
    for name, kw in impls.items():
        cache = init_cache(cfg, P, PS, device=device)
        logits, cnt = [], 0
        zero_counts()
        for rows, program in steps:
            toks, pos, sids, pts, lens, cu, ns, cu_np = batch(rows)
            hidden, cache, cnt_i, _ = forward_core(
                cfg, params, cache, toks, pos, sids, pts, lens, cu_q_lens=cu, num_seqs=ns,
                **{**kw, "attn_impl": kw["attn_impl"][program]})
            cnt = cnt + cnt_i
            last = torch.from_numpy(cu_np[1:] - 1).to(device)
            logits.append(unembed(cfg, params, hidden[last]))
        runs[name] = read_counts()
        if name == "kernel":
            by_instance = instance_counts()
        out[name], counts[name] = torch.cat(logits), cnt
    diff = (out["kernel"] - out["plain"]).abs().max().item()
    agree = (out["kernel"].argmax(-1) == out["plain"].argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(out["kernel"]).all())
    same_counts = bool(torch.equal(counts["kernel"], counts["plain"]))
    path = f" {moe_dispatch}" if cfg.is_moe else ""
    what = "mixed + decode batches" if cfg.is_mla else "mixed batch"
    log(f"forward: {model}{path} float32 {what} rows={out['kernel'].shape[0]} "
        f"logits_max_abs_diff={diff:.3e} atol={FORWARD_ATOL:.0e} argmax_agree={agree:.3f} "
        f"expert_counts_equal={same_counts} kernel_run={runs['kernel'][0]} "
        f"plain_run={runs['plain'][1]}")
    if not (finite and diff <= FORWARD_ATOL and agree == 1.0 and same_counts):
        raise AssertionError(f"forward: kernel vs plain logits diff {diff}, argmax "
                             f"agreement {agree}, finite {finite}, expert counts "
                             f"equal {same_counts}")
    if device.type == "cuda" and (any(runs["kernel"][1].values())
                                  or any(runs["plain"][0].values())):
        raise AssertionError(f"forward: the runs mixed kernels and plain versions: {runs}")
    if device.type == "cuda" and (any(by_instance[n]["mma"] for n in (
            "paged_attention", "mla_decode")) or any(
            by_instance[n]["wgmma"] for n in ("ragged_grouped_gemm", "grouped_gemm"))):
        raise AssertionError(f"forward: float32 kernels reached a bf16 instance: "
                             f"{by_instance}")
    if device.type == "cuda" and cfg.is_mla and (
            runs["kernel"][0]["mla_decode"] != cfg.num_layers
            or runs["kernel"][0]["paged_attention"] != 2 * cfg.num_layers):
        raise AssertionError(f"forward: K3 / K1 launches {runs['kernel'][0]}, expected "
                             f"{cfg.num_layers} / {2 * cfg.num_layers}")
    return {"logits_max_abs_diff": diff, "argmax_agree": agree, "atol": FORWARD_ATOL,
            "expert_counts_equal": same_counts,
            "expert_counts": counts["kernel"].tolist()}


def int8_forward_check(device, model: str, moe_dispatch: str = "sorted",
                       seed: int = 0) -> dict:
    """One mixed batch (a 300-token prefill and a 128-token one, then a step
    with a decode row of each beside a fresh 64-token chunk) through
    ``forward_core`` in float32 on the card, with int8 weights (the plain
    scaled products) and again with the dequantized weights ``q * s`` as
    plain float32 weights: logits max abs <= FORWARD_ATOL, argmax 100%."""
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.quant import dequantize_params, quantize_params
    from llmd_tpu_torch.models.transformer import (
        SORTED_DISPATCH, forward_core, init_cache, init_params, unembed)

    cfg = dataclasses.replace(get_model_config(model), dtype="float32")
    q8 = quantize_params(cfg, init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                          device))
    runs = {"int8": (cfg, q8),
            "dequantized": (dataclasses.replace(cfg, tie_embeddings=False),
                            dequantize_params(q8, torch.float32))}
    rng = np.random.default_rng(seed)
    toks = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (301, 129, 64)]
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)  # noqa: E731
    steps = [  # (rows of (table row, tokens, start))
        [(0, toks[0][:300], 0), (1, toks[1][:128], 0)],
        [(0, toks[0][300:], 300), (1, toks[1][128:], 128), (2, toks[2], 0)]]
    pts = t(np.arange(3 * 32).reshape(3, 32))
    logits = {}
    for name, (c, p) in runs.items():
        cache, out = init_cache(c, 96, PS, device=device), []
        for rows in steps:
            flat = [tok for _, tk, _ in rows for tok in tk]
            pos = [st + i for _, tk, st in rows for i in range(len(tk))]
            sids = [j for j, (_, tk, _) in enumerate(rows) for _ in tk]
            cu = np.cumsum([0] + [len(tk) for _, tk, _ in rows])
            hidden, cache, _, _ = forward_core(
                c, p, cache, t(flat), t(pos), t(sids), pts[[b for b, _, _ in rows]],
                t([st + len(tk) for _, tk, st in rows]), cu_q_lens=t(cu),
                num_seqs=t([len(rows)]),
                moe_dispatch_impl=SORTED_DISPATCH if moe_dispatch == "sorted" else None)
            out.append(unembed(c, p, hidden[t(cu[1:] - 1).long()]))
        logits[name] = torch.cat(out)
    diff = (logits["int8"] - logits["dequantized"]).abs().max().item()
    agree = (logits["int8"].argmax(-1) == logits["dequantized"].argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(logits["int8"]).all())
    del runs, q8
    torch.cuda.empty_cache()
    if not (finite and diff <= FORWARD_ATOL and agree == 1.0):
        raise AssertionError(f"int8 {model} {moe_dispatch}: int8 vs dequantized float32 "
                             f"logits diff {diff}, argmax agreement {agree}, finite {finite}")
    return {"logits_max_abs_diff": diff, "argmax_agree": agree, "atol": FORWARD_ATOL}


def phase_int8(device, card: str, model: str = "llama-1b", n_requests: int = 8,
               max_tokens: int = 32, seed: int = 0, engine_kw: "dict | None" = None,
               label: str = "") -> dict:
    """int8 weight-only weights at registry width through the captured,
    pipelined engine, replayed and eager (two engines of the same seed):
    greedy tokens and launch counts equal; K1 once per layer of every forward
    (of the unified forwards on MLA) and K3 once per layer of every decode
    iteration on MLA, all on their mma instances; no K2 / K4 launch (int8
    banks run plain products) and no plain version. Then the float32
    forward of the int8 weights against their dequantized plain weights."""
    from llmd_tpu_torch.models import get_model_config

    cfg = get_model_config(model)
    kw = dict(page_size=PS, num_pages=2048, max_model_len=2048, max_batch_size=32,
              prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4,
              quantize_weights="int8")
    kw.update(engine_kw or {})
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, n_requests)]
    runs = {mode: _served_run(device, cfg, kw, prompts, max_tokens, seed, mode == "graph")
            for mode in ("graph", "eager")}
    g, e = runs["graph"], runs["eager"]
    same = {k: g[k] == e[k] for k in ("tokens", "launches", "launches_by_instance",
                                      "moe_dropped_tokens")}
    k1_forwards = g["unified_steps"] + (0 if cfg.is_mla else g["decode_iterations"])
    expect = {"paged_attention": cfg.num_layers * k1_forwards,
              "mla_decode": cfg.num_layers * g["decode_iterations"] if cfg.is_mla else 0,
              "ragged_grouped_gemm": 0, "grouped_gemm": 0}
    by_inst = g["launches_by_instance"]
    on_mma = all(by_inst[n]["simt"] == 0 for n in ("paged_attention", "mla_decode"))
    fwd = int8_forward_check(device, model, kw.get("moe_dispatch", "sorted"), seed)
    row = {"card": card, "model": model, "label": label, "requests": n_requests,
           "same": same, "launches": g["launches"], "expected_launches": expect,
           "launches_by_instance": by_inst, "plain_calls": [g["plain_calls"], e["plain_calls"]],
           "captures": g["captures"], "replays": g["replays"], "moe_backend": g["moe_backend"],
           "moe_dropped_tokens": g["moe_dropped_tokens"], "forward": fwd}
    log(f"int8: {model} {label} on {card}: same={same} launches={g['launches']} "
        f"expected={expect} by_instance={by_inst} captures={g['captures']} "
        f"replays={g['replays']} moe_backend={g['moe_backend']!r} "
        f"forward={fwd}")
    if not all(same.values()) or any(g["plain_calls"].values()) or any(
            e["plain_calls"].values()):
        raise AssertionError(f"int8 {model} {label}: replayed and eager runs differ ({same}) "
                             f"or plain versions ran ({g['plain_calls']}, {e['plain_calls']})")
    if g["launches"] != expect or not on_mma or g["captures"] != 1:
        raise AssertionError(f"int8 {model} {label}: launches {g['launches']} "
                             f"(instances {by_inst}), expected {expect} on mma; "
                             f"{g['captures']} captures")
    return row


def phase_loader(device, card: str, model: str = "llama-1b", seed: int = 0,
                 n_requests: int = 4, max_tokens: int = 16) -> dict:
    """llama-1b's random bf16 params at full width written by the port's HF
    checkpoint writer (``testing/checkpoints``) under the gitignored
    ``checkpoints/``, loaded back by ``models/hf_loader`` onto the card:
    every leaf bit-equal, and the greedy tokens of an engine on the loaded
    params equal those of one on the in-memory params."""
    from llmd_tpu_torch.models import get_model_config, resolve_model
    from llmd_tpu_torch.models.transformer import init_params
    from llmd_tpu_torch.testing.checkpoints import write_hf_checkpoint

    cfg = get_model_config(model)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    out_dir = REPO / "checkpoints" / f"chip-smoke-{model}"
    t0 = time.perf_counter()
    write_hf_checkpoint(str(out_dir), cfg, params)
    write_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in out_dir.iterdir())
    try:
        t0 = time.perf_counter()
        lcfg, loaded = resolve_model(str(out_dir))
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir)
    same_cfg = dataclasses.replace(lcfg, name=cfg.name) == cfg
    unequal = [k for k in params if not torch.equal(params[k].cpu(), loaded[k])]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 257, n_requests)]
    kw = dict(page_size=PS, num_pages=512, max_model_len=1024, max_batch_size=8,
              prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine

    tokens = {}
    for name, p in (("in_memory", params), ("loaded", loaded)):
        eng = LLMEngine(lcfg if name == "loaded" else cfg, EngineConfig(**kw), params=p,
                        device=device)
        tokens[name] = eng.generate(prompts, SamplingParams(max_tokens=max_tokens,
                                                            temperature=0.0))
        del eng
    del params, loaded
    torch.cuda.empty_cache()
    row = {"card": card, "model": model, "checkpoint_bytes": size, "write_s": write_s,
           "load_s": load_s, "config_equal": same_cfg, "unequal_leaves": unequal,
           "tokens_equal": tokens["loaded"] == tokens["in_memory"],
           "requests": n_requests, "max_tokens": max_tokens}
    log(f"loader: {model} on {card}: checkpoint {size} bytes written in {write_s:.2f}s, "
        f"loaded in {load_s:.2f}s; config_equal={same_cfg} unequal_leaves={unequal} "
        f"tokens_equal={row['tokens_equal']}")
    if not (same_cfg and not unequal and row["tokens_equal"]):
        raise AssertionError(f"loader: {row}")
    return row


def phase_bench(device, card: str, argv: list[str]) -> dict:
    """``llmd_tpu_torch.tools.bench`` in this process with ``argv``: its JSON
    line, printed on a ``bench:`` line. No capture in the measured window
    (``recompiles`` 0), K1 once per layer of every forward of the window
    (verify steps included), all on its mma instance (``mma_fp8`` over an
    fp8 pool); no structured violation."""
    import contextlib
    import io

    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.tools import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv)
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"bench {argv}: rc {rc}, output {buf.getvalue()[-2000:]}")
    row = json.loads(lines[-1])
    print("bench: " + lines[-1], flush=True)
    torch.cuda.empty_cache()
    cfg = get_model_config("llama-1b")
    k1 = row["kernel_launches"]["paged_attention"]
    forwards = row["unified_steps"] + row["decode_iterations"] + row["spec_verify_steps"]
    inst = "mma_fp8" if row["kv_cache_dtype"] == "fp8" else "mma"
    if (row["recompiles"] != 0 or sum(k1.values()) != k1[inst]
            or k1[inst] != cfg.num_layers * forwards or row["structured_violations"]):
        raise AssertionError(f"bench {argv}: recompiles {row['recompiles']}, K1 launches "
                             f"{k1}, expected {cfg.num_layers * forwards} on {inst}")
    return row


# --------------------------------------------------------------------------
# fp8 pools (kv_cache_dtype="fp8")
# --------------------------------------------------------------------------

FP8 = torch.float8_e4m3fn


def fp8_pool(pool):
    """The pool as the engine writes an fp8 pool: clamped to +-448, cast."""
    return pool.float().clamp(-448.0, 448.0).to(FP8)


def _max_abs(t) -> float:
    return t.float().abs().max().item() if t.numel() else 0.0


def _one_launch(fn, want: str, call):
    """``call()``, which must launch ``fn``'s kernel once, on ``want``."""
    before = dict(fn.launches_by_instance)
    out = call()
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in fn.launches_by_instance.items()}
    if got != {k: int(k == want) for k in got}:
        raise AssertionError(f"fp8: {fn.__name__} launched {got}, expected one on {want}")
    return out


def fp8_attention_cases(device):
    """(kernel, label, bf16 case over an fp8 pool) of the fp8 check: K1 at
    llama-1b's decode, mixed, verify and long-context (B=4, kv 3000-8192)
    shapes; K1's latent mode at moe-wide-mla's mixed shape and a 512-token
    chunk at kv 2048; K3 at decode B=64 + 2 idle and at B=1 over kv 1 and 17."""
    bf = torch.bfloat16
    k1 = (("decode", decode_case(bf, device)), ("mixed", mixed_case(bf, device)),
          ("verify", verify_case(bf, device)),
          ("long_context_b4", long_decode_case(bf, device, 6, kv=[3000, 4711, 6150, 8192])))
    lat = (("mixed", mixed_case(bf, device, latent=True)),
           ("chunk512_kv2048", chunk_case(bf, device, 512, 2048, 7, latent=True)))
    k3 = (("decode", latent_decode_case(bf, device)),
          ("b1_kv1", latent_decode_case(bf, device, 10, [1])),
          ("b1_kv17", latent_decode_case(bf, device, 11, [17])))
    for kernel, cases in (("paged_attention", k1), ("paged_attention_latent", lat),
                          ("mla_decode", k3)):
        for label, c in cases:
            yield kernel, label, dict(c, pool=fp8_pool(c["pool"]))


def check_fp8(device) -> dict:
    """The fp8 variants of K1 (both modes) and K3, each case three ways:
    the bf16 q over the fp8 pool on ``mma_fp8`` equals the ``mma`` instance on
    the pool upcast to bf16, bit for bit (the same plan; the variant only
    converts each stage in shared memory); it reads <= 1 bf16 rounding unit
    against the plain version in float32 (which upcasts the fp8 pool at
    use), with the bf16 controls still above 1; a float32 q over the same
    fp8 pool on ``simt_fp8`` is within F32_ATOL of the plain version. K3 at
    kv 1 must return the latent row exactly; padding and idle rows are
    zeros."""
    from llmd_tpu_torch.ops import mla_decode as md
    from llmd_tpu_torch.ops import paged_attention as pa
    from llmd_tpu_torch.ops.paged_attention import bf16_rounding_units

    bf = torch.bfloat16
    out: dict = {}
    for kernel, label, c in fp8_attention_cases(device):
        c16 = dict(c, pool=c["pool"].to(bf))  # the upcast twin
        c32 = dict(c, q=c["q"].float())
        if kernel == "mla_decode":
            fn, run, plain = md.mla_decode, run_latent_decode, md.mla_decode_ref
            got = _one_launch(fn, "mma_fp8", lambda: run(fn, c))
            twin = _one_launch(fn, "mma", lambda: run(fn, c16))
            got32 = _one_launch(fn, "simt_fp8", lambda: run(fn, c32))
            bit_equal = torch.equal(got, twin)
            pts = c["pts"].clamp(min=0)
            q_scaled = (c["q"].float() * c["scale"]).to(bf).float()
            live = c["lens"] > 0
            ref = plain(q_scaled, c["pool"], pts, c["lens"], scale=1.0)[live]
            ref32 = plain(c32["q"] * c["scale"], c["pool"], pts, c["lens"], scale=1.0)[live]
            pad = max(_max_abs(got[~live]), _max_abs(got32[~live]))
            got, got32 = got[live], got32[live]
            if int(c["kv_lens"].max()) <= 1:  # one key: the latent row itself
                units, ctl = (0.0 if torch.equal(got.float(), ref) else float("inf")), ()
            else:
                units = bf16_rounding_units(got, ref)
                ctl = tuple(bf16_rounding_units(x, ref)
                            for x in latent_decode_controls(c16, q_scaled))
        else:
            fn, plain = pa.paged_attention, pa.paged_attention_ref
            got = _one_launch(fn, "mma_fp8", lambda: run_attention(fn, c))
            twin = _one_launch(fn, "mma", lambda: run_attention(fn, c16))
            got32 = _one_launch(fn, "simt_fp8", lambda: run_attention(fn, c32))
            v = c["valid"]
            ref = ref32 = run_attention(plain, c32)[:v]  # upcasts the fp8 pool at use
            pad = max(_max_abs(got[v:]), _max_abs(got32[v:]))
            bit_equal = torch.equal(got, twin)
            got, got32 = got[:v], got32[:v]
            units = bf16_rounding_units(got, ref)
            ctl = (bf16_rounding_units(run_attention(plain, c16)[:v], ref),
                   bf16_rounding_units(bf16_accumulating_control(c16), ref))
        err32 = (got32 - ref32).abs().max().item()
        err = (got.float() - ref).abs().max().item()
        row = {"bit_equal_to_bf16_twin": bit_equal, "bf16_units": units,
               "limit_units": BF16_UNITS, "controls_bf16_units": list(ctl),
               "max_abs_err": err, "f32_max_abs_err": err32, "atol": F32_ATOL,
               "pad_rows_max": pad, "kv_tokens": int(c["kv_lens"].sum())}
        log(f"check: fp8 {kernel} {label} kv_tokens={row['kv_tokens']} bit_equal_to_bf16_"
            f"twin={bit_equal} bf16_units={units:.3f} (limit {BF16_UNITS}) controls="
            f"{[round(x, 1) for x in ctl]} max_abs_err={err:.3e} f32_simt_fp8_max_abs_err="
            f"{err32:.3e} (atol {F32_ATOL:.0e}) pad_rows_max={pad:.1e}")
        out.setdefault(kernel, {})[label] = row
        if not (bit_equal and units <= BF16_UNITS and all(x > BF16_UNITS for x in ctl)
                and err32 <= F32_ATOL and pad == 0.0 and torch.isfinite(got).all()):
            raise AssertionError(f"fp8 {kernel} {label}: the check failed: {row}")
    return out


def time_fp8(device) -> dict:
    """The fp8 variants at the time phase's shapes, each beside its bf16 twin
    (the ``mma`` instance on the same data upcast to bf16) in turns: K1 at
    decode B=64, decode B=8 (kv 3072-5120), mixed and verify; K1's latent mode
    at the mixed shape; K3 at decode B=64 + 2 idle and B=8. The bound counts 1
    byte a K/V element (``bound_ms``; the bf16 twin's ``bf16_bound_ms``); the
    library call is SDPA over K/V gathered and upcast to bf16 in set-up; the
    plain version runs over the fp8 pool (it upcasts at use)."""
    from llmd_tpu_torch.ops import mla_decode as md
    from llmd_tpu_torch.ops import paged_attention as pa

    bf = torch.bfloat16
    rng = np.random.default_rng(4)
    k1 = {"decode": (decode_case(bf, device), sdpa_dense),
          "decode_b8": (long_decode_case(bf, device), sdpa_dense),
          "mixed": (mixed_case(bf, device), sdpa_packed),
          "verify": (verify_case(bf, device), sdpa_packed)}
    cases = [("paged_attention", k, c, lib) for k, (c, lib) in k1.items()]
    cases.append(("paged_attention_latent", "mixed", mixed_case(bf, device, latent=True),
                  sdpa_latent))
    cases += [("mla_decode", "decode", latent_decode_case(bf, device), sdpa_latent),
              ("mla_decode", "decode_b8",
               latent_decode_case(bf, device, 4, rng.integers(3072, 5121, 8)), sdpa_latent)]
    out: dict = {}
    for kernel, label, c, library in cases:
        c8 = dict(c, pool=fp8_pool(c["pool"]))
        c16 = dict(c8, pool=c8["pool"].to(bf))
        if kernel == "mla_decode":
            call = lambda x: run_latent_decode(md.mla_decode, x)  # noqa: E731
            plain = lambda: run_latent_decode(md.mla_decode_ref, c8)  # noqa: E731
            bound, bound16 = (latent_decode_bound(c8, bf, FP8), latent_decode_bound(c8, bf))
        else:
            call = lambda x: run_attention(pa.paged_attention, x)  # noqa: E731
            plain = lambda: run_attention(pa.paged_attention_ref, c8)  # noqa: E731
            bound, bound16 = attention_bound(c8, bf, FP8), attention_bound(c8, bf)
        ms, bf16_ms = cuda_ms(lambda: call(c8)), cuda_ms(lambda: call(c16))
        ms2, bf16_ms2 = cuda_ms(lambda: call(c16)), cuda_ms(lambda: call(c8))
        plain_ms = cuda_ms(plain, reps=5, inner=2)
        library_ms = cuda_ms(library(c16))
        row = {"ms": ms, "ms_turn2": bf16_ms2, "bf16_ms": bf16_ms, "bf16_ms_turn2": ms2,
               "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
               "bf16_bound_ms": bound16[0], "library_ms": library_ms,
               "kv_tokens": int(c["kv_lens"].sum()), "query_tokens": int(c["q_lens"].sum())}
        log(f"time: fp8 {kernel} {label} mma_fp8 ms={ms:.4f}/{bf16_ms2:.4f} bf16 twin (mma) "
            f"ms={bf16_ms:.4f}/{ms2:.4f} bound_ms={bound[0]:.4f} ({bound[1]}) bf16_bound_ms="
            f"{bound16[0]:.4f} plain_ms={plain_ms:.4f} library_ms(sdpa, upcast in set-up)="
            f"{library_ms:.4f} roofline_share={bound[0] / ms:.3f}")
        out.setdefault(kernel, {})[label] = row
    return out


def phase_fp8_engine(device, card: str, model: str, per_layer: dict, label: str,
                     engine_kw: "dict | None" = None, seed: int = 0) -> dict:
    """``model`` at full width over an fp8 pool (``kv_cache_dtype="fp8"``):
    behind the server through the captured, pipelined engine (the engine
    phase's checks, every K1 / K3 launch on ``mma_fp8``), then two engines
    of the seed through ``generate``, replayed and eager: tokens, launches
    and instances equal, no plain version."""
    from llmd_tpu_torch.models import get_model_config

    kw = {"kv_cache_dtype": "fp8", **(engine_kw or {})}
    served = phase_engine(device, card, model=model, label=f"fp8 {label}", engine_kw=kw,
                          per_layer=per_layer, attn_instance="mma_fp8")
    cfg = get_model_config(model)
    ekw = dict(page_size=PS, num_pages=2048, max_model_len=2048, max_batch_size=32,
               prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4, **kw)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, 8)]
    runs = {mode: _served_run(device, cfg, ekw, prompts, 32, seed, mode == "graph")
            for mode in ("graph", "eager")}
    g, e = runs["graph"], runs["eager"]
    same = {k: g[k] == e[k] for k in ("tokens", "launches", "launches_by_instance")}
    log(f"engine: fp8 {model} {label} replayed vs eager on {card}: same={same} "
        f"launches={g['launches']} by_instance={g['launches_by_instance']} captures="
        f"{g['captures']} replays={g['replays']}")
    attn_off = {n: by for n, by in g["launches_by_instance"].items()
                if n in ("paged_attention", "mla_decode") and sum(by.values()) != by["mma_fp8"]}
    if (not all(same.values()) or any(g["plain_calls"].values()) or any(e["plain_calls"].values())
            or attn_off or g["captures"] != 1 or not g["launches"]["paged_attention"]):
        raise AssertionError(f"fp8 engine {model}: replayed vs eager {same}, plain "
                             f"{g['plain_calls']} / {e['plain_calls']}, off mma_fp8 {attn_off}, "
                             f"{g['captures']} captures")
    return {"served": served, "same": same, "launches": g["launches"],
            "launches_by_instance": g["launches_by_instance"]}


def fp8_identity(device, card: str, seed: int = 0, n_requests: int = 4) -> dict:
    """llama-1b over an fp8 pool, in float32: the engine on the kernels
    (``simt_fp8``, decode replayed) against the same engine with its
    attention swapped for the plain versions (eager): greedy tokens
    identical. Then in bf16, the share of greedy tokens that the fp8 pool
    and the bf16 pool give alike (kernels on both); not bounded: a different
    pool is a different result."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.ops.paged_attention import paged_attention_ref

    cfg = get_model_config("llama-1b")
    kw = dict(page_size=PS, num_pages=1024, max_model_len=2048, max_batch_size=8,
              prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, n_requests)]
    sp = SamplingParams(max_tokens=32, temperature=0.0)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    runs = {}
    for name in ("kernels", "plain"):
        eng = LLMEngine(cfg32, EngineConfig(**kw, kv_cache_dtype="fp8"), seed=seed,
                        device=device, decode_graph=name == "kernels")
        if name == "plain":
            eng._attn = {"unified": paged_attention_ref, "decode": paged_attention_ref}
        zero_counts()
        runs[name] = (eng.generate(prompts, sp), read_counts(), instance_counts())
        del eng
        torch.cuda.empty_cache()
    (tk, (lk, _), ik), (tp, (lp, pp), _) = runs["kernels"], runs["plain"]
    bf = {}
    for kv in ("fp8", None):
        eng = LLMEngine(cfg, EngineConfig(**kw, kv_cache_dtype=kv), seed=seed, device=device)
        bf[kv] = eng.generate(prompts, sp)
        del eng
        torch.cuda.empty_cache()
    pairs = [(a, b) for r in bf["fp8"] for a, b in zip(bf["fp8"][r], bf[None][r])]
    share = sum(a == b for a, b in pairs) / len(pairs)
    row = {"card": card, "f32_tokens_identical": tk == tp, "kernel_launches": lk,
           "kernel_instances": ik, "plain_run_launches": lp, "plain_run_calls": pp,
           "bf16_fp8_vs_bf16_pool_identical_share": share, "requests": n_requests}
    log(f"identity: fp8 llama-1b on {card}: float32 kernels vs plain tokens_identical="
        f"{tk == tp} (kernel launches {lk['paged_attention']} on {ik['paged_attention']}; "
        f"plain run: paged_attention_ref calls {pp['paged_attention_ref']}); bf16 fp8 pool vs "
        f"bf16 pool identical share={share:.4f} (not bounded)")
    if not (tk == tp and lk["paged_attention"] == ik["paged_attention"]["simt_fp8"] > 0
            and not any(lp.values()) and pp["paged_attention_ref"] > 0):
        raise AssertionError(f"fp8 identity: {row}")
    return row


def phase_fp8(device, card: str) -> dict:
    """The fp8 pool: its kernels checked and timed, llama-1b and moe-wide-mla
    served over it, the float32 identity, and the bench with ``--kv-dtype
    fp8``."""
    k2 = {"ragged_grouped_gemm": (2, "all")}
    return {
        "check": check_fp8(device),
        "time": time_fp8(device),
        "engine": {
            "llama-1b": phase_fp8_engine(device, card, "llama-1b",
                                         {"paged_attention": (1, "all")}, "dense"),
            "mla_sorted": phase_fp8_engine(
                device, card, MLA, {"paged_attention": (1, "unified"),
                                    "mla_decode": (1, "decode"), **k2}, "mla sorted",
                engine_kw={"moe_dispatch": "sorted"}),
        },
        "identity": fp8_identity(device, card),
        "bench": phase_bench(device, card, ["--quantize", "none", "--kv-dtype", "fp8"]),
    }


def fp8_entry(fp8: dict, name: str, source: str, replaces: str, run: str,
              first: str) -> dict:
    """The ``kernels`` line's entry of a kernel's fp8 variant (``name`` +
    ``_fp8``): launches from the fp8 serving run ``run`` (the engine's count
    of the kernel, all on ``mma_fp8``), times at shape ``first``, the other
    timed shapes' numbers as ``<shape>_ms`` / ``_bound_ms`` / ``_library_ms``,
    the bf16 twin's ``bf16_ms`` beside each."""
    kernel = "mla_decode" if name == "mla_decode" else "paged_attention"
    t = fp8["time"][name]
    e = {"name": f"{name}_fp8", "route": "cuda", "source": source, "replaces": replaces,
         "variant": "float8_e4m3 pool (kv_cache_dtype='fp8'), instance mma_fp8",
         "launches": fp8["engine"][run]["served"]["launches"][kernel],
         "max_abs_err": max(r["max_abs_err"] for r in fp8["check"][name].values()),
         "ms": t[first]["ms"], "plain_ms": t[first]["plain_ms"],
         "bound_ms": t[first]["bound_ms"], "bound_by": t[first]["bound_by"],
         "library_ms": t[first]["library_ms"], "bf16_ms": t[first]["bf16_ms"],
         "bf16_bound_ms": t[first]["bf16_bound_ms"]}
    for label, r in t.items():
        if label != first:
            e.update({f"{label}_ms": r["ms"], f"{label}_bound_ms": r["bound_ms"],
                      f"{label}_library_ms": r["library_ms"], f"{label}_bf16_ms": r["bf16_ms"]})
    if name == "paged_attention":
        e["bench_bf16_fp8_launches"] = fp8["bench"]["kernel_launches"]["paged_attention"][
            "mma_fp8"]
    return e


# --------------------------------------------------------------------------
# The KV data plane (P/D disaggregation, the offload tiers)
# --------------------------------------------------------------------------


def _pd_servers(device, cfg, kw: dict, seed: int) -> tuple:
    """A prefill and a decode server of the same weights (``seed``), each
    with a KV-transfer source on a free port (auto: the native transport),
    and the id tokenizer (a text holds its tokens one for one)."""
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer

    servers = []
    for role in ("prefill", "decode"):
        s = EngineServer(cfg, EngineConfig(**kw, role=role), host="127.0.0.1", port=0,
                         kv_transfer_port=0, tokenizer=IdTokenizer(cfg.vocab_size),
                         seed=seed, device=device)
        s.start()
        servers.append(s)
    return tuple(servers)


def _resident_pages(server, token_ids: list) -> torch.Tensor:
    """The pool rows of a prompt's resident complete blocks, block-major, on
    the host (read under the engine lock)."""
    from llmd_tpu_torch.core.kv_events import block_keys_for_tokens
    from llmd_tpu_torch.disagg.transfer import gather_pages

    eng = server.engine

    def read():
        pids = []
        for h in block_keys_for_tokens(token_ids, eng.cfg.page_size):
            if h not in eng.alloc.cached:
                break
            pids.append(eng.alloc.cached[h])
        with eng._on_stream():
            return gather_pages(eng.cache, pids, eng.cfg.num_pages).cpu()

    return server.async_engine.run_locked(read)


def _pd_requests(P, D, prompts: list, max_tokens: int, py_source=None) -> dict:
    """The sidecar's two requests, driven here: each prompt to P with
    ``do_remote_decode`` and ``max_tokens`` 1, then (all P requests done,
    the launch counters zeroed) each prompt to D with ``do_remote_prefill``
    and P's transfer handle, concurrently. With ``py_source``, the second
    half of P's exports register there (the python transport) and the first
    half on P's own source. Returns D's texts, cached tokens, P's and D's
    launches, and the page bytes of both sides for every prompt."""
    from llmd_tpu_torch.disagg.transfer import KVTransferClient

    body = {"max_tokens": 1, "temperature": 0, "ignore_eos": True,
            "kv_transfer_params": {"do_remote_decode": True}}
    handles = []
    own = P.transfer_source
    zero_counts()
    for i, p in enumerate(prompts):
        if py_source is not None and i == len(prompts) // 2:
            P.transfer_source = py_source
        st, r = _post(f"http://{P.address}/v1/completions", {**body, "prompt_token_ids": p})
        if st != 200 or r["kv_transfer_params"]["num_blocks"] != len(p) // PS:
            raise AssertionError(f"kvplane: P's export of prompt {i}: {st} {r}")
        handles.append(r["kv_transfer_params"])
    P.transfer_source = own
    p_launches, p_plain = read_counts()
    p_inst = instance_counts()
    # the exports as a puller sees them (a pull does not release; D's notify does)
    exported = [KVTransferClient().pull(h["remote_host"], h["remote_port"],
                                        h["remote_request_id"]).blocks for h in handles]
    st0 = dataclasses.replace(D.engine.stats)
    zero_counts()
    results: list = [None] * len(prompts)

    def one(i: int) -> None:
        results[i] = _post(f"http://{D.address}/v1/completions", {
            "prompt_token_ids": prompts[i], "max_tokens": max_tokens, "temperature": 0,
            "ignore_eos": True,
            "kv_transfer_params": {"do_remote_prefill": True, **handles[i]}})

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    d_launches, d_plain = read_counts()
    d_inst = instance_counts()
    st = D.engine.stats
    sources = [own] + ([py_source] if py_source is not None else [])
    if any(r is None or r[0] != 200 for r in results):
        raise AssertionError(f"kvplane: D requests failed: {results}")
    injected = [_resident_pages(D, p) for p in prompts]
    return {"texts": [r[1]["choices"][0]["text"] for r in results],
            "cached": [r[1]["usage"]["cached_tokens"] for r in results],
            "exported": exported, "injected": injected, "wall_s": wall,
            "p_launches": p_launches, "p_plain": p_plain,
            "p_by_instance": p_inst, "d_launches": d_launches, "d_plain": d_plain,
            "d_by_instance": d_inst,
            "d_forwards": {"unified": st.n_unified_steps - st0.n_unified_steps,
                           "decode": st.n_decode_iterations - st0.n_decode_iterations},
            "d_replays": st.decode_graph_replays - st0.decode_graph_replays,
            "left_on_p": sum(len(s) for s in sources),
            "notifies": sum(s.stats["notifies"] for s in sources)}


def _aggregated(device, cfg, kw: dict, seed: int, prompts: list, max_tokens: int) -> list:
    """One engine of the same weights serving the prompts alone: its texts
    in the id tokenizer's spelling."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine

    eng = LLMEngine(cfg, EngineConfig(**kw), seed=seed, device=device)
    out = eng.generate(prompts, SamplingParams(max_tokens=max_tokens, temperature=0.0,
                                               ignore_eos=True))
    del eng
    tok = IdTokenizer(cfg.vocab_size)
    return [tok.decode(out[f"req-{i}"]) for i in range(len(prompts))]


def _check_pd(label: str, cfg, run: dict, prompts: list, ps: int, d_kernels: dict,
              p_kernels: dict, instance: str, device) -> dict:
    """Page bytes, cached tokens, launches on their instance, no plain run."""
    same_bytes = all(torch.equal(e.view(torch.uint8), i.view(torch.uint8))
                     for e, i in zip(run["exported"], run["injected"]))
    want_cached = [(len(p) - 1) // ps * ps for p in prompts]
    row = {"pages_equal": same_bytes, "cached_tokens": run["cached"],
           "expected_cached": want_cached, "left_on_p": run["left_on_p"],
           "notifies": run["notifies"], "d_launches": run["d_launches"],
           "p_launches": run["p_launches"], "d_by_instance": run["d_by_instance"],
           "d_forwards": run["d_forwards"], "d_replays": run["d_replays"],
           "injected_blocks": sum(int(i.shape[0]) for i in run["injected"])}
    problems = []
    if not same_bytes:
        problems.append("D's injected pages differ from P's exports")
    if run["cached"] != want_cached:
        problems.append(f"cached_tokens {run['cached']} != {want_cached}")
    if run["left_on_p"] or run["notifies"] != len(prompts):
        problems.append(f"exports left on P {run['left_on_p']}, notifies {run['notifies']}")
    if device.type == "cuda":
        fwd = run["d_forwards"]
        for name, program in d_kernels.items():
            n = cfg.num_layers * (fwd["unified"] + fwd["decode"] if program == "all"
                                  else fwd[program])
            if run["d_launches"][name] != n or n == 0:
                problems.append(f"D {name} launches {run['d_launches'][name]} != {n}")
            by = run["d_by_instance"][name]
            if by.get(instance, 0) != n or sum(by.values()) != n:
                problems.append(f"D {name} launches {by} not all on {instance}")
        for name in p_kernels:
            if run["p_launches"][name] == 0:
                problems.append(f"P never launched {name}")
        if any(run["d_plain"].values()) or any(run["p_plain"].values()):
            problems.append(f"plain versions ran: P {run['p_plain']} D {run['d_plain']}")
        if run["d_replays"] == 0:
            problems.append("D's decode never replayed its captured graph")
    if problems:
        raise AssertionError(f"kvplane {label}: {problems}")
    return row


def _pd_case(device, card: str, model: str, dtype: str, kv_cache_dtype, n: int,
             lengths: tuple, max_tokens: int, seed: int, label: str,
             d_kernels: dict, p_kernels: dict, instance: str, layers=None,
             both_transports: bool = False, ttft: bool = False) -> dict:
    """One P/D case: two servers, the prompts through them, the checks, the
    aggregated control; with ``ttft`` also TTFT aggregated against
    disaggregated on 1024-token prompts."""
    from llmd_tpu_torch.disagg.transfer import KVTransferSource
    from llmd_tpu_torch.models import get_model_config

    over = {"dtype": dtype} | ({"num_layers": layers} if layers else {})
    cfg = dataclasses.replace(get_model_config(model), **over)
    kw = dict(page_size=PS, num_pages=1024, max_model_len=2048, max_batch_size=8,
              prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4,
              kv_cache_dtype=kv_cache_dtype)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(k)).tolist()
               for k in rng.integers(lengths[0], lengths[1] + 1, n)]
    P, D = _pd_servers(device, cfg, kw, seed)
    py = None
    row: dict = {"card": card, "model": model, "dtype": dtype, "layers": cfg.num_layers,
                 "kv_cache_dtype": kv_cache_dtype or dtype, "prompts": n,
                 "prompt_tokens": [len(p) for p in prompts], "max_tokens": max_tokens,
                 "transport": "native" if P.transfer_source.native else "python"}
    try:
        if both_transports:
            py = KVTransferSource(host="127.0.0.1", transport="python")
            py.start()
            row["transports"] = [row["transport"], "python"]
        run = _pd_requests(P, D, prompts, max_tokens, py_source=py)
        row.update(_check_pd(label, cfg, run, prompts, PS, d_kernels, p_kernels,
                             instance, device))
        if ttft:
            row["ttft"] = _ttft(P, D, cfg, seed)
    finally:
        if py is not None:
            py.stop()
        P.stop()
        D.stop()
        del P, D
        torch.cuda.empty_cache()
    control = _aggregated(device, cfg, kw, seed, prompts, max_tokens)
    same = [a == b for a, b in zip(run["texts"], control)]
    toks = sum(len(t) for t in control)
    agree = sum(sum(x == y for x, y in zip(a, b)) for a, b in zip(run["texts"], control))
    row.update(tokens_identical=all(same), identical_token_share=agree / max(1, toks),
               d_wall_s=run["wall_s"])
    log(f"kvplane: P/D {label} on {card}: {n} prompts {min(row['prompt_tokens'])}-"
        f"{max(row['prompt_tokens'])} tokens x {max_tokens}, transport "
        f"{row.get('transports', row['transport'])}: pages_equal={row['pages_equal']} "
        f"cached_tokens_ok={row['cached_tokens'] == row['expected_cached']} "
        f"injected_blocks={row['injected_blocks']} tokens_identical={all(same)} "
        f"identical_token_share={row['identical_token_share']:.4f}")
    log(f"kvplane:   D launches={row['d_launches']} by_instance={row['d_by_instance']} "
        f"forwards={row['d_forwards']} replays={row['d_replays']} "
        f"P launches={row['p_launches']}")
    if dtype == "float32" and not all(same):
        raise AssertionError(f"kvplane {label}: D's greedy tokens differ from the "
                             f"aggregated engine's ({same})")
    return row


def _ttft(P, D, cfg, seed: int, n: int = 4, isl: int = 1024) -> dict:
    """TTFT of a fresh 1024-token prompt: aggregated = one max_tokens 1
    request to P alone; disaggregated = P's export request plus D's pulling
    request (max_tokens 1), driven back to back as the sidecar drives them."""
    rng = np.random.default_rng(seed + 99)
    agg, dis = [], []
    for i in range(n):
        a, b = (rng.integers(1, cfg.vocab_size, isl).tolist() for _ in range(2))
        t0 = time.perf_counter()
        _post(f"http://{P.address}/v1/completions", {"prompt_token_ids": a, "max_tokens": 1,
                                                     "temperature": 0, "ignore_eos": True})
        agg.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _, r = _post(f"http://{P.address}/v1/completions", {
            "prompt_token_ids": b, "max_tokens": 1, "temperature": 0, "ignore_eos": True,
            "kv_transfer_params": {"do_remote_decode": True}})
        _post(f"http://{D.address}/v1/completions", {
            "prompt_token_ids": b, "max_tokens": 1, "temperature": 0, "ignore_eos": True,
            "kv_transfer_params": {"do_remote_prefill": True, **r["kv_transfer_params"]}})
        dis.append(time.perf_counter() - t0)
    return {"isl": isl, "aggregated_ms": [x * 1e3 for x in agg],
            "disaggregated_ms": [x * 1e3 for x in dis],
            "aggregated_p50_ms": statistics.median(agg) * 1e3,
            "disaggregated_p50_ms": statistics.median(dis) * 1e3}


def _transfer_numbers(device, card: str, reps: int = 5) -> dict:
    """The data plane's byte movers at llama-1b's bf16 block (16 layers x 16
    tokens x 16 planes x 64 x 2 B = 512 KiB): the staged export's D2H and the
    inject's H2D per block beside a plain pinned ``copy_`` of the same bytes,
    and a 64-block (32 MiB) pull over loopback on each transport beside a
    host copy of the same bytes. Informational: no bound is enforced."""
    from llmd_tpu_torch.disagg.transfer import (
        KVTransferClient, KVTransferSource, drain_staged, gather_pages, insert_blocks,
        stage_pages)

    L, P, n = 16, 256, 64
    pool = torch.randn(L * P + 1, PS, 16, 64, device=device, dtype=torch.bfloat16)
    block = L * PS * 16 * 64 * 2
    pids = list(range(0, 2 * n, 2))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def best(fn) -> float:
        ts = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    gather = functools.partial(gather_pages, pool, pages_per_layer=P)
    staged = best(lambda: drain_staged(stage_pages(gather, pids, staging_pages=16)))
    flat = torch.randn(n * block // 2, device=device, dtype=torch.bfloat16)
    pinned = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=device.type == "cuda")
    d2h = best(lambda: pinned.copy_(flat))
    host_blocks = drain_staged(stage_pages(gather, pids))
    if device.type == "cuda":
        host_blocks = host_blocks.pin_memory()
    inject = best(lambda: insert_blocks(pool, [p + 1 for p in pids], host_blocks, P))
    h2d = best(lambda: flat.copy_(pinned))
    pulls = {}
    payload = host_blocks.contiguous()
    for transport in ("native", "python"):
        src = KVTransferSource(host="127.0.0.1", transport=transport)
        src.start()
        try:
            src.register("bench", list(range(n)), [[] for _ in range(n)], payload)
            cli = KVTransferClient()
            got = cli.pull("127.0.0.1", src.port, "bench")
            assert torch.equal(got.blocks.view(torch.uint8), payload.view(torch.uint8))
            pulls[transport] = best(lambda: cli.pull("127.0.0.1", src.port, "bench"))
        finally:
            src.stop()
    src_bytes = bytearray(n * block)
    memcpy = best(lambda: bytes(src_bytes))
    gbs = lambda s, b: b / s / 1e9  # noqa: E731
    row = {"card": card, "block_bytes": block, "blocks": n,
           "staged_export_ms_per_block": staged / n * 1e3,
           "staged_export_gb_s": gbs(staged, n * block),
           "pinned_d2h_copy_gb_s": gbs(d2h, n * block),
           "inject_ms_per_block": inject / n * 1e3, "inject_gb_s": gbs(inject, n * block),
           "pinned_h2d_copy_gb_s": gbs(h2d, n * block),
           "pull_ms": {k: v * 1e3 for k, v in pulls.items()},
           "pull_mb_s": {k: n * block / v / 1e6 for k, v in pulls.items()},
           "host_memcpy_ms": memcpy * 1e3, "host_memcpy_mb_s": n * block / memcpy / 1e6}
    log(f"kvplane: transfer on {card}: block {block} B; staged export D2H "
        f"{row['staged_export_gb_s']:.3f} GB/s ({row['staged_export_ms_per_block']:.4f} "
        f"ms/block) vs pinned copy_ {row['pinned_d2h_copy_gb_s']:.3f} GB/s; inject H2D "
        f"{row['inject_gb_s']:.3f} GB/s ({row['inject_ms_per_block']:.4f} ms/block) vs "
        f"pinned copy_ {row['pinned_h2d_copy_gb_s']:.3f} GB/s; pull of {n} blocks "
        f"({n * block} B) native {row['pull_ms']['native']:.3f} ms "
        f"({row['pull_mb_s']['native']:.1f} MB/s), python {row['pull_ms']['python']:.3f} "
        f"ms ({row['pull_mb_s']['python']:.1f} MB/s) vs host memcpy "
        f"{row['host_memcpy_ms']:.3f} ms")
    del pool, flat, pinned
    torch.cuda.empty_cache()
    return row


def _offload_case(device, card: str, seed: int = 0, n: int = 4, isl: int = 512,
                  max_tokens: int = 16, model: str = "llama-1b") -> dict:
    """llama-1b in float32 over a pool that holds one prompt set: a second
    set evicts the first to the CPU tier, which demotes to FS (a gitignored
    directory of the checkout, deleted after). The first set again reloads
    rather than recomputes, with the first run's tokens, K1 launched over the
    reloaded pages on its f32 instance, no plain version; demote and reload
    ms per block."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config

    cfg = dataclasses.replace(get_model_config(model), dtype="float32")
    fs_dir = REPO / "checkpoints" / "chip-smoke-kv-fs"
    shutil.rmtree(fs_dir, ignore_errors=True)
    blocks_per_set = n * (isl // PS)
    kw = dict(page_size=PS, num_pages=blocks_per_set + n * 4, max_model_len=2048,
              max_batch_size=n, prefill_chunk=512, max_num_batched_tokens=2048,
              decode_steps=4, cpu_offload_pages=blocks_per_set // 2,
              offload_fs_path=str(fs_dir))
    rng = np.random.default_rng(seed)
    first, second = ([rng.integers(1, cfg.vocab_size, isl).tolist() for _ in range(n)]
                     for _ in range(2))
    sp = SamplingParams(max_tokens=max_tokens, temperature=0.0, ignore_eos=True)
    eng = LLMEngine(cfg, EngineConfig(**kw), seed=seed, device=device)
    timing = {"demote": [0.0, 0], "evict": [0.0, 0], "reload": [0.0, 0]}
    off = eng.offload
    demote, evict, load = off.demote_batch, off.on_evict, off.load_into_cache

    def timed_evict(cache, h, pid):
        t0 = time.perf_counter()
        evict(cache, h, pid)
        timing["evict"][0] += time.perf_counter() - t0
        timing["evict"][1] += 1

    def timed_demote(cache, pairs):
        t0 = time.perf_counter()
        demote(cache, pairs)
        timing["demote"][0] += time.perf_counter() - t0
        timing["demote"][1] += len(pairs)

    def timed_load(cache, hashes, pids, request_id=None):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = load(cache, hashes, pids, request_id)
        if device.type == "cuda":
            torch.cuda.synchronize()
        timing["reload"][0] += time.perf_counter() - t0
        timing["reload"][1] += out[1]
        return out

    off.demote_batch, off.on_evict, off.load_into_cache = timed_demote, timed_evict, timed_load
    ptr = eng.cache.data_ptr()
    try:
        cold = eng.generate(first, sp)
        eng.generate(second, sp)
        st = eng.stats
        prefill0, loads0 = st.total_prefill_tokens, st.total_offload_loads
        fwd0 = (st.n_unified_steps, st.n_decode_iterations)
        zero_counts()
        again = eng.generate(first, sp)
        launches, plain = read_counts()
        by_inst = instance_counts()
        reprefill = st.total_prefill_tokens - prefill0
        loads = st.total_offload_loads - loads0
        forwards = (st.n_unified_steps - fwd0[0]) + (st.n_decode_iterations - fwd0[1])
        store = off.store
        row = {"card": card, "model": model, "dtype": "float32", "prompts": n, "isl": isl,
               "pool_pages": kw["num_pages"], "cpu_blocks": kw["cpu_offload_pages"],
               "tokens_equal": again == cold, "offload_loads": loads,
               "reprefill_tokens": reprefill, "saves": store.saves,
               "demotions": store.demotions, "cpu_loads": store.loads,
               "k1_launches": launches["paged_attention"],
               "k1_by_instance": by_inst["paged_attention"], "plain_calls": plain,
               "demote_ms_per_block": timing["demote"][0] / max(1, timing["demote"][1]) * 1e3,
               "demoted_blocks": timing["demote"][1],
               "evict_ms_per_block": timing["evict"][0] / max(1, timing["evict"][1]) * 1e3,
               "evicted_blocks": timing["evict"][1],
               "reload_ms_per_block": timing["reload"][0] / max(1, timing["reload"][1]) * 1e3,
               "reloaded_blocks": timing["reload"][1],
               "pool_address_unchanged": eng.cache.data_ptr() == ptr}
    finally:
        del eng
        torch.cuda.empty_cache()
        shutil.rmtree(fs_dir, ignore_errors=True)
    log(f"kvplane: offload {model} f32 on {card}: {n} x {isl} tokens, pool "
        f"{row['pool_pages']} pages, CPU {row['cpu_blocks']} blocks + FS: saves "
        f"{row['saves']} demotions_to_fs {row['demotions']} offload_loads {loads} "
        f"reprefill_tokens {reprefill} of {n * isl} tokens_equal={row['tokens_equal']} "
        f"demote {row['demote_ms_per_block']:.4f} ms/block ({row['demoted_blocks']} "
        f"blocks in batches) evict {row['evict_ms_per_block']:.4f} ms/block "
        f"({row['evicted_blocks']} one by one) reload {row['reload_ms_per_block']:.4f} ms/block "
        f"({row['reloaded_blocks']} blocks) K1 {row['k1_by_instance']}")
    problems = []
    if not (row["tokens_equal"] and loads > 0 and reprefill < n * isl
            and row["demotions"] > 0 and row["pool_address_unchanged"]):
        problems.append("the rerun did not reload from the tiers with the same tokens")
    if device.type == "cuda":
        if launches["paged_attention"] != cfg.num_layers * forwards or any(plain.values()):
            problems.append(f"K1 launches {launches} over {forwards} forwards, plain {plain}")
        if by_inst["paged_attention"].get("simt", 0) != launches["paged_attention"]:
            problems.append(f"K1 not all on simt: {by_inst['paged_attention']}")
    if problems:
        raise AssertionError(f"kvplane offload: {problems} {row}")
    return row


def phase_kvplane(device, card: str, seed: int = 0, dense: str = "llama-1b",
                  mla: str = MLA, n_requests: int = 8, max_tokens: int = 32) -> dict:
    """The KV data plane on the card: P/D between two port servers (the
    sidecar's two requests driven here, over loopback), llama-1b in float32
    on both transports, bf16 and an fp8 pool, moe-wide-mla at 2 layers in
    float32; the offload tiers; the transfer numbers."""
    k1_all = {"paged_attention": "all"}
    out = {"pd_f32": _pd_case(
        device, card, dense, "float32", None, n_requests, (256, 1024), max_tokens, seed,
        f"{dense} f32", k1_all, ("paged_attention",), "simt", both_transports=True)}
    out["pd_bf16"] = _pd_case(
        device, card, dense, "bfloat16", None, 4, (256, 1024), max_tokens, seed + 1,
        f"{dense} bf16", k1_all, ("paged_attention",), "mma", ttft=True)
    out["pd_fp8"] = _pd_case(
        device, card, dense, "bfloat16", "fp8", 4, (256, 1024), max_tokens, seed + 2,
        f"{dense} bf16 + fp8 pool", k1_all, ("paged_attention",), "mma_fp8")
    # MLA: P's unified program runs K1's latent mode, D's decode program K3
    out["pd_mla"] = _pd_case(
        device, card, mla, "float32", None, 4, (256, 1024), max_tokens, seed + 3,
        f"{mla} 2 layers f32", {"paged_attention": "unified", "mla_decode": "decode"},
        ("paged_attention",), "simt", layers=2)
    out["offload"] = _offload_case(device, card, seed, model=dense)
    out["transfer"] = _transfer_numbers(device, card)
    t = out["pd_bf16"]["ttft"]
    log(f"kvplane: TTFT on {card} ({t['isl']}-token prompts, llama-1b bf16): aggregated "
        f"p50 {t['aggregated_p50_ms']:.3f} ms, disaggregated p50 "
        f"{t['disaggregated_p50_ms']:.3f} ms")
    return out


# --------------------------------------------------------------------------
# Multi-adapter LoRA and the embed program
# --------------------------------------------------------------------------

LORA_KW = dict(page_size=PS, num_pages=2048, max_model_len=2048, max_batch_size=32,
               prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)


def _adapters(device, cfg, n: int, seed: int, first: int = 0) -> dict:
    """``n`` adapters (rank 8) drawn from a seeded generator on the card, in
    ``cfg``'s dtype: ``ad-<first>`` ..."""
    from llmd_tpu_torch.models.lora import LoRAConfig, make_adapter_weights

    return {f"ad-{i}": make_adapter_weights(
        cfg, LoRAConfig(), torch.Generator(device=device).manual_seed(seed + 100 + i))
        for i in range(first, first + n)}


def _lora_engine(device, cfg, adapters: dict, lora: bool = True, plain: bool = False,
                 decode_graph: bool = True, seed: int = 0, **kw):
    """An engine of the serving settings under ``LoRAConfig(max_adapters=8,
    rank=8)`` (or none) with ``adapters`` loaded, warmed up (its decode
    program captured unless ``plain`` or ``decode_graph=False``). ``plain``:
    the attention and, on MoE, the sorted dispatch's expert GEMMs run their
    plain versions, eagerly."""
    import functools

    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models.lora import LoRAConfig
    from llmd_tpu_torch.ops.grouped_gemm import ragged_grouped_gemm_ref
    from llmd_tpu_torch.ops.moe_dispatch import sorted_moe_local
    from llmd_tpu_torch.ops.paged_attention import paged_attention_ref

    eng = LLMEngine(cfg, EngineConfig(**(LORA_KW | kw), lora=LoRAConfig() if lora else None),
                    seed=seed, device=device, decode_graph=decode_graph and not plain)
    if plain:
        eng._attn = {"unified": paged_attention_ref, "decode": paged_attention_ref}
        if cfg.is_moe:
            eng._moe_dispatch_impl = functools.partial(sorted_moe_local,
                                                       gemm=ragged_grouped_gemm_ref)
    for name, w in adapters.items():
        eng.load_lora_adapter(name, w)
    eng.generate([[1, 2, 3]], SamplingParams(max_tokens=2 * eng.cfg.decode_steps + 2,
                                             temperature=0.0))
    return eng


_WINDOWS = itertools.count()


def _lora_window(eng, reqs: list, max_tokens: int) -> dict:
    """``reqs`` = (prompt, adapter or None) through the engine's steps, the
    counters zeroed just before and read just after: tokens per request (in
    order), launches, plain calls, instances and the engine's counts."""
    from llmd_tpu_torch.core.request import SamplingParams

    st0 = dataclasses.replace(eng.stats)
    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (lambda: None)
    sync()
    zero_counts()
    t0 = time.perf_counter()
    window = next(_WINDOWS)
    rids = [f"lora-{window}-{i}" for i in range(len(reqs))]
    for rid, (prompt, lora) in zip(rids, reqs):
        eng.add_request(rid, prompt, SamplingParams(max_tokens=max_tokens, temperature=0.0),
                        lora_id=lora)
    out: dict = {rid: [] for rid in rids}
    while eng.has_work():
        for o in eng.step():
            out[o.request_id].extend(o.new_token_ids)
    sync()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    st = eng.stats
    d = {k: getattr(st, k) - getattr(st0, k) for k in (
        "n_unified_steps", "n_decode_iterations", "n_spec_verify_steps", "n_decode_calls",
        "decode_graph_replays", "spec_drafted", "spec_accepted", "moe_dropped_tokens",
        "decode_tokens_fused")}
    d["time_decode_steps"] = st.time_decode_steps - st0.time_decode_steps
    return {"tokens": list(out.values()), "launches": launches, "plain_calls": plain_calls,
            "launches_by_instance": instance_counts(), "wall_s": wall, **d}


def _check_lora_launches(label: str, cfg, run: dict, per: dict, instance: str) -> None:
    """Each kernel of ``per`` (name -> launches per layer and forward)
    launched that many times per layer of every forward of the window, all
    on ``instance`` (K2 on ``wgmma`` for bf16, ``simt`` for float32), no
    plain version, no other kernel. On the card only."""
    if not torch.cuda.is_available():
        return
    forwards = run["n_unified_steps"] + run["n_decode_iterations"] + run["n_spec_verify_steps"]
    expect = {n: per.get(n, 0) * cfg.num_layers * forwards for n in run["launches"]}
    gemm_instance = "wgmma" if instance == "mma" else "simt"
    wrong = {n: by for n, by in run["launches_by_instance"].items()
             if by != {k: (run["launches"][n] if k == (gemm_instance if "gemm" in n else instance)
                           else 0) for k in by}}
    if run["launches"] != expect or any(run["plain_calls"].values()) or wrong:
        raise AssertionError(f"lora {label}: launches {run['launches']} expected {expect}, "
                             f"instances {wrong}, plain calls {run['plain_calls']}")


def _lora_requests(cfg, names: list, n_per: int, prompt_range, seed: int) -> list:
    """``n_per`` base requests and ``n_per`` per adapter, random prompts."""
    rng = np.random.default_rng(seed)
    loras = [None] * n_per + [n for n in names for _ in range(n_per)]
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(prompt_range[0],
                                                                prompt_range[1] + 1))).tolist(),
             lora) for lora in loras]


def _empty() -> None:
    """Hand the cached blocks of the engines just dropped back to the card
    (``empty_cache``), and say how much is still allocated. An engine frees
    its memory at its last reference (``EngineServer.stop`` closes the engine
    it built: ``LLMEngine.close``), so no cycle collection is needed."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        log(f"memory: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved between phases")


def lora_f32_identities(device, card: str, model: str, seed: int, n_per: int,
                        prompt_range, max_tokens: int) -> dict:
    """float32 ``model`` at full width and depth: 2 base + 2 per adapter
    (3 adapters) greedy requests. Kernels = plain versions in every row;
    the base rows = an engine without LoRA; each adapter's rows = a batch of
    that adapter alone; each adapter changes at least one token against the
    base model on its prompts."""
    from llmd_tpu_torch.models import get_model_config

    cfg = dataclasses.replace(get_model_config(model), dtype="float32")
    ads = _adapters(device, cfg, 3, seed)
    reqs = _lora_requests(cfg, list(ads), n_per, prompt_range, seed)
    eng = _lora_engine(device, cfg, ads, seed=seed)
    kern = _lora_window(eng, reqs, max_tokens)
    _check_lora_launches(f"{model} f32 kernels", cfg, kern, {"paged_attention": 1}, "simt")
    del eng
    _empty()
    eng = _lora_engine(device, cfg, ads, plain=True, seed=seed)
    plain = _lora_window(eng, reqs, max_tokens)
    del eng
    _empty()
    if device.type == "cuda" and (any(plain["launches"].values())
                                  or not plain["plain_calls"]["paged_attention_ref"]):
        raise AssertionError(f"lora {model}: the plain run launched kernels {plain}")
    eng = _lora_engine(device, cfg, {}, lora=False, seed=seed)
    base = _lora_window(eng, [(p, None) for p, _ in reqs], max_tokens)
    del eng
    _empty()
    eng = _lora_engine(device, cfg, ads, seed=seed)
    alone = {}
    for name in ads:
        idx = [i for i, (_, lora) in enumerate(reqs) if lora == name]
        r = _lora_window(eng, [reqs[i] for i in idx], max_tokens)
        alone[name] = dict(zip(idx, r["tokens"]))
    del eng
    _empty()
    toks = kern["tokens"]
    same_plain = toks == plain["tokens"]
    base_rows = [i for i, (_, lora) in enumerate(reqs) if lora is None]
    same_base = all(toks[i] == base["tokens"][i] for i in base_rows)
    same_alone = all(toks[i] == t for rows in alone.values() for i, t in rows.items())
    differs = {name: any(toks[i] != base["tokens"][i] for i in rows)
               for name, rows in alone.items()}
    row = {"model": model, "requests": len(reqs), "same_kernel_plain": same_plain,
           "same_base_rows_as_no_lora": same_base, "same_alone": same_alone,
           "adapter_differs_from_base": differs, "launches": kern["launches"],
           "unified_steps": kern["n_unified_steps"],
           "decode_iterations": kern["n_decode_iterations"],
           "launches_by_instance": kern["launches_by_instance"]}
    log(f"lora: {model} float32 on {card}: {len(reqs)} requests (2 base + 2 x 3 adapters) "
        f"kernels=plain {same_plain} base rows=no-LoRA engine {same_base} adapter rows="
        f"alone {same_alone} adapter differs from base {differs} launches={kern['launches']} "
        f"(unified {kern['n_unified_steps']} + decode {kern['n_decode_iterations']} forwards)")
    if not (same_plain and same_base and same_alone and all(differs.values())):
        raise AssertionError(f"lora {model} float32: {row}")
    return row


def lora_graph_vs_eager(device, card: str, model: str, seed: int, n_per: int,
                        prompt_range, max_tokens: int) -> dict:
    """bf16: the decode program replayed from its graph = eager, tokens and
    launches, with a fourth adapter loaded after the capture (the bank is
    written in place: the graph reads it)."""
    from llmd_tpu_torch.models import get_model_config

    cfg = get_model_config(model)
    ads = _adapters(device, cfg, 3, seed)
    late = _adapters(device, cfg, 1, seed, first=3)
    reqs = _lora_requests(cfg, list(ads), n_per, prompt_range, seed + 1)
    rng = np.random.default_rng(seed + 2)
    reqs2 = [(rng.integers(0, cfg.vocab_size, 200).tolist(), lora)
             for lora in ("ad-3", "ad-3", "ad-0", None)]
    runs = {}
    for graph in (True, False):
        eng = _lora_engine(device, cfg, ads, decode_graph=graph, seed=seed)
        first = _lora_window(eng, reqs, max_tokens)
        for name, w in late.items():
            eng.load_lora_adapter(name, w)
        second = _lora_window(eng, reqs2, max_tokens)
        runs[graph] = (first, second, eng.stats.decode_graph_captures)
        del eng
    _empty()
    (g1, g2, caps), (e1, e2, _) = runs[True], runs[False]
    same = (g1["tokens"] == e1["tokens"] and g2["tokens"] == e2["tokens"]
            and g1["launches"] == e1["launches"] and g2["launches"] == e2["launches"])
    for label, r in (("bf16 graph", g1), ("bf16 graph, adapter loaded after capture", g2)):
        _check_lora_launches(f"{model} {label}", cfg, r, {"paged_attention": 1}, "mma")
    row = {"same": same, "captures": caps, "replays": g1["decode_graph_replays"]
           + g2["decode_graph_replays"], "decode_calls": g1["n_decode_calls"]
           + g2["n_decode_calls"], "launches_first": g1["launches"],
           "launches_after_load": g2["launches"]}
    log(f"lora: {model} bf16 on {card}: replayed = eager {same} (captures {caps}, replays "
        f"{row['replays']} for {row['decode_calls']} calls), adapter loaded after the capture "
        f"served launches={g2['launches']}")
    if not same or (device.type == "cuda" and (caps != 1
                                               or row["replays"] != row["decode_calls"])):
        raise AssertionError(f"lora {model} graph vs eager: {row}")
    return row


def lora_spec(device, card: str, model: str, seed: int, max_tokens: int) -> dict:
    """Speculation on = off in float32 on the bench's echo prompts, rows on
    the null adapter and three adapters (the reference's
    ``tests/test_spec_decode.py:143`` case at full width)."""
    from llmd_tpu_torch.models import get_model_config

    cfg = dataclasses.replace(get_model_config(model), dtype="float32")
    ads = _adapters(device, cfg, 3, seed)
    names = [None, *ads]
    reqs = [(p, names[i % 4]) for i, p in enumerate(echo_prompts(8, 4, cfg.vocab_size))]
    runs = {}
    for spec in (False, True):
        eng = _lora_engine(device, cfg, ads, seed=seed, **(SPEC_KW if spec else {}))
        runs[spec] = _lora_window(eng, reqs, max_tokens)
        del eng
    _empty()
    on, off = runs[True], runs[False]
    for label, r in (("spec on", on), ("spec off", off)):
        _check_lora_launches(f"{model} f32 {label}", cfg, r, {"paged_attention": 1}, "simt")
    row = {"identical": on["tokens"] == off["tokens"], "verify_steps": on["n_spec_verify_steps"],
           "drafted": on["spec_drafted"], "accepted": on["spec_accepted"],
           "launches_on": on["launches"]}
    log(f"lora: {model} float32 spec on = off on {card}: {row['identical']} verify_steps="
        f"{row['verify_steps']} drafted={row['drafted']} accepted={row['accepted']} "
        f"launches={on['launches']}")
    if not row["identical"] or on["n_spec_verify_steps"] == 0:
        raise AssertionError(f"lora {model} spec: {row}")
    return row


def lora_moe(device, card: str, model: str, layers: int, seed: int, n_per: int,
             prompt_range, max_tokens: int) -> dict:
    """``model`` (MoE, sorted dispatch) at full width and ``layers`` layers in
    float32 under adapters: kernels = plain versions token for token; K1
    once and K2 twice per layer of every forward."""
    from llmd_tpu_torch.models import get_model_config

    cfg = dataclasses.replace(get_model_config(model), dtype="float32", num_layers=layers)
    ads = _adapters(device, cfg, 3, seed)
    reqs = _lora_requests(cfg, list(ads), n_per, prompt_range, seed + 3)
    runs = {}
    for plain in (False, True):
        eng = _lora_engine(device, cfg, ads, plain=plain, seed=seed, moe_dispatch="sorted")
        runs[plain] = _lora_window(eng, reqs, max_tokens)
        del eng
    _empty()
    k, p = runs[False], runs[True]
    _check_lora_launches(f"{model} f32", cfg, k,
                         {"paged_attention": 1, "ragged_grouped_gemm": 2}, "simt")
    row = {"same_kernel_plain": k["tokens"] == p["tokens"], "launches": k["launches"],
           "forwards": k["n_unified_steps"] + k["n_decode_iterations"],
           "moe_dropped_tokens": k["moe_dropped_tokens"]}
    log(f"lora: {model} ({layers} layers) float32 sorted on {card}: kernels=plain "
        f"{row['same_kernel_plain']} launches={k['launches']} over {row['forwards']} forwards "
        f"(K2 {2 * layers} a forward)")
    if not row["same_kernel_plain"] or k["moe_dropped_tokens"]:
        raise AssertionError(f"lora {model}: {row}")
    return row


def lora_server(device, card: str, model: str, seed: int, embed_len: int) -> dict:
    """llama-1b in float32 behind the server under LoRA: the load / unload
    routes and codes, ``/v1/models``, adapter resolution, 404 for an unknown
    and an unloaded adapter, the ``vllm:lora_requests_info`` labels, and
    ``/v1/embeddings``: K1 once per layer per chunk, the unit vector within
    1e-5 per element of the plain version's (the same engine's embed program
    over ``paged_attention_ref``), the adapter's vector differs from the
    base model's."""
    import tempfile

    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.lora import LoRAConfig
    from llmd_tpu_torch.ops.paged_attention import paged_attention_ref

    cfg = dataclasses.replace(get_model_config(model), dtype="float32")
    server = EngineServer(cfg, EngineConfig(**LORA_KW, lora=LoRAConfig()), host="127.0.0.1",
                          port=0, tokenizer=IdTokenizer(cfg.vocab_size), seed=seed,
                          device=device)
    name = server.model_name
    codes: dict = {}
    w = _adapters(torch.device("cpu"), cfg, 1, seed)["ad-0"]
    (REPO / "checkpoints").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "checkpoints") as tmp:  # gitignored
        npz = str(Path(tmp) / "ad.npz")
        np.savez(npz, **{k: v.float().numpy() for k, v in w.items()})
        server.start()
        try:
            base = f"http://{server.address}"

            def call(name, method, path, body=None):
                status, _, raw = _http(method, base + path, body)
                codes[name] = status
                return json.loads(raw) if raw and raw[:1] in (b"{", b"[") else raw

            call("load", "POST", "/v1/load_lora_adapter", {"lora_name": "sql", "lora_path": npz})
            call("load_test_double", "POST", "/v1/load_lora_adapter", {"lora_name": "chat"})
            call("load_bad_name", "POST", "/v1/load_lora_adapter", {"lora_name": "a b\""})
            call("load_missing_file", "POST", "/v1/load_lora_adapter",
                 {"lora_name": "x", "lora_path": npz + ".missing"})
            models = [m["id"] for m in call("models", "GET", "/v1/models")["data"]]
            gen = {"prompt": "abc" * 40, "max_tokens": 8, "temperature": 0.0}
            tuned = call("by_model", "POST", "/v1/completions", {**gen, "model": "sql"})
            plain_text = call("base", "POST", "/v1/completions", gen)
            call("by_field", "POST", "/v1/completions", {**gen, "lora_adapter": "chat"})
            call("unknown", "POST", "/v1/completions", {**gen, "lora_adapter": "nope"})
            _, _, metrics = _http("GET", base + "/metrics")
            info = [ln for ln in metrics.decode().splitlines()
                    if ln.startswith("vllm:lora_requests_info")]
            ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, embed_len).tolist()
            zero_counts()
            emb_tuned = call("embed_tuned", "POST", "/v1/embeddings",
                             {"input": ids, "model": "sql"})["data"][0]["embedding"]
            k1 = read_counts()[0]["paged_attention"]
            emb_base = call("embed_base", "POST", "/v1/embeddings",
                            {"input": [ids]})["data"][0]["embedding"]
            call("embed_empty", "POST", "/v1/embeddings", {"input": [[]]})
            call("embed_unknown", "POST", "/v1/embeddings", {"input": ids, "lora_adapter": "x"})
            eng = server.engine

            def plain_embed():
                attn = eng._attn
                eng._attn = {**attn, "unified": paged_attention_ref}
                try:
                    return eng.embed(ids, "sql")
                finally:
                    eng._attn = attn

            emb_plain = server.async_engine.run_locked(plain_embed)
            call("unload", "POST", "/v1/unload_lora_adapter", {"lora_name": "sql"})
            call("unload_again", "POST", "/v1/unload_lora_adapter", {"lora_name": "sql"})
            call("after_unload", "POST", "/v1/completions", {**gen, "lora_adapter": "sql"})
        finally:
            server.stop()
    del server
    _empty()
    chunks = -(-embed_len // LORA_KW["prefill_chunk"])
    err = float(np.abs(np.asarray(emb_tuned) - np.asarray(emb_plain)).max())
    differs = float(np.abs(np.asarray(emb_tuned) - np.asarray(emb_base)).max())
    want = {"load": 200, "load_test_double": 200, "load_bad_name": 400,
            "load_missing_file": 400, "models": 200, "by_model": 200, "base": 200,
            "by_field": 200, "unknown": 404, "embed_tuned": 200, "embed_base": 200,
            "embed_empty": 400, "embed_unknown": 404, "unload": 200, "unload_again": 404,
            "after_unload": 404}
    row = {"codes": codes, "models": models, "lora_info": info, "embed_max_abs": err,
           "embed_vs_base_max_abs": differs, "embed_k1_launches": k1, "embed_chunks": chunks,
           "tuned_differs": tuned["choices"][0]["text"] != plain_text["choices"][0]["text"]}
    log(f"lora: {model} float32 server on {card}: codes={codes} models={models} "
        f"lora_info={info} embeddings kernel vs plain max_abs={err:.3e} (limit 1e-05) "
        f"adapter vs base max_abs={differs:.3e} K1 launches={k1} for {embed_len} tokens "
        f"({chunks} chunks x {cfg.num_layers} layers)")
    ok = (codes == want and models == [name, "chat", "sql"] and err <= 1e-5
          and differs > 1e-4 and len(info) == 1 and 'max_lora="8"' in info[0])
    if device.type == "cuda":
        ok = ok and k1 == chunks * cfg.num_layers
    if not ok:
        raise AssertionError(f"lora server: {row}")
    return row


def lora_numbers(device, card: str, model: str, seed: int, batch: int, isl: int, osl: int,
                 embed_len: int) -> dict:
    """Informational, bf16: decode tok/s at ``batch`` rows of ISL ``isl`` /
    OSL ``osl`` (``decode_steps`` 32, the bench's) with 4 adapters spread over
    the rows against the same engine without LoRA, in turns (none, LoRA,
    none, LoRA); ``profile_batch`` at batch 8 replayed with and without
    LoRA (device kernels and host launch calls per decode iteration); the
    ``/v1/embeddings`` latency of one ``embed_len``-token input."""
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.lora import LoRAConfig
    from llmd_tpu_torch.models.transformer import init_params
    from llmd_tpu_torch.tools.profile_engine import profile_batch

    cfg = get_model_config(model)
    ads = _adapters(device, cfg, 4, seed)
    names = list(ads)
    pages = batch * (-(-(isl + osl) // PS) + 1) + 8
    kw = dict(max_batch_size=batch, decode_steps=32, num_pages=max(pages, 64))
    turns = []
    rng = np.random.default_rng(seed + 5)
    engines = {lora: _lora_engine(device, cfg, ads if lora else {}, lora=lora, seed=seed, **kw)
               for lora in (False, True)}
    for turn in range(2):
        for lora in (False, True):
            reqs = [(rng.integers(0, cfg.vocab_size, isl).tolist(),
                     names[i % len(names)] if lora else None) for i in range(batch)]
            r = _lora_window(engines[lora], reqs, osl)
            turns.append((lora, r["decode_tokens_fused"] / max(r["time_decode_steps"], 1e-9)))
    del engines
    _empty()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    prof = {}
    if device.type == "cuda":
        for lora in (0, 4):
            r = profile_batch(cfg, params, 8, 256, 4, 5, 3, seed, lora=lora)
            prof[lora] = {k: r[k] for k in ("host_launch_calls_per_iteration",
                                            "device_kernels_per_iteration", "decode_tok_s")}
    del params
    server = EngineServer(cfg, EngineConfig(**LORA_KW, lora=LoRAConfig()), host="127.0.0.1",
                          port=0, tokenizer=IdTokenizer(cfg.vocab_size), seed=seed,
                          device=device)
    server.start()
    try:
        ids = rng.integers(0, cfg.vocab_size, embed_len).tolist()
        url = f"http://{server.address}/v1/embeddings"
        _http("POST", url, {"input": ids})  # warm-up
        lat = []
        for _ in range(5):
            t0 = time.perf_counter()
            status, _, _ = _http("POST", url, {"input": ids})
            lat.append((time.perf_counter() - t0) * 1e3)
            assert status == 200
    finally:
        server.stop()
    del server
    _empty()
    none = [t for lora, t in turns if not lora]
    with_lora = [t for lora, t in turns if lora]
    row = {"decode_tok_s_turns": turns, "decode_tok_s_no_lora": none,
           "decode_tok_s_lora": with_lora,
           "ratio": statistics.median(with_lora) / statistics.median(none),
           "profile_batch8": prof, "embeddings_ms": lat,
           "embeddings_p50_ms": statistics.median(lat)}
    log(f"lora: {model} bf16 on {card}: decode tok/s batch {batch} ISL {isl} OSL {osl} "
        f"no LoRA {none} with 4 adapters {with_lora} ratio {row['ratio']:.4f}; batch 8 "
        f"replayed profile {prof}; /v1/embeddings {embed_len} tokens p50 "
        f"{row['embeddings_p50_ms']:.3f} ms of {lat}")
    return row


def phase_lora(device, card: str, seed: int = 0, dense: str = "llama-1b", moe: str = MOE,
               moe_layers: int = 4, n_per: int = 2, prompt_range=(64, 512),
               max_tokens: int = 32, embed_len: int = 700, bench=(64, 256, 128)) -> dict:
    """Multi-adapter LoRA through every step program and the embed program,
    on ``dense`` at full width (``LoRAConfig(max_adapters=8, rank=8)``, the
    serving settings): the float32 identities, replayed = eager with an
    adapter loaded after the capture, speculation on = off, ``moe`` at
    ``moe_layers`` layers, the server's routes and ``/v1/embeddings``, and
    the informational numbers."""
    out = {"f32": lora_f32_identities(device, card, dense, seed, n_per, prompt_range,
                                      max_tokens),
           "graph": lora_graph_vs_eager(device, card, dense, seed, n_per, prompt_range,
                                        max_tokens),
           "spec": lora_spec(device, card, dense, seed, 2 * max_tokens),
           "moe": lora_moe(device, card, moe, moe_layers, seed, n_per, prompt_range,
                           max_tokens),
           "server": lora_server(device, card, dense, seed, embed_len)}
    out["numbers"] = lora_numbers(device, card, dense, seed, *bench, 512)
    return out


# --------------------------------------------------------------------------
# Multimodal serving: the vision tower, the encode worker, media rows
# --------------------------------------------------------------------------

# CLIP ViT-L/14 at 336 px (openai/clip-vit-large-patch14-336, vision_config),
# LLaVA-1.5's tower: hidden 1024, 24 layers, 16 heads, patch 14 (576
# patches); the reference tower's MLP is its fixed 4 x hidden (4096); 576
# media tokens an image, as LLaVA-1.5 feeds its LM
VL_TOWER = dict(mm_tokens=576, mm_placeholder_id=32767, vision_patch=14,
                vision_image_size=336, vision_layers=24, vision_hidden=1024, vision_heads=16)
VL_KW = dict(page_size=PS, num_pages=1024, max_model_len=2048, max_batch_size=8,
             prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)
# the f32 tower on the card against the CPU, max abs relative to the output's
# max abs: summation order only (TF32 off)
TOWER_REL = 1e-4
# f32 first-token logits of two prompts that differ only in their images must
# move by more than this (the same inputs agree to ~1e-5: summation order);
# at random init the greedy token itself may hold (PERF.md §6)
IMAGE_LOGIT_MOVE = 1e-2


def vl_full(dtype: str = "bfloat16", base: str = "llama-1b", tower: "dict | None" = None):
    """VL_FULL: ``base`` (llama-1b, the reference registry's widths) with the
    tower at CLIP ViT-L/14-336's published widths; not a registry entry (the
    port's registry is the reference's, field for field)."""
    from llmd_tpu_torch.models import get_model_config

    return dataclasses.replace(get_model_config(base), name=f"{base}-vl336", dtype=dtype,
                               **(tower or VL_TOWER))


def _image(tag: str) -> dict:
    """A seeded byte payload as an inline ``data:`` image part."""
    import base64
    import hashlib

    payload = hashlib.sha256(tag.encode()).digest() * 8
    return {"type": "image_url", "image_url": {
        "url": "data:image/x-raw;base64," + base64.b64encode(payload).decode()}}


def _vl_bodies(n: int, seed: int, text_range, max_tokens: int) -> list:
    """``n`` chat bodies of 1-2 images beside 16-64 text bytes, greedy,
    ``max_tokens`` out, every other one streamed; bodies 2i and 2i + 1 share
    their text and differ in their images."""
    rng = np.random.default_rng(seed)
    bodies = []
    for i in range(n):
        if i % 2 == 0:
            text = "".join(rng.choice(list("abcdefghij klmnopqrst uvwxyz"),
                                      int(rng.integers(text_range[0], text_range[1] + 1))))
        images = [_image(f"vision-{seed}-{i}-{j}") for j in range(1 + (i // 2) % 2)]
        bodies.append({"messages": [{"role": "user", "content": [
            {"type": "text", "text": text}, *images]}], "max_tokens": max_tokens,
            "temperature": 0.0, "ignore_eos": True, "stream": i % 2 == 1})
    return bodies


def _chat(address: str, body: dict) -> dict:
    """One chat completion: its tokens (the id tokenizer's spelling), usage
    and status; a stream's pieces joined, its usage from the last event."""
    status, _, raw = _http("POST", f"http://{address}/v1/chat/completions", body)
    if status != 200:
        raise AssertionError(f"vision: chat {status}: {raw[:300]!r}")
    if body.get("stream"):
        events = [json.loads(e) for e in raw if e != b"[DONE]"]
        text = "".join(e["choices"][0]["delta"]["content"] for e in events)
        usage = events[-1]["usage"]
    else:
        r = json.loads(raw)
        text, usage = r["choices"][0]["message"]["content"], r["usage"]
    return {"tokens": [ord(c) - 0x10000 for c in text], "usage": usage}


def _vl_server(device, cfg, seed: int, **kw):
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer

    s = EngineServer(cfg, EngineConfig(**VL_KW), host="127.0.0.1", port=0,
                     tokenizer=IdTokenizer(cfg.vocab_size), seed=seed, device=device, **kw)
    s.start()
    return s


def _vl_window(server, bodies: list, prepare=None) -> dict:
    """``bodies`` concurrently through ``server`` (each through ``prepare``
    first, the sidecar's E step when given), the counters zeroed just before
    and read just after: answers in order, launches, plain calls, instances,
    the engine's forwards and replays, and the prompts the engine admitted."""
    eng = server.engine
    admitted: list = []
    add = eng.add_request

    def recording(rid, token_ids, *a, **k):
        admitted.append((list(token_ids), [h for h, _ in k.get("mm_items") or ()]))
        return add(rid, token_ids, *a, **k)

    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (lambda: None)
    st0 = dataclasses.replace(eng.stats)
    eng.add_request = recording
    sync()
    zero_counts()
    out: list = [None] * len(bodies)

    def one(i: int) -> None:
        out[i] = _chat(server.address, prepare(bodies[i]) if prepare else bodies[i])

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        sync()
    finally:
        eng.add_request = add
    launches, plain = read_counts()
    st = eng.stats
    if any(o is None for o in out):
        raise AssertionError("vision: a chat request failed")
    return {"answers": out, "launches": launches, "plain_calls": plain,
            "launches_by_instance": instance_counts(), "admitted": admitted,
            "forwards": (st.n_unified_steps - st0.n_unified_steps)
            + (st.n_decode_iterations - st0.n_decode_iterations),
            "unified_steps": st.n_unified_steps - st0.n_unified_steps,
            "replays": st.decode_graph_replays - st0.decode_graph_replays}


def _check_vl_launches(label: str, cfg, run: dict, instance: str) -> None:
    """K1 once per layer of every forward of the window, all on
    ``instance``, no plain version, the decode program replayed from its
    graph. On the card only."""
    if not torch.cuda.is_available():
        return
    n = cfg.num_layers * run["forwards"]
    by = run["launches_by_instance"]["paged_attention"]
    problems = []
    if run["launches"]["paged_attention"] != n or n == 0:
        problems.append(f"K1 launches {run['launches']['paged_attention']} != {n}")
    if by.get(instance, 0) != n or sum(by.values()) != n:
        problems.append(f"K1 launches {by} not all on {instance}")
    if any(run["plain_calls"].values()):
        problems.append(f"plain versions ran: {run['plain_calls']}")
    if run["replays"] == 0:
        problems.append("the decode program never replayed its graph")
    if problems:
        raise AssertionError(f"vision {label}: {problems}")


def _encode_items(address: str, body: dict) -> dict:
    """The sidecar's E step, driven here: each media part to the encode
    worker alone (``/v1/encode``), the wire items attached as ``mm_items``."""
    from llmd_tpu_torch.disagg.encode import iter_media_parts

    items = []
    for part in iter_media_parts(body):
        status, _, raw = _http("POST", f"http://{address}/v1/encode", {"items": [part]})
        if status != 200:
            raise AssertionError(f"vision: encode {status}: {raw[:300]!r}")
        items += json.loads(raw)["items"]
    return {**body, "mm_items": items}


def vision_tower_check(device, card: str, cfg, seed: int, n: int) -> dict:
    """The f32 tower on the card against the same tower on the CPU (same
    params, ``n`` images, TF32 off, highest matmul precision): max abs
    relative to the output's max abs <= TOWER_REL; bf16 against f32 on the
    card reported, not bounded."""
    from llmd_tpu_torch.models.vision import bytes_to_pixels, encode_images, init_vision_params

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu_params = init_vision_params(cfg32, torch.Generator().manual_seed(seed), "cpu")
    px = torch.from_numpy(np.stack([bytes_to_pixels(cfg32, f"tower-{seed}-{i}".encode())
                                    for i in range(n)]))
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            ref = encode_images(cfg32, cpu_params, px)
            cpu_s = time.perf_counter() - t0
            dev_params = {k: v.to(device) for k, v in cpu_params.items()}
            got = encode_images(cfg32, dev_params, px.to(device)).cpu()
            bf16 = dataclasses.replace(cfg, dtype="bfloat16")
            half = encode_images(bf16, {k: v.to(torch.bfloat16) for k, v in dev_params.items()},
                                 px.to(device)).float().cpu()
    finally:
        torch.set_float32_matmul_precision(precision)
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    bf16_err = float((half - ref).abs().max())
    row = {"images": n, "max_abs": err, "rel": err / scale, "limit_rel": TOWER_REL,
           "output_max_abs": scale, "bf16_vs_f32_max_abs": bf16_err,
           "bf16_vs_f32_rel": bf16_err / scale, "cpu_s": cpu_s,
           "shape": list(got.shape)}
    log(f"vision: tower {cfg.vision_layers} layers x {cfg.vision_hidden} "
        f"({cfg.vision_image_size} px, patch {cfg.vision_patch}) f32 on {card} vs CPU, "
        f"{n} images: max_abs={err:.3e} rel={err / scale:.3e} (limit {TOWER_REL:.0e}); "
        f"bf16 vs f32 max_abs={bf16_err:.3e} rel={bf16_err / scale:.3e} (reported); "
        f"CPU {cpu_s:.1f} s")
    if not err / scale <= TOWER_REL:
        raise AssertionError(f"vision tower: {row}")
    return row


def vision_combined(device, card: str, cfg, seed: int, bodies: list) -> dict:
    """Combined PD: the server with its in-process tower serves ``bodies``
    (then the first two again, and those two with another image behind the
    same text); K1 once per layer of every forward on its instance, the
    decode graph replayed, ``/render`` = the stream the engine admitted and
    its blocks keyed as the router keys them, a repeat hits the prefix cache
    (its tokens reported), a new image does not; the two bodies of at least
    one pair (same text, other images) give other tokens. In float32
    the tokens also equal an engine's given the same rows through
    ``add_request``, and each pair's first-token logits move by more than
    IMAGE_LOGIT_MOVE."""
    from llmd_tpu_torch.core.kv_events import block_keys_for_tokens
    from llmd_tpu_torch.core.request import mm_hashes_from_messages

    f32 = cfg.dtype == "float32"
    server = _vl_server(device, cfg, seed)
    try:
        # warm-up: the tower and the decode graph, media unlike any below
        _chat(server.address, {**_vl_bodies(1, seed + 1000, (16, 16), 10)[0],
                               "stream": False})
        run = _vl_window(server, bodies)
        _check_vl_launches(f"combined {cfg.dtype}", cfg, run, "simt" if f32 else "mma")
        renders = [json.loads(_http("POST", f"http://{server.address}"
                                    "/v1/chat/completions/render", b)[2])["prompt_token_ids"]
                   for b in bodies]
        again = _vl_window(server, bodies[:2])
        swapped = [{**b, "messages": [{"role": "user", "content": [
            b["messages"][0]["content"][0], _image(f"swap-{seed}-{i}")]}]}
            for i, b in enumerate(bodies[:2])]
        other = _vl_window(server, swapped)
        cached = server.engine.alloc.cached
        keys_ok = all(set(block_keys_for_tokens(
            r, PS, None, mm_hashes_from_messages(b["messages"]))) <= set(cached)
            for r, b in zip(renders, bodies))
        encoded = dict(server._vision.stats)
    finally:
        server.stop()
    del server
    _empty()
    toks = [a["tokens"] for a in run["answers"]]
    admitted = sorted(map(tuple, (p for p, _ in run["admitted"])))
    row = {"dtype": cfg.dtype, "requests": len(bodies),
           "prompt_tokens": [a["usage"]["prompt_tokens"] for a in run["answers"]],
           "images": [len(b["messages"][0]["content"]) - 1 for b in bodies],
           "launches": run["launches"], "launches_by_instance": run["launches_by_instance"],
           "forwards": run["forwards"], "replays": run["replays"],
           "render_equals_admitted": sorted(map(tuple, renders)) == admitted,
           "block_keys_equal_router_keys": keys_ok,
           "pair_tokens_differ": [toks[i] != toks[i + 1] for i in range(0, len(toks) - 1, 2)],
           "repeat_cached_tokens": [a["usage"]["cached_tokens"] for a in again["answers"]],
           "repeat_same_tokens": [a["tokens"] for a in again["answers"]] == toks[:2],
           "new_image_cached_tokens": [a["usage"]["cached_tokens"] for a in other["answers"]],
           "tower": encoded, "tokens": toks, "renders": renders,
           "mm_hashes": [h for _, h in run["admitted"]]}
    if f32:
        direct, logits = _direct_tokens(device, cfg, seed, bodies, renders)
        row["same_as_add_request"] = toks == direct
        # the rows reach the model: the first token's logits of the two
        # bodies of a pair (same text, other images) move by far more than
        # f32 noise, though at random init the greedy token may hold
        row["pair_first_logit_change"] = [float((logits[i] - logits[i + 1]).abs().max())
                                          for i in range(0, len(logits) - 1, 2)]
        row["first_top2_margin"] = [float(t[0] - t[1]) for t in
                                    (torch.topk(x, 2).values for x in logits)]
    log(f"vision: combined PD {cfg.dtype} on {card}: {len(bodies)} chats, "
        f"{row['images']} images, prompts {row['prompt_tokens']} tokens; K1 launches="
        f"{run['launches']['paged_attention']} by_instance="
        f"{run['launches_by_instance']['paged_attention']} over {run['forwards']} forwards "
        f"({run['unified_steps']} unified), replays={run['replays']}; render=admitted "
        f"{row['render_equals_admitted']}, block keys=router keys {keys_ok}, pairs (same text, "
        f"other images) tokens differ {row['pair_tokens_differ']}, repeat cached "
        f"{row['repeat_cached_tokens']} "
        f"(same tokens {row['repeat_same_tokens']}), new image cached "
        f"{row['new_image_cached_tokens']}; tower {encoded}"
        + (f"; tokens = add_request engine {row['same_as_add_request']}, pairs' first-token "
           f"logits moved by {row['pair_first_logit_change']} (limit > {IMAGE_LOGIT_MOVE}), "
           f"their top-2 margins {row['first_top2_margin']}"
           if f32 else ""))
    ok = (row["render_equals_admitted"] and keys_ok and any(row["pair_tokens_differ"])
          and all(d > IMAGE_LOGIT_MOVE for d in row.get("pair_first_logit_change", [1.0]))
          and all(c > 0 for c in row["repeat_cached_tokens"]) and row["repeat_same_tokens"]
          and all(c == 0 for c in row["new_image_cached_tokens"])
          and row.get("same_as_add_request", True))
    if not ok:
        raise AssertionError(f"vision combined {cfg.dtype}: "
                             f"{ {k: v for k, v in row.items() if k not in ('tokens', 'renders')} }")
    return row


def _direct_tokens(device, cfg, seed: int, bodies: list, renders: list) -> tuple:
    """The same prompts and media rows through one engine's ``add_request``
    (a ``VisionRunner`` of the same seeded tower encodes the parts): the
    greedy tokens, and each prompt's first-token logits from one
    ``forward_core`` of the whole prompt over a pool of its own."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.disagg.encode import (
        VisionRunner, iter_media_parts, media_bytes_from_part, part_identity)
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models.transformer import forward_core, init_cache, unembed

    runner = VisionRunner(cfg, device=device)
    eng = LLMEngine(cfg, EngineConfig(**VL_KW), seed=seed, device=device)
    logits = []
    for i, (b, toks) in enumerate(zip(bodies, renders)):
        parts = list(iter_media_parts(b))
        rows = runner.encode([media_bytes_from_part(p) for p in parts])
        items = [(part_identity(p), e) for p, (_, e) in zip(parts, rows)]
        eng.add_request(f"direct-{i}", toks, SamplingParams(
            max_tokens=b["max_tokens"], temperature=0.0, ignore_eos=True), mm_items=items)
        n, pages = len(toks), -(-len(toks) // PS)
        t = torch.tensor(toks, dtype=torch.int32, device=device)
        mask = t == cfg.mm_placeholder_id
        emb = torch.zeros((n, cfg.hidden_size), device=device)
        emb[mask] = torch.from_numpy(np.concatenate([e for _, e in items])).to(device)
        i32 = functools.partial(torch.tensor, dtype=torch.int32, device=device)
        with torch.no_grad():
            h = forward_core(cfg, eng.params, init_cache(cfg, pages, PS, device=device), t,
                             i32(list(range(n))), i32([0] * n), i32([list(range(pages))]),
                             i32([n]), cu_q_lens=i32([0, n]), num_seqs=i32([1]),
                             mm_embeds=emb, mm_mask=mask)[0]
            logits.append(unembed(cfg, eng.params, h[-1:])[0].cpu())
    out: dict = {f"direct-{i}": [] for i in range(len(bodies))}
    while eng.has_work():
        for o in eng.step():
            out[o.request_id].extend(o.new_token_ids)
    del eng, runner
    _empty()
    return list(out.values()), logits


def vision_epd(device, card: str, cfg, seed: int, bodies: list, combined: dict) -> dict:
    """E/PD: a port encode worker on loopback and a towerless server
    (``vision_layers=0``); the phase drives the sidecar's E step itself
    (``/v1/encode`` per item, then the chat body with ``mm_items``). The
    tokens equal combined PD's (float32: bound; bf16: share reported), K1
    once per layer of every forward, the towerless server encoding nothing."""
    from llmd_tpu_torch.disagg.encode import EncodeServer

    enc = EncodeServer(cfg, device=device)
    enc.start()
    server = _vl_server(device, dataclasses.replace(cfg, vision_layers=0), seed)
    try:
        _chat(server.address, _encode_items(enc.address, {
            **_vl_bodies(1, seed + 1000, (16, 16), 10)[0], "stream": False}))  # warm-up
        run = _vl_window(server, bodies, lambda b: _encode_items(enc.address, b))
        f32 = cfg.dtype == "float32"
        _check_vl_launches(f"E/PD {cfg.dtype}", cfg, run, "simt" if f32 else "mma")
        towerless_encoded = server._vision is not None
        enc_stats = dict(enc.runner_.stats)
    finally:
        server.stop()
        enc.stop()
    del server, enc
    _empty()
    toks = [a["tokens"] for a in run["answers"]]
    same = toks == combined["tokens"]
    agree = sum(sum(x == y for x, y in zip(a, b)) for a, b in zip(toks, combined["tokens"]))
    share = agree / max(1, sum(len(t) for t in combined["tokens"]))
    row = {"dtype": cfg.dtype, "same_as_combined": same, "identical_token_share": share,
           "launches": run["launches"], "forwards": run["forwards"],
           "replays": run["replays"], "encode_worker": enc_stats,
           "towerless_server_encoded": towerless_encoded,
           "hashes_equal_combined": [h for _, h in run["admitted"]] and sorted(
               map(tuple, (h for _, h in run["admitted"]))) == sorted(
               map(tuple, combined["mm_hashes"]))}
    log(f"vision: E/PD {cfg.dtype} on {card}: encode worker {enc_stats}, towerless server "
        f"encoded nothing {not towerless_encoded}; tokens = combined PD {same} (identical "
        f"share {share:.4f}); media identities = combined {row['hashes_equal_combined']}; "
        f"K1 launches={run['launches']['paged_attention']} over {run['forwards']} forwards, "
        f"replays={run['replays']}")
    if towerless_encoded or not row["hashes_equal_combined"] or (cfg.dtype == "float32"
                                                                 and not same):
        raise AssertionError(f"vision E/PD {cfg.dtype}: {row}")
    return row


def vision_epd_pd(device, card: str, cfg, seed: int, bodies: list, combined: dict) -> dict:
    """E/P/D in float32: the encode worker, then P (``do_remote_decode``,
    ``max_tokens`` 1), then D (``do_remote_prefill`` with P's handle) over
    the KVT1 wire, both towerless: D injects the media-keyed blocks (> 0)
    and reports ``cached_tokens`` > 0, its tokens equal combined PD's (an
    aggregated engine's), K1 once per layer of D's forwards over the pulled
    pages."""
    from llmd_tpu_torch.disagg.encode import EncodeServer

    towerless = dataclasses.replace(cfg, vision_layers=0)
    enc = EncodeServer(cfg, device=device)
    enc.start()
    P = _vl_server(device, towerless, seed, kv_transfer_port=0)
    D = _vl_server(device, towerless, seed, kv_transfer_port=0)
    try:
        encoded = [_encode_items(enc.address, b) for b in bodies]
        handles = []
        for b in encoded:
            status, _, raw = _http("POST", f"http://{P.address}/v1/chat/completions", {
                **b, "max_tokens": 1, "stream": False,
                "kv_transfer_params": {"do_remote_decode": True}})
            if status != 200:
                raise AssertionError(f"vision E/P/D: P answered {status}: {raw[:300]!r}")
            handles.append(json.loads(raw)["kv_transfer_params"])
        _chat(D.address, {**_vl_bodies(1, seed + 1000, (16, 16), 10)[0], "stream": False,
                          "messages": [{"role": "user", "content": "warm-up"}]})
        pd = {i: {**b, "kv_transfer_params": {"do_remote_prefill": True, **h}}
              for i, (b, h) in enumerate(zip(encoded, handles))}
        run = _vl_window(D, [pd[i] for i in range(len(bodies))])
        _check_vl_launches("E/P/D D", cfg, run, "simt")
        injected = D.transfer_stats["injected_blocks"]
        failures = D.transfer_stats["pull_failures"]
    finally:
        D.stop()
        P.stop()
        enc.stop()
    del D, P, enc
    _empty()
    toks = [a["tokens"] for a in run["answers"]]
    cached = [a["usage"]["cached_tokens"] for a in run["answers"]]
    row = {"injected_blocks": injected, "pull_failures": failures, "cached_tokens": cached,
           "blocks_exported": [h["num_blocks"] for h in handles],
           "same_as_aggregated": toks == combined["tokens"],
           "d_launches": run["launches"], "d_forwards": run["forwards"],
           "d_replays": run["replays"]}
    log(f"vision: E/P/D float32 on {card}: P exported {row['blocks_exported']} blocks, D "
        f"injected {injected} (pull failures {failures}), D cached_tokens {cached}; tokens = "
        f"aggregated (combined PD) {row['same_as_aggregated']}; D K1 launches="
        f"{run['launches']['paged_attention']} over {run['forwards']} forwards, replays="
        f"{run['replays']}")
    if not (injected > 0 and failures == 0 and all(c > 0 for c in cached)
            and row["same_as_aggregated"]):
        raise AssertionError(f"vision E/P/D: {row}")
    return row


def vision_numbers(device, card: str, cfg, seed: int, reps: int = 4) -> dict:
    """Informational, bf16: encode ms per image at batch 1 and 8 (CUDA
    events, median of ``reps``) beside the tower's operation bound at the
    bf16 peak; TTFT p50 of a one-image chat (64 text bytes, ``max_tokens``
    1, a new image each time) through combined PD against E/PD (the encode
    call and the chat back to back); device kernels per unified step with
    and without media rows (``profile_unified``, batch 4, one image)."""
    from llmd_tpu_torch.disagg.encode import EncodeServer, VisionRunner
    from llmd_tpu_torch.models.transformer import init_params
    from llmd_tpu_torch.models.vision import vision_flops
    from llmd_tpu_torch.tools.profile_engine import profile_unified

    bound_ms = vision_flops(cfg) / PEAK_FLOPS[torch.bfloat16] * 1e3
    runner = VisionRunner(cfg, device=device)
    rng = np.random.default_rng(seed)
    encode = {}
    for batch in (1, 8):
        px = rng.random((batch, cfg.vision_image_size, cfg.vision_image_size, 3),
                        dtype=np.float32)
        runner.encode_pixels(px)  # warm-up
        encode[batch] = cuda_ms(lambda: runner.encode_pixels(px), reps=reps, inner=1) / batch
    del runner
    _empty()
    ttft: dict = {"combined": [], "epd": []}
    server = _vl_server(device, cfg, seed)
    enc = EncodeServer(cfg, device=device)
    enc.start()
    towerless = _vl_server(device, dataclasses.replace(cfg, vision_layers=0), seed)
    try:
        for mode, srv in (("combined", server), ("epd", towerless)):
            for i in range(reps + 1):
                body = {"messages": [{"role": "user", "content": [
                    {"type": "text", "text": "x" * 64}, _image(f"ttft-{mode}-{i}")]}],
                    "max_tokens": 1, "temperature": 0.0, "ignore_eos": True}
                t0 = time.perf_counter()
                _chat(srv.address, _encode_items(enc.address, body) if mode == "epd" else body)
                if i:  # the first is the warm-up
                    ttft[mode].append((time.perf_counter() - t0) * 1e3)
    finally:
        towerless.stop()
        enc.stop()
        server.stop()
    del server, enc, towerless
    _empty()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    prof = {}
    for images in (1, 0):
        r = profile_unified(cfg, params, 4, 64 + cfg.mm_tokens, images, seed, device=device)
        prof[images] = {k: r[k] for k in ("device_kernels_per_step", "device_busy_ms_per_step",
                                          "wall_ms_per_step", "unified_steps")}
    del params
    _empty()
    row = {"encode_ms_per_image": encode, "encode_bound_ms_per_image": bound_ms,
           "tower_flops_per_image": vision_flops(cfg), "ttft_ms": ttft,
           "ttft_p50_ms": {m: statistics.median(v) for m, v in ttft.items()},
           "profile_unified": prof}
    log(f"vision: bf16 on {card}: encode ms/image batch 1 {encode[1]:.4f}, batch 8 "
        f"{encode[8]:.4f} (bound {bound_ms:.4f} ms: {vision_flops(cfg) / 1e12:.4f} TFLOP at "
        f"989 TFLOP/s); TTFT p50 one-image chat combined {row['ttft_p50_ms']['combined']:.3f} "
        f"ms, E/PD {row['ttft_p50_ms']['epd']:.3f} ms ({ttft}); unified step batch 4 with "
        f"one image each {prof[1]} / text only {prof[0]}")
    return row


def phase_vision(device, card: str, seed: int = 0, cfg=None, n_requests: int = 8,
                 text_range=(16, 64), max_tokens: int = 32, tower_images: int = 4,
                 numbers: bool = True) -> dict:
    """Multimodal serving at VL_FULL (``cfg``): the tower alone, combined PD
    in bf16 and f32, E/PD in bf16 and f32, E/P/D in f32, then the
    informational numbers."""
    cfg = cfg or vl_full()
    t0 = time.perf_counter()
    bodies = _vl_bodies(n_requests, seed, text_range, max_tokens)
    out = {"config": {k: getattr(cfg, k) for k in ("name", "hidden_size", "num_layers",
                                                   *VL_TOWER)},
           "tower": vision_tower_check(device, card, cfg, seed, tower_images)}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        out[f"combined_{dtype}"] = vision_combined(device, card, c, seed, bodies)
        out[f"epd_{dtype}"] = vision_epd(device, card, c, seed, bodies,
                                         out[f"combined_{dtype}"])
    c32 = dataclasses.replace(cfg, dtype="float32")
    out["epd_pd"] = vision_epd_pd(device, card, c32, seed, bodies, out["combined_float32"])
    if numbers and device.type == "cuda":
        out["numbers"] = vision_numbers(device, card, dataclasses.replace(cfg, dtype="bfloat16"),
                                        seed)
    for key in ("combined_bfloat16", "combined_float32"):
        for k in ("tokens", "renders", "mm_hashes"):
            out[key].pop(k)
    out["seconds"] = time.perf_counter() - t0
    log(f"vision: phase {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# The observability plane: flight recorder, tracing, ledgers, device plane,
# phase probes, Responses / Conversations
# --------------------------------------------------------------------------

OBS_KW = dict(page_size=PS, num_pages=2048, max_model_len=2048, max_batch_size=32,
              prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)
# the device plane's knobs for the phase: a 1 s watchdog, a poll and a
# liveness probe every 0.2 s / 1 s (read when the server's monitor is built)
OBS_ENV = {"LLMD_WATCHDOG_STALL_S": "1", "LLMD_DEVICE_POLL_S": "0.2",
           "LLMD_FABRIC_PROBE_INTERVAL_S": "1", "LLMD_FABRIC_PROBE_TIMEOUT_S": "20"}
TIMELINE = ("arrival", "admitted", "prefill_start", "prefill_end", "retired")


@contextlib.contextmanager
def _env(values: dict):
    """``os.environ`` updated with ``values`` inside the block (a None value
    unsets its variable), then restored."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _wait_until(cond, what: str, timeout_s: float, poll_s: float = 0.002) -> None:
    """Poll ``cond()`` until it holds; raise if ``timeout_s`` passes first."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not reached in {timeout_s} s")
        time.sleep(poll_s)


def _metric(text: str, name: str, labels: str = "") -> "float | None":
    """One sample's value from an exposition, None when absent."""
    for line in text.splitlines():
        if line.startswith(name + labels + " "):
            return float(line.split(" # ")[0].split()[-1])
    return None


def _phase_counts(text: str) -> dict:
    """``step_duration`` and ``request_phase_seconds`` observation counts."""
    out: dict = {}
    for line in text.splitlines():
        for fam, key in (("llmd_tpu:engine_step_duration_seconds_count", "step"),
                         ("llmd_tpu:request_phase_seconds_count", "request")):
            if line.startswith(fam + "{"):
                phase = line.split('phase="')[1].split('"')[0]
                out[(key, phase)] = out.get((key, phase), 0) + float(line.split()[-1])
    return out


def _timeline_ok(names: list) -> bool:
    """arrival -> admitted -> prefill_start -> prefill_end -> (chain_dispatch,
    decode)+ -> retired, in order."""
    core = [n for n in names if n in TIMELINE]
    if core != list(TIMELINE) or names[-1] != "retired":
        return False
    after = names[names.index("prefill_end"):]
    return ("chain_dispatch" in after and "decode" in after
            and after.index("chain_dispatch") < len(after) - 1)


def _probe_counts(text: str) -> dict:
    c = _phase_counts(text)
    return {p: int(c.get(("step", p), 0))
            for p in ("attn", "moe_dispatch", "moe_experts", "moe_combine")}


def _probe_ms(text: str, phase: str, layers: int, k: int) -> "float | None":
    """A probe phase's mean time per layer and decode iteration, in ms
    (its samples are time x layers x k)."""
    n = _metric(text, "llmd_tpu:engine_step_duration_seconds_count", f'{{phase="{phase}"}}')
    s = _metric(text, "llmd_tpu:engine_step_duration_seconds_sum", f'{{phase="{phase}"}}')
    return s / n / (layers * k) * 1e3 if n else None


def obs_main_run(device, card: str, model: str, seed: int, n_requests: int, prompt_range,
                 max_tokens: int, probe_tokens: int, profile_s: float) -> dict:
    """llama-1b at full width and depth behind the port's server (OBS_KW,
    bf16 random weights from ``seed``, the decode program captured and
    replayed, the pipelined dispatch), the device plane's knobs OBS_ENV."""
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.models import get_model_config

    cfg = get_model_config(model)
    on_card = device.type == "cuda"
    rng = np.random.default_rng(seed)
    prof_dir = tempfile.mkdtemp(prefix="llmd-obs-profiles-")
    with _env(OBS_ENV | {"LLMD_PROFILE_DIR": prof_dir}):
        server = EngineServer(cfg, EngineConfig(**OBS_KW), host="127.0.0.1", port=0,
                              tokenizer=IdTokenizer(cfg.vocab_size), seed=seed, device=device)
        server.start()
    base = f"http://{server.address}"
    eng = server.engine
    out: dict = {}
    try:
        greedy = {"temperature": 0, "ignore_eos": True}

        def prompt(lo: int, hi: int) -> list:
            return rng.integers(0, 256, int(rng.integers(lo, hi + 1))).tolist()

        # the decode graph is captured here, before the counted window
        assert _http("POST", base + "/v1/completions",
                     {"prompt_token_ids": prompt(40, 60), "max_tokens": 12, **greedy})[0] == 200
        _, _, before = _http("GET", base + "/metrics")
        st0 = dataclasses.replace(eng.stats)
        zero_counts()
        # 1. n_requests concurrent completions, a traceparent on half of them
        sent = {i: f"{rng.integers(1, 2 ** 63):016x}{rng.integers(1, 2 ** 63):016x}"
                for i in range(0, n_requests, 2)}
        headers = {i: {"traceparent": f"00-{t}-{rng.integers(1, 2 ** 63):016x}-01"}
                   for i, t in sent.items()}
        prompts = [prompt(*prompt_range) for _ in range(n_requests + 8)]
        results: list = [None] * n_requests

        def one(i: int) -> None:
            results[i] = _http("POST", base + "/v1/completions", {
                "prompt_token_ids": prompts[i], "max_tokens": max_tokens, **greedy},
                headers.get(i))

        # daemon clients: a failed check ends the run without waiting on them
        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(n_requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        rids = {}
        for i, r in enumerate(results):
            assert r is not None and r[0] == 200, f"obs: request {i} failed: {r}"
            rids[i] = json.loads(r[2])["id"]
        _, _, after = _http("GET", base + "/metrics")
        # every timeline complete and ordered, the traced ones under their id
        for i, rid in rids.items():
            status, _, body = _http("GET", f"{base}/debug/requests/{rid}")
            rec = json.loads(body)
            names = [e["event"] for e in rec["events"]]
            if status != 200 or not _timeline_ok(names):
                raise AssertionError(f"obs: {rid} timeline {status} {names}")
            if i in sent and rec["trace_id"] != sent[i]:
                raise AssertionError(f"obs: {rid} trace {rec['trace_id']} != {sent[i]}")
        status, _, body = _http("GET", base + "/debug/requests?status=finished")
        listing = json.loads(body)["requests"]
        finished = {r["request_id"] for r in listing}
        if status != 200 or not set(rids.values()) <= finished:
            raise AssertionError(f"obs: /debug/requests?status=finished lacks "
                                 f"{set(rids.values()) - finished}")
        c0, c1 = _phase_counts(before.decode()), _phase_counts(after.decode())
        delta = {p: c1[k] - c0.get(k, 0) for k in c1 if k[0] == "request"
                 for p in [k[1]] if c1[k] - c0.get(k, 0)}
        if (any(v > n_requests for v in delta.values())
                or any(delta.get(p) != n_requests
                       for p in ("prefill", "decode_overlap", "unattributed"))):
            raise AssertionError(f"obs: request_phase_seconds counts {delta}")
        # exemplars: a step's is its batch's first traced row (the
        # reference's rule), so which of the concurrent requests lands in a
        # bucket depends on slot order; a request with a traceparent served
        # alone must own the exemplars of the buckets its steps hit, and
        # every exemplar is a served request's trace id
        solo_rng = np.random.default_rng(seed + 1)
        solo = f"{solo_rng.integers(1, 2 ** 63):016x}{solo_rng.integers(1, 2 ** 63):016x}"
        assert _http("POST", base + "/v1/completions", {
            "prompt_token_ids": solo_rng.integers(0, 256, 48).tolist(), "max_tokens": 8,
            **greedy}, {"traceparent": f"00-{solo}-{solo_rng.integers(1, 2 ** 63):016x}-01"}
        )[0] == 200
        _, _, text = _http("GET", base + "/metrics")
        seen = {r["trace_id"] for r in listing} | {solo}
        ex = set(re.findall(r'engine_step_duration_seconds_bucket\{[^}]*\} \S+ '
                            r'# \{trace_id="([0-9a-f]+)"\}', text.decode()))
        if not ex <= seen or solo not in ex:
            raise AssertionError(f"obs: exemplar trace ids {ex} (served {seen}, alone {solo})")
        out["request_phase_counts"] = delta
        out["exemplar_trace_ids"] = len(ex)
        # 2. batch-8 decode long enough for the probes, with a profile window
        # (and a second capture that must be refused) taken while it runs
        st1 = dataclasses.replace(eng.stats)
        long_results: list = [None] * 8
        long_threads = [threading.Thread(target=lambda i=i: long_results.__setitem__(
            i, _http("POST", base + "/v1/completions", {
                "prompt_token_ids": prompts[n_requests + i], "max_tokens": probe_tokens,
                **greedy})), daemon=True) for i in range(8)]
        for t in long_threads:
            t.start()
        _wait_until(lambda: eng.stats.n_decode_dispatches - st1.n_decode_dispatches >= 4,
                    "obs: 4 decode dispatches of the long requests", 120.0, 0.005)
        prof: dict = {}
        first = threading.Thread(target=lambda: prof.setdefault(
            "first", _http("GET", f"{base}/debug/profile?seconds={profile_s}")), daemon=True)
        first.start()
        from llmd_tpu_torch.obs.device import capture_open

        while not capture_open() and first.is_alive():
            time.sleep(0.002)
        prof["second"] = _http("GET", f"{base}/debug/profile?seconds=0.2")
        first.join(timeout=120)
        for t in long_threads:
            t.join(timeout=900)
        assert all(r is not None and r[0] == 200 for r in long_results), long_results
        if prof["second"][0] != 409:
            raise AssertionError(f"obs: a concurrent capture answered {prof['second'][0]}")
        status, _, body = prof["first"]
        cap = json.loads(body)
        if status != 200 or not cap["files"] or cap["bytes"] <= 0:
            raise AssertionError(f"obs: /debug/profile {status} {cap}")
        events = json.loads(Path(cap["dir"], "trace.json").read_text())["traceEvents"]
        names = [e.get("name", "") for e in events]
        k1_events = sum(1 for e in events if e.get("cat") == "kernel"
                        and "paged_attention_mma" in e.get("name", ""))
        annotations = sorted({n for n in names if n.startswith("llmd.")})
        if "llmd.decode_dispatch" not in annotations or (on_card and not k1_events):
            raise AssertionError(f"obs: profile trace: K1 events {k1_events}, "
                                 f"annotations {annotations}")
        out["profile"] = {"seconds": cap["seconds"], "bytes": cap["bytes"],
                          "k1_kernel_events": k1_events, "annotations": annotations}
        shutil.rmtree(prof_dir, ignore_errors=True)
        # the probes, and K1's launches: once per layer of every forward plus
        # each probe run (the first probe's warm-up run included)
        _, _, text = _http("GET", base + "/metrics")
        text = text.decode()
        probes = _probe_counts(text)
        if probes["attn"] < 1 or not eng._attn_probe_on:
            raise AssertionError(f"obs: attn probe samples {probes}, on {eng._attn_probe_on}")
        st = eng.stats
        forwards = (st.n_unified_steps - st0.n_unified_steps
                    + st.n_decode_iterations - st0.n_decode_iterations)
        launches, plain_calls = read_counts()
        by_instance = instance_counts()
        want = cfg.num_layers * forwards + probes["attn"] + 1
        if on_card and (launches["paged_attention"] != want
                        or by_instance["paged_attention"]["mma"] != want
                        or any(plain_calls.values())):
            raise AssertionError(f"obs: K1 launches {launches['paged_attention']} "
                                 f"{by_instance['paged_attention']} expected {want} (mma), "
                                 f"plain {plain_calls}")
        out["launches"] = launches["paged_attention"]
        out["probe_launches"] = probes["attn"] + 1
        out["probes"] = probes
        out["attn_probe_ms_per_layer"] = _probe_ms(text, "attn", cfg.num_layers,
                                                   eng.cfg.decode_steps)
        # the HBM gauges against the allocator, read in-process, the engine
        # idle (no allocation between the poll and the read)
        label = f'{{device="cuda:{device.index or 0}"}}' if on_card else None
        if on_card:
            deadline = time.monotonic() + 5.0
            while True:
                stats = torch.cuda.memory_stats(device)
                _, _, t = _http("GET", base + "/metrics")
                t = t.decode()
                hbm = [_metric(t, f"llmd_tpu:device_hbm_{k}", label)
                       for k in ("bytes_in_use", "peak_bytes", "limit_bytes")]
                want_hbm = [float(stats["allocated_bytes.all.current"]),
                            float(stats["allocated_bytes.all.peak"]),
                            float(torch.cuda.get_device_properties(device).total_memory)]
                if hbm == want_hbm or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            resident = (eng.cache.numel() * eng.cache.element_size()
                        + sum(p.numel() * p.element_size() for p in eng.params.values()))
            if hbm != want_hbm or hbm[0] < resident:
                raise AssertionError(f"obs: HBM gauges {hbm} vs memory_stats {want_hbm}, "
                                     f"pool + weights {resident}")
            out["hbm"] = dict(zip(("in_use", "peak", "limit"), hbm))
        elif "llmd_tpu:device_hbm_bytes_in_use{" in text:
            raise AssertionError("obs: an HBM series on the CPU")
        if _metric(text, "llmd_tpu:device_fabric_alive") != 1.0 or not (
                _metric(text, "llmd_tpu:device_fabric_probe_seconds_count") or 0) >= 1:
            raise AssertionError("obs: device_fabric_alive is not 1 after a probe")
        # the watchdog: the engine lock held past LLMD_WATCHDOG_STALL_S while
        # a request is pending gives 503 engine_stalled, then 200
        pending = threading.Thread(target=lambda: _http("POST", base + "/v1/completions", {
            "prompt_token_ids": prompt(32, 64), "max_tokens": 64, **greedy}), daemon=True)
        pending.start()
        _wait_until(lambda: bool(eng.seqs), "obs: the pending request admitted", 60.0)
        lock = server.async_engine._lock
        lock.acquire()
        try:
            t0 = time.monotonic()
            health = None
            while time.monotonic() - t0 < 10.0:
                status, _, body = _http("GET", base + "/health")
                if status == 503:
                    health = json.loads(body)
                    break
                time.sleep(0.05)
        finally:
            lock.release()
        if health is None or health.get("reason") != "engine_stalled":
            raise AssertionError(f"obs: /health under a held engine lock: {health}")
        t0 = time.monotonic()
        while _http("GET", base + "/health")[0] != 200:
            if time.monotonic() - t0 > 10.0:
                raise AssertionError("obs: /health did not recover")
            time.sleep(0.05)
        pending.join(timeout=300)
        system = [e["event"] for e in eng.flight.system_events()]
        if not {"engine_stalled", "engine_recovered", "profile_capture"} <= set(system):
            raise AssertionError(f"obs: system events {system}")
        out["stall"] = health
        # /v1/responses = chat on the same messages (greedy; a prompt under
        # one page, so no prefix hit changes the second's shapes), and a
        # conversation of two turns
        content = "hi there"
        status, _, body = _http("POST", base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": content}], "max_tokens": 16, **greedy})
        chat = json.loads(body)["choices"][0]["message"]["content"]
        status2, _, body = _http("POST", base + "/v1/responses", {
            "input": content, "max_output_tokens": 16, **greedy})
        resp = json.loads(body)["output"][0]["content"][0]["text"]
        if status != 200 or status2 != 200 or resp != chat:
            raise AssertionError(f"obs: /v1/responses {status2} text differs from chat")
        _, _, body = _http("POST", base + "/v1/conversations", {})
        cid = json.loads(body)["id"]
        for turn in ("first turn", "second turn"):
            status, _, body = _http("POST", base + "/v1/responses", {
                "input": turn, "max_output_tokens": 8, "conversation": cid, **greedy})
            assert status == 200 and json.loads(body)["conversation"] == cid, body
        _, _, body = _http("GET", f"{base}/v1/conversations/{cid}/items")
        items = json.loads(body)["data"]
        if [i["role"] for i in items] != ["user", "assistant"] * 2 or [
                items[0]["content"], items[2]["content"]] != ["first turn", "second turn"]:
            raise AssertionError(f"obs: conversation items {items}")
        out["responses"] = {"text_equal_chat": True, "conversation_items": len(items)}
    finally:
        server.stop()
    log(f"obs: {model} bf16 on {card}: {n_requests} requests, timelines ordered, traced "
        f"{len(sent)}, request_phase deltas {out['request_phase_counts']}, exemplar trace "
        f"ids {out['exemplar_trace_ids']}; probes {out['probes']} attn K1 "
        f"{out['attn_probe_ms_per_layer']} ms a layer (batch {OBS_KW['max_batch_size']}, 8 "
        f"live rows); K1 launches {out['launches']} (probe runs {out['probe_launches']}); "
        f"profile {out['profile']}; HBM {out.get('hbm')}; stall {out['stall']}; "
        f"responses {out['responses']}")
    return out


def obs_probe_run(device, card: str, model: str, seed: int, label: str,
                  probe_tokens: int) -> dict:
    """``model`` at full width, bf16, sorted dispatch, the engine's
    defaults and OBS_KW's batch: 8 requests long enough for the probes. The
    attn probe runs the decode program's attention (K1, or K3 on MLA), the
    MoE probe the sorted dispatch's stages (K2 in ``experts_stage``); each
    probe took samples, none turned itself off, and each probe kernel ran
    once more per probe than the forwards account for (plus one warm-up)."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config

    cfg = get_model_config(model)
    eng = LLMEngine(cfg, EngineConfig(**(OBS_KW | {"moe_dispatch": "sorted"})), seed=seed,
                    device=device)
    eng.generate([[1, 2, 3]], SamplingParams(max_tokens=10, temperature=0.0))  # capture
    rng = np.random.default_rng(seed)
    st0 = dataclasses.replace(eng.stats)
    zero_counts()
    eng.generate([rng.integers(0, cfg.vocab_size, int(rng.integers(64, 257))).tolist()
                  for _ in range(8)], SamplingParams(max_tokens=probe_tokens, temperature=0.0))
    text = eng.registry.expose()
    probes = _probe_counts(text)
    moe = cfg.is_moe
    if probes["attn"] < 1 or (moe and min(probes[p] for p in probes) < 1) \
            or not eng._attn_probe_on or (moe and not eng._moe_probe_on):
        raise AssertionError(f"obs {label}: probe samples {probes}, on "
                             f"{eng._attn_probe_on}/{eng._moe_probe_on}")
    st = eng.stats
    unified = st.n_unified_steps - st0.n_unified_steps
    iters = st.n_decode_iterations - st0.n_decode_iterations
    L, runs = cfg.num_layers, probes["attn"] + 1
    launches, plain = read_counts()
    by = instance_counts()
    if cfg.is_mla:
        want = {"paged_attention": (L * unified, "mma"), "mla_decode": (L * iters + runs, "mma")}
    else:
        want = {"paged_attention": (L * (unified + iters) + runs, "mma")}
    if moe:
        want["ragged_grouped_gemm"] = (2 * L * (unified + iters) + 2 * runs, "wgmma")
    if device.type == "cuda":
        for name, (n, inst) in want.items():
            if launches[name] != n or by[name][inst] != n:
                raise AssertionError(f"obs {label}: {name} launches {launches[name]} "
                                     f"{by[name]} expected {n} on {inst}")
        if any(plain.values()):
            raise AssertionError(f"obs {label}: plain versions ran {plain}")
    k = eng.cfg.decode_steps
    ms = {p: _probe_ms(text, p, L, k) for p in probes}
    log(f"obs: {label} bf16 on {card}: probes {probes}, ms a layer and iteration {ms}; "
        f"launches {({n: launches[n] for n in want})} (probe runs {runs})")
    out = {"probes": probes, "probe_ms": ms, "launches": {n: launches[n] for n in want},
           "probe_launches": runs}
    del eng
    _empty()
    return out


def obs_numbers(device, card: str, model: str, seed: int, batch: int, isl: int,
                osl: int) -> dict:
    """Informational: the recorder's host cost (µs per ``flight.record``, per
    decode call's recording of 32 rows, per terminal ``finish`` with both
    exporters), ``record_function``'s cost outside a capture (what entering
    it at every step would add) beside the gate's flag read, and bf16 decode
    tok/s at ``batch`` rows of ISL ``isl`` / OSL ``osl`` (``decode_steps``
    32) with the recorder and decision ledger at their defaults against the
    same window with ``LLMD_FLIGHT_MAX_EVENTS=0`` and
    ``LLMD_DECISION_LEDGER=0``, in turns (on, off, on, off)."""
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.obs.attribution import attach_phase_exporter
    from llmd_tpu_torch.obs.decisions import attach_decision_exporter
    from llmd_tpu_torch.obs.device import profile_phase
    from llmd_tpu_torch.obs.events import FlightRecorder
    from llmd_tpu_torch.obs.metrics import Registry, register_engine_metrics

    def us_per(fn, n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    fr = FlightRecorder(max_events=1 << 30)
    fr.start("r")
    record_us = us_per(lambda: fr.record("r", "decode", n_tokens=4, generated=100), 20000)
    rows = [f"r{i}" for i in range(32)]
    for rid in rows:
        fr.start(rid)
    call_us = us_per(lambda: [fr.record(rid, "decode", n_tokens=4, generated=100)
                              for rid in rows], 2000)
    metrics = register_engine_metrics(Registry())
    finish_fr = FlightRecorder()
    attach_phase_exporter(finish_fr, metrics.request_phase)
    attach_decision_exporter(finish_fr, metrics, plane="engine")
    ids = iter(range(10 ** 9))

    def one_request() -> None:
        rid = f"f{next(ids)}"
        finish_fr.start(rid, model=model)
        for ev in ("arrival", "admitted", "prefill_start", "prefill_end", "first_token",
                   "chain_dispatch"):
            finish_fr.record(rid, ev)
        finish_fr.finish(rid, event="retired", reason="length", spec_drafted=8,
                         spec_accepted=5, spec_flips=1)
    request_us = us_per(one_request, 2000)
    nothing = lambda: None  # noqa: E731
    gated = profile_phase("llmd.decode_dispatch")(nothing)

    def entered() -> None:
        with torch.profiler.record_function("llmd.decode_dispatch"):
            pass
    rf_us = us_per(entered, 20000) - us_per(nothing, 20000)
    gate_us = us_per(gated, 20000) - us_per(nothing, 20000)
    cfg = get_model_config(model)
    pages = batch * (-(-(isl + osl) // PS) + 1) + 8
    kw = dict(max_batch_size=batch, decode_steps=32, num_pages=max(pages, 64))
    off_env = {"LLMD_FLIGHT_MAX_EVENTS": "0", "LLMD_DECISION_LEDGER": "0"}
    engines = {}
    for on in (True, False):
        with _env({} if on else off_env):
            engines[on] = _lora_engine(device, cfg, {}, lora=False, seed=seed, **kw)
    rng = np.random.default_rng(seed + 7)
    turns = []
    for _ in range(2):
        for on in (True, False):
            reqs = [(rng.integers(0, cfg.vocab_size, isl).tolist(), None) for _ in range(batch)]
            r = _lora_window(engines[on], reqs, osl)
            turns.append((on, r["decode_tokens_fused"] / max(r["time_decode_steps"], 1e-9)))
    del engines
    _empty()
    on = [t for o, t in turns if o]
    off = [t for o, t in turns if not o]
    row = {"record_us": record_us, "decode_call_recording_us_32_rows": call_us,
           "request_lifecycle_us": request_us, "record_function_us": rf_us,
           "record_function_us_per_decode_step": 2 * rf_us, "gate_us": gate_us,
           "decode_tok_s_turns": turns, "decode_tok_s_ledgers_on": on,
           "decode_tok_s_ledgers_off": off,
           "ratio": statistics.median(on) / statistics.median(off)}
    log(f"obs: host cost on {card}: flight.record {record_us:.3f} us, a decode call's "
        f"recording (32 rows) {call_us:.3f} us, a request's lifecycle with both exporters "
        f"{request_us:.3f} us; record_function {rf_us:.3f} us a range "
        f"({2 * rf_us:.3f} us a decode step of two phases) against the gate's "
        f"{gate_us:.3f} us")
    log(f"obs: {model} bf16 on {card}: decode tok/s batch {batch} ISL {isl} OSL {osl} "
        f"ledgers on {on} off {off} ratio {row['ratio']:.4f}")
    return row


def phase_obs(device, card: str, seed: int = 0, dense: str = "llama-1b", moe: str = MOE,
              mla: str = MLA, n_requests: int = 8, prompt_range=(64, 512),
              max_tokens: int = 32, probe_tokens: int = 300, profile_s: float = 1.0,
              bench=(64, 256, 128), time_report: "dict | None" = None) -> dict:
    """The observability plane (``llmd_tpu_torch/obs``, the server's debug,
    Responses and Conversations routes) at full width: the main run on
    ``dense``, the probe runs on ``moe`` and ``mla``, the informational
    numbers. ``time_report``: the time phase's K1 rows, printed beside the
    probe's K1 time."""
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.tools.profile_engine import profile_batch

    t0 = time.perf_counter()
    out = {"main": obs_main_run(device, card, dense, seed, n_requests, prompt_range,
                                max_tokens, probe_tokens, profile_s)}
    _empty()
    if time_report is not None:
        log(f"obs: K1 on {card}: attn probe {out['main']['attn_probe_ms_per_layer']} ms a "
            f"layer at batch {OBS_KW['max_batch_size']} (8 live rows) beside the time "
            f"phase's decode B=64 {time_report['decode']['ms']} ms and decode B=8 "
            f"(kv 3072-5120) {time_report['decode_b8']['ms']} ms")
    if device.type == "cuda":
        # the recorder and the ledgers add no launch call to a replayed decode
        # iteration: one graph launch and two RNG-state fills a call
        r = profile_batch(get_model_config(dense), None, 8, 256, OBS_KW["decode_steps"], 5, 3,
                          seed)
        calls = r["host_launch_calls_per_iteration"]
        if calls != 3 / OBS_KW["decode_steps"]:
            raise AssertionError(f"obs: {calls} host launch calls a replayed decode "
                                 f"iteration, expected {3 / OBS_KW['decode_steps']}")
        out["host_launch_calls_per_iteration"] = calls
        log(f"obs: {dense} replayed with the recorder on: {calls} host launch calls a "
            f"decode iteration on {card}")
        _empty()
    out["moe"] = obs_probe_run(device, card, moe, seed, "moe sorted", probe_tokens)
    out["mla"] = obs_probe_run(device, card, mla, seed, "mla sorted", probe_tokens)
    out["numbers"] = obs_numbers(device, card, dense, seed, *bench)
    out["seconds"] = time.perf_counter() - t0
    log(f"obs: phase {out['seconds']:.1f} s on {card}")
    return out


# --------------------------------------------------------------------------
# The launch surface: the serve CLI as a pool launches it, the predictor's
# training feed, K1's launch-config table, the kernel-selection modes and DP
# rank frontends
# --------------------------------------------------------------------------

LAUNCH_KW = dict(page_size=PS, num_pages=2048, max_model_len=2048, max_batch_size=32,
                 prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)
# the port bench's engine at its default shape: the tuner's table entry is
# keyed at its decode launch (64 rows over a 64-page table)
TUNE_KW = dict(page_size=PS, num_pages=2048, max_model_len=1024, max_batch_size=64,
               prefill_chunk=256, max_num_batched_tokens=8192, decode_steps=32)
# each rank process of check 4b: llama-1b's serving settings at batch 8
DP_RANK_KW = dict(page_size=PS, num_pages=1024, max_model_len=2048, max_batch_size=8,
                  prefill_chunk=512, decode_steps=4)
# the predictor's training row: the arrival features and the latencies
FEATURES = ("kv_usage", "input_len", "queue_depth", "running_requests", "inflight_tokens",
            "prefix_match_pct", "tokens_generated", "ttft_ms", "tpot_ms")


class _SampleSink:
    """The latency trainer's ``POST /samples`` in miniature, on loopback:
    every posted row kept, in order."""

    def __init__(self) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        sink = self
        self.rows: list = []
        self.posts = 0

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:
                pass

            def do_POST(self) -> None:
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                ok = self.path == "/samples" and isinstance(body.get("samples"), list)
                if ok:
                    sink.rows.extend(body["samples"])
                    sink.posts += 1
                data = json.dumps({"accepted": len(body.get("samples", []))}).encode()
                self.send_response(200 if ok else 404)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _replica_argv(port: int, cache_dir: str, tune_file: str, sink_url: str) -> list:
    """A port replica's argv in the shape of ``llmd_tpu.pool.launcher.
    engine_argv`` (written out here: this script imports nothing of
    ``llmd_tpu``): ``-m <serve> --model M --port P``, the warm start's
    ``--compile-cache-dir``, then the pool's extra flags (speculation,
    structured outputs, the chain depth, the tune table, the trainer) and the
    bench's decode batch, so the table's entry applies."""
    return [sys.executable, "-m", "llmd_tpu_torch.engine.serve",
            "--model", "llama-1b", "--port", str(port),
            "--compile-cache-dir", cache_dir,
            "--host", "127.0.0.1", "--block-size", str(PS), "--num-pages", "2048",
            "--max-model-len", "1024", "--max-batch-size", "64", "--prefill-chunk", "256",
            "--decode-steps", "4", "--spec-mode", "ngram", "--spec-tokens", "4",
            "--structured-mode", "auto", "--structured-fused", "on",
            "--spec-structured", "on", "--decode-chain-depth", "2",
            "--attn-tune-file", tune_file, "--predictor-train-url", sink_url]


def _launch_replica(argv: list, log_path: Path, timeout_s: float = 400.0) -> dict:
    """Start a replica, wait for ``/health`` 200 and its serving line: the
    process, the line, the seconds from spawn to healthy and the kernel
    libraries it compiled (its ``native builds: N compiled``)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=open(log_path, "w"), text=True, start_new_session=True)
    port = argv[argv.index("--port") + 1]
    url = f"http://127.0.0.1:{port}/health"
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"launch: the replica exited rc {proc.returncode}: "
                                 f"{log_path.read_text()[-3000:]}")
        try:
            if _get(url)[0] == 200:
                break
        except (OSError, ValueError):
            pass
        if time.perf_counter() - t0 > timeout_s:
            proc.kill()
            raise AssertionError(f"launch: no /health 200 in {timeout_s} s: "
                                 f"{log_path.read_text()[-3000:]}")
        time.sleep(0.2)
    start_s = time.perf_counter() - t0
    line = proc.stdout.readline().strip()
    m = re.search(r"native builds: (\d+) compiled", line)
    if m is None:
        proc.kill()
        raise AssertionError(f"launch: no build count in the serving line {line!r}")
    return {"proc": proc, "line": line, "start_s": start_s, "compiled": int(m.group(1)),
            "base": f"http://127.0.0.1:{port}"}


def _stop_replica(rep: dict) -> None:
    proc = rep["proc"]
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def launch_replica_runs(device, card: str, tune_file: str, cold: dict, cache_dir: str,
                        sink: _SampleSink, n: int = 8, max_tokens: int = 32) -> dict:
    """Check 1: the cold replica (already healthy) serves ``n`` completions,
    the sink receives ``n`` training rows carrying every feature column; the
    replica stops and one relaunched on the same cache directory loads the
    kernels from it with no compiler run."""
    rng = np.random.default_rng(5)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    prompts = [bytes(rng.choice(letters, int(k))).decode()
               for k in rng.integers(64, 400, n)]
    try:
        done = [_post(cold["base"] + "/v1/completions", {
            "prompt": p, "max_tokens": max_tokens, "temperature": 0}) for p in prompts]
        _wait_until(lambda: len(sink.rows) >= n, "launch: the trainer's rows", 10.0, 0.05)
        _, metrics = _http("GET", cold["base"] + "/metrics")[::2]
    finally:
        _stop_replica(cold)
    if any(s != 200 or b["usage"]["completion_tokens"] != max_tokens for s, b in done):
        raise AssertionError(f"launch: replica completions {done[:2]}")
    rows = sink.rows[:n]
    missing = [sorted(set(FEATURES) - set(r)) for r in rows if set(FEATURES) - set(r)]
    if len(sink.rows) != n or missing or not all(
            r["tpot_ms"] is not None and r["ttft_ms"] > 0 for r in rows):
        raise AssertionError(f"launch: the sink holds {len(sink.rows)} rows (want {n}), "
                             f"missing columns {missing[:2]}: {rows[:1]}")
    files = sorted(p.name for p in Path(cache_dir).glob("*.so"))
    warm = _launch_replica(cold["argv"], Path(cache_dir).parent / "warm.log")
    try:
        status, body = _post(warm["base"] + "/v1/completions", {
            "prompt": prompts[0], "max_tokens": 4, "temperature": 0})
    finally:
        _stop_replica(warm)
    after = sorted(p.name for p in Path(cache_dir).glob("*.so"))
    if cold["compiled"] < 1 or warm["compiled"] != 0 or after != files or status != 200:
        raise AssertionError(f"launch: cold compiled {cold['compiled']}, warm compiled "
                             f"{warm['compiled']} (want 0), cache {files} -> {after}, "
                             f"warm completion {status}")
    tune = re.search(r"tune (\w+)", cold["line"]).group(1)
    hit = _metric(metrics.decode(), "llmd_tpu:engine_attn_backend",
                  f'{{backend="cuda_paged_attention",tune="{tune}"}}')
    log(f"launch: replica cold start {cold['start_s']:.1f} s ({cold['compiled']} libraries "
        f"compiled into {cache_dir}), warm start {warm['start_s']:.1f} s (0 compiled, "
        f"{len(files)} loaded); {n} completions, {sink.posts} posts, {len(rows)} training "
        f"rows with {list(FEATURES)}; /metrics backend info tune={tune} ({hit}) on {card}")
    return {"cold_start_s": cold["start_s"], "warm_start_s": warm["start_s"],
            "cold_compiled": cold["compiled"], "warm_compiled": warm["compiled"],
            "cache_files": files, "rows": rows, "posts": sink.posts, "tune": tune,
            "metrics_tune_info": hit, "line": cold["line"]}


def launch_tuned_k1(device, table) -> dict:
    """K1 on the mma instance under the table's plan, at the tuner's decode
    shape (64 rows, kv 128-1024, a 64-page table), against the plain version
    in float32: bf16 rounding units <= BF16_UNITS, both controls above it."""
    from llmd_tpu_torch.ops import paged_attention as pa

    c = decode_case(torch.bfloat16, device)
    N, B, maxp = c["q"].shape[0], c["pts"].shape[0], c["pts"].shape[1]
    override = pa.plan_override(table, N, PS, maxp, H, D, 2 * HK)
    plan = pa._plan(N, B, maxp, PS, H // HK, HK, pa._num_sms(0), override)
    before = dict(pa.paged_attention.launches_by_instance)
    got = run_attention(functools.partial(pa.paged_attention, tune=table), c)
    torch.cuda.synchronize()
    inst = {k: v - before[k] for k, v in pa.paged_attention.launches_by_instance.items()}
    ref = run_attention(pa.paged_attention_ref, dict(c, q=c["q"].float(), pool=c["pool"].float()))
    v = c["valid"]
    units = pa.bf16_rounding_units(got[:v], ref[:v])
    ctl_p = pa.bf16_rounding_units(run_attention(pa.paged_attention_ref, c)[:v], ref[:v])
    ctl_acc = pa.bf16_rounding_units(bf16_accumulating_control(c), ref[:v])
    row = {"override": override, "plan": dataclasses.asdict(plan), "bf16_units": units,
           "control_p_bf16_units": ctl_p, "control_acc_bf16_units": ctl_acc}
    log(f"launch: K1 under the tuned plan {row['plan']} (override {override}): "
        f"bf16_units={units:.3f} (limit {BF16_UNITS}) controls p_bf16={ctl_p:.1f} "
        f"acc_bf16={ctl_acc:.1f}")
    if override is None or inst != {**dict.fromkeys(inst, 0), "mma": 1} or not (
            units <= BF16_UNITS < min(ctl_p, ctl_acc)):
        raise AssertionError(f"launch: K1 under the tuned plan: {row}, launched {inst}")
    return row


def launch_tuned_engines(device, card: str, tune_file: str, winner_is_policy: bool,
                         seed: int = 0, n: int = 8, max_tokens: int = 32) -> dict:
    """Check 2's engines: llama-1b bf16 at the bench's shape built from the
    table against one built without it (decode graphs captured, pipelined):
    launch counts equal; tokens identical where the winner is the policy's
    plan, else the identical share reported (not bounded)."""
    from llmd_tpu_torch.models import get_model_config

    cfg = get_model_config("llama-1b")
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(0, cfg.vocab_size, int(k)).tolist()
               for k in rng.integers(64, 512, n)]
    plain = _served_run(device, cfg, dict(TUNE_KW), prompts, max_tokens, seed, True)
    tuned = _served_run(device, cfg, dict(TUNE_KW, attn_tune_file=tune_file), prompts,
                        max_tokens, seed, True)
    same = sum(a == b for r in plain["tokens"] for a, b in zip(plain["tokens"][r],
                                                             tuned["tokens"][r]))
    share = same / max(1, sum(len(v) for v in plain["tokens"].values()))
    row = {"identical_share": share, "launches": tuned["launches"],
           "launches_plain": plain["launches"], "decode_tok_s": tuned["decode_tok_s"],
           "decode_tok_s_plain": plain["decode_tok_s"],
           "launches_by_instance": tuned["launches_by_instance"]}
    log(f"launch: tuned engine vs untuned (bf16, {n} requests) on {card}: launches "
        f"{tuned['launches']} vs {plain['launches']}, identical tokens {share:.4f}, "
        f"decode tok/s {tuned['decode_tok_s']:.1f} vs {plain['decode_tok_s']:.1f}")
    if (tuned["launches"] != plain["launches"] or any(tuned["plain_calls"].values())
            or tuned["launches"]["paged_attention"] == 0
            or (winner_is_policy and tuned["tokens"] != plain["tokens"])):
        raise AssertionError(f"launch: tuned engine {row} (winner is the policy: "
                             f"{winner_is_policy})")
    return row


def launch_modes(device, card: str, seed: int = 0, n: int = 8, max_tokens: int = 16,
                 moe_layers: int = 4, mla_layers: int = 2) -> dict:
    """Check 3, float32: llama-1b ``attn_impl="reference"`` = ``"auto"`` in
    tokens with 0 K1 launches; moe-wide-mla (``mla_layers``) reference = auto
    with 0 K1-latent and 0 K3 launches; moe-wide-sim (``moe_layers``)
    ``moe_matmul="einsum"`` = ``"pallas"`` with 0 K2 / K4 launches, on the
    sorted dispatch (pallas: K2, all on its simt instance in float32) and on
    the einsum dispatch (pallas: K4, likewise)."""
    from llmd_tpu_torch.models import get_model_config

    out = {}
    for label, model, layers, a, b, off, on in (
            ("dense", "llama-1b", None, {"attn_impl": "reference"}, {"attn_impl": "auto"},
             ("paged_attention",), ("paged_attention",)),
            ("mla", MLA, mla_layers, {"attn_impl": "reference"}, {"attn_impl": "auto"},
             ("paged_attention", "mla_decode"), ("paged_attention", "mla_decode")),
            ("moe", MOE, moe_layers, {"moe_matmul": "einsum"}, {"moe_matmul": "pallas"},
             ("ragged_grouped_gemm", "grouped_gemm"), ("ragged_grouped_gemm",)),
            ("moe_einsum", MOE, moe_layers, {"moe_matmul": "einsum", "moe_dispatch": "einsum"},
             {"moe_matmul": "pallas", "moe_dispatch": "einsum"},
             ("ragged_grouped_gemm", "grouped_gemm"), ("grouped_gemm",))):
        if device.type != "cuda":  # a CPU rehearsal: the kernels' mode is auto there
            b = {k: "auto" if v == "pallas" else v for k, v in b.items()}
        cfg = get_model_config(model)
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  **({"num_layers": layers} if layers else {}))
        rng = np.random.default_rng(seed + 3)
        prompts = [rng.integers(0, cfg.vocab_size, int(k)).tolist()
                   for k in rng.integers(32, 256, n)]
        ref, ker = (_served_run(device, cfg, dict(LAUNCH_KW, **kw), prompts, max_tokens,
                                seed, True) for kw in (a, b))
        row = {"tokens_equal": ref["tokens"] == ker["tokens"],
               "plain_mode_launches": ref["launches"], "plain_mode_plain_calls":
               ref["plain_calls"], "kernel_mode_launches": ker["launches"],
               "kernel_mode_by_instance": ker["launches_by_instance"]}
        out[label] = row
        log(f"launch: modes {label} f32 {a} vs {b} on {card}: tokens equal "
            f"{row['tokens_equal']}, launches {ref['launches']} (plain calls "
            f"{ref['plain_calls']}) vs {ker['launches']}")
        by = ker["launches_by_instance"]
        bad = (not row["tokens_equal"] or any(ref["launches"][k] for k in off)
               or not any(ref["plain_calls"].values()))
        if device.type == "cuda":  # launch checks run on the card only
            bad = bad or (not all(ker["launches"][k] for k in on)
                          or any(ker["plain_calls"].values())
                          or (label.startswith("moe") and any(
                              by[k]["simt"] != ker["launches"][k] for k in on)))
        if bad:
            raise AssertionError(f"launch: modes {label}: {row}")
    return out


def _completion_ids(body: dict) -> list:
    """Token ids of a completion decoded by ``IdTokenizer``."""
    return [ord(ch) - 0x10000 for ch in body["choices"][0]["text"]]


def launch_wide_ep(device, card: str, dtype: str, seed: int = 0, n: int = 8,
                   max_tokens: int = 32) -> dict:
    """Check 4a: a ``WideEPEngineGroup`` of 2 rank frontends over one
    llama-1b engine (the serving settings, KV events on), ``n`` requests
    split over both ports, concurrent; and a ``dp_ranks=1`` engine of the
    same seed on the same prompts. float32: tokens equal. Every page a rank
    allocated lies in its partition, and each rank's KV events hold its own
    prompts' blocks and none of the other rank's. Decode tok/s of both."""
    from llmd_tpu_torch.core.kv_events import BlockStored, block_keys_for_tokens
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.dp_group import WideEPEngineGroup
    from llmd_tpu_torch.models import get_model_config

    cfg = dataclasses.replace(get_model_config("llama-1b"), dtype=dtype)
    rng = np.random.default_rng(seed + 21)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    texts = [f"rank{i % 2} req{i} " + bytes(rng.choice(letters, int(k))).decode()
             for i, k in enumerate(rng.integers(64, 400, n))]
    group = WideEPEngineGroup(cfg, EngineConfig(**LAUNCH_KW, dp_ranks=2), ranks=2,
                              model_name="llmd-tpu/llama-1b", host="127.0.0.1",
                              tokenizer=IdTokenizer(cfg.vocab_size), device=device,
                              seed=seed, kv_events_port_base=0)
    eng = group.engine
    seen: dict = {0: set(), 1: set()}
    for r, alloc in enumerate(eng.allocs):  # observe each rank's page ids
        def allocate(orig=alloc.allocate, r=r):
            pid = orig()
            if pid is not None:
                seen[r].add(pid)
            return pid
        alloc.allocate = allocate
    group.start()
    subs = [_KVSubscriber(s.kv_events_port) for s in group.servers]
    try:
        eps = group.endpoints()
        for ep in eps:
            _post(f"http://{ep}/v1/completions", {"prompt": "warm up", "max_tokens": 2,
                                                  "temperature": 0})
        eng.stats = type(eng.stats)()
        results: list = [None] * n

        def one(i: int) -> None:
            results[i] = _post(f"http://{eps[i % 2]}/v1/completions", {
                "prompt": texts[i], "max_tokens": max_tokens, "temperature": 0})

        threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        st = eng.stats
        group_tok_s = st.decode_tokens_fused / max(st.time_decode_steps, 1e-9)
    finally:
        for sub in subs:
            sub.stop()
        group.stop()
        del group, eng
    if any(r is None or r[0] != 200 for r in results):
        raise AssertionError(f"launch: wide-EP completions {results[:2]}")
    got = {f"req-{i}": _completion_ids(r[1]) for i, r in enumerate(results)}
    ppr = LAUNCH_KW["num_pages"] // 2
    out_of_range = {r: sorted(p for p in pids if not r * ppr <= p < (r + 1) * ppr)[:4]
                    for r, pids in seen.items()}
    stored = [{h for _, _, evs in sub.batches for e in evs if isinstance(e, BlockStored)
               for h in e.block_hashes} for sub in subs]
    own = [set(), set()]
    for i, t in enumerate(texts):
        ids = list(t.encode())[: LAUNCH_KW["max_model_len"] - 1]  # as the engine truncates
        own[i % 2] |= set(block_keys_for_tokens(ids, PS, None, []))
    events_ok = all(own[r] <= stored[r] and not (own[1 - r] & stored[r]) for r in (0, 1))
    one_rank = _served_run(device, cfg, dict(LAUNCH_KW), [list(t.encode()) for t in texts],
                           max_tokens, seed, True)
    equal = one_rank["tokens"] == got
    row = {"dtype": dtype, "tokens_equal": equal, "pages_by_rank": {r: len(p) for r, p in
                                                                   seen.items()},
           "out_of_range": out_of_range, "events_ok": events_ok,
           "stored_blocks": [len(s) for s in stored], "decode_tok_s_ranks": group_tok_s,
           "decode_tok_s_one_rank": one_rank["decode_tok_s"]}
    same = sum(a == b for r in got for a, b in zip(got[r], one_rank["tokens"][r]))
    row["identical_share"] = same / max(1, sum(len(v) for v in got.values()))
    log(f"launch: wide-EP 2 ranks {dtype} on {card}: tokens equal to one rank {equal} "
        f"(share {row['identical_share']:.4f}), pages by rank {row['pages_by_rank']}, "
        f"KV events own blocks only {events_ok} ({row['stored_blocks']} stored), decode "
        f"tok/s ranks {group_tok_s:.1f} beside one rank {one_rank['decode_tok_s']:.1f}")
    if (any(out_of_range.values()) or not all(seen.values()) or not events_ok
            or (dtype == "float32" and not equal)):
        raise AssertionError(f"launch: wide-EP {dtype}: {row}")
    return row


def dp_rank0(device, rpc_port: int, seed: int = 0):
    """Rank 0 of a 2-rank ``DPEngineGroup`` in this process: the leader, its
    coordinator on ``rpc_port``, llama-1b at the rank processes' settings,
    retrying registration every 0.5 s until rank 1 joins."""
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.dp_group import DPEngineGroup, DPGroupConfig
    from llmd_tpu_torch.models import get_model_config

    group = DPEngineGroup(get_model_config("llama-1b"), EngineConfig(**DP_RANK_KW),
                          DPGroupConfig(dp_size=2, dp_size_local=1, dp_start_rank=0,
                                        dp_rpc_port=rpc_port, port_base=0),
                          model_name="llmd-tpu/llama-1b", host="127.0.0.1", device=device,
                          seed=seed)
    group.start()
    ae = group.servers[0].async_engine
    ae.register_retry_interval_s = 0.5
    ae._next_register = 0.0
    return group


def launch_dp_processes(device, card: str, group, rank1: subprocess.Popen, out_path: Path,
                        n_per: int = 4, max_tokens: int = 16) -> dict:
    """Check 4b: a ``DPEngineGroup`` of 2 rank processes on the card under one
    ``DPCoordinator``: rank 0 ``group`` here (:func:`dp_rank0`), rank 1 the
    process ``rank1``, both started at the phase's start. Once both
    registered, ``n_per`` completions to each rank; both serve, and the
    coordinator's waves equal the steps the two rank loops took (no request
    reached a rank before both registered, so no step was taken solo)."""
    ae = group.servers[0].async_engine
    try:
        _wait_until(lambda: b"ENDPOINT" in out_path.read_bytes(), "launch: rank 1 serving",
                    300.0, 0.2)
        ep1 = out_path.read_text().split("ENDPOINT", 1)[1].split()[0]
        _wait_until(lambda: ae.registered and group.coordinator.registered == {0, 1},
                    "launch: both ranks registered", 60.0, 0.05)
        eps = [group.servers[0].address, ep1]
        res: list = []
        lock = threading.Lock()

        def one(ep: str, i: int) -> None:
            r = _post(f"http://{ep}/v1/completions", {
                "prompt": f"dp rank request {i}", "max_tokens": max_tokens,
                "temperature": 0})
            with lock:
                res.append((ep, r))

        threads = [threading.Thread(target=one, args=(ep, i))
                   for i in range(n_per) for ep in eps]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        time.sleep(0.2)  # the loops' last reports
    finally:
        rank1.terminate()
        rank1.wait(timeout=60)
        waves = group.coordinator.waves
        steps0 = ae.steps
        group.stop()
        del group, ae
    m = re.search(r"STEPS (\d+) (\d+) (\d+)", out_path.read_text())
    if m is None:
        raise AssertionError(f"launch: rank 1 printed no steps: {out_path.read_text()[-2000:]}")
    steps1, empty1, reg1 = (int(x) for x in m.groups())
    ok = [r[0] == 200 and r[1]["usage"]["completion_tokens"] == max_tokens for _, r in res]
    row = {"waves": waves, "steps": [steps0, steps1], "rank1_empty_steps": empty1,
           "served": len(res), "ok": all(ok)}
    log(f"launch: DP group of 2 rank processes on {card}: {len(res)} completions "
        f"({sum(ok)} ok), coordinator waves {waves} = steps {steps0} + {steps1} "
        f"(rank 1 empty steps {empty1})")
    if not all(ok) or len(res) != 2 * n_per or not reg1 or waves != steps0 + steps1:
        raise AssertionError(f"launch: DP rank processes {row}")
    return row


def _allocated() -> int:
    """``torch.cuda.memory_allocated()`` with cuBLAS's per-handle workspaces
    released first: a thread's first product on a stream allocates one, kept
    by the library, not by any engine; no engine may be alive when this runs."""
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def phase_launch(device, card: str, seed: int = 0) -> dict:
    """The launch surface (``phase_launch``): see the module docstring's
    phase 19. Check 5 closes it: with every engine of the phase closed or
    dropped, ``torch.cuda.memory_allocated()`` is back at (or below) the
    phase's baseline, the cycle collector off for the whole phase."""
    import gc

    from llmd_tpu_torch.ops import attn_tune

    t0 = time.perf_counter()
    baseline = _allocated()
    gc.disable()  # a reference cycle that held an engine would show below
    work = Path(tempfile.mkdtemp(prefix="llmd-launch-"))
    out: dict = {}
    sink = _SampleSink()
    rank0 = rank1 = None
    try:
        # 2. the tuner (the bench, in this process), then its table's K1
        tune_file = str(work / "attn_tune.json")
        out["bench"] = row = phase_bench(device, card, [
            "--quantize", "none", "--tune-attn", "--attn-tune-file", tune_file])
        table = attn_tune.load_table(tune_file)
        winner, policy = row["attn_tune_winner"], row["attn_tune_policy"]
        log("launch: tuner candidates " + ", ".join(
            f"bkv={c['bkv']} ({c['splits']}x{c['split_keys']}) {c['ms']:.4f} ms"
            for c in row["attn_tune_candidates"])
            + f"; winner bkv={winner['bkv']} ({winner['splits']} splits) beside the "
            f"policy's {policy['splits']} splits; sha {table.sha} on {card}")
        if not (row["attn_tune_hash"] == table.sha and table.entries):
            raise AssertionError(f"launch: bench hash {row['attn_tune_hash']} != table "
                                 f"{table.sha}")
        # 1 and 4b start now: the cold replica compiles K1 into its own cache
        # directory and rank 1 loads its engine while the checks below run
        cache_dir = str(work / "compile_cache")
        argv = _replica_argv(_free_port(), cache_dir, tune_file, sink.url)
        cold: dict = {}

        def launch_cold() -> None:
            try:
                cold.update(_launch_replica(argv, work / "cold.log"), argv=argv)
            except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
                cold["error"] = e

        cold_thread = threading.Thread(target=launch_cold, daemon=True)
        cold_thread.start()
        rpc_port = _free_port()
        rank1_out = work / "rank1.out"
        rank1 = subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_dp_rank_worker.py"), "--rank", "1",
             "--dp-size", "2", "--rpc-port", str(rpc_port), "--model", "llama-1b",
             "--engine", json.dumps(DP_RANK_KW), "--seed", str(seed)], cwd=REPO,
            stdout=open(rank1_out, "w"),
            stderr=subprocess.STDOUT, start_new_session=True)
        rank0 = dp_rank0(device, rpc_port, seed)
        out["tuned_k1"] = launch_tuned_k1(device, table)
        out["tuned_engines"] = launch_tuned_engines(
            device, card, tune_file, winner["splits"] == policy["splits"]
            and winner["split_keys"] == policy["split_keys"], seed)
        # 3. the modes
        out["modes"] = launch_modes(device, card, seed)
        # 4. DP ranks on one card
        out["wide_ep_float32"] = launch_wide_ep(device, card, "float32", seed)
        out["wide_ep_bfloat16"] = launch_wide_ep(device, card, "bfloat16", seed)
        out["dp_processes"] = launch_dp_processes(device, card, rank0, rank1, rank1_out)
        rank0 = rank1 = None
        # 1. the replica: completions, the training rows, the warm relaunch
        cold_thread.join(timeout=600)
        if "error" in cold or "proc" not in cold:
            raise AssertionError(f"launch: cold replica: {cold.get('error')}")
        out["replica"] = launch_replica_runs(device, card, tune_file, cold, cache_dir, sink)
        if out["replica"]["tune"] != table.sha:
            raise AssertionError(f"launch: the replica's tune {out['replica']['tune']} "
                                 f"!= the table's {table.sha}")
    finally:
        sink.stop()
        if rank1 is not None:
            rank1.kill()
            rank1.wait(timeout=30)
        if rank0 is not None:
            rank0.stop()
        shutil.rmtree(work, ignore_errors=True)
        # 5. the HBM repair: no cycle collection, no empty_cache before the reading
        now = _allocated()
        gc.enable()
    out["memory"] = {"baseline": baseline, "after": now}
    out["seconds"] = time.perf_counter() - t0
    log(f"launch: memory allocated {now} B after the phase's engines closed and dropped "
        f"(baseline {baseline} B, the cycle collector off); phase {out['seconds']:.1f} s")
    if now > baseline:
        raise AssertionError(f"launch: {now - baseline} B still allocated after the "
                             "phase's servers stopped and engines were dropped")
    return out


# --------------------------------------------------------------------------
# The mesh (parallel/): one rank's kernel shapes, NCCL captured in a graph,
# and, with several cards, meshed engines as worlds of rank processes
# --------------------------------------------------------------------------

MESH_KW = dict(page_size=PS, num_pages=1024, max_model_len=4096, max_batch_size=16,
               prefill_chunk=2048, max_num_batched_tokens=2048, decode_steps=4)
TP2, TP4 = (H // 2, HK // 2), (H // 4, HK // 4)  # llama-1b heads on one tp rank
MLA_TP2 = (MLA_H // 2, 1)  # moe-wide-mla heads on one tp rank, the latent whole


def ep_receiver_case(dtype, device, seed: int, T: int = 64, ep: int = 2) -> dict:
    """K2's inputs on EP rank 0 of moe-wide-sim at ``ep`` (S/ep local slots),
    as ``ops/moe_dispatch.ep_moe`` builds them: the decode batch's T tokens
    routed to k distinct of the S slots at random, split over the ep ranks
    (T/ep tokens each); each sender's bucket for rank 0 holds its copies bound
    for rank 0's slots in (token, k) order, padded with -1 to cap = T/ep * k
    rows (the bounded bucket: nothing can drop); the receiver's ep * cap rows
    (pads on the sentinel slot) placed by the row plan at the kernel's block
    size; the weights of rank 0's slots for both launches of a layer."""
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.ops.moe_dispatch import _row_plan, pick_block_size

    Dm, Fe, k = moe_widths()
    S = get_model_config(MOE).moe_num_experts
    Sl, tpc = S // ep, T // ep
    cap = tpc * k
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    idx = np.argsort(rng.random((T, S)), axis=1)[:, :k]
    recv = np.full((ep * cap,), -1, np.int64)
    for src in range(ep):
        mine = idx[src * tpc:(src + 1) * tpc].reshape(-1)
        mine = mine[mine < Sl]
        recv[src * cap:src * cap + len(mine)] = mine
    lslot = torch.from_numpy(np.where(recv >= 0, recv, Sl))
    bc = pick_block_size(ep * cap, Sl, pallas=True)
    row, slot, rows, Tp = _row_plan(lslot, Sl, bc)
    xs = torch.zeros((Tp + 1, Dm)).index_copy_(0, row.long(), torch.randn((ep * cap, Dm),
                                                                           generator=g))
    nb = slot.shape[0]
    live_rows = (torch.arange(bc)[None, :] < rows[:, None])[..., None]
    h = torch.randn((nb, bc, Fe), generator=g) * live_rows
    wi = torch.randn((Sl, Dm, 2 * Fe), generator=g) * Dm ** -0.5
    wo = torch.randn((Sl, Fe, Dm), generator=g) * Fe ** -0.5
    xb, h, wi, wo = _on(device, dtype, xs[:Tp].view(nb, bc, Dm), h, wi, wo)
    return dict(launches=[("wi", xb, wi), ("wo", h, wo)], slot=slot.to(device),
                live=rows.to(device),
                shape=f"ep={ep} receiver rows={ep * cap} ({int((recv >= 0).sum())} routed) "
                      f"S_local={Sl} bc={bc} nb={nb}")


def mesh_kernel_checks(device) -> dict:
    """Every kernel against its plain version at one rank's shapes under the
    mesh, full width: K1 at llama-1b's tp=2 and tp=4 heads (16/4, 8/2) at
    decode B=64 and mixed, over bf16 and fp8 pools; K1's latent mode and K3
    at moe-wide-mla's tp=2 heads (8; both on their simt instances, the mma
    ones take 16 heads); K2 on ep rank 0's receiver rows at ep=2 (16 local
    slots, the buckets' pad rows on the sentinel); K4 over 16 groups (the
    einsum dispatch's local slots at ep=2, the decode batch's capacity 10).
    Bounds as the one-card checks': float32 within F32_ATOL (GEMM_F32_ATOL
    for K2 / K4), bfloat16 within one rounding unit with controls above."""
    def fp8(make):
        return lambda dt: (lambda c: dict(c, pool=fp8_pool(c["pool"])))(make(dt))

    def k1(heads, case):
        return lambda dt: case(dt, device, heads=heads)

    out = {"paged_attention": check_attention(device, name="paged_attention (mesh)", cases=(
        ("tp2_decode", k1(TP2, decode_case)), ("tp2_mixed", k1(TP2, mixed_case)),
        ("tp4_decode", k1(TP4, decode_case)), ("tp4_mixed", k1(TP4, mixed_case)),
        ("tp2_decode_fp8", fp8(k1(TP2, decode_case))),
        ("tp4_mixed_fp8", fp8(k1(TP4, mixed_case)))))}
    out["paged_attention_latent"] = check_attention(
        device, latent=True, name="paged_attention_latent (mesh)", cases=(
            ("tp2_mixed", lambda dt: mixed_case(dt, device, heads=MLA_TP2, latent=True)),
            ("tp2_decode", lambda dt: decode_case(dt, device, heads=MLA_TP2, latent=True))))
    out["mla_decode"] = check_mla_decode(device, heads=MLA_TP2[0], cases=(
        ("tp2_decode", 3, None), ("tp2_long_context_b4", 6, [3000, 4711, 6150, 8192, 0])))
    out |= check_gemms(device, plans=[
        ("ragged_grouped_gemm", (("ep2_receiver", lambda dt: ep_receiver_case(dt, device, 31)),)),
        ("grouped_gemm", (("ep2_local16", lambda dt: capacity_case(10, 16, dt, device, 32)),))])
    return out


def time_mesh_kernels(device, tm: dict) -> dict:
    """The rank-shaped kernels in bf16, each beside its bound, one PyTorch
    library call on the same inputs (the time phase's: SDPA for K1, K1-latent
    and K3, ``bmm`` for K2 / K4) and the one-card shape's time from the time
    phase (``tm``): K1 at tp=2 / tp=4 decode B=64 (one card: 32 heads), K1's
    latent mode at tp=2 mixed and K3 at tp=2 decode B=64+2 idle (one card: 16
    heads on the mma instance), K2's wi launch on the ep=2 receiver rows (one
    card: decode T=32 over 32 slots) and K4's wi launch over 16 groups (one
    card: 32 groups of capacity 5)."""
    from llmd_tpu_torch.ops import grouped_gemm as gg
    from llmd_tpu_torch.ops import mla_decode as md
    from llmd_tpu_torch.ops import paged_attention as pa

    bf = torch.bfloat16
    out = {}

    def row(name, label, fn, bound, unsharded_ms, shape, library, lib_name):
        ms = cuda_ms(fn)
        library_ms = cuda_ms(library)
        b_ms, by = bound
        out.setdefault(name, {})[label] = r = {
            "shape": shape, "ms": ms, "bound_ms": b_ms, "bound_by": by,
            "unsharded_ms": unsharded_ms, "library_ms": library_ms, "library": lib_name,
            "roofline_share": b_ms / ms}
        log(f"time: mesh {name} {label} {shape} ms={ms:.4f} bound_ms={b_ms:.4f} ({by}) "
            f"library_ms({lib_name})={library_ms:.4f} one-card shape ms={unsharded_ms:.4f} "
            f"roofline_share={r['roofline_share']:.3f}")

    for label, heads in (("tp2_decode", TP2), ("tp4_decode", TP4)):
        c = decode_case(bf, device, heads=heads)
        row("paged_attention", label, lambda c=c: run_attention(pa.paged_attention, c),
            attention_bound(c, bf), tm["paged_attention"]["decode"]["ms"],
            f"decode B=64 H{heads[0]} Hk{heads[1]} D64 bf16", sdpa_dense(c), "sdpa")
    c = mixed_case(bf, device, heads=MLA_TP2, latent=True)
    row("paged_attention_latent", "tp2_mixed", lambda: run_attention(pa.paged_attention, c),
        attention_bound(c, bf), tm["paged_attention_latent"]["mixed"]["ms"],
        f"mixed H{MLA_TP2[0]} latent W160 bf16 instance="
        f"{pa._instance(bf, 1, MLA_W, MLA_TP2[0])}", sdpa_latent(c), "sdpa, gather included")
    c3 = latent_decode_case(bf, device, heads=MLA_TP2[0])
    row("mla_decode", "tp2_decode", lambda: run_latent_decode(md.mla_decode, c3),
        latent_decode_bound(c3, bf), tm["mla_decode"]["decode"]["ms"],
        f"decode B=64+2 idle H{MLA_TP2[0]} W160 bf16 instance="
        f"{md._instance(bf, MLA_TP2[0], MLA_W)}", sdpa_latent(c3), "sdpa dense, gather included")
    for name, label, c, fn, one in (
            ("ragged_grouped_gemm", "ep2_receiver", ep_receiver_case(bf, device, 31),
             gg.ragged_grouped_gemm, tm["ragged_grouped_gemm"]["decode"]["ms"]),
            ("grouped_gemm", "ep2_local16", capacity_case(10, 16, bf, device, 32),
             gg.grouped_gemm, tm["grouped_gemm"]["decode"]["ms"])):
        _, x, w = c["launches"][0]
        ragged = name == "ragged_grouped_gemm"
        index = (c["slot"], c["live"]) if ragged else (c["live"],)
        bound_ms, by, _ = gemm_bound(x, w, c["slot"], c["live"], bf, len(index))
        slot_l = c["slot"].long()
        library = ((lambda x=x, w=w, s=slot_l: torch.bmm(x, w.index_select(0, s))) if ragged
                   else (lambda x=x, w=w: torch.bmm(x, w)))
        row(name, label, lambda x=x, w=w, index=index, fn=fn: fn(x, w, *index), (bound_ms, by),
            one, f"{c['shape']} wi bf16", library,
            "bmm over index_select-gathered weights, gather included" if ragged else "bmm")
    return out


def nccl_graph_check() -> dict:
    """A one-rank NCCL group on this card, then ``all_reduce`` /
    ``all_gather`` / ``all_to_all_single`` captured in one CUDA graph and
    replayed on fresh inputs: replayed must equal eager exactly
    (``parallel/checks.collectives_in_graph``). The collectives the decode
    program captures under a mesh are these."""
    import datetime

    import torch.distributed as dist

    from llmd_tpu_torch.parallel import checks

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        res = checks.collectives_in_graph()
    finally:
        dist.destroy_process_group()
    log(f"mesh: NCCL in a CUDA graph (world {res['world']}): all_reduce, all_gather, "
        f"all_to_all_single replayed vs eager max_abs_diff={res['max_abs_diff']}")
    if res["max_abs_diff"] != 0.0:
        raise AssertionError(f"mesh: NCCL replayed in a graph differs from eager: {res}")
    return res


def _mesh_generate(device, cfg, mesh, prompts, max_tokens, seed, decode_graph=True,
                   world=None, **kw):
    """Greedy tokens of one engine (rank 0 of ``world`` under ``mesh`` when
    the mesh spans several devices), its generation's output tok/s and
    stats, and rank 0's kernel launches in the measured run."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.engine import LLMEngine

    eng = LLMEngine(cfg, EngineConfig(**(MESH_KW | kw), mesh=mesh), seed=seed, device=device,
                    decode_graph=decode_graph,
                    rank_mesh=world.mesh(mesh) if mesh.num_devices > 1 else None)
    try:
        # warm-up (cuBLAS handles, the decode capture), no prefix of the prompts
        eng.generate([[7] * 8], SamplingParams(max_tokens=2, temperature=0.0))
        torch.cuda.synchronize()
        ring0 = eng.stats.n_ring_prefill_steps
        zero_counts()
        t0 = time.perf_counter()
        out = eng.generate(prompts, SamplingParams(max_tokens=max_tokens, temperature=0.0))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, _ = read_counts()
        st = eng.stats
        toks = [out[f"req-{i}"] for i in range(len(prompts))]
        return toks, {"tok_s": sum(map(len, toks)) / dt, "seconds": dt,
                      "rank0_launches": {k: v for k, v in launches.items() if v},
                      "ring_steps": st.n_ring_prefill_steps - ring0, "sp_attn_backend":
                      st.sp_attn_backend, "drops": st.moe_dropped_tokens,
                      "rebalances": st.eplb_rebalances, "captures": st.decode_graph_captures}
    finally:
        eng.close()


def mesh_worlds(device, card: str, seed: int = 0) -> dict:
    """With two cards or more: llama-1b tp=2; moe-wide-sim ep=2 with EPLB;
    moe-wide-mla tp=2; llama-1b sp=2 with one 2048-token fresh prompt on the
    ring; llama-1b dp=2 and sp=2 with 8 prompts, each step's rows split over
    the two ranks. Each: float32 tokens of the world (rank 0 here, rank 1 on cuda:1,
    NCCL; one world of two rank processes, ``parallel/launch.World``, for
    every mesh) equal to the one-card engine's, the replayed decode's equal
    to the eager one's, bfloat16's share of tokens equal to one card's,
    output tok/s beside one card's. With one card: not run (a fact of the
    machine)."""
    from llmd_tpu_torch.parallel.launch import World

    n = torch.cuda.device_count()
    if n < 2:
        log(f"mesh_world: not run, {n} device")
        return {"run": False, "devices": n}
    t0 = time.perf_counter()
    world = World.start(2, "cuda")
    log(f"mesh_world: a world of 2 rank processes (NCCL) up in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        from llmd_tpu_torch.engine.config import MeshConfig

        world.mesh(MeshConfig(tp=2))
        graph = world.call("llmd_tpu_torch.parallel.checks:collectives_in_graph")
        log(f"mesh_world: NCCL in a CUDA graph across 2 cards, replayed vs eager "
            f"max_abs_diff rank 0 {graph[0]['max_abs_diff']}, rank 1 "
            f"{graph[1][0]['max_abs_diff']}")
        if graph[0]["max_abs_diff"] != 0.0 or graph[1][0]["max_abs_diff"] != 0.0:
            raise AssertionError(f"mesh_world: NCCL replayed in a graph differs: {graph}")
        return {"run": True, "devices": n, "nccl_graph": graph,
                **_mesh_worlds(device, card, seed, world)}
    finally:
        world.close()


def _mesh_worlds(device, card: str, seed: int, world) -> dict:
    """``mesh_worlds``' engines on ``world``, mesh after mesh."""
    from llmd_tpu_torch.engine.config import MeshConfig
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.parallel.eplb import EPLBConfig

    rng = np.random.default_rng(seed)
    eplb = {"moe_dispatch": "sorted", "eplb": EPLBConfig(
        window_size=8, step_interval=2, num_redundant_experts=32)}
    worlds = (("llama-1b tp=2", "llama-1b", MeshConfig(tp=2), {}, None),
              ("moe-wide-sim ep=2 eplb", MOE, MeshConfig(ep=2), eplb, None),
              ("moe-wide-mla tp=2", MLA, MeshConfig(tp=2), {"moe_dispatch": "sorted"}, None),
              ("llama-1b sp=2 ring", "llama-1b", MeshConfig(sp=2), {}, 2048),
              ("llama-1b dp=2 rows", "llama-1b", MeshConfig(dp=2), {}, None),
              ("llama-1b sp=2 rows", "llama-1b", MeshConfig(sp=2), {}, None))
    out = {}
    for label, model, mesh, kw, fresh in worlds:
        base = get_model_config(model)
        vocab = base.vocab_size
        prompts = ([rng.integers(1, vocab, fresh).tolist()] if fresh else
                   [rng.integers(1, vocab, int(m)).tolist()
                    for m in rng.integers(64, 512, 8)])
        row: dict = {}
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, dtype=dtype)
            one, one_st = _mesh_generate(device, cfg, MeshConfig(), prompts, 16, seed, **kw)
            got, st = _mesh_generate(device, cfg, mesh, prompts, 16, seed, world=world, **kw)
            same = sum(a == b for x, y in zip(got, one) for a, b in zip(x, y))
            total = sum(map(len, one))
            row[dtype] = {"identical_share": same / total, "tok_s": st["tok_s"],
                          "one_card_tok_s": one_st["tok_s"], **st}
            if dtype == "float32":
                eager, eager_st = _mesh_generate(device, cfg, mesh, prompts, 16, seed,
                                                 decode_graph=False, world=world, **kw)
                row["replayed_equals_eager"] = (eager == got and eager_st["rank0_launches"]
                                                == st["rank0_launches"])
                if got != one or not row["replayed_equals_eager"]:
                    raise AssertionError(
                        f"mesh_world {label}: float32 tokens differ from one card's "
                        f"({same}/{total}), or the replayed run from the eager one (tokens "
                        f"or rank 0's launches {st['rank0_launches']} against "
                        f"{eager_st['rank0_launches']})")
            log(f"mesh_world: {label} {dtype} identical {same}/{total} output tok/s "
                f"{st['tok_s']:.1f} (one card {one_st['tok_s']:.1f}) ring_steps "
                f"{st['ring_steps']} {st['sp_attn_backend']} drops {st['drops']} "
                f"rebalances {st['rebalances']} captures {st['captures']} rank 0 "
                f"launches {st['rank0_launches']} on {card}")
        if fresh and row["float32"]["ring_steps"] < 1:
            raise AssertionError(f"mesh_world {label}: the fresh prompt missed the ring")
        out[label] = row
    out["llama-1b-vl tp=2 planes"] = _mesh_planes_world(device, card, seed, world)
    return out


def _text_ids(rng, cfg, n: int) -> list[int]:
    """``n`` random ids of the vocabulary, the media placeholder left out."""
    ids = rng.integers(1, cfg.vocab_size, n)
    return np.where(ids == cfg.mm_placeholder_id, 1, ids).tolist()


def _planes_script(eng, seed: int, tok) -> tuple[dict, dict]:
    """One engine's script of the planes world: an adapter request beside a
    base one, a ``logit_bias`` and a ``guided_choice`` request, a media
    request (a batch the masked decode graph serves), a plain request (the
    plain decode graph); then a second adapter loaded, after both graphs'
    capture, and a plain and a ``logit_bias`` request under it; then four
    prompts of a third of the pool each (the fourth evicts the
    first to the CPU tier) and the first again (reloaded). Greedy tokens by
    request, and the counts (``captured_before_late``: the graphs captured
    when the second adapter was written)."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.models.lora import make_adapter_weights

    cfg = eng.model_cfg
    rng = np.random.default_rng(seed)
    eng.load_lora_adapter("a", {k: v.cpu() for k, v in make_adapter_weights(
        cfg, eng.cfg.lora, torch.Generator().manual_seed(seed)).items()})
    k, ph = cfg.mm_tokens, cfg.mm_placeholder_id
    rows = (rng.standard_normal((k, cfg.hidden_size)) * 0.5).astype(np.float32)
    text = _text_ids(rng, cfg, 64)
    # each long prompt holds a third of the pool: the fourth evicts the first
    ps, n_pages = eng.cfg.page_size, eng.cfg.num_pages
    longs = [_text_ids(rng, cfg, n_pages // 3 * ps - ps // 2) for _ in range(4)]
    g = dict(max_tokens=16, temperature=0.0)
    batches = [[("base", text, g, {}), ("adapter", text, g, {"lora_id": "a"}),
                ("bias", text, dict(g, logit_bias={7: 100.0}), {}),
                ("choice", tok.encode("pick"), dict(g, guided_choice=["red", "green"],
                                                   stop_token_ids=(tok.eos_id,)), {}),
                ("media", text[:8] + [ph] * k + text[8:24], g,
                 {"mm_items": [(b"planes-image", rows)]})]]
    batches += [[("plain", text[:40], g, {})], [("late", text, g, {"lora_id": "b"})],
                [("late_bias", text, dict(g, logit_bias={7: 100.0}), {"lora_id": "b"})]]
    batches += [[(f"long{i}", p, dict(g, max_tokens=4), {})] for i, p in enumerate(longs)]
    batches += [[("again", longs[0], dict(g, max_tokens=4), {})]]
    toks: dict = {}
    for i, batch in enumerate(batches):
        if i == 2:
            captured = eng.stats.decode_graph_captures
            eng.load_lora_adapter("b", {k: v.cpu() for k, v in make_adapter_weights(
                cfg, eng.cfg.lora, torch.Generator().manual_seed(seed + 1)).items()})
        for rid, prompt, sp, kw in batch:
            eng.add_request(rid, prompt, SamplingParams(**sp), **kw)
        while eng.has_work():
            for o in eng.step():
                toks.setdefault(o.request_id, []).extend(o.new_token_ids)
    st = eng.stats
    return toks, {"offload_loads": st.total_offload_loads, "chain_stages":
                  st.structured_chain_stages, "captures": st.decode_graph_captures,
                  "captured_before_late": captured, "violations": st.structured_violations}


def _plane_ops_ms(eng, n: int = 48) -> dict:
    """Rank 0's wall ms (best of 3, the card synchronized around each) of
    ``eng``'s data plane and mask staging ops: ``pages_out`` of ``n`` pages,
    ``pages_in`` of those blocks from the host back into the same pages, and
    ``mask_stage`` of a plan that fills the masked programs' buffers
    (``structured_table_max_elems``); on a world the workers take part."""
    pool, pids = eng.kv_pool, list(range(n))

    def best(fn) -> float:
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return min(ts) * 1e3

    blocks = pool.gather(pids).cpu()
    V = eng.model_cfg.vocab_size
    rows = max(1, eng.cfg.structured_table_max_elems // V)
    bias, nxt = np.zeros((rows, V), np.float32), np.zeros((rows, V), np.int32)
    res = {"pages": n, "page_bytes": blocks.numel() * blocks.element_size(),
           "pages_out_ms": best(lambda: pool.gather(pids)),
           "pages_in_ms": best(lambda: pool.insert(pids, blocks)),
           "mask_rows": rows, "mask_bytes": bias.nbytes + nxt.nbytes,
           "mask_stage_ms": best(lambda: eng._op("mask_stage", n=rows,
                                                 host={"bias": bias, "nxt": nxt}))}
    eng._mask_buffers.staged = None  # the buffers hold no plan now
    return res


def _mesh_planes_world(device, card: str, seed: int, world) -> dict:
    """LoRA, the masked programs, media rows and the KV data plane on a tp=2
    world, llama-1b with the VL tower's media rows (``vl_full``) in float32:
    the planes script (``_planes_script``) on one card, on the world with the
    decode graphs and without; then the world's engine prefills a fresh
    prompt and exports its blocks over the KVT1 wire to the one-card engine,
    which decodes it. float32 tokens equal one card's, replayed equal eager
    (the second adapter's request included, its slot written after the
    graphs' capture on both ranks), the offload tier reloaded, the D's
    tokens equal the world's own; the data plane's and the mask staging's
    op times on the world beside one card's (``_plane_ops_ms``)."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.disagg import transfer as ttr
    from llmd_tpu_torch.engine.config import EngineConfig, MeshConfig
    from llmd_tpu_torch.engine.engine import LLMEngine
    from llmd_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmd_tpu_torch.models.lora import LoRAConfig

    t0 = time.perf_counter()
    cfg = vl_full("float32")
    tok = ByteTokenizer()
    kw = MESH_KW | dict(num_pages=96, lora=LoRAConfig(max_adapters=2, rank=16),
                        cpu_offload_pages=256)
    pd_prompt = _text_ids(np.random.default_rng(seed + 1), cfg, 300)
    runs = {}
    one = None
    try:
        one = LLMEngine(cfg, EngineConfig(**kw), seed=seed, device=device, tokenizer=tok)
        runs["one"] = _planes_script(one, seed, tok)
        ops = {"one": _plane_ops_ms(one)}
        for label, graph in (("eager", False), ("replayed", True)):
            eng = LLMEngine(cfg, EngineConfig(**kw, mesh=MeshConfig(tp=2)), seed=seed,
                            device=device, tokenizer=tok, decode_graph=graph,
                            rank_mesh=world.mesh(MeshConfig(tp=2)))
            try:
                zero_counts()
                runs[label] = _planes_script(eng, seed, tok)
                runs[label][1]["rank0_launches"] = {
                    k: v for k, v in read_counts()[0].items() if v}
                if graph:  # P: prefill, export; then its own decode of the prompt
                    ops["tp=2"] = _plane_ops_ms(eng)
                    sp = SamplingParams(max_tokens=1, temperature=0.0)
                    eng.add_request("pd", pd_prompt, sp)
                    while eng.has_work():
                        eng.step()
                    src = ttr.KVTransferSource(host="127.0.0.1", transport="python")
                    src.start()
                    try:
                        tx = time.perf_counter()
                        ttr.export_from_engine(eng, src, "pd", pd_prompt)
                        export_s = time.perf_counter() - tx
                        pulled = ttr.KVTransferClient(timeout_s=60).pull(
                            "127.0.0.1", src.port, "pd")
                    finally:
                        src.stop()
                    own = eng.generate([pd_prompt], SamplingParams(max_tokens=16,
                                                                   temperature=0.0))["req-0"]
            finally:
                eng.close()
        injected = ttr.inject_into_engine(one, pulled, pd_prompt)
        d_toks = one.generate([pd_prompt], SamplingParams(max_tokens=16,
                                                          temperature=0.0))["req-0"]
    finally:
        if one is not None:
            one.close()
    res = {"tokens_equal": runs["replayed"][0] == runs["one"][0],
           "replayed_equals_eager": runs["replayed"][0] == runs["eager"][0],
           "counts": {k: v[1] for k, v in runs.items()}, "pd_blocks": injected,
           "pd_export_s": export_s, "pd_tokens_equal": d_toks == own, "plane_ops": ops,
           "seconds": time.perf_counter() - t0}
    log(f"mesh_world: planes tp=2 ({cfg.name} float32): tokens == one card "
        f"{res['tokens_equal']}, replayed == eager {res['replayed_equals_eager']}, counts "
        f"{res['counts']}; P/D {injected} blocks exported in {export_s:.3f} s, D tokens == "
        f"the world's {res['pd_tokens_equal']}; {res['seconds']:.1f} s on {card}")
    for k, v in ops.items():
        log(f"mesh_world: planes {k}: pages_out {v['pages']} pages ({v['page_bytes']} B) "
            f"{v['pages_out_ms']:.3f} ms, pages_in {v['pages_in_ms']:.3f} ms, mask_stage "
            f"{v['mask_rows']} rows ({v['mask_bytes']} B) {v['mask_stage_ms']:.3f} ms on {card}")
    c = res["counts"]
    if not (res["tokens_equal"] and res["replayed_equals_eager"] and res["pd_tokens_equal"]
            and injected > 0 and c["replayed"]["captured_before_late"] == 2
            and c["replayed"]["captures"] == 2
            and all(v["offload_loads"] > 0 and v["chain_stages"] > 0
                    and v["violations"] == 0 for v in c.values())):
        raise AssertionError(f"mesh_world planes: {res} tokens {runs}")
    return res


def lora_shard_check(device, seed: int = 0, tokens: int = 64, rank: int = 16,
                     model: str = "llama-1b") -> dict:
    """The adapter bank under tp=2 through the engine's own code, on this
    card: one layer of ``model`` (llama-1b: 32 heads, 16 a rank) with 9 slots of rank
    16, every token on a random slot, through ``models/transformer.
    forward_core`` once on one card and once as two tp=2 ranks
    (``_TwoRanksOnOneCard``: threads, the reduce a barrier sum in the pool
    dtype), each rank holding its ``shard_params`` block of the weights and
    of the bank, whose slots the engine's ``_op_lora_write`` writes
    (``parallel/mesh.lora_adapter_block``). Held: the ranks' hidden states
    equal; float32, the tp=2 hidden within 1e-5 of the one-card hidden;
    wo's output under tp as the reduce returns it (wo's partial plus the
    adapter's partial from this rank's heads' rows of A, summed over the
    ranks) against the one-card expression (wo's product plus
    ``apply_lora`` of the whole bank) on the same attention rows (the
    ranks', concatenated): float32 within 1e-5; bfloat16, in units of one
    bf16 rounding of the largest output (2^-8·max|ref|) against the float32
    product of the same bf16 inputs, at most one unit more than the
    one-card expression reads (the partials are rounded before the sum)."""
    from types import SimpleNamespace

    from llmd_tpu_torch.engine.config import MeshConfig
    from llmd_tpu_torch.engine.engine import LLMEngine
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.lora import LoRAConfig, apply_lora, init_lora_params, slot_mask
    from llmd_tpu_torch.models.transformer import forward_core, init_cache, init_params, linear
    from llmd_tpu_torch.ops.paged_attention import paged_attention_ref
    from llmd_tpu_torch.parallel.mesh import (
        RankMesh, engine_rules, lora_bank_axes, param_logical_axes, shard_params)

    t0 = time.perf_counter()
    lcfg = LoRAConfig(max_adapters=8, rank=rank)
    S, N = lcfg.n_slots, tokens
    pages = -(-N // PS)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_model_config(model), num_layers=1, dtype=dtype)
        g = torch.Generator().manual_seed(seed)
        params = init_params(cfg, g, device=device)
        bank = init_lora_params(cfg, lcfg, device)
        ranks = [RankMesh(MeshConfig(tp=2), q, device, {}) for q in (0, 1)]
        rparams = [shard_params(params, q, param_logical_axes(cfg), engine_rules(cfg, 1, False))
                   for q in ranks]
        rbanks = [shard_params(init_lora_params(cfg, lcfg, device), q, lora_bank_axes())
                  for q in ranks]
        for slot in range(1, S):  # the engine's slot write, on one card and on each rank
            w = {}
            for key, b in bank.items():
                shape = b[:, :, slot].shape if key.startswith("lora_A_") else b[:, slot].shape
                scale = shape[1] ** -0.5 if key.startswith("lora_A_") else 0.05
                w[key] = torch.randn(shape, generator=g) * scale
            for pb, mesh in [(bank, None)] + list(zip(rbanks, ranks)):
                LLMEngine._op_lora_write(SimpleNamespace(_lora_params=pb, rank_mesh=mesh,
                                                         device=device), slot=slot, weights=w)
        toks = torch.randint(1, cfg.vocab_size, (N,), generator=g).to(device)
        idx = torch.randint(0, S, (N,), generator=g).to(device)
        inputs = dict(positions=torch.arange(N, dtype=torch.int32, device=device),
                      seq_slots=torch.zeros(N, dtype=torch.int32, device=device),
                      page_tables=torch.arange(pages, dtype=torch.int32, device=device)[None],
                      kv_lens=torch.tensor([N], dtype=torch.int32, device=device),
                      lora_indices=idx, lora_scale=lcfg.scale)
        attn: dict = {}

        def recorded(key):
            def impl(q, cache, pt, pos, sids, lens, *, scale, **_):
                attn[key] = paged_attention_ref(q, cache, pt, pos, sids, lens, scale=scale)
                return attn[key]
            return impl

        one = forward_core(cfg, params | bank, init_cache(cfg, pages, PS, device=device),
                           toks, attn_impl=recorded("one"), **inputs)[0]
        pair = _TwoRanksOnOneCard()
        hidden = pair.run(lambda r: forward_core(
            cfg, rparams[r] | rbanks[r], init_cache(cfg, pages, PS, device=device, tp=2), toks,
            attn_impl=recorded(r), mesh=pair.meshes[r], **inputs)[0])
        # the reduces: the embedding's, wo's, the MLP's; wo's output is the second
        o_tp = pair.meshes[0].reduced[1]
        x = torch.cat([attn[0], attn[1]], dim=1).reshape(N, -1)
        m = slot_mask(idx, S, x.dtype)
        A, B = bank["lora_A_wo"][0], bank["lora_B_wo"][0]
        o_one = linear(params, "wo", 0, x) + apply_lora(x, A, B, m, lcfg.scale)
        ref = (linear({"wo": params["wo"].float()}, "wo", 0, x.float())
               + apply_lora(x.float(), A.float(), B.float(), m.float(), lcfg.scale))
        unit = 2.0 ** -8 * ref.abs().max().item()
        row = {"ranks_equal": torch.equal(hidden[0], hidden[1])
               and torch.equal(o_tp, pair.meshes[1].reduced[1]),
               "hidden_max_abs_vs_one_card": (hidden[0].float() - one.float()).abs().max().item(),
               "wo_max_abs_vs_one_card": (o_tp.float() - o_one.float()).abs().max().item(),
               "wo_rounding_units": (o_tp.float() - ref).abs().max().item() / unit,
               "wo_one_card_rounding_units": (o_one.float() - ref).abs().max().item() / unit}
        out[dtype] = row
        log(f"mesh: lora tp=2 {dtype} forward_core, one {cfg.name} layer, S={S} r={rank} "
            f"N={N}: ranks equal {row['ranks_equal']}, hidden max_abs_vs_one_card "
            f"{row['hidden_max_abs_vs_one_card']:.3g}, wo + adapter after the reduce "
            f"max_abs_vs_one_card {row['wo_max_abs_vs_one_card']:.3g}, rounding_units "
            f"{row['wo_rounding_units']:.3f} (one card {row['wo_one_card_rounding_units']:.3f})")
        if dtype == "float32":
            ok = (row["hidden_max_abs_vs_one_card"] <= 1e-5
                  and row["wo_max_abs_vs_one_card"] <= 1e-5)
        else:
            ok = row["wo_rounding_units"] <= row["wo_one_card_rounding_units"] + 1.0
        if not (ok and row["ranks_equal"]):
            raise AssertionError(f"mesh: lora tp=2 {dtype}: the ranks' forward differs from "
                                 f"the one-card forward: {row}")
    out["seconds"] = time.perf_counter() - t0
    log(f"mesh: lora shard check {out['seconds']:.2f} s")
    return out


class _TwoRanksOnOneCard:
    """Two ranks of a mesh with 2 on ``axis`` (tp by default) on this card,
    each a thread of ``run``: ``meshes[r]`` is what the engine's code reads
    of rank r's ``parallel/mesh.RankMesh`` (its place on the mesh, and the
    collectives over axes that hold ``axis`` as the ranks' parts met at a
    barrier: the all-gather in rank order, the sum in the parts' dtype, the
    scatter of rank 0's parts, the broadcast of rank 0's tensor; identities
    over the other axes, of one rank)."""

    class Mesh:
        def __init__(self, pair, r: int) -> None:
            from llmd_tpu_torch.engine.config import MeshConfig

            self.pair, self.rank = pair, r
            self.cfg = MeshConfig(**{pair.axis: 2})
            self.reduced: list = []  # every sum this rank's reduce returned

        def _on(self, axes) -> bool:
            return self.pair.axis in ((axes,) if isinstance(axes, str) else tuple(axes))

        def size(self, axes) -> int:
            return 2 if self._on(axes) else 1

        def index(self, axes) -> int:
            return self.rank if self._on(axes) else 0

        def _meet(self, x) -> list:
            p = self.pair
            p.parts[self.rank] = x
            p.barrier.wait()
            parts = list(p.parts)
            p.barrier.wait()
            return parts

        def gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
            return torch.cat(self._meet(x), dim=dim) if self._on(axes) else x

        def reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
            if not self._on(axes):
                return x
            a, b = self._meet(x)
            self.reduced.append(a + b)
            return self.reduced[-1]

        def scatter(self, out: torch.Tensor, parts) -> torch.Tensor:
            return out.copy_(self._meet(parts)[0][self.rank])

        def broadcast(self, x: torch.Tensor) -> torch.Tensor:
            return x.copy_(self._meet(x)[0])

    def __init__(self, axis: str = "tp") -> None:
        self.axis = axis
        self.parts = [None, None]
        self.barrier = threading.Barrier(2, timeout=60)
        self.meshes = [self.Mesh(self, r) for r in (0, 1)]

    def run(self, fn) -> list:
        """``fn(r)`` on both ranks at once: their results, rank 0's first."""
        res, errs = [None, None], []

        def one(r):
            try:
                res[r] = fn(r)
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=one, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if errs:
            raise errs[0]
        if any(t.is_alive() for t in threads):
            raise AssertionError("mesh: two ranks on one card did not finish in 120 s")
        return res

    def pool_op(self, halves, cfg, num_pages: int, op: str, host: dict, **kw) -> list:
        """The engine's ``_op_<op>`` (``engine/engine.py``) on both ranks,
        rank r over pool plane half ``halves[r]``; ``host`` goes to rank 0
        alone, as ``LLMEngine._op`` passes it."""
        from types import SimpleNamespace

        from llmd_tpu_torch.engine.engine import LLMEngine

        def rank(r):
            eng = SimpleNamespace(rank_mesh=self.meshes[r], cache=halves[r], model_cfg=cfg,
                                  cfg=SimpleNamespace(num_pages=num_pages))
            return getattr(LLMEngine, "_op_" + op)(eng, **kw, **(host if r == 0 else {}))

        return self.run(rank)


def pages_split_check(device, seed: int = 0, num_pages: int = 256, n: int = 48) -> dict:
    """The KV data plane's pool ops at tp=2 on this card: a llama-1b pool (16
    layers, 16 planes of 64, pages of 16) in bfloat16 and in fp8 split into
    its two tp ranks' plane halves; ``pages_out`` of ``n`` scattered pages
    (each rank its planes, all-gathered over tp) against the one-card
    ``extract_blocks`` of the whole pool: the same bytes exactly; then
    ``pages_in`` of those blocks into halves whose pages were zeroed (rank 0
    scatters each rank its planes): both halves restored exactly."""
    from llmd_tpu_torch.disagg.transfer import extract_blocks
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.transformer import init_cache

    cfg = get_model_config("llama-1b")
    rng = np.random.default_rng(seed)
    pids = sorted(rng.choice(num_pages, n, replace=False).tolist())
    out = {}
    for label, dtype in (("bfloat16", torch.bfloat16), ("fp8", torch.float8_e4m3fn)):
        t0 = time.perf_counter()
        pool = init_cache(cfg, num_pages, PS, dtype=torch.bfloat16, device=device)
        pool.copy_(torch.randn(pool.shape, device=device, dtype=torch.float32))
        pool = pool.to(dtype)
        want = extract_blocks(pool, pids, num_pages)
        half = pool.shape[2] // 2
        halves = [pool[:, :, q * half:(q + 1) * half].contiguous() for q in (0, 1)]
        pair = _TwoRanksOnOneCard()
        got = pair.pool_op(halves, cfg, num_pages, "pages_out", {},
                           pids=np.asarray(pids, np.int64))[0]
        same_out = torch.equal(got.view(torch.uint8).cpu(), want.view(torch.uint8))
        rows = (torch.arange(cfg.num_layers)[:, None] * num_pages
                + torch.tensor(pids)[None, :]).reshape(-1).to(device)
        for h in halves:
            h.view(torch.uint8).index_fill_(0, rows, 0)
        pair.pool_op(halves, cfg, num_pages, "pages_in", {"blocks": want},
                     pids=np.asarray(pids, np.int64))
        if device.type == "cuda":
            torch.cuda.synchronize()
        same_in = all(torch.equal(h.view(torch.uint8), pool[:, :, q * half:(q + 1) * half]
                                  .contiguous().view(torch.uint8))
                      for q, h in enumerate(halves))
        out[label] = {"pages": n, "bytes": want.numel() * want.element_size(),
                      "pages_out_equal": same_out, "pages_in_equal": same_in,
                      "seconds": time.perf_counter() - t0}
        log(f"mesh: pages tp=2 {label} pool {tuple(pool.shape)} {n} pages "
            f"({out[label]['bytes']} B): pages_out bytes == one-card extract_blocks "
            f"{same_out}, pages_in restored both halves {same_in}; "
            f"{out[label]['seconds']:.2f} s")
        if not (same_out and same_in):
            raise AssertionError(f"mesh: pages tp=2 {label}: {out[label]}")
    return out


def _split_batches(rng, ps: int, vocab: int, chunks, decodes: int, verify, decode_b: int,
                   kv_range):
    """The host batches of ``row_split_check``: a mixed unified step
    (``decodes`` decode rows, then prefill chunks of ``chunks`` rows at
    offsets 0-256), a verify-shaped step (``verify[0]`` sequences of
    ``verify[1]`` rows) and the decode slots (``decode_b``); each sequence
    on pages of its own, kv lengths in ``kv_range``. Returns them and the
    pages a layer needs."""
    next_page = [0]
    width = -(-max(kv_range[1], 256 + max(chunks)) // ps)

    def pages(kv: int) -> np.ndarray:
        n = -(-kv // ps)
        row = np.full((width,), -1, np.int32)
        row[:n] = np.arange(next_page[0], next_page[0] + n)
        next_page[0] += n
        return row

    def flat(q_lens, kv_lens):
        cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
        pos = np.concatenate([np.arange(k - q, k) for q, k in zip(q_lens, kv_lens)])
        return {"tokens": rng.integers(1, vocab, int(cu[-1])).astype(np.int32),
                "positions": pos.astype(np.int32),
                "seq_slots": np.repeat(np.arange(len(q_lens)), q_lens).astype(np.int32),
                "page_tables": np.stack([pages(k) for k in kv_lens]),
                "kv_lens": np.asarray(kv_lens, np.int32), "cu_q_lens": cu,
                "num_seqs": np.array([len(q_lens)], np.int32)}

    q = [1] * decodes + list(chunks)
    kv = ([int(k) for k in rng.integers(*kv_range, decodes)]
          + [int(rng.choice([0, 64, 128, 256])) + c for c in chunks])
    unified = flat(q, kv)
    n, t = verify
    verify_b = flat([t] * n, [int(k) for k in rng.integers(max(t, kv_range[0]), kv_range[1], n)])
    dkv = rng.integers(*kv_range, decode_b).astype(np.int32)
    dec = {"tokens": rng.integers(1, vocab, decode_b).astype(np.int32),
           "positions": dkv - 1, "page_tables": np.stack([pages(int(k)) for k in dkv]),
           "kv_lens": dkv, "steps_left": np.ones((decode_b,), np.int32),
           "temperature": np.zeros((decode_b,), np.float32),
           "top_k": np.zeros((decode_b,), np.int32), "top_p": np.ones((decode_b,), np.float32),
           "lora": np.zeros((decode_b,), np.int32)}
    return unified, verify_b, dec, next_page[0]


def row_split_check(device, card: str = "", seed: int = 0, model: str = "llama-1b",
                    chunks=(400, 300, 200, 120), decodes: int = 4, verify=(64, 5),
                    decode_b: int = 64, kv_range=(64, 384), time_reps: int = 10) -> dict:
    """A step's rows split over dp=2 through the engine's own code on this
    card: ``model`` at full width and depth (llama-1b: 16 layers), random
    weights from a seed, as two dp ranks (``_TwoRanksOnOneCard("dp")``:
    threads, the all-gather a barrier concatenation in rank order), each
    running its part of the rows (``parallel/rows``: ``flat_plan`` and
    ``local_batch``; the decode program's ``block_plan``) through
    ``models/transformer.forward_core`` with K1 (``paged_attention``), each
    over its own pool; and on one card over a third pool (the three drawn
    alike), each step whole, then its two parts in turn. Steps: one mixed
    unified step (4 decode rows and prefill chunks of 400, 300, 200 and 120
    rows at offsets 0-256: 1024 rows, the 400-row chunk straddling the
    split), a verify-shaped step (64 sequences x 5 rows) and one eager decode
    iteration at B=64 (``engine/decode_program``, its tokens gathered over dp
    inside it). Held, in both dtypes: each rank's final hidden rows
    bit-equal to one card's over the same rows (the parts in turn: the same
    products at the same row counts), and after every step the three pools
    byte-equal (the dump page aside); every K1 launch of a rank over its own rows; float32: the
    greedy tokens of every row (the decode call's sampled tokens) equal one
    card's whole step's. The ranks' hidden rows against the whole step's
    (its products over twice the rows round otherwise: f32 GEMMs and
    reductions at another row count) and, in bfloat16, the share of equal
    greedy tokens are printed. Timed in bfloat16 (CUDA graphs
    replayed, CUDA events): rank 0's unified forward over its rows, its dense
    layers and K1 (the K/V all-gather, an NCCL collective across cards, left
    out), beside the one-card forward of all the rows (``time_reps`` 0: not
    timed)."""
    from llmd_tpu_torch.engine.decode_program import PACKED, DecodeBuffers, decode_program
    from llmd_tpu_torch.engine.sampling import greedy_tokens
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.transformer import forward_core, init_cache, init_params, unembed
    from llmd_tpu_torch.ops import paged_attention as pa
    from llmd_tpu_torch.parallel.rows import (
        RowSplit, block_plan, flat_plan, local_batch, take_rows)

    t_all = time.perf_counter()
    unified, verify_b, dec, num_pages = _split_batches(
        np.random.default_rng(seed), PS, get_model_config(model).vocab_size, chunks, decodes,
        verify, decode_b, kv_range)
    out: dict = {}

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_model_config(model), dtype=dtype)
        L = cfg.num_layers
        params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
        pools = [init_cache(cfg, num_pages, PS, device=device) for _ in range(3)]
        pools[0].normal_(generator=torch.Generator(device=device).manual_seed(seed + 1))
        for p in pools[1:]:
            p.copy_(pools[0])
        pair = _TwoRanksOnOneCard("dp")
        seen: list = [[], [], []]  # K1's query rows per launch: one card, rank 0, rank 1

        def k1(who):
            def impl(q, *args, **kw):
                seen[who].append(q.shape[0])
                return pa.paged_attention(q, *args, **kw)
            return impl

        def fwd(b, who, mesh=None, split=None):
            b = {k: v if isinstance(v, torch.Tensor) else dev(v) for k, v in b.items()}
            return forward_core(
                cfg, params, pools[who], b["tokens"], b["positions"], b["seq_slots"],
                b["page_tables"], b["kv_lens"], cu_q_lens=b["cu_q_lens"],
                num_seqs=b["num_seqs"], attn_impl=k1(who), moe_dispatch_impl=None, mesh=mesh,
                rows=split)[0]

        def tokens(h):
            return greedy_tokens(unembed(cfg, params, h))

        def held(plan) -> dict:
            return {"rows": [len(p) for p in plan.parts],
                    # every page but the dump page (pad rows' writes)
                    "pools_equal": all(torch.equal(pools[0][:-1].view(torch.uint8),
                                                   p[:-1].view(torch.uint8)) for p in pools[1:]),
                    "k1_rows": [sorted(set(seen[1 + q])) for q in (0, 1)],
                    "k1_rows_ok": all(seen[1 + q] == [len(plan.parts[q])] * L for q in (0, 1))}

        row: dict = {}
        for label, batch in (("unified", unified), ("verify", verify_b)):
            plan = flat_plan(batch["tokens"].shape[0], 2)
            locs = [local_batch(batch, plan.parts[r], ()) for r in (0, 1)]
            for s in seen:
                s.clear()
            one = fwd(batch, 0)
            parts = [fwd(loc, 0) for loc in locs]  # one card, the parts in turn
            hid = pair.run(lambda r: fwd(locs[r], 1 + r, pair.meshes[r],
                                         RowSplit(pair.meshes[r], plan, device)))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            want = tokens(one)
            got = torch.cat([tokens(h) for h in hid])
            cut = len(plan.parts[0])
            row[label] = held(plan) | {
                "hidden_equal_one_card_parts": all(torch.equal(h, q)
                                                   for h, q in zip(hid, parts)),
                "straddling": int(sum(1 for b in range(len(batch["kv_lens"]))
                                      if batch["cu_q_lens"][b] < cut < batch["cu_q_lens"][b + 1])),
                "hidden_max_abs_vs_one_card": max(
                    (h.float() - one[dev(plan.parts[q])].float()).abs().max().item()
                    for q, h in enumerate(hid)),
                "tokens_equal_share": (got == want).float().mean().item()}
        # one iteration of the decode program, each rank its dp block of the slots
        plan = block_plan(decode_b, 2)
        for s in seen:
            s.clear()

        def decode_on(who, rows, mesh=None):
            buf = DecodeBuffers.allocate(len(rows), dec["page_tables"].shape[1], device)
            for name, (_, idle) in PACKED.items():
                getattr(buf, name).copy_(dev(take_rows(dec[name], rows, idle)))
            split = draw = None
            if mesh is not None:
                split = RowSplit(mesh, plan, device)
                draw = (decode_b, dev(np.clip(rows, 0, decode_b - 1).astype(np.int64)))
            gen = torch.Generator(device=device).manual_seed(seed)
            return decode_program(cfg, params, pools[who], buf, 1, gen, attn_impl=k1(who),
                                  moe_dispatch_impl=None, mesh=mesh, split=split,
                                  draw=draw).toks_out

        want = decode_on(0, np.arange(decode_b))
        blocks = torch.cat([decode_on(0, p) for p in plan.parts], dim=1)[:, :decode_b]
        got = pair.run(lambda r: decode_on(1 + r, plan.parts[r], pair.meshes[r]))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        row["decode"] = held(plan) | {"ranks_equal": torch.equal(got[0], got[1]),
                                      "hidden_equal_one_card_parts": torch.equal(got[0], blocks),
                                      "tokens_equal_share": (got[0] == want).float().mean().item()}
        if dtype == "bfloat16" and time_reps:  # rank 0's unified forward: its rows, all rows
            plan = flat_plan(unified["tokens"].shape[0], 2)
            loc = {k: dev(v) for k, v in local_batch(unified, plan.parts[0], ()).items()}
            whole = {k: dev(v) for k, v in unified.items()}  # on the card before the capture
            row["time"] = {"rank0_rows": len(plan.parts[0]),
                           "rows": int(unified["tokens"].shape[0]),
                           "rank0_ms": _graph_ms(lambda: fwd(loc, 1), time_reps),
                           "one_card_ms": _graph_ms(lambda: fwd(whole, 0), time_reps)}
        row["seconds"] = time.perf_counter() - t0
        out[dtype] = row
        del params, pools
        _empty()
        for label in ("unified", "verify", "decode"):
            r = row[label]
            log(f"mesh: rows dp=2 {dtype} {cfg.name} {label}: rows per rank {r['rows']}"
                + (f" ({r['straddling']} sequence straddling the split)" if "straddling" in r
                   else "")
                + (f", hidden max_abs_vs_one_card {r['hidden_max_abs_vs_one_card']:.3g}"
                   if "hidden_max_abs_vs_one_card" in r else "")
                + f", greedy tokens equal one card's {r['tokens_equal_share']:.4f}, equal to one "
                f"card over the parts in turn {r['hidden_equal_one_card_parts']}, pools "
                f"byte-equal {r['pools_equal']}, K1 rows per launch {r['k1_rows']}")
        if "time" in row:
            t = row["time"]
            log(f"mesh: rows dp=2 bfloat16 {cfg.name} unified forward: rank 0 over "
                f"{t['rank0_rows']} rows {t['rank0_ms']:.3f} ms, one card over {t['rows']} "
                f"rows {t['one_card_ms']:.3f} ms (CUDA graphs, CUDA events; the K/V "
                f"all-gather not included) on {card}")
        log(f"mesh: rows dp=2 {dtype} {row['seconds']:.2f} s")
        steps = ("unified", "verify", "decode")
        ok = (all(row[k]["pools_equal"] and row[k]["k1_rows_ok"]
                  and row[k]["hidden_equal_one_card_parts"] for k in steps)
              and row["decode"]["ranks_equal"])
        if dtype == "float32":
            ok = ok and all(row[k]["tokens_equal_share"] == 1.0 for k in steps)
        if not ok:
            raise AssertionError(f"mesh: rows dp=2 {dtype}: {row}")
    out["seconds"] = time.perf_counter() - t_all
    log(f"mesh: row split check {out['seconds']:.2f} s on {card}")
    return out


def _graph_ms(fn, reps: int) -> float:
    """Device ms of ``fn`` captured once into a CUDA graph and replayed
    (``cuda_ms``), so the host's launch work stays out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, reps=reps, inner=3)
    del graph
    return ms


def phase_mesh(device, card: str, tm: dict) -> dict:
    """The mesh phase: the rank-shaped kernel checks and times, NCCL in a
    graph, the adapter bank's and the pool's tp=2 splits on this card, and
    the NCCL worlds when the machine has the cards."""
    t0 = time.perf_counter()
    out = {"check": mesh_kernel_checks(device), "time": time_mesh_kernels(device, tm),
           "nccl_graph": nccl_graph_check(), "lora_shards": lora_shard_check(device),
           "pages": pages_split_check(device), "rows": row_split_check(device, card),
           "worlds": mesh_worlds(device, card)}
    out["seconds"] = time.perf_counter() - t0
    log(f"mesh: phase {out['seconds']:.1f} s on {card}")
    return out


# --------------------------------------------------------------------------
# The router (EPP) in front of two port engines
# --------------------------------------------------------------------------

# the README's precise-prefix config (precise prefix weight 3, queue depth 2)
ROUTER_CFG = """
plugins:
  - {name: token-producer, type: token-producer}
  - {name: precise-producer, type: precise-prefix-cache-producer, params: {blockSize: 16}}
  - {name: prefix, type: precise-prefix-cache-scorer}
  - {name: queue, type: queue-depth-scorer}
schedulingProfiles:
  - {name: default, plugins: [{pluginRef: prefix, weight: 3}, {pluginRef: queue, weight: 2}]}
"""
ROUTER_KW = dict(page_size=PS, num_pages=1024, max_model_len=2048, max_batch_size=8,
                 prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)


class _LoopThread:
    """An asyncio event loop on a thread of its own, for the port's asyncio
    servers (router, predictor sidecars, routing sidecar)."""

    def __init__(self) -> None:
        import asyncio

        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._thread.start()

    def _call(self, coro, timeout: float = 60):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=30)
        self.loop.close()


class _RouterThread(_LoopThread):
    """The port's ``RouterServer`` on an event loop of its own thread, in
    front of ``servers`` (each publishing KV events on loopback), or of
    ``endpoints`` (address, role, labels) when given; ``cfg_text`` its
    plugin graph, ``objectives`` its objective -> priority map."""

    def __init__(self, servers, poll_interval_s: float = 0.05, cfg_text: str = ROUTER_CFG,
                 endpoints=None, objectives=None) -> None:
        from llmd_tpu_torch.core.config import FrameworkConfig
        from llmd_tpu_torch.core.endpoint import Endpoint, EndpointPool, EndpointRole
        from llmd_tpu_torch.kv.subscriber import LABEL_KV_EVENTS_ADDR
        from llmd_tpu_torch.router.plugins import known_plugin_types
        from llmd_tpu_torch.router.server import RouterServer

        pool = EndpointPool()
        if endpoints is None:
            endpoints = [(s.address, "both",
                          {LABEL_KV_EVENTS_ADDR: f"127.0.0.1:{s.kv_events_port}"})
                         for s in servers]
        for address, role, labels in endpoints:
            pool.upsert(Endpoint(address=address, labels=labels, role=EndpointRole(role)))
        cfg = FrameworkConfig.from_yaml(cfg_text, known_types=known_plugin_types())
        self.router = RouterServer(cfg, pool, host="127.0.0.1", port=0,
                                   poll_interval_s=poll_interval_s, seed=0,
                                   objectives=objectives)
        super().__init__()
        self._call(self.router.start())
        self.url = f"http://{self.router.address}"
        t_end = time.monotonic() + 30
        while any(ep.attrs.get("kv_cache_utilization") is None for ep in pool.list()):
            if time.monotonic() > t_end:
                raise AssertionError("router: no metrics poll reached the engines in 30 s")
            time.sleep(0.02)

    def stop(self) -> None:
        try:
            self._call(self.router.stop())
        finally:
            self.close()


def _router_engines(device, cfg, n: int = 2, seed: int = 0, engine_kw: "dict | None" = None,
                    **server_kw) -> list:
    """``n`` port servers of the same weights (``seed``), KV events on free
    loopback ports, the id tokenizer (a text holds its tokens one for one);
    ``engine_kw`` goes over ``ROUTER_KW`` into each ``EngineConfig``,
    ``server_kw`` to each ``EngineServer``."""
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer

    servers = []
    for _ in range(n):
        s = EngineServer(cfg, EngineConfig(**(ROUTER_KW | (engine_kw or {}))),
                         host="127.0.0.1", port=0,
                         kv_events_port=0, tokenizer=IdTokenizer(cfg.vocab_size),
                         seed=seed, device=device, **server_kw)
        s.start()
        servers.append(s)
    return servers


def _router_text(rng, n: int) -> str:
    """``n`` tokens of text under the id tokenizer (one ASCII byte each)."""
    return "".join(chr(c) for c in rng.integers(ord("a"), ord("z") + 1, n))


def _complete(url: str, prompt: str, max_tokens: int) -> tuple:
    """(status, headers with lower-case names, parsed body)."""
    status, headers, body = _http("POST", url + "/v1/completions", {
        "prompt": prompt, "max_tokens": max_tokens, "temperature": 0, "ignore_eos": True})
    return status, {k.lower(): v for k, v in headers.items()}, json.loads(body)


def _stream_ttft(url: str, prompt: str, headers: "dict | None" = None,
                 extra: "dict | None" = None, t0: "float | None" = None) -> float:
    """Seconds from sending a streamed one-request (``headers`` and ``extra``
    body fields added) to its first SSE event, or from ``t0``."""
    import http.client

    host, port = url[len("http://"):].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    try:
        t0 = time.perf_counter() if t0 is None else t0
        conn.request("POST", "/v1/completions", json.dumps({
            "prompt": prompt, "max_tokens": 8, "temperature": 0, "ignore_eos": True,
            "stream": True, **(extra or {})}),
            {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"router: a streamed request answered {resp.status}")
        while not resp.readline().startswith(b"data: "):
            pass
        ttft = time.perf_counter() - t0
        resp.read()
        return ttft
    finally:
        conn.close()


def router_f32_check(device, card: str, model: str = "llama-1b", seed: int = 0,
                     groups: int = 6, prefix_len: int = 512, suffix_len: int = 32,
                     max_tokens: int = 16) -> dict:
    """Two float32 engines behind the router: ``groups`` prefix groups of 3
    greedy requests (a ``prefix_len``-token group prefix and a distinct
    ``suffix_len``-token suffix), the group's first alone and the other two
    together. Every reply 200; each group stays on its first's engine with
    ``cached_tokens`` >= ``prefix_len``; the routed tokens equal a direct
    request of the same prompt to the engine the router named; the router
    counts every request scheduled and its index holds the groups' blocks; K1
    launched on the engines (counted per instance)."""
    from concurrent.futures import ThreadPoolExecutor

    from llmd_tpu_torch.core.metrics_contract import parse_prometheus
    from llmd_tpu_torch.models import get_model_config

    cfg = dataclasses.replace(get_model_config(model), dtype="float32")
    rng = np.random.default_rng(seed)
    prompts = [[pfx + _router_text(rng, suffix_len) for _ in range(3)]
               for pfx in (_router_text(rng, prefix_len) for _ in range(groups))]
    servers = _router_engines(device, cfg, seed=seed)
    rt = None
    try:
        rt = _RouterThread(servers)
        zero_counts()
        routed = []
        with ThreadPoolExecutor(2) as pool:
            for group in prompts:
                routed.append(_complete(rt.url, group[0], max_tokens))
                routed += list(pool.map(lambda p: _complete(rt.url, p, max_tokens), group[1:]))
        if device.type == "cuda":
            torch.cuda.synchronize()
        by_instance = instance_counts()
        launches, _ = read_counts()
        _, _, metrics = _http("GET", rt.url + "/metrics")
        samples = {name: v for name, labels, v in parse_prometheus(metrics.decode())
                   if not labels}
        index_blocks = len(rt.router.kv_index)
        event_batches = rt.router.kv_subscriber.batches_received
        flat = [p for group in prompts for p in group]
        direct = [_complete(f"http://{h['x-llm-d-endpoint']}", p, max_tokens)
                  for (_, h, _), p in zip(routed, flat)]
    finally:
        if rt is not None:
            rt.stop()
        for s in servers:
            s.stop()
    statuses = [st for st, _, _ in routed]
    picks = [h.get("x-llm-d-endpoint") for _, h, _ in routed]
    texts = [b["choices"][0]["text"] for _, _, b in routed]
    cached = [b["usage"].get("cached_tokens", 0) for _, _, b in routed]
    sticky = all(picks[3 * g + i] == picks[3 * g] for g in range(groups) for i in (1, 2))
    warm = all(cached[3 * g + i] >= prefix_len for g in range(groups) for i in (1, 2))
    same = [t == b["choices"][0]["text"] for t, (_, _, b) in zip(texts, direct)]
    row = {"card": card, "model": model, "dtype": "float32", "groups": groups,
           "prefix_tokens": prefix_len, "suffix_tokens": suffix_len,
           "max_tokens": max_tokens, "statuses": statuses, "picks": picks,
           "cached_tokens": cached, "sticky": sticky, "warm": warm,
           "tokens_identical": all(same), "scheduled": samples.get("llm_d_epp_scheduled_total"),
           "index_blocks": index_blocks, "event_batches": event_batches,
           "launches": launches,
           "launches_by_instance": by_instance,
           "engines_used": len(set(picks))}
    log(f"router: f32 {model} on {card}: {groups} groups x 3 ({prefix_len}+{suffix_len} "
        f"tokens, {max_tokens} out): statuses {sorted(set(statuses))} sticky={sticky} "
        f"warm={warm} (cached {min(cached[1::3] + cached[2::3])}+) "
        f"tokens_identical={all(same)} scheduled={row['scheduled']} "
        f"index_blocks={index_blocks} event_batches={event_batches} "
        f"engines_used={row['engines_used']} "
        f"K1 by instance={by_instance['paged_attention']}")
    if set(statuses) != {200}:
        raise AssertionError(f"router: statuses {statuses}")
    if not sticky or not warm:
        raise AssertionError(f"router: a prefix group left its engine or missed its prefix "
                             f"(picks {picks}, cached {cached})")
    if not all(same):
        raise AssertionError(f"router: routed tokens differ from the named engine's ({same})")
    if row["scheduled"] != 3 * groups:
        raise AssertionError(f"router: /metrics counts {row['scheduled']} scheduled, "
                             f"expected {3 * groups}")
    if index_blocks < groups * (prefix_len // PS) or event_batches == 0:
        raise AssertionError(f"router: the KV index holds {index_blocks} blocks from "
                             f"{event_batches} event batches")
    if device.type == "cuda" and not (launches["paged_attention"] > 0
                                      and by_instance["paged_attention"].get("simt", 0) > 0):
        raise AssertionError(f"router: K1 did not launch behind the router ({by_instance})")
    return row


def router_bf16_times(device, card: str, model: str = "llama-1b", seed: int = 1,
                      hop_n: int = 32, ttft_n: int = 16, isl: int = 512) -> dict:
    """bf16 engines behind the router, times printed (not bounded): the hop,
    p50 of ``hop_n`` serial one-token requests routed minus direct (in turns,
    to the engine the router named), and TTFT p50 of streamed fresh
    ``isl``-token prompts, routed and direct in turns."""
    from llmd_tpu_torch.models import get_model_config

    cfg = dataclasses.replace(get_model_config(model), dtype="bfloat16")
    rng = np.random.default_rng(seed)
    servers = _router_engines(device, cfg, seed=seed)
    rt = None
    try:
        rt = _RouterThread(servers)
        prompt = _router_text(rng, 32)
        _, h, _ = _complete(rt.url, prompt, 1)  # warm: the prompt's pages cached
        target = f"http://{h['x-llm-d-endpoint']}"
        routed, direct = [], []
        for _ in range(hop_n):
            for url, out in ((rt.url, routed), (target, direct)):
                t0 = time.perf_counter()
                status, _, _ = _complete(url, prompt, 1)
                out.append(time.perf_counter() - t0)
                if status != 200:
                    raise AssertionError(f"router: a one-token request answered {status}")
        # the routed requests' phase ledgers: before the pick (the token
        # producer's render call to the engine), the pick, the forward
        from llmd_tpu_torch.obs.attribution import build_ledger

        ledgers = [build_ledger(rt.router.flight.get(r["request_id"]))["phases"]
                   for r in rt.router.flight.snapshot(limit=hop_n + 1)]
        phases = {k: statistics.median(lg.get(k, 0.0) for lg in ledgers)
                  for k in ("flow", "schedule", "upstream")}
        ttft_routed, ttft_direct = [], []
        for i in range(ttft_n):
            ttft_routed.append(_stream_ttft(rt.url, _router_text(rng, isl)))
            ttft_direct.append(_stream_ttft(target, _router_text(rng, isl)))
    finally:
        if rt is not None:
            rt.stop()
        for s in servers:
            s.stop()
    p50 = statistics.median
    row = {"card": card, "model": model, "dtype": "bfloat16", "hop_n": hop_n,
           "routed_p50_ms": p50(routed) * 1e3, "direct_p50_ms": p50(direct) * 1e3,
           "hop_p50_ms": (p50(routed) - p50(direct)) * 1e3,
           "routed_ms": [x * 1e3 for x in routed], "direct_ms": [x * 1e3 for x in direct],
           "ttft_n": ttft_n, "ttft_isl": isl,
           "ttft_routed_p50_ms": p50(ttft_routed) * 1e3,
           "ttft_direct_p50_ms": p50(ttft_direct) * 1e3,
           "routed_phase_p50_ms": phases}
    log(f"router: bf16 {model} on {card}: one-token request p50 routed "
        f"{row['routed_p50_ms']:.3f} ms, direct {row['direct_p50_ms']:.3f} ms, hop "
        f"{row['hop_p50_ms']:.3f} ms ({hop_n} each); streamed TTFT p50 ({isl}-token "
        f"prompts, {ttft_n} each) routed {row['ttft_routed_p50_ms']:.3f} ms, direct "
        f"{row['ttft_direct_p50_ms']:.3f} ms")
    log(f"router:   routed one-token request phases p50 (ms): before the pick (render "
        f"call) {phases['flow']:.3f}, pick {phases['schedule']:.3f}, forward to response "
        f"{phases['upstream']:.3f}")
    return row


def phase_router(device, card: str, model: str = "llama-1b", f32_kw=None,
                 bf16_kw=None) -> dict:
    """The router phase: the port's ``RouterServer`` (the README's precise
    config) in front of two port engines; correctness in float32, times in
    bf16."""
    t0 = time.perf_counter()
    out = {"f32": router_f32_check(device, card, model=model, **(f32_kw or {}))}
    _empty()
    out["bf16"] = router_bf16_times(device, card, model=model, **(bf16_kw or {}))
    out["seconds"] = time.perf_counter() - t0
    log(f"router: phase {out['seconds']:.1f} s on {card}")
    return out


# --------------------------------------------------------------------------
# The latency plane, the P/D routing sidecar and the KV plane's router side
# --------------------------------------------------------------------------

# every routed request's TTFT and e2e are observed against these objectives
LATENCY_SLO_ENV = {"LLMD_SLO_TTFT_MS": "2000", "LLMD_SLO_E2E_MS": "20000"}
HDR_OBJECTIVE, HDR_SLO_TTFT = "x-llm-d-inference-objective", "x-llm-d-slo-ttft-ms"
HDR_PREFILLER = "x-prefiller-host-port"


def _latency_cfg(predict_url: str, train_url: str) -> str:
    """The README's precise config with the four latency plugins: the
    producer in sidecar mode against the port's prediction and training
    servers, the SLO tier filter, the shedding admitter and the latency
    scorer beside the prefix and queue scorers."""
    return f"""
plugins:
  - {{name: token-producer, type: token-producer}}
  - {{name: precise-producer, type: precise-prefix-cache-producer, params: {{blockSize: 16}}}}
  - name: latency
    type: predicted-latency-producer
    params: {{mode: sidecar, predictUrls: ["{predict_url}"], trainUrl: "{train_url}"}}
  - {{name: tier, type: slo-headroom-tier-filter}}
  - {{name: admit, type: latency-slo-admitter}}
  - {{name: latency-score, type: latency-scorer}}
  - {{name: prefix, type: precise-prefix-cache-scorer}}
  - {{name: queue, type: queue-depth-scorer}}
schedulingProfiles:
  - name: default
    plugins:
      - {{pluginRef: tier}}
      - {{pluginRef: prefix, weight: 3}}
      - {{pluginRef: queue, weight: 2}}
      - {{pluginRef: latency-score, weight: 2}}
"""


def _pd_router_cfg(predict_url: str) -> str:
    """P/D: the decode profile, the predictor-gated decider past 16 uncached
    tokens, then the prefill profile; the latency producer stamps both."""
    return f"""
plugins:
  - {{name: prefix-producer, type: approx-prefix-cache-producer, params: {{blockSize: 16}}}}
  - name: latency
    type: predicted-latency-producer
    params: {{mode: sidecar, predictUrls: ["{predict_url}"]}}
  - {{name: prefill-filter, type: prefill-endpoints-filter}}
  - {{name: decode-filter, type: decode-endpoints-filter}}
  - {{name: prefix, type: prefix-cache-scorer}}
  - {{name: queue, type: queue-depth-scorer}}
  - {{name: picker, type: max-score-picker}}
profileHandler: disagg-profile-handler
disaggregation: {{uncachedSuffixThreshold: 16}}
schedulingProfiles:
  - name: prefill
    plugins: [{{pluginRef: prefill-filter}}, {{pluginRef: queue, weight: 1}}, {{pluginRef: picker}}]
  - name: decode
    plugins:
      - {{pluginRef: decode-filter}}
      - {{pluginRef: prefix, weight: 3}}
      - {{pluginRef: queue, weight: 1}}
      - {{pluginRef: picker}}
"""


def _plane_cfg(store_port: int) -> str:
    """The README's precise config behind a zone filter (every request to
    zone b, as a rollout pins traffic), its index in the external RESP
    store."""
    return f"""
plugins:
  - {{name: token-producer, type: token-producer}}
  - {{name: precise-producer, type: precise-prefix-cache-producer, params: {{blockSize: 16}}}}
  - {{name: prefix, type: precise-prefix-cache-scorer}}
  - {{name: queue, type: queue-depth-scorer}}
  - {{name: zone, type: label-selector-filter, params: {{zone: b}}}}
kvEvents: {{indexBackend: external, indexParams: {{host: 127.0.0.1, port: {store_port}}}}}
schedulingProfiles:
  - name: default
    plugins: [{{pluginRef: zone}}, {{pluginRef: prefix, weight: 3}}, {{pluginRef: queue, weight: 2}}]
"""


def _routed(url: str, prompt: str, max_tokens: int, headers: "dict | None" = None,
            **extra) -> tuple:
    """(status, headers with lower-case names, parsed body) of one greedy
    completion, ``headers`` and ``extra`` body fields added."""
    status, h, body = _http("POST", url + "/v1/completions", {
        "prompt": prompt, "max_tokens": max_tokens, "temperature": 0, "ignore_eos": True,
        **extra}, headers=headers)
    return status, {k.lower(): v for k, v in h.items()}, json.loads(body)


def _text(reply: tuple) -> str:
    status, _, body = reply
    if status != 200:
        raise AssertionError(f"latency: a request answered {status}: {body}")
    return body["choices"][0]["text"]


def _pd_reasons(router) -> list:
    """The P/D decider's reason of every routed request the flight recorder
    holds, oldest first."""
    out = []
    for summary in reversed(router.flight.snapshot(limit=10_000)):
        rec = router.flight.get(summary["request_id"]) or {"events": []}
        out += [e["pd"]["reason"] for e in rec["events"]
                if e.get("event") == "route_decision" and "pd" in e]
    return out


def _metric_lines(url: str) -> list:
    _, _, text = _http("GET", url + "/metrics")
    return text.decode().splitlines()


def _predict_round_trips(predict_url: str, n: int) -> list:
    """Seconds of ``n`` producer predict calls (two candidates each) against
    the prediction server, as the router's scheduling thread makes them."""
    from llmd_tpu_torch.predictor import LatencySample, SidecarPredictorClient

    cli = SidecarPredictorClient([predict_url], timeout_s=5.0)
    samples = [LatencySample(kv_usage=0.1 * i, input_len=256.0, queue_depth=float(i),
                             running_requests=2.0, prefix_match_pct=0.5,
                             inflight_tokens=300.0) for i in range(2)]
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        got = cli.predict(samples)
        out.append(time.perf_counter() - t0)
        if got is None:
            raise AssertionError("latency: the prediction server did not answer /predict")
    return out


def _fit_window(seed: int) -> dict:
    """One ``LatencyModel.fit`` over a full default window: 40 buckets
    (kv-usage decile x prefix-hit quartile) of 256 rows, 10,240 rows, of
    which the last 1,024 are held out and 9,216 fit."""
    from llmd_tpu_torch.predictor import LatencyModel, LatencySample, StratifiedWindow

    rng = np.random.default_rng(seed)
    window = StratifiedWindow()
    for kv in range(10):
        for ph in range(4):
            for _ in range(256):
                s = LatencySample(kv_usage=(kv + rng.uniform(0, 0.99)) / 10,
                                  input_len=float(rng.integers(16, 2048)),
                                  queue_depth=float(rng.integers(0, 20)),
                                  running_requests=float(rng.integers(0, 16)),
                                  prefix_match_pct=(ph + rng.uniform(0, 0.99)) / 4,
                                  inflight_tokens=float(rng.integers(0, 4096)))
                s.ttft_ms = (0.4 * s.input_len * (1 - s.prefix_match_pct)
                             + 80.0 * s.queue_depth + 10.0) * float(rng.normal(1.0, 0.02))
                s.tpot_ms = (5.0 + 2.5 * s.running_requests) * float(rng.normal(1.0, 0.02))
                window.add(s)
    rows = window.snapshot()
    model = LatencyModel()
    t0 = time.perf_counter()
    if not model.fit(rows):
        raise AssertionError("latency: the full window did not fit")
    return {"window_rows": len(rows), "fit_rows": len(rows) - len(rows) // 10,
            "seconds": time.perf_counter() - t0, "mape": model.mape}


class _Predictors(_LoopThread):
    """The port's training and prediction servers on one shared model file,
    and the RESP store of the external index."""

    def __init__(self, workdir: str) -> None:
        from llmd_tpu_torch.predictor.server import PredictionServer, TrainingServer
        from llmd_tpu_torch.testing.resp_server import RespStoreServer

        super().__init__()
        path = os.path.join(workdir, "latency-model.pkl")
        self.trainer = TrainingServer(path, port=0, retrain_interval_s=3600)
        self.predictor = PredictionServer(path, port=0, reload_interval_s=0.0)
        self._call(self.trainer.start())
        self._call(self.predictor.start())
        self.train_url = f"http://{self.trainer.address}"
        self.predict_url = f"http://{self.predictor.address}"
        self.store = RespStoreServer()
        self.store.start()

    def stop(self) -> None:
        try:
            self._call(self.trainer.stop())
            self._call(self.predictor.stop())
            self.store.stop()
        finally:
            self.close()


def _sidecar(loops: _LoopThread, decode_addr: str):
    from llmd_tpu_torch.disagg.sidecar import RoutingSidecar

    sc = RoutingSidecar(decode_addr=decode_addr, host="127.0.0.1", port=0)
    loops._call(sc.start())
    return sc


def latency_f32_check(device, card: str, preds: _Predictors, model: str = "llama-1b",
                      seed: int = 0, warm_n: int = 72, after_n: int = 8,
                      prompt_len: int = 256, max_tokens: int = 8, pd_n: int = 4,
                      round_trips: int = 200) -> dict:
    """Two float32 engines (KV events, a transfer side channel, latency rows
    posted to the port's trainer) behind three port routers in turn:

    1. the latency plane: ``warm_n`` requests fit both regressors, the
       trainer refits, the prediction server reloads; then the producer's
       fallbacks stop growing over ``after_n`` more requests, whose routed
       tokens equal a direct request's to the engine named; a sheddable
       request whose SLO no endpoint can meet is refused (503, the
       reference's message) while the same SLO unshed is served; the SLO
       gauges and the calibration families carry samples;
    2. P/D through the port's ``RoutingSidecar`` (engine 0 prefill, engine 1
       decode behind the sidecar) and the router's P/D profile with the
       producer: every decision is predicted (``predicted_ttft`` or
       ``hop_not_worth_it``, never ``no_predictor``); the sidecar's P/D legs
       and its fallback past a dead prefiller give aggregated serving's
       tokens;
    3. the precise plane (``LLMD_KV_PLANE=precise``, the index in the
       external RESP store): a prompt cached on engine 0 and routed to
       engine 1 is stamped with a pull of engine 0's blocks; engine 1
       injects them and answers engine 0's tokens.

    K1's launches are counted over the three (its plain version never)."""
    from concurrent.futures import ThreadPoolExecutor

    from llmd_tpu_torch.core.kv_events import block_keys_for_tokens
    from llmd_tpu_torch.kv.subscriber import LABEL_KV_EVENTS_ADDR
    from llmd_tpu_torch.kvplane import LABEL_KV_TRANSFER_ADDR
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.predictor import LatencyModel

    cfg = dataclasses.replace(get_model_config(model), dtype="float32")
    rng = np.random.default_rng(seed)
    row: dict = {"card": card, "model": model, "dtype": "float32"}
    with _env({"LLMD_KV_PLANE": "precise"}):  # engines serve peers' prefix pulls
        servers = _router_engines(device, cfg, seed=seed, kv_transfer_port=0,
                                  predictor_train_url=preds.train_url)
    routers, sidecars = [], []
    try:
        zero_counts()
        # 1. the latency plane
        with _env({"LLMD_KV_PLANE": None} | LATENCY_SLO_ENV):
            lat = _RouterThread(servers, cfg_text=_latency_cfg(preds.predict_url,
                                                               preds.train_url),
                                objectives={"sheddable": -1})
        routers.append(lat)
        producer = lat.router.scheduler.plugins["latency"]
        prompts = [_router_text(rng, prompt_len) for _ in range(warm_n)]
        with ThreadPoolExecutor(4) as pool:
            for reply in pool.map(lambda p: _routed(lat.url, p, max_tokens), prompts):
                _text(reply)
        t_end, fitted = time.monotonic() + 30, False
        while not fitted:  # the engines post their rows once a second
            time.sleep(0.5)
            fitted = (preds._call(preds.trainer.retrain_now())
                      and preds.trainer.model.tpot is not None
                      and preds.trainer.model.ttft is not None)
            if not fitted and time.monotonic() > t_end:
                raise AssertionError(f"latency: the trainer did not fit both regressors "
                                     f"({len(preds.trainer.window)} rows in its window)")
        row["trainer"] = {"window": len(preds.trainer.window),
                          "samples": preds.trainer.samples_total,
                          "mape": dict(preds.trainer.model.mape),
                          "min_samples": LatencyModel.MIN_SAMPLES}
        fallbacks = producer.stats["fallbacks_total"]
        after = [_router_text(rng, prompt_len) for _ in range(after_n)]
        routed = [_routed(lat.url, p, max_tokens) for p in after]
        direct = [_routed(f"http://{h['x-llm-d-endpoint']}", p, max_tokens)
                  for (_, h, _), p in zip(routed, after)]
        row["fallbacks_before_fit"] = fallbacks
        row["fallbacks_after_fit"] = producer.stats["fallbacks_total"] - fallbacks
        row["tokens_identical"] = [_text(a) for a in routed] == [_text(b) for b in direct]
        shed = _routed(lat.url, after[0], max_tokens,
                       headers={HDR_OBJECTIVE: "sheddable", HDR_SLO_TTFT: "0.001"})
        kept = _routed(lat.url, after[0], max_tokens, headers={HDR_SLO_TTFT: "0.001"})
        row["shed"] = [shed[0], shed[2].get("error", {}).get("message"), kept[0]]
        lines = _metric_lines(lat.url)
        row["slo_series"] = sum(ln.startswith(("llm_d_epp_slo_attainment{",
                                               "llm_d_epp_slo_burn_rate{")) for ln in lines)
        row["calibration_series"] = sum(ln.startswith("llmd_tpu:predictor_calibration")
                                        and not ln.endswith(" 0") for ln in lines)
        row["producer"] = dict(producer.stats)
        times = _predict_round_trips(preds.predict_url, round_trips)
        row["predict_rt_p50_ms"] = statistics.median(times) * 1e3
        row["predict_rt_p99_ms"] = float(np.percentile(times, 99)) * 1e3
        # 2. P/D through the port's sidecar
        P, D = servers
        sc = _sidecar(preds, D.address)
        sidecars.append(sc)
        with _env({"LLMD_KV_PLANE": None}):
            pd = _RouterThread(None, cfg_text=_pd_router_cfg(preds.predict_url),
                               endpoints=[(P.address, "prefill", {}),
                                          (sc.address, "decode", {})])
        routers.append(pd)
        pd_prompts = [_router_text(rng, prompt_len) for _ in range(2 * pd_n + 1)]
        via_router = [_text(_routed(pd.url, p, max_tokens)) for p in pd_prompts[:pd_n]]
        via_sidecar = [_text(_routed(f"http://{sc.address}", p, max_tokens,
                                     headers={HDR_PREFILLER: P.address}))
                       for p in pd_prompts[pd_n:2 * pd_n]]
        fallback = _text(_routed(f"http://{sc.address}", pd_prompts[-1], max_tokens,
                                 headers={HDR_PREFILLER: "127.0.0.1:9"}))
        aggregated = [_text(_routed(f"http://{D.address}", p, max_tokens)) for p in pd_prompts]
        row["pd_reasons"] = _pd_reasons(pd.router)
        row["sidecar"] = dict(sc.stats)
        row["pd_injected_blocks"] = D.transfer_stats["injected_blocks"]
        row["pd_tokens_identical"] = via_router + via_sidecar + [fallback] == aggregated
        # 3. the precise plane over the external index
        with _env({"LLMD_KV_PLANE": "precise"}):
            plane = _RouterThread(None, cfg_text=_plane_cfg(preds.store.port), endpoints=[
                (s.address, "both", {LABEL_KV_EVENTS_ADDR: f"127.0.0.1:{s.kv_events_port}",
                                     LABEL_KV_TRANSFER_ADDR: f"127.0.0.1:{s.kv_transfer_port}",
                                     "zone": zone})
                for s, zone in zip(servers, "ab")])
        routers.append(plane)
        cached = _router_text(rng, prompt_len)
        on_a = _text(_routed(f"http://{P.address}", cached, max_tokens))
        keys = block_keys_for_tokens(IdTokenizer(cfg.vocab_size).encode(cached), PS)
        t_end = time.monotonic() + 30
        while plane.router.kv_index.lookup(keys, [P.address])[P.address].blocks < len(keys):
            if time.monotonic() > t_end:
                raise AssertionError("latency: engine 0's KV events did not reach the "
                                     "external index in 30 s")
            time.sleep(0.05)
        pulls0 = dict(D.transfer_stats)
        status, h, body = _routed(plane.url, cached, max_tokens)
        row["plane"] = {"status": status, "endpoint": h.get("x-llm-d-endpoint"),
                        "tokens_identical": status == 200 and _text((status, h, body)) == on_a,
                        "cached_tokens": body.get("usage", {}).get("cached_tokens", 0),
                        "prefix_pull_blocks": D.transfer_stats["prefix_pull_blocks"]
                        - pulls0["prefix_pull_blocks"],
                        "stats": dict(plane.router.kvplane.stats),
                        "index_keys": len(plane.router.kv_index), "blocks": len(keys)}
        if device.type == "cuda":
            torch.cuda.synchronize()
        row["launches"], row["plain_calls"] = read_counts()
        row["launches_by_instance"] = instance_counts()
    finally:
        for rt in routers:
            rt.stop()
        for sc in sidecars:
            preds._call(sc.stop())
        for s in servers:
            s.stop()
    pl = row["plane"]
    log(f"latency: f32 {model} on {card}: {warm_n} requests to fit ({row['trainer']}); "
        f"fallbacks {row['fallbacks_before_fit']} before the fit, "
        f"{row['fallbacks_after_fit']} after over {after_n} requests; "
        f"tokens_identical={row['tokens_identical']}; shed {row['shed']}; SLO series "
        f"{row['slo_series']}, calibration series {row['calibration_series']}")
    log(f"latency: P/D reasons {sorted(set(row['pd_reasons']))} ({len(row['pd_reasons'])}); "
        f"sidecar {row['sidecar']}; injected {row['pd_injected_blocks']} blocks; "
        f"tokens = aggregated: {row['pd_tokens_identical']}")
    log(f"latency: precise plane over the external index: routed to {pl['endpoint']} "
        f"(status {pl['status']}), pulled {pl['prefix_pull_blocks']} of {pl['blocks']} "
        f"blocks, cached {pl['cached_tokens']}, tokens_identical={pl['tokens_identical']}, "
        f"plane {pl['stats']}; K1 by instance {row['launches_by_instance']['paged_attention']}")
    log(f"latency: producer predict round trip on {card} (2 candidates, {round_trips} "
        f"calls): p50 {row['predict_rt_p50_ms']:.3f} ms, p99 {row['predict_rt_p99_ms']:.3f} ms")
    if row["fallbacks_before_fit"] == 0 or row["fallbacks_after_fit"] != 0:
        raise AssertionError(f"latency: fallbacks {row['fallbacks_before_fit']} before the "
                             f"fit, {row['fallbacks_after_fit']} after")
    if not row["tokens_identical"] or not row["pd_tokens_identical"]:
        raise AssertionError("latency: routed tokens differ from direct / aggregated ones")
    if row["shed"] != [503, "no endpoint: no endpoint within SLO for sheddable request", 200]:
        raise AssertionError(f"latency: the sheddable request was not shed as the "
                             f"reference sheds it: {row['shed']}")
    if row["slo_series"] == 0 or row["calibration_series"] == 0:
        raise AssertionError(f"latency: SLO series {row['slo_series']}, calibration series "
                             f"{row['calibration_series']}")
    reasons = set(row["pd_reasons"])
    if len(row["pd_reasons"]) != pd_n or not reasons <= {"predicted_ttft", "hop_not_worth_it"}:
        raise AssertionError(f"latency: P/D decisions {row['pd_reasons']}")
    sc = row["sidecar"]
    if sc["pd_requests"] < pd_n or sc["prefill_fallbacks"] != 1 or row["pd_injected_blocks"] == 0:
        raise AssertionError(f"latency: sidecar {sc}, injected {row['pd_injected_blocks']}")
    if not (pl["status"] == 200 and pl["endpoint"] == servers[1].address
            and pl["tokens_identical"] and pl["stats"]["pulls_planned"] == 1
            and pl["prefix_pull_blocks"] == len(keys)
            and pl["cached_tokens"] == min(len(keys), (prompt_len - 1) // PS) * PS):
        raise AssertionError(f"latency: the precise plane's pull {pl}")
    if device.type == "cuda" and not (row["launches"]["paged_attention"] > 0
                                      and not any(row["plain_calls"].values())):
        raise AssertionError(f"latency: K1 launches {row['launches']}, plain calls "
                             f"{row['plain_calls']}")
    return row


def _hand_pd_ttft(P, D, prompt: str) -> float:
    """The sidecar's two legs driven here: P with ``do_remote_decode`` and
    ``max_tokens`` 1, then D streamed with ``do_remote_prefill`` and P's
    handle; seconds from the first byte sent to D's first event."""
    t0 = time.perf_counter()
    _, _, body = _routed(f"http://{P.address}", prompt, 1,
                         kv_transfer_params={"do_remote_decode": True})
    ktp = {"do_remote_prefill": True, **body["kv_transfer_params"]}
    return _stream_ttft(f"http://{D.address}", prompt, extra={"kv_transfer_params": ktp},
                        t0=t0)


def latency_bf16_times(device, card: str, preds: _Predictors, model: str = "llama-1b",
                       seed: int = 1, hop_n: int = 32, ttft_n: int = 8,
                       isl: int = 512) -> dict:
    """bf16 engines, times printed (not bounded): the hop (p50 of ``hop_n``
    serial one-token requests routed minus direct to the engine named) of a
    router with the four latency plugins and of one with the README's config
    alone, in turns; streamed TTFT p50 of ``ttft_n`` fresh ``isl``-token
    prompts through the port's sidecar (engine 0 prefill, engine 1 decode)
    and through the same two legs driven here, in turns."""
    from llmd_tpu_torch.models import get_model_config

    cfg = dataclasses.replace(get_model_config(model), dtype="bfloat16")
    rng = np.random.default_rng(seed)
    servers = _router_engines(device, cfg, seed=seed, kv_transfer_port=0)
    routers, sc = [], None
    try:
        with _env({"LLMD_KV_PLANE": None} | LATENCY_SLO_ENV):
            routers.append(_RouterThread(servers, cfg_text=_latency_cfg(preds.predict_url,
                                                                        preds.train_url)))
        with _env({"LLMD_KV_PLANE": None}):
            routers.append(_RouterThread(servers))
        prompt = _router_text(rng, 32)
        targets = []
        for rt in routers:  # warm: the prompt's pages cached where each routes
            _, h, _ = _routed(rt.url, prompt, 1)
            targets.append(f"http://{h['x-llm-d-endpoint']}")
        times = {k: [] for k in ("latency", "latency_direct", "plain", "plain_direct")}
        for _ in range(hop_n):
            for url, key in ((routers[0].url, "latency"), (targets[0], "latency_direct"),
                             (routers[1].url, "plain"), (targets[1], "plain_direct")):
                t0 = time.perf_counter()
                status, _, _ = _routed(url, prompt, 1)
                times[key].append(time.perf_counter() - t0)
                if status != 200:
                    raise AssertionError(f"latency: a one-token request answered {status}")
        P, D = servers
        sc = _sidecar(preds, D.address)
        sidecar_ttft, hand_ttft = [], []
        for _ in range(ttft_n):
            sidecar_ttft.append(_stream_ttft(f"http://{sc.address}", _router_text(rng, isl),
                                             headers={HDR_PREFILLER: P.address}))
            hand_ttft.append(_hand_pd_ttft(P, D, _router_text(rng, isl)))
        stats = dict(sc.stats)
    finally:
        for rt in routers:
            rt.stop()
        if sc is not None:
            preds._call(sc.stop())
        for s in servers:
            s.stop()
    p50 = statistics.median
    row = {"card": card, "model": model, "dtype": "bfloat16", "hop_n": hop_n,
           **{f"{k}_p50_ms": p50(v) * 1e3 for k, v in times.items()},
           "hop_latency_plugins_p50_ms": (p50(times["latency"])
                                          - p50(times["latency_direct"])) * 1e3,
           "hop_plain_p50_ms": (p50(times["plain"]) - p50(times["plain_direct"])) * 1e3,
           "ttft_n": ttft_n, "ttft_isl": isl,
           "ttft_sidecar_p50_ms": p50(sidecar_ttft) * 1e3,
           "ttft_hand_legs_p50_ms": p50(hand_ttft) * 1e3, "sidecar": stats}
    log(f"latency: bf16 {model} on {card}: one-token hop p50 with the latency plugins "
        f"{row['hop_latency_plugins_p50_ms']:.3f} ms, without them "
        f"{row['hop_plain_p50_ms']:.3f} ms ({hop_n} each, in turns)")
    log(f"latency: bf16 P/D TTFT p50 on {card} ({isl}-token prompts, {ttft_n} each): "
        f"through the port's sidecar {row['ttft_sidecar_p50_ms']:.3f} ms, the same legs "
        f"driven here {row['ttft_hand_legs_p50_ms']:.3f} ms")
    if stats["pd_requests"] != ttft_n or stats["prefill_fallbacks"] != 0:
        raise AssertionError(f"latency: sidecar {stats}")
    return row


def phase_latency(device, card: str, model: str = "llama-1b", f32_kw=None,
                  bf16_kw=None, fit_seed: int = 2) -> dict:
    """The latency phase: the port's latency plane, P/D through its routing
    sidecar and the precise KV plane over the external index, in front of
    port engines; correctness in float32, times in bf16; one fit of a full
    predictor window timed."""
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="llmd-latency-")
    preds = _Predictors(workdir)
    try:
        out = {"f32": latency_f32_check(device, card, preds, model=model, **(f32_kw or {}))}
        _empty()
        out["bf16"] = latency_bf16_times(device, card, preds, model=model, **(bf16_kw or {}))
    finally:
        preds.stop()
        shutil.rmtree(workdir, ignore_errors=True)
    out["fit"] = fit = _fit_window(fit_seed)
    log(f"latency: one predictor fit over a full window ({fit['window_rows']} rows, "
        f"{fit['fit_rows']} fit, both regressors) {fit['seconds']:.3f} s on the host of "
        f"{card}")
    out["seconds"] = time.perf_counter() - t0
    log(f"latency: phase {out['seconds']:.1f} s on {card}")
    return out


# --------------------------------------------------------------------------
# The gateway fronts: the pod watch, the ext_proc EPP, the vLLM gRPC front
# --------------------------------------------------------------------------

GATEWAY_CFG = """
plugins:
  - {name: inflight, type: inflight-load-producer}
  - {name: queue, type: queue-depth-scorer}
  - {name: kv-util, type: kv-cache-utilization-scorer}
schedulingProfiles:
  - {name: default, plugins: [{pluginRef: queue, weight: 2}, {pluginRef: kv-util, weight: 1}]}
"""
# the pool as a cluster declares it: the watch takes its selector and port
GATEWAY_MANIFEST = """
apiVersion: inference.networking.k8s.io/v1
kind: InferencePool
metadata: {{name: llama-1b-pool, namespace: serving}}
spec:
  selector: {{matchLabels: {{app: llmd-gateway-smoke}}}}
  targetPorts: [{{number: {port}}}]
  endpointPickerRef: {{name: epp, port: 9002, failureMode: FailClose}}
"""
# two pods on loopback: both engines listen on one port, each on its own IP
GATEWAY_PODS = {"pod-a": "127.0.0.1", "pod-b": "127.0.0.2"}


def _gateway_pod(name: str, ip: str) -> dict:
    return {"metadata": {"name": name, "uid": f"uid-{name}",
                         "labels": {"app": "llmd-gateway-smoke", "llm-d.ai/role": "both"}},
            "status": {"phase": "Running", "podIP": ip,
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def _shared_free_port(hosts) -> int:
    """A port free on every one of ``hosts``."""
    import socket

    for _ in range(50):
        socks = []
        try:
            first = socket.socket()
            first.bind((hosts[0], 0))
            socks.append(first)
            port = first.getsockname()[1]
            for h in hosts[1:]:
                s = socket.socket()
                socks.append(s)
                s.bind((h, port))
            return port
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError(f"gateway: no port free on all of {hosts}")


class _FakePodsAPI:
    """The pods list + watch of a Kubernetes API server, on the port's
    ``HTTPServer`` (standard library): a list answers the pods held, a watch
    streams the events ``event`` sends, one JSON line each."""

    def __init__(self) -> None:
        self.pods: dict = {}
        self.watchers: list = []
        self.lists = 0

    async def start(self) -> None:
        from llmd_tpu_torch.router.http import HTTPServer

        self.server = HTTPServer()
        self.server.add_route("GET", "/api/v1/namespaces/{ns}/pods", self._pods)
        self.port = await self.server.start("127.0.0.1", 0)

    async def _pods(self, request):
        import asyncio

        from llmd_tpu_torch.router.http import StreamResponse, json_response

        if request.query.get("labelSelector") != "app=llmd-gateway-smoke":
            return json_response({"items": []}, status=400)
        if request.query.get("watch"):
            resp = StreamResponse(headers={"content-type": "application/json"})
            await resp.prepare(request)
            q: asyncio.Queue = asyncio.Queue()
            self.watchers.append(q)
            try:
                while (ev := await q.get()) is not None:
                    await resp.write(json.dumps(ev).encode() + b"\n")
            finally:
                self.watchers.remove(q)
            return resp
        self.lists += 1
        return json_response({"items": list(self.pods.values()),
                              "metadata": {"resourceVersion": str(self.lists)}})

    def event(self, etype: str, pod: dict) -> None:
        if etype == "DELETED":
            self.pods.pop(pod["metadata"]["uid"], None)
        else:
            self.pods[pod["metadata"]["uid"]] = pod
        for q in self.watchers:
            q.put_nowait({"type": etype, "object": pod})

    async def stop(self) -> None:
        for q in list(self.watchers):
            q.put_nowait(None)
        await self.server.stop()


class _GatewayStack(_LoopThread):
    """Two port engines (pods), the fake API server, and the port's router
    with its pod watch (the pool from ``GATEWAY_MANIFEST``), ext_proc EPP and
    vLLM gRPC front, on an event loop of their own thread; the Envoy
    stand-in and the gRPC clients run on a second loop (``client``)."""

    def __init__(self, device, cfg, seed: int) -> None:
        from llmd_tpu_torch.core.config import FrameworkConfig
        from llmd_tpu_torch.core.crds import load_manifest_yaml
        from llmd_tpu_torch.core.endpoint import EndpointPool
        from llmd_tpu_torch.engine.config import EngineConfig
        from llmd_tpu_torch.engine.server import EngineServer
        from llmd_tpu_torch.router.plugins import known_plugin_types
        from llmd_tpu_torch.router.server import RouterServer

        port = _shared_free_port(list(GATEWAY_PODS.values()))
        self.engines = {}
        self.client = None
        super().__init__()
        try:
            for name, ip in GATEWAY_PODS.items():
                s = EngineServer(cfg, EngineConfig(**ROUTER_KW), model_name="llama-1b",
                                 host=ip, port=port, tokenizer=IdTokenizer(cfg.vocab_size),
                                 seed=seed, device=device)
                s.start()
                self.engines[name] = s
            self.addresses = {name: f"{ip}:{port}" for name, ip in GATEWAY_PODS.items()}
            manifests = load_manifest_yaml(GATEWAY_MANIFEST.format(port=port))
            self.pool_spec = manifests.pools[0]
            self.router = RouterServer(
                FrameworkConfig.from_yaml(GATEWAY_CFG, known_types=known_plugin_types()),
                EndpointPool(), host="127.0.0.1", port=0, poll_interval_s=0.05, seed=0,
                objectives=manifests.objectives_map(), model_rewrites=manifests.rewrites_map())
            self._call(self._start())
            self.client = _LoopThread()
            self.wait_pool(set(self.addresses.values()))
        except BaseException:
            self.stop()
            raise

    async def _start(self) -> None:
        from llmd_tpu_torch.router.discovery import K8sWatchSource
        from llmd_tpu_torch.router.extproc import ExtProcEPP
        from llmd_tpu_torch.router.vllmgrpc import VllmGrpcFront

        self.api = _FakePodsAPI()
        await self.api.start()
        for name, ip in GATEWAY_PODS.items():
            self.api.pods[f"uid-{name}"] = _gateway_pod(name, ip)
        await self.router.start()
        p = self.pool_spec
        self.watch = K8sWatchSource(self.router.pool, p.selector, p.target_ports,
                                    namespace=p.namespace,
                                    api_base=f"http://127.0.0.1:{self.api.port}",
                                    token="gateway-smoke", rebackoff_s=0.05)
        await self.watch.start()
        self.epp = ExtProcEPP(self.router, host="127.0.0.1", failure_mode=p.failure_mode)
        await self.epp.start()
        self.front = VllmGrpcFront(self.router, host="127.0.0.1")
        await self.front.start()

    def wait_pool(self, want: set, timeout_s: float = 30.0) -> None:
        """Until the router's pool holds exactly ``want``, each polled."""
        pool = self.router.pool
        _wait_until(lambda: {e.address for e in pool.list()} == want and all(
            e.attrs.get("kv_cache_utilization") is not None for e in pool.list()),
            f"the pool {sorted(want)}", timeout_s)

    def pod_event(self, etype: str, name: str) -> None:
        pod = _gateway_pod(name, GATEWAY_PODS[name])
        self.loop.call_soon_threadsafe(self.api.event, etype, pod)

    def metric(self, name: str) -> "float | None":
        _, _, text = _http("GET", f"http://{self.router.address}/metrics")
        return _metric(text.decode(), name)

    def stop(self) -> None:
        async def down():
            for part in ("front", "epp", "watch", "router", "api"):
                if hasattr(self, part):
                    await getattr(self, part).stop()

        try:
            if self.client is not None:
                self.client.close()
            self._call(down())
        finally:
            self.close()
            for s in self.engines.values():
                s.stop()


async def _envoy_stream(ch, rid: str, body: dict, forward: bool) -> dict:
    """One request as an Envoy's ext_proc filter runs it: the request's
    headers and body phases, the pick read off the header mutation, then (when
    ``forward``) the request sent to the picked engine and its response's
    headers and body fed back; the stream closed. Times in seconds: the
    headers-to-pick stream time and the body phase's round trip (the pick)."""
    import asyncio

    from llmd_tpu_torch.router import ext_proc_pb as pb
    from llmd_tpu_torch.router.extproc import ENVOY_SERVICE, HDR_DESTINATION

    call = ch.stream_stream(f"/{ENVOY_SERVICE}/Process",
                            request_serializer=pb.ProcessingRequest.SerializeToString,
                            response_deserializer=pb.ProcessingResponse.FromString)(timeout=600)
    raw = json.dumps(body).encode()
    t0 = time.perf_counter()
    await call.write(pb.ProcessingRequest(request_headers=pb.HttpHeaders(headers=pb.HeaderMap(
        headers=[pb.HeaderValue(key=k, raw_value=v.encode()) for k, v in (
            (":path", "/v1/completions"), (":method", "POST"), ("x-request-id", rid),
            ("content-type", "application/json"))]))))
    if (await call.read()).WhichOneof("response") != "request_headers":
        raise AssertionError("gateway: the EPP did not continue the headers phase")
    t1 = time.perf_counter()
    await call.write(pb.ProcessingRequest(request_body=pb.HttpBody(body=raw, end_of_stream=True)))
    picked = await call.read()
    t2 = time.perf_counter()
    if picked.WhichOneof("response") != "request_body":
        raise AssertionError(f"gateway: the EPP answered the body phase with {picked}")
    common = picked.request_body.response
    hdrs = {o.header.key: o.header.raw_value.decode() for o in common.header_mutation.set_headers}
    out = {"dest": hdrs[HDR_DESTINATION], "stream_s": t2 - t0, "pick_s": t2 - t1}
    if forward:
        sent = json.loads(common.body_mutation.body) if common.HasField("body_mutation") else body
        status, headers, reply = await asyncio.get_running_loop().run_in_executor(
            None, _http, "POST", f"http://{out['dest']}/v1/completions", sent,
            {"x-request-id": rid})
        await call.write(pb.ProcessingRequest(response_headers=pb.HttpHeaders(
            headers=pb.HeaderMap(headers=[
                pb.HeaderValue(key=":status", raw_value=str(status).encode()),
                pb.HeaderValue(key="content-type", raw_value=headers.get(
                    "Content-Type", "application/json").encode())]))))
        await call.read()
        await call.write(pb.ProcessingRequest(response_body=pb.HttpBody(
            body=reply, end_of_stream=True)))
        await call.read()
        out.update(status=status, reply=json.loads(reply))
    await call.done_writing()
    if await call.read() is not None or call.code() != 0:
        raise AssertionError(f"gateway: the ext_proc stream ended {call.code()} "
                             f"{call.details()}")
    return out


async def _vllm_generate(ch, prompt: str, max_tokens: int, stream: bool, rid: str) -> dict:
    """Generate through the vLLM gRPC front: the joined text, the endpoint,
    the seconds to the first message and the messages."""
    from llmd_tpu_torch.router import vllm_grpc_pb as vpb
    from llmd_tpu_torch.router.vllmgrpc import SERVICE

    call = ch.unary_stream(f"/{SERVICE}/Generate",
                           request_serializer=vpb.GenerateRequest.SerializeToString,
                           response_deserializer=vpb.GenerateResponse.FromString)
    t0 = time.perf_counter()
    msgs, first = [], None
    async for m in call(vpb.GenerateRequest(
            request_id=rid, model="llama-1b", prompt=prompt, stream=stream,
            sampling_params=vpb.SamplingParams(max_tokens=max_tokens, ignore_eos=True)),
            timeout=600):
        if first is None:
            first = time.perf_counter() - t0
        msgs.append(m)
    return {"text": "".join(m.outputs[0].text for m in msgs), "endpoint": msgs[-1].endpoint,
            "ttft_s": first, "messages": len(msgs),
            "completion_tokens": msgs[-1].usage.completion_tokens}


def gateway_f32_check(device, card: str, model: str = "llama-1b", seed: int = 0,
                      n_requests: int = 8, prompt_len: int = 256, max_tokens: int = 16,
                      n_vllm: int = 2) -> dict:
    """float32 engines found through the pod watch; an Envoy stand-in on the
    port's gRPC client: every routed request's tokens equal a direct request
    to the engine the EPP named, ``/metrics`` counts every pick; a pod
    DELETED leaves the other alone in the pool (the picks follow) and
    re-ADDED brings it back; vLLM gRPC Generate, unary and streamed, gives the
    direct tokens; the health Check answers SERVING; K1 launched behind the
    fronts."""
    from llmd_tpu_torch.router.extproc import HEALTH_SERVICE
    from llmd_tpu_torch.router.grpc_wire import Channel
    from llmd_tpu_torch.models import get_model_config

    cfg = dataclasses.replace(get_model_config(model), dtype="float32")
    rng = np.random.default_rng(seed)
    prompts = [_router_text(rng, prompt_len) for _ in range(n_requests)]
    stack = _GatewayStack(device, cfg, seed)
    try:
        epp_ch, vllm_ch = Channel(stack.epp.address), Channel(stack.front.address)
        run = stack.client._call
        lists_before = stack.api.lists
        zero_counts()
        routed = [run(_envoy_stream(epp_ch, f"gw-{i}", {
            "model": "llama-1b", "prompt": p, "max_tokens": max_tokens, "temperature": 0,
            "ignore_eos": True}, forward=True), timeout=600) for i, p in enumerate(prompts)]
        generated = [run(_vllm_generate(vllm_ch, p, max_tokens, stream, f"gv-{i}-{stream}"),
                         timeout=600)
                     for i, p in enumerate(prompts[:n_vllm]) for stream in (False, True)]
        if device.type == "cuda":
            torch.cuda.synchronize()
        by_instance = instance_counts()
        launches, _ = read_counts()
        picks = stack.metric("llm_d_epp_extproc_picks_total")
        direct = [_complete(f"http://{r['dest']}", p, max_tokens)
                  for r, p in zip(routed, prompts)]
        direct_vllm = [_complete(f"http://{g['endpoint']}", p, max_tokens)
                       for g, p in zip(generated[::2], prompts[:n_vllm])]
        # the pool moves with the pods
        stack.pod_event("DELETED", "pod-b")
        stack.wait_pool({stack.addresses["pod-a"]})
        alone = [run(_envoy_stream(epp_ch, f"gw-alone-{i}", {"model": "llama-1b",
                                                               "prompt": "a", "max_tokens": 1},
                                   forward=False))["dest"] for i in range(2)]
        stack.pod_event("ADDED", "pod-b")
        stack.wait_pool(set(stack.addresses.values()))
        health = run(epp_ch.unary_unary(f"/{HEALTH_SERVICE}/Check")(b"", timeout=30))
        relists = stack.watch.relists
        run(epp_ch.close())
        run(vllm_ch.close())
    finally:
        stack.stop()
    statuses = [r["status"] for r in routed]
    texts = [r["reply"]["choices"][0]["text"] for r in routed]
    same = [t == b["choices"][0]["text"] for t, (_, _, b) in zip(texts, direct)]
    vllm_same = [g["text"] == b["choices"][0]["text"]
                 for g, (_, _, b) in zip(generated, [d for d in direct_vllm for _ in (0, 1)])]
    dests = [r["dest"] for r in routed]
    row = {"card": card, "model": model, "dtype": "float32", "requests": n_requests,
           "prompt_tokens": prompt_len, "max_tokens": max_tokens, "statuses": statuses,
           "picks": dests, "engines_used": len(set(dests)), "tokens_identical": all(same),
           "vllmgrpc_tokens_identical": all(vllm_same),
           "vllmgrpc_messages": [g["messages"] for g in generated],
           "metrics_picks": picks, "picks_after_delete": alone, "health": health.hex(),
           "watch_lists": relists, "lists_before": lists_before, "launches": launches,
           "launches_by_instance": by_instance}
    log(f"gateway: f32 {model} on {card}: {n_requests} requests through the ext_proc EPP "
        f"(pods found by the watch, {prompt_len}+{max_tokens} tokens): statuses "
        f"{sorted(set(statuses))}, engines used {row['engines_used']}, "
        f"tokens_identical={all(same)}, /metrics picks {picks}; pod-b DELETED: picks "
        f"{alone}; re-ADDED; vllmgrpc Generate unary+streamed x{n_vllm} "
        f"tokens_identical={all(vllm_same)}; health {health.hex()}; K1 by instance="
        f"{by_instance['paged_attention']}")
    if set(statuses) != {200}:
        raise AssertionError(f"gateway: statuses {statuses}")
    if not all(same) or not all(vllm_same):
        raise AssertionError(f"gateway: tokens differ from direct (ext_proc {same}, "
                             f"vllmgrpc {vllm_same})")
    if picks != n_requests:
        raise AssertionError(f"gateway: /metrics counts {picks} picks, expected {n_requests}")
    if set(alone) != {stack.addresses["pod-a"]}:
        raise AssertionError(f"gateway: with pod-b deleted the EPP picked {alone}")
    if health != b"\x08\x01":
        raise AssertionError(f"gateway: health Check answered {health!r}")
    if device.type == "cuda" and not launches["paged_attention"] > 0:
        raise AssertionError(f"gateway: K1 did not launch behind the fronts ({by_instance})")
    return row


def gateway_bf16_times(device, card: str, model: str = "llama-1b", seed: int = 1,
                       picks_n: int = 256, hop_n: int = 32, ttft_n: int = 16,
                       isl: int = 512) -> dict:
    """bf16 engines behind the fronts, times printed (not bounded): the
    ext_proc pick round trip (the body phase's round trip, and the stream from
    its headers to the pick) over ``picks_n`` streams, p50 / p99, beside the
    HTTP front's hop (p50 of ``hop_n`` one-token requests, routed minus direct);
    vLLM gRPC streamed TTFT p50 of fresh ``isl``-token prompts beside a direct
    streamed request's."""
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.router.grpc_wire import Channel

    cfg = dataclasses.replace(get_model_config(model), dtype="bfloat16")
    rng = np.random.default_rng(seed)
    stack = _GatewayStack(device, cfg, seed)
    try:
        epp_ch, vllm_ch = Channel(stack.epp.address), Channel(stack.front.address)
        run = stack.client._call
        body = {"model": "llama-1b", "prompt": _router_text(rng, 32), "max_tokens": 1}
        for i in range(8):  # warm: the connection, the pick path
            run(_envoy_stream(epp_ch, f"warm-{i}", body, forward=False))
        picks = [run(_envoy_stream(epp_ch, f"pick-{i}", body, forward=False))
                 for i in range(picks_n)]
        url = f"http://{stack.router.address}"
        prompt = _router_text(rng, 32)
        _, h, _ = _complete(url, prompt, 1)
        target = f"http://{h['x-llm-d-endpoint']}"
        routed, direct = [], []
        for _ in range(hop_n):
            for u, out in ((url, routed), (target, direct)):
                t0 = time.perf_counter()
                status, _, _ = _complete(u, prompt, 1)
                out.append(time.perf_counter() - t0)
                if status != 200:
                    raise AssertionError(f"gateway: a one-token request answered {status}")
        ttft_grpc, ttft_direct = [], []
        for i in range(ttft_n):
            g = run(_vllm_generate(vllm_ch, _router_text(rng, isl), 8, True, f"ttft-{i}"))
            ttft_grpc.append(g["ttft_s"])
            ttft_direct.append(_stream_ttft(f"http://{g['endpoint']}", _router_text(rng, isl)))
        run(epp_ch.close())
        run(vllm_ch.close())
    finally:
        stack.stop()
    p50 = statistics.median

    def p99(xs):
        return float(np.percentile(xs, 99))

    pick_ms = [p["pick_s"] * 1e3 for p in picks]
    stream_ms = [p["stream_s"] * 1e3 for p in picks]
    row = {"card": card, "model": model, "dtype": "bfloat16", "picks_n": picks_n,
           "pick_p50_ms": p50(pick_ms), "pick_p99_ms": p99(pick_ms),
           "pick_stream_p50_ms": p50(stream_ms), "pick_stream_p99_ms": p99(stream_ms),
           "hop_n": hop_n, "http_hop_p50_ms": (p50(routed) - p50(direct)) * 1e3,
           "http_routed_p50_ms": p50(routed) * 1e3, "http_direct_p50_ms": p50(direct) * 1e3,
           "ttft_n": ttft_n, "ttft_isl": isl,
           "vllmgrpc_ttft_p50_ms": p50(ttft_grpc) * 1e3,
           "direct_ttft_p50_ms": p50(ttft_direct) * 1e3}
    log(f"gateway: bf16 {model} on {card}: ext_proc pick round trip (body phase) p50 "
        f"{row['pick_p50_ms']:.3f} ms, p99 {row['pick_p99_ms']:.3f} ms; headers-to-pick "
        f"p50 {row['pick_stream_p50_ms']:.3f} ms, p99 {row['pick_stream_p99_ms']:.3f} ms "
        f"({picks_n} streams); HTTP front hop p50 {row['http_hop_p50_ms']:.3f} ms "
        f"(routed {row['http_routed_p50_ms']:.3f}, direct {row['http_direct_p50_ms']:.3f}; "
        f"{hop_n} each); vllmgrpc streamed TTFT p50 {row['vllmgrpc_ttft_p50_ms']:.3f} ms, "
        f"direct {row['direct_ttft_p50_ms']:.3f} ms ({isl}-token prompts, {ttft_n} each)")
    return row


def phase_gateway(device, card: str, model: str = "llama-1b", f32_kw=None,
                  bf16_kw=None) -> dict:
    """The gateway phase: the port's router found its engines through the
    Kubernetes pod watch and serves behind the ext_proc EPP and the vLLM gRPC
    front, on the port's own gRPC wire; correctness in float32, times in
    bf16."""
    t0 = time.perf_counter()
    out = {"f32": gateway_f32_check(device, card, model=model, **(f32_kw or {}))}
    _empty()
    out["bf16"] = gateway_bf16_times(device, card, model=model, **(bf16_kw or {}))
    out["seconds"] = time.perf_counter() - t0
    log(f"gateway: phase {out['seconds']:.1f} s on {card}")
    return out


# --------------------------------------------------------------------------
# The batch plane and the load harness
# --------------------------------------------------------------------------

BATCH_GATES = ("chaos_check", "kv_plane_check", "decision_check")


def _batch_lines(rng, n: int, prompt_len: int, max_tokens: int, tag: str,
                 chats: int = 0, refused: int = 0) -> list:
    """``n`` OpenAI Batch input lines: completions, then ``chats`` chat
    completions, the last ``refused`` of them with a ``response_format`` the
    server's structured-output check refuses (400)."""
    out = []
    for i in range(n):
        body = {"model": "llama-1b", "max_tokens": max_tokens, "temperature": 0,
                "ignore_eos": True}
        url = "/v1/completions"
        if i >= n - chats:
            url = "/v1/chat/completions"
            body["messages"] = [{"role": "user", "content": _router_text(rng, prompt_len)}]
        else:
            body["prompt"] = _router_text(rng, prompt_len)
        if i >= n - refused:
            body["response_format"] = {"type": "xml"}
        out.append({"custom_id": f"{tag}-{i}", "method": "POST", "url": url, "body": body})
    return out


def _multipart_upload(url: str, lines: list, filename: str) -> dict:
    """``POST /v1/files`` as multipart/form-data (the JSONL as the file part,
    a purpose part), as an OpenAI client uploads."""
    boundary = "llmd-chip-smoke-batch"
    data = "\n".join(json.dumps(line) for line in lines).encode()
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"purpose\"\r\n\r\n"
            f"batch\r\n--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: application/jsonl\r\n\r\n").encode() \
        + data + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(url + "/v1/files", data=body, method="POST", headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        meta = json.loads(resp.read())
    if meta.get("bytes") != len(data) or meta.get("filename") != filename:
        raise AssertionError(f"batch: the multipart upload stored {meta}")
    return meta


def _batch_wait(url: str, bid: str, want: tuple, timeout_s: float = 300.0) -> dict:
    """Poll ``GET /v1/batches/{bid}`` until its status is one of ``want``."""
    t_end = time.monotonic() + timeout_s
    while True:
        status, _, body = _http("GET", f"{url}/v1/batches/{bid}")
        row = json.loads(body)
        if status == 200 and row["status"] in want:
            return row
        if time.monotonic() > t_end:
            raise AssertionError(f"batch: {bid} still {row.get('status')} after "
                                 f"{timeout_s} s (want {want})")
        time.sleep(0.01)


def _file_lines(url: str, fid: "str | None") -> list:
    if fid is None:
        return []
    status, _, body = _http("GET", f"{url}/v1/files/{fid}/content")
    if status != 200:
        raise AssertionError(f"batch: file {fid} answered {status}")
    return [json.loads(line) for line in body.decode().splitlines()]


def _start_gateway(loops: "_LoopThread", cfg):
    from llmd_tpu_torch.batch import BatchGateway

    async def start():
        gw = BatchGateway(cfg)  # its queue and semaphores belong to this loop
        await gw.start()
        return gw

    gw = loops._call(start())
    return gw, f"http://{gw.address}"


def batch_f32_check(device, card: str, model: str = "llama-1b", seed: int = 0,
                    n_requests: int = 16, prompt_len: int = 128, max_tokens: int = 16,
                    cancel_n: int = 64, crash_n: int = 16) -> dict:
    """float32 engines behind the router, the port's ``BatchGateway`` in front
    of it: a multipart JSONL of ``n_requests`` (completions and chats, one
    line refused by the server's structured-output check) runs to
    ``completed``; every output line's tokens equal a direct request's and the
    refused line is in the error file with its 400; a second batch cancelled
    mid-run ends ``cancelled``; a third batch left ``in_progress`` by a stopped
    gateway is completed by a new gateway's recovery scan over the same
    SQLite store and files root. K1 launched behind the gateway."""
    from llmd_tpu_torch.batch import BatchGatewayConfig, BatchStore
    from llmd_tpu_torch.models import get_model_config

    cfg = dataclasses.replace(get_model_config(model), dtype="float32")
    rng = np.random.default_rng(seed)
    lines = _batch_lines(rng, n_requests, prompt_len, max_tokens, "main", chats=4, refused=1)
    cancel_lines = _batch_lines(rng, cancel_n, prompt_len, 2 * max_tokens, "cancel")
    crash_lines = _batch_lines(rng, crash_n, prompt_len, max_tokens, "crash")
    servers = _router_engines(device, cfg, seed=seed)
    work = Path(tempfile.mkdtemp(prefix="llmd-batch-"))
    rt = loops = gw = None
    try:
        rt = _RouterThread(servers)
        loops = _LoopThread()  # the gateway's loop, apart from the router's
        gcfg = BatchGatewayConfig(target_url=rt.url, files_root=str(work / "files"),
                                  store_path=str(work / "batches.db"),
                                  global_concurrency=8, per_model_concurrency=8)
        gw, url = _start_gateway(loops, gcfg)
        zero_counts()
        t0 = time.perf_counter()
        meta = _multipart_upload(url, lines, "main.jsonl")
        _, _, created = _http("POST", url + "/v1/batches", {
            "input_file_id": meta["id"], "endpoint": "/v1/completions"})
        bid = json.loads(created)["id"]
        done = _batch_wait(url, bid, ("completed", "failed"))
        batch_s = time.perf_counter() - t0
        if device.type == "cuda":
            torch.cuda.synchronize()
        by_instance = instance_counts()
        launches, _ = read_counts()
        outputs = _file_lines(url, done["output_file_id"])
        errors = _file_lines(url, done["error_file_id"])
        sent = {line["custom_id"]: line for line in lines}
        direct = {}
        for o in outputs:
            line = sent[o["custom_id"]]
            _, _, body = _http("POST", f"http://{servers[0].address}{line['url']}",
                               line["body"])
            direct[o["custom_id"]] = json.loads(body)
        # cancel mid-run
        meta_c = _multipart_upload(url, cancel_lines, "cancel.jsonl")
        _, _, created = _http("POST", url + "/v1/batches", {"input_file_id": meta_c["id"]})
        cid = json.loads(created)["id"]
        _batch_wait(url, cid, ("in_progress",))
        _, _, answer = _http("POST", f"{url}/v1/batches/{cid}/cancel")
        cancel_answer = json.loads(answer)["status"]
        cancelled = _batch_wait(url, cid, ("cancelled", "completed", "failed"))
        # a stopped gateway mid-run, then a new one over the same store
        meta_r = _multipart_upload(url, crash_lines, "crash.jsonl")
        _, _, created = _http("POST", url + "/v1/batches", {"input_file_id": meta_r["id"]})
        rid = json.loads(created)["id"]
        _batch_wait(url, rid, ("in_progress",))
        loops._call(gw.stop())
        gw = None
        left = BatchStore(gcfg.store_path).get(rid).status
        t1 = time.perf_counter()
        gw, url = _start_gateway(loops, gcfg)
        recovered_n = gw.stats["recovered"]
        recovered = _batch_wait(url, rid, ("completed", "failed"))
        recovery_s = time.perf_counter() - t1
        recovered_out = _file_lines(url, recovered["output_file_id"])
    finally:
        if gw is not None:
            loops._call(gw.stop())
        if loops is not None:
            loops.close()
        if rt is not None:
            rt.stop()
        for s in servers:
            s.stop()
        shutil.rmtree(work, ignore_errors=True)

    def text(body: dict) -> str:
        c = body["choices"][0]
        return c["message"]["content"] if "message" in c else c["text"]

    same = [text(o["response"]["body"]) == text(direct[o["custom_id"]]) for o in outputs]
    refused = [(e["custom_id"], (e["response"] or {}).get("status_code")) for e in errors]
    counts = done["request_counts"]
    row = {"card": card, "model": model, "dtype": "float32", "requests": n_requests,
           "prompt_tokens": prompt_len, "max_tokens": max_tokens, "status": done["status"],
           "request_counts": counts, "tokens_identical": all(same), "refused": refused,
           "batch_s": batch_s, "launches": launches, "launches_by_instance": by_instance,
           "cancel_requests": cancel_n, "cancel_answer": cancel_answer,
           "cancel_status": cancelled["status"], "crash_left": left,
           "recovered_batches": recovered_n, "recovered_status": recovered["status"],
           "recovered_counts": recovered["request_counts"],
           "recovered_outputs": len(recovered_out), "recovery_s": recovery_s}
    log(f"batch: f32 {model} on {card}: a multipart JSONL of {n_requests} ({n_requests - 5} "
        f"completions, 4 chats, 1 refused; {prompt_len}+{max_tokens} tokens) through the "
        f"port's BatchGateway -> router -> 2 engines: {done['status']} {counts} in "
        f"{batch_s:.3f} s, tokens_identical={all(same)} ({len(same)} lines vs direct), "
        f"error file {refused}; cancel mid-run: answered {cancel_answer}, ended "
        f"{cancelled['status']}; gateway stopped with a batch {left}, the new gateway "
        f"recovered {recovered_n} and ended it {recovered['status']} "
        f"{recovered['request_counts']} in {recovery_s:.3f} s; K1 by instance="
        f"{by_instance['paged_attention']}")
    if done["status"] != "completed" or counts != {"total": n_requests,
                                                  "completed": n_requests - 1, "failed": 1}:
        raise AssertionError(f"batch: the main batch ended {done['status']} {counts}")
    if not all(same) or len(same) != n_requests - 1:
        raise AssertionError(f"batch: batch tokens differ from direct ones ({same})")
    if refused != [(f"main-{n_requests - 1}", 400)]:
        raise AssertionError(f"batch: the error file holds {refused}")
    if cancel_answer != "cancelling" or cancelled["status"] != "cancelled":
        raise AssertionError(f"batch: the cancel answered {cancel_answer}, the batch ended "
                             f"{cancelled['status']}")
    if (left != "in_progress" or recovered_n != 1 or recovered["status"] != "completed"
            or recovered["request_counts"]["completed"] != crash_n
            or len(recovered_out) != crash_n):
        raise AssertionError(f"batch: crash recovery: left {left}, recovered {recovered_n}, "
                             f"ended {recovered['status']} {recovered['request_counts']}")
    if device.type == "cuda" and not launches["paged_attention"] > 0:
        raise AssertionError(f"batch: K1 did not launch behind the gateway ({by_instance})")
    return row


def batch_bf16_times(device, card: str, model: str = "llama-1b", seed: int = 1,
                     n_items: int = 32, item_tokens: int = 16, workload=None,
                     concurrency: int = 8) -> dict:
    """bf16 engines behind the router: the port's ``AsyncProcessor`` sends
    ``n_items`` through a ``PrometheusSaturationGate`` on an engine's
    ``vllm:num_requests_waiting`` (every item must succeed); then the load
    harness's ``compare_targets`` on ``shared-prefix`` between one engine
    directly and the router, its report printed with the card (not bounded).
    K1 launched."""
    import asyncio

    from llmd_tpu_torch.batch import (AsyncItem, AsyncProcessor, AsyncProcessorConfig,
                                      MemoryQueuePuller, PrometheusSaturationGate)
    from llmd_tpu_torch.benchmark import WorkloadSpec, compare_targets
    from llmd_tpu_torch.models import get_model_config

    cfg = dataclasses.replace(get_model_config(model), dtype="bfloat16")
    rng = np.random.default_rng(seed)
    spec = WorkloadSpec(**{**dict(kind="shared-prefix", num_requests=64, max_tokens=32,
                                  model="llama-1b", seed=seed), **(workload or {})})
    servers = _router_engines(device, cfg, seed=seed)
    rt = loops = None

    async def process() -> tuple:
        q = MemoryQueuePuller()
        gate = PrometheusSaturationGate(f"http://{servers[0].address}/metrics",
                                        "vllm:num_requests_waiting", threshold=64.0,
                                        poll_interval_s=0.05)
        done = asyncio.Event()
        results = {}

        def on_result(item, res):
            results[item.id] = res
            if len(results) == n_items:
                done.set()

        proc = AsyncProcessor(AsyncProcessorConfig(target_url=rt.url, num_workers=8, seed=0),
                              q, gate=gate, on_result=on_result)
        await proc.start()
        t0 = time.perf_counter()
        try:
            for i in range(n_items):
                await q.put(AsyncItem(id=f"item-{i}", url="/v1/completions", body={
                    "model": "llama-1b", "prompt": _router_text(rng, 64),
                    "max_tokens": item_tokens, "temperature": 0, "ignore_eos": True},
                    priority=i % 3, deadline=time.time() + 300))
            await asyncio.wait_for(done.wait(), 300)
        finally:
            await proc.stop()
        return results, dict(proc.stats), gate.last_value, time.perf_counter() - t0

    try:
        rt = _RouterThread(servers)
        loops = _LoopThread()  # the clients' loop, apart from the router's
        zero_counts()
        results, stats, gate_value, proc_s = loops._call(process(), timeout=360)
        report = loops._call(compare_targets(
            {"direct": servers[0].address, "router": rt.router.address}, spec,
            concurrency=concurrency), timeout=600)
        if device.type == "cuda":
            torch.cuda.synchronize()
        by_instance = instance_counts()
        launches, _ = read_counts()
        # an engine whose step loop died answers every request with an error
        # and says why on /health
        health = [_http("GET", f"http://{s.address}/health")[2].decode() for s in servers]
    finally:
        if loops is not None:
            loops.close()
        if rt is not None:
            rt.stop()
        for s in servers:
            s.stop()
    ok = [r is not None and len(r["choices"][0]["text"]) == item_tokens
          for r in results.values()]
    keys = ("out_tok_per_s", "ttft_p50_ms", "e2e_p90_ms", "errors", "requests")
    row = {"card": card, "model": model, "dtype": "bfloat16", "items": n_items,
           "processor_stats": stats, "processor_s": proc_s, "gate_last_value": gate_value,
           "items_ok": sum(ok), "workload": spec.describe(), "concurrency": concurrency,
           "report": report, "launches": launches, "launches_by_instance": by_instance,
           "engines_health": health}
    log(f"batch: bf16 {model} on {card}: AsyncProcessor {n_items} items through a "
        f"PrometheusSaturationGate (vllm:num_requests_waiting, last {gate_value}) in "
        f"{proc_s:.3f} s: {stats}; K1 by instance={by_instance['paged_attention']}")
    for name, summary in report["targets"].items():
        log(f"batch:   harness shared-prefix ({spec.num_requests} requests, "
            f"{spec.max_tokens} out, concurrency {concurrency}) {name}: "
            + ", ".join(f"{k} {summary[k]}" for k in keys) + f" on {card}")
    log(f"batch:   harness delta {report.get('delta')}")
    if stats["succeeded"] != n_items or sum(ok) != n_items:
        raise AssertionError(f"batch: the processor's items: {stats}, {sum(ok)} whole; "
                             f"the engines' /health: {health}")
    if any(report["targets"][t]["errors"] or report["targets"][t]["requests"]
           != spec.num_requests for t in report["targets"]):
        raise AssertionError(f"batch: the harness report {report['targets']}; the engines' "
                             f"/health: {health}")
    if device.type == "cuda" and not launches["paged_attention"] > 0:
        raise AssertionError(f"batch: K1 did not launch behind the processor ({by_instance})")
    return row


def phase_batch(device, card: str, model: str = "llama-1b", f32_kw=None,
                bf16_kw=None, gates: tuple = BATCH_GATES) -> dict:
    """The batch phase: the OpenAI Batch gateway and the async processor in
    front of the port's router over two engines, the load harness's
    direct-vs-router comparison, then the chaos, KV-plane and decision gates
    as concurrent subprocesses on the card's host."""
    t0 = time.perf_counter()
    out = {"f32": batch_f32_check(device, card, model=model, **(f32_kw or {}))}
    _empty()
    out["bf16"] = batch_bf16_times(device, card, model=model, **(bf16_kw or {}))
    out["gates"] = found = _pool_gates(120.0, gates, "batch")
    log("batch: gates " + ", ".join(f"{name} rc {g['rc']} ({g['seconds']:.1f} s)"
                                    for name, g in found.items()) + f", on the host of {card}")
    out["seconds"] = time.perf_counter() - t0
    log(f"batch: phase {out['seconds']:.1f} s on {card}")
    return out


# --------------------------------------------------------------------------
# The port's tooling: its lint, the operator CLIs, torch's syncs held to the lint
# --------------------------------------------------------------------------

def _tool(module: str, *args: str, timeout_s: float = 300.0) -> dict:
    """``python -m llmd_tpu_torch.tools.<module> args`` from the checkout:
    exit code, output and seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"llmd_tpu_torch.tools.{module}", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=timeout_s)
    return {"rc": proc.returncode, "stdout": proc.stdout, "stderr": proc.stderr,
            "seconds": time.perf_counter() - t0}


def tools_static(card: str) -> dict:
    """The port's lint (every analyzer over ``llmd_tpu_torch/``) and the
    manifest validator over ``deploy/``, each as a subprocess on the card's
    Python: exit 0, with the lint's finding and allow counts."""
    lint = _tool("llmd_lint", "--json")
    if lint["rc"] != 0:
        raise AssertionError(f"tools: llmd_lint exited {lint['rc']}: "
                             f"{lint['stdout'][-3000:]}{lint['stderr'][-3000:]}")
    found = json.loads(lint["stdout"])
    locks = found["summaries"]["locks"]
    row = {"lint_rc": lint["rc"], "lint_seconds": lint["seconds"],
           "lint_failures": found["counts"]["failures"],
           "lint_allowed": found["counts"]["allowed"],
           "lint_lock_classes": locks["num_classes"], "lint_locks": locks["num_locks"],
           "lint_lock_edges": locks["edges"]}
    log(f"tools: llmd_lint rc {lint['rc']} in {lint['seconds']:.2f} s: "
        f"{row['lint_failures']} findings, {row['lint_allowed']} allowed, "
        f"{locks['num_classes']} classes holding {locks['num_locks']} locks, "
        f"{locks['num_edges']} lock-order edges")
    val = _tool("validate_manifests", "deploy")
    if val["rc"] != 0:
        raise AssertionError(f"tools: validate_manifests exited {val['rc']}: "
                             f"{val['stderr'][-3000:]}")
    row |= {"validate_rc": val["rc"], "validate_seconds": val["seconds"],
            "validate": val["stdout"].strip()}
    log(f"tools: validate_manifests rc {val['rc']} in {val['seconds']:.2f} s: "
        f"{row['validate']} (on the host of {card})")
    return row


def tools_rollout(device, card: str, model: str = "llama-1b", seed: int = 0,
                  probes: int = 8, stages: str = "0.1,0.5,1.0") -> dict:
    """Two bf16 engines (LoRA on) behind the port's router: an adapter written
    locally from ``seed`` rolled out by the rollout CLI through the router's
    ``/admin/model-rewrites`` over ``stages`` with ``probes`` canaries each
    (exit 0, the successor pinned); ``dump_flight`` against one engine and the
    router (the list, and ``--id <a rollout probe> --phases --decisions``),
    each view also rendered from its ``--save`` file, byte-equal; then, with
    both engines drained, a second rollout whose stage fails: exit 1, the
    rewrites read back as they were."""
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.lora import LoRAConfig, make_adapter_weights

    cfg = get_model_config(model)
    servers = _router_engines(device, cfg, 2, seed, engine_kw={"lora": LoRAConfig()})
    router = None
    tmp = Path(tempfile.mkdtemp(prefix="llmd-tools-"))
    try:
        router = _RouterThread(servers)
        weights = make_adapter_weights(cfg, LoRAConfig(), torch.Generator().manual_seed(seed))
        npz = tmp / "ad-0.npz"
        np.savez(npz, **{k: v.float().numpy() for k, v in weights.items()})
        base = servers[0].model_name
        rewrites = f"{router.url}/admin/model-rewrites"
        addr = router.url.removeprefix("http://")
        zero_counts()
        run = _tool("rollout", "--router", addr, "--model", base, "--new", "ad-0",
                    "--stages", stages, "--probes", str(probes),
                    "--pods", ",".join(s.address for s in servers), "--adapter-path", str(npz))
        launches, plain = read_counts()
        by_instance = instance_counts()
        report = json.loads(run["stdout"]) if run["stdout"].strip() else {}
        pinned = json.loads(_http("GET", rewrites)[2])
        row = {"rollout_rc": run["rc"], "rollout_seconds": run["seconds"],
               "rollout": report, "rewrites": pinned, "launches": launches,
               "launches_by_instance": by_instance}
        log(f"tools: rollout {stages} x {probes} probes rc {run['rc']} in "
            f"{run['seconds']:.2f} s: {report.get('outcome')}, stages "
            f"{[s['success_rate'] for s in report.get('stages', [])]}, rewrites {pinned}; "
            f"K1 {launches['paged_attention']} launches {by_instance['paged_attention']}")
        if run["rc"] != 0 or report.get("outcome") != "completed" \
                or pinned.get(base) != [["ad-0", 1.0]]:
            raise AssertionError(f"tools: the rollout did not complete and pin ad-0: rc "
                                 f"{run['rc']} {report} {pinned}\n{run['stderr'][-3000:]}")
        if device.type == "cuda" and (  # launch checks on the card only
                any(plain.values()) or launches["paged_attention"] == 0
                or by_instance["paged_attention"].get("mma") != launches["paged_attention"]):
            raise AssertionError(f"tools: the rollout's engines did not run K1 on mma "
                                 f"alone: {launches} {by_instance} plain {plain}")

        # dump_flight, live and from its saved files
        eng_url = f"http://{servers[0].address}"
        listed = json.loads(_http("GET", f"{router.url}/debug/requests?limit=100")[2])
        probe = next(r["request_id"] for r in reversed(listed["requests"])
                     if r.get("status") == "finished")
        views = {"engine list": (eng_url,), "router --id --phases --decisions": (
            router.url, "--id", probe, "--phases", "--decisions")}
        for label, (src, *flags) in views.items():
            saved = tmp / (label.split()[0] + ".json")
            runs = [_tool("dump_flight", src, *flags),
                    _tool("dump_flight", src, *flags, "--save", str(saved)),
                    _tool("dump_flight", str(saved), *flags)]
            rc, rc_save, rc_file = (run["rc"] for run in runs)
            live, offline = runs[0]["stdout"], runs[2]["stdout"]
            row[f"dump_flight {label}"] = {"rc": (rc, rc_save, rc_file),
                                           "lines": len(live.splitlines()),
                                           "equal": live == offline}
            log(f"tools: dump_flight {label}: rc {rc} / {rc_save} / {rc_file}, "
                f"{len(live.splitlines())} lines, saved render equal {live == offline}")
            if (rc, rc_save, rc_file) != (0, 0, 0) or live != offline or not live:
                raise AssertionError(f"tools: dump_flight {label}: rc {rc} / {rc_save} / "
                                     f"{rc_file}; live:\n{live[-2000:]}\nsaved:\n"
                                     f"{offline[-2000:]}")
        if "phase ledger" not in live or "decision ledger" not in live:
            raise AssertionError(f"tools: dump_flight --phases --decisions of a rollout "
                                 f"probe shows no ledgers:\n{live[-2000:]}")

        # a failed stage rolls back
        for s in servers:
            _http("POST", f"http://{s.address}/drain", {})
        fail = _tool("rollout", "--router", addr, "--model", base, "--new", "ad-1",
                     "--stages", "0.5,1.0", "--probes", "4")
        after = json.loads(_http("GET", rewrites)[2])
        failed = json.loads(fail["stdout"]) if fail["stdout"].strip() else {}
        row |= {"failed_rc": fail["rc"], "failed_outcome": failed.get("outcome"),
                "rewrites_after_failure": after}
        log(f"tools: rollout to a drained pool rc {fail['rc']}: {failed.get('outcome')}; "
            f"rewrites {after}")
        if fail["rc"] == 0 or after != pinned \
                or not str(failed.get("outcome", "")).startswith("rolled-back"):
            raise AssertionError(f"tools: a failed stage did not roll back: rc {fail['rc']} "
                                 f"{failed} rewrites {after} (before {pinned})")
        return row
    finally:
        if router is not None:
            router.stop()
        for s in servers:
            s.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def tools_predictor(device, card: str, model: str = "llama-1b", reps: int = 3) -> dict:
    """``predictor_accuracy``'s offline mode on ``model`` at full width on the
    card: the reference's four regimes ``reps`` times, the GBDT fitted on the
    engine's trace; its artifact written into a temporary directory. MAPE,
    skill against the mean baseline and K1's launches on its instances."""
    from llmd_tpu_torch.tools.predictor_offline import offline

    tmp = Path(tempfile.mkdtemp(prefix="llmd-tools-"))
    try:
        zero_counts()
        art = offline(model, device.type == "cpu", reps, str(tmp / "predictor_accuracy.json"))
        launches, plain = read_counts()
        by_instance = instance_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"tools: predictor_accuracy {model} reps {reps}: {art['requests_served']} requests "
        f"in {art['serve_seconds']} s, ttft_mape {art['ttft_mape']} (mean baseline "
        f"{art['mean_baseline_ttft_mape']}, skill {art['skill_vs_mean']}x), tpot_mape "
        f"{art['tpot_mape']}; K1 {launches['paged_attention']} launches "
        f"{by_instance['paged_attention']} on {card}")
    if device.type == "cuda" and (  # launch checks on the card only
            any(plain.values()) or launches["paged_attention"] == 0
            or by_instance["paged_attention"].get("mma") != launches["paged_attention"]):
        raise AssertionError(f"tools: predictor_accuracy's engine did not run K1 on mma "
                             f"alone: {launches} {by_instance} plain {plain}")
    return {"artifact": art, "launches": launches, "launches_by_instance": by_instance}


def _enclosing(sf, line: int) -> "str | None":
    """The top-level function or method of ``sf`` whose body holds ``line``
    (the unit the hot-path lint selects), or None."""
    import ast

    for node in sf.tree.body:
        items = node.body if isinstance(node, ast.ClassDef) else [node]
        for fn in items:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and fn.lineno <= line <= (fn.end_lineno or fn.lineno):
                return fn.name
    return None


def _sync_run(eng, prompts, max_tokens: int, control: bool) -> tuple[list, int, int]:
    """Step ``eng`` through ``prompts`` (greedy, ``max_tokens`` each) under
    ``torch.cuda.set_sync_debug_mode("warn")``: (each sync warning's innermost
    frame in ``llmd_tpu_torch/`` with its message, steps, the sync warnings
    of this script's deliberate ``.item()`` control). Other warnings are not
    syncs and are left out."""
    import traceback
    import warnings

    from llmd_tpu_torch.core.request import SamplingParams

    sp = SamplingParams(max_tokens=max_tokens, temperature=0.0, ignore_eos=True)
    for i, toks in enumerate(prompts):
        eng.add_request(f"sync-{i}", list(toks), sp)
    pkg, me = str(REPO / "llmd_tpu_torch"), str(Path(__file__).resolve())
    seen, controls = [], []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        stack = traceback.extract_stack()
        ours = [f for f in stack if f.filename.startswith(pkg)]
        if ours:
            seen.append((ours[-1].filename, ours[-1].lineno, str(message)[:120]))
        elif any(f.filename == me and f.name == "_sync_run" for f in stack):
            controls.append(str(message)[:120])

    steps = 0
    on_card = eng.device.type == "cuda"  # the CPU has no sync debug mode: no sites
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            while eng.has_work():
                eng.step()
                steps += 1
            if control and on_card:  # the mode must see a deliberate read-back
                torch.ones(1, device=eng.device).item()
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)
    return seen, steps, len(controls)


def tools_sync_sites(device, card: str, model: str = "llama-1b", seed: int = 0,
                     n_requests: int = 4, prompt_len: int = 96, max_tokens: int = 16) -> dict:
    """The static lint held to what torch sees: one engine's unified step and
    replayed decode iterations, then a speculative engine's verify steps on
    echo prompts, under ``torch.cuda.set_sync_debug_mode("warn")`` (a
    deliberate ``.item()`` in this script must be reported). Each warning's
    innermost frame in ``llmd_tpu_torch/`` is a sync site; a site inside a
    function the lint holds hot must carry an ``allow[hot-host-sync]`` with
    its justification."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.tools.llmd_lint import core as lint_core
    from llmd_tpu_torch.tools.llmd_lint.hotpath import _hot_functions, _selected

    cfg = get_model_config(model)
    rng = np.random.default_rng(seed)
    seen, steps, controls = [], {}, {}
    for label, kw, prompts in (
            ("plain", {}, [rng.integers(1, cfg.vocab_size - 1, prompt_len).tolist()
                           for _ in range(n_requests)]),
            ("spec", SPEC_KW, echo_prompts(n_requests, 7, cfg.vocab_size, prompt_len))):
        eng = LLMEngine(cfg, EngineConfig(**(ROUTER_KW | kw)), seed=seed, device=device)
        try:  # captures the decode program (and, with speculation, runs a verify step)
            eng.generate(echo_prompts(1, 1, cfg.vocab_size, 64),
                         SamplingParams(max_tokens=2 * eng.cfg.decode_steps + 2,
                                        temperature=0.0))
            found, steps[label], n = _sync_run(eng, prompts, max_tokens, control=True)
            seen += found
            controls[label] = n
        finally:
            eng.close()
    project = lint_core.Project(REPO)
    sites: dict = {}
    unallowed = []
    for filename, lineno, message in seen:
        rel = Path(filename).resolve().relative_to(REPO).as_posix()
        site = sites.setdefault(f"{rel}:{lineno}", {"count": 0, "message": message})
        site["count"] += 1
        if site["count"] > 1:
            continue
        sf = project.file(rel)
        fn = _enclosing(sf, lineno) if sf is not None else None
        funcs = _hot_functions(project.config.hot_paths, sf) if sf is not None else None
        site["function"] = fn
        site["hot"] = hot = bool(funcs is not None and fn and _selected(funcs, fn))
        allow = sf.allow_for("hot-host-sync", lineno) if sf is not None else None
        site["allow"] = allow[1] if allow else None
        if hot and not (allow and allow[1]):
            unallowed.append(f"{rel}:{lineno} in {fn}: {message}")
    for key, site in sites.items():
        log(f"tools: sync site {key} x{site['count']} in {site['function']} "
            f"(hot {site['hot']}; allow: {site['allow'] or '-'}): {site['message']}")
    log(f"tools: {len(sites)} sync sites in llmd_tpu_torch over {steps} steps on {card} "
        f"({sum(s['hot'] for s in sites.values())} in hot functions, "
        f"{sum(bool(s['allow']) for s in sites.values())} allowed; the .item() control's "
        f"sync warnings by run: {controls})")
    if device.type == "cuda" and not all(controls.values()):
        raise AssertionError(f"tools: the sync debug mode missed a deliberate .item() "
                             f"control: {controls}")
    if unallowed:
        raise AssertionError("tools: syncs inside hot functions without an "
                             "allow[hot-host-sync]: " + "; ".join(unallowed))
    return {"sites": sites, "steps": steps, "controls": controls}


def phase_tools(device, card: str, model: str = "llama-1b", rollout_kw=None,
                predictor_kw=None, sync_kw=None) -> dict:
    """The tools phase: the port's lint and manifest validator, a rollout and
    dump_flight over two engines behind the router, predictor_accuracy
    offline, and the dynamic check of the static lint's hot-path syncs."""
    t0 = time.perf_counter()
    out = {"static": tools_static(card)}
    out["rollout"] = tools_rollout(device, card, model=model, **(rollout_kw or {}))
    _empty()
    out["predictor"] = tools_predictor(device, card, model=model, **(predictor_kw or {}))
    _empty()
    out["sync"] = tools_sync_sites(device, card, model=model, **(sync_kw or {}))
    out["seconds"] = time.perf_counter() - t0
    log(f"tools: phase {out['seconds']:.1f} s on {card}")
    return out


POOL_EXTRA = ["--host", "127.0.0.1", "--num-pages", "1024", "--max-batch-size", "64",
              "--prefill-chunk", "256", "--decode-steps", "4"]
POOL_READY_S = 400.0  # a cold replica compiles its kernels (nvcc) before /health
# HPA (no stabilization window, as the reference's) reads running requests and
# the router's flow-control queue. On an H100 one llama-1b replica held about
# HPA's 16 running at 32 rps, and the scaled-up replica was retired at its first
# step, before it served; at 48 rps the pool flapped. At 64 rps one replica
# saturates and the router's queue keeps two while the second takes the backlog.
POOL_TRACE = dict(duration_s=60.0, base_rps=2.0, burst_rps=64.0, burst_start_s=5.0,
                  burst_end_s=45.0, seed=0, prompt_tokens=256, max_tokens=64)
# the pool's router: flow control on, load-aware scoring (the SLO gate's config)
POOL_ROUTER_CFG = """
flowControl:
  enabled: true
plugins:
  - {name: inflight, type: inflight-load-producer}
  - {name: queue, type: queue-depth-scorer}
  - {name: kv-util, type: kv-cache-utilization-scorer}
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: queue, weight: 2}
      - {pluginRef: kv-util, weight: 1}
"""
# the latency phase's P/D profile without the latency producer: no predictor
# runs here, so past 16 uncached tokens the decider splits (``no_predictor``)
POOL_PD_CFG = """
plugins:
  - {name: prefix-producer, type: approx-prefix-cache-producer, params: {blockSize: 16}}
  - {name: prefill-filter, type: prefill-endpoints-filter}
  - {name: decode-filter, type: decode-endpoints-filter}
  - {name: prefix, type: prefix-cache-scorer}
  - {name: queue, type: queue-depth-scorer}
  - {name: picker, type: max-score-picker}
profileHandler: disagg-profile-handler
disaggregation: {uncachedSuffixThreshold: 16}
schedulingProfiles:
  - name: prefill
    plugins: [{pluginRef: prefill-filter}, {pluginRef: queue, weight: 1}, {pluginRef: picker}]
  - name: decode
    plugins:
      - {pluginRef: decode-filter}
      - {pluginRef: prefix, weight: 3}
      - {pluginRef: queue, weight: 1}
      - {pluginRef: picker}
"""
# greedy, with every printable ASCII id raised by 100: the served byte
# tokenizer's text then holds each generated token, one character each
POOL_BIAS = {str(i): 100 for i in range(33, 127)}


def _pool_launcher(model: str, store, extra: list, log_dir: str, events: list,
                   role: str = "both", sidecar: bool = False, ready_s: float = POOL_READY_S):
    """The port's ``ProcessReplicaLauncher`` over ``engine_argv(model, ...,
    snapshots=store, extra=extra)``, its replicas' output in ``log_dir``. Each
    handle carries ``role`` (the controller copies it onto the endpoint); with
    ``sidecar`` a port ``RoutingSidecar`` in this process fronts the replica,
    as the fake launcher fronts a fake one. Stops are noted in ``events``:
    ("stop", address) before the terminate, ("exited", address, rc) after."""
    import asyncio

    from llmd_tpu_torch.disagg.sidecar import RoutingSidecar
    from llmd_tpu_torch.pool.launcher import ProcessReplicaLauncher, engine_argv

    class Launcher(ProcessReplicaLauncher):
        async def launch(self):
            handle = await super().launch()
            handle.role = role
            if sidecar:
                sc = RoutingSidecar(decode_addr=handle.address, host="127.0.0.1", port=0)
                await sc.start()
                handle.sidecar, handle.address = sc, sc.address
            return handle

        async def _unfront(self, handle) -> None:
            if handle.sidecar is not None:
                sc, handle.sidecar = handle.sidecar, None
                await sc.stop()

        async def stop(self, handle) -> None:
            proc = handle.proc
            events.append(("stop", handle.address))
            await self._unfront(handle)
            await super().stop(handle)
            if proc is not None:
                rc = await asyncio.to_thread(proc.wait, 30)
                events.append(("exited", handle.address, rc))

        async def kill(self, handle) -> None:
            await self._unfront(handle)
            await super().kill(handle)

    return Launcher(lambda port: engine_argv(model, port, snapshots=store, extra=extra),
                    ready_timeout_s=ready_s, log_dir=log_dir)


def _pool_logs(log_dir: Path, n: int = 1500) -> str:
    return "\n".join(f"--- {p.name}: {p.read_text()[-n:]}" for p in sorted(log_dir.glob("*.log")))


async def _pool_get(client, url: str) -> tuple:
    r = await client.request("GET", url, timeout=60)
    return r.status, (await r.read()).decode()


async def _pool_complete(client, base: str, prompt: str, max_tokens: int) -> tuple:
    """(status, body) of one greedy completion under ``POOL_BIAS``."""
    r = await client.request("POST", f"http://{base}/v1/completions", json_body={
        "prompt": prompt, "max_tokens": max_tokens, "temperature": 0, "ignore_eos": True,
        "logit_bias": POOL_BIAS}, timeout=600)
    return r.status, json.loads(await r.read())


async def _pool_wait(cond, what: str, timeout_s: float, log_dir: Path) -> float:
    """Seconds until ``cond()`` holds (checked every 0.1 s on the loop)."""
    import asyncio

    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"pool: {what}: not reached in {timeout_s} s\n"
                                 f"{_pool_logs(log_dir)}")
        await asyncio.sleep(0.1)
    return time.monotonic() - t0


async def _pool_scraped(pool, log_dir: Path) -> None:
    """Every endpoint of ``pool`` scraped once by the router's poller."""
    await _pool_wait(lambda: all(ep.attrs.get("kv_cache_utilization") is not None
                                 for ep in pool.list()), "the router's first scrape", 60.0,
                     log_dir)


async def _pool_run(device, card: str, work: Path, model: str, extra: list, trace_kw: dict,
                    n_probe: int, probe_len: int, probe_tokens: int, n_pd: int, pd_len: int,
                    ready_s: float, settle_s: float, running_target: float) -> dict:
    import asyncio

    from llmd_tpu_torch.core.config import FrameworkConfig
    from llmd_tpu_torch.core.endpoint import EndpointPool
    from llmd_tpu_torch.pool.controller import PoolConfig, PoolController
    from llmd_tpu_torch.pool.disagg import DisaggPoolSet
    from llmd_tpu_torch.pool.harness import replay_trace
    from llmd_tpu_torch.pool.snapshot import PoolSnapshotStore, config_fingerprint
    from llmd_tpu_torch.pool.traces import bursty_trace
    from llmd_tpu_torch.router.http import HTTPClient
    from llmd_tpu_torch.router.plugins import known_plugin_types
    from llmd_tpu_torch.router.server import RouterServer

    on_card = device.type == "cuda"
    served = f"llmd-tpu/{model}"
    logs = work / "logs"
    store = PoolSnapshotStore(str(work / "snap"))
    cache = Path(store.path(config_fingerprint({"model": model}), "compile_cache"))

    def libs() -> list:
        return sorted(p.name for p in cache.glob("*.so"))

    def metric(text: str, name: str, labels: str = "") -> float:
        return _metric(text, name, labels) or 0.0

    row: dict = {"card": card, "model": model}
    events: list = []
    pool = EndpointPool()
    pool.subscribe(lambda kind, ep: events.append((kind, ep.address)))
    router = RouterServer(FrameworkConfig.from_yaml(POOL_ROUTER_CFG,
                                                    known_types=known_plugin_types()),
                          pool, host="127.0.0.1", port=0, poll_interval_s=0.2, seed=0)
    launcher = _pool_launcher(model, store, extra, str(logs), events, ready_s=ready_s)
    ctl = PoolController(PoolConfig(model=model, min_replicas=1, max_replicas=2, policy="hpa",
                                    interval_s=1.0), launcher, router=router)
    for m in ctl.hpa.metrics:  # the reference's target unless a rehearsal shrinks it
        if m.name == "igw_running_requests":
            m.target = running_target
    client = HTTPClient()
    drain_seen: dict = {}
    ctl_drain = ctl._drain

    async def drain(address: str) -> None:  # the handshake, observed
        events.append(("drain", address))
        await ctl_drain(address)
        try:
            drain_seen[address] = (await _pool_get(client, f"http://{address}/health"))[0]
            served_by[address] = metric((await _pool_get(
                client, f"http://{address}/metrics"))[1], "llmd_tpu:requests_total")
        except Exception as e:  # noqa: BLE001 — recorded, judged below
            drain_seen[address] = type(e).__name__

    ctl._drain = drain
    steps: list = []  # (unix s, running, router queue, replicas, desired after)
    ctl_step = ctl.step

    async def step() -> None:  # HPA's inputs at each step, observed
        seen = (time.time(), ctl._running_total(), float(ctl._flow_depth()), len(ctl.replicas))
        await ctl_step()
        steps.append(seen + (ctl.variant.desired_replicas,))

    ctl.step = step
    served_by: dict = {}  # requests_total by replica: polled, and read at its drain
    pds = pd_router = None
    await router.start()
    try:
        # 1. the floor: one cold replica
        t0 = time.monotonic()
        await ctl.start()
        row["floor_s"] = time.monotonic() - t0
        recs = ctl.launch_records
        if len(ctl.replicas) != 1 or [r.kind for r in recs] != ["cold"]:
            raise AssertionError(f"pool: the floor launched {ctl.status()}\n{_pool_logs(logs)}")
        (first,) = ctl.replicas
        row["cold_libs"] = libs()
        _, text = await _pool_get(client, f"http://{first}/metrics")
        row["backend"] = [ln for ln in text.splitlines()
                          if ln.startswith("llmd_tpu:engine_attn_backend{")]
        if on_card and (not row["cold_libs"] or not any(
                'backend="cuda_paged_attention"' in ln for ln in row["backend"])):
            raise AssertionError(f"pool: the cold replica built {row['cold_libs']} into "
                                 f"{cache}, backend {row['backend']}")
        log(f"pool: floor: one cold {model} replica in {recs[0].seconds:.1f} s "
            f"({len(row['cold_libs'])} kernel libraries built into the fingerprint's "
            f"compile_cache), backend {row['backend']} on {card}")
        await _pool_scraped(pool, logs)

        # 2. the burst through the router, open loop
        peaks = {"running": 0.0, "router_queue": 0.0}

        async def watch() -> None:
            while True:
                peaks["running"] = max(peaks["running"], router.fleet.running_total())
                peaks["router_queue"] = max(peaks["router_queue"],
                                            float(router.flow._total_queued()))
                for address in list(ctl.replicas):
                    try:
                        _, t = await _pool_get(client, f"http://{address}/metrics")
                        served_by[address] = max(served_by.get(address, 0.0),
                                                 metric(t, "llmd_tpu:requests_total"))
                    except Exception:  # noqa: BLE001 — a replica going away
                        pass
                await asyncio.sleep(1.0)

        trace = bursty_trace(**trace_kw)
        t_trace = time.time()
        watcher = asyncio.get_running_loop().create_task(watch())
        try:
            report = await replay_trace(router.address, trace, model=served, slo_e2e_s=3.0,
                                        request_timeout_s=120.0)
        finally:
            watcher.cancel()
        row["burst"] = summary = report.summary()
        row["burst_launches"] = [(r.kind, r.seconds, r.address) for r in ctl.launch_records]
        second = ctl.launch_records[1:]
        row["served_by"] = {a: served_by.get(a, 0.0) for _, _, a in row["burst_launches"]}
        row["burst_peaks"] = peaks
        row["hpa_changes"] = [(round(s[0] - t_trace, 1), *s[1:]) for i, s in enumerate(steps)
                              if s[0] >= t_trace and s[4] != (steps[i - 1][4] if i else 1)]
        row["timeline"] = [(e["event"].removeprefix("pool_"), e.get("reason") or e.get("kind"),
                            round(e["t_unix"] - t_trace, 1))
                           for e in router.flight.system_events()
                           if e["event"].startswith("pool_") and e["t_unix"] >= t_trace]
        log(f"pool: burst: {summary['requests']} requests ({trace_kw}), statuses "
            f"{summary['statuses']}, client 5xx {summary['client_5xx']}, attainment "
            f"{summary['slo_attainment']} at e2e <= {summary['slo_e2e_s']} s, e2e p50 "
            f"{summary['p50_e2e_s']} s p99 {summary['p99_e2e_s']} s, wall {summary['wall_s']} s;"
            f" launches {[(k, round(s, 1)) for k, s, _ in row['burst_launches']]} s; "
            f"requests_total by replica {list(row['served_by'].values())}; peaks (1 s polls) "
            f"{peaks}; HPA steps that changed the count (s, running, router queue, "
            f"replicas, desired) {row['hpa_changes']}; pool events (s "
            f"from the trace's start) {row['timeline']} on {card}")
        if summary["client_5xx"] != 0 or summary["statuses"] != {"200": len(trace)}:
            raise AssertionError(f"pool: the burst answered {summary}")
        if not second or any(r.kind != "warm" for r in second) or libs() != row["cold_libs"]:
            raise AssertionError(f"pool: scale-up launches {row['burst_launches']}, "
                                 f"libraries {row['cold_libs']} -> {libs()}")
        # HPA keeps no stabilization window (as the reference's): a dip in the
        # running count can retire a replica that a later step launches again
        if not any(row["served_by"][r.address] > 0 for r in second):
            raise AssertionError(f"pool: no scaled-up replica served: {row['served_by']}")

        # 3. back to the floor: each victim drained, left discovery, then stopped
        row["settle_s"] = await _pool_wait(lambda: len(ctl.replicas) == 1, "back to 1 replica",
                                           settle_s, logs)
        victims = [a for _, _, a in row["burst_launches"] if a not in ctl.replicas]
        row["retired"] = {}
        for a in victims:
            seq = [e for e in events if e[1] == a and e[0] in ("drain", "removed", "stop",
                                                                "exited")]
            row["retired"][a] = (seq, drain_seen.get(a))
            if [e[0] for e in seq] != ["drain", "removed", "stop", "exited"] or \
                    drain_seen.get(a) != 503 or seq[-1][2] != -15:
                raise AssertionError(f"pool: the victim {a}: {seq}, /health after the drain "
                                     f"{drain_seen.get(a)} (want drain, removed, stop, exited "
                                     f"rc -15; 503 draining)")
        log(f"pool: back to the floor {row['settle_s']:.1f} s after the trace; retired "
            f"{len(victims)}: POST /drain (then /health 503), out of discovery, terminate, "
            f"exit rc -15")

        # 4. chaos: kill the survivor; the sweep retires it, a warm launch replaces it
        rng = np.random.default_rng(7)
        probes = [_router_text(rng, probe_len) for _ in range(n_probe)]
        pd_prompts = [_router_text(rng, pd_len) for _ in range(n_pd)]

        async def ask(prompts: list, tokens: int) -> list:
            out = []
            for p in prompts:  # one at a time
                status, body = await _pool_complete(client, router.address, p, tokens)
                if status != 200 or body["usage"]["completion_tokens"] != tokens:
                    raise AssertionError(f"pool: a probe answered {status}: {body}")
                out.append(body["choices"][0]["text"])
            return out

        before = await ask(probes, probe_tokens)
        row["aggregated_pd"] = await ask(pd_prompts, probe_tokens)
        (victim,) = ctl.replicas.values()
        n_launched, t_kill = len(ctl.launch_records), time.monotonic()
        await launcher.kill(victim)
        row["heal_s"] = await _pool_wait(
            lambda: victim.address not in ctl.replicas and len(ctl.replicas) == 1,
            "a replacement for the killed replica", ready_s, logs)
        dead = [e for e in router.flight.system_events()
                if e["event"] == "pool_scale_down" and e.get("endpoint") == victim.address]
        repl = ctl.launch_records[n_launched:]
        await _pool_scraped(pool, logs)
        after = await ask(probes, probe_tokens)
        row["chaos"] = {"dead": dead, "replacement": [(r.kind, r.seconds) for r in repl],
                        "tokens_equal": before == after, "kill_to_ready_s":
                        time.monotonic() - t_kill}
        log(f"pool: chaos: killed {victim.address}; retired {[e.get('reason') for e in dead]}"
            f" ({[e.get('detail') for e in dead]}), replaced by {row['chaos']['replacement']}"
            f" in {row['heal_s']:.1f} s; {n_probe} probes x {probe_tokens} tokens equal "
            f"before and after: {before == after}")
        if [e.get("reason") for e in dead] != ["replica_dead"] or \
                [r.kind for r in repl] != ["warm"] or before != after or libs() != \
                row["cold_libs"]:
            raise AssertionError(f"pool: chaos {row['chaos']}, libraries {libs()}")

        # 6a. the pool families on the router
        _, text = await _pool_get(client, f"http://{router.address}/metrics")
        fam = {"desired": metric(text, "llmd_tpu:pool_desired_replicas"),
               "ready": metric(text, "llmd_tpu:pool_ready_replicas"),
               **{f"decisions_{r}": metric(text, "llmd_tpu:pool_scale_decisions_total",
                                           f'{{reason="{r}"}}')
                  for r in ("floor", "hpa", "replica_dead")},
               **{f"warm_start_{k}": metric(text, "llmd_tpu:pool_warm_start_seconds_count",
                                            f'{{kind="{k}"}}') for k in ("cold", "warm")}}
        row["families"] = fam
        await ctl.stop()

        # 5. a P/D pool set behind a P/D router
        pd_pool = EndpointPool()
        pd_router = RouterServer(FrameworkConfig.from_yaml(POOL_PD_CFG,
                                                           known_types=known_plugin_types()),
                                 pd_pool, host="127.0.0.1", port=0, poll_interval_s=0.2, seed=0)
        await pd_router.start()
        kv = ["--kv-transfer-port", "0"]
        pds = DisaggPoolSet(
            _pool_launcher(model, store, extra + ["--role", "prefill"] + kv, str(logs), events,
                           role="prefill", ready_s=ready_s),
            _pool_launcher(model, store, extra + ["--role", "decode"] + kv, str(logs), events,
                           role="decode", sidecar=True, ready_s=ready_s),
            router=pd_router,
            prefill_cfg=PoolConfig(model=model, min_replicas=1, max_replicas=1, interval_s=1.0,
                                   policy="hpa"),
            decode_cfg=PoolConfig(model=model, min_replicas=1, max_replicas=1, interval_s=1.0,
                                  policy="wva"))
        libs_before = libs()
        await pds.start()
        recs = pds.prefill.launch_records + pds.decode.launch_records
        new_libs = sorted(set(libs()) - set(libs_before))
        row["pd_launches"] = [(r.kind, r.seconds) for r in recs]
        if [r.kind for r in recs] != ["warm", "warm"] or len(pd_pool.list()) != 2 or any(
                not n.startswith("kv_transfer-") for n in new_libs):
            raise AssertionError(f"pool: P/D launches {row['pd_launches']}, endpoints "
                                 f"{[(e.address, e.role) for e in pd_pool.list()]}, new "
                                 f"libraries {new_libs}\n{_pool_logs(logs)}")
        await _pool_scraped(pd_pool, logs)
        (d,) = pds.decode.replicas.values()
        injected0 = metric((await _pool_get(client, f"http://{d.address}/metrics"))[1],
                           "llmd_tpu:kv_transfer_injected_blocks_total")
        replies = [await _pool_complete(client, pd_router.address, p, probe_tokens)
                   for p in pd_prompts]
        injected = metric((await _pool_get(client, f"http://{d.address}/metrics"))[1],
                          "llmd_tpu:kv_transfer_injected_blocks_total") - injected0
        reasons = _pd_reasons(pd_router)
        texts = [b["choices"][0]["text"] if s == 200 else "" for s, b in replies]
        same = sum(a == b for x, y in zip(texts, row["aggregated_pd"]) for a, b in zip(x, y))
        _, pd_text = await _pool_get(client, f"http://{pd_router.address}/metrics")
        row["pd"] = {"statuses": [s for s, _ in replies], "reasons": reasons,
                     "sidecar": dict(d.sidecar.stats), "injected_blocks": injected,
                     "identical_share": same / (n_pd * probe_tokens), "new_libs": new_libs,
                     "warm_start_warm": metric(pd_text, "llmd_tpu:pool_warm_start_seconds_count",
                                               '{kind="warm"}')}
        log(f"pool: P/D: prefill and decode replicas warm in "
            f"{[round(s, 1) for _, s in row['pd_launches']]} s (new libraries {new_libs}); "
            f"{n_pd} prompts of {pd_len} tokens: statuses {row['pd']['statuses']}, decisions "
            f"{reasons}, sidecar {row['pd']['sidecar']}, D injected {injected:.0f} blocks; "
            f"tokens identical to the aggregated replica's: {row['pd']['identical_share']:.3f}"
            f" (bf16, another program order; not bounded) on {card}")
        if row["pd"]["statuses"] != [200] * n_pd or any(
                b["usage"]["completion_tokens"] != probe_tokens for _, b in replies) or \
                reasons != ["no_predictor"] * n_pd or injected <= 0 or \
                row["pd"]["sidecar"]["pd_requests"] != n_pd or \
                row["pd"]["sidecar"]["prefill_fallbacks"] != 0:
            raise AssertionError(f"pool: P/D {row['pd']}")
    finally:
        await ctl.stop()
        if pds is not None:
            await pds.stop()
        if pd_router is not None:
            await pd_router.stop()
        await router.stop()
        await client.close()

    # 6b. the families' counts (the P/D controllers report on the P/D router)
    fam["warm_start_warm_pd"] = row["pd"]["warm_start_warm"]
    log(f"pool: families on the routers: {fam}")
    if not (fam["desired"] >= 1 and fam["ready"] >= 1 and fam["decisions_floor"] >= 1
            and fam["decisions_hpa"] >= 2 and fam["decisions_replica_dead"] == 1
            and fam["warm_start_cold"] == 1 and fam["warm_start_warm"] >= 2
            and fam["warm_start_warm"] + fam["warm_start_warm_pd"] >= 3):
        raise AssertionError(f"pool: families {fam}")
    return row


def _pool_gates(timeout_s: float = 180.0, gates: tuple = ("slo_check", "pd_check"),
                label: str = "pool") -> dict:
    """The port's gates (``llmd_tpu_torch.tools.<name>``; the SLO and P/D gates
    by default) as concurrent subprocesses (fake replicas on the host; none
    imports jax): exit codes and seconds. A gate past ``timeout_s`` gets
    SIGABRT first, so its threads' stacks come back."""
    import signal

    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-X", "faulthandler", "-m",
                                     f"llmd_tpu_torch.tools.{name}"],
                                    cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name in gates}
    out = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=max(1.0, t0 + timeout_s
                                                          - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGABRT)
            try:
                stdout, stderr = proc.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
        out[name] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0}
        if proc.returncode != 0:
            for other in procs.values():
                if other.poll() is None:
                    other.kill()
                    other.communicate()
            raise AssertionError(f"{label}: {name} exited {proc.returncode}: "
                                 f"{stdout[-2000:]}\n{stderr[-6000:]}")
    return out


def phase_pool(device, card: str, model: str = "llama-1b", extra=None, trace_kw=None,
               n_probe: int = 8, probe_len: int = 128, probe_tokens: int = 32, n_pd: int = 4,
               pd_len: int = 512, ready_s: float = POOL_READY_S, settle_s: float = 120.0,
               running_target: float = 16.0) -> dict:
    """The pool phase: the port's ``PoolController`` (HPA) over engine
    replicas it launches as processes, behind the port's router; a burst
    replayed open loop, the scale back, a killed replica healed, a P/D pool
    set, the pool families, and the SLO and P/D gates."""
    import asyncio

    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="llmd-pool-"))
    extra = list(POOL_EXTRA if extra is None else extra)
    if device.type != "cuda":
        extra.append("--cpu")
    try:
        out = asyncio.run(_pool_run(device, card, work, model, extra,
                                    dict(POOL_TRACE, **(trace_kw or {})), n_probe, probe_len,
                                    probe_tokens, n_pd, pd_len, ready_s, settle_s,
                                    running_target))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["gates"] = gates = _pool_gates()
    log(f"pool: gates slo_check rc {gates['slo_check']['rc']} "
        f"({gates['slo_check']['seconds']:.1f} s), pd_check rc {gates['pd_check']['rc']} "
        f"({gates['pd_check']['seconds']:.1f} s), on the host of {card}")
    out["seconds"] = time.perf_counter() - t0
    log(f"pool: phase {out['seconds']:.1f} s on {card}")
    return out


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=None, help="write every phase's details here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    # a run that overstays its limit fails here, every thread's stack on
    # stderr, rather than being stopped from outside with nothing said
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    report: dict = {}
    report["device"] = dev = phase_device()
    card = dev["nvidia_smi"].splitlines()[0] if dev["nvidia_smi"] else dev["kind"]
    report["build"] = phase_build()
    report["check"] = {"paged_attention": check_attention(device), **check_gemms(device),
                       "paged_attention_latent": check_attention(device, latent=True),
                       "mla_decode": check_mla_decode(device)}
    report["time"] = tm = {"paged_attention": time_attention(device), **time_gemms(device),
                           "paged_attention_latent": time_attention(device, latent=True),
                           "mla_decode": time_mla_decode(device)}
    from llmd_tpu_torch.parallel.eplb import EPLBConfig

    moe = dict(model=MOE)
    k1, k2 = {"paged_attention": (1, "all")}, {"ragged_grouped_gemm": (2, "all")}
    _empty()  # the previous phase's engines
    report["engine"] = eng = {
        "llama-1b": phase_engine(device, card, label="dense"),
        "moe_sorted": phase_engine(device, card, **moe, label="sorted",
                                   engine_kw={"moe_dispatch": "sorted"}, per_layer=k1 | k2),
        "moe_einsum": phase_engine(device, card, **moe, n_requests=4, label="einsum",
                                   engine_kw={"moe_dispatch": "einsum"},
                                   per_layer=k1 | {"grouped_gemm": (2, "all")}),
        "moe_eplb": phase_engine(device, card, **moe, n_requests=4, label="sorted+eplb",
                                 engine_kw={"moe_dispatch": "sorted", "eplb": EPLBConfig(
                                     window_size=8, step_interval=2,
                                     num_redundant_experts=32)},
                                 per_layer=k1 | k2),
        # MLA: K1's latent instance in the unified program, K3 in the decode one
        "mla_sorted": phase_engine(device, card, model=MLA, label="mla sorted",
                                   engine_kw={"moe_dispatch": "sorted"},
                                   per_layer={"paged_attention": (1, "unified"),
                                              "mla_decode": (1, "decode"), **k2}),
    }
    eplb_kw = {"moe_dispatch": "sorted", "eplb": EPLBConfig(
        window_size=8, step_interval=2, num_redundant_experts=32)}
    _empty()  # the previous phase's engines
    report["graph"] = {
        "llama-1b": phase_graph(device, card, label="dense"),
        "moe_sorted": phase_graph(device, card, **moe, label="sorted",
                                  engine_kw={"moe_dispatch": "sorted"}),
        "moe_einsum": phase_graph(device, card, **moe, n_requests=4, label="einsum",
                                  engine_kw={"moe_dispatch": "einsum"}),
        "moe_eplb": phase_graph(device, card, **moe, n_requests=4, label="sorted+eplb",
                                engine_kw=eplb_kw),
        "mla_sorted": phase_graph(device, card, model=MLA, label="mla sorted",
                                  engine_kw={"moe_dispatch": "sorted"}),
    }
    # the metric families add no launch call to the replayed decode program:
    # one graph launch and two RNG-state fills a call, as before them
    dense = report["graph"]["llama-1b"]["profile_graph"]
    if dense["host_launch_calls_per_iteration"] != 3 / dense["decode_steps"]:
        raise AssertionError(f"graph: llama-1b replayed makes "
                             f"{dense['host_launch_calls_per_iteration']} host launch calls "
                             f"an iteration, expected {3 / dense['decode_steps']}")
    _empty()  # the previous phase's engines
    report["surface"] = surface = phase_surface(device, card)
    _empty()  # the previous phase's engines
    report["spec"] = spec = phase_spec(device, card)
    _empty()  # the previous phase's engines
    report["structured"] = phase_structured(device, card)
    if report["graph"]["moe_eplb"]["graph_eplb_rebalances"] < 2:
        raise AssertionError("graph: EPLB re-placed its experts fewer than twice")
    for run in ("moe_sorted", "mla_sorted"):
        if eng[run]["moe_dropped_tokens"] != 0:
            raise AssertionError(f"engine {run}: the sorted dispatch dropped routed copies")
    if eng["moe_eplb"]["eplb_rebalances"] < 2:
        raise AssertionError(f"engine: EPLB re-placed its experts "
                             f"{eng['moe_eplb']['eplb_rebalances']} times, expected >= 2")
    _empty()  # the previous phase's engines
    report["forward"] = {
        "llama-1b": phase_forward_check(device),
        "moe_sorted": phase_forward_check(device, MOE, moe_dispatch="sorted"),
        "moe_einsum": phase_forward_check(device, MOE, moe_dispatch="einsum"),
        "mla_sorted": phase_forward_check(device, MLA, moe_dispatch="sorted"),
    }
    _empty()  # the previous phase's engines
    report["int8"] = {
        "llama-1b": phase_int8(device, card, label="dense"),
        "moe_sorted": phase_int8(device, card, model=MOE, label="sorted",
                                 engine_kw={"moe_dispatch": "sorted"}),
        "moe_einsum": phase_int8(device, card, model=MOE, n_requests=4, label="einsum",
                                 engine_kw={"moe_dispatch": "einsum"}),
        "mla_sorted": phase_int8(device, card, model=MLA, label="mla sorted",
                                 engine_kw={"moe_dispatch": "sorted"}),
    }
    _empty()  # the previous phase's engines
    report["loader"] = phase_loader(device, card)
    _empty()  # the previous phase's engines
    report["bench"] = {"int8": phase_bench(device, card, []),
                       "bf16": phase_bench(device, card, ["--quantize", "none"]),
                       "bf16_spec_echo": phase_bench(device, card, [
                           "--quantize", "none", "--spec-mode", "ngram", "--workload", "echo"]),
                       "bf16_json": phase_bench(device, card, [
                           "--quantize", "none", "--workload", "json"])}
    _empty()  # the previous phase's engines
    report["fp8"] = fp8 = phase_fp8(device, card)
    _empty()  # the previous phase's engines
    report["kvplane"] = kv = phase_kvplane(device, card)
    _empty()  # the previous phase's engines
    report["lora"] = lora = phase_lora(device, card)
    _empty()  # the previous phase's engines
    report["vision"] = vision = phase_vision(device, card)
    _empty()  # the previous phase's engines
    report["obs"] = obs = phase_obs(device, card, time_report=tm["paged_attention"])
    _empty()  # the previous phase's engines
    report["launch"] = launch = phase_launch(device, card)
    _empty()  # the previous phase's engines
    report["mesh"] = mesh = phase_mesh(device, card, tm)
    _empty()  # the previous phase's engines
    report["router"] = router = phase_router(device, card)
    _empty()  # the previous phase's engines
    report["latency"] = latency = phase_latency(device, card)
    _empty()  # the previous phase's engines
    report["gateway"] = gateway = phase_gateway(device, card)
    _empty()  # the previous phase's engines
    report["batch"] = batch = phase_batch(device, card)
    _empty()  # the previous phase's engines
    report["tools"] = tools = phase_tools(device, card)
    _empty()  # the previous phase's engines
    report["pool"] = pool = phase_pool(device, card)
    report["seconds"] = time.perf_counter() - t_start
    log(f"smoke: all phases {report['seconds']:.1f} s (vision {vision['seconds']:.1f} s, "
        f"obs {obs['seconds']:.1f} s, launch {launch['seconds']:.1f} s, "
        f"mesh {mesh['seconds']:.1f} s, router {router['seconds']:.1f} s, "
        f"latency {latency['seconds']:.1f} s, gateway {gateway['seconds']:.1f} s, "
        f"batch {batch['seconds']:.1f} s, tools {tools['seconds']:.1f} s, "
        f"pool {pool['seconds']:.1f} s)")
    if args.report:
        out = Path(args.report)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))

    def bf16_err(rows: dict) -> float:
        return max(v["max_abs_err"] for k, v in rows.items() if k.endswith("bfloat16"))

    def entry(name, source, replaces, launches, t, prefill=None):
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, "max_abs_err": bf16_err(report["check"][name]),
             "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if prefill is not None:  # grouped GEMMs: ms etc. at decode, these at prefill (wi)
            e.update(prefill_ms=prefill["ms"], prefill_bound_ms=prefill["bound_ms"],
                     prefill_library_ms=prefill["library_ms"], instance=t["instance"])
        return e

    k1 = tm["paged_attention"]  # ms etc. at decode B=64; these at decode B=8 and mixed
    k1_more = {"instance": k1["decode"]["instance"], "simt_ms": k1["decode"]["simt_ms"],
               "decode_b8_ms": k1["decode_b8"]["ms"],
               "decode_b8_bound_ms": k1["decode_b8"]["bound_ms"],
               "decode_b8_library_ms": k1["decode_b8"]["library_ms"],
               "decode_b8_simt_ms": k1["decode_b8"]["simt_ms"],
               "mixed_ms": k1["mixed"]["ms"], "mixed_bound_ms": k1["mixed"]["bound_ms"],
               "mixed_library_ms": k1["mixed"]["library_ms"],
               "mixed_simt_ms": k1["mixed"]["simt_ms"],
               "verify_ms": k1["verify"]["ms"], "verify_bound_ms": k1["verify"]["bound_ms"],
               "verify_library_ms": k1["verify"]["library_ms"],
               "verify_simt_ms": k1["verify"]["simt_ms"],
               "verify_launches": spec["llama-1b_bfloat16"]["verify_launches"]["paged_attention"]}

    lat, k3 = tm["paged_attention_latent"]["mixed"], tm["mla_decode"]
    k3_more = {"instance": k3["decode"]["instance"], "simt_ms": k3["decode"]["simt_ms"],
               "decode_b8_ms": k3["decode_b8"]["ms"],
               "decode_b8_bound_ms": k3["decode_b8"]["bound_ms"],
               "decode_b8_library_ms": k3["decode_b8"]["library_ms"],
               "decode_b8_simt_ms": k3["decode_b8"]["simt_ms"]}

    def mesh_keys(name: str) -> dict:  # one rank's shapes under the mesh
        return {f"mesh_{label}_{k}": row[k] for label, row in mesh["time"][name].items()
                for k in ("ms", "bound_ms", "unsharded_ms", "library_ms")}

    gemm_src = "llmd_tpu_torch/csrc/grouped_gemm.cu"
    attn_src = "llmd_tpu_torch/csrc/paged_attention.cu"
    kernels = {"kernels": [
        entry("paged_attention", attn_src, "llmd_tpu/ops/paged_attention.py:106",
              eng["llama-1b"]["launches"]["paged_attention"], k1["decode"]) | k1_more
        | {f"bench_{q}_launches": report["bench"][q]["kernel_launches"]["paged_attention"]["mma"]
           for q in ("int8", "bf16", "bf16_spec_echo", "bf16_json")}
        | {"surface_launches": surface["launches"]["paged_attention"],
           "kvplane_launches": kv["pd_f32"]["d_launches"]["paged_attention"],
           "kvplane_offload_launches": kv["offload"]["k1_launches"],
           "lora_launches": lora["f32"]["launches"]["paged_attention"],
           "lora_embed_launches": lora["server"]["embed_k1_launches"],
           "vision_launches": vision["combined_float32"]["launches"]["paged_attention"],
           "vision_bf16_launches": vision["combined_bfloat16"]["launches"]["paged_attention"],
           "vision_epd_pd_d_launches": vision["epd_pd"]["d_launches"]["paged_attention"],
           "obs_launches": obs["main"]["launches"],
           "obs_probe_launches": obs["main"]["probe_launches"],
           "launch_launches": launch["tuned_engines"]["launches_by_instance"]
           ["paged_attention"]["mma"],
           "tuned_plan": launch["tuned_k1"]["plan"],
           "router_launches": router["f32"]["launches"]["paged_attention"],
           "latency_launches": latency["f32"]["launches"]["paged_attention"]}
        | mesh_keys("paged_attention"),
        # the unified program's absorbed MLA attention, XLA in the reference
        entry("paged_attention_latent", attn_src, "llmd_tpu/models/transformer.py:428",
              eng["mla_sorted"]["launches"]["paged_attention"], lat)
        | {"instance": lat["instance"], "simt_ms": lat["simt_ms"],
           "kvplane_launches": kv["pd_mla"]["p_launches"]["paged_attention"],
           "launch_launches": launch["modes"]["mla"]["kernel_mode_launches"]
           ["paged_attention"]} | mesh_keys("paged_attention_latent"),
        entry("mla_decode", "llmd_tpu_torch/csrc/mla_decode.cu",
              "llmd_tpu/ops/mla_decode.py:110", eng["mla_sorted"]["launches"]["mla_decode"],
              k3["decode"]) | k3_more
        | {"kvplane_launches": kv["pd_mla"]["d_launches"]["mla_decode"],
           "obs_launches": obs["mla"]["launches"]["mla_decode"],
           "obs_probe_launches": obs["mla"]["probe_launches"],
           "launch_launches": launch["modes"]["mla"]["kernel_mode_launches"]["mla_decode"]}
        | mesh_keys("mla_decode"),
        entry("ragged_grouped_gemm", gemm_src, "llmd_tpu/ops/grouped_gemm.py:98",
              eng["moe_sorted"]["launches"]["ragged_grouped_gemm"],
              tm["ragged_grouped_gemm"]["decode"], tm["ragged_grouped_gemm"]["prefill"])
        | {"lora_launches": lora["moe"]["launches"]["ragged_grouped_gemm"],
           "obs_launches": obs["moe"]["launches"]["ragged_grouped_gemm"],
           "obs_probe_launches": 2 * obs["moe"]["probe_launches"],
           "launch_launches": launch["modes"]["moe"]["kernel_mode_launches"]
           ["ragged_grouped_gemm"]} | mesh_keys("ragged_grouped_gemm"),
        entry("grouped_gemm", gemm_src, "llmd_tpu/ops/grouped_gemm.py:43",
              eng["moe_einsum"]["launches"]["grouped_gemm"], tm["grouped_gemm"]["decode"],
              tm["grouped_gemm"]["prefill"])
        | {"launch_launches": launch["modes"]["moe_einsum"]["kernel_mode_launches"]
           ["grouped_gemm"]} | mesh_keys("grouped_gemm"),
        # the fp8 pool variants (mma_fp8): ms etc. at the first shape, the rest beside
        *(fp8_entry(fp8, name, src, replaces, run, first)
          for name, src, replaces, run, first in (
              ("paged_attention", attn_src, "llmd_tpu/ops/paged_attention.py:106",
               "llama-1b", "decode"),
              ("paged_attention_latent", attn_src, "llmd_tpu/models/transformer.py:428",
               "mla_sorted", "mixed"),
              ("mla_decode", "llmd_tpu_torch/csrc/mla_decode.cu",
               "llmd_tpu/ops/mla_decode.py:110", "mla_sorted", "decode"))),
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
