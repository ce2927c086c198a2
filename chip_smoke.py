#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mythril_tpu_torch) on one card.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card
    python3 chip_smoke.py --headline   # only the two headline analyses
    python3 chip_smoke.py --sat-shard  # only the build and phase 22a
    python3 chip_smoke.py --load       # only the build and phase 20m

It builds the hand-written kernels (K1-K13, eleven sources) from the
checkout's sources, holds each against its plain PyTorch version on the
card, then drives the port's main device path, the frontier's drain loop
(`DeviceFrontier.run` around `symstep.run_chunk`, one CUDA graph a
chunk), at the frontier's default geometry until the tree is drained:
with telemetry and state merging off (phases 8-9), in the default
configuration with both on (phases 12-13), sharded into 4 logical shards
with work stealing (phase 18) and at 2048 lanes (phase 19); then the
device SAT lane (`device_solver.solve_cnf_device` and
`solve_cnf_device_batch` on K11) on captured analysis queries at full
width (phases 21-22), after the port's SMT façade and its own CDCL have
decided the same queries on the host (phase 20a), its host engine has
explored two contracts and held K1 and K2 to its interpreter (phase 20b),
its `analyze` CLI has analyzed three contracts end to end with
--engine host (phase 20c) and four with --engine tpu on the card (phase
20d), four more with the device SAT lane deciding the solver's queries on
K11 (--solver jax, phase 20e), and a killed analysis and a device drive
have resumed from their checkpoints (phase 20f), and six contracts have
been analyzed as one fleet in shared device phases, sharded with K12's
steal passes too (phase 20g), and two analyses have written the metric
snapshot and trace that the JAX package's CLI writes (phase 20h), the
gas superoptimizer has proved its rewrites on K11 (phase 20i), and the
port's daemon has answered analyze requests on the card, cold, warm, as a
fleet and through its worker pool (phase 20j), and its CLI has analyzed a
contract read from a stub JSON-RPC chain with its storage faulted in from
the chain (phase 20k) and a Solidity file and a foundry project through a
stub solc (phase 20l), and the daemon has answered an open-loop load,
uncontended and then past its capacity (phase 20m).
Every phase prints one JSON line; any mismatch raises, and the run exits
non-zero. Each frontier* phase drives its
configuration once more with every summary the loop reads (K5 and its
copy to the host) held word for word to the twin on the same tensors
(`summaries_checked`). Phases:

  1. the card's name and power limit (nvidia-smi);
 1a. static_tables, on the host: the port's static analysis
     (`frontier.static_tables` over staticanalysis/) on branchy(12),
     mem_branchy(8), the fleet pair, the KILLBILLY and BECTOKEN
     dispatchers (tools/measure_headline.py), a loop beside joins and 40
     diamonds past the tag and window caps: the number of tags,
     merge pcs and window rows and a digest of the tables, held to the JAX
     static analysis's (constants here), the cold build (a fresh
     Disassembly: CFA, absint and taint) and the memoized lookup;
  2. K1 keccak (its standalone form) vs `keccak256_reference`: 4096
     random messages of 0..512 bytes, and the SHA3 shape of the main path
     (128 rows of a 4096-byte memory, ranges clipped at msize); at both,
     the wrapper's messages a warp timed in turn with one and 32;
  3. K2 evm_step after K1's step form (a warp a lane each) vs
     `step_reference`: bench.py's concrete loop at 512 lanes for 256 steps
     and a program reaching every expensive family at 128 lanes, every leaf
     compared after each chunk of 32 steps, and its first chunk at 2048
     lanes; the device time a step of K1's step form and of K2 at 128 and
     2048 lanes (on that program, and K1's on bench.py's loop, where no
     lane hashes), each launched once a step and sha_prep never, their
     grids as the launches recorded them and ptxas's registers and spills
     (K1's numbers go to its kernels record);
  4. K3 arena_alloc vs its twins: a random want-mask sequence up to and
     past capacity, then the main path's standalone launch (one host-term
     leaf, `Frontier._alloc_host_term`) on a default-size arena, fresh, at
     its last free row and full; that launch is the one timed;
  5. K4 (K3's step allocations folded in) with K1-K2 vs the twins on
     contracts that walk the symbolic planes
     (memory round trips, symbolic SSTORE, a cold SLOAD pause, a concrete
     SHA3, escapes on dirty memory) for 2 chunks at the default geometry;
  6. the slice: `assemble(dispatcher({"stress()": branchy(12)}))` at 128
     lanes, chunk 64, `build_batch` defaults, 64 conds, the default arena,
     3072 stack and 1024 escape rows, one RUNNING lane with symbolic env.
     The first 8 chunks run twice, through the kernels and through the plain
     twins on the card, and every leaf is compared. The escape buffer is
     drained (K6 `reset_esc`) after each chunk; the totals must equal the
     JAX reference's (computed once with mythril_tpu on the CPU);
  7. frontier_programs: K5-K8 vs their twins on the same contract two
     chunks in (1024 escape rows, 680+ of them live): the summary, the
     drain's maxima and pack at its real index and quantized widths, the
     escape reset (K6's grids as the launches recorded them, the maxima
     over more than one block, its device time by launch and its plan
     lookup), a gather and a scatter of 32 lanes (and with clamped
     indices and dropped pads; K7's grid of row copy items), the cold-SLOAD
     service's flat gather and scatter of 1, 2 and 3 rows (the index padded
     to a power of two with its first lane, the pad rows scattered to the
     drop index 128), the arena delta
     of the first drain (K8 into the pinned staging: the whole refresh
     into an emptied mirror timed from the launch to the mirror landed,
     beside seven narrow + copy_ into pinned memory and the card's
     device-to-pinned copy rate, its bound; one refresh profiled: one
     launch, no memcpy, no device allocation); each timed beside its twin
     and, where one exists, the PyTorch call that computes the same
     function; K5's grid as its
     launch recorded it (more than one block at 1024 escape rows, or the
     phase fails) and its device time by launch (the grid, the one-block
     combine); the drain loop's read of the summary (a pageable .cpu())
     timed in turn with a copy into a pinned buffer waited on by an event;
     the plan lookups of K5 and of the chunk graph (key against last call);
  8. frontier: `DeviceFrontier(128).run` on the same contract at the
     default budgets until the tree drains (K1-K6 and K8 on the main path);
     its counters and the sha256 digests of its deferred row blocks and of
     its arena mirror must equal the JAX `_Frontier`'s (and one K8 plan
     must serve every refresh of its mirror); each chunk's host time split
     by call (the chunk's enqueue, the steal pass, the summary
     with its read, the decode, the drain, the rest; every frontier* phase
     prints the means);
  9. frontier_spill: 16 lanes, 32 stack rows, branchy(10): the deadlock
     spill and the host reseed (K7) run on the card, checked the same way;
     phases 7-9 run with telemetry and merging off, as the JAX references
     they are held to;
 10. telemetry: K4 with the telemetry plane armed (K9: tag pcs, fleet
     slots) vs the twins on the planes contracts for 2 chunks, every leaf
     and counter, and K5's telemetry tail; K9's device cost per step and
     by launch (each of K4's functions, its TEL instantiation against its
     plain one) at 128 lanes and at 2048 (a chunk into 256 branchy(12)
     seeds), eager; ptxas's registers and spills of both instantiations
     side by side; no global atomic in the TEL instantiation of a launch
     over lanes (cuobjdump's SASS); phases 12 and 19 add K9 by launch in
     their graphed drives (against phase 8's and a telemetry-off drive at
     2048 lanes);
 11. merge_kernel: K10 (K3's allocations folded in), one host call a
     pass, vs `merge_pass_reference` on the states the
     default-configuration frontier hands its merge passes: branchy(12)
     (strict rounds) and mem_branchy(8) with its window table (widened
     rounds), on the tables the frontier built for itself (held to the JAX
     static analysis's); every leaf, the arena and the stats; K10's time per strict
     and per widened pass, by launch, and its standalone K3 calls (none);
 12. frontier_default: `DeviceFrontier(128)` on branchy(12) with telemetry
     and merging on, held to the JAX `_Frontier`'s counters, merges,
     digests and final telemetry words, and the tables it built for itself
     to the JAX analysis's (empty: branchy(12) has no joins); its wall time and idle share beside
     phase 8's;
 13. frontier_merge: the same on mem_branchy(8), on the tag and window
     tables the frontier builds for itself, held to those the JAX static
     analysis builds (constants here);
 14. graph_chunk: `run_chunk`'s CUDA graph vs eager `sym_step` calls from
     the same state (branchy(12), 3 chunks): telemetry and merging off, on
     (a merge pass between chunks), and on with 4 shards; every leaf after
     each chunk; a state rebound to copies must recapture;
 15. wide_lanes: K4 and K10 at 2048 lanes vs the twins: one graphed chunk
     from 256 branchy(12) seeds at D = 1 and D = 2, then one merge pass
     (the pairing sort above 1024 lanes); K4's device time a step there;
 16. shard_step: K4 and K5 with a 4-shard scheduler (vector tops,
     segment-local ranks; 768 stack and 256 escape rows a segment) vs the
     twins, the planes contracts and branchy(12) one per lane block,
     telemetry armed, 2 chunks, every leaf and the summary's shard block;
 17. steal_kernel: K12 vs `steal_pass_reference` at the same geometry
     (random pool rows, max_rows 32): a forced imbalance, gaps below the
     threshold, tied loads, receivers with less room than half the gap,
     and the sharded frontier's first pass; every pool leaf and counter;
     one pass under `torch.cuda.set_sync_debug_mode("error")`; its time
     beside the twin, the bound and index_select + index_copy_ per leaf;
     the plan's and the move's grids as the launches recorded them (the
     moves on a (row slot, copy item) grid);
 18. frontier_shard: `DeviceFrontier(128, n_shards=4)` in the default
     configuration with the default steal knobs on branchy(12) from one
     seed (every path starts in shard 0), held to the JAX `_Frontier`'s
     counters, steal counters, digests and telemetry words; wall, idle
     share, K12 launches and K4's device time per step beside phase 12's;
     then a fleet of branchy(12) and mem_branchy(8) owned by shards 0 and
     2 with fleet slots, on the tables the frontier builds for both codes
     (held to the JAX analysis's), held the same way;
 19. frontier_wide: `DeviceFrontier(2048)` in the default configuration on
     branchy(12) until the tree drains, held to the JAX
     `_Frontier(n_lanes=2048)`'s counters, digests and telemetry words,
     and once more profiled (K1's and K2's device time a step);
 20. sat_kernel: K11, one CUDA graph a chunk and eager, vs
     `run_chunk_reference`, every leaf after each chunk, on fixtures
     (opposite-phase races in one tile and across two, the no-flip
     backtrack, 32 forced probes, the batch runner's freeze; at the card's
     variable tile and at 64 vars a block) and at full width (32 probes,
     V1 65,536) on a captured query of each tile bucket (64 and 256): 64
     steps compared, then K11's time per step by launch (device time,
     launches, blocks) beside the twin's and the bound;
20a. host_solver, on the host: the port's SMT façade and its own CDCL
     (mythril_tpu_torch/native/cdcl.cpp, built here with g++; the build's
     seconds): every EXPECTED_SAT query parsed with from_smt2 and decided
     by `Solver().check()` through the incremental pipeline, and its
     one-shot CNF (lower_constraints -> Blaster -> `sat.solve_cnf`), both
     held to the CDCL verdicts, every SAT model to each parsed constraint
     (`Model.eval`) or to every clause and lowered constraint; then
     `get_model` minimizing 1540-2's gas, held to the JAX package's
     optimum, and a second `get_model` answered from the ModelCache without
     a solver query; the seconds per query (parse, check, one-shot). Phases
     21 and 22 hold every verdict K11 decides to the façade's too;
20b. host_engine, on the host and then the card: the port's
     `LaserEVM(engine="host")` explores KILLBILLY (2 transactions) and
     branchy(8) (1 transaction) in dispatchers, in creation and runtime
     mode, each run's states, nodes, edges and open states after each
     transaction held to EXPECTED_HOST_ENGINE (the JAX package's LaserEVM);
     its seconds, states a second, solver queries and their seconds; that
     this Python has ripemd160 (precompile 3), or the run fails. Then the
     mixed program at 128 lanes through `lockstep.step_many` on the card
     (K1's step form and K2): every lane that does not escape ends with the
     storage and transient storage that the host interpreter's concrete
     message call of the same lane leaves (core/transaction/concolic.py,
     GAS bound to the lower-bound gas the host accounts);
20c. analyze, on the host: the port's CLI in a subprocess (`python -m
     mythril_tpu_torch -v 4 analyze -c <creation code> -o json`, the
     default --engine host with the CDCL) on KILLBILLY with all modules
     at 2 transactions, SAFE_KILL and the tx.origin contract, each exit
     code and issue (SWC id, title, address) held to EXPECTED_ANALYZE
     (the JAX package's CLI); a line a run with its exit code, host wall
     seconds, explored states, states a host second and solver queries
     and their seconds (the host's clock: the card runs none of it).
     `--headline` runs only tools/measure_headline.py's KILLBILLY (3
     transactions, AccidentallyKillable) and BECTOKEN (4,
     IntegerArithmetics) the same way, side by side, held to SWC-106 and
     SWC-101 unless a run reports itself incomplete at its budget: they
     are solver-bound and take tens of minutes;
20d. analyze_tpu, on the card: the port's CLI with `--engine tpu`
     (`cli.main` in this process, so its launches count; the default
     configuration: 128 lanes, telemetry and merging on, the CDCL, bfs) on
     the three ANALYZE_RUNS, KILLBILLY's runtime code (`--bin-runtime`:
     a symbolic storage base, so SLOADs pause and fault in: standalone K3
     a symbolic leaf, K7's gather and scatter a service) and SPIN, whose
     counting loop outlasts the device's step budget (the hand-over
     materializes its live lane through K6 and defers the rest), each exit
     code, issue and per-transaction frontier counters held to
     EXPECTED_ANALYZE_TPU (the JAX package's CLI with --engine tpu); a line
     a run with its host wall seconds, explored states, solver queries
     and seconds, its launches and, per transaction, the frontier's
     forks, fault-ins, rows materialized and deferred, lane-steps, chunks
     and its device and host phases' seconds. It fails unless it
     launched standalone K3 and K7 and handed a live lane over;
20e. analyze_jax, on the card: 20d's runs but SPIN with `--solver jax
     --device-crosscheck 1` (the batch dispatch, smt/solver/dispatch.py,
     onto `solve_cnf_device(_batch)` and K11 at the lane's defaults: 32
     probes, chunk 256; every device verdict re-decided on the host
     CDCL), each exit code and issue held to EXPECTED_ANALYZE_TPU (the
     solver changes no verdict), then KILLBILLY's runtime code once more
     with escape-time pruning (`frontier.configure(check_escapes=True)`),
     whose slab queues its rows' feasibility queries on the dispatch; a
     line a run with 20d's fields and the lane's counters: queries
     submitted, flushes and their mean occupancy, cache and dedup hits,
     verdicts decided on the card and left UNKNOWN (the CDCL decides
     those), cross-checks, K11 launches and graph captures, and the
     seconds in flushes against the rest of the solver's. It fails on a
     classified device failure, a divergence, a breaker that left CLOSED,
     or when K11 never launched or decided nothing;
20f. resume_tpu, each analysis in this process: (a) `analyze --engine tpu
     --checkpoint P` on KILLBILLY (2 transactions), a save every 5 popped
     host states, killed at the 10th by `--inject-fault host_crash:10`
     (mid-way through the second transaction's host continuation, after a
     periodic save); `--resume P` must give EXPECTED_ANALYZE_TPU's exit
     and issues; (c) LATE_GUARD's runtime code (a cold SLOAD's host-term
     leaf guarding a kill 1,200 steps later), its device phase killed
     right after the first periodic save, which holds the leaf; `--resume
     P` loads `P.device.npz` in `Frontier.run` (host terms unpickled,
     contract ids and transaction checked, the host mirror rebuilt from
     row 0 through K8) and must give the uninterrupted run's report; (b)
     SPIN's device drive (128 lanes, the escape buffer drained every
     chunk) saved to its .npz after 16 chunks, loaded into a fresh
     DeviceFrontier (seeded, then `load_checkpoint`) and continued: after
     16 more chunks its state, planes and arena are bit for bit the
     uninterrupted drive's after 32, and its first chunk is a new graph
     capture;
20g. analyze_fleet, each analysis in this process: FLEET_CORPUS (the three
     ANALYZE_RUNS contracts and tests/test_fleet.py's three, one hex file
     each, FLEET_MODULES, one transaction) through the port's CLI with
     --engine tpu one contract a run, then all six with --fleet at 128
     lanes (`parallel/fleet.py`: one frontier a transaction for every
     member), then the same fleet under FLEET_SHARDED (4 shards, a steal
     pass every chunk, the narrowest fleet and 8-step chunks): each
     member's exit and issues held to its sequential run and, with the
     driver's phases, lane-steps, forks, each member's lane-steps and the
     steal passes and rows moved, to EXPECTED_ANALYZE_FLEET (the JAX
     fleet's); it fails unless the sharded run launched K12 and moved
     rows. Then a FleetDriver over the corpus with FLEET_PREEMPTED's
     preempt event set: its report incomplete with the JAX member's
     dropped states, the others complete. A line a run: host walls (the
     fleet's beside the sum of the sequential runs'), the counters and
     their share a phase, the device phases' seconds, K12 launches;
20h. observe_tpu, each analysis in this process: the port's metric
     registry, span tracer and exporter (mythril_tpu_torch/observe/) on
     the paths above. (a) KILLBILLY in 20d's configuration with
     --metrics-out and --trace-out: exit and issues held to
     EXPECTED_ANALYZE_TPU, the snapshot's frontier counters (chunks,
     lane-steps, forks, cold-SLOAD fault-ins) to the run's own
     per-transaction frontier lines, both files read by `python -m
     tools.traceview` and `python -m tools.frontierview` with exit 0, and
     `export.collect_device_memory()`'s HBM gauges non-zero; (b)
     OBSERVE_CONTRACT at 8-step chunks, its snapshot (but for clock
     readings, TIME_VALUED) held to EXPECTED_OBSERVE (the JAX CLI's);
     (c) (a)'s span rollup (host seconds by category and by span name)
     and the publish calls' host microseconds on (a)'s last summary,
     tracer off and on, beside (a)'s host milliseconds a chunk;
20i. optimize_jax, each run in this process: the port's `optimize
     --crosscheck 1` (superopt/, `cli.main`) on OPTIMIZE_CODES
     (tests/test_superopt.py's SYNTHETIC, the KILLBILLY and BECTOKEN
     dispatchers and bench.py's superopt contract at 12 blocks, copies
     here) under `--solver jax`, whose real queries go through one
     dispatch flush onto K11 (the CDCL decides what the card leaves
     UNKNOWN), then under `--solver cdcl` on the host: each report but
     its wall held to EXPECTED_OPTIMIZE (the JAX package's); a line a run
     with its host wall, rewrites, queries, proofs by route, flushes and
     their occupancy, device-decided and UNKNOWN verdicts, crosschecks,
     divergences, K11 launches and graph captures. It fails if K11 never
     launched from the optimizer, if one of the 12-block code's 12 proofs
     is not the device's, on a divergence or a breaker off CLOSED, or if
     a cdcl run launched a kernel;
20j. serve_tpu: the port's daemon (`python -m mythril_tpu_torch serve
     --socket S --engine tpu`: 128 lanes, telemetry and merging on, K11 at
     32 probes and chunk 256), a subprocess driven through the port's
     client, four times. Cold (warmup over an empty manifest): ping;
     ANALYZE_RUNS' three contracts, each reply's issues held to
     EXPECTED_ANALYZE_TPU, a `metrics` scrape and a `healthz` answered
     while the first holds its grant (the Prometheus exposition with
     `device.hbm.*`); tx_origin under `"solver": "jax"` on K11; a repeat
     answered from the result store; shutdown, exit 0, the manifest
     holding the K11 shape keys it ran. Warm, on that manifest (its result
     store and verdict sidecar removed, so that the request runs): every
     key warmed, none failed; tx_origin under `"solver": "jax"` counts
     bucket reuses and no first run; K11 launches and graph captures in
     the warmup and in the request, the request's wall beside the cold
     one's. Fleet (`--fleet`): FLEET_CORPUS sent at once, issues held to
     EXPECTED_ANALYZE_FLEET, one reply or more batched with another.
     Workers (`--workers 2 --inject-fault worker_segv:2`): three tx_origin
     requests at once, the killed dispatch retried on a fresh worker, one
     death, one restart, nothing quarantined. Each process writes its
     kernel launches at exit (SERVE_RUNNER), and they count on the main
     path; `--serve` runs only the build and this phase;
20k. onchain_tpu, each run in this process: the port's `analyze -a
     ONCHAIN_ADDRESS --rpc 127.0.0.1:PORT --engine tpu -t 1` against
     `ChainStub` (a JSON-RPC chain in a thread serving KILLBILLY's
     runtime code; `-a` in mixed case) at the default configuration,
     with slot 0 = 1 (the kill armed), slot 0 = 0, and `--no-onchain-data`
     (the slot symbolic): exit, issues and frontier counters a
     transaction held to EXPECTED_ONCHAIN and the chain's request log to
     EXPECTED_ONCHAIN_RPC (the JAX CLI's); then `read-storage` (two
     positions, a mapping key) and `disassemble -a`, their output held to
     the JAX CLI's by EXPECTED_ONCHAIN_OUTPUT's digests. A line a run with
     its wall, its seconds and calls of JSON-RPC (an RPC made during a
     CUDA graph capture fails the phase) and K7's gathers and scatters.
     It fails unless the on-chain runs faulted a slot in through K7's
     gather and scatter with at least one `eth_getStorageAt`;
20l. solidity_tpu, each run in this process: a stub `solc` (an executable
     script written to a temporary directory, put first on PATH, which is
     restored after) prints canned standard-JSON for KillBilly.sol (the
     source text beside it, a source map entry an instruction, a small
     AST); `analyze KillBilly.sol --engine tpu -t 2` and `foundry
     --project-root foundry --engine tpu -t 2` (forge's artifact layout)
     held to EXPECTED_SOLIDITY: each issue's SWC id, address and source
     mapping (file, line, code);
20m. serve_load_tpu: tools/torch_loadgen.py's SLO A/B (the JAX
     tools/loadgen.py's profiles: 20 s at 0.6 Hz interactive only, then 30
     s at 4 Hz with three bulk requests in four over 5 contracts, 1
     worker elastic to 2, queue 4, autoscale every 300 ms, up after 2)
     against the port's daemon with `--engine tpu`, started by
     torch_loadgen's launcher under SERVE_RUNNER, then one unloaded
     request of each contract to a daemon with no result store: each
     unloaded reply's result and frontier counters held to EXPECTED_LOAD
     (the JAX daemon's), every answered reply's result to its contract's;
     tools/load_smoke.py's invariants 1, 2, 4 and 5 asserted (no
     interactive shed, a bulk shed, a scale-up to a pool of 2, a
     result-store hit); a line with each class's p50, p95 and p99, the
     interactive p99 beside its bound max(2x, +5 s) of the baseline's
     (measured, not asserted), the sheds and when, scale-ups, store hits,
     each worker's spawn-to-ready time, each engine run's seconds, a fresh
     process's start by step (torch, the worker's modules, the CUDA
     context, the kernel libraries) and the launches of K1, K2, K4, K5,
     K6, K8 and K9; `--load` runs only the build and this phase;
 21. sat_lane: captured queries (tests/data/smt2_corpus.tar.gz, two of
     each bucket) through the port's from_smt2 -> lower_constraints ->
     Blaster -> `solve_cnf_device` with its defaults: CNF sizes (and, where
     the CNF does not depend on the process, its digest) and the state
     after the first two chunks held to the JAX lane (or, for a
     process-dependent CNF, to the twin on the card), decided verdicts to
     CDCL, SAT models to every clause and lowered constraint, 1689-24's
     verdict, chunk count and model to the JAX lane's; steps, verdict,
     wall and host ms per chunk; one solve again under the profiler for
     the card's idle share;
 22. sat_batch: `solve_cnf_device_batch` on four captured queries of one
     bucket (a dispatch flush) at chunk 32, held to the JAX batch runner's
     state after the first chunk, verdicts and models as in phase 21;
 22a. sat_shard: K13, the clause-sharded chunk (`device_solver.configure`,
     `run_chunk_sharded`, `ops.sat_run_sharded`: K11's launches a shard
     with the seal after propagate, the two-bitmap exchange planes copied
     between shards, `sat_shard_combine`; on a one-card mesh one CUDA
     graph replay a chunk, a stream a shard), graphed and eager, against
     `run_chunk_sharded_reference` on the card at D = 2 and 4 logical
     shards on one card: the phase race (D = 4 must give FALSE where the
     unsharded K11 gives TRUE) and 1689-24 and 1689-28 at 32 probes, every
     leaf after every chunk, every shard's replica equal to the state and
     `REPLAYS["sat_shard_chunk"]` one a graphed chunk; both queries solved
     sharded, their verdicts the unsharded K11's; on a host with two cards
     or more the full-width comparison again over distinct cards (else one
     line says that one card was present); the time a step at D = 1, 2
     and 4, graphed and eager (CUDA events and the host clock), its device
     time by launch (seal, combine, copies) and its bound (K11's bytes and
     D + 1 exchange planes of two bits a var, beside the bound with D + 1
     int8 phase planes instead); the plane bytes copied a step;
     the seal's and the combine's device times beside their own bounds
     (this run's bitmaps, flags and keyed vars) and `torch.amax` over the
     stacked int8 phase planes (JAX's pmax) as the combine's yardstick;
     then SAT_SHARD_RUN through the CLI with `--solver jax` on a mesh of
     four logical shards and the clause cap at SAT_SHARD_CAP, so that its
     queries shard through the dispatch: exit and issues held to
     EXPECTED_ANALYZE_TPU, and it fails unless the combine launched;
 23. the kernels line: each kernel's launches on the main-path phases (8, 9,
     12, 13, 18, 19, 20d-20m, 21, 22, 22a; 20g's also on their own; K3's are
     its allocations folded
     into K4's steps and K10's passes and its standalone calls in 20d-20f
     and 20k; K11's from the analyzer, 20e, and from the optimizer, 20i,
     also on their own; the serving tier's, 20j and 20m, and the on-chain and
     Solidity inputs', 20k and 20l, on their own too), its
     time, its plain version's time, the least time the card could take
     and the library call's time (K11's per step).

The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits 2 and prints no result."""

from __future__ import annotations

import contextlib
import hashlib
import io
import itertools
import json
import logging
import os
import random
import re
import subprocess
import sys
import tarfile
import time
from unittest import mock

import numpy as np
import torch

from mythril_tpu_torch import native, smt
from mythril_tpu_torch.core import function_managers, node, svm
from mythril_tpu_torch.core.state.world_state import WorldState
from mythril_tpu_torch.core.transaction import concolic, transaction_models
from mythril_tpu_torch.frontends.asm import (assemble, creation_wrapper,
                                             dispatcher, selector)
from mythril_tpu_torch.frontends.disassembler import Disassembly
from mythril_tpu_torch.kernels import build, ops
from mythril_tpu_torch.parallel import arena as A
from mythril_tpu_torch.parallel import batch as B
from mythril_tpu_torch.parallel import (convert, device_solver, frontier,
                                        keccak, lockstep, symstep, words)
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.smtlib import from_smt2
from mythril_tpu_torch.smt.solver import dispatch, preprocess, sat, simplify
from mythril_tpu_torch.smt.solver import solver as smt_solver
from mythril_tpu_torch.smt.solver.bitblast import Blaster
from mythril_tpu_torch.smt.solver.solver_statistics import SolverStatistics
from mythril_tpu_torch.support import model as model_service
from tools.measure_headline import BECTOKEN
from tools.measure_headline import KILLBILLY as HEADLINE_KILLBILLY

# ---- the frontier's default geometry (mythril_tpu/parallel/frontier.py) ---------
LANES = 128          # DEFAULT_LANES (MYTHRIL_TPU_LANES)
CHUNK = 64           # CHUNK
MAX_CONDS = 64       # MAX_CONDS
STACK_ROWS = 24 * LANES   # _new_sched: min(1<<17, 24 * lanes, budget)
ESC_ROWS = 8 * LANES      # _new_sched: min(1<<16, 8 * lanes, budget)
N_BRANCHES = 12
COMPARE_CHUNKS = 8
TIMING_CHUNK = 2      # the per-kernel timing replays this chunk
MAX_CHUNKS = 200

#: the JAX reference drain of the same contract at the same geometry
#: (mythril_tpu.parallel.symstep.run_chunk on the CPU, escape count zeroed
#: after each chunk): one escape per path (2^12) plus the dispatcher's
#: fallback STOP
EXPECTED = {"escapes": 4097, "forks": 4096, "pushes": 3968, "pops": 3968,
            "executed": 36868, "arena_n": 12291, "n_const": 4097}

#: the JAX reference of the drain loop at the frontier's default budgets and
#: of the reduced-pool run: `mythril_tpu.parallel.frontier._Frontier(
#: laser_evm=None, n_lanes=...)` on the CPU with `telemetry_enabled` and
#: `state_merge` set False on the instance (and `stack_bytes` = 32 rows x
#: 39306 bytes for the spill run), `run(state, planes)` on the lanes
#: `DeviceFrontier.seed` makes from one seed (code, {}, False, 10**7, 0).
#: Chunks, drains and frozen lanes are counted by wrapping
#: `symstep.run_chunk`, `_fetch_escapes` and `_defer_lanes`; the digests are
#: `frontier.deferred_digest(_Frontier.deferred)` and
#: `frontier.mirror_digest(_Frontier.harena)`.
#: tests/test_torch_frontier_constants.py recomputes both with JAX and
#: checks them.
EXPECTED_FRONTIER = {
    "chunks": 8, "drains": 4, "drained_rows": 3713, "frozen_rows": 384,
    "spilled": 0, "reseeded": 0, "lane_steps": 36868, "forks": 4096,
    "stack_pushes": 3583, "stack_pops": 3583, "deferred_blocks": 7,
    "deferred_rows": 4097, "mirror_n": 12291, "mirror_n_const": 4097,
    "deferred_sha256":
        "44841bb4765ba59781afd31e1292960e791e41ade47e821f4dca49926b9f394d",
    "mirror_sha256":
        "5483260d1d0e0a6acb12f7b4bfacd9f86122f53a4627d0b21e4bc850b9f68da4"}
SPILL_LANES = 16
SPILL_STACK_ROWS = 32
#: branchy(8) never deadlocks at these pools (the JAX run spills nothing);
#: branchy(10) does
SPILL_BRANCHES = 10
EXPECTED_SPILL = {
    "chunks": 9, "drains": 6, "drained_rows": 649, "frozen_rows": 34,
    "spilled": 8, "reseeded": 8, "lane_steps": 5692, "forks": 682,
    "stack_pushes": 338, "stack_pops": 338, "deferred_blocks": 9,
    "deferred_rows": 683, "mirror_n": 2049, "mirror_n_const": 683,
    "deferred_sha256":
        "0c25dae9844a0f01a578c3796f24b5e37fc84bcb8ab24d4b2ff81e0f5d2c87b2",
    "mirror_sha256":
        "215f5550dfb3a0f8dc7073eccfe283295fcb225bf151e1ad5d84a00c0df9e2b2"}

#: the default configuration (telemetry and merging on) on the same
#: contract, and on dispatcher(mem_branchy(8)) with the static tables below:
#: `_Frontier` as above with `telemetry_enabled` and `state_merge` left on,
#: `_collect_tag_pcs` / `_merge_pc_table` returning what the JAX static
#: analysis builds for the contract; merge passes, ITEs, memory blends and
#: refusals summed over the passes' stats vectors, and the final telemetry
#: words (`_Frontier._tel_prev`).
#: tests/test_torch_frontier_constants_merge.py recomputes both.
EXPECTED_DEFAULT = {
    "chunks": 8, "drains": 4, "drained_rows": 3697, "frozen_rows": 384,
    "spilled": 0, "reseeded": 0, "lane_steps": 36788, "forks": 4088,
    "stack_pushes": 3503, "stack_pops": 3503, "deferred_blocks": 7,
    "deferred_rows": 4081, "mirror_n": 12267, "mirror_n_const": 4089,
    "merge_passes": 1, "merges": 8, "merge_ites": 0, "mem_blends": 0,
    "deferred_sha256":
        "a2dd2a8c592b782ab25ceaeac7da6cdb27bd7478f4bfe83ab52564a48120f2cf",
    "mirror_sha256":
        "c220cf2bd2aedee55047622b72ae7c8a77604775969b07d89e66bcec1ed1365a",
    "blocked_by": {"depth": 60, "mem_sym": 0, "memory": 0,
                   "storage_keys": 0, "tstore": 0},
    "telemetry_words": [
        0, 4089, 0, 4088, 0, 1, 0, 12263, 12265, 1, 0, 0, 0, 4081, 0, 3503, 0,
        0, 0, 3697, 18744, 0, 0, 585, 3503, 0, 0, 4081, 0, 0, 0, 0, 0, 0, 0,
        36788, 512, 640, 1024]}
#: the default configuration at 2048 lanes (phase frontier_wide), past the
#: 1024 lanes K4 and K10 once scanned in one block: `_Frontier(laser_evm=
#: None, n_lanes=2048)` as EXPECTED_DEFAULT, at the default geometry and
#: budgets (49,152 stack and 16,384 escape rows, an 8192-row drain batch)
WIDE_LANES = 2048
EXPECTED_WIDE = {
    "chunks": 2, "drains": 1, "drained_rows": 4097, "frozen_rows": 0,
    "spilled": 0, "reseeded": 0, "lane_steps": 36868, "forks": 4096,
    "stack_pushes": 2048, "stack_pops": 2048, "deferred_blocks": 1,
    "deferred_rows": 4097, "mirror_n": 12291, "mirror_n_const": 4097,
    "merge_passes": 0, "merges": 0, "merge_ites": 0, "mem_blends": 0,
    "deferred_sha256":
        "7d4aa16e85ad19debee485f26744513e1fbfd8d4fbe3328f0e83f3ef04a9e6e6",
    "mirror_sha256":
        "225b6740a3833f06b1f5a2df8fed26b1a5b968de757fa9235226bc6c74861f24",
    "blocked_by": {"depth": 0, "mem_sym": 0, "memory": 0,
                   "storage_keys": 0, "tstore": 0},
    "telemetry_words": [
        0, 4097, 0, 4096, 0, 1, 0, 12287, 12289, 1, 0, 0, 0, 4097, 0, 2048, 0,
        0, 0, 4097, 0, 0, 0, 2048, 2048, 0, 0, 4097, 0, 0, 0, 0, 0, 0, 0,
        36868, 128, 2048, 4097]}
MERGE_BRANCHES = 8
EXPECTED_MERGE = {
    "chunks": 2, "drains": 1, "drained_rows": 129, "frozen_rows": 0,
    "spilled": 0, "reseeded": 0, "lane_steps": 2476, "forks": 144,
    "stack_pushes": 0, "stack_pops": 0, "deferred_blocks": 1,
    "deferred_rows": 129, "mirror_n": 229, "mirror_n_const": 34,
    "merge_passes": 1, "merges": 16, "merge_ites": 32, "mem_blends": 16,
    "deferred_sha256":
        "1cfac54a20031f5641d5430ffee6e25cb5193ee7172818ee94eca1a87bf72520",
    "mirror_sha256":
        "90e9fe1ae3f34e16a298fec845094894580de238a35d8bfc54210dfe20ab9165",
    "blocked_by": {"depth": 8, "mem_sym": 0, "memory": 0,
                   "storage_keys": 0, "tstore": 0},
    "telemetry_words": [
        0, 2, 0, 160, 0, 287, 0, 860, 1037, 1, 0, 0, 0, 129, 0, 0, 0, 0, 0,
        129, 0, 0, 0, 144, 0, 0, 0, 129, 0, 0, 0, 0, 0, 0, 0, 2476, 128, 0,
        129, 2, 4, 8, 16, 32, 32, 64, 128]}

#: the JAX static analysis of dispatcher(mem_branchy(8)): its 8 joins (tag
#: and merge-attribution pcs) and the window table (one 32-byte window per
#: join, a row for every pc of the join block up to its first MSTORE)
MEM_BRANCHY_JOINS = [44, 69, 94, 119, 144, 169, 194, 219]
MEM_BRANCHY_MEM_PCS = [44, 45, 48, 49, 52, 69, 70, 73, 74, 77, 94, 95, 98, 99,
                       102, 119, 120, 123, 124, 127, 144, 145, 148, 149, 152,
                       169, 170, 173, 174, 177, 194, 195, 198, 199, 202, 219,
                       220]


#: the sharded frontier (phases shard_step, steal_kernel, frontier_shard):
#: 4 logical shards of 32 lanes, the default steal knobs (a pass every 4
#: chunks, a load gap of 8 at least)
SHARDS = 4
#: the JAX reference of DeviceFrontier(128, n_shards=4) in the default
#: configuration on dispatcher(branchy(12)) from one seed (shard 0's block):
#: `_Frontier(laser_evm=None, n_lanes=128)` with `n_shards = 4` set on the
#: instance, counted as EXPECTED_DEFAULT, plus its steal passes and the
#: shard block's final steal counters.
#: tests/test_torch_frontier_constants_merge.py recomputes it. The run
#: never drains and ends at the step budget (64 chunks): the drain trigger
#: compares the global escape count with the 1024-row drain batch while
#: the escapes fill shard 0's 256-row segment,
#: whose overflow freezes lanes that the host defers a chunk at a time
#: (the JAX frontier does the same).
EXPECTED_SHARD = {
    "chunks": 64, "drains": 0, "drained_rows": 0, "frozen_rows": 2965,
    "spilled": 0, "reseeded": 0, "lane_steps": 34432, "forks": 3844,
    "stack_pushes": 3710, "stack_pops": 3626, "deferred_blocks": 64,
    "deferred_rows": 3845, "mirror_n": 11535, "mirror_n_const": 3845,
    "merge_passes": 0, "merges": 0, "merge_ites": 0, "mem_blends": 0,
    "steal_passes": 16, "steal_rows": 536, "steals_sent": [508, 28, 0, 0],
    "steals_received": [0, 380, 128, 28],
    "deferred_sha256":
        "293e5289e0856ec85479ca919c0a472977687d6b2dd5e43f26654210c5988268",
    "mirror_sha256":
        "b7b3da3f314a2e7ec9fb7ffeb61d13689eb347a50f9b3eb434bcf59ba2419185",
    "blocked_by": {"depth": 0, "mem_sym": 0, "memory": 0,
                   "storage_keys": 0, "tstore": 0},
    "telemetry_words": [
        0, 3845, 0, 3844, 0, 1, 0, 11447, 11533, 1, 0, 0, 0, 3761, 0, 3626, 0, 0,
        0, 796, 163228, 0, 0, 134, 3710, 0, 0, 3761, 0, 0, 0, 0, 0, 0, 0, 34432,
        4096, 271, 796]}
#: the two-member fleet: branchy(12) owned by shard 0 and mem_branchy(8) by
#: shard 2 (`seed_owner_index`), fleet slots [0, 1] named as FLEET_RUN's
#: keys, the tables of the JAX static analysis of both codes
#: (`fleet_tables`), the rest as EXPECTED_SHARD
FLEET_OWNERS = [0, 2]
EXPECTED_FLEET = {
    "chunks": 64, "drains": 0, "drained_rows": 0, "frozen_rows": 3090,
    "spilled": 0, "reseeded": 0, "lane_steps": 36908, "forks": 3988,
    "stack_pushes": 3818, "stack_pops": 3734, "deferred_blocks": 64,
    "deferred_rows": 3974, "mirror_n": 11763, "mirror_n_const": 3879,
    "merge_passes": 3, "merges": 16, "merge_ites": 32, "mem_blends": 16,
    "steal_passes": 16, "steal_rows": 540, "steals_sent": [508, 28, 4, 0],
    "steals_received": [0, 380, 128, 32],
    "deferred_sha256":
        "b4b5a49ff382f294ea2e5344a64e246acd008ee860bdec8605a1553b1b411aec",
    "mirror_sha256":
        "65e6d62c18527f5e1f590aee9df5f36f308124d68063f86626b0b226c872f425",
    "blocked_by": {"depth": 47, "mem_sym": 0, "memory": 0,
                   "storage_keys": 0, "tstore": 0},
    "telemetry_words": [
        0, 3847, 0, 4004, 0, 288, 0, 12307, 12570, 2, 0, 0, 0, 3890, 0, 3734, 0,
        0, 0, 800, 170437, 0, 0, 170, 3818, 0, 0, 3890, 0, 0, 0, 0, 0, 0, 0,
        36908, 4096, 271, 800, 4, 12, 40, 80, 280, 988, 1960, 128, 34432, 2476]}


def mem_branchy_tables() -> dict:
    """DeviceFrontier's table arguments for dispatcher(mem_branchy(8))."""
    names = [f"merge@{pc:#x}" for pc in MEM_BRANCHY_JOINS]
    # diamond i writes bytes [32 i, 32 i + 32); a row's pc lies in the block
    # of the last join at or before it
    windows = [[32 * (sum(join <= pc for join in MEM_BRANCHY_JOINS) - 1)]
               for pc in MEM_BRANCHY_MEM_PCS]
    return {"tag_pcs": list(MEM_BRANCHY_JOINS), "tag_names": names,
            "merge_pcs": list(MEM_BRANCHY_JOINS), "merge_names": list(names),
            "mem_pcs": list(MEM_BRANCHY_MEM_PCS), "mem_words": windows}


# ---- the card's published peaks (H100 SXM data sheet, dense, 700 W) -------------
PEAK_BYTES_PER_S = 3.35e12
#: 32-bit integer work is bounded by the CUDA cores' float32 rate, the
#: highest scalar rate in the data sheet (an optimistic, hence safe, bound)
PEAK_OPS_PER_S = 67e12

#: bench.py's concrete loop (counter += 1 stored to memory until 3,000,000)
BENCH_LOOP = bytes.fromhex(
    "6000" "5b" "6001" "01" "80" "6000" "52"
    "80" "63002dc6c0" "11" "6002" "57" "00")
BENCH_GEOMETRY = dict(stack_slots=16, memory_bytes=64, calldata_bytes=32,
                      retdata_bytes=32, storage_slots=4, tstore_slots=2)

#: every expensive family and memory/storage path: x, y, n from calldata
#: words 0..2 and the SHA3 length from word 3
MIXED_SOURCE = """
PUSH1 0x00
CALLDATALOAD
PUSH1 0x20
CALLDATALOAD
DUP2
DUP2
DIV
PUSH1 0x00
SSTORE
DUP2
DUP2
SDIV
PUSH1 0x01
SSTORE
DUP2
DUP2
MOD
PUSH1 0x02
SSTORE
DUP2
DUP2
SMOD
PUSH1 0x03
SSTORE
PUSH1 0x40
CALLDATALOAD
DUP3
DUP3
ADDMOD
PUSH1 0x04
SSTORE
PUSH1 0x40
CALLDATALOAD
DUP3
DUP3
MULMOD
PUSH1 0x05
SSTORE
DUP2
DUP2
EXP
PUSH1 0x06
SSTORE
DUP2
DUP2
MUL
PUSH1 0x07
SSTORE
DUP2
DUP2
SIGNEXTEND
PUSH1 0x08
TSTORE
DUP2
DUP2
SAR
DUP3
DUP3
BYTE
XOR
DUP3
DUP3
SHL
DUP4
DUP4
SHR
OR
SUB
PUSH1 0x09
SSTORE
PUSH1 0x08
TLOAD
DUP2
SLT
DUP3
DUP3
SGT
ADD
PUSH1 0x0a
SSTORE
DUP2
PUSH1 0x00
MSTORE
DUP1
PUSH1 0x20
MSTORE
PUSH1 0x07
PUSH1 0x5f
MSTORE8
CALLDATASIZE
PUSH1 0x00
PUSH1 0x60
CALLDATACOPY
PUSH1 0x40
PUSH1 0x00
PUSH2 0x0100
MCOPY
PUSH1 0x20
PUSH1 0x10
PUSH2 0x0180
CODECOPY
PUSH1 0x60
CALLDATALOAD
PUSH2 0x01ff
AND
PUSH1 0x00
SHA3
PUSH1 0x0b
SSTORE
PUSH1 0x44
MLOAD
PUSH1 0x0c
SSTORE
GAS
MSIZE
PC
ADD
ADD
PUSH1 0x0d
SSTORE
PUSH1 0x24
PUSH1 0x30
RETURN
"""

#: a dispatcher body that walks the symbolic planes: a clean MSTORE/MLOAD
#: round trip, a symbolic SSTORE read back, an env var, a concrete SHA3 on
#: the device, then forks whose sides escape on a dirty MLOAD, a SHA3 over
#: symbolic bytes and a CALLDATACOPY of symbolic calldata
PLANES_SOURCE = """
PUSH1 0x04
CALLDATALOAD
DUP1
PUSH1 0x00
MSTORE
PUSH1 0x00
MLOAD
PUSH1 0x24
CALLDATALOAD
ADD
DUP1
PUSH1 0x01
SSTORE
PUSH1 0x01
SLOAD
CALLER
XOR
PUSH1 0x2a
PUSH1 0x40
MSTORE
PUSH1 0x20
PUSH1 0x40
SHA3
PUSH1 0x02
SSTORE
DUP1
PUSH1 0x10
GT
PUSH @a
JUMPI
PUSH1 0x07
PUSH1 0x03
MSTORE8
PUSH1 0x00
MLOAD
STOP
a:
JUMPDEST
DUP1
PUSH1 0x03
SWAP1
DUP2
LT
PUSH @b
JUMPI
PUSH1 0x20
PUSH1 0x00
SHA3
STOP
b:
JUMPDEST
PUSH1 0x20
PUSH1 0x00
PUSH1 0x60
CALLDATACOPY
STOP
"""

#: tests/test_analysis.py's KILLBILLY: its SLOAD on a symbolic-base storage
#: pauses the lane for a fault-in (the cold-SLOAD path)
KILLBILLY = {
    "activatekillability()": "PUSH1 0x01\nPUSH1 0x00\nSSTORE\nSTOP",
    "commencekilling()":
        "PUSH1 0x00\nSLOAD\nPUSH1 0x01\nEQ\nPUSH @do_kill\nJUMPI\nSTOP\n"
        "do_kill:\nJUMPDEST\nCALLER\nSELFDESTRUCT",
}

#: tests/test_analysis.py's SAFE_KILL: only the creator may kill
SAFE_KILL = {
    "kill()":
        "CALLER\nPUSH1 0x07\nSLOAD\nEQ\nPUSH @do_kill\nJUMPI\nSTOP\n"
        "do_kill:\nJUMPDEST\nCALLER\nSELFDESTRUCT",
}

#: tests/test_analysis.py's tx.origin contract
TX_ORIGIN = {
    "check()": "ORIGIN\nPUSH1 0x42\nEQ\nPUSH @ok\nJUMPI\nSTOP\n"
               "ok:\nJUMPDEST\nSTOP",
}

WORD_MASK = (1 << 256) - 1
SPECIAL = [0, 1, 2, 3, 7, 31, 32, 255, 256, 1 << 255, WORD_MASK,
           WORD_MASK - 1, (1 << 255) - 1, 0xDEADBEEF, 1 << 128,
           12345678901234567890]


def mixed_specs(n_lanes: int, seed: int = 7):
    """LaneSpecs running MIXED_SOURCE on adversarial and random operands:
    lane 0 divides INT_MIN by -1, lane 1 divides by zero, and the SHA3
    lengths walk the keccak block boundaries."""
    code = assemble(MIXED_SOURCE)
    rng = np.random.default_rng(seed)

    def word(value):
        return (value & WORD_MASK).to_bytes(32, "big")

    specs = []
    for lane in range(n_lanes):
        x, y, n = (SPECIAL[int(rng.integers(len(SPECIAL)))]
                   if rng.random() < .6
                   else int.from_bytes(rng.bytes(32), "big")
                   for _ in range(3))
        if lane == 0:
            x, y = 1 << 255, WORD_MASK
        if lane == 1:
            y, n = 0, 0
        sha_len = [0, 135, 136, 137, 271, 272, 511][lane % 7]
        specs.append(B.LaneSpec(
            code=code, calldata=word(x) + word(y) + word(n) + word(sha_len),
            gas_limit=10_000_000, caller=0xCAFE + lane,
            timestamp=1_700_000_000, chainid=1, basefee=7))
    return specs


def mem_branchy_contract(n_branches: int) -> str:
    """bench.py's memory diamonds (bench.py:96): n diamonds whose arms both
    MSTORE a different constant into the same 32-byte slot before they
    reconverge; the pad JUMPDEST keeps the siblings in lockstep."""
    lines = []
    for i in range(n_branches):
        lines += [
            f"PUSH2 {hex(4 + 32 * i)}", "CALLDATALOAD",
            f"PUSH @t{i}", "JUMPI",
            f"PUSH1 {hex(2 * i + 1)}", f"PUSH1 {hex(32 * i)}", "MSTORE",
            f"PUSH @j{i}", "JUMP",
            f"t{i}:", "JUMPDEST",
            f"PUSH1 {hex(2 * i + 2)}", f"PUSH1 {hex(32 * i)}", "MSTORE",
            "JUMPDEST",
            f"j{i}:", "JUMPDEST",
        ]
    lines.append("STOP")
    return "\n".join(lines)


def branchy_contract(n_branches: int) -> str:
    """bench.py's stress body: n sequential branches on distinct calldata
    words whose sides converge, so every combination is a live path."""
    lines = []
    for i in range(n_branches):
        lines += [f"PUSH2 {hex(4 + 32 * i)}", "CALLDATALOAD",
                  f"PUSH4 {hex(0x10000 + i)}", "LT", f"PUSH @l{i}", "JUMPI",
                  f"l{i}:", "JUMPDEST"]
    return "\n".join(lines + ["STOP"])


#: the host engine's statespace runs (phase host_engine): the contracts
#: behind a dispatcher and their transaction counts
HOST_ENGINE_CONTRACTS = {"killbilly": KILLBILLY,
                         "branchy8": {"stress()": branchy_contract(8)}}
HOST_ENGINE_RUNS = (("killbilly", 2), ("branchy8", 1))

#: the JAX package's `mythril_tpu.core.svm.LaserEVM(max_depth=128,
#: transaction_count=n)` (DFS, budgets it never reaches) on the same runs
#: from fresh node, transaction and function-manager counters: total states,
#: nodes, edges and open states after each transaction. Creation mode runs
#: `sym_exec(creation_code=creation_wrapper(runtime))`, runtime mode the
#: world state SymExecWrapper builds (balance 10**18, symbolic storage).
#: tests/test_torch_svm.py recomputes them with JAX and checks them.
EXPECTED_HOST_ENGINE = {
    "killbilly": {
        "creation": {"states": 124, "nodes": 25, "edges": 24,
                     "open_after_tx": [3, 9]},
        "runtime": {"states": 127, "nodes": 27, "edges": 26,
                    "open_after_tx": [4, 11]}},
    "branchy8": {
        "creation": {"states": 2313, "nodes": 514, "edges": 513,
                     "open_after_tx": [257]},
        "runtime": {"states": 2307, "nodes": 513, "edges": 512,
                    "open_after_tx": [257]}},
}
#: wall-clock budgets of the host engine's runs: neither is reached
HOST_ENGINE_BUDGET_S = 600
#: the analyze phase's runs of the port's CLI (`python -m mythril_tpu_torch
#: analyze -c <creation code> -t N [-m MODULES] -o json`, the default
#: configuration: --engine host, the CDCL, bfs): a dispatcher of the
#: contract, its modules (None: all) and transaction count
ANALYZE_RUNS = {
    "killbilly": (KILLBILLY, None, 2),
    "safe_kill": (SAFE_KILL, "AccidentallyKillable", 2),
    "tx_origin": (TX_ORIGIN, "TxOrigin", 1),
}
#: the JAX package's CLI (`python -m mythril_tpu analyze`) on the same
#: arguments: its exit code and each issue's SWC id, title and address, in
#: the report's order. tests/test_torch_cli.py recomputes them with JAX.
EXPECTED_ANALYZE = {
    "killbilly": {"exit": 1,
                  "issues": [["106", "Unprotected Selfdestruct", 52]]},
    "safe_kill": {"exit": 0, "issues": []},
    "tx_origin": {"exit": 1,
                  "issues": [["115", "Dependence on tx.origin", 27]]},
}
#: a counting loop of 1024 turns (8 steps a turn) past the device's step
#: budget, beside an unprotected kill: the device phase ends with the loop's
#: lane live, so the hand-over materializes it into the host's worklist
SPIN = {
    "spin()": "PUSH1 0x00\nloop:\nJUMPDEST\nPUSH1 0x01\nADD\nDUP1\n"
              "PUSH2 0x0400\nGT\nPUSH @loop\nJUMPI\nPOP\nSTOP",
    "kill()": "CALLER\nSELFDESTRUCT",
}
#: the analyze_tpu phase's runs of the port's CLI with `--engine tpu`, in
#: the default configuration (128 lanes, telemetry and merging on, the
#: CDCL, bfs): ANALYZE_RUNS in creation mode, KILLBILLY's runtime code
#: (`--bin-runtime`: a symbolic storage base, so SLOADs fault in) and SPIN
#: in creation mode for one transaction (the step budget's hand-over)
ANALYZE_TPU_RUNS = (*ANALYZE_RUNS, "killbilly_runtime", "spin")
#: the JAX package's CLI (`MYTHRIL_TPU_LANES=128 python -m mythril_tpu
#: analyze ... --engine tpu`) on the same arguments: its exit code, each
#: issue's SWC id, title and address and, per transaction, its frontier's
#: forks, storage fault-ins, states materialized and rows deferred. tests/test_torch_tpu_engine.py
#: recomputes them with JAX.
EXPECTED_ANALYZE_TPU = {
    "killbilly": {"exit": 1,
                  "issues": [["106", "Unprotected Selfdestruct", 52]],
                  "frontier": [[2, 0, 0, 3], [6, 0, 0, 9]]},
    "safe_kill": {"exit": 0, "issues": [],
                  "frontier": [[2, 0, 0, 3], [4, 0, 0, 6]]},
    "tx_origin": {"exit": 1,
                  "issues": [["115", "Dependence on tx.origin", 27]],
                  "frontier": [[1, 0, 0, 2]]},
    "killbilly_runtime": {"exit": 1,
                          "issues": [["106", "Unprotected Selfdestruct", 52]],
                          "frontier": [[3, 1, 0, 4], [8, 2, 0, 11]]},
    "spin": {"exit": 1, "issues": [["106", "Unprotected Selfdestruct", 51]],
             "frontier": [[2, 0, 1, 2]]},
}
#: the analyze_fleet phase's corpus: ANALYZE_RUNS' three contracts and
#: tests/test_fleet.py's three, each a dispatcher in creation mode, one
#: file a contract (the CLI names each member after its file), analyzed
#: with one module list at one transaction (KILLBILLY and SAFE_KILL report
#: nothing at one transaction; the JAX CLI recomputes the constants below
#: in under a minute on a host CPU)
def load_test_fleet():
    """tests/test_fleet.py, loaded from this checkout by its path (a
    `tests` package installed elsewhere may shadow the checkout's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_test_fleet", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests",
            "test_fleet.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_TEST_FLEET = load_test_fleet()
FLEET_CORPUS = {"killbilly": KILLBILLY, "safe_kill": SAFE_KILL,
                "tx_origin": TX_ORIGIN, "branchy": _TEST_FLEET.BRANCHY,
                "addflow": _TEST_FLEET.ADDFLOW, "combo": _TEST_FLEET.COMBO}
FLEET_MODULES = "AccidentallyKillable,IntegerArithmetics,TxOrigin"
FLEET_TX = 1
#: the sharded fleet's settings: 4 shards and a steal pass every chunk;
#: the corpus's trees end in under 64 steps and never fill a 32-lane
#: shard of 128 lanes, so the run takes the narrowest fleet (2 lanes a
#: seed, 3 a shard) and 8-step chunks, where shards fill and rows wait
#: on the stack between forks for a steal pass to move
FLEET_SHARDED = {"fleet_shard": 4, "steal_cadence": 1,
                 "steal_min_imbalance": 1, "fleet_lanes": 8, "chunk": 8}
#: the JAX knobs that give the JAX fleet FLEET_SHARDED
FLEET_SHARDED_ENV = {"MYTHRIL_TPU_FLEET_SHARD": "4",
                     "MYTHRIL_TPU_STEAL_CADENCE": "1",
                     "MYTHRIL_TPU_STEAL_MIN_IMBALANCE": "1",
                     "MYTHRIL_TPU_FLEET_LANES": "8", "MYTHRIL_TPU_CHUNK": "8"}
#: the member whose preempt event is set before the preempted fleet runs
FLEET_PREEMPTED = "addflow"
#: the JAX package's fleet on the same corpus and arguments at 128 lanes
#: (`MYTHRIL_TPU_LANES=128 python -m mythril_tpu analyze -f ... --engine tpu
#: --fleet`, in process): its exit code and each contract's issues (SWC id,
#: title, address); its driver's phases, lane-steps and forks and each
#: member's lane-steps (the `frontier.fleet.lane_steps` labels), unsharded
#: and under FLEET_SHARDED_ENV (with its steal passes and rows moved); and
#: a FleetDriver over the corpus with FLEET_PREEMPTED's preempt event set:
#: each member's completion, dropped states and issues.
#: tests/test_torch_fleet_cli.py recomputes them with JAX.
EXPECTED_ANALYZE_FLEET = {
    "exit": 1,
    "issues": {"killbilly": [], "safe_kill": [],
               "tx_origin": [["115", "Dependence on tx.origin", 27]],
               "branchy": [["106", "Unprotected Selfdestruct", 46]],
               "addflow": [["101", "Integer Arithmetic Bugs", 26]],
               "combo": [["106", "Unprotected Selfdestruct", 57],
                         ["101", "Integer Arithmetic Bugs", 66]]},
    "fleet": {"phases": 1, "lane_steps": 186, "forks": 11,
              "occupancy": {"addflow": 25, "branchy": 36, "combo": 56,
                            "killbilly": 30, "safe_kill": 22,
                            "tx_origin": 17}},
    "sharded": {"phases": 1, "lane_steps": 184, "forks": 11,
                "occupancy": {"addflow": 25, "branchy": 34, "combo": 56,
                              "killbilly": 30, "safe_kill": 22,
                              "tx_origin": 17},
                "steal_passes": 4, "steal_rows": 3},
    "preempted": {
        "killbilly": {"incomplete": False, "dropped_states": 0,
                      "issues": []},
        "safe_kill": {"incomplete": False, "dropped_states": 0,
                      "issues": []},
        "tx_origin": {"incomplete": False, "dropped_states": 0,
                      "issues": [["115", "Dependence on tx.origin", 27]]},
        "branchy": {"incomplete": False, "dropped_states": 0,
                    "issues": [["106", "Unprotected Selfdestruct", 46]]},
        "addflow": {"incomplete": True, "dropped_states": 2, "issues": []},
        "combo": {"incomplete": False, "dropped_states": 0,
                  "issues": [["101", "Integer Arithmetic Bugs", 66],
                             ["106", "Unprotected Selfdestruct", 57]]}},
}
#: tools/measure_headline.py's two runs through the port's CLI, with the
#: same contract, modules and transaction count, and the SWC ids each must
#: report. They are solver-bound and take tens of minutes on a host CPU,
#: past this script's time limit: `python3 chip_smoke.py --headline` runs
#: them alone, side by side
HEADLINE_RUNS = {
    "headline_killbilly": (HEADLINE_KILLBILLY, "AccidentallyKillable", 3),
    "headline_bectoken": (BECTOKEN, "IntegerArithmetics", 4),
}
EXPECTED_HEADLINE = {"headline_killbilly": ["106"],
                     "headline_bectoken": ["101"]}
#: the headline runs' --execution-timeout; a run that reaches it reports
#: itself incomplete
HEADLINE_BUDGET_S = 1800
#: transient slots the mixed program writes (TSTORE 8)
MIXED_TRANSIENT_SLOTS = (8,)
#: the callee of the host interpreter's concrete call of a mixed lane
MIXED_CALLEE = 0x0ACE000000000000000000000000000000000001
#: steps of the mixed program in phase host_engine: every lane halts by then
MIXED_STEPS = 256


#: the fleet run's members, in seed and fleet-slot order
FLEET_RUN = {"branchy12": branchy_contract(N_BRANCHES),
             "mem_branchy8": mem_branchy_contract(MERGE_BRANCHES)}


#: a dispatcher with a counting loop beside three memory diamonds: its loop
#: header is tagged before the merge points
LOOPS_AND_JOINS = {
    "count()": "PUSH1 0x00\nhead:\nJUMPDEST\nDUP1\nPUSH1 0x05\nEQ\n"
               "PUSH @exit\nJUMPI\nPUSH1 0x01\nADD\nPUSH @head\nJUMP\n"
               "exit:\nJUMPDEST\nPOP\nSTOP",
    "diamonds()": mem_branchy_contract(3)}


def wide_diamonds(n_branches: int) -> str:
    """mem_branchy(n) with two-byte memory offsets, for n past 8: 40 of them
    fill the 32 tag slots and the 64 window rows."""
    lines = []
    for i in range(n_branches):
        lines += [f"PUSH2 {hex(4 + 32 * (i % 8))}", "CALLDATALOAD",
                  f"PUSH @t{i}", "JUMPI",
                  f"PUSH1 {hex(2 * i + 1)}", f"PUSH2 {hex(32 * i)}", "MSTORE",
                  f"PUSH @j{i}", "JUMP",
                  f"t{i}:", "JUMPDEST",
                  f"PUSH1 {hex(2 * i + 2)}", f"PUSH2 {hex(32 * i)}", "MSTORE",
                  "JUMPDEST", f"j{i}:", "JUMPDEST"]
    return "\n".join(lines + ["STOP"])


def fleet_tables() -> dict:
    """The JAX static analysis's tables for the fleet's two codes: those of
    mem_branchy(8) (branchy(12) has no joins)."""
    return mem_branchy_tables()


#: the JAX static analysis's tables for a code without joins or loops
#: (branchy(12))
NO_TABLES = {"tag_pcs": [], "tag_names": [], "merge_pcs": [],
             "merge_names": [], "mem_pcs": [], "mem_words": []}


def static_codes() -> dict:
    """The static_tables phase's code sets, each in seed order: branchy(12),
    mem_branchy(8), the fleet pair, the headline dispatchers
    (tools/measure_headline.py), a loop beside joins and 40 diamonds past
    the tag and window caps."""
    def stress(body):
        return assemble(dispatcher({"stress()": body}))

    return {"branchy12": [stress(branchy_contract(N_BRANCHES))],
            "mem_branchy8": [stress(mem_branchy_contract(MERGE_BRANCHES))],
            "fleet": [stress(body) for body in FLEET_RUN.values()],
            "killbilly": [assemble(dispatcher(HEADLINE_KILLBILLY))],
            "bectoken": [assemble(dispatcher(BECTOKEN))],
            "loops_and_joins": [assemble(dispatcher(LOOPS_AND_JOINS))],
            "past_the_caps": [stress(wide_diamonds(40))]}


def table_counts(tables: dict) -> dict:
    """The sizes of a set of static tables (`frontier.static_tables`'s keys)
    and the sha256 of every table's shape and values."""
    doc = {key: [list(np.shape(tables[key])),
                 np.asarray(tables[key]).tolist()]
           for key in frontier.TABLE_KEYS}
    return {"tags": len(tables["tag_pcs"]),
            "merge_pcs": len(tables["merge_pcs"]),
            "window_rows": len(tables["mem_pcs"]),
            "sha256": hashlib.sha256(json.dumps(
                doc, sort_keys=True).encode()).hexdigest()}


#: table_counts of the JAX static analysis's tables for each of
#: static_codes() (tests/test_torch_frontier.py recomputes them): the
#: fleet's are mem_branchy(8)'s, branchy(12) and the headline dispatchers
#: have no joins or loops; loops_and_joins tags its loop header before its
#: merge points, past_the_caps fills the 32 tags and the 64 window rows
_EMPTY_SHA256 = \
    "f889d5258842060f7a4a3e4507b0807d8d4d56d4feb9361f539fd32449a7eceb"
_MEM_BRANCHY_SHA256 = \
    "6a9cbbeba5b0d1aba2eb51d221b083cff7e77806674f06e98c2ce3eee216811e"
EXPECTED_STATIC = {
    "branchy12": {"tags": 0, "merge_pcs": 0, "window_rows": 0,
                  "sha256": _EMPTY_SHA256},
    "mem_branchy8": {"tags": 8, "merge_pcs": 8, "window_rows": 37,
                     "sha256": _MEM_BRANCHY_SHA256},
    "fleet": {"tags": 8, "merge_pcs": 8, "window_rows": 37,
              "sha256": _MEM_BRANCHY_SHA256},
    "killbilly": {"tags": 0, "merge_pcs": 0, "window_rows": 0,
                  "sha256": _EMPTY_SHA256},
    "bectoken": {"tags": 0, "merge_pcs": 0, "window_rows": 0,
                 "sha256": _EMPTY_SHA256},
    "loops_and_joins": {"tags": 5, "merge_pcs": 4, "window_rows": 12,
                        "sha256": "da6c8f0c43bdb4c56eadb8e0bc9a5900d8890da95"
                                  "cf85736b5f478fb92b70c82"},
    "past_the_caps": {"tags": 32, "merge_pcs": 40, "window_rows": 64,
                      "sha256": "b13e3bf55e7989a052cb692deaa3d94c32daca3e85"
                                "18bc4f68ca228fa456514b"}}


def check_tables(fr, expected: dict, what: str) -> None:
    """The tables a DeviceFrontier built for itself equal `expected` (the
    JAX static analysis's, as the constants above hold them)."""
    got = fr.tables()
    if not fr.own_tables or any(
            np.asarray(got[key]).tolist() != np.asarray(expected[key]).tolist()
            for key in frontier.TABLE_KEYS):
        raise AssertionError(f"{what}: the frontier's own tables differ from "
                             f"the JAX static analysis's: {got}")
    for key in ("merge_pcs", "mem_pcs", "mem_words"):
        if got[key].dtype != np.int32:
            raise AssertionError(f"{what}: {key} is {got[key].dtype}")


# ---- helpers ---------------------------------------------------------------------

#: `nvidia-smi --query-gpu=name,power.limit` of the card this run uses
CARD = ""


def emit(record: dict) -> None:
    """One phase line, with the card it ran on."""
    print(json.dumps({**record, "card": CARD}), flush=True)


def assert_same(kernel_tree, plain_tree, what: str) -> None:
    """Every leaf identical (dtype, shape, bytes)."""
    for (name, got), (_, ref) in zip(convert.leaves(convert.to_numpy(kernel_tree)),
                                     convert.leaves(convert.to_numpy(plain_tree))):
        if got.dtype != ref.dtype or got.shape != ref.shape \
                or not np.array_equal(got, ref):
            where = np.argwhere(got != ref)[:4].tolist() \
                if got.shape == ref.shape else "shape"
            raise AssertionError(f"{what}: leaf {name} differs at {where}")


def max_abs_err(got: torch.Tensor, ref: torch.Tensor) -> int:
    return int((got.to(torch.int64) - ref.to(torch.int64)).abs().max()) \
        if got.numel() else 0


def event_ms(fn, reps: int, setup=None) -> float:
    """Mean device time of fn() in ms over `reps` runs, each timed by CUDA
    events around the call alone (setup() runs outside the timed span)."""
    fn_args = setup() if setup else None
    fn(fn_args)  # warm
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        fn_args = setup() if setup else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(fn_args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def host_us(fn, reps: int = 200) -> float:
    """Median host time of fn() in microseconds over `reps` calls."""
    spent = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        spent.append(time.perf_counter() - start)
    return float(np.median(spent)) * 1e6


def lookup_us(cache, tensors_of, static: tuple) -> dict:
    """A cached plan's lookup on the host, in microseconds: building its
    key from the tensors (`key_us`) against the last-call check that
    `ops._Plans.get` makes first (`last_call_us`), the tensor list built in
    both. The cache's last call must have had these tensors."""
    hit = cache.get(tensors_of(), static, lambda: None)
    if hit is None:
        raise AssertionError("the plan looked up was not the last call's")
    return {"tensors": len(tensors_of()),
            "key_us": host_us(lambda: ops._key(tensors_of(), static)),
            "last_call_us": host_us(lambda: cache.get(tensors_of(), static,
                                                      None))}


def paired_ms(fns: dict, reps: int, rounds: int = 6) -> dict:
    """Event time of each of `fns` in ms (as event_ms), taken in turn
    `rounds` times, the order reversed every other round: each one's
    median over the rounds and its spread (least and most)."""
    times = {name: [] for name in fns}
    for turn in range(rounds):
        for name in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
            times[name].append(event_ms(fns[name], reps))
    return {name: {"ms": float(np.median(v)), "min_ms": min(v),
                   "max_ms": max(v)} for name, v in times.items()}


def profile_cuda(run, what: str, prepare=None, complete=None):
    """run() under torch.profiler (CUPTI), after prepare() outside it:
    (prepare's result, run's result, the trace's CUDA events). Now and then
    CUPTI hands back a trace without any device time, or drops a few
    kernel records; prepare() and run() then run again, three times in all,
    when the trace has no device time or `complete(events)` (the caller's
    count of the launches it knows ran) is false. A trace still short
    after that fails its caller's check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        prepared = prepare() if prepare else None
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            result = run(prepared)
            torch.cuda.synchronize()
        events = [event for event in prof.key_averages()
                  if event.device_type == DeviceType.CUDA]
        if sum(event.self_device_time_total for event in events) > 0:
            if complete is None or complete(events):
                break
            print(f"{what}: the profiler dropped kernel records "
                  f"(attempt {attempt + 1})", file=sys.stderr, flush=True)
            continue
        print(f"{what}: the profiler recorded no device time "
              f"(attempt {attempt + 1})", file=sys.stderr, flush=True)
    return prepared, result, events


def device_times(fn, reps: int, counts: bool = False, complete=None) -> dict:
    """Mean device time in ms per fn() call over `reps` calls of every CUDA
    function it runs, by name, as torch.profiler (CUPTI) records it,
    without the host's time to enqueue them; with `counts`, (ms, launches)
    per fn() call. `complete` as in profile_cuda."""
    fn(None)  # warm
    _, _, events = profile_cuda(
        lambda _: [fn(None) for _ in range(reps)], "device_times",
        complete=complete)
    return {event.key: ((event.self_device_time_total / reps / 1e3,
                         event.count / reps) if counts
                        else event.self_device_time_total / reps / 1e3)
            for event in events}


def refill(dst_trees, src_trees) -> None:
    """Copy every leaf of `src_trees` into `dst_trees`' storage: a cached
    plan and graph stay keyed on the same tensors between timed calls."""
    for dst, src in zip(dst_trees, src_trees):
        for dst_leaf, src_leaf in zip(dst, src):
            dst_leaf.copy_(src_leaf)


def launch_table(times: dict, prefix: str, per: int, grids: dict) -> dict:
    """{kernel: {device ms, launches, blocks}} per `per` of the functions
    named `prefix`... in `device_times(..., counts=True)`."""
    table = {}
    for key, (ms, calls) in times.items():
        name = key.split("(")[0].split()[-1].split("<")[0]
        if name.startswith(prefix):
            table[name] = {"device_ms": ms / per, "launches": calls / per,
                           "blocks": grids.get(name)}
    return table


def named_ms(times: dict, names=None) -> float:
    """The device_times() of every function whose name contains one of
    `names` (all of them when None), summed."""
    total = sum(ms for key, ms in times.items()
                if names is None or any(name in key for name in names))
    if total <= 0:
        raise AssertionError(f"the profiler recorded no device time of "
                             f"{names or 'any function'}")
    return total


def launch_ms(fn, reps: int, name: str) -> float:
    """Device ms a launch of the CUDA functions whose name contains `name`
    over `reps` calls of fn(), over the launches the profiler recorded (it
    drops a few of a side stream's records)."""
    times = device_times(fn, reps, counts=True)
    ms = sum(t for key, (t, _) in times.items() if name in key)
    calls = sum(c for key, (_, c) in times.items() if name in key)
    if ms <= 0 or not calls:
        raise AssertionError(f"the profiler recorded no launch of {name}")
    return ms / calls


def device_ms(fn, reps: int, names=None) -> float:
    """Mean device time of fn() in ms over `reps` calls: every CUDA function
    it runs whose name contains one of `names` (all of them when None)."""
    return named_ms(device_times(fn, reps), names)


def bound_ms(nbytes: float, nops: float):
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    op_ms = nops / PEAK_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=30)
    return proc.stdout.strip().splitlines()[0]


# ---- phase 2: K1 ------------------------------------------------------------------

KECCAK_OPS_PER_BLOCK = 24 * 216 * 2  # ~216 64-bit ops a round, 2 32-bit ops each


def phase_keccak(dev, rng) -> dict:
    n = 4096
    data = torch.from_numpy(rng.integers(0, 256, (n, 512), dtype=np.uint8)).to(dev)
    length = torch.from_numpy(rng.integers(0, 513, n).astype(np.int32)).to(dev)
    got = keccak.keccak256(data, length)
    ref = keccak.keccak256_reference(data, length)
    err_msgs = max_abs_err(got, ref)
    if err_msgs:
        raise AssertionError("K1 disagrees with keccak256_reference")
    msgs_ms = event_ms(lambda _: ops.keccak256(data, length), 20)

    # the main path's call: SHA3 ranges of 128 rows of a 4096-byte memory
    memory = torch.from_numpy(rng.integers(0, 256, (LANES, 4096),
                                           dtype=np.uint8)).to(dev)
    msize = torch.from_numpy(32 * rng.integers(0, 129, LANES)
                             .astype(np.int32)).to(dev)
    offset = torch.from_numpy(rng.integers(0, 4096, LANES)).to(dev)
    mlen = torch.from_numpy(rng.integers(0, 513, LANES).astype(np.int32)).to(dev)
    mask = torch.ones(LANES, dtype=torch.bool, device=dev)
    mask[::5] = False

    def kernel(_):
        return ops.keccak_rows(memory, mlen, offset=offset, limit=msize,
                               mask=mask)

    def plain(_):
        buf = lockstep.mem_read(memory, msize, offset, lockstep.SHA3_MAX)
        out = keccak.keccak256_reference(buf, mlen)
        return torch.where(mask[:, None], out, torch.zeros_like(out))

    err = max_abs_err(kernel(None), plain(None))
    if err:
        raise AssertionError("K1 (memory ranges) disagrees with its plain version")
    # the messages a warp takes: the wrapper's choice against one and 32,
    # timed in turn at both shapes
    choose = ops.messages_a_warp

    def forced(per: int, call):
        def run(_):
            ops.messages_a_warp = lambda batch, device: per
            try:
                return call()
            finally:
                ops.messages_a_warp = choose
        return run

    def per_warp_ms(call, shape: int, reps: int) -> dict:
        chosen = choose(shape, dev)
        return {"chosen": chosen, **paired_ms(
            {per: forced(per, call) for per in sorted({1, chosen, 32})}, reps)}

    per_warp = {
        "messages": per_warp_ms(lambda: ops.keccak_rows(data, length), n, 20),
        "main_shape": per_warp_ms(lambda: ops.keccak_rows(
            memory, mlen, offset=offset, limit=msize, mask=mask), LANES, 50)}
    lens = mlen[mask].to(torch.int64)
    blocks = int(((lens + 1 + 135) // 136).sum())
    nbytes = int(lens.sum()) + LANES * (8 + 4 + 4 + 1 + 32)
    b_ms, b_by = bound_ms(nbytes, blocks * KECCAK_OPS_PER_BLOCK)
    record = {"phase": "keccak", "messages": n, "max_abs_err": err_msgs,
              "messages_ms": msgs_ms,
              "messages_per_s": n / (msgs_ms / 1e3),
              "main_shape": [LANES, 4096], "main_max_abs_err": err,
              "per_warp_ms": per_warp}
    emit(record)
    return {"name": "keccak", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/keccak.cu",
            "replaces": "mythril_tpu/parallel/keccak.py:137",
            "max_abs_err": err, "ms": event_ms(kernel, 50),
            "plain_ms": event_ms(plain, 10), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "held_by": "phase keccak"}


# ---- phase 3: K2 ------------------------------------------------------------------

_DIV_OPS = {0x04, 0x05, 0x06, 0x07}


def step_work(state) -> tuple:
    """(bytes, 32-bit ops) one concrete step needs for these lanes: each
    running lane reads its opcode, three operand words and its scalars and
    writes a result word and its scalars; memory ops move their range; the
    division ladder, EXP and MULMOD cost operations."""
    status = state.status.cpu().numpy()
    pc = state.pc.cpu().numpy().astype(np.int64)
    code = state.code.cpu().numpy()
    code_len = state.code_len.cpu().numpy()
    running = status == B.RUNNING
    op = np.where(pc < code_len,
                  code[np.arange(len(pc)), np.clip(pc, 0, code.shape[1] - 1)], 0)
    nbytes = int((~running).sum()) * 4
    nops = 0
    for o in op[running]:
        nbytes += 1 + 3 * 64 + 64 + 2 * 24
        if o in (0x51, 0x52):
            nbytes += 32
        if o in (0x54, 0x55):
            nbytes += state.storage_keys.shape[1] * 129
        if o in _DIV_OPS or o == 0x08:
            nops += 257 * 40
        if o == 0x09:
            nops += 512 * 40 + 128
        if o == 0x0A:
            nops += 256 * 2 * 128
        if 0x37 <= o <= 0x3E or o == 0x5E:
            nbytes += 2 * 512
    return nbytes, nops


def phase_step(dev) -> dict:
    # bench.py's concrete loop at 512 lanes, 256 steps
    specs = [B.LaneSpec(BENCH_LOOP, gas_limit=2 ** 60) for _ in range(512)]
    state = B.build_batch(specs, device=dev, **BENCH_GEOMETRY)
    plain = convert.clone(state)
    for chunk in range(8):
        for _ in range(32):
            state = lockstep.step(state)
            plain = lockstep.step_reference(plain)
        assert_same(state, plain, f"K2 bench loop chunk {chunk}")

    # the mixed program at 128 lanes, default geometry, until every lane halts
    specs = mixed_specs(LANES)
    state = B.build_batch(specs, device=dev)
    plain = convert.clone(state)
    snapshot = None
    for chunk in range(8):
        for _ in range(32):
            state = lockstep.step(state)
            plain = lockstep.step_reference(plain)
        assert_same(state, plain, f"K2 mixed chunk {chunk}")
        if chunk == 0:
            snapshot = convert.clone(state)
    status = state.status.cpu().numpy()
    if not np.all(status == B.RETURNED):
        raise AssertionError(f"mixed program did not return: {np.bincount(status)}")

    # the same program at frontier_wide's 2048 lanes: one chunk held to the
    # twin, then K2's device time a step there
    wide = B.build_batch(mixed_specs(WIDE_LANES), device=dev)
    wide_plain = convert.clone(wide)
    for _ in range(32):
        wide = lockstep.step(wide)
        wide_plain = lockstep.step_reference(wide_plain)
    assert_same(wide, wide_plain, f"K2 mixed chunk 0 at {WIDE_LANES} lanes")
    emit({"phase": "evm_step", "bench_loop": [512, 256], "mixed": [LANES, 256],
          "mixed_wide": [WIDE_LANES, 32], "max_abs_err": 0})

    # time one step from the mixed program's first chunk (divisions, EXP,
    # MULMOD and SHA3 still ahead of most lanes), each call on the same
    # tensors refilled from the snapshot (the cached plan holds)
    nbytes, nops = step_work(snapshot)
    b_ms, b_by = bound_ms(nbytes, nops)
    timed = convert.clone(snapshot)

    def split_ms(source, tree):
        """K1's step form's and K2's device ms a step, from the profiler;
        each must launch once a step, and sha_prep (folded into K1) not at
        all."""
        times = device_times(
            lambda _: (refill([tree], [source]), ops.evm_step(tree)), 20,
            counts=True, complete=lambda events: all(
                sum(e.count for e in events if f"{name}_kernel" in e.key) == 20
                for name in ("keccak_step", "evm_step")))
        if any("sha_prep" in key for key in times):
            raise AssertionError(f"sha_prep launched: {sorted(times)}")
        split = {}
        for name in ("keccak_step", "evm_step"):
            launches = sum(count for key, (_, count) in times.items()
                           if f"{name}_kernel" in key)
            if launches != 1:
                raise AssertionError(f"{name}: {launches} launches a step")
            split[name] = named_ms({key: ms for key, (ms, _) in times.items()},
                                   [f"{name}_kernel"])
        return split

    wide_timed = convert.clone(wide)
    device, grid, k1_grid, no_sha3 = {}, {}, {}, {}
    for lanes, source, tree in ((LANES, snapshot, timed),
                                (WIDE_LANES, wide, wide_timed)):
        device[lanes] = split_ms(source, tree)
        # as the last launches recorded them: a block of a warp a lane
        grid[lanes] = ops.evm_step_grid()
        k1_grid[lanes] = ops.keccak_step_grid()
        if grid[lanes] != (lanes, 32) or k1_grid[lanes] != (lanes, 32):
            raise AssertionError(f"K1/K2 at {lanes} lanes launched "
                                 f"{k1_grid[lanes]}, {grid[lanes]}")
        # K1's step form where no lane hashes: bench.py's loop
        loop = B.build_batch([B.LaneSpec(BENCH_LOOP, gas_limit=2 ** 60)] * lanes,
                             device=dev)
        no_sha3[lanes] = split_ms(loop, convert.clone(loop))["keccak_step"]

    def ptxas(source, names):
        report = build.ptxas_report(source)
        return {name: next((props for fn, props in report.items() if name in fn), None)
                for name in names}

    k2 = {"name": "evm_step", "route": "cuda",
          "source": "mythril_tpu_torch/kernels/evm_step.cu",
          "replaces": "mythril_tpu/parallel/lockstep.py:159",
          "max_abs_err": 0,
          "ms": event_ms(lambda _: ops.evm_step(timed), 20,
                         setup=lambda: refill([timed], [snapshot])),
          "plain_ms": event_ms(lambda s: lockstep.step_reference(s), 5,
                               setup=lambda: convert.clone(snapshot)),
          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
          "device_ms": device[LANES], "device_ms_wide": device[WIDE_LANES],
          "wide_lanes": WIDE_LANES, "grid": grid[LANES],
          "grid_wide": grid[WIDE_LANES],
          "ptxas": ptxas("evm_step", ("evm_step_kernel", "heavy_word")),
          "held_by": "phase evm_step"}
    k1_step = {"step_device_ms": {"mixed": device[LANES]["keccak_step"],
                                  "mixed_wide": device[WIDE_LANES]["keccak_step"],
                                  "no_sha3": no_sha3[LANES],
                                  "no_sha3_wide": no_sha3[WIDE_LANES]},
               "step_grid": k1_grid[LANES], "step_grid_wide": k1_grid[WIDE_LANES],
               "ptxas": ptxas("keccak", ("keccak_step_kernel", "keccak_rows_kernel"))}
    return k2, k1_step


# ---- phase 4: K3 ------------------------------------------------------------------

def phase_arena(dev, rng) -> dict:
    plain = A.new_arena(2048, 128, device=dev)
    kern = convert.clone(plain)
    overflowed = False
    for round_ in range(48):
        want = torch.from_numpy(rng.random(LANES) < 0.5).to(dev)
        if round_ % 4 == 0:
            words = torch.from_numpy(rng.integers(0, 1 << 16, (LANES, 16))
                                     .astype(np.int32)).to(dev)
            plain, ids_p, ovf_p = A.alloc_consts_reference(plain, want, words)
            kern, ids_k, ovf_k = A.alloc_consts(kern, want, words)
        else:
            n = int(plain.n)
            args = [torch.from_numpy(v.astype(np.int32)).to(dev) for v in (
                rng.choice([0x01, 0x10, 0x14, A.VAR, A.CONST], LANES),
                rng.integers(0, n, LANES), rng.integers(0, n, LANES),
                rng.integers(0, n, LANES), rng.integers(0, 40, LANES),
                rng.integers(0, 1 << 20, LANES))]
            plain, ids_p, ovf_p = A.alloc_rows_reference(plain, want, *args)
            kern, ids_k, ovf_k = A.alloc_rows(kern, want, *args)
        if not (torch.equal(ids_p, ids_k) and torch.equal(ovf_p, ovf_k)):
            raise AssertionError(f"K3 ids differ in round {round_}")
        assert_same(kern, plain, f"K3 round {round_}")
        overflowed |= bool(ovf_p.any())
    if not overflowed:
        raise AssertionError("K3 sequence never reached capacity")
    emit({"phase": "arena_alloc", "rounds": 48, "lanes": LANES,
          "overflowed": overflowed, "max_abs_err": 0})

    # the main path's standalone launch (Frontier._alloc_host_term): a batch
    # of one VAR leaf of class V_HOST_TERM on a default-size arena, fresh,
    # at its last free row and full
    arena_p = A.new_arena(device=dev)
    arena_k = convert.clone(arena_p)
    cap = arena_p.capacity
    one = torch.ones(1, dtype=torch.bool, device=dev)

    def leaf(alloc, arena, term):
        return alloc(arena, one, A.VAR, 0, 0, 0, A.V_HOST_TERM, term)

    seen = []
    for term, start in enumerate((None, None, None, cap - 1, None)):
        if start is not None:
            arena_p.n.fill_(start)
            arena_k.n.fill_(start)
        _, id_p, ovf_p = leaf(A.alloc_rows_reference, arena_p, term)
        _, id_k, ovf_k = leaf(A.alloc_rows, arena_k, term)
        if not (torch.equal(id_p, id_k) and torch.equal(ovf_p, ovf_k)):
            raise AssertionError(f"K3 host-term leaf {term}: {id_k.tolist()} "
                                 f"{ovf_k.tolist()}, twin {id_p.tolist()} "
                                 f"{ovf_p.tolist()}")
        assert_same(arena_k, arena_p, f"K3 host-term leaf {term}")
        seen.append((int(id_p[0]), bool(ovf_p[0])))
    if seen != [(1, False), (2, False), (3, False), (cap - 1, False),
                (0, True)]:
        raise AssertionError(f"K3 host-term leaves: {seen}")
    emit({"phase": "arena_alloc_leaf", "capacity": cap, "leaves": seen,
          "max_abs_err": 0})

    # time that launch; the arena back to one node so that none overflows
    arena_p.n.fill_(1)
    arena_k.n.fill_(1)
    # the lane reads want and six operands and writes its id and overflow;
    # the node writes 7 columns and reads 3 child masks; n is read and written
    b_ms, b_by = bound_ms((1 + 6 * 4 + 4 + 1) + (7 * 4 + 3 * 4) + 8, 0)
    return {"name": "arena_alloc", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/arena_alloc.cu",
            "replaces": "mythril_tpu/parallel/arena.py:105",
            "max_abs_err": 0,
            "ms": event_ms(lambda _: leaf(A.alloc_rows, arena_k, 0), 50),
            "plain_ms": event_ms(
                lambda _: leaf(A.alloc_rows_reference, arena_p, 0), 20),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": "one host-term leaf, arena of 1<<22 rows",
            "held_by": "phases arena_alloc, arena_alloc_leaf"}


# ---- phase 5: the slice ----------------------------------------------------------

def seed_frontier(dev, codes, base_sym=()):
    """One RUNNING lane per code with symbolic env, the rest DEAD, as the
    frontier's `seed` does; `base_sym` lanes have a symbolic storage base."""
    specs = [B.LaneSpec(code=code, gas_limit=10_000_000) for code in codes] \
        + [B.LaneSpec(code=b"\x00")] * (LANES - len(codes))
    state = B.build_batch(specs, device=dev)
    state.status.fill_(B.DEAD)
    state.status[:len(codes)] = B.RUNNING
    planes = symstep.SymPlanes.empty(LANES, state.stack.shape[1],
                                     state.memory.shape[1],
                                     state.storage_keys.shape[1], MAX_CONDS,
                                     device=dev)
    planes.ctx_id[:len(codes)] = torch.arange(len(codes), dtype=torch.int32)
    for lane in base_sym:
        planes.storage_base_sym[lane] = True
    arena = A.new_arena(device=dev)
    sched = symstep.new_scheduler(state, planes, STACK_ROWS, ESC_ROWS)
    return [state, planes, arena, sched]


def phase_planes(dev) -> None:
    """K4 (K3 folded in; K1-K2 through it) vs the twins on contracts that
    walk the symbolic planes, a cold SLOAD pause and a concrete SHA3 on the
    device."""
    codes = [assemble(dispatcher({"planes()": PLANES_SOURCE})),
             assemble(dispatcher(KILLBILLY)),
             assemble(dispatcher({"stress()": branchy_contract(3)}))]
    tree = seed_frontier(dev, codes, base_sym=[1])
    plain = [convert.clone(t) for t in tree]
    escapes = 0
    for chunk in range(2):
        tree = list(symstep.run_chunk(*tree, CHUNK))
        plain = list(symstep.run_chunk_reference(*plain, CHUNK))
        for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                  tree, plain):
            assert_same(got, ref, f"planes chunk {chunk} {kind}")
        escapes += drain(tree, at_stop=False)[0]
        drain(plain, at_stop=False, reset=frontier.reset_esc_reference)
    paused = int(((tree[0].status == B.FORKING)
                  & (tree[1].fork_cond == 0)).sum())
    if not paused:
        raise AssertionError("the cold SLOAD lane did not pause")
    emit({"phase": "planes", "contracts": ["planes()", "KILLBILLY",
                                           "branchy(3)"],
          "chunks": 2, "escapes": escapes, "cold_sload_paused": paused,
          "forks": int(tree[3].forks), "max_abs_err": 0})


def drain(tree, at_stop: bool = True, reset=frontier.reset_esc) -> tuple:
    """Read and zero the escape count as the frontier's drain does (K6's
    `reset_esc`, or `reset` given); check that buffered rows are escaped
    lanes (at a STOP, with `at_stop`) or spilled siblings, still RUNNING.
    Returns (rows, spilled rows)."""
    sched = tree[3]
    rows = int(sched.esc_count)
    status = sched.esc_state.status[:rows].cpu().numpy()
    pc = sched.esc_state.pc[:rows].cpu().numpy().astype(np.int64)
    code = sched.esc_state.code[:rows].cpu().numpy()
    spilled = int((status == B.RUNNING).sum())
    halted = status == B.ESCAPED
    if spilled + int(halted.sum()) != rows:
        raise AssertionError(f"escape rows with status {np.unique(status)}")
    at = code[np.arange(rows), np.clip(pc, 0, code.shape[1] - 1)]
    if at_stop and np.any(at[halted] != 0x00):
        raise AssertionError("an escaped row is not at a STOP")
    reset(sched)
    return rows, spilled


def live(tree) -> bool:
    status = tree[0].status
    busy = (status == B.RUNNING) | (status == B.FORKING) | (status == B.ESCAPED)
    return bool(busy.any()) or int(tree[3].stack_top) > 0


def phase_slice(dev) -> dict:
    code = assemble(dispatcher({"stress()": branchy_contract(N_BRANCHES)}))
    torch.cuda.reset_peak_memory_stats()
    tree = seed_frontier(dev, [code])
    plain = [convert.clone(t) for t in tree]
    row_bytes = sum(leaf[0].numel() * leaf.element_size()
                    for leaf in list(tree[0]) + list(tree[1]))
    escapes = spilled = chunks = 0
    kernel_s = 0.0
    snapshot = None
    ops.reset_launches()
    while live(tree):
        if chunks == MAX_CHUNKS:
            raise AssertionError("the frontier did not drain")
        if chunks == TIMING_CHUNK:
            snapshot = [convert.clone(t) for t in tree]
        torch.cuda.synchronize()
        start = time.perf_counter()
        tree = list(symstep.run_chunk(*tree, CHUNK))
        torch.cuda.synchronize()
        kernel_s += time.perf_counter() - start
        if chunks < COMPARE_CHUNKS:
            plain = list(symstep.run_chunk_reference(*plain, CHUNK))
            for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                      tree, plain):
                assert_same(got, ref, f"slice chunk {chunks} {kind}")
            drain(plain, reset=frontier.reset_esc_reference)
        rows, spill = drain(tree)
        escapes += rows
        spilled += spill
        chunks += 1
    launches = dict(ops.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    sched, arena = tree[3], tree[2]
    totals = {"escapes": escapes, "forks": int(sched.forks),
              "pushes": int(sched.pushes), "pops": int(sched.pops),
              "executed": int(sched.executed), "arena_n": int(arena.n),
              "n_const": int(arena.n_const)}
    if totals != EXPECTED:
        raise AssertionError(f"slice totals {totals} != JAX reference {EXPECTED}")
    if any(launches[name] == 0 for name in ("keccak", "evm_step",
                                             "arena_alloc_step", "sym_step",
                                             "pack_rows")):
        raise AssertionError(f"a kernel of the slice never ran: {launches}")
    replays = dict(ops.REPLAYS)
    if replays["run_chunk"] != chunks:
        raise AssertionError(f"the slice's chunks were not graphed: {replays}")
    if snapshot is None:
        raise AssertionError("the frontier drained before the timing snapshot")

    # per-kernel times on the main path: one chunk of eager steps from the
    # snapshot, CUDA events around each host call (K4 = its pre and post
    # calls; K2 = evm_step; K1 = its step form), then the same
    # chunk under the profiler for the kernels' device time per step
    spans = {"keccak": [], "evm_step": [], "sym_step": []}
    owner = {"mtpu_keccak_step": "keccak", "mtpu_evm_step": "evm_step"}
    call = ops._call

    def timed_call(name, block):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call(name, block)
        end.record()
        spans[owner.get(name, "sym_step")].append((start, end))

    timing = [convert.clone(t) for t in snapshot]
    before = {k: int(getattr(timing[3], k)) for k in ("pops", "forks", "executed")}
    frontier.reset_esc_reference(timing[3])
    ops.step_plan(*timing)  # built before the timed span
    ops._call = timed_call
    try:
        for _ in range(CHUNK):
            timing = list(ops.sym_step(*timing))
        torch.cuda.synchronize()
    finally:
        ops._call = call
    per = {k: sum(s.elapsed_time(e) for s, e in v) / CHUNK
           for k, v in spans.items()}
    k2_only = per["evm_step"]
    k4_only = per["sym_step"]
    moved = (int(timing[3].pops) - before["pops"] + int(timing[3].esc_count)
             + int(timing[3].forks) - before["forks"])
    lane_steps = int(timing[3].executed) - before["executed"]
    eager = [convert.clone(t) for t in snapshot]
    frontier.reset_esc_reference(eager[3])
    step_times = device_times(lambda _: ops.sym_step(*eager), CHUNK)
    k4_device = named_ms(step_times, K4_KERNELS)
    # K4 moves whole rows (read + write) and touches ~600 bytes of planes
    # and scratch per lane per step; the bound is per step, like `ms`
    b_ms, b_by = bound_ms((2 * moved * row_bytes + CHUNK * LANES * 600)
                          / CHUNK, 0)
    plain_snap = [convert.clone(t) for t in snapshot]
    plain_ms = event_ms(
        lambda t: symstep.sym_step_reference(*t), 4,
        setup=lambda: [convert.clone(t) for t in plain_snap])

    emit({"phase": "slice", "contract": f"dispatcher(branchy({N_BRANCHES}))",
          "lanes": LANES, "chunk": CHUNK, "stack_rows": STACK_ROWS,
          "esc_rows": ESC_ROWS, "row_bytes": row_bytes, "chunks": chunks,
          "compared_chunks": min(chunks, COMPARE_CHUNKS), **totals, "spilled": spilled,
          "expected": EXPECTED, "wall_s": kernel_s,
          "lane_steps_per_s": totals["executed"] / kernel_s,
          "steps_per_s": chunks * CHUNK / kernel_s,
          "launch_ms": {"keccak": per["keccak"], "evm_step": k2_only,
                        "sym_step": k4_only,
                        "whole_step": sum(per.values())},
          "eager_device_ms_per_step": {
              "sym_step": k4_device,
              "by_kernel": {name: named_ms(step_times, (name,))
                            for name in K4_KERNELS}},
          "replays": replays,
          "timed_chunk": {"lane_steps": lane_steps, "rows_moved": moved},
          "peak_device_bytes": peak_bytes,
          "launches": launches})
    record = {"name": "sym_step", "route": "cuda",
              "source": "mythril_tpu_torch/kernels/sym_step.cu",
              "replaces": "mythril_tpu/parallel/symstep.py:347",
              "max_abs_err": 0, "ms": k4_only, "device_ms": k4_device,
              "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
              "held_by": "phase slice"}
    return record


# ---- phases 7-9: the frontier's drain loop -------------------------------------------

def frontier_totals(fr) -> dict:
    """The counters and digests a drain-loop run is checked by."""
    return {"chunks": fr.chunks, "drains": fr.drains,
            "drained_rows": fr.drained_rows, "frozen_rows": fr.frozen_rows,
            "spilled": fr.spilled, "reseeded": fr.reseeded,
            "lane_steps": fr.lane_steps, "forks": fr.forks,
            "stack_pushes": fr.stack_pushes, "stack_pops": fr.stack_pops,
            "deferred_blocks": len(fr.deferred),
            "deferred_rows": sum(block[2] for block in fr.deferred),
            "mirror_n": fr.harena.n, "mirror_n_const": fr.harena.n_const,
            "deferred_sha256": frontier.deferred_digest(fr.deferred),
            "mirror_sha256": frontier.mirror_digest(fr.harena)}


def stress_seed(n_branches: int, body=None):
    body = body or branchy_contract(n_branches)
    code = assemble(dispatcher({"stress()": body}))
    return [(code, {}, False, 10_000_000, 0)]


#: DeviceFrontier with telemetry and state merging off (PR 2's runs)
OFF = {"telemetry": False, "state_merge": False}


def default_totals(fr) -> dict:
    """frontier_totals plus the merge totals and the final telemetry
    words of a default-configuration run."""
    return {**frontier_totals(fr), "merge_passes": fr.merge_passes,
            "merges": fr.merges, "merge_ites": fr.merge_ites,
            "mem_blends": fr.mem_blends, "blocked_by": dict(fr.blocked_by),
            "telemetry_words": [int(v) for v in fr.tel_words]}


def shard_totals(fr) -> dict:
    """default_totals plus the steal passes and the steal counters of a
    sharded run."""
    return {**default_totals(fr), "steal_passes": fr.steal_passes,
            "steal_rows": int(fr.steal_rows),
            "steals_sent": [int(v) for v in fr.steals_sent],
            "steals_received": [int(v) for v in fr.steals_received]}


def check_same(got, ref, what: str) -> None:
    for mine, theirs in zip(got, ref):
        if mine.dtype != theirs.dtype or not torch.equal(mine, theirs):
            raise AssertionError(f"{what} disagrees with its twin")


def phase_frontier_programs(dev) -> list:
    """K5-K8 vs their twins at the main path's shapes, two chunks into the
    slice, each timed beside its twin and its library yardstick."""
    fr = frontier.DeviceFrontier(LANES, device=dev, **OFF)
    state, planes = fr.seed(stress_seed(N_BRANCHES))
    sched = fr.new_sched(state, planes)
    arena = fr.arena
    for _ in range(2):
        state, planes, arena, sched = symstep.run_chunk(state, planes, arena,
                                                        sched, CHUNK)
    esc_count = int(sched.esc_count)
    if not esc_count:
        raise AssertionError("no escape rows buffered after two chunks")
    records = []
    # the chunk graph's lookup in run_chunk (the last call's tensors)
    _, step_static = ops._step_parts(
        state, planes, arena, sched, ops.LANES_PER_BLOCK, ops.LANE_GROUP)
    chunk_lookup = lookup_us(
        ops._GRAPHS, lambda: ops._step_parts(
            state, planes, arena, sched, ops.LANES_PER_BLOCK,
            ops.LANE_GROUP)[0], step_static + (CHUNK,))

    # K5: the summary, its grid as the launch recorded it, its device time
    # by launch, and the drain loop's read beside a pinned copy, timed in
    # turn on one plan
    ref = frontier.summary_reference(state, planes, arena, sched)
    packed = frontier.summary(state, planes, arena, sched).clone()
    check_same([packed], [ref], "K5")
    grid = ops.frontier_summary_grid()
    esc_rows = sched.esc_state.status.shape[0]
    if grid[0] < 2:
        raise AssertionError(f"K5 at {esc_rows} escape rows launched {grid}")
    read = frontier.summary_read(state, planes, arena, sched)
    if not np.array_equal(read, ref.cpu().numpy()):
        raise AssertionError("K5's read disagrees with its twin")
    out = frontier.summary(state, planes, arena, sched)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    copied = torch.cuda.Event()

    def pinned_read(_):
        host.copy_(frontier.summary(state, planes, arena, sched),
                   non_blocking=True)
        copied.record()
        copied.synchronize()
        return host.numpy()

    if not np.array_equal(pinned_read(None), read):
        raise AssertionError("K5's pinned read disagrees with its twin")
    k5_times = device_times(lambda _: frontier.summary(state, planes, arena,
                                                       sched), 20)
    k5_split = {name: named_ms(k5_times, (name,))
                for name in ("frontier_summary_kernel",
                             "frontier_summary_combine_kernel")}
    live_rows = esc_count
    b_ms, b_by = bound_ms(live_rows * (4 + 4 + 64 + 4) + LANES * 12
                          + (13 + 3 * LANES) * 8 + 6 * 8 + 2 * 4, 0)
    records.append({
        "name": "frontier_summary", "route": "cuda",
        "source": "mythril_tpu_torch/kernels/frontier_summary.cu",
        "replaces": "mythril_tpu/parallel/frontier.py:99", "max_abs_err": 0,
        "ms": event_ms(lambda _: frontier.summary(state, planes, arena,
                                                  sched), 50),
        "device_ms": sum(k5_split.values()),
        "device_ms_by_kernel": k5_split,
        "plain_ms": event_ms(lambda _: frontier.summary_reference(
            state, planes, arena, sched), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no single PyTorch call packs the summary",
        "escape_rows": esc_rows, "live_rows": live_rows,
        "grid": {"blocks": grid[0], "threads": grid[1]},
        "lookup": lookup_us(ops._SUMMARY_PLANS, lambda: ops._summary_tensors(
            state, planes, arena, sched), ()),
        "read": paired_ms({
            "pageable": lambda _: frontier.summary_read(state, planes, arena,
                                                        sched),
            "pinned": pinned_read}, 50),
        "held_by": "phase frontier_programs"})

    # K6: the drain's maxima, pack and reset at its real index and widths
    scalars = packed[:frontier.SUMMARY_SCALARS].cpu().numpy()
    esc_cap = sched.esc_state.status.shape[0]
    bucket = min(B.next_pow2(esc_count), esc_cap)
    index_np = np.zeros(bucket, dtype=np.int32)
    index_np[:min(esc_count, bucket)] = np.arange(min(esc_count, bucket))
    index = torch.from_numpy(index_np).to(dev)
    rows = (sched.esc_state, sched.esc_planes)
    check_same([frontier.row_maxima(*rows, index)],
               [frontier.row_maxima_reference(*rows, index)], "K6 row_maxima")
    widths = frontier.pack_widths(*rows, *(int(v) for v in scalars[8:12]))
    packed_rows = frontier.pack_rows(*rows, index, *widths)
    check_same(packed_rows, frontier.pack_rows_reference(*rows, index,
                                                         *widths), "K6 pack")
    reset_k, reset_p = convert.clone(sched), convert.clone(sched)
    frontier.reset_esc(reset_k)
    frontier.reset_esc_reference(reset_p)
    assert_same(reset_k, reset_p, "K6 reset_esc")
    pack_bytes = sum(t.numel() * t.element_size() for t in packed_rows)
    b_ms, b_by = bound_ms(2 * pack_bytes + bucket * 4, 0)
    maxima_ms = event_ms(lambda _: frontier.row_maxima(*rows, index), 50)
    reset_ms = event_ms(lambda _: frontier.reset_esc(reset_k), 50)
    # each entry's grid as its last launch recorded it (the maxima over
    # more than one block at the drain's rows), its device time by launch,
    # and the plan lookup of the pool's rows (key against last call)
    k6_grid = ops.pack_rows_grid()
    if k6_grid["row_maxima"][0] < 2:
        raise AssertionError(f"K6 row_maxima over {bucket} rows launched {k6_grid}")

    def by_launch(fn, names):
        times = device_times(fn, 20)
        return {name: named_ms(times, (name,)) for name in names}

    k6_device = {
        **by_launch(lambda _: frontier.row_maxima(*rows, index),
                    ("row_maxima_kernel", "row_maxima_combine_kernel")),
        **by_launch(lambda _: frontier.pack_rows(*rows, index, *widths),
                    ("pack_rows_kernel",)),
        **by_launch(lambda _: frontier.reset_esc(reset_k), ("reset_esc_kernel",))}
    frontier.pack_rows(*rows, index, *widths)
    k6_lookup = lookup_us(ops._ROW_PLANS, lambda: list(rows[0]) + list(rows[1]), ())
    records.append({
        "name": "pack_rows", "route": "cuda",
        "source": "mythril_tpu_torch/kernels/pack_rows.cu",
        "replaces": "mythril_tpu/parallel/frontier.py:156", "max_abs_err": 0,
        "ms": event_ms(lambda _: frontier.pack_rows(*rows, index, *widths),
                       50),
        "device_ms": k6_device["pack_rows_kernel"],
        "plain_ms": event_ms(lambda _: frontier.pack_rows_reference(
            *rows, index, *widths), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no single PyTorch call packs the row fields",
        "row_maxima_ms": maxima_ms, "reset_esc_ms": reset_ms,
        "device_ms_by_kernel": k6_device, "grid": k6_grid,
        "lookup": k6_lookup, "rows": bucket,
        "held_by": "phase frontier_programs"})

    # K7: a gather and a scatter of 32 lanes
    lanes = torch.arange(32, dtype=torch.int32, device=dev) * 4 % LANES
    gathered = frontier.gather_rows(state, planes, lanes)
    for got, ref in zip(gathered, frontier.gather_rows_reference(
            state, planes, lanes)):
        assert_same(got, ref, "K7 gather")
    targets = (torch.arange(32, dtype=torch.int32, device=dev) * 4 + 1) % LANES
    scat_k = [convert.clone(t) for t in (state, planes)]
    scat_p = [convert.clone(t) for t in (state, planes)]
    frontier.scatter_rows(*scat_k, targets, *gathered)
    frontier.scatter_rows_reference(*scat_p, targets, *gathered)
    assert_same(scat_k[0], scat_p[0], "K7 scatter state")
    assert_same(scat_k[1], scat_p[1], "K7 scatter planes")
    # clamped gather indices, dropped scatter pads, separate source leaves
    odd = torch.tensor([-5, 3, LANES + 7, LANES - 1, 0, 2 ** 31 - 1, -2 ** 31, 9],
                       dtype=torch.int32, device=dev)
    odd_rows = frontier.gather_rows(state, planes, odd)
    odd_ref = frontier.gather_rows_reference(state, planes, odd)
    for got, ref in zip(odd_rows, odd_ref):
        assert_same(got, ref, "K7 gather, clamped indices")
    pads = torch.tensor([7, -1, LANES, 40, 2 ** 31 - 1, 11, -2 ** 31, 100],
                        dtype=torch.int32, device=dev)
    drop_k = [convert.clone(t) for t in (state, planes)]
    drop_p = [convert.clone(t) for t in (state, planes)]
    frontier.scatter_rows(*drop_k, pads, *odd_ref)
    frontier.scatter_rows_reference(*drop_p, pads, *odd_ref)
    assert_same(drop_k[0], drop_p[0], "K7 scatter state, dropped pads")
    assert_same(drop_k[1], drop_p[1], "K7 scatter planes, dropped pads")
    # the cold-SLOAD service's shapes (Frontier._gather_host, _scatter_host):
    # the paused lanes' rows into one flat buffer, the index padded to a
    # power of two with its first lane; back from that buffer's views to
    # other lanes, the pad rows sent to the drop index LANES
    n_state = len(B.StateBatch._fields)
    for cold in ([5], [9, 3], [17, 2, 40]):
        bucket = B.next_pow2(len(cold))
        index = torch.tensor(cold + cold[:1] * (bucket - len(cold)),
                             dtype=torch.int32, device=dev)
        flat, slabs = frontier.gather_rows_flat(state, planes, index)
        views = B.row_views(flat, slabs)
        rows = (B.StateBatch(*views[:n_state]),
                symstep.SymPlanes(*views[n_state:]))
        for got, ref in zip(rows, frontier.gather_rows_reference(
                state, planes, index)):
            assert_same(got, ref, f"K7 flat gather of {len(cold)} rows")
        back = torch.tensor([(lane + 1) % LANES for lane in cold]
                            + [LANES] * (bucket - len(cold)),
                            dtype=torch.int32, device=dev)
        cold_k = [convert.clone(t) for t in (state, planes)]
        cold_p = [convert.clone(t) for t in (state, planes)]
        frontier.scatter_rows(*cold_k, back, *rows)
        frontier.scatter_rows_reference(*cold_p, back, *rows)
        assert_same(cold_k[0], cold_p[0],
                    f"K7 scatter state of {len(cold)} rows")
        assert_same(cold_k[1], cold_p[1],
                    f"K7 scatter planes of {len(cold)} rows")
    row_bytes = fr.row_bytes
    leaves = list(state) + list(planes)
    lanes64 = lanes.to(torch.int64)

    def library_gather(_):
        return [torch.index_select(leaf, 0, lanes64) for leaf in leaves]

    g_rows = list(gathered[0]) + list(gathered[1])
    dst = [leaf.clone() for leaf in leaves]
    targets64 = targets.to(torch.int64)

    def library_scatter(_):
        for leaf, block in zip(dst, g_rows):
            leaf.index_copy_(0, targets64, block)

    b_ms, b_by = bound_ms(2 * 32 * row_bytes + 32 * 4, 0)
    records.append({
        "name": "gather_rows", "route": "cuda",
        "source": "mythril_tpu_torch/kernels/gather_rows.cu",
        "replaces": "mythril_tpu/parallel/frontier.py:79", "max_abs_err": 0,
        "ms": event_ms(lambda _: frontier.gather_rows(state, planes, lanes),
                       50),
        "device_ms": device_ms(lambda _: frontier.gather_rows(
            state, planes, lanes), 20),
        "plain_ms": event_ms(lambda _: frontier.gather_rows_reference(
            state, planes, lanes), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": event_ms(library_gather, 20),
        "library": "torch.index_select per leaf (46 calls)",
        "blocks": ops.rows_plan(state, planes, lanes).blocks,
        "scatter_ms": event_ms(lambda _: frontier.scatter_rows(
            *scat_k, targets, *gathered), 50),
        "scatter_device_ms": device_ms(lambda _: frontier.scatter_rows(
            *scat_k, targets, *gathered), 20),
        "library_device_ms": device_ms(library_gather, 20),
        "scatter_plain_ms": event_ms(lambda _: frontier.scatter_rows_reference(
            *scat_p, targets, *gathered), 20),
        "scatter_library_ms": event_ms(library_scatter, 20),
        "held_by": "phase frontier_programs"})

    # K8: the first drain's arena delta (an empty mirror, then [1, arena_n))
    arena_n, arena_nc = int(scalars[6]), int(scalars[7])
    d_bucket = min(max(B.next_pow2(arena_n - 1), 16), arena.capacity)
    d_cbucket = min(max(B.next_pow2(arena_nc), 16), arena.const_vals.shape[0])
    check_same(A.fetch_delta(arena, 1, 0, d_bucket, d_cbucket),
               [t.cpu() for t in A.fetch_delta_reference(
                   arena, 1, 0, d_bucket, d_cbucket)], "K8")
    # the whole refresh, from the launch to the mirror landed (HostArena's
    # delta fetch, its landing in host memory and the mirror's copy), of
    # that delta into an emptied mirror, host clock
    mirror = A.HostArena(arena, 1, 0)

    def refresh():
        mirror.n, mirror.n_const = 1, 0
        mirror.refresh(arena, arena_n, arena_nc)

    refresh()
    for col in A.ROW_COLS:
        if not np.array_equal(getattr(mirror, col)[1:arena_n],
                              getattr(arena, col)[1:arena_n].cpu().numpy()):
            raise AssertionError(f"K8's refresh: mirror column {col} differs")
    if not np.array_equal(mirror.const_vals[:arena_nc], arena.const_vals[
            :arena_nc].cpu().numpy().view(np.uint32)):
        raise AssertionError("K8's refresh: mirror consts differ")
    # a refresh is one launch on its plan: 20 refreshes launch K8 20 times
    # and allocate no device memory, and their profile holds K8 and no
    # copy (CUPTI drops a few of the copy stream's kernel records)
    def twenty(_):
        before = ops.LAUNCHES["arena_delta"]
        for _ in range(20):
            refresh()
        return ops.LAUNCHES["arena_delta"] - before

    allocations = torch.cuda.memory_stats()["allocation.all.allocated"]
    _, launched, events = profile_cuda(twenty, "K8 refresh")
    k8_profile = {event.key: event.count for event in events}
    if torch.cuda.memory_stats()["allocation.all.allocated"] != allocations \
            or launched != 20 or any("emcpy" in key for key in k8_profile) \
            or not any("arena_delta_kernel" in key for key in k8_profile):
        raise AssertionError(f"K8's refresh is not one launch: {launched} "
                             f"launches, profile {k8_profile}")
    cols = [getattr(arena, col) for col in A.ROW_COLS]
    host_rows = torch.empty((6, d_bucket), dtype=torch.int32, pin_memory=True)
    host_consts = torch.empty((d_cbucket, 16), dtype=torch.int32,
                              pin_memory=True)

    def library_delta():
        for position, col in enumerate(cols):
            host_rows[position].copy_(col.narrow(0, 1, d_bucket),
                                      non_blocking=True)
        host_consts.copy_(arena.const_vals.narrow(0, 0, d_cbucket),
                          non_blocking=True)
        torch.cuda.current_stream().synchronize()

    # the device-to-pinned copy rate of this card (64 MiB)
    big = torch.empty(1 << 26, dtype=torch.uint8, device=dev)
    big_host = torch.empty(1 << 26, dtype=torch.uint8, pin_memory=True)
    pinned_rate = (1 << 26) / (event_ms(lambda _: big_host.copy_(
        big, non_blocking=True), 5) * 1e-3)
    del big, big_host
    delta_bytes = 6 * d_bucket * 4 + d_cbucket * 64
    b_ms = max(bound_ms(delta_bytes, 0)[0],
               delta_bytes / pinned_rate * 1e3)
    records.append({
        "name": "arena_delta", "route": "cuda",
        "source": "mythril_tpu_torch/kernels/arena_delta.cu",
        "replaces": "mythril_tpu/parallel/arena.py:185", "max_abs_err": 0,
        "ms": host_us(refresh) / 1e3,
        "ms_is": "host clock, launch to mirror landed (HostArena.refresh)",
        "fetch_ms": host_us(lambda: [t.cpu() for t in A.fetch_delta(
            arena, 1, 0, d_bucket, d_cbucket)]) / 1e3,
        "device_ms": launch_ms(lambda _: A.fetch_delta(
            arena, 1, 0, d_bucket, d_cbucket), 20, "arena_delta_kernel"),
        "plain_ms": host_us(lambda: [t.cpu() for t in A.fetch_delta_reference(
            arena, 1, 0, d_bucket, d_cbucket)], 50) / 1e3,
        "plain_is": "host clock, the twin on the card, landed by .cpu()",
        "bound_ms": b_ms, "bound_by": "bytes",
        "bound_is": "the delta read once at 3.35 TB/s, or written to the "
                    "host once at the measured pinned rate (the larger)",
        "pinned_bytes_per_s": pinned_rate, "delta_bytes": delta_bytes,
        "library_ms": host_us(library_delta) / 1e3,
        "library": "narrow + copy_ into pinned host tensors (7 calls) and "
                   "a wait, host clock",
        "refresh_profile": k8_profile,
        "held_by": "phase frontier_programs"})
    emit({"phase": "frontier_programs", "esc_count": esc_count,
          "esc_rows": esc_cap, "drain_bucket": bucket,
          "pack_widths": list(widths), "pack_bytes": pack_bytes,
          "gather_lanes": 32, "delta": [d_bucket, d_cbucket],
          "max_abs_err": 0, "chunk_graph_lookup": chunk_lookup,
          "ms": {r["name"]: r["ms"] for r in records}})
    return records


#: the drain loop's calls a chunk's host time is split by (HOST_CALLS[:-1])
#: and the rest of the chunk's host time ("other")
HOST_CALLS = ("run_chunk", "steal_pass", "summary_read", "decode", "drain",
              "other")


def drive_frontier(fr, seeds, by_chunk: bool = False) -> dict:
    """Seed and run one DeviceFrontier with the launch counts zeroed just
    before and read just after; returns the run's timing record. Each
    chunk's host time (from one `run_chunk` call to the next, or to the
    run's end) is split by call: the chunk's enqueue, the steal pass, the
    summary with its read (which waits for the chunk's device work), the
    decode, the drain (escape fetch and flush, deferral, spill, reseed) and
    the rest; the record holds the mean per chunk and, with `by_chunk`,
    every chunk's."""
    state, planes = fr.seed(seeds)
    chunk_events = []
    drain_s, setup_s = [0.0], [0.0]
    chunk_host = []   # per chunk: {call: seconds}, and its start
    run_chunk = symstep.run_chunk
    steal_pass, summary_read = frontier.steal_pass, frontier.summary_read

    def host_timed(fn, total=None, call=None):
        def run(*args, **kwargs):
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent = time.perf_counter() - start
                if total is not None:
                    total[0] += spent
                if call and chunk_host:
                    chunk_host[-1][call] += spent
        return run

    def timed_chunk(*args):
        chunk_host.append({**{call: 0.0 for call in HOST_CALLS},
                           "start": time.perf_counter()})
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_chunk(*args)
        end.record()
        chunk_events.append((start, end))
        chunk_host[-1]["run_chunk"] = time.perf_counter() \
            - chunk_host[-1]["start"]
        return out

    for name in ("_fetch_escapes", "_flush_backlog", "_defer_lanes",
                 "_spill_host", "_reseed_host"):
        setattr(fr, name, host_timed(getattr(fr, name), drain_s, "drain"))
    fr._decode_summary = host_timed(fr._decode_summary, call="decode")
    fr.new_sched = host_timed(fr.new_sched, setup_s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    symstep.run_chunk = timed_chunk
    frontier.steal_pass = host_timed(steal_pass, call="steal_pass")
    frontier.summary_read = host_timed(summary_read, call="summary_read")
    ops.reset_launches()
    start = time.perf_counter()
    try:
        fr.run(state, planes)
        torch.cuda.synchronize()
    finally:
        symstep.run_chunk = run_chunk
        frontier.steal_pass, frontier.summary_read = steal_pass, summary_read
    end = time.perf_counter()
    wall = end - start
    launches = dict(ops.LAUNCHES)
    chunk_ms = sum(s.elapsed_time(e) for s, e in chunk_events)
    chunks = max(fr.chunks, 1)
    for index, record in enumerate(chunk_host):
        until = chunk_host[index + 1]["start"] if index + 1 < len(chunk_host) \
            else end
        record["other"] = until - record.pop("start") - sum(
            record[call] for call in HOST_CALLS[:-1])
    host = {call: [record[call] * 1e3 for record in chunk_host]
            for call in HOST_CALLS}
    timing = {"launches": launches, "replays": dict(ops.REPLAYS),
              "wall_s": wall, "setup_ms": setup_s[0] * 1e3,
              "chunk_stream_ms": chunk_ms / chunks,
              "host_ms_per_chunk": (wall * 1e3 - chunk_ms) / chunks,
              "drain_host_ms_per_chunk": drain_s[0] * 1e3 / chunks,
              "host_ms_by_call": {call: sum(values) / chunks
                                  for call, values in host.items()},
              "lane_steps_per_s": fr.lane_steps / wall,
              "peak_device_bytes": torch.cuda.max_memory_allocated()}
    if by_chunk:
        timing["host_ms_by_chunk"] = host
    return timing


#: K4's CUDA functions (K9 is the TEL instantiation of the counting ones)
K4_KERNELS = ("sym_seed_count_kernel", "sym_seed_seg_kernel",
              "sym_seed_apply_kernel", "sym_move_kernel",
              "sym_classify_kernel", "sym_alloc_count_kernel",
              "sym_alloc_seg_kernel", "sym_planes_kernel",
              "sym_esc_seg_kernel", "sym_esc_apply_kernel",
              "sym_fork_seg_kernel", "sym_fork_apply_kernel")

#: CUDA function -> the port kernel (wrapper) that launches it (K9 runs
#: inside K4's launches: its device time is phase telemetry's; the folded
#: K3 allocations run inside K4's sym_alloc_*/sym_planes launches and
#: K10's merge_alloc_seg/merge_nodes launches)
KERNEL_OF = {
    "keccak_rows_kernel": "keccak", "keccak_step_kernel": "keccak",
    "evm_step_kernel": "evm_step", "arena_alloc_kernel": "arena_alloc",
    **{name: "sym_step" for name in K4_KERNELS},
    "frontier_summary_kernel": "frontier_summary",
    "frontier_summary_combine_kernel": "frontier_summary",
    "merge_hash_kernel": "merge_pass", "merge_pair_kernel": "merge_pass",
    "merge_keys_kernel": "merge_pass", "merge_sort_stage_kernel": "merge_pass",
    "merge_pairs_kernel": "merge_pass",
    "merge_check_kernel": "merge_pass", "merge_nodes_kernel": "merge_pass",
    "merge_alloc_seg_kernel": "merge_pass",
    "merge_apply_kernel": "merge_pass", "merge_blocked_kernel": "merge_pass",
    "steal_plan_kernel": "steal_pass", "steal_move_kernel": "steal_pass",
    "row_maxima_kernel": "pack_rows", "row_maxima_combine_kernel": "pack_rows",
    "pack_rows_kernel": "pack_rows",
    "reset_esc_kernel": "pack_rows", "gather_rows_kernel": "gather_rows",
    "scatter_rows_kernel": "gather_rows",
    "arena_delta_kernel": "arena_delta"}


def k4_table(times: dict, steps: float = 1.0) -> dict:
    """K4's CUDA functions as instantiated ("sym_classify_kernel<true>")
    from `{profiler key: (device ms, launches)}` over `steps` steps: each
    one's device ms a launch and launches a step."""
    table = {}
    for key, (ms, calls) in times.items():
        name = key.split("(")[0].split()[-1]
        if name.split("<")[0] in K4_KERNELS and calls:
            table[name] = {"ms_per_launch": ms / calls,
                           "launches_per_step": calls / steps}
    return table


def k9_increments(tel: dict, plain: dict) -> dict:
    """K9's device time by launch: for each of K4's functions, its device
    ms a launch in the telemetry run (the TEL instantiation, or the
    untemplated function) minus that in the plain run (the TEL = false
    instantiation), and that difference a step; `total` sums the steps'."""
    out, total = {}, 0.0
    for name in K4_KERNELS:
        on = tel.get(f"{name}<true>") or tel.get(name)
        off = plain.get(f"{name}<false>") or plain.get(name)
        if on is None or off is None:
            continue
        k9 = on["ms_per_launch"] - off["ms_per_launch"]
        out[name] = {"tel_ms": on["ms_per_launch"],
                     "plain_ms": off["ms_per_launch"], "k9_ms": k9,
                     "launches_per_step": on["launches_per_step"],
                     "k9_ms_per_step": k9 * on["launches_per_step"]}
        total += k9 * on["launches_per_step"]
    out["total"] = {"k9_ms_per_step": total}
    return out


def k9_eager(snapshot, steps: int) -> tuple:
    """K9 by launch over `steps` eager steps from `snapshot` (a tree with
    the plane armed), with the plane and without it: both walk the same
    states, since the plane changes nothing else. Returns (increments,
    K4's device ms a step with the plane, without it)."""
    on = [convert.clone(t) for t in snapshot]
    off = [convert.clone(t) for t in snapshot]
    off[3] = off[3]._replace(telemetry=None)
    tables = [k4_table(device_times(lambda _, tree=tree: ops.sym_step(*tree),
                                    steps, counts=True))
              for tree in (on, off)]
    step_ms = [sum(f["ms_per_launch"] * f["launches_per_step"]
                   for f in table.values()) for table in tables]
    return k9_increments(*tables), step_ms[0], step_ms[1]


def ptxas_side_by_side(source: str, names) -> dict:
    """ptxas's registers, stack frame and spills of each function's TEL
    (`<true>`) and plain (`<false>`) instantiations, side by side
    (`untemplated` for a function with one)."""
    out = {}
    for mangled, info in build.ptxas_report(source).items():
        name = next((n for n in names if n in mangled), None)
        if name is None:
            continue
        kind = ("tel" if "ILb1E" in mangled else
                "plain" if "ILb0E" in mangled else "untemplated")
        out.setdefault(name, {})[kind] = info
    return out


#: K4's launches over lanes (many blocks a launch); the rest run one block
K4_MANY_BLOCKS = ("sym_seed_count_kernel", "sym_seed_apply_kernel",
                  "sym_move_kernel", "sym_classify_kernel",
                  "sym_alloc_count_kernel", "sym_planes_kernel",
                  "sym_esc_apply_kernel", "sym_fork_apply_kernel")


def global_atomics(source: str, names) -> dict:
    """Global-memory atomic instructions (RED, ATOM; not the shared ATOMS)
    in the SASS of each instantiation of `names` in the built `source`,
    as cuobjdump lists it: {function: {"tel" | "plain" | "untemplated": n}}."""
    import re

    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build.library_path(source)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            mangled = found.group(1)
            name = next((n for n in names if n in mangled), None)
            current = None
            if name is not None:
                kind = ("tel" if "ILb1E" in mangled else
                        "plain" if "ILb0E" in mangled else "untemplated")
                current = counts.setdefault(name, {}).setdefault(kind, [0])
            continue
        if current is not None and re.search(r"\b(RED|REDG|ATOM|ATOMG)\.", line):
            current[0] += 1
    return {name: {kind: n[0] for kind, n in kinds.items()}
            for name, kinds in counts.items()}


def profiled_run(make, seeds) -> tuple:
    """Run the drain loop again, on a DeviceFrontier from make(), under
    torch.profiler (CUPTI): (the frontier, its record of device time per
    port kernel and for everything else on the card (copies, fills,
    PyTorch's own kernels), and the share of the run's wall time the card
    was idle). Profiling slows the host, so the wall here is longer than
    the unprofiled run's."""
    def prepare():
        fr = make()
        return fr, fr.seed(seeds), ops.LAUNCHES["evm_step"]

    def run(prepared):
        fr, (state, planes), _ = prepared
        start = time.perf_counter()
        fr.run(state, planes)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3

    def complete(events):
        counts = [sum(e.count for e in events if f"{name}_kernel" in e.key)
                  for name in ("keccak_step", "evm_step")]
        return counts[0] == counts[1]

    (fr, _, steps), wall_ms, events = profile_cuda(run, "profiled_run",
                                                   prepare, complete)
    steps = max(ops.LAUNCHES["evm_step"] - steps, 1)
    by_kernel = {name: 0.0 for name in ops.LAUNCHES}
    device_calls = {name: 0 for name in ops.LAUNCHES}
    step_split = {"keccak_step": 0.0, "evm_step": 0.0}
    step_calls = {name: 0 for name in step_split}
    other_ms = 0.0
    for event in events:
        ms = event.self_device_time_total / 1e3
        if "sha_prep" in event.key:
            raise AssertionError(f"sha_prep launched: {event.key}")
        for name in step_split:
            if f"{name}_kernel" in event.key:
                step_split[name] += ms
                step_calls[name] += event.count
        owner = next((kernel for function, kernel in KERNEL_OF.items()
                      if function in event.key), None)
        if owner is None:
            other_ms += ms
        else:
            by_kernel[owner] += ms
            device_calls[owner] += event.count
    busy_ms = sum(by_kernel.values()) + other_ms
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    if step_calls["keccak_step"] != step_calls["evm_step"]:
        raise AssertionError(f"a step launched K1 other than once: {step_calls}")
    return fr, {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "step_device_ms_per_step": {name: ms / steps
                                            for name, ms in step_split.items()},
                "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
                "kernel_device_ms": by_kernel, "device_calls": device_calls,
                "other_device_ms": other_ms,
                "k4_functions": k4_table(
                    {event.key: (event.self_device_time_total / 1e3,
                                 event.count) for event in events}, steps)}


def checked_run(make, seeds, totals, expected: dict, what: str,
                tables=None) -> int:
    """One more drive of a DeviceFrontier from make() with every summary it
    reads (K5 and its copy to the host) held word for word to the twin on the
    same tensors, its totals(fr) to `expected` and, given `tables`, the
    tables it built for itself to them; returns the summaries checked."""
    read, checked = frontier.summary_read, [0]

    def check(state, planes, arena, sched):
        got = read(state, planes, arena, sched)
        ref = frontier.summary_reference(state, planes, arena, sched)
        if not np.array_equal(got, ref.cpu().numpy()):
            raise AssertionError(f"{what}: K5 disagrees with its twin at "
                                 f"summary {checked[0]}")
        checked[0] += 1
        return got

    fr = make()
    frontier.summary_read = check
    try:
        fr.run(*fr.seed(seeds))
    finally:
        frontier.summary_read = read
    check_totals(totals(fr), expected, f"{what} (summaries checked)")
    if tables is not None:
        check_tables(fr, tables, f"{what} (summaries checked)")
    return checked[0]


def check_totals(totals: dict, expected: dict, what: str) -> None:
    if totals != expected:
        diff = {k: (totals.get(k), v) for k, v in expected.items()
                if totals.get(k) != v}
        raise AssertionError(f"{what} differs from the JAX reference: {diff}")


def phase_static_tables() -> None:
    """The port's static analysis on the host: for each of static_codes(),
    the tables `frontier.static_tables` builds, held to EXPECTED_STATIC (the
    JAX static analysis's), the cold build (a fresh Disassembly per code:
    the CFA, absint and taint passes as `DeviceFrontier.seed` warms them,
    then the tables; median of 5) and the memoized lookup (median of 200)."""
    record = {}
    for name, codes in static_codes().items():
        cold = []
        for _ in range(5):
            disassemblies = {}
            start = time.perf_counter()
            frontier.warm_static(codes, disassemblies)
            tables = frontier.static_tables(codes,
                                            disassemblies=disassemblies)
            cold.append(time.perf_counter() - start)
        counts = table_counts(tables)
        if counts != EXPECTED_STATIC[name]:
            raise AssertionError(f"static_tables {name}: {counts} differs "
                                 f"from the JAX analysis's "
                                 f"{EXPECTED_STATIC[name]}")
        record[name] = {**counts, "codes": len(codes),
                        "code_bytes": sum(len(code) for code in codes),
                        "cold_ms": float(np.median(cold)) * 1e3,
                        "memo_us": host_us(lambda: frontier.static_tables(
                            codes, disassemblies=disassemblies))}
    emit({"phase": "static_tables", "tables": record})


def phase_frontier(dev) -> tuple:
    # the first run of the process pays one-time costs (pinned host pages,
    # the copy stream, pool allocations); the second is the steady state
    cold = frontier.DeviceFrontier(LANES, device=dev, **OFF)
    cold_wall = drive_frontier(cold, stress_seed(N_BRANCHES))["wall_s"]
    check_totals(frontier_totals(cold), EXPECTED_FRONTIER, "cold frontier")
    fr = frontier.DeviceFrontier(LANES, device=dev, **OFF)
    timing = drive_frontier(fr, stress_seed(N_BRANCHES), by_chunk=True)
    totals = frontier_totals(fr)
    check_totals(totals, EXPECTED_FRONTIER, "frontier")
    # one K8 plan (and pinned staging) served every refresh of the drive
    delta_plan = ops.delta_plan(fr.arena, fr.harena._key)
    if delta_plan.launches != timing["launches"]["arena_delta"]:
        raise AssertionError(f"K8: {delta_plan.launches} of the drive's "
                             f"{timing['launches']['arena_delta']} refreshes "
                             "on its mirror's plan")
    replay, profiled = profiled_run(
        lambda: frontier.DeviceFrontier(LANES, device=dev, **OFF),
        stress_seed(N_BRANCHES))
    check_totals(frontier_totals(replay), EXPECTED_FRONTIER, "profiled frontier")
    checked = checked_run(lambda: frontier.DeviceFrontier(LANES, device=dev, **OFF),
                          stress_seed(N_BRANCHES), frontier_totals,
                          EXPECTED_FRONTIER, "frontier")
    emit({"phase": "frontier", "contract": f"dispatcher(branchy({N_BRANCHES}))",
          "lanes": LANES, "chunk": fr.chunk, "row_bytes": fr.row_bytes,
          "drain_batch": fr.drain_batch, "arena_capacity": fr.arena.capacity,
          **totals, **timing, "cold_wall_s": cold_wall,
          "k8_plan": {"refreshes": delta_plan.launches,
                      "staging_slot_words": delta_plan.slot_words},
          "profiled": profiled, "summaries_checked": checked})
    return timing, profiled


def phase_frontier_spill(dev) -> dict:
    def make():
        return frontier.DeviceFrontier(SPILL_LANES, device=dev,
                                       stack_bytes=SPILL_STACK_ROWS * 39306,
                                       **OFF)

    fr = make()
    timing = drive_frontier(fr, stress_seed(SPILL_BRANCHES))
    if fr.row_bytes != 39306:
        raise AssertionError(f"row bytes {fr.row_bytes} != 39306")
    totals = frontier_totals(fr)
    check_totals(totals, EXPECTED_SPILL, "frontier_spill")
    if not (fr.spilled and fr.reseeded and fr.frozen_rows):
        raise AssertionError("the spill run missed a path")
    checked = checked_run(make, stress_seed(SPILL_BRANCHES), frontier_totals,
                          EXPECTED_SPILL, "frontier_spill")
    emit({"phase": "frontier_spill",
          "contract": f"dispatcher(branchy({SPILL_BRANCHES}))",
          "lanes": SPILL_LANES, "stack_rows": SPILL_STACK_ROWS,
          **totals, **timing, "summaries_checked": checked})
    return timing


# ---- phases 10-13: the default configuration ---------------------------------------

#: telemetry tags of phase telemetry: pcs the planes contracts' lanes pass
#: and one no lane reaches; contexts 0..2 -> fleet slots
TEL_TAG_PCS = [5, 13, 0x1B, 0x40, 0x7FF]
TEL_FLEET_SLOTS = [0, 1, 0]


def phase_telemetry(dev) -> dict:
    """K9 (K4's TEL instantiation) and K5's tail vs the twins."""
    codes = [assemble(dispatcher({"planes()": PLANES_SOURCE})),
             assemble(dispatcher(KILLBILLY)),
             assemble(dispatcher({"stress()": branchy_contract(3)}))]
    tree = seed_frontier(dev, codes, base_sym=[1])
    tree[3] = tree[3]._replace(telemetry=symstep.new_telemetry(
        TEL_TAG_PCS, TEL_FLEET_SLOTS, 2, device=dev))
    plain = [convert.clone(t) for t in tree]
    snapshot = None
    for chunk in range(2):
        tree = list(symstep.run_chunk(*tree, CHUNK))
        plain = list(symstep.run_chunk_reference(*plain, CHUNK))
        for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                  tree, plain):
            assert_same(got, ref, f"telemetry chunk {chunk} {kind}")
        check_same([frontier.summary(*tree)],
                   [frontier.summary_reference(*plain)], "K5 telemetry tail")
        if chunk == 0:
            snapshot = [convert.clone(t) for t in tree]
        drain(tree, at_stop=False)
        drain(plain, at_stop=False, reset=frontier.reset_esc_reference)
    words = symstep.telemetry_words(tree[3].telemetry).cpu().tolist()
    lifecycle = dict(zip(symstep.LIFECYCLE_NAMES, tree[3].telemetry
                         .lifecycle.cpu().tolist()))
    if not (lifecycle["cold_sloads"] and lifecycle["esc_buffered"]
            and lifecycle["forks_claimed"]):
        raise AssertionError(f"the telemetry run missed a path: {lifecycle}")

    # K9's device cost per step and by launch: the TEL instantiation against
    # the plain one, a chunk of eager steps each from the same snapshot; at
    # 2048 lanes from one graphed chunk of wide_tree's 256 seeds with the
    # plane armed, its escape rows drained
    by_launch, on_ms, off_ms = k9_eager(snapshot, CHUNK)
    wide = wide_tree(dev, 1)
    wide[3] = wide[3]._replace(telemetry=symstep.new_telemetry(
        TEL_TAG_PCS, TEL_FLEET_SLOTS, 2, device=dev))
    wide = list(symstep.run_chunk(*wide, CHUNK))
    frontier.reset_esc(wide[3])
    wide_by_launch, wide_on_ms, wide_off_ms = k9_eager(wide, 16)
    registers = ptxas_side_by_side("sym_step", K4_KERNELS)
    # no launch over lanes adds to the plane with a global atomic: the TEL
    # instantiations of K4's many-block launches hold none (the plain
    # classify holds the executed count's, which shows the search works)
    atomics = global_atomics("sym_step", K4_KERNELS)
    shared = {name: kinds for name, kinds in atomics.items()
              if name in K4_MANY_BLOCKS and kinds.get("tel")}
    if shared or not atomics.get("sym_classify_kernel", {}).get("plain"):
        raise AssertionError(f"K9: global atomics in the many-block TEL "
                             f"launches: {shared} (found {atomics})")
    plain_on = [convert.clone(t) for t in snapshot]
    plain_off = [convert.clone(t) for t in snapshot]
    plain_off[3] = plain_off[3]._replace(telemetry=None)
    # the twin's plane costs the device time of its counting ops: the same
    # on-off difference over every CUDA function of the twin step (its
    # event-timed step is host-bound and spreads by more than the plane)
    plain_on_ms = device_ms(
        lambda _: symstep.sym_step_reference(*plain_on), 16)
    plain_off_ms = device_ms(
        lambda _: symstep.sym_step_reference(*plain_off), 16)
    plain_ms = plain_on_ms - plain_off_ms
    tel = snapshot[3].telemetry
    # the plane's words read and written once, two scratch words per lane
    nbytes = 2 * 8 * int(symstep.telemetry_words(tel).shape[0]) \
        + LANES * (2 * 4 * 2 + 4) + 4 * (len(TEL_TAG_PCS)
                                         + len(TEL_FLEET_SLOTS))
    b_ms, b_by = bound_ms(nbytes, LANES * (4 + len(TEL_TAG_PCS)))
    emit({"phase": "telemetry", "contracts": ["planes()", "KILLBILLY",
                                              "branchy(3)"],
          "chunks": 2, "tag_pcs": TEL_TAG_PCS, "fleet_slots": TEL_FLEET_SLOTS,
          "telemetry_words": words, "max_abs_err": 0,
          "step_device_ms": {"tel": on_ms, "plain": off_ms,
                             "k9": on_ms - off_ms},
          "wide_step_device_ms": {"lanes": WIDE_LANES, "tel": wide_on_ms,
                                  "plain": wide_off_ms,
                                  "k9": wide_on_ms - wide_off_ms},
          "k9_by_launch": {"lanes_128": by_launch,
                           f"lanes_{WIDE_LANES}": wide_by_launch},
          "ptxas": registers, "global_atomics": atomics,
          "twin_step_device_ms": {"tel": plain_on_ms, "plain": plain_off_ms,
                                  "plane": plain_ms}})
    return {"name": "telemetry", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/sym_step.cu",
            "replaces": "mythril_tpu/parallel/symstep.py:822",
            "max_abs_err": 0, "ms": on_ms - off_ms,
            "device_ms": on_ms - off_ms, "plain_ms": plain_ms,
            "wide_device_ms": wide_on_ms - wide_off_ms,
            "k9_by_launch_eager": {
                "lanes_128": {name: v["k9_ms_per_step"]
                              for name, v in by_launch.items()},
                f"lanes_{WIDE_LANES}": {name: v["k9_ms_per_step"]
                                        for name, v in wide_by_launch.items()}},
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": "none: no PyTorch call computes the counters",
            "held_by": "phase telemetry"}


#: the merge_kernel phase's runs: (branches, body, the tables the frontier
#: must build for itself)
MERGE_RUNS = {"branchy12": (N_BRANCHES, None, NO_TABLES),
              "mem_branchy8": (0, mem_branchy_contract(MERGE_BRANCHES),
                               mem_branchy_tables())}


def captured_merges(dev, name) -> list:
    """The (state, planes, arena, tables) each merge pass of a default
    DeviceFrontier(128) run on `name` is handed, cloned before the pass; the
    frontier builds its tables itself."""
    branches, body, tables = MERGE_RUNS[name]
    captured = []
    merge_pass = symstep.merge_pass

    def capture(state, planes, arena, *args, **kwargs):
        captured.append(([convert.clone(t) for t in (state, planes, arena)],
                         args, kwargs))
        return merge_pass(state, planes, arena, *args, **kwargs)

    fr = frontier.DeviceFrontier(LANES, device=dev)
    symstep.merge_pass = capture
    try:
        fr.run(*fr.seed(stress_seed(branches, body)))
    finally:
        symstep.merge_pass = merge_pass
    check_tables(fr, tables, f"merge_kernel {name}")
    return captured


def merge_grids(trees, tables) -> dict:
    """Blocks of each K10 launch of a pass over these lanes (up to 1024)."""
    lanes = trees[0].pc.shape[0]
    return {"merge_hash_kernel": lanes, "merge_pair_kernel": 1,
            "merge_check_kernel": lanes // 2, "merge_alloc_seg_kernel": 1,
            "merge_nodes_kernel": lanes // 2, "merge_apply_kernel": lanes // 2,
            "merge_blocked_kernel": lanes // 2}


def merge_times(trees, tables, n_rounds) -> dict:
    """One pass's event time, device time and launches by kernel, and its
    standalone K3 calls, from `trees` copied into the same tensors before
    each call."""
    work = [convert.clone(t) for t in trees]

    def fresh():
        refill(work, trees)

    def run(_):
        return ops.merge_pass(*work, *tables, n_rounds)

    def timed(_):
        fresh()
        return run(None)

    times = device_times(timed, 4, counts=True)
    launches = launch_table(times, "merge_", 1, merge_grids(trees, tables))
    ops.reset_launches()
    timed(None)
    standalone = ops.LAUNCHES["arena_alloc"]
    if standalone or ops.LAUNCHES["arena_alloc_merge"] != 1:
        raise AssertionError(f"K10 made standalone K3 calls: {ops.LAUNCHES}")
    return {"ms": event_ms(run, 5, setup=fresh),
            "device_ms": sum(row["device_ms"] for row in launches.values()),
            "launches": sum(row["launches"] for row in launches.values()),
            "by_launch": launches, "standalone_k3_calls": standalone}


def phase_merge_kernel(dev) -> dict:
    """K10 (K3's allocations folded in) vs merge_pass_reference on the
    states a default frontier hands its merge passes."""
    stats = {}
    timed = {}
    for name in MERGE_RUNS:
        captured = captured_merges(dev, name)
        if not captured:
            raise AssertionError(f"{name}: the frontier ran no merge pass")
        totals = None
        for trees, args, kwargs in captured:
            kern = [convert.clone(t) for t in trees]
            plain = [convert.clone(t) for t in trees]
            tables = symstep._merge_tables(*args, dev)
            n_rounds = kwargs["n_rounds"]
            ref = symstep.merge_pass_reference(*plain, *tables,
                                               n_rounds=n_rounds)
            got = ops.merge_pass(*kern, *tables, n_rounds)
            for kind, mine, theirs in zip(("state", "planes", "arena"),
                                          got[:3], ref[:3]):
                assert_same(mine, theirs, f"K10 {name} {kind}")
            check_same([got[3]], [ref[3]], f"K10 {name} stats")
            totals = ref[3] if totals is None else totals + ref[3]
            widened = bool(tables[1].shape[0])
            kind = "widened" if widened else "strict"
            if kind not in timed and (int(ref[3][2]) or not widened):
                timed[kind] = (trees, tables, n_rounds)
        stats[name] = {"passes": len(captured),
                       "stats": totals.cpu().tolist()}
        if not int(totals[0]):
            raise AssertionError(f"{name}: no pair merged")
    if "widened" not in timed:
        raise AssertionError("no merge pass blended memory")

    # K10's time per pass: the first strict pass of branchy(12), the first
    # widened pass that blended memory
    passes = {kind: merge_times(*timed[kind]) for kind in ("strict", "widened")}
    trees, tables, n_rounds = timed["widened"]

    def fresh():
        return [convert.clone(t) for t in trees]

    plain_ms = event_ms(lambda t: symstep.merge_pass_reference(
        *t, *tables, n_rounds=n_rounds), 3, setup=fresh)
    # the library yardstick: torch.argsort(stable=True) on the first
    # round's sort keys, against K10's own bitonic sort
    state, planes, arena = trees
    static_h = symstep._merge_hash(state, planes, symstep.MERGE_WEAK_LEAVES
                                   + symstep.MERGE_MEM_LEAVES)
    cc, _, last, conds_abs, eligible = symstep._merge_keys(state, planes)
    h = symstep._merge_fold(static_h, conds_abs) * symstep._H_PRIME + cc
    keys = torch.where(eligible, ((h & symstep._H_MASK) << 1)
                       | (last > 0).to(torch.int64), symstep._H_SENTINEL)
    library_ms = event_ms(lambda _: torch.argsort(keys, stable=True), 50)
    # each input read once: the lanes' rows of every leaf the pass reads;
    # each output written once: the new arena nodes and consts
    read = sum(leaf[0].numel() * leaf.element_size()
               for leaf in list(state) + list(planes))
    after = ops.merge_pass(*fresh(), *tables, n_rounds)[2]
    new_nodes = int(after.n) - int(arena.n)
    new_consts = int(after.n_const) - int(arena.n_const)
    b_ms, b_by = bound_ms(LANES * read + new_nodes * 7 * 4 + new_consts * 64,
                          0)
    widened = passes["widened"]
    emit({"phase": "merge_kernel", "runs": stats, "n_rounds": n_rounds,
          "max_abs_err": 0, "passes": passes,
          "plain_ms_per_pass": plain_ms, "argsort_ms": library_ms})
    return {"name": "merge_pass", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/merge_pass.cu",
            "replaces": "mythril_tpu/parallel/symstep.py:1057",
            "max_abs_err": 0, "per": "widened pass (mem_branchy(8), 128 lanes)",
            "ms": widened["ms"], "device_ms": widened["device_ms"],
            "strict_ms": passes["strict"]["ms"],
            "strict_device_ms": passes["strict"]["device_ms"],
            "launches_per_pass": {kind: p["launches"]
                                  for kind, p in passes.items()},
            "standalone_k3_calls_per_pass": {
                kind: p["standalone_k3_calls"] for kind, p in passes.items()},
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "library": "torch.argsort(stable=True) on the first round's keys "
                       "(the pass's sort only)",
            "held_by": "phase merge_kernel"}


def phase_frontier_default(dev, off_timing, off_profiled) -> dict:
    """The default configuration on branchy(12), beside phase frontier's
    telemetry-and-merge-off run of the same contract."""
    fr = frontier.DeviceFrontier(LANES, device=dev)
    timing = drive_frontier(fr, stress_seed(N_BRANCHES))
    totals = default_totals(fr)
    check_totals(totals, EXPECTED_DEFAULT, "frontier_default")
    check_tables(fr, NO_TABLES, "frontier_default")
    replay, profiled = profiled_run(
        lambda: frontier.DeviceFrontier(LANES, device=dev),
        stress_seed(N_BRANCHES))
    check_totals(default_totals(replay), EXPECTED_DEFAULT,
                 "profiled frontier_default")
    checked = checked_run(lambda: frontier.DeviceFrontier(LANES, device=dev),
                          stress_seed(N_BRANCHES), default_totals,
                          EXPECTED_DEFAULT, "frontier_default", NO_TABLES)
    emit({"phase": "frontier_default",
          "contract": f"dispatcher(branchy({N_BRANCHES}))", "lanes": LANES,
          **totals, **timing, "profiled": profiled,
          "summaries_checked": checked,
          "off": {"wall_s": off_timing["wall_s"],
                  "idle_share": off_profiled["idle_share"],
                  "device_busy_ms": off_profiled["device_busy_ms"]},
          "wall_ratio_on_off": timing["wall_s"] / off_timing["wall_s"],
          "k9_by_launch": k9_increments(profiled["k4_functions"],
                                        off_profiled["k4_functions"])})
    return timing, profiled


def phase_frontier_merge(dev) -> dict:
    """The default configuration on mem_branchy(8), on the tables the
    frontier builds for itself: the tag trigger and the widened rounds."""
    tables = mem_branchy_tables()
    fr = frontier.DeviceFrontier(LANES, device=dev)
    timing = drive_frontier(fr, stress_seed(
        0, mem_branchy_contract(MERGE_BRANCHES)))
    totals = default_totals(fr)
    check_totals(totals, EXPECTED_MERGE, "frontier_merge")
    check_tables(fr, tables, "frontier_merge")
    if not (fr.mem_blends and fr.merges):
        raise AssertionError("frontier_merge blended no memory")
    checked = checked_run(
        lambda: frontier.DeviceFrontier(LANES, device=dev),
        stress_seed(0, mem_branchy_contract(MERGE_BRANCHES)), default_totals,
        EXPECTED_MERGE, "frontier_merge", tables)
    emit({"phase": "frontier_merge",
          "contract": f"dispatcher(mem_branchy({MERGE_BRANCHES}))",
          "lanes": LANES, "tables": table_counts(fr.tables()),
          **totals, "tag_merges": fr.tag_merges, "ite_depth": fr.ite_depth,
          **timing, "summaries_checked": checked})
    return timing


# ---- phases 14-15: the chunk graph and 2048 lanes ---------------------------------

def phase_graph_chunk(dev) -> dict:
    """`run_chunk`'s CUDA graph against eager `sym_step` calls from the
    same state at the default geometry, branchy(12): telemetry and merging
    off, on (a merge pass between chunks, in place), and on with 4 shards
    (a seed in each block); every leaf, the arena and the scheduler after
    each chunk. After the first chunk the graphed side's tensors are
    rebound to copies, which must recapture."""
    code = assemble(dispatcher({"stress()": branchy_contract(N_BRANCHES)}))
    empty = symstep._merge_tables(np.zeros(0, np.int32), None, None, dev)
    cases = {}
    for name, armed, n_shards in (("off", False, 1), ("on", True, 1),
                                  ("d4", True, SHARDS)):
        placed = {lane: code for lane in range(0, LANES, LANES // n_shards)}
        tel = symstep.new_telemetry(TEL_TAG_PCS, device=dev) if armed else None
        graphed = sharded_tree(dev, placed, telemetry=tel, n_shards=n_shards)
        eager = [convert.clone(t) for t in graphed]
        ops.reset_launches()
        ops._GRAPHS.clear()  # every case captures its own
        for chunk in range(3):
            graphed = list(symstep.run_chunk(*graphed, CHUNK))
            eager = list(symstep.run_chunk(*eager, CHUNK, graph=False))
            for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                      graphed, eager):
                assert_same(got, ref, f"graph_chunk {name} chunk {chunk} {kind}")
            for tree in (graphed, eager):
                frontier.reset_esc(tree[3])
                if armed:
                    symstep.merge_pass(*tree[:3], *empty, n_rounds=frontier.MERGE_ROUNDS)
            if chunk == 0:
                graphed = [convert.clone(t) for t in graphed]
        replays = {kind: ops.REPLAYS[kind] for kind in ("run_chunk", "captures")}
        if replays != {"run_chunk": 3, "captures": 2}:
            raise AssertionError(f"graph_chunk {name}: {dict(ops.REPLAYS)}")
        cases[name] = {"forks": int(eager[3].forks),
                       "pushes": int(eager[3].pushes),
                       "executed": int(eager[3].executed), **replays}
    emit({"phase": "graph_chunk", "contract": f"dispatcher(branchy({N_BRANCHES}))",
          "lanes": LANES, "chunk": CHUNK, "chunks": 3, "cases": cases,
          "max_abs_err": 0})
    return cases


#: phase wide_lanes: a branchy(12) seed every 8 lanes, pools of two rows
#: a lane
WIDE_STACK_ROWS = 2 * WIDE_LANES
WIDE_ESC_ROWS = 2 * WIDE_LANES


def wide_tree(dev, n_shards: int):
    """[state, planes, arena, sched] at 2048 lanes and the default row
    geometry: a branchy(12) seed on every 8th lane, the rest DEAD."""
    code = assemble(dispatcher({"stress()": branchy_contract(N_BRANCHES)}))
    state = B.build_batch([B.LaneSpec(code=code, gas_limit=10_000_000)]
                          * WIDE_LANES, device=dev)
    planes = symstep.SymPlanes.empty(WIDE_LANES, state.stack.shape[1],
                                     state.memory.shape[1],
                                     state.storage_keys.shape[1], MAX_CONDS,
                                     device=dev)
    seeds = torch.arange(0, WIDE_LANES, 8, device=dev)
    state.status.fill_(B.DEAD)
    state.status[seeds] = B.RUNNING
    planes.ctx_id[seeds] = torch.arange(len(seeds), dtype=torch.int32,
                                        device=dev)
    sched = symstep.new_scheduler(state, planes, WIDE_STACK_ROWS,
                                  WIDE_ESC_ROWS, n_shards=n_shards)
    return [state, planes, A.new_arena(device=dev), sched]


def phase_wide_lanes(dev) -> dict:
    """K4 (K3 folded in) and K10 at 2048 lanes against their twins on the
    card: one graphed chunk from 256 branchy(12) seeds at D = 1 and D = 2,
    every leaf; then one merge pass (strict rounds, the sort above 1024
    lanes) on the D = 1 chunk's state. K4's device time per step there."""
    record = {}
    end = None
    for n_shards in (1, 2):
        tree = wide_tree(dev, n_shards)
        plain = [convert.clone(t) for t in tree]
        tree = list(symstep.run_chunk(*tree, CHUNK))
        plain = list(symstep.run_chunk_reference(*plain, CHUNK))
        for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                  tree, plain):
            assert_same(got, ref, f"wide_lanes d{n_shards} {kind}")
        record[f"d{n_shards}"] = {"forks": int(plain[3].forks),
                                  "pushes": int(plain[3].pushes),
                                  "escapes": int(plain[3].esc_count.sum()),
                                  "executed": int(plain[3].executed)}
        if n_shards == 1:
            end = tree
    if not record["d1"]["pushes"]:
        raise AssertionError(f"wide_lanes pushed nothing: {record}")
    tables = symstep._merge_tables(np.zeros(0, np.int32), None, None, dev)
    kern = [convert.clone(t) for t in end[:3]]
    plain = [convert.clone(t) for t in end[:3]]
    got = ops.merge_pass(*kern, *tables, frontier.MERGE_ROUNDS)
    ref = symstep.merge_pass_reference(*plain, *tables, n_rounds=frontier.MERGE_ROUNDS)
    for kind, mine, theirs in zip(("state", "planes", "arena"), got[:3],
                                  ref[:3]):
        assert_same(mine, theirs, f"wide_lanes merge {kind}")
    check_same([got[3]], [ref[3]], "wide_lanes merge stats")
    step = [convert.clone(t) for t in end]
    frontier.reset_esc_reference(step[3])
    k4_ms = device_ms(lambda _: ops.sym_step(*step), 16, K4_KERNELS)
    emit({"phase": "wide_lanes", "lanes": WIDE_LANES, "chunk": CHUNK,
          "seeds": WIDE_LANES // 8, "stack_rows": WIDE_STACK_ROWS,
          "esc_rows": WIDE_ESC_ROWS, **record,
          "merge_stats": ref[3].cpu().tolist(),
          "k4_device_ms_per_step": k4_ms, "max_abs_err": 0})
    return record


def phase_frontier_wide(dev) -> tuple:
    """DeviceFrontier(2048) in the default configuration on branchy(12)
    until the tree drains, held to the JAX `_Frontier(n_lanes=2048)`'s
    counters, digests and telemetry words; its wall and lane-steps/s. As in
    phase frontier, a cold run first takes the process's one-time costs at
    this width."""
    cold = frontier.DeviceFrontier(WIDE_LANES, device=dev)
    cold_wall = drive_frontier(cold, stress_seed(N_BRANCHES))["wall_s"]
    check_totals(default_totals(cold), EXPECTED_WIDE, "cold frontier_wide")
    fr = frontier.DeviceFrontier(WIDE_LANES, device=dev)
    timing = drive_frontier(fr, stress_seed(N_BRANCHES))
    totals = default_totals(fr)
    check_totals(totals, EXPECTED_WIDE, "frontier_wide")
    replays = dict(ops.REPLAYS)
    replay, profiled = profiled_run(
        lambda: frontier.DeviceFrontier(WIDE_LANES, device=dev),
        stress_seed(N_BRANCHES))
    check_totals(default_totals(replay), EXPECTED_WIDE, "profiled frontier_wide")
    checked = checked_run(
        lambda: frontier.DeviceFrontier(WIDE_LANES, device=dev),
        stress_seed(N_BRANCHES), default_totals, EXPECTED_WIDE, "frontier_wide")
    # the same drive with telemetry and merging off (no merge pass runs at
    # this width): K9 by launch, the graphed TEL functions against these
    off, off_profiled = profiled_run(
        lambda: frontier.DeviceFrontier(WIDE_LANES, device=dev, **OFF),
        stress_seed(N_BRANCHES))
    if off.lane_steps != fr.lane_steps:
        raise AssertionError(f"frontier_wide off walked {off.lane_steps} "
                             f"lane-steps, on {fr.lane_steps}")
    k9 = k9_increments(profiled["k4_functions"], off_profiled["k4_functions"])
    emit({"phase": "frontier_wide",
          "contract": f"dispatcher(branchy({N_BRANCHES}))",
          "lanes": WIDE_LANES, "chunk": fr.chunk, "drain_batch": fr.drain_batch,
          **totals, **timing, "cold_wall_s": cold_wall, "replays": replays,
          "profiled": profiled, "summaries_checked": checked,
          "off_profiled": {key: off_profiled[key] for key in (
              "wall_ms", "device_busy_ms", "idle_share", "k4_functions")},
          "k9_by_launch": k9})
    return timing, k9


# ---- phases 14-16: the sharded frontier (K4/K5 segmented, K12) -----------------------

SHARD_STACK_ROWS = STACK_ROWS   # 768 rows a segment
SHARD_ESC_ROWS = ESC_ROWS       # 256 rows a segment
#: steal width of the full-width frontier: min(P / D, max(16, B / D))
STEAL_MAX_ROWS = min(SHARD_STACK_ROWS // SHARDS, max(16, LANES // SHARDS))


def sharded_tree(dev, placed, base_sym=(), telemetry=None, n_shards=SHARDS):
    """[state, planes, arena, sched] at the default geometry with
    `placed` = {lane: code} RUNNING (ctx_id in order), the rest DEAD, and
    a scheduler of 3072 stack and 1024 escape rows in `n_shards` shards."""
    specs = [B.LaneSpec(code=b"\x00")] * LANES
    for lane, code in placed.items():
        specs[lane] = B.LaneSpec(code=code, gas_limit=10_000_000)
    state = B.build_batch(specs, device=dev)
    planes = symstep.SymPlanes.empty(LANES, state.stack.shape[1],
                                     state.memory.shape[1],
                                     state.storage_keys.shape[1], MAX_CONDS,
                                     device=dev)
    state.status.fill_(B.DEAD)
    for index, lane in enumerate(placed):
        state.status[lane] = B.RUNNING
        planes.ctx_id[lane] = index
    for lane in base_sym:
        planes.storage_base_sym[lane] = True
    sched = symstep.new_scheduler(state, planes, SHARD_STACK_ROWS,
                                  SHARD_ESC_ROWS, telemetry=telemetry,
                                  n_shards=n_shards)
    return [state, planes, A.new_arena(device=dev), sched]


def phase_shard_step(dev) -> dict:
    """K4 and K5 with 4 shards (vector tops, segment-local ranks) vs the
    twins: the planes contracts and branchy(12), one per lane block,
    telemetry armed, 2 chunks, every leaf and the summary with its shard
    block compared."""
    placed = {0: assemble(dispatcher({"planes()": PLANES_SOURCE})),
              32: assemble(dispatcher(KILLBILLY)),
              64: assemble(dispatcher({"stress()": branchy_contract(3)})),
              96: assemble(dispatcher({"stress()": branchy_contract(
                  N_BRANCHES)}))}
    tree = sharded_tree(dev, placed, base_sym=[32],
                        telemetry=symstep.new_telemetry(
                            TEL_TAG_PCS, [0, 1, 0, 1], 2, device=dev))
    plain = [convert.clone(t) for t in tree]
    escapes = 0
    for chunk in range(2):
        tree = list(symstep.run_chunk(*tree, CHUNK))
        plain = list(symstep.run_chunk_reference(*plain, CHUNK))
        for kind, got, ref in zip(("state", "planes", "arena", "sched"),
                                  tree, plain):
            assert_same(got, ref, f"shard_step chunk {chunk} {kind}")
        check_same([frontier.summary(*tree)],
                   [frontier.summary_reference(*plain)], "K5 shard block")
        escapes += int(tree[3].esc_count.sum())
        frontier.reset_esc(tree[3])
        frontier.reset_esc_reference(plain[3])
    tops = tree[3].stack_top.tolist()
    if not (escapes and int(tree[3].pushes) and max(tops) > 0
            and min(tops) == 0):
        raise AssertionError(f"shard_step missed a path: tops {tops}, "
                             f"{escapes} escapes")

    # K4's device time per step, one chunk from the same seeds with one
    # and with four shards (the same work but for the lanes the segments
    # place), and the rows each step moved (reseeds, escapes, forks)
    def k4_chunk(n_shards):
        def chunk(_):
            fresh = sharded_tree(dev, placed, base_sym=[32], n_shards=n_shards)
            for _ in range(CHUNK):
                fresh = list(ops.sym_step(*fresh))
            moved[n_shards] = int(fresh[3].pops) + int(fresh[3].forks) \
                + int(fresh[3].esc_count.sum())
        moved = {}
        ms = device_ms(chunk, 2, K4_KERNELS)
        return ms / CHUNK, moved[n_shards] / CHUNK

    k4_d1, moved_d1 = k4_chunk(1)
    k4_d4, moved_d4 = k4_chunk(SHARDS)
    emit({"phase": "shard_step", "shards": SHARDS,
          "contracts": ["planes()", "KILLBILLY", "branchy(3)",
                        f"branchy({N_BRANCHES})"],
          "chunks": 2, "escapes": escapes, "stack_tops": tops,
          "forks": int(tree[3].forks), "pushes": int(tree[3].pushes),
          "max_abs_err": 0,
          "k4_device_ms_per_step": {"d1": k4_d1, "d4": k4_d4},
          "rows_moved_per_step": {"d1": moved_d1, "d4": moved_d4}})
    return k4_d1, k4_d4


def fill_pool(sched, seed: int) -> None:
    """Every pool leaf of the stack filled with random bytes, so that a
    misplaced or partial row copy shows."""
    gen = torch.Generator(device=sched.stack_top.device)
    gen.manual_seed(seed)
    for leaf in list(sched.stack_state) + list(sched.stack_planes):
        if leaf.dtype == torch.bool:
            leaf.copy_(torch.randint(0, 2, leaf.shape, generator=gen,
                                     device=leaf.device).bool())
        else:
            info = torch.iinfo(leaf.dtype)
            low, high = max(info.min, -(1 << 31)), min(info.max, (1 << 31) - 1)
            leaf.copy_(torch.randint(low, high, leaf.shape, generator=gen,
                                     device=leaf.device, dtype=torch.int64)
                       .to(leaf.dtype))


def steal_case(dev, tops, running, seed: int):
    """(state, sched): 128 lanes at the default geometry, `running[d]` of
    block d's lanes RUNNING, a 4-shard pool of random rows with `tops`."""
    state = B.build_batch([B.LaneSpec(code=b"\x00")] * LANES, device=dev)
    planes = symstep.SymPlanes.empty(LANES, state.stack.shape[1],
                                     state.memory.shape[1],
                                     state.storage_keys.shape[1], MAX_CONDS,
                                     device=dev)
    state.status.fill_(B.DEAD)
    block = LANES // SHARDS
    for d, count in enumerate(running):
        state.status[d * block:d * block + count] = B.RUNNING
    sched = symstep.new_scheduler(state, planes, SHARD_STACK_ROWS,
                                  SHARD_ESC_ROWS, n_shards=SHARDS)
    fill_pool(sched, seed)
    sched.stack_top.copy_(torch.tensor(tops, dtype=torch.int32))
    return state, sched


def captured_steal(dev):
    """(state, sched) the sharded frontier hands its first steal pass
    (chunk 4 of the frontier_shard run), cloned before the pass."""
    captured = []
    steal_pass = frontier.steal_pass

    def capture(state, sched, *args):
        if not captured:
            captured.append((convert.clone(state), convert.clone(sched)))
        return steal_pass(state, sched, *args)

    fr = frontier.DeviceFrontier(LANES, device=dev, n_shards=SHARDS,
                                 max_steps=4 * CHUNK)
    frontier.steal_pass = capture
    try:
        fr.run(*fr.seed(stress_seed(N_BRANCHES)))
    finally:
        frontier.steal_pass = steal_pass
    return captured[0]


#: (tops, RUNNING lanes per block, min_imbalance) of phase steal_kernel
STEAL_CASES = {
    # shards 1 and 3 rich: both pairs move STEAL_MAX_ROWS rows
    "forced": ([0, 700, 0, 500], [0, 32, 0, 0], 8),
    # every gap below the threshold: nothing moves
    "below_threshold": ([3, 5, 4, 6], [0, 0, 0, 0], 8),
    # loads 40, 40, 0, 0: the stable order pairs (2, 1) and (3, 0)
    "tied": ([40, 40, 0, 0], [0, 0, 0, 0], 8),
    # loads 760, 800, 766, 788: half the gaps (20, 11) exceed the
    # receivers' room (8, 2)
    "short_room": ([760, 768, 766, 768], [0, 32, 0, 20], 8),
}


def phase_steal_kernel(dev) -> dict:
    """K12 vs steal_pass_reference at the full geometry, every pool leaf
    and counter; its time beside the twin's, the bound and one
    index_select + index_copy_ per leaf; one pass under the sync check."""
    cases = {name: steal_case(dev, tops, running, seed)
             for seed, (name, (tops, running, _)) in enumerate(
                 STEAL_CASES.items())}
    cases["mid_run"] = captured_steal(dev)
    thresholds = {name: case[2] for name, case in STEAL_CASES.items()}
    thresholds["mid_run"] = frontier.STEAL_MIN_IMBALANCE
    moved, grids = {}, {}
    for name, (state, sched) in cases.items():
        kernel, plain = convert.clone(sched), convert.clone(sched)
        frontier.steal_pass(state, kernel, thresholds[name], STEAL_MAX_ROWS)
        grids[name] = ops.steal_pass_grid()  # as the pass's launches recorded it
        frontier.steal_pass_reference(state, plain, thresholds[name],
                                      STEAL_MAX_ROWS)
        assert_same(kernel, plain, f"K12 {name}")
        moved[name] = int(plain.steal_rows) - int(sched.steal_rows)
    expected = {"forced": 2 * STEAL_MAX_ROWS, "below_threshold": 0,
                "tied": 40, "short_room": 10}
    if any(moved[name] != count for name, count in expected.items()) \
            or not moved["mid_run"]:
        raise AssertionError(f"K12 moved {moved}")
    # the moves run on a (slot, item) grid: several copy items a row slot
    plan_blocks, plan_threads, move_blocks, move_threads = grids["forced"]
    slots = SHARDS // 2 * STEAL_MAX_ROWS
    if plan_blocks != 1 or move_blocks % slots or move_blocks // slots < 2 \
            or len(set(grids.values())) != 1:
        raise AssertionError(f"K12 launched {grids}")

    # no host synchronization in the pass (the sizes stay on the card)
    state, sched = cases["forced"]
    quiet = convert.clone(sched)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frontier.steal_pass(state, quiet, thresholds["forced"], STEAL_MAX_ROWS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    # time on the forced case (64 rows moved), each rep from the same pool
    # tensors refilled from the case (outside the timed span), as the drain
    # loop passes the same tensors pass after pass (its plan cached)
    timed = convert.clone(sched)

    def fresh():
        for (_, mine), (_, theirs) in zip(convert.leaves(timed),
                                          convert.leaves(sched)):
            mine.copy_(theirs)
        return timed

    ms = event_ms(lambda t: ops.steal_pass(state, t, 8, STEAL_MAX_ROWS), 20,
                  setup=fresh)
    lookup = lookup_us(ops._STEAL_PLANS, lambda: ops._steal_tensors(state, timed),
                       (STEAL_MAX_ROWS,))
    by_kernel = device_times(lambda _: ops.steal_pass(state, fresh(), 8,
                                                      STEAL_MAX_ROWS), 10)
    dev_split = {name: named_ms(by_kernel, (name,))
                 for name in ("steal_plan_kernel", "steal_move_kernel")}
    dev_ms = sum(dev_split.values())
    plain_ms = event_ms(lambda t: frontier.steal_pass_reference(
        state, t, 8, STEAL_MAX_ROWS), 5, setup=fresh)
    seg_pool = SHARD_STACK_ROWS // SHARDS
    src, dst = [], []
    for poor, rich, n in frontier.steal_plan(state.status, sched.stack_top,
                                             seg_pool, 8, STEAL_MAX_ROWS):
        top_r, top_p = int(sched.stack_top[rich]), int(sched.stack_top[poor])
        src += [rich * seg_pool + top_r - 1 - r for r in range(n)]
        dst += [poor * seg_pool + top_p + r for r in range(n)]
    src_t = torch.tensor(src, dtype=torch.int64, device=dev)
    dst_t = torch.tensor(dst, dtype=torch.int64, device=dev)
    pool = fresh()
    leaves = list(pool.stack_state) + list(pool.stack_planes)

    def library(_):
        for leaf in leaves:
            leaf.index_copy_(0, dst_t, leaf.index_select(0, src_t))

    library_ms = event_ms(library, 20)
    row_bytes = sum(leaf[0].numel() * leaf.element_size() for leaf in leaves)
    nbytes = 2 * len(src) * row_bytes + LANES * 4 + SHARDS * (2 * 4 + 2 * 8) + 8
    b_ms, b_by = bound_ms(nbytes, 0)
    emit({"phase": "steal_kernel", "shards": SHARDS,
          "stack_rows": SHARD_STACK_ROWS, "max_rows": STEAL_MAX_ROWS,
          "row_bytes": row_bytes, "rows_moved": moved, "max_abs_err": 0,
          "grid": {"plan": [plan_blocks, plan_threads],
                   "move": [move_blocks, move_threads],
                   "items_per_row": move_blocks // slots},
          "no_host_sync": True, "ms": ms, "device_ms": dev_ms,
          "lookup": lookup,
          "device_ms_by_kernel": dev_split,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "bound_bytes": nbytes})
    return {"name": "steal_pass", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/steal_pass.cu",
            "replaces": "mythril_tpu/parallel/frontier.py:319",
            "max_abs_err": 0, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "library": "index_select + index_copy_ per leaf (46 pairs)",
            "grid": {"plan": [plan_blocks, plan_threads],
                     "move": [move_blocks, move_threads]},
            "held_by": "phase steal_kernel"}


def phase_frontier_shard(dev, default_timing, default_profiled) -> tuple:
    """DeviceFrontier(128, n_shards=4) in the default configuration on
    branchy(12) from one seed in shard 0, held to the JAX constants; its
    wall, idle share and K4's device time per step beside the unsharded
    default run's; then the two-member fleet."""
    fr = frontier.DeviceFrontier(LANES, device=dev, n_shards=SHARDS)
    timing = drive_frontier(fr, stress_seed(N_BRANCHES))
    totals = shard_totals(fr)
    check_totals(totals, EXPECTED_SHARD, "frontier_shard")
    replay, profiled = profiled_run(
        lambda: frontier.DeviceFrontier(LANES, device=dev, n_shards=SHARDS),
        stress_seed(N_BRANCHES))
    check_totals(shard_totals(replay), EXPECTED_SHARD,
                 "profiled frontier_shard")
    checked = checked_run(
        lambda: frontier.DeviceFrontier(LANES, device=dev, n_shards=SHARDS),
        stress_seed(N_BRANCHES), shard_totals, EXPECTED_SHARD, "frontier_shard")

    def k4_step_ms(run_timing, run_profiled):
        return run_profiled["kernel_device_ms"]["sym_step"] \
            / run_timing["launches"]["sym_step"]

    emit({"phase": "frontier_shard",
          "contract": f"dispatcher(branchy({N_BRANCHES}))", "lanes": LANES,
          "shards": SHARDS, "steal_cadence": fr.steal_cadence,
          "steal_min_imbalance": fr.steal_min_imbalance,
          "steal_max_rows": STEAL_MAX_ROWS, **totals, **timing,
          "profiled": profiled, "shard_tops": fr.shard_tops.tolist(),
          "shard_fairness": fr.shard_fairness,
          "shard_imbalance": fr.shard_imbalance,
          "k12_launches": timing["launches"]["steal_pass"],
          "k4_device_ms_per_step": {
              "d4": k4_step_ms(timing, profiled),
              "d1_frontier_default": k4_step_ms(default_timing,
                                                default_profiled)},
          "unsharded": {"wall_s": default_timing["wall_s"],
                        "idle_share": default_profiled["idle_share"]},
          "summaries_checked": checked})

    names = list(FLEET_RUN)

    def make_fleet():
        return frontier.DeviceFrontier(LANES, device=dev, n_shards=SHARDS,
                                       seed_owner_index=FLEET_OWNERS,
                                       fleet_slots=list(range(len(names))),
                                       fleet_names=names)

    fleet = make_fleet()
    seeds = [seed for body in FLEET_RUN.values()
             for seed in stress_seed(0, body)]
    fleet_timing = drive_frontier(fleet, seeds)
    fleet_totals = shard_totals(fleet)
    check_totals(fleet_totals, EXPECTED_FLEET, "frontier_shard fleet")
    check_tables(fleet, fleet_tables(), "frontier_shard fleet")
    if not (fleet.mem_blends and fleet.steal_rows):
        raise AssertionError("the fleet run blended no memory or stole "
                             "no rows")
    fleet_checked = checked_run(make_fleet, seeds, shard_totals, EXPECTED_FLEET,
                                "frontier_shard fleet", fleet_tables())
    emit({"phase": "frontier_shard_fleet", "members": names,
          "owners": FLEET_OWNERS, "lanes": LANES, "shards": SHARDS,
          **fleet_totals,
          "fleet_occupancy": dict(zip(names, fleet.fleet_occupancy.tolist())),
          **fleet_timing, "summaries_checked": fleet_checked})
    return timing, profiled, fleet_timing


# ---- phases 17-19: the device SAT lane (K11) --------------------------------------

#: captured analysis queries (tests/data/smt2_corpus.tar.gz) the lane runs
#: at full width: two of the 64-tile bucket, two of the 256-tile one (V1 =
#: 65,536 for all; 32 probes)
SAT_CORPUS = "tests/data/smt2_corpus.tar.gz"
SAT_LANE_QUERIES = ("1689-24.smt2", "1540-2.smt2", "1689-28.smt2",
                    "1674-23.smt2")
#: the query the JAX lane decides in a few chunks: held to its verdict,
#: chunk count and model too
SAT_FULL_QUERY = "1689-24.smt2"
#: one dispatch flush: four queries of the 64-tile bucket, solved as one
#: batch at a short chunk
SAT_BATCH_QUERIES = ("1689-24.smt2", "1540-2.smt2", "1536-1.smt2",
                     "1689-10.smt2")
SAT_BATCH_CHUNK = 32
#: the queries above whose CNF came out the same in every process we ran
#: (24 with random hash seeds). The JAX pipeline, and the port's copy of
#: it, orders commutative operands by a hash of their children's ids
#: (terms.py), so most captured queries, the 256-tile ones among them,
#: blast to a CNF that depends on the process: those are held to their
#: sizes, the CDCL verdict and the twin on the card instead of a digest
#: (`tests/_torch_sat_constants.py stability` lists the stable ones)
STABLE_CNFS = frozenset({"1689-24.smt2", "1540-2.smt2", "1536-1.smt2",
                         "1689-10.smt2"})

#: the JAX lane's numbers for these queries, printed by
#: tests/_torch_sat_constants.py (mythril_tpu's from_smt2 ->
#: lower_constraints -> Blaster, the native CDCL core, then
#: jax_solver.solve_cnf_device with its defaults on the CPU): clause and
#: variable counts, the tile bucket, the CDCL verdict (1 SAT, 0 UNSAT); for
#: a stable CNF its sha256 (`cnf_digest`) and, on the lane, the state after
#: the first two chunks (`state_digest`); for SAT_FULL_QUERY the JAX lane's
#: verdict, chunk count and model (`model_digest`)
EXPECTED_SAT = {
    "1689-24.smt2": {
        "clauses": 57463, "n_vars": 16468, "tiles": 64, "cdcl": 1,
        "cnf": "5a0d28076df926aa5eb38cdf22bad05c1a2251da12cf66112b70460b2865d3db",
        "chunks": ["0d6f97568a404a705374e28733fb44c6d00c2fd5adc7f84ecd3cd5227da54bc5",
                   "e8a18ed68055cb63ee8552eaef0061fa74a453aa118413d206736707fec2a996"],
        "jax": {"status": 1, "chunks": 10,
                "model": "8172ea319f6368a8cc9a470ba86ca61b70fc73a21d12106a0d03bfd635ffe983"}},
    "1540-2.smt2": {
        "clauses": 58488, "n_vars": 16980, "tiles": 64, "cdcl": 1,
        "cnf": "36aecd682216cbfaa0515fc67e41e169adaa4112f26ac31eeda9dffb632a5a24",
        "chunks": ["eb76ebde3f35370980b253640a1d7b29c9d146e26a97e0eaf9c94d93b14a71d7",
                   "1e5af8eafb8c8a4c4efafebbed505e078639491af5265e08e08d9a9a0813307d"]},
    "1689-28.smt2": {
        "clauses": 143559, "n_vars": 42114, "tiles": 256, "cdcl": 1},
    "1674-23.smt2": {
        "clauses": 134237, "n_vars": 39288, "tiles": 256, "cdcl": 0},
    "1536-1.smt2": {
        "clauses": 63601, "n_vars": 17946, "tiles": 64, "cdcl": 1,
        "cnf": "3d15f7436559b31318af61f8a28668c28594d47ee357dfc33d5c0fd8b26cc3c8"},
    "1689-10.smt2": {
        "clauses": 58488, "n_vars": 16980, "tiles": 64, "cdcl": 1,
        "cnf": "f3dde26bfc2a494a6a2160a721e5e84d9bf9694d4f0d99d638d5a20ffa996907"},
}
#: the JAX batch runner's state after the first chunk of SAT_BATCH_QUERIES
#: (jax_solver.solve_cnf_device_batch, chunk SAT_BATCH_CHUNK)
EXPECTED_SAT_BATCH = \
    "5118d7baf4d0e1f264d333ecb4e6b5b975196d9ae37051337f9013580e71b13f"


def sha256_of(*arrays) -> str:
    sha = hashlib.sha256()
    for array in arrays:
        sha.update(np.ascontiguousarray(array).tobytes())
    return sha.hexdigest()


def cnf_digest(clauses, n_vars: int) -> str:
    """sha256 of int32 LE [n_vars, n_clauses, clause 0's literals, 0, ...]."""
    flat = [n_vars, len(clauses)]
    for clause in clauses:
        flat.extend(clause)
        flat.append(0)
    return sha256_of(np.asarray(flat, dtype="<i4"))


def state_digest(leaves) -> str:
    """sha256 of a SolverState's five leaves (assign, trail, tag,
    trail_len, status), C order, as numpy arrays or tensors."""
    return sha256_of(*[leaf.cpu().numpy() if isinstance(leaf, torch.Tensor)
                       else leaf for leaf in leaves])


def model_digest(model) -> str:
    return sha256_of(np.asarray(model, dtype=np.uint8))


def corpus_text(name: str) -> str:
    """The SMT-LIB2 text of one captured query."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SAT_CORPUS)
    with tarfile.open(path) as tar:
        return tar.extractfile(name).read().decode("utf-8")


def blast(constraints):
    """(clauses, n_vars, lowered constraints, blaster) of a constraint list
    through the port's lower_constraints -> Blaster."""
    lowered, _ = preprocess.lower_constraints(list(constraints))
    blaster = Blaster()
    for node in lowered:
        blaster.assert_true(node)
    return blaster.clauses, blaster.n_vars, lowered, blaster


def corpus_query(name: str):
    """(clauses, n_vars, lowered constraints, blaster) of one captured
    query through the port's from_smt2 -> lower_constraints -> Blaster."""
    # fresh names from 0, as if the query were the first of its process
    # (no incremental pipeline may lower anything after this: its pool's
    # fresh names would come round again)
    preprocess._fresh_counter = itertools.count()
    return blast(from_smt2(corpus_text(name)))


def check_model(clauses, lowered, blaster, model, what: str) -> None:
    """A SAT model holds every clause and every lowered constraint."""
    values = np.concatenate([[False], np.asarray(model, dtype=bool)])
    lits = np.zeros((len(clauses), 3), dtype=np.int64)
    for i, clause in enumerate(clauses):
        lits[i, :len(clause)] = clause
    hit = np.where(lits > 0, values[np.abs(lits)], ~values[np.abs(lits)])
    if not (hit & (lits != 0)).any(axis=1).all():
        raise AssertionError(f"{what}: the model falsifies a clause")

    def bit(lit):
        return bool(values[abs(lit)]) != (lit < 0)

    assignment = {var: bit(lit) for var, lit in blaster.var_lits.items()}
    for var, bits in blaster.var_bits.items():
        assignment[var] = sum(int(bit(lit)) << i for i, lit in enumerate(bits))
    for node in lowered:
        if terms.evaluate(node, assignment) is not True:
            raise AssertionError(f"{what}: the model falsifies a constraint")


#: the K11 fixtures: opposite-phase races inside one tile and across two
#: (the higher clause index lands), the no-flip backtrack, 32 probes on a
#: 3-SAT instance deep enough for their forced prefixes, implications and
#: a backtrack spread over the whole variable range; pad variables in
#: all. (name, clauses, n_vars, probes)
def sat_fixtures() -> list:
    return [("race_tile", [[-1, 2], [-1, -2], [3, 4]], 4, 2),
            ("race_tiles", [[-1, -2]] * 2100 + [[-1, 2]], 2, 2),
            ("no_flip", [[1, 2], [1, -2], [-1, 3], [-1, -3]], 3, 2),
            ("prefix32", three_sat(9), 60, 32),
            ("spread", spread_cnf(), 900, 2)]


def spread_cnf() -> list:
    """Var 1 is decided first (in the forced prefix), var 2 next (FALSE,
    flippable); that implies vars 3..402 at once, they imply 403..802, a
    phase race on 802 and then a conflict follow, and the backtrack to var
    2 clears 800 trail entries: appends and clears across every tile of a
    small variable tile."""
    spread = range(3, 403)
    return ([[1, s, s + 400] for s in spread] + [[1, 803, 804]]
            + [[2, s] for s in spread] + [[-s, s + 400] for s in spread]
            + [[-402, -802]])


def three_sat(seed: int, n_vars: int = 60, n_clauses: int = 250) -> list:
    """Random 3-SAT without unit clauses: deep enough to search."""
    rng = random.Random(seed)
    return [[rng.choice([-1, 1]) * v
             for v in rng.sample(range(1, n_vars + 1), 3)]
            for _ in range(n_clauses)]


def sat_batch_fixture() -> list:
    """A bucket of 4 queries for the batch runner; the second decides in
    its first steps, so the freeze holds it while the others step."""
    return [(three_sat(10), 60), ([[1, 2], [-1, 2], [-2, 3], [-3]], 3),
            (three_sat(11), 60), (three_sat(12), 60)]


def sat_compare(state, tensors, chunk, n_chunks, n_probes, freeze, what,
                graphs=(True, False), var_tile=ops.SAT_VAR_TILE):
    """K11 against run_chunk_reference from one state, every leaf after
    each chunk, once for each of `graphs` (the chunk's CUDA graph, eager
    launches); returns the kernel's final state."""
    depth = device_solver.forced_depth_of(n_probes)
    plain = convert.clone(state)
    kerns = [convert.clone(state) for _ in graphs]
    for index in range(n_chunks):
        device_solver.run_chunk_reference(plain, tensors, chunk, depth, freeze)
        for kern, graph in zip(kerns, graphs):
            ops.sat_run(kern, tensors, chunk, depth, freeze, graph, var_tile)
            mode = "graphed" if graph else "eager"
            assert_same(kern, plain, f"K11 {what} {mode} chunk {index}")
    return kerns[0]


def sat_step_bytes(before, after, tensors) -> int:
    """The least bytes one step of one query moved, from the state before
    and after it: `valid` read once and the literals of each real clause;
    every probe's status, and each searching probe's assignment row, its
    tags inside the trail and its trail length; `order` at the free vars of
    the probes that decided; the trail entries a backtrack read; each leaf
    element the step changed, written once."""
    searching = before.status == device_solver.SEARCHING
    v1 = before.assign.shape[-1]
    length, new_length = before.trail_len.long(), after.trail_len.long()
    # a decision appends one entry tagged 1 or 2; a backtrack shortens the
    # trail, or keeps its length with a flip at its end, or refutes the cube
    appended = after.tag.gather(-1, length.clamp(max=v1 - 1)[..., None])[..., 0]
    decided = searching & (new_length == length + 1) & (appended >= 1)
    refuted = searching & (after.status == device_solver.S_UNSAT)
    flipped = searching & (after.status == device_solver.SEARCHING) \
        & (new_length <= length)
    free = (before.assign == 0) & decided[..., None]  # unassigned
    trail_read = (torch.where(refuted, length, 0)
                  + torch.where(flipped, length - new_length + 1, 0))
    reads = (tensors.valid.numel() + 12 * int(tensors.valid.sum())
             + before.status.numel()
             + int(searching.sum()) * (v1 + 4)
             + int(torch.where(searching, length, 0).sum())
             + 4 * int(free.any(dim=-2).sum()) + 4 * int(trail_read.sum()))
    writes = sum(int((old != new).sum()) * old.element_size()
                 for old, new in zip(before, after))
    return reads + writes


def sat_mean_step_bytes(state, tensors, steps: int, depth: int,
                        n_shards: int = 0) -> float:
    """`sat_step_bytes` of one step, averaged over the `steps` steps from
    `state`, stepped on a copy by the twin (with `n_shards`, the sharded
    twin)."""
    total = 0
    before = convert.clone(state)
    for _ in range(steps):
        after = convert.clone(before)
        if n_shards:
            device_solver.run_chunk_sharded_reference(after, tensors, 1,
                                                      depth, n_shards)
        else:
            device_solver.run_chunk_reference(after, tensors, 1, depth)
        total += sat_step_bytes(before, after, tensors)
        before = after
    return total / steps


def sat_bound_ms_per_step(state, tensors, steps: int, depth: int) -> tuple:
    """bound_ms of one K11 step, averaged over the `steps` steps from
    `state`."""
    return bound_ms(sat_mean_step_bytes(state, tensors, steps, depth), 0)


#: K11's variable tile in the fixtures' second pass: V1 1,024 over 16 blocks
SAT_SMALL_TILE = 64


def phase_sat_kernel(dev) -> dict:
    """K11, graphed and eager, vs its twin on the fixtures (at the card's
    variable tile and at a small one) and at full width on a query of each
    bucket; its time per step there, by launch."""
    for var_tile in (ops.SAT_VAR_TILE, SAT_SMALL_TILE):
        for name, clauses, n_vars, n_probes in sat_fixtures():
            problem = device_solver.build_problem(clauses, n_vars)
            tensors = device_solver.device_problem(problem, dev)
            state = device_solver.initial_state(problem.init_assign, n_probes,
                                                dev)
            sat_compare(state, tensors, 2, 6, n_probes, False, name,
                        var_tile=var_tile)
        problems = [device_solver.build_problem(c, n)
                    for c, n in sat_batch_fixture()]
        tensors = device_solver.device_problem(problems, dev)
        state = device_solver.initial_state(
            np.stack([p.init_assign for p in problems]), 8, dev)
        sat_compare(state, tensors, 4, 5, 8, True, "batch", var_tile=var_tile)

    # full width, both buckets: 64 compared steps, graphed and eager, then
    # the time per step
    depth = device_solver.forced_depth_of(32)
    steps = 64
    timings = {}
    for name in ("1689-24.smt2", "1689-28.smt2"):
        clauses, n_vars, _, _ = corpus_query(name)
        problem = device_solver.build_problem(clauses, n_vars)
        tensors = device_solver.device_problem(problem, dev)
        state = device_solver.initial_state(problem.init_assign, 32, dev)
        state = sat_compare(state, tensors, 32, 2, 32, False, name)
        v1 = problem.order.shape[0]
        n_clauses = problem.valid.size
        tiles = 32 * -(-v1 // ops.SAT_VAR_TILE)
        # propagate: a thread per clause and group of four probes
        grids = {"sat_mirror_kernel": -(-v1 * 32 // 256),
                 "sat_propagate_kernel": -(-n_clauses * 8 // 256),
                 "sat_count_kernel": tiles, "sat_apply_kernel": tiles}
        if tiles < 132:
            raise AssertionError(f"{name}: resolve launches {tiles} blocks")
        work = convert.clone(state)

        def fresh(graph=True):
            refill([work], [state])
            return graph

        def run(graph):
            return ops.sat_run(work, tensors, steps, depth, False, graph)

        b_ms, b_by = sat_bound_ms_per_step(state, tensors, steps, depth)
        times = device_times(lambda _: run(fresh()), 2, counts=True)
        launches = launch_table(times, "sat_", steps, grids)
        ops.reset_launches()
        timings[name] = {
            "tiles": problem.lits.shape[0], "v1": v1,
            "ms_per_step": event_ms(run, 3, setup=fresh) / steps,
            "eager_ms_per_step": event_ms(
                run, 3, setup=lambda: fresh(False)) / steps,
            "device_ms_per_step": sum(
                row["device_ms"] for row in launches.values()),
            "launches_per_step": launches,
            "replays": dict(ops.REPLAYS),
            "plain_ms_per_step": event_ms(
                lambda s: device_solver.run_chunk_reference(
                    s, tensors, 4, depth), 2,
                setup=lambda: convert.clone(state)) / 4,
            "bound_ms_per_step": b_ms, "bound_by": b_by}
    emit({"phase": "sat_kernel",
          "fixtures": [f[0] for f in sat_fixtures()] + ["batch"],
          "var_tiles": [ops.SAT_VAR_TILE, SAT_SMALL_TILE],
          "probes": 32, "compared_steps": 64, "compared": "graphed, eager",
          "max_abs_err": 0, "full_width": timings})
    main = timings["1689-24.smt2"]
    return {"name": "sat_step", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/sat_step.cu",
            "replaces": "mythril_tpu/parallel/jax_solver.py:247",
            "max_abs_err": 0, "per": "step (32 probes, 64 tiles, V1 65536)",
            "ms": main["ms_per_step"], "device_ms": main["device_ms_per_step"],
            "plain_ms": main["plain_ms_per_step"],
            "bound_ms": main["bound_ms_per_step"], "bound_by": main["bound_by"],
            "library_ms": None,
            "library": "none: no PyTorch call computes a DPLL step",
            "held_by": "phase sat_kernel"}


#: host_solver's get_model objective: 1540-2's gas, which the query bounds
#: below (bvult 2300 gas), so the search goes past its first extreme probe;
#: the optimum is the JAX package's get_model's on the same text
#: (tests/_torch_sat_constants.py)
HOST_SOLVER_QUERY = "1540-2.smt2"
HOST_SOLVER_OBJECTIVE = ("1_gas", 256)
HOST_SOLVER_OPTIMUM = 2301

VERDICT_OF = {"sat": sat.SAT, "unsat": sat.UNSAT, "unknown": sat.UNKNOWN}


def phase_host_solver() -> dict:
    """The SMT façade and the port's CDCL on the host: the EXPECTED_SAT
    queries through `Solver().check()` (the incremental pipeline) and
    through the one-shot CNF with `sat.solve_cnf`, both held to the CDCL
    verdicts, then `get_model` with an objective and a ModelCache hit.
    Returns the façade's verdicts (1 SAT, 0 UNSAT)."""
    start = time.perf_counter()
    compiled = not os.path.exists(native.library_path())
    library = native.build()
    build_s = time.perf_counter() - start
    # a fresh pipeline, and its pool lowered on one run of fresh names
    smt_solver.reset_solver_backend()
    verdicts, queries = {}, {}
    for name, want in EXPECTED_SAT.items():
        start = time.perf_counter()
        constraints = [smt.Bool(raw) for raw in from_smt2(corpus_text(name))]
        parse_s = time.perf_counter() - start
        solver = smt.Solver()
        solver.add(*constraints)
        start = time.perf_counter()
        status = solver.check()
        check_s = time.perf_counter() - start
        if VERDICT_OF[status] != want["cdcl"]:
            raise AssertionError(f"host_solver {name}: Solver says {status}, "
                                 f"CDCL {want['cdcl']}")
        if status == "sat":
            model = solver.model()
            if not all(model.eval(c) is True for c in constraints):
                raise AssertionError(f"host_solver {name}: the model "
                                     f"falsifies a constraint")
        start = time.perf_counter()
        clauses, n_vars, lowered, blaster = blast(c.raw for c in constraints)
        oneshot, bits = sat.solve_cnf(clauses, n_vars)
        oneshot_s = time.perf_counter() - start
        if oneshot != want["cdcl"]:
            raise AssertionError(f"host_solver {name}: the one-shot CNF is "
                                 f"{oneshot}, CDCL {want['cdcl']}")
        if oneshot == sat.SAT:
            check_model(clauses, lowered, blaster, bits, name)
        verdicts[name] = VERDICT_OF[status]
        queries[name] = {"verdict": status, "clauses": len(clauses),
                         "n_vars": n_vars, "parse_s": parse_s,
                         "check_s": check_s, "oneshot_s": oneshot_s}
    # get_model: the optimum, then a query the cache answers
    constraints = [smt.Bool(raw) for raw in
                   from_smt2(corpus_text(HOST_SOLVER_QUERY))]
    gas = smt.symbol_factory.BitVecSym(*HOST_SOLVER_OBJECTIVE)
    start = time.perf_counter()
    best = model_service.get_model(constraints, minimize=(gas,))
    minimize_s = time.perf_counter() - start
    if best.eval(gas) != HOST_SOLVER_OPTIMUM:
        raise AssertionError(f"host_solver: get_model's minimum "
                             f"{best.eval(gas)}, the JAX package's "
                             f"{HOST_SOLVER_OPTIMUM}")
    first = model_service.get_model(constraints)
    stats = SolverStatistics()
    solved = stats.query_count
    start = time.perf_counter()
    again = model_service.get_model(constraints + [gas == first.eval(gas)])
    cached_s = time.perf_counter() - start
    hits = int(again is first and stats.query_count == solved)
    if not hits:
        raise AssertionError("host_solver: the second get_model was not "
                             "answered from the ModelCache")
    # later phases lower corpus queries from fresh name 0: no pipeline may
    # outlive this phase
    smt_solver.reset_solver_backend()
    emit({"phase": "host_solver", "library": os.path.basename(library),
          "compiled": compiled, "build_s": build_s, "queries": queries,
          "get_model": {"query": HOST_SOLVER_QUERY,
                        "minimize": HOST_SOLVER_OBJECTIVE[0],
                        "optimum": best.eval(gas), "minimize_s": minimize_s,
                        "model_cache_hits": hits, "cached_s": cached_s}})
    return verdicts


def fresh_host_engine() -> None:
    """Reset what numbers the host engine's symbols (node uids, transaction
    ids, the keccak and exponent function managers) and the solver's
    backend, statistics and memo: a run then numbers as the JAX package's
    LaserEVM does from a fresh process."""
    node.Node._uid_counter = 0
    transaction_models.tx_id_manager.restart_counter()
    function_managers.keccak_function_manager.reset()
    function_managers.exponent_function_manager.__init__()
    smt_solver.reset_solver_backend()
    SolverStatistics().reset()
    simplify.reset_simplify_memo()


def host_engine_run(contract: str, mode: str, transaction_count: int) -> dict:
    """One `LaserEVM(engine="host").sym_exec` on a dispatcher of
    HOST_ENGINE_CONTRACTS[contract], held to EXPECTED_HOST_ENGINE."""
    fresh_host_engine()
    runtime = assemble(dispatcher(HOST_ENGINE_CONTRACTS[contract]))
    laser = svm.LaserEVM(max_depth=128, execution_timeout=HOST_ENGINE_BUDGET_S,
                         create_timeout=HOST_ENGINE_BUDGET_S,
                         transaction_count=transaction_count)
    after_tx = []
    laser.register_laser_hooks(
        "stop_sym_trans", lambda: after_tx.append(len(laser.open_states)))
    stats = SolverStatistics()
    start = time.perf_counter()
    if mode == "creation":
        laser.sym_exec(creation_code=creation_wrapper(runtime).hex(),
                       contract_name=contract)
    else:
        # the world state SymExecWrapper builds for runtime code
        world_state = WorldState()
        account = world_state.create_account(balance=10 ** 18, address=None,
                                             concrete_storage=False)
        account.code = Disassembly(runtime.hex())
        account.contract_name = contract
        laser.sym_exec(world_state=world_state,
                       target_address=account.address.value)
    seconds = time.perf_counter() - start
    counts = {"states": laser.total_states, "nodes": len(laser.nodes),
              "edges": len(laser.edges), "open_after_tx": after_tx}
    if laser.timed_out:
        raise AssertionError(f"host_engine {contract} {mode}: the budget "
                             f"of {HOST_ENGINE_BUDGET_S} s ran out")
    if counts != EXPECTED_HOST_ENGINE[contract][mode]:
        raise AssertionError(f"host_engine {contract} {mode}: {counts}, the "
                             f"JAX LaserEVM "
                             f"{EXPECTED_HOST_ENGINE[contract][mode]}")
    return {**counts, "transactions": transaction_count, "seconds": seconds,
            "states_per_s": laser.total_states / seconds,
            "solver_queries": stats.query_count,
            "solver_s": stats.solver_time}


def host_lane(spec: B.LaneSpec) -> dict:
    """One lane as a concrete message call through the host interpreter
    (core/transaction/concolic.py): the callee's storage and transient
    storage after it. The host models GAS as a fresh symbol; the step
    kernels push the gas limit less the lower-bound gas used, which the
    host accounts too (`min_gas_used`), so each GAS symbol is bound to that
    reading."""
    world_state = WorldState()
    account = world_state.create_account(balance=10 ** 18, address=MIXED_CALLEE,
                                         concrete_storage=True)
    account.code = Disassembly(spec.code.hex())
    world_state.create_account(balance=2 ** 128, address=spec.caller)
    laser = svm.LaserEVM(max_depth=8000, execution_timeout=HOST_ENGINE_BUDGET_S,
                         requires_statespace=False)
    laser.open_states = [world_state]
    gas = {}

    def read_gas(state):
        gas[state.mstate.stack[-1].raw] = \
            state.mstate.gas_limit - state.mstate.min_gas_used

    laser.register_instr_hooks("post", "GAS", read_gas)
    concolic.execute_message_call(
        laser, callee_address=MIXED_CALLEE, caller_address=spec.caller,
        origin_address=spec.caller, value=0, data=list(spec.calldata),
        gas_limit=spec.gas_limit, gas_price=1)
    if len(laser.open_states) != 1:
        raise AssertionError("host_engine: the host's concrete call of a "
                             "returning lane left no world state")
    post = laser.open_states[0]
    callee = post.accounts[MIXED_CALLEE]

    def bound(expression):
        raw = expression.raw
        return raw.value if raw.is_const else terms.evaluate(raw, gas)

    slot = smt.symbol_factory.BitVecVal
    return {"storage": {bound(key): bound(value) for key, value
                        in callee.storage.printable_storage.items()},
            "transient": {index: bound(post.transient_storage.get(
                callee.address, slot(index, 256)))
                for index in MIXED_TRANSIENT_SLOTS}}


def lane_tables(state, lane: int) -> dict:
    """One lane's storage and transient storage (at MIXED_TRANSIENT_SLOTS)
    as the step left them."""
    used = state.tstore_used[lane].cpu().tolist()
    keys = words.to_ints(state.tstore_keys[lane])
    values = words.to_ints(state.tstore_vals[lane])
    transient = {int(keys[i]): int(values[i])
                 for i in range(len(used)) if used[i]}
    return {"storage": B.extract_storage(state, lane),
            "transient": {index: transient.get(index, 0)
                          for index in MIXED_TRANSIENT_SLOTS}}


def phase_host_engine(dev) -> None:
    """The port's host engine: the statespace runs of HOST_ENGINE_RUNS,
    then K1 and K2 held to the host interpreter on the mixed program."""
    try:
        hashlib.new("ripemd160")
    except ValueError as error:
        raise AssertionError(f"host_engine: this Python's hashlib has no "
                             f"ripemd160, which precompile 3 needs: {error}")
    runs = {}
    for contract, transaction_count in HOST_ENGINE_RUNS:
        for mode in ("creation", "runtime"):
            runs[f"{contract}/{mode}"] = host_engine_run(
                contract, mode, transaction_count)
    fresh_host_engine()
    specs = mixed_specs(LANES)
    before = dict(ops.LAUNCHES)
    state = lockstep.step_many(B.build_batch(specs, device=dev), MIXED_STEPS)
    torch.cuda.synchronize()
    launches = {name: ops.LAUNCHES[name] - before[name]
                for name in ("keccak", "evm_step")}
    if launches != {"keccak": MIXED_STEPS, "evm_step": MIXED_STEPS}:
        raise AssertionError(f"host_engine: K1/K2 launches {launches} for "
                             f"{MIXED_STEPS} steps")
    status = state.status.cpu().tolist()
    compared = escaped = 0
    start = time.perf_counter()
    for lane, spec in enumerate(specs):
        if status[lane] == B.ESCAPED:
            escaped += 1
            continue
        if status[lane] != B.RETURNED:
            raise AssertionError(f"host_engine: mixed lane {lane} ended "
                                 f"with status {status[lane]}")
        host, device = host_lane(spec), lane_tables(state, lane)
        if host != device:
            raise AssertionError(f"host_engine: mixed lane {lane}: the host "
                                 f"interpreter left {host}, K1/K2 {device}")
        compared += 1
    host_s = time.perf_counter() - start
    fresh_host_engine()
    emit({"phase": "host_engine", "ripemd160": True,
          "runs": runs, "interpreter_vs_step": {
              "lanes": len(specs), "steps": MIXED_STEPS,
              "compared": compared, "escaped": escaped,
              "launches": launches, "host_s": host_s}})


def analyze_argv(contract, modules, transaction_count: int,
                 budget_s=None) -> list:
    """The port's CLI arguments of one analyze run of a dispatcher of
    `contract`, in creation mode."""
    code = creation_wrapper(assemble(dispatcher(contract))).hex()
    argv = ["analyze", "-c", code, "-t", str(transaction_count), "-o", "json"]
    if modules:
        argv += ["-m", modules]
    if budget_s:
        argv += ["--execution-timeout", str(budget_s)]
    return argv


def analyze_summary(report: dict, exit_code: int) -> dict:
    """What EXPECTED_ANALYZE holds of a run: its exit code and each issue's
    SWC id, title and address."""
    return {"exit": exit_code,
            "issues": [[issue["swc-id"], issue["title"], issue["address"]]
                       for issue in report["issues"]]}


def check_analyze(name: str, report: dict, exit_code: int) -> None:
    """Raise unless one of ANALYZE_RUNS gave its EXPECTED_ANALYZE."""
    got = analyze_summary(report, exit_code)
    if got != EXPECTED_ANALYZE[name]:
        raise AssertionError(f"analyze {name}: {got}, the JAX CLI "
                             f"{EXPECTED_ANALYZE[name]}")


#: the port analyzer's INFO lines the analyze phase reads
STATES_LINE = re.compile(r"analysis of \S+: (\d+) states explored")
SOLVER_LINE = re.compile(r"solver statistics: Solver statistics: query "
                         r"count: (\d+), solver time: ([0-9.]+)s")


def start_analyze(argv: list) -> tuple:
    """Start `python -m mythril_tpu_torch -v 4 <argv>` from the checkout's
    root; `finish_analyze` waits for it."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "mythril_tpu_torch", "-v", "4", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, time.perf_counter()


def finish_analyze(name: str, started: tuple, timeout_s: float) -> tuple:
    """A started run's report and a record of its exit code, host wall
    seconds, explored states and solver queries (from its log)."""
    proc, start = started
    try:
        stdout, stderr = proc.communicate(timeout=timeout_s)
    finally:
        proc.kill()
    wall = time.perf_counter() - start
    if proc.returncode not in (0, 1):
        raise AssertionError(f"analyze {name}: exit {proc.returncode}: "
                             f"{stderr[-2000:]}")
    report = json.loads(stdout)
    states = STATES_LINE.findall(stderr)
    solver = SOLVER_LINE.findall(stderr)
    if len(states) != 1 or len(solver) != 1:
        raise AssertionError(f"analyze {name}: no states or solver line "
                             f"in its log")
    states = int(states[0])
    return report, {"phase": "analyze", "run": name, "exit": proc.returncode,
                    "clock": "host", "host_wall_s": wall, "states": states,
                    "states_per_host_s": states / wall,
                    "solver_queries": int(solver[0][0]),
                    "host_solver_s": float(solver[0][1]),
                    "incomplete": bool(report.get("incomplete"))}


def phase_analyze() -> None:
    """The port's `analyze` CLI end to end on the host (--engine host):
    ANALYZE_RUNS held to EXPECTED_ANALYZE; one line a run."""
    for name, run in ANALYZE_RUNS.items():
        report, record = finish_analyze(
            name, start_analyze(analyze_argv(*run)), 300)
        if record["incomplete"]:
            raise AssertionError(f"analyze {name}: the budget ran out")
        check_analyze(name, report, record["exit"])
        emit({**record, "issues": analyze_summary(report, 0)["issues"]})


def phase_headline() -> None:
    """HEADLINE_RUNS side by side through the port's CLI, each held to its
    SWC ids unless it reports itself incomplete; one line a run."""
    started = {name: start_analyze(analyze_argv(
                   *run, budget_s=HEADLINE_BUDGET_S))
               for name, run in HEADLINE_RUNS.items()}
    missed = []
    for name, run in started.items():
        report, record = finish_analyze(name, run, HEADLINE_BUDGET_S + 600)
        found = sorted({issue["swc-id"] for issue in report["issues"]})
        emit({**record, "swc": found, "budget_s": HEADLINE_BUDGET_S})
        if found != EXPECTED_HEADLINE[name] and not record["incomplete"]:
            missed.append(f"{name}: SWC {found}, expected "
                          f"{EXPECTED_HEADLINE[name]}")
    if missed:
        raise AssertionError(f"analyze: {missed}")


def analyze_tpu_argv(name: str) -> list:
    """The CLI arguments of one of ANALYZE_TPU_RUNS."""
    if name == "killbilly_runtime":
        argv = ["analyze", "-c", assemble(dispatcher(KILLBILLY)).hex(),
                "--bin-runtime", "-t", "2", "-o", "json"]
    elif name == "spin":
        argv = analyze_argv(SPIN, None, 1)
    else:
        argv = analyze_argv(*ANALYZE_RUNS[name])
    return argv + ["--engine", "tpu"]


#: the device driver's lines, one each a transaction
FRONTIER_LINE = re.compile(
    r"frontier: (\d+) forks, (\d+) storage fault-ins, \d+ infeasible "
    r"pruned, (\d+) states materialized \+ (\d+) deferred")
PHASES_LINE = re.compile(
    r"frontier phases: \d+ lanes, (\d+) lane-steps in (\d+) chunks, device "
    r"phase ([0-9.]+) s, host continuation ([0-9.]+) s")


def tpu_summary(report: dict, exit_code: int, log_text: str) -> dict:
    """What EXPECTED_ANALYZE_TPU holds of a run, from its report and its
    log (the port's or the JAX package's: their frontier lines read
    alike)."""
    return {**analyze_summary(report, exit_code),
            "frontier": [[int(forks), int(faults), int(materialized),
                          int(deferred)] for forks, faults, materialized,
                         deferred in FRONTIER_LINE.findall(log_text)]}


class LogLines(logging.Handler):
    """Collects the messages of the records it handles."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def fresh_analysis() -> None:
    """What a fresh process starts an analysis from: the symbol counters,
    the detection modules' issues, the plugins and the analyzer's
    arguments."""
    from mythril_tpu_torch.analysis.security import reset_callback_modules
    from mythril_tpu_torch.core.plugin.loader import LaserPluginLoader
    from mythril_tpu_torch.support.support_args import args

    fresh_host_engine()
    reset_callback_modules()
    LaserPluginLoader().reset()
    args._init_defaults()


@contextlib.contextmanager
def counted(record: dict):
    """Fills `record` with the block's host wall seconds, INFO log text and
    kernel launches and graph replays."""
    before, replays = dict(ops.LAUNCHES), dict(ops.REPLAYS)
    lines, root = LogLines(), logging.getLogger()
    level = root.level
    root.addHandler(lines)
    root.setLevel(logging.INFO)
    start = time.perf_counter()
    try:
        yield record
    finally:
        root.removeHandler(lines)
        root.setLevel(level)
        record.update(
            wall=time.perf_counter() - start,
            log_text="\n".join(lines.lines),
            launches={key: ops.LAUNCHES[key] - before[key]
                      for key in ops.LAUNCHES},
            replays={key: ops.REPLAYS[key] - replays[key]
                     for key in ops.REPLAYS})


def run_cli(name: str, argv: list) -> tuple:
    """`cli.main(["-v", "4", *argv])` in this process (so that its kernel
    launches count here), from what a fresh process starts from: its exit
    code (raises unless 0 or 1), its report and `counted`'s record."""
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.support.support_args import args

    fresh_analysis()
    out = io.StringIO()
    record = {}
    try:
        with counted(record), contextlib.redirect_stdout(out):
            exit_code = cli.main(["-v", "4", *argv])
    finally:
        args._init_defaults()
    if exit_code not in (0, 1):
        raise AssertionError(f"{name}: exit {exit_code}: "
                             f"{record['log_text'][-2000:]}")
    return exit_code, json.loads(out.getvalue()), record


def analyze_tpu_run(name: str, extra=(), argv=None) -> tuple:
    """One of ANALYZE_TPU_RUNS through the port's CLI entry point in this
    process (`run_cli`), on the device `frontier.configure` names. Its
    report and a record: exit code, host wall seconds, explored states,
    solver queries and seconds, the launches, and per transaction the
    frontier's counters and its device and host phases' seconds. `extra`
    arguments follow the run's own; `argv` replaces them."""
    exit_code, report, counts = run_cli(
        f"analyze_tpu {name}", [*(argv or analyze_tpu_argv(name)), *extra])
    log_text, wall = counts["log_text"], counts["wall"]
    solver = SOLVER_LINE.findall(log_text)
    states = STATES_LINE.findall(log_text)
    phases = PHASES_LINE.findall(log_text)
    summary = tpu_summary(report, exit_code, log_text)
    if len(states) != 1 or len(solver) != 1 \
            or len(phases) != len(summary["frontier"]):
        raise AssertionError(f"analyze_tpu {name}: no states, solver or "
                             f"frontier lines in its log")
    frontier_runs = [
        {"forks": counts[0], "fault_ins": counts[1],
         "materialized": counts[2], "deferred": counts[3],
         "lane_steps": int(steps), "chunks": int(chunks),
         "device_phase_s": float(device_s), "host_continuation_s":
         float(host_s)}
        for counts, (steps, chunks, device_s, host_s)
        in zip(summary["frontier"], phases)]
    return report, summary, {
        "phase": "analyze_tpu", "run": name, "exit": exit_code,
        "clock": "host", "host_wall_s": wall, "states": int(states[0]),
        "solver_queries": int(solver[0][0]),
        "host_solver_s": float(solver[0][1]),
        "incomplete": bool(report.get("incomplete")),
        "frontier": frontier_runs, "launches": counts["launches"],
        "replays": counts["replays"]}


def check_analyze_tpu(name: str, summary: dict) -> None:
    """Raise unless one of ANALYZE_TPU_RUNS gave its EXPECTED_ANALYZE_TPU."""
    if summary != EXPECTED_ANALYZE_TPU[name]:
        raise AssertionError(f"analyze_tpu {name}: {summary}, the JAX CLI "
                             f"{EXPECTED_ANALYZE_TPU[name]}")


def phase_analyze_tpu() -> dict:
    """The port's `analyze --engine tpu` end to end on the card:
    ANALYZE_TPU_RUNS held to EXPECTED_ANALYZE_TPU; one line a run. Returns
    the phase's kernel launches."""
    frontier.configure()
    launches = {name: 0 for name in ops.LAUNCHES}
    handed_over = 0
    for name in ANALYZE_TPU_RUNS:
        report, summary, record = analyze_tpu_run(name)
        if record["incomplete"]:
            raise AssertionError(f"analyze_tpu {name}: the budget ran out")
        check_analyze_tpu(name, summary)
        emit({**record, "issues": summary["issues"]})
        for key, count in record["launches"].items():
            launches[key] += count
        handed_over += sum(tx["materialized"] for tx in record["frontier"])
    missing = [key for key in ("arena_alloc", "gather_rows", "pack_rows",
                               "sym_step") if not launches[key]]
    if missing:
        raise AssertionError(f"analyze_tpu: no launch of {missing}")
    if not handed_over:
        raise AssertionError("analyze_tpu: no live lane handed over")
    return launches


#: the analyze_jax phase's runs: ANALYZE_TPU_RUNS without SPIN, under the
#: device SAT lane with every device verdict held to the host CDCL
ANALYZE_JAX_RUNS = tuple(name for name in ANALYZE_TPU_RUNS if name != "spin")
SOLVER_JAX = ("--solver", "jax", "--device-crosscheck", "1")


def lane_record(stats) -> dict:
    """The device SAT lane's counters of one analysis (SolverStatistics):
    queries submitted, flushes and their mean occupancy, cache and dedup
    hits, verdicts the device decided and left UNKNOWN, cross-checks,
    divergences, the host oracle's answers that failed their own clauses
    (ROADMAP C) and how many of those a second ask (unit clauses first)
    proved UNSAT, classified failures, and the seconds inside flushes."""
    flushes = stats.batch_flushes
    return {"submitted": stats.batch_submitted, "flushes": flushes,
            "mean_occupancy": (stats.batch_flushed_queries / flushes
                               if flushes else 0.0),
            "cache_hits": stats.batch_cache_hits,
            "dedup_hits": stats.batch_dedup_hits,
            "device_queries": stats.device_queries,
            "device_decided": stats.device_solved,
            "unknown": stats.device_fallbacks,
            "skipped": stats.device_skipped,
            "crosschecks": stats.crosschecks,
            "divergences": stats.divergences,
            "oracle_faults": stats.oracle_faults,
            "oracle_confirmed": stats.oracle_confirmed,
            "failures": dict(stats.failure_counts),
            "flush_s": stats.batch_device_time}


def check_lane(name: str, lane: dict) -> None:
    """Raise if the device lane failed, diverged or left its breaker, or if
    a device UNSAT stood on the host oracle's faulty answer without a
    second witness."""
    from mythril_tpu_torch.support import resilience

    state = resilience.registry.backend(resilience.DEVICE).state
    if lane["failures"] or lane["divergences"] or lane["skipped"] \
            or state != resilience.CLOSED \
            or lane["oracle_confirmed"] != lane["oracle_faults"]:
        raise AssertionError(f"analyze_jax {name}: failures "
                             f"{lane['failures']}, divergences "
                             f"{lane['divergences']}, oracle faults "
                             f"{lane['oracle_faults']} of which confirmed "
                             f"{lane['oracle_confirmed']}, breaker {state}")


def phase_analyze_jax() -> dict:
    """The port's `analyze --engine tpu --solver jax --device-crosscheck 1`
    on the card: ANALYZE_JAX_RUNS held to EXPECTED_ANALYZE_TPU's exits and
    issues (the solver changes no verdict; what the device leaves UNKNOWN
    the CDCL decides), every device verdict cross-checked on the host;
    then KILLBILLY's runtime code once more with escape-time pruning, whose
    slab queues its rows' feasibility queries on the dispatch. One line a
    run; returns the phase's kernel launches."""
    launches = {name: 0 for name in ops.LAUNCHES}
    decided = 0
    runs = [(name, {}) for name in ANALYZE_JAX_RUNS] \
        + [("killbilly_runtime", {"check_escapes": True})]
    for name, settings in runs:
        frontier.configure(**settings)
        try:
            report, summary, record = analyze_tpu_run(name, SOLVER_JAX)
        finally:
            frontier.configure()
        lane = lane_record(SolverStatistics())
        if record["incomplete"]:
            raise AssertionError(f"analyze_jax {name}: the budget ran out")
        want = EXPECTED_ANALYZE_TPU[name]
        if (summary["exit"], summary["issues"]) != (want["exit"],
                                                    want["issues"]):
            raise AssertionError(f"analyze_jax {name}: {summary}, the JAX "
                                 f"CLI {want}")
        check_lane(name, lane)
        lane["k11_launches"] = record["launches"]["sat_step"]
        lane["sat_captures"] = record["replays"]["sat_captures"]
        lane["cdcl_and_host_s"] = record["host_solver_s"] - lane["flush_s"]
        decided += lane["device_decided"]
        emit({**record, "phase": "analyze_jax", "settings": settings,
              "solver": "jax", "issues": summary["issues"], "lane": lane})
        for key, count in record["launches"].items():
            launches[key] += count
    if not launches["sat_step"] or not decided:
        raise AssertionError(f"analyze_jax: K11 launched "
                             f"{launches['sat_step']} times, the device "
                             f"decided {decided} queries")
    return launches


#: the killed analysis of resume_tpu (a): a save every 5 popped host states,
#: KILLBILLY's 10th popped state kills it (3 in the first transaction's
#: host continuation, so the kill lands mid-way through the second's, after
#: a periodic save)
KILL_AT = 10
CHECKPOINT_STATES = 5
#: resume_tpu (c): runtime code whose cold SLOAD faults in a host-term
#: leaf that guards a kill 1,200 straight-line steps later, so that the
#: drive's first periodic save (16 chunks of 64: 1,024 steps) holds the
#: leaf on a lane's stack before the guard forks. KILLBILLY's runtime drive
#: faults in only after its one save, and SPIN's holds no leaf
LATE_GUARD = {
    "kill()": "PUSH1 0x00\nSLOAD\n" + "JUMPDEST\n" * 1200 +
              "PUSH1 0x01\nEQ\nPUSH @do_kill\nJUMPI\nSTOP\n"
              "do_kill:\nJUMPDEST\nCALLER\nSELFDESTRUCT",
}
LATE_GUARD_ARGV = ["analyze", "-c", assemble(dispatcher(LATE_GUARD)).hex(),
                   "--bin-runtime", "-t", "1", "-o", "json", "--engine", "tpu"]
#: resume_tpu (b): SPIN's drive saves every 16 chunks; the uninterrupted
#: drive runs 32, the continuation 16 from the first save
SAVE_CHUNKS = 16


def spin_seeds():
    return [(assemble(dispatcher(SPIN)), {}, False, 10_000_000, 0)]


def saving_drive(dev, path: str, chunks: int, load=None) -> tuple:
    """SPIN's drive on a DeviceFrontier that saves to `path` every
    SAVE_CHUNKS chunks (the escape buffer drained every chunk, so a save
    holds no scheduler rows), `chunks` chunks long; with `load`, the seeded
    trees are replaced by that .npz's. Returns the frontier, copies of the
    trees at each save, a copy of the first .npz, the graph captures of
    the first chunk, and the seeded and driven trees (alive, so that a
    later drive's tensors cannot take their addresses)."""
    fr = frontier.DeviceFrontier(LANES, device=dev,
                                 max_steps=chunks * CHUNK, drain_batch=1)
    fr.checkpoint_path = path
    seeded = fr.seed(spin_seeds())
    state, planes = fr.load_checkpoint(load) if load else seeded
    saves, first, captures = [], [], []
    periodic = fr.periodic_checkpoint

    def record(state, planes, sched):
        periodic(state, planes, sched)
        saves.append([convert.clone(tree)
                      for tree in (state, planes, fr.arena)])
        if not first:
            with np.load(path + ".npz", allow_pickle=False) as data:
                first.append({key: data[key] for key in data.files})

    run_chunk = symstep.run_chunk

    def first_chunk(*args, **kwargs):
        before = ops.REPLAYS["captures"]
        out = run_chunk(*args, **kwargs)
        if not captures:
            captures.append(ops.REPLAYS["captures"] - before)
        return out

    fr.periodic_checkpoint = record
    symstep.run_chunk = first_chunk
    try:
        fr.run(state, planes)
        torch.cuda.synchronize()
    finally:
        symstep.run_chunk = run_chunk
    return fr, saves, first, captures, (seeded, state, planes)


@contextlib.contextmanager
def device_phase_kill(saves: list):
    """`Frontier.periodic_checkpoint` wrapped to kill the analysis with
    `InjectedCrash` right after its first save that holds a host-term leaf
    (`--inject-fault host_crash` fires on popped host states only, never
    inside the device phase); each save's host-term counts go to
    `saves`."""
    from mythril_tpu_torch.support import resilience

    periodic = frontier.Frontier.periodic_checkpoint

    def save_then_kill(fr, state, planes, sched):
        periodic(fr, state, planes, sched)
        terms = [len(ctx.host_terms) for ctx in fr.contexts]
        saves.append(terms)
        if sum(terms):
            raise resilience.InjectedCrash("killed after a device save")

    with mock.patch.object(frontier.Frontier, "periodic_checkpoint",
                           save_then_kill):
        yield


@contextlib.contextmanager
def mirror_watch(seen: dict):
    """Records each `Frontier.load_checkpoint`'s restored arena rows and
    host terms, and each host-mirror refresh after it (the mirror's rows
    before and the rows asked for), into `seen`."""
    load = frontier.Frontier.load_checkpoint
    refresh = A.HostArena.refresh_async

    def watched_load(fr, path):
        out = load(fr, path)
        seen["loads"].append({"rows": int(fr.arena.n), "mirror": fr.harena,
                              "host_terms": [len(ctx.host_terms)
                                             for ctx in fr.contexts]})
        return out

    def watched_refresh(mirror, arena, used=None, used_const=None):
        if seen["loads"]:
            seen["refreshes"].append((id(mirror), mirror.n, used))
        return refresh(mirror, arena, used, used_const)

    with mock.patch.object(frontier.Frontier, "load_checkpoint",
                           watched_load), \
            mock.patch.object(A.HostArena, "refresh_async", watched_refresh):
        yield


def killed_run(name: str, argv: list) -> float:
    """One analysis in this process, killed by an `InjectedCrash`, the
    harness's stand-in for kill -9 (it unwinds past every `except
    Exception`). Returns its seconds; raises if it ended otherwise."""
    from mythril_tpu_torch.support import resilience

    start = time.perf_counter()
    try:
        analyze_tpu_run(name, argv=argv)
    except resilience.InjectedCrash:
        return time.perf_counter() - start
    raise AssertionError(f"resume_tpu: the killed {name} run ended")


def phase_resume_tpu(dev) -> dict:
    """Checkpoint and resume on the card, each analysis in this process.
    (a) `analyze --engine tpu --checkpoint P` on KILLBILLY (2
    transactions), killed by `--inject-fault host_crash:KILL_AT` in the
    host continuation; `--resume P` must give
    EXPECTED_ANALYZE_TPU["killbilly"]'s exit and issues. (c) LATE_GUARD's
    device phase killed right after a periodic save that holds a host-term
    leaf; `--resume P` goes through `Frontier.run`'s load of
    `P.device.npz` (the host terms unpickled, the contract ids and the
    transaction checked, the host mirror rebuilt from row 0 through K8)
    and must give the uninterrupted run's report. (b) SPIN's drive saved
    after 16 chunks, loaded into a fresh frontier and continued: the
    continuation's trees after 16 more chunks are bit for bit the
    uninterrupted drive's after 32, and its first chunk is a new graph
    capture. Returns the phase's kernel launches."""
    import shutil
    import tempfile

    from mythril_tpu_torch.support import checkpoint

    work = tempfile.mkdtemp(prefix="resume_tpu-")
    try:
        path = os.path.join(work, "killbilly.ckpt")
        checkpoint.configure(state_interval=CHECKPOINT_STATES)
        try:
            killed_s = killed_run("killbilly", [
                *analyze_tpu_argv("killbilly"), "--checkpoint", path,
                "--inject-fault", f"host_crash:{KILL_AT}"])
        finally:
            checkpoint.configure()
        if not os.path.exists(path) or os.path.exists(path + ".tmp"):
            raise AssertionError("resume_tpu: the killed run left no "
                                 "checkpoint, or a partial one")
        report, summary, record = analyze_tpu_run(
            "killbilly", argv=[*analyze_tpu_argv("killbilly"), "--resume",
                               path])
        want = EXPECTED_ANALYZE_TPU["killbilly"]
        if (summary["exit"], summary["issues"]) != (want["exit"],
                                                    want["issues"]):
            raise AssertionError(f"resume_tpu: the resumed run gave "
                                 f"{summary}, the JAX CLI {want}")
        launches = dict(record["launches"])

        # (c) the analyzer's device phase killed and resumed
        _, late_want, late_record = analyze_tpu_run("late_guard",
                                                    argv=LATE_GUARD_ARGV)
        late_path = os.path.join(work, "late_guard.ckpt")
        saves, seen = [], {"loads": [], "refreshes": []}
        with device_phase_kill(saves):
            late_killed_s = killed_run("late_guard", [
                *LATE_GUARD_ARGV, "--checkpoint", late_path])
        npz = late_path + ".device.npz"
        if not os.path.exists(npz) or os.path.exists(npz + ".tmp"):
            raise AssertionError("resume_tpu: the killed device phase left "
                                 "no .npz, or a partial one")
        with mirror_watch(seen):
            _, late_got, late_resumed = analyze_tpu_run(
                "late_guard", argv=[*LATE_GUARD_ARGV, "--resume", late_path])
        if (late_got["exit"], late_got["issues"]) != (
                late_want["exit"], late_want["issues"]) \
                or not late_want["issues"]:
            raise AssertionError(f"resume_tpu: LATE_GUARD resumed gave "
                                 f"{late_got}, uninterrupted {late_want}")
        loads, refreshes = seen["loads"], seen["refreshes"]
        if len(loads) != 1 or loads[0]["mirror"] is not None \
                or not sum(loads[0]["host_terms"]):
            raise AssertionError(f"resume_tpu: LATE_GUARD's resume loaded "
                                 f"{loads}")
        mirror = refreshes[0][0] if refreshes else None
        reached = [used for key, _, used in refreshes if key == mirror]
        if not refreshes or refreshes[0][1] != 0 or not any(
                used is None or used >= loads[0]["rows"] for used in reached) \
                or not late_resumed["launches"]["arena_delta"]:
            raise AssertionError(f"resume_tpu: the host mirror after the "
                                 f"load refreshed {refreshes}")
        for record_c in (late_record, late_resumed):
            for key, count in record_c["launches"].items():
                launches[key] += count

        # (b) the device phase's own .npz
        ops.reset_launches()
        uninterrupted, saves_a, first, _, alive = saving_drive(
            dev, os.path.join(work, "a"), 2 * SAVE_CHUNKS)
        npz = os.path.join(work, "first.npz")
        np.savez(npz, **first[0])
        if "pend_state_status" in first[0]:
            raise AssertionError("resume_tpu: the save holds scheduler rows")
        start = time.perf_counter()
        resumed, saves_b, _, captures, _ = saving_drive(
            dev, os.path.join(work, "b"), SAVE_CHUNKS, load=npz)
        resumed_s = time.perf_counter() - start
        if len(saves_a) != 2 or len(saves_b) != 1:
            raise AssertionError(f"resume_tpu: {len(saves_a)} and "
                                 f"{len(saves_b)} saves")
        for kind, got, ref in zip(("state", "planes", "arena"), saves_b[0],
                                  saves_a[1]):
            assert_same(got, ref, f"resume_tpu continuation {kind}")
        if captures != [1]:
            raise AssertionError(f"resume_tpu: the first chunk after the "
                                 f"load captured {captures} graphs")
        for key, count in ops.LAUNCHES.items():
            launches[key] += count
        del alive
        emit({"phase": "resume_tpu", "clock": "host",
              "killed": {"run": "killbilly", "kill_at": KILL_AT,
                         "checkpoint_states": CHECKPOINT_STATES,
                         "wall_s": killed_s},
              "resumed": {**record, "issues": summary["issues"]},
              "device_phase": {
                  "run": "late_guard", "issues": late_got["issues"],
                  "saves_host_terms": saves, "killed_wall_s": late_killed_s,
                  "restored_rows": loads[0]["rows"],
                  "restored_host_terms": loads[0]["host_terms"],
                  "mirror_refreshes": [[start_row, used] for _, start_row,
                                       used in refreshes[:4]],
                  "uninterrupted": late_record, "resumed": late_resumed},
              "npz": {"contract": "dispatcher(SPIN)", "lanes": LANES,
                      "save_chunks": SAVE_CHUNKS,
                      "saved_lane_steps": int(first[0]["counters"][3]),
                      "lane_steps": [uninterrupted.lane_steps,
                                     resumed.lane_steps],
                      "first_chunk_captures": captures[0],
                      "continuation_wall_s": resumed_s,
                      "bit_identical": True}})
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def fleet_files(directory: str) -> dict:
    """FLEET_CORPUS's creation codes, one hex file a contract: {name:
    path}."""
    paths = {}
    for name, contract in FLEET_CORPUS.items():
        paths[name] = os.path.join(directory, f"{name}.hex")
        with open(paths[name], "w") as handle:
            handle.write(creation_wrapper(assemble(dispatcher(contract)))
                         .hex())
    return paths


def fleet_argv(paths, fleet: bool = True) -> list:
    """The CLI arguments of an analysis of `paths` (one -f each) with
    --engine tpu, FLEET_MODULES and FLEET_TX; `fleet` adds --fleet."""
    return ["analyze", *[arg for path in paths for arg in ("-f", path)],
            "--engine", "tpu", *(["--fleet"] if fleet else []), "-t",
            str(FLEET_TX), "-m", FLEET_MODULES, "-o", "json"]


def fleet_issues(report: dict, names) -> dict:
    """{contract: its issues' [SWC id, title, address], sorted} of a
    report whose issues name their contracts."""
    issues = {name: [] for name in names}
    for issue in report["issues"]:
        issues[issue["contract"]].append(
            [issue["swc-id"], issue["title"], issue["address"]])
    return {name: sorted(rows, key=lambda row: (row[2], row[0]))
            for name, rows in issues.items()}


#: the fleet analyzer's counters line
FLEET_LINE = re.compile(r"fleet counters: (\{.*\})")


def fleet_counters(counters: dict, sharded: bool) -> dict:
    """What EXPECTED_ANALYZE_FLEET holds of a fleet driver's counters."""
    keys = ["phases", "lane_steps", "forks", "occupancy"]
    if sharded:
        keys += ["steal_passes", "steal_rows"]
    return {key: counters[key] for key in keys}


def preempted_fleet(fleet_module, symbolic, security) -> dict:
    """A FleetDriver over FLEET_CORPUS with FLEET_PREEMPTED's preempt event
    set before `run` (a package's `fleet_module` holding FleetDriver and
    FleetMember, its analysis.symbolic and analysis.security): {name:
    {"incomplete", "dropped_states", "issues"}}."""
    import threading

    members = []
    modules = FLEET_MODULES.split(",")
    for index, (name, contract) in enumerate(FLEET_CORPUS.items()):
        preempt = threading.Event()
        if name == FLEET_PREEMPTED:
            preempt.set()
        member = fleet_module.FleetMember(index, name, execution_timeout=600,
                                          preempt=preempt)
        code = creation_wrapper(assemble(dispatcher(contract))).hex()

        def work(member=member, code=code):
            sym = symbolic.SymExecWrapper(
                code, address=None, strategy="bfs", max_depth=128,
                execution_timeout=600, create_timeout=30,
                transaction_count=FLEET_TX, compulsory_statespace=False,
                modules=modules, engine="tpu", fleet=member)
            return security.fire_lasers(sym, modules)

        member.work = work
        members.append(member)
    fleet_module.FleetDriver(members).run()
    out = {}
    for member in members:
        if member.error is not None:
            raise AssertionError(f"preempted fleet: {member.contract_id} "
                                 f"failed: {member.traceback_str}")
        laser = member.gate_laser or member.laser
        out[member.contract_id] = {
            "incomplete": bool(getattr(laser, "timed_out", False)),
            "dropped_states": getattr(laser, "dropped_states", 0),
            "issues": sorted([issue.swc_id, issue.title, issue.address]
                             for issue in member.result)}
    return out


def check_analyze_fleet(what: str, got) -> None:
    """Raise unless `what` of EXPECTED_ANALYZE_FLEET is `got`."""
    if got != EXPECTED_ANALYZE_FLEET[what]:
        raise AssertionError(f"analyze_fleet {what}: {got}, the JAX fleet "
                             f"{EXPECTED_ANALYZE_FLEET[what]}")


def fleet_run(paths: dict, what: str) -> dict:
    """The port's CLI with --fleet over `paths` in this process: its record
    (exit, issues by contract, the driver's counters and their share a
    phase, host wall, launches), held to EXPECTED_ANALYZE_FLEET."""
    exit_code, report, counts = run_cli(f"analyze_fleet {what}",
                                        fleet_argv(paths.values()))
    counters = FLEET_LINE.findall(counts["log_text"])
    if len(counters) != 1:
        raise AssertionError(f"analyze_fleet {what}: no counters line")
    counters = json.loads(counters[0])
    issues = fleet_issues(report, paths)
    if report.get("incomplete"):
        raise AssertionError(f"analyze_fleet {what}: the budget ran out")
    check_analyze_fleet("exit", exit_code)
    check_analyze_fleet("issues", issues)
    check_analyze_fleet(what, fleet_counters(counters, what == "sharded"))
    phases = counters["phases"]
    return {"phase": "analyze_fleet", "run": what, "exit": exit_code,
            "clock": "host", "host_wall_s": counts["wall"],
            "issues": issues, **counters,
            "lane_steps_per_phase": counters["lane_steps"] / phases,
            "forks_per_phase": counters["forks"] / phases,
            "k12_launches": counts["launches"]["steal_pass"],
            "launches": counts["launches"]}


def phase_analyze_fleet() -> dict:
    """The port's `analyze --engine tpu --fleet` on the card, in this
    process: FLEET_CORPUS one by one (a CLI run a contract), then as one
    fleet at 128 lanes, held to the sequential runs' issues and to
    EXPECTED_ANALYZE_FLEET (issues and the driver's counters); the same
    fleet under FLEET_SHARDED (K12 from the analyzer, rows moved); then
    the fleet with FLEET_PREEMPTED preempted (its report incomplete with
    the JAX member's dropped states, the others complete). One line a
    run; returns the phase's kernel launches."""
    import tempfile

    from mythril_tpu_torch.analysis import security, symbolic
    from mythril_tpu_torch.parallel import fleet

    frontier.configure()
    launches = {name: 0 for name in ops.LAUNCHES}
    with tempfile.TemporaryDirectory() as directory:
        paths = fleet_files(directory)
        sequential = {}
        for name, path in paths.items():
            exit_code, report, counts = run_cli(
                f"analyze_fleet sequential {name}",
                fleet_argv([path], fleet=False))
            sequential[name] = {
                "exit": exit_code, "host_wall_s": counts["wall"],
                "issues": fleet_issues(
                    {"issues": [{**issue, "contract": name}
                                for issue in report["issues"]]},
                    [name])[name]}
            for key, count in counts["launches"].items():
                launches[key] += count
        sequential_s = sum(run["host_wall_s"] for run in sequential.values())
        emit({"phase": "analyze_fleet", "run": "sequential", "clock": "host",
              "host_wall_s": sequential_s, "runs": sequential})
        records = {}
        for what, settings in (("fleet", {}), ("sharded", FLEET_SHARDED)):
            frontier.configure(**settings)
            try:
                records[what] = fleet_run(paths, what)
            finally:
                frontier.configure()
            for name, run in sequential.items():
                member_exit = 1 if records[what]["issues"][name] else 0
                if (member_exit, records[what]["issues"][name]) != (
                        run["exit"], run["issues"]):
                    raise AssertionError(
                        f"analyze_fleet {what}: {name} exit {member_exit}, "
                        f"issues {records[what]['issues'][name]}; the "
                        f"sequential run {run}")
            records[what]["sequential_host_wall_s"] = sequential_s
            emit(records[what])
            for key, count in records[what]["launches"].items():
                launches[key] += count
    if not records["sharded"]["k12_launches"] \
            or not records["sharded"]["steal_rows"]:
        raise AssertionError(
            f"analyze_fleet sharded: K12 launched "
            f"{records['sharded']['k12_launches']} times, moved "
            f"{records['sharded']['steal_rows']} rows")
    fresh_analysis()
    record = {}
    with counted(record):
        preempted = preempted_fleet(fleet, symbolic, security)
    check_analyze_fleet("preempted", preempted)
    if not preempted[FLEET_PREEMPTED]["incomplete"] or any(
            run["incomplete"] for name, run in preempted.items()
            if name != FLEET_PREEMPTED):
        raise AssertionError(f"analyze_fleet preempted: {preempted}")
    emit({"phase": "analyze_fleet", "run": "preempted", "clock": "host",
          "host_wall_s": record["wall"], "members": preempted,
          "launches": record["launches"]})
    for key, count in record["launches"].items():
        launches[key] += count
    return launches


# ---- phase 20h: observe_tpu ----------------------------------------------------------

#: the metrics whose values read a clock, with the reason two runs cannot
#: agree on them; of a histogram the observation counts are still compared
TIME_VALUED = {
    "solver.time": "seconds of wall time inside solver checks",
    "simplify.time": "seconds of wall time inside the simplifier",
    "dispatch.device_time": "seconds of wall time inside device flushes",
    "dispatch.flush.latency_ms": "wall time of each flush",
    "cache.exec.deserialize_ms": "wall time of each executable load",
    "checkpoint.write_ms": "wall time of each checkpoint write",
    "absint.build_ms": "wall time of each absint build",
    "serve.request_ms": "wall time of each request",
    "serve.queue.wait_ms": "wall time in the admission queue",
    "profiler.instruction_us": "wall time of each instruction",
    "bench.states_per_sec": "states over wall seconds",
}
#: metric families never compared, and why
NOT_COMPARED = {
    "xla.": "per-shape compile accounting: the JAX solver compiles a "
            "program per clause shape, a CUDA kernel compiles once, so the "
            "port declares these and emits none (ROADMAP 12)",
    "device.hbm.": "the memory of the device each package runs on",
}


def deterministic(snapshot: dict) -> dict:
    """The part of a `metrics.snapshot()` that two runs on the same inputs
    must agree on: NOT_COMPARED families dropped, TIME_VALUED scalars
    dropped and TIME_VALUED histograms cut to their observation counts."""
    out = {}
    for name, value in snapshot.items():
        if name.startswith(tuple(NOT_COMPARED)):
            continue
        if name in TIME_VALUED:
            if not isinstance(value, dict):
                continue
            if "count" in value and not isinstance(value["count"], dict):
                out[name] = {"count": value["count"]}
            else:
                out[name] = {label: {"count": hist["count"]}
                             for label, hist in value.items()}
            continue
        out[name] = value
    return out


#: (b)'s run: one FLEET_CORPUS contract, FLEET_MODULES, one transaction,
#: 128 lanes and 8-step chunks (its tree takes several), --engine tpu
OBSERVE_CONTRACT = "combo"
OBSERVE_CHUNK = 8
#: the deterministic snapshot of that run from the JAX package's CLI
#: (`MYTHRIL_TPU_LANES=128 MYTHRIL_TPU_CHUNK=8 python -m mythril_tpu analyze
#: -f combo.hex --engine tpu -t 1 -m ... --metrics-out M`);
#: tests/test_torch_observe_cli.py recomputes it with JAX
EXPECTED_OBSERVE = json.loads(
    '{"absint.build_ms": {"count": 1}, "absint.regions_proven": 1, '
    '"cfa.blocks": 10, "cfa.jumps_resolved": 4, "cfa.merge_points": 1, '
    '"frontier.chunks": 4, "frontier.drain.rows": {"avg": 3.0, '
    '"count": 1, "max": 3, "min": 3, "p50": 3, "p95": 3, "p99": 3, '
    '"sum": 3.0}, "frontier.merge.events": 1, '
    '"frontier.merge.ite_depth": {"1": {"avg": 1.0, "count": 1, '
    '"max": 1, "min": 1, "p50": 1, "p95": 1, "p99": 1, "sum": 1.0}}, '
    '"frontier.merge.ites": 1, "frontier.merge.lanes_retired": 1, '
    '"frontier.merge.passes": 1, '
    '"frontier.merge.tag_merges": {"untagged": {"avg": 1.0, '
    '"count": 1, "max": 1, "min": 1, "p50": 1, "p95": 1, "p99": 1, '
    '"sum": 1.0}}, "frontier.telemetry.arena_bytes": 504, '
    '"frontier.telemetry.esc_bytes": 117918, '
    '"frontier.telemetry.esc_cause": {"halt": {"avg": 1.0, "count": 2, '
    '"max": 1, "min": 1, "p50": 1, "p95": 1, "p99": 1, "sum": 2.0}, '
    '"host_op": {"avg": 7.0, "count": 1, "max": 7, "min": 7, "p50": 7, '
    '"p95": 7, "p99": 7, "sum": 7.0}}, '
    '"frontier.telemetry.esc_hwm": 3, "frontier.telemetry.escapes": 3, '
    '"frontier.telemetry.executed": 54, "frontier.telemetry.forks": 3, '
    '"frontier.telemetry.lifecycle": {"esc_buffered": {"avg": 1.5, '
    '"count": 2, "max": 2, "min": 1, "p50": 1, "p95": 2, "p99": 2, '
    '"sum": 3.0}, "forks_claimed": {"avg": 1.5, "count": 2, "max": 2, '
    '"min": 1, "p50": 1, "p95": 2, "p99": 2, "sum": 3.0}}, '
    '"frontier.telemetry.occupancy": 1.6875, '
    '"frontier.telemetry.op_class": {"arith": {"avg": 1.0, "count": 1, '
    '"max": 1, "min": 1, "p50": 1, "p95": 1, "p99": 1, "sum": 1.0}, '
    '"cmp": {"avg": 2.0, "count": 2, "max": 2, "min": 2, "p50": 2, '
    '"p95": 2, "p99": 2, "sum": 4.0}, "dup": {"avg": 1.0, "count": 2, '
    '"max": 1, "min": 1, "p50": 1, "p95": 1, "p99": 1, "sum": 2.0}, '
    '"env": {"avg": 1.25, "count": 4, "max": 2, "min": 1, "p50": 1, '
    '"p95": 2, "p99": 2, "sum": 5.0}, "halt": {"avg": 1.5, "count": 2, '
    '"max": 2, "min": 1, "p50": 1, "p95": 2, "p99": 2, "sum": 3.0}, '
    '"jump": {"avg": 6.0, "count": 2, "max": 8, "min": 4, "p50": 4, '
    '"p95": 8, "p99": 8, "sum": 12.0}, "mem": {"avg": 1.5, "count": 2, '
    '"max": 2, "min": 1, "p50": 1, "p95": 2, "p99": 2, "sum": 3.0}, '
    '"push": {"avg": 5.25, "count": 4, "max": 9, "min": 3, "p50": 4, '
    '"p95": 9, "p99": 9, "sum": 21.0}, "storage": {"avg": 3.0, '
    '"count": 1, "max": 3, "min": 3, "p50": 3, "p95": 3, "p99": 3, '
    '"sum": 3.0}}, '
    '"frontier.telemetry.tag_occupancy": {"merge@0x33": {"avg": 2.0, '
    '"count": 1, "max": 2, "min": 2, "p50": 2, "p95": 2, "p99": 2, '
    '"sum": 2.0}}, "simplify.const_props": 19, '
    '"simplify.ite_collapses": 8, "simplify.iterations": 35, '
    '"simplify.rewrites": 27, "solver.queries": 6, '
    '"taint.functions": 2}')
#: the span names whose host seconds (c) rolls up
ROLLUP_SPANS = ("svm.tx", "frontier.device_phase", "frontier.chunk",
                "frontier.sync", "frontier.host_continuation",
                "dispatch.flush", "cfa.build")


def observe_argv(path: str, metrics_out: str, trace_out: str) -> list:
    """(b)'s CLI arguments on the contract in `path`."""
    return [*fleet_argv([path], fleet=False), "--metrics-out", metrics_out,
            "--trace-out", trace_out]


def reset_observe() -> None:
    """The registry and the tracer back to a fresh process's state."""
    from mythril_tpu_torch.observe import metrics, trace

    metrics.reset()
    trace.reset()


def observe_run(name: str, argv: list, metrics_out: str,
                trace_out: str) -> tuple:
    """`run_cli` from a fresh registry and tracer: its exit code, report
    and record, the snapshot the CLI wrote and the trace's events."""
    reset_observe()
    try:
        exit_code, report, counts = run_cli(name, argv)
    finally:
        reset_observe()
    with open(metrics_out, encoding="utf-8") as handle:
        snapshot = json.load(handle)
    with open(trace_out, encoding="utf-8") as handle:
        events = json.load(handle)["traceEvents"]
    return exit_code, report, counts, snapshot, events


def view_headings(trace_out: str, metrics_out: str) -> dict:
    """`python -m tools.traceview` and `python -m tools.frontierview` on a
    trace and a snapshot (both stdlib-only, reading the files): each
    exit code must be 0; returns each tool's section headings."""
    headings = {}
    root = os.path.dirname(os.path.abspath(__file__))
    for tool, extra in (("traceview", []),
                        ("frontierview", ["--metrics", metrics_out])):
        proc = subprocess.run(
            [sys.executable, "-m", f"tools.{tool}", trace_out, *extra],
            capture_output=True, text=True, cwd=root, timeout=120)
        if proc.returncode != 0:
            raise AssertionError(f"observe_tpu: tools.{tool} exit "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        headings[tool] = [line for line in proc.stdout.splitlines()
                          if line.startswith("== ")]
    return headings


def span_rollup(events) -> dict:
    """Host seconds of the trace's spans by category and by name (their
    durations summed; a nested span counts in its parent too)."""
    by_cat, by_name = {}, {}
    for event in events:
        if event["ph"] != "X":
            continue
        seconds = event["dur"] / 1e6
        by_cat[event["cat"]] = by_cat.get(event["cat"], 0.0) + seconds
        by_name[event["name"]] = by_name.get(event["name"], 0.0) + seconds
    return {"by_category_s": dict(sorted(by_cat.items())),
            "by_span_s": {name: by_name.get(name, 0.0)
                          for name in ROLLUP_SPANS}}


def check_frontier_metrics(snapshot: dict, record: dict) -> None:
    """The snapshot's frontier counters agree with the run's own
    per-transaction frontier lines: chunks, lane-steps, forks and
    cold-SLOAD fault-ins summed over its transactions."""
    lines = record["frontier"]
    expected = {
        "frontier.chunks": sum(tx["chunks"] for tx in lines),
        "frontier.telemetry.executed": sum(tx["lane_steps"] for tx in lines),
        "frontier.telemetry.forks": sum(tx["forks"] for tx in lines),
        "frontier.cold_sloads": sum(tx["fault_ins"] for tx in lines)}
    got = {name: snapshot.get(name, 0) for name in expected}
    if got != expected:
        raise AssertionError(f"observe_tpu: snapshot {got}, the frontier "
                             f"lines {expected}")


@contextlib.contextmanager
def recorded_summaries(recorded: list):
    """Within the block, every summary a DeviceFrontier decodes is kept in
    `recorded` as (frontier, a copy of the vector, telemetry)."""
    decode = frontier.DeviceFrontier._decode_summary

    def recording(self, packed, telemetry):
        recorded.append((self, np.array(packed), telemetry))
        return decode(self, packed, telemetry)

    with mock.patch.object(frontier.DeviceFrontier, "_decode_summary",
                           recording):
        yield


def publish_host_us(recorded: list) -> dict:
    """Host microseconds of one chunk's publish calls (`_decode_summary`:
    the shard block and the telemetry words into the registry, the slog
    check and, traced, the counter tracks) on the last summary `recorded`,
    with the tracer off and on. The registry is reset after."""
    from mythril_tpu_torch.observe import trace

    import tempfile

    fr, packed, telemetry = recorded[-1]
    try:
        off_us = host_us(lambda: fr._decode_summary(packed, telemetry))
        with tempfile.TemporaryDirectory() as directory:
            trace.enable(os.path.join(directory, "publish.trace.json"))
            on_us = host_us(lambda: fr._decode_summary(packed, telemetry))
    finally:
        reset_observe()
    return {"publish_host_us": off_us, "publish_host_us_traced": on_us}


def phase_observe_tpu() -> dict:
    """The port's observability on the card, in this process: (a)
    KILLBILLY in analyze_tpu's configuration with --metrics-out and
    --trace-out (exit and issues EXPECTED_ANALYZE_TPU's, the snapshot's
    frontier counters the run's frontier lines', both files read by
    tools.traceview and tools.frontierview, the CUDA memory gauges
    non-zero); (b) OBSERVE_CONTRACT at 8-step chunks, its deterministic
    snapshot EXPECTED_OBSERVE; (c) (a)'s span rollup on the host clock,
    and the publish calls' host microseconds on (a)'s last summary beside
    (a)'s host milliseconds a chunk. Returns the phase's kernel
    launches."""
    import tempfile

    from mythril_tpu_torch.observe import export, metrics

    frontier.configure()
    launches = {name: 0 for name in ops.LAUNCHES}
    with tempfile.TemporaryDirectory() as directory:
        metrics_out = os.path.join(directory, "killbilly.metrics.json")
        trace_out = os.path.join(directory, "killbilly.trace.json")
        recorded = []
        reset_observe()
        try:
            with recorded_summaries(recorded):
                report, summary, record = analyze_tpu_run(
                    "killbilly", extra=["--metrics-out", metrics_out,
                                        "--trace-out", trace_out])
        finally:
            reset_observe()
        check_analyze_tpu("killbilly", summary)
        with open(metrics_out, encoding="utf-8") as handle:
            snapshot = json.load(handle)
        with open(trace_out, encoding="utf-8") as handle:
            trace_doc = json.load(handle)
        events = trace_doc["traceEvents"]
        check_frontier_metrics(snapshot, record)
        headings = view_headings(trace_out, metrics_out)
        memory = export.collect_device_memory()
        if not memory.get("bytes_in_use") or not memory.get("peak_bytes") \
                or metrics.value("device.hbm.bytes_in_use") \
                != memory["bytes_in_use"]:
            raise AssertionError(f"observe_tpu: device memory {memory}")
        for key, count in record["launches"].items():
            launches[key] += count
        rollup = span_rollup(events)
        # (c): what the publish calls cost a chunk, beside the run's host
        # time a chunk in its device phases
        rollup.update(publish_host_us(recorded))
        rollup["host_ms_per_chunk"] = (
            rollup["by_span_s"]["frontier.device_phase"] * 1000.0
            / snapshot["frontier.chunks"])
        emit({"phase": "observe_tpu", "run": "killbilly", "clock": "host",
              "host_wall_s": record["host_wall_s"], "exit": record["exit"],
              "issues": summary["issues"], "frontier": record["frontier"],
              "metrics": len(snapshot),
              "trace_events": len(events),
              "dropped_events": trace_doc["otherData"]["dropped_events"],
              "counter_samples": sum(1 for e in events if e["ph"] == "C"),
              "headings": headings, "device_memory": memory, **rollup,
              "launches": record["launches"]})
        # (b): the small run held to the JAX package's snapshot
        paths = fleet_files(directory)
        metrics_out = os.path.join(directory, "small.metrics.json")
        trace_out = os.path.join(directory, "small.trace.json")
        frontier.configure(chunk=OBSERVE_CHUNK)
        try:
            exit_code, report, counts, snapshot, events = observe_run(
                "observe_tpu small", observe_argv(
                    paths[OBSERVE_CONTRACT], metrics_out, trace_out),
                metrics_out, trace_out)
        finally:
            frontier.configure()
        got = deterministic(snapshot)
        if got != EXPECTED_OBSERVE:
            differ = sorted(name for name in set(got) | set(EXPECTED_OBSERVE)
                            if got.get(name) != EXPECTED_OBSERVE.get(name))
            raise AssertionError(f"observe_tpu small: the snapshot differs "
                                 f"from the JAX package's in {differ}")
        for key, count in counts["launches"].items():
            launches[key] += count
        emit({"phase": "observe_tpu", "run": "small",
              "contract": OBSERVE_CONTRACT, "chunk": OBSERVE_CHUNK,
              "clock": "host", "host_wall_s": counts["wall"],
              "exit": exit_code, "metrics_compared": len(got),
              "chunks": got.get("frontier.chunks", 0),
              "counter_samples": sum(1 for e in events if e["ph"] == "C"),
              "launches": counts["launches"]})
    missing = [key for key in ("sym_step", "frontier_summary", "merge_pass")
               if not launches[key]]
    if missing:
        raise AssertionError(f"observe_tpu: no launch of {missing}")
    return launches


# ---- phase 20i: optimize_jax ----------------------------------------------------

#: tests/test_superopt.py's SYNTHETIC (a copy: this script imports nothing
#: of the tests): jump-linked blocks multiplying by powers of two, a
#: dup/pop peephole and a swap before a commutative op
SUPEROPT_SYNTHETIC = (
    "PUSH1 0x00\nCALLDATALOAD\n"
    "PUSH @b0\nJUMP\n"
    "b0:\nJUMPDEST\nPUSH1 0x20\nMUL\nPUSH @b1\nJUMP\n"
    "b1:\nJUMPDEST\nDUP1\nPOP\nPUSH2 0x100\nMUL\nPUSH @b2\nJUMP\n"
    "b2:\nJUMPDEST\nPUSH1 0x05\nSWAP1\nADD\nPUSH1 0x08\nDIV\nSTOP"
)


def superopt_contract(n_blocks: int = 12) -> str:
    """bench.py's `_superopt_contract` (a copy: bench.py imports the JAX
    package): one stack word, then n_blocks jump-linked blocks, each
    multiplying by a power of two, so that every block's PUSH 2^k; MUL ->
    PUSH k; SHL rewrite is a real SAT query."""
    lines = ["PUSH1 0x00", "CALLDATALOAD"]
    for i in range(n_blocks):
        lines += [f"PUSH @b{i}", "JUMP",
                  f"b{i}:", "JUMPDEST",
                  f"PUSH2 {hex(1 << (i % 14 + 1))}", "MUL"]
    lines.append("STOP")
    return "\n".join(lines)


#: the optimizer's runtime codes: tests/test_superopt.py's corpus and
#: bench.py's superopt A/B contract at 12 blocks
OPTIMIZE_CODES = {
    "synthetic": assemble(SUPEROPT_SYNTHETIC).hex(),
    "killbilly": assemble(dispatcher(HEADLINE_KILLBILLY)).hex(),
    "bectoken": assemble(dispatcher(BECTOKEN)).hex(),
    "superopt12": assemble(superopt_contract()).hex(),
}
OPTIMIZE_SOLVERS = ("jax", "cdcl")
#: the code whose 12 proofs must all be the device's under --solver jax
OPTIMIZE_DEVICE_RUN = "superopt12"
OPTIMIZE_DEVICE_PROOFS = 12
#: the JAX package's reports (`optimize_bytecode(code, solver=...,
#: crosscheck=1).to_json()` on the CPU) but for `wall_ms` and `code_in`
#: (OPTIMIZE_CODES), by solver and code; tests/test_torch_superopt.py
#: recomputes them with JAX
EXPECTED_OPTIMIZE = json.loads(
    '{"cdcl": {"bectoken": {"blocks_scanned": 11, "candidates": 0, '
    '"code_out": "60003560e01c8063a9059cbb1461001d57806383f12fec1461005c5'
    '7005b50602435336000526000602052604060002080548281106100be57039055602'
    '43560043560005260006020526040600020805482019055005b60006000fd5b50600'
    '4356004013580156100be57806014106100be5760243580156100be5702336000526'
    '000602052604060002080548281106100be570390556024356024600435013560005'
    '260006020526040600020805482019055600160005260206000f35b60006000fd", '
    '"gas_saved": 0, "note": "", "proof_stats": {"batched": 0, '
    '"crosschecks": 0, "divergences": 0, "obligations": 0, "queries": 0, '
    '"sat": 0, "selfcheck_failures": 0, "syntactic": 0, "unknown": 0, '
    '"unsat": 0}, "rewrites": [], "weighted_gas_saved": 0}, "killbilly": '
    '{"blocks_scanned": 11, "candidates": 6, "code_out": "60003560e01c806'
    '39fa299cc14610028578063840570651461003e5780637c11da201461005f57005b5'
    '060016004356000526001602052604060002055005b5033600052600160205260406'
    '0002054610058575f6000fdfe5b60015f5500fe5b505f546200006d575f6000fdfe5'
    'b33ff", "gas_saved": 4, "note": "", "proof_stats": {"batched": 0, '
    '"crosschecks": 0, "divergences": 0, "obligations": 6, "queries": 0, '
    '"sat": 0, "selfcheck_failures": 0, "syntactic": 6, "unknown": 0, '
    '"unsat": 0}, "rewrites": [{"after": ["PUSH0", "PUSH1 0x0"], '
    '"before": ["PUSH1 0x0", "PUSH1 0x0"], "block_id": 6, "gas_after": 5,'
    ' "gas_before": 6, "gas_saved": 1, "proof": "syntactic", "rule": '
    '"push0_min", "start_pc": 83, "weight": 1, "weighted_saved": 1}, '
    '{"after": ["PUSH1 0x1", "PUSH0", "SSTORE"], "before": ["PUSH1 0x1", '
    '"PUSH1 0x0", "SSTORE"], "block_id": 7, "gas_after": 105, '
    '"gas_before": 106, "gas_saved": 1, "proof": "syntactic", "rule": '
    '"push0_min", "start_pc": 89, "weight": 1, "weighted_saved": 1}, '
    '{"after": ["POP", "PUSH0", "SLOAD", "PUSH3 0x6d"], "before": ["POP",'
    ' "PUSH1 0x0", "SLOAD", "PUSH2 0x6d"], "block_id": 8, "gas_after": '
    '107, "gas_before": 108, "gas_saved": 1, "proof": "syntactic", '
    '"rule": "push0_min", "start_pc": 96, "weight": 1, "weighted_saved": '
    '1}, {"after": ["PUSH0", "PUSH1 0x0"], "before": ["PUSH1 0x0", "PUSH1'
    ' 0x0"], "block_id": 9, "gas_after": 5, "gas_before": 6, "gas_saved":'
    ' 1, "proof": "syntactic", "rule": "push0_min", "start_pc": 104, '
    '"weight": 1, "weighted_saved": 1}], "weighted_gas_saved": 4}, '
    '"superopt12": {"blocks_scanned": 13, "candidates": 12, "code_out": "'
    '600035610007565b60011b61001056fe5b60021b61001956fe5b60031b61002256fe'
    '5b60041b61002b56fe5b60051b61003456fe5b60061b61003d56fe5b60071b610046'
    '56fe5b60081b61004f56fe5b60091b61005856fe5b600a1b61006156fe5b600b1b61'
    '006a56fe5b600c1b00fe", "gas_saved": 24, "note": "", "proof_stats": '
    '{"batched": 0, "crosschecks": 12, "divergences": 0, "obligations": '
    '12, "queries": 12, "sat": 0, "selfcheck_failures": 0, "syntactic": '
    '0, "unknown": 0, "unsat": 12}, "rewrites": [{"after": ["PUSH1 0x1", '
    '"SHL", "PUSH2 0x10"], "before": ["PUSH2 0x2", "MUL", "PUSH2 0x10"], '
    '"block_id": 1, "gas_after": 9, "gas_before": 11, "gas_saved": 2, '
    '"proof": "host", "rule": "strength_mul", "start_pc": 8, "weight": 1,'
    ' "weighted_saved": 2}, {"after": ["PUSH1 0x2", "SHL", "PUSH2 0x19"],'
    ' "before": ["PUSH2 0x4", "MUL", "PUSH2 0x19"], "block_id": 2, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "host", '
    '"rule": "strength_mul", "start_pc": 17, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x3", "SHL", "PUSH2 0x22"], '
    '"before": ["PUSH2 0x8", "MUL", "PUSH2 0x22"], "block_id": 3, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "host", '
    '"rule": "strength_mul", "start_pc": 26, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x4", "SHL", "PUSH2 0x2b"], '
    '"before": ["PUSH2 0x10", "MUL", "PUSH2 0x2b"], "block_id": 4, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "host", '
    '"rule": "strength_mul", "start_pc": 35, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x5", "SHL", "PUSH2 0x34"], '
    '"before": ["PUSH2 0x20", "MUL", "PUSH2 0x34"], "block_id": 5, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "host", '
    '"rule": "strength_mul", "start_pc": 44, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x6", "SHL", "PUSH2 0x3d"], '
    '"before": ["PUSH2 0x40", "MUL", "PUSH2 0x3d"], "block_id": 6, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "host", '
    '"rule": "strength_mul", "start_pc": 53, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x7", "SHL", "PUSH2 0x46"], '
    '"before": ["PUSH2 0x80", "MUL", "PUSH2 0x46"], "block_id": 7, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "host", '
    '"rule": "strength_mul", "start_pc": 62, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x8", "SHL", "PUSH2 0x4f"], '
    '"before": ["PUSH2 0x100", "MUL", "PUSH2 0x4f"], "block_id": 8, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "host", '
    '"rule": "strength_mul", "start_pc": 71, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x9", "SHL", "PUSH2 0x58"], '
    '"before": ["PUSH2 0x200", "MUL", "PUSH2 0x58"], "block_id": 9, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "host", '
    '"rule": "strength_mul", "start_pc": 80, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0xa", "SHL", "PUSH2 0x61"], '
    '"before": ["PUSH2 0x400", "MUL", "PUSH2 0x61"], "block_id": 10, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "host", '
    '"rule": "strength_mul", "start_pc": 89, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0xb", "SHL", "PUSH2 0x6a"], '
    '"before": ["PUSH2 0x800", "MUL", "PUSH2 0x6a"], "block_id": 11, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "host", '
    '"rule": "strength_mul", "start_pc": 98, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0xc", "SHL"], "before": '
    '["PUSH2 0x1000", "MUL"], "block_id": 12, "gas_after": 6, '
    '"gas_before": 8, "gas_saved": 2, "proof": "host", "rule": '
    '"strength_mul", "start_pc": 107, "weight": 1, "weighted_saved": 2}],'
    ' "weighted_gas_saved": 24}, "synthetic": {"blocks_scanned": 4, '
    '"candidates": 4, "code_out": "600035610007565b60051b61000f565b610100'
    '0261001a56fefe5b60050160080400fe", "gas_saved": 10, "note": "", '
    '"proof_stats": {"batched": 0, "crosschecks": 2, "divergences": 0, '
    '"obligations": 4, "queries": 2, "sat": 0, "selfcheck_failures": 0, '
    '"syntactic": 2, "unknown": 0, "unsat": 2}, "rewrites": [{"after": '
    '["PUSH1 0x5", "SHL", "PUSH2 0xf"], "before": ["PUSH1 0x20", "MUL", '
    '"PUSH2 0xf"], "block_id": 1, "gas_after": 9, "gas_before": 11, '
    '"gas_saved": 2, "proof": "host", "rule": "strength_mul", "start_pc":'
    ' 8, "weight": 1, "weighted_saved": 2}, {"after": ["PUSH2 0x100", '
    '"MUL", "PUSH2 0x1a"], "before": ["DUP1", "POP", "PUSH2 0x100", '
    '"MUL", "PUSH2 0x1a"], "block_id": 2, "gas_after": 11, "gas_before": '
    '16, "gas_saved": 5, "proof": "syntactic", "rule": "dup_pop", '
    '"start_pc": 16, "weight": 1, "weighted_saved": 5}, {"after": ["PUSH1'
    ' 0x5", "ADD", "PUSH1 0x8", "DIV"], "before": ["PUSH1 0x5", "SWAP1", '
    '"ADD", "PUSH1 0x8", "DIV"], "block_id": 3, "gas_after": 14, '
    '"gas_before": 17, "gas_saved": 3, "proof": "syntactic", "rule": '
    '"swap_commutative", "start_pc": 27, "weight": 1, "weighted_saved": '
    '3}], "weighted_gas_saved": 10}}, "jax": {"bectoken": '
    '{"blocks_scanned": 11, "candidates": 0, "code_out": "60003560e01c806'
    '3a9059cbb1461001d57806383f12fec1461005c57005b50602435336000526000602'
    '052604060002080548281106100be570390556024356004356000526000602052604'
    '0600020805482019055005b60006000fd5b506004356004013580156100be5780601'
    '4106100be5760243580156100be57023360005260006020526040600020805482811'
    '06100be5703905560243560246004350135600052600060205260406000208054820'
    '19055600160005260206000f35b60006000fd", "gas_saved": 0, "note": "", '
    '"proof_stats": {"batched": 1, "crosschecks": 0, "divergences": 0, '
    '"obligations": 0, "queries": 0, "sat": 0, "selfcheck_failures": 0, '
    '"syntactic": 0, "unknown": 0, "unsat": 0}, "rewrites": [], '
    '"weighted_gas_saved": 0}, "killbilly": {"blocks_scanned": 11, '
    '"candidates": 6, "code_out": "60003560e01c80639fa299cc14610028578063'
    '840570651461003e5780637c11da201461005f57005b506001600435600052600160'
    '2052604060002055005b50336000526001602052604060002054610058575f6000fd'
    'fe5b60015f5500fe5b505f546200006d575f6000fdfe5b33ff", "gas_saved": 4,'
    ' "note": "", "proof_stats": {"batched": 1, "crosschecks": 0, '
    '"divergences": 0, "obligations": 6, "queries": 0, "sat": 0, '
    '"selfcheck_failures": 0, "syntactic": 6, "unknown": 0, "unsat": 0}, '
    '"rewrites": [{"after": ["PUSH0", "PUSH1 0x0"], "before": ["PUSH1 '
    '0x0", "PUSH1 0x0"], "block_id": 6, "gas_after": 5, "gas_before": 6, '
    '"gas_saved": 1, "proof": "syntactic", "rule": "push0_min", '
    '"start_pc": 83, "weight": 1, "weighted_saved": 1}, {"after": ["PUSH1'
    ' 0x1", "PUSH0", "SSTORE"], "before": ["PUSH1 0x1", "PUSH1 0x0", '
    '"SSTORE"], "block_id": 7, "gas_after": 105, "gas_before": 106, '
    '"gas_saved": 1, "proof": "syntactic", "rule": "push0_min", '
    '"start_pc": 89, "weight": 1, "weighted_saved": 1}, {"after": ["POP",'
    ' "PUSH0", "SLOAD", "PUSH3 0x6d"], "before": ["POP", "PUSH1 0x0", '
    '"SLOAD", "PUSH2 0x6d"], "block_id": 8, "gas_after": 107, '
    '"gas_before": 108, "gas_saved": 1, "proof": "syntactic", "rule": '
    '"push0_min", "start_pc": 96, "weight": 1, "weighted_saved": 1}, '
    '{"after": ["PUSH0", "PUSH1 0x0"], "before": ["PUSH1 0x0", "PUSH1 '
    '0x0"], "block_id": 9, "gas_after": 5, "gas_before": 6, "gas_saved": '
    '1, "proof": "syntactic", "rule": "push0_min", "start_pc": 104, '
    '"weight": 1, "weighted_saved": 1}], "weighted_gas_saved": 4}, '
    '"superopt12": {"blocks_scanned": 13, "candidates": 12, "code_out": "'
    '600035610007565b60011b61001056fe5b60021b61001956fe5b60031b61002256fe'
    '5b60041b61002b56fe5b60051b61003456fe5b60061b61003d56fe5b60071b610046'
    '56fe5b60081b61004f56fe5b60091b61005856fe5b600a1b61006156fe5b600b1b61'
    '006a56fe5b600c1b00fe", "gas_saved": 24, "note": "", "proof_stats": '
    '{"batched": 1, "crosschecks": 12, "divergences": 0, "obligations": '
    '12, "queries": 12, "sat": 0, "selfcheck_failures": 0, "syntactic": '
    '0, "unknown": 0, "unsat": 12}, "rewrites": [{"after": ["PUSH1 0x1", '
    '"SHL", "PUSH2 0x10"], "before": ["PUSH2 0x2", "MUL", "PUSH2 0x10"], '
    '"block_id": 1, "gas_after": 9, "gas_before": 11, "gas_saved": 2, '
    '"proof": "device", "rule": "strength_mul", "start_pc": 8, "weight": '
    '1, "weighted_saved": 2}, {"after": ["PUSH1 0x2", "SHL", "PUSH2 '
    '0x19"], "before": ["PUSH2 0x4", "MUL", "PUSH2 0x19"], "block_id": 2,'
    ' "gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": '
    '"device", "rule": "strength_mul", "start_pc": 17, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x3", "SHL", "PUSH2 0x22"], '
    '"before": ["PUSH2 0x8", "MUL", "PUSH2 0x22"], "block_id": 3, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "device",'
    ' "rule": "strength_mul", "start_pc": 26, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x4", "SHL", "PUSH2 0x2b"], '
    '"before": ["PUSH2 0x10", "MUL", "PUSH2 0x2b"], "block_id": 4, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "device",'
    ' "rule": "strength_mul", "start_pc": 35, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x5", "SHL", "PUSH2 0x34"], '
    '"before": ["PUSH2 0x20", "MUL", "PUSH2 0x34"], "block_id": 5, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "device",'
    ' "rule": "strength_mul", "start_pc": 44, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x6", "SHL", "PUSH2 0x3d"], '
    '"before": ["PUSH2 0x40", "MUL", "PUSH2 0x3d"], "block_id": 6, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "device",'
    ' "rule": "strength_mul", "start_pc": 53, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x7", "SHL", "PUSH2 0x46"], '
    '"before": ["PUSH2 0x80", "MUL", "PUSH2 0x46"], "block_id": 7, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "device",'
    ' "rule": "strength_mul", "start_pc": 62, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x8", "SHL", "PUSH2 0x4f"], '
    '"before": ["PUSH2 0x100", "MUL", "PUSH2 0x4f"], "block_id": 8, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "device",'
    ' "rule": "strength_mul", "start_pc": 71, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0x9", "SHL", "PUSH2 0x58"], '
    '"before": ["PUSH2 0x200", "MUL", "PUSH2 0x58"], "block_id": 9, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "device",'
    ' "rule": "strength_mul", "start_pc": 80, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0xa", "SHL", "PUSH2 0x61"], '
    '"before": ["PUSH2 0x400", "MUL", "PUSH2 0x61"], "block_id": 10, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "device",'
    ' "rule": "strength_mul", "start_pc": 89, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0xb", "SHL", "PUSH2 0x6a"], '
    '"before": ["PUSH2 0x800", "MUL", "PUSH2 0x6a"], "block_id": 11, '
    '"gas_after": 9, "gas_before": 11, "gas_saved": 2, "proof": "device",'
    ' "rule": "strength_mul", "start_pc": 98, "weight": 1, '
    '"weighted_saved": 2}, {"after": ["PUSH1 0xc", "SHL"], "before": '
    '["PUSH2 0x1000", "MUL"], "block_id": 12, "gas_after": 6, '
    '"gas_before": 8, "gas_saved": 2, "proof": "device", "rule": '
    '"strength_mul", "start_pc": 107, "weight": 1, "weighted_saved": 2}],'
    ' "weighted_gas_saved": 24}, "synthetic": {"blocks_scanned": 4, '
    '"candidates": 4, "code_out": "600035610007565b60051b61000f565b610100'
    '0261001a56fefe5b60050160080400fe", "gas_saved": 10, "note": "", '
    '"proof_stats": {"batched": 1, "crosschecks": 2, "divergences": 0, '
    '"obligations": 4, "queries": 2, "sat": 0, "selfcheck_failures": 0, '
    '"syntactic": 2, "unknown": 0, "unsat": 2}, "rewrites": [{"after": '
    '["PUSH1 0x5", "SHL", "PUSH2 0xf"], "before": ["PUSH1 0x20", "MUL", '
    '"PUSH2 0xf"], "block_id": 1, "gas_after": 9, "gas_before": 11, '
    '"gas_saved": 2, "proof": "device", "rule": "strength_mul", '
    '"start_pc": 8, "weight": 1, "weighted_saved": 2}, {"after": ["PUSH2 '
    '0x100", "MUL", "PUSH2 0x1a"], "before": ["DUP1", "POP", "PUSH2 '
    '0x100", "MUL", "PUSH2 0x1a"], "block_id": 2, "gas_after": 11, '
    '"gas_before": 16, "gas_saved": 5, "proof": "syntactic", "rule": '
    '"dup_pop", "start_pc": 16, "weight": 1, "weighted_saved": 5}, '
    '{"after": ["PUSH1 0x5", "ADD", "PUSH1 0x8", "DIV"], "before": '
    '["PUSH1 0x5", "SWAP1", "ADD", "PUSH1 0x8", "DIV"], "block_id": 3, '
    '"gas_after": 14, "gas_before": 17, "gas_saved": 3, "proof": '
    '"syntactic", "rule": "swap_commutative", "start_pc": 27, "weight": '
    '1, "weighted_saved": 3}], "weighted_gas_saved": 10}}}')


def optimize_argv(name: str, solver: str) -> list:
    """The port's CLI arguments of one optimizer run: every accepted proof
    cross-checked on the host CDCL."""
    return ["optimize", "-c", OPTIMIZE_CODES[name], "--solver", solver,
            "--crosscheck", "1", "-o", "json"]


def check_optimize(solver: str, name: str, report: dict) -> None:
    """Raise unless a report is the JAX package's but for its wall."""
    got = {key: value for key, value in report.items()
           if key not in ("wall_ms", "code_in")}
    want = EXPECTED_OPTIMIZE[solver][name]
    if report["code_in"] != OPTIMIZE_CODES[name] or got != want:
        differ = sorted(key for key in set(got) | set(want)
                        if got.get(key) != want.get(key))
        raise AssertionError(f"optimize_jax {solver} {name}: the report "
                             f"differs from the JAX package's in {differ}")


def phase_optimize_jax() -> dict:
    """The port's `optimize --crosscheck 1` (`cli.main` in this process,
    so its launches count) on OPTIMIZE_CODES: under `--solver jax` every
    real query goes through one dispatch flush onto K11 on the card, and
    the CDCL decides only what the card leaves UNKNOWN; then the same
    runs under `--solver cdcl`, on the host. Each report held to
    EXPECTED_OPTIMIZE; one line a run. It fails if K11 never launched from
    the optimizer, if fewer than all of OPTIMIZE_DEVICE_RUN's proofs are
    the device's, on a crosscheck divergence or a breaker off CLOSED, or
    if the cdcl route launched a kernel. Returns the jax runs' launches."""
    from mythril_tpu_torch.support import resilience

    launches = {name: 0 for name in ops.LAUNCHES}
    for solver in OPTIMIZE_SOLVERS:
        for name in OPTIMIZE_CODES:
            exit_code, report, record = run_cli(
                f"optimize_jax {solver} {name}", optimize_argv(name, solver))
            stats = report["proof_stats"]
            lane = lane_record(SolverStatistics())
            state = resilience.registry.backend(resilience.DEVICE).state
            if exit_code or stats["divergences"] \
                    or stats["selfcheck_failures"] \
                    or state != resilience.CLOSED:
                raise AssertionError(f"optimize_jax {solver} {name}: exit "
                                     f"{exit_code}, {stats}, breaker "
                                     f"{state}")
            check_optimize(solver, name, report)
            proofs = [rewrite["proof"] for rewrite in report["rewrites"]]
            if solver == "jax" and name == OPTIMIZE_DEVICE_RUN \
                    and proofs.count("device") < OPTIMIZE_DEVICE_PROOFS:
                raise AssertionError(f"optimize_jax {name}: proofs {proofs}")
            launched = sum(record["launches"].values())
            if solver == "cdcl" and launched:
                raise AssertionError(f"optimize_jax cdcl {name}: launched "
                                     f"{record['launches']}")
            emit({"phase": "optimize_jax", "run": name, "solver": solver,
                  "clock": "host", "host_wall_s": record["wall"],
                  "wall_ms": report["wall_ms"], "exit": exit_code,
                  "rewrites": len(report["rewrites"]),
                  "gas_saved": report["gas_saved"],
                  "queries": stats["queries"],
                  "syntactic": stats["syntactic"],
                  "proofs": {proof: proofs.count(proof)
                             for proof in sorted(set(proofs))},
                  "flushes": lane["flushes"],
                  "mean_occupancy": lane["mean_occupancy"],
                  "device_decided": lane["device_decided"],
                  "unknown": lane["unknown"],
                  "crosschecks": stats["crosschecks"],
                  "divergences": stats["divergences"],
                  "flush_s": lane["flush_s"],
                  "k11_launches": record["launches"]["sat_step"],
                  "sat_captures": record["replays"]["sat_captures"]})
            if solver == "jax":
                for key, count in record["launches"].items():
                    launches[key] += count
    if not launches["sat_step"]:
        raise AssertionError("optimize_jax: K11 never launched from the "
                             "optimizer")
    return launches


#: the serve_tpu phase's runner of a daemon or worker process: runs
#: MODULE as `python -m MODULE ARGS` does and writes the process's kernel
#: launches and graph replays to OUT at exit, with the counts after the
#: warm set's warmup, each CUDA-graph capture's window on the system's
#: monotonic clock, and each engine run's launches beside the worker job
#: it served (its id and whether it was a retry), and each worker's
#: spawn-to-ready time in a daemon's pool; a pool's fork server runs under
#: it too, and each worker it forks writes a file of its own beside OUT (a
#: worker that dies writes none). It imports torch only once the daemon's
#: service is built, as the daemon itself does
SERVE_RUNNER = r"""
import atexit, json, os, runpy, sys, time

sys.path.insert(0, {repo!r})
out, module = sys.argv[1], sys.argv[2]
sys.argv = [module, *sys.argv[3:]]
marks = {{"captures": [], "runs": [], "spawns": []}}
# a worker forked by a fork server under this runner writes its own file
runner_pid = os.getpid()


def counts():
    from mythril_tpu_torch.kernels import ops

    return {{"launches": dict(ops.LAUNCHES), "replays": dict(ops.REPLAYS)}}


def dump():
    path = out if os.getpid() == runner_pid else f"{{out}}-{{os.getpid()}}"
    with open(path, "w") as handle:
        json.dump({{**counts(), "marks": marks}}, handle)


atexit.register(dump)


def time_captures():
    # torch is imported here, not first: a daemon builds its service (and
    # starts its pool's fork server) before its own import of torch
    import torch

    capture_enter = torch.cuda.graph.__enter__
    capture_exit = torch.cuda.graph.__exit__

    def timed_enter(self):
        self.started_at = time.monotonic()
        return capture_enter(self)

    def timed_exit(self, *exc):
        try:
            return capture_exit(self, *exc)
        finally:
            marks["captures"].append([self.started_at, time.monotonic()])

    torch.cuda.graph.__enter__ = timed_enter
    torch.cuda.graph.__exit__ = timed_exit


from mythril_tpu_torch.observe import slog
from mythril_tpu_torch.serve import service, supervisor, warmset

warmup = warmset.WarmSet.warmup
event = slog.event
job = {{}}


def marked_warmup(self):
    warmed = warmup(self)
    marks["after_warmup"] = counts()
    return warmed


def job_event(name, **fields):
    if name == "serve.worker.job":
        job.update(job_id=fields.get("job_id"), retry=fields.get("retry"))
    if name == "serve.worker.ready":
        marks["spawns"].append({{"slot": fields.get("slot"),
                                "seconds": fields.get("spawn_s")}})
    return event(name, **fields)


run_local = service.AnalysisService._run_analysis_local


def counted_run(self, *args, **kwargs):
    before = counts()["launches"]
    started = time.monotonic()
    try:
        return run_local(self, *args, **kwargs)
    finally:
        after = counts()["launches"]
        marks["runs"].append({{**job, "seconds": time.monotonic() - started,
                              "launches": {{name: after[name] - before[name]
                                           for name in after}}}})


def runner_fork_server(self):
    return [sys.executable, os.path.abspath(__file__),
            f"{{out}}.worker-{{os.urandom(4).hex()}}",
            "mythril_tpu_torch.serve.forkserver"]


startup = service.AnalysisService.startup


def timed_startup(self):
    time_captures()
    return startup(self)


warmset.WarmSet.warmup = marked_warmup
slog.event = job_event
service.AnalysisService._run_analysis_local = counted_run
service.AnalysisService.startup = timed_startup
supervisor.Supervisor._fork_server_command = runner_fork_server
if module == "mythril_tpu_torch.serve.forkserver":
    time_captures()  # before the forks: the workers inherit it
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""
#: how long a daemon may take to answer its first ping
SERVE_START_S = 180


class ServeDaemon:
    """`python -m mythril_tpu_torch serve --socket S ARGS` as a
    subprocess under SERVE_RUNNER, with its log in the work directory."""

    def __init__(self, work: str, name: str, args: list):
        from mythril_tpu_torch.serve import client

        self.client = client
        self.socket = os.path.join(work, f"{name}.sock")
        self.counts_path = os.path.join(work, f"{name}.counts.json")
        self.log_path = os.path.join(work, f"{name}.log")
        runner = os.path.join(work, "serve_runner.py")
        with open(runner, "w") as handle:
            handle.write(SERVE_RUNNER.format(
                repo=os.path.dirname(os.path.abspath(__file__))))
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, runner, self.counts_path, "mythril_tpu_torch",
             "serve", "--socket", self.socket, *args],
            stdout=self.log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        started = time.perf_counter()
        while True:
            try:
                self.request({"op": "ping"}, timeout=10)
                break
            except client.ServeClientError:
                if self.proc.poll() is not None or \
                        time.perf_counter() - started > SERVE_START_S:
                    self.fail(f"daemon {name} never answered a ping")
                time.sleep(0.25)
        self.start_s = time.perf_counter() - started

    def request(self, payload: dict, timeout: float = 600.0) -> dict:
        return self.client.request(payload, socket_path=self.socket,
                                   timeout=timeout)

    def fail(self, message: str):
        self.log.flush()
        with open(self.log_path) as handle:
            tail = handle.read()[-3000:]
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        raise AssertionError(f"serve_tpu: {message}\n{tail}")

    def stop(self) -> dict:
        """Shut the daemon down (exit 0 or fail); its process's and its
        workers' counts (`runner_counts`)."""
        reply = self.request({"op": "shutdown"}, timeout=120)
        try:
            code = self.proc.wait(120)
        except subprocess.TimeoutExpired:
            self.fail("daemon did not exit after shutdown")
        self.log.close()
        if not reply.get("ok") or code != 0:
            self.fail(f"shutdown {reply}, exit {code}")
        return runner_counts(self.counts_path)


def runner_counts(counts_path: str) -> dict:
    """What a daemon under SERVE_RUNNER and its workers wrote at their
    exit, summed: {"launches", "replays", "after_warmup", "captures",
    "runs", "spawns"}: the daemon's capture windows and its workers'
    spawn-to-ready times, and every engine run of the daemon and its
    workers with its launches."""
    with open(counts_path) as handle:
        own = json.load(handle)
    total = {key: dict(own[key]) for key in ("launches", "replays")}
    total["runs"] = list(own["marks"]["runs"])
    directory = os.path.dirname(counts_path)
    prefix = os.path.basename(counts_path) + ".worker-"
    for filename in sorted(os.listdir(directory)):
        if filename.startswith(prefix):
            with open(os.path.join(directory, filename)) as handle:
                worker = json.load(handle)
            for key in ("launches", "replays"):
                for name, count in worker[key].items():
                    total[key][name] += count
            total["runs"] += worker["marks"]["runs"]
    total["after_warmup"] = own["marks"].get("after_warmup")
    total["captures"] = own["marks"]["captures"]
    total["spawns"] = own["marks"]["spawns"]
    return total


def serve_analyze(name: str, contract, modules, transaction_count: int,
                  **extra) -> dict:
    """An analyze request of one dispatcher in creation mode."""
    payload = {"op": "analyze", "id": name,
               "code": creation_wrapper(assemble(dispatcher(contract))).hex(),
               "transaction_count": transaction_count, **extra}
    if modules:
        payload["modules"] = modules.split(",")
    return payload


def serve_issues(reply: dict, what: str) -> list:
    """A reply's issues as EXPECTED_ANALYZE_TPU holds them (fails on an
    error reply)."""
    if not reply.get("ok"):
        raise AssertionError(f"serve_tpu {what}: {reply}")
    return [[issue["swc-id"], issue["title"], issue["address"]]
            for issue in reply["report"]["issues"]]


def concurrently(daemon: ServeDaemon, payloads: list) -> list:
    """Send `payloads` at once, one connection and thread each; their
    replies in order."""
    import threading

    replies = [None] * len(payloads)
    barrier = threading.Barrier(len(payloads))

    def send(index):
        barrier.wait()
        try:
            replies[index] = daemon.request(payloads[index])
        except Exception as error:  # noqa: BLE001 — reported below
            replies[index] = {"ok": False, "error": repr(error)}

    threads = [threading.Thread(target=send, args=(index,))
               for index in range(len(payloads))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(900)
    return replies


def count_delta(after: dict, before: dict) -> dict:
    return {key: {name: after[key][name] - before[key][name]
                  for name in after[key]} for key in ("launches", "replays")}


def phase_serve_tpu() -> dict:
    """Phase 20j: the port's daemon on the card (`python -m
    mythril_tpu_torch serve --engine tpu`, the default 128 lanes with
    telemetry and merging on, K11 at 32 probes and chunk 256), four
    daemons in turn, each a subprocess driven through the port's client:
    a cold one (empty manifest), a warm one on the manifest the cold one
    wrote, a `--fleet` one and one of two workers with an injected worker
    death. A line a daemon; it fails on any reply that differs from the
    JAX constants. Returns the launches the daemons and their workers
    made."""
    import shutil
    import tempfile

    from mythril_tpu_torch.serve import result_store, warmset

    work = tempfile.mkdtemp(prefix="chip-smoke-serve-")
    launches = {name: 0 for name in ops.LAUNCHES}

    def add(counts):
        for name, count in counts["launches"].items():
            launches[name] += count

    try:
        # 1. the cold daemon: warmup over an empty manifest
        manifest = os.path.join(work, "warmset.json")
        cold = ServeDaemon(work, "cold", ["--engine", "tpu",
                                          "--manifest", manifest])
        first = serve_analyze("killbilly", *ANALYZE_RUNS["killbilly"])
        import threading

        held = {}
        analyze = threading.Thread(
            target=lambda: held.update(reply=cold.request(first)))
        analyze.start()
        time.sleep(0.3)
        scrape_start = time.perf_counter()
        scraped = cold.request({"op": "metrics", "id": "m"}, timeout=60)
        health = cold.request({"op": "healthz", "id": "h"}, timeout=60)
        scrape_ms = (time.perf_counter() - scrape_start) * 1000.0
        # the analyze held its admission grant when healthz answered
        in_flight = bool(health.get("ok")) and health["queue"]["active"] >= 1
        analyze.join(900)
        exposition = scraped.get("exposition", "")
        hbm = re.search(r"^mythril_tpu_device_hbm_bytes_in_use (\S+)$",
                        exposition, re.M)
        if not (scraped.get("ok") and in_flight and hbm
                and "mythril_tpu_serve_requests_total" in exposition
                and "requests_served" in health):
            cold.fail(f"scrapes during an analyze: in flight {in_flight}, "
                      f"{health}, {exposition[:500]}")
        replies = {"killbilly": held["reply"]}
        for name in ("safe_kill", "tx_origin"):
            replies[name] = cold.request(serve_analyze(name,
                                                       *ANALYZE_RUNS[name]))
        for name, reply in replies.items():
            if serve_issues(reply, name) != \
                    EXPECTED_ANALYZE_TPU[name]["issues"]:
                cold.fail(f"{name}: {serve_issues(reply, name)}")
        jax_cold = cold.request(serve_analyze(
            "tx_origin_jax", *ANALYZE_RUNS["tx_origin"], solver="jax"))
        if serve_issues(jax_cold, "tx_origin jax") != \
                EXPECTED_ANALYZE_TPU["tx_origin"]["issues"] \
                or not jax_cold["warm"]["cold_buckets"]:
            cold.fail(f"tx_origin jax: {jax_cold['warm']}")
        repeat = cold.request(serve_analyze("repeat",
                                            *ANALYZE_RUNS["killbilly"]))
        if not repeat.get("cached") or serve_issues(repeat, "repeat") != \
                EXPECTED_ANALYZE_TPU["killbilly"]["issues"]:
            cold.fail(f"repeat not from the result store: {repeat}")
        observed = cold.request({"op": "status"})["warmset"]
        # the allocator's bytes once the requests ran (the scrape above
        # came before the first allocation)
        after = re.search(r"^mythril_tpu_device_hbm_peak_bytes (\S+)$",
                          cold.request({"op": "metrics"})["exposition"],
                          re.M)
        cold_counts = cold.stop()
        add(cold_counts)
        keys = warmset.load_manifest(manifest)
        if not keys or len(keys) != observed["observed_buckets"] \
                or not cold_counts["launches"]["sat_step"]:
            raise AssertionError(f"serve_tpu cold: manifest {keys}, "
                                 f"{observed}, {cold_counts['launches']}")
        emit({"phase": "serve_tpu", "daemon": "cold", "clock": "host",
              "start_s": cold.start_s, "scrape_ms": scrape_ms,
              "scrape_in_flight": in_flight,
              "hbm_bytes_in_use": float(hbm.group(1)),
              "hbm_peak_bytes_after": float(after.group(1)),
              "elapsed_ms": {name: reply["elapsed_ms"]
                             for name, reply in replies.items()},
              "jax_elapsed_ms": jax_cold["elapsed_ms"],
              "jax_warm": jax_cold["warm"], "repeat_cached": True,
              "manifest_keys": keys, "launches": cold_counts["launches"],
              "replays": cold_counts["replays"]})

        # 2. the warm daemon on that manifest; the cold daemon's result
        # store and verdict sidecar go, so that the request runs K11
        for path in (warmset.verdicts_path_for(manifest),
                     result_store.results_path_for(manifest)):
            if os.path.exists(path):
                os.remove(path)
        warm = ServeDaemon(work, "warm", ["--engine", "tpu",
                                          "--manifest", manifest])
        status = warm.request({"op": "status"})["warmset"]
        # metrics and healthz back to back from another connection for as
        # long as the request runs: its chunk graphs and K11 graphs are
        # captured and replayed in the engine thread meanwhile
        scrapes, scraping = [], threading.Event()

        def scrape_loop():
            while not scraping.is_set():
                for op in ("metrics", "healthz"):
                    sent = time.monotonic()
                    try:
                        reply = warm.request({"op": op, "id": op},
                                             timeout=60)
                    except Exception as error:  # noqa: BLE001 — failed
                        reply = {"ok": False, "error": repr(error)}
                    scrapes.append((sent, time.monotonic(), op, reply))

        scraper = threading.Thread(target=scrape_loop)
        scraper.start()
        try:
            jax_warm = warm.request(serve_analyze(
                "tx_origin_jax", *ANALYZE_RUNS["tx_origin"], solver="jax"))
        finally:
            scraping.set()
            scraper.join(120)
        warm_counts = warm.stop()
        add(warm_counts)
        during = count_delta(warm_counts, warm_counts["after_warmup"])
        if status["warmed_buckets"] != len(keys) \
                or status["unwarmable_buckets"] \
                or serve_issues(jax_warm, "warm tx_origin jax") != \
                EXPECTED_ANALYZE_TPU["tx_origin"]["issues"] \
                or jax_warm["warm"]["cold_buckets"] \
                or not jax_warm["warm"]["warm_hits"]:
            raise AssertionError(f"serve_tpu warm: {status}, "
                                 f"{jax_warm.get('warm')}")
        failed = [(op, reply) for _, _, op, reply in scrapes
                  if not reply.get("ok")
                  or (op == "metrics" and "mythril_tpu_device_hbm_bytes_in_use"
                      not in reply.get("exposition", ""))
                  or (op == "healthz" and "requests_served" not in reply)]
        # the scrapes in flight while a graph was being captured
        overlapping = sum(
            1 for sent, answered, _, _ in scrapes
            if any(sent < end and start < answered
                   for start, end in warm_counts["captures"]))
        request_captures = during["replays"]["captures"] \
            + during["replays"]["sat_captures"]
        if failed or not scrapes or not request_captures \
                or not overlapping:
            raise AssertionError(
                f"serve_tpu warm: scrapes during the request: {len(scrapes)}"
                f", {overlapping} during a capture, {request_captures} "
                f"captures, failed {failed[:2]}")
        emit({"phase": "serve_tpu", "daemon": "warm", "clock": "host",
              "start_s": warm.start_s, "warmed_buckets":
              status["warmed_buckets"], "warm": jax_warm["warm"],
              "warmup_k11_launches":
              warm_counts["after_warmup"]["launches"]["sat_step"],
              "warmup_sat_captures":
              warm_counts["after_warmup"]["replays"]["sat_captures"],
              "request_k11_launches": during["launches"]["sat_step"],
              "request_sat_captures": during["replays"]["sat_captures"],
              "request_chunk_captures": during["replays"]["captures"],
              "scrapes_during_request": len(scrapes),
              "scrapes_during_a_capture": overlapping,
              "scrape_ms_max": max((answered - sent) * 1000.0
                                   for sent, answered, _, _ in scrapes),
              "elapsed_ms": jax_warm["elapsed_ms"],
              "cold_elapsed_ms": jax_cold["elapsed_ms"]})

        # 3. the fleet daemon: FLEET_CORPUS sent at once
        fleet = ServeDaemon(work, "fleet", [
            "--engine", "tpu", "--fleet",
            "--manifest", os.path.join(work, "fleet", "warmset.json")])
        names = list(FLEET_CORPUS)
        fleet_replies = concurrently(fleet, [
            serve_analyze(name, FLEET_CORPUS[name], FLEET_MODULES, FLEET_TX)
            for name in names])
        fleet_counts = fleet.stop()
        add(fleet_counts)
        got = {name: serve_issues(reply, f"fleet {name}")
               for name, reply in zip(names, fleet_replies)}
        batched = [reply.get("fleet_batched", 1) for reply in fleet_replies]
        if got != EXPECTED_ANALYZE_FLEET["issues"] or max(batched) < 2:
            raise AssertionError(f"serve_tpu fleet: {got}, batches "
                                 f"{batched}")
        emit({"phase": "serve_tpu", "daemon": "fleet", "clock": "host",
              "start_s": fleet.start_s, "fleet_batched": batched,
              "elapsed_ms": [reply["elapsed_ms"] for reply in fleet_replies],
              "launches": fleet_counts["launches"]})

        # 4. two workers, the second dispatch's worker killed (SIGSEGV)
        pool = ServeDaemon(work, "pool", [
            "--engine", "tpu", "--workers", "2",
            "--inject-fault", "worker_segv:2",
            "--manifest", os.path.join(work, "pool", "warmset.json")])
        pool_replies = concurrently(pool, [
            serve_analyze(f"tx_origin_{index}", *ANALYZE_RUNS["tx_origin"])
            for index in range(3)])
        deadline = time.perf_counter() + SERVE_START_S
        while True:
            workers = pool.request({"op": "healthz"})["workers"]
            if workers["restarts"] >= 1 or time.perf_counter() > deadline:
                break
            time.sleep(0.5)
        pool_counts = pool.stop()
        add(pool_counts)
        issues = [serve_issues(reply, "pool") for reply in pool_replies]
        # each engine run in a worker (the killed dispatch died before
        # its run) and the retry among them, each on the card: K1, K2, K4
        runs = pool_counts["runs"]
        retried = [run for run in runs if run.get("retry")]
        on_card = [all(run["launches"][name] for name in
                       ("keccak", "evm_step", "sym_step")) for run in runs]
        if issues != [EXPECTED_ANALYZE_TPU["tx_origin"]["issues"]] * 3 \
                or workers["deaths"] != 1 or workers["restarts"] != 1 \
                or workers["quarantine"]["quarantined"] \
                or any(reply.get("cached") for reply in pool_replies) \
                or len(runs) != 3 or len(retried) != 1 or not all(on_card):
            raise AssertionError(f"serve_tpu pool: {issues}, {workers}, "
                                 f"runs {runs}")
        emit({"phase": "serve_tpu", "daemon": "pool", "clock": "host",
              "start_s": pool.start_s, "deaths": workers["deaths"],
              "restarts": workers["restarts"],
              "quarantined": workers["quarantine"]["quarantined"],
              "elapsed_ms": [reply["elapsed_ms"] for reply in pool_replies],
              "retry_launches": retried[0]["launches"],
              "launches": pool_counts["launches"]})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name in ("keccak", "evm_step", "sym_step", "frontier_summary",
                 "sat_step"):
        if not launches[name]:
            raise AssertionError(f"serve_tpu: {name} never launched")
    return launches


# ---- phase 20m: serve_load_tpu ---------------------------------------------------------

#: the kernels of the daemon's `--engine tpu` analyses whose launches the
#: load phase reports: K1, K2, K4, K5, K6, K8 and K9
LOAD_KERNELS = ("keccak", "evm_step", "sym_step", "frontier_summary",
                "pack_rows", "arena_delta", "telemetry")

#: the JAX daemon's reply to one analyze request of each contract of
#: tools/loadgen.py's corpus (`build_corpus(5)`): its result (the reply's
#: `torch_loadgen.RESULT_KEYS`, from tools/loadgen.py's daemon: engine
#: host, solver cdcl) and the frontier counters of the same request under
#: `"engine": "tpu"` (the JAX frontier on the CPU); recomputed by
#: tests/test_torch_tools.py. No report of this corpus holds an issue: a
#: reply held to it shows a whole, complete, issue-free analysis, not that
#: an issue was found.
_LOAD_RESULT = {"issue_count": 0, "incomplete": False, "coverage": {},
                "report": {"error": None, "issues": [], "success": True}}
_LOAD_FRONTIER = {"cold_sload_pauses": 0, "deaths": 0, "escapes": 2,
                  "executed": 2, "forks": 0, "reseeds": 0}
EXPECTED_LOAD = {
    "600050600035600055600160005260206000f3": {
        "result": _LOAD_RESULT, "frontier": _LOAD_FRONTIER},
    "600150600035600055600160005260206000f3": {
        "result": _LOAD_RESULT, "frontier": _LOAD_FRONTIER},
    "600250600035600055600160005260206000f3": {
        "result": _LOAD_RESULT, "frontier": _LOAD_FRONTIER},
    "600350600035600055600160005260206000f3": {
        "result": _LOAD_RESULT, "frontier": _LOAD_FRONTIER},
    "600450600035600055600160005260206000f3": {
        "result": _LOAD_RESULT, "frontier": _LOAD_FRONTIER},
}


#: a fresh process's start on the card, step by step, as a serve worker
#: started by a fresh interpreter would make it: torch's import, the
#: worker's modules, the CUDA context, the eleven kernel libraries
#: (seconds from the process's first line)
PROCESS_START = r"""
import json, sys, time
started = time.perf_counter()
marks = {{}}
import torch
marks["import_torch"] = time.perf_counter() - started
sys.path.insert(0, {repo!r})
from mythril_tpu_torch.serve import service, worker
marks["import_worker"] = time.perf_counter() - started
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
marks["cuda_context"] = time.perf_counter() - started
from mythril_tpu_torch.kernels import build
for name in build.SOURCES:
    build.load(name)
marks["kernel_libraries"] = time.perf_counter() - started
print(json.dumps(marks))
"""


def process_start_s() -> dict:
    """PROCESS_START's marks in a fresh interpreter."""
    proc = subprocess.run(
        [sys.executable, "-c", PROCESS_START.format(
            repo=os.path.dirname(os.path.abspath(__file__)))],
        capture_output=True, text=True, timeout=300, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _spread(values: list) -> list:
    """[n, min, median, max] of `values` (an empty list for none)."""
    values = sorted(values)
    if not values:
        return []
    return [len(values), values[0], values[len(values) // 2], values[-1]]


def phase_serve_load_tpu() -> dict:
    """Phase 20m: tools/torch_loadgen.py's SLO A/B against the port's
    daemon with `--engine tpu`, the JAX tool's two profiles as they stand
    (an uncontended interactive-only baseline, then the contended run: 1
    worker elastic to 2, queue 4, autoscale every 300 ms, up after 2),
    then one unloaded request of each corpus contract, one at a time, to a
    daemon with one worker and no result store; each daemon and its
    workers (forked by its fork server) under SERVE_RUNNER. Asserts
    tools/load_smoke.py's invariants 1 (no interactive request shed), 2
    (bulk shed), 4 (a scale-up to a pool of 2) and 5 (result-store hits).
    Each unloaded reply's result and frontier counters equal
    EXPECTED_LOAD's (the JAX daemon's), and every answered reply of both
    runs equals its contract's unloaded result; a reply the daemon
    computed under load ran the frontier (its counters at least the
    unloaded ones: deltas of concurrent requests add up). The line gives
    per-class percentiles, the interactive p99 beside max(2x, +5 s) of the
    baseline's (measured, not asserted: that floor was set for CPU noise),
    sheds with their times beside the pool's first live sample, each
    worker's spawn-to-ready, each engine run's seconds, a fresh process's
    start step by step (PROCESS_START) and the K-kernel launches. Returns
    the launches of the three daemons and their workers."""
    import shutil
    import tempfile

    from mythril_tpu_torch.serve import client
    from tools import torch_loadgen

    work = tempfile.mkdtemp(prefix="chip-smoke-load-")
    runner = os.path.join(work, "serve_runner.py")
    with open(runner, "w") as handle:
        handle.write(SERVE_RUNNER.format(
            repo=os.path.dirname(os.path.abspath(__file__))))
    stopped = []

    class LoadDaemon(torch_loadgen.SpawnedDaemon):
        """A daemon under SERVE_RUNNER, with launcher flags of its own
        after the profile's; every daemon's counts are read at its stop,
        before its directory goes."""

        def __init__(self, args, extra=()):
            self.extra = list(extra)
            super().__init__(args)

        def command(self, argv):
            self.counts_path = os.path.join(self.workdir,
                                            "daemon.counts.json")
            return [sys.executable, runner, self.counts_path,
                    "tools.torch_loadgen", "daemon", *argv, *self.extra]

        def stop(self):
            try:
                self.shutdown()
                if self.process.returncode != 0:
                    raise AssertionError(
                        f"serve_load_tpu: daemon exit "
                        f"{self.process.returncode}\n{self.log_tail()}")
                stopped.append(runner_counts(self.counts_path))
            finally:
                shutil.rmtree(self.workdir, ignore_errors=True)

    unloaded = {}
    try:
        started = time.perf_counter()
        ab = torch_loadgen.slo_ab(engine="tpu", spawn=LoadDaemon)
        wall_s = time.perf_counter() - started
        daemon = LoadDaemon(torch_loadgen.build_parser().parse_args(
            [*torch_loadgen.BASELINE_PROFILE, "--engine", "tpu"]),
            extra=["--no-result-store"])
        try:
            daemon.wait_ready()
            for code in EXPECTED_LOAD:
                unloaded[code] = client.request(
                    {"op": "analyze", "code": code,
                     "priority": "interactive"},
                    socket_path=daemon.socket_path, timeout=240)
        finally:
            daemon.stop()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    baseline, contended = ab["baseline"], ab["contended"]
    classes = contended["classes"]
    problems = []
    for code, reply in unloaded.items():
        got = {"result": torch_loadgen.reply_result(reply),
               "frontier": reply.get("frontier")}
        if reply.get("cached") or got != EXPECTED_LOAD[code]:
            problems.append(f"unloaded reply of {code[:8]} is not the JAX "
                            f"daemon's: {got} cached={reply.get('cached')}")
    answered = [record for run in (baseline, contended)
                for record in run["records"] if record["outcome"] == "ok"]
    computed = [record for record in answered if not record["cached"]]
    differ = [(record["code"][:8], record["priority"], record["result"])
              for record in answered
              if record["result"] != EXPECTED_LOAD[record["code"]]["result"]]
    idle_runs = [record["frontier"] for record in computed
                 if not record["frontier"] or any(
                     record["frontier"].get(name, 0) < floor
                     for name, floor in EXPECTED_LOAD[record["code"]][
                         "frontier"].items())]
    base_p99 = ab["slo"]["baseline_interactive_p99_ms"]
    load_p99 = ab["slo"]["contended_interactive_p99_ms"]
    p99_bound = max(2.0 * base_p99, base_p99 + 5000.0)
    launches = {name: 0 for name in ops.LAUNCHES}
    for counts in stopped:
        for name, count in counts["launches"].items():
            launches[name] += count
    transport = [outcome for name in classes
                 for outcome in classes[name]["outcomes"]
                 if outcome.startswith("transport:")]
    # the pool's first live worker on the load's clock: the last status
    # sample with no live worker
    cold_until = max((sample["t_s"] for sample in contended["trajectory"]
                      if not sample.get("pool_live")), default=0.0)
    shed_at = sorted(record["at_s"] + record["elapsed_ms"] / 1000.0
                     for record in contended["records"]
                     if record["priority"] == "interactive"
                     and record["outcome"] == "overloaded")
    if classes["interactive"]["shed"]:
        problems.append(f"{classes['interactive']['shed']} interactive "
                        f"request(s) shed, at {shed_at} s (the pool's "
                        f"first live sample at {cold_until} s)")
    if classes["bulk"]["shed"] < 1:
        problems.append("no bulk request was shed")
    if transport:
        problems.append(f"transport failures {transport}")
    if not contended["autoscale"]["scale_ups"] \
            or (contended["autoscale"]["peak_pool"] or 0) < 2:
        problems.append(f"no scale-up to a pool of 2: "
                        f"{contended['autoscale']}")
    if not contended["cache"]["store_hits"]:
        problems.append("no result-store hit")
    if differ:
        problems.append(f"replies whose result is not their contract's "
                        f"unloaded one: {differ[:4]}")
    if idle_runs:
        problems.append(f"computed replies whose frontier did less than "
                        f"the unloaded run's: {idle_runs[:4]}")
    if len(stopped) != 3:
        problems.append(f"{len(stopped)} daemons' counts read, expected 3")
    idle = [name for name in LOAD_KERNELS if not launches[name]]
    if idle:
        problems.append(f"kernels never launched: {idle}")
    emit({"phase": "serve_load_tpu", "clock": "host", "wall_s": wall_s,
          "classes": {name: {key: rollup[key] for key in (
              "sent", "ok", "cached", "shed", "p50_ms", "p95_ms",
              "p99_ms")} for name, rollup in classes.items()},
          "baseline_interactive": {key: baseline["classes"]["interactive"][
              key] for key in ("sent", "ok", "cached", "p50_ms", "p95_ms",
                               "p99_ms")},
          "interactive_p99_ms": load_p99,
          "interactive_p99_bound_ms": p99_bound,
          "interactive_p99_within_bound": load_p99 <= p99_bound,
          "interactive_p99_ratio": ab["slo"]["interactive_p99_ratio"],
          "shed": {name: rollup["shed"] for name, rollup in classes.items()},
          "interactive_shed_at_s": shed_at,
          "pool_cold_until_s": cold_until,
          "scale_ups": contended["autoscale"]["scale_ups"],
          "peak_pool": contended["autoscale"]["peak_pool"],
          "store_hits": contended["cache"]["store_hits"],
          "store_hit_rate": contended["cache"]["store_hit_rate"],
          "replies_checked": len(answered) + len(unloaded),
          "replies_computed": len(computed) + len(unloaded),
          "reference_issue_lists_nonempty": sum(
              1 for expected in EXPECTED_LOAD.values()
              if expected["result"]["report"]["issues"]),
          "worker_spawn_to_ready_s": [
              [spawn["seconds"] for spawn in counts["spawns"]]
              for counts in stopped],
          "engine_run_s": [_spread([run["seconds"] for run in counts["runs"]])
                           for counts in stopped],
          "process_start_s": process_start_s(),
          "launches": {name: launches[name] for name in LOAD_KERNELS}})
    if problems:
        raise AssertionError("serve_load_tpu: " + "; ".join(problems))
    return launches


# ---- on-chain input: a JSON-RPC chain stub -------------------------------------------


class ChainStub:
    """A JSON-RPC chain on 127.0.0.1 (a free port) served from a thread:
    `eth_getCode`, `eth_getStorageAt` and `eth_getBalance` answer from
    `codes`, `storage` and `balances`, keyed by the lower-case address (so
    both spellings of an address read one account), any method of
    `answers` with its canned result, and every other method, or one named
    in `fail`, with a JSON-RPC error. `log` holds each request's [method,
    params] in order and `bodies` the requests as sent. A context manager:
    the server runs inside the block."""

    def __init__(self, codes: dict, storage=None, balances=None,
                 answers=None, fail=()):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.codes = {address.lower(): code for address, code in codes.items()}
        self.storage = {(address.lower(), slot): value
                        for (address, slot), value in (storage or {}).items()}
        self.balances = {address.lower(): value
                         for address, value in (balances or {}).items()}
        self.answers = dict(answers or {})
        self.fail = set(fail)
        self.bodies = []
        self.lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                reply = json.dumps(stub.answer(json.loads(
                    self.rfile.read(length)))).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(reply)))
                self.end_headers()
                self.wfile.write(reply)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    @property
    def rpc(self) -> str:
        """The endpoint as `--rpc` takes it."""
        return f"127.0.0.1:{self.server.server_address[1]}"

    @property
    def log(self) -> list:
        with self.lock:
            return [[body.get("method"), body.get("params")]
                    for body in self.bodies]

    def clear(self) -> None:
        with self.lock:
            self.bodies.clear()

    def answer(self, body: dict) -> dict:
        with self.lock:
            self.bodies.append(body)
        method, params = body.get("method"), body.get("params") or []
        result = None
        if method in self.fail:
            pass
        elif method in self.answers:
            result = self.answers[method]
        elif method == "eth_getCode":
            result = "0x" + self.codes.get(params[0].lower(), "")
        elif method == "eth_getStorageAt":
            value = self.storage.get((params[0].lower(), int(params[1], 16)),
                                     0)
            result = "0x{:064x}".format(value)
        elif method == "eth_getBalance":
            result = hex(self.balances.get(params[0].lower(), 0))
        if result is None:
            return {"jsonrpc": "2.0", "id": body.get("id"),
                    "error": {"code": -32601,
                              "message": f"the stub chain does not serve "
                                         f"{method}"}}
        return {"jsonrpc": "2.0", "id": body.get("id"), "result": result}

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


#: the onchain_tpu phase's account: KILLBILLY's runtime code, named to `-a`
#: in mixed case (the frontier's fault-ins ask for its storage in lower
#: case, `Storage.__getitem__`)
ONCHAIN_ADDRESS = "0x00000000000000000000000000000000DeaDBeef"
ONCHAIN_CODE = assemble(dispatcher(KILLBILLY)).hex()
#: read-storage's slots: 0 and 1 (slot 1 = 5), and key 7 of the mapping at
#: position 1 (keccak(key . position) = 42)
ONCHAIN_MAPPING = (1, 7, 42)


def mapping_slot(position: int, key: int) -> int:
    from mythril_tpu_torch.utils.helpers import sha3

    return int.from_bytes(sha3(key.to_bytes(32, "big")
                               + position.to_bytes(32, "big")), "big")


def onchain_chain(armed: int, fail=()) -> ChainStub:
    """The chain of the onchain_tpu phase: slot 0 = `armed`."""
    position, key, value = ONCHAIN_MAPPING
    return ChainStub(
        {ONCHAIN_ADDRESS: ONCHAIN_CODE},
        storage={(ONCHAIN_ADDRESS, 0): armed, (ONCHAIN_ADDRESS, 1): 5,
                 (ONCHAIN_ADDRESS, mapping_slot(position, key)): value},
        balances={ONCHAIN_ADDRESS: 10 ** 18}, fail=fail)


#: the phase's analyses, at the default configuration and one transaction:
#: slot 0's value on the chain and the extra arguments. Slot 0 = 1 arms
#: the kill (SWC-106 at one transaction), 0 leaves it unarmed, and
#: --no-onchain-data leaves the slot symbolic (the kill is reachable)
ONCHAIN_RUNS = {"armed": (1, ()), "unarmed": (0, ()),
                "no_onchain_data": (1, ("--no-onchain-data",))}
#: the phase's other commands on the same chain (slot 0 = 1)
ONCHAIN_COMMANDS = {
    "read_storage": ["read-storage", ONCHAIN_ADDRESS, "0", "2"],
    "read_storage_mapping": ["read-storage", ONCHAIN_ADDRESS, "mapping",
                             str(ONCHAIN_MAPPING[0]),
                             str(ONCHAIN_MAPPING[1])],
    "disassemble": ["disassemble", "-a", ONCHAIN_ADDRESS],
}


def onchain_argv(name: str, rpc: str, engine: str = "tpu") -> list:
    """The CLI arguments of one of ONCHAIN_RUNS or ONCHAIN_COMMANDS."""
    if name in ONCHAIN_COMMANDS:
        return [*ONCHAIN_COMMANDS[name], "--rpc", rpc]
    return ["analyze", "-a", ONCHAIN_ADDRESS, "--rpc", rpc, "-t", "1", "-o",
            "json", "--engine", engine, *ONCHAIN_RUNS[name][1]]


#: the JAX package's CLI (`MYTHRIL_TPU_LANES=128 python -m mythril_tpu -v 4
#: analyze -a ... --rpc ... --engine tpu`) on ONCHAIN_RUNS: exit code,
#: issues and per transaction the frontier's counters (`tpu_summary`);
#: tests/test_torch_rpc.py recomputes them with JAX
EXPECTED_ONCHAIN = {
    "armed": {"exit": 1,
              "issues": [["106", "Unprotected Selfdestruct", 52]],
              "frontier": [[2, 1, 0, 3]]},
    "unarmed": {"exit": 0, "issues": [], "frontier": [[2, 1, 0, 3]]},
    "no_onchain_data": {"exit": 1,
                        "issues": [["106", "Unprotected Selfdestruct", 52]],
                        "frontier": [[3, 1, 0, 4]]},
}
_GET_CODE = ["eth_getCode", ["0x00000000000000000000000000000000DeaDBeef",
                             "latest"]]
#: the stub's request log ([method, params]) of each of the JAX CLI's
#: ONCHAIN_RUNS and ONCHAIN_COMMANDS: `-a` as given, the fault-in's slot at
#: the lower-case address
EXPECTED_ONCHAIN_RPC = {
    "armed": [_GET_CODE, [
        "eth_getStorageAt",
        ["0x00000000000000000000000000000000deadbeef", "0x0", "latest"]]],
    "unarmed": [_GET_CODE, [
        "eth_getStorageAt",
        ["0x00000000000000000000000000000000deadbeef", "0x0", "latest"]]],
    "no_onchain_data": [_GET_CODE],
    "read_storage": [
        ["eth_getStorageAt",
         ["0x00000000000000000000000000000000DeaDBeef", "0x0", "latest"]],
        ["eth_getStorageAt",
         ["0x00000000000000000000000000000000DeaDBeef", "0x1", "latest"]]],
    "read_storage_mapping": [
        ["eth_getStorageAt",
         ["0x00000000000000000000000000000000DeaDBeef",
          "0xdc686ec4a0ff239c70e7c7c36e8f853eced3bc8618f48d2b816da2a74311237e",
          "latest"]]],
    "disassemble": [_GET_CODE],
}
#: the sha256 of the JAX CLI's standard output of each of ONCHAIN_COMMANDS
EXPECTED_ONCHAIN_OUTPUT = {
    "read_storage":
        "8fe5fa015fa7fb6cf6ed7fb4be5ca4e97c36d3462fc4f8f3427c536ab4f34d6c",
    "read_storage_mapping":
        "93679275bbb2908567a58017384ef718fc8a365d1242fef8e6a4c14c06c110f9",
    "disassemble":
        "6ae6734f4f52ac24b7b058e7c57e62a5256f5cb41004080254303360767a77ca",
}


def cli_output(name: str, argv: list) -> tuple:
    """`cli.main(argv)` in this process: exit code and standard output
    (raises unless 0)."""
    from mythril_tpu_torch.interfaces import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exit_code = cli.main(argv)
    if exit_code != 0:
        raise AssertionError(f"{name}: exit {exit_code}")
    return exit_code, out.getvalue()


@contextlib.contextmanager
def rpc_timed(record: dict):
    """Adds each JSON-RPC call's seconds to record["rpc_s"] and counts it
    in record["rpc_calls"]; a call made while the current stream captures
    a CUDA graph raises."""
    from mythril_tpu_torch.ethereum.rpc import EthJsonRpc

    call = EthJsonRpc._call
    record.update(rpc_s=0.0, rpc_calls=0)

    def timed(self, method, params=None):
        if torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            raise AssertionError(f"{method} inside a CUDA graph capture")
        start = time.perf_counter()
        try:
            return call(self, method, params)
        finally:
            record["rpc_s"] += time.perf_counter() - start
            record["rpc_calls"] += 1

    with mock.patch.object(EthJsonRpc, "_call", timed):
        yield record


@contextlib.contextmanager
def k7_calls(record: dict):
    """Counts K7's gathers and scatters (`ops.gather_rows_flat`,
    `ops.scatter_rows`) in record["k7_gathers"] and ["k7_scatters"]."""
    record.update(k7_gathers=0, k7_scatters=0)
    gather, scatter = ops.gather_rows_flat, ops.scatter_rows

    def counted_gather(*args, **kwargs):
        record["k7_gathers"] += 1
        return gather(*args, **kwargs)

    def counted_scatter(*args, **kwargs):
        record["k7_scatters"] += 1
        return scatter(*args, **kwargs)

    with mock.patch.object(ops, "gather_rows_flat", counted_gather), \
            mock.patch.object(ops, "scatter_rows", counted_scatter):
        yield record


def onchain_run(name: str, chain: ChainStub) -> tuple:
    """One of ONCHAIN_RUNS through `analyze_tpu_run` on `chain` (its log
    cleared first): the run's summary, its record with the RPC seconds and
    calls and K7's gathers and scatters, and the chain's request log."""
    chain.clear()
    record = {}
    with rpc_timed(record), k7_calls(record):
        _, summary, run = analyze_tpu_run(
            name, argv=onchain_argv(name, chain.rpc))
    return summary, {**run, **record, "phase": "onchain_tpu"}, chain.log


def check_onchain(name: str, summary: dict, log: list) -> None:
    """Raise unless one of ONCHAIN_RUNS gave the JAX CLI's summary and
    request log."""
    if summary != EXPECTED_ONCHAIN[name]:
        raise AssertionError(f"onchain_tpu {name}: {summary}, the JAX CLI "
                             f"{EXPECTED_ONCHAIN[name]}")
    if log != EXPECTED_ONCHAIN_RPC[name]:
        raise AssertionError(f"onchain_tpu {name}: requests {log}, the JAX "
                             f"CLI's {EXPECTED_ONCHAIN_RPC[name]}")


def onchain_command(name: str, chain: ChainStub) -> tuple:
    """One of ONCHAIN_COMMANDS through `cli.main` in this process: its
    output's sha256 and the chain's request log."""
    chain.clear()
    _, text = cli_output(f"onchain_tpu {name}", onchain_argv(name, chain.rpc))
    return hashlib.sha256(text.encode()).hexdigest(), chain.log


def phase_onchain_tpu() -> dict:
    """`analyze -a ADDRESS --rpc` on the card: ONCHAIN_RUNS against a stub
    chain, each held to EXPECTED_ONCHAIN and its request log to
    EXPECTED_ONCHAIN_RPC, then ONCHAIN_COMMANDS' output to the JAX CLI's.
    Fails unless the on-chain runs faulted storage in through K7's
    gathers and scatters with at least one eth_getStorageAt. Returns the
    phase's kernel launches."""
    frontier.configure()
    launches = {name: 0 for name in ops.LAUNCHES}
    gathers = scatters = fault_ins = storage_reads = 0
    for name, (armed, extra) in ONCHAIN_RUNS.items():
        with onchain_chain(armed) as chain:
            summary, record, log = onchain_run(name, chain)
        if record["incomplete"]:
            raise AssertionError(f"onchain_tpu {name}: the budget ran out")
        check_onchain(name, summary, log)
        emit({**record, "issues": summary["issues"], "requests": len(log)})
        for key, count in record["launches"].items():
            launches[key] += count
        if not extra:
            gathers += record["k7_gathers"]
            scatters += record["k7_scatters"]
            fault_ins += sum(tx["fault_ins"] for tx in record["frontier"])
            storage_reads += sum(method == "eth_getStorageAt"
                                 for method, _ in log)
    if not (gathers and scatters and fault_ins and storage_reads):
        raise AssertionError(
            f"onchain_tpu: {gathers} K7 gathers, {scatters} scatters, "
            f"{fault_ins} fault-ins, {storage_reads} eth_getStorageAt")
    with onchain_chain(1) as chain:
        for name in ONCHAIN_COMMANDS:
            digest, log = onchain_command(name, chain)
            if [digest, log] != [EXPECTED_ONCHAIN_OUTPUT[name],
                                 EXPECTED_ONCHAIN_RPC[name]]:
                raise AssertionError(
                    f"onchain_tpu {name}: output {digest}, requests {log}; "
                    f"the JAX CLI's {EXPECTED_ONCHAIN_OUTPUT[name]}, "
                    f"{EXPECTED_ONCHAIN_RPC[name]}")
            emit({"phase": "onchain_tpu", "run": name, "requests": len(log)})
    return launches


# ---- Solidity and foundry input: a stub solc -----------------------------------------

#: KILLBILLY as Solidity: the source text the stub solc's output names, and
#: the source range of each of its runtime instructions (`killbilly_srcmap`)
KILLBILLY_SOL = """\
// SPDX-License-Identifier: MIT
pragma solidity ^0.8.0;

contract KillBilly {
    uint256 killable;

    function activatekillability() public {
        killable = 1;
    }

    function commencekilling() public {
        if (killable == 1) {
            selfdestruct(payable(msg.sender));
        }
    }
}
"""
_ACTIVATE = "function activatekillability() public {\n        killable = 1;\n    }"
_COMMENCE = KILLBILLY_SOL[KILLBILLY_SOL.index("function commencekilling"):
                          KILLBILLY_SOL.rindex("    }\n}") + 5]
_IF = KILLBILLY_SOL[KILLBILLY_SOL.index("if (killable"):
                    KILLBILLY_SOL.rindex("        }") + 9]
#: the runtime instructions in order (`dispatcher(KILLBILLY)`), a snippet
#: of the source each: the dispatcher and fallback are the contract's
KILLBILLY_SNIPPETS = (
    [KILLBILLY_SOL[KILLBILLY_SOL.index("contract"):].rstrip("\n")] * 15
    + [_ACTIVATE] * 2 + ["killable = 1"] * 3 + [_ACTIVATE]
    + [_COMMENCE] * 2 + ["killable == 1"] * 4 + [_IF] * 2 + [_COMMENCE]
    + [_IF[_IF.index("{"):], "msg.sender",
       "selfdestruct(payable(msg.sender))"])
SOLIDITY_FILE = "KillBilly.sol"
SOLIDITY_CONTRACT = "KillBilly"


def killbilly_srcmap(snippets) -> str:
    """A solc source map (`s:l:f:j`, a field left empty where it repeats
    the entry before) with one entry a snippet, file 0."""
    entries, before = [], None
    for snippet in snippets:
        fields = [str(KILLBILLY_SOL.index(snippet)), str(len(snippet)), "0",
                  "-"]
        entries.append(":".join(
            "" if before and field == was else field
            for field, was in zip(fields, before or fields)).rstrip(":"))
        before = fields
    return ";".join(entries)


def killbilly_standard_json() -> dict:
    """The stub solc's standard-JSON output for KillBilly.sol: creation and
    runtime code, a source map entry an instruction (the creation code's
    CODECOPY prologue is the contract's, the runtime it carries mapped as
    the runtime) and a small AST (two functions, one with selfdestruct)."""
    runtime = assemble(dispatcher(KILLBILLY))
    creation = creation_wrapper(runtime)
    if len(Disassembly(runtime.hex()).instruction_list) \
            != len(KILLBILLY_SNIPPETS):
        raise AssertionError("KILLBILLY_SNIPPETS: not one an instruction")
    prologue = len(Disassembly(creation.hex()).instruction_list) \
        - len(KILLBILLY_SNIPPETS)
    contract = KILLBILLY_SNIPPETS[0]

    def function(name, body):
        return {"nodeType": "FunctionDefinition", "name": name,
                "stateMutability": "nonpayable", "visibility": "public",
                "modifiers": [], "body": {"nodeType": "Block",
                                          "statements": body}}

    killable = {"nodeType": "Identifier", "name": "killable"}
    ast = {"nodeType": "SourceUnit", "absolutePath": SOLIDITY_FILE, "id": 0,
           "nodes": [{"nodeType": "ContractDefinition",
                      "name": SOLIDITY_CONTRACT, "nodes": [
                          {"nodeType": "VariableDeclaration",
                           "name": "killable", "stateVariable": True},
                          function("activatekillability", [
                              {"nodeType": "ExpressionStatement",
                               "expression": {"nodeType": "Assignment",
                                              "leftHandSide": killable}}]),
                          function("commencekilling", [
                              {"nodeType": "IfStatement",
                               "condition": {"nodeType": "BinaryOperation",
                                             "operator": "==",
                                             "leftExpression": killable},
                               "trueBody": {"nodeType": "FunctionCall",
                                            "expression": {
                                                "nodeType": "Identifier",
                                                "name": "selfdestruct"}}}])]}]}
    return {
        "sources": {SOLIDITY_FILE: {"id": 0, "ast": ast}},
        "contracts": {SOLIDITY_FILE: {SOLIDITY_CONTRACT: {"evm": {
            "bytecode": {"object": creation.hex(), "sourceMap":
                         killbilly_srcmap([contract] * prologue
                                          + KILLBILLY_SNIPPETS)},
            "deployedBytecode": {"object": runtime.hex(), "sourceMap":
                                 killbilly_srcmap(KILLBILLY_SNIPPETS)},
            "methodIdentifiers": {signature: f"{selector(signature):08x}"
                                  for signature in KILLBILLY}}}}},
    }


#: the stub solc: prints the canned output beside it and reads (and drops)
#: the standard-JSON input
STUB_SOLC = """#!{python}
import sys
sys.stdin.read()
with open({output!r}) as handle:
    sys.stdout.write(handle.read())
"""


def solidity_fixture(directory: str) -> dict:
    """Writes into `directory` KillBilly.sol, a stub `solc` (in bin/) that
    prints `killbilly_standard_json()`, and a foundry project
    (foundry/out/KillBilly.sol/KillBilly.json, forge's artifact layout).
    Returns their paths: `bin`, `source`, `foundry`."""
    paths = {"bin": os.path.join(directory, "bin"),
             "source": os.path.join(directory, SOLIDITY_FILE),
             "foundry": os.path.join(directory, "foundry")}
    os.makedirs(paths["bin"], exist_ok=True)
    output = killbilly_standard_json()
    with open(paths["source"], "w") as handle:
        handle.write(KILLBILLY_SOL)
    canned = os.path.join(paths["bin"], "solc.json")
    with open(canned, "w") as handle:
        json.dump(output, handle)
    solc = os.path.join(paths["bin"], "solc")
    with open(solc, "w") as handle:
        handle.write(STUB_SOLC.format(python=sys.executable, output=canned))
    os.chmod(solc, 0o755)
    artifacts = os.path.join(paths["foundry"], "out", SOLIDITY_FILE)
    os.makedirs(artifacts, exist_ok=True)
    evm = output["contracts"][SOLIDITY_FILE][SOLIDITY_CONTRACT]["evm"]
    with open(os.path.join(artifacts, SOLIDITY_CONTRACT + ".json"),
              "w") as handle:
        json.dump({kind: {"object": "0x" + evm[kind]["object"],
                          "sourceMap": evm[kind]["sourceMap"]}
                   for kind in ("bytecode", "deployedBytecode")}, handle)
    return paths


#: the solidity_tpu phase's runs, from the fixture's directory with the stub
#: solc first on PATH
SOLIDITY_RUNS = {
    "analyze": ["analyze", SOLIDITY_FILE, "-t", "2", "-o", "json"],
    "foundry": ["foundry", "--project-root", "foundry", "-t", "2", "-o",
                "json"],
}


def source_issues(report: dict) -> list:
    """Each issue's SWC id, address and source mapping (file, line,
    code)."""
    return [[issue["swc-id"], issue["address"], issue.get("filename"),
             issue.get("lineno"), issue.get("code")]
            for issue in report["issues"]]


def solidity_summary(report: dict, exit_code: int, log_text: str) -> dict:
    """What EXPECTED_SOLIDITY holds of a run: `tpu_summary`'s, its issues
    by `source_issues`."""
    return {**tpu_summary(report, exit_code, log_text),
            "issues": source_issues(report)}


#: the JAX package's CLI (`MYTHRIL_TPU_LANES=128 python -m mythril_tpu -v 4
#: <run> --engine tpu` from the fixture's directory, the stub solc first on
#: PATH) on SOLIDITY_RUNS; tests/test_torch_solidity.py recomputes them
EXPECTED_SOLIDITY = {
    "analyze": {"exit": 1,
                "issues": [["106", 52, "KillBilly.sol", 13,
                            "selfdestruct(payable(msg.sender))"]],
                "frontier": [[2, 0, 0, 3], [6, 0, 0, 9]]},
    "foundry": {"exit": 1, "issues": [["106", 52, None, None, None]],
                "frontier": [[2, 0, 0, 3], [6, 0, 0, 9]]},
}


@contextlib.contextmanager
def solidity_fixture_dir():
    """A fixture directory (`solidity_fixture`) as the working directory,
    its stub solc first on PATH; both restored after the block."""
    import shutil
    import tempfile

    directory = tempfile.mkdtemp(prefix="chip_smoke_solidity_")
    cwd, path = os.getcwd(), os.environ.get("PATH", "")
    try:
        paths = solidity_fixture(directory)
        os.environ["PATH"] = paths["bin"] + os.pathsep + path
        os.chdir(directory)
        yield paths
    finally:
        os.chdir(cwd)
        os.environ["PATH"] = path
        shutil.rmtree(directory, ignore_errors=True)


def solidity_run(name: str) -> tuple:
    """One of SOLIDITY_RUNS with `--engine tpu` through `analyze_tpu_run`,
    from the fixture directory that `solidity_fixture_dir` made current:
    its summary (as `solidity_summary`) and record."""
    report, summary, record = analyze_tpu_run(
        name, argv=[*SOLIDITY_RUNS[name], "--engine", "tpu"])
    return ({**summary, "issues": source_issues(report)},
            {**record, "phase": "solidity_tpu"})


def phase_solidity_tpu() -> dict:
    """A Solidity file and a foundry project on the card: SOLIDITY_RUNS
    with the stub solc, each held to EXPECTED_SOLIDITY (the source-mapped
    issues of the JAX CLI). Returns the phase's kernel launches."""
    frontier.configure()
    launches = {name: 0 for name in ops.LAUNCHES}
    with solidity_fixture_dir():
        for name in SOLIDITY_RUNS:
            summary, record = solidity_run(name)
            if record["incomplete"] or summary != EXPECTED_SOLIDITY[name]:
                raise AssertionError(f"solidity_tpu {name}: {summary}, the "
                                     f"JAX CLI {EXPECTED_SOLIDITY[name]}")
            emit({**record, "issues": summary["issues"]})
            for key, count in record["launches"].items():
                launches[key] += count
    for name in ("keccak", "evm_step", "sym_step"):
        if not launches[name]:
            raise AssertionError(f"solidity_tpu: {name} never launched")
    return launches


def sat_solve(solve, *args, **kwargs) -> dict:
    """One entry-point call with the launch counts zeroed just before and
    read just after, each chunk's stream time (CUDA events around
    run_chunk) and a device copy of the state after each of the first two
    chunks."""
    events, states = [], []
    run_chunk = device_solver.run_chunk

    def timed_chunk(state, *chunk_args, **chunk_kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_chunk(state, *chunk_args, **chunk_kwargs)
        end.record()
        events.append((start, end))
        if len(states) < 2:
            states.append(convert.clone(state))
        return out

    torch.cuda.synchronize()
    device_solver.run_chunk = timed_chunk
    ops.reset_launches()
    start = time.perf_counter()
    try:
        result = solve(*args, **kwargs)
        torch.cuda.synchronize()
    finally:
        device_solver.run_chunk = run_chunk
    wall = time.perf_counter() - start
    stream_ms = sum(s.elapsed_time(e) for s, e in events)
    chunks = max(len(events), 1)
    return {"result": result, "launches": dict(ops.LAUNCHES),
            "replays": dict(ops.REPLAYS),
            "states": states, "chunks": len(events),
            "steps": len(events) * kwargs.get("chunk", 256),
            "wall_s": wall, "chunk_stream_ms": stream_ms / chunks,
            "host_ms_per_chunk": (wall * 1e3 - stream_ms) / chunks}


def sat_verdict(name, status, model, clauses, lowered, blaster,
                facade) -> str:
    if status == device_solver.SAT:
        check_model(clauses, lowered, blaster, model, name)
    if status != device_solver.UNKNOWN and status != EXPECTED_SAT[name]["cdcl"]:
        raise AssertionError(f"{name}: verdict {status}, CDCL says "
                             f"{EXPECTED_SAT[name]['cdcl']}")
    if status != device_solver.UNKNOWN and status != facade[name]:
        raise AssertionError(f"{name}: verdict {status}, the SMT façade "
                             f"says {facade[name]}")
    return {device_solver.SAT: "sat", device_solver.UNSAT: "unsat",
            device_solver.UNKNOWN: "unknown"}[status]


def check_cnf(name, clauses, n_vars) -> None:
    want = EXPECTED_SAT[name]
    if (len(clauses), n_vars) != (want["clauses"], want["n_vars"]) \
            or ("cnf" in want and cnf_digest(clauses, n_vars) != want["cnf"]):
        raise AssertionError(f"{name}: the CNF differs from the JAX one")


def phase_sat_lane(dev, facade) -> tuple:
    """The slice at full width: captured queries through the port's CNF
    pipeline and `solve_cnf_device` with its defaults."""
    launches = {name: 0 for name in ops.LAUNCHES}
    runs = {}
    for name in SAT_LANE_QUERIES:
        start = time.perf_counter()
        clauses, n_vars, lowered, blaster = corpus_query(name)
        cnf_s = time.perf_counter() - start
        check_cnf(name, clauses, n_vars)
        want = EXPECTED_SAT[name]
        run = sat_solve(device_solver.solve_cnf_device, clauses, n_vars,
                        device=dev)
        status, model = run.pop("result")
        states = run.pop("states")
        if "chunks" in want:
            held = "JAX digests"
            for index, state in enumerate(states):
                if state_digest(state) != want["chunks"][index]:
                    raise AssertionError(f"{name}: state after chunk "
                                         f"{index + 1} differs from the JAX "
                                         f"lane's")
        else:
            # a process-dependent CNF: the same chunks through the twin
            held = "the twin on the card"
            problem = device_solver.build_problem(clauses, n_vars)
            if problem.lits.shape[0] != want["tiles"]:
                raise AssertionError(f"{name}: {problem.lits.shape[0]} tiles")
            tensors = device_solver.device_problem(problem, dev)
            plain = device_solver.initial_state(problem.init_assign, 32, dev)
            for index, state in enumerate(states):
                device_solver.run_chunk_reference(plain, tensors, 256, 5)
                assert_same(state, plain, f"{name} chunk {index + 1}")
        verdict = sat_verdict(name, status, model, clauses, lowered, blaster,
                              facade)
        if "jax" in want:
            jax_run = want["jax"]
            if (status, run["chunks"]) != (jax_run["status"],
                                           jax_run["chunks"]) \
                    or model_digest(model) != jax_run["model"]:
                raise AssertionError(f"{name}: verdict, chunk count or model "
                                     f"differs from the JAX lane's")
        for kernel, count in run.pop("launches").items():
            launches[kernel] += count
        # the solve's host set-up: the bucketed arrays, built in Python
        start = time.perf_counter()
        device_solver.build_problem(clauses, n_vars)
        build_s = time.perf_counter() - start
        runs[name] = {"clauses": len(clauses), "n_vars": n_vars,
                      "tiles": want["tiles"], "verdict": verdict,
                      "chunks_held_to": held, "cnf_s": cnf_s,
                      "build_problem_s": build_s, **run}
    # the device's share of the lane: 1689-24 again under the profiler
    clauses, n_vars, _, _ = corpus_query(SAT_FULL_QUERY)

    def solve(_):
        start = time.perf_counter()
        device_solver.solve_cnf_device(clauses, n_vars, device=dev)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3

    _, wall_ms, events = profile_cuda(solve, "sat_lane", ops.reset_launches)
    k11_ms = other_ms = 0.0
    for event in events:
        if "sat_" in event.key:
            k11_ms += event.self_device_time_total / 1e3
        else:
            other_ms += event.self_device_time_total / 1e3
    steps = ops.LAUNCHES["sat_step"] * 256
    if k11_ms <= 0 or not steps:
        raise AssertionError("the profiler recorded no device time of K11")
    idle_share = 1.0 - (k11_ms + other_ms) / wall_ms
    if idle_share < 0:
        raise AssertionError(f"the profiled solve's device time exceeds its "
                             f"wall time (idle share {idle_share})")
    profiled = {"query": SAT_FULL_QUERY, "wall_ms": wall_ms, "steps": steps,
                "k11_device_ms": k11_ms, "other_device_ms": other_ms,
                "idle_share": idle_share,
                "k11_device_ms_per_step": k11_ms / steps}
    emit({"phase": "sat_lane", "defaults": {"n_probes": 32, "chunk": 256,
                                            "max_steps": 20_000},
          "queries": runs, "profiled": profiled})
    return launches, profiled


def phase_sat_batch(dev, facade) -> dict:
    """One dispatch flush: four captured queries of one bucket through
    `solve_cnf_device_batch`, held to the JAX batch runner's first chunk."""
    queries, parts = [], []
    for name in SAT_BATCH_QUERIES:
        clauses, n_vars, lowered, blaster = corpus_query(name)
        check_cnf(name, clauses, n_vars)
        queries.append((clauses, n_vars))
        parts.append((clauses, lowered, blaster))
    run = sat_solve(device_solver.solve_cnf_device_batch, queries,
                    chunk=SAT_BATCH_CHUNK, device=dev)
    # the flush's host set-up: the four bucketed arrays, built in Python
    start = time.perf_counter()
    for clauses, n_vars in queries:
        device_solver.build_problem(clauses, n_vars)
    run["build_problem_s"] = time.perf_counter() - start
    results = run.pop("result")
    if state_digest(run.pop("states")[0]) != EXPECTED_SAT_BATCH:
        raise AssertionError("sat_batch: the state after the first chunk "
                             "differs from the JAX batch runner's")
    verdicts = {name: sat_verdict(name, status, model, *part, facade)
                for name, (status, model), part
                in zip(SAT_BATCH_QUERIES, results, parts)}
    launches = run.pop("launches")
    emit({"phase": "sat_batch", "chunk": SAT_BATCH_CHUNK,
          "queries": list(SAT_BATCH_QUERIES), "verdicts": verdicts, **run})
    return launches


#: K13's logical shard counts on one card
SAT_SHARD_COUNTS = (2, 4)
#: the full-width comparison: two chunks of this many steps a query
SAT_SHARD_STEPS = 16
#: the analyze_jax run whose queries shard through the dispatch, and the
#: clause cap that sends its cones (17 to 51 thousand clauses: 16 and 64
#: tiles) to a mesh of four shards
SAT_SHARD_RUN = "tx_origin"
SAT_SHARD_CAP = 16384


def race_cnf() -> tuple:
    """The phase race of two shards (tests/test_torch_sat_shard.py): var 5
    FALSE by clause 0 and TRUE by clause 2048; at D = 4 the two lie in
    different shards and FALSE wins, unsharded the higher clause (TRUE)."""
    return [[-5]] + [[1, 2, 3]] * 2047 + [[5]] + [[1, 2, 4]] * 2047, 8


def sat_shard_compare(state, tensors, chunk, n_chunks, depth, mesh,
                      what) -> None:
    """K13, graphed and eager, against its twin from one state: every leaf
    after each chunk, every shard's replica equal to the state, and on a
    one-card mesh one graph replay a graphed chunk (the eager chunk none);
    on a mesh of several cards both run eager host calls."""
    plain = convert.clone(state)
    runs = {"graphed": (convert.clone(state), True),
            "eager": (convert.clone(state), False)}
    one_card = all(dev == state.assign.device for dev in mesh)
    for index in range(n_chunks):
        device_solver.run_chunk_sharded_reference(plain, tensors, chunk,
                                                  depth, len(mesh))
        for mode, (kern, graph) in runs.items():
            replays = ops.REPLAYS["sat_shard_chunk"]
            ops.sat_run_sharded(kern, tensors, chunk, depth, mesh,
                                graph=graph)
            want = replays + (1 if graph and one_card else 0)
            if ops.REPLAYS["sat_shard_chunk"] != want:
                raise AssertionError(
                    f"K13 {what} {mode} chunk {index}: "
                    f"{ops.REPLAYS['sat_shard_chunk'] - replays} graph "
                    f"replays")
            assert_same(kern, plain, f"K13 {what} {mode} chunk {index}")
            for shard, replica in enumerate(ops.sat_shard_replicas(
                    kern, tensors, depth, mesh)):
                for leaf, got in zip(kern, replica):
                    if not torch.equal(leaf.cpu(), got.cpu()):
                        raise AssertionError(
                            f"K13 {what} {mode} chunk {index}: shard "
                            f"{shard}'s replica differs")


#: set bits of each byte value
POPCOUNT8 = [bin(value).count("1") for value in range(256)]


def plane_bytes(state) -> int:
    """Bytes of one shard's exchange plane (layout.cuh K11_XCHG): two
    bitmap words a probe and bitmap word, two flags a probe, int32."""
    rows = state.assign.numel() // state.assign.shape[-1]
    return 4 * rows * 2 * (-(-state.assign.shape[-1] // 32) + 1)


def shard_exchange(state, tensors, depth, mesh) -> tuple:
    """What the last K13 step of `state` exchanged (each shard's own
    plane, which its seal wrote whole): the keyed-var and FALSE-phase
    bitmaps [D, rows, NW] (int32 words) and each shard's conflict and unit
    flags [D, 2, rows]."""
    n_shards = len(mesh)
    rows = state.assign.numel() // state.assign.shape[-1]
    n_words = -(-state.assign.shape[-1] // 32)
    planes = ops.sat_shard_planes(state, tensors, depth, mesh)
    own = torch.stack([planes[d][d].to(state.assign.device)
                       for d in range(n_shards)])
    words = rows * n_words
    keyed = own[:, :words].reshape(n_shards, rows, n_words)
    false = own[:, words:2 * words].reshape(n_shards, rows, n_words)
    flags = own[:, 2 * words:].reshape(n_shards, 2, rows)
    return keyed, false, flags


def phase_planes_of(keyed, false, v1: int) -> torch.Tensor:
    """int8 [D, rows, V1] phase codes (0 none, 1 TRUE, 2 FALSE) of the
    bitmaps: each shard's phase of each var, as JAX's `implied` plane."""
    shifts = torch.arange(32, device=keyed.device, dtype=torch.int32)

    def unpack(words):
        bits = (words.unsqueeze(-1) >> shifts) & 1
        return bits.reshape(words.shape[:-1] + (-1,))[..., :v1]

    k, f = unpack(keyed), unpack(false)
    return (k * (1 + f)).to(torch.int8)


def shard_exchange_bound(state, tensors, depth, mesh, steps) -> dict:
    """bound_ms of all D shards' seal launches and of all D combine
    launches, a step averaged over `steps` K13 steps from `state`, counted
    on this run's exchange. The seal of a shard reads its bitmap words,
    its two flags and the key of each var keyed there and writes its plane;
    the combine function reads the D planes once and writes the combined
    bitmap words and flags and a key for each var keyed in any shard.
    Also the plane bytes copied a step (D (D - 1) planes) and the last
    step's stacked int8 phase planes [D, rows, V1]."""
    n_shards = len(mesh)
    table = torch.tensor(POPCOUNT8, dtype=torch.int64,
                         device=state.assign.device)
    work = convert.clone(state)
    plane = plane_bytes(state)
    seal = combine = keyed_vars = union_vars = 0
    for _ in range(steps):
        ops.sat_run_sharded(work, tensors, 1, depth, mesh)
        keyed, false, flags = shard_exchange(work, tensors, depth, mesh)
        rows, n_words = keyed.shape[1:]
        union = keyed[0]
        for d in range(1, n_shards):
            union = union | keyed[d]
        per_shard = int(table[keyed.contiguous().view(torch.uint8).long()]
                        .sum())
        in_union = int(table[union.contiguous().view(torch.uint8).long()]
                       .sum())
        keyed_vars += per_shard
        union_vars += in_union
        seal += n_shards * (rows * n_words * 4 + rows * 2 * 4 + plane) \
            + 4 * per_shard
        combine += n_shards * plane + rows * n_words * 4 + rows * 2 * 4 \
            + 4 * in_union
    seal_ms, seal_by = bound_ms(seal / steps, 0)
    combine_ms, combine_by = bound_ms(combine / steps, 0)
    return {"seal_bound_ms": seal_ms, "seal_bound_by": seal_by,
            "seal_bytes": seal / steps, "combine_bound_ms": combine_ms,
            "combine_bound_by": combine_by, "combine_bytes": combine / steps,
            "keyed_vars": keyed_vars / steps,
            "keyed_vars_union": union_vars / steps,
            "plane_bytes": plane,
            "plane_bytes_copied": n_shards * (n_shards - 1) * plane,
            "phases": phase_planes_of(keyed, false,
                                      state.assign.shape[-1])}


def chunk_launch_ms(run, fresh, steps: int) -> dict:
    """{function: {device_ms, launches}} a step of one chunk `run()` of
    `steps` steps, as torch.profiler records it (`fresh()`, which puts the
    start state back, outside the trace)."""
    _, _, events = profile_cuda(lambda _: run(), "sat_shard",
                                prepare=fresh)
    out = {}
    for event in events:
        key = event.key if "Memcpy" in event.key \
            else event.key.split("(")[0].split()[-1]
        entry = out.setdefault(key, {"device_ms": 0.0, "launches": 0.0})
        entry["device_ms"] += event.self_device_time_total / 1e3 / steps
        entry["launches"] += event.count / steps
    return out


def host_ms(run, fresh, reps: int) -> list:
    """Host clock of `run()` to its synchronize, in ms, each of `reps`
    calls after `fresh()` and a synchronize (the first call warms)."""
    fresh()
    run()
    spent = []
    for _ in range(reps):
        fresh()
        torch.cuda.synchronize()
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - start) * 1e3)
    return spent


def phase_sat_shard(dev) -> tuple:
    """K13 against its twin at D = 2 and 4 logical shards on the card (and
    over distinct cards where the host has them), verdicts against the
    unsharded K11's, times a step, then the dispatch route through the
    CLI. Returns the kernels record and the CLI run's launches."""
    card = torch.device("cuda", torch.cuda.current_device())
    depth = device_solver.forced_depth_of(32)
    # the phase race, one step a chunk
    clauses, n_vars = race_cnf()
    problem = device_solver.build_problem(clauses, n_vars)
    tensors = device_solver.device_problem(problem, dev)
    race = {}
    for n_shards in SAT_SHARD_COUNTS:
        mesh = (card,) * n_shards
        state = device_solver.initial_state(problem.init_assign, 2, dev)
        sat_shard_compare(state, tensors, 1, 3, 1, mesh, f"race D={n_shards}")
        first = convert.clone(state)
        ops.sat_run_sharded(first, tensors, 1, 1, mesh)
        race[n_shards] = first.assign[:, 5].tolist()
    unsharded = device_solver.initial_state(problem.init_assign, 2, dev)
    ops.sat_run(unsharded, tensors, 1, 1, False, graph=False)
    if race[4] != [2, 2] or unsharded.assign[:, 5].tolist() != [1, 1]:
        raise AssertionError(f"K13 race: D = 4 gave {race[4]}, the unsharded "
                             f"K11 {unsharded.assign[:, 5].tolist()}")

    # full width: two chunks against the twin, then the solve's verdict
    queries = {}
    timing = None
    for name in ("1689-24.smt2", "1689-28.smt2"):
        clauses, n_vars, lowered, blaster = corpus_query(name)
        problem = device_solver.build_problem(clauses, n_vars)
        tensors = device_solver.device_problem(problem, dev)
        state = device_solver.initial_state(problem.init_assign, 32, dev)
        start = time.perf_counter()
        status, model = device_solver.solve_cnf_device(clauses, n_vars,
                                                       device=dev)
        torch.cuda.synchronize()
        record = {"tiles": problem.lits.shape[0], "k11": {
            "status": status, "wall_s": time.perf_counter() - start}}
        for n_shards in SAT_SHARD_COUNTS:
            mesh = (card,) * n_shards
            sat_shard_compare(state, tensors, SAT_SHARD_STEPS, 2, depth, mesh,
                              f"{name} D={n_shards}")
            device_solver.configure(shard=True, mesh=mesh)
            keys = device_solver._SHAPES_RUN
            device_solver._SHAPES_RUN = set()
            try:
                start = time.perf_counter()
                got, got_model = device_solver.solve_cnf_device(
                    clauses, n_vars, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
                shard_keys = device_solver.observed_shape_keys()
            finally:
                device_solver._SHAPES_RUN = keys
                device_solver.reset_settings()
            if got != status or shard_keys[0][1] != n_shards:
                raise AssertionError(f"K13 {name} D={n_shards}: verdict "
                                     f"{got} keyed {shard_keys}, the "
                                     f"unsharded K11's {status}")
            if got == device_solver.SAT:
                check_model(clauses, lowered, blaster, got_model,
                            f"K13 {name} D={n_shards}")
            record[f"d{n_shards}"] = {"status": got, "wall_s": wall,
                                      "key": list(shard_keys[0])}
        queries[name] = record
        if timing is None:
            timing = (state, tensors)

    # times a step on 1689-24: K11, and K13 at D = 1, 2 and 4, graphed
    # and eager (event-timed, host clock, and by launch under the profiler)
    state, tensors = timing
    steps = 32
    work = convert.clone(state)

    def fresh():
        refill([work], [state])

    per_step = {"k11_graphed": event_ms(
        lambda _: ops.sat_run(work, tensors, steps, depth, False), 3,
        setup=fresh) / steps,
        "k11_eager": event_ms(
        lambda _: ops.sat_run(work, tensors, steps, depth, False,
                              graph=False), 3, setup=fresh) / steps}
    host_per_step = {}
    by_launch = {}
    replays = {}
    for n_shards in (1,) + SAT_SHARD_COUNTS:
        mesh = (card,) * n_shards
        for mode, graph in (("graphed", True), ("eager", False)):
            def run(mesh=mesh, graph=graph):
                return ops.sat_run_sharded(work, tensors, steps, depth, mesh,
                                           graph=graph)

            name = f"d{n_shards}_{mode}"
            per_step[name] = event_ms(lambda _, run=run: run(), 3,
                                      setup=fresh) / steps
            host_per_step[name] = [ms / steps
                                   for ms in host_ms(run, fresh, 3)]
            before = ops.REPLAYS["sat_shard_chunk"]
            by_launch[name] = chunk_launch_ms(run, fresh, steps)
            replays[name] = ops.REPLAYS["sat_shard_chunk"] - before
    if replays != {f"d{d}_{mode}": int(mode == "graphed")
                   for d in (1,) + SAT_SHARD_COUNTS
                   for mode in ("graphed", "eager")}:
        raise AssertionError(f"K13: graph replays a profiled chunk {replays}")
    n_shards = SAT_SHARD_COUNTS[-1]
    main = by_launch[f"d{n_shards}_graphed"]

    def launch_sum(table, part):
        return sum(row["device_ms"] for key, row in table.items()
                   if part in key)

    parts = {name: {part: launch_sum(table, part) for part in (
        "sat_shard_seal", "sat_shard_combine", "Memcpy")}
        for name, table in by_launch.items()}
    for name, row in parts.items():
        missing = [part for part, ms in row.items() if ms <= 0
                   and not (part == "Memcpy" and name.startswith("d1_"))]
        if missing:
            raise AssertionError(f"K13 {name}: the profiler recorded no "
                                 f"device time of {missing}")
    main_mesh = (card,) * n_shards
    exchange = shard_exchange_bound(state, tensors, depth, main_mesh, steps)
    phases = exchange.pop("phases")
    # the combine's yardstick: JAX's pmax as one PyTorch call, over the
    # stacked int8 phase planes [D, P, V1] of this run's last step
    library_ms = event_ms(lambda _: torch.amax(phases, dim=0), 20)
    plain_ms = event_ms(
        lambda s: device_solver.run_chunk_sharded_reference(
            s, tensors, 4, depth, n_shards), 2,
        setup=lambda: convert.clone(state)) / 4
    # the step's bound: K11's bytes and the exchange the function needs,
    # the D planes of two bits a var and two flags a probe read once and
    # the combined one written; beside it, as once counted, with D + 1 int8
    # phase planes [P, V1] (JAX's pmax of `implied`) instead
    step_bytes = sat_mean_step_bytes(state, tensors, steps, depth, n_shards)
    b_ms, b_by = bound_ms(step_bytes
                          + (n_shards + 1) * exchange["plane_bytes"], 0)
    b8_ms, _ = bound_ms(step_bytes
                        + (n_shards + 1) * state.assign.numel(), 0)

    # distinct cards, where the host has them
    cards = torch.cuda.device_count()
    if cards >= 2:
        mesh = tuple(torch.device("cuda", i)
                     for i in range(4 if cards >= 4 else 2))
        sat_shard_compare(state, tensors, SAT_SHARD_STEPS, 2, depth, mesh,
                          f"1689-24 over {len(mesh)} cards")
        cards_note = f"compared over {len(mesh)} cards"
    else:
        cards_note = "one card present: no comparison over distinct cards"
        print(f"sat_shard: {cards_note}", flush=True)

    # the dispatch route: the analyzer's queries over four logical shards
    device_solver.configure(shard=True, mesh=(card,) * 4)
    dispatch.configure(clause_cap=SAT_SHARD_CAP)
    keys = device_solver._SHAPES_RUN
    device_solver._SHAPES_RUN = set()
    try:
        _, summary, run = analyze_tpu_run(SAT_SHARD_RUN, SOLVER_JAX)
        shard_keys = device_solver.observed_shape_keys()
    finally:
        device_solver._SHAPES_RUN = keys
        device_solver.reset_settings()
        dispatch.reset_settings()
    lane = lane_record(SolverStatistics())
    want = EXPECTED_ANALYZE_TPU[SAT_SHARD_RUN]
    if run["incomplete"] or (summary["exit"], summary["issues"]) != (
            want["exit"], want["issues"]):
        raise AssertionError(f"sat_shard {SAT_SHARD_RUN}: {summary}, the JAX "
                             f"CLI {want}")
    check_lane(SAT_SHARD_RUN, lane)
    if not run["launches"]["sat_shard_combine"]:
        raise AssertionError(f"sat_shard {SAT_SHARD_RUN}: the combine never "
                             f"launched (keys {shard_keys})")
    emit({"phase": "sat_shard", "shard_counts": list(SAT_SHARD_COUNTS),
          "race": {f"d{d}": race[d] for d in race},
          "race_unsharded": unsharded.assign[:, 5].tolist(),
          "compared_steps": 2 * SAT_SHARD_STEPS, "max_abs_err": 0,
          "compared": ["graphed", "eager"],
          "queries": queries, "ms_per_step": per_step,
          "host_ms_per_step": host_per_step,
          "device_ms_per_step_by_launch": by_launch,
          "device_ms_per_step_by_part": parts,
          "graph_replays_per_chunk": replays,
          **exchange,
          "amax_library_ms": library_ms, "plain_ms_per_step": plain_ms,
          "bound_ms_per_step": b_ms, "bound_ms_per_step_int8_planes": b8_ms,
          "cards": cards_note,
          "dispatch": {**run, "settings": {"shard": True, "mesh": 4,
                                           "clause_cap": SAT_SHARD_CAP},
                       "issues": summary["issues"], "lane": lane,
                       "shape_keys": [list(k) for k in shard_keys]}})
    main_parts = parts[f"d{n_shards}_graphed"]
    return {"name": "sat_shard_combine", "route": "cuda",
            "source": "mythril_tpu_torch/kernels/sat_step.cu",
            "replaces": "mythril_tpu/parallel/jax_solver.py:397",
            "max_abs_err": 0,
            "per": f"step (32 probes, 64 tiles, V1 65536, D = {n_shards} "
                   f"logical shards on one card, graphed)",
            "ms": per_step[f"d{n_shards}_graphed"],
            "ms_eager": per_step[f"d{n_shards}_eager"],
            "host_ms": min(host_per_step[f"d{n_shards}_graphed"]),
            "device_ms_summed_over_streams": sum(
                row["device_ms"] for row in main.values()),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_int8_planes": b8_ms,
            "bound": "K11's bytes and D + 1 exchange planes of two bits "
                     "a var and two flags a probe (bound_ms_int8_planes: "
                     "D + 1 int8 phase planes)",
            "plane_bytes": exchange["plane_bytes"],
            "plane_bytes_copied": exchange["plane_bytes_copied"],
            "library_ms": None,
            "library": "none: no PyTorch call computes a sharded DPLL step "
                       "(as K11); the combine's own yardstick is under "
                       "combine",
            "seal": {"device_ms": main_parts["sat_shard_seal"],
                     "bound_ms": exchange["seal_bound_ms"],
                     "bound_by": exchange["seal_bound_by"],
                     "bytes": exchange["seal_bytes"]},
            "copies_device_ms": main_parts["Memcpy"],
            "combine": {
                "device_ms": main_parts["sat_shard_combine"],
                "bound_ms": exchange["combine_bound_ms"],
                "bound_by": exchange["combine_bound_by"],
                "bytes": exchange["combine_bytes"],
                "keyed_vars": exchange["keyed_vars"],
                "library_ms": library_ms,
                "library": f"torch.amax over the stacked int8 [{n_shards}, "
                           f"P, V1] phase planes (JAX's pmax of implied)"},
            "held_by": "phase sat_shard"}, run["launches"]


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    CARD = card_line()
    emit({"phase": "card", "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if sys.argv[1:] == ["--headline"]:
        phase_headline()
        print(CARD, flush=True)
        print_ok()
        return 0
    if sys.argv[1:] == ["--serve"]:
        build.build_all()
        emit({"phase": "serve_tpu", "launches": phase_serve_tpu()})
        print(CARD, flush=True)
        print_ok()
        return 0
    if sys.argv[1:] == ["--load"]:
        build.build_all()
        emit({"phase": "serve_load_tpu",
              "launches": phase_serve_load_tpu()})
        print(CARD, flush=True)
        print_ok()
        return 0
    if sys.argv[1:] == ["--sat-shard"]:
        build.build_all()
        record, _ = phase_sat_shard(dev)
        print(CARD, flush=True)
        print(json.dumps({"kernels": [record]}), flush=True)
        print_ok()
        return 0
    start = time.perf_counter()
    paths = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - start,
          "libraries": sorted(p.rsplit("/", 1)[-1] for p in paths.values())})
    phase_static_tables()
    rng = np.random.default_rng(2024)
    keccak_record = phase_keccak(dev, rng)
    step_record, keccak_step = phase_step(dev)
    keccak_record.update(keccak_step)
    records = [keccak_record, step_record, phase_arena(dev, rng)]
    phase_planes(dev)
    records.append(phase_slice(dev))
    records += phase_frontier_programs(dev)
    records.append(phase_telemetry(dev))
    records.append(phase_merge_kernel(dev))
    phase_graph_chunk(dev)
    phase_wide_lanes(dev)
    k4_same_work = phase_shard_step(dev)
    records.append(phase_steal_kernel(dev))
    records.append(phase_sat_kernel(dev))
    # the main path: the drain loop at full width and the spill run with
    # telemetry and merging off, then the default configuration
    launches = {name: 0 for name in ops.LAUNCHES}
    off_timing, off_profiled = phase_frontier(dev)
    main_path_launches = [off_timing["launches"],
                       phase_frontier_spill(dev)["launches"]]
    default_timing, default_profiled = phase_frontier_default(
        dev, off_timing, off_profiled)
    main_path_launches += [default_timing["launches"],
                        phase_frontier_merge(dev)["launches"]]
    # the sharded frontier: 4 logical shards with stealing, then a fleet
    shard_timing, shard_profiled, fleet_timing = phase_frontier_shard(
        dev, default_timing, default_profiled)
    main_path_launches += [shard_timing["launches"], fleet_timing["launches"]]
    # 2048 lanes: past the 1024 that K4 and K10 once scanned in one block
    wide_timing, wide_k9 = phase_frontier_wide(dev)
    main_path_launches.append(wide_timing["launches"])
    # the SMT façade and the host CDCL, then the device SAT lane: captured
    # queries at full width, one flush, their verdicts held to the façade's
    facade = phase_host_solver()
    phase_host_engine(dev)
    phase_analyze()
    main_path_launches.append(phase_analyze_tpu())
    jax_launches = phase_analyze_jax()
    main_path_launches += [jax_launches, phase_resume_tpu(dev)]
    # several contracts in one frontier: the fleet driver, sharded too
    fleet_launches = phase_analyze_fleet()
    main_path_launches.append(fleet_launches)
    # the same paths with the metric registry, tracer and exporter read back
    main_path_launches.append(phase_observe_tpu())
    # the gas superoptimizer's proofs on K11
    optimize_launches = phase_optimize_jax()
    main_path_launches.append(optimize_launches)
    # the daemon: its processes' launches, read from each at its exit
    serve_launches = phase_serve_tpu()
    main_path_launches.append(serve_launches)
    # the daemon under open-loop load, baseline and contended
    load_launches = phase_serve_load_tpu()
    main_path_launches.append(load_launches)
    # on-chain input through a stub chain, then Solidity and foundry input
    # through a stub solc
    onchain_launches = phase_onchain_tpu()
    solidity_launches = phase_solidity_tpu()
    main_path_launches += [onchain_launches, solidity_launches]
    sat_launches, sat_profiled = phase_sat_lane(dev, facade)
    main_path_launches += [sat_launches, phase_sat_batch(dev, facade)]
    # K13: the clause-sharded route, its CLI run on the main path
    shard_record, shard_launches = phase_sat_shard(dev)
    records.append(shard_record)
    main_path_launches.append(shard_launches)
    for counts in main_path_launches:
        for name, count in counts.items():
            launches[name] += count
    # K3 runs on the main path folded into K4's steps and K10's passes
    # (one count a step and a pass), and standalone for the host-term
    # leaves of analyze_tpu's seeds and fault-ins
    folded = launches["arena_alloc_step"] + launches["arena_alloc_merge"]
    idle = sorted(name for name, count in launches.items() if count == 0)
    if idle or not folded:
        raise AssertionError(f"kernels the main-path phases never ran: {idle}"
                             f" (K3 folded: {folded})")
    for record in records:
        name = record["name"]
        record["launches"] = launches[name]
        # the fleet analyzer's share (analyze_fleet)
        record["launches_analyze_fleet"] = fleet_launches[name]
        # the serving tier's share (serve_tpu's daemons and workers)
        record["launches_serve"] = serve_launches[name]
        # the daemon's under load (serve_load_tpu's daemons and workers)
        record["launches_serve_load"] = load_launches[name]
        # the on-chain and Solidity inputs' shares (onchain_tpu,
        # solidity_tpu)
        record["launches_onchain"] = onchain_launches[name]
        record["launches_solidity"] = solidity_launches[name]
        if name == "telemetry":
            # K9 by launch in the graphed drives with the plane armed
            record["k9_by_launch_graphed"] = {
                "frontier_default": {
                    key: value["k9_ms_per_step"] for key, value in
                    k9_increments(default_profiled["k4_functions"],
                                  off_profiled["k4_functions"]).items()},
                "frontier_wide": {key: value["k9_ms_per_step"]
                                  for key, value in wide_k9.items()}}
        if name == "arena_alloc":
            record["launches"] = launches[name] + folded
            record["launches_standalone"] = launches[name]
            record["launches_folded"] = {
                "sym_step": launches["arena_alloc_step"],
                "merge_pass": launches["arena_alloc_merge"]}
        if name == "sat_shard_combine":
            # the sharded chunks of the dispatch route (sat_shard's CLI run)
            record["launches_dispatch"] = shard_launches[name]
            continue
        if name == "sat_step":
            # the analyzer's share: analyze_jax's chunks
            record["launches_analyzer"] = jax_launches["sat_step"]
            # the optimizer's share: optimize_jax's chunks
            record["launches_optimizer"] = optimize_launches["sat_step"]
            # K11's device time per step on the lane's profiled solve
            record["main_path_device_ms"] = \
                sat_profiled["k11_device_ms_per_step"]
            continue
        # device time per wrapper call on the full-width drain loop: the
        # off run's, or the default run's or the sharded run's for what only
        # they launch (K9 runs inside K4's launches and has no device time
        # of its own)
        run_timing, run_profiled = next(
            (run for run in ((off_timing, off_profiled),
                             (default_timing, default_profiled),
                             (shard_timing, shard_profiled))
             if run[0]["launches"][name]), (shard_timing, shard_profiled))
        calls = run_timing["launches"][name]
        record["main_path_device_ms"] = (
            run_profiled["kernel_device_ms"][name] / calls
            if calls and name != "telemetry" else None)
        if name == "sym_step":
            # the sharded run's steps, and one chunk of the same work at
            # D = 1 and D = 4 (phase shard_step)
            record["main_path_device_ms_d4"] = \
                shard_profiled["kernel_device_ms"][name] \
                / shard_timing["launches"][name]
            record["shard_step_device_ms"] = dict(zip(("d1", "d4"),
                                                      k4_same_work))
    print(CARD, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print_ok()
    return 0


def print_ok() -> None:
    """The last line: the card the run used."""
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
