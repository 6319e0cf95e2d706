#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (odesat_tpu_torch) runs on an
NVIDIA GPU: builds the CUDA kernels from this checkout, holds each against
its plain torch version, and drives the port's main paths (``python -m
odesat_tpu_torch inter``, ``stoch``, ``solve``, ``batch`` and ``hybrid``,
in process) through them, with checkpoint and resume, a profiler trace and
the exact time-to-solution protocol.

Run from the root of a checkout on a machine with one Hopper GPU and nvcc:

    python3 chip_smoke.py

Phases, each printing its lines; the first failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: nvcc of csrc/fused_chunk.cu, csrc/stoch_chunk.cu (B3, B4, B8, B9),
   csrc/stream_chunk.cu (B2, B5, B6, B10) and csrc/butterfly.cu (B7) and g++
   of the native preprocessor
   (csrc/odesat_native.cc), all started together; seconds, ptxas's
   registers and spills, and whether the preprocessor runs native;
3. kernel vs plain: random 3- and 4-SAT formulas, a formula of widths 2,
   3 and 5 (plain and width-bucketed), hard.cnf at B=16384, uf250 at
   B=4096 and an odd B=1000, and ragged batches (B = 1, 7, 33 on hard.cnf
   and the bucketed formula: a last tile of padded lanes), both
   integrators, both rigidity gates, float32 and bf16 rounding, after one
   32-step chunk; then uf250 at B=4096 from a partly solved state, until a
   compared chunk holds rows done before it, rows that finish inside it and
   rows still running (both integrators, float32 and bf16). The kernel
   must equal its plain version exactly (max abs error 0, done equal);
   rows done before a chunk come out unchanged;
4. determinism: the same input twice gives bit-identical outputs;
5. main path, SAT: inter on uf250 (seed 0) at -b 4096 -s 0.01 -n 20000
   --seed 0, and on easy.cnf adaptive at -b 256 -n 20000 --seed 1, must
   verify true, with the kernel launched;
6. main path, UNSAT budget: inter on hard.cnf at -b 16384 -s 0.01 -n 4096,
   float32 and bf16: verdict false after exactly 4096 steps, kernel
   launched, in device-loop graph launches (one dispatch of 16 chunks);
   prints traj*steps/s;
7. timing: the kernel's and the plain version's device time per 256-step
   chunk at hard.cnf B=16384 and uf250 B=4096 (CUDA events), beside the
   one-CTA-a-trajectory kernel it replaced, at hard.cnf fixed;
8. stoch kernel vs plain: B3 (resident) and B4 (tables in L2), tiles of
   R chains a CTA, on the formulas of phase 3 and its ragged batches (B =
   1, 7, 33 on hard.cnf and the bucketed formula: a last tile of padded
   lanes) at every R from 1 to the most that fit, and B4 on the
   preprocessed n=1k instance (run_benchmarks.py config 4) at B=8192 at
   its R, f32 and bf16, random v and xl up to 3000, each R's shared
   memory equal to the Python footprint; then a planted 3-SAT (n=200,
   m=700) at B=4096 until a compared chunk holds chains done before it,
   chains that finish in it and chains still running. Exact equality of
   v, xl and done; B3 and B4 equal on every formula both take;
9. stoch determinism: two launches give bit-identical outputs;
10. stoch main path: stoch on easy.cnf at -b 4096 verifies true through
    B3; stoch --no-preprocess on hard.cnf at -b 16384 -n 4096 (f32 and
    bf16) gives false after exactly 4096 steps, through the device loop;
    stoch on the n=1k
    instance at -b 8192 runs B4 (a solved chain must verify); stoch on a
    planted 5-SAT (n=2000, m=8000, past B3's gate) verifies true
    through B4; each prints chain*steps/s;
11. stoch timing: kernel and plain version in turns over the same steps,
    B3 and B4 at hard.cnf B=16384, B4 at the n=1k instance B=8192; then
    B3 (hard.cnf) and B4 (n1k) alone per 256-step chunk, the length phase
    10's launches run; then B3 (hard.cnf, B=16384 and 1000) and B4 (n1k)
    at 512 and 1024 threads a CTA, beside the threads the wrapper takes;
12. B2 vs plain: the large-formula chunk kernel against its plain version
    (B1's), exactly (max abs error 0, done equal), on phase 3's formulas
    and ragged batches (where it must also equal B1) and on the formulas
    past B1's gate at
    their main-path batches: the preprocessed n=1k instance at B=10240,
    the preprocessed planted n=2000 m=7000 at B=1024 and the locally
    structured n=4096 (config 6) at B=10240; both integrators, both
    rigidity gates, f32 and bf16, one chunk; then phase 3's finishing
    chunks on uf250 through B2; then two launches bit-identical;
13. B2 main path: solve on the planted n=2000 m=7000 (adaptive and fixed)
    and batch on the planted n=2000 m=8000 at -b 1024 verify true; solve
    on the n=1k instance at --solve-batch 10240 (f32, bf16) and inter on
    the n=4096 instance at -b 10240 (a solved trajectory must verify);
    inter --dv-strategy stream on hard.cnf at -b 16384 ends false after
    exactly 4096 steps; each through B2, each printing traj*steps/s;
14. B2 timing: B2 and plain per chunk in turns at the n=1k instance
    B=10240 (fixed, adaptive), the n=4096 instance B=10240 and hard.cnf
    B=16384 (beside B1), beside the kernel it replaced at n1k fixed; then B2 alone
    per 256-step chunk, the length phase 13's launches run, at the n=1k
    and n=4096 instances;
15. B10 vs its plain version (the kernel-order RHS), exactly (max abs
    error 0, allsat equal), at hard.cnf B=16384, uf250 B=4096 and the n=1k
    instance B=1024 and at ragged B = 1, 7, 33, float32 and float64, both
    rigidity gates, at every R from 1 to the most the wrapper's form takes
    and in the streamed form forced into windows of 64 clauses; then the
    wrapper's own launch (its R, threads and form printed) vs the twin's
    gather RHS, f32 rtol 2e-4 / atol 2e-5, f64 1e-12;
16. B10 main path: inter --dv-strategy pallas on hard.cnf at -b 4096 ends
    false after exactly 1024 steps, on uf250 true, and adaptive with
    --dt-mode shared on uf250 true (two B10 launches a step), each through
    the device loop around the captured scan chunk (graph launches counted,
    B10's launches the steps run times its calls a step); then the split of
    a fixed step at hard.cnf B=4096, captured (a 64-step scan chunk) beside
    host-paced: its wall, the card's busy time, B10's;
17. B10 timing: one RHS pass, B10 and its plain version in turns, device
    time with the launches queued, at hard.cnf B=16384 (f32 and f64),
    uf250 B=4096 and n1k B=1024, beside the one-CTA-a-trajectory design's
    time (ONE_CTA_MS, taken with --time-b10 on the tree before the tiles)
    and the bound;
18. B5 vs plain, exactly (max abs error 0): phase 3's formulas compiled
    with compile_stream_sharded at S=1 and S=2 (each shard on its own), the
    config 7 instance (run_benchmarks.py:289-313, n=10240) at S=2 (both
    shards) and S=1, B=256, and ragged batches (B = 1, 7, 33 on the
    widths 2,3,5 formula at S=2: a part-filled last tile of 32); modes
    rhs, fixed, second, both rigidity gates, f32 and bf16, through the
    row-major wrappers (tile, launch, untile), each case printing its
    grid; then two launches bit-identical; then B6 (the clause-sharded
    chunk's launches, on the buffers tiled by 32 trajectories as its
    runner lays them out) the same way, in each of its phases with and
    without the apply prologue, reading its own partials (S=1) or 2 or 4
    ranks' partials that its kernels add in the butterfly's tree (B7
    fused);
19. B8 vs plain, exactly, on the same shards and ragged batches, random xl
    up to 3000 and frozen chains, f32 and bf16, printing its grid; then
    two launches bit-identical; then B9 (the stoch chunk's launches, on
    tiled chains) with and without the flip prologue and flip-only,
    reading its own partials or 2 or 4 ranks' (B7 fused);
20. the clause mesh through the CLI, two gloo ranks sharing the card
    (spawned; each reports its launch counts; every solve checks that its
    clause ranks' v are bit-identical and raises otherwise; B6's and B9's
    launches read the peers' slots over CUDA IPC themselves (B7 fused: no
    standalone B7 call, counted), B5's and B8's steps sum through B7's
    standalone call, gloo carries the host's decisions and the handles):
    a. inter on
    uf250 -b 4096 --clause-shards 2 verifies true through B6; b. inter on
    the config 7 instance -b 1024 -n 64 ends false after exactly 64 steps
    (or verifies) through B6 on both ranks, and the CLI's mesh solve of the
    same command with --shard-chunk off -n 16 solves no row in its 16 steps
    through B5; the ODE clause mesh at S=2 on the config 7 instance (B6 and
    B5, fixed 8 steps and adaptive 4) against the in-process S=1 runner row
    for row (rtol 2e-4 / atol 2e-5, xs and xl clause by clause, done
    exactly), B6 equal to B5 bit for bit and both ranks' v bit-identical;
    c. stoch --no-preprocess on the config 7 instance for 32 steps through
    B9 and (the CLI's mesh solve) with --shard-chunk off, 16 steps, through
    B8, the clause path at S=2 equal to S=1 flip for flip through each, and
    stoch on easy.cnf verifying true through B9; d. the clause step and the
    B6 chunk over an NCCL world of one equal the mesh-free B5 runner bit for
    bit; e. inter --devices 2 on uf250 B=4096 through B1 equals the T=1 run
    row for row, its dispatches in the mesh device loop (phase 28); the B5
    and B8 solves and parity checks of b and c, e's mesh run, B7 against its
    plain version bit for bit (lengths 1, 7, 33*1025 and the full (1024,
    Np+1) buffer, with and without a max zone, then 1000 back-to-back calls
    on fresh data), the race runs (B6 fixed 250 steps, adaptive 125, B9
    250 steps on a 3-SAT n=300 at B=64, one chunk on the card with no host
    sync against the plain version, bit for bit, v bit-identical), the split
    of B7's standalone call and phase 21's timings share one spawned world,
    as do phase 23's mesh runs; f. at
    S=4, four gloo ranks in one more world: inter and stoch on config 7
    through the CLI's mesh solve (B6, B9, B7 fused), the ODE clause mesh
    through B6 and through B5 against S=1 (rtol 2e-4 / atol 2e-5, v
    bit-identical on the four ranks, B5 equal to B6 bit for bit), the stoch
    clause path through B9 and through B8 against S=1 flip for flip, the
    race runs, B7's checks, timings and split; in phase 20's worlds (S=2
    and S=4) and phase 21 (S=1) B5's fixed chunk and the B8 path's, each
    captured as CUDA graphs with their B7 calls (ops/scan_chunk.py), against
    the same 64 steps launched from Python: bit for bit, v identical over
    the ranks, no allocation in a second chunk, both chunks' walls and
    peaks, graph replays a chunk, device operations a host-paced step and
    the host's share of each (torch.profiler, over 4 chunks back to back
    each way at S=1, one on the shared card); at S=2 also B5 and B8
    captured between B6 and B9 chunks on one B7 ring, equal to host-paced
    bit for bit, every rank's flag on the card equal to the host's count;
21. timing at the config 7 instance, B=1024, S=1: B5 fixed and second and
    B8 per launch on tiled buffers allocated once, as their runners run
    them, beside the one-CTA-a-trajectory (chain) kernels they replaced,
    and through their row-major wrappers (tile and untile included); B6
    step and B9 per launch; each beside its plain version and bound; the
    single-device runner (B5) and the B6 chunk in traj*steps/s; the stoch
    clause path through B8 and through B9 in chain*steps/s, with the
    counter-hash uniform draw's share of a B8-path step; B7's standalone
    call at the (1024, Np+1) buffer at S=2 and S=4 (host clock, timed in
    phase 20's worlds) beside its plain version, its bound ((S+1) x the
    buffer's bytes over 3.35 TB/s) and the gloo all-reduce it replaces, and
    its split (dist.time_butterfly_split: back to back, the flags already
    raised, one rank at a time, the kernel alone); the clause-mesh steps at
    S=2 and S=4 (inter through B6 and B5, stoch through B9 and B8); B7
    fused: B6's apply launch reading 1, 2 and 4 partials (CUDA events),
    the fused sum's cost over one buffer beside its bound;
22. the hybrid main path through the CLI: hybrid --no-preprocess on
    hard.cnf at -b 16384 -s 0.01 -n 4096 ends "Winner: none after 4096
    steps per engine" and false through B1 and B3, with each engine's
    traj*steps/s and chain*steps/s and the split of the engines' time (CUDA
    events around their launches); hybrid on uf250 at -b 4096 verifies
    true; hybrid on the n=1k instance (preprocessed) at -b 8192 -n 1024
    runs B2 and B4 and verifies a solved row or ends false after exactly
    1024 steps;
23. resume equals the uninterrupted run bit for bit, in process through
    the library calls: ODE fixed hard.cnf B=16384 (B1), ODE n1k B=512
    (B2), stoch hard.cnf B=16384 (B3), stoch n1k B=8192 (B4) and the
    hybrid on hard.cnf B=16384: a run stopped partway (its last snapshot),
    resumed, ends in the final state and steps of a run with the same
    cadence that never stopped; a --profile-dir inter solve on hard.cnf
    (python -m odesat_tpu_torch, its own process) writes a chrome trace that
    names B1's kernel; in phase 20's world: the
    hybrid on uf250 at --clause-shards 2 verifies true through B6 and B9,
    inter (B6) and stoch (B9) snapshots on hard.cnf B=1024 at S=2 resume on
    S=2 to the very
    snapshot of the uninterrupted mesh run and are refused on S=1 with the
    JAX package's message;
24. exact time to solution (odesat_tpu_torch/tools/uf250_tts.py): solve_exact on
    uf250 seeds 0-2, B=4096, fixed dt=0.01, bf16 rounding, through B1,
    each verified, with steps, chunks, compute / dispatch / residual
    seconds and the kernel rate; instance 0's exact step equals the first
    step at which one-step B1 launches from the same state leave a row
    done; the solve takes the one-dispatch path (one device-loop graph
    launch, counted as one chunk);
25. the device loop (csrc/device_loop.cu, ops/device_loop.py): a. one
    dispatch through the models' multi-chunk runners (one graph launch,
    counted) against the host loop over the same kernel, bit for bit, steps
    included: B1 on hard.cnf B=16384 and on uf250 B=4096 from its initial
    state (the stop falls inside the dispatch) and from the partly solved
    state it leaves, B2 on the n=1k instance B=512, B3 on hard.cnf B=16384
    and on a planted n=200 at B=4096 (chains finish inside the dispatch), B4
    on the n=1k instance B=8192; bounds 1, 3 and the whole dispatch, stop on
    any and all (ODE), and entry states already stopped (0 chunks, the state
    untouched); the stoch generators equal after a dispatch that ran every
    chunk; b. phases 6 and 10 above run through its graph; c. a chunk's cost
    beyond the chunk kernel (the decide kernel and the conditional node,
    CUDA events over empty bodies) against the host loop's done read, one
    dispatch of 0 chunks, and phase 6's busy share: its 16 B1 launches
    times phase 7's B1 time over its loop wall; d. the state donated
    (ops/device_loop.py's contract): B1-B4 host-paced in place equal to
    out of place (donate=False) bit for bit, each form's time a launch;
    dispatches over B1, the scan chunk and B3 each from the last one's
    result equal to the host loop, with no copy and no new capture or graph
    after the first (B1 none from the first: the pointer block); a result held
    across a dispatch and a chunk from another state unchanged; the stoch
    twin's snapshot resumed to the same flips; e. the clause mesh donated:
    B6 fixed and adaptive, B5, B9 and B8's runners at config 7 S=1 B=1024,
    and B6 at a ragged B=1000, return their input's storage, equal to a
    copy-first run of the plain version on the card bit for bit; a second
    chunk of the shape from another state allocates nothing and leaves the
    first result, still held, as it was; then each runner's 64-step chunk
    walls and its peak bytes (B5's and B8's captured and host-paced; and,
    in phase 20's world, each rank's peak over a B6 and a B9 chunk at S=2);
26. the pod mesh (parallel/multihost.py): two CLI processes of one job on
    this host (the CLI's main in ``python -c``, ``--coordinator
    127.0.0.1:<free port> --num-processes 2 --process-id 0|1 --dist-backend
    gloo``, each bounded by a timeout), which share the one card: the
    TCPStore world, global ranks, clause groups inside a process, the shared
    seed and the verdict on every process, not NVLink or a network. a.
    inter on the config 7 instance -b 1024 -n 64 --seed 0 --pod-mesh
    --clause-shards 2 with LOCAL_WORLD_SIZE=2 (a 2x2 mesh): false after
    exactly 64 steps on both processes (or a solved row that verifies), B6
    on all four ranks with B7 fused and no standalone B7 call, the ranks of
    both processes on the same libraries, process 0 alone writing -o, whose
    assignment and steps equal the single-process --devices 2
    --clause-shards 2 run's bit for bit; b. inter on uf250 -b 4096 -n 20000
    --pod-mesh, one rank a process: true on both, B1 on each rank inside the
    mesh device loop's graphs, the stop exchanged across the processes; c.
    stoch --no-preprocess on config 7 -b 1024 -n 32 --pod-mesh
    --clause-shards 2: B9 on all four ranks, 32 steps or a verified row; d.
    process 1 alone with --dist-timeout 10: a non-zero exit, an error and no
    verdict; e. each pair's wall and a process's start-up (its CLI run less
    its solve and its import) beside phase 20's single-process one, and the
    2x2 pod's inter step through B6 (host clock around 2 chunks of 16, as
    phase 21 times S=2);
27. the scan tier on the card (ops/scan_chunk.py): a. the captured 16-step
    chunk equal to its steps launched one by one, exactly (max abs error 0,
    done equal), for pallas (B10), gather and segment_sum, fixed, adaptive
    and adaptive shared, f32 and f64, at hard.cnf and uf250 B=4096; the
    device-loop dispatch over it equal to models/loop.run_chunks over the
    same chunk, bit for bit, steps included (uf250 pallas fixed from its
    initial state, where the stop falls inside the dispatch, and from the
    state it leaves, stopped at entry; hard.cnf gather adaptive on any,
    segment_sum shared f64 on all); b. phase 16 above through it; c. phase
    16's step split; d. inter on random_local_ksat(65536, 280000, k=3,
    locality=512, seed=9) -b 512 -s 0.01 -n 512, which only the twin takes
    on one card (Np=65,536, past B2's and B10's gates): false after exactly
    512 steps or a verified row, its rate, capture seconds and peak memory;
    then at B=512 an 8-step captured chunk equal to the same 8 steps
    launched one by one, exactly, and a step's time in each; e. two replays
    of every captured configuration bit-identical, segment_sum included;
28. the trajectory mesh's device loop (ops/device_loop.py MeshPeers,
    csrc/device_loop.cu's stop exchange over CUDA IPC pages), in phase 20's
    world (2x1 meshes of its two ranks sharing the card), reported after
    phase 20: a. a 256-step B1 chunk's cost at hard.cnf 8192 rows a rank,
    dispatches of bound 1 and 16 through the host loop (run_chunks with
    MeshSync) and through the device loop, and with bodies that launch
    nothing, beside B1 alone; b. the device loop against the host loop bit
    for bit, steps included, one graph launch a rank and the kernel's count
    grown by the chunks run: B1 hard.cnf B=16384 and B2 n1k B=10240 (bounds
    1, 3 and 16, stop on any and all, a state stopped at entry on rank 1
    only), B1 uf250 B=4096 (the stop inside the dispatch), B3 hard.cnf
    B=16384 and B4 n1k B=8192 (bounds 1, 3 and 16, a chain of rank 1 done
    at entry); c. the CLI's inter --devices 2 on hard.cnf -b 16384 -s 0.01
    -n 4096 (B1), stoch --devices 2 --no-preprocess hard.cnf -b 16384 -n
    4096 (B3) and stoch --devices 2 on the n=1k instance -b 8192 -n 4096
    (B4), each false after exactly 4096 steps (or, n1k, a solved chain that
    verifies), one mesh graph launch a dispatch on each rank;
29. the mesh twin step's reductions on B7 (its standalone call, float64
    form; parallel/dist.mesh_reduce), in phase 20's world, reported after
    phase 28: B7's float64 kernel alone on S = 1-4 buffers (S = 3 among
    them) and its call at S=2 (here) and S=4 (phase 20f's world) against
    the plain tree bit for bit, NaN, signed zeros and infinities included;
    a. config 7 B=1024 S=2 f64 on the plain layout, fixed dt=0.01 and
    adaptive tol 1e-3: ms a step (host clock around 2 chunks of 8 steps)
    and its reductions' share (a sync before and after each); b. uf250
    B=4096 on a 2x1 mesh, adaptive --dt-mode shared, the same; c. 29a's
    steps under torch.profiler (the card's busy time, B7's part, the host's
    share); the twin step on B7's route equal to torch.distributed's bit
    for bit over 8 steps, two runs bit-identical, a chunk with no
    torch.distributed call and no host read; inter on config 7 -b 1024 -s
    0.01 -n 16 --devices 1 --clause-shards 2 --dtype float64 through the
    CLI's mesh solve on both routes: the same steps, solved rows, verdict
    and assignment; B7's float64 call timed beside gloo's all-reduce;
    29a's steps (fixed, 64-step chunks; adaptive, 16), the stoch clause
    twin's on 29a's plain layout (config 7 B=1024 S=2, 64) and 29b's (64)
    captured against host-paced, as phase 20 holds B5's;
30. the stoch twin's chunk captured (ops/scan_chunk.StochScanChunk: the
    steps and their uniform draws as CUDA graphs, the device generator
    registered with them), host-paced between chunks: a. stoch
    --no-preprocess --fused off on hard.cnf -b 16384 -n 4096 through the
    CLI: false after exactly 4096 steps, captured chunks counted, no B3, B4
    or device-loop launch; b. stoch --no-preprocess -b 512 -n 128
    --chunk-steps 64 on 27d's formula (past B3's and B4's gates, so the
    default --fused auto takes the twin): two captured chunks, false after
    exactly 128 steps or a solved chain that verifies; each with its rate,
    capture seconds and peak memory. Then in process at each (a at B=16384,
    b at B=512, from the all-false start): a 64-step runner's chunks 1 (its
    capture) and 2 against the same steps launched from Python with a copy
    of its device generator, v, xl and done bit for bit and the generators'
    states equal; a snapshot of the generators after chunk 1 restored into
    a runner built anew from another seed, whose chunk from chunk 1's chains
    equals chunk 2; at a also a 100-step runner (a graph of 64 steps and one
    of 36) over two chunks; a step's wall captured (a: 8 calls of the
    64-step chunk, b: one) against host-paced (64 steps from Python), the
    rates, capture seconds, peak memory, and at a the graph's replay alone.

``python3 chip_smoke.py --time-loop ROOT`` runs, with the port at ROOT (a
parent tree unpacked beside this one, or this one), phase 6's and phase
10's hard.cnf runs, the busy share, B1-B4 a launch, phase 24's exact time
to solution, the host loop's (and, where ROOT has one, the device loop's)
cost a chunk and a dispatch of 0 chunks, phase 16b's pallas step, phases
27d's and 30b's peak memory, and phase 25d where ROOT donates its state;
``python3 chip_smoke.py --time-b10 ROOT`` times B10 of the checkout at ROOT
(a parent tree unpacked beside this one) as phase 17 times this one;
``--time-mesh ROOT`` phase 25e's 64-step chunk walls and peaks at S=1, each
rank's peak at S=2, the clause-mesh steps of phase 21 at S=2 and S=4 and
phase 29's 29a and 29b with the port at ROOT; ``--time-b7`` the split of B7's standalone call at S=2
and S=4; ``--time-segment ROOT`` a segment_sum step of the port at ROOT
at hard.cnf B=4096 and phase 27d's B=512 (``--time-segment ROOT cpu`` on
the CPU, 27d's formula at B=16); ``--scan-peak`` the peak memory of 27d's
shape through inter's device loop and through batch's host-paced, growing
chunks; ``--time-mesh-loop [host]`` phase 28a alone (both loops, or the
host loop alone; on a host of several cards one NCCL rank a card);
``--twin`` phase 29 alone (on a host of several cards 29a at S=2 and S=4,
one NCCL rank a card, through B7 and through NCCL's all-reduce);
``--stoch-scan`` phase 30 alone; ``--donation`` phases 25d and 25e alone.

The last two lines are the ``kernels`` JSON object (one row per kernel,
with its bound: the larger of its bytes over 3.35 TB/s and its operations
over 67 TFLOP/s; B7's standalone call at S=2, its library time the gloo
all-reduce; its float64 form's call at config 7's f64 buffer, beside
gloo's all-reduce of it; B7 fused, B6's apply launch reading two
partials; the device loop, a chunk's cost beyond the chunk kernel; on a
trajectory mesh, a B1
chunk's cost beyond the two ranks' launches against the host loop's
(phase 28a); the scan chunk, a captured 64-step chunk beside the same steps
launched from Python; the stoch twin's chunk, the same at phase 30a; the
clause mesh's per-step chunk, B5's captured 64-step chunk at S=2 beside
host-paced) and
then ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the package beside this script, it exits non-zero
and prints no result.
"""

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, ".scratch", "chip_smoke")  # git-ignored
F32_TOL = dict(rtol=2e-4, atol=2e-5)
EXACT = dict(rtol=0.0, atol=0.0)  # B1 and B2 compute exactly what their plain version does
# the one-CTA-a-trajectory (chain) B1, B2, B3, B4, B5 and B8 that the tiles
# replaced, ms a launch as this script measured them (NVIDIA H100 80GB HBM3,
# 700 W)
ONE_CTA_MS = {"B1 hard.cnf fixed 256": 7.368186, "B2 n1k fixed 8": 19.397267,
              "B3 hard.cnf 64": 1.372734, "B4 n1k 8": 4.844923,
              "B5 config 7 fixed": 3.454327, "B5 config 7 second": 4.454574,
              "B8 config 7": 2.935702,
              # B10 one CTA a trajectory, device time with the launches
              # queued: this script's --time-b10 on the tree before the tiles
              "B10 hard.cnf f32 16384": 0.055973, "B10 uf250 f32 4096": 0.086188,
              "B10 hard.cnf f64 16384": 0.082365, "B10 n1k f32 1024": 0.490681}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build(fc, sc, stc):
    """Build the five CUDA sources and the native host library at once
    (one nvcc per source, all started together), then report each."""
    from concurrent.futures import ThreadPoolExecutor

    from odesat_tpu_torch import native
    from odesat_tpu_torch.ops import butterfly as bf
    from odesat_tpu_torch.ops import device_loop as dl

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=6) as pool:
        jobs = {name: pool.submit(fn) for name, fn in (
            ("fused_chunk", fc.load_library), ("stoch_chunk", sc.load_library),
            ("stream_chunk", stc.load_library), ("butterfly", bf.load_library),
            ("device_loop", dl.load_library), ("native", native.build_info))}
        results = {name: job.result() for name, job in jobs.items()}
    for name in ("fused_chunk", "stoch_chunk", "stream_chunk", "butterfly", "device_loop"):
        _, build = results[name]
        say(f"[build] csrc/{name}.cu -> {os.path.relpath(build['path'], ROOT)} "
            f"nvcc {build['seconds']:.1f} s (cached={build['cached']})")
        for line in build["log"].splitlines():
            if "registers" in line or "bytes stack frame" in line:
                say(f"[build] {name} ptxas {line.strip()}")
    info = results["native"]
    if info["available"]:
        say(f"[build] native preprocessor {os.path.relpath(info['path'], ROOT)} g++ "
            f"{info['seconds']:.1f} s (cached={info['cached']}); the preprocessor runs native")
    else:
        say(f"[build] native preprocessor unavailable ({info['error']}); "
            "the preprocessor runs in Python")
    say(f"[build] all builds {time.perf_counter() - t0:.1f} s")


def load_cases():
    """Phase 3's formulas: ``(cases, hard, uf250, specs)`` where ``cases``
    holds (label, FormulaArrays, B) and ``specs`` (label, normalized
    formula, bucket, B), from which the clause-shard phases recompile."""
    from odesat_tpu_torch.cnf import (
        CNFFormula,
        compile_formula,
        normalize_cnf_variables,
        parse_dimacs_file,
    )
    from odesat_tpu_torch.utils.generate import random_ksat, uf_instance

    def norm(formula):
        return normalize_cnf_variables(formula)[1]

    # widths 2, 3 and 5: padding slots inside the (K, Mp) grid, and with
    # bucketing a clause axis sorted into three width buckets
    mixed = norm(CNFFormula(
        [c for k in (2, 3, 5) for c in random_ksat(300, 400, k=k, seed=10 + k).clauses], 300))
    hard = norm(parse_dimacs_file(os.path.join(ROOT, "tests", "data", "hard.cnf")))
    uf250 = norm(uf_instance(250, seed=0))
    specs = [
        ("ksat n=50 m=213 seed=0", norm(random_ksat(50, 213, seed=0)), False, 257),
        ("ksat n=100 m=300 k=4 seed=1", norm(random_ksat(100, 300, k=4, seed=1)), False, 129),
        ("ksat n=200 m=852 seed=2 planted", norm(random_ksat(200, 852, seed=2, planted=True)),
         False, 64),
        ("widths 2,3,5 n=300 m=1200", mixed, False, 300),
        ("widths 2,3,5 n=300 m=1200 bucketed", mixed, True, 300),
        ("hard.cnf B=16384", hard, False, 16384),
        ("uf250 B=4096", uf250, False, 4096),
        ("hard.cnf B=1000", hard, False, 1000),
    ]
    cases = [(label, compile_formula(f, window_sort=True, bucket=bucket), B)
             for label, f, bucket, B in specs]
    return cases, cases[5][1], cases[6][1], specs


def random_state(fa, B, seed, device="cuda"):
    """A fresh batch on the card (or ``device``): v ~ U(-1, 1) from ``seed``
    (NumPy), xs from the all-false valuation, xl = 1, dt = 0.01, nothing
    done."""
    import numpy as np

    from odesat_tpu_torch.interop import state_from_numpy

    v = np.random.default_rng(seed).uniform(-1, 1, (B, fa.n_vars_padded)).astype(np.float32)
    xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
    return state_from_numpy(v, xs, np.ones_like(xs), np.full(B, 0.01, np.float32),
                            np.zeros(B, bool), device=device)


def compare(torch, out, ref, tol):
    """Max abs error over v/xs/xl/dt, after checking the tolerance and
    that done matches exactly; returns (error, None) or (None, why)."""
    worst = 0.0
    for name in ("v", "xs", "xl", "dt"):
        a, b = getattr(out, name), getattr(ref, name)
        if not torch.isfinite(a).all():
            return None, f"{name} not finite"
        if not torch.allclose(a, b, **tol):
            err = (a - b).abs().max().item()
            return None, f"{name} off by {err} (tolerance {tol})"
        worst = max(worst, (a - b).abs().max().item())
    if not torch.equal(out.done, ref.done):
        return None, f"done differs in {int((out.done != ref.done).sum())} rows"
    return worst, None


def copied(state):
    """A copy of ``state``: a chunk runner's call and a dispatch consume
    their input (the port's donation, ``ops/device_loop.py``), so a check
    that runs twice from one state gives each call a copy. Written here, not
    imported, so that ``--time-*`` runs a parent tree too."""
    return type(state)(*(t.clone() for t in state))


def device_ms(torch, fn, iters=40, warmup=1):
    """Device milliseconds a call of ``fn()``: CUDA events around ``iters``
    calls that the host queues behind a sleep on the stream, so the card
    runs them back to back however long a call's host work takes (events
    around a plain loop time the enqueue where that outlasts the kernels).
    The sleep is lengthened until the host has queued the last call before
    the card reaches the first."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    cycles = int(4e9 * (time.perf_counter() - t0)) + 1_000_000  # twice the enqueue at 2 GHz
    for _ in range(4):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        queued = not start.query()
        stop.record()
        stop.synchronize()
        if queued:
            return start.elapsed_time(stop) / iters
        cycles *= 4
    fail("device_ms: the card kept reaching the timed calls before the host had queued them")


def ragged_ode_cases(cases):
    """B = 1, 7, 33 on hard.cnf and the bucketed formula of phase 3: every
    tile of R lanes but the last is full, the last has padded lanes."""
    pick = [c for c in cases if c[0] in ("hard.cnf B=16384", "widths 2,3,5 n=300 m=1200 bucketed")]
    return [(f"{label.split(' B=')[0]} B={B}", fa, B) for label, fa, _ in pick for B in (1, 7, 33)]


def phase_compare(torch, fc, cases):
    from odesat_tpu_torch.utils.config import ODEConfig

    worst = 0.0
    lib, _ = fc.load_library()
    for label, fa, B in [*cases, *ragged_ode_cases(cases)]:
        nnz = int((fa.lit_mask > 0).sum())
        K, Mp = fa.lit_var.shape
        for fixed in (True, False):
            for R in (1, fc.fused_lanes(fa, fixed)):
                c_bytes = lib.fused_chunk_smem_bytes(fa.n_vars_padded, Mp, K, nnz, int(fixed), R)
                if c_bytes != fc.fused_smem_bytes(fa, fixed, R):
                    fail(f"{label}: shared-memory gate {fc.fused_smem_bytes(fa, fixed, R)} != "
                         f"kernel's {c_bytes} at {R} lanes")
        state = random_state(fa, B, seed=B)
        for mode in ("fixed", "adaptive"):
            for rigidity in ("paper", "reference"):
                for mm in ("float32", "bfloat16"):
                    ode = ODEConfig(step_size=0.01 if mode == "fixed" else None,
                                    rigidity=rigidity, matmul_dtype=mm)
                    zeta = ode.resolve_zeta(fa.density)
                    fn = fc.make_fused_chunk(fa, zeta, ode, 32, "cuda")
                    out = fn(copied(state))
                    ref = fc.fused_chunk_plain(state, fn.spec, 32)
                    torch.cuda.synchronize()
                    err, why = compare(torch, out, ref, EXACT)
                    tag = f"{label} {mode} {rigidity} {mm}"
                    if why:
                        fail(f"kernel vs plain, {tag}: {why}")
                    worst = max(worst, err)
                    say(f"[compare] {tag}: max abs err {err:.1f}, done {int(out.done.sum())}/{B} "
                        f"({fn.spec.lanes} lanes a CTA at most)")
    return worst


def phase_compare_finishing(torch, fc, uf250, make=None, kernel="B1"):
    """Kernel vs plain on chunks in which trajectories finish. uf250
    (planted SAT) at B=4096 is advanced by the kernel until some rows are
    done; then 32-step chunks are compared one after another, each from
    the kernel's last output, until one holds rows done before it (the
    freeze), rows that finish inside it (the done latch, the fixed
    integrator's update-then-freeze, the adaptive no-advance branch) and
    rows still running. Rows done before a chunk must come out unchanged.
    ``make`` builds the chunk (B1's by default; B2's plain version is B1's);
    both are held to exact equality."""
    from odesat_tpu_torch.utils.config import ODEConfig

    make = make or fc.make_fused_chunk
    B, worst = 4096, 0.0
    for mode in ("fixed", "adaptive"):
        for mm in ("float32", "bfloat16"):
            ode = ODEConfig(step_size=0.01 if mode == "fixed" else None, matmul_dtype=mm)
            zeta = ode.resolve_zeta(uf250.density)
            feed = make(uf250, zeta, ode, 64, "cuda")
            fn = make(uf250, zeta, ode, 32, "cuda")
            tag = f"{kernel} uf250 B={B} {mode} {mm}"
            state, steps = random_state(uf250, B, seed=11), 0
            while not bool(state.done.any()):
                if steps >= 20000:
                    fail(f"finishing, {tag}: no trajectory solved in {steps} steps")
                state, steps = feed(state), steps + 64
            for _ in range(64):
                out = fn(copied(state))
                ref = fc.fused_chunk_plain(state, fn.spec, 32)
                torch.cuda.synchronize()
                err, why = compare(torch, out, ref, EXACT)
                if why:
                    fail(f"kernel vs plain, {tag} from step {steps}: {why}")
                worst = max(worst, err)
                was = state.done
                for name in ("v", "xs", "xl", "dt"):
                    if not torch.equal(getattr(out, name)[was], getattr(state, name)[was]):
                        fail(f"finishing, {tag}: the kernel moved {name} of a done row")
                before, after = int(was.sum()), int(out.done.sum())
                state, steps = out, steps + 32
                if 0 < before < after < B:
                    say(f"[compare] {tag}, chunk ending at step {steps}: done {before} -> "
                        f"{after}/{B}, max abs err {err:.1f}")
                    break
            else:
                fail(f"finishing, {tag}: no trajectory finished inside a compared chunk "
                     f"by step {steps}")
    return worst


def phase_determinism(torch, fc, hard, uf250):
    from odesat_tpu_torch.utils.config import ODEConfig

    for label, fa, B, ode in (
        ("hard.cnf B=16384 fixed f32", hard, 16384, ODEConfig(step_size=0.01)),
        ("uf250 B=4096 adaptive f32", uf250, 4096, ODEConfig()),
        ("uf250 B=4096 fixed bf16", uf250, 4096,
         ODEConfig(step_size=0.01, matmul_dtype="bfloat16")),
    ):
        state = random_state(fa, B, seed=7)
        fn = fc.make_fused_chunk(fa, ode.resolve_zeta(fa.density), ode, 256, "cuda")
        a, b = fn(copied(state)), fn(copied(state))
        torch.cuda.synchronize()
        for x, y, name in zip(a, b, a._fields):
            if not torch.equal(x, y):
                fail(f"determinism, {label}: {name} differs between two identical launches")
        say(f"[determinism] {label}: two launches bit-identical")


MAIN_PATH_GRAPHS = {"launches": 0}  # device-loop graph launches of the CLI runs below
MESH_STARTUP = {}  # phase 20's CLI mesh runs: the whole run less the solve, s


def loop_counter():
    """The device loop's launch count as a counter, where the port has one
    (``--time-loop`` may run a tree from before it)."""
    try:
        from odesat_tpu_torch.ops import device_loop
    except ImportError:
        return {}
    return {"device_loop": (device_loop, "launches")}


def run_cli(counters, cmd, args):
    """The port's CLI in process, every kernel launch count set to 0 just
    before and read just after, the device loop's graph launches with them
    (key "device_loop", summed into MAIN_PATH_GRAPHS). ``counters`` maps a
    kernel name to its (module, attribute). Returns (verdict, launches by
    kernel, steps, solved, seconds, output)."""
    from odesat_tpu_torch import cli

    counters = {**counters, **loop_counter()}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([cmd, *args])
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    MAIN_PATH_GRAPHS["launches"] += launches.get("device_loop", 0)
    out = buf.getvalue()
    if rc != 0:
        fail(f"{cmd} {' '.join(args)} exited {rc}:\n{out}")
    m = re.search(r"Steps run: (\d+) \| (?:trajectories|chains) solved: (\d+)/(\d+) \| "
                  r"([0-9.]+) s", out)
    if m is None:
        fail(f"{cmd} printed no steps line:\n{out}")
    steps, solved, seconds = int(m.group(1)), int(m.group(2)), float(m.group(4))
    verdict = re.search(r"Checking if solution vector satisfies formula: (true|false)", out)
    if verdict is None:
        fail(f"{cmd} printed no verdict:\n{out}")
    return verdict.group(1), launches, steps, solved, seconds, out


def run_inter(fc, args, graphs=None):
    """``inter`` through :func:`run_cli`; returns (verdict, B1's launches,
    steps, solved, seconds). ``graphs``, a list, gets the run's device-loop
    graph launches."""
    verdict, launches, steps, solved, seconds, _ = run_cli(
        {"fused_chunk": (fc, "launches")}, "inter", args)
    if graphs is not None:
        graphs.append(launches.get("device_loop", 0))
    return verdict, launches["fused_chunk"], steps, solved, seconds


def phase_main_sat(fc):
    from odesat_tpu_torch.cnf import cnf_to_dimacs
    from odesat_tpu_torch.utils.generate import uf_instance

    os.makedirs(OUT, exist_ok=True)
    uf_path = os.path.join(OUT, "uf250_seed0.cnf")
    with open(uf_path, "w", encoding="utf-8") as fh:
        fh.write(cnf_to_dimacs(uf_instance(250, seed=0)))
    total = 0
    for label, B, args in (
        ("uf250 B=4096 fixed", 4096, ["-f", uf_path, "-b", "4096", "-s", "0.01", "-n", "20000",
                                      "--seed", "0"]),
        ("easy.cnf B=256 adaptive", 256, ["-f", os.path.join(ROOT, "tests", "data", "easy.cnf"),
                                          "-b", "256", "-n", "20000", "--seed", "1"]),
    ):
        verdict, launches, steps, solved, seconds = run_inter(fc, args)
        say(f"[main SAT] {label}: verdict {verdict}, {solved} solved after {steps} steps "
            f"in {seconds:.6f} s = {B * steps / seconds:.6e} traj*steps/s, kernel launches "
            f"{launches}")
        if verdict != "true":
            fail(f"{label}: the port did not verify a satisfying assignment")
        if launches == 0:
            fail(f"{label}: the main path never launched the kernel")
        total += launches
    return total


def phase_main_unsat(fc, card):
    """Returns (B1's launches, the f32 run's loop wall in s)."""
    total = 0
    hard = os.path.join(ROOT, "tests", "data", "hard.cnf")
    for mm in ("float32", "bfloat16"):
        args = ["-f", hard, "-b", "16384", "-s", "0.01", "-n", "4096", "--seed", "0",
                "--matmul-dtype", mm]
        graphs = []
        verdict, launches, steps, solved, seconds = run_inter(fc, args, graphs)
        rate = 16384 * steps / seconds
        say(f"[main UNSAT] hard.cnf B=16384 {mm}: verdict {verdict} after {steps} steps in "
            f"{seconds:.6f} s = {rate:.6e} traj*steps/s, kernel launches {launches} in "
            f"{graphs[0]} device-loop graph launches ({card})")
        if verdict != "false" or steps != 4096 or solved != 0:
            fail(f"hard.cnf {mm}: expected false after exactly 4096 steps")
        if launches == 0:
            fail(f"hard.cnf {mm}: the main path never launched the kernel")
        if graphs[0] == 0:
            fail(f"hard.cnf {mm}: the multi-chunk dispatch never launched the device loop")
        total += launches
        if mm == "float32":
            wall = seconds
    return total, wall


def phase_timing(torch, fc, hard, uf250, card):
    """Kernel and plain version in turns (plain, kernel, kernel, plain) on
    the same input; each time is the mean of its two turns."""
    from odesat_tpu_torch.utils.config import ODEConfig
    from odesat_tpu_torch.utils.timing import cuda_ms

    times = {}
    for label, fa, B in (("hard.cnf B=16384", hard, 16384), ("uf250 B=4096", uf250, 4096)):
        for mode in ("fixed", "adaptive"):
            ode = ODEConfig(step_size=0.01 if mode == "fixed" else None)
            state = random_state(fa, B, seed=3)
            fn = fc.make_fused_chunk(fa, ode.resolve_zeta(fa.density), ode, 256, "cuda")

            def plain_turn():
                return cuda_ms(lambda: fc.fused_chunk_plain(state, fn.spec, 256), 1, warmup=0)

            def kernel_turn():
                return cuda_ms(lambda: fn(state), iters=10, warmup=2)

            p1, k1, k2, p2 = plain_turn(), kernel_turn(), kernel_turn(), plain_turn()
            kernel, plain = (k1 + k2) / 2, (p1 + p2) / 2
            times[(label, mode)] = (kernel, plain)
            was = ONE_CTA_MS.get(f"B1 {label.split(' B=')[0]} {mode} 256")
            was = f" (one CTA a trajectory: {was:.6f} ms, {was / kernel:.3f}x)" if was else ""
            say(f"[timing] {label} {mode} f32, 256-step chunk: kernel {k1:.6f} / {k2:.6f} ms"
                f"{was}, plain {p1:.6f} / {p2:.6f} ms ({plain / kernel:.3f}x), "
                f"kernel {B * 256 / kernel * 1e3:.6e} traj*steps/s ({card})")
    return times


# ------------------------------------------------------------ stoch (B3, B4)

STOCH_KERNELS = ("fused", "stream")


def stoch_counters(fc, sc):
    return {"fused_chunk": (fc, "launches"), "stoch_fused": (sc, "fused_launches"),
            "stoch_stream": (sc, "stream_launches")}


def n1k_instance():
    """run_benchmarks.py config 4: planted random 3-SAT n=1000 m=4300."""
    from odesat_tpu_torch.utils.generate import random_ksat

    return random_ksat(1000, 4300, k=3, seed=7, planted=True)


def sat5_instance():
    """A SAT instance past B3's gate that B4 solves: planted random 5-SAT,
    n=2000, m=8000 (ratio 4), seed 11. Preprocessed it has 1892 variables
    and 13,239 clauses of widths up to 8, about 1.3 MB of B3 tables.
    (The engine's parallel flips stall on this family from ratio 6 on.)"""
    from odesat_tpu_torch.utils.generate import random_ksat

    return random_ksat(2000, 8000, k=5, seed=11, planted=True)


def preprocessed_n1k():
    from odesat_tpu_torch.preprocess import preprocess_formula

    t0 = time.perf_counter()
    reduced, _ = preprocess_formula(n1k_instance(), 7.0)
    say(f"[n1k] n=1k instance preprocessed in {time.perf_counter() - t0:.3f} s: "
        f"{reduced.num_clauses} clauses, {reduced.varnum} vars")
    return reduced


def load_stoch_cases(cases, reduced):
    """The ODE phase's formulas, then the preprocessed n=1k instance
    (K=9, Mp=6528: past B3's gate) at B=8192, the main path's shapes."""
    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables

    n1k = compile_formula(normalize_cnf_variables(reduced)[1], bucket=True)
    stoch_cases = [*cases, ("n1k preprocessed B=8192", n1k, 8192)]
    return stoch_cases, n1k


def stoch_state(fa, B, seed, xl_hi=3000):
    """Chains on the card: v random bits, xl random in [1, xl_hi] (past
    256, so bf16 rounds), nothing done; from NumPy."""
    import numpy as np

    from odesat_tpu_torch.interop import stoch_state_from_numpy

    rng = np.random.default_rng(seed)
    v = rng.random((B, fa.n_vars_padded)) < 0.5
    xl = rng.integers(1, xl_hi + 1, (B, fa.n_clauses_padded)).astype(np.int32)
    return stoch_state_from_numpy(v, xl, np.zeros(B, bool), device="cuda")


def stoch_compare(torch, out, ref):
    """Exact equality of v, xl and done; returns (max abs error, why)."""
    worst = 0
    for name in ("v", "xl", "done"):
        a, b = getattr(out, name), getattr(ref, name)
        if not torch.equal(a, b):
            return None, f"{name} differs in {int((a != b).sum())} entries"
        worst = max(worst, int((a.long() - b.long()).abs().max()) if a.numel() else 0)
    return float(worst), None


def stoch_kernels_for(sc, fa):
    return [k for k in STOCH_KERNELS if k == "stream" or sc.stoch_fused_supported(fa)]


def stoch_lanes_to_compare(fc, most, B, Mp):
    """The chains a CTA phase 8 compares a kernel at: every power of two
    from 1 to ``most`` on the small cases, the most and the launch's choice
    (``launch_lanes``) on the main-path shapes."""
    if B * Mp > 2**22:
        return sorted({most, fc.launch_lanes(most, B, "cuda")})
    return [1 << k for k in range(most.bit_length())]


def phase_stoch_compare(torch, fc, sc, stoch_cases):
    from odesat_tpu_torch.ops.stoch_chunk import stoch_chunk_plain, stoch_spec, traj_block

    lib, _ = sc.load_library()
    worst = dict.fromkeys(STOCH_KERNELS, 0.0)
    launch = {"fused": sc.stoch_fused_cuda, "stream": sc.stoch_stream_cuda}
    for label, fa, B in stoch_cases:
        nnz = int((fa.lit_mask > 0).sum())
        K, Mp = fa.lit_var.shape
        Np = fa.n_vars_padded
        spec = stoch_spec(fa, "cuda")
        most = {"fused": spec.fused_lanes, "stream": spec.stream_lanes}
        steps = 8 if B * Mp > 2**24 else 32
        state = stoch_state(fa, B, seed=B)
        for mm in ("float32", "bfloat16"):
            ref = stoch_chunk_plain(state, spec, steps, 1234567, traj_block(B), mm == "bfloat16")
            outs = {}
            for kernel in stoch_kernels_for(sc, fa):
                for R in stoch_lanes_to_compare(fc, most[kernel], B, Mp):
                    c_bytes = lib.stoch_fused_smem_bytes(Np, Mp, K, nnz, R) \
                        if kernel == "fused" else lib.stoch_stream_smem_bytes(Np, Mp, R)
                    py_bytes = sc.stoch_fused_smem_bytes(fa, R) if kernel == "fused" \
                        else sc.stoch_stream_smem_bytes(fa, R)
                    if c_bytes != py_bytes:
                        fail(f"{label}: {kernel}'s shared memory {py_bytes} != kernel's "
                             f"{c_bytes} at {R} chains a CTA")
                    out = launch[kernel](copied(state), spec, steps, 1234567, mm == "bfloat16",
                                         lanes=R)
                    torch.cuda.synchronize()
                    err, why = stoch_compare(torch, out, ref)
                    tag = f"{label} {kernel} {mm} {steps} steps, {R} chains a CTA"
                    if why:
                        fail(f"stoch kernel vs plain, {tag}: {why}")
                    worst[kernel] = max(worst[kernel], err)
                    outs[kernel] = out
                    say(f"[stoch compare] {tag}: equal (max abs err {err:.1f}), "
                        f"flips {int((out.v != state.v).sum())}, done {int(out.done.sum())}/{B}")
            if "fused" in outs:
                _, why = stoch_compare(torch, outs["fused"], outs["stream"])
                if why:
                    fail(f"B3 vs B4, {label} {mm}: {why}")
                say(f"[stoch B3 vs B4] {label} {mm}: equal")
    return worst


def phase_stoch_finishing(torch, sc, planted):
    """Kernel vs plain on chunks in which chains finish: from the all-false
    start the kernel advances a planted formula until some chains are
    done; then 8-step chunks are compared, each from the kernel's last
    output, until one holds chains done before it, chains that finish in
    it and chains still running. Done chains must come out unchanged."""
    from odesat_tpu_torch.models.stoch import init_stoch_state
    from odesat_tpu_torch.ops.stoch_chunk import make_stoch_chunk, stoch_chunk_plain, traj_block

    B, worst = 4096, dict.fromkeys(STOCH_KERNELS, 0.0)
    for kernel in STOCH_KERNELS:
        for mm in ("float32", "bfloat16"):
            feed = make_stoch_chunk(planted, 32, kernel, mm, "cuda")
            fn = make_stoch_chunk(planted, 8, kernel, mm, "cuda")
            tag = f"planted 3-SAT n=200 m=700 B={B} {kernel} {mm}"
            state, steps, seed = init_stoch_state(planted, B, "cuda"), 0, 1
            while not bool(state.done.any()):
                if steps >= 20000:
                    fail(f"stoch finishing, {tag}: no chain solved in {steps} steps")
                state, steps, seed = feed(state, seed), steps + 32, seed + 1
            for _ in range(256):
                out = fn(copied(state), seed)
                ref = stoch_chunk_plain(state, fn.spec, 8, seed, traj_block(B), mm == "bfloat16")
                torch.cuda.synchronize()
                err, why = stoch_compare(torch, out, ref)
                if why:
                    fail(f"stoch kernel vs plain, {tag} from step {steps}: {why}")
                worst[kernel] = max(worst[kernel], err)
                was = state.done
                for name in ("v", "xl"):
                    if not torch.equal(getattr(out, name)[was], getattr(state, name)[was]):
                        fail(f"stoch finishing, {tag}: the kernel moved {name} of a done chain")
                before, after = int(was.sum()), int(out.done.sum())
                state, steps, seed = out, steps + 8, seed + 1
                if 0 < before < after < B:
                    say(f"[stoch compare] {tag}, chunk ending at step {steps}: done {before} -> "
                        f"{after}/{B}, equal (max abs err {err:.1f})")
                    break
            else:
                fail(f"stoch finishing, {tag}: no chain finished inside a compared chunk "
                     f"by step {steps}")
    return worst


def phase_stoch_determinism(torch, sc, hard, n1k):
    from odesat_tpu_torch.ops.stoch_chunk import make_stoch_chunk

    for label, fa, B, kernel, steps in (("hard.cnf B=16384", hard, 16384, "fused", 256),
                                        ("hard.cnf B=16384", hard, 16384, "stream", 256),
                                        ("n1k B=8192", n1k, 8192, "stream", 32)):
        state = stoch_state(fa, B, seed=7)
        fn = make_stoch_chunk(fa, steps, kernel, "float32", "cuda")
        a, b = fn(copied(state), 99), fn(copied(state), 99)
        torch.cuda.synchronize()
        for x, y, name in zip(a, b, a._fields):
            if not torch.equal(x, y):
                fail(f"stoch determinism, {label} {kernel}: {name} differs between two launches")
        say(f"[stoch determinism] {label} {kernel}: two launches bit-identical")


def phase_stoch_main(fc, sc, card):
    """The stoch main path through the CLI; returns launches by kernel."""
    from odesat_tpu_torch.cnf import cnf_to_dimacs

    os.makedirs(OUT, exist_ok=True)
    n1k_path = os.path.join(OUT, "ksat_n1000_m4300_seed7_planted.cnf")
    sat5_path = os.path.join(OUT, "ksat5_n2000_m8000_seed11_planted.cnf")
    for path, formula in ((n1k_path, n1k_instance()), (sat5_path, sat5_instance())):
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(cnf_to_dimacs(formula))
    counters = stoch_counters(fc, sc)
    total = {name: 0 for name in counters}
    hard = os.path.join(ROOT, "tests", "data", "hard.cnf")
    easy = os.path.join(ROOT, "tests", "data", "easy.cnf")
    runs = (
        # label, args, kernel that must run, expected verdict (None: any)
        ("easy.cnf B=4096", ["-f", easy, "-b", "4096", "-n", "20000", "--seed", "1"],
         "stoch_fused", "true"),
        ("hard.cnf B=16384 f32 --no-preprocess", ["-f", hard, "--no-preprocess", "-b", "16384",
                                                  "-n", "4096", "--seed", "0"],
         "stoch_fused", "false"),
        ("hard.cnf B=16384 bf16 --no-preprocess", ["-f", hard, "--no-preprocess", "-b", "16384",
                                                   "-n", "4096", "--seed", "0",
                                                   "--matmul-dtype", "bfloat16"],
         "stoch_fused", "false"),
        ("n1k preprocessed B=8192", ["-f", n1k_path, "-b", "8192", "-n", "4096", "--seed", "0"],
         "stoch_stream", None),
        ("5-SAT n=2000 m=8000 B=1024", ["-f", sat5_path, "-b", "1024", "-n", "20000",
                                         "--seed", "0"],
         "stoch_stream", "true"),
    )
    for label, args, kernel, want in runs:
        verdict, launches, steps, solved, seconds, out = run_cli(counters, "stoch", args)
        B = int(args[args.index("-b") + 1])
        shape = re.search(r"Clauses: (\d+) \| Vars: (\d+)", out)
        shape = f", preprocessed to {shape.group(1)} clauses / {shape.group(2)} vars" \
            if shape else ""
        say(f"[stoch main] {label}{shape}: verdict {verdict}, {solved} solved after {steps} "
            f"steps in {seconds:.6f} s = {B * steps / seconds:.6e} chain*steps/s, launches "
            f"{launches} ({card})")
        if launches[kernel] == 0:
            fail(f"stoch {label}: the main path never launched {kernel}")
        if label.startswith("hard.cnf") and launches["device_loop"] == 0:
            fail(f"stoch {label}: the multi-chunk dispatch never launched the device loop")
        if want == "false" and (verdict != "false" or steps != 4096 or solved != 0):
            fail(f"stoch {label}: expected false after exactly 4096 steps")
        if want == "true" and verdict != "true":
            fail(f"stoch {label}: the port did not verify a satisfying assignment")
        if solved and verdict != "true":
            fail(f"stoch {label}: a chain solved but its assignment did not verify")
        for name in total:
            total[name] += launches[name]
    return total


def phase_stoch_timing(torch, sc, hard, n1k, card):
    """Kernel and plain version in turns (plain, kernel, kernel, plain) on
    the same input and the same number of steps; each time is the mean of
    its two turns."""
    from odesat_tpu_torch.ops.stoch_chunk import make_stoch_chunk, stoch_chunk_plain, traj_block
    from odesat_tpu_torch.utils.timing import cuda_ms

    times = {}
    for label, fa, B, kernel, steps in (("hard.cnf B=16384", hard, 16384, "fused", 64),
                                        ("hard.cnf B=16384", hard, 16384, "stream", 64),
                                        ("n1k B=8192", n1k, 8192, "stream", 8)):
        state = stoch_state(fa, B, seed=3, xl_hi=1)
        fn = make_stoch_chunk(fa, steps, kernel, "float32", "cuda")
        Bb = traj_block(B)
        R = sc.stoch_lanes(fa, kernel)

        def plain_turn():
            return cuda_ms(lambda: stoch_chunk_plain(state, fn.spec, steps, 5, Bb, False), 1,
                           warmup=0)

        def kernel_turn():
            return cuda_ms(lambda: fn(state, 5), iters=10, warmup=2)

        p1, k1, k2, p2 = plain_turn(), kernel_turn(), kernel_turn(), plain_turn()
        kern, plain = (k1 + k2) / 2, (p1 + p2) / 2
        times[(label, kernel)] = (kern, plain)
        was = ONE_CTA_MS.get(f"{'B3' if kernel == 'fused' else 'B4'} {label.split(' ')[0]} "
                             f"{steps}")
        was = f" (one CTA a chain: {was:.6f} ms, {was / kern:.3f}x)" if was else ""
        say(f"[stoch timing] {label} {kernel} f32, {steps}-step chunk, {R} chains a CTA: "
            f"kernel {k1:.6f} / {k2:.6f} ms{was}, plain {p1:.6f} / {p2:.6f} ms "
            f"({plain / kern:.3f}x), kernel {B * steps / kern * 1e3:.6e} chain*steps/s ({card})")
    # the chunk length phase 10's launches run: the kernel alone (its plain
    # version would take 4 and 32 times its timed length)
    for label, fa, B, kernel in (("hard.cnf B=16384", hard, 16384, "fused"),
                                 ("n1k B=8192", n1k, 8192, "stream")):
        state = stoch_state(fa, B, seed=3, xl_hi=1)
        fn = make_stoch_chunk(fa, 256, kernel, "float32", "cuda")
        ks = [cuda_ms(lambda: fn(state, 5), iters=1, warmup=1) for _ in range(2)]
        say(f"[stoch timing] {label} {kernel} f32, 256-step chunk, {sc.stoch_lanes(fa, kernel)} "
            f"chains a CTA: kernel {ks[0]:.6f} / {ks[1]:.6f} ms, "
            f"{B * 256 / (sum(ks) / 2) * 1e3:.6e} chain*steps/s ({card})")
    # the threads a CTA (stoch_threads): 512 and 1024 in turns, beside the
    # wrapper's choice, where tiles share SMs (hard.cnf B=16384, 512 tiles of
    # 42 KB), where each has an SM to itself but 1024 threads would give a
    # group fewer than four clauses (B=1000: 125 tiles of 8) and where one
    # CTA fills an SM (n1k)
    from odesat_tpu_torch.ops.fused_chunk import launch_lanes, sm_count

    lib, _ = sc.load_library()
    for label, fa, B, kernel, steps in (("hard.cnf B=16384", hard, 16384, "fused", 64),
                                        ("hard.cnf B=1000", hard, 1000, "fused", 64),
                                        ("n1k B=8192", n1k, 8192, "stream", 8)):
        state = stoch_state(fa, B, seed=3, xl_hi=1)
        out = type(state)(*(torch.empty_like(t) for t in state))
        spec = sc.stoch_spec(fa, "cuda")
        R = launch_lanes(sc.stoch_lanes(fa, kernel), B, "cuda")
        smem = sc.lanes_smem_bytes(kernel == "fused", spec.Np, spec.Mp, spec.K,
                                   spec.occ_clause.numel(), R)
        chosen = sc.stoch_threads(R, smem, -(-B // R), sm_count("cuda"), spec.Np, spec.Mp)

        def launch(threads):
            rc = getattr(lib, f"stoch_{kernel}_launch")(
                *(t.data_ptr() for t in state), *(t.data_ptr() for t in out),
                spec.lit_code.data_ptr(), spec.pos_ptr.data_ptr(), spec.pos_clause.data_ptr(),
                spec.var_order.data_ptr(), spec.segments.data_ptr(), spec.segments.shape[0], B,
                spec.Np, spec.Mp, spec.K, spec.occ_clause.numel(), steps, 5, traj_block(B), 0,
                R, threads, 0, 0, 0, 0, torch.cuda.current_stream().cuda_stream)
            if rc:
                fail(f"stoch_{kernel}_launch at {threads} threads: "
                     + lib.stoch_chunk_error_string(rc).decode())

        ms = {T: [] for T in (512, 1024)}
        for T in (512, 1024, 1024, 512):
            ms[T].append(cuda_ms(lambda: launch(T), iters=5, warmup=1))
        say(f"[stoch threads] {label} {kernel} f32, {steps}-step chunk, {R} chains a CTA: "
            + ", ".join(f"{T} threads {a:.6f} / {b:.6f} ms" for T, (a, b) in ms.items())
            + f"; the wrapper takes {chosen} ({card})")
    return times


# ---------------------------------------------- large formulas (B2) and B10

def planted_n2000(m):
    """Planted random 3-SAT, n=2000, seed 11: m=7000 preprocesses (ratio 7)
    to 1,523 variables and 10,631 clauses (K=11, Mp=11136, Np=1536);
    m=8000 unpreprocessed is K=3, Mp=8064, Np=2048. Both are past B1's
    gate in both integrators."""
    from odesat_tpu_torch.utils.generate import random_ksat

    return random_ksat(2000, m, k=3, seed=11, planted=True)


def local_n4096():
    """run_benchmarks.py config 6: locally structured 3-SAT, n=4096,
    m=17203, locality 256, seed 3 (window-sorted: K=3, Mp=17280)."""
    from odesat_tpu_torch.utils.generate import random_local_ksat

    return random_local_ksat(4096, 17203, k=3, locality=256, seed=3)


def load_stream_cases(n1k_reduced):
    """The real-size formulas past B1's gate, laid out as ``solve`` and
    ``inter`` lay them out (compile_for_config: width buckets on mixed
    widths, window-sorted), with the batch each is compared at."""
    from odesat_tpu_torch.cnf import normalize_cnf_variables
    from odesat_tpu_torch.models.ode import compile_for_config
    from odesat_tpu_torch.preprocess import preprocess_formula
    from odesat_tpu_torch.utils.config import SolverConfig

    def fa_of(formula):
        return compile_for_config(normalize_cnf_variables(formula)[1], SolverConfig())

    p2k, _ = preprocess_formula(planted_n2000(7000), 7.0)
    # chunks of 4, 8 and 4 steps (8, 16 and 8 before phase 25e came): the
    # plain version at B=10240 is most of phase 12's time
    return [
        ("n1k preprocessed B=10240", fa_of(n1k_reduced), 10240, 4),
        ("planted n=2000 m=7000 preprocessed B=1024", fa_of(p2k), 1024, 8),
        ("local n=4096 B=10240", fa_of(local_n4096()), 10240, 4),
    ]


def phase_stream_compare(torch, fc, stc, cases, big):
    """B2 vs its plain version (B1's fused_chunk_plain), exactly, on phase
    3's formulas (each also vs B1, which takes them all) and on the
    real-size formulas past B1's gate: both integrators, both rigidity
    gates, f32 and bf16 rounding, one chunk."""
    from odesat_tpu_torch.utils.config import ODEConfig

    worst = 0.0
    lib, _ = stc.load_library()
    small = [*cases, *ragged_ode_cases(cases)]
    for label, fa, B, steps in [*((lb, f, b, 32) for lb, f, b in small), *big]:
        state = random_state(fa, B, seed=B + 1)
        for fixed in (True, False):
            R = stc.stream_lanes(fa.n_vars_padded, fixed)
            c_bytes = lib.stream_chunk_smem_bytes(fa.n_vars_padded, int(fixed), R)
            if c_bytes != stc.stream_smem_bytes(fa.n_vars_padded, fixed, R):
                fail(f"{label}: B2's shared memory {stc.stream_smem_bytes(fa.n_vars_padded, fixed, R)}"
                     f" != kernel's {c_bytes}")
            for rigidity in ("paper", "reference"):
                for mm in ("float32", "bfloat16"):
                    ode = ODEConfig(step_size=0.01 if fixed else None, rigidity=rigidity,
                                    matmul_dtype=mm)
                    zeta = ode.resolve_zeta(fa.density)
                    fn = stc.make_stream_chunk(fa, zeta, ode, steps, "cuda")
                    out = fn(copied(state))
                    ref = stc.stream_chunk_plain(state, fn.spec, steps)
                    torch.cuda.synchronize()
                    tag = f"{label} {'fixed' if fixed else 'adaptive'} {rigidity} {mm}"
                    err, why = compare(torch, out, ref, EXACT)
                    if why:
                        fail(f"B2 vs plain, {tag}: {why}")
                    del ref
                    also = ""
                    if fc.fused_supported(fa, fixed):
                        _, why = compare(torch, out, fc.make_fused_chunk(fa, zeta, ode, steps,
                                                                         "cuda")(copied(state)),
                                         EXACT)
                        if why:
                            fail(f"B2 vs B1, {tag}: {why}")
                        also = ", equals B1"
                    worst = max(worst, err)
                    say(f"[B2 compare] {tag}, {steps} steps: max abs err {err:.1f}{also}, "
                        f"done {int(out.done.sum())}/{B} ({R} lanes a CTA at most, shared "
                        f"memory {c_bytes} B)")
    return worst


def phase_stream_determinism(torch, stc, big):
    from odesat_tpu_torch.utils.config import ODEConfig

    for (label, fa, B, steps), ode in ((big[0], ODEConfig(step_size=0.01)),
                                       (big[2], ODEConfig())):
        state = random_state(fa, B, seed=7)
        fn = stc.make_stream_chunk(fa, ode.resolve_zeta(fa.density), ode, steps, "cuda")
        a, b = fn(copied(state)), fn(copied(state))
        torch.cuda.synchronize()
        for x, y, name in zip(a, b, a._fields):
            if not torch.equal(x, y):
                fail(f"B2 determinism, {label}: {name} differs between two identical launches")
        say(f"[B2 determinism] {label} {'fixed' if ode.step_size else 'adaptive'}: "
            "two launches bit-identical")


def ode_counters(fc, stc, rk):
    return {"fused_chunk": (fc, "launches"), "stream_chunk": (stc, "launches"),
            "rhs": (rk, "launches")}


def phase_stream_main(fc, stc, rk, n1k_reduced, card):
    """The large-formula ODE path through the CLI (solve, batch, inter);
    returns B2's launches over these runs."""
    from odesat_tpu_torch.cnf import cnf_to_dimacs

    os.makedirs(OUT, exist_ok=True)
    paths = {}
    for name, formula in (("planted_n2000_m7000", planted_n2000(7000)),
                          ("planted_n2000_m8000", planted_n2000(8000)),
                          ("ksat_n1000_m4300_seed7_planted", n1k_instance()),
                          ("local_n4096_m17203", local_n4096())):
        paths[name] = os.path.join(OUT, f"{name}.cnf")
        with open(paths[name], "w", encoding="utf-8") as fh:
            fh.write(cnf_to_dimacs(formula))
    hard = os.path.join(ROOT, "tests", "data", "hard.cnf")
    counters = ode_counters(fc, stc, rk)
    total = 0
    runs = (
        # label, subcommand, args, trajectories, expected verdict (None: any)
        ("solve planted n=2000 m=7000 adaptive", "solve",
         ["-f", paths["planted_n2000_m7000"], "-n", "20000", "--seed", "0"], 8, "true"),
        ("solve planted n=2000 m=7000 fixed", "solve",
         ["-f", paths["planted_n2000_m7000"], "-s", "0.01", "-n", "20000", "--seed", "0"], 8,
         "true"),
        ("batch planted n=2000 m=8000 B=1024", "batch",
         ["-f", paths["planted_n2000_m8000"], "-b", "1024", "-s", "0.01", "-n", "20000",
          "--seed", "0"], 1024, "true"),
        ("solve n1k B=10240 f32", "solve",
         ["-f", paths["ksat_n1000_m4300_seed7_planted"], "--solve-batch", "10240", "-s", "0.01",
          "-n", "4096", "--seed", "0"], 10240, None),
        ("solve n1k B=10240 bf16", "solve",
         ["-f", paths["ksat_n1000_m4300_seed7_planted"], "--solve-batch", "10240", "-s", "0.01",
          "-n", "4096", "--seed", "0", "--matmul-dtype", "bfloat16"], 10240, None),
        ("inter local n=4096 B=10240", "inter",
         ["-f", paths["local_n4096_m17203"], "-b", "10240", "-s", "0.01", "-n", "2048",
          "--seed", "0"], 10240, None),
        ("inter --dv-strategy stream hard.cnf B=16384", "inter",
         ["-f", hard, "-b", "16384", "-s", "0.01", "-n", "4096", "--seed", "0",
          "--dv-strategy", "stream"], 16384, "false"),
    )
    for label, cmd, args, B, want in runs:
        verdict, launches, steps, solved, seconds, out = run_cli(counters, cmd, args)
        shape = re.search(r"Clauses: (\d+) \| Vars: (\d+)", out)
        shape = f", preprocessed to {shape.group(1)} clauses / {shape.group(2)} vars" \
            if shape else ""
        say(f"[B2 main] {label}{shape}: verdict {verdict}, {solved} solved after {steps} steps "
            f"in {seconds:.6f} s = {B * steps / seconds:.6e} traj*steps/s, launches "
            f"{launches} ({card})")
        if launches["stream_chunk"] == 0:
            fail(f"{label}: the main path never launched B2")
        if want == "false" and (verdict != "false" or steps != 4096 or solved != 0):
            fail(f"{label}: expected false after exactly 4096 steps")
        if want == "true" and verdict != "true":
            fail(f"{label}: the port did not verify a satisfying assignment")
        if solved and verdict != "true":
            fail(f"{label}: a trajectory solved but its assignment did not verify")
        total += launches["stream_chunk"]
    return total


def rhs_inputs(torch, fa, B, dtype, seed):
    """v ~ U(-1, 1), xs ~ U(0.001, 0.999), xl ~ U(1, 50) on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def put(a):
        return torch.as_tensor(a).to("cuda", dtype)

    return (put(rng.uniform(-1, 1, (B, fa.n_vars_padded))),
            put(rng.uniform(0.001, 0.999, (B, fa.n_clauses_padded))),
            put(rng.uniform(1.0, 50.0, (B, fa.n_clauses_padded))))


def rhs_lane_tries(rk, spec, itemsize):
    """The plans phase 15 holds B10 to: every R from 1 to the most that fit
    in the form the wrapper takes, and the streamed form forced with a
    window of 64 clauses (several windows a pass) at up to 4 lanes."""
    best = rk.rhs_plan(spec.Np, spec.Mp, spec.nnz, itemsize)
    lanes = rk.rhs_lane_range(spec.Np, spec.Mp, spec.nnz, itemsize, best.resident)
    return best, [(R, best.resident, None) for R in lanes] + [(min(lanes[0], 4), False, 64)]


def phase_rhs_compare(torch, rk, cases):
    """B10 vs its plain version (the kernel-order RHS), exactly, at each
    formula's main-path batch and at ragged B = 1, 7, 33, float32 and
    float64, both rigidity gates, at every R and in both forms; then the
    wrapper's own plan against the plain version and the twin's gather RHS
    (f32 rtol 2e-4 / atol 2e-5, f64 1e-12: the twin sums in another
    order). Returns the max abs error against the plain version."""
    from odesat_tpu_torch.models.ode import formula_device

    worst, n = 0.0, 0
    for label, fa, B0 in cases:
        buckets = fa.bucket_slices if len(fa.bucket_slices) > 1 else None
        for B in (B0, 1, 7, 33):
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.float64, dict(rtol=1e-12, atol=1e-12))):
                name = str(dtype).split(".")[1]
                itemsize = 8 if dtype == torch.float64 else 4
                v, xs, xl = rhs_inputs(torch, fa, B, dtype, seed=B)
                dev = formula_device(fa, "cuda", dtype)
                for rigidity in ("paper", "reference"):
                    spec = rk.rhs_spec(fa, 0.05, rigidity, "cuda")
                    plain = rk.rhs_plain(v, xs, xl, spec)
                    best, tries = rhs_lane_tries(rk, spec, itemsize)
                    tag = f"{label.split(' B=')[0]} B={B} {name} {rigidity}"
                    for R, resident, window in tries:
                        out = rk.rhs_cuda(v, xs, xl, spec, rk.rhs_plan(
                            spec.Np, spec.Mp, spec.nnz, itemsize, R, resident, window))
                        torch.cuda.synchronize()
                        for what, a, b in zip(("dv", "dxs", "dxl", "allsat"), out, plain):
                            if not torch.equal(a, b):
                                err = (a.double() - b.double()).abs().max().item()
                                fail(f"B10 vs plain, {tag}, {R} lanes resident={resident} "
                                     f"window={window}: {what} differs (max abs err {err})")
                        n += 1
                    plan = rk.launch_plan(spec, B, dtype)
                    out = rk.make_rhs_kernel(fa, 0.05, rigidity, name)(v, xs, xl)
                    twin = rk.rhs_twin(v, xs, xl, dev, 0.05, rigidity, buckets)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(out, plain)):
                        fail(f"B10 vs plain, {tag}: the wrapper's launch differs")
                    err = 0.0
                    for what, a, b in zip(("dv", "dxs", "dxl"), out[:3], twin[:3]):
                        if not torch.isfinite(a).all():
                            fail(f"B10 vs twin, {tag}: {what} not finite")
                        if not torch.allclose(a, b, **tol):
                            fail(f"B10 vs twin, {tag}: {what} off by "
                                 f"{(a - b).abs().max().item()} (tolerance {tol})")
                        err = max(err, (a - b).abs().max().item())
                    if not torch.equal(out[3], twin[3]):
                        fail(f"B10 vs twin, {tag}: allsat differs")
                    say(f"[B10 compare] {tag}: equal to the plain version at R = "
                        f"{[t[0] for t in tries[:-1]]} ({'resident' if best.resident else 'streamed'}"
                        f") and streamed at R = {tries[-1][0]} in windows of 64 clauses; the "
                        f"wrapper's launch {plan.lanes} lanes, "
                        f"{plan.threads} threads, "
                        f"{'resident' if plan.resident else 'streamed'} (window {plan.window}), "
                        f"{plan.smem_bytes} B of shared memory; vs the twin max abs err "
                        f"{err:.3e} (|dv| up to {twin[0].abs().max().item():.3e}), allsat equal")
    say(f"[B10 compare] {n} kernel launches equal to the plain version bit for bit")
    return worst


def phase_rhs_main(fc, stc, rk, card):
    """inter --dv-strategy pallas: single steps through B10, fixed on
    hard.cnf and uf250, and adaptive with a batch-shared dt on uf250 (the
    reference inter's configuration, which B1 and B2 refuse; two B10
    launches a step). Each run's multi-chunk dispatches are device-loop
    graph launches around the captured scan chunk, and B10 launches the
    steps run times its calls a step: no step is launched from Python.
    Returns (B10's launches, the scan chunk's graph chunks)."""
    from odesat_tpu_torch.ops import scan_chunk

    os.makedirs(OUT, exist_ok=True)
    uf_path = os.path.join(OUT, "uf250_seed0.cnf")  # written by phase 5
    hard = os.path.join(ROOT, "tests", "data", "hard.cnf")
    total = chunks = 0
    for label, args, B, want in (
        ("hard.cnf B=4096", ["-f", hard, "-b", "4096", "-s", "0.01", "-n", "1024", "--seed", "0",
                             "--dv-strategy", "pallas"], 4096, "false"),
        ("uf250 B=4096", ["-f", uf_path, "-b", "4096", "-s", "0.01", "-n", "20000",
                          "--seed", "0", "--dv-strategy", "pallas"], 4096, "true"),
        ("uf250 B=4096 adaptive --dt-mode shared", ["-f", uf_path, "-b", "4096", "-n", "20000",
                                                    "--seed", "0", "--dt-mode", "shared",
                                                    "--dv-strategy", "pallas"], 4096, "true"),
    ):
        verdict, launches, steps, solved, seconds, _ = run_cli(
            {**ode_counters(fc, stc, rk), "scan_chunk": (scan_chunk, "launches")}, "inter", args)
        say(f"[B10 main] inter --dv-strategy pallas {label}: verdict {verdict}, {solved} solved "
            f"after {steps} steps in {seconds:.6f} s = {B * steps / seconds:.6e} traj*steps/s, "
            f"launches {launches} ({card})")
        if launches["rhs"] == 0:
            fail(f"pallas {label}: the main path never launched B10")
        if launches["device_loop"] == 0:
            fail(f"pallas {label}: the multi-chunk dispatch never launched the device loop")
        per_step = 1 if "-s" in args else 2
        if launches["rhs"] != steps * per_step:
            fail(f"pallas {label}: {launches['rhs']} B10 launches for {steps} steps of "
                 f"{per_step}: a step ran outside the captured chunk")
        if launches["fused_chunk"] or launches["stream_chunk"]:
            fail(f"pallas {label}: a chunk kernel ran instead of B10")
        if want == "false" and (verdict != "false" or steps != 1024 or solved != 0):
            fail(f"pallas {label}: expected false after exactly 1024 steps")
        if want == "true" and verdict != "true":
            fail(f"pallas {label}: the port did not verify a satisfying assignment")
        total += launches["rhs"]
        chunks += launches["scan_chunk"]
    return total, chunks


def step_walls(torch, fa, ode, B, steps=64, chunk_steps=64, chunks=8):
    """ms a step of ``ode`` at ``fa`` and B rows from a random state:
    host-paced (the step function called from Python, host clock over
    ``steps`` steps ending in a sync) and captured (``chunks`` calls of the
    ``chunk_steps``-step scan chunk, copies included). Returns (host-paced,
    captured, the scan chunk, the step, the state, the formula tensors)."""
    from odesat_tpu_torch.models.ode import formula_device, make_chunk_runner, make_step_fn

    step = make_step_fn(fa, 0.05, ode, device="cuda")
    dev = formula_device(fa, "cuda", torch.float32)
    state = random_state(fa, B, seed=5)
    for _ in range(4):
        state = step(state, dev)
    chunk = make_chunk_runner(fa, 0.05, ode, chunk_steps, "cuda")
    chunk(state, dev)  # captures the graph
    walls = []
    for fn, n, per in ((step, steps, 1), (chunk, chunks, chunk_steps)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = state
        for _ in range(n):
            s = fn(s, dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / (n * per) * 1e3)
    return walls[0], walls[1], chunk, step, state, dev


def phase_rhs_step_split(torch, rk, hard, uf250, card):
    """Where a fixed --dv-strategy pallas step goes at hard.cnf B=4096 (phase
    16's first run), host-paced and captured. Host-paced (the step function
    called from Python): the step's wall (host clock over 64 steps ending
    in a sync), the card's busy time a step and B10's part of it
    (torch.profiler over 16 steps: the kernels' device time, by name), and
    B10's device time alone with its launches queued. Captured (the scan
    chunk of 64 steps, ops/scan_chunk.py, as phase 16 runs it): a step's
    wall (host clock over 8 chunk calls, copies included, ending in a
    sync), the same kernels' busy time over it and B10's part, and the
    graph's replay alone (device time, replays queued). The same two walls
    of phase 16's third run's step, uf250 B=4096 adaptive with a
    batch-shared dt. Returns a dict of those times in ms (the busy ones
    None when the profiler reads no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from odesat_tpu_torch.utils.config import ODEConfig

    B, steps, traced, chunk_steps, chunks = 4096, 64, 16, 64, 8
    shared = step_walls(torch, uf250, ODEConfig(dt_mode="shared", dv_strategy="pallas"), B)[:2]
    say(f"[B10 step split] uf250 B={B} adaptive --dt-mode shared, --dv-strategy pallas: a step's "
        f"wall {shared[1]:.6f} ms captured, {shared[0]:.6f} ms host-paced, "
        f"{shared[0] / shared[1]:.3f}x ({card})")
    ode = ODEConfig(step_size=0.01, dv_strategy="pallas")
    wall, captured, chunk, step, state, dev = step_walls(torch, hard, ode, B, steps, chunk_steps,
                                                         chunks)
    (cap,) = chunk.graphs.values()
    ((graph, _),) = cap.parts  # one graph of the 64 steps
    replay = device_ms(torch, graph.replay, iters=10)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s = state
        for _ in range(traced):
            s = step(s, dev)
        torch.cuda.synchronize()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = prof.key_averages()
    busy = sum(device_us(e) for e in events) / traced / 1e3
    rhs = sum(device_us(e) for e in events if "rhs_" in e.key) / traced / 1e3
    fn = rk.make_rhs_kernel(hard, 0.05)
    b10 = device_ms(torch, lambda: fn(state.v, state.xs, state.xl), iters=steps)
    times = {"wall": wall, "busy": None, "rhs": None, "b10": b10, "captured": captured,
             "replay": replay, "plain_chunk": wall * chunk_steps, "shared": shared}
    say(f"[B10 step split] hard.cnf B={B} fixed, --dv-strategy pallas, captured: a step's wall "
        f"{captured:.6f} ms (host clock over {chunks} calls of the {chunk_steps}-step scan "
        f"chunk, copies included), the graph's replay alone {replay / chunk_steps:.6f} ms a step "
        f"({replay:.6f} ms a chunk, device time); host-paced: a step's wall {wall:.6f} ms (host "
        f"clock over {steps} steps), {wall / captured:.3f}x the captured step ({card})")
    if busy <= 0.0 or rhs <= 0.0:
        say(f"[B10 step split] B10 {b10:.6f} ms with its launches queued; the profiler read no "
            f"device time, so the rest of the step is not measured ({card})")
        return times
    times.update(busy=busy, rhs=rhs)
    say(f"[B10 step split] host-paced: the card busy {busy:.6f} ms of a step's wall "
        f"(torch.profiler over {traced} steps), B10 {rhs:.6f} ms of that ({b10:.6f} ms with its "
        f"launches queued), the torch update and latch {busy - rhs:.6f} ms; the card idle "
        f"{wall - busy:.6f} ms a step ({(wall - busy) / wall:.3f} of the wall), waiting on the "
        f"host; captured, the graph's replay spans {replay / chunk_steps / captured:.3f} of the "
        f"step's wall and its kernels' device time (the host-paced step's) "
        f"{busy / captured:.3f} of it, B10 {rhs / captured:.3f} ({card})")
    return times


def phase_stream_timing(torch, fc, stc, hard, big, card):
    """B2 and its plain version in turns (plain, kernel, kernel, plain) on
    the same input and steps; at hard.cnf B1 takes turns beside B2."""
    from odesat_tpu_torch.utils.config import ODEConfig
    from odesat_tpu_torch.utils.timing import cuda_ms

    n1k, _, local = big
    times = {}
    for label, fa, B, steps, fixed in ((n1k[0], n1k[1], n1k[2], 8, True),
                                       (n1k[0], n1k[1], n1k[2], 8, False),
                                       (local[0], local[1], local[2], 8, True),
                                       ("hard.cnf B=16384", hard, 16384, 256, True)):
        ode = ODEConfig(step_size=0.01 if fixed else None)
        state = random_state(fa, B, seed=3)
        fn = stc.make_stream_chunk(fa, ode.resolve_zeta(fa.density), ode, steps, "cuda")

        def plain_turn():
            return cuda_ms(lambda: stc.stream_chunk_plain(state, fn.spec, steps), 1, warmup=0)

        def kernel_turn():
            return cuda_ms(lambda: fn(state), iters=5, warmup=1)

        p1, k1, k2, p2 = plain_turn(), kernel_turn(), kernel_turn(), plain_turn()
        kern, plain = (k1 + k2) / 2, (p1 + p2) / 2
        mode = "fixed" if fixed else "adaptive"
        times[(label, mode)] = (kern, plain)
        b1 = ""
        if fc.fused_supported(fa, fixed):
            f1 = fc.make_fused_chunk(fa, ode.resolve_zeta(fa.density), ode, steps, "cuda")
            b1s = [cuda_ms(lambda: f1(state), iters=5, warmup=1) for _ in range(2)]
            b1 = f", B1 {b1s[0]:.6f} / {b1s[1]:.6f} ms"
        was = ONE_CTA_MS.get(f"B2 {label.split(' ')[0]} {mode} {steps}")
        was = f" (one CTA a trajectory: {was:.6f} ms, {was / kern:.3f}x)" if was else ""
        say(f"[B2 timing] {label} {mode} f32, {steps}-step chunk: B2 {k1:.6f} / {k2:.6f} ms"
            f"{was}, plain {p1:.6f} / {p2:.6f} ms ({plain / kern:.3f}x){b1}, B2 "
            f"{B * steps / kern * 1e3:.6e} traj*steps/s ({card})")
    # the chunk length phase 13's launches run: B2 alone (its plain version
    # would take about 32 times its 8-step time)
    for label, fa, B in (n1k[:3], local[:3]):
        ode = ODEConfig(step_size=0.01)
        state = random_state(fa, B, seed=3)
        fn = stc.make_stream_chunk(fa, ode.resolve_zeta(fa.density), ode, 256, "cuda")
        ks = [cuda_ms(lambda: fn(state), iters=1, warmup=1) for _ in range(2)]
        times[(label, "fixed 256")] = (sum(ks) / 2, None)
        say(f"[B2 timing] {label} fixed f32, 256-step chunk: B2 {ks[0]:.6f} / {ks[1]:.6f} ms, "
            f"{B * 256 / (sum(ks) / 2) * 1e3:.6e} traj*steps/s ({card})")
    return times


def b10_shapes(torch, hard, uf250, n1k):
    """Phase 17's shapes: (label, formula, B, dtype)."""
    return (("hard.cnf f32 16384", hard, 16384, torch.float32),
            ("uf250 f32 4096", uf250, 4096, torch.float32),
            ("hard.cnf f64 16384", hard, 16384, torch.float64),
            ("n1k f32 1024", n1k, 1024, torch.float32))


def phase_rhs_timing(torch, rk, shapes, card):
    """B10 and its plain version per pass, in turns (plain, kernel, kernel,
    plain), device time with the launches queued, beside the one-CTA-a-
    trajectory design's time (ONE_CTA_MS, ``--time-b10`` on the tree before
    the tiles) and the bound.
    Returns {label: (kernel ms, plain ms)}."""
    times = {}
    for label, fa, B, dtype in shapes:
        v, xs, xl = rhs_inputs(torch, fa, B, dtype, seed=3)
        name = str(dtype).split(".")[1]
        fn = rk.make_rhs_kernel(fa, 0.05, "paper", name)
        spec = rk.rhs_spec(fa, 0.05, "paper", "cuda")
        plan = rk.launch_plan(spec, B, dtype)

        def plain_turn():
            return device_ms(torch, lambda: rk.rhs_plain(v, xs, xl, spec), iters=5)

        def kernel_turn():
            return device_ms(torch, lambda: fn(v, xs, xl), iters=40)

        p1, k1, k2, p2 = plain_turn(), kernel_turn(), kernel_turn(), plain_turn()
        kern, plain = (k1 + k2) / 2, (p1 + p2) / 2
        times[label] = (kern, plain)
        bound_ms, by = rhs_pass_bound(fa, B, 8 if dtype == torch.float64 else 4)
        was = ONE_CTA_MS[f"B10 {label}"]
        say(f"[B10 timing] {label}, one RHS pass: B10 {k1:.6f} / {k2:.6f} ms ({plan.lanes} lanes, "
            f"{plan.threads} threads, "
            f"{'resident' if plan.resident else 'streamed'}), one CTA a trajectory {was:.6f} ms "
            f"({was / kern:.3f}x), plain {p1:.6f} / {p2:.6f} ms ({plain / kern:.3f}x), bound "
            f"{bound_ms:.6f} ms ({by}, {bound_ms / kern:.3f} of it) ({card})")
    return times


def time_b10(root):
    """``--time-b10 ROOT``: B10 of the checkout at ROOT (the parent tree,
    unpacked beside this one) at phase 17's shapes, device time with the
    launches queued, as phase 17 times the current one: ONE_CTA_MS's B10
    entries come from this mode."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(root))
    from odesat_tpu_torch.models.ode import formula_device
    from odesat_tpu_torch.ops import rhs_kernel as rk

    _, hard, uf250, _ = load_cases()
    n1k = load_stream_cases(preprocessed_n1k())[0][1]
    for label, fa, B, dtype in b10_shapes(torch, hard, uf250, n1k):
        v, xs, xl = rhs_inputs(torch, fa, B, dtype, seed=3)
        dev = formula_device(fa, "cuda", dtype)
        fn = rk.make_rhs_kernel(fa, 0.05, "paper", str(dtype).split(".")[1])
        ms = [device_ms(torch, lambda: fn(v, xs, xl, dev), iters=40) for _ in range(2)]
        say(f"[B10 of {root}] {label}: {ms[0]:.6f} / {ms[1]:.6f} ms, mean "
            f"{sum(ms) / 2:.6f} ({torch.cuda.get_device_name(0)})")
    return 0


B7_SHAPE = (1024, 10241)  # config 7's (B, Np+1) f32 buffer at B=1024 (Np = 10240)


def b7_split_line(S, r, card):
    """Phase 21's line for a split of B7's standalone call (time_butterfly_split)."""
    return (f"[B7 split] config 7 (B, Np+1) = {B7_SHAPE} f32 at S={S}, {S} ranks sharing the "
            f"card: back to back {r['back_to_back']:.6f} ms a call (host clock), the flags "
            f"already raised {r['synced']:.6f} (every rank at once) / {r['turns']:.6f} (one rank "
            f"at a time), the kernel alone on {S} buffers of one process {r['alone']:.6f} ms "
            f"(CUDA events); the wait for the peers {r['back_to_back'] - r['synced']:.6f}, the "
            f"contexts' sharing {r['synced'] - r['turns']:.6f}, the stream operations "
            f"{r['turns'] - r['alone']:.6f} ms ({card})")


def mesh_step_ms(mesh, device, fa, steps=16, reps=2, B=1024):
    """A rank's ms a step of the four clause-mesh paths at config 7 on this
    mesh, each over ``reps`` chunks of ``steps`` steps after a warm-up chunk
    (host clock, a device sync and a barrier at each end): inter's fixed
    step through B6 (``time_ode_chunk``) and through B5 (``--shard-chunk
    off``), the stoch step through B9 and through B8. Uses only entry points
    that trees from before the fused B7 also have, so that ``--time-mesh``
    can run it on an older tree. Run in a spawned world (rank 0's value
    returns)."""
    import torch
    import torch.distributed as dist

    from odesat_tpu_torch.models.stoch import init_stoch_state
    from odesat_tpu_torch.parallel import sharded
    from odesat_tpu_torch.utils.config import ODEConfig

    ode = ODEConfig(step_size=0.01)
    zeta = ode.resolve_zeta(fa.density)
    out = {"B6": sharded.time_ode_chunk(mesh, device, fa, zeta, ode, steps, B, reps),
           "B5": sharded.time_ode_chunk(mesh, device, fa, zeta,
                                        ODEConfig(step_size=0.01, shard_chunk="off"), steps, B,
                                        reps)}
    for name, mode in (("B9", "auto"), ("B8", "off")):
        state = sharded.shard_stoch_inputs(init_stoch_state(fa, B * mesh.n_traj, device), mesh)
        run = sharded.make_clause_stoch_runner(fa, steps, device, sharded.row_generator(5, mesh),
                                               mesh.clause_group, "float32", mode)

        def settle():
            torch.cuda.synchronize(device)
            dist.barrier()

        state = run(state)  # a call consumes its input where the tree donates
        settle()
        t0 = time.perf_counter()
        for _ in range(reps):
            state = run(state)
        settle()
        out[name] = (time.perf_counter() - t0) / (reps * steps) * 1e3
    return out


def mesh_step_line(S, r, card, origin="this tree"):
    return (f"[mesh steps] config 7 B=1024 S={S} ({S} ranks sharing the card, {origin}), ms a "
            f"step (host clock around 2 chunks of 16 steps): inter fixed through B6 "
            f"{r['B6']:.6f}, through B5 (--shard-chunk off) {r['B5']:.6f}; stoch through B9 "
            f"{r['B9']:.6f}, through B8 (--shard-chunk off) {r['B8']:.6f} ({card})")


def time_mesh(root):
    """``--time-mesh ROOT``: phase 25e's clause-mesh chunk walls and peaks
    at S=1 (clause_walls_and_peaks) and each rank's peak at S=2
    (mesh_chunk_peaks), and phase 20's clause-mesh steps (mesh_step_ms) at
    S=2 and S=4, on config 7 with the port of the checkout at ROOT (a parent
    tree unpacked beside this one, or this one)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(root))
    from odesat_tpu_torch.cnf import normalize_cnf_variables
    from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded
    from odesat_tpu_torch.parallel import launch

    card = phase_device(torch)
    c7 = config7_instance()
    normalized = normalize_cnf_variables(c7)[1]
    # phase 25e's and 21's: each runner's 64-step chunk walls and peak at S=1,
    # and each rank's peak at S=2
    walls = clause_walls_and_peaks(torch, compile_stream_sharded(normalized, 1)[0])
    for name in walls:
        say(clause_walls_line(name, walls[name], card, root))
    every = launch.spawn(mesh_chunk_peaks, 1, 2, "gloo", "cuda", timeout_s=600,
                         args=(compile_stream_sharded(normalized, 2)[0],))
    say(mesh_peaks_line(2, every, card, root))
    for S in (2, 4):
        fa = compile_stream_sharded(normalized, S)[0]
        r = launch.spawn(mesh_step_ms, 1, S, "gloo", "cuda", timeout_s=600, args=(fa,))
        say(mesh_step_line(S, r, card, root))
    # 29a and 29b: the twin's mesh step, on the route the tree at ROOT takes
    from odesat_tpu_torch.cnf import compile_formula
    from odesat_tpu_torch.utils.generate import uf_instance

    uf250 = compile_formula(normalize_cnf_variables(uf_instance(250, seed=0))[1],
                            window_sort=True)
    calls = [(twin_timing, (twin_config7(c7), twin_ode(mode), 1024)) for mode, _ in TWIN_MODES]
    calls.append((launch.on_mesh, ((2, 1), twin_timing, uf250,
                                   twin_ode("adaptive", "float32", "shared"), 4096)))
    values = launch.spawn(launch.run_all, 1, 2, "gloo", "cuda", timeout_s=600, args=(calls,))
    for label, r in zip(TWIN_LABELS, values):
        say(twin_line(label, r, card, root))
    return 0


def time_b7():
    """``--time-b7``: the split of a standalone B7 call at S=2 and S=4
    (parallel/dist.time_butterfly_split), as phase 20's worlds take it."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from odesat_tpu_torch.ops import butterfly as bf
    from odesat_tpu_torch.parallel import launch
    from odesat_tpu_torch.parallel.dist import time_butterfly, time_butterfly_split

    card = phase_device(torch)
    bf.load_library()
    for S in (2, 4):
        calls = [(time_butterfly_split, (B7_SHAPE, 20)), (time_butterfly, (B7_SHAPE, 20, 1))]
        split, (ms, _) = launch.spawn(launch.run_all, 1, S, "gloo", "cuda", timeout_s=300,
                                      args=(calls,))
        say(b7_split_line(S, split, card))
        say(f"[B7 timing] S={S}: time_butterfly {ms:.6f} ms a call ({card})")
    return 0


# ------------------------------------------ clause shards: B5, B8, the mesh

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, HBM3 peak rate
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, the rate the bounds use


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nnz_of(fa):
    return int((fa.lit_mask > 0).sum())


def table_bytes(K, Mp, Np, nnz):
    """Literal codes, CSR pointers and occurrence lists, int32, read once."""
    return 4 * (K * Mp + Np + 1 + nnz)


def ode_step_ops(nnz, Np, Mp, fixed):
    """Operations of one ODE step of one trajectory: per literal slot 3
    (its value, the running min and second min), per occurrence 12 (the
    contribution and its add), per variable 3 (the update and its clamp),
    per clause 10 (c, dxs, dxl, the clamped updates); the adaptive step is
    two RHS passes plus the trial states and the error."""
    f = 15 * nnz + 3 * Np + 10 * Mp
    return f if fixed else 2 * f + 6 * Np + 20 * Mp


def ode_chunk_bound(fa, B, steps, fixed):
    """B1 and B2 over a chunk: the state (v, xs, xl, dt in float32, done)
    read and written once, the tables read once; operations for every
    step of every trajectory (no row is done in the timed inputs)."""
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, nnz_of(fa)
    nbytes = 2 * B * (4 * (Np + 2 * Mp + 1) + 1) + table_bytes(K, Mp, Np, nnz)
    return bound(nbytes, B * steps * ode_step_ops(nnz, Np, Mp, fixed))


def rhs_pass_bound(fa, B, itemsize=4):
    """B10, one RHS pass: v, xs, xl in; dv, dxs, dxl, allsat out."""
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, nnz_of(fa)
    nbytes = 2 * itemsize * B * (Np + 2 * Mp) + B + table_bytes(K, Mp, Np, nnz)
    return bound(nbytes, B * (15 * nnz + 5 * Mp))


def stoch_step_ops(nnz, Np, Mp):
    """One stoch step of one chain: per literal slot 2 (its truth and the
    OR), per clause 3 (the weight update), per occurrence 3 (the weight
    and two adds), per variable 14 (the counter hash, the draw, the
    flip)."""
    return 5 * nnz + 3 * Mp + 14 * Np


def stoch_chunk_bound(fa, B, steps):
    """B3 and B4 over a chunk: v (bytes), xl (int32) and done read and
    written once, the tables once."""
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, nnz_of(fa)
    nbytes = 2 * B * (Np + 4 * Mp + 1) + table_bytes(K, Mp, Np, nnz)
    return bound(nbytes, B * steps * stoch_step_ops(nnz, Np, Mp))


def shard_bound(spec, B, mode):
    """B5, one launch over a shard (Mp its clause count): rhs reads v, xs,
    xl and writes dv, dxs, dxl, sat; fixed reads v, dt, xs, xl and writes
    dv, xs, xl, sat; second reads hv, dt, adv, xs, xl, dxs1, dxl1 and
    writes dv, xs, xl, the error."""
    Np, Mp = spec.Np, spec.Mp
    nnz = int(spec.occ_code.numel())
    words = {"rhs": (Np + 2 * Mp) + (Np + 2 * Mp + 1),
             "fixed": (Np + 1 + 2 * Mp) + (Np + 2 * Mp + 1),
             "second": (Np + 1 + 4 * Mp) + (Np + 2 * Mp + 1)}[mode]
    nbytes = 4 * B * words + (B if mode == "second" else 0) + table_bytes(spec.K, Mp, Np, nnz)
    ops = {"rhs": 15 * nnz + 5 * Mp, "fixed": 15 * nnz + 10 * Mp,
           "second": 15 * nnz + 20 * Mp}[mode]
    return bound(nbytes, B * ops)


def stoch_shard_bound(spec, B):
    """B8, one launch over a shard: v (bytes), active and xl in; the two
    (B, Np) partial sums, xl and the sat flag out."""
    Np, Mp = spec.Np, spec.Mp
    nnz = int(spec.occ_clause.numel())
    nbytes = B * Np + B + 4 * B * Mp + 8 * B * Np + 4 * B * Mp + B + \
        table_bytes(spec.K, Mp, Np, nnz)
    return bound(nbytes, B * (5 * nnz + 3 * Mp))


def shard_chunk_bound(spec, B):
    """B6, one fixed ``step`` launch with the apply prologue: reads v, the
    reduced (B, Np+1) buffer, done, xs and xl; writes v, the new partial
    (B, Np+1), done, xs and xl; B5's fixed operations plus the v update."""
    Np, Mp = spec.Np, spec.Mp
    nnz = int(spec.occ_code.numel())
    nbytes = 2 * (4 * B * (2 * Np + 1 + 2 * Mp) + B) + table_bytes(spec.K, Mp, Np, nnz)
    return bound(nbytes, B * (15 * nnz + 10 * Mp + 3 * Np))


def stoch_shard_chunk_bound(spec, B):
    """B9, one launch with the flip prologue: reads v (bytes), the reduced
    (B, 2*Np+1) buffer, done and xl; writes v, the new partials, done and
    xl; B8's operations plus the counter hash, draw and flip per
    variable."""
    Np, Mp = spec.Np, spec.Mp
    nnz = int(spec.occ_clause.numel())
    nbytes = 2 * (B * Np + 4 * B * (2 * Np + 1) + B + 4 * B * Mp) + \
        table_bytes(spec.K, Mp, Np, nnz)
    return bound(nbytes, B * (5 * nnz + 3 * Mp + 14 * Np))


def config7_instance():
    """run_benchmarks.py config 7: locally structured 3-SAT, n=10240,
    m=43700, locality 512, seed 9 (compile_stream_sharded: K=3, Np=10240,
    Mp=43,776 at S=1, 21,888 clauses a shard at S=2), as generated (the
    DIMACS variables, before normalization)."""
    from odesat_tpu_torch.utils.generate import random_local_ksat

    return random_local_ksat(10240, 43700, k=3, locality=512, seed=9)


def load_shard_cases(specs, card):
    """Phase 3's formulas compiled for S=1 and S=2, and the config 7
    instance at S=2 and S=1 (B=256), S=1 last."""
    from odesat_tpu_torch.cnf import normalize_cnf_variables
    from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded

    out = []
    for label, formula, bucket, B in specs:
        for S in (1, 2):
            out.append((f"{label} S={S}", compile_stream_sharded(formula, S, bucket=bucket)[0], B))
    t0 = time.perf_counter()
    c7 = config7_instance()
    normalized = normalize_cnf_variables(c7)[1]
    fa7 = compile_stream_sharded(normalized, 1)[0]
    fa7_2 = compile_stream_sharded(normalized, 2)[0]
    say(f"[config 7] instance and its S=1 and S=2 compiles in {time.perf_counter() - t0:.3f} s: "
        f"Np={fa7.n_vars_padded}, Mp={fa7.n_clauses_padded}, K={fa7.max_width}, "
        f"{fa7_2.shard_plan.mp_local} clauses a shard at S=2 (host; {card})")
    # B=256: the shape family's checks at a quarter of the CLI runs' rows
    out.append(("config 7 S=2 B=256", fa7_2, 256))
    out.append(("config 7 S=1 B=256", fa7, 256))
    return out, c7, fa7, fa7_2


def shard_inputs(torch, fa, B, seed):
    """Random B5 inputs for one shard on the card: v, xs, xl, dt, adv,
    dxs1, dxl1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ml = fa.shard_plan.mp_local

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to("cuda", dtype)

    return dict(v=put(rng.uniform(-1, 1, (B, fa.n_vars_padded))),
                xs=put(rng.uniform(0.001, 0.999, (B, ml))), xl=put(rng.uniform(1, 50, (B, ml))),
                dt=put(rng.uniform(0, 0.05, B)), adv=put(rng.random(B) < 0.7, torch.bool),
                dxs1=put(rng.uniform(-1, 1, (B, ml))), dxl1=put(rng.uniform(-1, 1, (B, ml))))


SHARD_MODES = ("rhs", "fixed", "second")


SHARD_KEYS = {"rhs": ("v", "xs", "xl"), "fixed": ("v", "dt", "xs", "xl"),
              "second": ("v", "dt", "adv", "xs", "xl", "dxs1", "dxl1")}
TILE_FILL = {"xs": 0.5, "xl": 1.0, "adv": False}  # the runner's padding rows


def shard_call(ss, mode, inp, spec, plain=False):
    """B5's row-major wrapper (tile, launch, untile) or its plain version
    in ``mode``."""
    fn = {"rhs": (ss.shard_rhs, ss.shard_rhs_plain), "fixed": (ss.shard_fixed, ss.shard_fixed_plain),
          "second": (ss.shard_second, ss.shard_second_plain)}[mode][plain]
    return fn(*(inp[k] for k in SHARD_KEYS[mode]), spec)


def tile_grid(B, n):
    """csrc/tile.cuh's grid of CTAs of 128 threads over ceil(B/32) tiles
    and an axis of n items (spans of 16 items: 4 lane groups of 32, 4
    items each)."""
    return (-(-B // 32), max(1, min(-(-n // 16), 65535)))


def phase_shard_compare(torch, ss, shard_cases):
    """B5 vs its plain version, exactly, every shard of every case and the
    ragged batches: three modes, both rigidity gates, f32 and bf16; then
    two launches at config 7 bit-identical."""
    from odesat_tpu_torch.utils.config import ODEConfig

    worst, n = 0.0, 0
    for label, fa, B in shard_cases + ragged_cases(shard_cases):
        for s in range(fa.shard_plan.n_shards):
            inp = shard_inputs(torch, fa, B, seed=B + s)
            for rigidity in ("paper", "reference"):
                for mm in ("float32", "bfloat16"):
                    ode = ODEConfig(step_size=0.01, rigidity=rigidity, matmul_dtype=mm)
                    spec = ss.shard_spec(fa, ode.resolve_zeta(fa.density), ode, "cuda", s)
                    for mode in SHARD_MODES:
                        out = shard_call(ss, mode, inp, spec)
                        ref = shard_call(ss, mode, inp, spec, plain=True)
                        torch.cuda.synchronize()
                        for a, b in zip(out, ref):
                            if not torch.equal(a, b):
                                err = (a.float() - b.float()).abs().max().item()
                                fail(f"B5 vs plain, {label} shard {s} {mode} {rigidity} {mm}: "
                                     f"off by {err}")
                        n += 1
            say(f"[B5 compare] {label} shard {s}/{fa.shard_plan.n_shards} B={B}: rhs, fixed, "
                f"second x paper, reference x f32, bf16 equal (max abs err 0.0), grid: pass "
                f"{tile_grid(B, fa.n_vars_padded)}, pad {tile_grid(B, spec.pads.numel())} CTAs "
                f"of 128 threads, nothing of a trajectory in shared memory")
    label, fa7, B = shard_cases[-1]
    inp = shard_inputs(torch, fa7, B, seed=7)
    ode = ODEConfig(step_size=0.01)
    spec = ss.shard_spec(fa7, ode.resolve_zeta(fa7.density), ode, "cuda", 0)
    for mode in ("fixed", "second"):
        a, b = shard_call(ss, mode, inp, spec), shard_call(ss, mode, inp, spec)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"B5 determinism, {label} {mode}: two launches differ")
        say(f"[B5 determinism] {label} {mode}: two launches bit-identical")
    say(f"[B5 compare] {n} cases equal to the plain version")
    return 0.0


def stoch_shard_inputs(torch, fa, B, shard, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    ml = fa.shard_plan.mp_local
    return (torch.as_tensor(rng.random((B, fa.n_vars_padded)) < 0.5, device="cuda"),
            torch.as_tensor(rng.integers(1, 3001, (B, ml)).astype(np.int32), device="cuda"),
            torch.as_tensor(rng.random(B) < 0.8, device="cuda"))


def phase_stoch_shard_compare(torch, sc, shard_cases):
    """B8 vs its plain version, exactly, every shard of every case and the
    ragged batches, f32 and bf16; then two launches at config 7
    bit-identical. Returns the max abs error (0.0: anything else fails)."""
    n = 0
    for label, fa, B in shard_cases + ragged_cases(shard_cases):
        for s in range(fa.shard_plan.n_shards):
            v, xl, active = stoch_shard_inputs(torch, fa, B, s, seed=B + s)
            for mm in ("float32", "bfloat16"):
                ev = sc.make_stoch_shard_eval(fa, "cuda", s, mm)
                out = ev(v, xl, active)
                ref = sc.stoch_shard_eval_plain(v, xl, active, ev.spec, mm == "bfloat16")
                torch.cuda.synchronize()
                for a, b in zip(out, ref):
                    if not torch.equal(a, b):
                        fail(f"B8 vs plain, {label} shard {s} {mm}: differs")
                n += 1
            say(f"[B8 compare] {label} shard {s}/{fa.shard_plan.n_shards} B={B}: f32, bf16 equal "
                f"(max abs err 0.0), grid: clause {tile_grid(B, ev.spec.Mp)}, var "
                f"{tile_grid(B, ev.spec.Np)} CTAs of 128 threads, nothing of a chain in shared "
                f"memory")
    label, fa7, B = shard_cases[-1]
    v, xl, active = stoch_shard_inputs(torch, fa7, B, 0, seed=9)
    ev = sc.make_stoch_shard_eval(fa7, "cuda", 0)
    a, b = ev(v, xl, active), ev(v, xl, active)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"B8 determinism, {label}: two launches differ")
    say(f"[B8 determinism] {label}: two launches bit-identical")
    say(f"[B8 compare] {n} cases equal to the plain version")
    return 0.0


def chunk_buffers(torch, fa, B, fixed, seed):
    """Random B6 buffers for one shard on the card: a state with some rows
    done and a partial whose sat count is 0 on some rows (adaptive: acc2
    with the error in its last column), the sums a group of one reads."""
    import numpy as np

    from odesat_tpu_torch.ops.shard_chunk import ChunkBuffers

    rng = np.random.default_rng(seed)
    Np, ml = fa.n_vars_padded, fa.shard_plan.mp_local

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to("cuda", dtype)

    acc = rng.uniform(-2, 2, (B, Np + 1))
    acc[:, Np] = rng.integers(0, 3, B)
    b = ChunkBuffers(put(rng.uniform(-1, 1, (B, Np))), put(rng.uniform(0.001, 0.999, (B, ml))),
                     put(rng.uniform(1, 50, (B, ml))), put(rng.uniform(0.01, 0.05, B)),
                     put(rng.random(B) < 0.2, torch.bool), put(acc))
    if not fixed:
        acc2 = rng.uniform(-2, 2, (B, Np + 1))
        acc2[:, Np] = rng.uniform(0, 1e-2, B)
        b = b._replace(acc2=put(acc2), dxs1=put(rng.uniform(-1, 1, (B, ml))),
                       dxl1=put(rng.uniform(-1, 1, (B, ml))))
    return b


def chunk_parts(torch, b, S, seed):
    """S partials (rank order) of acc and acc2 as a clause mesh of S ranks
    hands them to B6's next launch, which adds them in the butterfly's
    tree (None at S = 1: the launch reads its own acc, acc2): magnitudes
    from 1e-3 to 1e5 on which rank order and tree order round differently,
    each rank's sat count 0 or 1, each rank's error non-negative."""
    import numpy as np

    if S == 1:
        return None
    rng = np.random.default_rng(seed)
    B, Np = b.acc.shape[0], b.acc.shape[1] - 1

    def draw(flag):
        out = []
        for _ in range(S):
            a = rng.uniform(-1, 1, b.acc.shape) * 10.0 ** rng.integers(-3, 6, b.acc.shape)
            a[:, Np] = flag()
            out.append(torch.as_tensor(a.astype(np.float32), device="cuda"))
        return out

    p1 = draw(lambda: rng.integers(0, 2, B) * (rng.random(B) < 0.7))
    return p1, None if b.acc2 is None else draw(lambda: rng.uniform(0, 1e-2, B))


def tiled_parts(parts):
    from odesat_tpu_torch.ops.tiles import tile

    return None if parts is None else tuple(None if p is None else [tile(t) for t in p]
                                            for p in parts)


CHUNK_PHASES = {"fixed": (("step", False), ("step", True), ("apply", False)),
                "adaptive": (("first", False), ("first", True), ("half", False),
                             ("commit", False))}


def tiled(b):
    """Tiled copies of (B, X) chunk buffers, as the runner lays them out."""
    from odesat_tpu_torch.ops.tiles import tile

    return type(b)(*(None if t is None else tile(t) for t in b))


def untiled(b, B):
    from odesat_tpu_torch.ops.tiles import untile

    return type(b)(*(None if t is None else untile(t, B) for t in b))


def ragged_cases(shard_cases):
    """B6's and B9's ragged batches: the widths 2,3,5 formula at S=2 with
    B = 1, 7 and 33 (a part-filled last tile of 32)."""
    fa = next(fa for label, fa, _ in shard_cases if label == "widths 2,3,5 n=300 m=1200 S=2")
    return [(f"widths 2,3,5 n=300 m=1200 S=2 B={B}", fa, B) for B in (1, 7, 33)]


def phase_shard_chunk_compare(torch, sch, ss, shard_cases):
    """B6 vs its plain version, exactly, every shard of every case (and
    the ragged batches): each phase of both integrators with and without
    the apply prologue, both rigidity gates, f32 and bf16, the kernel on
    the tiled buffers, reading its own partials (S = 1, a group of one) or
    S = 2 and S = 4 ranks' partials, which its kernels add in the
    butterfly's tree as they read them (B7 fused); then two launches at
    config 7 bit-identical."""
    from odesat_tpu_torch.utils.config import ODEConfig

    n = 0
    for label, fa, B in shard_cases + ragged_cases(shard_cases):
        for s in range(fa.shard_plan.n_shards):
            for mode, phases in CHUNK_PHASES.items():
                fixed = mode == "fixed"
                # one draw a shard and integrator: the plain version writes
                # nothing, the kernel runs on tiled copies
                b = chunk_buffers(torch, fa, B, fixed, seed=B + 10 * s + fixed)
                for rigidity, S in (("paper", 1), ("reference", 2), ("paper", 4)):
                    parts = chunk_parts(torch, b, S, seed=B + 10 * s + S)
                    for mm in ("float32", "bfloat16"):
                        ode = ODEConfig(step_size=0.01 if fixed else None, rigidity=rigidity,
                                        matmul_dtype=mm)
                        spec = ss.shard_spec(fa, ode.resolve_zeta(fa.density), ode, "cuda", s)
                        for ph, apply in phases:
                            ref = sch.shard_chunk_plain(ph, b, spec, apply, parts)
                            out = untiled(sch.shard_chunk_cuda(ph, tiled(b), spec, apply,
                                                               parts=tiled_parts(parts)), B)
                            torch.cuda.synchronize()
                            for name, x, y in zip(b._fields, out, ref):
                                if not ((x is None and y is None) or torch.equal(x, y)):
                                    err = (x.float() - y.float()).abs().max().item()
                                    fail(f"B6 vs plain, {label} shard {s} {ph} apply={apply} "
                                         f"{rigidity} {mm} S={S}: {name} off by {err}")
                            n += 1
            say(f"[B6 compare] {label} shard {s}/{fa.shard_plan.n_shards} B={B}: step, apply, "
                f"first, half, commit (with and without the prologue) x paper reading its own "
                f"partials (S=1), reference reading 2 ranks' partials, paper reading 4 (B7 "
                f"fused) x f32, bf16 equal (max abs err 0.0)")
    label, fa7, B = shard_cases[-1]
    for mode, phases in CHUNK_PHASES.items():
        ode = ODEConfig(step_size=0.01 if mode == "fixed" else None)
        spec = ss.shard_spec(fa7, ode.resolve_zeta(fa7.density), ode, "cuda", 0)
        b = chunk_buffers(torch, fa7, B, mode == "fixed", seed=8)
        for ph, apply in phases:
            x = sch.shard_chunk_cuda(ph, tiled(b), spec, apply)
            y = sch.shard_chunk_cuda(ph, tiled(b), spec, apply)
            torch.cuda.synchronize()
            if not all((p is None and q is None) or torch.equal(p, q) for p, q in zip(x, y)):
                fail(f"B6 determinism, {label} {ph}: two launches differ")
        say(f"[B6 determinism] {label} {mode}: two launches of every phase bit-identical")
    say(f"[B6 compare] {n} cases equal to the plain version")
    return 0.0


def stoch_sums(torch, fa, B, rng):
    """A (B, 2*Np+1) buffer of B9's integer sums with unsat <= total and a
    sat count of 0 or 1, on the card."""
    import numpy as np

    Np = fa.n_vars_padded
    acc = rng.integers(0, 60000, (B, 2 * Np + 1)).astype(np.float32)
    acc[:, Np:2 * Np] = np.minimum(acc[:, Np:2 * Np], acc[:, :Np]) * rng.integers(0, 2, (B, Np))
    acc[:, 2 * Np] = rng.integers(0, 2, B)
    return torch.as_tensor(acc, device="cuda")


def stoch_chunk_inputs(torch, fa, B, seed):
    """Random B9 inputs for one shard: v, xl up to 3000, done, and a
    reduced buffer of integer sums with unsat <= total."""
    import numpy as np

    rng = np.random.default_rng(seed)
    Np, ml = fa.n_vars_padded, fa.shard_plan.mp_local
    acc = stoch_sums(torch, fa, B, rng)
    return (torch.as_tensor(rng.random((B, Np)) < 0.5, device="cuda"),
            torch.as_tensor(rng.integers(1, 3001, (B, ml)).astype(np.int32), device="cuda"),
            torch.as_tensor(rng.random(B) < 0.2, device="cuda"), acc)


STOCH_CHUNK_CASES = ((False, True), (True, True), (True, False))  # (apply, evaluate)


def phase_stoch_shard_chunk_compare(torch, sc, shard_cases):
    """B9 vs its plain version, exactly, every shard (and the ragged
    batches): with and without the flip prologue and flip-only, f32 reading
    its own partials (a group of one), bf16 reading 2 ranks' partials and
    f32 reading 4 (as on a clause mesh: its kernels sum them in the
    butterfly's tree), the kernel on tiled chains; then two launches at
    config 7 bit-identical."""
    import numpy as np

    from odesat_tpu_torch.ops.tiles import tile, untile

    n = 0
    for label, fa, B in shard_cases + ragged_cases(shard_cases):
        for s in range(fa.shard_plan.n_shards):
            spec = sc.stoch_shard_spec(fa, "cuda", s)
            inp = stoch_chunk_inputs(torch, fa, B, seed=B + 10 * s)  # one draw a shard
            for i, (apply, evaluate) in enumerate(STOCH_CHUNK_CASES):
                for mm, S in (("float32", 1), ("bfloat16", 2), ("float32", 4)):
                    args = (spec, mm == "bfloat16", 987654 + i, sc.traj_block(B), 5, apply,
                            evaluate)
                    parts = None  # S = 1: the launch reads its own partials
                    if S > 1:  # S ranks' partials, summed by the launch's kernels
                        rng = np.random.default_rng(B + 10 * s + S + 100 * i)
                        parts = [stoch_sums(torch, fa, B, rng) for _ in range(S)]
                    ref = sc.stoch_shard_step_plain(*inp, *args, parts=parts)
                    out = sc.stoch_shard_step_cuda(*(tile(t) for t in inp), *args,
                                                   parts=None if parts is None else
                                                   [tile(p) for p in parts])
                    torch.cuda.synchronize()
                    for name, x, y in zip(("v", "xl", "done", "acc"), out, ref):
                        if not torch.equal(untile(x, B), y):
                            fail(f"B9 vs plain, {label} shard {s} apply={apply} "
                                 f"evaluate={evaluate} {mm} S={S}: {name} differs")
                    n += 1
            say(f"[B9 compare] {label} shard {s}/{fa.shard_plan.n_shards} B={B}: with and "
                f"without the flip prologue, flip-only x f32 reading its own partials (S=1), "
                f"bf16 reading 2 ranks' partials, f32 reading 4 (B7 fused) equal (max abs err "
                f"0.0)")
    label, fa7, B = shard_cases[-1]
    spec = sc.stoch_shard_spec(fa7, "cuda", 0)
    inp = stoch_chunk_inputs(torch, fa7, B, seed=9)
    args = (spec, False, 4321, sc.traj_block(B), 5, True, True)
    x = sc.stoch_shard_step_cuda(*(tile(t) for t in inp), *args)
    y = sc.stoch_shard_step_cuda(*(tile(t) for t in inp), *args)
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(x, y)):
        fail(f"B9 determinism, {label}: two launches differ")
    say(f"[B9 determinism] {label}: two launches bit-identical")
    say(f"[B9 compare] {n} cases equal to the plain version")
    return 0.0


def config7_path(c7):
    """Write the config 7 instance as DIMACS where phases 20, 26 and 29
    read it; returns the path."""
    from odesat_tpu_torch.cnf import cnf_to_dimacs

    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "local_n10240_m43700.cnf")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(cnf_to_dimacs(c7))
    return path


def run_cli_mesh(cmd, args):
    """The CLI with a mesh flag: the kernels launch in the spawned ranks,
    which report their counts (parallel/launch.last_reports)."""
    from odesat_tpu_torch.parallel import launch

    launch.last_reports = []
    verdict, _, steps, solved, seconds, out = run_cli({}, cmd, args)
    return verdict, launch.last_reports, steps, solved, seconds, out


def b7_checks(shape7, dtype=None):
    """B7 against its plain version (parallel/dist.all_reduce_error, bit
    for bit), as calls of a run_all world: ragged lengths 1, 7, 33*1025
    and the full (1024, Np+1) buffer of config 7, each with and without a
    max zone, then 1000 back-to-back calls on fresh data (the race run).
    ``dtype`` None: the float32 form; torch.float64: the float64 form, on
    partials that also hold infinities of both signs."""
    from odesat_tpu_torch.parallel.dist import all_reduce_error

    extra = () if dtype is None else (dtype,)
    calls = []
    for i, shape in enumerate(((1,), (7,), (33 * 1025,), shape7)):
        n = math.prod(shape)
        # the full buffer's max zone is B6's: each tile's error row, 32 words of (Np+1)*32
        zones = (shape[1] * 32, 32) if shape == shape7 else (min(n, shape[-1]), min(n, 3))
        calls.append((all_reduce_error, (shape, 10 + i, None, 1, *extra)))
        calls.append((all_reduce_error, (shape, 20 + i, zones, 1, *extra)))
    calls.append((all_reduce_error, ((33, 1025), 30, (1025, 1), 1000, *extra)))
    return calls


def phase_mesh_main(torch, fa7_1, fa7_2, c7, uf250_formula, card, loop_calls):
    """Phase 20: the clause-mesh main path (gloo ranks sharing the card,
    B7 fused into B6's and B9's launches, its standalone call in B5's and
    B8's steps) and the trajectory mesh; returns the launches of B5, B6, B8,
    B9, B7's standalone calls and B7's fused launches summed over the ranks
    of the main-path runs, B7's numbers at S=2 (phase 21's: ms a call,
    the plain version's, the gloo all-reduce's, the call's split, the
    clause-mesh steps, timed in this phase's world; the largest error of its
    checks, the race runs' among them), and phase 28's: ``loop_calls`` run
    last in this world, their values and each one's launch counts on each
    rank (:func:`phase_mesh_loop` reports them). The
    CLI runs on the config 7 instance are 64 steps (B6) and 32 (B9); the
    CLI's stoch mesh solve through B9 and those through B5 and B8 (16 steps
    each), the parity checks (256 rows for the ODE, 32 steps for stoch) and
    B7's checks run in one spawned world with the trajectory mesh's run and
    the timings: every spawn pays its ranks' start-up."""
    import numpy as np

    from odesat_tpu_torch import cli
    from odesat_tpu_torch.cnf import evaluate_cnf, map_values_by_indices, normalize_cnf_variables
    from odesat_tpu_torch.parallel import launch, sharded

    c7_path = config7_path(c7)
    uf_path = os.path.join(OUT, "uf250_seed0.cnf")  # written by phase 5
    easy = os.path.join(ROOT, "tests", "data", "easy.cnf")
    gloo = ["--clause-shards", "2", "--dist-backend", "gloo"]
    off = ["--shard-chunk", "off"]
    totals = {"shard_stream": 0, "shard_chunk": 0, "stoch_shard_eval": 0, "stoch_shard_chunk": 0,
              "butterfly": 0, "butterfly_fused": 0}
    c7_inter = ["-f", c7_path, "-b", "1024", "-s", "0.01", "--seed", "0"]
    c7_stoch = ["-f", c7_path, "--no-preprocess", "-b", "1024", "--seed", "0"]
    # the per-step paths (B5, B8) run fewer steps than the default chunk kernels (B6, B9)
    runs = (
        # label, subcommand, args, kernel, B, expected verdict (None: false after the budget
        # or a solved trajectory that verifies)
        ("a. inter uf250 B=4096", "inter",
         ["-f", uf_path, "-b", "4096", "-s", "0.01", "-n", "20000", "--seed", "0"],
         "shard_chunk", 4096, "true"),
        ("b. inter config 7 B=1024", "inter", c7_inter + ["-n", "64"], "shard_chunk", 1024,
         None),
        ("c. stoch easy.cnf B=256", "stoch", ["-f", easy, "-b", "256", "-n", "20000", "--seed", "1"],
         "stoch_shard_chunk", 256, "true"),
    )
    for label, cmd, args, kernel, B, want in runs:
        t_run = time.perf_counter()
        verdict, reports, steps, solved, seconds, _ = run_cli_mesh(cmd, [*args, *gloo])
        t_run = time.perf_counter() - t_run
        counts = [r[kernel] for r in reports]
        fused = [r["butterfly_fused"] for r in reports]
        others = {k: [r[k] for r in reports] for k in totals
                  if k not in (kernel, "butterfly_fused")}
        say(f"[mesh main] {label} --clause-shards 2 (gloo for the host's decisions, B7 fused "
            f"into the launches): verdict {verdict}, {solved} solved after {steps} steps in "
            f"{seconds:.6f} s = {B * steps / seconds:.6e} steps*rows/s, {kernel} launches per "
            f"rank {counts}, of them reading both ranks' slots (B7 fused) {fused}, standalone "
            f"B7 calls and other clause kernels {others}, v replicated (every rank checked "
            f"it); the whole run {t_run:.1f} s ({card})")
        if len(counts) != 2 or min(counts) == 0 or min(fused) == 0:
            fail(f"{label}: {kernel} or B7 fused was not launched on both ranks")
        if any(sum(c) for c in others.values()):
            fail(f"{label}: another clause kernel than {kernel}, or a standalone B7 call, ran")
        if want == "true" and verdict != "true":
            fail(f"{label}: the port did not verify a satisfying assignment")
        budget = int(args[args.index("-n") + 1])
        if want is None and not (verdict == "false" and steps == budget and solved == 0) and \
                not (solved and verdict == "true"):
            fail(f"{label}: expected false after exactly {budget} steps or a verified solution")
        totals[kernel] += sum(counts)
        totals["butterfly_fused"] += sum(fused)
        MESH_STARTUP[label] = t_run - seconds

    # b. the ODE clause mesh at S=2 against the S=1 runner, row for row, c.
    # the stoch clause path at S=2 against S=1, flip for flip, e. the
    # trajectory mesh T=2 against T=1, and phase 21's all-reduce: one world
    from odesat_tpu_torch.interop import state_from_numpy
    from odesat_tpu_torch.ops import shard_stream as ss
    from odesat_tpu_torch.utils.config import ODEConfig

    t0 = time.perf_counter()
    B = 256  # rows enough for a row-for-row check; the CLI runs above are the full batch
    rng = np.random.default_rng(31)
    v0 = rng.uniform(-1, 1, (B, fa7_2.n_vars_padded)).astype(np.float32)
    dt0, done0 = np.full(B, 0.01, np.float32), np.zeros(B, bool)

    def layout(fa):
        xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
        return v0, xs, np.ones_like(xs), dt0, done0

    arrays2 = layout(fa7_2)
    odes = (("fixed", ODEConfig(step_size=0.01), 8), ("adaptive", ODEConfig(), 4))
    zeta = odes[0][1].resolve_zeta(fa7_2.density)
    cases = [(fa7_2, zeta, ode, n, arrays2) for _, ode, n in odes]
    cases += [(fa7_2, zeta, ODEConfig(step_size=ode.step_size, shard_chunk="off"), n, arrays2)
              for _, ode, n in odes]
    stoch_modes = (("auto", "stoch_shard_chunk"), ("off", "stoch_shard_eval"))
    from odesat_tpu_torch.models.ode import simulate_batch
    from odesat_tpu_torch.parallel.dist import (
        time_all_reduce,
        time_butterfly,
        time_butterfly_split,
    )
    from odesat_tpu_torch.utils.config import SolverConfig

    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=20000), batch_size=4096, seed=0)
    shape7 = (1024, fa7_1.n_vars_padded + 1)  # B6's (B, Np+1) buffer at config 7, B=1024
    calls = [(sharded.run_ode_cases, (cases,))]
    calls += [(sharded.run_stoch_clause, (fa7_2, 4, 8, 5, "float32", 1024, mode))
              for mode, _ in stoch_modes]
    calls += [(launch.on_mesh, ((2, 1), cli._mesh_solve, "ode", uf250_formula, config,
                                {"stop_on": "any"})),
              (time_all_reduce, (shape7, 10)), (time_butterfly, (shape7, 20, 2)),
              (mesh_step_ms, (fa7_2,))]
    # b, c through B5 and B8: the CLI's mesh solves with --shard-chunk off,
    # in this world rather than a world each (a spawn costs its ranks'
    # start-up, most of it importing torch)
    off_runs = (("b. inter", "inter", c7_inter + ["-n", "16"] + off + gloo, "shard_stream"),
                ("c. stoch", "stoch", c7_stoch + ["-n", "16"] + off + gloo, "stoch_shard_eval"))
    calls += [cli.mesh_call([cmd, *args]) for _, cmd, args, _ in off_runs]
    # 23 in this world: the hybrid at S=2 through B6 and B9, and S=2 snapshots
    # resumed on S=2 (whole, stopped and resumed runs of inter and stoch)
    hybrid_argv = ["hybrid", "-f", uf_path, "-b", "4096", "-s", "0.01", "--seed", "0",
                   "--no-preprocess", *gloo]
    resume_runs = mesh_resume_argv()
    calls += [cli.mesh_call(hybrid_argv)]
    calls += [cli.mesh_call([*argv, *gloo]) for _, argv in resume_runs]
    races = race_calls(2)
    calls += races + [(time_butterfly_split, (shape7, 20)), (mesh_chunk_peaks, (fa7_2,))]
    # c. stoch config 7 through B9: the CLI's mesh solve, in this world
    c7_stoch_argv = ["stoch", *c7_stoch, "-n", "32", *gloo]
    calls += [cli.mesh_call(c7_stoch_argv)]
    checks = b7_checks(shape7)
    calls += checks
    # the per-step chunks captured against host-paced, then phase 28's and
    # 29's calls, last: their values and each one's counts on each rank
    capture = capture_calls(fa7_2, 2)
    values = launch.spawn(launch.run_all, 1, 2, "gloo", "cuda", timeout_s=600,
                          args=([*calls, *capture, *loop_calls],))
    n, m = len(calls), len(capture)
    loop_values = values[n + m:]
    loop_reports = [[r["calls"][i] for r in launch.last_reports]
                    for i in range(n + m, n + m + len(loop_calls))]
    capture_reports = [[r["calls"][i] for r in launch.last_reports] for i in range(n, n + m)]
    capture_values = values[n:n + m]
    main_chunks = sum(r["calls"][i]["mesh_step_chunk"] for r in launch.last_reports
                      for i in (7, 8))
    values = values[:n]
    for r in launch.last_reports:
        r["calls"] = r["calls"][:n]
    two, stoch_two = values[0], values[1:3]
    traj_two, allreduce_ms, (b7_ms, b7_plain), steps_two, b_off, c_off, hyb_two = values[3:10]
    n_resume = len(resume_runs)
    resumed_two = values[10:10 + n_resume]
    race_two = values[10 + n_resume:10 + n_resume + len(races)]
    split_two = values[10 + n_resume + len(races)]
    peaks_two = values[11 + n_resume + len(races)]
    c7_stoch_two = values[12 + n_resume + len(races)]
    b7_errs = values[13 + n_resume + len(races):]
    # run_all zeroes every count before each call: each call's launches per rank
    per_call = [{k: [r["calls"][i][k] for r in launch.last_reports]
                 for k in (*totals, "fused_chunk")} for i in range(len(calls))]
    if any(sum(c["butterfly"]) for c in [per_call[1], per_call[9],
                                          *per_call[10:10 + n_resume + len(races)]]):
        fail(f"a B6 or B9 chunk at S=2 made a standalone B7 call: {per_call}")
    # B6 and B9 at S=2 read the peers' slots themselves (butterfly_fused) and
    # make no standalone B7 call; B5 and B8 sum through the standalone call
    ran = (("shard_chunk", "shard_stream", "butterfly", "butterfly_fused"),
           ("stoch_shard_chunk", "butterfly_fused"), ("stoch_shard_eval", "butterfly"),
           ("fused_chunk",), (), ("butterfly",),
           ("shard_chunk", "shard_stream", "stoch_shard_chunk", "stoch_shard_eval", "butterfly",
            "butterfly_fused"),
           ("shard_stream", "butterfly"), ("stoch_shard_eval", "butterfly"),
           ("shard_chunk", "stoch_shard_chunk", "butterfly_fused"),
           *((("shard_chunk", "butterfly_fused") if argv[0] == "inter" else
              ("stoch_shard_chunk", "butterfly_fused")) for _, argv in resume_runs),
           *((kernel, "butterfly_fused") for kernel in RACE_KERNELS), ("butterfly",),
           ("shard_chunk", "stoch_shard_chunk", "butterfly_fused"),
           ("stoch_shard_chunk", "butterfly_fused"),
           *((("butterfly",),) * len(checks)))
    for i, (kernels, counts) in enumerate(zip(ran, per_call)):
        if any(len(counts[k]) != 2 or min(counts[k]) == 0 for k in kernels) or \
                any(sum(c) for k, c in counts.items() if k not in kernels):
            fail(f"the parity world's call {i}: expected {kernels or 'no kernel'} on both ranks "
                 f"and nothing else, launches per rank {counts}")
    for (label, cmd, args, kernel), result, counts in zip(off_runs, (b_off, c_off), per_call[7:]):
        budget = int(args[args.index("-n") + 1])
        if result.steps != budget or result.done.any():
            fail(f"{label} config 7 --shard-chunk off: expected no solve after exactly {budget} "
                 f"steps, got {int(result.done.sum())} after {result.steps}")
        totals[kernel] += sum(counts[kernel])
        totals["butterfly"] += sum(counts["butterfly"])
        say(f"[mesh main] {label} config 7 B=1024 --shard-chunk off --clause-shards 2 (the "
            f"CLI's mesh solve, cli.mesh_call, in the parity world): no row solved after "
            f"exactly {budget} steps, {kernel} launches per rank {counts[kernel]}, their sums "
            f"through B7's standalone call {counts['butterfly']} ({card})")
    i_c7 = 12 + n_resume + len(races)
    counts, fused = per_call[i_c7]["stoch_shard_chunk"], per_call[i_c7]["butterfly_fused"]
    mapping = normalize_cnf_variables(c7)[0]
    if c7_stoch_two.solved_index is not None:
        if not evaluate_cnf(map_values_by_indices(mapping, c7_stoch_two.best_assignment()), c7):
            fail("c. stoch config 7 at S=2: the solved row does not satisfy the formula")
    elif c7_stoch_two.steps != 32:
        fail(f"c. stoch config 7 at S=2: expected no solve after exactly 32 steps or a "
             f"verified solution, got {c7_stoch_two.steps} steps")
    totals["stoch_shard_chunk"] += sum(counts)
    totals["butterfly_fused"] += sum(fused)
    say(f"[mesh main] c. stoch config 7 B=1024 --no-preprocess --clause-shards 2 (the CLI's "
        f"mesh solve, cli.mesh_call, in the parity world; B7 fused into the launches): "
        f"{int(c7_stoch_two.done.sum())} solved after {c7_stoch_two.steps} steps, "
        f"stoch_shard_chunk launches per rank {counts}, of them reading both ranks' slots (B7 "
        f"fused) {fused}, no other clause kernel and no standalone B7 call ({card})")
    p2, p1 = fa7_2.shard_plan, fa7_1.shard_plan

    def by_clause(x, plan, dtype=np.float32):
        out = np.zeros((x.shape[0], int(p1.clause_of.max()) + 1), dtype)
        out[:, plan.clause_of[plan.clause_of >= 0]] = x[:, plan.clause_of >= 0]
        return out

    worst = 0.0
    for i, (mode, ode, n) in enumerate(odes):
        one = ss.make_single_device_runner(fa7_1, zeta, ode, n, "cuda")(
            state_from_numpy(*layout(fa7_1), device="cuda"))
        one = [t.cpu().numpy() for t in one]
        for path, out in (("B6", two[i]), ("B5", two[i + 2])):
            pairs = ((out[0], one[0]), (by_clause(out[1], p2), by_clause(one[1], p1)),
                     (by_clause(out[2], p2), by_clause(one[2], p1)))
            for name, (a, b) in zip(("v", "xs", "xl"), pairs):
                if not (np.isfinite(a).all() and np.allclose(a, b, **F32_TOL)):
                    fail(f"config 7 {mode} {path} S=2 vs S=1: {name} off by "
                         f"{np.abs(a - b).max()}")
                worst = max(worst, float(np.abs(a - b).max()))
            if not (np.array_equal(out[4], one[4]) and np.allclose(out[3], one[3], rtol=2e-4,
                                                                    atol=2e-6)):
                fail(f"config 7 {mode} {path} S=2 vs S=1: done or dt differ")
            if not np.array_equal(out[5][0], out[5][1]):
                fail(f"config 7 {mode} {path}: the clause ranks' v differ")
        for a, b in zip(two[i][:5], two[i + 2][:5]):
            if not np.array_equal(a, b):
                fail(f"config 7 {mode} S=2: B6 differs from B5")
    say(f"[mesh main] b. inter's clause mesh config 7 B={B} at S=2 (gloo), fixed 8 steps and "
        f"adaptive 4, through B6 and B5: equal to the S=1 runner row for row within rtol 2e-4 / "
        f"atol 2e-5 (max abs err {worst:.6e}; xs, xl clause by clause; done exact), B6 equal "
        f"to B5 bit for bit, both ranks' v bit-identical ({card})")
    for (mode, kernel), two_s in zip(stoch_modes, stoch_two):
        one = sharded.run_stoch_clause(None, "cuda", fa7_1, 4, 8, 5, "float32", 1024, mode)
        if not (np.array_equal(two_s[0], one[0]) and np.array_equal(two_s[2], one[2])
                and np.array_equal(by_clause(two_s[1], p2, np.int64),
                                   by_clause(one[1], p1, np.int64))):
            fail(f"stoch clause path ({kernel}): S=2 differs from S=1")
        say(f"[mesh main] c. stoch clause path config 7 B=1024, 32 steps through {kernel}: "
            f"S=2 (gloo) equals S=1 flip for flip (v, xl clause by clause, done; "
            f"{int(two_s[0].sum())} variables true, max weight {int(two_s[1].max())}) ({card})")
    # e. trajectory mesh: T=2 through B1 equals T=1 row for row
    one = simulate_batch(uf250_formula, config, device="cuda", stop_on="any")
    two = traj_two
    if not (np.array_equal(two.assignment, one.assignment) and np.array_equal(two.done, one.done)
            and two.steps == one.steps):
        rows = int((two.assignment != one.assignment).any(axis=1).sum())
        fail(f"trajectory mesh T=2 differs from T=1: {rows} rows, steps {two.steps} vs "
             f"{one.steps}, done {int(two.done.sum())} vs {int(one.done.sum())}")
    e_graphs = [r["calls"][3]["device_loop_mesh"] for r in launch.last_reports]
    if min(e_graphs) == 0:
        fail(f"e. the trajectory mesh's dispatches made no mesh device-loop graph launch: "
             f"{e_graphs}")
    totals["device_loop_mesh"] = sum(e_graphs)
    say(f"[mesh main] e. inter --devices 2 uf250 B=4096 (the same world as a 2x1 mesh): equals "
        f"T=1 row for row ({one.steps} steps, {int(one.done.sum())} solved), B1 launches per "
        f"rank {per_call[3]['fused_chunk']}, through the mesh device loop (graph launches per "
        f"rank {e_graphs})")
    race_err = report_races(2, race_two, per_call[10 + n_resume:10 + n_resume + len(races)],
                            card)
    b7_err = report_b7_checks(2, checks, b7_errs, per_call[-len(checks):], card)
    if totals["butterfly"] == 0 or totals["butterfly_fused"] == 0:
        fail("B7 was not launched: fused into B6's and B9's launches, standalone in B5's and "
             "B8's steps")
    say(f"[mesh main] b, c, e, B7's checks and the timings: one world of two ranks, launches "
        f"per rank and call {per_call}, in {time.perf_counter() - t0:.1f} s; B7: "
        f"{totals['butterfly_fused']} B6 and B9 launches reading both ranks' slots in the CLI "
        f"mesh runs, {totals['butterfly']} standalone calls in the --shard-chunk off solves "
        f"(both ranks) ({card})")
    phase_mesh_hybrid_and_resume(hyb_two, per_call[9], uf_path, resume_runs, resumed_two,
                                 per_call[10:10 + n_resume], totals, card)
    say(b7_split_line(2, split_two, card))
    say(mesh_step_line(2, steps_two, card))
    say(mesh_peaks_line(2, peaks_two, card))
    captured, capture_err, _ = report_capture("20", 2, capture_values, capture_reports, card)
    if main_chunks == 0:
        fail("b, c --shard-chunk off: B5's and B8's chunks ran no captured graph")
    totals["mesh_step_chunk"] = main_chunks
    b7 = {"S=2": {"ms": b7_ms, "plain_ms": b7_plain, "library_ms": allreduce_ms,
                  "steps": steps_two, "split": split_two, "err": max(b7_err, race_err),
                  "capture": captured, "capture_err": capture_err}}
    return totals, b7, (loop_values, loop_reports)


RACE_KERNELS = ("shard_chunk", "shard_chunk", "stoch_shard_chunk")
# the race runs' length: B6 fixed and B9 this many steps, B6 adaptive half
RACE_STEPS = 128


def race_calls(S):
    """The race runs of a world of S ranks (parallel/sharded.fused_against_plain):
    B6 fixed (RACE_STEPS) and adaptive (half of them) and B9 (RACE_STEPS), 64 rows,
    on a random 3-SAT of n=300, m=1200 compiled for S shards, each one chunk
    on the card with no host sync against its plain version."""
    from odesat_tpu_torch.cnf import normalize_cnf_variables
    from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded
    from odesat_tpu_torch.parallel import sharded
    from odesat_tpu_torch.utils.generate import random_ksat

    fa = compile_stream_sharded(normalize_cnf_variables(random_ksat(300, 1200, seed=12))[1],
                                S)[0]
    return [(sharded.fused_against_plain, (fa, "ode", True, RACE_STEPS, 64, 1)),
            (sharded.fused_against_plain, (fa, "ode", False, RACE_STEPS // 2, 64, 2)),
            (sharded.fused_against_plain, (fa, "stoch", True, RACE_STEPS, 64, 3))]


def report_races(S, values, counts, card):
    """Fail unless every race run equals its plain version bit for bit with
    v replicated, and its chunk read the S slots itself on every launch but
    the first (no standalone call); print them; return the largest error."""
    for (err, same), count, kernel, what in zip(values, counts, RACE_KERNELS,
                                                ("B6 fixed", "B6 adaptive", "B9")):
        launched = count[kernel]
        if err != 0.0 or not same or count["butterfly"] != [0] * S or \
                count["butterfly_fused"] != [n - 1 for n in launched]:
            fail(f"race run {what} at S={S}: max abs err {err} against the plain version, v "
                 f"replicated {same}, launches {launched}, fused {count['butterfly_fused']}, "
                 f"standalone B7 {count['butterfly']}")
    say(f"[B7 fused] S={S} ranks on one card, the race runs (one chunk with no host sync, 64 "
        f"rows of a 3-SAT n=300 m=1200): B6 fixed {RACE_STEPS} steps, adaptive "
        f"{RACE_STEPS // 2} and B9 {RACE_STEPS} steps "
        f"equal their plain versions bit for bit (max abs err {max(v[0] for v in values)}), v "
        f"bit-identical on every rank, every launch after a chunk's first reading the {S} "
        f"ranks' slots itself, no standalone B7 call ({card})")
    return max(v[0] for v in values)


def report_b7_checks(S, checks, errs, counts, card, dtype=None):
    """Fail unless every B7 check read 0 and launched the kernel (the
    float32 form, or ``dtype``'s) once a call on every rank; print them;
    return the largest error."""
    key, form = ("butterfly", "") if dtype is None else ("butterfly_f64", " (float64 form)")
    for (_, (shape, _, zones, n, *_)), err, count in zip(checks, errs, counts):
        if err != 0.0 or count[key] != [n] * S:
            fail(f"B7{form} at S={S}, {shape} zones {zones}, {n} calls: max abs err {err} "
                 f"against the plain version, launches per rank {count[key]}")
    shapes = sorted({str(c[1][0]) for c in checks})
    say(f"[B7 compare] S={S} ranks on one card: B7{form} equals its plain version bit for bit "
        f"(max abs err {max(errs)}; a NaN equal to any NaN) at {', '.join(shapes)}, each with and "
        f"without a max zone, and over {checks[-1][1][3]} back-to-back calls on fresh data at "
        f"{checks[-1][1][0]}, every call's result on every rank ({card})")
    return max(errs)


def phase_mesh_s4(torch, fa7_1, c7, b7_two, card):
    """Phase 20f: the clause mesh at S=4 in one more spawned world of four
    gloo ranks on the card: inter (B6) and stoch (B9) on config 7 through
    the CLI's mesh solve, the ODE clause mesh (fixed 8 steps, adaptive 4,
    256 rows) through B6 and through B5 against the S=1 runner row for row
    with v bit-identical on the four clause ranks and B5 equal to B6 bit for
    bit, the stoch clause path through B9 and through B8 against S=1 flip
    for flip, the race runs, B7's checks, timings and split and the mesh
    steps at S=4; returns the launches per kernel summed over the ranks of
    the CLI runs and B7's numbers at S=4."""
    import numpy as np

    from odesat_tpu_torch import cli
    from odesat_tpu_torch.cnf import evaluate_cnf, map_values_by_indices, normalize_cnf_variables
    from odesat_tpu_torch.interop import state_from_numpy
    from odesat_tpu_torch.ops import shard_stream as ss
    from odesat_tpu_torch.parallel import launch, sharded
    from odesat_tpu_torch.parallel.dist import (
        time_all_reduce,
        time_butterfly,
        time_butterfly_split,
    )
    from odesat_tpu_torch.utils.config import ODEConfig

    t0 = time.perf_counter()
    mapping, normalized = normalize_cnf_variables(c7)
    fa7_4 = ss.compile_stream_sharded(normalized, 4)[0]
    c7_path = os.path.join(OUT, "local_n10240_m43700.cnf")  # written by phase 20
    mesh4 = ["--clause-shards", "4", "--dist-backend", "gloo"]
    runs = (("inter", ["-f", c7_path, "-b", "1024", "-s", "0.01", "--seed", "0", "-n", "64"],
             "shard_chunk"),
            ("stoch", ["-f", c7_path, "--no-preprocess", "-b", "1024", "--seed", "0", "-n",
                       "32"], "stoch_shard_chunk"))
    with contextlib.redirect_stdout(io.StringIO()):
        calls = [cli.mesh_call([cmd, *args, *mesh4]) for cmd, args, _ in runs]
    B = 256
    rng = np.random.default_rng(31)
    v0 = rng.uniform(-1, 1, (B, fa7_4.n_vars_padded)).astype(np.float32)

    def layout(fa):
        xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
        return v0, xs, np.ones_like(xs), np.full(B, 0.01, np.float32), np.zeros(B, bool)

    odes = (("fixed", ODEConfig(step_size=0.01), 8), ("adaptive", ODEConfig(), 4))
    zeta = odes[0][1].resolve_zeta(fa7_4.density)
    calls.append((sharded.run_ode_cases, ([(fa7_4, zeta, ode, n, layout(fa7_4))
                                           for _, ode, n in odes],)))
    calls.append((sharded.run_stoch_clause, (fa7_4, 4, 8, 5, "float32", 1024, "auto")))
    shape7 = (1024, fa7_1.n_vars_padded + 1)
    calls += [(time_all_reduce, (shape7, 10)), (time_butterfly, (shape7, 20, 2))]
    # B5 and B8, whose sums take B7's standalone call: B5 equal to B6, B8 to S=1
    calls.append((sharded.run_ode_cases, ([(fa7_4, zeta, ODEConfig(
        step_size=ode.step_size, shard_chunk="off"), n, layout(fa7_4)) for _, ode, n in odes],)))
    calls.append((sharded.run_stoch_clause, (fa7_4, 4, 8, 5, "float32", 1024, "off")))
    races = race_calls(4)
    calls += races + [(time_butterfly_split, (shape7, 20)), (mesh_step_ms, (fa7_4,))]
    checks = b7_checks(shape7)
    checks64 = b7_checks(shape7, torch.float64)  # the float64 form (the twin's clause step)
    calls += checks + checks64
    capture = capture_calls(fa7_4, 4)
    values = launch.spawn(launch.run_all, 1, 4, "gloo", "cuda", timeout_s=600,
                          args=([*calls, *capture],))
    capture_values = values[len(calls):]
    capture_reports = [[r["calls"][i] for r in launch.last_reports]
                       for i in range(len(calls), len(calls) + len(capture))]
    values = values[:len(calls)]
    names = ("shard_chunk", "stoch_shard_chunk", "shard_stream", "stoch_shard_eval", "butterfly",
             "butterfly_f64", "butterfly_fused")
    per_call = [{k: [r["calls"][i][k] for r in launch.last_reports] for k in names}
                for i in range(len(calls))]
    totals = {"shard_chunk": 0, "stoch_shard_chunk": 0, "butterfly_fused": 0}
    for (cmd, args, kernel), result, counts in zip(runs, values[:2], per_call[:2]):
        budget = int(args[args.index("-n") + 1])
        if min(counts[kernel]) == 0 or min(counts["butterfly_fused"]) == 0 or \
                sum(counts["butterfly"]):
            fail(f"{cmd} config 7 at S=4: {kernel} or B7 fused not launched on every rank, or "
                 f"a standalone B7 call: {counts}")
        if result.solved_index is not None:
            if not evaluate_cnf(map_values_by_indices(mapping, result.best_assignment()), c7):
                fail(f"{cmd} config 7 at S=4: the solved row does not satisfy the formula")
        elif result.steps != budget:
            fail(f"{cmd} config 7 at S=4: expected no solve after exactly {budget} steps or a "
                 f"solved row that verifies, got {result.steps} steps")
        totals[kernel] += sum(counts[kernel])
        totals["butterfly_fused"] += sum(counts["butterfly_fused"])
        say(f"[mesh S=4] {cmd} config 7 B=1024 --clause-shards 4 (four gloo ranks on one card, "
            f"the CLI's mesh solve): {int(result.done.sum())} solved after {result.steps} "
            f"steps, {kernel} launches per rank {counts[kernel]}, of them reading the four "
            f"ranks' slots (B7 fused) {counts['butterfly_fused']}, standalone B7 calls "
            f"{counts['butterfly']}, v replicated (every rank checked it) ({card})")
    worst = 0.0
    for (mode, ode, n), out, off in zip(odes, values[2], values[6]):
        if not all(np.array_equal(a, b) for a, b in zip(out[:5], off[:5])):
            fail(f"config 7 {mode} S=4: B5 (sums through B7's standalone call) differs from B6")
        one = ss.make_single_device_runner(fa7_1, zeta, ode, n, "cuda")(
            state_from_numpy(*layout(fa7_1), device="cuda"))
        one = [t.cpu().numpy() for t in one]
        if not (np.isfinite(out[0]).all() and np.allclose(out[0], one[0], **F32_TOL)):
            fail(f"config 7 {mode} S=4 vs S=1: v off by {np.abs(out[0] - one[0]).max()}")
        worst = max(worst, float(np.abs(out[0] - one[0]).max()))
        if not (np.array_equal(out[4], one[4]) and np.allclose(out[3], one[3], rtol=2e-4,
                                                                atol=2e-6)):
            fail(f"config 7 {mode} S=4 vs S=1: done or dt differ")
        if not all(np.array_equal(c, out[5][0]) for c in out[5]):
            fail(f"config 7 {mode} S=4: the clause ranks' v differ")
    if sum(per_call[2]["butterfly"]) or min(per_call[6]["butterfly"]) == 0:
        fail(f"config 7 S=4: B6 made a standalone B7 call, or B5 none: {per_call[2]}, "
             f"{per_call[6]}")
    say(f"[mesh S=4] inter's clause mesh config 7 B={B} at S=4, fixed 8 steps and adaptive 4 "
        f"through B6 (B7 fused): v equal to the S=1 runner row for row within rtol 2e-4 / atol "
        f"2e-5 (max abs err {worst:.6e}; done exact), the four clause ranks' v bit-identical; "
        f"through B5 (sums by B7's standalone call, {per_call[6]['butterfly']} a rank) equal to "
        f"B6 bit for bit ({card})")
    one = sharded.run_stoch_clause(None, "cuda", fa7_1, 4, 8, 5, "float32", 1024, "auto")
    for what, four in (("B9, B7 fused", values[3]), ("B8, B7 standalone", values[7])):
        if not (np.array_equal(four[0], one[0]) and np.array_equal(four[2], one[2])):
            fail(f"stoch clause path config 7 at S=4 through {what} differs from S=1")
        say(f"[mesh S=4] stoch clause path config 7 B=1024, 32 steps through {what}: S=4 "
            f"equals S=1 flip for flip (v, done; {int(four[0].sum())} variables true) ({card})")
    if sum(per_call[3]["butterfly"]) or min(per_call[7]["butterfly"]) == 0:
        fail(f"config 7 S=4: B9 made a standalone B7 call, or B8's path none: {per_call[3]}, "
             f"{per_call[7]}")
    allreduce_ms, (b7_ms, b7_plain) = values[4], values[5]
    n = 8 + len(races)
    race_err = report_races(4, values[8:n], per_call[8:n], card)
    split, steps = values[n], values[n + 1]
    m = n + 2 + len(checks)
    b7_err = report_b7_checks(4, checks, values[n + 2:m], per_call[n + 2:m], card)
    b7_two["S=4 f64"] = report_b7_checks(4, checks64, values[m:], per_call[m:], card,
                                         torch.float64)
    say(b7_split_line(4, split, card))
    say(mesh_step_line(4, steps, card))
    captured, capture_err, _ = report_capture("20f", 4, capture_values, capture_reports, card)
    say(f"[mesh S=4] one world of four ranks in {time.perf_counter() - t0:.1f} s ({card})")
    b7_two["S=4"] = {"ms": b7_ms, "plain_ms": b7_plain, "library_ms": allreduce_ms,
                     "steps": steps, "split": split, "err": max(b7_err, race_err),
                     "capture": captured, "capture_err": capture_err}
    return totals


def mesh_resume_argv():
    """Phase 23's S=2 snapshot runs, for phase 20's world: inter (B6) and
    stoch --no-preprocess (B9) on hard.cnf B=1024, 16-step chunks, a
    snapshot every chunk: 64 steps whole, 32 stopped, 32 more resumed."""
    hard = os.path.join(ROOT, "tests", "data", "hard.cnf")
    folder = os.path.join(OUT, "mesh_resume")
    os.makedirs(folder, exist_ok=True)
    runs = []
    for cmd, extra in (("inter", ["-s", "0.01"]), ("stoch", ["--no-preprocess"])):
        for name, steps, resume in (("whole", 64, None), ("part", 32, None),
                                    ("resumed", 64, "part")):
            path = os.path.join(folder, f"{cmd}_{name}.npz")
            argv = [cmd, "-f", hard, "-b", "1024", "--seed", "0", "--chunk-steps", "16",
                    "-n", str(steps), *extra, "--checkpoint", path, "--checkpoint-every", "1"]
            if resume:
                argv += ["--resume", os.path.join(folder, f"{cmd}_{resume}.npz")]
            runs.append((path, argv))
    return runs


def same_snapshot(a, b):
    """The keys of two snapshot files on which they differ (none: equal)."""
    import numpy as np

    with np.load(a) as x, np.load(b) as y:
        if sorted(x.files) != sorted(y.files):
            return ["the key lists"]
        return [k for k in x.files if not np.array_equal(x[k], y[k])]


def phase_mesh_hybrid_and_resume(hyb, hyb_counts, uf_path, resume_runs, results, counts,
                                 totals, card):
    """Phase 23's mesh part, from phase 20's world: the hybrid on uf250 at
    S=2 verifies through B6 and B9; each S=2 resumed run ends in the very
    snapshot of the run that never stopped; the S=2 snapshots are refused
    on S=1 with the JAX package's message."""
    from odesat_tpu_torch import cli
    from odesat_tpu_torch.cnf import (
        evaluate_cnf,
        map_values_by_indices,
        normalize_cnf_variables,
        parse_dimacs_file,
    )

    formula = parse_dimacs_file(uf_path)
    mapping, _ = normalize_cnf_variables(formula)
    ok = evaluate_cnf(map_values_by_indices(mapping, hyb.assignment), formula)
    say(f"[mesh hybrid] hybrid uf250 B=4096 --no-preprocess --clause-shards 2 (gloo): winner "
        f"{hyb.engine} after {hyb.steps} steps per engine, verdict {str(ok).lower()}, B6 "
        f"launches per rank {hyb_counts['shard_chunk']}, B9 {hyb_counts['stoch_shard_chunk']}, "
        f"B7 fused {hyb_counts['butterfly_fused']} ({card})")
    if not (hyb.solved and ok):
        fail("the hybrid on uf250 at S=2 did not verify a satisfying assignment")
    for name in ("shard_chunk", "stoch_shard_chunk", "butterfly_fused"):
        totals[name] += sum(hyb_counts[name])
    for i in range(0, len(resume_runs), 3):
        (whole, argv), (part, _), (resumed, _) = resume_runs[i:i + 3]
        steps = [r.steps for r in results[i:i + 3]]
        bad = same_snapshot(whole, resumed)
        kernel = "shard_chunk" if argv[0] == "inter" else "stoch_shard_chunk"
        if steps != [64, 32, 64] or bad:
            fail(f"{argv[0]} at S=2: the resumed run's snapshot differs from the whole run's "
                 f"in {bad} (steps {steps})")
        what = "ODE" if argv[0] == "inter" else "stoch"
        axes = " clause axis of the" if what == "ODE" else ""
        want = (f"cannot resume this {what} snapshot: it was taken on a (traj=1, clause=2) mesh "
                f"but this run uses (traj=1, clause=1); resume with the same{axes} "
                "--devices/--clause-shards layout")
        err = io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            try:
                cli.main([*argv[:argv.index("--checkpoint")], "--resume", part])
                code = 0
            except SystemExit as e:
                code = e.code
        if code != 2 or want not in err.getvalue():
            fail(f"the S=2 {what} snapshot was not refused on S=1 as JAX refuses it: exit "
                 f"{code}, {err.getvalue().strip()}")
        launched = [c[kernel] for c in counts[i:i + 3]]
        say(f"[mesh resume] {argv[0]} hard.cnf B=1024 --clause-shards 2 (gloo), 16-step "
            f"chunks, a snapshot every chunk: stopped at 32 steps and resumed to 64, the final "
            f"snapshot (v, xs/xl whole, done, steps, generator states) equals the uninterrupted "
            f"run's bit for bit; {kernel} launches per rank and run {launched}; on S=1 refused: "
            f"{want!r} ({card})")
        for path, _ in resume_runs[i:i + 3]:
            os.remove(path)


def phase_nccl_world_of_one(torch, fa7):
    """20d: the clause step (B5) and the clause-sharded chunk (B6)
    through an NCCL process group of one rank equal the mesh-free B5 runner
    bit for bit."""
    import tempfile

    import torch.distributed as dist

    from odesat_tpu_torch.ops import shard_chunk as sch
    from odesat_tpu_torch.ops import shard_stream as ss
    from odesat_tpu_torch.parallel.mesh import Mesh
    from odesat_tpu_torch.parallel.multihost import initialize_distributed
    from odesat_tpu_torch.utils.config import ODEConfig

    tmp = tempfile.mkdtemp(prefix="odesat_nccl_")
    initialize_distributed("nccl", "cuda", rank=0, world_size=1,
                           store_path=os.path.join(tmp, "store"), timeout_s=120)
    try:
        mesh = Mesh(1, 1)
        for ode in (ODEConfig(step_size=0.01), ODEConfig()):
            zeta = ode.resolve_zeta(fa7.density)
            grouped = ss.make_clause_chunk(
                ss.make_fused_clause_step(fa7, zeta, ode, mesh.clause_group, "cuda"), 16)
            chunk = sch.make_shard_chunk(fa7, zeta, ode, 16, mesh.clause_group, "cuda")
            alone = ss.make_single_device_runner(fa7, zeta, ode, 16, "cuda")
            state = random_state(fa7, 1024, seed=21)
            a, c, b = grouped(copied(state)), chunk(copied(state)), alone(state)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                fail("the clause step over an NCCL world of one differs from the B5 runner")
            if not all(torch.equal(x, y) for x, y in zip(c, b)):
                fail("the B6 chunk over an NCCL world of one differs from the B5 runner")
            say(f"[mesh main] d. config 7 B=1024 {'fixed' if ode.step_size else 'adaptive'}, "
                "16 steps: the clause step (B5) and the B6 chunk over an NCCL world of one "
                "equal the mesh-free B5 runner bit for bit")
    finally:
        dist.destroy_process_group()


def phase_shard_timing(torch, ss, sch, sc, fa7, b7, card):
    """Phase 21 at the config 7 instance, B=1024, S=1: B5 fixed and second
    and B8 per launch on tiled buffers allocated once (as their runners
    run them) and through their row-major wrappers, B6's fixed step and B9
    per launch (kernel and plain in turns, CUDA events, beside the bound;
    B6 and B9 on the tiled buffers their runners make), the single-device
    runner's (B5) and the B6 chunk's throughput, the stoch clause path
    through B8 and through B9 with the uniform draw's share of a B8-path
    step, and B7 at S=2 and S=4 (timed in phase 20's worlds) beside its
    plain version, its bound and the gloo all-reduce it replaces."""
    from odesat_tpu_torch.models.stoch import init_stoch_state
    from odesat_tpu_torch.ops.tiles import tile
    from odesat_tpu_torch.parallel import sharded
    from odesat_tpu_torch.utils.config import ODEConfig
    from odesat_tpu_torch.utils.timing import cuda_ms

    B = 1024
    ode = ODEConfig(step_size=0.01)
    zeta = ode.resolve_zeta(fa7.density)
    spec = ss.shard_spec(fa7, zeta, ode, "cuda", 0)
    inp = shard_inputs(torch, fa7, B, seed=3)
    tiled_inp = {k: tile(x, fill=TILE_FILL.get(k, 0)) for k, x in inp.items()}
    scratch = ss.ShardScratch(spec, tiled_inp["v"].shape[0])  # allocated once, as the runner does
    times = {}
    for mode in ("fixed", "second"):
        args = [inp[k] for k in SHARD_KEYS[mode]]
        kern = {"fixed": ss.shard_fixed, "second": ss.shard_second}[mode]
        plain = {"fixed": ss.shard_fixed_plain, "second": ss.shard_second_plain}[mode]
        held = dict(tiled_inp)

        def launch():  # the new clause memories come back in the other copy, as in the runner
            out = ss.shard_stream_cuda(mode, spec, **{k: held[k] for k in SHARD_KEYS[mode]},
                                       scratch=scratch)
            held["xs"], held["xl"] = out[1], out[2]

        def kernel_turn():
            return cuda_ms(launch, iters=20, warmup=2)

        def plain_turn():
            return cuda_ms(lambda: plain(*args, spec), 2, warmup=1)

        p1, k1, k2, p2 = plain_turn(), kernel_turn(), kernel_turn(), plain_turn()
        rows = cuda_ms(lambda: kern(*args, spec), iters=10, warmup=1)
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        b, by = shard_bound(spec, B, mode)
        times[mode] = (k, p, b, by)
        old = ONE_CTA_MS[f"B5 config 7 {mode}"]
        say(f"[B5 timing] config 7 B={B} S=1 {mode} f32, one launch on tiled buffers: B5 "
            f"{k1:.6f} / {k2:.6f} ms (the one-CTA-a-trajectory kernel: {old:.6f} ms, "
            f"{old / k:.3f}x), through the row-major wrapper (tile, launch, untile) "
            f"{rows:.6f} ms, plain {p1:.6f} / {p2:.6f} ms ({p / k:.3f}x), bound {b:.6f} ms by "
            f"{by} ({b / k:.3f} of it) ({card})")
    v, xl, active = stoch_shard_inputs(torch, fa7, B, 0, seed=4)
    ev = sc.make_stoch_shard_eval(fa7, "cuda", 0)
    vt, xlt, donet = tile(v), tile(xl, fill=1), tile(~active, fill=True)
    acc8 = torch.empty((vt.shape[0], 2 * ev.spec.Np + 1, vt.shape[-1]), device="cuda")
    w8 = torch.empty_like(xlt)  # B8's buffers, allocated once, as the runner does

    def b8_turn():  # the weights of active chains move in place: they stay below the cap
        return cuda_ms(lambda: ev.tiled(vt, xlt, donet, acc8, w8), iters=20, warmup=2)

    def b8_plain():
        return cuda_ms(lambda: sc.stoch_shard_eval_plain(v, xl, active, ev.spec, False), 2,
                       warmup=1)

    p1, k1, k2, p2 = b8_plain(), b8_turn(), b8_turn(), b8_plain()
    rows = cuda_ms(lambda: ev(v, xl, active), iters=10, warmup=1)
    k, p = (k1 + k2) / 2, (p1 + p2) / 2
    b, by = stoch_shard_bound(ev.spec, B)
    times["b8"] = (k, p, b, by)
    old = ONE_CTA_MS["B8 config 7"]
    say(f"[B8 timing] config 7 B={B} S=1 f32, one launch on tiled buffers: B8 {k1:.6f} / "
        f"{k2:.6f} ms (the one-CTA-a-chain kernel: {old:.6f} ms, {old / k:.3f}x), through the "
        f"row-major wrapper (tile, launch, untile) {rows:.6f} ms, plain {p1:.6f} / {p2:.6f} ms "
        f"({p / k:.3f}x), bound {b:.6f} ms by {by} ({b / k:.3f} of it) ({card})")

    # B6: one fixed step launch with the apply prologue, in place
    spec6 = ss.shard_spec(fa7, zeta, ode, "cuda", 0)
    b = chunk_buffers(torch, fa7, B, True, seed=6)
    b = b._replace(done=torch.zeros_like(b.done), acc=b.acc.index_fill(1, torch.tensor(
        [spec6.Np], device="cuda"), 1.0))  # no row latches done while timed
    bt = [tiled(b)]
    scratch = sch.chunk_scratch(bt[0], spec6)  # allocated once, as the runner does

    def b6_step():  # a step returns the clause memories in the other copy
        bt[0] = sch.shard_chunk_cuda("step", bt[0], spec6, True, scratch)

    def b6_turn():
        return cuda_ms(b6_step, iters=20, warmup=2)

    def b6_plain():
        return cuda_ms(lambda: sch.shard_chunk_plain("step", b, spec6, True), 2, warmup=1)

    p1, k1, k2, p2 = b6_plain(), b6_turn(), b6_turn(), b6_plain()
    k, p = (k1 + k2) / 2, (p1 + p2) / 2
    bb, by = shard_chunk_bound(spec6, B)
    times["b6"] = (k, p, bb, by)
    say(f"[B6 timing] config 7 B={B} S=1 fixed f32, one step launch (apply + fixed pass): B6 "
        f"{k1:.6f} / {k2:.6f} ms, plain {p1:.6f} / {p2:.6f} ms ({p / k:.3f}x), bound "
        f"{bb:.6f} ms by {by} ({bb / k:.3f} of it) ({card})")

    # B9: one launch with the flip prologue, in place
    spec9 = sc.stoch_shard_spec(fa7, "cuda", 0)
    v9, xl9, done9, acc9 = stoch_chunk_inputs(torch, fa7, B, seed=10)
    done9.zero_()
    acc9[:, 2 * spec9.Np] = 1.0
    args9 = (spec9, False, 5555, sc.traj_block(B), 1, True, True)
    t9 = [tile(t) for t in (v9, xl9, done9, acc9)]
    w9 = torch.empty_like(t9[1])  # the weight scratch, as the runner allocates it once

    def b9_turn():
        return cuda_ms(lambda: sc.stoch_shard_step_cuda(*t9, *args9, w=w9), iters=20, warmup=2)

    def b9_plain():
        return cuda_ms(lambda: sc.stoch_shard_step_plain(v9, xl9, done9, acc9, *args9), 2,
                       warmup=1)

    p1, k1, k2, p2 = b9_plain(), b9_turn(), b9_turn(), b9_plain()
    k, p = (k1 + k2) / 2, (p1 + p2) / 2
    bb, by = stoch_shard_chunk_bound(spec9, B)
    times["b9"] = (k, p, bb, by)
    say(f"[B9 timing] config 7 B={B} S=1 f32, one launch (flip + evaluation): B9 {k1:.6f} / "
        f"{k2:.6f} ms, plain {p1:.6f} / {p2:.6f} ms ({p / k:.3f}x), bound {bb:.6f} ms by {by} "
        f"({bb / k:.3f} of it) ({card})")

    state = random_state(fa7, B, seed=5)
    rates = {}
    for name, run in (("B5 runner", ss.make_single_device_runner(fa7, zeta, ode, 64, "cuda")),
                      ("B6 chunk", sch.make_shard_chunk(fa7, zeta, ode, 64, None, "cuda"))):
        state = run(state)  # each call consumes its input and returns it advanced
        torch.cuda.synchronize()
        rates[name] = []
        for _ in range(2):
            t0 = time.perf_counter()
            state = run(state)
            torch.cuda.synchronize()
            rates[name].append(B * 64 / (time.perf_counter() - t0))
        r = rates[name]
        say(f"[{name}] config 7 B={B} S=1 fixed f32, 64-step chunk: {r[0]:.6e} / {r[1]:.6e} "
            f"traj*steps/s (the counterpart of local3sat_n10240_shard_rhs) ({card})")
    # the stoch clause path at S=1: B8 with the flips and their uniforms in
    # torch ('off'), and B9 ('auto'), 64-step chunks from the all-false start
    chains = {}
    for name, mode in (("B8 path", "off"), ("B9 chunk", "auto")):
        run = sharded.make_clause_stoch_runner(fa7, 64, "cuda", torch.Generator().manual_seed(7),
                                               None, "float32", mode)
        s0 = init_stoch_state(fa7, B, "cuda")
        s0 = run(s0)
        torch.cuda.synchronize()
        chains[name] = []
        for _ in range(2):
            t0 = time.perf_counter()
            s0 = run(s0)
            torch.cuda.synchronize()
            chains[name].append(B * 64 / (time.perf_counter() - t0))
    G, Np = -(-B // 32), fa7.n_vars_padded
    uniforms = sc.TiledUniforms(G, sc.traj_block(B), Np, "cuda")  # B8's runner's, a shape
    u_ms = cuda_ms(lambda: uniforms.draw(12345, 3), iters=20, warmup=2)
    step_ms = B / max(chains["B8 path"]) * 1e3
    a, c = chains["B8 path"], chains["B9 chunk"]
    say(f"[stoch clause runners] config 7 B={B} S=1 f32, 64-step chunks: through B8 (flips "
        f"drawn in torch, on tiled chains) {a[0]:.6e} / {a[1]:.6e} chain*steps/s, through B9 "
        f"{c[0]:.6e} / {c[1]:.6e}; the counter-hash uniforms of one B8-path step "
        f"(TiledUniforms.draw into its held buffers, as the runner draws them) "
        f"{u_ms:.6f} ms (CUDA events), {u_ms / step_ms:.3f} of its {step_ms:.6f} ms ({card})")
    times["stoch_runner"] = chains
    # B5's and the B8 path's chunks captured against the same steps from
    # Python, with the host's share of each under torch.profiler
    times["capture"] = {}
    for label, kind, o in (("B5 fixed", "B5", ode), ("B8", "B8", None)):
        r = times["capture"][label] = captured_against_host_paced(
            None, "cuda", kind, fa7, o, B, CAPTURE_STEPS, profiled=PROFILED_CHUNKS)
        check_capture(f"21 {label} S=1", r)
        say(capture_line(f"21 config 7 B={B} S=1 {label}", r, CAPTURE_STEPS, card))
    # B7 at (B, Np+1) f32: S partials read and one result written, a rank
    nbytes = 4 * B * (fa7.n_vars_padded + 1)
    for S in (2, 4):
        r = b7[f"S={S}"]
        r["bound_ms"] = (S + 1) * nbytes / HBM_BYTES_PER_S * 1e3
        say(f"[B7 timing] config 7 B={B} (B, Np+1) = {nbytes} B f32 at S={S}, {S} ranks sharing "
            f"the card: B7 {r['ms']:.6f} ms a call (host clock around 20 calls ending in a sync "
            f"on every rank), plain version (gloo gather, tree on the host) "
            f"{r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms by bytes ((S+1) x {nbytes} B "
            f"over 3.35 TB/s; {r['bound_ms'] / r['ms']:.3f} of it), the gloo all-reduce it "
            f"replaces (library) {r['library_ms']:.6f} ms ({r['library_ms'] / r['ms']:.3f}x) "
            f"({card})")
    for S in (2, 4):
        st = b7[f"S={S}"]["steps"]
        say(f"[mesh timing] config 7 B={B} S={S} ({S} ranks sharing the card), ms a step: "
            f"inter fixed through B6 (B7 fused) {st['B6']:.6f}, through B5 (B7 standalone, "
            f"--shard-chunk off) {st['B5']:.6f}; stoch through B9 (B7 fused) {st['B9']:.6f}, "
            f"through B8 (B7 standalone) {st['B8']:.6f}; beside B6's S=1 step "
            f"{times['b6'][0]:.6f} and B7's standalone call {b7[f'S={S}']['ms']:.6f} ({card})")
    # B7 fused: B6's closing apply launch (the apply prologue and the head,
    # v and done from the sums) reading its own partial (S=1) or S ranks'
    # partials, which its kernels add in the tree (buffers of this process)
    b_ap = chunk_buffers(torch, fa7, B, True, seed=11)
    fused = {}
    for S in (1, 2, 4):
        parts = chunk_parts(torch, b_ap, S, seed=40 + S)
        tp, bt = tiled_parts(parts), tiled(b_ap)
        sc_ap = sch.chunk_scratch(bt, spec6)

        def go():
            sch.shard_chunk_cuda("apply", bt, spec6, False, sc_ap, tp)

        def go_plain():
            return sch.shard_chunk_plain("apply", b_ap, spec6, False, parts)

        p1, k1, k2, p2 = (cuda_ms(go_plain, 2, warmup=1), cuda_ms(go, iters=20, warmup=2),
                          cuda_ms(go, iters=20, warmup=2), cuda_ms(go_plain, 2, warmup=1))
        nb = 2 * 4 * B * fa7.n_vars_padded + S * nbytes + 2 * B
        fused[S] = ((k1 + k2) / 2, (p1 + p2) / 2, nb / HBM_BYTES_PER_S * 1e3, "bytes")
        say(f"[B7 fused] config 7 B={B} B6's apply launch (apply + head) reading {S} "
            f"partial(s) of {nbytes} B: {k1:.6f} / {k2:.6f} ms (CUDA events), plain "
            f"{p1:.6f} / {p2:.6f} ms, bound {fused[S][2]:.6f} ms by bytes ({nb} B: v read and "
            f"written, the partials read; {fused[S][2] / fused[S][0]:.3f} of it) ({card})")
    for S in (2, 4):
        extra = (S - 1) * nbytes / HBM_BYTES_PER_S * 1e3
        say(f"[B7 fused] the fused sum at S={S}: {fused[S][0] - fused[1][0]:.6f} ms over the "
            f"launch reading one buffer, bound {extra:.6f} ms ((S-1) x {nbytes} B over 3.35 "
            f"TB/s), where the standalone call took {b7[f'S={S}']['ms']:.6f} ms ({card})")
    two = b7["S=2"]
    times["b7"] = (two["ms"], two["plain_ms"], two["bound_ms"], "bytes", two["library_ms"])
    times["b7_fused"] = fused[2]
    times["runner"] = rates
    return times


# ------------- the clause mesh's per-step chunks captured (phases 20, 21, 29)

CAPTURE_STEPS = 64  # a captured chunk's length where it is timed (the adaptive twin's: 16)
# chunks in host_share's profiled window at S=1 (phase 21), where the host
# runs ahead of the card; 1 on a shared card, where the reading is each
# rank's own kernels, no host share, and what it counts is the launches
PROFILED_CHUNKS = 4


def mesh_case(mesh, device, kind, fa, ode, B, steps, seed):
    """A clause-mesh path's runner maker and this rank's block of a global
    state of ``B`` rows a trajectory rank made from ``seed`` on the host:
    ``kind`` "B5" (``make_clause_chunk`` over B5's step), "B8" (the stoch
    clause path with ``shard_chunk`` 'off'), "twin" (the twin's mesh step,
    ``make_sharded_chunk_runner`` past the kernels' gates) or "stoch_twin"
    (the stoch clause path on a formula with no shard plan). Returns
    ``(make, state, dev)``: ``make()`` builds a fresh runner, ``run(state,
    dev)`` or ``run(state)`` (``dev`` None), whose chunks draw the same
    seeds as every other runner ``make`` builds."""
    import numpy as np
    import torch

    from odesat_tpu_torch.interop import state_from_numpy
    from odesat_tpu_torch.models.ode import formula_device, state_dtype
    from odesat_tpu_torch.models.stoch import StochState
    from odesat_tpu_torch.parallel import sharded

    n_traj = 1 if mesh is None else mesh.n_traj
    group = None if mesh is None else mesh.clause_group
    rng = np.random.default_rng(seed)
    rows = B * n_traj
    Np, M = fa.n_vars_padded, fa.n_clauses_padded
    if kind in ("B8", "stoch_twin"):
        v = torch.as_tensor(rng.random((rows, Np)) < 0.5)
        state = StochState(v, torch.ones((rows, M), dtype=torch.int32),
                           torch.zeros(rows, dtype=torch.bool))
        if mesh is not None:
            state = sharded.shard_stoch_inputs(state, mesh)
        state = StochState(*(t.to(device) for t in state))

        def make():
            return sharded.make_clause_stoch_runner(fa, steps, device,
                                                    sharded.row_generator(seed, mesh), group,
                                                    shard_chunk="off")
        return make, state, None
    np_dtype = np.float64 if ode.dtype == "float64" else np.float32
    xs = np.broadcast_to(fa.xs_init, (rows, M)).astype(np_dtype)
    state = state_from_numpy(rng.uniform(-1, 1, (rows, Np)).astype(np_dtype), xs,
                             np.ones_like(xs), np.full(rows, 0.01, np_dtype),
                             np.zeros(rows, bool), device=device)
    zeta = ode.resolve_zeta(fa.density)
    if kind == "twin":
        state, dev = sharded.shard_inputs(
            state, formula_device(fa, device, dtype=state_dtype(ode)), mesh)
        return ((lambda: sharded.make_sharded_chunk_runner(fa, zeta, ode, steps, mesh, device)),
                state, dev)
    from odesat_tpu_torch.ops.shard_stream import make_clause_chunk, make_fused_clause_step

    if mesh is not None:
        state = sharded.shard_state(state, mesh)
    return (lambda: make_clause_chunk(make_fused_clause_step(fa, zeta, ode, group, device),
                                      steps)), state, None


def captured_against_host_paced(mesh, device, kind, fa, ode=None, B=1024, steps=64, seed=7,
                                profiled=0):
    """One clause-mesh path (:func:`mesh_case`'s ``kind``) on this rank,
    its chunk captured (``ops/scan_chunk.py``) against the same steps
    launched from Python (``scan_chunk.host_paced``), from one state: two
    chunks of ``steps`` steps each way, the second from the first's
    result. Raises unless the clause ranks' v are bit-identical
    (``sharded.check_replicated``). Returns ``{"err"}`` (the largest
    ``bit_error`` over the fields, 0.0: bit for bit), ``"ms"`` and
    ``"host_ms"`` (each second chunk's wall: the host clock from a device
    sync and a barrier over the world to the next), ``"allocs"`` and
    ``"host_allocs"`` (the allocator's allocations in each second chunk),
    ``"peak"`` and ``"host_peak"`` (bytes above what was allocated before
    each second chunk; a captured graph's temporaries live in its pool,
    which that count does not see), ``"reserved"`` and ``"host_reserved"``
    (bytes the allocator reserved over each first chunk, from an emptied
    cache: a capture's pool and buffers, the host-paced steps' cached
    temporaries), ``"replays"`` (graph launches a captured chunk), ``"b7"``
    (B7 calls a chunk, both forms) and, with ``profiled`` chunks,
    :func:`host_share`'s keys over that many."""
    import gc

    import torch
    import torch.distributed as dist

    from odesat_tpu_torch.models.loop import copy_state
    from odesat_tpu_torch.ops import butterfly, scan_chunk
    from odesat_tpu_torch.parallel import sharded
    from odesat_tpu_torch.parallel.dist import bit_error

    gc.collect()  # earlier runners' captures and buffers (their chunks hold cycles)
    make, state0, dev = mesh_case(mesh, device, kind, fa, ode, B, steps, seed)
    args = () if dev is None else (dev,)

    def settle():
        torch.cuda.synchronize(device)
        if dist.is_initialized():
            dist.barrier()

    def two(run, got):
        settle()
        torch.cuda.empty_cache()  # so that what the first chunk reserves is its own
        reserved = torch.cuda.memory_reserved(device)
        st = run(copy_state(state0), *args)
        settle()
        got["reserved"] = torch.cuda.memory_reserved(device) - reserved
        stats = torch.cuda.memory_stats(device)["allocation.all.allocated"]
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        st = run(st, *args)
        settle()
        got["ms"] = (time.perf_counter() - t0) * 1e3
        got["peak"] = torch.cuda.max_memory_allocated(device) - base
        got["allocs"] = torch.cuda.memory_stats(device)["allocation.all.allocated"] - stats
        return st

    run, got = make(), {}
    b7 = butterfly.launches + butterfly.launches_f64
    ours = two(run, got)
    b7 = (butterfly.launches + butterfly.launches_f64 - b7) / 2
    sharded.check_replicated(ours.v, mesh)
    host = {}
    with scan_chunk.host_paced():
        theirs = two(make(), host)
    err = max(bit_error(a.float() if a.dtype in (torch.bool, torch.int32) else a,
                        b.float() if b.dtype in (torch.bool, torch.int32) else b)
              for a, b in zip(ours, theirs))
    chunks = [c for c in (getattr(run, "chunks", {}).values() or [run])
              if isinstance(c, scan_chunk.ScanChunk)]
    chunks += [c for _, c in getattr(run, "twins", {}).values()]
    replays = sum(t for c in chunks for cap in c.graphs.values() for _, t in cap.parts)
    out = dict(got, err=err, host_ms=host["ms"], host_allocs=host["allocs"],
               host_peak=host["peak"], host_reserved=host["reserved"], replays=replays, b7=b7)
    if profiled:
        out.update(host_share(run, make, ours, args, steps, settle, profiled))
    return out


def host_share(run, make, state, args, steps, settle, chunks):
    """Under ``torch.profiler``, ``chunks`` chunks back to back each way,
    captured (``run``, already warm) and host-paced (a runner from
    ``make``, its first chunk outside the window): ``"kernels"`` (device
    operations a host-paced step, each launched from Python),
    ``"captured_share"``, ``"host_share"`` (the host's share of the
    window's wall: 1 less the card's busy time, the union of its kernels'
    spans, over it; None where the profiler read no device time) and
    ``"profiled"`` (``chunks``). A window of several chunks lets the host
    run ahead of the card, as in a solve: what stays is the host's share
    of the steady state, not one chunk's start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from odesat_tpu_torch.ops import scan_chunk

    def busy(events):
        spans = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        total, end = 0.0, -math.inf
        for a, b in spans:
            if b > end:
                total += b - max(a, end)
                end = b
        return total / 1e3, len(spans)

    out = {"profiled": chunks}
    for name, runner in (("captured", run), ("host", None)):
        paced = scan_chunk.host_paced() if name == "host" else contextlib.nullcontext()
        with paced:
            if runner is None:
                runner = make()
                state = runner(state, *args)  # its first chunk outside the window
            settle()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(chunks):
                    state = runner(state, *args)
                settle()
                wall = (time.perf_counter() - t0) * 1e3
        ms, n = busy(prof.events())
        out[f"{name}_share"] = None if n == 0 else 1.0 - ms / wall
        if name == "host":
            out["kernels"] = n / (steps * chunks)
    return out


def mixed_chunks(mesh, device, fa, B=64, steps=6, rounds=2):
    """``rounds`` rounds of a B5 chunk (captured), a B6 chunk, a B8 chunk
    (captured) and a B9 chunk on this rank's clause group, all on B7's one
    ring and counter, against the same rounds with B5's and B8's chunks
    host-paced (``scan_chunk.host_paced``). Returns ``(err, count, flags)``
    on every rank: the largest ``bit_error`` over both states' fields (0.0:
    bit for bit), the host's count of the group's launches after both
    sequences and every rank's flag on the card then (equal to it when the
    ring stayed in order)."""
    import torch

    from odesat_tpu_torch.models.loop import copy_state
    from odesat_tpu_torch.ops import butterfly, scan_chunk
    from odesat_tpu_torch.ops.shard_chunk import make_shard_chunk
    from odesat_tpu_torch.parallel import sharded
    from odesat_tpu_torch.parallel.dist import bit_error
    from odesat_tpu_torch.utils.config import ODEConfig

    ode = ODEConfig(step_size=0.01)
    zeta = ode.resolve_zeta(fa.density)
    make5, ode0, _ = mesh_case(mesh, device, "B5", fa, ode, B, steps, 3)
    make8, stoch0, _ = mesh_case(mesh, device, "B8", fa, None, B, steps, 4)
    group = mesh.clause_group

    def rounds_of():
        b5, b8 = make5(), make8()
        b6 = make_shard_chunk(fa, zeta, ode, steps, group, device)
        b9 = sharded.make_clause_stoch_runner(fa, steps, device, sharded.row_generator(5, mesh),
                                              group, shard_chunk="auto")
        s, t = copy_state(ode0), copy_state(stoch0)
        for _ in range(rounds):
            s = b6(b5(s))
            t = b9(b8(t))
        return (*s, *t)

    ours = rounds_of()
    with scan_chunk.host_paced():
        theirs = rounds_of()
    err = max(bit_error(a.float() if a.dtype in (torch.bool, torch.int32) else a,
                        b.float() if b.dtype in (torch.bool, torch.int32) else b)
              for a, b in zip(ours, theirs))
    comm = butterfly.communicator(group, device)
    return err, comm.count, comm.flags_on_card()


def capture_calls(fa, S):
    """A world's calls of :func:`captured_against_host_paced`
    at config 7 B=1024 (``fa`` laid out for S shards): B5 fixed and the B8
    path, 64-step chunks, under torch.profiler too (a chunk); at S=2 also the ring
    check of B5 and B8 captured between B6 and B9 chunks
    (:func:`mixed_chunks`)."""
    from odesat_tpu_torch.utils.config import ODEConfig

    calls = [(captured_against_host_paced,
              (kind, fa, ode, 1024, CAPTURE_STEPS, 7, 1))
             for kind, ode in (("B5", ODEConfig(step_size=0.01)), ("B8", None))]
    if S == 2:
        calls.append((mixed_chunks, (fa, 64, 6)))
    return calls


CAPTURE_LABELS = ("B5 fixed", "B8")


def check_capture(label, r):
    if r["err"] != 0.0 or r["allocs"] or not r["replays"]:
        fail(f"{label}: the captured chunk against host-paced max abs err {r['err']}, "
             f"{r['allocs']} allocations in its second chunk, {r['replays']} graph replays")


def capture_line(label, r, steps, card):
    prof = ""
    if r.get("kernels") is not None:
        shares = ", ".join(f"{k} {r[f'{k}_share']:.4f}" if r[f"{k}_share"] is not None
                           else f"{k} not measured" for k in ("captured", "host"))
        prof = (f"; under torch.profiler {r['kernels']:.1f} device operations a host-paced "
                f"step, each launched from Python, and the host's share of the wall of "
                f"{r['profiled']} chunk(s) back to back (1 less the card's busy time over it): "
                f"{shares}")
    return (f"[mesh capture] {label}: a {steps}-step chunk captured {r['ms']:.6f} ms, "
            f"host-paced {r['host_ms']:.6f} ms ({r['host_ms'] / r['ms']:.3f}x; host clock, "
            f"the second chunk each way, ending in a sync on every rank), equal bit for bit "
            f"(max abs err {r['err']}), v bit-identical over the clause ranks; {r['replays']} "
            f"graph replay(s) a chunk, {r['b7']:.0f} B7 calls a chunk; allocations in the "
            f"second chunk {r['allocs']} (host-paced {r['host_allocs']}); its peak {r['peak']} B "
            f"above what was allocated before it (host-paced {r['host_peak']} B; a graph's "
            f"temporaries live in its pool, which that count does not see); the first chunk "
            f"reserved {r['reserved']} B from an emptied cache (its capture's pool and buffers; "
            f"host-paced {r['host_reserved']} B){prof} ({card})")


def report_capture(where, S, values, reports, card):
    """Print and check a world's :func:`capture_calls` results; returns
    ``({label: result}, largest error, mesh_step_chunk launches over the
    ranks)``."""
    out, worst, chunks = {}, 0.0, 0
    for label, r, per_rank in zip(CAPTURE_LABELS, values, reports):
        check_capture(f"{where} {label} S={S}", r)
        launched = [c["mesh_step_chunk"] for c in per_rank]
        if min(launched) == 0:
            fail(f"{where} {label} S={S}: no captured chunk ran on some rank: {launched}")
        chunks += sum(launched)
        worst = max(worst, r["err"])
        out[label] = r
        say(capture_line(f"{where} config 7 B=1024 S={S} ({S} ranks sharing the card) {label}",
                         r, CAPTURE_STEPS, card))
    if S == 2:
        err, count, flags = values[2]
        if err != 0.0 or flags != [count] * S:
            fail(f"{where}: B5 and B8 captured between B6 and B9 chunks: max abs err {err}, "
                 f"the host's count {count}, the ranks' flags on the card {flags}")
        say(f"[mesh capture] {where} config 7 B=64 S=2: two rounds of a B5 chunk (captured), a "
            f"B6 chunk, a B8 chunk (captured) and a B9 chunk on one B7 ring equal the same "
            f"rounds with B5 and B8 host-paced bit for bit (max abs err {err}); every rank's "
            f"flag on the card {flags} equals the host's count {count} ({card})")
    return out, worst, chunks


# ------------------------------ the hybrid, resume and exact time to solution


def hybrid_counters(fc, sc, stc):
    return {"fused_chunk": (fc, "launches"), "stream_chunk": (stc, "launches"),
            "stoch_fused": (sc, "fused_launches"), "stoch_stream": (sc, "stream_launches")}


def run_hybrid(counters, args):
    """``hybrid`` through the port's CLI in process, every count in
    ``counters`` set to 0 just before and read just after, keeping the
    ``HybridResult`` the CLI's solve returned (a wrapper around
    ``models.hybrid.hybrid_search``, which the CLI looks up at call time).
    Returns (winner, steps, verdict, launches, result, output)."""
    from odesat_tpu_torch import cli
    from odesat_tpu_torch.models import hybrid

    kept = []
    real = hybrid.hybrid_search

    def keep(*a, **k):
        kept.append(real(*a, **k))
        return kept[-1]

    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    buf = io.StringIO()
    hybrid.hybrid_search = keep
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["hybrid", *args])
    finally:
        hybrid.hybrid_search = real
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    out = buf.getvalue()
    if rc != 0:
        fail(f"hybrid {' '.join(args)} exited {rc}:\n{out}")
    winner = re.search(r"Winner: (\w+) after (\d+) steps per engine \(([0-9.]+)s\)", out)
    verdict = re.search(r"Checking if solution vector satisfies formula: (true|false)", out)
    if winner is None or verdict is None:
        fail(f"hybrid printed no Winner or verdict line:\n{out}")
    return winner.group(1), int(winner.group(2)), verdict.group(1), launches, kept[0], out


def phase_hybrid_main(fc, sc, stc, card):
    """Phase 22: the hybrid through the CLI at full width; returns the
    launches by kernel and the hard.cnf run's engine rates."""
    counters = hybrid_counters(fc, sc, stc)
    hard = os.path.join(ROOT, "tests", "data", "hard.cnf")
    uf_path = os.path.join(OUT, "uf250_seed0.cnf")  # written by phase 5
    n1k_path = os.path.join(OUT, "ksat_n1000_m4300_seed7_planted.cnf")  # phase 10
    total = {name: 0 for name in counters}
    runs = (
        # label, args, B, the kernels that must run (ODE, stoch), expected (None: a verified
        # solve or none after the budget)
        ("hard.cnf B=16384 --no-preprocess", ["-f", hard, "--no-preprocess", "-b", "16384",
                                              "-s", "0.01", "-n", "4096", "--seed", "0"],
         16384, ("fused_chunk", "stoch_fused"), "false"),
        ("uf250 B=4096", ["-f", uf_path, "-b", "4096", "-s", "0.01", "--seed", "0"], 4096,
         None, "true"),
        ("n1k preprocessed B=8192", ["-f", n1k_path, "-b", "8192", "-s", "0.01", "-n", "1024",
                                     "--seed", "0"], 8192, ("stream_chunk", "stoch_stream"),
         None),
    )
    rates = {}
    for label, args, B, kernels, want in runs:
        winner, steps, verdict, launches, res, out = run_hybrid(counters, args)
        sec = res.engine_seconds
        shape = re.search(r"Clauses: (\d+) \| Vars: (\d+)", out)
        shape = f", preprocessed to {shape.group(1)} clauses / {shape.group(2)} vars" \
            if shape else ""
        ode_rate, stoch_rate = B * steps / sec["ode"], B * steps / sec["stoch"]
        rates[label] = (ode_rate, stoch_rate, sec, res.wall_time_s)
        say(f"[hybrid main] {label}{shape}: Winner {winner} after {steps} steps per engine, "
            f"verdict {verdict}, wall {res.wall_time_s:.6f} s; the ODE engine's launches "
            f"{sec['ode']:.6f} s ({ode_rate:.6e} traj*steps/s), the stoch engine's "
            f"{sec['stoch']:.6f} s ({stoch_rate:.6e} chain*steps/s; CUDA events): "
            f"{sec['ode'] / (sec['ode'] + sec['stoch']):.4f} / "
            f"{sec['stoch'] / (sec['ode'] + sec['stoch']):.4f} of the engines' time, "
            f"{(sec['ode'] + sec['stoch']) / res.wall_time_s:.4f} of the wall; launches "
            f"{launches} ({card})")
        ode_ran = launches["fused_chunk"] + launches["stream_chunk"]
        stoch_ran = launches["stoch_fused"] + launches["stoch_stream"]
        if kernels and min(launches[k] for k in kernels) == 0 or not (ode_ran and stoch_ran):
            fail(f"hybrid {label}: expected launches of {kernels or 'an ODE and a stoch kernel'}"
                 f", got {launches}")
        if want == "false" and (winner, steps, verdict) != ("none", 4096, "false"):
            fail(f"hybrid {label}: expected Winner none after exactly 4096 steps and false")
        if want == "true" and verdict != "true":
            fail(f"hybrid {label}: the port did not verify a satisfying assignment")
        if want is None and (verdict != "true" if winner != "none" else
                             (steps, verdict) != (1024, "false")):
            fail(f"hybrid {label}: expected a verified solve or false after exactly 1024 steps")
        for name in total:
            total[name] += launches[name]
    return total, rates


def final_state(fn):
    """``fn()`` with ``models.loop.drive_chunks`` wrapped (the engines look
    it up at call time): returns (fn's result, the state drive_chunks
    returned, whether or not the run stopped early)."""
    from odesat_tpu_torch.models import loop

    kept = []
    real = loop.drive_chunks

    def keep(*a, **k):
        out = real(*a, **k)
        kept.append(out[0])
        return out

    loop.drive_chunks = keep
    try:
        result = fn()
    finally:
        loop.drive_chunks = real
    return result, kept[0]


def state_fields(state):
    """The tensors of an ODE, stoch or hybrid state, by name."""
    if hasattr(state, "ode"):
        return {**{f"ode {k}": v for k, v in state.ode._asdict().items()},
                **{f"stoch {k}": v for k, v in state.stoch._asdict().items()}}
    return dict(state._asdict())


def phase_resume(torch, fc, sc, stc, n1k_reduced, card):
    """Phase 23 on one card, in process through the library calls: for
    each case a run with a snapshot every ``every`` chunks that never
    stops, one stopped at ``part`` steps (its last snapshot) and one
    resumed from that snapshot; the resumed run's final state and steps
    equal the uninterrupted run's bit for bit. Then a ``--profile-dir``
    solve of inter on hard.cnf names B1's kernel in its trace."""
    from odesat_tpu_torch.cnf import normalize_cnf_variables, parse_dimacs_file
    from odesat_tpu_torch.models.hybrid import hybrid_search
    from odesat_tpu_torch.models.ode import simulate_batch
    from odesat_tpu_torch.models.stoch import search
    from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig

    hard_path = os.path.join(ROOT, "tests", "data", "hard.cnf")
    hard = normalize_cnf_variables(parse_dimacs_file(hard_path))[1]
    n1k = normalize_cnf_variables(n1k_reduced)[1]
    counters = hybrid_counters(fc, sc, stc)
    folder = os.path.join(OUT, "resume")
    os.makedirs(folder, exist_ok=True)
    fixed = dict(step_size=0.01)
    cases = (
        # label, engine, formula, ODE config, B, chunk, budget, stop at, every, kernels
        ("ODE fixed hard.cnf B=16384", simulate_batch, hard, fixed, 16384, 256, 1024, 512, 2,
         ("fused_chunk",)),
        ("ODE fixed n1k B=512", simulate_batch, n1k, fixed, 512, 64, 192, 128, 1,
         ("stream_chunk",)),
        ("stoch hard.cnf B=16384", search, hard, {}, 16384, 256, 1024, 512, 2, ("stoch_fused",)),
        ("stoch n1k B=8192", search, n1k, {}, 8192, 256, 512, 256, 1, ("stoch_stream",)),
        ("hybrid hard.cnf B=16384", hybrid_search, hard, fixed, 16384, 256, 1024, 512, 2,
         ("fused_chunk", "stoch_fused")),
    )
    for label, engine, formula, ode, B, chunk, budget, part, every, kernels in cases:
        path = os.path.join(folder, "part.npz")

        def run(steps, checkpoint=None, resume=None):
            config = SolverConfig(ode=ODEConfig(steps=steps, **ode), batch_size=B, seed=0,
                                  chunk_steps=chunk, checkpoint_path=checkpoint or
                                  os.path.join(folder, "scratch.npz"),
                                  checkpoint_every_chunks=every, resume_from=resume)
            return final_state(lambda: engine(formula, config, device="cuda"))

        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        whole, whole_state = run(budget)
        stopped, _ = run(part, checkpoint=path)
        resumed, resumed_state = run(budget, resume=path)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
        a, b = state_fields(whole_state), state_fields(resumed_state)
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        if bad or whole.steps != resumed.steps:
            fail(f"resume {label}: the resumed run differs from the uninterrupted one in {bad}, "
                 f"steps {resumed.steps} vs {whole.steps}")
        if min(launches[k] for k in kernels) == 0:
            fail(f"resume {label}: expected launches of {kernels}, got {launches}")
        say(f"[resume] {label}, {chunk}-step chunks, a snapshot every {every}: stopped at "
            f"{stopped.steps} steps and resumed, the final {', '.join(a)} and steps "
            f"({resumed.steps}) equal the uninterrupted run's bit for bit; launches "
            f"{launches}, three runs in {seconds:.1f} s ({card})")
        for name in ("part.npz", "scratch.npz"):
            if os.path.exists(os.path.join(folder, name)):
                os.remove(os.path.join(folder, name))

    # the profiler: a traced inter solve names B1's kernel. In its own process,
    # as a user runs it: in a process's later profiler sessions (phase 16 opens
    # one) the trace misses kernel launches (the first of each kernel at least)
    prof = os.path.join(OUT, "profile")
    trace = os.path.join(prof, "trace_rank0.json")
    if os.path.exists(trace):
        os.remove(trace)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "odesat_tpu_torch", "inter", "-f", hard_path, "-b", "16384",
         "-s", "0.01", "-n", "512", "--seed", "0", "--profile-dir", prof],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    text = ""
    if os.path.exists(trace):
        with open(trace, encoding="utf-8") as fh:
            text = fh.read()
    verdict = re.search(r"satisfies formula: (true|false)", proc.stdout)
    named = text.count("lanes_chunk_kernel")
    if proc.returncode != 0 or not named or not verdict or "Steps run: 512 |" not in proc.stdout:
        fail(f"--profile-dir: exit {proc.returncode}, the trace names lanes_chunk_kernel "
             f"{named} times:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    say(f"[profile] python -m odesat_tpu_torch inter hard.cnf B=16384 -n 512 --profile-dir: "
        f"verdict {verdict.group(1)} after 512 steps; {os.path.relpath(trace, ROOT)} "
        f"({len(text)} bytes) names B1's lanes_chunk_kernel {named} times; the process "
        f"{seconds:.1f} s ({card})")
    os.remove(trace)


def phase_exact_tts(torch, fc, card):
    """Phase 24: ``solve_exact`` on uf250 seeds 0-2, B=4096, fixed dt=0.01,
    through B1 (``odesat_tpu_torch.tools.uf250_tts``); instance 0's exact
    step equals the first step at which one-step B1 launches from the same
    initial state leave any row done."""
    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables
    from odesat_tpu_torch.models.ode import init_state
    from odesat_tpu_torch.tools import uf250_tts
    from odesat_tpu_torch.utils.config import ODEConfig
    from odesat_tpu_torch.utils.generate import uf_instance

    B, chunk, dtype = 4096, 64, "bfloat16"
    fc.launches = 0
    out = uf250_tts.measure(3, B, chunk, 20000, dtype, "cuda")
    launches = fc.launches
    say(f"[exact TTS] uf250 B={B} fixed dt=0.01 {dtype} rounding, {chunk}-step chunks: "
        f"dispatch round trip {out['dispatch_s'] * 1e3:.6f} ms, steady-state kernel rate "
        f"{out['rate']:.6e} traj*steps/s, {launches} B1 launches ({card})")
    for seed, res, verified, bd in out["rows"]:
        say(f"[exact TTS] seed {seed}: solved {res.solved} (verified {verified}) at exact step "
            f"{bd['steps']} in {res.chunks} chunks, wall {bd['wall_s']:.6f} s = compute "
            f"{bd['compute_s']:.6f} + dispatch {bd['dispatch_s']:.6f} + residual "
            f"{bd['residual_s']:.6f} s ({card})")
        if not (res.solved and verified):
            fail(f"exact TTS seed {seed}: solved {res.solved}, verified {verified}")
    if launches == 0:
        fail("exact TTS: B1 was never launched")
    # instance 0 by single-step replay through B1
    fa = compile_formula(normalize_cnf_variables(uf_instance(250, seed=0))[1])
    ode = ODEConfig(step_size=0.01, matmul_dtype=dtype)
    one = fc.make_fused_chunk(fa, ode.resolve_zeta(fa.density), ode, 1, "cuda")
    state = init_state(fa, B, torch.Generator(device="cuda").manual_seed(0), ode, "cuda")
    want, truth = out["rows"][0][1].steps, None
    for step in range(1, want + 2):
        state = one(state)
        if bool(state.done.any()):
            truth = step
            break
    if truth != want:
        fail(f"exact TTS seed 0: solve_exact says step {want}, the single-step replay {truth}")
    say(f"[exact TTS] seed 0: the single-step replay (one-step B1 launches from the same "
        f"state) first has a row done at step {truth}, solve_exact's step ({card})")


# ------------------------------------------------- the device loop (phase 25)


def loop_compare(torch, got, want, fields):
    """Max abs error over the float fields after demanding every field equal
    bit for bit; fails otherwise."""
    worst = 0.0
    for name in fields:
        a, b = getattr(got, name), getattr(want, name)
        if not torch.equal(a, b):
            diff = (a.float() - b.float()).abs().max().item()
            return None, f"{name} differs (max abs {diff})"
        if a.is_floating_point():
            worst = max(worst, (a - b).abs().max().item())
    return worst, None


def loop_case(torch, label, multi, host, state, fields, chunk_steps, bound, counter):
    """One dispatch of ``multi`` (the model's multi-chunk runner: the device
    loop on the card) against ``host`` (models/loop.run_chunks over the same
    kernel): state bit for bit and steps; the graph launched once and the
    kernel ``counter`` (module, attribute) grown by the chunks run."""
    from odesat_tpu_torch.ops import device_loop as dl

    want, steps = host(copied(state))  # both consume their input: ``state`` serves again
    graphs, (mod, attr) = dl.launches, counter
    before = getattr(mod, attr)
    got, got_steps = multi(copied(state))
    torch.cuda.synchronize()
    err, why = loop_compare(torch, got, want, fields)
    if why or got_steps != steps:
        fail(f"device loop {label} bound {bound}: {why or ''} steps {got_steps} against the host "
             f"loop's {steps}")
    if dl.launches != graphs + 1 or getattr(mod, attr) != before + steps // chunk_steps:
        fail(f"device loop {label} bound {bound}: {dl.launches - graphs} graph launches, "
             f"{getattr(mod, attr) - before} kernel launches for {steps // chunk_steps} chunks")
    return err, steps // chunk_steps, got


def phase_loop_compare(torch, fc, sc, stc, hard, uf250, big, n1k_stoch, planted, card):
    """Phase 25a: one dispatch of the device loop against the repaired host
    loop over the same kernel, bit for bit, steps included: B1 (hard.cnf
    B=16384; uf250 B=4096 from its initial state, where the stop falls inside
    the dispatch, and from the partly solved state that leaves), B2 (n1k
    B=512, and phase 13's shapes: n1k and local n=4096 at B=10240, whose
    launches take other tiles, in 8-step chunks, 16 a dispatch as phase 13's
    dispatches hold), B3 (hard.cnf B=16384; the planted n=200 B=4096, where
    chains finish), B4 (n1k B=8192); bounds 1, 3 and the whole dispatch,
    stop on any and all (ODE), and from entry states already stopped."""
    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.models.ode import init_state, make_multi_chunk_runner
    from odesat_tpu_torch.models.stoch import (
        init_stoch_state,
        make_multi_stoch_runner,
        make_stoch_chunk_runner,
    )
    from odesat_tpu_torch.utils.config import ODEConfig

    t0 = time.perf_counter()
    worst, cases = 0.0, 0
    ode_fields = ("v", "xs", "xl", "dt", "done")
    fixed = ODEConfig(step_size=0.01)

    def stopped(state, stop_on):
        done = torch.ones_like(state.done) if stop_on == "all" else state.done.clone()
        done[0] = True
        return state._replace(done=done)

    def ode_runs(label, fa, make, chunk, full, state, counter, inside=False):
        nonlocal worst, cases
        fn = make(fa, 0.05, fixed, chunk, "cuda")
        last = None
        for stop_on in ("any", "all"):
            for bound in (1, 3, full):
                multi = make_multi_chunk_runner(fa, 0.05, fixed, chunk, bound, "cuda",
                                                stop_on=stop_on, chunk=fn)
                host = run_chunks(fn, chunk, bound, stop_all=stop_on == "all")
                err, ran, out = loop_case(torch, f"{label} {stop_on}", multi, host, state,
                                          ode_fields, chunk, bound, counter)
                worst, cases = max(worst, err), cases + 1
                if inside and stop_on == "any" and bound == full:
                    if not 1 < ran < full:
                        fail(f"device loop {label}: the stop fell at chunk {ran} of {full}, not "
                             "inside the dispatch")
                    last = out
            entry = stopped(state, stop_on)
            multi = make_multi_chunk_runner(fa, 0.05, fixed, chunk, full, "cuda", stop_on=stop_on,
                                            chunk=fn)
            err, ran, _ = loop_case(torch, f"{label} {stop_on} stopped at entry", multi,
                                    run_chunks(fn, chunk, full, stop_all=stop_on == "all"),
                                    entry, ode_fields, chunk, full, counter)
            cases += 1
            if ran != 0:
                fail(f"device loop {label}: {ran} chunks from a stopped entry state")
        return last

    b1 = (fc, "launches")
    ode_runs("B1 hard.cnf B=16384 fixed 256-step", hard, fc.make_fused_chunk, 256, 16,
             random_state(hard, 16384, seed=3), b1)
    init = init_state(uf250, 4096, torch.Generator(device="cuda").manual_seed(0), fixed, "cuda")
    partly = ode_runs("B1 uf250 B=4096 fixed 64-step", uf250, fc.make_fused_chunk, 64, 20,
                      init, b1, inside=True)
    say(f"[device loop] uf250 B=4096: the stop fell inside the dispatch; the partly solved "
        f"state it left holds {int(partly.done.sum())} done rows")
    ode_runs("B1 uf250 B=4096 partly solved", uf250, fc.make_fused_chunk, 64, 20, partly,
             b1)
    n1k_ode = big[0][1]
    ode_runs("B2 n1k B=512 fixed 8-step", n1k_ode, stc.make_stream_chunk, 8, 8,
             random_state(n1k_ode, 512, seed=4), (stc, "launches"))
    for label, fa, B, _ in (big[0], big[2]):  # phase 13's B2 shapes
        ode_runs(f"B2 {label} fixed 8-step", fa, stc.make_stream_chunk, 8, 16,
                 random_state(fa, B, seed=4), (stc, "launches"))

    def stoch_runs(label, fa, B, chunk, full, counter, inside=False):
        nonlocal worst, cases
        state = init_stoch_state(fa, B, "cuda")
        for entry in (state, stopped(state, "any")):
            for bound in ((1, 3, full) if entry is state else (full,)):
                gens = [torch.Generator().manual_seed(11) for _ in range(2)]
                chunks = [make_stoch_chunk_runner(fa, chunk, "cuda", g, fused="on") for g in gens]
                err, ran, _ = loop_case(torch, label, make_multi_stoch_runner(chunks[1], chunk, bound),
                                        run_chunks(chunks[0], chunk, bound), entry,
                                        ("v", "xl", "done"), chunk, bound, counter)
                worst, cases = max(worst, err), cases + 1
                if entry is not state and ran:
                    fail(f"device loop {label}: {ran} chunks from a stopped entry state")
                if inside and entry is state and bound == full and not 1 < ran < full:
                    fail(f"device loop {label}: the stop fell at chunk {ran} of {full}")
                if ran == bound and not torch.equal(gens[0].get_state(), gens[1].get_state()):
                    fail(f"device loop {label} bound {bound}: the generators differ after a "
                         "dispatch that ran every chunk")

    stoch_runs("B3 hard.cnf B=16384 64-step", hard, 16384, 64, 16, (sc, "fused_launches"))
    stoch_runs("B3 planted n=200 B=4096 8-step", planted, 4096, 8, 100, (sc, "fused_launches"),
               inside=True)
    stoch_runs("B4 n1k B=8192 8-step", n1k_stoch, 8192, 8, 8, (sc, "stream_launches"))
    say(f"[device loop] {cases} dispatches equal the host loop bit for bit (state and steps; "
        f"max abs err {worst}), each one graph launch, in {time.perf_counter() - t0:.1f} s "
        f"({card})")
    return worst


def loop_iteration_ms(torch, iters=2000):
    """The device loop's cost a chunk beyond the chunk kernel (CUDA events
    around dispatches of ``iters`` empty bodies against dispatches of 0),
    the host loop's (``done.any()`` read on the host a chunk, host clock),
    and one dispatch of 0 chunks (head, launch, the read of the count; the
    median of 21, host clock), ms."""
    from types import SimpleNamespace

    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.ops import device_loop as dl

    state = random_state(load_cases_hard(), 16384, seed=1)
    # a chunk runner whose body launches nothing: a dispatch of it times the
    # loop alone (the head, and a decide kernel a chunk)
    chunk = dl.KernelChunk(lambda st: st, lambda *args: (), 1,
                           (SimpleNamespace(launches=0), "launches"))

    def graph_ms(bound, reps=5):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        dl.run(chunk, state, bound)  # builds the graph at the first call
        start.record()
        for _ in range(reps):
            dl.run(chunk, state, bound)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    per = (graph_ms(iters) - graph_ms(0)) / iters
    empties = []
    for _ in range(21):
        t0 = time.perf_counter()
        dl.run(chunk, state, 0)
        empties.append((time.perf_counter() - t0) * 1e3)
    empty = sorted(empties)[10]
    host = run_chunks(lambda st: st, 1, iters)
    host(state)
    t0 = time.perf_counter()
    host(state)
    plain = (time.perf_counter() - t0) * 1e3 / iters
    return per, plain, empty


def load_cases_hard():
    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables, parse_dimacs_file

    return compile_formula(normalize_cnf_variables(
        parse_dimacs_file(os.path.join(ROOT, "tests", "data", "hard.cnf")))[1])


def busy_share(torch, B=16384, steps=4096):
    """Phase 6's solve (hard.cnf fixed dt 0.01, 256-step chunks, the
    multi-chunk dispatch plan) in process after a warm-up, under
    torch.profiler: (wall s, the card's busy share: the device events' self
    time over the traced wall), None for the share when the profiler reads
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    from odesat_tpu_torch.models.ode import simulate_batch
    from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig

    fa = load_cases_hard()
    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=steps), batch_size=B, seed=0)
    simulate_batch(fa, config, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = simulate_batch(fa, config, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if result.steps != steps or result.any_solved:
        fail(f"busy share: hard.cnf ran {result.steps} steps, solved {result.any_solved}")

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy = sum(device_us(e) for e in prof.key_averages()) / 1e6
    return wall, (busy / wall if busy > 0 else None)


def say_loop_iteration(torch, card, origin="this tree"):
    """Print :func:`loop_iteration_ms`'s times; returns (loop ms a chunk,
    host loop ms a chunk)."""
    per, plain, empty = loop_iteration_ms(torch)
    say(f"[device loop timing] {origin}: a chunk's cost beyond the chunk kernel: device loop "
        f"(decide kernel, conditional node) {per:.6f} ms, host loop (done.any() read) "
        f"{plain:.6f} ms; one dispatch of 0 chunks (head kernel, graph launch, the count read; "
        f"median of 21) {empty:.6f} ms ({card})")
    return per, plain


def say_kernel_share(wall_s, launches, launch_ms, card, origin="this tree"):
    """Phase 6's f32 loop wall against its B1 launches times B1's time a
    launch (CUDA events, the kernel alone): the card's busy share without a
    profiler."""
    busy = launches * launch_ms / 1e3
    say(f"[loop timing] {origin}: phase 6's f32 loop wall {wall_s:.6f} s holds "
        f"{launches} B1 launches of {launch_ms:.6f} ms = {busy:.6f} s: the card busy "
        f"{busy / wall_s:.4f} of it, idle {(wall_s - busy) * 1e3:.6f} ms ({card})")


def phase_loop_timing(torch, card, unsat_wall, b1_ms):
    """Phase 25c: the device loop's cost a chunk beyond the chunk kernel
    against the host loop's, one dispatch of 0 chunks, and phase 6's busy
    share from its wall and phase 7's B1 time (no profiler: a process's
    later torch.profiler sessions miss launches, and this process opened
    one in phase 16; ``--time-loop`` reads the profiler in a fresh
    process). Returns (loop ms a chunk, host loop ms a chunk)."""
    per, plain = say_loop_iteration(torch, card)
    say_kernel_share(unsat_wall, 16, b1_ms, card)
    return per, plain


def phase_donation(torch, card):
    """Phase 25d: the state donated, as JAX donates it (ops/device_loop.py's
    contract), at the main path's shapes. a. B1-B4 host-paced (hard.cnf
    B=16384 256 and 64 steps, n1k B=10240 and B=8192 8 steps): a donating
    runner runs in place and returns its input's tensors, bit for bit what
    the runner built with donate=False writes into new tensors, which
    leaves its input as it was; each form's time a launch. b. Dispatches
    that pass each result back (B1 hard.cnf B=16384, 4 chunks of 256 a
    dispatch; the scan chunk, pallas fixed hard.cnf B=4096, 2 chunks of
    64): from the second on no copy into a graph's buffers, no new graph
    or capture, B1 on the caller's own tensors from the first, each result
    equal to the host loop's bit for bit; the scan dispatch's time from its
    own result and from another state (its copy in); B3 (hard.cnf B=16384,
    4 chunks of 64), whose graphs run on the runner's buffer sets: a copy
    in at the first dispatch only, one graph. c. A result held
    across a dispatch and a chunk from another state (B1 and the scan
    chunk) is unchanged, and the other state's result equals its run alone.
    d. The stoch twin's snapshot resumes to the same flips (hard.cnf
    B=4096, 64-step chunks), each run from a copy of the chains it
    resumes."""
    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.models.ode import (
        formula_device,
        make_chunk_runner,
        make_multi_chunk_runner,
    )
    from odesat_tpu_torch.models.stoch import (
        generator_states,
        init_stoch_state,
        make_stoch_chunk_runner,
        restore_generators,
    )
    from odesat_tpu_torch.ops import device_loop as dl
    from odesat_tpu_torch.ops import fused_chunk as fc
    from odesat_tpu_torch.ops import scan_chunk
    from odesat_tpu_torch.ops import stoch_chunk as sc
    from odesat_tpu_torch.ops import stream_chunk as stc
    from odesat_tpu_torch.utils.config import ODEConfig
    from odesat_tpu_torch.utils.timing import cuda_ms

    hard = load_cases_hard()
    n1k_reduced = preprocessed_n1k()
    n1k_ode = load_stream_cases(n1k_reduced)[0][1]
    _, n1k_stoch = load_stoch_cases([], n1k_reduced)
    fixed = ODEConfig(step_size=0.01)

    def same(label, got, want, fields):
        _, why = loop_compare(torch, got, want, fields)
        if why:
            fail(f"donation {label}: {why}")

    # a. B1-B4 in place against out of place
    kernels = (
        ("B1 hard.cnf B=16384 256-step",
         lambda d: fc.make_fused_chunk(hard, 0.05, fixed, 256, "cuda", d), (),
         lambda: random_state(hard, 16384, seed=3)),
        ("B2 n1k B=10240 8-step",
         lambda d: stc.make_stream_chunk(n1k_ode, 0.05, fixed, 8, "cuda", d), (),
         lambda: random_state(n1k_ode, 10240, seed=3)),
        ("B3 hard.cnf B=16384 64-step",
         lambda d: sc.make_stoch_chunk(hard, 64, "fused", "float32", "cuda", d), (5,),
         lambda: init_stoch_state(hard, 16384, "cuda")),
        ("B4 n1k B=8192 8-step",
         lambda d: sc.make_stoch_chunk(n1k_stoch, 8, "stream", "float32", "cuda", d), (5,),
         lambda: init_stoch_state(n1k_stoch, 8192, "cuda")),
    )
    for label, make, args, fresh in kernels:
        runs = {d: make(d) for d in (True, False)}
        state = fresh()
        entry = copied(state)
        kept = runs[False](state, *args)
        torch.cuda.synchronize()
        same(f"{label}: donate=False changed its input", state, entry, state._fields)
        ptrs = [t.data_ptr() for t in state]
        got = runs[True](state, *args)
        torch.cuda.synchronize()
        if [t.data_ptr() for t in got] != ptrs:
            fail(f"donation {label}: the donating runner did not return its input's tensors")
        same(f"{label} in place against out of place", got, kept, state._fields)
        ms = {d: cuda_ms(lambda d=d: runs[d](state, *args), iters=10, warmup=2)
              for d in (True, False)}
        say(f"[donation] a. {label}: in place (its input's tensors returned) equal to out of "
            f"place bit for bit; {ms[True]:.6f} ms a launch in place, {ms[False]:.6f} ms out "
            f"of place ({card})")
        del state, entry, kept, got, runs

    # b. dispatches from their own results; c. a held result
    def dispatch_case(kind):
        if kind == "B1":
            fa, ode, B, steps, bound = hard, fixed, 16384, 256, 4
        else:
            fa, ode, B, steps, bound = hard, scan_ode("pallas", "fixed"), 4096, 64, 2
        chunk = make_chunk_runner(fa, 0.05, ode, steps, "cuda")
        multi = make_multi_chunk_runner(fa, 0.05, ode, steps, bound, "cuda", stop_on="all",
                                        chunk=chunk)
        dev = formula_device(fa, "cuda")
        return (chunk, lambda st: multi(st, dev), dev, steps, bound,
                lambda seed: random_state(fa, B, seed=seed))

    for kind in ("B1", "scan"):
        chunk, multi, dev, steps, bound, fresh = dispatch_case(kind)
        host = run_chunks(lambda st: chunk(st, dev), steps, bound, stop_all=True)
        wants, st = [], fresh(1)
        for _ in range(3):
            st = host(st)[0]
            wants.append(copied(st))
        del st
        state = fresh(1)
        ptrs, loads0 = [t.data_ptr() for t in state], dl.loads
        state, _ = multi(state)
        loads, captures, graphs = dl.loads, scan_chunk.captures, len(chunk.loops)
        for i, want in enumerate(wants):
            if i:
                state, _ = multi(state)
            torch.cuda.synchronize()
            same(f"{kind} dispatch {i + 1} from its own result", state, want, STATE_FIELDS)
        if (dl.loads, scan_chunk.captures, len(chunk.loops)) != (loads, captures, graphs):
            fail(f"donation {kind}: a dispatch from its own result copied ({dl.loads - loads}), "
                 f"captured ({scan_chunk.captures - captures}) or built a graph "
                 f"({len(chunk.loops) - graphs})")
        if kind == "B1" and ([t.data_ptr() for t in state] != ptrs or dl.loads != loads0):
            fail("donation B1: the dispatches did not run on the caller's own tensors")
        timing = ""
        if kind == "scan":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                state, _ = multi(state)
            torch.cuda.synchronize()
            own = (time.perf_counter() - t0) / 5 * 1e3
            other = fresh(2)
            multi(other)  # a capture of its own: ``state`` holds the first one's buffers
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                multi(other)
            torch.cuda.synchronize()
            copy = (time.perf_counter() - t0) / 5 * 1e3
            timing = (f"; a dispatch from its own result {own:.6f} ms, from another state (its "
                      f"copy in) {copy:.6f} ms (host clock)")
            del other
        first = ", the first too, on the caller's tensors (the pointer block)" \
            if kind == "B1" else ""
        say(f"[donation] b. {kind}: 3 dispatches each from the last one's result equal the host "
            f"loop bit for bit, no copy and no new capture or graph after the first{first}"
            f"{timing} ({card})")
        for call, run in (("dispatch", lambda st: multi(st)[0]),
                          ("chunk", lambda st: chunk(st, dev))):
            alone = copied(run(fresh(3)))
            held = run(fresh(2))
            kept = copied(held)
            other = run(fresh(3))
            torch.cuda.synchronize()
            same(f"{kind} {call}: the held result after a call from another state", held, kept,
                 STATE_FIELDS)
            same(f"{kind} {call}: the other state's result against its run alone", other, alone,
                 STATE_FIELDS)
            del alone, held, kept, other
        say(f"[donation] c. {kind}: a result held across a dispatch and a chunk from another "
            f"state is unchanged bit for bit; the other state's results equal their runs alone")
        del state, wants, chunk, multi, host

    # b. B3 (its graphs on the runner's buffer sets): dispatches from their
    # own results against the host loop over a generator of the same seed
    from odesat_tpu_torch.models.stoch import make_multi_stoch_runner

    gens = [torch.Generator().manual_seed(13) for _ in range(2)]
    chunks = [make_stoch_chunk_runner(hard, 64, "cuda", g, fused="on") for g in gens]
    host = run_chunks(chunks[0], 64, 4)
    multi = make_multi_stoch_runner(chunks[1], 64, 4)
    want, state = init_stoch_state(hard, 16384, "cuda"), init_stoch_state(hard, 16384, "cuda")
    for i in range(3):
        want = host(want)[0]
        loads = dl.loads
        state, _ = multi(state)
        torch.cuda.synchronize()
        same(f"B3 dispatch {i + 1} from its own result", state, want, ("v", "xl", "done"))
        if i and dl.loads != loads:
            fail("donation B3: a dispatch from its own result copied its state in")
        graphs = len(chunks[1].loops)
    if graphs != 1:
        fail(f"donation B3: {graphs} graphs for dispatches from their own results")
    say(f"[donation] b. B3 hard.cnf B=16384: 3 dispatches each from the last one's result equal "
        f"the host loop bit for bit; one graph, on the runner's buffer set, a copy in at the "
        f"first dispatch only ({card})")
    del chunks, host, multi, want, state

    # d. the stoch twin's snapshot
    chunk = make_stoch_chunk_runner(hard, 64, "cuda", torch.Generator().manual_seed(0),
                                    fused="off")
    mid = chunk(chunk(init_stoch_state(hard, 4096, "cuda")))
    saved = generator_states(torch.Generator(), chunk)
    want = chunk(chunk(copied(mid)))
    final = chunk.device_generator.get_state()
    fresh_runner = make_stoch_chunk_runner(hard, 64, "cuda", torch.Generator().manual_seed(8),
                                           fused="off")
    for runner in (chunk, fresh_runner):
        restore_generators(saved, torch.Generator(), runner)
        got = runner(runner(copied(mid)))
        torch.cuda.synchronize()
        same("the stoch twin resumed from its snapshot", got, want, ("v", "xl", "done"))
        if not torch.equal(runner.device_generator.get_state(), final):
            fail("donation: the stoch twin's device generator differs after the resumed chunks")
    say(f"[donation] d. the stoch twin (hard.cnf B=4096, 64-step chunks): its snapshot resumed "
        f"in the same runner and in one built anew gives the same flips and generator state bit "
        f"for bit ({card})")


# Phase 25e's runners, at config 7 S=1: B6 fixed and adaptive, B5 (fixed,
# --shard-chunk off), B9 and B8 (--shard-chunk off)
CLAUSE_RUNNERS = ("B6 fixed", "B6 adaptive", "B5", "B9", "B8")


def clause_runner(torch, name, fa, steps, plain=False):
    """``run(state) -> state`` for one of :data:`CLAUSE_RUNNERS` (S=1,
    on the card). ``plain``: the plain version on the card that it is held
    against, B6's for B5 and B9's for B8 (the same results bit for bit),
    drawing the runner's seed. Only entry points that the parent trees
    have, so that ``--time-mesh`` runs it on them."""
    from odesat_tpu_torch.ops import shard_chunk as sch
    from odesat_tpu_torch.ops import shard_stream as ss
    from odesat_tpu_torch.ops import stoch_chunk as sc
    from odesat_tpu_torch.parallel import sharded
    from odesat_tpu_torch.utils.config import ODEConfig

    if name in ("B9", "B8"):
        gen = torch.Generator().manual_seed(7)
        if plain:
            chunk = sc.make_stoch_shard_chunk(fa, steps, "cuda", plain=True)
            return lambda st: chunk(st, int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))
        return sharded.make_clause_stoch_runner(fa, steps, "cuda", gen, None, "float32",
                                                "auto" if name == "B9" else "off")
    ode = ODEConfig() if name == "B6 adaptive" else ODEConfig(step_size=0.01)
    zeta = ode.resolve_zeta(fa.density)
    if plain:
        chunk = sch.make_shard_chunk(fa, zeta, ode, steps, None, "cuda", plain=True)
    elif name == "B5":
        chunk = ss.make_single_device_runner(fa, zeta, ode, steps, "cuda")
    else:
        chunk = sch.make_shard_chunk(fa, zeta, ode, steps, None, "cuda")
    return lambda st: chunk(st, None)


def clause_state(name, fa, B, seed):
    return stoch_state(fa, B, seed) if name in ("B9", "B8") else random_state(fa, B, seed)


def allocations(torch):
    """The caching allocator's allocations so far on this device."""
    return torch.cuda.memory_stats()["allocation.all.allocated"]


def phase_clause_donation(torch, fa7, card, B=1024, steps=4):
    """Phase 25e: the clause mesh's runners donated, as JAX donates their
    state (ops/device_loop.py's contract), at config 7 S=1 B=1024 and a
    ragged B=1000 (B6 fixed): each returns its input's own storage, equal
    bit for bit to a copy-first run of the plain version on the card; a
    second chunk of the shape, from another state, allocates nothing
    (``allocation.all.allocated`` unchanged) and leaves the first result,
    still held, as it was. Then each runner's 64-step chunk walls and its
    peak (:func:`clause_walls_and_peaks`)."""
    import gc

    cases = [*((name, B) for name in CLAUSE_RUNNERS), ("B6 fixed", 1000)]
    for name, batch in cases:
        run = clause_runner(torch, name, fa7, steps)
        plain = clause_runner(torch, name, fa7, steps, plain=True)
        first = clause_state(name, fa7, batch, seed=31)
        want = plain(copied(first))
        ptrs = [t.data_ptr() for t in first]
        got = run(first)
        torch.cuda.synchronize()
        if [t.data_ptr() for t in got] != ptrs:
            fail(f"clause donation, {name} B={batch}: the result is not the input's storage")
        err = 0.0
        for field, a, b in zip(got._fields, got, want):
            if not torch.equal(a, b):
                fail(f"clause donation, {name} B={batch}: {field} differs from the copy-first "
                     f"plain run by {(a.float() - b.float()).abs().max().item()}")
        kept = copied(got)
        second = copied(want)  # another state of the shape
        torch.cuda.synchronize()
        before = allocations(torch)
        run(second)
        torch.cuda.synchronize()
        new = allocations(torch) - before
        if new:
            fail(f"clause donation, {name} B={batch}: a second chunk of the shape made {new} "
                 f"allocations")
        if not all(torch.equal(a, b) for a, b in zip(got, kept)):
            fail(f"clause donation, {name} B={batch}: a chunk from another state wrote the "
                 f"held result")
        say(f"[clause donation] config 7 S=1 B={batch} {name}, {steps}-step chunks: returns "
            f"its input's storage, equal to the copy-first plain run (max abs err {err}); a "
            f"second chunk from another state: 0 allocations, the held result unchanged "
            f"({card})")
        del run, plain, first, want, got, kept, second
        gc.collect()
    r = clause_walls_and_peaks(torch, fa7)
    for name in r:
        if r[name]["allocs"]:
            fail(f"clause donation, {name}: its timed 64-step chunks made {r[name]['allocs']} "
                 f"allocations")
        say(clause_walls_line(name, r[name], card))
    return r


def clause_walls_and_peaks(torch, fa7, B=1024, steps=64, reps=2):
    """For each of :data:`CLAUSE_RUNNERS` at config 7 S=1, from a fresh
    state after a warm-up chunk (each call from the last one's result):
    ``reps`` walls of a ``steps``-step chunk (ms, host clock, each ending
    in a sync), the peak bytes allocated over those chunks above what the
    process held before the runner and its state were made
    (``reset_peak_memory_stats``, ``max_memory_allocated``), the state's
    bytes and the chunks' allocations."""
    import gc

    from odesat_tpu_torch.ops import scan_chunk

    # B5's and B8's captured chunks also host-paced, where the tree has both
    paced = ("B5", "B8") if hasattr(scan_chunk, "host_paced") else ()
    out = {}
    for name in (*CLAUSE_RUNNERS, *(f"{n} host-paced" for n in paced)):
        base_name, _, how = name.partition(" host-paced")
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        with scan_chunk.host_paced() if name != base_name else contextlib.nullcontext():
            run = clause_runner(torch, base_name, fa7, steps)
            state = run(clause_state(base_name, fa7, B, seed=41))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before, walls = allocations(torch), []
            for _ in range(reps):
                t0 = time.perf_counter()
                state = run(state)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"walls": walls, "peak": torch.cuda.max_memory_allocated() - base,
                     "state": sum(t.numel() * t.element_size() for t in state),
                     "allocs": allocations(torch) - before}
        del run, state
    gc.collect()
    return out


def clause_walls_line(name, r, card, origin="this tree"):
    return (f"[clause chunk] config 7 S=1 B=1024 {name} ({origin}): 64-step chunk "
            f"{' / '.join(f'{w:.6f}' for w in r['walls'])} ms (host clock), peak "
            f"{r['peak']} B above the process's before the runner (state {r['state']} B), "
            f"{r['allocs']} allocations over the timed chunks ({card})")


# a solve of 8 chunks of 16 steps, a chunk grown to 256 and a tail of 7
# (models/loop.drive_chunks: GROW_AFTER 8, 16x): a runner of each length
SOLVE_STEPS = 8 * 16 + 256 + 7


def mesh_chunk_peaks(mesh, device, fa, steps=16, B=1024):
    """Every rank's peak bytes over a ``steps``-step chunk of B6 (fixed)
    and of B9 at config 7 on this clause mesh, after a warm-up chunk, above
    what the rank held before its runner and state were made; then over a
    whole ``simulate_batch_sharded`` through B6 with a wall-clock budget
    (so no dispatch, and the chunk grows) of :data:`SOLVE_STEPS` steps,
    which builds runners of 16, 256 and 7 steps, above what the rank held
    before it (and the steps it ran). Gathered to every rank (rank order).
    Only entry points that the parent trees have. Run in a spawned world."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from odesat_tpu_torch.interop import state_from_numpy
    from odesat_tpu_torch.models.ode import formula_device, state_dtype
    from odesat_tpu_torch.models.stoch import init_stoch_state
    from odesat_tpu_torch.parallel import sharded
    from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig

    ode = ODEConfig(step_size=0.01)
    peaks = {}
    for name in ("B6", "B9"):
        gc.collect()
        torch.cuda.synchronize(device)
        dist.barrier()
        base = torch.cuda.memory_allocated(device)
        if name == "B6":
            rng = np.random.default_rng(5)
            v = rng.uniform(-1, 1, (B, fa.n_vars_padded)).astype(np.float32)
            xs = np.broadcast_to(fa.xs_init, (B, fa.n_clauses_padded)).astype(np.float32)
            state, dev = sharded.shard_inputs(
                state_from_numpy(v, xs, np.ones_like(xs), np.full(B, 0.01, np.float32),
                                 np.zeros(B, bool), device=device),
                formula_device(fa, device, dtype=state_dtype(ode)), mesh)
            chunk = sharded.make_sharded_chunk_runner(fa, ode.resolve_zeta(fa.density), ode,
                                                      steps, mesh, device)

            def run(st):
                return chunk(st, dev)
        else:
            state = sharded.shard_stoch_inputs(init_stoch_state(fa, B, device), mesh)
            run = sharded.make_clause_stoch_runner(fa, steps, device,
                                                   sharded.row_generator(5, mesh),
                                                   mesh.clause_group, "float32", "auto")
        state = run(state)
        torch.cuda.synchronize(device)
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(device)
        state = run(state)
        torch.cuda.synchronize(device)
        peaks[name] = torch.cuda.max_memory_allocated(device) - base
        del run, state
        if name == "B6":
            del chunk, dev
    gc.collect()
    torch.cuda.synchronize(device)
    dist.barrier()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    config = SolverConfig(ode=ODEConfig(step_size=0.01, steps=SOLVE_STEPS), batch_size=B,
                          seed=5, chunk_steps=16, wall_clock_budget_s=3600.0)
    result = sharded.simulate_batch_sharded(fa, config, mesh, device=device)
    torch.cuda.synchronize(device)
    peaks["solve"] = torch.cuda.max_memory_allocated(device) - base
    peaks["solve_steps"] = result.steps
    del result
    gc.collect()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, peaks)
    return every


def mesh_peaks_line(S, every, card, origin="this tree"):
    ranks = ", ".join(f"rank {r}: B6 {p['B6']} B9 {p['B9']} solve {p['solve']} "
                      f"({p['solve_steps']} steps)" for r, p in enumerate(every))
    return (f"[mesh peaks] config 7 B=1024 S={S} ({S} ranks sharing the card, {origin}), each "
            f"rank's peak bytes over a 16-step chunk above what it held before its runner and "
            f"state, and over a simulate_batch_sharded through B6 with a wall-clock budget "
            f"(chunks of 16, a grown 256 and a tail of 7) above what it held before: {ranks} "
            f"({card})")


def time_loop(root):
    """``--time-loop ROOT``: with the port of the checkout at ROOT (a parent
    tree unpacked beside this one, or this one), phase 6's inter runs on
    hard.cnf (f32, bf16) and its busy share, phase 10's stoch runs on
    hard.cnf, B1-B4 per launch at phases 7, 11 and 14's shapes, phase 24's
    exact time to solution on uf250 seeds 0-2, and the host loop's cost a
    chunk; this tree's device loop's where ROOT has one (a chunk's cost and
    a dispatch of 0 chunks); phase 16b's fixed pallas step, host-paced and
    captured; phases 27d's and 30b's peak memory, of their CLI runs and in
    process; and phase 25d where ROOT donates its state."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(root))
    import odesat_tpu_torch
    from odesat_tpu_torch.ops import fused_chunk as fc
    from odesat_tpu_torch.ops import stoch_chunk as sc
    from odesat_tpu_torch.ops import stream_chunk as stc
    from odesat_tpu_torch.tools import uf250_tts
    from odesat_tpu_torch.utils.config import ODEConfig
    from odesat_tpu_torch.utils.timing import cuda_ms

    if not os.path.abspath(odesat_tpu_torch.__file__).startswith(os.path.abspath(root) + os.sep):
        fail(f"odesat_tpu_torch came from {odesat_tpu_torch.__file__}, not {root}")
    card = phase_device(torch)
    origin = f"the port at {root}"
    hard_path = os.path.join(ROOT, "tests", "data", "hard.cnf")
    run_inter(fc, ["-f", hard_path, "-b", "16384", "-s", "0.01", "-n", "1024", "--seed", "0"])
    f32_walls = []
    for mm in ("float32", "bfloat16", "float32", "bfloat16"):
        _, launches, steps, _, seconds = run_inter(
            fc, ["-f", hard_path, "-b", "16384", "-s", "0.01", "-n", "4096", "--seed", "0",
                 "--matmul-dtype", mm])
        say(f"[loop timing] {origin}: inter hard.cnf B=16384 {mm} -n 4096: {steps} steps in "
            f"{seconds:.6f} s = {16384 * steps / seconds:.6e} traj*steps/s, {launches} B1 "
            f"launches ({card})")
        if mm == "float32":
            f32_walls.append((seconds, launches))
    wall, share = busy_share(torch)
    share = f"{share:.4f}" if share is not None else "not measured (no device time traced)"
    say(f"[loop timing] {origin}: hard.cnf B=16384 fixed 4096 steps in process after a "
        f"warm-up: wall {wall:.6f} s, the card busy {share} of it under torch.profiler ({card})")
    for mm in ("float32", "bfloat16", "float32", "bfloat16"):
        _, launches, steps, _, seconds, _ = run_cli(
            stoch_counters(fc, sc), "stoch",
            ["-f", hard_path, "--no-preprocess", "-b", "16384", "-n", "4096", "--seed", "0",
             "--matmul-dtype", mm])
        say(f"[loop timing] {origin}: stoch --no-preprocess hard.cnf B=16384 {mm} -n 4096: "
            f"{steps} steps in {seconds:.6f} s = {16384 * steps / seconds:.6e} chain*steps/s, "
            f"B3 launches {launches['stoch_fused']} ({card})")
    # B1-B4 per launch, the kernels alone (CUDA events over back-to-back calls)
    hard = load_cases_hard()
    from odesat_tpu_torch.models.stoch import init_stoch_state

    n1k_reduced = preprocessed_n1k()
    n1k_ode = load_stream_cases(n1k_reduced)[0][1]
    _, n1k_stoch = load_stoch_cases([], n1k_reduced)
    fixed = ODEConfig(step_size=0.01)
    b1 = fc.make_fused_chunk(hard, 0.05, fixed, 256, "cuda")
    b2 = stc.make_stream_chunk(n1k_ode, 0.05, fixed, 8, "cuda")
    b3 = sc.make_stoch_chunk(hard, 64, "fused", "float32", "cuda")
    b4 = sc.make_stoch_chunk(n1k_stoch, 8, "stream", "float32", "cuda")
    s1, s2 = random_state(hard, 16384, seed=3), random_state(n1k_ode, 10240, seed=3)
    s3, s4 = init_stoch_state(hard, 16384, "cuda"), init_stoch_state(n1k_stoch, 8192, "cuda")
    for label, call in (("B1 hard.cnf B=16384 256-step", lambda: b1(s1)),
                        ("B2 n1k B=10240 8-step", lambda: b2(s2)),
                        ("B3 hard.cnf B=16384 64-step", lambda: b3(s3, 5)),
                        ("B4 n1k B=8192 8-step", lambda: b4(s4, 5))):
        ms = [cuda_ms(call, iters=10, warmup=2) for _ in range(2)]
        say(f"[loop timing] {origin}: {label} {ms[0]:.6f} / {ms[1]:.6f} ms a launch ({card})")
        if label.startswith("B1"):
            for seconds, launches in f32_walls:
                say_kernel_share(seconds, launches, sum(ms) / 2, card, origin)
    out = uf250_tts.measure(3, 4096, 64, 20000, "bfloat16", "cuda")
    for seed, res, verified, bd in out["rows"]:
        say(f"[loop timing] {origin}: uf250 seed {seed} B=4096 bf16: solved {res.solved} "
            f"(verified {verified}) at exact step {bd['steps']} in {res.chunks} chunks, wall "
            f"{bd['wall_s']:.6f} s = compute {bd['compute_s']:.6f} + dispatch "
            f"{bd['dispatch_s']:.6f} + residual {bd['residual_s']:.6f} s ({card})")
    try:
        from odesat_tpu_torch.ops import device_loop  # noqa: F401
    except ImportError:
        device_loop = None
    if device_loop is None:
        from odesat_tpu_torch.models.loop import run_chunks

        state = random_state(hard, 16384, seed=1)
        host = run_chunks(lambda st: st, 1, 2000)
        host(state)
        t0 = time.perf_counter()
        host(state)
        say(f"[loop timing] {origin}: the host loop's cost a chunk (done.any() read) "
            f"{(time.perf_counter() - t0) * 1e3 / 2000:.6f} ms ({card})")
    else:
        say_loop_iteration(torch, card, origin)
    # phase 16b's fixed pallas step, host-paced and captured
    from odesat_tpu_torch.ops import rhs_kernel as rk

    host_ms, captured_ms = step_walls(torch, hard, ODEConfig(step_size=0.01, dv_strategy="pallas"),
                                      4096)[:2]
    say(f"[loop timing] {origin}: 16b hard.cnf B=4096 fixed --dv-strategy pallas: a step's "
        f"wall {captured_ms:.6f} ms captured (8 calls of the 64-step scan chunk, copies "
        f"included), {host_ms:.6f} ms host-paced (host clock) ({card})")
    # 27d and 30b: their CLI runs' and in-process peaks (the phases' own lines)
    phase_scan_full_width(torch, fc, stc, rk, card)
    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables

    w = FULL_WIDTH
    formula, path = full_width_formula()
    stoch_scan_cli(torch, sc, f"30b n={w['n']} m={w['m']}", path, w["B"], 2 * STOCH_SCAN_CHUNK,
                   ["--chunk-steps", str(STOCH_SCAN_CHUNK)], card)
    fa = compile_formula(normalize_cnf_variables(formula)[1])
    stoch_scan_case(torch, f"30b n={w['n']}", fa, w["B"], 1, card)
    if hasattr(device_loop, "StateBuffers"):  # 25d where the tree donates its state
        phase_donation(torch, card)
    return 0


# ------------------------------------------------ the pod mesh (phase 26)

# One process of a pod: the CLI's own main on argv[2:], then its ranks'
# launch counts, the libraries its ranks loaded and its clock; with argv[1]
# "time", then also a 2x2 world of the same pod timing config 7's B6 step.
POD_DRIVER = """
import json, sys, time
t0 = time.perf_counter()
from odesat_tpu_torch import cli
from odesat_tpu_torch.ops import _cuda
from odesat_tpu_torch.parallel import launch, multihost, sharded
t_import = time.perf_counter() - t0
rc = cli.main(sys.argv[2:])
t_cli = time.perf_counter() - t0
print("[pod] " + json.dumps({"reports": launch.last_reports, "import_s": t_import,
                             "cli_s": t_cli, "libraries": sorted(
                                 _cuda.build(n)["path"] for n in launch.CUDA_SOURCES)}),
      flush=True)
if rc == 0 and sys.argv[1] == "time":
    from odesat_tpu_torch.cnf import normalize_cnf_variables, parse_dimacs_file
    from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded
    from odesat_tpu_torch.utils.config import ODEConfig
    argv = sys.argv[2:]
    fa = compile_stream_sharded(normalize_cnf_variables(parse_dimacs_file(
        argv[argv.index("-f") + 1]))[1], 2)[0]
    ode = ODEConfig(step_size=0.01)
    ms = launch.spawn(sharded.time_ode_chunk, 2, 2, "gloo", "cuda", timeout_s=300,
                      args=(fa, ode.resolve_zeta(fa.density), ode, 16, 1024, 2),
                      collective_timeout_s=120, pod=multihost.current_pod())
    print("[pod] " + json.dumps({"step_ms": ms}), flush=True)
sys.exit(rc)
"""
POD_TIMEOUT_S = 240  # each process of a pair


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def pod_start(argv, local_ranks, mode="cli", processes=(0, 1), timeout=60, outputs=None):
    """Start processes ``processes`` of a two-process pod on this host (both,
    or one alone), each running POD_DRIVER over the CLI's ``argv`` with the
    coordinator flags, ``LOCAL_WORLD_SIZE=local_ranks`` and a collective
    timeout of ``timeout`` s (``outputs[i]``: process i's ``-o``). Returns
    (start time, the processes)."""
    coord = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "LOCAL_WORLD_SIZE": str(local_ranks)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", POD_DRIVER, mode, *argv, "--coordinator", coord,
         "--num-processes", "2", "--process-id", str(i), "--dist-backend", "gloo",
         "--dist-timeout", str(timeout), *(["-o", outputs[i]] if outputs else [])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env)
        for i in processes]
    return t0, procs


def pod_wait(label, started):
    """Wait for a pair from :func:`pod_start`, each process bounded by
    POD_TIMEOUT_S (then every one is killed and the phase fails). Returns
    (wall s, [(returncode, stdout, its [pod] records merged)])."""
    t0, procs = started
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=POD_TIMEOUT_S)
            records = {}
            for line in out.splitlines():
                if line.startswith("[pod] "):
                    records.update(json.loads(line[len("[pod] "):]))
            results.append((p.returncode, out, records))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        fail(f"26{label}: a process of the pod outlived {POD_TIMEOUT_S} s")
    return time.perf_counter() - t0, results


def pod_verdict(label, rc, out):
    """(verdict, steps, solved, solve seconds) of a pod process's CLI run."""
    if rc != 0:
        fail(f"26{label}: a process of the pod exited {rc}:\n{out[-4000:]}")
    m = re.search(r"Steps run: (\d+) \| (?:trajectories|chains) solved: (\d+)/(\d+) \| "
                  r"([0-9.]+) s", out)
    verdict = re.search(r"Checking if solution vector satisfies formula: (true|false)", out)
    if m is None or verdict is None:
        fail(f"26{label}: a process printed no steps line or verdict:\n{out[-4000:]}")
    return verdict.group(1), int(m.group(1)), int(m.group(2)), float(m.group(4))


def pod_launches(label, results, kernel, ranks):
    """Each rank's launches of ``kernel``, B7's fused reads and its
    standalone calls over the pair, in global rank order; fails unless all
    ``ranks`` ranks launched ``kernel`` and both processes' ranks loaded the
    same libraries."""
    reports = [r for _, _, records in results for r in records.get("reports", [])]
    counts = [r[kernel] for r in reports]
    if len(counts) != ranks or min(counts) == 0:
        fail(f"26{label}: {kernel} launched on ranks {counts}, expected all {ranks}")
    libraries = {tuple(records.get("libraries", ())) for _, _, records in results}
    if len(libraries) != 1:
        fail(f"26{label}: the processes loaded different libraries {libraries}")
    return counts, [r["butterfly_fused"] for r in reports], [r["butterfly"] for r in reports]


def pod_startup(results, runs):
    """Each process's start-up: its CLI run less its solve and its import of
    the package (the parse, the compile, the join over the TCPStore, the
    spawn and the ranks' own start-up), s."""
    return [round(rec["cli_s"] - rec["import_s"] - run[3], 3)
            for (_, _, rec), run in zip(results, runs)]


def pod_budget(label, runs, budget):
    for verdict, steps, solved, _ in runs:
        if not ((verdict == "false" and steps == budget and solved == 0) or
                (solved and verdict == "true")):
            fail(f"26{label}: expected false after exactly {budget} steps or a verified "
                 f"solution, got {verdict} after {steps} with {solved} solved")


def phase_pod(card):
    """Phase 26: the pod mesh on the card, two CLI processes of one job on
    this host (gloo; they share the one card, so this proves the TCPStore
    world, the global ranks, clause groups inside a process, the shared seed
    and the verdict on every process, not NVLink or a network). Returns the
    launches of B1, B6, B9 and B7 fused of its CLI runs, summed over the
    ranks."""
    c7_path = os.path.join(OUT, "local_n10240_m43700.cnf")  # written by phase 20
    uf_path = os.path.join(OUT, "uf250_seed0.cnf")  # written by phase 5
    launches = {"fused_chunk": 0, "shard_chunk": 0, "stoch_shard_chunk": 0,
                "butterfly_fused": 0, "device_loop_mesh": 0}
    c7_20 = MESH_STARTUP.get("b. inter config 7 B=1024", float("nan"))

    # a. a 2x2 mesh on config 7: a clause group of two inside each process,
    # the trajectory axis across the processes; then its B6 step timed in a
    # second world of the same pod. Each process has its own -o, so that a
    # write by process 1 would show.
    outs = [os.path.join(OUT, f"pod_a_{i}.txt") for i in range(2)]
    ref_out = os.path.join(OUT, "pod_a_one_process.txt")
    for path in (*outs, ref_out):
        if os.path.exists(path):
            os.remove(path)
    argv = ["inter", "-f", c7_path, "-b", "1024", "-s", "0.01", "-n", "64", "--seed", "0"]
    wall, results = pod_wait("a", pod_start(argv + ["--pod-mesh", "--clause-shards", "2"], 2,
                                            "time", outputs=outs))
    runs = [pod_verdict("a", rc, out) for rc, out, _ in results]
    pod_budget("a", runs, 64)
    b6, fused, standalone = pod_launches("a", results, "shard_chunk", 4)
    if min(fused) == 0 or sum(standalone):
        fail(f"26a: B7 fused reads per rank {fused}, standalone B7 calls {standalone}")
    if not os.path.exists(outs[0]) or os.path.exists(outs[1]):
        fail(f"26a: -o written by {[os.path.exists(p) for p in outs]}, expected process 0 "
             "alone")
    launches["shard_chunk"] += sum(b6)
    launches["butterfly_fused"] += sum(fused)
    step_ms = results[0][2].get("step_ms")
    if step_ms is None:
        fail("26a: the 2x2 step timing printed nothing")
    startup = pod_startup(results, runs)
    # b. a trajectory-only pod: one rank a process, B1 on each; d. a lone
    # process 1 of a pair whose process 0 never comes; c. the stoch engine
    # on the 2x2 pod through B9: all three at the same time, beside a's
    # single-process run (none is timed but by its wall), so that their
    # start-ups overlap
    lone = pod_start(["inter", "-f", uf_path, "-b", "4096", "-s", "0.01", "-n", "20000",
                      "--seed", "0", "--pod-mesh"], 1, processes=(1,), timeout=10)
    pair_b = pod_start(["inter", "-f", uf_path, "-b", "4096", "-s", "0.01", "-n", "20000",
                        "--seed", "0", "--pod-mesh"], 1)
    pair_c = pod_start(["stoch", "--no-preprocess", "-f", c7_path, "-b", "1024", "-n", "32",
                        "--seed", "0", "--pod-mesh", "--clause-shards", "2"], 2)
    try:
        # the same command on one process: --devices 2 --clause-shards 2
        t_one = time.perf_counter()
        verdict, reports, steps, solved, seconds, _ = run_cli_mesh(
            argv[0], [*argv[1:], "--devices", "2", "--clause-shards", "2", "--dist-backend", "gloo",
                      "-o", ref_out])
        t_one = time.perf_counter() - t_one
        with open(outs[0], encoding="utf-8") as a_fh, open(ref_out, encoding="utf-8") as r_fh:
            same = a_fh.read() == r_fh.read()
        if not same or {r[1] for r in runs} != {steps} or {r[0] for r in runs} != {verdict}:
            fail(f"26a: the pod's assignment and steps {[r[:2] for r in runs]} differ from the "
                 f"single-process 2x2 run's ({verdict}, {steps}; assignment equal: {same})")
        one_b6 = [r["shard_chunk"] for r in reports]
        launches["shard_chunk"] += sum(one_b6)
        launches["butterfly_fused"] += sum(r["butterfly_fused"] for r in reports)
        say(f"[pod] a. inter config 7 -b 1024 -n 64 --seed 0 --pod-mesh --clause-shards 2, 2 "
            f"processes x LOCAL_WORLD_SIZE=2 (a 2x2 mesh, a clause group inside each process): "
            f"verdicts {[r[0] for r in runs]} after {[r[1] for r in runs]} steps, B6 launches per "
            f"rank {b6}, of them reading both ranks' slots (B7 fused) {fused}, standalone B7 "
            f"{standalone}; process 0 alone wrote -o, equal to the single-process --devices 2 "
            f"--clause-shards 2 run's bit for bit ({verdict} after {steps} steps, B6 per rank "
            f"{one_b6}) ({card})")
        say(f"[pod timing] a. the pair's wall {wall:.1f} s with its timing world; start-up a "
            f"process (its CLI run less its solve and its import) {startup} s, beside phase 20's "
            f"single-process S=2 run on config 7 {c7_20:.3f} s and this single-process 2x2 run "
            f"{t_one - seconds:.3f} s (beside pods b, c and d); the 2x2 pod's inter step through "
            f"B6 {step_ms:.6f} ms (host clock around 2 chunks of 16 steps, B=1024 a trajectory "
            f"row; two processes of two ranks sharing the card) ({card})")

        wall_b, results = pod_wait("b", pair_b)
        runs = [pod_verdict("b", rc, out) for rc, out, _ in results]
        if [r[0] for r in runs] != ["true", "true"]:
            fail(f"26b: verdicts {[r[0] for r in runs]}, expected true on both processes")
        b1, _, _ = pod_launches("b", results, "fused_chunk", 2)
        graphs = [r["device_loop_mesh"] for _, _, rec in results for r in rec.get("reports", [])]
        if graphs != [graphs[0]] * 2 or graphs[0] == 0:
            fail(f"26b: mesh device-loop graph launches per rank {graphs}, expected the same "
                 "number, at least one, on both processes")
        launches["fused_chunk"] += sum(b1)
        launches["device_loop_mesh"] += sum(graphs)
        say(f"[pod] b. inter uf250 -b 4096 -n 20000 --seed 0 --pod-mesh, 2 processes of one rank "
            f"(the trajectory axis across them): verdicts {[r[0] for r in runs]}, "
            f"{[r[2] for r in runs]} solved after {[r[1] for r in runs]} steps, B1 launches per "
            f"rank {b1} in mesh device-loop graphs {graphs} (the stop exchanged across the two "
            f"processes); pair wall {wall_b:.1f} s, start-up a process "
            f"{pod_startup(results, runs)} s, beside pods c and d and a's single-process run "
            f"({card})")
        wall_d, ((rc, out, _),) = pod_wait("d", lone)
        if rc == 0 or "Checking if solution vector" in out or "error:" not in out or wall_d > 60:
            fail(f"26d: a lone process 1 exited {rc} after {wall_d:.1f} s:\n{out[-3000:]}")
        say(f"[pod] d. process 1 alone (no process 0 hosts the store), --dist-timeout 10: exit "
            f"{rc} after {wall_d:.1f} s with no verdict: "
            f"{next(line for line in out.splitlines() if line.startswith('error:'))[:200]}")

        wall_c, results = pod_wait("c", pair_c)
        runs = [pod_verdict("c", rc, out) for rc, out, _ in results]
        pod_budget("c", runs, 32)
        b9, fused, standalone = pod_launches("c", results, "stoch_shard_chunk", 4)
        if min(fused) == 0 or sum(standalone):
            fail(f"26c: B7 fused reads per rank {fused}, standalone B7 calls {standalone}")
        launches["stoch_shard_chunk"] += sum(b9)
        launches["butterfly_fused"] += sum(fused)
        say(f"[pod] c. stoch --no-preprocess config 7 -b 1024 -n 32 --pod-mesh --clause-shards 2 "
            f"(2x2): verdicts {[r[0] for r in runs]} after {[r[1] for r in runs]} steps, B9 "
            f"launches per rank {b9}, B7 fused {fused}, standalone B7 {standalone}; pair wall "
            f"{wall_c:.1f} s, start-up a process {pod_startup(results, runs)} s, beside pods b and "
            f"d and a's single-process run ({card})")
    finally:
        # a failed check exits with the pods still running: stop them
        for _, procs in (lone, pair_b, pair_c):
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    return launches


# ------------------------------- the trajectory mesh's device loop (phase 28)


def mesh_loop_timing(mesh, device, fa, rows, routes=("host", "device"), empty=200, reps=3):
    """Phase 28a, on each rank of a trajectory mesh sharing the card: a
    chunk's cost on the mesh's multi-chunk loop, each route in ``routes``
    ("host": models/loop.run_chunks with parallel/dist.MeshSync; "device":
    parallel/sharded.make_sharded_multi_runner, the device loop exchanging
    the stop on the card). B1 at ``rows`` rows a rank of ``fa``, 256-step
    fixed chunks: the least of ``reps`` walls (host clock from a barrier to
    a device sync and a barrier) of a dispatch of bound 1 and of bound 16,
    the difference over 15 chunks; then bodies that launch nothing, bounds 1
    and ``empty``. And B1 alone at ``rows`` (CUDA events, one rank at a time
    while the other waits at a barrier). Returns rank 0's ms: {"kernel",
    route: {"b1_1", "b1_16", "b1_chunk", "empty_chunk"}}."""
    from types import SimpleNamespace

    import torch
    import torch.distributed as dist

    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.ops import device_loop as dl
    from odesat_tpu_torch.ops import fused_chunk as fc
    from odesat_tpu_torch.parallel.dist import MeshSync
    from odesat_tpu_torch.parallel.sharded import make_sharded_multi_runner
    from odesat_tpu_torch.utils.config import ODEConfig
    from odesat_tpu_torch.utils.timing import cuda_ms

    state = random_state(fa, rows, seed=40 + mesh.rank, device=device)
    b1 = fc.make_fused_chunk(fa, 0.05, ODEConfig(step_size=0.01), 256, device)
    # a chunk runner whose body launches nothing: the loop alone
    empty_chunk = dl.KernelChunk(lambda st, dev=None: st, lambda *args: (), 1,
                                 (SimpleNamespace(launches=0), "launches"))

    def settle():
        if state.v.is_cuda:
            torch.cuda.synchronize(device)
        dist.barrier()

    def wall(run):
        best = math.inf
        for _ in range(reps):
            settle()
            t0 = time.perf_counter()
            run(state)
            settle()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    def multi(route, chunk, steps, bound):
        if route == "host":
            return run_chunks(lambda st: chunk(st, None), steps, bound,
                              sync=MeshSync(mesh, device))
        return make_sharded_multi_runner(chunk, steps, bound, mesh, device)

    out = {}
    for route in routes:
        w1, w16 = (wall(multi(route, b1, 256, b)) for b in (1, 16))
        e1, en = (wall(multi(route, empty_chunk, 1, b)) for b in (1, empty))
        out[route] = {"b1_1": w1, "b1_16": w16, "b1_chunk": (w16 - w1) / 15,
                      "empty_chunk": (en - e1) / (empty - 1)}
    kernel = None
    for r in range(mesh.n_traj):
        if r == mesh.rank and state.v.is_cuda:
            kernel = cuda_ms(lambda: b1(state), iters=10, warmup=2)
        dist.barrier()
    out["kernel"] = kernel
    return out


MESH_LOOP_ARGV = (
    # label, argv (--devices 2 over gloo: two ranks sharing the card), kernel, budget
    ("inter hard.cnf B=16384 (B1)",
     ["inter", "-f", os.path.join(ROOT, "tests", "data", "hard.cnf"), "-b", "16384", "-s", "0.01",
      "-n", "4096", "--seed", "0"], "fused_chunk", 4096),
    ("stoch --no-preprocess hard.cnf B=16384 (B3)",
     ["stoch", "-f", os.path.join(ROOT, "tests", "data", "hard.cnf"), "--no-preprocess", "-b",
      "16384", "-n", "4096", "--seed", "0"], "stoch_fused", 4096),
    ("stoch n1k preprocessed B=8192 (B4)",
     ["stoch", "-f", os.path.join(OUT, "ksat_n1000_m4300_seed7_planted.cnf"), "-b", "8192", "-n",
      "4096", "--seed", "0"], "stoch_stream", 4096),
)


def say_mesh_loop_timing(timing, card, ranks=2, per_card=2):
    """Print phase 28a's lines (:func:`mesh_loop_timing`'s result) for
    ``ranks`` ranks, ``per_card`` of them on each card."""
    k = timing["kernel"]
    where = "sharing the card" if per_card == ranks else f"{per_card} a card"
    for route in ("host", "device"):
        t = timing.get(route)
        if t is None:
            continue
        say(f"[mesh loop timing] a. {route} loop, hard.cnf 8192 rows a rank, {ranks} ranks "
            f"{where}: a dispatch of one 256-step B1 chunk {t['b1_1']:.6f} ms, of 16 "
            f"{t['b1_16']:.6f} ms: {t['b1_chunk']:.6f} ms a chunk, "
            f"{t['b1_chunk'] - per_card * k:.6f} beyond the B1 launches a card runs ({k:.6f} "
            f"ms each, CUDA events, one rank at a time); bodies that launch nothing "
            f"{t['empty_chunk']:.6f} ms a chunk ({card})")


def time_mesh_loop(routes):
    """``--time-mesh-loop [host]``: phase 28a alone, both routes or the
    host loop alone: on one card two gloo ranks sharing it; on a host of
    several cards one NCCL rank a card (the stop exchanged over NVLink)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from odesat_tpu_torch.parallel import launch

    card = phase_device(torch)
    cards = torch.cuda.device_count()
    ranks, backend = (2, "gloo") if cards == 1 else (cards, "nccl")
    timing = launch.spawn(mesh_loop_timing, ranks, 1, backend, "cuda", timeout_s=600,
                          args=(load_cases_hard(), 8192, routes))
    say_mesh_loop_timing(timing, card, ranks, ranks // min(cards, ranks))
    return 0


def mesh_loop_cases(hard, uf250, n1k_ode, n1k_stoch):
    """Phase 28b's cases of parallel/sharded.loop_against_host_loop over
    two trajectory ranks, each state made on the ranks: B1 on hard.cnf
    B=16384 (256-step chunks) and B2 on the n=1k instance B=10240 (8-step),
    bounds 1, 3 and 16, stop on any and all, and a state stopped at entry on
    rank 1 only (its last row done for any, all its rows for all); B1 on
    uf250 B=4096 from a random start, 64-step chunks, bound 40 (the stop
    inside the dispatch); B3 on hard.cnf B=16384 (64-step) and B4 on the
    n=1k instance B=8192 (8-step), bounds 1, 3 and 16, and rank 1's last
    chain done at entry."""
    from odesat_tpu_torch.utils.config import ODEConfig

    cases, labels = [], []
    for name, fa, B, chunk, kernel in (("B1 hard.cnf", hard, 16384, 256, "fused"),
                                       ("B2 n1k", n1k_ode, 10240, 8, "stream")):
        ode = ODEConfig(step_size=0.01, dv_strategy=kernel)
        for rule in ("any", "all"):
            for bound in (1, 3, 16):
                cases.append(("ode", fa, ode, chunk, bound, rule, (B, 3, ())))
                labels.append(f"{name} B={B} bound {bound} {rule}")
            rows = [B - 1] if rule == "any" else range(B // 2, B)
            cases.append(("ode", fa, ode, chunk, 16, rule, (B, 3, rows)))
            labels.append(f"{name} B={B} {rule}, rank 1 stopped at entry")
    cases.append(("ode", uf250, ODEConfig(step_size=0.01, dv_strategy="fused"), 64, 40, "any",
                  (4096, 0, ())))
    labels.append("B1 uf250 B=4096 bound 40 any")
    for name, fa, B, chunk in (("B3 hard.cnf", hard, 16384, 64), ("B4 n1k", n1k_stoch, 8192, 8)):
        for bound in (1, 3, 16):
            cases.append(("stoch", fa, "on", chunk, bound, 11, (B, 5, ())))
            labels.append(f"{name} B={B} bound {bound}")
        cases.append(("stoch", fa, "on", chunk, 16, 11, (B, 5, [B - 1])))
        labels.append(f"{name} B={B}, rank 1 stopped at entry")
    return cases, labels


def mesh_loop_calls(hard, uf250, n1k_ode, n1k_stoch):
    """Phase 28's calls for phase 20's world (two ranks sharing the card),
    each on a 2x1 mesh of that world: 28a's timing at hard.cnf 8192 rows a
    rank, 28b's cases, then 28c's CLI runs (the CLI's parse and set-up,
    cli.mesh_call, then its mesh solve). Returns (calls, 28b's cases and
    their labels)."""
    from odesat_tpu_torch import cli
    from odesat_tpu_torch.parallel import launch, sharded

    cases, labels = mesh_loop_cases(hard, uf250, n1k_ode, n1k_stoch)
    calls = [(launch.on_mesh, ((2, 1), mesh_loop_timing, hard, 8192)),
             (launch.on_mesh, ((2, 1), sharded.loop_against_host_loop, cases))]
    with contextlib.redirect_stdout(io.StringIO()):  # the preprocessor's lines
        for _, argv, _, _ in MESH_LOOP_ARGV:
            fn, args = cli.mesh_call([*argv, "--devices", "2", "--dist-backend", "gloo"])
            calls.append((launch.on_mesh, ((2, 1), fn, *args)))
    return calls, (cases, labels)


def cli_verdict(argv, result):
    """Whether ``result``'s best assignment, mapped back as the CLI maps it
    (normalization, the preprocessor's witness), satisfies the original
    formula of ``argv``'s input."""
    from odesat_tpu_torch import cli
    from odesat_tpu_torch.cnf import evaluate_cnf, map_values_by_indices
    from odesat_tpu_torch.preprocess import reconstruct_witness

    args = cli._build_parser().parse_args(argv)
    formula = cli._load(args.input)
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, _, trace, var_mapping, _ = cli._prepare(args, formula)
    mapped = map_values_by_indices(var_mapping, result.best_assignment())
    if trace is not None:
        reconstruct_witness(mapped, trace)
    return evaluate_cnf(mapped, formula)


def phase_mesh_loop(cases, labels, values, reports, card):
    """Phase 28, from phase 20's world: a. the chunk's cost beyond B1 on the
    trajectory mesh, host loop against the device loop; b. the device loop
    against the host loop bit for bit (every case one graph launch a rank,
    the kernel launched the chunks run); c. the CLI's inter and stoch at
    --devices 2 through the device loop, one graph launch a dispatch on
    each rank. Returns the kernels line's numbers: {"ms", "plain_ms",
    "err", "launches"} (launches: 28c's graph launches, both ranks).
    ``reports[i]``: call i's launch counts on each rank."""
    timing, results, runs = values[0], values[1], values[2:]
    say_mesh_loop_timing(timing, card)
    worst, inside = 0.0, 0
    for case, label, (err, steps, host_steps, graphs, launches) in zip(cases, labels, results):
        engine, _, _, chunk, bound, rule, (_, _, rows) = case
        if err != 0.0 or steps != host_steps or graphs != 1 or launches != steps // chunk:
            fail(f"28b {label}: max abs err {err}, steps {steps} against the host loop's "
                 f"{host_steps}, {graphs} graph launches, {launches} kernel launches")
        if len(rows) and (engine == "stoch" or rule == "any") and steps != 0:
            fail(f"28b {label}: {steps} steps from a state stopped at entry")
        inside += not len(rows) and 0 < steps < bound * chunk
        worst = max(worst, err)
    if not inside:
        fail("28b: no dispatch stopped inside its bound")
    say(f"[mesh loop] b. {len(cases)} dispatches of the trajectory mesh's device loop (T=2, "
        f"one graph launch a rank) equal run_chunks with MeshSync bit for bit, steps included "
        f"(max abs err {worst}; {inside} stopped inside the dispatch, the stops at entry on "
        f"rank 1 ran no chunk anywhere): B1 hard.cnf B=16384 and uf250 B=4096, B2 n1k "
        f"B=10240, B3 hard.cnf B=16384, B4 n1k B=8192; mesh graph launches per rank "
        f"{[c['device_loop_mesh'] for c in reports[1]]} ({card})")
    graphs = 0
    for (label, argv, kernel, budget), result, counts in zip(MESH_LOOP_ARGV, runs, reports[2:]):
        mesh_graphs = [c["device_loop_mesh"] for c in counts]
        launched = [c[kernel] for c in counts]
        solved = bool(result.done.any())
        verdict = cli_verdict(argv, result) if solved else False
        if mesh_graphs != [1, 1] or [c["device_loop"] for c in counts] != [1, 1] or \
                min(launched) == 0:
            fail(f"28c {label}: mesh graph launches per rank {mesh_graphs}, {kernel} {launched}")
        if not ((not solved and result.steps == budget) or (solved and verdict)):
            fail(f"28c {label}: {int(result.done.sum())} solved after {result.steps} steps, "
                 f"verdict {verdict}")
        graphs += sum(mesh_graphs)
        say(f"[mesh loop] c. {label} --devices 2 (the CLI's mesh solve in phase 20's world): "
            f"{'true' if verdict else 'false'} after {result.steps} steps, one device-loop graph "
            f"launch a dispatch on each rank {mesh_graphs}, {kernel} launches per rank "
            f"{launched} ({card})")
    k = timing["kernel"]
    return {"ms": timing["device"]["b1_chunk"] - 2 * k,
            "plain_ms": timing["host"]["b1_chunk"] - 2 * k, "err": worst, "launches": graphs}


# ------------------- the mesh twin step's reductions on B7 (phase 29)

TWIN_STEPS = 8
TWIN_MODES = (("fixed", dict(step_size=0.01)), ("adaptive", dict(tolerance=1e-3)))
TWIN_C7_ARGV = ("--devices", "1", "--clause-shards", "2", "--dtype", "float64",
                "--dist-backend", "gloo")


def twin_config7(c7, S=2):
    """Config 7 laid out for the twin's clause step at ``S`` clause ranks in
    float64 (``compile_for_mesh`` with the f64 config: the plain layout,
    past B5's and B6's gate by its dtype)."""
    from types import SimpleNamespace

    from odesat_tpu_torch.cnf import normalize_cnf_variables
    from odesat_tpu_torch.parallel import sharded
    from odesat_tpu_torch.utils.config import ODEConfig, SolverConfig

    config = SolverConfig(ode=ODEConfig(step_size=0.01, dtype="float64"))
    return sharded.compile_for_mesh(normalize_cnf_variables(c7)[1], config,
                                    SimpleNamespace(n_clause=S))


def twin_ode(mode, dtype="float64", dt_mode="per-trajectory"):
    from odesat_tpu_torch.utils.config import ODEConfig

    return ODEConfig(**dict(TWIN_MODES)[mode], dtype=dtype, dt_mode=dt_mode)


def twin_state(mesh, device, fa, ode, B, seed=5):
    """This rank's block of a global twin state of ``B`` rows made on the
    card from ``seed`` (v ~ U(-1, 1), xs from the all-false valuation, xl
    = 1, dt = 0.01, none done) and its clause segment of the formula
    tensors."""
    import torch

    from odesat_tpu_torch.models.ode import ODEState, formula_device, state_dtype
    from odesat_tpu_torch.parallel import sharded

    dtype = state_dtype(ode)
    gen = torch.Generator(device=device).manual_seed(seed)
    v = torch.rand((B, fa.n_vars_padded), generator=gen, device=device, dtype=dtype) * 2 - 1
    xs = torch.as_tensor(fa.xs_init).to(device=device, dtype=dtype).expand(
        B, fa.n_clauses_padded).clone()
    state = ODEState(v, xs, torch.ones_like(xs), torch.full((B,), 0.01, dtype=dtype,
                                                            device=device),
                     torch.zeros(B, dtype=torch.bool, device=device))
    return sharded.shard_inputs(state, formula_device(fa, device, dtype=dtype), mesh)


@contextlib.contextmanager
def twin_route(route):
    """The twin step's reductions on ``route`` (None: the runner's own, B7
    on a card; "dist": torch.distributed, the route before B7 took them),
    where the tree has the choice (``sharded.TWIN_ROUTE``)."""
    from odesat_tpu_torch.parallel import sharded

    before = getattr(sharded, "TWIN_ROUTE", None)
    if hasattr(sharded, "TWIN_ROUTE"):
        sharded.TWIN_ROUTE = route
    try:
        yield
    finally:
        if hasattr(sharded, "TWIN_ROUTE"):
            sharded.TWIN_ROUTE = before


@contextlib.contextmanager
def counting_collectives(counts):
    """Count every torch.distributed collective called inside (into
    ``counts["dist"]``)."""
    import torch.distributed as dist

    names = ("all_reduce", "all_gather", "all_gather_object", "broadcast", "reduce",
             "gather", "scatter", "reduce_scatter", "all_to_all")
    saved = {n: getattr(dist, n) for n in names if hasattr(dist, n)}

    def wrap(fn):
        def counted(*a, **k):
            counts["dist"] += 1
            return fn(*a, **k)
        return counted

    for n, fn in saved.items():
        setattr(dist, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def b7_count():
    from odesat_tpu_torch.ops import butterfly as bf

    return bf.launches + getattr(bf, "launches_f64", 0)


def twin_timing(mesh, device, fa, ode, B, steps=TWIN_STEPS, reps=2, route=None):
    """29a and 29b: a rank's ms a step of the twin's mesh step
    (``make_sharded_chunk_runner``'s twin at ``ode`` on this mesh, ``B``
    global rows), host clock around ``reps`` chunks of ``steps`` steps after
    a warm-up chunk, each ending in a sync on every rank; then one chunk
    with the host clock around each reduction the steps make
    (``parallel/dist.mesh_reduce``, or ``all_reduce`` in a tree from
    before it), a device sync before and after each, its steps launched
    from Python where the tree captures them. Uses only entry points
    that trees from before B7 took the twin's sums also have, so that
    ``--time-mesh`` runs it on an older tree. Returns rank 0's ``{"step_ms",
    "reduce_ms" (a step's reductions), "calls" (reductions a step),
    "dist_calls" (torch.distributed collectives a step in the timed
    chunks), "b7" (B7 launches a step)}``."""
    import torch
    import torch.distributed as dist

    from odesat_tpu_torch.ops import scan_chunk
    from odesat_tpu_torch.parallel import dist as pdist
    from odesat_tpu_torch.parallel import sharded

    zeta = ode.resolve_zeta(fa.density)
    state, dev = twin_state(mesh, device, fa, ode, B)

    def settle():
        torch.cuda.synchronize(device)
        dist.barrier()

    with twin_route(route):
        run = sharded.make_sharded_chunk_runner(fa, zeta, ode, steps, mesh, device)
        run(state, dev)
        settle()
        counts, b7 = {"dist": 0}, b7_count()
        t0 = time.perf_counter()
        with counting_collectives(counts):
            for _ in range(reps):
                run(state, dev)
                settle()
        wall = (time.perf_counter() - t0) / (reps * steps) * 1e3
        b7 = (b7_count() - b7) / (reps * steps)
        name = "mesh_reduce" if hasattr(pdist, "mesh_reduce") else "all_reduce"
        plain, spent = getattr(pdist, name), [0.0, 0]

        def timed(*a, **k):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = plain(*a, **k)
            torch.cuda.synchronize(device)
            spent[0] += time.perf_counter() - t
            spent[1] += 1
            return out

        setattr(pdist, name, timed)
        # a sync around each reduction: the steps from Python, where a tree
        # captures the chunk
        paced = getattr(scan_chunk, "host_paced", contextlib.nullcontext)
        try:  # built after the swap: an older tree binds all_reduce when it builds
            with paced():
                sharded.make_sharded_chunk_runner(fa, zeta, ode, steps, mesh, device)(state, dev)
            settle()
        finally:
            setattr(pdist, name, plain)
    return {"step_ms": wall, "reduce_ms": spent[0] / steps * 1e3, "calls": spent[1] / steps,
            "dist_calls": counts["dist"] / (reps * steps), "b7": b7}


def busy_in(events, window, match=""):
    """ms the card was busy inside ``window`` (host clock, us), over the
    device events whose name holds ``match``: the union of their spans,
    clipped to the window."""
    spans = sorted((max(e.time_range.start, window[0]), min(e.time_range.end, window[1]))
                   for e in events if match in e.name)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b <= a:
            continue
        if a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return busy / 1e3


def twin_profile(mesh, device, fa, B, steps=TWIN_STEPS):
    """29c: config 7's twin clause step, fixed and adaptive, ``steps`` steps
    each under one torch.profiler session on every rank (a window a mode,
    marked with record_function and ending in a device sync; one session,
    since a process's later sessions miss each kernel's first launch).
    Returns every rank's ``{mode: (wall, busy, b7)}`` in ms a step: the
    window's wall, the rank's device time inside it (the union of its
    kernels' and copies' spans) and B7's part of it (``bfly_kernel``);
    busy None when the profiler read no device time."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from odesat_tpu_torch.parallel import sharded

    runs = {}
    for mode, _ in TWIN_MODES:
        ode = twin_ode(mode)
        state, dev = twin_state(mesh, device, fa, ode, B)
        runs[mode] = (sharded.make_sharded_chunk_runner(fa, ode.resolve_zeta(fa.density), ode,
                                                        steps, mesh, device), state, dev)
        runs[mode][0](state, dev)  # warm-up: B7's set-up, the segment table
    torch.cuda.synchronize(device)
    dist.barrier()
    walls = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for mode, (run, state, dev) in runs.items():
            dist.barrier()
            with record_function(f"twin29c {mode}"):
                t0 = time.perf_counter()
                run(state, dev)
                torch.cuda.synchronize(device)
                walls[mode] = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device_events = [e for e in events if e.device_type == DeviceType.CUDA]
    out = {}
    for mode in runs:
        # the host's range (the trace also names a device annotation so)
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == f"twin29c {mode}" and e.device_type == DeviceType.CPU]
        window = (min(a for a, _ in spans), max(b for _, b in spans))
        busy = busy_in(device_events, window)
        b7 = busy_in(device_events, window, "bfly_kernel")
        out[mode] = (walls[mode] / steps, busy / steps if busy > 0 else None, b7 / steps)
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, out)
    return seen


def host_call_recorder(torch):
    """A TorchFunctionMode that records (in ``.calls``) the calls that make
    a tensor from host values or read one back to the host."""
    from torch.overrides import TorchFunctionMode

    watched = {torch.Tensor.new_tensor: "new_tensor", torch.tensor: "torch.tensor",
               torch.as_tensor: "as_tensor", torch.Tensor.item: ".item()",
               torch.Tensor.tolist: ".tolist()", torch.Tensor.cpu: ".cpu()",
               torch.Tensor.__bool__: "bool()"}

    class Recorder(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in watched:
                self.calls.append(watched[func])
            return func(*args, **(kwargs or {}))

    return Recorder()


def twin_route_check(mesh, device, fa, B, steps=TWIN_STEPS):
    """Phase 29's checks of config 7's twin clause step at S=2 in float64,
    fixed and adaptive, ``steps`` steps from one state: on today's route
    (torch.distributed), and twice on B7's; then one more chunk on B7's
    route under a recorder of host reads and of torch.distributed calls.
    Returns rank 0's ``{mode: {"today": err, "repeat": err, "host": calls,
    "dist": calls, "b7": launches}}``: the largest bit error over every
    field and rank (``parallel/dist.bit_error``; a bool field that differs
    counts inf) against B7's first run, the calls recorded in the last
    chunk, and B7's launches in it."""
    import torch
    import torch.distributed as dist

    from odesat_tpu_torch.parallel import sharded
    from odesat_tpu_torch.parallel.dist import bit_error

    def err(a, b):
        worst = 0.0
        for x, y in zip(a, b):
            if x.dtype == torch.bool:
                worst = max(worst, 0.0 if torch.equal(x, y) else math.inf)
            else:
                worst = max(worst, bit_error(x.cpu(), y.cpu()))
        t = torch.tensor([worst], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    out = {}
    for mode, _ in TWIN_MODES:
        ode = twin_ode(mode)
        zeta = ode.resolve_zeta(fa.density)
        state, dev = twin_state(mesh, device, fa, ode, B)
        got = {}
        for label, route in (("today", "dist"), ("b7", None), ("repeat", None)):
            with twin_route(route):
                run = sharded.make_sharded_chunk_runner(fa, zeta, ode, steps, mesh, device)
                got[label] = run(state, dev)
        torch.cuda.synchronize(device)
        counts, b7, recorder = {"dist": 0}, b7_count(), host_call_recorder(torch)
        with counting_collectives(counts), recorder:
            run(got["b7"], dev)
        torch.cuda.synchronize(device)
        out[mode] = {"today": err(got["today"], got["b7"]), "repeat": err(got["repeat"], got["b7"]),
                     "host": sorted(set(recorder.calls)), "dist": counts["dist"],
                     "b7": b7_count() - b7}
    return out


def with_twin_route(mesh, device, route, fn, *args):
    """``fn(mesh, device, *args)`` with the twin step's reductions on
    ``route`` (:func:`twin_route`)."""
    with twin_route(route):
        return fn(mesh, device, *args)


def b7_tree_f64_check(torch, card):
    """B7's float64 kernel alone (``tree_cuda``) on S = 1 to 4 buffers of
    this process against the plain tree, bit for bit (a NaN equal to any
    NaN), with and without a max zone, at lengths 1, 7, 33*1025 and config
    7's (1024, Np+1) f64 buffer, on partials with NaN, signed zeros and
    infinities of both signs: the S = 3 tree, which no world of the smoke
    has, among them. Returns the largest error."""
    from odesat_tpu_torch.ops import butterfly as bf
    from odesat_tpu_torch.parallel.dist import bit_error, butterfly_inputs

    worst = 0.0
    for S in (1, 2, 3, 4):
        for i, shape in enumerate(((1,), (7,), (33 * 1025,), B7_SHAPE)):
            data = butterfly_inputs(shape, S, 1, 50 + 10 * S + i, "cuda", torch.float64)[0]
            parts = [data[k].contiguous() for k in range(S)]
            n = math.prod(shape)
            for zones in (None, (shape[-1], min(n, 3))):
                got = bf.tree_cuda(parts, zones)
                want = bf.combine_parts([p.cpu() for p in parts], zones)
                worst = max(worst, bit_error(got.cpu(), want))
    if worst != 0.0:
        fail(f"B7's float64 kernel differs from the plain tree: max abs err {worst}")
    say(f"[B7 f64] the float64 kernel alone (tree_cuda) on S = 1, 2, 3, 4 buffers equals the "
        f"plain tree bit for bit (max abs err {worst}; NaN, signed zeros, infinities of both "
        f"signs) at (1,), (7,), ({33 * 1025},) and {B7_SHAPE}, with and without a max zone "
        f"({card})")
    return worst


def twin_alone():
    """``--twin``: phase 29 alone: B7's float64 kernel against its plain
    tree in this process, then phase 29's calls in a world of two gloo
    ranks sharing the card, reported as the smoke reports them. On a host
    of several cards instead 29a at S=2 and S=4 (as many as there are
    cards), one NCCL rank a card, on B7's route and on NCCL's all-reduce
    (the route before it)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables
    from odesat_tpu_torch.parallel import launch
    from odesat_tpu_torch.utils.generate import uf_instance

    card = phase_device(torch)
    b7_tree_f64_check(torch, card)
    c7 = config7_instance()
    cards = torch.cuda.device_count()
    if cards > 1:
        for S in (2, 4) if cards >= 4 else (2,):
            calls = [(twin_timing, (twin_config7(c7, S), twin_ode(mode), 1024, TWIN_STEPS, 2,
                                    route)) for mode, _ in TWIN_MODES for route in (None, "dist")]
            values = launch.spawn(launch.run_all, 1, S, "nccl", "cuda", timeout_s=600,
                                  args=(calls,))
            for (mode, _), r in zip([m for m in TWIN_MODES for _ in range(2)], values):
                what = "B7" if r["b7"] else "NCCL's all-reduce"
                say(twin_line(f"29a config 7 B=1024 S={S} (one NCCL rank a card) f64 {mode}, "
                              f"through {what}", r, card))
        return 0
    uf250 = compile_formula(normalize_cnf_variables(uf_instance(250, seed=0))[1],
                            window_sort=True)
    fa_twin = twin_config7(c7)
    calls, argv, checks = twin_calls(fa_twin, uf250, config7_path(c7))
    values = launch.spawn(launch.run_all, 1, 2, "gloo", "cuda", timeout_s=600, args=(calls,))
    reports = [[r["calls"][i] for r in launch.last_reports] for i in range(len(calls))]
    phase_twin(values, reports, argv, checks, fa_twin, card)
    return 0


def twin_calls(fa_twin, uf250, c7_path):
    """Phase 29's calls for phase 20's world (two gloo ranks sharing the
    card): 29a at config 7 S=2 f64 B=1024 fixed and adaptive, 29b on a 2x1
    mesh of the world (uf250 B=4096, 2048 rows a rank, adaptive,
    --dt-mode shared), 29c, the route checks, ``inter`` on config 7 with
    TWIN_C7_ARGV through the CLI's mesh solve on today's route and on B7's,
    B7's float64 checks at S=2 and its timing beside gloo's all-reduce.
    Returns (calls, the inter argv, the checks)."""
    import torch

    from odesat_tpu_torch import cli
    from odesat_tpu_torch.parallel import launch
    from odesat_tpu_torch.parallel.dist import time_all_reduce, time_butterfly

    argv = ["inter", "-f", c7_path, "-b", "1024", "-s", "0.01", "-n", "16", "--seed", "0",
            *TWIN_C7_ARGV]
    with contextlib.redirect_stdout(io.StringIO()):
        fn, args = cli.mesh_call(argv)
    shape7 = (1024, fa_twin.n_vars_padded + 1)
    checks = b7_checks(shape7, torch.float64)
    calls = [(twin_timing, (fa_twin, twin_ode(mode), 1024)) for mode, _ in TWIN_MODES]
    calls += [(launch.on_mesh, ((2, 1), twin_timing, uf250,
                                twin_ode("adaptive", "float32", "shared"), 4096)),
              (twin_profile, (fa_twin, 1024)), (twin_route_check, (fa_twin, 1024)),
              (with_twin_route, ("dist", fn, *args)), (with_twin_route, (None, fn, *args)),
              (time_butterfly, (shape7, 20, 2, torch.float64)),
              (time_all_reduce, (shape7, 10, torch.float64))]
    return calls + twin_capture_calls(fa_twin, uf250) + checks, argv, checks


def twin_capture_calls(fa_twin, uf250):
    """Phase 29's captured chunks against host-paced
    (:func:`captured_against_host_paced`): 29a config 7 S=2 f64 fixed
    (64-step chunks) and adaptive (16), the stoch clause twin on the same
    plain layout (64), 29b uf250 T=2 adaptive --dt-mode shared (2048 rows
    a rank, 64)."""
    from odesat_tpu_torch.parallel import launch

    return [(captured_against_host_paced,
             ("twin", fa_twin, twin_ode("fixed"), 1024, CAPTURE_STEPS)),
            (captured_against_host_paced,
             ("twin", fa_twin, twin_ode("adaptive"), 1024, TWIN_CAPTURE_ADAPTIVE)),
            (captured_against_host_paced, ("stoch_twin", fa_twin, None, 1024, CAPTURE_STEPS)),
            (launch.on_mesh, ((2, 1), captured_against_host_paced, "twin", uf250,
                              twin_ode("adaptive", "float32", "shared"), 2048, CAPTURE_STEPS, 7,
                              1))]


TWIN_CAPTURE_ADAPTIVE = 16  # the adaptive f64 twin's captured chunk (61 ms a step)
TWIN = "the twin's mesh step"
TWIN_CAPTURE_LABELS = (("29a config 7 B=1024 S=2 f64 fixed", CAPTURE_STEPS, TWIN),
                       ("29a config 7 B=1024 S=2 f64 adaptive", TWIN_CAPTURE_ADAPTIVE, TWIN),
                       ("29 config 7 B=1024 S=2 (the plain layout, no shard plan)",
                        CAPTURE_STEPS, "the stoch clause twin"),
                       ("29b uf250 T=2 (2048 rows a rank) f32 adaptive --dt-mode shared",
                        CAPTURE_STEPS, TWIN))


def twin_line(label, r, card, origin="this tree"):
    return (f"[mesh twin] {label} ({origin}): {r['step_ms']:.6f} ms a step (host clock around 2 "
            f"chunks of {TWIN_STEPS} steps, each ending in a sync on every rank), its "
            f"reductions {r['reduce_ms']:.6f} ms a step ({r['calls']:.0f} a step, a sync "
            f"before and after each) = {r['reduce_ms'] / r['step_ms']:.4f} of the step; "
            f"torch.distributed collectives a step {r['dist_calls']:.0f}, B7 launches a step "
            f"{r['b7']:.0f} ({card})")


TWIN_LABELS = ("29a config 7 B=1024 S=2 (two ranks sharing the card) f64 fixed dt=0.01",
               "29a config 7 B=1024 S=2 (two ranks sharing the card) f64 adaptive tol 1e-3",
               "29b uf250 B=4096 T=2 (2048 rows a rank, sharing the card) f32 adaptive "
               "--dt-mode shared")


def phase_twin(values, reports, argv, checks, fa_twin, card):
    """Phase 29, from phase 20's world: the mesh twin step's reductions on
    B7. Prints 29a-29c and the checks; fails unless B7's float64 form
    equals its plain version bit for bit at S=2, the new route equals
    today's bit for bit and repeats itself, its steps make no
    torch.distributed call and read nothing back, and inter gives the same
    verdict and steps on both routes. Returns the kernels line's numbers
    for B7's float64 form: {"ms", "plain_ms", "library_ms", "bound_ms",
    "err", "launches"}."""
    import numpy as np

    timing_fixed, timing_adaptive, timing_shared, prof, check, today, new, b7, lib = values[:9]
    n_cap = len(TWIN_CAPTURE_LABELS)
    captured = {}
    for (label, steps, what), r, per_rank in zip(TWIN_CAPTURE_LABELS, values[9:9 + n_cap],
                                                 reports[9:9 + n_cap]):
        check_capture(label, r)
        launched = [c["mesh_step_chunk"] for c in per_rank]
        if min(launched) == 0 or r["b7"] == 0:
            fail(f"{label}: captured chunks per rank {launched}, B7 calls a chunk {r['b7']}")
        captured[label] = r
        say(capture_line(f"{label} (two ranks sharing the card), {what}", r, steps, card))
    values, reports = values[:9] + values[9 + n_cap:], reports[:9] + reports[9 + n_cap:]
    b7_ms, b7_plain = b7
    for label, r in zip(TWIN_LABELS, (timing_fixed, timing_adaptive, timing_shared)):
        say(twin_line(label, r, card))
        if r["dist_calls"] != 0 or r["b7"] == 0:
            fail(f"{label}: the twin step made {r['dist_calls']} torch.distributed calls a step "
                 f"and {r['b7']} B7 launches")
    for mode, _ in TWIN_MODES:
        per_rank = [p[mode] for p in prof]
        wall, busy, b7_busy = per_rank[0]
        if busy is None:
            say(f"[mesh twin] 29c config 7 S=2 f64 {mode}: the profiler read no device time; "
                f"a step's wall {wall:.6f} ms ({card})")
            continue
        others = ", ".join(f"{p[1] / p[0]:.4f}" for p in per_rank[1:] if p[1] is not None)
        say(f"[mesh twin] 29c config 7 B=1024 S=2 f64 {mode}, {TWIN_STEPS} steps under "
            f"torch.profiler: a step's wall {wall:.6f} ms on rank 0, its kernels' spans "
            f"{busy:.6f} ms ({busy / wall:.4f}; a span of a context that shares the card "
            f"holds the peer's turns too: the other ranks' {others}), B7 {b7_busy:.6f} ms of "
            f"it ({b7_busy / busy:.4f}); the host's share, the wall less the spans "
            f"{wall - busy:.6f} ms ({(wall - busy) / wall:.4f}): what capturing the chunk could "
            f"at most remove ({card})")
    for mode, c in check.items():
        if c["today"] != 0.0 or c["repeat"] != 0.0 or c["dist"] or c["host"] or not c["b7"]:
            fail(f"29 config 7 S=2 f64 {mode}: B7's route against today's max abs err "
                 f"{c['today']}, two runs {c['repeat']}, torch.distributed calls {c['dist']}, "
                 f"host reads {c['host']}, B7 launches {c['b7']}")
        say(f"[mesh twin] config 7 B=1024 S=2 f64 {mode}, {TWIN_STEPS} steps: B7's route equals "
            f"today's (torch.distributed) bit for bit (max abs err {c['today']}), two runs "
            f"bit-identical ({c['repeat']}); a chunk makes {c['b7']} B7 calls, no "
            f"torch.distributed call and no host read or tensor from a Python number ({card})")
    counts = reports[5:7]
    verdicts = [cli_verdict(argv, r) if r.done.any() else False for r in (today, new)]
    same = (today.steps == new.steps and np.array_equal(today.done, new.done)
            and np.array_equal(today.assignment, new.assignment) and verdicts[0] == verdicts[1])
    launched = [c["butterfly_f64"] for c in counts[1]]
    budget = int(argv[argv.index("-n") + 1])
    if not same or min(launched) == 0 or sum(c["butterfly_f64"] for c in counts[0]) or \
            not (verdicts[1] or (new.steps == budget and not new.done.any())):
        fail(f"29 inter config 7 {' '.join(TWIN_C7_ARGV)}: today's route {today.steps} steps "
             f"{int(today.done.sum())} solved, verdict {verdicts[0]}; B7's {new.steps}, "
             f"{int(new.done.sum())}, {verdicts[1]}; B7 f64 launches per rank {launched}")
    word = "true" if verdicts[1] else "false"
    say(f"[mesh twin] inter config 7 -b 1024 -s 0.01 -n {budget} {' '.join(TWIN_C7_ARGV)} (the "
        f"CLI's mesh solve in phase 20's world): today's route and B7's both print 'Steps run: "
        f"{new.steps} | trajectories solved: {int(new.done.sum())}/{new.done.size}' and "
        f"'Checking if solution vector satisfies formula: {word}', assignments bit-identical; "
        f"B7 f64 launches per rank {launched}, none on today's route ({card})")
    import torch

    per_call = [{k: [r[k] for r in call] for k in call[0]} for call in reports[9:]]
    b7_err = report_b7_checks(2, checks, values[9:], per_call, card, torch.float64)
    shape7 = (1024, fa_twin.n_vars_padded + 1)
    nbytes = math.prod(shape7) * 8
    bound_ms = 3 * nbytes / HBM_BYTES_PER_S * 1e3
    say(f"[B7 f64 timing] config 7 (B, Np+1) = {shape7} f64 ({nbytes} B) at S=2, two "
        f"ranks sharing the card: B7 {b7_ms:.6f} ms a call (host clock around 20 calls ending "
        f"in a sync on every rank), its plain version {b7_plain:.6f}, gloo's all-reduce "
        f"{lib:.6f}, bound {bound_ms:.6f} (3 x the buffer's bytes over 3.35 TB/s) ({card})")
    return {"ms": b7_ms, "plain_ms": b7_plain, "library_ms": lib, "bound_ms": bound_ms,
            "err": b7_err, "launches": sum(launched), "capture": captured,
            "capture_err": max(r["err"] for r in captured.values()),
            "chunks": sum(c["mesh_step_chunk"] for c in counts[1])}


SCAN_STRATEGIES = ("pallas", "gather", "segment_sum")
SCAN_MODES = ("fixed", "adaptive", "shared")
STATE_FIELDS = ("v", "xs", "xl", "dt", "done")


def scan_ode(strategy, mode, dtype="float32"):
    from odesat_tpu_torch.utils.config import ODEConfig

    return ODEConfig(step_size=0.01 if mode == "fixed" else None, dtype=dtype,
                     dt_mode="shared" if mode == "shared" else "per-trajectory",
                     dv_strategy=strategy)


def scan_runner(fa, ode, chunk_steps):
    """The scan chunk of ``chunk_steps`` steps (models/ode.make_chunk_runner),
    the step it captures and the formula tensors, on the card."""
    from odesat_tpu_torch.models.ode import (
        formula_device,
        make_chunk_runner,
        make_step_fn,
        state_dtype,
    )

    return (make_chunk_runner(fa, 0.05, ode, chunk_steps, "cuda"),
            make_step_fn(fa, 0.05, ode, device="cuda"),
            formula_device(fa, "cuda", state_dtype(ode)))


def b10_calls(ode):
    """B10 launches a step of ``ode``: one a fixed step, two an adaptive one."""
    return 0 if ode.dv_strategy != "pallas" else (1 if ode.step_size is not None else 2)


def phase_scan_compare(torch, rk, hard, uf250, card):
    """Phase 27a and e: the captured 16-step scan chunk against the same
    steps launched one by one on the card, exactly (max abs error 0, done
    equal), and a second replay bit-identical to the first, for pallas
    (B10), gather and segment_sum, fixed, adaptive and adaptive shared, f32
    and f64, at hard.cnf and uf250 B=4096; each replay counts one graph
    chunk and B10's launches of its steps. Returns the largest error."""
    from odesat_tpu_torch.ops import scan_chunk

    n, worst = 0, 0.0
    for label, fa in (("hard.cnf B=4096", hard), ("uf250 B=4096", uf250)):
        for strategy in SCAN_STRATEGIES:
            for mode in SCAN_MODES:
                for dtype in ("float32", "float64"):
                    ode = scan_ode(strategy, mode, dtype)
                    chunk, step, dev = scan_runner(fa, ode, 16)
                    state = random_state(fa, 4096, seed=n)
                    if dtype == "float64":
                        state = type(state)(*(t.double() if t.is_floating_point() else t
                                              for t in state))
                    want = state
                    for _ in range(16):
                        want = step(want, dev)
                    before = (scan_chunk.launches, rk.launches)
                    # the first result copied and dropped: its buffers serve again
                    got = copied(chunk(state, dev))
                    again = chunk(state, dev)
                    torch.cuda.synchronize()
                    case = f"{label} {strategy} {mode} {dtype}"
                    err, why = loop_compare(torch, got, want, STATE_FIELDS)
                    if why:
                        fail(f"scan chunk {case}: the captured chunk against its steps: {why}")
                    _, why = loop_compare(torch, again, got, STATE_FIELDS)
                    if why:
                        fail(f"scan chunk {case}: two replays differ: {why}")
                    counts = (scan_chunk.launches - before[0], rk.launches - before[1])
                    if counts != (2, 2 * 16 * b10_calls(ode)):
                        fail(f"scan chunk {case}: two replays counted {counts} (graph chunks, "
                             f"B10 launches)")
                    worst = max(worst, err)
                    n += 1
    say(f"[scan compare] {n} configurations (pallas, gather, segment_sum; fixed, adaptive, "
        f"shared; f32, f64; hard.cnf and uf250 B=4096): the captured 16-step chunk equal to its "
        f"steps launched one by one, max abs err {worst}; two replays bit-identical ({card})")
    return worst


def phase_scan_loop(torch, rk, hard, uf250, card):
    """Phase 27a's dispatches: the multi-chunk runner over the scan chunk
    (one device-loop graph launch: the captured chunk, then the stop kernel,
    under the WHILE node) against models/loop.run_chunks over the same
    chunk, bit for bit, steps included: pallas fixed on uf250 B=4096 from
    its initial state (the stop falls inside the dispatch), then from the
    state it leaves (stopped at entry: 0 chunks, the state untouched);
    gather adaptive f32 on hard.cnf stopping on any, and segment_sum
    adaptive shared f64 on hard.cnf stopping on all. Returns the largest
    error."""
    from odesat_tpu_torch.models.loop import run_chunks
    from odesat_tpu_torch.models.ode import init_state, make_multi_chunk_runner
    from odesat_tpu_torch.ops import scan_chunk

    def case(label, fa, ode, state, bound, stop_on, chunk_steps=64):
        chunk, _, dev = scan_runner(fa, ode, chunk_steps)
        multi = make_multi_chunk_runner(fa, 0.05, ode, chunk_steps, bound, "cuda",
                                        stop_on=stop_on, chunk=chunk)
        host = run_chunks(lambda st: chunk(st, dev), chunk_steps, bound,
                          stop_all=stop_on == "all")
        b10 = rk.launches
        err, ran, out = loop_case(torch, f"scan chunk {label}", lambda st: multi(st, dev), host,
                                  state, STATE_FIELDS, chunk_steps, bound,
                                  (scan_chunk, "launches"))
        host_b10 = ran * chunk_steps * b10_calls(ode)
        if rk.launches - b10 != 2 * host_b10:  # the host loop's replays, then the graph's
            fail(f"scan chunk {label}: B10 counted {rk.launches - b10} for 2 x {ran} chunks")
        say(f"[scan loop] {label}: {ran} of {bound} chunks in one graph launch, equal to the "
            f"host loop bit for bit (max abs err {err}) ({card})")
        return err, ran, out

    fixed = scan_ode("pallas", "fixed")
    init = init_state(uf250, 4096, torch.Generator(device="cuda").manual_seed(0), fixed, "cuda")
    worst, ran, out = case("pallas fixed uf250 B=4096 any", uf250, fixed, init, 20, "any")
    if not 0 < ran < 20:
        fail(f"scan chunk uf250: the stop fell at chunk {ran} of 20, not inside the dispatch")
    err, ran, _ = case("pallas fixed uf250 B=4096 any, stopped at entry", uf250, fixed, out, 20,
                       "any")
    if ran:
        fail(f"scan chunk uf250: {ran} chunks from a stopped entry state")
    worst = max(worst, err)
    hard_state = random_state(hard, 4096, seed=3)
    err, _, _ = case("gather adaptive hard.cnf B=4096 any", hard,
                     scan_ode("gather", "adaptive"), hard_state, 3, "any")
    worst = max(worst, err)
    f64 = type(hard_state)(*(t.double() if t.is_floating_point() else t for t in hard_state))
    err, _, _ = case("segment_sum shared f64 hard.cnf B=4096 all", hard,
                     scan_ode("segment_sum", "shared", "float64"), f64, 3, "all")
    return max(worst, err)


# at B=1024 a twin step takes 0.109 s on an H100 (80 s of this phase), so
# the smoke runs half the rows
FULL_WIDTH = dict(n=65536, m=280000, k=3, locality=512, seed=9, B=512, steps=512)


def full_width_formula():
    """27d's formula, written to a DIMACS file under OUT: (formula, path)."""
    from odesat_tpu_torch.cnf import cnf_to_dimacs
    from odesat_tpu_torch.utils.generate import random_local_ksat

    w = FULL_WIDTH
    formula = random_local_ksat(w["n"], w["m"], k=w["k"], locality=w["locality"],
                                seed=w["seed"])
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"local_n{w['n']}_m{w['m']}.cnf")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(cnf_to_dimacs(formula))
    return formula, path


def phase_scan_full_width(torch, fc, stc, rk, card):
    """Phase 27d: inter on a formula only the twin takes on one card:
    random_local_ksat(65536, 280000, k=3, locality=512, seed=9), config 7's
    generator (run_benchmarks.py:289-313) at 6.4x its variables (Np=65,536,
    past B2's fixed gate and B10's f32 one), -b 512 -s 0.01 -n 512 --seed 0
    through the CLI (B cut from 1024 for the smoke's time): its dispatches
    are device-loop graph launches around the captured chunk. Prints the
    verdict (false after exactly 512 steps, or a solved row the oracle
    verifies), the rate, the capture seconds and the peak memory. Then, at
    the same B, an 8-step captured chunk against the same 8 steps of the
    twin launched one by one from the same state: equal bit for bit (max
    abs error 0, done equal), twice, and each one's time a step. Returns
    (the CLI run's graph chunks, the largest error)."""
    import gc

    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables
    from odesat_tpu_torch.models.ode import (
        formula_device,
        init_state,
        make_chunk_runner,
        make_step_fn,
        resolve_strategy,
    )
    from odesat_tpu_torch.ops import scan_chunk
    from odesat_tpu_torch.utils.config import ODEConfig

    w = FULL_WIDTH
    formula, path = full_width_formula()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    scan_chunk.capture_seconds = 0.0
    verdict, launches, steps, solved, seconds, _ = run_cli(
        {**ode_counters(fc, stc, rk), "scan_chunk": (scan_chunk, "launches")}, "inter",
        ["-f", path, "-b", str(w["B"]), "-s", "0.01", "-n", str(w["steps"]), "--seed", "0"])
    peak = torch.cuda.max_memory_allocated()
    capture = scan_chunk.capture_seconds
    rate = w["B"] * steps / seconds
    if launches["fused_chunk"] or launches["stream_chunk"] or launches["rhs"]:
        fail(f"n={w['n']}: a kernel other than the twin ran: {launches}")
    if launches["device_loop"] == 0 or launches["scan_chunk"] != steps // 256:
        fail(f"n={w['n']}: {launches['device_loop']} graph launches, {launches['scan_chunk']} "
             f"graph chunks for {steps} steps of 256-step chunks")
    if solved == 0 and (verdict != "false" or steps != w["steps"]):
        fail(f"n={w['n']}: unsolved after {steps} steps with verdict {verdict}, not false after "
             f"exactly {w['steps']}")
    if solved and verdict != "true":
        fail(f"n={w['n']}: a row solved but the oracle refused its assignment")
    fa = compile_formula(normalize_cnf_variables(formula)[1])
    ode = ODEConfig(step_size=0.01)
    strategy = resolve_strategy(fa, ode, "cuda")
    ode = ODEConfig(step_size=0.01, dv_strategy=strategy)
    zeta = ode.resolve_zeta(fa.density)
    say(f"[scan full width] inter n={w['n']} m={w['m']} (Np={fa.n_vars_padded}, "
        f"Mp={fa.n_clauses_padded}, max_occ {fa.max_occ}, the twin's {strategy}) B={w['B']} "
        f"fixed dt 0.01: verdict {verdict}, {solved} solved after {steps} steps in "
        f"{seconds:.6f} s = {rate:.6e} traj*steps/s, {launches['device_loop']} device-loop graph "
        f"launches of {launches['scan_chunk']} captured 256-step chunks, capture and instantiate "
        f"{capture:.6f} s, peak memory {peak} B ({peak / 2**30:.3f} GiB) ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = formula_device(fa, "cuda")
    state = init_state(fa, w["B"], torch.Generator(device="cuda").manual_seed(0), ode, "cuda")
    step = make_step_fn(fa, zeta, ode, device="cuda")
    step(state, dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = state
    for _ in range(8):
        want = step(want, dev)
    torch.cuda.synchronize()
    eager = (time.perf_counter() - t0) / 8 * 1e3
    chunk = make_chunk_runner(fa, zeta, ode, 8, "cuda")
    got = chunk(state, dev)  # its capture, then a replay
    torch.cuda.synchronize()
    err, why = loop_compare(torch, got, want, STATE_FIELDS)
    if why:
        fail(f"n={w['n']} B={w['B']}: the captured 8-step chunk against its steps launched one "
             f"by one: {why}")
    del got
    t0 = time.perf_counter()
    again = chunk(state, dev)
    torch.cuda.synchronize()
    captured = (time.perf_counter() - t0) / 8 * 1e3
    _, why = loop_compare(torch, again, want, STATE_FIELDS)
    if why:
        fail(f"n={w['n']} B={w['B']}: two replays of the captured 8-step chunk differ: {why}")
    peak = torch.cuda.max_memory_allocated()
    say(f"[scan full width] 8 steps at B={w['B']}: the captured chunk equal to the steps "
        f"launched one by one bit for bit (max abs err {err}), twice; a step launched one by one "
        f"{eager:.6f} ms, in the captured chunk {captured:.6f} ms (copies included), "
        f"{captured / eager:.4f} of it (host clock, ending in a sync); peak memory in process "
        f"{peak} B ({peak / 2**30:.3f} GiB) ({card})")
    del again, want, state, chunk, step, dev
    gc.collect()
    torch.cuda.empty_cache()
    return launches["scan_chunk"], err


# --time-segment's shapes: (label, B on the card, B on the CPU); on the CPU
# 27d's formula runs at B=16, since its step at B=512 moves tens of GB
SEGMENT_SHAPES = (("hard.cnf", 4096, 4096), ("27d's n=65536 formula", 512, 16))


def time_segment(root, device="cuda"):
    """``--time-segment ROOT [cpu]``: with the port at ROOT (a parent tree
    unpacked beside this one, or this one), a fixed segment_sum step (dt
    0.01, float32, built without ``device=``, as every tree takes it)
    launched from Python a step at a time, at hard.cnf B=4096 and at 27d's
    formula B=512: host clock over the steps, ending in a sync (what a
    caller of the step pays; a checkout from before the scan chunk makes
    its constants from Python floats, which synchronizes every step).
    Where ROOT has segment_sum's sorted sum, the dv sum alone on the step's
    slots: ``index_add_`` (what the CPU, and a checkout from before it,
    run) against the sorted sum, device time with the launches queued
    (device_ms). With ``cpu``, both on the CPU by the host clock, 27d's
    formula at B=16. Two timings a shape. Run parent, this, this, parent."""
    import numpy as np
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; --time-segment without cpu runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(root))
    import odesat_tpu_torch
    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables
    from odesat_tpu_torch.models.ode import formula_device, make_step_fn
    from odesat_tpu_torch.ops import rhs as rhs_ops
    from odesat_tpu_torch.utils.config import ODEConfig

    if not os.path.abspath(odesat_tpu_torch.__file__).startswith(os.path.abspath(root) + os.sep):
        fail(f"odesat_tpu_torch came from {odesat_tpu_torch.__file__}, not {root}")
    if device == "cuda":
        card = phase_device(torch)
    else:
        card = f"CPU, {os.cpu_count()} cores, {torch.get_num_threads()} torch threads"

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def host_ms(fn, iters):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        return (time.perf_counter() - t0) / iters * 1e3

    ode = ODEConfig(step_size=0.01, dv_strategy="segment_sum")
    wide = compile_formula(normalize_cnf_variables(full_width_formula()[0])[1])
    for (label, b_card, b_cpu), fa in zip(SEGMENT_SHAPES, (load_cases_hard(), wide)):
        B = b_card if device == "cuda" else b_cpu
        state = random_state(fa, B, seed=5, device=device)
        dev = formula_device(fa, device)
        step = make_step_fn(fa, 0.05, ode)
        iters = 40 if fa is not wide else 8
        ms = [host_ms(lambda: step(state, dev), iters) for _ in range(2)]
        say(f"[segment step of {root}] {label} B={B} (Np={fa.n_vars_padded}, "
            f"Mp={fa.n_clauses_padded}): {ms[0]:.6f} / {ms[1]:.6f} ms a step, mean "
            f"{sum(ms) / 2:.6f} (host clock, ending in a sync) ({card})")
        if not hasattr(rhs_ops, "segment_table"):
            continue
        ids = fa.lit_var.reshape(-1).astype(np.int64)
        x = torch.rand(B, ids.size, generator=torch.Generator().manual_seed(5)).to(device)
        index = torch.as_tensor(ids, device=device)
        table = rhs_ops.segment_table(ids, fa.n_vars_padded, device)

        def index_add():
            return x.new_zeros(B, fa.n_vars_padded).index_add_(-1, index, x)

        def sorted_sum():
            return rhs_ops.segment_sum_sorted(x, table)

        sums = {"index_add_": [], "sorted": []}
        for name, fn in (("index_add_", index_add), ("sorted", sorted_sum),
                         ("sorted", sorted_sum), ("index_add_", index_add)):
            sums[name].append(device_ms(torch, fn, iters=iters) if device == "cuda" else
                              host_ms(fn, iters))
        kind = "device time, launches queued" if device == "cuda" else "host clock"
        say(f"[segment sum of {root}] {label} B={B}, {ids.size} slots into {fa.n_vars_padded} "
            f"variables: index_add_ {sums['index_add_'][0]:.6f} / {sums['index_add_'][1]:.6f} "
            f"ms, the sorted sum (segment_reduce) {sums['sorted'][0]:.6f} / "
            f"{sums['sorted'][1]:.6f} ms ({kind}) ({card})")
        del x, index, table
    return 0


def scan_peak():
    """``--scan-peak``: the peak memory of 27d's shape on the two scan paths
    of the CLI. inter (27d's run: one 256-step runner, its dispatches in the
    device loop), then batch, whose oracle-verified exit paces the chunks
    from the host and grows them: -b 512 -s 0.01 -n 1700 --chunk-steps 64
    runs 8 chunks of 64, one of 1024 and a tail of 164, three runners, each
    with its own state buffers and capture. Each run's peak
    (torch.cuda.max_memory_allocated, reset before it), steps, wall and
    capture seconds."""
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from odesat_tpu_torch.ops import fused_chunk as fc
    from odesat_tpu_torch.ops import rhs_kernel as rk
    from odesat_tpu_torch.ops import scan_chunk
    from odesat_tpu_torch.ops import stream_chunk as stc

    card = phase_device(torch)
    w = FULL_WIDTH
    _, path = full_width_formula()
    for cmd, extra in (("inter", ["-n", str(w["steps"])]),
                       ("batch", ["-n", "1700", "--chunk-steps", "64"])):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        scan_chunk.capture_seconds = 0.0
        _, launches, steps, solved, seconds, _ = run_cli(
            {**ode_counters(fc, stc, rk), "scan_chunk": (scan_chunk, "launches")}, cmd,
            ["-f", path, "-b", str(w["B"]), "-s", "0.01", "--seed", "0", *extra])
        peak = torch.cuda.max_memory_allocated()
        say(f"[scan peak] {cmd} n={w['n']} m={w['m']} -b {w['B']} -s 0.01 {' '.join(extra)}: "
            f"{solved} solved after {steps} steps in {seconds:.6f} s, {launches['scan_chunk']} "
            f"graph chunks, {launches['device_loop']} device-loop launches, capture and "
            f"instantiate {scan_chunk.capture_seconds:.6f} s, peak memory {peak} B "
            f"({peak / 2**30:.3f} GiB) ({card})")
    return 0


def scan_chunk_bound(fa, B, steps, itemsize=4):
    """The scan chunk: a step reads and writes v, xs and xl, and writes and
    reads the derivatives once; its operations are the ODE step's."""
    K, Mp = fa.lit_var.shape
    Np, nnz = fa.n_vars_padded, nnz_of(fa)
    nbytes = steps * 4 * itemsize * B * (Np + 2 * Mp)
    return bound(nbytes, B * steps * ode_step_ops(nnz, Np, Mp, True))


# ---------------------------------------- phase 30: the stoch twin captured

STOCH_SCAN_CHUNK = 64  # the in-process runners' chunk: one graph of 64 steps


def stoch_scan_cli(torch, sc, label, path, B, steps, extra, card):
    """30's CLI run of ``stoch`` on ``path`` at ``B`` chains: the twin's
    captured chunks counted (every other count set to 0 just before, read
    just after: no B3, B4 or device-loop launch), false after exactly
    ``steps`` steps or a solved chain that verifies. Returns the stoch
    graph chunks."""
    from odesat_tpu_torch.ops import scan_chunk

    scan_chunk.capture_seconds = 0.0
    torch.cuda.reset_peak_memory_stats()
    counters = {"stoch_fused": (sc, "fused_launches"), "stoch_stream": (sc, "stream_launches"),
                "stoch_scan_chunk": (scan_chunk, "stoch_launches")}
    verdict, launches, ran, solved, seconds, _ = run_cli(
        counters, "stoch", ["-f", path, "--no-preprocess", "-b", str(B), "-n", str(steps),
                            "--seed", "0", *extra])
    peak = torch.cuda.max_memory_allocated()
    chunks = launches["stoch_scan_chunk"]
    if launches["stoch_fused"] or launches["stoch_stream"] or launches.get("device_loop"):
        fail(f"stoch scan {label}: a kernel or the device loop ran: {launches}")
    if chunks == 0:
        fail(f"stoch scan {label}: the main path ran no captured chunk of the twin")
    if solved == 0 and (verdict != "false" or ran != steps):
        fail(f"stoch scan {label}: unsolved after {ran} steps with verdict {verdict}, not false "
             f"after exactly {steps}")
    if solved and verdict != "true":
        fail(f"stoch scan {label}: a chain solved but its assignment did not verify")
    say(f"[stoch scan] {label}: stoch {' '.join(extra) or '--fused auto'} -b {B} -n {steps}: "
        f"verdict {verdict}, {solved} solved after {ran} steps in {seconds:.6f} s = "
        f"{B * ran / seconds:.6e} "
        f"chain*steps/s, {chunks} captured chunks (no B3, B4 or device-loop launch), capture "
        f"and instantiate {scan_chunk.capture_seconds:.6f} s, peak memory {peak} B "
        f"({peak / 2**30:.3f} GiB) ({card})")
    return chunks


def stoch_host_paced(torch, step, state, n, gen, Np):
    """``n`` steps of the twin launched from Python, each drawing from
    ``gen``: the loop the captured chunk replaces."""
    for _ in range(n):
        state = step(state, torch.rand((state.v.shape[0], Np), generator=gen, device="cuda"))
    return state


def stoch_scan_check(torch, label, got, want, runner, host):
    """The captured chunk's chains against the host-paced loop's, bit for
    bit, and the two device generators in one state; fails otherwise."""
    torch.cuda.synchronize()
    err, why = loop_compare(torch, got, want, ("v", "xl", "done"))
    if why:
        fail(f"stoch scan {label}: the captured chunk against the host-paced steps: {why}")
    if not torch.equal(runner.device_generator.get_state(), host.get_state()):
        fail(f"stoch scan {label}: the device generator's state after the captured chunk "
             f"differs from the host-paced loop's")
    return err


def stoch_scan_case(torch, label, fa, B, calls, card):
    """30's in-process checks and times at ``fa``, ``B`` chains from the
    all-false start: a 64-step runner's captured chunks against the same
    steps launched from Python from a copy of its device generator, chunk
    1 (its capture) and chunk 2, bit for bit with the generators' states;
    a snapshot after chunk 1 (models/stoch.generator_states) restored into
    a runner built anew from another seed, whose chunk from chunk 1's
    chains equals chunk 2; with ``calls`` > 1 a 100-step runner (a graph of
    64 steps and one of 36) over two chunks the same way. A step's wall
    (host clock ending in a sync): captured over ``calls`` calls of the
    64-step chunk (copies included), host-paced over chunk 2's 64 steps.
    Returns the numbers."""
    import gc

    from odesat_tpu_torch.models.stoch import (
        generator_states,
        init_stoch_state,
        make_stoch_chunk_runner,
        make_stoch_step,
        restore_generators,
    )
    from odesat_tpu_torch.ops import scan_chunk

    n, Np = STOCH_SCAN_CHUNK, fa.n_vars_padded
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    scan_chunk.capture_seconds = 0.0
    step = make_stoch_step(fa, "cuda")
    runner = make_stoch_chunk_runner(fa, n, "cuda", torch.Generator().manual_seed(1),
                                     fused="off")
    host = torch.Generator(device="cuda")
    host.set_state(runner.device_generator.get_state())
    state = init_stoch_state(fa, B, "cuda")
    first = runner(state)  # the capture, then a replay
    saved = generator_states(torch.Generator(), runner)
    want = stoch_host_paced(torch, step, state, n, host, Np)
    err = stoch_scan_check(torch, f"{label} chunk 1", first, want, runner, host)
    capture = scan_chunk.capture_seconds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = stoch_host_paced(torch, step, want, n, host, Np)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    kept = copied(first)  # the next call consumes ``first``; the resume starts from it
    t0 = time.perf_counter()
    second = runner(first)
    torch.cuda.synchronize()
    captured_ms = (time.perf_counter() - t0) / n * 1e3
    err = max(err, stoch_scan_check(torch, f"{label} chunk 2", second, want, runner, host))
    del want
    flips = int((second.v != state.v).sum())
    if flips == 0:
        fail(f"stoch scan {label}: no chain flipped a variable in 128 steps")
    resumed_runner = make_stoch_chunk_runner(fa, n, "cuda", torch.Generator().manual_seed(2),
                                             fused="off")
    restore_generators(saved, torch.Generator(), resumed_runner)
    resumed = resumed_runner(kept)
    err = max(err, stoch_scan_check(torch, f"{label} resumed from the snapshot after chunk 1",
                                    resumed, second, resumed_runner, runner.device_generator))
    del resumed, resumed_runner
    out = {"host_ms": host_ms, "err": err}
    if calls > 1:
        s = second
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            s = runner(s)
        torch.cuda.synchronize()
        captured_ms = (time.perf_counter() - t0) / (calls * n) * 1e3
        (cap,) = runner.graphs.values()
        ((graph, _),) = cap.parts  # one graph of the 64 steps
        out["replay_ms"] = device_ms(torch, graph.replay, iters=10)
        long = make_stoch_chunk_runner(fa, 100, "cuda", torch.Generator().manual_seed(3),
                                       fused="off")
        host.set_state(long.device_generator.get_state())
        got = want = state
        for i in range(2):
            got = long(got)
            want = stoch_host_paced(torch, step, want, 100, host, Np)
            err = max(err, stoch_scan_check(torch, f"{label} 100-step chunk {i + 1}", got, want,
                                            long, host))
        (cap,) = long.graphs.values()
        if [times for _, times in cap.parts] != [1, 1]:
            fail(f"stoch scan {label}: the 100-step chunk is not a graph of 64 and one of 36")
        out["err"] = err
        del got, want, long, s
    peak = torch.cuda.max_memory_allocated()
    say(f"[stoch scan] {label} B={B}: captured chunks equal to the host-paced steps bit for bit "
        f"(v, xl, done; max abs err {err}; {flips} chain variables changed in 128 steps) with "
        f"the device generator's state, chunk 1 (the capture) and 2"
        f"{', and a 100-step chunk (64 + 36) twice' if calls > 1 else ''}; a snapshot after "
        f"chunk 1 resumed in a runner built anew equal to chunk 2")
    say(f"[stoch scan] {label} B={B}: a step's wall {captured_ms:.6f} ms captured (host clock "
        f"over {calls} call{'s' if calls > 1 else ''} of the {n}-step chunk, copies included), "
        f"{host_ms:.6f} ms host-paced (host clock over {n} steps from Python), "
        f"{host_ms / captured_ms:.3f}x; {B / captured_ms * 1e3:.6e} chain*steps/s captured, "
        f"{B / host_ms * 1e3:.6e} host-paced; capture and instantiate {capture:.6f} s; peak "
        f"memory {peak} B ({peak / 2**30:.3f} GiB)"
        + (f"; the 64-step graph's replay alone {out['replay_ms']:.6f} ms "
           f"({out['replay_ms'] / n:.6f} ms a step, device time)" if "replay_ms" in out else "")
        + f" ({card})")
    del first, kept, second, state, runner, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_stoch_scan(torch, sc, card):
    """Phase 30: the stoch twin's chunk captured (ops/scan_chunk.
    StochScanChunk), host-paced between chunks. a. hard.cnf through the
    CLI's stoch --no-preprocess --fused off at -b 16384 -n 4096 (256-step
    chunks: a 64-step graph four times), false after exactly 4096 steps,
    then the in-process checks and times at B=16384 (8 timed calls, the
    100-step runner, the graph's replay); b. 27d's formula
    (random_local_ksat(65536, 280000, k=3, locality=512, seed=9), past B3's
    and B4's gates, so --fused auto takes the twin) through stoch
    --no-preprocess -b 512 -n 128 --chunk-steps 64 (two chunks), then the
    in-process checks at B=512 (chunks 1 and 2 and the resumed chunk; one
    timed call). Returns (the CLI runs' captured chunks, the largest error,
    a's numbers)."""
    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables, parse_dimacs_file

    hard_path = os.path.join(ROOT, "tests", "data", "hard.cnf")
    chunks = stoch_scan_cli(torch, sc, "30a hard.cnf", hard_path, 16384, 4096,
                            ["--fused", "off"], card)
    hard = compile_formula(normalize_cnf_variables(parse_dimacs_file(hard_path))[1])
    a = stoch_scan_case(torch, "30a hard.cnf", hard, 16384, 8, card)
    w = FULL_WIDTH
    formula, path = full_width_formula()
    n = stoch_scan_cli(torch, sc, f"30b n={w['n']} m={w['m']}", path, w["B"],
                       2 * STOCH_SCAN_CHUNK, ["--chunk-steps", str(STOCH_SCAN_CHUNK)], card)
    if n != 2:
        fail(f"stoch scan 30b: {n} captured chunks, not 2")
    fa = compile_formula(normalize_cnf_variables(formula)[1])
    b = stoch_scan_case(torch, f"30b n={w['n']} (Np={fa.n_vars_padded}, Mp="
                        f"{fa.n_clauses_padded})", fa, w["B"], 1, card)
    return chunks + n, max(a["err"], b["err"]), a


def stoch_scan_alone():
    """``--stoch-scan``: phase 30 alone (it builds nothing: the twin is
    torch's kernels, captured)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from odesat_tpu_torch.ops import stoch_chunk as sc

    card = phase_device(torch)
    t0 = time.perf_counter()
    phase_stoch_scan(torch, sc, card)
    say(f"[done] phase 30 passed in {time.perf_counter() - t0:.1f} s")
    return 0


def donation_alone():
    """``--donation``: phases 25d and 25e alone (they build B1-B9 and the
    loop at first use)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from odesat_tpu_torch.cnf import normalize_cnf_variables
    from odesat_tpu_torch.ops.shard_stream import compile_stream_sharded

    card = phase_device(torch)
    t0 = time.perf_counter()
    phase_donation(torch, card)
    say(f"[done] phase 25d passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fa7 = compile_stream_sharded(normalize_cnf_variables(config7_instance())[1], 1)[0]
    phase_clause_donation(torch, fa7, card)
    say(f"[done] phase 25e passed in {time.perf_counter() - t0:.1f} s")
    return 0


def main():
    if sys.argv[1:2] == ["--time-b10"]:
        return time_b10(sys.argv[2])
    if sys.argv[1:2] == ["--time-b7"]:
        return time_b7()
    if sys.argv[1:2] == ["--time-loop"]:
        return time_loop(sys.argv[2])
    if sys.argv[1:2] == ["--time-mesh"]:
        return time_mesh(sys.argv[2])
    if sys.argv[1:2] == ["--time-segment"]:
        return time_segment(sys.argv[2], *sys.argv[3:4])
    if sys.argv[1:2] == ["--scan-peak"]:
        return scan_peak()
    if sys.argv[1:2] == ["--twin"]:
        return twin_alone()
    if sys.argv[1:2] == ["--time-mesh-loop"]:
        return time_mesh_loop(tuple(sys.argv[2:3]) or ("host", "device"))
    if sys.argv[1:2] == ["--stoch-scan"]:
        return stoch_scan_alone()
    if sys.argv[1:2] == ["--donation"]:
        return donation_alone()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import odesat_tpu_torch
    from odesat_tpu_torch.ops import fused_chunk as fc
    from odesat_tpu_torch.ops import rhs_kernel as rk
    from odesat_tpu_torch.ops import stoch_chunk as sc
    from odesat_tpu_torch.ops import stream_chunk as stc

    if not os.path.abspath(odesat_tpu_torch.__file__).startswith(ROOT + os.sep):
        fail(f"odesat_tpu_torch came from {odesat_tpu_torch.__file__}, not this checkout")
    if "jax" in sys.modules:
        fail("jax was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()

    def clock(what):
        say(f"[clock] {what} done at {time.perf_counter() - t0:.1f} s")

    card = phase_device(torch)
    phase_build(fc, sc, stc)
    cases, hard, uf250, specs = load_cases()
    worst = phase_compare(torch, fc, cases)
    worst = max(worst, phase_compare_finishing(torch, fc, uf250))
    say(f"[compare] every case equal to the plain version; max abs err {worst}")
    phase_determinism(torch, fc, hard, uf250)
    launches = phase_main_sat(fc)
    unsat_launches, unsat_wall = phase_main_unsat(fc, card)
    launches += unsat_launches
    times = phase_timing(torch, fc, hard, uf250, card)
    clock("phases 1-7 (B1)")

    from odesat_tpu_torch.cnf import compile_formula, normalize_cnf_variables
    from odesat_tpu_torch.utils.generate import random_ksat

    n1k_reduced = preprocessed_n1k()
    stoch_cases, n1k = load_stoch_cases(cases, n1k_reduced)
    stoch_worst = phase_stoch_compare(torch, fc, sc, [*stoch_cases, *ragged_ode_cases(cases)])
    planted = compile_formula(normalize_cnf_variables(random_ksat(200, 700, seed=3,
                                                                  planted=True))[1])
    finishing = phase_stoch_finishing(torch, sc, planted)
    stoch_worst = {k: max(stoch_worst[k], finishing[k]) for k in STOCH_KERNELS}
    say(f"[stoch compare] every case equal; max abs err {stoch_worst}")
    phase_stoch_determinism(torch, sc, hard, n1k)
    stoch_launches = phase_stoch_main(fc, sc, card)
    stoch_times = phase_stoch_timing(torch, sc, hard, n1k, card)
    clock("phases 8-11 (B3, B4)")

    big = load_stream_cases(n1k_reduced)
    b2_worst = phase_stream_compare(torch, fc, stc, cases, big)
    b2_worst = max(b2_worst, phase_compare_finishing(torch, fc, uf250, stc.make_stream_chunk,
                                                     "B2"))
    say(f"[B2 compare] every case equal to the plain version; max abs err {b2_worst}")
    phase_stream_determinism(torch, stc, big)
    clock("phase 12 (B2 against its plain version)")
    b2_launches = phase_stream_main(fc, stc, rk, n1k_reduced, card)
    clock("phase 13 (B2's main path)")
    b2_times = phase_stream_timing(torch, fc, stc, hard, big, card)
    clock("phase 14 (B2 timing)")
    b10_worst = phase_rhs_compare(torch, rk, (("hard.cnf B=16384", hard, 16384),
                                              ("uf250 B=4096", uf250, 4096),
                                              ("n1k preprocessed B=1024", big[0][1], 1024)))
    clock("phase 15 (B10 against its plain version)")
    b10_launches, scan_launches = phase_rhs_main(fc, stc, rk, card)
    split = phase_rhs_step_split(torch, rk, hard, uf250, card)
    b10_times = phase_rhs_timing(torch, rk, b10_shapes(torch, hard, uf250, big[0][1]), card)
    b10_ms, b10_plain = b10_times["hard.cnf f32 16384"]
    clock("phases 12-17 (B2, B10)")

    from odesat_tpu_torch.ops import shard_chunk as sch
    from odesat_tpu_torch.ops import shard_stream as ss

    shard_cases, c7, fa7, fa7_2 = load_shard_cases(specs, card)
    b5_worst = phase_shard_compare(torch, ss, shard_cases)
    clock("phase 18 B5")
    b6_worst = phase_shard_chunk_compare(torch, sch, ss, shard_cases)
    clock("phase 18 B6")
    b8_worst = phase_stoch_shard_compare(torch, sc, shard_cases)
    clock("phase 19 B8")
    b9_worst = phase_stoch_shard_chunk_compare(torch, sc, shard_cases)
    clock("phases 18-19 (B5, B6, B8, B9 against their plain versions)")
    b7_tree64_err = b7_tree_f64_check(torch, card)
    loop_calls, (loop_cases, loop_labels) = mesh_loop_calls(hard, uf250, big[0][1], n1k)
    fa_twin = twin_config7(c7)
    t_calls, t_argv, t_checks = twin_calls(fa_twin, uf250, config7_path(c7))
    mesh_launches, b7, (loop_values, loop_reports) = phase_mesh_main(
        torch, fa7, fa7_2, c7, specs[6][1], card, [*loop_calls, *t_calls])
    n_loop = len(loop_calls)
    mesh_loop = phase_mesh_loop(loop_cases, loop_labels, loop_values[:n_loop],
                                loop_reports[:n_loop], card)
    twin = phase_twin(loop_values[n_loop:], loop_reports[n_loop:], t_argv, t_checks, fa_twin,
                      card)
    for name, n in phase_mesh_s4(torch, fa7, c7, b7, card).items():
        mesh_launches[name] += n
    phase_nccl_world_of_one(torch, fa7)
    clock("phases 20, 28 and 29 (the meshes)")
    shard_times = phase_shard_timing(torch, ss, sch, sc, fa7, b7, card)
    clock("phases 18-21 (the clause mesh)")
    hybrid_launches, _ = phase_hybrid_main(fc, sc, stc, card)
    clock("phase 22 (the hybrid)")
    phase_resume(torch, fc, sc, stc, n1k_reduced, card)
    clock("phase 23 (resume, the profiler)")
    phase_exact_tts(torch, fc, card)
    clock("phase 24 (exact time to solution)")
    loop_worst = phase_loop_compare(torch, fc, sc, stc, hard, uf250, big, n1k, planted, card)
    loop_ms, loop_plain = phase_loop_timing(torch, card, unsat_wall,
                                            times[("hard.cnf B=16384", "fixed")][0])
    clock("phase 25 (the device loop)")
    phase_donation(torch, card)
    clock("phase 25d (the state donated)")
    phase_clause_donation(torch, fa7, card)
    clock("phase 25e (the clause mesh donated)")
    pod_launches = phase_pod(card)
    clock("phase 26 (the pod mesh)")
    scan_worst = max(phase_scan_compare(torch, rk, hard, uf250, card),
                     phase_scan_loop(torch, rk, hard, uf250, card))
    full_width_chunks, full_width_err = phase_scan_full_width(torch, fc, stc, rk, card)
    scan_launches += full_width_chunks
    scan_worst = max(scan_worst, full_width_err)
    clock("phase 27 (the scan tier on the card)")
    stoch_scan_chunks, stoch_scan_err, stoch_scan = phase_stoch_scan(torch, sc, card)
    clock("phase 30 (the stoch twin captured)")
    if "jax" in sys.modules:
        fail("jax was imported")
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    # the main paths' launches: phases 5-6, 10, 13, 16, 20, the hybrid's (22),
    # the pod's (26), the full-width scan run's (27d) and phase 30's
    launches += hybrid_launches["fused_chunk"] + pod_launches["fused_chunk"]
    for name in ("shard_chunk", "stoch_shard_chunk", "butterfly_fused"):
        mesh_launches[name] += pod_launches[name]
    b2_launches += hybrid_launches["stream_chunk"]
    for name in ("stoch_fused", "stoch_stream"):
        stoch_launches[name] += hybrid_launches[name]

    kernel_ms, plain_ms = times[("hard.cnf B=16384", "fixed")]
    b3_ms, b3_plain = stoch_times[("hard.cnf B=16384", "fused")]
    b4_ms, b4_plain = stoch_times[("n1k B=8192", "stream")]
    b2_ms, b2_plain = b2_times[(big[0][0], "fixed")]

    def row(name, source, replaces, n, err, ms, plain, bound_ms_by, library_ms=None):
        # no single PyTorch call computes the hand-written kernels' functions
        return {"name": name, "route": "cuda", "source": f"odesat_tpu_torch/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound_ms_by[0], "bound_by": bound_ms_by[1],
                "library_ms": library_ms}

    b5_ms, b5_plain, b5_bound, b5_by = shard_times["fixed"]
    b8_ms, b8_plain, b8_bound, b8_by = shard_times["b8"]
    b6_ms, b6_plain, b6_bound, b6_by = shard_times["b6"]
    b9_ms, b9_plain, b9_bound, b9_by = shard_times["b9"]
    b7_ms, b7_plain, b7_bound, b7_by, b7_library = shard_times["b7"]
    b7f_ms, b7f_plain, b7f_bound, b7f_by = shard_times["b7_fused"]
    b7_err = max(b7["S=2"]["err"], b7["S=4"]["err"])
    # the clause mesh's per-step chunk captured: B5's at S=2 (phase 20's
    # world), 64 steps, against the same steps from Python; bound: 64 of
    # B5's fixed passes on a rank's shard and its B7 call at S=2
    from odesat_tpu_torch.utils.config import ODEConfig

    b5_two = b7["S=2"]["capture"]["B5 fixed"]
    fixed = ODEConfig(step_size=0.01)
    spec_two = ss.shard_spec(fa7_2, fixed.resolve_zeta(fa7_2.density), fixed, "cuda", 0)
    call_ms = 3 * 4 * 1024 * (spec_two.Np + 1) / HBM_BYTES_PER_S * 1e3
    mesh_chunk_bound = (CAPTURE_STEPS * (shard_bound(spec_two, 1024, "fixed")[0] + call_ms),
                        "bytes")
    capture_err = max(b7["S=2"]["capture_err"], b7["S=4"]["capture_err"], twin["capture_err"],
                      *(r["err"] for r in shard_times["capture"].values()))
    say(json.dumps({"kernels": [
        row("fused_chunk", "csrc/fused_chunk.cu", "odesat_tpu/ops/fused_pallas.py:66", launches,
            worst, kernel_ms, plain_ms, ode_chunk_bound(hard, 16384, 256, True)),
        row("stoch_fused", "csrc/stoch_chunk.cu", "odesat_tpu/ops/stoch_pallas.py:75",
            stoch_launches["stoch_fused"], stoch_worst["fused"], b3_ms, b3_plain,
            stoch_chunk_bound(hard, 16384, 64)),
        row("stoch_stream", "csrc/stoch_chunk.cu", "odesat_tpu/ops/stoch_pallas.py:345",
            stoch_launches["stoch_stream"], stoch_worst["stream"], b4_ms, b4_plain,
            stoch_chunk_bound(n1k, 8192, 8)),
        row("stream_chunk", "csrc/stream_chunk.cu", "odesat_tpu/ops/stream_pallas.py:166",
            b2_launches, b2_worst, b2_ms, b2_plain, ode_chunk_bound(big[0][1], big[0][2], 8, True)),
        row("rhs", "csrc/stream_chunk.cu", "odesat_tpu/ops/rhs_pallas.py:62", b10_launches,
            b10_worst, b10_ms, b10_plain, rhs_pass_bound(hard, 16384)),
        row("shard_stream", "csrc/stream_chunk.cu", "odesat_tpu/ops/shard_stream.py:574",
            mesh_launches["shard_stream"], b5_worst, b5_ms, b5_plain, (b5_bound, b5_by)),
        row("shard_chunk", "csrc/stream_chunk.cu", "odesat_tpu/ops/shard_chunk.py:158",
            mesh_launches["shard_chunk"], b6_worst, b6_ms, b6_plain, (b6_bound, b6_by)),
        row("stoch_shard_eval", "csrc/stoch_chunk.cu", "odesat_tpu/ops/stoch_pallas.py:605",
            mesh_launches["stoch_shard_eval"], b8_worst, b8_ms, b8_plain, (b8_bound, b8_by)),
        row("stoch_shard_chunk", "csrc/stoch_chunk.cu", "odesat_tpu/ops/stoch_pallas.py:868",
            mesh_launches["stoch_shard_chunk"], b9_worst, b9_ms, b9_plain, (b9_bound, b9_by)),
        # B7's standalone call at S=2 (the --shard-chunk off steps); its
        # library call is the gloo all-reduce of the same buffer
        row("butterfly", "csrc/butterfly.cu", "odesat_tpu/ops/butterfly.py:99",
            mesh_launches["butterfly"], b7_err, b7_ms, b7_plain, (b7_bound, b7_by),
            library_ms=b7_library),
        # B7's float64 form (the twin's clause step in float64, phase 29):
        # its standalone call at S=2 on config 7's (B, Np+1) f64 buffer, its
        # library call gloo's all-reduce of it; launches: both ranks' in
        # 29's inter run on B7's route
        row("butterfly_f64", "csrc/butterfly.cu", "odesat_tpu/ops/butterfly.py:99",
            twin["launches"], max(twin["err"], b7["S=4 f64"], b7_tree64_err), twin["ms"],
            twin["plain_ms"], (twin["bound_ms"], "bytes"), library_ms=twin["library_ms"]),
        # B7 fused into B6's and B9's prologues (csrc/bfly_tree.cuh): B6's
        # apply launch reading two ranks' partials; launches: the B6 and B9
        # launches of the mesh runs that read S > 1 slots
        row("butterfly_fused", "csrc/bfly_tree.cuh", "odesat_tpu/ops/butterfly.py:99",
            mesh_launches["butterfly_fused"], b7_err, b7f_ms, b7f_plain, (b7f_bound, b7f_by)),
        # the device loop's head and decide kernels around B1-B4 (no Pallas
        # kernel: JAX's lax.while_loop around them): a chunk's cost beyond
        # the chunk kernel against the host loop's, bound by the decide
        # kernel's 20 bytes; launches: the graph launches of the CLI's main
        # paths (phases 5-6, 10, 13, 16)
        row("device_loop", "csrc/device_loop.cu", "odesat_tpu/models/ode.py:443",
            MAIN_PATH_GRAPHS["launches"], loop_worst, loop_ms, loop_plain, bound(20, 0)),
        # the device loop on a trajectory mesh of two ranks sharing the card
        # (no Pallas kernel: JAX's pmax over traj inside its lax.while_loop):
        # a 256-step B1 chunk's cost beyond the two ranks' launches at
        # hard.cnf 8192 rows a rank, the stop exchanged on the card against
        # run_chunks with MeshSync's gloo all-reduce (28a); bound: T = 2
        # words a chunk; launches: the mesh graph launches of 28c's CLI
        # runs, 20e's and the pod's 26b, every rank
        row("device_loop_mesh", "csrc/device_loop.cu", "odesat_tpu/parallel/sharded.py:332",
            mesh_loop["launches"] + mesh_launches["device_loop_mesh"]
            + pod_launches["device_loop_mesh"],
            mesh_loop["err"], mesh_loop["ms"], mesh_loop["plain_ms"], bound(4 * 2, 0)),
        # the scan tier's chunk (no Pallas kernel: JAX's jitted lax.scan of
        # single steps): a captured 64-step chunk of phase 16's fixed B10
        # step at hard.cnf B=4096 (the graph's replay, device time) against
        # the same steps launched from Python (host clock); launches: the
        # graph chunks of phases 16 and 27d's CLI runs
        row("scan_chunk", "ops/scan_chunk.py", "odesat_tpu/models/ode.py:416", scan_launches,
            scan_worst, split["replay"], split["plain_chunk"], scan_chunk_bound(hard, 4096, 64)),
        # the stoch twin's chunk (no Pallas kernel: JAX's jitted lax.scan of
        # stoch steps): its captured 64-step graph's replay at hard.cnf
        # B=16384 (device time) against the same steps and draws launched
        # from Python (host clock), bound as B3's chunk of the same
        # function; launches: the captured chunks of phase 30's CLI runs
        row("stoch_scan_chunk", "ops/scan_chunk.py", "odesat_tpu/models/stoch.py:232",
            stoch_scan_chunks, stoch_scan_err, stoch_scan["replay_ms"],
            stoch_scan["host_ms"] * STOCH_SCAN_CHUNK,
            stoch_chunk_bound(hard, 16384, STOCH_SCAN_CHUNK)),
        # the clause mesh's per-step chunk (no Pallas kernel: JAX's jitted,
        # donated lax.scan of B5's step with its psum, or of the twin's mesh
        # step): a captured 64-step chunk of B5 at config 7 B=1024 S=2, its
        # B7 calls in the graph, against the same steps launched from Python
        # (host clock); launches: the captured chunks of phase 20's
        # --shard-chunk off solves and 29's inter on B7's route, every rank
        row("mesh_step_chunk", "ops/scan_chunk.py", "odesat_tpu/parallel/sharded.py:597",
            mesh_launches["mesh_step_chunk"] + twin["chunks"], capture_err, b5_two["ms"],
            b5_two["host_ms"], mesh_chunk_bound),
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
