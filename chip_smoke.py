#!/usr/bin/env python3
"""Drive the PyTorch port of DEG on one NVIDIA card: build its CUDA kernels,
hold each against its plain PyTorch version, build an index at the
paper's audio size, take the exact ground truth from the brute-force scan,
serve queries and exploration sessions from the index, serve from its
compressed stores (fp16, sq8, pq), save the index and serve the restored
copy through the query engine, recover a journaled index and resume a
checkpointed build, build and serve the paper's baseline graphs, refine
the index, delete vertices from it, and serve again; then serve the
recsys models DIN and DCN-v2 at their published widths, their embedding
bags through the bag_lookup kernel.

    python3 chip_smoke.py            # needs one CUDA card and nvcc
    python3 chip_smoke.py --n 20000  # a smaller build (a cut of n only)

Phases (any failure raises and exits non-zero):
  1. header: the card's name and power limit, kernel build seconds;
  2. each kernel against its plain version at the main path's shapes:
     serving (B=256, d=20, m=192, L=30, E in {1, 4}, V=1024), an insert
     wave's search (B=64, L=80), an exploration hop (B=8, L=42), the
     lune test at an extend block's shape (B=16, K=40, and the build's
     last block) and at a refine chunk's (B=16, K=20), an extend block's
     whole selection pass, extend_select (W=16, K=40, d=20; the build's
     last block; and a block with failed lanes and the phase-2 latch, each
     under every scheme, with and without the Alg. 2 check, and
     sqeuclidean), held equal (torch.equal) to the two-step path it
     replaces (the mrng_occlusion kernel, then the torch steps) and to its
     plain version (ids on >= 99% of slots, dists rtol 1e-5), and
     refinement's searches (L=40: a chunk's
     batched first search, B=REFINE_LANES, and a live one, B=1), and
     the compressed stores' (gather_dist on fp16 rows, gather_dist_q on
     sq8 codes and pq_adc on pq codes at B=256, d=20 and, for an E=4 hop,
     80; the merges at their rerank-wide beams), and the brute-force
     l2_topk at the serving batch (B=256, k in {10, 100}), a single query,
     a ragged shape (B=37, N=1000, m=33, k=50), the padding case (B=3,
     N=130, m=16, k=50) and the ground truths of phases 4 and 4c, each
     also with the base cut into the splits the kernel plans, held
     bit-identical (torch.equal) to one split in both modes; and the
     whole-search beam_search over the phase-2 graph at classic serving
     (B=256, L=30) on float32 and fp16 rows, E=4, E=2 with V=1024, an
     insert wave (B=64, L=80, k=40, eps 0.3), an exploration hop (B=8,
     L=42, 32 excluded ids), refinement's two searches (B=75 and 1,
     L=40, k=20, eps 0.001), pq-serving over the phase-2 rows encoded
     under seeded codebooks (m_sub=24, no k-means fit; B=256, L=120, eps
     0.2, and E=4 with V=4096 under the fused preset), the fused preset
     over float32 rows (B=256, L=30, E=4, V=1024) and sq8-serving over
     the phase-2 rows encoded under their sq8 scale (B=256, L=40, and
     E=4 with V=1024 under the fused preset), each held equal
     (torch.equal, every field of the state) to the host loop with the
     per-hop kernels (gather_dist, gather_dist_q or pq_adc and
     beam_merge; fused_hop for the fused preset over float32 rows) and on
     >= 99% of id slots to its plain version; with times
     (kernel, plain version and library call alike: CUDA events around
     a replay of a CUDA graph of 50 back-to-back calls, over 50; the
     plain whole search, which reads "any lane alive?" to the host, by
     events around 2 eager calls);
  3. build: make_dataset("manifold", n, 10000, 192) under the paper's
     audio parameters (degree 20, k_ext 40, eps_ext 0.3), the device
     extension in blocks of 16 (one extend_select launch a block),
     wave_size=64, then the Table-1
     invariants; the idle share of one wave search and of one extend
     block; then the host extension on a build of N_HOST vertices;
  4. ground truth: BruteForceIndex(base).search(backend="kernel"), the
     l2_topk kernel over all 10,000 queries, held against
     exact_knn_batched (ids equal on GT_AGREE of the slots, every other
     slot a tie); then serve: 10,000 queries in batches of 256 (k=10,
     eps=0.1) under the "classic" and "multi-e4-fused" presets, recall@10
     against that ground truth, and 8 exploration sessions of 4 hops;
  4b. compressed serving on the same graph: for the "fp16", "sq8-serving"
     and "pq-serving" QUANT_PRESETS under "classic", the store's encode
     seconds (pq's host fit apart), memory_stats() against the bytes
     written out and against the bytes each store's tensors hold, 10,000
     queries (QPS, recall@10, hops, evals), the idle
     share of one batch; then 512 queries of each store under
     "multi-e4-fused" (beam_search over every store, where the fused
     preset is the composed hop with the visited filter);
  4c. baselines on the first N_HOST rows and N_BASELINE_QUERIES queries:
     the kGraph (nn_descent, K=20, 6 iterations) searched from vertex 0,
     the random even-regular graph (degree 20, Table-1) searched from the
     medoid, and NSW (f=10, max_degree=60, k_search 40, eps 0.2) over the
     first N_NSW rows; build seconds, QPS and recall@10 against the
     kernel's ground truth, and each graph's first 256 queries again
     through the plain versions;
  5. refine: Alg. 5 over REFINE_VERTICES vertices under the audio
     config's k_opt, eps_opt and i_opt, the average neighbor distance
     (Eq. 4) before and after, Table-1, the idle share of one chunk; then
     "classic" served again on the refined graph;
  6. the main path again through the plain versions: 512 queries of each
     preset, and of each compressed store under "classic" and
     "multi-e4-fused", one wave search, every exploration hop, one refine
     chunk
     (equal adjacency and improved edges), and a device-extend build of
     N_HOST vertices with the kernels and with the plain versions;
  7. delete: idx.remove() of N_DELETE vertices drawn from seed 0 after
     refinement, Table-1, the ground truth recomputed over the remaining
     rows, "classic" served again (recall@10 >= 0.90, no deleted vector
     returned);
  8. (run right after phase 2, so that a fault shows early, and while
     the profiler is fresh: late in one run it saw no device activity)
     recsys serving at full width, weights from init_params (a
     torch.Generator seeded 0) and batches from CriteoLikeStream(seed=0):
     first bag_lookup against its plain version and F.embedding_bag at
     the path's shapes (DIN's interest at serve_p99 and serve_bulk,
     DCN-v2's user_embedding at B=1 and 512, a ragged case); then DIN:
     RECSYS_BATCHES serve_p99 batches of 512 (ms a batch, the idle share
     of one), one serve_bulk forward of 262,144 (s, samples/s, peak
     memory), retrieval (k=100) over the 63,001 item rows at B=1 and 512
     (each retrieval also timed with and without user_embedding's id
     bounds check);
     DCN-v2 (its 33,762,577-row table, 2.16 GB): table init s and bytes,
     RECSYS_BATCHES serve_p99 batches, retrieval_cand (B=1 over 1,000,000
     rows of field 2); every logit finite; the DIN batches and the three
     retrievals again through the plain versions (logits rtol 1e-5 atol
     1e-6; ids equal on RETRIEVAL_AGREE of the slots, the rest ties);
  9. (run after phase 6's serving comparisons, on the graph and stores
     phases 4 and 4b served) persistence and the serving engine:
     9a. idx.save() (seconds, bytes, each section's bytes) and
     DEGIndex.load() on the card (seconds, beside the pq fit it skips);
     adjacency, weights, vectors and every store's tensors torch.equal to
     the live index's; "classic", "sq8-serving" and "pq-serving" served
     from the restored index in batches of 256, ids, dists, hops and
     evals torch.equal to the live index's and ids to phases 4 and 4b;
     9b. QueryEngine.from_snapshot(k=10, eps=0.1, max_batch=256,
     preset="classic"): warmup() seconds per bucket (8 to 256), the
     10,000 queries through engine.search (40 flushes: 39 of 256, one of
     16 padded to 16), ids equal to phase 4's on every slot and its
     recall; flush p50/p99 per bucket, QPS, the idle share of one flush
     of 256; bursts of 1, 3, 17 and 100 queries equal to their rows; a
     codec="sq8" engine at sq8-serving's rerank width equal to phase
     4b's ids; 8 exploration sessions of 5 steps; on the restored copy
     engine.insert of 64 held-out queries, each its own nearest on the
     next flush when searched from its first neighbor (the share found
     from the medoid logged beside the share of 256 indexed rows found
     so), and one engine.delete;
     9c. at N_HOST rows: 3,000 built with the WAL on and snapshotted, 1,000
     added in waves of 64, 16 removed, 32 refined; recover(snapshot,
     wal) equal to the live index (adjacency, weights, vectors, RNG
     stream, WAL cursor); a build checkpointed every 4 waves, resumed
     from its last checkpoint, equal to the uninterrupted build; each
     step's seconds;
  10. the kernels' JSON line, then the final JSON line.

The kernels' launch counters read the builds, the ground truths, the
timed serving loops (compressed ones and the baselines' too), the
exploration sessions, the refinement, the deletion, phase 9's pieces
(the restored index's serving, the engine's warm-up, flushes, bursts,
sessions, insert and delete, the journaled and checkpointed builds and
their recovery) and the recsys serving only;
warm-ups, profiled reruns and the runs of the plain versions are not
counted.  Each counted piece that searches is held to one beam_search
launch for each of its range_search calls where the search kernel takes
the configuration (any store under l2, either hop), with no beam_merge,
gather_dist, gather_dist_q, pq_adc or fused_hop launch beside them, and
to none elsewhere: one a wave of the build, 40 for 10,000 "classic"
queries in batches of 256, one a flush of the engine.  gather_dist, gather_dist_q, beam_merge,
pq_adc and fused_hop then serve only the host loop (ip, cos, oversize
lanes): each must launch no time on the main path and at least once in
phase 2's comparisons against the host loop.  A build with the device
extension launches extend_select once an extend block and no
mrng_occlusion, which refinement's conformity test launches once a
chunk.

Without a CUDA device, or without the rest of the repository beside it,
the script exits non-zero and prints no result.  It imports nothing of
JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

INVALID = -1
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside tensor cores
TIMING_REPS = 50
PROFILE_TRIES = 3
GRAPH_REPLAYS = 3                  # timed replays of a kernel row's graph
N_AUDIO, DIM, N_QUERIES, BATCH = 53_387, 192, 10_000, 256
K, EPS = 10, 0.1                   # serving: recall@10 at eps 0.1
K_EXT, WAVE = 40, 64               # the audio config's k_ext; insert wave
EPS_EXT = 0.3                      # the audio config's eps_ext
K_OPT, EPS_OPT = 20, 0.001         # the audio config's k_opt and eps_opt
EXTEND_BLOCK, CHUNK = 16, 16       # DEGParams.extend_block; refine chunk
REFINE_LANES = 75                  # a chunk's edge tasks (about 4.7 per vertex)
N_HOST = 4_000                     # the host-extension and comparison builds
# 0.25% of the audio graph: refinement costs about 0.5 s per vertex on one
# H100 (single-lane host hop loops, PERF.md); 256 vertices left the run
# too little room for the baselines and the deletion within 900 s
REFINE_VERTICES = 128
EXPLORE_SESSIONS, EXPLORE_HOPS = 8, 4
PHASE2 = dict(B=256, d=20, m=192, L=30, V=1024)
RECALL_FLOOR = 0.90
AGREE_FLOOR = 0.99
N_COMPARE = 512                    # queries served again through the plain versions
RECALL_GAP = 0.005
GT_AGREE = 0.999                   # kernel vs exact_knn_batched id slots
GT_RTOL = 1e-5                     # a differing slot must be a tie
RETRIEVAL_AGREE = 0.99             # recsys retrieval ids, kernel vs plain
# phase 4c: the baselines of benchmarks/qps_recall.py at degree 20
N_BASELINE_QUERIES = 1_000
KNNG_K, KNNG_ITERS = 20, 6
NSW_F, NSW_MAX_DEGREE, NSW_K_SEARCH, NSW_EPS = 10, 60, 40, 0.2
# every NSW insert is a single-lane search on the host hop loop: at 1,000
# rows (989 searches of about 93 hops) the build took 163.6 s on one H100,
# which left the run 32 s inside 900 s
N_NSW = 500
N_DELETE = 512                     # phase 7
# phase 8: recsys serving; the batch sizes and the candidate count are the
# serve_p99, serve_bulk and retrieval_cand cells of RECSYS_SHAPES
RECSYS_ARCHS = ("din", "dcn-v2")
RECSYS_BATCHES = 20                # serve_p99 batches per model
RETRIEVAL_K = 100
RETRIEVAL_REPS = 20                # retrievals timed with and without the id check
DCN_CANDIDATE_FIELD = 2            # Criteo-Kaggle field 2: 10.1M rows
BAG_RTOL, BAG_ATOL = 1e-5, 1e-6    # kernel vs plain: bag sums and logits

KERNELS = {
    "gather_dist": "src/repro/kernels/gather_dist/gather_dist.py:35",
    "beam_merge": "src/repro/kernels/beam_merge/beam_merge.py:189",
    "fused_hop": "src/repro/kernels/fused_hop/fused_hop.py:114",
    "mrng_occlusion": "src/repro/kernels/mrng_occlusion/mrng_occlusion.py:50",
    "gather_dist_q": "src/repro/kernels/gather_dist_q/gather_dist_q.py:37",
    "pq_adc": "src/repro/kernels/pq_adc/pq_adc.py:68",
    "l2_topk": "src/repro/kernels/l2_topk/l2_topk.py:93",
    "bag_lookup": "src/repro/kernels/bag_lookup/bag_lookup.py:38",
    # the whole search folds beam_merge, gather_dist, gather_dist_q, pq_adc
    # and fused_hop into one launch
    "beam_search": "src/repro/kernels/beam_merge/beam_merge.py:189, "
                   "src/repro/kernels/gather_dist/gather_dist.py:35, "
                   "src/repro/kernels/gather_dist_q/gather_dist_q.py:37, "
                   "src/repro/kernels/pq_adc/pq_adc.py:68, "
                   "src/repro/kernels/fused_hop/fused_hop.py:114",
    # the extension's selection pass: the lune test and the steps around it
    "extend_select": "src/repro/kernels/mrng_occlusion/mrng_occlusion.py:50",
}
# kernels that only the host loop of hops launches, since beam_search takes
# every l2 search over every store under either hop: none on the main
# path, and phase 2's comparisons against the host loop launch each
HOST_LOOP_ONLY = ("gather_dist", "gather_dist[fp16]", "gather_dist_q",
                  "beam_merge", "fused_hop", "pq_adc")
# phase 4b: the compressed stores served under the "classic" preset
QUANT_SERVED = ("fp16", "sq8-serving", "pq-serving")
# phase 9: persistence and the serving engine on the audio-size index
SNAPSHOT_SERVED = ("classic", "sq8-serving", "pq-serving")
BURSTS = (1, 3, 17, 100)           # queries a burst, each one flush
ENGINE_SESSIONS, ENGINE_STEPS = 8, 5
N_INSERT = 64                      # held-out points inserted through the engine
WAL_SNAP = 3_000                   # rows journaled before the snapshot
WAL_REMOVE, WAL_REFINE = 16, 32
CKPT_EVERY = 4                     # waves between checkpoints
# DEGIndex.memory_stats() at the audio size (n=53,387, m=192), by
# quant/codec.py::store_bytes; pq: 24 code bytes a row plus the codebooks
AUDIO_STORE_BYTES = {"float32": 41_001_216, "fp16": 20_500_608,
                     "sq8": 10_251_072, "pq": 1_477_896}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def device_profile(fn, reps: int = 1, host: bool = True) -> list:
    """Run ``fn`` ``reps`` times under torch.profiler: every kernel, copy
    and fill on the device as (name, summed ms, calls), most time first.
    ``host=False`` records device activity only: much cheaper on a long
    run, but on the H100 it missed some of 50 back-to-back launches of a
    few microseconds, which the kernel timings must count exactly."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * host
    with profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [(a.key, getattr(a, "self_device_time_total", 0.0) / 1e3, a.count)
           for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    dev.sort(key=lambda x: -x[1])
    return dev


def time_call(fn, symbol: str | None = None, reps: int = TIMING_REPS) -> dict:
    """Per-call device time of ``fn``: CUDA events around a replay of one
    CUDA graph that holds ``reps`` back-to-back calls, divided by ``reps``
    (the median of GRAPH_REPLAYS replays, after an eager warm-up and a
    warm-up replay).  That counts every kernel, copy and fill the calls
    launch (both of l2_topk's passes), and the small gaps between kernels
    in a graph; ``timed_by`` is "cuda_graph".  A call that cannot be
    captured is timed by events around ``reps`` eager calls instead
    ("events_loop", launch overhead included), and the log says why.
    ``event_ms`` is the median event time of one eager call, launch
    overhead included.  With ``symbol``, torch.profiler runs ``reps``
    calls once more and every ``__global__`` function whose name holds
    ``symbol`` is printed with the launches it saw and their mean: a
    cross-check, read by no number."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ev.append(s.elapsed_time(e))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                     # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
    except RuntimeError as exc:
        log(f"  graph capture refused ({str(exc).splitlines()[0][:160]}): "
            f"timed by events around {reps} eager calls")
        graph = None
    times = []
    for _ in range(GRAPH_REPLAYS + 1):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        if graph is None:
            for _ in range(reps):
                fn()
        else:
            graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    how = "events_loop" if graph is None else "cuda_graph"
    del graph                                    # frees its memory pool
    if symbol is not None:
        seen = [r for r in device_profile(fn, reps) if symbol in r[0]]
        for name, total, n in seen:
            log(f"  profiler cross-check {name[:70]}: {n} launches in {reps} "
                f"calls, {total / n:.6f} ms each")
        if not seen:
            log(f"  profiler cross-check: no {symbol} launch seen in {reps} "
                "calls")
    return {"device_ms": float(np.median(times[1:])),
            "timed_by": how,
            "event_ms": float(np.median(ev))}


def idle_share(fn, wall_ms: float, what: str) -> None:
    """Print the device time of one call of ``fn`` (profiled) against its
    unprofiled wall time, and the kernels that took the most of it.
    Host operations are not recorded: on a refine chunk's hundred
    thousand launches that costs minutes."""
    for _ in range(PROFILE_TRIES):
        rows = device_profile(fn, host=False)
        if rows:
            break
    else:
        log(f"  {what}: idle share not measured (the profiler saw no device "
            f"activity, {PROFILE_TRIES} times)")
        return
    dev_ms = sum(r[1] for r in rows)
    log(f"  {what}: device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms wall, "
        f"idle share {1 - dev_ms / wall_ms:.4f}; top: " + "; ".join(
            f"{name[:40]} {ms:.3f} ms x{n}" for name, ms, n in rows[:5]))


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def expect_launches(kernel: str, got: int, want: int, what: str) -> None:
    if got != want:
        raise AssertionError(f"{got} {kernel} launches for {want} {what}")


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def timings(r: dict, library: str) -> str:
    """A check's kernel, plain and library times as one log phrase."""
    def one(t):
        return (f"{t['device_ms']:.6f} ms device ({t['timed_by']}; "
                f"{t['event_ms']:.6f} ms per eager call)")

    lib = "n/a" if r["tl"] is None else one(r["tl"])
    return (f"kernel {one(r['t'])}, plain {one(r['tp'])}, {library} {lib}, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
            f"max_abs_err {r['max_abs_err']:.3g}")


def timed_by(r: dict) -> str:
    """How a check's three times were taken: one word when they agree."""
    ways = {"kernel": r["t"]["timed_by"], "plain": r["tp"]["timed_by"]}
    if r["tl"] is not None:
        ways["library"] = r["tl"]["timed_by"]
    if len(set(ways.values())) == 1:
        return ways["kernel"]
    return "; ".join(f"{k}: {v}" for k, v in ways.items())


def kernel_rows(checks: dict, launches: dict) -> list:
    """The kernels' JSON rows: one per kernel, at its check's shape."""
    return [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{name}.cu",
             "replaces": KERNELS[name], "launches": launches[name],
             "max_abs_err": r["max_abs_err"], "ms": r["t"]["device_ms"],
             "plain_ms": r["tp"]["device_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"],
             "library_ms": None if r["tl"] is None else r["tl"]["device_ms"],
             "timed_by": timed_by(r)}
            for name, r in checks.items()]


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------
def phase2_inputs(device, N=N_AUDIO, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    p = PHASE2
    B, d, m = p["B"], p["d"], p["m"]
    vectors = torch.tensor(rng.normal(size=(N, m)).astype(np.float32),
                           device=device)
    n_valid = N - 1000                       # ids in [n_valid, N) are invalid
    adj = rng.integers(0, N + 50, size=(N, d)).astype(np.int32)  # some >= N
    adj[rng.random((N, d)) < 0.05] = INVALID
    queries = vectors[torch.tensor(rng.integers(0, N, B), device=device)]
    queries = queries + 0.3 * torch.tensor(
        rng.normal(size=(B, m)).astype(np.float32), device=device)
    return dict(rng=rng, vectors=vectors, adjacency=torch.tensor(adj, device=device),
                queries=queries, n_valid=n_valid, N=N)


def _ids(inp, B, d, device):
    """(B, d) gather ids over the N rows, 5% INVALID and three clipped."""
    import torch

    rng = inp["rng"]
    ids = rng.integers(0, inp["N"], size=(B, d)).astype(np.int32)
    ids[rng.random((B, d)) < 0.05] = INVALID
    ids[0, :3] = [inp["N"], inp["N"] + 9, INVALID]         # clipped ids
    return torch.tensor(ids, device=device)


def check_gather_dist(inp, device, B, rows="f32") -> dict:
    """``rows``: "f32", "f16" (the fp16 store's rows) or "bf16", the
    half rows upcast in the kernel."""
    import torch
    from repro_torch.kernels.gather_dist import ops

    d, m = PHASE2["d"], PHASE2["m"]
    ids = _ids(inp, B, d, device)
    v, q = inp["vectors"], inp["queries"][:B]
    v = v.to({"f32": torch.float32, "f16": torch.float16,
              "bf16": torch.bfloat16}[rows])
    err = 0.0
    for squared in (False, True):
        got = ops.gather_dist(v, ids, q, squared=squared)
        want = ops.gather_dist(v, ids, q, squared=squared, impl="ref")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        if not squared:
            err = float((got - want).abs().max())
    t = time_call(lambda: ops.gather_dist(v, ids, q), "gather_dist_kernel")
    tp = time_call(lambda: ops.gather_dist(v, ids, q, impl="ref"))
    n_rows = torch.unique(ids.clamp(0, inp["N"] - 1)).numel()
    nb = (ids.numel() * 4 + n_rows * m * v.element_size() + q.numel() * 4
          + B * d * 4)
    bms, by = bound_ms(nb, 3 * B * d * m + B * d)
    return dict(name="gather_dist", max_abs_err=err, t=t, tp=tp,
                tl=None, bound_ms=bms, bound_by=by,
                shape=f"B={B} d={d} m={m} {rows} l2",
                tol="rtol 1e-5")


def check_gather_dist_q(inp, device, d) -> dict:
    """The sq8 store's kernel at serving's B: d = 20 for a classic hop, 80
    for an E=4 hop, which over a compressed store runs composed."""
    import torch
    from repro_torch.kernels.gather_dist_q import ops
    from repro_torch.quant import codec

    B, m = PHASE2["B"], PHASE2["m"]
    v, q = inp["vectors"], inp["queries"][:B]
    scale = codec.calibrate_sq8_scale(v)
    codes = codec.sq8_encode(v, scale)
    ids = _ids(inp, B, d, device)
    err = 0.0
    for squared in (False, True):
        got = ops.gather_dist_q(codes, scale, ids, q, squared=squared)
        want = ops.gather_dist_q(codes, scale, ids, q, squared=squared,
                                 impl="ref")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        if not squared:
            err = float((got - want).abs().max())
    t = time_call(lambda: ops.gather_dist_q(codes, scale, ids, q),
                  "gather_dist_q_kernel")
    tp = time_call(lambda: ops.gather_dist_q(codes, scale, ids, q,
                                             impl="ref"))
    rows = torch.unique(ids.clamp(0, inp["N"] - 1)).numel()
    nb = ids.numel() * 4 + rows * m + m * 4 + q.numel() * 4 + B * d * 4
    bms, by = bound_ms(nb, 4 * B * d * m + B * d)
    return dict(name="gather_dist_q", max_abs_err=err, t=t, tp=tp, tl=None,
                bound_ms=bms, bound_by=by, shape=f"B={B} d={d} m={m} sq8 l2",
                tol="rtol 1e-5")


def check_pq_adc(inp, device, d, m_sub=24) -> dict:
    """The pq store's kernel at serving's B over (N, m_sub) codes and
    seeded codebooks (the kernel computes the same function of any
    codebook, so phase 2 does not fit one)."""
    import torch
    from repro_torch.kernels.pq_adc import ops

    rng, B, m, N = inp["rng"], PHASE2["B"], PHASE2["m"], inp["N"]
    dsub = m // m_sub
    books = torch.tensor(rng.normal(size=(m_sub, 256, dsub)).astype(
        np.float32), device=device)
    codes = torch.tensor(rng.integers(0, 256, size=(N, m_sub)).astype(
        np.uint8), device=device)
    q = inp["queries"][:B]
    ids = _ids(inp, B, d, device)
    err = 0.0
    for squared in (False, True):
        got = ops.pq_adc(codes, books, ids, q, squared=squared)
        want = ops.pq_adc(codes, books, ids, q, squared=squared, impl="ref")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        if not squared:
            err = float((got - want).abs().max())
    t = time_call(lambda: ops.pq_adc(codes, books, ids, q), "pq_adc_kernel")
    tp = time_call(lambda: ops.pq_adc(codes, books, ids, q, impl="ref"))
    rows = torch.unique(ids.clamp(0, N - 1)).numel()
    nb = (ids.numel() * 4 + rows * m_sub + books.numel() * 4
          + q.numel() * 4 + B * d * 4)
    # the cheaper of the function's two forms: each query's whole table
    # (3 flops per (subspace, centroid, dim)) and m_sub adds a row, or the
    # B * d distances straight from the code rows and codebooks (3 flops
    # per (row, dim))
    bms, by = bound_ms(nb, min(3 * B * 256 * m + B * d * m_sub,
                               3 * B * d * m))
    return dict(name="pq_adc", max_abs_err=err, t=t, tp=tp, tl=None,
                bound_ms=bms, bound_by=by,
                shape=f"B={B} d={d} m={m} m_sub={m_sub} pq l2",
                tol="rtol 1e-5")


def _near_queries(inp, B, device):
    """B queries near random rows of the phase-2 vectors, as
    ``phase2_inputs`` makes its 256."""
    import torch

    rng, N, m = inp["rng"], inp["N"], PHASE2["m"]
    q = inp["vectors"][torch.tensor(rng.integers(0, N, B), device=device)]
    return q + 0.3 * torch.tensor(rng.normal(size=(B, m)).astype(np.float32),
                                  device=device)


def true_dists(q, x, ids, squared=False):
    """float64 distances of each query to the rows its ids name."""
    diff = q[:, None, :].double() - x[ids.long()].double()
    d2 = (diff * diff).sum(-1)
    return d2 if squared else d2.sqrt()


def check_l2_topk(inp, device, B, k, N=None, m=None,
                  reps=TIMING_REPS) -> dict:
    """The brute-force scan: B queries near the phase-2 rows against all
    N_AUDIO of them, or (with ``N`` and ``m``) seeded normal queries and
    rows of that ragged shape.  Distances at rtol and atol 1e-5; ids
    through their true distances at 1e-4 (an id may differ on a tie);
    every id in [0, N); and the kernel's own split of the base
    (``plan_splits``) bit-identical (``torch.equal``) to one split, in
    both modes.  Every timing counts both of the kernel's passes."""
    import torch
    from repro_torch.kernels.l2_topk import ops

    if N is None:
        x, N, m = inp["vectors"], inp["N"], PHASE2["m"]
        q = inp["queries"][:B] if B <= len(inp["queries"]) else \
            _near_queries(inp, B, device)
    else:
        rng = inp["rng"]
        x = torch.tensor(rng.normal(size=(N, m)).astype(np.float32),
                         device=device)
        q = torch.tensor(rng.normal(size=(B, m)).astype(np.float32),
                         device=device)
    plan = ops.plan_splits(B, N, k, ops.sm_count(device))
    err, same = 0.0, 1.0
    for squared in (False, True):
        got_d, got_i = ops.l2_topk(q, x, k, squared=squared)
        want_d, want_i = ops.l2_topk(q, x, k, squared=squared, impl="ref")
        torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-5)
        if not bool(((got_i >= 0) & (got_i < N)).all()):
            raise AssertionError(f"l2_topk (B={B} N={N} m={m} k={k}) "
                                 "returned an id outside [0, N)")
        torch.testing.assert_close(true_dists(q, x, got_i, squared),
                                   want_d.double(), rtol=1e-4, atol=1e-4)
        one_d, one_i = ops.l2_topk(q, x, k, squared=squared, splits=1)
        if not (torch.equal(got_d, one_d) and torch.equal(got_i, one_i)):
            raise AssertionError(
                f"l2_topk (B={B} N={N} m={m} k={k}, squared={squared}): "
                f"S={plan.splits} differs from S=1")
        if not squared:
            err = float((got_d - want_d).abs().max())
            same = float((got_i == want_i).float().mean())
    torch.backends.cuda.matmul.allow_tf32 = False
    qn = torch.sum(q * q, dim=1, keepdim=True)
    xn = torch.sum(x * x, dim=1)
    t = time_call(lambda: ops.l2_topk(q, x, k), "l2_topk", reps)
    tp = time_call(lambda: ops.l2_topk(q, x, k, impl="ref"), reps=reps)
    tl = time_call(lambda: torch.topk(
        torch.addmm(xn[None, :], q, x.T, alpha=-2.0).add_(qn), k, dim=1,
        largest=False), reps=reps)
    nb = (B + N) * m * 4 + B * k * 8
    bms, by = bound_ms(nb, 2 * B * N * m)
    return dict(name="l2_topk", max_abs_err=err, t=t, tp=tp, tl=tl,
                bound_ms=bms, bound_by=by, splits=plan.splits, tq=plan.tq,
                shape=f"B={B} N={N} m={m} k={k} f32 l2, ids equal "
                      f"{same:.4%}; S={plan.splits} (TQ={plan.tq}, "
                      f"{plan.split_tiles} tiles of {plan.tn} rows a split) "
                      "bit-identical to S=1",
                tol="dists rtol 1e-5; ids by true distance 1e-4")


def _beam(rng, B, L, C, device):
    import torch

    pool = np.linspace(0.5, 3.0, 11).astype(np.float32)   # many exact ties
    bd = np.sort(rng.choice(pool, size=(B, L)).astype(np.float32), axis=1)
    bd[:, L - 4:] = np.inf
    cd = rng.choice(pool, size=(B, C)).astype(np.float32)
    cd[rng.random((B, C)) < 0.4] = np.inf
    bi = rng.integers(0, N_AUDIO, size=(B, L)).astype(np.int32)
    ci = rng.integers(0, N_AUDIO, size=(B, C)).astype(np.int32)
    bi[np.isinf(bd)] = INVALID
    ci[np.isinf(cd)] = INVALID
    f = [torch.tensor(rng.random(s) < 0.5, device=device)
         for s in ((B, L), (B, L), (B, C))]
    t = functools.partial(torch.tensor, device=device)
    return t(bd), t(bi), f[0], f[1], t(cd), t(ci), f[2]


def check_beam_merge(inp, device, B, L, C) -> dict:
    import torch
    from repro_torch.kernels.beam_merge import ops

    args = _beam(inp["rng"], B, L, C, device)
    got = ops.beam_merge(*args)
    want = ops.beam_merge(*args, impl="ref")
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"beam_merge (B={B} L={L} C={C}) differs "
                                 "from the stable argsort")
    t = time_call(lambda: ops.beam_merge(*args), "beam_merge_kernel")
    tp = time_call(lambda: ops.beam_merge(*args, impl="ref"))
    cat = torch.cat([args[0], args[4]], dim=1)
    tl = time_call(lambda: torch.sort(cat, dim=1, stable=True))
    T = L + C
    nb = B * L * 10 + B * C * 9 + B * L * 10
    bms, by = bound_ms(nb, B * T * math.ceil(math.log2(T)))
    return dict(name="beam_merge", max_abs_err=0.0, t=t, tp=tp, tl=tl,
                bound_ms=bms, bound_by=by, shape=f"B={B} L={L} C={C}",
                tol="bit-exact")


def check_fused_hop(inp, device, E) -> dict:
    import torch
    from repro_torch.core import visited
    from repro_torch.kernels.fused_hop import ops
    from repro_torch.kernels.gather_dist import ops as gd_ops

    rng, B, d, m, V = (inp["rng"], PHASE2["B"], PHASE2["d"], PHASE2["m"],
                       PHASE2["V"])
    N, adj, v, q = inp["N"], inp["adjacency"], inp["vectors"], inp["queries"]
    sel = rng.integers(0, N, size=(B, E)).astype(np.int32)
    sel[rng.random((B, E)) < 0.1] = INVALID
    sel[1, 0] = N + 5                                  # clipped selection
    sel = torch.tensor(sel, device=device)
    nbrs = adj[sel.clamp(0, N - 1).long()].reshape(B, -1)
    seen = torch.where(torch.rand(nbrs.shape, device=device) < 0.3, nbrs,
                       INVALID)
    vis = visited.insert(visited.make_table(B, V, device), seen,
                         seen != INVALID)
    dist_all = gd_ops.gather_dist(v, nbrs, q, impl="ref")
    dmax = torch.quantile(dist_all, 0.3, dim=1).contiguous()
    got = ops.fused_hop(adj, v, sel, q, dmax, vis, n_valid=inp["n_valid"])
    want = ops.fused_hop(adj, v, sel, q, dmax, vis, n_valid=inp["n_valid"],
                         impl="ref")
    if not (torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])):
        raise AssertionError(f"fused_hop E={E}: nbr_ids or evals differ")
    # a distance within 1e-6 (relative) of dmax may fall on either side of
    # it under another summation order: such lanes are exempt from the id
    # comparison, every other lane must agree exactly
    valid = want[2] != INVALID
    border = (((dist_all - dmax[:, None]).abs() <= 1e-6 * dmax[:, None])
              & valid).any(dim=1)
    same = ((got[0] == want[0]).all(dim=1) | border)
    if not bool(same.all()) or int(border.sum()) > B // 100 + 1:
        raise AssertionError(f"fused_hop E={E}: candidate ids differ in "
                             f"{int((~same).sum())} lanes "
                             f"({int(border.sum())} border lanes)")
    ok = (~border)[:, None] & (want[0] != INVALID)
    torch.testing.assert_close(got[1][ok], want[1][ok], rtol=1e-5, atol=1e-6)
    err = float((got[1][ok] - want[1][ok]).abs().max()) if ok.any() else 0.0
    t = time_call(lambda: ops.fused_hop(adj, v, sel, q, dmax, vis,
                                        n_valid=inp["n_valid"]),
                  "fused_hop_kernel")
    tp = time_call(lambda: ops.fused_hop(adj, v, sel, q, dmax, vis,
                                         n_valid=inp["n_valid"], impl="ref"))
    act = sel != INVALID
    sel_rows = torch.unique(sel.clamp(0, N - 1)[act]).numel()
    scored_rows = torch.unique(want[0][want[0] != INVALID]).numel()
    evals = int(want[3].sum())
    n_valid_pos = int(valid.sum())
    nb = (B * E * 5 + sel_rows * d * 4
          + min(n_valid_pos * visited.DEFAULT_PROBES, B * V) * 4
          + scored_rows * m * 4 + B * m * 4 + B * 4 + 3 * B * E * d * 4 + B * 4)
    bms, by = bound_ms(nb, evals * 3 * m)
    return dict(name="fused_hop", max_abs_err=err, t=t, tp=tp, tl=None,
                bound_ms=bms, bound_by=by, shape=f"B={B} E={E} d={d} m={m} V={V}",
                tol="ids/nbr_ids/evals exact outside 1e-6 of dmax; rtol 1e-5")


@contextlib.contextmanager
def indexed_rows(tensors):
    """Record the row indices that each of ``tensors`` is indexed with
    (``t[idx]``) inside: yields one list of int64 tensors per tensor."""
    import torch
    from torch.overrides import TorchFunctionMode

    reads = [[] for _ in tensors]

    class Rows(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.__getitem__:
                for t, r in zip(tensors, reads):
                    if args[0] is t:
                        r.append(torch.as_tensor(args[1]).reshape(-1).long())
            return func(*args, **(kwargs or {}))

    with Rows():
        yield reads


def check_beam_search(inp, device, B, L, *, E=1, k=K, eps=EPS, rows="f32",
                      V=0, X=0, seeds=1, hop="composed", m_sub=24,
                      what="serve") -> dict:
    """The whole-search kernel at one of the main path's shapes, over the
    phase-2 adjacency (a graph of n_valid vertices) and rows (float32, fp16
    with ``rows="f16"``, with ``rows="sq8"`` the phase-2 rows encoded under
    their own sq8 scale, as ``check_gather_dist_q`` encodes them, or with
    ``rows="pq"`` the phase-2 rows encoded under seeded codebooks of
    ``m_sub`` subspaces, as ``check_pq_adc`` seeds them: the kernel
    computes the same function of any codebook, so no k-means fit): B
    lanes of near-row queries seeded at ``seeds``
    random vertices, ``X`` excluded ids a lane, a ``V``-slot visited
    table.  From one ``init``, the kernel against the host loop under
    ``hop`` with the per-hop kernels (``torch.equal`` on every field of
    the final state; ``hop="fused"`` runs ``fused_hop`` there over float32
    rows, which the whole search replaces by the composed hop with the
    visited filter, and the composed hop over a compressed store)
    and against the plain version: ids equal on AGREE_FLOOR of the slots,
    dists within rtol 1e-5 where the ids are equal, and the lanes' total
    hops and evals within 1 - AGREE_FLOOR of the plain version's (a lane's
    counters may differ where a distance rounds otherwise, the kernel
    summing a row's squares in its shuffle order and PyTorch in its own,
    and a comparison at the radius turns).  A call is timed alone, init
    and extract outside it.  The bound: the distinct store rows (code rows
    of m_sub bytes over pq, with its codebooks once) and adjacency rows the
    call reads (those the plain version indexes, which may add row 0, its
    filler for a slot it does not score), the sq8 scale once, the
    queries, exclude lists and visited tables, and the beam in and out,
    over the memory rate; or the operations, 3 a scored row's dimension
    (over sq8 4, the dequantizing multiply too; over pq: each lane's
    table, 3 a subspace, centroid and dimension, and m_sub adds a scored
    row).
    ``host_launches`` holds the kernel launches of the host-loop run."""
    import torch
    from repro_torch.core import beam
    from repro_torch.core.graph import DEGraph
    from repro_torch.kernels.beam_search import ops
    from repro_torch.quant import codec, pq
    from repro_torch.quant.store import VectorStore

    rng, d, m, n_valid = inp["rng"], PHASE2["d"], PHASE2["m"], inp["n_valid"]
    adj = inp["adjacency"]
    graph = DEGraph(adjacency=adj, weights=torch.zeros(adj.shape,
                                                       device=device),
                    n=n_valid)
    if rows == "pq":
        books = torch.tensor(rng.normal(size=(m_sub, 256, m // m_sub)).astype(
            np.float32), device=device)
        store = VectorStore(data=pq.encode(inp["vectors"], books), codec="pq",
                            codebooks=books)
    elif rows == "sq8":
        scale = codec.calibrate_sq8_scale(inp["vectors"])
        store = VectorStore(data=codec.sq8_encode(inp["vectors"], scale),
                            scale=scale, codec="sq8")
    elif rows == "f16":
        store = VectorStore(data=inp["vectors"].to(torch.float16),
                            codec="fp16")
    else:
        store = VectorStore(data=inp["vectors"])
    q = _near_queries(inp, B, device)

    def ids(shape):
        return torch.tensor(rng.integers(0, n_valid, size=shape).astype(
            np.int32), device=device)

    excl = (ids((B, X)) if X else
            torch.full((B, 1), INVALID, dtype=torch.int32, device=device))
    st = beam.init(store, q, ids((B, seeds)), excl, n_valid, beam_width=L,
                   metric="l2", visited_size=V)
    names = [f.name for f in dataclasses.fields(st)]
    state = [getattr(st, name) for name in names]
    max_hops = beam.default_max_hops(L)
    kw = dict(n_valid=n_valid, k=k, eps1=beam._eps1(eps), expand_width=E,
              max_hops=max_hops)

    def run(impl="kernel"):
        return ops.beam_search(adj, store.data, q, excl, *state, impl=impl,
                               scale=store.scale, codebooks=store.codebooks,
                               **kw)

    got = run()
    counters = launch_counters()
    before = {n: getattr(mod, a) for n, (mod, a) in counters.items()}
    host = beam.host_loop(st, graph, store, q, excl, k=k, eps=eps,
                          max_hops=max_hops, metric="l2", expand_width=E,
                          hop_backend=hop)
    sync()
    host_launches = {n: getattr(mod, a) - before[n]
                     for n, (mod, a) in counters.items()}
    for name, g in zip(names, got):
        h = getattr(host, name)
        if not ((g is None and h is None) or torch.equal(g, h)):
            raise AssertionError(f"beam_search ({what}, B={B} L={L} E={E} "
                                 f"{rows} V={V} {hop}): {name} differs from "
                                 "the host loop's")
    with indexed_rows((adj, store.data)) as reads:
        plain = run("ref")
    agree = got[0] == plain[0]
    same = float(agree.float().mean())
    if same < AGREE_FLOOR:
        raise AssertionError(f"beam_search ({what}): ids equal the plain "
                             f"version's on only {same:.4f} of slots")
    if not torch.allclose(got[1][agree], plain[1][agree], rtol=1e-5, atol=0):
        raise AssertionError(f"beam_search ({what}): dists differ from the "
                             "plain version's by more than rtol 1e-5")
    for name, i in (("hops", 4), ("evals", 5)):
        a, b = int(got[i].sum()), int(plain[i].sum())
        if abs(a - b) > (1 - AGREE_FLOOR) * b:
            raise AssertionError(f"beam_search ({what}): {a} {name} in all, "
                                 f"the plain version {b}")
    lanes = int(((got[4] != plain[4]) | (got[5] != plain[5])).sum())
    both = agree & torch.isfinite(got[1])
    err = float((got[1] - plain[1])[both].abs().max()) if both.any() else 0.0
    t = time_call(run, "beam_search_kernel")
    tp = time_call(lambda: run("ref"), reps=2)
    hops = got[4] - st.hops
    scored = int((got[5] - st.evals).sum())
    expanded = int(hops.sum())
    n_adj, n_rows = (int(torch.cat(r).unique().numel()) if r else 0
                     for r in reads)
    # a row's bytes (m_sub code bytes over pq) and the operations
    label = rows
    if rows == "pq":
        row_bytes, n_ops = m_sub, 3 * B * 256 * m + scored * m_sub
        books_bytes = store.codebooks.numel() * 4
        label = f"pq m_sub={m_sub}"
    elif rows == "sq8":
        row_bytes, n_ops, books_bytes = m, 4 * scored * m, m * 4
    else:
        row_bytes, n_ops, books_bytes = (m * store.data.element_size(),
                                         3 * scored * m, 0)
    nb = (n_rows * row_bytes + books_bytes + n_adj * d * 4 + B * L * 10 * 2
          + B * m * 4 + excl.numel() * 4 + 2 * B * V * 4 + B * 8 * 2)
    bms, by = bound_ms(nb, n_ops)
    return dict(name="beam_search", max_abs_err=err, t=t, tp=tp, tl=None,
                bound_ms=bms, bound_by=by, host_launches=host_launches,
                shape=f"{what}: B={B} L={L} E={E} k={k} eps={eps} d={d} "
                      f"m={m} {label} V={V} X={X} {hop}, "
                      f"{expanded / B:.1f} hops and "
                      f"{scored / B:.1f} evals a lane, at most "
                      f"{int(hops.max())} hops; {n_rows} distinct rows and "
                      f"{n_adj} adjacency rows read; ids equal to the plain "
                      f"version's on {same:.4%} of slots, hops and evals on "
                      f"{B - lanes} of {B} lanes",
                tol="every state field equal to the host loop's "
                    "(torch.equal); ids >= 99% equal to the plain version, "
                    "dists rtol 1e-5 there, total hops and evals within 1%")


def check_mrng_occlusion(inp, device, B, K) -> dict:
    """The lune test at (B, K, d): ids from N_AUDIO rows with INVALID and
    out-of-range slots, weights within 20% of the true distances and each
    candidate distance at the median of its row's max(dist, w), so about
    half the flags are set."""
    import torch
    from repro_torch.kernels.mrng_occlusion import ops

    rng, d, m, N = inp["rng"], PHASE2["d"], PHASE2["m"], inp["N"]
    ids = rng.integers(0, N, size=(B, K, d)).astype(np.int32)
    ids[rng.random((B, K, d)) < 0.05] = INVALID
    ids[0, 0, :2] = [N, N + 7]                              # clipped ids
    ids = torch.tensor(ids, device=device)
    v, q = inp["vectors"], inp["queries"][:B]
    nd0, _ = ops.mrng_occlusion(v, ids, q, torch.zeros((B, K), device=device),
                                torch.zeros((B, K, d), device=device),
                                impl="ref")
    w = (nd0 * torch.tensor(rng.uniform(0.8, 1.2, size=(B, K, d)).astype(
        np.float32), device=device)).contiguous()
    cd = torch.quantile(torch.maximum(nd0, w), 0.5, dim=2).contiguous()
    err = 0.0
    for metric in ("l2", "sqeuclidean"):
        got = ops.mrng_occlusion(v, ids, q, cd, w, metric=metric)
        want = ops.mrng_occlusion(v, ids, q, cd, w, metric=metric,
                                  impl="ref")
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        # a flag whose two sides lie within 1e-5 (relative) may fall either
        # way under another summation order; every other flag must agree
        border = ((cd[:, :, None] - torch.maximum(want[0], w)).abs()
                  <= 1e-5 * cd[:, :, None].abs())
        if not bool(((got[1] == want[1]) | border).all()):
            raise AssertionError(f"mrng_occlusion ({metric}, B={B} K={K}): "
                                 "occlusion flags differ off the border")
        if metric == "l2":
            err = float((got[0] - want[0]).abs().max())
            n_set = int(want[1].sum())
    t = time_call(lambda: ops.mrng_occlusion(v, ids, q, cd, w),
                  "mrng_occlusion_kernel")
    tp = time_call(lambda: ops.mrng_occlusion(v, ids, q, cd, w, impl="ref"))
    rows = torch.unique(ids.clamp(0, N - 1)).numel()
    P = B * K * d
    nb = rows * m * 4 + B * m * 4 + B * K * 4 + P * (4 + 4 + 4 + 1)
    bms, by = bound_ms(nb, P * (3 * m + 2))
    return dict(name="mrng_occlusion", max_abs_err=err, t=t, tp=tp, tl=None,
                bound_ms=bms, bound_by=by,
                shape=f"B={B} K={K} d={d} m={m} f32 l2, {n_set} of {P} set",
                tol="dists rtol 1e-5; flags equal off a 1e-5 border")


def extend_select_inputs(inp, device, W, *, failed=False):
    """An extend block's operands over the phase-2 graph: W near-row
    points, each with its K_EXT nearest of 4 K_EXT random vertices as its
    ascending candidate list, taking the ids after the graph's vertices
    (so every candidate is eligible), and edge weights that are the true
    distances of the candidates' rows.  ``failed``: lane 0 keeps 3
    candidates and lane 1 none (both must fail), lane 2 takes an id below
    half its candidates (they become ineligible), and in a copy of the
    graph lane 3's first candidate becomes the first neighbor of each of
    its others, whose distances are doubled: once the first joins U, the
    lune test blocks every other, and the phase-2 latch flips."""
    import torch

    rng, N, n_valid = inp["rng"], inp["N"], inp["n_valid"]
    vec, adj = inp["vectors"], inp["adjacency"]
    K = K_EXT
    q = _near_queries(inp, W, device)
    pool = torch.tensor(np.stack([rng.choice(n_valid, 4 * K, replace=False)
                                  for _ in range(W)]).astype(np.int32),
                        device=device)
    dist = true_dists(q, vec, pool).float()
    order = torch.argsort(dist, dim=1, stable=True)[:, :K]
    cand = torch.gather(pool, 1, order).contiguous()
    cand_d = torch.gather(dist, 1, order).contiguous()
    v_ids = torch.arange(n_valid, n_valid + W, dtype=torch.int32,
                         device=device)
    if failed:
        cand[0, 3:] = INVALID
        cand_d[0, 3:] = float("inf")
        cand[1] = INVALID
        cand_d[1] = float("inf")
        v_ids[2] = int(cand[2].median())
        adj = adj.clone()
        adj[cand[3, 1:].long(), 0] = cand[3, 0]
        cand_d[3] *= 2
    rows = torch.unique(cand[cand != INVALID]).long()
    nbr = adj[rows].long().clamp(0, N - 1)
    weights = torch.zeros(adj.shape, device=device)
    weights[rows] = (vec[rows][:, None, :] - vec[nbr]).norm(dim=-1)
    return (adj, weights, vec, cand, cand_d, q, v_ids)


def check_extend_select(inp, device, W, *, failed=False,
                        what="extend block") -> dict:
    """The Alg. 3 selection pass at (W, K_EXT, d) on extend_select_inputs:
    for every scheme, with and without the Alg. 2 check, and under
    sqeuclidean, the kernel against the two-step path it replaces (the
    mrng_occlusion kernel, then the torch steps): sel_ids, sel_dists and
    ok equal (torch.equal, the lune test being the same device function);
    and against its plain version: sel_ids equal on AGREE_FLOOR of the
    slots, sel_dists within rtol 1e-5 where they are, ok equal.  The
    scheme of the audio config (C, with the check) is timed, beside the
    two-step path (logged).  The bound: the distinct valid neighbor rows,
    the candidates' adjacency and weight rows, the queries, candidates and
    outputs, over the memory rate; or 3 operations a scored row's
    dimension."""
    import torch
    from repro_torch.kernels.extend_select import ops, ref
    from repro_torch.kernels.mrng_occlusion import ops as occ_ops

    d, m = PHASE2["d"], PHASE2["m"]
    args = extend_select_inputs(inp, device, W, failed=failed)

    def two_step(**kw):
        return ref.extend_select_ref(*args, occlusion=occ_ops.mrng_occlusion,
                                     **kw)

    agree, n_latched, n_failed, err = [], 0, 0, 0.0
    for kw in [dict(scheme=s, rng_checks=c) for s in ref.SCHEMES
               for c in (True, False)] + [dict(metric="sqeuclidean")]:
        got = ops.extend_select(*args, **kw)
        want = two_step(**kw)
        for name, g, h in zip(("sel_ids", "sel_dists", "ok"), got, want):
            if not torch.equal(g, h):
                raise AssertionError(f"extend_select ({what}, W={W}, {kw}): "
                                     f"{name} differs from the two-step "
                                     "path's")
        *plain, latched = ref.extend_select_latched(*args, **kw)
        same = got[0] == plain[0]
        agree.append(float(same.float().mean()))
        if not torch.equal(got[2], plain[2]):
            raise AssertionError(f"extend_select ({what}, {kw}): ok differs "
                                 "from the plain version's")
        fin = same & torch.isfinite(plain[1])
        if not torch.allclose(got[1][fin], plain[1][fin], rtol=1e-5, atol=0):
            raise AssertionError(f"extend_select ({what}, {kw}): sel_dists "
                                 "differ from the plain version's by more "
                                 "than rtol 1e-5")
        if fin.any():
            err = max(err, float((got[1] - plain[1])[fin].abs().max()))
        if kw.get("rng_checks", True) and kw.get("scheme", "C") == "C":
            n_latched = max(n_latched, int(latched.sum()))
            n_failed = max(n_failed, int((~got[2]).sum()))
    if min(agree) < AGREE_FLOOR:
        raise AssertionError(f"extend_select ({what}): sel_ids equal the "
                             f"plain version's on only {min(agree):.4f} of "
                             "slots")
    if failed and not (n_failed >= 2 and n_latched >= 1):
        raise AssertionError(f"extend_select ({what}): {n_failed} failed "
                             f"and {n_latched} latched lanes, want >= 2 "
                             "and >= 1")
    t = time_call(lambda: ops.extend_select(*args), "extend_select_kernel")
    tp = time_call(lambda: ops.extend_select(*args, impl="ref"))
    t2 = time_call(two_step)
    log(f"  extend_select ({what}): the two-step path it replaces "
        f"(mrng_occlusion kernel, then the torch steps) "
        f"{t2['device_ms']:.6f} ms device ({t2['timed_by']}; "
        f"{t2['event_ms']:.6f} ms per eager call)")
    adj, weights, vec, cand, cand_d, q, v_ids = args
    valid = (cand != INVALID) & (cand < v_ids[:, None])
    nbr = adj[torch.where(valid, cand, 0).long()]
    scored = valid[:, :, None] & (nbr != INVALID)
    rows = torch.unique(nbr[scored].long().clamp(0, inp["N"] - 1)).numel()
    cand_rows = torch.unique(cand[valid]).numel()
    nb = (rows * m * 4 + cand_rows * d * 8 + q.numel() * 4 + cand.numel() * 8
          + W * 4 + W * d * 8 + W)
    bms, by = bound_ms(nb, 3 * int(scored.sum()) * m)
    return dict(name="extend_select", max_abs_err=err, t=t, tp=tp, tl=None,
                two_step=t2, bound_ms=bms, bound_by=by,
                shape=f"{what}: W={W} K={K_EXT} d={d} m={m} f32 l2, "
                      f"{int(scored.sum())} rows scored ({rows} distinct), "
                      f"cluster {ops.cluster_size(K_EXT)}; {n_failed} failed "
                      f"and {n_latched} latched lanes (scheme C); sel_ids "
                      f"equal to the plain version's on {min(agree):.4%} "
                      "of slots or more",
                tol="sel_ids, sel_dists, ok equal to the two-step path "
                    "(torch.equal); ids >= 99% equal to the plain version, "
                    "dists rtol 1e-5 there, ok equal")


def last_block(n: int, degree: int) -> int:
    """Lanes of the last extend block of a build of ``n`` vertices: the
    first degree + 1 form the initial graph, the rest come in waves."""
    return (n - degree - 1) % WAVE % EXTEND_BLOCK or EXTEND_BLOCK


def phase2(device, n_build=N_AUDIO, n_queries=N_QUERIES) -> dict:
    from repro_torch.configs.deg import QUANT_PRESETS
    from repro_torch.core.beam import default_beam_width, default_visited_size

    inp = phase2_inputs(device)
    B, d, L = PHASE2["B"], PHASE2["d"], PHASE2["L"]
    # the other shapes the main path gives the kernels: an insert wave's
    # search (k = k_ext), the last hop of an exploration session, whose
    # exclude list holds the seed twice plus 3 hops of k results, and
    # refinement's searches (k = k_opt): a chunk's batched first search
    # and the single-lane live searches of Alg. 4
    L_wave = default_beam_width(K_EXT, d, 1)
    L_explore = default_beam_width(K, d, 1, 2 + (EXPLORE_HOPS - 1) * K)
    L_opt = default_beam_width(K_OPT, d, 2)
    # the compressed presets' beams (phase 4b): L grows to the rerank width
    L_sq8 = max(L, QUANT_PRESETS["sq8-serving"].rerank_k)
    pq_serving = QUANT_PRESETS["pq-serving"]
    L_pq = max(L, pq_serving.rerank_k)
    # the fused preset's default tables: 1,024 slots at L=30 (and sq8's
    # L=40), 4,096 at 120
    V_fused, V_pq = default_visited_size(L, d), default_visited_size(L_pq, d)
    V_sq8 = default_visited_size(L_sq8, d)
    results = [check_gather_dist(inp, device, B),
               check_beam_merge(inp, device, B, L, d),
               check_beam_merge(inp, device, B, L, 4 * d),
               check_fused_hop(inp, device, 1),
               check_fused_hop(inp, device, 4),
               check_gather_dist(inp, device, WAVE),
               check_beam_merge(inp, device, WAVE, L_wave, d),
               check_gather_dist(inp, device, EXPLORE_SESSIONS),
               check_beam_merge(inp, device, EXPLORE_SESSIONS, L_explore, d),
               check_mrng_occlusion(inp, device, EXTEND_BLOCK, K_EXT),
               check_mrng_occlusion(inp, device, CHUNK, d),
               check_mrng_occlusion(inp, device, last_block(n_build, d),
                                    K_EXT),
               # the extension's selection pass: an extend block, the
               # build's last block, and failed lanes with the latch
               check_extend_select(inp, device, EXTEND_BLOCK),
               check_extend_select(inp, device, last_block(n_build, d),
                                   what="last block"),
               check_extend_select(inp, device, EXTEND_BLOCK, failed=True,
                                   what="failed lanes and the latch"),
               check_gather_dist(inp, device, REFINE_LANES),
               check_beam_merge(inp, device, REFINE_LANES, L_opt, d),
               check_gather_dist(inp, device, 1),
               check_beam_merge(inp, device, 1, L_opt, d),
               check_gather_dist_q(inp, device, d),
               check_pq_adc(inp, device, d),
               check_gather_dist(inp, device, B, rows="f16"),
               check_gather_dist_q(inp, device, 4 * d),
               check_pq_adc(inp, device, 4 * d),
               check_beam_merge(inp, device, B, L_sq8, d),
               check_beam_merge(inp, device, B, L_pq, d),
               check_beam_merge(inp, device, B, L_pq, 4 * d),
               # bf16 rows: on no path yet, but built into gather_dist.cu
               check_gather_dist(inp, device, B, rows="bf16"),
               # the brute-force scan: the ground truth of phase 4 (over
               # every query; its plain version holds the whole (B, N)
               # matrix, so fewer timing runs) and of phase 4c's baselines,
               # the serving batch, a single query, a ragged shape and the
               # padding case
               check_l2_topk(inp, device, n_queries, K, reps=5),
               check_l2_topk(inp, device, N_BASELINE_QUERIES, K,
                             N=N_HOST, m=PHASE2["m"]),
               check_l2_topk(inp, device, B, K),
               check_l2_topk(inp, device, B, 100),
               check_l2_topk(inp, device, 1, K),
               check_l2_topk(inp, device, 37, 50, N=1000, m=33),
               check_l2_topk(inp, device, 3, 50, N=130, m=16),
               # the whole search at the eligible paths' shapes: classic
               # serving on float32 and fp16 rows, an E=4 and a visited
               # search, an insert wave, an exploration hop, refinement's
               # batched and live searches
               check_beam_search(inp, device, B, L),
               check_beam_search(inp, device, B, L, rows="f16",
                                 what="serve fp16"),
               check_beam_search(inp, device, B, L, E=4, what="multi-e4"),
               check_beam_search(inp, device, B, L, E=2, V=PHASE2["V"],
                                 what="visited"),
               check_beam_search(inp, device, WAVE, L_wave, k=K_EXT,
                                 eps=EPS_EXT, what="wave"),
               check_beam_search(inp, device, EXPLORE_SESSIONS, L_explore,
                                 X=2 + (EXPLORE_HOPS - 1) * K,
                                 what="explore"),
               check_beam_search(inp, device, REFINE_LANES, L_opt, k=K_OPT,
                                 eps=EPS_OPT, seeds=2, what="refine"),
               check_beam_search(inp, device, 1, L_opt, k=K_OPT,
                                 eps=EPS_OPT, seeds=2, what="refine live"),
               # pq-serving under "classic" and "multi-e4-fused", and
               # "multi-e4-fused" over float32 rows, each held against the
               # host loop with pq_adc or fused_hop
               check_beam_search(inp, device, B, L_pq, eps=pq_serving.eps,
                                 rows="pq", what="pq-serving"),
               check_beam_search(inp, device, B, L_pq, E=4, V=V_pq,
                                 eps=pq_serving.eps, rows="pq", hop="fused",
                                 what="pq-serving multi-e4-fused"),
               check_beam_search(inp, device, B, L, E=4, V=V_fused,
                                 hop="fused", what="multi-e4-fused"),
               # sq8-serving under "classic" and "multi-e4-fused", each held
               # against the host loop with gather_dist_q and beam_merge
               check_beam_search(inp, device, B, L_sq8, rows="sq8",
                                 what="sq8-serving"),
               check_beam_search(inp, device, B, L_sq8, E=4, V=V_sq8,
                                 rows="sq8", hop="fused",
                                 what="sq8-serving multi-e4-fused")]
    for r in results:
        log(f"phase2 {r['name']} [{r['shape']}] ok ({r['tol']}): "
            + timings(r, "library"))
    host_loop = {name: sum(r["host_launches"][name] for r in results
                           if "host_launches" in r)
                 for name in launch_counters()}
    log(f"phase2 the host loops' launches beside beam_search: {host_loop}")
    # the JSON rows carry the main path's shapes: the classic hop's merge
    # (C = d), the fused preset's hop (E = 4), a refine chunk's lune test
    # (the main path's mrng_occlusion launches), an extend block's
    # selection pass (K = k_ext), the ground truth's scan and classic
    # serving's whole search
    by_name = {}
    for r in results:
        by_name.setdefault(r["name"], []).append(r)
    rows = {"gather_dist": by_name["gather_dist"][0],
            "beam_merge": by_name["beam_merge"][0],
            "fused_hop": by_name["fused_hop"][1],
            "mrng_occlusion": by_name["mrng_occlusion"][1],
            "extend_select": by_name["extend_select"][0],
            "gather_dist_q": by_name["gather_dist_q"][0],
            "pq_adc": by_name["pq_adc"][0],
            "l2_topk": by_name["l2_topk"][0],
            "beam_search": by_name["beam_search"][0]}
    return rows, host_loop


# ---------------------------------------------------------------------------
# phases 3 and 4: build, serve, explore
# ---------------------------------------------------------------------------
def launch_counters() -> dict:
    """Every kernel's launch counter as name -> (ops module, attribute);
    fp16 rows' launches of gather_dist are also counted apart."""
    from repro_torch.kernels.bag_lookup import ops as bag_ops
    from repro_torch.kernels.beam_merge import ops as bm_ops
    from repro_torch.kernels.beam_search import ops as bs_ops
    from repro_torch.kernels.extend_select import ops as es_ops
    from repro_torch.kernels.fused_hop import ops as fh_ops
    from repro_torch.kernels.gather_dist import ops as gd_ops
    from repro_torch.kernels.gather_dist_q import ops as gdq_ops
    from repro_torch.kernels.l2_topk import ops as l2_ops
    from repro_torch.kernels.mrng_occlusion import ops as mo_ops
    from repro_torch.kernels.pq_adc import ops as adc_ops

    return {"beam_search": (bs_ops, "launches"),
            "extend_select": (es_ops, "launches"),
            "gather_dist": (gd_ops, "launches"),
            "gather_dist[fp16]": (gd_ops, "launches_f16"),
            "beam_merge": (bm_ops, "launches"),
            "fused_hop": (fh_ops, "launches"),
            "mrng_occlusion": (mo_ops, "launches"),
            "gather_dist_q": (gdq_ops, "launches"),
            "pq_adc": (adc_ops, "launches"),
            "l2_topk": (l2_ops, "launches"),
            "bag_lookup": (bag_ops, "launches")}


def counted(ops: dict, total: dict, fn, *args, **kwargs):
    """Run one piece of the main path with every launch counter of ``ops``
    (name -> (module, counter attribute)) set to 0 just before it, and add
    the counts read just after it into ``total``.  Warm-ups, profiled
    reruns and comparisons run outside."""
    for m, attr in ops.values():
        setattr(m, attr, 0)
    out = fn(*args, **kwargs)
    for name, (m, attr) in ops.items():
        total[name] += getattr(m, attr)
    return out


@contextlib.contextmanager
def range_search_calls(calls: list):
    """Append an entry to ``calls`` for every ``range_search`` call made
    inside.  DEGIndex.search_batch (served queries, exploration, the
    insert waves, refinement's searches), search_graph and NSW's inserts
    and searches reach it through these three modules."""
    from repro_torch.core import build, search
    from repro_torch.core.baselines import nsw

    inner = search.range_search

    def counting(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    mods = (build, search, nsw)
    try:
        for m in mods:
            m.range_search = counting
        yield
    finally:
        for m in mods:
            m.range_search = inner


def count_searches(count, what: str, fn, *args, kernel: bool, **kwargs):
    """``count(fn, ...)``, one counted piece of the main path, and its
    launches read just after it: one beam_search launch for each of its
    range_search calls where ``kernel`` (the search kernel takes their
    configuration), and then no beam_merge, gather_dist, gather_dist_q,
    pq_adc or fused_hop launch beside them; no beam_search launch where
    not.
    Returns fn's result and the number of calls."""
    from repro_torch.kernels.beam_search import ops as bs

    calls = []
    with range_search_calls(calls):
        out = count(fn, *args, **kwargs)
    counters = launch_counters()
    hop = {name: getattr(*counters[name]) for name in (
        "beam_merge", "gather_dist", "gather_dist_q", "pq_adc", "fused_hop")}
    log(f"  {what}: {len(calls)} range_search calls; launches: beam_search "
        f"{bs.launches}, " + ", ".join(f"{n} {v}" for n, v in hop.items()))
    expect_launches("beam_search", bs.launches, len(calls) if kernel else 0,
                    f"range_search calls ({what})")
    if kernel:
        for name, n in hop.items():
            expect_launches(name, n, 0, what)
    return out, len(calls)


def check_main_path_launches(launches: dict, host_loop: dict) -> None:
    """Every kernel the main path runs launched there, and each of
    HOST_LOOP_ONLY launched no time there (beam_search took every search
    it served) and at least once in phase 2's comparisons against the
    host loop (``host_loop``, name -> launches)."""
    for name, n in launches.items():
        if name in HOST_LOOP_ONLY:
            expect_launches(name, n, 0, "launches on the main path (it "
                            "serves the host loop only)")
            if host_loop[name] == 0:
                raise AssertionError(f"phase 2's host loops never launched "
                                     f"{name}")
        elif n == 0:
            raise AssertionError(f"the main path never launched {name}")


def extend_blocks(inserted: int) -> int:
    """Extend-block passes of a build that inserted ``inserted`` vertices
    in waves of WAVE: one per EXTEND_BLOCK vertices of each wave."""
    return ((inserted // WAVE) * -(-WAVE // EXTEND_BLOCK)
            + -(-(inserted % WAVE) // EXTEND_BLOCK))


def build_phase(n: int, n_query: int, device, count=None, *,
                device_extend=True, tag="phase3"):
    """Build over the manifold data at the audio config; Table-1 after.
    With the device extension, one ``extend_select`` launch an extend
    block and no ``mrng_occlusion`` launch.  Returns the index, the base
    vectors, the queries and the launches of ``extend_select`` in the
    build."""
    from repro_torch.configs.deg import DEG_PAPER_CONFIGS
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.core.build import build_deg
    from repro_torch.core.invariants import check_table1
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels.extend_select import ops as es_ops
    from repro_torch.kernels.mrng_occlusion import ops as occ_ops

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    t0 = time.perf_counter()
    base, queries = make_dataset("manifold", n, n_query, DIM, seed=0)
    log(f"{tag} data: manifold base {base.shape} queries {queries.shape} "
        f"in {time.perf_counter() - t0:.2f} s")
    params = dataclasses.replace(DEG_PAPER_CONFIGS["audio"],
                                 device_extend=device_extend)
    assert (params.k_ext, params.eps_ext) == (K_EXT, EPS_EXT), \
        "phase 2 checks the wave shape at K_EXT and EPS_EXT"
    assert params.extend_block == EXTEND_BLOCK
    t0 = time.perf_counter()
    idx, n_calls = count_searches(
        count, f"{tag} build", build_deg, base, params, wave_size=WAVE,
        device=device,
        kernel=search_kernel_eligible(base, "l2", "composed", device))
    sync()
    secs = time.perf_counter() - t0
    waves = -(-(n - params.degree - 1) // WAVE)
    if n_calls != waves:
        raise AssertionError(f"{n_calls} range_search calls for {waves} "
                             "insert waves")
    sel, occ = es_ops.launches, occ_ops.launches
    st = idx.build_stats
    inserted = st["vertices"]
    blocks = extend_blocks(inserted)
    mode = "device" if device_extend else "host"
    log(f"{tag} build: n={idx.n} degree={params.degree} k_ext="
        f"{params.k_ext} eps_ext={params.eps_ext} wave_size={WAVE} "
        f"{mode} extension: {secs:.2f} s (search_s {st['search_s']:.2f}, "
        f"extend_s {st['extend_s']:.2f}, {inserted} vertices); "
        f"extend_select launches {sel}, mrng_occlusion launches {occ}"
        + (f" for {blocks} extend blocks" if device_extend else ""))
    if device_extend:
        expect_launches("extend_select", sel, blocks, "extend blocks")
        expect_launches("mrng_occlusion", occ, 0, "extend blocks (the "
                        "selection pass runs the lune test)")
    inv = check_table1(idx.builder)
    log(f"{tag} table-1: {inv}")
    if not all(inv.values()):
        raise AssertionError(f"Table-1 invariants broken: {inv}")
    return idx, base, queries, sel


def wave_search(idx, pts) -> np.ndarray:
    """One insert wave's candidate search (k = k_ext, eps = eps_ext), as
    ``DEGIndex._insert_wave`` runs it, on the built graph."""
    seeds = np.zeros((len(pts), 1), np.int32)
    return idx.search_batch(pts, seeds, k=idx.params.k_ext,
                            eps=idx.params.eps_ext).ids.cpu().numpy()


def wave_phase(idx, queries) -> np.ndarray:
    """Time and profile one insert wave's search and one extend block's
    selection pass on the built graph; returns the wave's ids."""
    from repro_torch.core.extend import extend_wave

    pts = queries[:WAVE]
    ids = wave_search(idx, pts)                                  # warm-up
    t0 = time.perf_counter()
    wave_search(idx, pts)
    idle_share(lambda: wave_search(idx, pts),
               (time.perf_counter() - t0) * 1e3,
               f"phase3 one wave search ({WAVE} lanes)")
    # the block's candidates as its wave search finds them; the lanes take
    # the ids after the last vertex, so every candidate is eligible, and
    # the pass reads the graph without changing it
    blk = pts[:EXTEND_BLOCK]
    res = idx.search_batch(blk, np.zeros((EXTEND_BLOCK, 1), np.int32),
                           k=idx.params.k_ext, eps=idx.params.eps_ext)

    def select():
        return extend_wave(idx, blk, res.ids, res.dists, idx.n)

    select()                                                     # warm-up
    t0 = time.perf_counter()
    select()
    wall = (time.perf_counter() - t0) * 1e3
    st = idx.build_stats
    per_block = st["extend_s"] * 1e3 / extend_blocks(st["vertices"])
    log(f"phase3 extend: {per_block:.3f} ms of extend_s per block of "
        f"{EXTEND_BLOCK} (selection pass, apply, host completion)")
    idle_share(select, wall, f"phase3 one extend block's selection pass "
               f"({EXTEND_BLOCK} lanes, K={idx.params.k_ext})")
    return ids


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain version for the duration
    (a CUDA tensor then never reaches a kernel)."""
    from repro_torch.kernels.bag_lookup import ops as bag
    from repro_torch.kernels.beam_merge import ops as bm
    from repro_torch.kernels.beam_search import ops as bs
    from repro_torch.kernels.extend_select import ops as es
    from repro_torch.kernels.fused_hop import ops as fh
    from repro_torch.kernels.gather_dist import ops as gd
    from repro_torch.kernels.gather_dist_q import ops as gdq
    from repro_torch.kernels.l2_topk import ops as l2
    from repro_torch.kernels.mrng_occlusion import ops as mo
    from repro_torch.kernels.pq_adc import ops as adc

    saved = [(m, name, getattr(m, name)) for m, name in
             ((bs, "beam_search"), (bm, "beam_merge"), (fh, "fused_hop"),
              (gd, "gather_dist"), (es, "extend_select"),
              (mo, "mrng_occlusion"), (gdq, "gather_dist_q"),
              (adc, "pq_adc"), (l2, "l2_topk"), (bag, "bag_lookup"))]
    try:
        for m, name, fn in saved:
            setattr(m, name, functools.partial(fn, impl="ref"))
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _batches(search, queries, batch):
    """Run ``search`` (host queries -> SearchResult) over ``queries`` in
    batches; returns host ids, hops and evals."""
    ids, hops, evals = [], [], []
    for lo in range(0, len(queries), batch):
        r = search(queries[lo : lo + batch])
        ids.append(r.ids.cpu().numpy())
        hops.append(r.hops.cpu().numpy())
        evals.append(r.evals.cpu().numpy())
    return np.concatenate(ids), np.concatenate(hops), np.concatenate(evals)


def _serve(idx, queries, preset, k, eps, batch, quant=None):
    """Serve ``queries`` in batches under a search preset and, with
    ``quant`` (a QuantPreset), over its compressed store: its eps where it
    sets one, its codec and its rerank width."""
    kw = {}
    if quant is not None:
        eps = eps if quant.eps is None else quant.eps
        kw = dict(quantized=quant.codec, rerank_k=quant.rerank_k or None)
    return _batches(lambda q: idx.search_batch(
        q, k=k, eps=eps, expand_width=preset.expand_width,
        hop_backend=preset.hop_backend, visited_size=preset.visited_size,
        beam_width=preset.beam_width, **kw), queries, batch)


def ground_truth(base, queries, device, count=None, *, k=K,
                 tag="phase4") -> np.ndarray:
    """Exact k-NN ids of ``queries`` over ``base``: the brute-force scan
    through the ``l2_topk`` kernel (``BruteForceIndex.search(backend=
    "kernel")``, through ``count``), held against ``exact_knn_batched``:
    ids equal on GT_AGREE of the slots and every other slot a tie (the two
    distances there within GT_RTOL).  Prints both times and the serial
    scan's queries per second."""
    from repro_torch.core.baselines import BruteForceIndex
    from repro_torch.core.distances import exact_knn_batched

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    bf = BruteForceIndex(base, device=device)
    sync()
    t0 = time.perf_counter()
    d, ids = count(bf.search, queries, k, backend="kernel")
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_ref, ids_ref = exact_knn_batched(queries, base, k, device=device)
    secs_ref = time.perf_counter() - t0
    same = float((ids == ids_ref).mean())
    diff = ids != ids_ref
    ties = np.isclose(d[diff], d_ref[diff], rtol=GT_RTOL, atol=0.0)
    log(f"{tag} ground truth of {len(queries)} queries over {len(base)} "
        f"rows: l2_topk scan {secs:.3f} s = {len(queries) / secs:.1f} QPS "
        f"(serial scan), exact_knn_batched {secs_ref:.3f} s; ids equal on "
        f"{same:.4%} of {ids.size} slots, {int(diff.sum())} differing "
        f"slots, {int(ties.sum())} of them ties within rtol {GT_RTOL}")
    if same < GT_AGREE or not ties.all():
        raise AssertionError(f"{tag}: the l2_topk ground truth disagrees "
                             "with exact_knn_batched")
    np.testing.assert_allclose(d, d_ref, rtol=GT_RTOL, atol=GT_RTOL)
    return ids


def serve_phase(idx, base, queries, device, count=None, *, k=K, eps=EPS,
                batch=BATCH, gt=None, presets=("classic", "multi-e4-fused"),
                tag="phase4") -> dict:
    """Serve every query under each preset; returns each preset's result
    and, under "gt", the exact k-NN ids (the brute-force scan of
    ``ground_truth`` unless given).  Only the ground truth and the timed
    loops go through ``count``."""
    from repro_torch.configs.deg import SEARCH_PRESETS
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.core.metrics import recall_at_k

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    if gt is None:
        gt = ground_truth(base, queries, device, count, k=k, tag=tag)
    out = {"gt": gt}
    for name in presets:
        preset = SEARCH_PRESETS[name]
        _serve(idx, queries[:batch], preset, k, eps, batch)       # warm-up
        sync()
        t0 = time.perf_counter()
        (ids, hops, evals), n_calls = count_searches(
            count, f"{tag} serve {name}", _serve, idx, queries, preset, k,
            eps, batch, kernel=search_kernel_eligible(
                idx._dev_vectors, "l2", preset.hop_backend, device))
        secs = time.perf_counter() - t0
        if n_calls != -(-len(queries) // batch):
            raise AssertionError(f"{n_calls} range_search calls for "
                                 f"{len(queries)} queries in batches of "
                                 f"{batch}")
        rec = recall_at_k(ids, gt)
        log(f"{tag} serve {name}: {len(queries)} queries in {secs:.3f} s = "
            f"{len(queries) / secs:.1f} QPS, recall@{k} {rec:.4f}, "
            f"mean hops {hops.mean():.2f}, mean evals {evals.mean():.1f}")
        if rec < RECALL_FLOOR:
            raise AssertionError(f"{name}: recall@{k} {rec:.4f} < "
                                 f"{RECALL_FLOOR}")
        idle_share(lambda: _serve(idx, queries[:batch], preset, k, eps,
                                  batch),
                   secs * 1e3 * batch / len(queries),
                   f"{tag} {name} one batch of {batch}")
        out[name] = dict(ids=ids, recall=rec, qps=len(queries) / secs,
                         hops=float(hops.mean()), evals=float(evals.mean()))
    return out


@contextlib.contextmanager
def timed_pq_fit(secs: list):
    """Append the seconds of every host ``pq.fit`` run inside to ``secs``."""
    from repro_torch.quant import pq

    fit = pq.fit

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fit(*args, **kwargs)
        finally:
            secs.append(time.perf_counter() - t0)

    pq.fit = timed
    try:
        yield
    finally:
        pq.fit = fit


def expected_store_bytes(n: int, m: int) -> dict:
    """``memory_stats()``'s byte counts written out: rows at 4, 2 and 1
    bytes a dimension, sq8's (m,) float32 scale, pq's m/8 code bytes a
    row (8-dim subspaces when 8 divides m) and its 256 * m floats of
    codebook."""
    assert m % 8 == 0
    want = {"float32": n * m * 4, "fp16": n * m * 2, "sq8": n * m + m * 4,
            "pq": n * (m // 8) + 256 * m * 4}
    if (n, m) == (N_AUDIO, DIM):
        assert want == AUDIO_STORE_BYTES
    return want


def held_bytes(store, n: int) -> int:
    """The bytes a store's tensors hold for its first ``n`` rows: the
    code rows plus sq8's scale or pq's codebooks, read off the tensors
    themselves, not from ``quant/codec.py::store_bytes``."""
    rows = store.data[:n]
    return sum(t.numel() * t.element_size()
               for t in (rows, store.scale, store.codebooks) if t is not None)


def check_held_bytes(store, stats: dict, n: int) -> None:
    held = held_bytes(store, n)
    if held != stats[f"{store.codec}_bytes"]:
        raise AssertionError(
            f"the {store.codec} store holds {held:,} bytes for {n} rows, "
            f"memory_stats() says {stats[f'{store.codec}_bytes']:,}")


def quant_serve_phase(idx, queries, gt, count=None, *, k=K, batch=BATCH,
                      presets=QUANT_SERVED) -> dict:
    """Phase 4b: the compressed stores on the unrefined graph.  For each
    QUANT_PRESETS entry, under the "classic" search preset: the store's
    encode seconds (pq's host fit apart), ``memory_stats()`` against the
    bytes written out and against the bytes the store's tensors hold,
    every query timed in batches (QPS, recall@k against
    the exact k-NN, hops and evals, through ``count``), and the idle share
    of one batch; then the first N_COMPARE queries under "multi-e4-fused"
    (through ``count``), which over a compressed store is the composed hop
    with the visited filter: one beam_search launch a batch over every
    store."""
    from repro_torch.configs.deg import QUANT_PRESETS, SEARCH_PRESETS
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.quant.store import as_store

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    stats = idx.memory_stats()
    want = expected_store_bytes(idx.n, idx.dim)
    got = {c: stats[f"{c}_bytes"] for c in want}
    log(f"phase4b memory_stats at n={idx.n} m={idx.dim}: " + ", ".join(
        f"{c} {b:,} bytes ({stats[f'{c}_ratio']:.2f}x)"
        for c, b in got.items()))
    if got != want:
        raise AssertionError(f"memory_stats {got} != {want}")
    check_held_bytes(as_store(idx._dev_vectors), stats, idx.n)  # exact rows
    classic = SEARCH_PRESETS["classic"]
    out = {}
    for name in presets:
        quant = QUANT_PRESETS[name]
        fit_s = []
        t0 = time.perf_counter()
        with timed_pq_fit(fit_s):
            store = idx.store_for(quant.codec)
        sync()
        enc = time.perf_counter() - t0
        log(f"phase4b store {name} ({quant.codec}): {enc:.4f} s"
            + (f", of which the host pq fit {sum(fit_s):.4f} s"
               if fit_s else "")
            + f"; its tensors hold {held_bytes(store, idx.n):,} bytes for "
            f"{idx.n} rows, data {tuple(store.data.shape)} {store.data.dtype}")
        check_held_bytes(store, stats, idx.n)
        _serve(idx, queries[:batch], classic, k, EPS, batch, quant)  # warm-up
        sync()
        t0 = time.perf_counter()
        (ids, hops, evals), _ = count_searches(
            count, f"phase4b serve {name}", _serve, idx, queries, classic, k,
            EPS, batch, quant,
            kernel=search_kernel_eligible(store, "l2", classic.hop_backend,
                                          store.data.device))
        secs = time.perf_counter() - t0
        rec = recall_at_k(ids, gt)
        eps = EPS if quant.eps is None else quant.eps
        log(f"phase4b serve {name} (classic, eps {eps}, rerank_k "
            f"{quant.rerank_k}): {len(queries)} queries in {secs:.3f} s = "
            f"{len(queries) / secs:.1f} QPS, recall@{k} {rec:.4f}, "
            f"mean hops {hops.mean():.2f}, mean evals {evals.mean():.1f}")
        if rec < RECALL_FLOOR:
            raise AssertionError(f"{name}: recall@{k} {rec:.4f} < "
                                 f"{RECALL_FLOOR}")
        idle_share(lambda: _serve(idx, queries[:batch], classic, k, EPS,
                                  batch, quant),
                   secs * 1e3 * batch / len(queries),
                   f"phase4b {name} one batch of {batch}")
        e4 = SEARCH_PRESETS["multi-e4-fused"]
        (e4_ids, _, _), _ = count_searches(
            count, f"phase4b serve {name} multi-e4-fused", _serve, idx,
            queries[:N_COMPARE], e4, k, EPS, batch, quant,
            kernel=search_kernel_eligible(store, "l2", e4.hop_backend,
                                          store.data.device))
        out[name] = dict(ids=ids, recall=rec, qps=len(queries) / secs,
                         hops=float(hops.mean()), evals=float(evals.mean()),
                         encode_s=enc, fit_s=sum(fit_s), e4_ids=e4_ids)
    return out


def explore_phase(idx, *, sessions=EXPLORE_SESSIONS, hops=EXPLORE_HOPS, k=K,
                  seed=0) -> list:
    """``sessions`` exploration sessions of ``hops`` hops with a growing
    exclude list; returns each hop's (seeds, exclude, ids)."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, idx.n, size=sessions).astype(np.int32)
    seen = [[int(v)] for v in cur]
    calls = []
    for hop in range(hops):
        width = max(len(s) for s in seen)
        excl = np.full((sessions, width), INVALID, np.int32)
        for i, s in enumerate(seen):
            excl[i, : len(s)] = s
        ids = idx.explore(cur, k=k, exclude=excl).ids.cpu().numpy()
        calls.append((cur.copy(), excl, ids))
        for i in range(sessions):
            got = [int(x) for x in ids[i] if x != INVALID]
            if not got or set(got) & set(seen[i]):
                raise AssertionError(f"exploration session {i} hop {hop}: "
                                     f"{got} repeats {seen[i]}")
            seen[i].extend(got)
            cur[i] = got[0]
    log(f"phase4 explore: {sessions} sessions x {hops} hops, "
        f"{sum(len(s) for s in seen)} distinct vertices, none repeated")
    return calls


def refine_phase(idx, queries, gt, device, count=None, *,
                 vertices=REFINE_VERTICES) -> dict:
    """Alg. 5 over ``vertices`` vertices drawn from seed 0, under the
    index's k_opt / eps_opt / i_opt; then "classic" served again on the
    refined graph against the same exact k-NN."""
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.core.invariants import check_table1
    from repro_torch.core.metrics import average_neighbor_distance
    from repro_torch.kernels.mrng_occlusion import ops as occ_ops

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    p = idx.params
    assert (p.k_opt, p.eps_opt) == (K_OPT, EPS_OPT), \
        "phase 2 checks refinement's shapes at K_OPT and EPS_OPT"
    nd0 = average_neighbor_distance(idx.builder)
    tasks0 = idx.refine_stats["edge_tasks"]
    t0 = time.perf_counter()
    improved, _ = count_searches(
        count, "phase5 refine", idx.refine, vertices, seed=0,
        kernel=search_kernel_eligible(idx._dev_vectors, "l2", "composed",
                                      device))
    sync()
    secs = time.perf_counter() - t0
    occ = occ_ops.launches
    tasks = idx.refine_stats["edge_tasks"] - tasks0
    nd1 = average_neighbor_distance(idx.builder)
    chunks = -(-vertices // CHUNK)
    log(f"phase5 refine: {vertices} vertices (k_opt={p.k_opt} eps_opt="
        f"{p.eps_opt} i_opt={p.i_opt}) in {secs:.2f} s: {tasks} edge tasks, "
        f"{improved} improved edges; average neighbor distance (Eq. 4) "
        f"{nd0:.6f} -> {nd1:.6f}; mrng_occlusion launches {occ} for "
        f"{chunks} chunks")
    expect_launches("mrng_occlusion", occ, chunks, "refine chunks")
    if improved == 0 or not nd1 < nd0:
        raise AssertionError(f"refinement improved {improved} edges, "
                             f"Eq. 4 {nd0} -> {nd1}")
    inv = check_table1(idx.builder)
    log(f"phase5 table-1 after refinement: {inv}")
    if not all(inv.values()):
        raise AssertionError(f"Table-1 invariants broken: {inv}")
    refine_chunk_phase(idx)
    return serve_phase(idx, None, queries, device, count, gt=gt,
                       presets=("classic",), tag="phase5 refined")


def refine_chunk_phase(idx) -> None:
    """One refine chunk of CHUNK vertices (drawn from seed 1), run three
    times from the same graph: with the kernels (timed), through the plain
    versions, which must leave the same adjacency and improve the same
    number of edges, and under the profiler for its idle share.  The graph
    is restored after each run, so the phase leaves it as it was."""
    from repro_torch.core.optimize import refine_sweep

    b = idx.builder
    adj, w, n = b.adjacency.copy(), b.weights.copy(), b.n
    verts = np.random.default_rng(1).integers(0, n, CHUNK)
    p = idx.params

    def chunk():
        return refine_sweep(idx, verts, i_opt=p.i_opt, k_opt=p.k_opt,
                            eps_opt=p.eps_opt, chunk=CHUNK)

    def restore():
        b.load(adj, w, n)
        b.device_graph()
        sync()

    stats = dict(idx.refine_stats)
    t0 = time.perf_counter()
    improved = chunk()
    sync()
    wall = (time.perf_counter() - t0) * 1e3
    got_adj, got_w = b.adjacency[:n].copy(), b.weights[:n].copy()
    restore()
    with plain_kernels():
        improved_plain = chunk()
    same = float((b.adjacency[:n] == got_adj).mean())
    log(f"phase6 plain vs kernels one refine chunk ({CHUNK} vertices): "
        f"{improved_plain} vs {improved} improved edges, adjacency slots "
        f"equal {same:.4%}")
    if improved_plain != improved or same < 1.0:
        raise AssertionError("the refine chunk through the plain versions "
                             "differs from the kernels'")
    np.testing.assert_allclose(b.weights[:n], got_w, rtol=1e-5)
    restore()
    idle_share(chunk, wall, f"phase5 one refine chunk ({CHUNK} vertices)")
    restore()
    idx.refine_stats = stats


def baselines_phase(base, queries, device, count=None, *, n=N_HOST,
                    n_nsw=N_NSW, n_query=N_BASELINE_QUERIES, k=K, eps=EPS,
                    batch=BATCH, n_compare=256) -> dict:
    """Phase 4c: the paper's baseline graphs over the first ``n`` rows
    (NSW: ``n_nsw``), as benchmarks/qps_recall.py sets them at degree 20.
    For each: build seconds, QPS and recall@k of ``n_query`` queries
    against the kernel's ground truth (recorded, no floor), and its first
    ``n_compare`` queries again through the plain versions (ids equal on
    AGREE_FLOOR of the slots).  The random-regular graph must hold
    Table-1."""
    import torch
    from repro_torch.configs.deg import DEG_PAPER_CONFIGS
    from repro_torch.core.baselines import (NSWIndex, build_knng,
                                            random_regular_index)
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.core.invariants import check_table1
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.core.search import search_graph

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    sub, qs = base[:n], queries[:n_query]
    gt = ground_truth(sub, qs, device, count, k=k, tag="phase4c")
    gt_nsw = ground_truth(base[:n_nsw], qs, device, count, k=k,
                          tag="phase4c nsw")
    params = DEG_PAPER_CONFIGS["audio"]
    built = {}

    kernel = search_kernel_eligible(
        torch.as_tensor(sub[:1], device=device), "l2", "composed", device)

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out, _ = count_searches(count, f"phase4c {name} build", fn, *a,
                                kernel=kernel, **kw)
        sync()
        built[name] = time.perf_counter() - t0
        return out

    kg = timed("kgraph", build_knng, sub, K=KNNG_K, iterations=KNNG_ITERS,
               device=device)
    rr = timed("random-regular", random_regular_index, sub, params, seed=0,
               device=device)
    nsw = NSWIndex(sub.shape[1], f=NSW_F, max_degree=NSW_MAX_DEGREE,
                   k_search=NSW_K_SEARCH, eps=NSW_EPS, capacity=n_nsw,
                   device=device)
    timed("nsw", nsw.add, base[:n_nsw])
    inv = check_table1(rr.builder)
    log(f"phase4c random-regular graph (n={rr.n}, degree {params.degree}) "
        f"table-1: {inv}")
    if not all(inv.values()):
        raise AssertionError(f"random-regular graph breaks Table-1: {inv}")
    kg_vecs = torch.as_tensor(sub, device=device)
    searches = {
        "kgraph": (lambda q: search_graph(
            kg, kg_vecs, torch.as_tensor(q, device=device), k=k, eps=eps,
            seed=0), gt, f"n={n} K={KNNG_K} iterations={KNNG_ITERS}"),
        "random-regular": (lambda q: rr.search_batch(q, k=k, eps=eps), gt,
                           f"n={n} degree={params.degree}"),
        "nsw": (lambda q: nsw.search(q, k=k, eps=eps), gt_nsw,
                f"n={n_nsw} f={NSW_F} max_degree={NSW_MAX_DEGREE} "
                f"k_search={NSW_K_SEARCH} eps={NSW_EPS}"),
    }
    out = {}
    for name, (search, truth, what) in searches.items():
        _batches(search, qs[:batch], batch)                     # warm-up
        sync()
        t0 = time.perf_counter()
        (ids, hops, evals), _ = count_searches(
            count, f"phase4c {name} serve", _batches, search, qs, batch,
            kernel=kernel)
        secs = time.perf_counter() - t0
        rec = recall_at_k(ids, truth)
        log(f"phase4c {name} ({what}): built in {built[name]:.2f} s; "
            f"{len(qs)} queries (k={k}, eps={eps}) in {secs:.3f} s = "
            f"{len(qs) / secs:.1f} QPS, recall@{k} {rec:.4f}, mean hops "
            f"{hops.mean():.2f}, mean evals {evals.mean():.1f}")
        with plain_kernels():
            plain, _, _ = _batches(search, qs[:n_compare], batch)
        _agree(f"{name}, {n_compare} queries", plain, ids[:n_compare])
        out[name] = dict(build_s=built[name], qps=len(qs) / secs,
                         recall=rec, hops=float(hops.mean()),
                         evals=float(evals.mean()))
    return out


def delete_phase(idx, queries, device, count=None, *,
                 n_delete=N_DELETE) -> dict:
    """Phase 7: ``idx.remove`` of ``n_delete`` distinct vertices drawn from
    seed 0; every one must go, ``n`` shrinks by as many and Table-1
    holds.  Then the ground truth over the remaining rows and "classic"
    served again: recall@10 >= RECALL_FLOOR, and no returned id names a
    row equal to a deleted vector."""
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.core.invariants import check_table1

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    n0 = idx.n
    ids = np.random.default_rng(0).choice(n0, size=n_delete, replace=False)
    gone = {row.tobytes() for row in idx.vectors[ids]}
    t0 = time.perf_counter()
    done, _ = count_searches(
        count, "phase7 delete", idx.remove, ids,
        kernel=search_kernel_eligible(idx._dev_vectors, "l2", "composed",
                                      device))
    sync()
    secs = time.perf_counter() - t0
    log(f"phase7 delete: {done} of {n_delete} vertices in {secs:.2f} s = "
        f"{secs / n_delete * 1e3:.3f} ms per deletion; n {n0} -> {idx.n}")
    if done != n_delete or idx.n != n0 - n_delete:
        raise AssertionError(f"removed {done} of {n_delete} vertices, n "
                             f"{n0} -> {idx.n}")
    inv = check_table1(idx.builder)
    log(f"phase7 table-1 after deletion: {inv}")
    if not all(inv.values()):
        raise AssertionError(f"Table-1 invariants broken: {inv}")
    gt = ground_truth(idx.vectors[: idx.n], queries, device, count,
                      tag="phase7")
    out = serve_phase(idx, None, queries, device, count, gt=gt,
                      presets=("classic",), tag="phase7 after deletion")
    found = out["classic"]["ids"]
    rows = idx.vectors[found[found >= 0]]
    hits = sum(row.tobytes() in gone for row in rows)
    log(f"phase7 {rows.shape[0]} returned ids, {hits} of them a deleted "
        "vector")
    if hits:
        raise AssertionError(f"{hits} returned ids name deleted vectors")
    return out


def compare_extend_phase(device, n=N_HOST) -> float:
    """A device-extend build of ``n`` vertices with the kernels and with
    the plain versions: the share of vertices with equal neighbor sets."""
    from repro_torch.configs.deg import DEG_PAPER_CONFIGS
    from repro_torch.core.build import build_deg
    from repro_torch.data.synthetic import make_dataset

    base, _ = make_dataset("manifold", n, 16, DIM, seed=0)
    params = DEG_PAPER_CONFIGS["audio"]
    got = build_deg(base, params, wave_size=WAVE, device=device).builder
    with plain_kernels():
        want = build_deg(base, params, wave_size=WAVE, device=device).builder
    same = np.mean([set(got.neighbors(v).tolist())
                    == set(want.neighbors(v).tolist()) for v in range(n)])
    slots = float((got.adjacency[:n] == want.adjacency[:n]).mean())
    log(f"phase6 plain vs kernels device-extend build (n={n}): neighbor "
        f"sets equal for {same:.4%} of vertices, adjacency slots equal "
        f"{slots:.4%}")
    if same < AGREE_FLOOR:
        raise AssertionError(f"device-extend build: the plain versions "
                             f"agree on only {same:.4f} of vertices")
    return float(same)


def _agree(what: str, ids: np.ndarray, want: np.ndarray) -> float:
    agree = float((ids == want).mean())
    log(f"phase6 plain vs kernels {what}: ids equal on {agree:.4%} of "
        f"{ids.size} slots")
    if agree < AGREE_FLOOR:
        raise AssertionError(f"{what}: the plain versions agree on only "
                             f"{agree:.4f} of ids")
    return agree


def compare_quant_phase(idx, queries, gt, quant_served, *, k=K, batch=BATCH,
                        search_presets=("classic", "multi-e4-fused")):
    """Each compressed store's first N_COMPARE queries under each
    search preset with the kernels and through the plain versions: ids
    equal on AGREE_FLOOR of the slots, recall within RECALL_GAP.  Both
    kernel runs are phase 4b's."""
    from repro_torch.configs.deg import QUANT_PRESETS, SEARCH_PRESETS
    from repro_torch.core.metrics import recall_at_k

    gt_ids = gt[:N_COMPARE]
    qs = queries[:N_COMPARE]
    for name, res in quant_served.items():
        quant = QUANT_PRESETS[name]
        for sp in search_presets:
            preset = SEARCH_PRESETS[sp]
            kern = res["ids" if sp == "classic" else "e4_ids"][:N_COMPARE]
            with plain_kernels():
                ids, _, _ = _serve(idx, qs, preset, k, EPS, batch, quant)
            _agree(f"{name} {sp}, {len(qs)} queries", ids, kern)
            r_plain, r_kern = recall_at_k(ids, gt_ids), recall_at_k(kern,
                                                                    gt_ids)
            log(f"  recall@{k} {r_plain:.4f} plain vs {r_kern:.4f} kernels")
            if abs(r_plain - r_kern) > RECALL_GAP:
                raise AssertionError(f"{name} {sp}: recall {r_plain:.4f} "
                                     f"plain vs {r_kern:.4f} kernels")


def compare_plain_phase(idx, queries, served, wave_ids, explore_calls, *,
                        k=K, eps=EPS, batch=BATCH, n_compare=N_COMPARE):
    """The main path again through the plain versions on the card: the
    first ``n_compare`` queries of each preset, one insert wave's search,
    and every exploration hop.  Ids must agree on AGREE_FLOOR of the
    slots (a distance one ulp apart may swap a near tie) and serving
    recall within RECALL_GAP."""
    from repro_torch.configs.deg import SEARCH_PRESETS
    from repro_torch.core.metrics import recall_at_k

    gt_ids = served["gt"][:n_compare]
    for name, res in served.items():
        if name == "gt":
            continue
        with plain_kernels():
            ids, _, _ = _serve(idx, queries[:n_compare], SEARCH_PRESETS[name],
                               k, eps, batch)
        _agree(f"{name}, {n_compare} queries", ids, res["ids"][:n_compare])
        r_plain = recall_at_k(ids, gt_ids)
        r_kern = recall_at_k(res["ids"][:n_compare], gt_ids)
        log(f"  recall@{k} {r_plain:.4f} plain vs {r_kern:.4f} kernels")
        if abs(r_plain - r_kern) > RECALL_GAP:
            raise AssertionError(f"{name}: recall {r_plain:.4f} plain vs "
                                 f"{r_kern:.4f} kernels")
    with plain_kernels():
        ids = wave_search(idx, queries[:WAVE])
    _agree(f"one insert wave's search ({WAVE} lanes, k={idx.params.k_ext})",
           ids, wave_ids)
    with plain_kernels():
        got = [idx.explore(cur, k=k, exclude=excl).ids.cpu().numpy()
               for cur, excl, _ in explore_calls]
    _agree(f"{len(explore_calls)} exploration hops",
           np.concatenate(got), np.concatenate([c[2] for c in explore_calls]))


# ---------------------------------------------------------------------------
# phase 9: persistence and the serving engine
# ---------------------------------------------------------------------------
def serve_tensors(idx, queries, name, *, k=K, batch=BATCH) -> dict:
    """Every field of the search results of ``queries`` in batches under
    the "classic" preset: the exact store for "classic", else the
    QUANT_PRESETS entry ``name`` (its codec, rerank width and eps).  Each
    field is the batches' tensors concatenated, on the index's device."""
    import torch
    from repro_torch.configs.deg import QUANT_PRESETS

    quant = None if name == "classic" else QUANT_PRESETS[name]
    kw = {} if quant is None else dict(quantized=quant.codec,
                                       rerank_k=quant.rerank_k or None)
    eps = EPS if quant is None or quant.eps is None else quant.eps
    parts = [idx.search_batch(queries[lo : lo + batch], k=k, eps=eps, **kw)
             for lo in range(0, len(queries), batch)]
    return {f: torch.cat([getattr(r, f) for r in parts])
            for f in ("ids", "dists", "hops", "evals")}


def snapshot_sections(path) -> dict:
    """Section -> (bytes the arrays hold, bytes they take in the file),
    from the archive's own directory (nothing decompressed)."""
    import zipfile

    out: dict = {}
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            sec = info.filename.split("/")[0]
            raw, packed = out.get(sec, (0, 0))
            out[sec] = (raw + info.file_size, packed + info.compress_size)
    return out


def check_restored(live, loaded) -> list:
    """The restored index's host rows, device tensors and every store's
    tensors ``torch.equal`` to the live index's; returns what was held."""
    import torch

    n = live.n
    if loaded.n != n or sorted(loaded._stores) != sorted(live._stores):
        raise AssertionError(f"restored n={loaded.n} stores "
                             f"{sorted(loaded._stores)}, live n={n} stores "
                             f"{sorted(live._stores)}")
    g, h = live.frozen(), loaded.frozen()
    pairs = {"adjacency": (g.adjacency[:n], h.adjacency[:n]),
             "weights": (g.weights[:n], h.weights[:n]),
             "vectors": (live._dev_vectors[:n], loaded._dev_vectors[:n])}
    for codec, s in live._stores.items():
        t = loaded._stores[codec]
        pairs[f"{codec} codes"] = (s.data[:n], t.data[:n])
        for part in ("scale", "codebooks"):
            if getattr(s, part) is not None:
                pairs[f"{codec} {part}"] = (getattr(s, part),
                                            getattr(t, part))
    for what, (a, b) in pairs.items():
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"restored {what} differs from the live "
                                 "index's")
    if not (np.array_equal(live.builder.adjacency[:n],
                           loaded.builder.adjacency[:n])
            and np.array_equal(live.vectors[:n], loaded.vectors[:n])):
        raise AssertionError("restored host rows differ")
    if live._rng.bit_generator.state != loaded._rng.bit_generator.state:
        raise AssertionError("restored RNG stream differs")
    return list(pairs)


def snapshot_phase(idx, queries, results: dict, path, device, count=None, *,
                   batch=BATCH, pq_fit_s=None, names=SNAPSHOT_SERVED):
    """Phase 9a: ``idx.save(path)`` and ``DEGIndex.load(path)`` on
    ``device`` (seconds, the file's bytes and its sections); the restored
    index's tensors ``torch.equal`` to ``idx``'s; then each of ``names``
    served from the restored index (through ``count``, one
    ``beam_search`` launch a ``range_search`` call where the kernel takes
    it) ``torch.equal`` in ids, dists, hops and evals to the live index
    on the same queries, and in ids to ``results[name]`` (phases 4 and
    4b).  Returns the restored index and the save and load numbers."""
    import torch
    from repro_torch.configs.deg import QUANT_PRESETS
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.core.build import DEGIndex

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    t0 = time.perf_counter()
    count(idx.save, path)
    save_s = time.perf_counter() - t0
    secs = snapshot_sections(path)
    log(f"phase9 save: n={idx.n} in {save_s:.3f} s, {os.path.getsize(path):,}"
        " bytes on disk; sections (array bytes / compressed): " + ", ".join(
            f"{s} {raw:,} / {packed:,}" for s, (raw, packed) in secs.items()))
    t0 = time.perf_counter()
    loaded = count(DEGIndex.load, path, device=device)
    sync()
    load_s = time.perf_counter() - t0
    log(f"phase9 load on {device}: {load_s:.3f} s"
        + ("" if pq_fit_s is None else
           f" (the pq store's host fit it skips: {pq_fit_s:.2f} s)"))
    held = check_restored(idx, loaded)
    log(f"phase9 restored index torch.equal to the live one: "
        f"{', '.join(held)}; RNG stream equal")
    for name in names:
        want = serve_tensors(idx, queries, name, batch=batch)
        store = (loaded._dev_vectors if name == "classic" else
                 loaded.store_for(QUANT_PRESETS[name].codec))
        got, n_calls = count_searches(
            count, f"phase9 restored serve {name}", serve_tensors, loaded,
            queries, name, batch=batch,
            kernel=search_kernel_eligible(store, "l2", "composed", device))
        if n_calls != -(-len(queries) // batch):
            raise AssertionError(f"{n_calls} range_search calls for "
                                 f"{len(queries)} queries")
        for f, t in got.items():
            if not torch.equal(t, want[f]):
                raise AssertionError(f"restored {name} {f} differ from the "
                                     "live index's")
        if not np.array_equal(got["ids"].cpu().numpy(), results[name]):
            raise AssertionError(f"restored {name} ids differ from the "
                                 "earlier phase's")
        log(f"phase9 restored serve {name}: {len(queries)} queries, ids, "
            "dists, hops and evals torch.equal to the live index's, ids to "
            "the earlier phase's")
    return loaded, dict(save_s=save_s, load_s=load_s,
                        bytes=os.path.getsize(path), sections=secs)


def flush_latencies(engine) -> dict:
    """Bucket -> (flushes, p50 ms, p99 ms) of the engine's
    ``serving_flush_latency_ms`` histograms."""
    return {int(dict(m.labels)["bucket"]): (m.count, m.percentile(50.0),
                                            m.percentile(99.0))
            for m in engine.metrics.metrics()
            if m.name == "serving_flush_latency_ms"}


def engine_phase(path, queries, results: dict, gt, device, count=None, *,
                 k=K, batch=BATCH, bursts=BURSTS, sessions=ENGINE_SESSIONS,
                 steps=ENGINE_STEPS, n_insert=N_INSERT):
    """Phase 9b: ``QueryEngine.from_snapshot(path)`` under "classic" at
    ``max_batch=batch``: ``warmup()`` seconds per bucket; every query
    through ``engine.search`` (through ``count``: one ``beam_search``
    launch a flush), ids equal to ``results["classic"]`` on every slot and
    the same recall; flush p50/p99 per bucket, QPS and the idle share of
    one full flush; bursts of ``bursts`` queries equal to their rows; an
    sq8 engine at sq8-serving's rerank width equal to
    ``results["sq8-serving"]``; ``sessions`` exploration sessions of
    ``steps`` steps (no repeats, no seed in its own results); then on the
    restored copy ``engine.insert`` of ``n_insert`` held-out queries: on
    the next flush each is its own nearest when searched from its first
    neighbor, and the share found from the medoid is logged beside the
    share of ``batch`` indexed rows found so before the insert (an
    approximate search from the medoid misses some of either); then one
    ``engine.delete``."""
    from repro_torch.configs.deg import QUANT_PRESETS
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.core.invariants import check_table1
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.serving import QueryEngine

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    t0 = time.perf_counter()
    engine = count(QueryEngine.from_snapshot, path, device=device, k=k,
                   eps=EPS, max_batch=batch, preset="classic")
    idx = engine.index
    log(f"phase9 engine from_snapshot: {time.perf_counter() - t0:.3f} s, "
        f"buckets {engine.buckets}")
    kernel = search_kernel_eligible(idx._dev_vectors, "l2", "composed",
                                    device)
    warm = count(engine.warmup)
    log("phase9 engine warmup: " + ", ".join(
        f"{b} {s:.4f} s" for (b, _), s in sorted(warm.items())))
    t0 = time.perf_counter()
    (ids, _), n_calls = count_searches(count, "phase9 engine search",
                                       engine.search, queries, kernel=kernel)
    secs = time.perf_counter() - t0
    flushes = -(-len(queries) // batch)
    if n_calls != flushes or engine.stats.flushes != flushes:
        raise AssertionError(f"{n_calls} range_search calls, "
                             f"{engine.stats.flushes} flushes for "
                             f"{len(queries)} queries at max_batch {batch}")
    if not np.array_equal(ids, results["classic"]):
        raise AssertionError("the engine's ids differ from phase 4's")
    rec = recall_at_k(ids, gt)
    lat, qps = flush_latencies(engine), engine.stats.qps
    log(f"phase9 engine search: {len(queries)} queries in {flushes} flushes "
        f"({secs:.3f} s wall, {qps:.1f} QPS over the flushes), "
        f"ids equal to phase 4's on every slot, recall@{k} {rec:.4f}; "
        "flush ms by bucket (flushes, p50, p99): " + "; ".join(
            f"{b}: {c}, {p50:.3f}, {p99:.3f}" for b, (c, p50, p99)
            in sorted(lat.items())))
    t0 = time.perf_counter()
    engine.search(queries[:batch])
    wall = (time.perf_counter() - t0) * 1e3
    idle_share(lambda: engine.search(queries[:batch]), wall,
               f"phase9 one engine flush of {batch}")
    lo = 0
    for n in bursts:
        (got, _), n_calls = count_searches(
            count, f"phase9 burst of {n}", engine.search,
            queries[lo : lo + n], kernel=kernel)
        if n_calls != 1 or not np.array_equal(got,
                                              results["classic"][lo : lo + n]):
            raise AssertionError(f"a burst of {n}: {n_calls} flushes, ids "
                                 "differ from their rows of the full flushes")
        lo += n
    log(f"phase9 bursts of {', '.join(map(str, bursts))}: each one flush, "
        "ids equal to their rows of the full flushes")
    sq8 = QUANT_PRESETS["sq8-serving"]
    q8 = QueryEngine(idx, k=k, eps=EPS if sq8.eps is None else sq8.eps,
                     max_batch=batch, preset="classic", codec=sq8.codec,
                     rerank_k=sq8.rerank_k)
    (ids8, _), _ = count_searches(
        count, "phase9 sq8 engine search", q8.search, queries,
        kernel=search_kernel_eligible(idx.store_for("sq8"), "l2",
                                      "composed", device))
    if not np.array_equal(ids8, results["sq8-serving"]):
        raise AssertionError("the sq8 engine's ids differ from phase 4b's")
    log(f"phase9 sq8 engine: {len(queries)} queries in "
        f"{q8.stats.flushes} flushes, ids equal to phase 4b's sq8-serving")
    count_searches(count, "phase9 engine sessions", engine_sessions, engine,
                   sessions=sessions, steps=steps, kernel=kernel)
    n0 = idx.n
    probe = np.random.default_rng(1).choice(n0, size=batch, replace=False)
    (got, _), _ = count_searches(count, "phase9 search indexed rows",
                                 engine.search, idx.vectors[probe],
                                 kernel=kernel)
    self_hit = float((got[:, 0] == probe).mean())
    pts = queries[-n_insert:]
    new = n0 + np.arange(n_insert)
    count_searches(count, f"phase9 engine insert of {n_insert}",
                   engine.insert, pts, kernel=kernel)
    (got, _), _ = count_searches(count, "phase9 search the inserted",
                                 engine.search, pts, kernel=kernel)
    found = int((got[:, 0] == new).sum())
    # the new rows are wired in: a search seeded at a new vertex's first
    # neighbor reaches it in one hop, so the next flush returns it first
    seeds = [int(idx.builder.neighbors(v)[0]) for v in new]
    futs, _ = count_searches(count, "phase9 search the inserted from a "
                             "neighbor", engine_seeded, engine, pts, seeds,
                             kernel=kernel)
    reached = int(sum(int(f["ids"][0]) == v for f, v in zip(futs, new)))
    degrees = {idx.builder.vertex_degree(v) for v in new}
    log(f"phase9 engine insert: n {n0} -> {idx.n}; on the next flush "
        f"{found} of {n_insert} inserted points their own nearest from the "
        f"medoid (the restored index finds {self_hit:.4f} of {batch} indexed "
        f"rows so), {reached} from their first neighbor; degrees {degrees}")
    if (idx.n != n0 + n_insert or reached != n_insert
            or degrees != {idx.params.degree}):
        raise AssertionError(f"inserted: n {idx.n}, {reached} of {n_insert} "
                             f"reached from a neighbor, degrees {degrees}")
    ok, _ = count_searches(count, "phase9 engine delete", engine.delete,
                           n0 // 2, kernel=kernel)
    inv = check_table1(idx.builder)
    if not ok or idx.n != n0 + n_insert - 1 or not all(inv.values()):
        raise AssertionError(f"engine.delete: {ok}, n {idx.n}, {inv}")
    log(f"phase9 engine delete of vertex {n0 // 2}: n {idx.n}, Table-1 "
        "holds")
    return engine, dict(warmup=warm, latency=lat, qps=qps, recall=rec,
                        flush_wall_ms=wall, inserted_found=found,
                        self_hit=self_hit)


def engine_seeded(engine, queries, seeds) -> list:
    """One flush of ``queries``, each searched from its own seed vertex
    (a seeded request outside a session: the seed is not hidden)."""
    futs = [engine.submit(q, seed_vertex=s) for q, s in zip(queries, seeds)]
    engine.flush()
    return futs


def engine_sessions(engine, *, sessions=ENGINE_SESSIONS, steps=ENGINE_STEPS,
                    seed=0) -> int:
    """``sessions`` exploration sessions of ``steps`` steps through
    ``engine.explore``, one flush a step: no session sees a vertex twice,
    and no seed in its own results.  Returns the vertices seen."""
    rng = np.random.default_rng(seed)
    cur = [int(v) for v in rng.integers(0, engine.index.n, size=sessions)]
    seen = [set() for _ in range(sessions)]
    for step in range(steps):
        futs = [engine.explore(v, session=f"s{i}")
                for i, v in enumerate(cur)]
        engine.flush()
        for i, fut in enumerate(futs):
            got = [int(x) for x in fut["ids"] if x != INVALID]
            if not got or cur[i] in got or set(got) & seen[i]:
                raise AssertionError(f"engine session {i} step {step}: "
                                     f"{got} repeats {sorted(seen[i])} or "
                                     f"its seed {cur[i]}")
            seen[i].update(got)
            seen[i].add(cur[i])
            cur[i] = got[0]
    total = sum(len(s) for s in seen)
    log(f"phase9 engine explore: {sessions} sessions x {steps} steps, "
        f"{total} distinct vertices, none repeated, no seed returned")
    return total


def wal_phase(base, device, tmp, count=None, *, n=N_HOST, n_snap=WAL_SNAP,
              n_remove=WAL_REMOVE, n_refine=WAL_REFINE) -> dict:
    """Phase 9c, on the first ``n`` rows of ``base`` at the audio config
    in waves of WAVE: build ``n_snap`` rows with the WAL on and snapshot;
    add the rest, remove ``n_remove`` vertices and refine ``n_refine``;
    ``recover(snapshot, wal)`` equal to the live index (adjacency,
    weights, vectors, RNG stream, WAL cursor).  Then a build of ``n`` rows
    with ``enable_checkpoints(every_waves=CKPT_EVERY)``, resumed from its
    last checkpoint, equal to the uninterrupted build.  Every step timed
    and counted."""
    from repro_torch.configs.deg import DEG_PAPER_CONFIGS
    from repro_torch.core.build import DEGIndex
    from repro_torch.persist import recover

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    params = DEG_PAPER_CONFIGS["audio"]
    rows = np.ascontiguousarray(base[:n])
    wal, snap = os.path.join(tmp, "wal.log"), os.path.join(tmp, "wal.npz")
    secs = {}

    def step(what, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = count(fn, *args, **kwargs)
        sync()
        secs[what] = time.perf_counter() - t0
        return out

    live = DEGIndex(rows.shape[1], params, capacity=n, device=device)
    live.enable_wal(wal)
    step("build", live.add, rows[:n_snap], wave_size=WAVE)
    step("save", live.save, snap)
    step("add", live.add, rows[n_snap:], wave_size=WAVE)
    victims = np.random.default_rng(0).choice(live.n, size=n_remove,
                                              replace=False)
    step("remove", live.remove, victims)
    step("refine", live.refine, n_refine)
    rec = step("recover", recover, snap, wal, device=device)
    compare_indexes("recovered", live, rec)
    log(f"phase9 WAL: {n_snap} rows journaled and snapshotted, then "
        f"{n - n_snap} added in waves of {WAVE}, {n_remove} removed, "
        f"{n_refine} refined ({live._wal_seq} records); recover() equal to "
        "the live index in adjacency, weights, vectors, RNG stream and "
        "cursor; seconds: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in secs.items()))
    ck = os.path.join(tmp, "ck_{waves}.npz")
    whole = DEGIndex(rows.shape[1], params, capacity=n, device=device)
    whole.enable_checkpoints(ck, every_waves=CKPT_EVERY)
    step("checkpointed build", whole.add, rows, wave_size=WAVE)
    waves = max(int(f[3:-4]) for f in os.listdir(tmp) if f.startswith("ck_"))
    resumed = step("load checkpoint", DEGIndex.load,
                   ck.format(waves=waves), device=device)
    n_ck = resumed.n
    step("resume", resumed.add, rows[n_ck:], wave_size=WAVE)
    compare_indexes("resumed", whole, resumed)
    log(f"phase9 checkpoints every {CKPT_EVERY} waves: resumed from wave "
        f"{waves} (n={n_ck}), the resumed build equal to the uninterrupted "
        "one; seconds: " + ", ".join(
            f"{k} {secs[k]:.3f}" for k in ("checkpointed build",
                                           "load checkpoint", "resume")))
    return secs


def compare_indexes(what: str, want, got) -> None:
    """Adjacency, weights and vectors equal on the host, and the RNG
    stream and WAL cursor."""
    n = want.n
    same = (got.n == n
            and np.array_equal(got.builder.adjacency[:n],
                               want.builder.adjacency[:n])
            and np.array_equal(got.builder.weights[:n],
                               want.builder.weights[:n])
            and np.array_equal(got.vectors[:n], want.vectors[:n]))
    if not same:
        raise AssertionError(f"the {what} index's rows differ")
    if (got._rng.bit_generator.state != want._rng.bit_generator.state
            or got._wal_seq != want._wal_seq):
        raise AssertionError(f"the {what} index's RNG stream or WAL cursor "
                             "differs")


def served_ids(served, quant_served) -> dict:
    """Phase 4's "classic" ids and phase 4b's ids of each store, by name."""
    return {"classic": served["classic"]["ids"],
            **{name: r["ids"] for name, r in quant_served.items()}}


def persist_serve_phase(idx, base, queries, served, quant_served, device,
                        count=None) -> dict:
    """Phase 9: 9a, 9b and 9c in a temporary directory (removed after)."""
    import tempfile

    results = served_ids(served, quant_served)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "audio.npz")
        _, snap = snapshot_phase(idx, queries, results, path, device, count,
                                 pq_fit_s=quant_served["pq-serving"]["fit_s"])
        _, eng = engine_phase(path, queries, results, served["gt"], device,
                              count)
        wal_dir = os.path.join(tmp, "wal")
        os.mkdir(wal_dir)
        wal = wal_phase(base, device, wal_dir, count)
    return dict(snapshot=snap, engine=eng, wal=wal)


# ---------------------------------------------------------------------------
# phase 8: recsys serving (DIN and DCN-v2) and the bag_lookup kernel
# ---------------------------------------------------------------------------
def peak_memory(reset: bool = False) -> int | None:
    """The card's peak allocated bytes since the last reset (``reset``
    starts a new window and returns None)."""
    import torch

    if reset:
        torch.cuda.reset_peak_memory_stats()
        return None
    return torch.cuda.max_memory_allocated()


def recsys_setup(device, *, reduced=False, p99=None, bulk=None,
                 n_candidates=None, n_batches=RECSYS_BATCHES) -> dict:
    """Per model of RECSYS_ARCHS: its config (the published one, or
    ``reduced()``), host batches from CriteoLikeStream(seed=0) on the
    card, and a RecsysModel from init_params with a torch.Generator seeded
    0, its init seconds and bytes.  Batch sizes and the candidate count
    default to the RECSYS_SHAPES cells."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import CriteoLikeStream
    from repro_torch.models import recsys as R

    out = {}
    for name in RECSYS_ARCHS:
        spec = get_arch(name)
        cfg = spec.reduced() if reduced else spec.model
        b99 = p99 or spec.cell("serve_p99")["batch"]
        stream = CriteoLikeStream(cfg, seed=0)
        t0 = time.perf_counter()
        batches = [R.as_tensors(stream.batch(s, b99), device)
                   for s in range(n_batches)]
        rec = {"cfg": cfg, "p99": batches,
               "query": R.as_tensors(stream.batch(
                   n_batches, spec.cell("retrieval_cand")["batch"]), device),
               "n_candidates": (n_candidates
                                or spec.cell("retrieval_cand")["n_candidates"])}
        if name == "din":
            rec["bulk"] = R.as_tensors(stream.batch(
                n_batches + 1, bulk or spec.cell("serve_bulk")["batch"]),
                device)
        data_s = time.perf_counter() - t0
        gen = torch.Generator(device=device).manual_seed(0)
        t0 = time.perf_counter()
        rec["model"] = R.init_params(cfg, gen, device)
        sync()
        rec["init_s"] = time.perf_counter() - t0
        rec["bytes"] = sum(p.numel() * p.element_size()
                           for p in rec["model"].parameters())
        log(f"phase8 {name}: {cfg.total_rows:,} table rows x {cfg.embed_dim}, "
            f"parameters {rec['bytes']:,} bytes initialised in "
            f"{rec['init_s']:.3f} s; {n_batches} batches of {b99} and the "
            f"queries made in {data_s:.2f} s")
        out[name] = rec
    return out


def check_bag_lookup(table, ids, weights, shape: str) -> dict:
    """The kernel against its plain version and F.embedding_bag (mode
    "sum" over the clipped ids and masked weights, timed as the library
    call) on one main-path input.  The bound counts ids, weights, each
    distinct row a valid id names and the output once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.bag_lookup import ops

    V, E = table.shape
    B, nf = ids.shape
    got = ops.bag_lookup(table, ids, weights)
    want = ops.bag_lookup(table, ids, weights, impl="ref")
    torch.testing.assert_close(got, want, rtol=BAG_RTOL, atol=BAG_ATOL)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    valid = ids >= 0
    safe = ids.clamp(0, V - 1)
    w = torch.ones_like(ids, dtype=torch.float32) if weights is None \
        else weights
    w = None if weights is None and bool(valid.all()) else \
        torch.where(valid, w, 0.0)
    lib = F.embedding_bag(safe, table, mode="sum", per_sample_weights=w)
    torch.testing.assert_close(lib, want, rtol=BAG_RTOL, atol=BAG_ATOL)
    t = time_call(lambda: ops.bag_lookup(table, ids, weights),
                  "bag_lookup")
    tp = time_call(lambda: ops.bag_lookup(table, ids, weights, impl="ref"))
    tl = time_call(lambda: F.embedding_bag(safe, table, mode="sum",
                                           per_sample_weights=w))
    rows = torch.unique(safe[valid]).numel()
    n_valid = int(valid.sum())
    nb = (ids.numel() * 4 + (0 if weights is None else weights.numel() * 4)
          + rows * E * 4 + B * E * 4)
    bms, by = bound_ms(nb, 2 * n_valid * E)
    return dict(name="bag_lookup", max_abs_err=err, t=t, tp=tp, tl=tl,
                bound_ms=bms, bound_by=by,
                shape=f"{shape}: B={B} F={nf} E={E} V={V}, {n_valid} valid "
                      f"ids, {rows} rows",
                tol=f"rtol {BAG_RTOL:g} atol {BAG_ATOL:g}")


def bag_checks(rec: dict, device, seed=0) -> list:
    """bag_lookup at the shapes phase 8's main path gives it: DIN's
    interest pooling at serve_p99 and serve_bulk (history ids with their
    -1 tails, weights in [0, 1)), DCN-v2's user_embedding at
    retrieval_cand and serve_p99 (no weights, over its whole table), and
    a ragged case (B=37, F=5, E=7, ids < 0 and >= V)."""
    import torch
    from repro_torch.models import recsys as R

    rng = np.random.default_rng(seed)
    din, dcn = rec["din"], rec["dcn-v2"]

    def weights_for(ids):
        return torch.tensor(rng.random(tuple(ids.shape), dtype=np.float32),
                            device=device)

    rows = []
    for what, b in (("DIN interest serve_p99", din["p99"][0]),
                    ("DIN interest serve_bulk", din["bulk"])):
        ids = R.history_ids(din["cfg"], b["hist"])
        rows.append(check_bag_lookup(din["model"].table, ids,
                                     weights_for(ids), what))
    for what, b in (("DCN-v2 user_embedding retrieval_cand", dcn["query"]),
                    ("DCN-v2 user_embedding serve_p99", dcn["p99"][0])):
        ids = R.global_ids(dcn["cfg"], b["sparse"]).to(torch.int32)
        rows.append(check_bag_lookup(dcn["model"].table, ids, None, what))
    V = 1000
    table = torch.tensor(rng.normal(size=(V, 7)).astype(np.float32),
                         device=device)
    ids = rng.integers(0, V, size=(37, 5)).astype(np.int32)
    ids[rng.random((37, 5)) < 0.2] = INVALID
    ids[0, :3] = [V, V + 11, INVALID]
    ids = torch.tensor(ids, device=device)
    rows.append(check_bag_lookup(table, ids, weights_for(ids), "ragged"))
    for r in rows:
        log(f"phase8 bag_lookup [{r['shape']}] ok ({r['tol']}): "
            + timings(r, "F.embedding_bag"))
    return rows


def _timed(fn, *args):
    """(result, wall ms) of one call ended by a synchronise."""
    t0 = time.perf_counter()
    out = fn(*args)
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def _ms_summary(ms: list) -> str:
    return (f"median {float(np.median(ms)):.3f} ms, mean "
            f"{float(np.mean(ms)):.3f} ms, max {max(ms):.3f} ms")


def _check_finite(what: str, x) -> None:
    import torch

    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{what}: non-finite values")


def _check_retrieval(what: str, got, want, u, cands) -> float:
    """Kernel vs plain retrieval: scores at BAG_RTOL/BAG_ATOL, ids equal
    on RETRIEVAL_AGREE of the slots, and every id's own score (the plain
    user vector against its candidate row) equal to the plain score of its
    slot, so a differing id is a tie."""
    import torch

    (top, ids), (top_p, ids_p) = got, want
    torch.testing.assert_close(top, top_p, rtol=BAG_RTOL, atol=BAG_ATOL)
    own = (u[:, None, :] * cands[ids.long()]).sum(-1)
    torch.testing.assert_close(own, top_p, rtol=BAG_RTOL, atol=BAG_ATOL)
    same = float((ids == ids_p).float().mean())
    log(f"phase8 plain vs kernels {what}: ids equal on {same:.4%} of "
        f"{ids.numel()} slots, the rest ties by score")
    if same < RETRIEVAL_AGREE:
        raise AssertionError(f"{what}: ids equal on only {same:.4f}")
    return same


def retrieval_check_cost(model, q, cands, k: int, reps: int
                         ) -> tuple[float, float]:
    """Median wall ms of ``serve_retrieval`` with ``user_embedding``'s id
    bounds check (one device-to-host read) and with the check replaced by
    a no-op, as the call ran before it; the two interleaved."""
    from repro_torch.models import recsys as R

    checked, unchecked = [], []
    real = R.check_rows
    for _ in range(reps):
        checked.append(_timed(R.serve_retrieval, model, q, cands, k)[1])
        R.check_rows = lambda ids, n_rows: None
        try:
            unchecked.append(_timed(R.serve_retrieval, model, q, cands, k)[1])
        finally:
            R.check_rows = real
    return float(np.median(checked)), float(np.median(unchecked))


def recsys_phase(rec: dict, device, count=None,
                 check_reps: int = RETRIEVAL_REPS) -> dict:
    """DIN and DCN-v2 served at the widths ``rec`` holds: each model's
    serve_p99 batches (ms a batch; DIN's idle share of one), DIN's
    serve_bulk forward (s, samples/s, peak bytes), DIN's retrieval at B=1
    and at serve_p99 over its item field, and DCN-v2's retrieval_cand
    over ``n_candidates`` rows of DCN_CANDIDATE_FIELD (k = RETRIEVAL_K, or
    every candidate where there are fewer), each retrieval also timed
    ``check_reps`` times with and without the id bounds check of
    ``user_embedding``; every logit finite.
    Then the DIN batches and the three retrievals again through the plain
    versions.  Returns the numbers and the bag_lookup launches of each
    piece."""
    import torch
    from repro_torch.kernels.bag_lookup import ops as bag_ops
    from repro_torch.models import recsys as R

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name in RECSYS_ARCHS:
        r = rec[name]
        model = r["model"]
        batches = r["p99"]
        R.forward(model, batches[0])                          # warm-up
        sync()
        logits, ms = [], []
        for b in batches:
            bag_ops.launches = 0
            y, t = _timed(count, R.forward, model, b)
            # DIN pools its history through the kernel; DCN-v2 does not
            expect_launches("bag_lookup", bag_ops.launches,
                            int(name == "din"), f"{name} forward")
            logits.append(y)
            ms.append(t)
            _check_finite(f"{name} serve_p99 logits", y)
        B = batches[0]["sparse"].shape[0]
        log(f"phase8 {name} serve_p99: {len(batches)} batches of {B}, "
            f"{_ms_summary(ms)} a batch, {B * len(batches) / sum(ms) * 1e3:,.1f}"
            " samples/s")
        res = {"p99_ms": ms, "logits": logits}
        if name == "din":
            idle_share(lambda: R.forward(model, batches[0]),
                       float(np.median(ms)), "one DIN serve_p99 batch")
            bulk = r["bulk"]
            R.forward(model, bulk)                            # warm-up
            sync()
            peak_memory(reset=True)
            bag_ops.launches = 0
            y, t = _timed(count, R.forward, model, bulk)
            peak = peak_memory()
            expect_launches("bag_lookup", bag_ops.launches, 1,
                            "din serve_bulk forward")
            _check_finite("din serve_bulk logits", y)
            nb = bulk["sparse"].shape[0]
            log(f"phase8 din serve_bulk: one forward of {nb:,} in "
                f"{t / 1e3:.4f} s = {nb / t * 1e3:,.1f} samples/s, peak "
                f"memory {peak if peak is None else f'{peak:,}'} bytes")
            res.update(bulk_s=t / 1e3, bulk_samples_s=nb / t * 1e3,
                       bulk_peak_bytes=peak)
            cands = R.item_vectors(model, model.cfg.item_field)
            queries = {1: {key: v[:1] for key, v in batches[0].items()},
                       B: batches[0]}
        else:
            cands = R.item_vectors(model, DCN_CANDIDATE_FIELD,
                                   r["n_candidates"])
            queries = {1: r["query"]}
        kk = min(RETRIEVAL_K, cands.shape[0])
        res["retrieval"] = {}
        for nq, q in queries.items():
            R.serve_retrieval(model, q, cands, kk)            # warm-up
            sync()
            bag_ops.launches = 0
            got, t = _timed(count, R.serve_retrieval, model, q, cands, kk)
            expect_launches("bag_lookup", bag_ops.launches, 1,
                            f"{name} user_embedding")
            _check_finite(f"{name} retrieval scores", got[0])
            with_check, without = retrieval_check_cost(model, q, cands, kk,
                                                       check_reps)
            log(f"phase8 {name} retrieval: B={nq}, k={kk} over "
                f"{cands.shape[0]:,} candidates in {t:.3f} ms; median of "
                f"{check_reps}: {with_check:.3f} ms with the id bounds check, "
                f"{without:.3f} ms without it, a difference of "
                f"{with_check - without:.3f} ms")
            res["retrieval"][nq] = {"ms": t, "got": got, "q": q,
                                    "cands": cands, "ms_checked": with_check,
                                    "ms_unchecked": without}
        out[name] = res

    # the plain versions on the same inputs
    din = rec["din"]["model"]
    with plain_kernels():
        for i, b in enumerate(rec["din"]["p99"]):
            want = R.forward(din, b)
            torch.testing.assert_close(out["din"]["logits"][i], want,
                                       rtol=BAG_RTOL, atol=BAG_ATOL)
        log(f"phase8 plain vs kernels: {len(rec['din']['p99'])} DIN "
            f"serve_p99 batches' logits agree (rtol {BAG_RTOL:g}, atol "
            f"{BAG_ATOL:g})")
        for name in RECSYS_ARCHS:
            model = rec[name]["model"]
            for nq, res in out[name]["retrieval"].items():
                q, cands = res["q"], res["cands"]
                want = R.serve_retrieval(model, q, cands,
                                         res["got"][0].shape[1])
                res["agree"] = _check_retrieval(
                    f"{name} retrieval B={nq}", res["got"], want,
                    R.user_embedding(model, q), cands)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N_AUDIO,
                    help="base vectors to index (the paper's audio size)")
    ap.add_argument("--queries", type=int, default=N_QUERIES)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.kernels import _build

    device = "cuda"
    t_start = time.perf_counter()
    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    secs = _build.build_all()
    log(f"phase1 kernels built in {secs:.2f} s: {', '.join(_build.sources())}")
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # phase 2
    checks, host_loop = phase2(device, args.n, args.queries)

    # phases 3-5 and 7: the main path (builds, ground truths, timed
    # serving, exploration, compressed serving, the baselines, refinement,
    # deletion), each piece counted on its own;
    # measurement reruns and the plain-version comparisons (phase 6) go
    # uncounted
    ops = launch_counters()
    launches = dict.fromkeys(ops, 0)
    count = functools.partial(counted, ops, launches)
    def stamp(what):
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    stamp("phases 1-2")
    rec = recsys_setup(device)
    checks["bag_lookup"] = bag_checks(rec, device)[0]
    recsys_phase(rec, device, count)
    del rec
    torch.cuda.empty_cache()
    stamp("phase 8")
    idx, base, queries, _ = build_phase(args.n, args.queries, device, count)
    wave_ids = wave_phase(idx, queries)
    build_phase(N_HOST, 16, device, count, device_extend=False,
                tag="phase3 host-extension")
    stamp("phase 3")
    served = serve_phase(idx, base, queries, device, count)
    explore_calls, _ = count_searches(
        count, "phase4 explore", explore_phase, idx,
        kernel=search_kernel_eligible(idx._dev_vectors, "l2", "composed",
                                      device))
    stamp("phase 4")
    quant_served = quant_serve_phase(idx, queries, served["gt"], count)
    stamp("phase 4b")
    # compare on the graph that served, before refinement changes it
    compare_plain_phase(idx, queries, served, wave_ids, explore_calls)
    compare_quant_phase(idx, queries, served["gt"], quant_served)
    stamp("phase 6, serving part")
    # on the graph and stores phases 4 and 4b served, before refinement
    # changes them
    persist_serve_phase(idx, base, queries, served, quant_served, device,
                        count)
    stamp("phase 9")
    baselines_phase(base, queries, device, count)
    stamp("phase 4c")
    refine_phase(idx, queries, served["gt"], device, count)
    stamp("phase 5")
    delete_phase(idx, queries, device, count)
    stamp("phase 7")
    log(f"main-path launches: {launches}")
    check_main_path_launches(launches, host_loop)
    compare_extend_phase(device)
    stamp("phase 6, build part")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)                    # the card again, beside the run's end

    print(json.dumps({"kernels": kernel_rows(checks, launches)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
