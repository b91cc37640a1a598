#!/usr/bin/env python3
"""Drive the PyTorch port of DEG on one NVIDIA card: build its CUDA kernels,
hold each against its plain PyTorch version, build an index at the
paper's audio size, take the exact ground truth from the brute-force scan,
serve queries and exploration sessions from the index, serve from its
compressed stores (fp16, sq8, pq), save the index and serve the restored
copy through the query engine, recover a journaled index and resume a
checkpointed build, mutate the restored index while the sync and async
engines serve published epochs of it, scrub and repair injected damage,
run the serve and build_index launchers, shard the index over
torch.distributed (at world size 1, and as four ranks on the one card)
and snapshot the shards, build and serve the paper's baseline graphs,
refine
the index, delete vertices from it, and serve again; then serve the
recsys models DIN and DCN-v2 at their published widths, their embedding
bags through the bag_lookup kernel, and train both at the train_batch
cell's width, DIN's bag gradient through the bag_lookup_bwd kernel; and,
first of all, serve the LMs gemma3-12b and qwen3-moe-30b-a3b at their
published widths and hold the five reduced LMs on the card against the
CPU, then train EGNN on minibatch_lg's Reddit-sized graph and run its
forward over ogb_products' whole graph.

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
  10. (inside phase 9's temporary directory, on its snapshot) live
     mutation under serving:
     10a. the restored index: enable_publishing(), one publish() timed and
     the device bytes an epoch holds; the 10,000 queries in batches of 256
     from the epoch, ids, dists, hops and evals torch.equal to the live
     index and ids to phase 4's; the epoch held across an insert wave of
     LIVE_INSERT held-out rows, a remove of LIVE_REMOVE and a refine of
     LIVE_REFINE on the live index, its tensors and searches torch.equal
     to before; after its release one live epoch;
     10b. corrupt_adjacency(idx, LIVE_CORRUPT, seed=0) and one timed
     IntegrityScrubber.run_pass(): every corrupted row quarantined; at the
     scrubber's scrub.repair hook (quarantine published, repair not begun)
     a sync-engine flush of the 10,000 queries returns no quarantined id,
     one beam_search launch a flush; after the repair Table 1, an empty
     quarantine and classic recall@10 >= 0.90 against the exact neighbors
     of the rows now held;
     10c. a fresh restore: AsyncQueryEngine(max_batch=256, preset
     "classic"), warm-up, the 10,000 queries as single submits with no
     deadline (one beam_search launch a flush), ids equal to phase 4's on
     every slot, request p50/p99, QPS, flushes; each rung of the
     degradation ladder forced on 256 queries, ids equal to a sync flush
     under the rung's config and hop budget (the sq8 rung over the sq8
     store); LIVE_PARTIAL expired submits complete partial with hops <=
     partial_hops;
     10d. the "classic" and "sq8-serving" async engines serve rounds of
     256 queries while a writer thread runs LIVE_TICKS ticks (insert
     LIVE_INSERT held-out rows, remove LIVE_REMOVE, refine LIVE_REFINE,
     publish) and the scrubber audits; every result replayed bit for bit
     against its stamped epoch (zero torn reads), Table 1 at the end,
     epochs published and retired and the p99 retire lag;
     10e. python -m repro_torch.launch.serve --index <the snapshot>
     --engine async --warmup --refine-while-serving 4 --scrub-every 0.5
     --inject-corruption 16 as a subprocess, its resilience:, scrub: and
     invariants: lines required; launch.build_index --out at
     N_BUILD_INDEX rows, loaded back;
  11. (after phases 9 and 10, while phase 3's graph and phase 4's ground
     truth hold) the sharded DEG (distributed/, persist/sharded.py,
     launch/mesh.py) on phase 3's data:
     11a. world size 1 (NCCL, a (1, 1) mesh): build_sharded_deg(base, 1)
     at the audio config (waves of 64), its build seconds and Table 1;
     ShardedDEG.search of the 10,000 queries in batches of 256 (k=10,
     eps=0.1) after one warm-up batch, ids and dists torch.equal to
     range_search over the same sub-DEG, one beam_search launch a batch
     and none of the host-loop kernels, recall@10;
     11b. S=2 over all rows (26,694 + 26,693): both shards built on the
     card (seconds, Table 1 and graph quality, Eq. 3, per shard); the
     composed search (each shard's range_search, the stable merge) and
     its recall@10 against phase 4's ground truth; sq8 per shard; pq per
     shard on a second S=2 index of N_HOST rows (the host k-means fit at
     full size would take about as long as phase 4b's);
     11d. save_sharded / load_sharded of the sq8 S=2 index (seconds,
     bytes, every stacked tensor torch.equal); reshard-on-restore to S=1
     (a rebuild: n_total, Table 1, adjacency torch.equal to 11a's), its
     sq8 world-1 search torch.equal to 11a's index under sq8 (the S=2
     restored copy is searched by the ranks of 11c: at world size 1 the
     model axis has one rank, and the port searches only S equal to it);
     11c. four ranks on the one card (torch.multiprocessing spawn, gloo,
     the (2, 2) debug mesh, a FileStore; a rank that fails, or any rank
     still running after RANK_TIMEOUT_S, fails the run): each loads the
     stacked tensors of 11b and 11d and runs make_sharded_search over the
     10,000 queries in batches of 256 (after one warm-up batch) under
     float32, sq8 (rerank 40, sq8-serving), the restored sq8 copy and pq
     (rerank 80, eps 0.2, pq-compact), float32 after drop_shard(0), one
     exploration batch with 32 excluded ids, sharded_brute_topk (l2, over
     data x model, on the first 53,384 rows), compressed_psum and the
     sharded lookup; each reports its beam_search launches (one a local
     search) and its ms a batch in local search, merge and data gather.
     Held: every rank's output equal to every other's; float32 equal to
     11b's composed search; recall@10 >= RECALL_FLOOR; the sq8 and pq
     dists the exact float distances (rtol 1e-5); the restored copy's
     results equal to the live one's; after drop_shard(0) every id odd;
     no excluded id returned; the brute-force ids against
     exact_knn_batched under GT_AGREE / GT_RTOL; compressed_psum
     bit-identical on every rank and within its bound; every group gloo;
  12. (right after phase 8, so that a fault shows early; the card's memory
     freed after it) recsys training at the train_batch cell: DIN and
     DCN-v2 at their published widths, seeded weights (init_params, a
     torch.Generator seeded 0), the MLPerf split (SGD 0.05 on the tables,
     AdamW 1e-3 on the towers), batches of 65,536 from
     CriteoLikeStream(seed=0), each made once on the host (s a batch);
     12a. bag_lookup_bwd at DIN's train_batch shape (step 0's Zipf history
     ids with their -1 tails over DIN's table, weights in [0, 1), a normal
     dL/dout) against its plain version (grad_w at rtol 1e-5 atol 1e-6;
     grad_table there plus 1e-6 times each entry's sum of |w| |g|, since
     the Zipf head sums some 800,000 float32 terms, in another order in
     each version), a second launch torch.equal to the first; times of the
     kernel with its sort, of its kernels alone on sorted keys, of the
     sort, of the plain version and of F.embedding_bag's forward plus
     backward; the bound by analysis/roofline.py::bag_lookup_bwd_costs;
     12b. TRAIN_STEPS steps of each model: the loss curve, every loss
     finite, ms a step between CUDA events and samples/s, the host batch
     time beside it, peak bytes, the idle share of one step (on a copy),
     the model flops over the float32 peak; one bag_lookup and one
     bag_lookup_bwd launch a DIN step and none a DCN-v2 step; each of the
     first TRAIN_PLAIN_STEPS steps again through the plain versions from
     the kernel run's parameters and state before it: losses at rtol
     1e-5, parameters after it at rtol 1e-4 atol 1e-6 (two chains of
     steps part: AdamW divides a gradient near its eps by its own size);
     12c. DIN through train_loop with a checkpoint every
     TRAIN_CKPT_EVERY steps and a failure injected after step
     TRAIN_FAIL_AT; the rerun resumes from the step-5 checkpoint, and its
     final parameters and optimizer state are torch.equal to 12b's
     uninterrupted run; DCN-v2's whole train state saved and restored
     (seconds, bytes, every leaf torch.equal);
     12d. python -m repro_torch.launch.train --arch din --steps 60
     --batch 256 --fail-at 30 as a subprocess exits non-zero; its rerun
     resumes and prints a final loss below its first;
  13. (run first, right after phase 1's build, while the card holds
     nothing: each served model in a process of its own) the LM family,
     no kernel on its path, weights from init_params (a torch.Generator
     seeded 0 on the card) and seeded tokens:
     13a. gemma3-12b whole (48 layers, 46.5 GB of float32 parameters, 4 x
     param_count bytes required): init seconds and memory_allocated; one
     serve_prefill of 1 x 32,768 tokens (prefill_32k's length, its batch
     cut from 32 to 1) into a cache of 32,784 slots (s, tokens/s, the
     model flops over s x the bfloat16 peak), then 16 greedy
     serve_decode_step calls (decode_32k's context, its batch cut from 128
     to 1; ms a step by CUDA events beside the bytes bound of the float32
     parameters and the cache), every logit finite, pos at 32,784, peak
     bytes, the idle share of a step; readings by CUDA events of one
     layer's gqa_attention over the 32,768 queries and of a decode step's
     float32 -> bfloat16 weight casts; then at B=2 and 2,049 tokens (past
     the 1,024-slot ring) forward_train's logits at positions 2,047 and
     2,048 against serve_prefill of 2,048 tokens and one decode step:
     float32 at rtol 1e-3 atol 1e-3, bfloat16 no farther apart than the
     bfloat16 forward is from the float32 one (the share past 2e-2
     logged);
     13b. qwen3-moe-30b-a3b at full width, 16 of its 48 layers (40.5 GB):
     as 13a with a prefill of 4 x 4,096 (16,384 tokens a MoE layer at
     capacity 1,288) and decode at B=4; the readings add one layer's
     moe_ffn and its dispatch's one-hot cumsum; the check at 257 tokens
     and capacity factor 16 (= E / K: no assignment drops);
     13c. the five reduced() configs, card against CPU on the same
     weights and tokens: forward_train's logits and aux, serve_prefill of
     12 tokens and 4 decode steps with their caches, embed_sequences, in
     float32 (rtol 1e-4 atol 1e-5, loss_fn and every gradient too) and
     bfloat16 (2e-2), and qwen3's at moe_groups=2; an MoE token routed
     otherwise at a near tie (router gap under 1/32) leaves out what it
     reaches;
     13d. python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b
     --steps 60 --batch 16 --seq 64 --ckpt-every 20 --fail-at 30 as a
     subprocess exits non-zero; its rerun resumes and prints a final loss
     below its first;
  14. (right after phase 13's children, in a child process of its own)
     the EGNN family, no kernel on its path, weights from init_params (a
     torch.Generator seeded 0 on the card):
     14a. minibatch_lg at Reddit's size: random_power_law_graph(232_965,
     492)'s distribution drawn on the card (power_law_on_device: about
     114.6 M edges, a 458 MB col_idx; the numpy generator takes about a
     minute on the host), 602 normal features a node (561 MB), 41 uniform
     classes; launch.train.gnn_trainer under adamw(1e-3), 1,024 seeds a
     step sampled on the card at fanouts (15, 10) (169,984 nodes, 168,960
     edges, a 409 MB feature gather); the sampler's and a batch's ms by
     CUDA events; GNN_STEPS steps: ms a step, seeds/s, peak bytes, the idle
     share of a step, the model flops over the float32 peak;
     14b. full_graph_sm (2,708 nodes, a geometric graph's edges cut to
     10,556, 1,433 features, 7 classes) and molecule (128 graphs of 30
     nodes and 64 edges through egnn_forward_batched): ms a step and peak
     bytes; card against CPU on the same weights and batch at those widths
     and at reduced() on both layouts: logits, coordinates, loss and every
     gradient, float32 at rtol 1e-4 atol 1e-5, bfloat16 at 2e-2 (or no
     farther apart than the card's bfloat16 result is from its float32 one);
     14c. one minibatch_lg batch's loss and gradients twice, and one step
     twice, torch.equal; train_loop with a checkpoint every 5 steps and a
     failure after step 7, resumed torch.equal to 14a's run; python -m
     repro_torch.launch.train --arch egnn --steps 60 --batch 256
     --ckpt-every 20 --fail-at 30 as a subprocess exits non-zero, its rerun
     resumes and ends below its first loss (at batch 16 one batch's noise
     outweighs 60 steps);
     14d. the halo loss on full_graph_sm: at world size 1 (NCCL)
     make_sharded_loss torch.equal to loss_fn, loss and gradients; four
     gloo ranks on the one card (the (2, 2) debug mesh), their losses equal
     to each other's, loss and gradients against loss_fn at rtol 1e-5 and
     rtol 1e-4 atol 1e-6; per rank the ms of a step and of its collectives;
     14e. ogb_products at its full size (2,449,029 nodes, 61,859,140
     edges, 100 features, 47 classes): egnn_forward and node_embeddings
     under inference_mode (s, peak bytes, the share of the float32 peak),
     every output finite, the decoder over the embeddings torch.equal to
     the logits; every launch counter 0 after the phase;
  15. the kernels' JSON line (the ten kernel rows: phases 13 and 14 launch
     none), then the final JSON line.

The kernels' launch counters read the builds, the ground truths, the
timed serving loops (compressed ones and the baselines' too), the
exploration sessions, the refinement, the deletion, phase 9's pieces
(the restored index's serving, the engine's warm-up, flushes, bursts,
sessions, insert and delete, the journaled and checkpointed builds and
their recovery), phase 10's (the epoch's serving and the mutations under
it, the scrub pass, the async engines' flushes, the writer and the
engines of 10d together, build_index), phase 11's (the sharded builds,
the world-1 and composed searches, the reshard and the restored copy's
search; the ranks' searches, counted in each rank and added), the
recsys serving and the recsys training steps (12b's and 12c's) only;
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
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

INVALID = -1
# the H100 SXM's HBM3 rate and float32 peak outside the tensor cores
# (vendor figures), from the port's one roofline module
from repro_torch.analysis.roofline import (FP32_OPS_PER_S,  # noqa: E402
                                           HBM_BYTES_PER_S)
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
# phase 12: recsys training at the train_batch cell (batches of 65,536),
# the MLPerf split, seeded weights, CriteoLikeStream(seed=0)
TRAIN_STEPS = 12
TRAIN_PLAIN_STEPS = 3              # 12b: steps run again through the plain versions
TRAIN_PARAM_RTOL = 1e-4            # 12b: parameters after each, kernels vs plain
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 5, 7   # 12c: checkpoints at 0 and 5
# 12d: launch.train on the reduced DIN; at its default batch of 16 one
# batch's BCE noise is larger than what the steps learn
LAUNCH_TRAIN = dict(arch="din", steps=60, fail_at=30, batch=256)
# phase 13: LM serving at published widths, seeded weights (a
# torch.Generator seeded 0 on the card) and seeded tokens.  gemma3-12b
# whole (46.5 GB of float32 parameters) at prefill_32k's length with its
# batch cut from 32 to 1, then decode_32k's context with its batch cut from
# 128 to 1; qwen3-moe-30b-a3b at full width with 16 of its 48 layers (40.5
# GB: the whole model is 119.1 GB), a prefill of 4 x 4,096 tokens (16,384
# through each MoE layer at capacity 1,288) and decode at B=4
LM_SERVED = (
    dict(arch="gemma3-12b", layers=None, B=1, S=32_768,
         check=dict(B=2, S=2_049)),
    dict(arch="qwen3-moe-30b-a3b", layers=16, B=4, S=4_096,
         # capacity factor E / K: C >= T, no assignment can drop
         check=dict(B=2, S=257, capacity_factor=16.0)),
)
LM_DECODE = 16                     # greedy decode steps after the prefill
# 13a-b: float32 held at LM_TOL; bfloat16 held to the bfloat16 forward's
# own distance from the float32 one, LM_TOL's share logged
LM_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (2e-2, 2e-2)}
LM_REDUCED_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}  # 13c
LM_REDUCED = dict(B=2, S=40, prompt=12, decode=4)  # 13c: S past q_chunk 32
# a router logit gap within a few bfloat16 steps: two runs that round an
# activation to another neighbour may send such a token to another expert
# (13b's float32 check and 13c's comparisons leave out what it reaches)
ROUTE_TIE = 1 / 32
LAUNCH_LM = dict(arch="qwen3-moe-30b-a3b", steps=60, fail_at=30, batch=16,
                 seq=64, ckpt_every=20)
# phase 14: the EGNN family, weights from init_params (a torch.Generator
# seeded 0 on the card).  14a: minibatch_lg at Reddit's size, the graph of
# random_power_law_graph(232_965, 492) drawn on the card
REDDIT_DEGREE = 492
GNN_STEPS = 12                     # 14a's train steps; 14c resumes to them
GNN_CKPT_EVERY, GNN_FAIL_AT = 5, 7   # 14c: checkpoints at 0 and 5
GNN_SMALL_STEPS = 10               # 14b: full_graph_sm and molecule steps
GNN_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}  # 14b
HALO_MESH = (2, 2)                 # 14d: the debug mesh (data, model)
HALO_TOL = {"loss": 1e-5, "grad": (1e-4, 1e-6)}
HALO_REPS = 5                      # 14d: timed steps a rank
# 14c: launch.train on the reduced EGNN; at batch 16 one batch's NLL noise
# is larger than what 60 steps learn (the card's run: first 1.5035, final
# 1.5138), as 12d found for DIN
LAUNCH_GNN = dict(arch="egnn", steps=60, fail_at=30, batch=256,
                  ckpt_every=20)

KERNELS = {
    "gather_dist": "src/repro/kernels/gather_dist/gather_dist.py:35",
    "beam_merge": "src/repro/kernels/beam_merge/beam_merge.py:189",
    "fused_hop": "src/repro/kernels/fused_hop/fused_hop.py:114",
    "mrng_occlusion": "src/repro/kernels/mrng_occlusion/mrng_occlusion.py:50",
    "gather_dist_q": "src/repro/kernels/gather_dist_q/gather_dist_q.py:37",
    "pq_adc": "src/repro/kernels/pq_adc/pq_adc.py:68",
    "l2_topk": "src/repro/kernels/l2_topk/l2_topk.py:93",
    "bag_lookup": "src/repro/kernels/bag_lookup/bag_lookup.py:38",
    # the gradient of DIN's pooling sum, which JAX takes with its autodiff
    # and the port with the bag_lookup kernel
    "bag_lookup_bwd": "src/repro/models/recsys.py:220",
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
HOP_KERNELS = ("beam_merge", "gather_dist", "gather_dist_q", "pq_adc",
               "fused_hop")
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
# phase 10: live mutation under serving on the restored audio index
LIVE_INSERT, LIVE_REMOVE, LIVE_REFINE = 64, 16, 32   # a writer tick
LIVE_CORRUPT = 64                  # adjacency entries flipped for the scrubber
LIVE_TICKS = 3                     # writer ticks while the engines serve
LIVE_ROUNDS = 4                    # serving rounds at least, per engine
LIVE_PARTIAL = 64                  # submits with an expired deadline
N_BUILD_INDEX = 4_000              # launch.build_index --out
# phase 11: the sharded DEG
N_SHARDS = 2
MESH = (2, 2)                      # 11c: the debug mesh (data, model)
RANK_TIMEOUT_S = 300               # 11c: a rank still running then fails
N_EXPLORE_EXCLUDE = 32             # 11c: excluded ids of the exploration batch
LOOKUP_ROWS, LOOKUP_DIM = 65_536, 16   # 11c: the sharded lookup's table
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


def phase2(device, n_build=N_AUDIO, n_queries=N_QUERIES,
           n_rows=N_AUDIO) -> dict:
    """Every kernel's checks over ``n_rows`` phase-2 rows (the ground
    truth's scan always over N_AUDIO of them).  The card runs them at
    N_AUDIO; a rehearsal on the CPU may take fewer rows, every check and
    shape but N kept."""
    from repro_torch.configs.deg import QUANT_PRESETS
    from repro_torch.core.beam import default_beam_width, default_visited_size

    inp = phase2_inputs(device, N=n_rows)
    gt_inp = inp if n_rows == N_AUDIO else phase2_inputs(device)
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
               check_l2_topk(gt_inp, device, n_queries, K, reps=5),
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
            "bag_lookup": (bag_ops, "launches"),
            "bag_lookup_bwd": (bag_ops, "launches_bwd")}


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


def count_searches(count, what: str, fn, *args, kernel: bool,
                   local_searches: int | None = None, **kwargs):
    """``count(fn, ...)``, one counted piece of the main path, and its
    launches read just after it: one beam_search launch for each of its
    range_search calls (or, for the sharded step, which drives the beam
    engine itself, each of its ``local_searches``) where ``kernel`` (the
    search kernel takes their configuration), and then no beam_merge,
    gather_dist, gather_dist_q, pq_adc or fused_hop launch beside them;
    no beam_search launch where not.
    Returns fn's result and the number of searches."""
    from repro_torch.kernels.beam_search import ops as bs

    calls = []
    with range_search_calls(calls):
        out = count(fn, *args, **kwargs)
    n = len(calls) if local_searches is None else local_searches
    counters = launch_counters()
    hop = {name: getattr(*counters[name]) for name in HOP_KERNELS}
    kind = "range_search calls" if local_searches is None else \
        "local searches"
    log(f"  {what}: {n} {kind}; launches: beam_search "
        f"{bs.launches}, " + ", ".join(f"{n} {v}" for n, v in hop.items()))
    expect_launches("beam_search", bs.launches, n if kernel else 0,
                    f"{kind} ({what})")
    if kernel:
        for name, v in hop.items():
            expect_launches(name, v, 0, what)
    return out, n


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
              (adc, "pq_adc"), (l2, "l2_topk"), (bag, "bag_lookup"),
              (bag, "bag_lookup_bwd"))]
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


# ---------------------------------------------------------------------------
# phase 10: live mutation under serving, the async engine, the launchers
# ---------------------------------------------------------------------------
def _no_count(fn, *a, **kw):
    return fn(*a, **kw)


def _same_fields(what: str, got: dict, want: dict) -> None:
    import torch

    for f, t in want.items():
        if not torch.equal(got[f], t):
            raise AssertionError(f"{what}: {f} differ")


def epoch_phase(idx, queries, results: dict, held_out, device, count=None,
                *, batch=BATCH, n_insert=LIVE_INSERT, n_remove=LIVE_REMOVE,
                n_refine=LIVE_REFINE) -> dict:
    """Phase 10a on the restored index ``idx``: ``enable_publishing()``,
    then one ``publish()`` timed and the device bytes an epoch holds; the
    queries served from the epoch in batches (one ``beam_search`` launch a
    call) with ids, dists, hops and evals ``torch.equal`` to the live
    index's and ids equal to phase 4's; the epoch held across an insert
    wave of ``n_insert`` held-out rows, a remove of ``n_remove`` and a
    refine of ``n_refine`` on the live index, its tensors and its searches
    ``torch.equal`` to before; after its release one live epoch."""
    from repro_torch.core.beam import search_kernel_eligible

    count = count or _no_count
    kernel = search_kernel_eligible(idx._dev_vectors, "l2", "composed",
                                    device)
    mgr = count(idx.enable_publishing)
    t0 = time.perf_counter()
    count(idx.publish)
    sync()
    publish_s = time.perf_counter() - t0
    view = idx.acquire_view()
    nbytes = view.nbytes()
    log(f"phase10 publish: epoch {view.epoch} in {publish_s * 1e3:.3f} ms, "
        f"{nbytes:,} device bytes held (graph and vectors of "
        f"{idx.capacity:,} rows)")
    got, n_calls = count_searches(count, "phase10 epoch serve",
                                  serve_tensors, view, queries, "classic",
                                  batch=batch, kernel=kernel)
    if n_calls != -(-len(queries) // batch):
        raise AssertionError(f"{n_calls} range_search calls for "
                             f"{len(queries)} queries from the epoch")
    _same_fields("the epoch's search against the live index's", got,
                 serve_tensors(idx, queries, "classic", batch=batch))
    if not np.array_equal(got["ids"].cpu().numpy(), results["classic"]):
        raise AssertionError("the epoch's ids differ from phase 4's")
    held = {"adjacency": view.graph.adjacency.clone(),
            "weights": view.graph.weights.clone(),
            "vectors": view.vectors.clone()}
    n0 = idx.n
    secs = {}
    victims = np.random.default_rng(0).choice(n0, size=n_remove,
                                              replace=False)
    for what, fn, args, kw in (
            ("insert", idx.add, (held_out[:n_insert],), {"wave_size": WAVE}),
            ("remove", idx.remove, (victims,), {}),
            ("refine", idx.refine, (n_refine,), {"seed": 0})):
        t0 = time.perf_counter()
        count_searches(count, f"phase10 live {what}", fn, *args,
                       kernel=kernel, **kw)
        sync()
        secs[what] = time.perf_counter() - t0
    _same_fields("the held epoch's tensors after the mutations",
                 {"adjacency": view.graph.adjacency,
                  "weights": view.graph.weights, "vectors": view.vectors},
                 held)
    _same_fields("the held epoch's searches after the mutations",
                 serve_tensors(view, queries, "classic", batch=batch), got)
    count(idx.publish)
    live_held = mgr.live_epochs()
    idx.release_view(view)
    live_after = mgr.live_epochs()
    if len(live_held) != 2 or live_after != [mgr.current.epoch]:
        raise AssertionError(f"live epochs {live_held} while held, "
                             f"{live_after} after the release")
    log(f"phase10 epochs: {len(queries)} queries from epoch {view.epoch} "
        "torch.equal to the live index (ids, dists, hops, evals), ids equal "
        f"to phase 4's; held across insert {n_insert} / remove {n_remove} / "
        f"refine {n_refine} (n {n0} -> {idx.n}; seconds " + ", ".join(
            f"{k} {v:.3f}" for k, v in secs.items()) + "), its tensors and "
        f"searches torch.equal to before; live epochs {live_held} while "
        f"held, {live_after} after the release")
    return dict(publish_ms=publish_s * 1e3, epoch_bytes=nbytes, **secs)


def scrub_phase(idx, queries, device, count=None, *, batch=BATCH,
                n_corrupt=LIVE_CORRUPT, refine_repaired=True) -> dict:
    """Phase 10b: ``corrupt_adjacency(idx, n_corrupt, seed=0)``, then one
    timed ``IntegrityScrubber.run_pass()``; every corrupted row must enter
    the quarantine.  Between quarantine and re-admission (the scrubber's
    ``scrub.repair`` hook) a sync-engine flush of every query returns no
    quarantined id, one ``beam_search`` launch a flush.  After the repair:
    Table 1, an empty quarantine, and "classic" recall@10 against the
    exact neighbors of the rows the index now holds."""
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.core.invariants import check_table1
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.kernels.beam_search import ops as bs
    from repro_torch.resilience import FaultPlan
    from repro_torch.serving import QueryEngine
    from repro_torch.serving.scrub import IntegrityScrubber, corrupt_adjacency

    count = count or _no_count
    kernel = search_kernel_eligible(idx._dev_vectors, "l2", "composed",
                                    device)
    rows = count(corrupt_adjacency, idx, n_corrupt, seed=0)
    engine = QueryEngine(idx, k=K, eps=EPS, max_batch=batch,
                         preset="classic")
    seen = {}

    def between(**ctx):
        # the quarantine is published; the repair has not begun
        ep = idx._epochs.current
        q = set(ep.quarantine)
        f0, l0 = engine.stats.flushes, bs.launches
        ids, _ = engine.search(queries)
        flushes = engine.stats.flushes - f0
        seen.update(quarantine=q, flushes=flushes,
                    launches=bs.launches - l0,
                    leaked=int(np.isin(ids, list(q)).sum()))

    scrub = IntegrityScrubber(idx, refine_repaired=refine_repaired)
    t0 = time.perf_counter()
    with FaultPlan().call("scrub.repair", between, at=1):
        summary, _ = count_searches(count, "phase10 scrub pass",
                                    scrub.run_pass, kernel=kernel)
    sync()
    pass_s = time.perf_counter() - t0
    missed = sorted(set(rows) - seen.get("quarantine", set()))
    want_launches = seen.get("flushes", -1) if kernel else 0
    if (missed or seen.get("leaked", 1) or seen["flushes"]
            != -(-len(queries) // batch)
            or seen["launches"] != want_launches):
        raise AssertionError(f"scrub: corrupted rows {missed} not "
                             f"quarantined, or the flush between: {seen}")
    inv = check_table1(idx.builder)
    if not all(inv.values()) or idx.quarantine or summary["unrepaired"]:
        raise AssertionError(f"after the scrub pass: {inv}, quarantine "
                             f"{sorted(idx.quarantine)}, {summary}")
    gt = ground_truth(idx.vectors[: idx.n], queries, device,
                      tag="phase10 scrubbed")
    got, _ = count_searches(count, "phase10 serve after the repair",
                            serve_tensors, idx, queries, "classic",
                            batch=batch, kernel=kernel)
    rec = recall_at_k(got["ids"].cpu().numpy(), gt)
    log(f"phase10 scrub: {n_corrupt} flips over {len(rows)} rows; run_pass "
        f"{pass_s:.3f} s: {summary}; every corrupted row quarantined "
        f"({len(seen['quarantine'])} in all); the flush between: "
        f"{len(queries)} queries in {seen['flushes']} flushes, "
        f"{seen['launches']} beam_search launches, no quarantined id; "
        f"after the repair Table 1 holds, quarantine empty, recall@{K} "
        f"{rec:.4f} over the n={idx.n} rows (phase 4: the built graph's)")
    if rec < RECALL_FLOOR:
        raise AssertionError(f"recall@{K} {rec:.4f} after the repair")
    return dict(pass_s=pass_s, summary=summary, recall=rec,
                quarantined=len(seen["quarantine"]))


def _direct_flush(view, cfg, queries, hop_budget):
    """One sync flush of ``queries`` under ``cfg``: the bucket dispatch a
    ``QueryEngine`` flush runs, with a per-lane hop budget and the view's
    quarantine excluded, as both engines exclude it."""
    from repro_torch.serving import buckets as B
    from repro_torch.serving.engine import to_host

    quarantine = tuple(getattr(view, "quarantine", ()) or ())
    items = [B.BatchItem(query=q, exclude=quarantine) for q in queries]
    bucket = B.pow2_bucket(len(items))
    qs, seeds, excl = B.pad_batch(items, bucket, view.medoid())
    budget = (None if hop_budget is None
              else np.full(bucket, hop_budget, np.int32))
    return to_host(B.dispatch(view, cfg, qs, seeds, excl, budget))


def _sync_engine_ids(idx, cfg, queries):
    """The ids of ``queries`` from a sync ``QueryEngine`` built with
    ``cfg``'s knobs (the sync engine has no hop budget)."""
    from repro_torch.serving import QueryEngine

    eng = QueryEngine(idx, k=cfg.k, eps=cfg.eps, max_batch=len(queries),
                      beam_width=cfg.beam_width, codec=cfg.codec,
                      rerank_k=cfg.rerank_k, expand_width=cfg.expand_width,
                      visited_size=cfg.visited_size,
                      hop_backend=cfg.hop_backend)
    if eng.cfg != cfg:
        raise AssertionError(f"the sync engine's config {eng.cfg} is not "
                             f"{cfg}")
    return eng.search(queries)[0]


def _async_all(engine, queries, **kw):
    futs = [engine.submit(q, **kw) for q in queries]
    outs = [f.result(600.0) for f in futs]
    return futs, outs


def async_phase(path, queries, results: dict, device, count=None, *,
                batch=BATCH, n_partial=LIVE_PARTIAL, tmp=None) -> dict:
    """Phase 10c on a fresh restore of the snapshot:
    ``AsyncQueryEngine(max_batch=batch, preset="classic")``: ``warmup()``,
    then every query as its own submit with no deadline (one
    ``beam_search`` launch a flush), ids equal to phase 4's on every slot;
    request p50/p99 and QPS.  Each rung of the degradation ladder forced
    once on ``batch`` queries, its ids equal on every lane to a flush of
    the buckets' dispatch under the rung's config and hop budget, and to
    a sync ``QueryEngine`` built with the rung's config (the sq8 rung's
    an sq8 engine) on every lane that the hop budget did not stop.
    ``n_partial`` submits with an expired
    deadline complete ``partial`` with hops <= ``partial_hops`` (read
    from the query log)."""
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.core.build import DEGIndex
    from repro_torch.obs import QueryLogWriter, read_query_log
    from repro_torch.serving import AsyncQueryEngine

    count = count or _no_count
    idx = count(DEGIndex.load, path, device=device)
    kernel = search_kernel_eligible(idx._dev_vectors, "l2", "composed",
                                    device)
    kw = dict(k=K, eps=EPS, max_batch=batch, preset="classic",
              deadline_ms=None)
    eng = AsyncQueryEngine(idx, **kw)
    try:
        warm = count(eng.warmup)
        t0 = time.perf_counter()
        (futs, outs), n_calls = count_searches(
            count, "phase10 async serve", _async_all, eng, queries,
            kernel=kernel)
        wall = time.perf_counter() - t0
        st = eng.stats
    finally:
        eng.close()
    ids = np.stack([o[0] for o in outs])
    if n_calls != st.flushes or not np.array_equal(ids, results["classic"]):
        raise AssertionError(f"async: {n_calls} range_search calls for "
                             f"{st.flushes} flushes, or ids differ from "
                             "phase 4's")
    lat = np.array([f.latency_s for f in futs]) * 1e3
    out = dict(p50_ms=float(np.percentile(lat, 50)),
               p99_ms=float(np.percentile(lat, 99)),
               qps=len(queries) / wall, flushes=st.flushes,
               buckets=dict(st.bucket_hist), warmup_s=sum(warm.values()))
    log(f"phase10 async engine: {len(queries)} single submits in "
        f"{st.flushes} flushes (buckets {dict(sorted(st.bucket_hist.items()))})"
        f", {n_calls} beam_search launches, ids equal to phase 4's on every "
        f"slot; request p50 {out['p50_ms']:.3f} ms p99 {out['p99_ms']:.3f} "
        f"ms, {out['qps']:.1f} QPS over {wall:.3f} s wall; warmup "
        f"{out['warmup_s']:.3f} s over {len(warm)} flush shapes")
    # the ladder, each rung forced on every flush of one batch
    eng = AsyncQueryEngine(idx, max_queue=4 * batch, degrade=True, **kw)
    rungs, capped = [], {}
    try:
        count(eng.warmup)
        for level, rung in enumerate(eng._ladder):
            eng._ladder_ctl.observe = lambda backlog, lv=level: lv
            (futs, outs), _ = count_searches(
                count, f"phase10 async rung {rung.name}", _async_all, eng,
                queries[:batch], kernel=kernel)
            got = np.stack([o[0] for o in outs])
            want, _, hops = _direct_flush(idx, rung.cfg, queries[:batch],
                                          rung.hop_budget)[:3]
            want, hops = want[:batch], hops[:batch]
            free = (np.ones(batch, bool) if rung.hop_budget is None
                    else hops < rung.hop_budget)
            sync_ids = _sync_engine_ids(idx, rung.cfg, queries[:batch])
            if (not np.array_equal(got, want)
                    or not np.array_equal(got[free], sync_ids[free])
                    or {f.degrade_level for f in futs} != {level}):
                raise AssertionError(f"rung {rung.name}: ids differ from a "
                                     "flush or a sync engine under its "
                                     "config")
            rungs.append(rung.name)
            capped[rung.name] = int(batch - free.sum())
    finally:
        eng.close()
    log(f"phase10 degrade ladder: rungs {rungs} each forced on {batch} "
        "queries, ids equal to a flush under the rung's config and hop "
        "budget on every lane, and to a sync QueryEngine of the rung's "
        "config (the sq8 rung's an sq8 engine) on the lanes the budget did "
        f"not stop (lanes stopped: {capped})")
    # expired deadlines: served under the partial hop budget
    path_log = os.path.join(tmp, "partials.jsonl")
    qlog = QueryLogWriter(path_log)
    eng = AsyncQueryEngine(idx, k=K, eps=EPS, max_batch=batch,
                           preset="classic", deadline_ms=0.0, partial_hops=4,
                           trace_sample=1.0, query_log=qlog)
    try:
        futs, _ = count(_async_all, eng, queries[:n_partial])
    finally:
        eng.close()
        qlog.close()
    recs = read_query_log(path_log)
    hops = [r["hops"] for r in recs]
    if (not all(f.partial for f in futs) or len(recs) != n_partial
            or not all(r["partial"] for r in recs) or max(hops) > 4):
        raise AssertionError(f"expired deadlines: partial "
                             f"{sum(f.partial for f in futs)}, hops {hops}")
    log(f"phase10 expired deadlines: {n_partial} submits all partial, hops "
        f"<= partial_hops 4 (max {max(hops)})")
    out["rungs"] = rungs
    return out


def live_serve_phase(idx, queries, held_out, device, count=None, *,
                     batch=BATCH, ticks=LIVE_TICKS, n_insert=LIVE_INSERT,
                     n_remove=LIVE_REMOVE, n_refine=LIVE_REFINE,
                     min_rounds=LIVE_ROUNDS) -> dict:
    """Phase 10d on the publishing index of 10a and 10b: a "classic" and
    an "sq8-serving" async engine serve rounds of ``batch`` queries, in
    turn, while
    a writer thread runs ``ticks`` ticks (insert ``n_insert`` held-out
    rows, remove ``n_remove``, refine ``n_refine``, publish) and the
    scrubber audits.  Every served result replays bit-identically
    (``torch.equal`` of ids and dists) against the epoch stamped on it;
    Table 1 holds at the end; the scrubber ended at least one pass, none
    of them with an error or a crash; epochs published and retired and
    the p99 supersede-to-retire lag are logged."""
    import threading

    import torch
    from repro_torch.configs.deg import QUANT_PRESETS
    from repro_torch.core.invariants import check_table1
    from repro_torch.obs import EPOCH_RETIRED_LAG_MS, MetricsRegistry
    from repro_torch.serving import AsyncQueryEngine
    from repro_torch.serving.scrub import IntegrityScrubber

    count = count or _no_count
    if idx.metrics is None:
        idx.metrics = MetricsRegistry()
    mgr = idx._epochs
    kept = {e: mgr.live[e] for e in mgr.live_epochs()}
    publish0, retired0 = mgr.current.epoch, mgr.retired_total
    orig_publish = mgr.publish
    lock = threading.Lock()

    def keeping_publish(ep):
        with lock:
            kept[ep.epoch] = ep
        orig_publish(ep)

    sq8 = QUANT_PRESETS["sq8-serving"]
    engines = {
        "classic": AsyncQueryEngine(idx, k=K, eps=EPS, max_batch=batch,
                                    preset="classic", deadline_ms=None),
        "sq8-serving": AsyncQueryEngine(
            idx, k=K, eps=EPS if sq8.eps is None else sq8.eps,
            max_batch=batch, preset="classic", codec=sq8.codec,
            rerank_k=sq8.rerank_k, deadline_ms=None)}
    for e in engines.values():
        e.warmup()
    errors, done = [], threading.Event()
    rng = np.random.default_rng(3)

    def writer():
        try:
            for i in range(ticks):
                rows = held_out[i * n_insert:(i + 1) * n_insert]
                idx.add(rows, wave_size=WAVE)
                idx.remove(rng.choice(idx.n, size=n_remove, replace=False))
                idx.refine(n_refine, seed=100 + i)
                idx.publish()
        except Exception as e:          # surfaced below
            errors.append(e)
        finally:
            done.set()

    def serve():
        # the writer and the scrubber start inside the counted piece, so
        # each of their searches is counted with its launch
        scrub.start()
        wt.start()
        served = []
        rounds = 0
        names = list(engines)
        while (not done.is_set() or rounds < min_rounds
               or not scrub.pass_ended.is_set()):
            lo = (rounds * batch) % max(1, len(queries) - batch)
            qs = queries[lo:lo + batch]
            name = names[rounds % len(names)]      # the engines in turn
            futs = [engines[name].submit(q) for q in qs]
            for q, f in zip(qs, futs):
                ids, dists = f.result(600.0)
                served.append((name, q, ids, dists, f.epoch))
            rounds += 1
            # the writer's host work needs the interpreter too: without a
            # pause between rounds the serving threads starve it
            time.sleep(0.005)
        wt.join()
        scrub.stop()
        return served, rounds

    scrub = IntegrityScrubber(idx, interval_s=0.5)
    wt = threading.Thread(target=writer, name="phase10-writer")
    mgr.publish = keeping_publish
    t0 = time.perf_counter()
    try:
        (served, rounds), _ = count_searches(
            count, "phase10 live mutation under serving", serve,
            kernel=torch.device(device).type == "cuda")
    finally:
        if wt.is_alive():
            wt.join()
        scrub.stop()
        for e in engines.values():
            e.close()
        mgr.publish = orig_publish
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    torn = 0
    by = {}
    for name, q, ids, dists, ep in served:
        by.setdefault((name, ep), []).append((q, ids, dists))
    for (name, e), group in sorted(by.items()):
        cfg = engines[name].cfg
        for lo in range(0, len(group), batch):
            chunk = group[lo:lo + batch]
            r_ids, r_d = _direct_flush(kept[e], cfg, [g[0] for g in chunk],
                                       None)[:2]
            got_ids = torch.from_numpy(np.stack([g[1] for g in chunk]))
            got_d = torch.from_numpy(np.stack([g[2] for g in chunk]))
            n = len(chunk)
            torn += int((~(torch.from_numpy(r_ids[:n]) == got_ids).all(1)
                         | ~(torch.from_numpy(r_d[:n]).view(torch.int32)
                             == got_d.view(torch.int32)).all(1)).sum())
    inv = check_table1(idx.builder)
    lag = idx.metrics.histogram(EPOCH_RETIRED_LAG_MS)
    published = mgr.current.epoch - publish0
    retired = mgr.retired_total - retired0
    log(f"phase10 live mutation under serving: {ticks} writer ticks (insert "
        f"{n_insert}, remove {n_remove}, refine {n_refine}, publish) and "
        f"{scrub.stats.passes} scrub passes ({scrub.stats.errors} errors, "
        f"{scrub.stats.crashes} crashes) in {wall:.3f} s while "
        f"{rounds} rounds of {batch} queries went to the classic and "
        f"sq8-serving async engines in turn: {len(served)} results over "
        f"epochs {sorted({k[1] for k in by})}, {torn} torn reads (each result "
        "replayed against its epoch, ids and dists bit for bit); epochs "
        f"published {published}, retired {retired}, retire lag p99 "
        f"{lag.percentile(99.0):.3f} ms over {lag.count}; n {idx.n}; "
        f"Table 1 {inv}")
    ss = scrub.stats
    if (torn or not all(inv.values()) or len({k[1] for k in by}) < 2
            or ss.passes < 1 or ss.errors or ss.crashes):
        raise AssertionError(f"live mutation: {torn} torn reads, Table 1 "
                             f"{inv}, epochs {sorted(by)}, scrubber {ss}")
    return dict(results=len(served), torn=torn, published=published,
                retired=retired, lag_p99_ms=lag.percentile(99.0),
                wall_s=wall, scrub_passes=scrub.stats.passes)


def launcher_phase(path, device, tmp, count=None, *, queries=None,
                   n_build=N_BUILD_INDEX) -> dict:
    """Phase 10e: ``python -m repro_torch.launch.serve --index <path>
    --engine async --warmup --refine-while-serving 4 --scrub-every 0.5
    --inject-corruption 16`` as a subprocess (its ``resilience:``,
    ``refine:``, ``scrub:`` and ``invariants:`` lines required: no crash,
    at least one refine tick and no refine error, no scrub error or
    crash, nothing left unrepaired), then ``launch.build_index --out`` at
    ``n_build`` rows, loaded back."""
    from repro_torch.core.build import DEGIndex
    from repro_torch.launch import build_index

    count = count or _no_count
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--index", path,
           "--engine", "async", "--warmup", "--refine-while-serving", "4",
           "--scrub-every", "0.5", "--inject-corruption", "16",
           "--device", device]
    if queries:
        cmd += ["--queries", str(queries)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=env)
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    want = {}
    for key in ("resilience:", "refine: ticks=", "scrub:", "invariants:",
                "served "):
        hit = [ln for ln in lines if ln.startswith(key)]
        want[key] = hit[-1] if hit else None
    for ln in want.values():
        if ln:
            log(f"  serve: {ln}")
    if proc.returncode != 0 or None in want.values():
        raise AssertionError(f"launch.serve exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    res, refine, scrub = (dict(kv.split("=") for kv in want[key].split()[1:])
                          for key in ("resilience:", "refine: ticks=",
                                      "scrub:"))
    if (res["crashed"] != "0" or res["status"] != "ok"
            or int(refine["ticks"]) < 1 or refine["errors"] != "0"
            or scrub["errors"] != "0" or scrub["crashes"] != "0"
            or scrub["unrepaired"] != "0" or int(scrub["quarantined"]) < 1
            or want["invariants:"] != "invariants: ok=True"):
        raise AssertionError(f"launch.serve: {want}")
    import torch

    out_path = os.path.join(tmp, "built.npz")
    kernel = torch.device(device).type == "cuda"    # l2, the exact store
    t1 = time.perf_counter()
    count_searches(count, "phase10 build_index", build_index.main,
                   ["--n", str(n_build), "--out", out_path,
                    "--device", device], kernel=kernel)
    build_s = time.perf_counter() - t1
    back = DEGIndex.load(out_path, device=device)
    if back.n != n_build:
        raise AssertionError(f"build_index wrote n={back.n}")
    log(f"phase10 launch.serve subprocess: exit 0 in {secs:.1f} s; "
        f"build_index --out at n={n_build}: {build_s:.1f} s, loaded back "
        f"n={back.n}")
    return dict(serve_s=secs, build_s=build_s)


def live_phase(path, queries, results: dict, device, count=None, *, tmp,
               batch=BATCH, ticks=LIVE_TICKS, n_insert=LIVE_INSERT,
               n_remove=LIVE_REMOVE, n_refine=LIVE_REFINE,
               n_corrupt=LIVE_CORRUPT, n_partial=LIVE_PARTIAL,
               launcher_queries=None, n_build=N_BUILD_INDEX) -> dict:
    """Phase 10: 10a-10e on the index phase 9 saved at ``path``.  The rows
    inserted are midpoints of seeded pairs of its rows, each inserted
    once: rows of the data's spread that no query sits on, so the exact
    scan after the inserts meets no near-zero distance (where the scan's
    expanded form and ``exact_knn_batched`` part by more than 1e-5)."""
    from repro_torch.core.build import DEGIndex

    count = count or _no_count
    t0 = time.perf_counter()
    tick = dict(n_insert=n_insert, n_remove=n_remove, n_refine=n_refine)
    idx = count(DEGIndex.load, path, device=device)
    pairs = np.random.default_rng(10).integers(
        0, idx.n, size=(2, n_insert * (ticks + 1)))
    held_out = (0.5 * (idx.vectors[pairs[0]] + idx.vectors[pairs[1]])
                ).astype(np.float32)
    out = {"epochs": epoch_phase(idx, queries, results, held_out[:n_insert],
                                 device, count, batch=batch, **tick)}
    out["scrub"] = scrub_phase(idx, queries, device, count, batch=batch,
                               n_corrupt=n_corrupt)
    out["async"] = async_phase(path, queries, results, device, count,
                               batch=batch, n_partial=n_partial, tmp=tmp)
    out["live"] = live_serve_phase(idx, queries, held_out[n_insert:],
                                   device, count, batch=batch, ticks=ticks,
                                   **tick)
    out["launch"] = launcher_phase(path, device, tmp, count,
                                   queries=launcher_queries, n_build=n_build)
    log(f"phase10 total {time.perf_counter() - t0:.1f} s")
    return out


def served_ids(served, quant_served) -> dict:
    """Phase 4's "classic" ids and phase 4b's ids of each store, by name."""
    return {"classic": served["classic"]["ids"],
            **{name: r["ids"] for name, r in quant_served.items()}}


def persist_serve_phase(idx, base, queries, served, quant_served, device,
                        count=None) -> dict:
    """Phase 9 (9a, 9b and 9c), then phase 10 on phase 9's snapshot, in a
    temporary directory (removed after)."""
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
        live = live_phase(path, queries, results, device, count, tmp=tmp)
    return dict(snapshot=snap, engine=eng, wal=wal, live=live)


# ---------------------------------------------------------------------------
# phase 11: the sharded DEG over torch.distributed
# ---------------------------------------------------------------------------
def shard_graph(sd, s: int):
    """Shard ``s`` of a ShardedDEG's stacked tensors as a DEGraph."""
    import torch

    from repro_torch.core.graph import DEGraph

    return DEGraph(adjacency=sd.adjacency[s],
                   weights=torch.zeros(sd.adjacency.shape[1:],
                                       device=sd.adjacency.device),
                   n=int(sd.n[s]))


def composed_search(sd, queries, *, k=K, eps=EPS, batch=BATCH):
    """The sharded float32 search without collectives: each shard's
    ``range_search`` from its seed, global ids, the stable merge of the
    shards' lists in shard order.  Returns (ids, dists) tensors."""
    import torch

    from repro_torch.core.search import range_search

    S = sd.n_shards
    dev = sd.adjacency.device
    out_ids, out_d = [], []
    for lo in range(0, len(queries), batch):
        q = torch.as_tensor(queries[lo: lo + batch], device=dev)
        vals, ids = [], []
        for s in range(S):
            seeds = sd.seeds[s: s + 1].reshape(1, 1).expand(len(q), 1)
            r = range_search(shard_graph(sd, s), sd.vectors[s], q,
                             seeds.contiguous(), k=k, eps=eps)
            vals.append(r.dists)
            ids.append(torch.where(r.ids == INVALID, INVALID, r.ids * S + s))
        top, pos = torch.sort(torch.cat(vals, 1), dim=1, stable=True)
        out_d.append(top[:, :k])
        out_ids.append(torch.gather(torch.cat(ids, 1), 1, pos[:, :k]))
    return torch.cat(out_ids), torch.cat(out_d)


def sharded_batches(search, queries, *, batch=BATCH):
    """``search`` (a batch of host queries -> (ids, dists)) over every
    batch; returns the (ids, dists) tensors."""
    import torch

    ids, dists = [], []
    for lo in range(0, len(queries), batch):
        i, d = search(queries[lo: lo + batch])
        ids.append(i)
        dists.append(d)
    return torch.cat(ids), torch.cat(dists)


def table1(what: str, builder) -> None:
    from repro_torch.core.invariants import check_table1

    inv = check_table1(builder)
    log(f"  {what} table-1: {inv}")
    if not all(inv.values()):
        raise AssertionError(f"{what}: Table-1 invariants broken: {inv}")


def build_shards(base, n_shards: int, device, count, tag: str):
    """build_sharded_deg at the audio config (waves of WAVE), counted: one
    beam_search launch a wave and one extend_select launch an extend
    block; Table 1 on every shard.  Returns the ShardedDEG."""
    from repro_torch.configs.deg import DEG_PAPER_CONFIGS
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.distributed.index import build_sharded_deg
    from repro_torch.kernels.extend_select import ops as es_ops

    params = DEG_PAPER_CONFIGS["audio"]
    t0 = time.perf_counter()
    sd, calls = count_searches(
        count, f"{tag} build", build_sharded_deg, base, n_shards, params,
        wave_size=WAVE, device=device,
        kernel=search_kernel_eligible(base, "l2", "composed", device))
    sync()
    secs = time.perf_counter() - t0
    waves = sum(-(-(sh.n - params.degree - 1) // WAVE) for sh in sd.shards)
    blocks = sum(extend_blocks(sh.build_stats["vertices"])
                 for sh in sd.shards)
    if calls != waves:
        raise AssertionError(f"{calls} range_search calls for {waves} "
                             "insert waves")
    log(f"{tag} build of {len(base)} rows in {n_shards} shards "
        f"{[sh.n for sh in sd.shards]}: {secs:.2f} s; extend_select "
        f"launches {es_ops.launches} for {blocks} extend blocks")
    expect_launches("extend_select", es_ops.launches, blocks,
                    "extend blocks")
    for s, sh in enumerate(sd.shards):
        st = sh.build_stats
        log(f"  {tag} shard {s}: n={sh.n}, search_s {st['search_s']:.2f}, "
            f"extend_s {st['extend_s']:.2f}, seed {int(sd.seeds[s])}")
        table1(f"{tag} shard {s}", sh.builder)
    return sd, secs


def world1_phase(base, queries, gt, device, count, tmp, *, k=K, eps=EPS,
                 batch=BATCH, n_host=N_HOST) -> dict:
    """11a, 11b and 11d at world size 1 (NCCL on the card, gloo on the
    CPU): see the module docstring.  Writes the stacked tensors the ranks
    of 11c search to ``tmp``; returns its measurements and the composed
    float32 search of the S=2 index."""
    import torch

    from repro_torch.configs.deg import QUANT_PRESETS
    from repro_torch.core.beam import search_kernel_eligible
    from repro_torch.core.metrics import graph_quality, recall_at_k
    from repro_torch.core.search import range_search
    from repro_torch.distributed.index import ShardedDEG
    from repro_torch.interop import sharded_to_numpy
    from repro_torch.launch.mesh import axis_group, make_mesh
    from repro_torch.launch.ranks import process_group

    backend = "nccl" if str(device) != "cpu" else "gloo"
    kernel = search_kernel_eligible(base, "l2", "composed", device)
    sq8_rr = QUANT_PRESETS["sq8-serving"].rerank_k
    out = {}
    with process_group(backend):
        mesh = make_mesh((1, 1), ("data", "model"), device)
        groups = {a: axis_group(mesh, a).backend for a in ("data", "model")}
        log(f"phase11a world size 1, mesh (1, 1) on {device}: default "
            f"group {backend}; groups {groups}")
        if set(groups.values()) != {backend}:
            raise AssertionError(f"phase11a: groups {groups}, want {backend}")
        # 11a: one shard at world size 1
        sd1, out["build1_s"] = build_shards(base, 1, device, count,
                                            "phase11a")
        sd1.search(mesh, queries[:batch], k=k, eps=eps)   # warm-up
        sync()
        t0 = time.perf_counter()
        (ids1, d1), n = count_searches(
            count, "phase11a sharded search", sharded_batches,
            lambda q: sd1.search(mesh, q, k=k, eps=eps), queries,
            batch=batch, kernel=kernel,
            local_searches=-(-len(queries) // batch))
        sync()
        secs = time.perf_counter() - t0
        g = shard_graph(sd1, 0)
        for lo in range(0, len(queries), batch):
            q = torch.as_tensor(queries[lo: lo + batch], device=device)
            seeds = torch.full((len(q), 1), int(sd1.seeds[0]),
                               dtype=torch.int32, device=device)
            r = range_search(g, sd1.vectors[0], q, seeds, k=k, eps=eps)
            if not (torch.equal(r.ids, ids1[lo: lo + batch])
                    and torch.equal(r.dists, d1[lo: lo + batch])):
                raise AssertionError("phase11a: the world-1 sharded search "
                                     "differs from range_search at batch "
                                     f"{lo // batch}")
        rec1 = recall_at_k(ids1.cpu().numpy(), gt)
        log(f"phase11a search: {len(queries)} queries in {n} batches, "
            f"{secs:.3f} s = {len(queries) / secs:.1f} QPS, recall@{k} "
            f"{rec1:.4f}; ids and dists torch.equal to range_search")
        idle_share(lambda: sd1.search(mesh, queries[:batch], k=k, eps=eps),
                   secs * 1e3 / n, f"phase11a one batch of {batch}")
        out.update(world1_qps=len(queries) / secs, world1_recall=rec1)

        # 11b: two shards over every row
        sd2, out["build2_s"] = build_shards(base, N_SHARDS, device, count,
                                            "phase11b")
        for s, sh in enumerate(sd2.shards):
            t0 = time.perf_counter()
            gq = graph_quality(sh.builder, sh.vectors, "l2")
            log(f"  phase11b shard {s} graph quality (Eq. 3) {gq:.4f} in "
                f"{time.perf_counter() - t0:.2f} s")
            out[f"gq{s}"] = gq
        t0 = time.perf_counter()
        (ids2, d2), _ = count_searches(
            count, "phase11b merged search", composed_search, sd2, queries,
            k=k, eps=eps, batch=batch, kernel=kernel)
        sync()
        rec2 = recall_at_k(ids2.cpu().numpy(), gt)
        log(f"phase11b merged search (each shard's range_search, the "
            f"stable merge): {time.perf_counter() - t0:.3f} s, recall@{k} "
            f"{rec2:.4f}")
        if rec2 < RECALL_FLOOR:
            raise AssertionError(f"phase11b recall@{k} {rec2:.4f} < "
                                 f"{RECALL_FLOOR}")
        out.update(merged=(ids2, d2), merged_recall=rec2)
        t0 = time.perf_counter()
        sq8 = sd2.quantize("sq8")
        sync()
        log(f"phase11b sq8 per shard: {time.perf_counter() - t0:.3f} s, "
            f"{sq8.memory_stats()}")
        pq_base = base[:n_host]
        sdp, _ = build_shards(pq_base, N_SHARDS, device, count,
                              "phase11b pq index")
        t0 = time.perf_counter()
        pq = sdp.quantize("pq")
        sync()
        out["pq_s"] = time.perf_counter() - t0
        log(f"phase11b pq per shard (host fit, seed = shard) on {n_host} "
            f"rows: {out['pq_s']:.2f} s, {pq.memory_stats()}")

        # 11d: the sharded snapshot of the sq8 index
        path = os.path.join(tmp, "sharded_sq8.npz")
        t0 = time.perf_counter()
        sq8.save(path)
        save_s, nbytes = time.perf_counter() - t0, os.path.getsize(path)
        t0 = time.perf_counter()
        back = ShardedDEG.load(path, device=device)
        sync()
        load_s = time.perf_counter() - t0
        for name in ("adjacency", "vectors", "n", "seeds", "codes",
                     "scales"):
            if not torch.equal(getattr(back, name), getattr(sq8, name)):
                raise AssertionError(f"phase11d: the restored {name} "
                                     "differs")
        log(f"phase11d save_sharded {save_s:.3f} s, {nbytes} bytes; "
            f"load_sharded on {device} {load_s:.3f} s (re-encodes sq8); "
            "every stacked tensor torch.equal")
        t0 = time.perf_counter()
        re1, _ = count_searches(
            count, "phase11d reshard to 1 shard", ShardedDEG.load, path,
            n_shards=1, wave_size=WAVE, device=device, kernel=kernel)
        sync()
        reshard_s = time.perf_counter() - t0
        if re1.n_total != len(base) or re1.codec != "sq8":
            raise AssertionError(f"phase11d: reshard holds {re1.n_total} "
                                 f"rows under {re1.codec}")
        table1("phase11d reshard", re1.shards[0].builder)
        if not torch.equal(re1.adjacency, sd1.adjacency):
            raise AssertionError("phase11d: the S=1 rebuild differs from "
                                 "11a's build of the same rows")
        live = sd1.quantize("sq8")
        (ids_r, d_r), _ = count_searches(
            count, "phase11d restored sq8 world-1 search", sharded_batches,
            lambda q: re1.search(mesh, q, k=k, eps=eps, rerank_k=sq8_rr),
            queries, batch=batch, kernel=kernel,
            local_searches=-(-len(queries) // batch))
        ids_l, d_l = sharded_batches(
            lambda q: live.search(mesh, q, k=k, eps=eps, rerank_k=sq8_rr),
            queries, batch=batch)
        if not (torch.equal(ids_r, ids_l) and torch.equal(d_r, d_l)):
            raise AssertionError("phase11d: the restored copy's world-1 "
                                 "search differs from the live one's")
        log(f"phase11d reshard-on-restore to 1 shard: {reshard_s:.2f} s, "
            f"n_total {re1.n_total}, adjacency torch.equal to 11a's; its "
            f"sq8 world-1 search (rerank {sq8_rr}) torch.equal to 11a's "
            f"index under sq8, recall@{k} "
            f"{recall_at_k(ids_r.cpu().numpy(), gt):.4f}")
        out.update(save_s=save_s, bytes=nbytes, load_s=load_s,
                   reshard_s=reshard_s)
    torch.save({"stacked": {"float32": sharded_to_numpy(sd2),
                            "sq8": sharded_to_numpy(sq8),
                            "sq8_restored": sharded_to_numpy(back),
                            "pq": sharded_to_numpy(pq)},
                "queries": np.asarray(queries, np.float32),
                "base": np.asarray(base, np.float32)},
               os.path.join(tmp, "shards.pt"))
    return out


def shard_rank(rank, world, tmp, cfg) -> dict:
    """One of 11c's ranks: the (2, 2) debug mesh over gloo on the card,
    the stacked tensors of 11b and 11d loaded to it, every search of 11c
    in batches with its launches and stage times counted, and the
    collectives.  Returns host arrays."""
    import torch

    from repro_torch.distributed.collectives import (
        compressed_psum, make_sharded_lookup, sharded_brute_topk)
    from repro_torch.distributed.index import make_sharded_search
    from repro_torch.interop import sharded_from_numpy
    from repro_torch.launch.mesh import axis_group, make_mesh

    device = cfg["device"]
    if device != "cpu":
        torch.cuda.set_device(0)
    mesh = make_mesh(cfg["mesh"], ("data", "model"), device)
    every = axis_group(mesh, ("data", "model"))
    out = {"index": every.index, "launches": {}, "calls": {},
           "stage_ms": {}, "wall_s": {},
           "backends": {str(a): axis_group(mesh, a).backend
                        for a in ("data", "model", ("data", "model"))}}
    data = torch.load(os.path.join(tmp, "shards.pt"), weights_only=False)
    queries, base = data["queries"], data["base"]
    k, eps, batch = cfg["k"], cfg["eps"], cfg["batch"]
    ops = launch_counters()

    def index(name):
        return sharded_from_numpy(**data["stacked"][name], device=device)

    def run(tag, sd, qs, *, eps=eps, rerank_k=0, exclude=None):
        stage = {}
        f = make_sharded_search(
            mesh, k=k, eps=eps, metric=sd.params.metric, codec=sd.codec,
            rerank_k=rerank_k, stage_ms=stage,
            exclude_width=0 if exclude is None else exclude.shape[1])
        for m, attr in ops.values():
            setattr(m, attr, 0)
        t0 = time.perf_counter()
        ids, dists = [], []
        for lo in range(0, len(qs), batch):
            q = torch.as_tensor(qs[lo: lo + batch], device=device)
            extra = [] if exclude is None else [torch.as_tensor(
                exclude[lo: lo + batch], device=device)]
            i, d = f(*sd.search_args(), q, *extra)
            ids.append(i.cpu())
            dists.append(d.cpu())
        calls = len(ids)
        out["wall_s"][tag] = time.perf_counter() - t0
        out["launches"][tag] = {n: getattr(m, a) for n, (m, a) in ops.items()}
        out["calls"][tag] = calls
        out["stage_ms"][tag] = {s: v / calls for s, v in stage.items()}
        out[tag] = (torch.cat(ids).numpy(), torch.cat(dists).numpy())

    f32 = index("float32")
    run("warm-up", f32, queries[:batch])       # the groups' first calls
    run("float32", f32, queries)
    run("float32_drop", f32.drop_shard(0), queries)
    run("sq8", index("sq8"), queries, rerank_k=cfg["sq8_rerank"])
    run("sq8_restored", index("sq8_restored"), queries,
        rerank_k=cfg["sq8_rerank"])
    run("pq", index("pq"), queries, eps=cfg["pq_eps"],
        rerank_k=cfg["pq_rerank"])
    # one exploration batch: the query is an indexed row, which is
    # excluded with N_EXPLORE_EXCLUDE - 1 more ids, some INVALID
    rng = np.random.default_rng(11)
    n_total = int(f32.n.sum())
    rows = rng.choice(n_total, size=batch, replace=False)
    ex = rng.integers(0, n_total, size=(batch, cfg["n_exclude"]))
    ex[:, 0] = rows
    ex[::4, 1:8] = INVALID
    out["explore_exclude"] = ex.astype(np.int32)
    run("explore", f32, base[rows], exclude=ex.astype(np.int32))

    n_db = len(base) // every.size * every.size
    t0 = time.perf_counter()
    vals, ids = sharded_brute_topk(
        mesh, k=k, shard_axes=("data", "model"), metric="l2")(
        torch.as_tensor(queries, device=device),
        torch.as_tensor(base[:n_db], device=device))
    out["brute"] = (vals.cpu().numpy(), ids.cpu().numpy(), n_db)
    out["wall_s"]["brute"] = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(every.index)
    x = torch.randn(4096, generator=gen) * 10.0 ** every.index
    out["psum"] = (x.numpy(), compressed_psum(x.to(device), every).cpu()
                   .numpy())
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(LOOKUP_ROWS, LOOKUP_DIM, generator=gen)
    lids = torch.randint(0, LOOKUP_ROWS, (batch, 8), generator=gen)
    got = make_sharded_lookup(mesh)(table.to(device), lids.to(device))
    out["lookup_equal"] = bool(torch.equal(got.cpu(), table[lids]))
    return out


def shard_ranks_phase(tmp, queries, gt, merged, device, *, k=K, eps=EPS,
                      batch=BATCH, rank_fn=None) -> dict:
    """11c: four gloo ranks on one device (the debug mesh), each running
    ``rank_fn`` (``shard_rank``); every rank's output held equal to every
    other's and checked as the module docstring says.  Returns the
    measurements and the ranks' launches by kernel."""
    from repro_torch.configs.deg import QUANT_PRESETS
    from repro_torch.core.distances import exact_knn_batched
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.launch.ranks import spawn_ranks

    pq = QUANT_PRESETS["pq-compact"]
    cfg = dict(device=str(device), mesh=MESH, k=k, eps=eps, batch=batch,
               sq8_rerank=QUANT_PRESETS["sq8-serving"].rerank_k,
               pq_rerank=pq.rerank_k, pq_eps=pq.eps,
               n_exclude=N_EXPLORE_EXCLUDE)
    world = math.prod(MESH)
    t0 = time.perf_counter()
    res = spawn_ranks(rank_fn or shard_rank, world, (tmp, cfg),
                      backend="gloo", timeout_s=RANK_TIMEOUT_S)
    secs = time.perf_counter() - t0
    res.sort(key=lambda r: r["index"])
    r0 = res[0]
    log(f"phase11c {world} ranks (gloo, mesh {MESH} on {device}) in "
        f"{secs:.1f} s (timeout {RANK_TIMEOUT_S} s); groups "
        f"{r0['backends']}")
    if set(r0["backends"].values()) != {"gloo"}:
        raise AssertionError(f"phase11c: groups {r0['backends']}, want "
                             "gloo")
    tags = ("float32", "float32_drop", "sq8", "sq8_restored", "pq",
            "explore")
    for r in res[1:]:
        for tag in tags + ("brute",):
            for a, b in zip(r[tag], r0[tag]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"phase11c: rank {r['index']}'s "
                                         f"{tag} differs from rank 0's")
        if not np.array_equal(r["psum"][1], r0["psum"][1]):
            raise AssertionError("phase11c: compressed_psum differs between "
                                 "ranks")
    launches = {}
    for r in res:
        for tag in tags:
            got, calls = r["launches"][tag], r["calls"][tag]
            expect_launches("beam_search", got["beam_search"], calls,
                            f"local searches (rank {r['index']} {tag})")
            for name in HOP_KERNELS:
                expect_launches(name, got[name], 0,
                                f"rank {r['index']} {tag}")
            for name, v in got.items():
                launches[name] = launches.get(name, 0) + v
        sm = "; ".join(f"{tag} " + ", ".join(
            f"{s} {v:.3f}" for s, v in r["stage_ms"][tag].items())
            for tag in tags)
        log(f"  rank {r['index']}: ms a batch: {sm}")
    ids, dists = r0["float32"]
    want_ids, want_d = (t.cpu().numpy() for t in merged)
    if not (np.array_equal(ids, want_ids) and np.array_equal(dists, want_d)):
        raise AssertionError("phase11c: the float32 sharded search differs "
                             "from each shard's range_search + the stable "
                             "merge")
    rec = recall_at_k(ids, gt)
    log(f"phase11c float32: ids and dists equal to the composed search; "
        f"recall@{k} {rec:.4f}; {r0['calls']['float32']} batches in "
        f"{r0['wall_s']['float32']:.3f} s on rank 0")
    if rec < RECALL_FLOOR:
        raise AssertionError(f"phase11c recall@{k} {rec:.4f} < "
                             f"{RECALL_FLOOR}")
    data = _shards_file(tmp)
    base = data["base"]
    n_pq = int(data["stacked"]["pq"]["n"].sum())
    _, gt_pq = exact_knn_batched(queries, base[:n_pq], k, device=device)
    for tag in ("sq8", "sq8_restored", "pq"):
        ids, dists = r0[tag]
        ok = ids != INVALID
        exact = np.linalg.norm(queries[np.nonzero(ok)[0]] - base[ids[ok]],
                               axis=1)
        np.testing.assert_allclose(dists[ok], exact, rtol=1e-5, atol=1e-6,
                                   err_msg=f"phase11c {tag} rerank")
        rec_q = recall_at_k(ids, gt_pq if tag == "pq" else gt)
        log(f"phase11c {tag}: every returned dist the exact float distance "
            f"(rtol 1e-5), recall@{k} {rec_q:.4f}"
            + (f" against the exact k-NN of its {n_pq} rows"
               if tag == "pq" else ""))
    for name in ("ids", "dists"):
        i = ("ids", "dists").index(name)
        if not np.array_equal(r0["sq8_restored"][i], r0["sq8"][i]):
            raise AssertionError(f"phase11d: the restored sq8 index's {name} "
                                 "differ from the live one's on the ranks")
    drop = r0["float32_drop"][0]
    if not (drop % 2 == 1).all():
        raise AssertionError("phase11c: drop_shard(0) returned an even id")
    ex = r0["explore_exclude"]
    e_ids = r0["explore"][0]
    hit = (e_ids[:, :, None] == ex[:, None, :]) & (e_ids[:, :, None]
                                                   != INVALID)
    if hit.any() or (e_ids == INVALID).any():
        raise AssertionError("phase11c: an exploration lane returned an "
                             "excluded id or fewer than k")
    vals, bids, n_db = r0["brute"]
    brute_s = r0["wall_s"]["brute"]
    d_ref, i_ref = exact_knn_batched(queries, base[:n_db], k, device=device)
    same = float((bids == i_ref).mean())
    diff = bids != i_ref
    ties = np.isclose(np.sqrt(np.maximum(vals[diff], 0)), d_ref[diff],
                      rtol=GT_RTOL, atol=0.0)
    log(f"phase11c sharded_brute_topk (l2, over data x model, {n_db} rows): "
        f"{brute_s:.3f} s on rank 0; ids equal to exact_knn_batched on "
        f"{same:.4%}, {int(diff.sum())} differing slots, {int(ties.sum())} "
        "ties")
    if same < GT_AGREE or not ties.all():
        raise AssertionError("phase11c: sharded_brute_topk disagrees with "
                             "the exact k-NN")
    xs = np.stack([r["psum"][0] for r in res])
    err = np.abs(r0["psum"][1] - xs.sum(0)).max()
    bound = world * np.abs(xs).max() / 127
    log(f"phase11c compressed_psum bit-identical on {world} ranks, max "
        f"error {err:.4g} <= {bound:.4g}; sharded lookup equal to the "
        f"gather: {all(r['lookup_equal'] for r in res)}")
    if err > bound + 1e-6 or not all(r["lookup_equal"] for r in res):
        raise AssertionError("phase11c: compressed_psum or the sharded "
                             "lookup is wrong")
    log(f"phase11c beam_search launches over the ranks: "
        f"{launches.get('beam_search', 0)}")
    return {"secs": secs, "recall": rec, "launches": launches,
            "stage_ms": r0["stage_ms"]}


def _shards_file(tmp) -> dict:
    import torch

    return torch.load(os.path.join(tmp, "shards.pt"), weights_only=False)


def sharded_phase(base, queries, gt, device, count=None, *, k=K, eps=EPS,
                  batch=BATCH, n_host=N_HOST, rank_fn=None) -> dict:
    """Phase 11 (11a, 11b and 11d at world size 1, then 11c's ranks) in a
    temporary directory (removed after).  Returns the measurements; the
    ranks' launches, by kernel, under "launches"."""
    import tempfile

    count = count or _no_count
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shards_") as tmp:
        out = world1_phase(base, queries, gt, device, count, tmp, k=k,
                           eps=eps, batch=batch, n_host=n_host)
        out["ranks"] = shard_ranks_phase(tmp, queries, gt, out.pop("merged"),
                                         device, k=k, eps=eps, batch=batch,
                                         rank_fn=rank_fn)
    out["launches"] = out["ranks"]["launches"]
    log(f"phase11 total {time.perf_counter() - t0:.1f} s")
    return out


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


# ---------------------------------------------------------------------------
# phase 12: recsys training (DIN and DCN-v2) and the bag_lookup_bwd kernel
# ---------------------------------------------------------------------------
def _event_timed(fn, *args):
    """(result, ms between CUDA events recorded around ``fn``): the stream's
    time for the call, gaps where the card waits on the host included."""
    import torch

    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn(*args)
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def _clone_tree(tree, device=None):
    from repro_torch.train import tree as T

    return T.tree_map(
        lambda t: t.detach().to(device or t.device, copy=True), tree)


def train_setup(device, *, reduced=False, batch=None,
                steps=TRAIN_STEPS) -> dict:
    """Per model of RECSYS_ARCHS: the train_batch cell's trainer
    (``launch.train.train_batch_trainer``: the published config or
    ``reduced()``, seeded weights, the MLPerf split, batches of 65,536 or
    ``batch`` from CriteoLikeStream(seed=0)), a copy of its initial
    parameters and optimizer state, and its first ``steps`` batches made
    once (host seconds each)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_batch_trainer

    out = {}
    for name in RECSYS_ARCHS:
        spec = get_arch(name)
        cfg = spec.reduced() if reduced else spec.model
        B = batch or spec.cell("train_batch")["batch"]
        t0 = time.perf_counter()
        step, params, state, batch_fn = train_batch_trainer(
            name, device, seed=0, batch=B, cfg=cfg)
        sync()
        init_s = time.perf_counter() - t0
        init = (_clone_tree(params), _clone_tree(state))
        for s in range(steps):
            batch_fn(s)
        host = [batch_fn.host_s[s] for s in range(steps)]
        log(f"phase12 {name}: B={B}, {cfg.total_rows:,} table rows x "
            f"{cfg.embed_dim}, trainer built in {init_s:.3f} s; {steps} "
            f"batches made on the host, median {np.median(host):.4f} s a "
            f"batch (max {max(host):.4f} s)")
        out[name] = dict(cfg=cfg, B=B, step=step, params=params, state=state,
                         batch_fn=batch_fn, init=init, host_s=host)
    return out


def _close_sums(what: str, got, want, mag=None) -> None:
    """``got`` against ``want`` at BAG_RTOL / BAG_ATOL, plus BAG_ATOL times
    ``mag`` (the sum of the magnitudes each entry adds) where given."""
    import torch

    bound = BAG_RTOL * want.abs() + BAG_ATOL
    if mag is not None:
        bound = bound + BAG_ATOL * mag
    off = (got - want).abs() > bound
    if bool(off.any()):
        raise AssertionError(
            f"{what}: {int(off.sum())} of {off.numel()} entries off, the "
            f"worst by {float(((got - want).abs() - bound).max()):.3g} past "
            f"its bound; largest difference "
            f"{float((got - want).abs().max()):.3g}")


def check_bag_lookup_bwd(table, ids, weights, g, shape: str) -> dict:
    """The backward kernel against its plain version (grad_w at BAG_RTOL /
    BAG_ATOL; grad_table there plus BAG_ATOL times each entry's sum of
    |w| |g|, ``_close_sums``), a second launch bit-identical to the first, and times: the kernel with its sort (``t``), the kernels
    alone on sorted keys (``t_kernels``), the sort alone (``t_sort``), the
    plain version, and F.embedding_bag's forward plus backward as the
    library call.  The bound counts what
    ``analysis/roofline.py::bag_lookup_bwd_costs`` counts."""
    import torch
    import torch.nn.functional as F
    from repro_torch.analysis.roofline import bag_lookup_bwd_costs
    from repro_torch.kernels.bag_lookup import ops

    V, E = table.shape
    B, nf = ids.shape
    valid = ids >= 0
    safe = ids.clamp(0, V - 1)
    w = torch.ones_like(ids, dtype=torch.float32) if weights is None \
        else weights
    w = torch.where(valid, w, 0.0)
    # sum |w| |g| an entry of grad_table: a row named 800,000 times (DIN's
    # Zipf head) sums that many float32 terms, in another order in each
    # version (the plain one by atomics), and keeps the rounding of its
    # terms' scale
    mag = torch.zeros((V, E), dtype=torch.float32, device=table.device)
    mag.index_add_(0, safe.reshape(-1).long(),
                   (w.abs()[..., None] * g.abs()[:, None, :]).reshape(-1, E))
    got = ops.bag_lookup_bwd(table, ids, weights, g)
    want = ops.bag_lookup_bwd(table, ids, weights, g, impl="ref")
    _close_sums("grad_w", got[0], want[0])
    _close_sums("grad_table", got[1], want[1], mag)
    again = ops.bag_lookup_bwd(table, ids, weights, g)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("bag_lookup_bwd: a second launch on the same "
                             "inputs gave other bits")
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    lt = table.detach().clone().requires_grad_()
    lw = w.detach().clone().requires_grad_()

    def library():
        out = F.embedding_bag(safe, lt, mode="sum", per_sample_weights=lw)
        return torch.autograd.grad(out, (lt, lw), g)

    lib_t, lib_w = library()
    _close_sums("F.embedding_bag grad_table", lib_t, want[1], mag)
    _close_sums("F.embedding_bag grad_w", torch.where(valid, lib_w, 0.0),
                want[0])
    order = ops.bwd_order(ids, V)
    t = time_call(lambda: ops.bag_lookup_bwd(table, ids, weights, g),
                  "bag_bwd_")
    t_kernels = time_call(lambda: ops.bag_lookup_bwd(table, ids, weights, g,
                                                     order=order))
    t_sort = time_call(lambda: ops.bwd_order(ids, V))
    tp = time_call(lambda: ops.bag_lookup_bwd(table, ids, weights, g,
                                              impl="ref"))
    tl = time_call(library)
    n_valid = int(valid.sum())
    rows = torch.unique(safe[valid]).numel()
    c = bag_lookup_bwd_costs(B, nf, E, V, n_valid, rows,
                             weighted=weights is not None)
    bms, by = bound_ms(c["hbm_bytes"], c["flops"])
    head = int(torch.bincount(safe[valid].long()).max()) if n_valid else 0
    return dict(name="bag_lookup_bwd", max_abs_err=err, t=t, tp=tp, tl=tl,
                t_kernels=t_kernels, t_sort=t_sort, bound_ms=bms,
                bound_by=by,
                shape=f"{shape}: B={B} F={nf} E={E} V={V}, {n_valid} valid "
                      f"ids, {rows} rows, {head} on the most named row",
                tol=f"rtol {BAG_RTOL:g} atol {BAG_ATOL:g}, grad_table plus "
                    f"{BAG_ATOL:g} x sum |w| |g|; a second launch "
                    "torch.equal")


def bag_bwd_check(tr: dict, device, seed=0) -> dict:
    """bag_lookup_bwd at the shape DIN's train step gives it: the
    train_batch cell's history ids of step 0 (Zipf-skewed, -1 tails) over
    DIN's table, weights in [0, 1) and a normal dL/dout."""
    import torch
    from repro_torch.models import recsys as R

    din = tr["din"]
    ids = R.history_ids(din["cfg"], din["batch_fn"](0)["hist"])
    rng = np.random.default_rng(seed)
    B, nf = ids.shape
    weights = torch.tensor(rng.random((B, nf), dtype=np.float32),
                           device=device)
    g = torch.tensor(rng.normal(size=(B, din["cfg"].embed_dim))
                     .astype(np.float32), device=device)
    r = check_bag_lookup_bwd(din["params"]["table"].detach(), ids, weights,
                             g, "DIN interest train_batch")
    log(f"phase12a bag_lookup_bwd [{r['shape']}] ok ({r['tol']}): "
        + timings(r, "F.embedding_bag fwd+bwd")
        + f"; without the sort {r['t_kernels']['device_ms']:.6f} ms, the "
        f"sort alone {r['t_sort']['device_ms']:.6f} ms "
        f"({r['t_kernels']['timed_by']})")
    return r


def _leaf_diffs(got, want):
    """(path, largest absolute difference, torch.equal) for every leaf of
    ``got`` against ``want``."""
    import torch
    from repro_torch.train import tree as T

    out = []
    for path, a in T.leaves_with_path(got):
        a, b = a.detach(), T.get(want, path).detach()
        d = float((a - b).abs().max()) if a.numel() else 0.0
        out.append((path, d, bool(torch.equal(a, b))))
    return out


def _worst(diffs) -> str:
    """The largest difference of ``_leaf_diffs`` and the leaf it is in."""
    d, path = max(((d, p) for p, d, _ in diffs), default=(0.0, None),
                  key=lambda x: x[0])
    return f"{d:.3g} in {path}" if d else "0"


def _compare_params(what: str, got, want, *, rtol, atol) -> None:
    """Every leaf of ``got`` against ``want`` at rtol / atol.  Logs the
    worst leaf and raises listing every leaf off."""
    import torch
    from repro_torch.train import tree as T

    diffs = _leaf_diffs(got, want)
    bad = [f"{path}: max diff {d:.3g}" for path, d, _ in diffs
           if not torch.allclose(T.get(got, path).detach(),
                                 T.get(want, path).detach(),
                                 rtol=rtol, atol=atol)]
    log(f"  {what}: largest difference {_worst(diffs)}")
    if bad:
        raise AssertionError(f"{what}: " + "; ".join(bad))


def chain_readings(name: str, r: dict, kept, steps: int) -> dict:
    """Phase 12b's reading of where chains of train steps part.  From the
    model's initial copy, ``steps`` steps again with the kernels, which
    must be torch.equal to ``kept`` (the kernel run's parameters and state
    after as many steps, held on the host); then twice through the plain
    versions.  Logs and returns the largest difference of the plain chains
    against each other and of one of them against the kernel chain: if
    the plain versions add in a new order each run, their own two chains
    part as far as they part from the kernels."""
    from repro_torch.train import tree as T

    kept = T.tree_map(lambda t: t.to(r["init"][0]["table"].device), kept)

    def chain(plain: bool):
        p, s = _clone_tree(r["init"][0]), _clone_tree(r["init"][1])
        with plain_kernels() if plain else contextlib.nullcontext():
            for i in range(steps):
                (p, s), _ = r["step"](p, s, r["batch_fn"](i))
        sync()
        return {"params": p, "opt": s}

    off = [(p, d) for p, d, eq in _leaf_diffs(chain(False), kept) if not eq]
    if off:
        raise AssertionError(f"phase12b {name}: a second kernel chain of "
                             f"{steps} steps differs from the first: {off}")
    a = chain(True)
    plain_plain = _leaf_diffs(a, chain(True))
    plain_kernel = _leaf_diffs(a, kept)
    log(f"phase12b {name} chains of {steps} steps from the initial weights: "
        f"kernels twice torch.equal; plain twice, largest difference "
        f"{_worst(plain_plain)}; plain vs kernels {_worst(plain_kernel)}")
    return {k: max((d for _, d, _ in v), default=0.0) for k, v in
            (("plain_plain", plain_plain), ("plain_kernel", plain_kernel))}


def _plain_step(what: str, step, before, batch, loss: float, after) -> None:
    """One train step through the plain versions from ``before`` (the
    kernel run's parameters and state ahead of its step on ``batch``): the
    loss within BAG_RTOL / BAG_ATOL of the kernel step's ``loss``, the
    parameters after it at TRAIN_PARAM_RTOL / BAG_ATOL of ``after``."""
    p0, s0 = before
    with plain_kernels():
        (p0, s0), m = step(p0, s0, batch)
    pl = float(m["loss"])
    if not math.isclose(pl, loss, rel_tol=BAG_RTOL, abs_tol=BAG_ATOL):
        raise AssertionError(f"{what}: loss {loss} with the kernels, {pl} "
                             "plain")
    _compare_params(f"{what} params, kernels vs plain", after, p0,
                    rtol=TRAIN_PARAM_RTOL, atol=BAG_ATOL)


def train_phase(tr: dict, device, count=None, *, steps=TRAIN_STEPS,
                plain_steps=TRAIN_PLAIN_STEPS) -> dict:
    """Phase 12b: each model's first ``steps`` train steps from its seeded
    weights (ms a step between CUDA events, samples/s, the host's batch
    time beside, peak bytes of one step past the comparisons, the idle
    share of one step on a copy, the model flops over the card's float32
    peak), one bag_lookup and one bag_lookup_bwd launch a DIN step and
    none a DCN-v2 step, every loss finite.  Each of the first
    ``plain_steps`` steps runs again through the plain versions from the
    kernel run's parameters and state before it (``_plain_step``): two
    chains of steps may part, and ``chain_readings`` measures how far
    once every model has run its steps.  Returns each model's final parameters and state (the 12-step run 12c
    resumes against)."""
    import torch
    from repro_torch.analysis import roofline
    from repro_torch.kernels.bag_lookup import ops as bag_ops

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    torch.backends.cuda.matmul.allow_tf32 = False
    peak_step = min(plain_steps, steps - 1)
    out, keeps = {}, {}
    for name in RECSYS_ARCHS:
        r = tr[name]
        step, batch_fn, cfg, B = r["step"], r["batch_fn"], r["cfg"], r["B"]
        params, state = r["params"], r["state"]
        want = int(name == "din")
        losses, ms, walls, peak = [], [], [], None
        for s in range(steps):
            b = batch_fn(s)
            before = (_clone_tree(params), _clone_tree(state)) \
                if s < plain_steps else None
            if s == peak_step:
                peak_memory(reset=True)
            t0 = time.perf_counter()
            ((params, state), m), dev_ms = _event_timed(
                count, step, params, state, b)
            loss = float(m["loss"])
            walls.append((time.perf_counter() - t0) * 1e3)
            if s == peak_step:
                peak = peak_memory()
            expect_launches("bag_lookup", bag_ops.launches, want,
                            f"{name} train step")
            expect_launches("bag_lookup_bwd", bag_ops.launches_bwd, want,
                            f"{name} train step")
            if not math.isfinite(loss):
                raise AssertionError(f"{name} step {s}: loss {loss}")
            losses.append(loss)
            ms.append(dev_ms)
            if before is not None:
                _plain_step(f"phase12b {name} step {s}", step, before, b,
                            loss, params)
                del before
            if s == plain_steps - 1:
                # on the host: it takes no room from a peak step's window
                keeps[name] = {"params": _clone_tree(params, "cpu"),
                               "opt": _clone_tree(state, "cpu")}
        steady = ms[1:] or ms
        med = float(np.median(steady))
        flops = roofline.recsys_model_flops(cfg, "recsys_train", B)
        host = float(np.median(r["host_s"]))
        log(f"phase12b {name}: steps 0-{plain_steps - 1} each again through "
            f"the plain versions from the same state: losses rtol "
            f"{BAG_RTOL:g}, params rtol {TRAIN_PARAM_RTOL:g} atol "
            f"{BAG_ATOL:g}")
        log(f"phase12b {name} train: losses {[round(x, 6) for x in losses]}")
        log(f"phase12b {name} train: step 0 {ms[0]:.3f} ms, steps 1-"
            f"{steps - 1} {_ms_summary(steady)} a step (CUDA events), "
            f"{B / med * 1e3:,.1f} samples/s; wall {_ms_summary(walls)}; "
            f"host batch {host:.4f} s, {host * 1e3 / med:.1f} x the device "
            f"step; peak memory of step {peak_step} "
            f"{peak if peak is None else f'{peak:,}'} bytes; "
            f"{flops / 1e9:.1f} GFLOP a step, "
            f"{flops / roofline.PEAK_FLOPS * 1e3:.3f} ms at the float32 "
            f"peak ({flops / roofline.PEAK_FLOPS * 1e3 / med:.4f} of it)")
        p2, s2 = _clone_tree(params), _clone_tree(state)
        idle_share(lambda: step(p2, s2, batch_fn(0)), med,
                   f"one {name} train step")
        del p2, s2
        out[name] = dict(params=params, state=state, losses=losses, ms=ms,
                         step_ms=med, samples_s=B / med * 1e3, peak=peak,
                         host_s=host, flops=flops, chains=None)
    # after every model's peak step, so no chain's tensors reach its window
    for name, kept in keeps.items():
        out[name]["chains"] = chain_readings(name, tr[name], kept,
                                             plain_steps)
    return out


def loop_phase(tr: dict, trained: dict, tmp, count=None, *,
               steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
               fail_at=TRAIN_FAIL_AT) -> dict:
    """Phase 12c: DIN through ``train_loop`` from its initial copy with a
    checkpoint every ``ckpt_every`` steps and an injected failure after
    step ``fail_at``; a second loop from a fresh copy resumes from the last
    checkpoint and runs to ``steps``, and its final parameters and state
    must be torch.equal to 12b's uninterrupted run.  Then DCN-v2's whole
    train state after 12b (its 2.16 GB table at full width) saved and
    restored, torch.equal, with seconds and bytes."""
    import shutil

    import torch
    from repro_torch.kernels.bag_lookup import ops as bag_ops
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import tree as T
    from repro_torch.train.loop import InjectedFailure, LoopConfig, train_loop

    count = count or (lambda fn, *a, **kw: fn(*a, **kw))
    r = tr["din"]
    d = os.path.join(tmp, "din")
    cfg = LoopConfig(total_steps=steps, ckpt_dir=d, ckpt_every=ckpt_every,
                     log_every=0)
    p, s = _clone_tree(r["init"][0]), _clone_tree(r["init"][1])
    t0 = time.perf_counter()
    try:
        count(train_loop, r["step"], p, s, r["batch_fn"],
              dataclasses.replace(cfg, fail_at=fail_at), log=log)
    except InjectedFailure as exc:
        log(f"phase12c din: {exc}")
    else:
        raise AssertionError("train_loop ran past its injected failure")
    failed_s = time.perf_counter() - t0
    for kernel in ("bag_lookup", "bag_lookup_bwd"):
        expect_launches(kernel, getattr(bag_ops, "launches" if kernel ==
                                        "bag_lookup" else "launches_bwd"),
                        fail_at + 1, "din loop steps before the failure")
    latest = ckpt.latest_step(d)
    if latest != fail_at // ckpt_every * ckpt_every:
        raise AssertionError(f"latest checkpoint {latest}")
    p, s = _clone_tree(r["init"][0]), _clone_tree(r["init"][1])
    t0 = time.perf_counter()
    (p, s), hist = count(train_loop, r["step"], p, s, r["batch_fn"], cfg,
                         log=log)
    resumed_s = time.perf_counter() - t0
    for kernel in ("bag_lookup", "bag_lookup_bwd"):
        expect_launches(kernel, getattr(bag_ops, "launches" if kernel ==
                                        "bag_lookup" else "launches_bwd"),
                        steps - latest - 1, "din loop steps after the resume")
    if [h["step"] for h in hist] != list(range(latest + 1, steps)):
        raise AssertionError(f"resumed steps {[h['step'] for h in hist]}")
    ref = trained["din"]
    diff = []
    for tag, got, want in (("params", p, ref["params"]),
                           ("opt", s, ref["state"])):
        for path, a in T.leaves_with_path(got):
            b = T.get(want, path)
            if not torch.equal(a, b):
                diff.append(((tag,) + path,
                             float((a.detach() - b.detach()).abs().max())))
    if diff:
        raise AssertionError(f"the resumed run differs from the "
                             f"uninterrupted one: {diff}")
    log(f"phase12c din train_loop: failure after step {fail_at} "
        f"({failed_s:.2f} s), resumed from step {latest}, steps "
        f"{latest + 1}-{steps - 1} in {resumed_s:.2f} s; final parameters "
        "and optimizer state torch.equal to the uninterrupted run; losses "
        f"{[round(h['loss'], 6) for h in hist]}")
    dcn = trained["dcn-v2"]
    state = {"params": dcn["params"], "opt": dcn["state"]}
    d2 = os.path.join(tmp, "dcn")
    t0 = time.perf_counter()
    path = ckpt.save(d2, steps - 1, state, keep=1)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    t0 = time.perf_counter()
    back, manifest = ckpt.restore_latest(d2, state)
    sync()
    restore_s = time.perf_counter() - t0
    for (path_, a), (_, b) in zip(T.leaves_with_path(state),
                                  T.leaves_with_path(back)):
        if a.dtype != b.dtype or a.device != b.device or \
                not torch.equal(a, b):
            raise AssertionError(f"dcn-v2 checkpoint: {path_} differs")
    del back
    shutil.rmtree(d2)
    log(f"phase12c dcn-v2 checkpoint: {len(manifest['leaves'])} leaves, "
        f"{nbytes:,} bytes saved in {save_s:.2f} s, restored to the card "
        f"in {restore_s:.2f} s, every leaf torch.equal")
    return dict(resumed_s=resumed_s, save_s=save_s, restore_s=restore_s,
                ckpt_bytes=nbytes)


def train_launcher_phase(device, tmp, tag="phase12d", **kw) -> dict:
    """Phase 12d (13d with LAUNCH_LM): ``python -m repro_torch.launch.train
    --arch din`` (the reduced config, batches of LAUNCH_TRAIN["batch"]) as
    a subprocess with a checkpoint directory and ``--fail-at``: it must
    exit non-zero with the injected failure; the rerun must resume from a
    checkpoint and print a final loss below its first."""
    a = dict(LAUNCH_TRAIN, **kw)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           a["arch"], "--steps", str(a["steps"]), "--batch", str(a["batch"]),
           "--ckpt-dir", os.path.join(tmp, "launcher"), "--device", device]
    for key in ("seq", "ckpt_every"):
        if key in a:
            cmd += [f"--{key.replace('_', '-')}", str(a[key])]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    t0 = time.perf_counter()
    first = subprocess.run(cmd + ["--fail-at", str(a["fail_at"])],
                           capture_output=True, text=True, timeout=600,
                           cwd=ROOT, env=env)
    if first.returncode == 0 or "InjectedFailure" not in first.stderr:
        raise AssertionError(f"launch.train --fail-at exited "
                             f"{first.returncode}: {first.stderr[-2000:]}")
    second = subprocess.run(cmd, capture_output=True, text=True,
                            timeout=600, cwd=ROOT, env=env)
    secs = time.perf_counter() - t0
    lines = second.stdout.splitlines()
    resumed = [ln for ln in lines if ln.startswith("[loop] resumed from")]
    final = [ln for ln in lines if ln.startswith("final loss:")]
    if second.returncode != 0 or not resumed or not final:
        raise AssertionError(f"launch.train rerun exited "
                             f"{second.returncode}: {second.stdout[-2000:]}"
                             f"{second.stderr[-2000:]}")
    last, first_loss = (float(x) for x in re.search(
        r"final loss: ([0-9.]+) \(first: ([0-9.]+)\)", final[-1]).groups())
    if not last < first_loss:
        raise AssertionError(f"launch.train: {final[-1]}")
    log(f"{tag} launch.train --arch {a['arch']} subprocesses: the first "
        f"exited "
        f"{first.returncode} on its injected failure; the rerun "
        f"{resumed[-1][7:]}, {final[-1]} ({secs:.1f} s for both)")
    return dict(seconds=secs, final=last, first=first_loss)


def training_phase(device, count=None, *, reduced=False, batch=None,
                   **launcher) -> dict:
    """Phase 12 (12a-12d) in a temporary directory (removed after).
    Returns the bag_lookup_bwd row of 12a and each piece's numbers."""
    import tempfile

    tr = train_setup(device, reduced=reduced, batch=batch)
    bwd = bag_bwd_check(tr, device)
    trained = train_phase(tr, device, count)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        loop = loop_phase(tr, trained, tmp, count)
        launch = train_launcher_phase(device, tmp, **launcher)
    return dict(bwd=bwd, trained={k: {kk: v for kk, v in r.items()
                                      if kk not in ("params", "state")}
                                  for k, r in trained.items()},
                loop=loop, launcher=launch)


# ---------------------------------------------------------------------------
# phase 13: LM serving (gemma3-12b, qwen3-moe-30b-a3b) and the reduced LMs
# ---------------------------------------------------------------------------
def lm_setup(arch: str, device, *, layers=None, cfg=None, seed=0) -> dict:
    """The published config of ``arch`` (or ``cfg``), cut to ``layers``
    layers where given, and its model from ``init_params`` with a
    torch.Generator on ``device`` seeded ``seed``: init seconds, the bytes
    allocated after it, and the parameters' own bytes, which must be 4 x
    ``param_count`` (float32, nothing else held)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as TT

    cfg = cfg or get_arch(arch).model
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    model = TT.init_params(cfg, gen, device)
    sync()
    init_s = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if nbytes != 4 * cfg.param_count:
        raise AssertionError(f"{arch}: {nbytes:,} parameter bytes for "
                             f"{cfg.param_count:,} parameters")
    alloc = torch.cuda.memory_allocated() if str(device).startswith("cuda") \
        else None
    log(f"phase13 {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab:,}; {cfg.param_count:,} "
        f"parameters ({cfg.active_param_count:,} active), {nbytes:,} "
        f"bytes initialised in {init_s:.3f} s; memory_allocated "
        f"{alloc if alloc is None else f'{alloc:,}'}")
    return dict(arch=arch, cfg=cfg, model=model, init_s=init_s,
                param_bytes=nbytes, allocated=alloc)


def lm_tokens(cfg, B: int, S: int, device, seed=0):
    rng = np.random.default_rng(seed)
    import torch

    return torch.tensor(rng.integers(0, cfg.vocab, (B, S)), dtype=torch.int32,
                        device=device)


def lm_serve_phase(lm: dict, B: int, S: int, device, *, steps=LM_DECODE,
                   seed=0) -> dict:
    """13a / 13b: one prefill of B x S seeded tokens into a cache of
    ``S + steps`` slots (seconds, tokens/s, the model flops over seconds x
    the bfloat16 peak), then ``steps`` greedy decode steps (ms a step by
    CUDA events, median, beside the bytes bound: the float32 parameters
    and the cache read once over the HBM rate; wall ms too); peak bytes;
    the idle share of one decode step (the last one again, on the same
    slot: it writes the values it wrote).  Every logit must be finite and
    ``pos`` end at S + steps."""
    import torch
    from repro_torch.analysis import roofline
    from repro_torch.models import transformer as TT

    model, cfg = lm["model"], lm["cfg"]
    toks = lm_tokens(cfg, B, S, device, seed)
    # a warm-up prefill past one query chunk: the process's first launches
    # load their kernels and cuBLAS's
    warm = min(S, cfg.q_chunk + 1)
    _, warm_ms = _timed(TT.serve_prefill, model, toks[:, :warm])
    peak_memory(reset=True)
    (logits, cache), prefill_ms = _timed(TT.serve_prefill, model, toks,
                                         S + steps)
    prefill_s = prefill_ms / 1e3
    finite = torch.isfinite(logits).all()
    ms, walls = [], []
    tok = torch.argmax(logits, dim=-1, keepdim=True)
    for _ in range(steps):
        last = (tok, cache["pos"])
        t0 = time.perf_counter()
        (logits, cache), dev_ms = _event_timed(TT.serve_decode_step, model,
                                               cache, tok)
        walls.append((time.perf_counter() - t0) * 1e3)
        ms.append(dev_ms)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1, keepdim=True)
    peak = peak_memory()
    if not bool(finite):
        raise AssertionError(f"{lm['arch']}: a non-finite logit")
    if cache["pos"] != S + steps:
        raise AssertionError(f"{lm['arch']}: pos {cache['pos']}")
    flops = roofline.lm_model_flops(cfg, "prefill", B, S)
    mfu = flops / (prefill_s * roofline.PEAK_FLOPS_BF16)
    kv = sum(t.numel() * t.element_size() for t in cache["k"] + cache["v"])
    bms, by = bound_ms(lm["param_bytes"] + kv, 0.0)
    med = float(np.median(ms[1:] or ms))
    log(f"phase13 {lm['arch']} prefill B={B} S={S:,}: {prefill_s:.3f} s, "
        f"{B * S / prefill_s:,.1f} tokens/s; {flops / 1e12:.1f} TFLOP, "
        f"{mfu:.4f} of the bfloat16 peak; cache {kv:,} bytes (after a "
        f"warm-up prefill of {B} x {warm:,} tokens, {warm_ms / 1e3:.3f} s)")
    log(f"phase13 {lm['arch']} decode B={B}, {steps} steps to pos "
        f"{cache['pos']:,}: step 0 {ms[0]:.3f} ms, steps 1-{steps - 1} "
        f"{_ms_summary(ms[1:] or ms)} (CUDA events); wall "
        f"{_ms_summary(walls[1:] or walls)}; bound {bms:.3f} ms ({by}: the "
        f"float32 parameters and the cache once), {bms / med:.4f} of it; "
        f"peak memory {peak if peak is None else f'{peak:,}'} bytes")
    tok0, pos0 = last
    idle_share(lambda: TT.serve_decode_step(model, dict(cache, pos=pos0),
                                            tok0),
               float(np.median(walls[1:] or walls)),
               f"one {lm['arch']} decode step")
    del cache, logits
    return dict(prefill_s=prefill_s, warm_s=warm_ms / 1e3,
                tokens_s=B * S / prefill_s, mfu=mfu,
                decode_ms=med, decode_wall_ms=float(np.median(walls)),
                bound_ms=bms, peak=peak, kv_bytes=kv)


def lm_readings(lm: dict, B: int, S: int, device, seed=2) -> dict:
    """Where 13a's and 13b's time goes, by CUDA events around one call each
    (after one call not timed) on seeded inputs at the prefill's shapes:
    one layer's ``gqa_attention`` (B x S queries in chunks of ``q_chunk``,
    the plain float32 score tile of every chunk; a global layer, so the
    whole S x S tile), one chunk's scores by ``f32_bmm``'s route and by
    float32 upcasts, the float32 -> bfloat16 casts of every parameter a
    decode step makes (each layer's weights at each use, and the tied
    head), and for an MoE one layer's ``moe_ffn`` over the B x S tokens
    beside its dispatch alone (the one-hot of the T x K assignments, its
    cumsum and the positions' gather)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe as M
    from repro_torch.models.layers import f32_bmm, gqa_attention

    cfg, model = lm["cfg"], lm["model"]
    g = torch.Generator(device=device).manual_seed(seed)
    dt, Dh = cfg.dtype, cfg.head_dim

    def timed(fn, *args):
        """ms of one call by CUDA events, after one call not timed."""
        fn(*args)
        return _event_timed(fn, *args)[1]

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device).to(dt)

    q = rnd(B, S, cfg.n_heads, Dh)
    k, v = rnd(B, S, cfg.n_kv_heads, Dh), rnd(B, S, cfg.n_kv_heads, Dh)
    pos = torch.arange(S, device=device)
    chunk = min(S, cfg.q_chunk)
    attn_ms = timed(lambda: gqa_attention(
        q, k, v, pos, pos, window=None,
        q_chunk=cfg.q_chunk if S > cfg.q_chunk else None))
    # one chunk's scores, (B * Hkv, rep * chunk, Dh) @ (B * Hkv, Dh, S),
    # by the route f32_bmm takes and by float32 upcasts
    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q[:, :chunk].reshape(B, chunk, cfg.n_kv_heads, rep, Dh) \
        .permute(0, 2, 3, 1, 4).reshape(B * cfg.n_kv_heads, rep * chunk, Dh)
    kt = k.permute(0, 2, 3, 1).reshape(B * cfg.n_kv_heads, Dh, S)
    route_ms = timed(f32_bmm, qg, kt)
    upcast_ms = timed(
        lambda: torch.bmm(qg.to(torch.float32), kt.to(torch.float32)))
    del q, k, v, qg, kt

    def casts():
        for p in model.parameters():
            p.to(dt)
        if cfg.tie_embeddings:
            model.embed.T.to(dt)

    cast_ms = timed(casts)
    out = dict(attention_ms=attn_ms, cast_ms=cast_ms, scores_ms=route_ms,
               scores_upcast_ms=upcast_ms)
    # f32_bmm's choice for these operands (no gradient taken)
    route = ("torch.bmm(out_dtype=float32)" if str(device).startswith("cuda")
             and dt in (torch.bfloat16, torch.float16) else "float32 upcasts")
    line = (f"phase13 {lm['arch']} readings: one layer's gqa_attention over "
            f"{B} x {S:,} queries {attn_ms:.3f} ms (x {cfg.n_layers} layers "
            f"{attn_ms * cfg.n_layers / 1e3:.3f} s); one chunk's scores "
            f"({B * cfg.n_kv_heads} x {rep * chunk} x {Dh} by {Dh} x {S}) "
            f"{route_ms:.3f} ms by f32_bmm's route, {route}, against "
            f"{upcast_ms:.3f} ms by float32 upcasts; the float32 -> bfloat16 "
            f"casts of a decode step {cast_ms:.3f} ms")
    if cfg.moe is not None:
        T, E, K = B * S, cfg.moe.n_experts, cfg.moe.top_k
        lp = {k_: v_[0] for k_, v_ in model.params()["layers"].items()}
        x = rnd(T, cfg.d_model)
        moe_ms = timed(lambda: M.moe_ffn(x, lp, cfg.moe))
        ids = torch.randint(0, E, (T * K,), generator=g, device=device)

        def dispatch():
            pos_all = torch.cumsum(F.one_hot(ids, E).to(torch.int32), dim=0,
                                   dtype=torch.int32) - 1
            return pos_all.gather(1, ids[:, None])

        disp_ms = timed(dispatch)
        out.update(moe_ms=moe_ms, dispatch_ms=disp_ms)
        line += (f"; one layer's moe_ffn over {T:,} tokens {moe_ms:.3f} ms, "
                 f"its dispatch's one-hot cumsum ({T * K:,} x {E}) "
                 f"{disp_ms:.3f} ms of it")
    log(line)
    return out


@contextlib.contextmanager
def recorded_routes():
    """Every MoE dispatch of the port's transformer while the context is
    open: (top-k expert ids sorted, the router logit gap between the K-th
    and (K+1)-th expert) a call, in call order."""
    import torch
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as TT

    calls, orig = [], TT.moe_ffn

    def wrap(x, lp, moe):
        lg = (x @ lp["router"].to(x.dtype)).to(torch.float32)
        _, ids = M.top_k_desc(torch.softmax(lg, -1), moe.top_k)
        top = torch.sort(lg, -1, descending=True).values
        calls.append((torch.sort(ids, -1).values.cpu().numpy(),
                      (top[:, moe.top_k - 1] - top[:, moe.top_k])
                      .cpu().numpy()))
        return orig(x, lp, moe)

    TT.moe_ffn = wrap
    try:
        yield calls
    finally:
        TT.moe_ffn = orig


def routes_apart(a: list, b: list, B: int) -> tuple:
    """Two runs' dispatches, layer for layer (each run's calls of a layer
    in token order, concatenated): the tokens (B, S) routed otherwise in
    any layer and the largest of their two gaps."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} dispatches against {len(b)}")
    other, worst = None, 0.0
    for (ia, ga), (ib, gb) in zip(a, b):
        if ia.shape != ib.shape:
            raise AssertionError(f"dispatch of {ia.shape} against {ib.shape}")
        diff = (ia != ib).any(-1)
        other = diff if other is None else other | diff
        if diff.any():
            worst = max(worst, float(np.maximum(ga, gb)[diff].max()))
    if other is None:
        return None, 0.0
    return other.reshape(B, -1), worst


def _join_layers(L: int, B: int, *runs: list) -> list:
    """Runs over consecutive token spans of B sequences (a forward; or a
    prefill, then decode steps), their dispatches joined layer by layer:
    a layer's calls (one, or one a group of ``moe_groups``) in token order,
    then the runs' spans a sequence after another, so that each layer's
    tokens come sequence-major as (B, positions)."""
    if not runs[0]:
        return []
    out = []
    for i in range(L):
        ids, gaps = [], []
        for r in runs:
            per = len(r) // L
            calls = r[i * per:(i + 1) * per]
            ri = np.concatenate([c[0] for c in calls])
            ids.append(ri.reshape(B, -1, ri.shape[-1]))
            gaps.append(np.concatenate([c[1] for c in calls]).reshape(B, -1))
        out.append((np.concatenate(ids, 1).reshape(-1, ids[0].shape[-1]),
                    np.concatenate(gaps, 1).reshape(-1)))
    return out


def _reached(other, B: int, S: int):
    """Positions (B, S) a token routed otherwise can reach: itself and
    every later position of its sequence."""
    if other is None:
        return np.zeros((B, S), bool)
    return np.cumsum(other.reshape(B, S), axis=1) > 0


def _allclose(what: str, got, want, tol, keep=None) -> float:
    """``got`` against ``want`` (tensors, any devices) at (rtol, atol) over
    the rows ``keep`` (a (B,) or (B, S) mask of their leading dims):
    raises if any entry is off; returns the largest difference kept."""
    import torch

    got = got.detach().to("cpu", torch.float32)
    want = want.detach().to("cpu", torch.float32)
    if keep is not None:
        k = torch.as_tensor(keep)
        got, want = got[k], want[k]
    rtol, atol = tol
    if got.numel() == 0:
        return 0.0
    off = (got - want).abs() > atol + rtol * want.abs()
    if bool(off.any()):
        raise AssertionError(
            f"{what}: {int(off.sum())} of {off.numel()} entries off at rtol "
            f"{rtol:g} atol {atol:g}, largest difference "
            f"{float((got - want).abs().max()):.3g}")
    return float((got - want).abs().max())


def _near_tie_rows(what: str, a: list, b: list, B: int, S: int):
    """The rows (B, S) that no token routed otherwise between two runs'
    dispatches reaches; raises if a token routed otherwise at a router
    gap of ROUTE_TIE or more.  Returns (rows, a note for the log)."""
    other, worst = routes_apart(a, b, B)
    if other is None or not other.any():
        return np.ones((B, S), bool), ""
    if worst >= ROUTE_TIE:
        raise AssertionError(f"{what}: {int(other.sum())} tokens routed "
                             f"otherwise, at router gaps up to {worst:.4g}")
    keep = ~_reached(other, B, S)
    return keep, (f"; {int(other.sum())} tokens routed otherwise at near "
                  f"ties (gaps up to {worst:.4g}), {int((~keep).sum())} "
                  f"rows left out")


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def lm_consistency(lm: dict, device, *, B, S, capacity_factor=None,
                   seed=1) -> dict:
    """13a / 13b: ``forward_train``'s logits at positions S-2 and S-1
    against ``serve_prefill`` of the first S-1 tokens and one
    ``serve_decode_step``, on the same parameters; an MoE at
    ``capacity_factor``.

    float32: the two within LM_TOL["float32"]; the rows a token routed
    otherwise at a near tie reaches are left out (``_near_tie_rows``).
    bfloat16: at 48 (16) layers the bfloat16 model parts from its own
    float32 logits by more than LM_TOL["bfloat16"] (PERF.md §6: by up
    to 0.10 for gemma3-12b and 0.20 for qwen3-moe-30b-a3b, a tenth of the
    logits and more past 2e-2), so the two bfloat16 paths may part by no
    more than the bfloat16 forward parts from the float32 forward; the
    share of logits past LM_TOL["bfloat16"] is logged beside."""
    import torch
    from repro_torch.models import transformer as TT

    params = lm["model"].params()
    toks = lm_tokens(lm["cfg"], B, S, device, seed)
    runs = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        kw = {"dtype": dt}
        if capacity_factor is not None:
            kw["moe"] = dataclasses.replace(lm["cfg"].moe,
                                            capacity_factor=capacity_factor)
        cfg = dataclasses.replace(lm["cfg"], **kw)
        with recorded_routes() as fwd, torch.inference_mode():
            full, _ = TT.forward_train(params, toks, cfg)
            want = full[:, S - 2:].clone()
            del full
        with recorded_routes() as pre:
            lg0, cache = TT.serve_prefill(params, toks[:, :S - 1], S, cfg)
        with recorded_routes() as dec:
            lg1, cache = TT.serve_decode_step(params, cache, toks[:, S - 1:],
                                              cfg)
        del cache
        L = cfg.n_layers
        runs[name] = (want, torch.stack([lg0, lg1], dim=1),
                      _join_layers(L, B, fwd), _join_layers(L, B, pre, dec))
    where = (f"phase13 {lm['arch']} consistency, B={B} S={S:,}"
             + ("" if capacity_factor is None
                else f" at capacity factor {capacity_factor:g}")
             + f", logits at positions {S - 2:,} and {S - 1:,}, "
             "forward_train against serve_prefill + one decode step")
    want, got, rf, rs = runs["float32"]
    keep, note = _near_tie_rows(f"{lm['arch']} float32", rf, rs, B, S)
    d32 = _allclose(f"{lm['arch']} float32 forward vs prefill + decode",
                    got, want, LM_TOL["float32"], keep[:, S - 2:])
    log(f"{where}: float32 largest difference {d32:.3g} (rtol "
        f"{LM_TOL['float32'][0]:g} atol {LM_TOL['float32'][1]:g}){note}")
    want16, got16, rf, rs = runs["bfloat16"]
    d16 = _max_diff(got16, want16)
    own = _max_diff(want16, want)
    rtol, atol = LM_TOL["bfloat16"]
    past = int(((got16.float() - want16.float()).abs()
                > atol + rtol * want16.float().abs()).sum())
    past_own = int(((want16.float() - want).abs()
                    > atol + rtol * want.abs()).sum())
    other, _ = routes_apart(rf, rs, B)
    log(f"{where}: bfloat16 largest difference {d16:.3g}, against the "
        f"bfloat16 forward's own {own:.3g} from the float32 forward; past "
        f"rtol {rtol:g} atol {atol:g}: {past:,} of {got16.numel():,} "
        f"logits (the bfloat16 forward against the float32 one: "
        f"{past_own:,}); tokens routed otherwise between the bfloat16 "
        f"paths: {0 if other is None else int(other.sum())}")
    if not d16 <= own:
        raise AssertionError(
            f"{lm['arch']} bfloat16: forward and prefill + decode part by "
            f"{d16:.3g}, more than the bfloat16 forward parts from the "
            f"float32 one ({own:.3g})")
    return {"float32": d32, "bfloat16": d16, "bfloat16_own": own,
            "bfloat16_past": past}


def _lm_runs(params, cfg, toks, P: int, steps: int):
    """Everything 13c compares, from one device: forward_train's logits and
    aux, the prefill of the first P tokens, ``steps`` decode steps (logits
    and the cache after), embed_sequences; each run's MoE dispatches."""
    import torch
    from repro_torch.models import transformer as TT

    r = {}
    with recorded_routes() as r["fwd_routes"], torch.inference_mode():
        r["logits"], r["aux"] = TT.forward_train(params, toks, cfg)
    with recorded_routes() as pre:
        lg, cache = TT.serve_prefill(params, toks[:, :P], P + steps, cfg)
    dec_logits, decs = [lg], []
    for t in range(P, P + steps):
        with recorded_routes() as d:
            lg, cache = TT.serve_decode_step(params, cache,
                                             toks[:, t:t + 1], cfg)
        decs.append(d)
        dec_logits.append(lg)
    r["serve_logits"] = torch.stack(dec_logits, dim=1)  # (B, 1 + steps, V)
    r["cache"] = cache
    B, L = toks.shape[0], cfg.n_layers
    r["serve_routes"] = _join_layers(L, B, pre, *decs)
    r["fwd_routes"] = _join_layers(L, B, r["fwd_routes"])
    with recorded_routes() as embed:
        r["embed"] = TT.embed_sequences(params, toks, cfg)
    r["embed_routes"] = _join_layers(L, B, embed)
    return r


def lm_reduced_check(arch: str, device, *, dtype: str, moe_groups=1,
                     B=LM_REDUCED["B"], S=LM_REDUCED["S"],
                     P=LM_REDUCED["prompt"], steps=LM_REDUCED["decode"],
                     seed=0) -> dict:
    """13c for one reduced config: the same weights (made on the CPU with
    a torch.Generator seeded ``seed``, copied to ``device``) and seeded
    tokens through both devices; forward_train's logits and aux, the
    prefill of P tokens and ``steps`` decode steps (their logits and the
    cache after, ``pos`` included), embed_sequences; in float32 also
    loss_fn and every gradient (labels the next tokens, the last -1).
    Tolerances LM_REDUCED_TOL; what a token routed otherwise at a near tie
    reaches is left out (``_near_tie_rows``)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as TT
    from repro_torch.train import tree as T

    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dt,
                              moe_groups=moe_groups)
    host = TT.init_params(cfg, torch.Generator().manual_seed(seed),
                          "cpu").params()
    toks = lm_tokens(cfg, B, S, "cpu", seed)
    runs = {dev: _lm_runs(_clone_tree(host, dev), cfg, toks.to(dev), P,
                          steps)
            for dev in ("cpu", device)}
    a, b = runs[device], runs["cpu"]
    tol = LM_REDUCED_TOL[dtype]
    what = f"{arch} {dtype}" + (f" moe_groups={moe_groups}"
                                if moe_groups > 1 else "")
    near = []

    def keep_of(ra, rb, n):
        keep, note = _near_tie_rows(what, ra, rb, B, n)
        if note:
            near.append(int((~keep).sum()))
        return keep

    k = keep_of(a["fwd_routes"], b["fwd_routes"], S)
    diffs = {"logits": _allclose(f"{what} forward logits", a["logits"],
                                 b["logits"], tol, k)}
    if k.all():
        diffs["aux"] = _allclose(f"{what} aux", torch.as_tensor(a["aux"]),
                                 torch.as_tensor(b["aux"]), tol)
    k = keep_of(a["serve_routes"], b["serve_routes"], P + steps)
    diffs["serve_logits"] = _allclose(f"{what} prefill + decode logits",
                                      a["serve_logits"], b["serve_logits"],
                                      tol, k[:, P - 1:])
    if a["cache"]["pos"] != b["cache"]["pos"] or a["cache"]["pos"] != P + steps:
        raise AssertionError(f"{what}: cache pos {a['cache']['pos']}")
    for i in range(cfg.n_layers):
        cl = a["cache"]["k"][i].shape[1]
        if cfg.layer_window(i) is None:
            pos = np.where(np.arange(cl) < P + steps, np.arange(cl), -1)
        else:
            pos = TT._ring_slot_positions(cl, P + steps).numpy()
        kc = k[:, np.clip(pos, 0, None)] | (pos < 0)[None]
        for kv in ("k", "v"):
            diffs[f"{kv}[{i}]"] = _allclose(
                f"{what} cache {kv}[{i}]", a["cache"][kv][i],
                b["cache"][kv][i], tol, kc)
    k = keep_of(a["embed_routes"], b["embed_routes"], S)
    diffs["embed"] = _allclose(f"{what} embed_sequences", a["embed"],
                               b["embed"], tol, k.all(axis=1))
    if dtype == "float32":
        labels = torch.cat([toks[:, 1:], torch.full((B, 1), -1,
                                                    dtype=toks.dtype)], 1)
        grads = {}
        for dev in ("cpu", device):
            views = T.tree_map(lambda p: p.requires_grad_(),
                               _clone_tree(host, dev))
            with torch.enable_grad():
                loss, _ = TT.loss_fn(views, {"tokens": toks.to(dev),
                                             "labels": labels.to(dev)}, cfg)
                g = torch.autograd.grad(loss, T.leaves(views))
            grads[dev] = (loss.detach(), g)
        diffs["loss"] = _allclose(f"{what} loss", grads[device][0],
                                  grads["cpu"][0], tol)
        diffs["grad"] = max(
            _allclose(f"{what} grad {T.key_of(path)}", ga, gb, tol)
            for (path, _), ga, gb in zip(T.leaves_with_path(host),
                                         grads[device][1], grads["cpu"][1]))
    worst = max(diffs.values())
    log(f"phase13c {what}: card vs CPU, forward, prefill + {steps} decode "
        f"steps with the caches, embed_sequences"
        + (", loss and every gradient" if dtype == "float32" else "")
        + f": largest difference {worst:.3g} (rtol {tol[0]:g} atol "
        f"{tol[1]:g})"
        + (f"; rows left out after near-tie routes: {near}" if near else ""))
    return dict(worst=worst, near=near)


def lm_reduced_phase(device) -> list:
    """13c: the five reduced LM configs, card against CPU, in float32 and
    bfloat16, and the reduced qwen3 at moe_groups=2."""
    from repro_torch.configs import get_arch, list_archs

    out = []
    for arch in list_archs():
        if get_arch(arch).family != "lm":
            continue
        for dtype in ("float32", "bfloat16"):
            out.append(lm_reduced_check(arch, device, dtype=dtype))
    for dtype in ("float32", "bfloat16"):
        out.append(lm_reduced_check("qwen3-moe-30b-a3b", device, dtype=dtype,
                                    moe_groups=2))
    return out


def served_phase(spec: dict, device, steps: int = LM_DECODE) -> dict:
    """13a or 13b for one LM_SERVED spec in this process: ``lm_setup`` (the
    published config cut to ``layers``, or its ``reduced()`` one where the
    spec says ``reduced``), ``lm_serve_phase``, ``lm_readings`` and
    ``lm_consistency``; the numbers of each."""
    from repro_torch.configs import get_arch

    cfg = get_arch(spec["arch"]).reduced() if spec.get("reduced") else None
    lm = lm_setup(spec["arch"], device, layers=spec.get("layers"), cfg=cfg)
    r = lm_serve_phase(lm, spec["B"], spec["S"], device, steps=steps)
    r["readings"] = lm_readings(lm, spec["B"], spec["S"], device)
    r["consistency"] = lm_consistency(lm, device, **spec["check"])
    r.update(init_s=lm["init_s"], param_bytes=lm["param_bytes"],
             allocated=lm["allocated"])
    return r


RESULT = "phase13-result "          # the line a served child prints last


def served_in_child(spec: dict, device, steps: int = LM_DECODE) -> dict:
    """``served_phase`` in a process of its own (``python -c``), its log
    relayed line by line: a fresh CUDA context.  In one process, after
    phases 2-12 and gemma3-12b's 13a, the caching allocator kept the 76 GiB
    it had reserved through ``empty_cache()``, and qwen3's first 12 GiB
    expert stack found 0.7 GiB free (NVIDIA H100 80GB HBM3, PERF.md §6)."""
    code = ("import json, chip_smoke as cs; "
            f"r = cs.served_phase(json.loads({json.dumps(json.dumps(spec))}), "
            f"{device!r}, {steps}); print(cs.RESULT + json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900, cwd=ROOT, env=env)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(RESULT):
            result = json.loads(line[len(RESULT):])
        else:
            log(line)
    if proc.returncode != 0 or result is None:
        raise AssertionError(f"phase13 {spec['arch']} exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    return result


def lm_phase(device, *, served=LM_SERVED, steps=LM_DECODE, launcher=None,
             tmp=None) -> dict:
    """Phase 13 (13a-13d): each LM_SERVED model at its published width in
    a process of its own (``served_in_child``), one after the other; the
    reduced configs card against CPU; the launcher on the reduced qwen3
    (LAUNCH_LM, or ``launcher``) failing and resuming."""
    import tempfile

    out = {spec["arch"]: served_in_child(spec, device, steps)
           for spec in served}
    out["reduced"] = lm_reduced_phase(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as t:
        out["launcher"] = train_launcher_phase(
            device, tmp or t, tag="phase13d", **(launcher or LAUNCH_LM))
    return out


# ---------------------------------------------------------------------------
# phase 14: the EGNN family (minibatch_lg training, full_graph_sm and
# molecule, determinism and resume, the halo loss, ogb_products' forward)
# ---------------------------------------------------------------------------
def power_law_on_device(n: int, avg_degree: int, device, *, seed=0,
                        n_edges=None, alpha=1.6):
    """``data.graphs.random_power_law_graph``'s distribution drawn on
    ``device`` with torch (the numpy generator takes about a minute on the
    host at minibatch_lg's 114.6 M edges): Pareto(alpha) weights,
    ``n * avg_degree`` sources drawn by them (the inverse of their CDF),
    uniform destinations, self-loops dropped, the first ``n_edges`` kept
    where given, sorted by source with a stable sort.  Returns
    (GraphTensors, the sorted sources int64)."""
    import torch
    from repro_torch.data.graphs import GraphTensors

    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    w = (1.0 - u).pow_(-1.0 / alpha)          # numpy's pareto(alpha) + 1
    cdf = torch.cumsum(w / w.sum(), 0)
    del u, w
    m = n * avg_degree
    src = torch.searchsorted(cdf, torch.rand(m, generator=gen, device=device,
                                             dtype=torch.float64),
                             right=True).clamp_(max=n - 1)
    dst = torch.randint(0, n, (m,), generator=gen, device=device)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    del keep, cdf
    if n_edges is not None:
        if src.shape[0] < n_edges:
            raise AssertionError(f"{src.shape[0]:,} edges drawn for "
                                 f"{n_edges:,}")
        src, dst = src[:n_edges], dst[:n_edges]
    src, order = torch.sort(src, stable=True)
    col = dst[order].to(torch.int32)
    del dst, order
    deg = torch.bincount(src, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=row_ptr[1:])
    return GraphTensors(row_ptr=row_ptr, col_idx=col, deg=deg,
                        n_nodes=n), src


def _bytes(n) -> str:
    return "not measured" if n is None else f"{n:,} bytes"


def gnn_minibatch_setup(device, *, n_nodes=None, avg_degree=REDDIT_DEGREE,
                        batch_nodes=None, fanouts=None, seed=0) -> dict:
    """14a's set-up: minibatch_lg's graph (``power_law_on_device`` at
    Reddit's nodes and ``avg_degree``, or ``n_nodes``), normal features of
    the cell's width, uniform labels of its classes and normal
    coordinates on the card, and ``launch.train.gnn_trainer`` for the
    cell's config under ``adamw(1e-3)`` (as the JAX package's
    ``_egnn_train_full`` sets it) at its batch and fanouts."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import gnn_trainer
    from repro_torch.train.optimizer import adamw

    spec = get_arch("egnn")
    cell = spec.cell("minibatch_lg")
    cfg = spec.model_for("minibatch_lg")
    n = n_nodes or cell["n_nodes"]
    B = batch_nodes or cell["batch_nodes"]
    fanouts = tuple(fanouts or cell["fanouts"])
    t0 = time.perf_counter()
    g, src = power_law_on_device(n, avg_degree, device, seed=seed)
    del src
    sync()
    graph_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    feats = torch.randn(n, cfg.d_feat, generator=gen, device=device)
    labels = torch.randint(0, cfg.n_classes, (n,), generator=gen,
                           device=device, dtype=torch.int32)
    coords = torch.randn(n, 3, generator=gen, device=device)
    step, params, state, batch_fn = gnn_trainer(
        cfg, adamw(1e-3), g, feats, labels, coords, B, fanouts, seed)
    sync()
    log(f"phase14a minibatch_lg graph: {n:,} nodes, {g.n_edges:,} edges "
        f"(largest out-degree {int(g.deg.max()):,}) drawn on the card in "
        f"{graph_s:.3f} s; col_idx {g.col_idx.numel() * 4:,} bytes, "
        f"features {feats.numel() * 4:,} bytes ({n:,} x {cfg.d_feat}), "
        f"{cfg.n_classes} classes; batch {B} seeds at fanouts {fanouts}")
    return dict(cfg=cfg, graph=g, B=B, fanouts=fanouts, step=step,
                params=params, state=state, batch_fn=batch_fn,
                init=(_clone_tree(params), _clone_tree(state)),
                graph_s=graph_s, n_edges=g.n_edges)


def gnn_train_phase(tr: dict, device, *, steps=GNN_STEPS) -> dict:
    """14a: the sampler alone and a whole batch (sampler and gathers) by
    CUDA events; ``steps`` train steps (ms a step by CUDA events, the
    median of steps 1 on, seeds/s, peak bytes of step 1, the idle share
    of one step on a copy, the model flops over the float32 peak), every
    loss finite.  Keeps the final parameters and state in ``tr``."""
    import torch
    from repro_torch.analysis import roofline
    from repro_torch.data.graphs import sample_neighbors, subgraph_shapes

    g, B, fanouts, cfg = tr["graph"], tr["B"], tr["fanouts"], tr["cfg"]
    n_sub, e_sub = subgraph_shapes(B, fanouts)
    seeds = torch.randint(0, g.n_nodes, (B,), device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(99))

    def sample():
        gen = torch.Generator(device=device).manual_seed(0)
        return sample_neighbors(g.row_ptr, g.col_idx, g.deg, seeds, gen,
                                fanouts)

    nodes, edges = sample()
    if tuple(nodes.shape) != (n_sub,) or tuple(edges.shape) != (2, e_sub):
        raise AssertionError(f"phase14a: subgraph {tuple(nodes.shape)} "
                             f"{tuple(edges.shape)}, want {n_sub} / {e_sub}")
    sampler_ms = float(np.median([_event_timed(sample)[1]
                                  for _ in range(5)]))
    batch_ms = float(np.median([_event_timed(tr["batch_fn"], s)[1]
                                for s in range(3)]))
    step, params, state = tr["step"], tr["params"], tr["state"]
    losses, ms, peak = [], [], None
    for s in range(steps):
        b = tr["batch_fn"](s)
        if s == 1:
            peak_memory(reset=True)
        ((params, state), m), dev_ms = _event_timed(step, params, state, b)
        if s == 1:
            peak = peak_memory()
        loss = float(m["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"phase14a step {s}: loss {loss}")
        losses.append(loss)
        ms.append(dev_ms)
    tr["params"], tr["state"] = params, state
    steady = ms[1:] or ms
    med = float(np.median(steady))
    flops = roofline.egnn_model_flops(cfg, n_sub, e_sub, True)
    share = flops / roofline.PEAK_FLOPS / (med / 1e3)
    log(f"phase14a sampler: {n_sub:,} nodes and {e_sub:,} edges from {B} "
        f"seeds in {sampler_ms:.3f} ms (CUDA events, median of 5); a "
        f"whole batch with its {n_sub * cfg.d_feat * 4:,}-byte feature "
        f"gather {batch_ms:.3f} ms")
    log(f"phase14a minibatch_lg train: losses "
        f"{[round(x, 6) for x in losses]}")
    log(f"phase14a minibatch_lg train: step 0 {ms[0]:.3f} ms, steps 1-"
        f"{steps - 1} {_ms_summary(steady)} a step (CUDA events), "
        f"{B / med * 1e3:,.1f} seeds/s; peak memory of step 1 "
        f"{_bytes(peak)}; "
        f"{flops / 1e9:.1f} GFLOP a step, "
        f"{flops / roofline.PEAK_FLOPS * 1e3:.3f} ms at the float32 peak "
        f"({share:.4f} of it)")
    p2, s2 = _clone_tree(params), _clone_tree(state)
    b0 = tr["batch_fn"](0)
    idle_share(lambda: step(p2, s2, b0), med,
               "one minibatch_lg train step")
    del p2, s2, b0
    return dict(sampler_ms=sampler_ms, batch_ms=batch_ms, step0_ms=ms[0],
                step_ms=med, seeds_s=B / med * 1e3, peak=peak, flops=flops,
                fp32_share=share, losses=losses, graph_s=tr["graph_s"],
                n_edges=tr["n_edges"])


def gnn_loss_grads(loss, params, batch):
    """(loss, gradients as a list in pytree order) of ``loss(params,
    batch)``, through views of ``params``."""
    import torch
    from repro_torch.train import tree as T

    views = T.tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        value, _ = loss(views, batch)
        grads = torch.autograd.grad(value, T.leaves(views))
    return value.detach(), list(grads)


def gnn_determinism(tr: dict) -> None:
    """14c: one minibatch_lg batch's loss and gradients from the initial
    parameters twice, and one whole step from the same state twice:
    torch.equal."""
    import torch
    from repro_torch.models import egnn as E

    b = tr["batch_fn"](0)
    runs = [gnn_loss_grads(lambda p, x: E.loss_fn(p, x, tr["cfg"]),
                           tr["init"][0], b) for _ in range(2)]
    (l0, g0), (l1, g1) = runs
    if not torch.equal(l0, l1) or not all(
            torch.equal(a, c) for a, c in zip(g0, g1)):
        raise AssertionError("phase14c: two runs of one minibatch_lg "
                             "batch's loss and gradients differ")
    after = []
    for _ in range(2):
        p, s = _clone_tree(tr["init"][0]), _clone_tree(tr["init"][1])
        (p, s), _ = tr["step"](p, s, b)
        after.append({"params": p, "opt": s})
    off = [(p, d) for p, d, eq in _leaf_diffs(after[0], after[1]) if not eq]
    if off:
        raise AssertionError(f"phase14c: two runs of one step differ: {off}")
    log(f"phase14c determinism: one minibatch_lg batch's loss "
        f"({float(l0):.6f}) and {len(g0)} gradient leaves torch.equal over "
        "two runs; one step from the same state torch.equal twice")


def gnn_loop_phase(tr: dict, tmp, *, steps=GNN_STEPS,
                   ckpt_every=GNN_CKPT_EVERY, fail_at=GNN_FAIL_AT) -> dict:
    """14c: ``train_loop`` on minibatch_lg batches from the initial copy,
    a checkpoint every ``ckpt_every`` steps and a failure after step
    ``fail_at``; a second loop from a fresh copy resumes from the last
    checkpoint, and its final parameters and optimizer state must be
    torch.equal to 14a's uninterrupted run."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import InjectedFailure, LoopConfig, train_loop

    d = os.path.join(tmp, "egnn")
    cfg = LoopConfig(total_steps=steps, ckpt_dir=d, ckpt_every=ckpt_every,
                     log_every=0)
    p, s = _clone_tree(tr["init"][0]), _clone_tree(tr["init"][1])
    try:
        train_loop(tr["step"], p, s, tr["batch_fn"],
                   dataclasses.replace(cfg, fail_at=fail_at), log=log)
    except InjectedFailure as exc:
        log(f"phase14c egnn: {exc}")
    else:
        raise AssertionError("train_loop ran past its injected failure")
    latest = ckpt.latest_step(d)
    if latest != fail_at // ckpt_every * ckpt_every:
        raise AssertionError(f"latest checkpoint {latest}")
    p, s = _clone_tree(tr["init"][0]), _clone_tree(tr["init"][1])
    t0 = time.perf_counter()
    (p, s), hist = train_loop(tr["step"], p, s, tr["batch_fn"], cfg, log=log)
    resumed_s = time.perf_counter() - t0
    if [h["step"] for h in hist] != list(range(latest + 1, steps)):
        raise AssertionError(f"resumed steps {[h['step'] for h in hist]}")
    off = [(path, dd) for path, dd, eq in _leaf_diffs(
        {"params": p, "opt": s}, {"params": tr["params"],
                                  "opt": tr["state"]}) if not eq]
    if off:
        raise AssertionError(f"phase14c: the resumed run differs from the "
                             f"uninterrupted one: {off}")
    log(f"phase14c egnn train_loop: failure after step {fail_at}, resumed "
        f"from step {latest}, steps {latest + 1}-{steps - 1} in "
        f"{resumed_s:.2f} s; final parameters and optimizer state "
        "torch.equal to 14a's uninterrupted run")
    return dict(resumed_s=resumed_s, latest=latest)


def full_graph_batch(cfg, device, *, n=None, n_edges=None, k=4,
                     seed=0) -> dict:
    """full_graph_sm's graph as numpy: ``random_geometric_graph`` (k
    neighbours a node, taken on ``device``) at the cell's nodes, its edge
    list cut to the cell's count, normal features of ``cfg.d_feat`` and
    uniform labels of its classes."""
    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import random_geometric_graph

    cell = get_arch("egnn").cell("full_graph_sm")
    n = n or cell["n_nodes"]
    E = n_edges or cell["n_edges"]
    g, coords = random_geometric_graph(n, k, seed=seed, device=device)
    if g.n_edges < E:
        raise AssertionError(f"{g.n_edges} edges for {E}")
    src = np.repeat(np.arange(n, dtype=np.int32), np.diff(g.row_ptr))
    rng = np.random.default_rng(seed)
    return {"feats": rng.normal(size=(n, cfg.d_feat)).astype(np.float32),
            "coords": coords,
            "edges": np.stack([src[:E], g.col_idx[:E]]).astype(np.int32),
            "labels": rng.integers(0, cfg.n_classes, size=n).astype(
                np.int32)}


def molecule_batch(cfg, *, B=None, n=None, e=None, seed=0) -> dict:
    """The molecule cell as numpy: B graphs of n nodes and e random edges,
    normal features and coordinates, one label a graph."""
    from repro_torch.configs import get_arch

    cell = get_arch("egnn").cell("molecule")
    B, n, e = B or cell["batch"], n or cell["n_nodes"], e or cell["n_edges"]
    rng = np.random.default_rng(seed)
    return {"feats": rng.normal(size=(B, n, cfg.d_feat)).astype(np.float32),
            "coords": rng.normal(size=(B, n, 3)).astype(np.float32),
            "edges": rng.integers(0, n, size=(B, 2, e)).astype(np.int32),
            "labels": rng.integers(0, cfg.n_classes, size=B).astype(
                np.int32)}


def _on(batch: dict, device) -> dict:
    import torch

    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def gnn_step_readings(what: str, cfg, batch: dict, device, *,
                      steps=GNN_SMALL_STEPS) -> dict:
    """ms a train step (``adamw(1e-3)``, CUDA events, the median of steps
    1 on) and the peak bytes of step 1, every loss finite."""
    import torch
    from repro_torch.models import egnn as E
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.steps import make_train_step

    opt = adamw(1e-3)
    step = make_train_step(lambda p, b: E.loss_fn(p, b, cfg), opt)
    params = E.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    state = opt.init(params)
    b = _on(batch, device)
    ms, peak = [], None
    for s in range(steps):
        if s == 1:
            peak_memory(reset=True)
        ((params, state), m), dev_ms = _event_timed(step, params, state, b)
        if s == 1:
            peak = peak_memory()
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"phase14b {what} step {s}: loss "
                                 f"{float(m['loss'])}")
        ms.append(dev_ms)
    med = float(np.median(ms[1:] or ms))
    log(f"phase14b {what} train: steps 1-{steps - 1} {_ms_summary(ms[1:])} "
        f"a step (CUDA events), step 0 {ms[0]:.3f} ms; peak memory of step "
        f"1 {_bytes(peak)}")
    return dict(step_ms=med, peak=peak)


def _held(what: str, got, want, tol, bf16_own=None) -> float:
    """``got`` (on the card) against ``want`` (the CPU) at ``tol``; in
    bfloat16 an entry past it still holds while the largest difference is
    no more than ``bf16_own``, the card's bfloat16 result's own distance
    from its float32 one.  Returns the largest difference."""
    import torch

    a, b = got.detach().float().cpu(), want.detach().float().cpu()
    d = float((a - b).abs().max()) if a.numel() else 0.0
    if torch.allclose(a, b, rtol=tol[0], atol=tol[1]):
        return d
    off = int((~torch.isclose(a, b, rtol=tol[0], atol=tol[1])).sum())
    if bf16_own is not None and d <= bf16_own:
        log(f"  {what}: {off} of {a.numel()} entries past {tol}, largest "
            f"difference {d:.3g}, within bfloat16's own {bf16_own:.3g}")
        return d
    raise AssertionError(f"{what}: {off} of {a.numel()} entries past {tol}, "
                         f"largest difference {d:.3g}")


def _gnn_outputs(cfg, params, batch: dict, device) -> dict:
    """The forward's logits and coordinates (batched where the batch is),
    the loss and every gradient, on ``device``."""
    from repro_torch.models import egnn as E
    from repro_torch.train import tree as T

    p = T.tree_map(lambda t: t.to(device), params)
    b = _on(batch, device)
    if b["feats"].ndim == 3:
        logits, x = E.egnn_forward_batched(p, b["feats"], b["coords"],
                                           b["edges"], cfg)
    else:
        logits, x = E.egnn_forward(p, b["feats"], b["coords"], b["edges"],
                                   cfg)
    loss, grads = gnn_loss_grads(lambda q, bb: E.loss_fn(q, bb, cfg), p, b)
    return {"logits": logits.detach(), "coords": x.detach(), "loss": loss,
            "grads": grads}


def gnn_card_vs_cpu(what: str, cfg, batch: dict, device) -> dict:
    """14b: the card against the CPU on the same weights (``init_params``
    from a CPU generator seeded 0) and batch: logits, coordinates, loss
    and every gradient, float32 at GNN_TOL, then bfloat16 at its
    GNN_TOL (or within the card's bfloat16 result's own distance from
    its float32 one).  Returns the largest difference of each."""
    import torch
    from repro_torch.models import egnn as E

    params = E.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out, f32 = {}, None
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=getattr(torch, dt))
        card = _gnn_outputs(c, params, batch, device)
        cpu = _gnn_outputs(c, params, batch, "cpu")
        tol = GNN_TOL[dt]
        worst = {}
        for key in ("logits", "coords", "loss"):
            own = None if f32 is None else float(
                (card[key].float() - f32[key].float()).abs().max())
            worst[key] = _held(f"phase14b {what} {dt} {key}", card[key],
                               cpu[key], tol, own)
        gw = []
        for i, (a, b) in enumerate(zip(card["grads"], cpu["grads"])):
            own = None if f32 is None else float(
                (a - f32["grads"][i]).abs().max())
            gw.append(_held(f"phase14b {what} {dt} grad {i}", a, b, tol,
                            own))
        worst["grads"] = max(gw)
        out[dt] = worst
        if f32 is None:
            f32 = card
    log(f"phase14b {what} card vs CPU ({len(gw)} gradient leaves): "
        + "; ".join(f"{dt} largest differences " + ", ".join(
            f"{k} {v:.3g}" for k, v in w.items()) for dt, w in out.items()))
    return out


def gnn_small_phase(device, *, full=None, molecule=None) -> dict:
    """14b: full_graph_sm (Cora's size, its edge list cut to the cell's
    count) and molecule (128 graphs of 30 nodes through
    ``egnn_forward_batched``) at their widths: ms a step and peak bytes;
    then the card against the CPU at those widths and at ``reduced()``
    on both layouts."""
    from repro_torch.configs import get_arch

    spec = get_arch("egnn")
    fcfg, mcfg = spec.model_for("full_graph_sm"), spec.model_for("molecule")
    rcfg = spec.reduced()
    fb = full_graph_batch(fcfg, device, **(full or {}))
    mb = molecule_batch(mcfg, **(molecule or {}))
    out = {"full_graph_sm": gnn_step_readings("full_graph_sm", fcfg, fb,
                                              device),
           "molecule": gnn_step_readings("molecule", mcfg, mb, device)}
    rb = full_graph_batch(rcfg, device, **(full or {}))
    rmb = molecule_batch(rcfg, **(molecule or {}))
    out["card_vs_cpu"] = {
        "full_graph_sm": gnn_card_vs_cpu("full_graph_sm", fcfg, fb, device),
        "molecule": gnn_card_vs_cpu("molecule", mcfg, mb, device),
        "reduced_node": gnn_card_vs_cpu("reduced() node", rcfg, rb, device),
        "reduced_graph": gnn_card_vs_cpu("reduced() graph", rcfg, rmb,
                                         device)}
    return out


def _halo_batch(batch: dict, shards: int) -> dict:
    from repro_torch.data.graphs import partition_edges_by_dst

    out = dict(batch)
    out["edges"], out["edge_valid"] = partition_edges_by_dst(
        batch["edges"], batch["feats"].shape[0], shards)
    return out


def halo_rank(rank, world, cfg, batch: dict, params: dict, device,
              reps: int) -> dict:
    """One of 14d's ranks: the (2, 2) debug mesh over gloo on ``device``,
    ``make_sharded_loss`` on ``batch`` (host arrays, edges partitioned
    over the ranks) and its gradients; then ``reps`` timed steps (loss and
    backward) and ``reps`` runs of the step's collectives alone (per
    layer an all-gather of h and of x, and their backward all-reduces).
    Returns host arrays and ms."""
    import torch
    from repro_torch.distributed.collectives import all_gather_cat, all_reduce
    from repro_torch.launch.mesh import axis_group, make_mesh
    from repro_torch.models import egnn as E
    from repro_torch.train import tree as T

    def sync_here():                # a spawned rank: not the script's sync
        if device != "cpu":
            torch.cuda.synchronize()

    if device != "cpu":
        torch.cuda.set_device(0)
    mesh = make_mesh(HALO_MESH, ("data", "model"), device)
    ag = axis_group(mesh, ("data", "model"))
    b = _on(batch, device)
    p = T.tree_map(lambda a: torch.tensor(a, device=device), params)
    loss_fn = E.make_sharded_loss(cfg, mesh, ("data", "model"))
    loss, grads = gnn_loss_grads(loss_fn, p, b)
    sync_here()
    t0 = time.perf_counter()
    for _ in range(reps):
        gnn_loss_grads(loss_fn, p, b)
    sync_here()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    n_local = batch["feats"].shape[0] // ag.size
    h = torch.zeros(n_local, cfg.d_hidden, device=device, dtype=cfg.dtype)
    x = torch.zeros(n_local, 3, device=device, dtype=cfg.dtype)
    sum_ = torch.distributed.ReduceOp.SUM
    sync_here()
    t0 = time.perf_counter()
    for _ in range(reps):
        for _ in range(cfg.n_layers):
            for t in (h, x):
                all_reduce(all_gather_cat(t, ag, 0), ag, sum_)
    sync_here()
    gather_ms = (time.perf_counter() - t0) / reps * 1e3
    return {"index": ag.index, "backend": ag.backend,
            "loss": float(loss), "grads": [g.cpu().numpy() for g in grads],
            "step_ms": step_ms, "gather_ms": gather_ms}


def gnn_halo_phase(device, *, full=None, reps=HALO_REPS) -> dict:
    """14d on full_graph_sm at full width, weights from ``init_params``
    (a generator seeded 0 on ``device``): at world size 1 (NCCL on the
    card) ``make_sharded_loss`` on the edges partitioned for one shard
    (their order kept) against ``loss_fn``, loss and every gradient
    torch.equal; then four gloo ranks on the one card (``halo_rank``),
    their losses equal to each other's and, with their gradients, to
    ``loss_fn`` on the card at HALO_TOL; per rank the ms of a step and of
    its collectives alone."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import axis_group, make_mesh
    from repro_torch.launch.ranks import process_group, spawn_ranks
    from repro_torch.models import egnn as E
    from repro_torch.train import tree as T

    cfg = get_arch("egnn").model_for("full_graph_sm")
    base = full_graph_batch(cfg, device, **(full or {}))
    params = E.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    backend = "nccl" if str(device) != "cpu" else "gloo"
    one = _on(_halo_batch(base, 1), device)
    if not torch.equal(one["edges"].cpu(), torch.as_tensor(base["edges"])):
        raise AssertionError("phase14d: the one-shard partition moved edges")
    full_loss = lambda p, b: E.loss_fn(p, b, cfg)       # noqa: E731
    with process_group(backend):
        mesh = make_mesh((1, 1), ("data", "model"), device)
        got = axis_group(mesh, ("data", "model")).backend
        if got != backend:
            raise AssertionError(f"phase14d: group {got}, want {backend}")
        l1, g1 = gnn_loss_grads(
            E.make_sharded_loss(cfg, mesh, ("data", "model")), params, one)
    l0, g0 = gnn_loss_grads(full_loss, params, one)
    if not torch.equal(l1, l0) or not all(
            torch.equal(a, b) for a, b in zip(g1, g0)):
        raise AssertionError("phase14d: the halo loss at world size 1 "
                             "differs from loss_fn")
    log(f"phase14d world size 1 ({backend}): halo loss {float(l1):.6f} and "
        f"{len(g1)} gradient leaves torch.equal to loss_fn's")
    world = math.prod(HALO_MESH)
    four = _halo_batch(base, world)
    want_l, want_g = gnn_loss_grads(full_loss, params, _on(four, device))
    t0 = time.perf_counter()
    res = spawn_ranks(halo_rank, world,
                      (cfg, four, T.tree_map(lambda t: t.cpu().numpy(),
                                             params), str(device), reps),
                      backend="gloo", timeout_s=RANK_TIMEOUT_S)
    secs = time.perf_counter() - t0
    res.sort(key=lambda r: r["index"])
    if {r["backend"] for r in res} != {"gloo"}:
        raise AssertionError(f"phase14d: groups {[r['backend'] for r in res]}")
    worst = 0.0
    for r in res:
        if r["loss"] != res[0]["loss"]:
            raise AssertionError(f"phase14d: rank {r['index']}'s loss "
                                 f"{r['loss']} differs from rank 0's")
        if not math.isclose(r["loss"], float(want_l),
                            rel_tol=HALO_TOL["loss"], abs_tol=0.0):
            raise AssertionError(f"phase14d: rank loss {r['loss']}, "
                                 f"loss_fn {float(want_l)}")
        for i, (a, b) in enumerate(zip(r["grads"], want_g)):
            b = b.cpu().numpy()
            if not np.allclose(a, b, rtol=HALO_TOL["grad"][0],
                               atol=HALO_TOL["grad"][1]):
                raise AssertionError(f"phase14d: rank {r['index']} grad {i} "
                                     f"off by {np.abs(a - b).max():.3g}")
            worst = max(worst, float(np.abs(a - b).max()))
        log(f"  rank {r['index']}: {r['step_ms']:.3f} ms a step (loss and "
            f"backward), {r['gather_ms']:.3f} ms of it in the collectives "
            f"alone, {r['step_ms'] - r['gather_ms']:.3f} ms the rest")
    log(f"phase14d {world} gloo ranks (mesh {HALO_MESH} on {device}) in "
        f"{secs:.1f} s: losses equal, {res[0]['loss']:.6f} against "
        f"loss_fn's {float(want_l):.6f}; gradients within {HALO_TOL['grad']}"
        f", largest difference {worst:.3g}")
    return dict(loss=res[0]["loss"], want=float(want_l), grad_diff=worst,
                ranks_s=secs,
                step_ms=[r["step_ms"] for r in res],
                gather_ms=[r["gather_ms"] for r in res])


def gnn_products_phase(device, *, n_nodes=None, n_edges=None,
                       seed=0) -> dict:
    """14e: ogb_products at its full size, a graph drawn by
    ``power_law_on_device`` cut to the cell's edges, normal features and
    coordinates, weights from ``init_params``; ``egnn_forward`` and
    ``node_embeddings`` under ``torch.inference_mode`` (seconds, peak
    bytes, the model flops over seconds x the float32 peak); every output
    finite, and the decoder over the embeddings torch.equal to the
    logits."""
    import torch
    from repro_torch.analysis import roofline
    from repro_torch.configs import get_arch
    from repro_torch.models import egnn as E
    from repro_torch.models.layers import apply_mlp_tower

    spec = get_arch("egnn")
    cell, cfg = spec.cell("ogb_products"), spec.model_for("ogb_products")
    n, E_ = n_nodes or cell["n_nodes"], n_edges or cell["n_edges"]
    t0 = time.perf_counter()
    g, src = power_law_on_device(n, -(-E_ // n) + 1, device, seed=seed,
                                 n_edges=E_)
    edges = torch.stack([src, g.col_idx.long()])
    del g, src
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    feats = torch.randn(n, cfg.d_feat, generator=gen, device=device)
    coords = torch.randn(n, 3, generator=gen, device=device)
    params = E.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    sync()
    setup_s = time.perf_counter() - t0
    out = {"n_nodes": n, "n_edges": E_, "setup_s": setup_s}
    with torch.inference_mode():
        peak_memory(reset=True)
        t0 = time.perf_counter()
        logits, x = E.egnn_forward(params, feats, coords, edges, cfg)
        sync()
        out["forward_s"] = time.perf_counter() - t0
        out["forward_peak"] = peak_memory()
        _check_finite("phase14e logits", logits)
        _check_finite("phase14e coords", x)
        if tuple(logits.shape) != (n, cfg.n_classes):
            raise AssertionError(f"phase14e logits {tuple(logits.shape)}")
        del x
        peak_memory(reset=True)
        t0 = time.perf_counter()
        emb = E.node_embeddings(params, feats, coords, edges, cfg)
        sync()
        out["embeddings_s"] = time.perf_counter() - t0
        out["embeddings_peak"] = peak_memory()
        _check_finite("phase14e embeddings", emb)
        dec = apply_mlp_tower(params["decoder"], emb, act=E.silu).to(
            torch.float32)
        if not torch.equal(dec, logits):
            raise AssertionError("phase14e: the decoder over node_embeddings "
                                 "differs from egnn_forward's logits")
    flops = roofline.egnn_model_flops(cfg, n, E_, train=False)
    out["flops"] = flops
    out["fp32_share"] = flops / roofline.PEAK_FLOPS / out["forward_s"]
    log(f"phase14e ogb_products: {n:,} nodes, {E_:,} edges, "
        f"{cfg.d_feat} features, {cfg.n_classes} classes; graph, features "
        f"and weights on the card in {setup_s:.3f} s; egnn_forward "
        f"{out['forward_s']:.3f} s (peak memory "
        f"{_bytes(out['forward_peak'])}), node_embeddings "
        f"{out['embeddings_s']:.3f} s (peak {_bytes(out['embeddings_peak'])}"
        f"); {flops / 1e12:.2f} TFLOP a forward, "
        f"{out['fp32_share']:.4f} of the float32 peak; the decoder over the "
        "embeddings torch.equal to the logits")
    return out


def gnn_phase(device, *, minibatch=None, small=None, halo=None,
              products=None, launcher=None, steps=GNN_STEPS) -> dict:
    """Phase 14 (14a-14e) in this process: see the module docstring.  No
    kernel of the port is on this path: every launch counter must read 0
    after it.  Returns the numbers of each piece."""
    import gc
    import tempfile

    import torch

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    ops = launch_counters()
    for m, attr in ops.values():
        setattr(m, attr, 0)
    out = {}
    tr = gnn_minibatch_setup(device, **(minibatch or {}))
    out["14a"] = gnn_train_phase(tr, device, steps=steps)
    gnn_determinism(tr)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gnn_") as tmp:
        out["14c"] = gnn_loop_phase(tr, tmp, steps=steps)
        out["14c"]["launcher"] = train_launcher_phase(
            device, tmp, tag="phase14c", **(launcher or LAUNCH_GNN))
    del tr
    if str(device) != "cpu":
        torch.cuda.empty_cache()
    out["14b"] = gnn_small_phase(device, **(small or {}))
    out["14d"] = gnn_halo_phase(device, **(halo or {}))
    if str(device) != "cpu":
        gc.collect()
        torch.cuda.empty_cache()
    out["14e"] = gnn_products_phase(device, **(products or {}))
    launches = {name: getattr(m, attr) for name, (m, attr) in ops.items()}
    if any(launches.values()):
        raise AssertionError(f"phase14 launched kernels: {launches}")
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase14 done in {out['seconds']:.1f} s; kernel launches "
        f"{launches} (none expected: no kernel is on this path)")
    return out


RESULT14 = "phase14-result "         # the line the phase-14 child prints last


def gnn_in_child(device, **kw) -> dict:
    """``gnn_phase(device, **kw)`` in a process of its own (``python -c``;
    ``kw`` must be JSON), its log relayed line by line: a fresh CUDA
    context, as phase 13's children.  The child's caching allocator maps
    expandable segments: with fixed ones an ogb_products layer's 29.7 GiB
    concatenation found 29.8 GiB reserved but split among the freed
    blocks of the layer before, and failed at 33.5 GiB allocated
    (NVIDIA H100 80GB HBM3, PERF.md §6)."""
    code = ("import json, chip_smoke as cs; "
            f"r = cs.gnn_phase({device!r}, "
            f"**json.loads({json.dumps(json.dumps(kw))})); "
            "print(cs.RESULT14 + json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900, cwd=ROOT, env=env)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(RESULT14):
            result = json.loads(line[len(RESULT14):])
        else:
            log(line)
    if proc.returncode != 0 or result is None:
        raise AssertionError(f"phase14 exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return result


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

    # phase 13 first, in processes of its own, while the card holds
    # nothing: after phase 12 this process kept about 47 GB of the card
    # that empty_cache() did not return (PERF.md §6)
    lm_phase(device)
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 13 done")
    # phase 14 in a process of its own too, while this one holds only the
    # built kernels
    gnn_in_child(device)
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 14 done")

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
    checks["bag_lookup_bwd"] = training_phase(device, count)["bwd"]
    torch.cuda.empty_cache()
    stamp("phase 12")
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
    stamp("phases 9 and 10")
    # the graph of phase 3 and the ground truth of phase 4 still hold
    sharded = sharded_phase(base, queries, served["gt"], device, count)
    for name, n in sharded["launches"].items():
        launches[name] += n
    stamp("phase 11")
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
