"""Serving launcher: ``python -m repro_torch.launch.serve``.

Loads (or builds) a DEG index, then serves a synthetic request trace.
Two front ends:

* ``--engine sync`` (default) — the batched ``QueryEngine`` driven
  closed-loop, mixing fresh ANN queries, exploration sessions, and
  online inserts — the interactive-browsing workload the paper targets
  (§1, §6.7).  Reports QPS and recall.
* ``--engine async`` — the continuous-batching ``AsyncQueryEngine``:
  single-query submits coalesced into bucketed fixed-shape programs
  with per-request deadlines (``--deadline-ms`` / ``--slo``).  Reports
  p50/p99 latency, sustained QPS, recall, and partial/forced-flush
  counts.

``--warmup`` runs one throwaway flush of every (bucket, variant) at boot
and logs its time per bucket (the kernels' builds land there), so a
warm-started snapshot (``--index``) serves its first request at
steady-state latency.

The index lives on the card (``--device cuda``, the default) unless
``--device cpu`` is given; on the card every l2 flush is one
``beam_search`` launch.

Observability (obs/): ``--metrics-port P`` serves the engine registry at
``http://127.0.0.1:P/metrics`` (Prometheus text), ``/metrics.json``, and
``/healthz`` (engine liveness: 503 once the engine is crashed) while the
process runs (``--hold-secs`` keeps it up after the trace for scrapers); ``--stats-every S`` prints a one-line registry
digest every S seconds; ``--trace-sample R`` + ``--query-log PATH``
write the sampled JSONL query log.

Resilience (resilience/, --engine async): ``--max-queue`` bounds
admission (overflow sheds with a typed ``OverloadError`` per
``--shed-policy``), ``--degrade`` arms the adaptive degradation ladder,
``--wal PATH`` journals every index mutation for crash-safe recovery,
and ``--faults SPEC`` installs a deterministic fault plan
(``point:op[=arg][@n]``).  Shed /
invalid / crashed submissions are counted, never silently dropped, and
the run ends with one greppable ``resilience:`` summary line.

Live mutation (--engine async): ``--refine-while-serving N`` runs a
background continuous-refinement writer that republishes a fresh epoch
per tick (at least one tick; after injected damage, the first waits for
the scrubber's first pass), ``--scrub-every S`` runs the online integrity scrubber
(audit / quarantine / repair / re-admit), and ``--inject-corruption K``
seeds adjacency damage the scrubber must heal.  Either flag enables epoch publication: readers serve immutable
published snapshots while writers mutate the live builder.  The run
ends with greppable ``scrub:`` and ``invariants:`` summary lines.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np


def _load_index(path, device="cuda"):
    """Warm-start: the persist snapshot format, with a fallback for the
    legacy build_index archives (adjacency/weights/vectors/degree keys)."""
    from repro_torch.core.build import DEGIndex, DEGParams

    with np.load(path) as z:
        legacy = "__meta__" not in z
        if legacy:
            adjacency = z["adjacency"]
            weights = z["weights"]
            vectors = z["vectors"]
            degree = int(z["degree"])
    if not legacy:
        return DEGIndex.load(path, device=device)
    params = DEGParams(degree=degree, k_ext=max(2 * degree, 20))
    idx = DEGIndex(vectors.shape[1], params, capacity=vectors.shape[0] + 1024,
                   device=device)
    idx.vectors[: vectors.shape[0]] = vectors
    idx._put_rows(vectors, 0)
    from repro_torch.core.graph import GraphBuilder

    b = GraphBuilder(idx.capacity, degree, device=device)
    b.load(adjacency, weights, adjacency.shape[0])
    idx.builder = b
    return idx


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", default=None,
                    help="warm-start from a persist snapshot (.npz from "
                    "build_index.py --out / DEGIndex.save); legacy "
                    "adjacency/vectors archives are still accepted")
    ap.add_argument("--save-index", default=None,
                    help="snapshot the (possibly mutated) index to this "
                    "path after serving — the restart loop: "
                    "--index X ... --save-index X")
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--explore-sessions", type=int, default=8)
    ap.add_argument("--insert-every", type=int, default=0,
                    help="insert one new vector every N queries")
    ap.add_argument("--refine-budget", type=int, default=0)
    ap.add_argument("--build-refine", type=int, default=500,
                    help="refinement iterations after build (paper Alg. 5; "
                    "without it recall plateaus)")
    from repro_torch.configs.deg import QUANT_PRESETS

    ap.add_argument("--preset", default=None, choices=sorted(QUANT_PRESETS),
                    help="named store preset from configs/deg.py "
                    "(sets --codec/--rerank-k/--eps)")
    ap.add_argument("--codec", default="float32",
                    choices=("float32", "fp16", "sq8", "pq"),
                    help="vector store the beam traverses (compressed "
                    "codecs run the two-stage exact-rerank search)")
    ap.add_argument("--rerank-k", type=int, default=0,
                    help="exact-rerank width for compressed codecs "
                    "(0 = auto 4*k)")
    ap.add_argument("--eps", type=float, default=0.1,
                    help="beam exploration slack (pq presets widen this — "
                    "ADC distances distort the stopping rule)")
    from repro_torch.configs.deg import SEARCH_PRESETS, SLO_PRESETS

    ap.add_argument("--engine", default="sync", choices=("sync", "async"),
                    help="sync = closed-loop batched QueryEngine (golden "
                    "baseline); async = continuous-batching "
                    "AsyncQueryEngine with deadlines")
    ap.add_argument("--search-preset", default=None,
                    choices=sorted(SEARCH_PRESETS),
                    help="L/E search program preset from configs/deg.py "
                    "(one bucket table per preset)")
    ap.add_argument("--slo", default="balanced", choices=sorted(SLO_PRESETS),
                    help="scheduler preset (max_batch/buckets/deadline/"
                    "linger) for --engine async")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request SLO override for --engine async "
                    "(negative = no deadline)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the async admission queue at this depth; "
                    "overflow sheds with a typed OverloadError "
                    "(default: unbounded)")
    ap.add_argument("--shed-policy", default="reject",
                    choices=("reject", "drop"),
                    help="reject = refuse the incoming submit at "
                    "capacity; drop = evict the most-expired queued "
                    "request instead (needs deadlines)")
    ap.add_argument("--degrade", action="store_true",
                    help="arm the adaptive degradation ladder (slim "
                    "beam -> hop cap -> sq8) driven by queue backlog; "
                    "requires --max-queue")
    ap.add_argument("--wal", default=None,
                    help="journal every index mutation to this "
                    "write-ahead log; load_index(snapshot) + "
                    "replay_wal(wal) recovers bit-identically after a "
                    "crash")
    ap.add_argument("--faults", default=None,
                    help="deterministic fault plan spec, e.g. "
                    "'scheduler.loop:kill@5;wal.append:delay=0.01' "
                    "(see resilience.faults.FaultPlan.parse)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for probabilistic fault-plan rules")
    ap.add_argument("--refine-while-serving", type=int, default=0,
                    help="run N continuous-refinement iterations per "
                    "background tick while the async engine serves, "
                    "publishing a fresh epoch after each tick (0 = off; "
                    "enables epoch publication)")
    ap.add_argument("--scrub-every", type=float, default=0.0,
                    help="run the online integrity scrubber (audit / "
                    "quarantine / repair / re-admit) every S seconds "
                    "while serving (0 = off; enables epoch publication)")
    ap.add_argument("--inject-corruption", type=int, default=0,
                    help="flip this many adjacency entries (seeded) after "
                    "boot — the scrub-smoke hook: the scrubber must "
                    "detect, quarantine, and repair them")
    ap.add_argument("--warmup", action="store_true",
                    help="run one throwaway flush of every bucket at boot "
                    "and log its time per bucket")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the metrics registry on this port "
                    "(/metrics Prometheus text, /metrics.json snapshot; "
                    "0 = ephemeral, the bound port is printed)")
    ap.add_argument("--stats-every", type=float, default=0.0,
                    help="print a one-line registry digest every N seconds "
                    "while serving (0 = off)")
    ap.add_argument("--trace-sample", type=float, default=0.0,
                    help="query-log sample rate in [0,1] (0 = tracing off, "
                    "no per-query work)")
    ap.add_argument("--query-log", default=None,
                    help="rotating JSONL query log path (needs "
                    "--trace-sample > 0)")
    ap.add_argument("--hold-secs", type=float, default=0.0,
                    help="keep the process (and --metrics-port endpoint) "
                    "alive this long after the trace finishes — for "
                    "external scrapers")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the index and its searches live on")
    args = ap.parse_args(argv)
    if args.preset:
        preset = QUANT_PRESETS[args.preset]
        args.codec, args.rerank_k = preset.codec, preset.rerank_k
        if preset.eps is not None:
            args.eps = preset.eps

    from repro_torch import obs
    from repro_torch.core.build import DEGIndex, DEGParams, build_deg
    from repro_torch.core.distances import exact_knn_batched
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.resilience import (EngineCrashedError, FaultPlan,
                                  OverloadError, RequestValidationError,
                                  install_faults)
    from repro_torch.serving.async_engine import AsyncQueryEngine
    from repro_torch.serving.engine import QueryEngine

    if args.faults:
        plan = FaultPlan.parse(args.faults, seed=args.fault_seed)
        install_faults(plan)
        print(f"faults: installed plan {args.faults!r} "
              f"(seed {args.fault_seed})")

    registry = obs.MetricsRegistry()
    metrics_srv = None
    if args.metrics_port is not None:
        metrics_srv = obs.serve_metrics(registry, args.metrics_port)
        print(f"metrics: {metrics_srv.url} (and /metrics.json)")
    qlog = None
    if args.query_log:
        qlog = obs.QueryLogWriter(args.query_log)
        print(f"query log: {args.query_log} "
              f"(sample rate {args.trace_sample})")
    stats_stop = threading.Event()
    if args.stats_every > 0:
        def _stats_loop():
            lat = registry.histogram(obs.LATENCY_METRIC)
            while not stats_stop.wait(args.stats_every):
                p = lat.percentiles()
                print(f"stats: requests="
                      f"{registry.counter('serving_requests_total').value:.0f} "
                      f"flushes="
                      f"{registry.counter('serving_flushes_total').value:.0f} "
                      f"queue={registry.gauge('serving_queue_depth').value:.0f} "
                      f"p50={p['p50']:.2f}ms p99={p['p99']:.2f}ms")
        threading.Thread(target=_stats_loop, name="stats-printer",
                         daemon=True).start()

    def _teardown():
        if args.hold_secs > 0:
            print(f"holding for {args.hold_secs}s "
                  f"(metrics endpoint stays up)")
            time.sleep(args.hold_secs)
        stats_stop.set()
        if qlog is not None:
            qlog.close()
        if metrics_srv is not None:
            metrics_srv.close()

    if args.index:
        idx = _load_index(args.index, args.device)
        base = idx.vectors[: idx.n].copy()
        rng = np.random.default_rng(args.seed)
        queries = base[rng.integers(0, base.shape[0], args.queries)] + \
            0.01 * rng.normal(size=(args.queries, base.shape[1])
                              ).astype(np.float32)
    else:
        base, queries = make_dataset("gaussian", args.n, args.queries,
                                     args.dim, seed=args.seed)
        idx = build_deg(base, DEGParams(degree=args.degree,
                                        k_ext=2 * args.degree),
                        wave_size=16,
                        refine_iterations=args.build_refine,
                        device=args.device)
    # build-side spans (insert waves, refine chunks) land in the same
    # registry the serving metrics export from
    idx.metrics = registry
    if args.wal:
        idx.enable_wal(args.wal)
        print(f"wal: journaling mutations to {args.wal} "
              f"(cursor seq={idx._wal_seq})")
    live_mutation = bool(args.refine_while_serving or args.scrub_every > 0)
    if args.engine == "async":
        dl = args.deadline_ms
        if dl is not None and dl < 0:
            dl = None
        scrubber = None
        refine_stop = threading.Event()
        refine_thread = None
        refine_stats = {"ticks": 0, "errors": 0}
        if live_mutation:
            # epoch publication: writers mutate the live builder, readers
            # serve immutable published snapshots (see core/epoch.py)
            idx.enable_publishing()
            print(f"epochs: publication enabled "
                  f"(epoch {idx._epochs.current.epoch})")
        if args.inject_corruption:
            from repro_torch.serving.scrub import corrupt_adjacency
            rows = corrupt_adjacency(idx, args.inject_corruption,
                                     seed=args.seed)
            print(f"corruption: flipped {args.inject_corruption} adjacency "
                  f"entries across rows {rows}")
        if args.scrub_every > 0:
            from repro_torch.serving.scrub import IntegrityScrubber
            scrubber = IntegrityScrubber(idx, interval_s=args.scrub_every)
            scrubber.start()
            print(f"scrubber: auditing every {args.scrub_every}s")
        if args.refine_while_serving:
            def _refine_loop():
                # let the engine warm its first flushes before the
                # writer starts competing for the mutation lock, and let
                # injected damage meet the scrubber's first pass: a swap
                # over an unaudited broken row finds no reverse edge and
                # raises.  A stop during either wait still leaves one
                # tick, so the summary always reports a writer that ran.
                refine_stop.wait(1.0)
                while (args.inject_corruption and scrubber is not None
                       and scrubber.running
                       and not scrubber.pass_ended.wait(0.05)):
                    pass
                while True:
                    try:
                        idx.refine(args.refine_while_serving,
                                   seed=refine_stats["ticks"])
                        idx.publish()
                        refine_stats["ticks"] += 1
                    except Exception:
                        # counted and reported on the summary line
                        refine_stats["errors"] += 1
                    if refine_stop.wait(0.05):
                        return
            refine_thread = threading.Thread(
                target=_refine_loop, name="refine-while-serving",
                daemon=True)
            refine_thread.start()
            print(f"refine: {args.refine_while_serving} iterations per "
                  f"background tick, republishing each tick")
        aeng = AsyncQueryEngine(idx, k=args.k, eps=args.eps,
                                codec=args.codec,
                                rerank_k=args.rerank_k or None,
                                preset=args.search_preset, slo=args.slo,
                                max_batch=args.batch,
                                metrics=registry,
                                trace_sample=args.trace_sample,
                                query_log=qlog,
                                max_queue=args.max_queue,
                                shed_policy=args.shed_policy,
                                degrade=args.degrade,
                                **({} if args.deadline_ms is None
                                   else {"deadline_ms": dl}))
        if metrics_srv is not None:
            metrics_srv.set_health(aeng.health)
        if args.warmup:
            t0 = time.time()
            times = aeng.warmup()
            for (b, variant), secs in sorted(times.items()):
                print(f"warmup: bucket={b:4d} variant={variant:6s} "
                      f"first run {secs*1e3:8.1f} ms")
            print(f"warmup: {len(times)} programs in {time.time()-t0:.2f}s "
                  f"(buckets {list(aeng.buckets)})")
        # every submit ends in exactly one bucket: served, shed (typed
        # OverloadError), invalid (RequestValidationError), or crashed
        # (EngineCrashedError) — nothing hangs, nothing is silently lost
        t0 = time.time()
        served_q, served_fut = [], []
        shed = invalid = crashed = 0
        for q in queries:
            try:
                fut = aeng.submit(q)
            except OverloadError:
                shed += 1
                continue
            except RequestValidationError:
                invalid += 1
                continue
            except EngineCrashedError:
                crashed += 1
                continue
            served_q.append(q)
            served_fut.append(fut)
        futs, outs = [], []
        ok_q = []
        for q, f in zip(served_q, served_fut):
            try:
                outs.append(f.result(120.0))
            except OverloadError:
                shed += 1
                continue
            except EngineCrashedError:
                crashed += 1
                continue
            futs.append(f)
            ok_q.append(q)
        wall = time.time() - t0
        st = aeng.stats
        if futs:
            lats = np.array([f.latency_s for f in futs]) * 1e3
            found = np.stack([o[0] for o in outs])
            _, gt = exact_knn_batched(np.stack(ok_q), base, args.k,
                                      device=args.device)
            rec = recall_at_k(found, gt)
            print(f"served {len(futs)} queries in {wall:.2f}s "
                  f"({len(futs)/wall:.0f} qps sustained), "
                  f"recall@{args.k}={rec:.4f}, "
                  f"p50={np.percentile(lats, 50):.2f}ms "
                  f"p99={np.percentile(lats, 99):.2f}ms, "
                  f"{st.flushes} flushes {st.partials} partial "
                  f"{st.forced_flushes} deadline-forced, "
                  f"buckets={st.bucket_hist}")
        else:
            print(f"served 0 queries in {wall:.2f}s")
        print(f"resilience: served={len(futs)} shed={shed} "
              f"invalid={invalid} crashed={crashed} "
              f"degraded={st.degraded} restarts={st.restarts} "
              f"status={aeng.health()['status']}")
        if refine_thread is not None:
            refine_stop.set()
            refine_thread.join(timeout=60.0)
            print(f"refine: ticks={refine_stats['ticks']} "
                  f"errors={refine_stats['errors']}")
        if scrubber is not None:
            # one final synchronous pass so quarantined-but-unrepaired
            # damage from a late corruption never slips past the summary
            scrubber.stop()
            scrubber.run_pass()
            ss = scrubber.stats
            print(f"scrub: passes={ss.passes} audited={ss.audited} "
                  f"quarantined={ss.quarantined} repaired={ss.repaired} "
                  f"readmitted={ss.readmitted} unrepaired={ss.unrepaired} "
                  f"crashes={ss.crashes} errors={ss.errors} "
                  f"epoch={idx._epochs.current.epoch if idx.publishing else -1}")
        if live_mutation:
            from repro_torch.core.invariants import check_invariants
            ok, problems = check_invariants(idx.builder)
            print(f"invariants: ok={ok}"
                  + ("" if ok else f" problems={problems}"))
        aeng.close()
        _teardown()
        if args.save_index:
            idx.save(args.save_index)
            print(f"saved index snapshot to {args.save_index} "
                  f"(n={idx.n}; warm-start with --index)")
        return

    engine = QueryEngine(idx, k=args.k, eps=args.eps, max_batch=args.batch,
                         refine_budget=args.refine_budget,
                         codec=args.codec,
                         rerank_k=args.rerank_k or None,
                         preset=args.search_preset,
                         metrics=registry,
                         trace_sample=args.trace_sample,
                         query_log=qlog)
    if args.warmup:
        t0 = time.time()
        times = engine.warmup()
        for (b, variant), secs in sorted(times.items()):
            print(f"warmup: bucket={b:4d} first run {secs*1e3:8.1f} ms")
        print(f"warmup: {len(times)} programs in {time.time()-t0:.2f}s "
              f"(buckets {list(engine.buckets)})")
    if args.codec != "float32":
        ms = engine.memory_stats()
        print(f"codec={args.codec}: traversal store "
              f"{ms['serving_bytes']/1e6:.2f} MB "
              f"({ms['serving_ratio']:.2f}x smaller than float32)")

    futs = []
    t0 = time.time()
    for i, q in enumerate(queries):
        futs.append(engine.submit(q))
        if args.insert_every and i % args.insert_every == args.insert_every - 1:
            engine.insert(q + 0.05 * np.random.default_rng(i).normal(
                size=q.shape).astype(np.float32))
    engine.flush()
    wall = time.time() - t0
    found = np.stack([f["ids"] for f in futs])
    _, gt = exact_knn_batched(queries, base, args.k, device=args.device)
    rec = recall_at_k(found, gt)
    print(f"served {len(futs)} queries in {wall:.2f}s "
          f"({engine.stats.qps:.0f} qps device-time), recall@{args.k}={rec:.4f}, "
          f"{engine.stats.inserts} inserts, "
          f"{engine.stats.refine_iterations} refine edge improvements")

    # exploration sessions (paper §6.7): 4 hops each, no repeats
    for s in range(args.explore_sessions):
        v = int(np.random.default_rng(s).integers(0, idx.n))
        seen: set = set()
        for _ in range(4):
            fut = engine.explore(v, session=f"s{s}")
            engine.flush()
            ids = [int(x) for x in fut["ids"] if x >= 0]
            assert not (set(ids) & seen), "session exclusion violated"
            seen.update(ids)
            if ids:
                v = ids[0]
    print(f"ran {args.explore_sessions} exploration sessions "
          f"(4 hops each, exclusion verified)")
    _teardown()
    if args.save_index:
        engine.save(args.save_index)
        print(f"saved index snapshot to {args.save_index} "
              f"(n={idx.n}; warm-start with --index)")


if __name__ == "__main__":
    main()
