"""A rehearsal of ``chip_smoke.py`` on the CPU at a small size: its phase
functions run with ``device="cpu"``, where every kernel wrapper takes its
plain version.  The card-only pieces (synchronisation, the profiler and
the CUDA-graph timer ``time_call``) are replaced, and each launch count
the script expects must read 0 here, since a CPU tensor never reaches a
kernel."""
import functools
import os
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

N, N_QUERIES, BATCH, N_SMALL = 800, 64, 32, 300
#: the script's own check, which the module's rehearsal replaces
EXPECT_LAUNCHES = cs.expect_launches


def _no_launches(kernel, got, want, what):
    assert got == 0, f"{got} {kernel} launches on the CPU"


def _untimed(fn, symbol=None, reps=0):
    """``time_call``'s result without the card: one call, no time."""
    fn()
    return {"device_ms": 0.0, "timed_by": "cuda_graph", "event_ms": 0.0}


@pytest.fixture(scope="module")
def rehearsal():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "sync", lambda: None)
        mp.setattr(cs, "idle_share", lambda fn, wall_ms, what: None)
        mp.setattr(cs, "peak_memory", lambda reset=False: None)
        mp.setattr(cs, "expect_launches", _no_launches)
        mp.setattr(cs, "time_call", _untimed)
        yield mp


@pytest.fixture(scope="module")
def served(rehearsal):
    idx, base, queries, occ = cs.build_phase(N, N_QUERIES, "cpu")
    out = cs.serve_phase(idx, base, queries, "cpu", batch=BATCH)
    return idx, queries, occ, out


@pytest.mark.parametrize("n, degree, want", [
    (cs.N_AUDIO, 20, 6),            # 53,366 inserted: 833 waves + 54
    (21 + 64, 20, 16),              # one full wave
    (21 + 64 + 17, 20, 1),
    (21 + 48, 20, 16),
])
def test_last_block(n, degree, want):
    assert cs.last_block(n, degree) == want


def test_extend_blocks():
    assert cs.extend_blocks(53_366) == 3_336
    assert cs.extend_blocks(64) == 4 and cs.extend_blocks(65) == 5


@pytest.fixture(scope="module")
def recsys(rehearsal):
    """Phase 8's inputs on the reduced DIN and DCN-v2: 3 serve_p99 batches
    of 64, a bulk batch of 300, 25 retrieval candidates."""
    return cs.recsys_setup("cpu", reduced=True, p99=64, bulk=300,
                           n_candidates=25, n_batches=3)


def test_phase2_rows(rehearsal, recsys):
    rows, host_loop = cs.phase2("cpu", n_queries=64)
    rows["bag_lookup"] = cs.bag_checks(recsys, "cpu")[0]   # as main() does
    assert set(rows) == set(cs.KERNELS)
    # the host loops' launches beside the whole search, by counter: none
    # on the CPU, where every wrapper takes its plain version
    assert set(host_loop) == set(cs.launch_counters())
    assert set(cs.HOST_LOOP_ONLY) <= set(host_loop)
    assert not any(host_loop.values()), host_loop
    # the kernels' JSON line: every key of every row, the timing method too
    line = cs.kernel_rows(rows, dict.fromkeys(rows, 3))
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "timed_by"}
    assert [r["name"] for r in line] == list(rows)
    for r in line:
        assert set(r) == keys and r["timed_by"] == "cuda_graph", r["name"]
        assert r["launches"] == 3 and r["route"] == "cuda"
        assert os.path.exists(os.path.join(cs.ROOT, r["source"]))
    # the ground truth's row at B=64: 32-query tiles, 105 splits of 4 tiles
    assert rows["l2_topk"]["splits"] == 105 and rows["l2_topk"]["tq"] == 32
    for r in rows.values():
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
        assert r["max_abs_err"] == 0.0          # both sides are plain here
    # at d=20 computing pq_adc's distances straight from the code rows
    # (3 * d * m flops a query) is cheaper than the whole table (3 * 256 * m),
    # and then its bytes (codebooks, queries, code rows) bound it, as they
    # bound the gathers
    assert rows["pq_adc"]["bound_by"] == "bytes"
    assert rows["gather_dist_q"]["bound_by"] == "bytes"
    # the JSON row of the scan is the ground truth's shape, and at any
    # real B its 2 B N m flops bound it
    assert "B=64 N=53387 m=192 k=10" in rows["l2_topk"]["shape"]
    assert rows["l2_topk"]["bound_by"] == "operations"
    assert rows["l2_topk"]["tl"] is not None


@pytest.mark.parametrize("kw, shape", [
    (dict(B=cs.BATCH, k=10), "B=256 N=3000 m=192 k=10"),
    (dict(B=1, k=10), "B=1 N=3000"),
    (dict(B=300, k=100), "B=300 N=3000 m=192 k=100"),   # beyond phase 2's 256
    (dict(B=37, k=50, N=1000, m=33), "B=37 N=1000 m=33 k=50"),
    (dict(B=3, k=50, N=130, m=16), "B=3 N=130 m=16 k=50"),
])
def test_phase2_l2_topk_checks(rehearsal, kw, shape):
    from repro_torch.kernels.l2_topk import ops

    inp = cs.phase2_inputs("cpu", N=3000)
    r = cs.check_l2_topk(inp, "cpu", **kw)
    assert shape in r["shape"] and "ids equal 100.0000%" in r["shape"]
    assert r["max_abs_err"] == 0.0 and r["bound_ms"] > 0
    # the split the card would plan, reported beside its check
    plan = ops.plan_splits(kw["B"], kw.get("N", 3000), kw["k"], ops.H100_SMS)
    assert (r["splits"], r["tq"]) == (plan.splits, plan.tq)
    assert f"S={plan.splits} (TQ={plan.tq}" in r["shape"]
    assert r["shape"].endswith("bit-identical to S=1")


def test_timings_and_timed_by():
    """A check's log phrase names each time's method; the JSON row's
    ``timed_by`` is one word when the three agree, each otherwise."""
    t = {"device_ms": 0.5, "timed_by": "cuda_graph", "event_ms": 0.7}
    loop = dict(t, timed_by="events_loop")
    r = dict(t=t, tp=t, tl=None, bound_ms=0.1, bound_by="bytes",
             max_abs_err=0.0)
    assert cs.timed_by(r) == "cuda_graph"
    assert "0.500000 ms device (cuda_graph" in cs.timings(r, "library")
    assert cs.timed_by(dict(r, tl=loop)) == (
        "kernel: cuda_graph; plain: cuda_graph; library: events_loop")


def test_ground_truth_is_the_scan(rehearsal):
    """The ground truth of every recall is the brute-force scan; on the CPU
    it runs the plain version, so no l2_topk launch is counted."""
    from repro_torch.core.distances import exact_knn_batched

    rng = np.random.default_rng(0)
    base = rng.normal(size=(500, 16)).astype(np.float32)
    queries = rng.normal(size=(40, 16)).astype(np.float32)
    ops = cs.launch_counters()
    launches = dict.fromkeys(ops, 0)
    gt = cs.ground_truth(base, queries, "cpu",
                         lambda fn, *a, **kw: cs.counted(ops, launches, fn,
                                                         *a, **kw))
    _, want = exact_knn_batched(queries, base, cs.K, device="cpu")
    np.testing.assert_array_equal(gt, want)
    assert launches["l2_topk"] == 0 and "l2_topk" in launches


@pytest.mark.parametrize("check, kw, shape", [
    (cs.check_gather_dist, dict(B=cs.BATCH, rows="f16"), "f16"),
    (cs.check_gather_dist, dict(B=cs.BATCH, rows="bf16"), "bf16"),
    (cs.check_gather_dist_q, dict(d=20), "d=20"),
    (cs.check_gather_dist_q, dict(d=80), "d=80"),
    (cs.check_pq_adc, dict(d=20), "m_sub=24"),
    (cs.check_pq_adc, dict(d=80), "d=80"),
])
def test_phase2_compressed_checks(rehearsal, check, kw, shape):
    inp = cs.phase2_inputs("cpu", N=3000)
    r = check(inp, "cpu", **kw)
    assert shape in r["shape"] and r["max_abs_err"] == 0.0
    assert r["bound_ms"] > 0


@pytest.mark.parametrize("kw, shape", [
    (dict(B=cs.BATCH, L=30), "serve: B=256 L=30 E=1 k=10 eps=0.1 d=20 m=192 "
                             "f32 V=0 X=0 composed"),
    (dict(B=16, L=30, rows="f16", what="serve fp16"), "f16 V=0"),
    (dict(B=16, L=30, E=2, V=1024, what="visited"), "E=2 k=10"),
    (dict(B=8, L=42, X=32, what="explore"), "explore: B=8 L=42"),
    (dict(B=1, L=40, k=20, eps=0.001, seeds=2, what="refine live"),
     "refine live: B=1 L=40 E=1 k=20 eps=0.001"),
    (dict(B=16, L=120, eps=0.2, rows="pq", what="pq-serving"),
     "pq-serving: B=16 L=120 E=1 k=10 eps=0.2 d=20 m=192 pq m_sub=24 V=0 "
     "X=0 composed"),
    (dict(B=16, L=120, E=4, V=4096, eps=0.2, rows="pq", hop="fused",
          what="pq-serving multi-e4-fused"), "E=4 k=10 eps=0.2 d=20 m=192 "
                                             "pq m_sub=24 V=4096 X=0 fused"),
    (dict(B=16, L=30, E=4, V=1024, hop="fused", what="multi-e4-fused"),
     "multi-e4-fused: B=16 L=30 E=4 k=10 eps=0.1 d=20 m=192 f32 V=1024 X=0 "
     "fused"),
    (dict(B=16, L=40, rows="sq8", what="sq8-serving"),
     "sq8-serving: B=16 L=40 E=1 k=10 eps=0.1 d=20 m=192 sq8 V=0 X=0 "
     "composed"),
    (dict(B=16, L=40, E=4, V=1024, rows="sq8", hop="fused",
          what="sq8-serving multi-e4-fused"),
     "E=4 k=10 eps=0.1 d=20 m=192 sq8 V=1024 X=0 fused"),
])
def test_phase2_beam_search_checks(rehearsal, kw, shape):
    """The whole search's check on the CPU: the wrapper takes its plain
    version, so the kernel side, the host loop (with gather_dist_q, pq_adc
    or fused_hop where the check names them) and the plain version all
    agree, and no launch is counted, neither of beam_search nor in the
    host loop."""
    from repro_torch.kernels.beam_search import ops

    inp = cs.phase2_inputs("cpu", N=3000)
    before = ops.launches
    r = cs.check_beam_search(inp, "cpu", **kw)
    assert ops.launches == before == 0
    assert r["name"] == "beam_search" and shape in r["shape"]
    assert "on 100.0000% of slots" in r["shape"]
    assert f"hops and evals on {kw['B']} of {kw['B']} lanes" in r["shape"]
    assert r["max_abs_err"] == 0.0 and r["tl"] is None
    # the bound counts distinct rows: all lanes together read at most the
    # n_valid rows of the graph, so the 256 lanes, which share them, are
    # bound by their scoring operations here
    rows = int(re.search(r"(\d+) distinct rows", r["shape"]).group(1))
    assert 0 < rows <= inp["n_valid"]
    # over pq each lane's table (3 * 256 * m flops) is small beside the
    # codebooks' 196,608 bytes and the beams', so bytes bound it
    assert r["bound_ms"] > 0 and r["bound_by"] == (
        "operations" if kw["B"] == cs.BATCH else "bytes")
    assert not any(r["host_launches"].values()), r["host_launches"]


@pytest.mark.parametrize("kw, shape", [
    (dict(W=16), "extend block: W=16 K=40 d=20 m=192"),
    (dict(W=6, what="last block"), "last block: W=6 K=40"),
    (dict(W=16, failed=True, what="failed lanes and the latch"),
     "failed lanes and the latch: W=16 K=40"),
])
def test_phase2_extend_select_checks(rehearsal, kw, shape):
    """The selection pass's check on the CPU: the wrapper and the two-step
    path take their plain versions and agree with the plain version, no
    launch is counted, and the failed-lane case fails two lanes and
    latches at least one."""
    from repro_torch.kernels.extend_select import ops

    inp = cs.phase2_inputs("cpu", N=3000)
    before = ops.launches
    r = cs.check_extend_select(inp, "cpu", **kw)
    assert ops.launches == before == 0
    assert r["name"] == "extend_select" and shape in r["shape"]
    assert "on 100.0000% of slots" in r["shape"] and "cluster 8" in r["shape"]
    assert r["max_abs_err"] == 0.0 and r["tl"] is None
    assert r["bound_ms"] > 0 and r["bound_by"] == "bytes"
    n_failed, n_latched = map(int, re.search(
        r"(\d+) failed and (\d+) latched", r["shape"]).groups())
    if kw.get("failed"):
        assert n_failed == 2 and n_latched >= 1
    else:
        assert n_failed == 0


def test_extend_select_is_counted_and_routed_to_plain():
    from repro_torch.kernels.extend_select import ops

    assert cs.launch_counters()["extend_select"] == (ops, "launches")
    fn = ops.extend_select
    with cs.plain_kernels():
        assert ops.extend_select.keywords == {"impl": "ref"}
    assert ops.extend_select is fn
    assert cs.KERNELS["extend_select"] == (
        "src/repro/kernels/mrng_occlusion/mrng_occlusion.py:50")
    assert "gather_dist_q.py:37" in cs.KERNELS["beam_search"]


def test_beam_search_is_counted_and_routed_to_plain():
    from repro_torch.kernels.beam_search import ops

    assert cs.launch_counters()["beam_search"] == (ops, "launches")
    fn = ops.beam_search
    with cs.plain_kernels():
        assert ops.beam_search.keywords == {"impl": "ref"}
    assert ops.beam_search is fn
    assert cs.KERNELS["beam_search"].startswith(
        "src/repro/kernels/beam_merge/beam_merge.py:189")


def test_count_searches_counts_range_search_calls(rehearsal, served):
    """Every search of a counted piece goes through range_search once a
    batch; on the CPU no kernel takes it, so none launches."""
    from repro_torch.core import beam

    idx, queries, _, _ = served
    ops = cs.launch_counters()
    launches = dict.fromkeys(ops, 0)
    count = functools.partial(cs.counted, ops, launches)
    rule = functools.partial(beam.search_kernel_eligible, idx._dev_vectors,
                             "l2")
    assert not rule("composed", "cpu")
    # the kernel takes either hop over every store; the ip metric keeps
    # the host loop
    assert rule("composed", "cuda") and rule("fused", "cuda")
    from repro_torch.quant.store import make_store

    for codec, want in (("fp16", True), ("pq", True), ("sq8", True)):
        # not idx.store_for: phase 4b times the index's first pq fit
        store = make_store(idx._dev_vectors, codec, n=idx.n)
        for hop in beam.HOP_BACKENDS:
            assert beam.search_kernel_eligible(store, "l2", hop,
                                               "cuda") == want
    assert not beam.search_kernel_eligible(idx._dev_vectors, "ip",
                                           "composed", "cuda")
    _, n = cs.count_searches(count, "serve", cs._batches,
                             lambda q: idx.search_batch(q, k=cs.K),
                             queries, 16, kernel=False)
    assert n == -(-len(queries) // 16)
    _, n = cs.count_searches(count, "explore", cs.explore_phase, idx,
                             sessions=2, hops=3, kernel=False)
    assert n == 3
    assert all(v == 0 for v in launches.values()), launches
    from repro_torch.core import build, search
    assert build.range_search is search.range_search   # restored


def _launch_counts(main=1, host=1):
    """Main-path and phase-2 host-loop launches: every kernel ``main``
    times on the main path but the host-loop-only ones, which the host
    loops launch ``host`` times."""
    names = list(cs.launch_counters())
    launches = {n: 0 if n in cs.HOST_LOOP_ONLY else main for n in names}
    return launches, {n: host if n in cs.HOST_LOOP_ONLY else 0
                      for n in names}


def test_main_path_launch_rule(monkeypatch):
    """Kernels of the main path must launch there; gather_dist,
    gather_dist_q, beam_merge, pq_adc and fused_hop, which serve only the
    host loop since beam_search takes every l2 search over every store,
    must launch no time there and at least once in phase 2's host
    loops."""
    monkeypatch.setattr(cs, "expect_launches", EXPECT_LAUNCHES)
    assert set(cs.HOST_LOOP_ONLY) == {"gather_dist", "gather_dist[fp16]",
                                      "gather_dist_q", "beam_merge",
                                      "fused_hop", "pq_adc"}
    cs.check_main_path_launches(*_launch_counts())
    for name in cs.HOST_LOOP_ONLY:
        launches, host = _launch_counts()
        launches[name] = 3
        with pytest.raises(AssertionError, match=f"3 {re.escape(name)} "):
            cs.check_main_path_launches(launches, host)
        launches, host = _launch_counts()
        host[name] = 0
        with pytest.raises(AssertionError, match="host loops never"):
            cs.check_main_path_launches(launches, host)
    for name in ("beam_search", "extend_select", "mrng_occlusion",
                 "l2_topk", "bag_lookup"):
        launches, host = _launch_counts()
        launches[name] = 0
        with pytest.raises(AssertionError, match="main path never"):
            cs.check_main_path_launches(launches, host)


@pytest.mark.parametrize("beside", [None, "beam_merge", "gather_dist",
                                    "gather_dist_q", "pq_adc", "fused_hop"])
def test_count_searches_refuses_a_hop_kernel_beside_the_whole_search(
        monkeypatch, beside):
    """Where the kernel takes a piece's searches, one beam_search launch a
    range_search call and no per-hop kernel launch beside them."""
    from repro_torch.core import build, search
    from repro_torch.core.baselines import nsw

    monkeypatch.setattr(cs, "expect_launches", EXPECT_LAUNCHES)
    counters = cs.launch_counters()
    for mod, attr in counters.values():
        monkeypatch.setattr(mod, attr, 0)            # restored afterwards
    for mod in (build, search, nsw):
        monkeypatch.setattr(mod, "range_search", lambda: None)
    bs = counters["beam_search"][0]

    def piece():
        for _ in range(3):
            search.range_search()                    # the counted call
            bs.launches += 1
        if beside is not None:
            setattr(*counters[beside], 1)

    count = functools.partial(cs.counted, counters,
                              dict.fromkeys(counters, 0))
    if beside is None:
        assert cs.count_searches(count, "piece", piece, kernel=True) == (
            None, 3)
    else:
        with pytest.raises(AssertionError, match=f"1 {beside} launches"):
            cs.count_searches(count, "piece", piece, kernel=True)
    with pytest.raises(AssertionError, match="3 beam_search launches"):
        cs.count_searches(count, "piece", piece, kernel=False)


def test_store_bytes_at_audio_size():
    assert cs.expected_store_bytes(cs.N_AUDIO, cs.DIM) == cs.AUDIO_STORE_BYTES


def test_held_bytes_reads_the_tensors():
    """Phase 4b holds memory_stats() against the stores' own tensors, so a
    store that kept float32 rows under the fp16 codec is caught."""
    import torch
    from repro_torch.quant.store import VectorStore, make_store

    rows = torch.tensor(np.random.default_rng(0).normal(size=(40, 16)),
                        dtype=torch.float32)
    stats = {"fp16_bytes": 30 * 16 * 2, "sq8_bytes": 30 * 16 + 16 * 4}
    cs.check_held_bytes(make_store(rows, "fp16", n=30), stats, 30)
    cs.check_held_bytes(make_store(rows, "sq8", n=30), stats, 30)
    with pytest.raises(AssertionError, match="holds 1,920 bytes"):
        cs.check_held_bytes(VectorStore(data=rows, codec="fp16"), stats, 30)


def test_build_and_serve(served):
    idx, _, occ, out = served
    assert idx.n == N and occ == 0
    for name in ("classic", "multi-e4-fused"):
        assert out[name]["recall"] >= cs.RECALL_FLOOR
        assert out[name]["ids"].shape == (N_QUERIES, cs.K)


def test_host_extension_build(rehearsal):
    idx, _, _, _ = cs.build_phase(N_SMALL, 8, "cpu", device_extend=False)
    assert idx.n == N_SMALL


def test_compare_then_refine(served):
    idx, queries, _, out = served
    ids = cs.wave_phase(idx, queries)
    calls = cs.explore_phase(idx, sessions=4, hops=3)
    ops = cs.launch_counters()
    launches = dict.fromkeys(ops, 0)
    quant = cs.quant_serve_phase(
        idx, queries, out["gt"],
        lambda fn, *a, **kw: cs.counted(ops, launches, fn, *a, **kw),
        batch=BATCH)
    assert set(quant) == set(cs.QUANT_SERVED)
    for name, res in quant.items():
        assert res["recall"] >= cs.RECALL_FLOOR, name
        assert res["ids"].shape == (N_QUERIES, cs.K)
    assert quant["pq-serving"]["fit_s"] > 0 and quant["fp16"]["fit_s"] == 0
    assert set(idx._stores) == {"fp16", "sq8", "pq"}
    assert all(n == 0 for n in launches.values()), launches  # CPU: plain
    cs.compare_plain_phase(idx, queries, out, ids, calls, batch=BATCH,
                           n_compare=BATCH)
    cs.compare_quant_phase(idx, queries, out["gt"], quant, batch=BATCH)
    adj0 = idx.builder.adjacency.copy()
    refined = cs.refine_phase(idx, queries, out["gt"], "cpu", vertices=16)
    assert idx.refine_stats["vertices"] == 16
    assert not np.array_equal(idx.builder.adjacency, adj0)
    assert refined["classic"]["recall"] >= cs.RECALL_FLOOR


def test_baselines_phase(served):
    idx, queries, _, _ = served
    base = idx.vectors[: idx.n]
    ops = cs.launch_counters()
    launches = dict.fromkeys(ops, 0)
    out = cs.baselines_phase(
        base, queries, "cpu",
        lambda fn, *a, **kw: cs.counted(ops, launches, fn, *a, **kw),
        n=300, n_nsw=120, n_query=N_QUERIES, batch=BATCH, n_compare=BATCH)
    assert set(out) == {"kgraph", "random-regular", "nsw"}
    for name, r in out.items():
        assert 0.0 <= r["recall"] <= 1.0 and r["build_s"] > 0, name
        assert r["hops"] > 0 and r["evals"] > 0, name
    assert out["kgraph"]["recall"] > 0.5
    assert all(n == 0 for n in launches.values()), launches  # CPU: plain


def test_delete_phase(rehearsal):
    idx, _, queries, _ = cs.build_phase(N, N_QUERIES, "cpu")
    ops = cs.launch_counters()
    launches = dict.fromkeys(ops, 0)
    out = cs.delete_phase(
        idx, queries, "cpu",
        lambda fn, *a, **kw: cs.counted(ops, launches, fn, *a, **kw),
        n_delete=64)
    assert idx.n == N - 64
    assert out["classic"]["recall"] >= cs.RECALL_FLOOR
    assert out["gt"].max() < idx.n
    assert all(n == 0 for n in launches.values()), launches  # CPU: plain


def test_compare_extend(rehearsal):
    assert cs.compare_extend_phase("cpu", n=N_SMALL) == 1.0


def test_recsys_setup(recsys):
    assert set(recsys) == set(cs.RECSYS_ARCHS)
    din, dcn = recsys["din"], recsys["dcn-v2"]
    assert din["cfg"].kind == "din" and dcn["cfg"].kind == "dcn-v2"
    assert len(din["p99"]) == 3 and din["p99"][0]["hist"].shape == (64, 10)
    assert din["bulk"]["sparse"].shape == (300, 3) and "bulk" not in dcn
    assert dcn["query"]["sparse"].shape == (1, 5)      # retrieval_cand: B=1
    for r in (din, dcn):
        assert r["bytes"] == sum(p.numel() * 4
                                 for p in r["model"].parameters())


def test_recsys_setup_reads_the_published_cells():
    """Without overrides the batch sizes and candidates are RECSYS_SHAPES'
    (checked on the specs, not by building the full-width models here)."""
    from repro_torch.configs import get_arch

    spec = get_arch("dcn-v2")
    assert spec.cell("serve_p99")["batch"] == 512
    assert spec.cell("serve_bulk")["batch"] == 262_144
    assert spec.cell("retrieval_cand")["n_candidates"] == 1_000_000
    assert spec.model.vocab_sizes[cs.DCN_CANDIDATE_FIELD] >= 1_000_000
    assert spec.model.total_rows == 33_762_577


def test_phase8_bag_rows(recsys):
    rows = cs.bag_checks(recsys, "cpu")
    shapes = [r["shape"] for r in rows]
    for what in ("DIN interest serve_p99: B=64 F=10 E=8",
                 "DIN interest serve_bulk: B=300 F=10 E=8",
                 "DCN-v2 user_embedding retrieval_cand: B=1 F=5 E=8",
                 "DCN-v2 user_embedding serve_p99: B=64 F=5 E=8",
                 "ragged: B=37 F=5 E=7 V=1000"):
        assert any(s.startswith(what) for s in shapes), what
    for r in rows:
        assert r["name"] == "bag_lookup" and r["max_abs_err"] == 0.0
        assert r["bound_ms"] > 0 and r["bound_by"] == "bytes"
        assert r["tl"] is not None                     # F.embedding_bag


def test_bag_bound_counts_what_the_data_needs():
    """ids, weights, each distinct row named by a valid id, the output."""
    import torch

    table = torch.zeros((10, 4))
    ids = torch.tensor([[1, 1, -1], [2, 12, -1]], dtype=torch.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "time_call", _untimed)
        r = cs.check_bag_lookup(table, ids, torch.ones((2, 3)), "t")
        r0 = cs.check_bag_lookup(table, ids, None, "t")
    rows = 3                                           # 1, 2 and 12 -> 9
    want = (6 * 4 + 6 * 4 + rows * 4 * 4 + 2 * 4 * 4) / cs.HBM_BYTES_PER_S
    assert r["bound_ms"] == pytest.approx(want * 1e3)
    assert r0["bound_ms"] == pytest.approx((want - 24 / cs.HBM_BYTES_PER_S)
                                           * 1e3)
    assert "4 valid ids, 3 rows" in r["shape"]


def test_recsys_phase(recsys):
    ops = cs.launch_counters()
    launches = dict.fromkeys(ops, 0)
    out = cs.recsys_phase(
        recsys, "cpu",
        lambda fn, *a, **kw: cs.counted(ops, launches, fn, *a, **kw),
        check_reps=2)
    din, dcn = out["din"], out["dcn-v2"]
    assert len(din["p99_ms"]) == 3 and len(dcn["p99_ms"]) == 3
    assert din["bulk_samples_s"] > 0 and din["bulk_peak_bytes"] is None
    assert set(din["retrieval"]) == {1, 64} and set(dcn["retrieval"]) == {1}
    for r in (*din["retrieval"].values(), *dcn["retrieval"].values()):
        assert r["agree"] == 1.0
        assert r["ms_checked"] > 0 and r["ms_unchecked"] > 0
    from repro_torch.models import recsys as R
    assert R.check_rows.__name__ == "check_rows"       # the check restored
    top, ids = dcn["retrieval"][1]["got"]
    assert ids.shape == (1, 25) and int(ids.max()) < 25
    assert "bag_lookup" in launches
    assert all(n == 0 for n in launches.values()), launches  # CPU: plain


# ---------------------------------------------------------------------------
# phase 9: persistence and the serving engine
# ---------------------------------------------------------------------------
def _counted():
    ops = cs.launch_counters()
    launches = dict.fromkeys(ops, 0)
    return launches, functools.partial(cs.counted, ops, launches)


@pytest.fixture(scope="module")
def persisted(rehearsal):
    """Phase 9's inputs at a small size: a build of N_SMALL rows, phase
    4's "classic" ids and phase 4b's three stores and their ids."""
    idx, base, queries, _ = cs.build_phase(N_SMALL, 160, "cpu")
    out = cs.serve_phase(idx, base, queries, "cpu", batch=BATCH,
                         presets=("classic",))
    quant = cs.quant_serve_phase(idx, queries, out["gt"], batch=BATCH)
    return idx, base, queries, out, quant


def test_phase9_snapshot(persisted, tmp_path):
    idx, _, queries, out, quant = persisted
    launches, count = _counted()
    path = str(tmp_path / "i.npz")
    loaded, info = cs.snapshot_phase(
        idx, queries, cs.served_ids(out, quant), path, "cpu", count,
        batch=BATCH, pq_fit_s=quant["pq-serving"]["fit_s"])
    assert loaded.n == idx.n and loaded.device.type == "cpu"
    assert info["bytes"] == os.path.getsize(path) and info["save_s"] > 0
    secs = info["sections"]
    assert set(secs) == {"__meta__.npy", "vectors", "graph", "store_fp16",
                         "store_sq8", "store_pq"}
    raw = {s: r for s, (r, _) in secs.items()}
    n = idx.n
    assert n * cs.DIM * 4 < raw["vectors"] < n * cs.DIM * 4 + 256
    assert 2 * n * 20 * 4 < raw["graph"] < 2 * n * 20 * 4 + 512
    assert all(v == 0 for v in launches.values()), launches  # CPU: plain
    # a restored tensor that differs is caught
    loaded._stores["sq8"].scale[0] += 1.0
    with pytest.raises(AssertionError, match="sq8 scale"):
        cs.check_restored(idx, loaded)


def test_phase9_engine(persisted, tmp_path):
    idx, _, queries, out, quant = persisted
    path = str(tmp_path / "i.npz")
    idx.save(path)
    launches, count = _counted()
    engine, info = cs.engine_phase(
        path, queries, cs.served_ids(out, quant), out["gt"], "cpu", count,
        batch=BATCH, bursts=(1, 3, 17, 30), sessions=4, steps=3, n_insert=8)
    assert engine.buckets == (8, 16, 32)
    assert set(info["warmup"]) == {(b, "plain") for b in engine.buckets}
    assert info["latency"] == {32: (5, pytest.approx(info["latency"][32][1]),
                                    pytest.approx(info["latency"][32][2]))}
    assert info["recall"] == out["classic"]["recall"] and info["qps"] > 0
    assert engine.index.n == idx.n + 8 - 1           # 8 inserted, 1 deleted
    assert idx.n == N_SMALL                          # the live index untouched
    assert all(v == 0 for v in launches.values()), launches  # CPU: plain


def test_phase9_engine_refuses_a_burst_over_one_flush(persisted, tmp_path):
    idx, _, queries, out, quant = persisted
    path = str(tmp_path / "i.npz")
    idx.save(path)
    with pytest.raises(AssertionError, match="a burst of 40: 2 flushes"):
        cs.engine_phase(path, queries, cs.served_ids(out, quant), out["gt"],
                        "cpu", batch=BATCH, bursts=(40,), sessions=1,
                        steps=1, n_insert=1)


def test_phase9_wal(rehearsal, tmp_path):
    base = np.random.default_rng(3).normal(size=(400, cs.DIM)).astype(
        np.float32)
    launches, count = _counted()
    secs = cs.wal_phase(base, "cpu", str(tmp_path), count, n=400, n_snap=300,
                        n_remove=4, n_refine=8)
    assert set(secs) == {"build", "save", "add", "remove", "refine",
                         "recover", "checkpointed build", "load checkpoint",
                         "resume"}
    assert all(v == 0 for v in launches.values()), launches  # CPU: plain
    ck = sorted(f for f in os.listdir(tmp_path) if f.startswith("ck_"))
    # 379 rows in waves of 64: 6 waves, a checkpoint at wave 4
    assert ck == ["ck_4.npz"]


def test_compare_indexes_catches_a_difference(persisted, tmp_path):
    from repro_torch.core.build import DEGIndex

    idx = persisted[0]
    path = str(tmp_path / "i.npz")
    idx.save(path)
    twin = DEGIndex.load(path, device="cpu")
    cs.compare_indexes("twin", idx, twin)
    twin._rng.integers(0, 10)
    with pytest.raises(AssertionError, match="RNG stream"):
        cs.compare_indexes("twin", idx, twin)
    twin = DEGIndex.load(path, device="cpu")
    twin.builder.weights[5, 0] += 1.0
    with pytest.raises(AssertionError, match="rows differ"):
        cs.compare_indexes("twin", idx, twin)


def test_main_without_a_card_exits_nonzero(capsys):
    assert cs.main([]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_main_keeps_its_kernels_and_ok_lines():
    """main() still runs phase 9 between the serving comparisons and the
    baselines, prints the kernels' line with every kernel it listed
    before, and ends with the ok line."""
    import inspect

    assert set(cs.KERNELS) == {
        "gather_dist", "beam_merge", "fused_hop", "mrng_occlusion",
        "gather_dist_q", "pq_adc", "l2_topk", "bag_lookup", "beam_search",
        "extend_select"}
    src = inspect.getsource(cs.main)
    order = [src.index(s) for s in (
        "compare_quant_phase(", "persist_serve_phase(", "baselines_phase(",
        "refine_phase(", 'json.dumps({"kernels": kernel_rows(',
        'json.dumps({"ok": True')]
    assert order == sorted(order)
    tail = src[src.index('json.dumps({"ok": True'):]
    assert tail.rstrip().endswith("return 0")
    assert '"platform": "gpu"' in tail and "get_device_name(0)" in tail
