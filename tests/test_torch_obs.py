"""The port's ``obs`` layer against the JAX package's.

``obs/`` is copied, so one script of counter, gauge and histogram
operations with labels gives equal ``snapshot()`` documents and equal
text expositions in both registries.  The port's query log round-trips
and rotates, its sampler takes the JAX sampler's sequence, and the index
records the JAX package's build and refinement metrics: for one build and
one refinement the counters are equal and each histogram has as many
observations.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro_torch.core.build import DEGParams, build_deg
from repro_torch.interop import index_from_numpy
from repro_torch.obs import (LATENCY_METRIC, MetricsRegistry, QueryLogWriter,
                             Sampler, make_record, read_query_log,
                             replay_registry)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch")


def _script(reg):
    """Counters, gauges and histograms with and without labels, a
    custom bucket layout, and a merge of a second registry."""
    reg.counter("requests_total").inc()
    reg.counter("requests_total").inc(4)
    reg.counter("requests_total", bucket="16").inc(2.5)
    reg.gauge("queue_depth").set(7)
    reg.gauge("queue_depth").inc(-2)
    reg.gauge("occupancy", shard="1").set(0.25)
    h = reg.histogram("latency_ms")
    for v in (0.01, 0.05, 0.3, 1.0, 2.5, 17.0, 400.0, 1e9):
        h.observe(v)
    lab = reg.histogram("latency_ms", bucket="256")
    for v in np.linspace(0.1, 9.0, 37):
        lab.observe(float(v))
    small = reg.histogram("hops", bounds=(1.0, 2.0, 4.0, 8.0))
    for v in (0, 1, 3, 3, 9):
        small.observe(v)
    other = type(reg)()
    other.counter("requests_total").inc(10)
    other.histogram("latency_ms").observe(5.0)
    other.gauge("fresh").set(3)
    reg.merge_from(other)
    return reg


def test_registry_script_matches_jax():
    got, want = _script(MetricsRegistry()), _script(JMetricsRegistry())
    assert got.snapshot() == want.snapshot()
    assert got.snapshot_json() == want.snapshot_json()
    assert got.to_prometheus() == want.to_prometheus()
    h = got.histogram("latency_ms", bucket="256")
    assert h.percentiles() == want.histogram(
        "latency_ms", bucket="256").percentiles()
    again = MetricsRegistry.from_snapshot(got.snapshot())
    assert again.snapshot() == got.snapshot()


def test_registry_refuses_a_kind_clash():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError, match="already registered"):
        reg.histogram("x")


def _record(qid, lat):
    return make_record(qid=qid, query=np.full(4, qid, np.float32), k=3,
                       ids=np.array([qid, 5, -1]),
                       dists=np.array([0.5, 1.0, np.inf], np.float32),
                       hops=7 + qid, evals=30, latency_ms=lat,
                       t_mono=float(qid))


def test_querylog_roundtrip_and_replay(tmp_path):
    path = str(tmp_path / "q.jsonl")
    w = QueryLogWriter(path)
    recs = [_record(i, 0.5 + i) for i in range(12)]
    for r in recs:
        w.write(dict(r))
    w.close()
    got = read_query_log(path)
    assert [r["qid"] for r in got] == list(range(12))
    assert got[3]["ids"] == [3, 5] and got[3]["dists"] == [0.5, 1.0]
    assert all("t_wall_unix" in r for r in got)
    live = MetricsRegistry().histogram(LATENCY_METRIC)
    for r in recs:
        live.observe(r["latency_ms"])
    replayed = replay_registry(got)
    assert replayed.histogram(LATENCY_METRIC).counts == live.counts
    assert replayed.counter("serving_hops_total").value == sum(
        r["hops"] for r in recs)


def test_querylog_rotation(tmp_path):
    path = str(tmp_path / "q.jsonl")
    w = QueryLogWriter(path, max_bytes=1200, max_files=2)
    for i in range(40):
        w.write(_record(i, 1.0))
    w.close()
    assert os.path.exists(path + ".1") and os.path.exists(path + ".2")
    assert not os.path.exists(path + ".3")         # the oldest dropped
    got = read_query_log(path)
    qids = [r["qid"] for r in got]
    assert qids == sorted(qids) and qids[-1] == 39  # chronological
    assert len(qids) < 40
    assert len(read_query_log(path, include_rotated=False)) < len(qids)


def test_querylog_rejects_an_unknown_schema(tmp_path):
    path = tmp_path / "q.jsonl"
    path.write_text('{"v": 2, "qid": 0}\n')
    with pytest.raises(ValueError, match="schema version 2"):
        read_query_log(str(path))


@pytest.mark.parametrize("rate, n, want", [
    (1.0, 20, 20), (0.5, 20, 10), (0.25, 40, 10), (0.0, 20, 0),
    (0.3, 100, 29), (2.0, 5, 5), (-1.0, 5, 0)])
def test_sampler_rates(rate, n, want):
    """The fractional accumulator takes ``rate`` of the calls, evenly
    spaced, in the JAX sampler's sequence (0.3 sums to 29 in 100 in
    float64)."""
    from repro.obs import Sampler as JSampler

    s, j = Sampler(rate), JSampler(rate)
    got = [s.take() for _ in range(n)]
    assert got == [j.take() for _ in range(n)]
    assert sum(got) == want and s.active == (want > 0)


def test_no_wall_clock_calls_in_serving_and_obs():
    """Every duration, span and deadline reads ``obs.clock.now``."""
    banned = "time.time" + "("
    for pkg in ("serving", "obs"):
        for name in os.listdir(os.path.join(SRC, pkg)):
            if name.endswith(".py"):
                with open(os.path.join(SRC, pkg, name)) as f:
                    assert banned not in f.read(), f"{pkg}/{name}"


# ---------------------------------------------------------------------------
# the index's metrics: a build and a refinement in both packages
# ---------------------------------------------------------------------------
def _counts(reg):
    """Each counter's value and each histogram's observation count."""
    return {m.name: (m.value if m.kind == "counter" else m.count)
            for m in reg.metrics()}


def test_build_and_refine_metrics_match_jax():
    base = np.random.default_rng(13).normal(size=(200, 16)).astype(
        np.float32)
    kw = dict(degree=8, k_ext=16, eps_ext=0.3, k_opt=8, i_opt=3)
    jreg, treg = JMetricsRegistry(), MetricsRegistry()
    jidx = j_build_deg(base[:21], JDEGParams(**kw), capacity=200)
    tidx = build_deg(base[:21], DEGParams(**kw), capacity=200, device="cpu")
    jidx.metrics, tidx.metrics = jreg, treg
    jidx.add(base[21:], wave_size=16)
    tidx.add(base[21:], wave_size=16)
    build = {"build_vertices_total": 179.0, "build_wave_search_ms": 12,
             "build_wave_extend_ms": 12}
    assert _counts(treg) == _counts(jreg) == build
    # the refinement on one graph: the JAX one, carried across
    b = jidx.builder
    tidx = index_from_numpy(base, b.adjacency, b.weights, b.n,
                            dataclasses.asdict(jidx.params), device="cpu")
    jreg, treg = JMetricsRegistry(), MetricsRegistry()
    jidx.metrics, tidx.metrics = jreg, treg
    assert tidx.refine(40, seed=3) == jidx.refine(40, seed=3)
    got, want = _counts(treg), _counts(jreg)
    assert got == want
    assert set(got) == {"refine_chunk_ms", "refine_edge_tasks_total",
                        "refine_improved_edges_total",
                        "refine_vertices_total"}
    assert got["refine_chunk_ms"] == 3 and got["refine_vertices_total"] == 40
    assert tidx.refine_stats["edge_tasks"] == got["refine_edge_tasks_total"]
    np.testing.assert_array_equal(tidx.builder.adjacency,
                                  jidx.builder.adjacency)
