"""The whole-search kernel's plain version (``kernels/beam_search/ref.py``)
against the JAX engine and against the port's host loop, the routing rule
that sends a search to the kernel, and the wrapper's checks.

The graph, vectors and queries come from the golden fixture
(``tests/data/range_search_golden.npz``: 300 vertices, degree 8, dim 24);
the matrix runs E in {1, 2, 4}, no visited set, a 256-slot table and a
saturated 16-slot one, float32 and fp16 rows, and five variants: the
defaults, a hop budget, an exclude list, a max_hops that cuts lanes off,
and the sqeuclidean metric.  Against the JAX engine's final
``BeamState``: ids, checked, excluded, hops, evals and the visited table
exactly, dists at rtol 1e-6 (the frameworks sum the squares in different
orders).  Against the port's lock-step host loop: every field under
``torch.equal``.  JAX runs on the CPU, its jnp hop.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam as jbeam
from repro.core.graph import DEGraph as JDEGraph
from repro.quant.store import make_store as j_make_store
from repro_torch.core import beam
from repro_torch.interop import (beam_state_to_numpy, graph_from_numpy,
                                  store_from_numpy)
from repro_torch.kernels.beam_search import ops as bs_ops
from repro_torch.quant.store import VectorStore
from _torch_threads import _one_torch_thread  # noqa: F401

INVALID = -1
B = 12
_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                        "range_search_golden.npz")
VARIANTS = {
    "defaults": {},
    "budget": dict(budget=3),
    "exclude": dict(exclude=True),
    "max_hops": dict(max_hops=5, k=10, eps=0.3),
    "sqeuclidean": dict(metric="sqeuclidean"),
}
FIELDS = ("ids", "dists", "checked", "excluded", "hops", "evals", "visited")


@pytest.fixture(scope="module")
def golden():
    g = dict(np.load(_FIXTURE))
    graph = graph_from_numpy(g["adjacency"], g["weights"], g["n"], "cpu")
    jgraph = JDEGraph(adjacency=jnp.asarray(g["adjacency"]),
                      weights=jnp.asarray(g["weights"]),
                      n=jnp.asarray(g["n"]))
    jf16 = j_make_store(jnp.asarray(g["vectors"]), "fp16", n=None)
    stores = {"f32": (jnp.asarray(g["vectors"]),
                      torch.from_numpy(g["vectors"])),
              "f16": (jf16, store_from_numpy(jf16.data, jf16.scale, "fp16",
                                             device="cpu"))}
    return g, graph, jgraph, stores


def _case(g, graph, E, visited, variant):
    """Queries, seeds, exclude list, budget and search options of one
    case, made with numpy from a seed."""
    opts = dict(k=6, eps=0.15, metric="l2", budget=None, exclude=False,
                max_hops=0)
    opts.update(VARIANTS[variant])
    rng = np.random.default_rng(E * 7 + visited + 31 * list(VARIANTS).index(
        variant))
    qs = (g["vectors"][rng.integers(0, 300, B)]
          + 0.1 * rng.normal(size=(B, 24))).astype(np.float32)
    seeds = rng.integers(0, 300, size=(B, 2)).astype(np.int32)
    seeds[0, -1] = INVALID
    excl = np.full((B, 1), INVALID, np.int32)
    if opts["exclude"]:
        excl = rng.integers(0, 300, size=(B, 4)).astype(np.int32)
        excl[:, -1] = INVALID
    hb = (None if opts["budget"] is None
          else np.full((B,), opts["budget"], np.int32))
    L = beam.default_beam_width(opts["k"], graph.degree, seeds.shape[1],
                                excl.shape[1] if opts["exclude"] else 0)
    max_hops = opts["max_hops"] or beam.default_max_hops(L)
    return qs, seeds, excl, hb, dict(
        k=opts["k"], eps=opts["eps"], beam_width=L, max_hops=max_hops,
        metric=opts["metric"], expand_width=E, visited_size=visited)


def _plain(graph, store, qs, seeds, excl, hb, kw):
    """init, then the plain whole-search version through its wrapper (a
    CPU tensor takes it)."""
    vecs = store if isinstance(store, VectorStore) else VectorStore(store)
    st = beam.init(vecs, qs, seeds, excl, graph.n,
                   beam_width=kw["beam_width"], metric=kw["metric"],
                   visited_size=kw["visited_size"])
    return beam.BeamState(*bs_ops.beam_search(
        graph.adjacency, vecs.data, qs, excl, st.ids, st.dists, st.checked,
        st.excluded, st.hops, st.evals, st.visited, n_valid=graph.n,
        k=kw["k"], eps1=beam._eps1(kw["eps"]),
        expand_width=min(kw["expand_width"], kw["beam_width"]),
        max_hops=kw["max_hops"], squared=kw["metric"] == "sqeuclidean",
        hop_budget=hb))


@functools.lru_cache(maxsize=None)
def _jax_search(**kw):
    return jax.jit(functools.partial(jbeam.beam_search, **kw))


MATRIX = [(E, visited, rows, variant) for E in (1, 2, 4)
          for visited in (0, 256, 16) for rows in ("f32", "f16")
          for variant in VARIANTS]


@pytest.mark.parametrize("E, visited, rows, variant", MATRIX)
def test_plain_equals_host_loop(golden, E, visited, rows, variant):
    """The plain per-lane version and the lock-step host loop (both on the
    CPU) end in the same state, field for field."""
    g, graph, _, stores = golden
    qs, seeds, excl, hb, kw = _case(g, graph, E, visited, variant)
    store = stores[rows][1]
    t = torch.from_numpy
    hb_t = None if hb is None else t(hb)
    got = _plain(graph, store, t(qs), t(seeds), t(excl), hb_t, kw)
    want = beam.beam_search(graph, store, t(qs), t(seeds), exclude=t(excl),
                            hop_budget=hb_t, **kw)
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if name == "visited":
            assert (a is None) == (b is None) == (visited == 0)
        assert (a is None and b is None) or torch.equal(a, b), name
    if variant == "max_hops":   # cut off: some lane could still expand
        assert bool(beam.alive(got, k=kw["k"], eps=kw["eps"]).any())
    if visited == 16:
        # saturated: some lane's table is full, so inserts were dropped
        assert bool((got.visited != INVALID).all(dim=1).any())


@pytest.mark.parametrize("E, visited, rows, variant", MATRIX[::2] + [
    (E, 16, "f16", "sqeuclidean") for E in (1, 2, 4)])
def test_plain_equals_jax_engine(golden, E, visited, rows, variant):
    """The plain version against JAX's ``beam_search`` (jnp hop) on the
    same graph, rows and inputs: the whole final state."""
    g, graph, jgraph, stores = golden
    qs, seeds, excl, hb, kw = _case(g, graph, E, visited, variant)
    jvecs, store = stores[rows]
    t = torch.from_numpy
    got = beam_state_to_numpy(_plain(graph, store, t(qs), t(seeds), t(excl),
                                     None if hb is None else t(hb), kw))
    want = _jax_search(**kw)(jgraph, jvecs, jnp.asarray(qs),
                             jnp.asarray(seeds), exclude=jnp.asarray(excl),
                             hop_budget=None if hb is None else jnp.asarray(hb))
    for name in FIELDS:
        w = getattr(want, name)
        if name == "dists":
            np.testing.assert_allclose(got[name], np.asarray(w), rtol=1e-6)
        elif w is None:
            assert got[name] is None
        else:
            np.testing.assert_array_equal(got[name], np.asarray(w),
                                          err_msg=name)


def test_matrix_covers_every_axis():
    jax_cases = MATRIX[::2]
    for i, values in enumerate(((1, 2, 4), (0, 256, 16), ("f32", "f16"),
                                tuple(VARIANTS))):
        assert {c[i] for c in jax_cases} == set(values)


def _store(codec):
    data = {"float32": torch.zeros((4, 8)),
            "fp16": torch.zeros((4, 8), dtype=torch.float16),
            "sq8": torch.zeros((4, 8), dtype=torch.int8),
            "pq": torch.zeros((4, 1), dtype=torch.uint8)}[codec]
    return VectorStore(
        data=data, codec=codec,
        scale=torch.ones(8) if codec == "sq8" else None,
        codebooks=torch.zeros((1, 256, 8)) if codec == "pq" else None)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("hop_backend", beam.HOP_BACKENDS)
@pytest.mark.parametrize("codec", ["float32", "fp16", "sq8", "pq"])
@pytest.mark.parametrize("metric", ["l2", "sqeuclidean", "ip", "cos"])
def test_routing_rule(device, hop_backend, codec, metric):
    """Exactly a search over any store (float32, fp16, sq8 or pq) under
    l2 or sqeuclidean on a CUDA device runs as one kernel launch, under
    either hop backend (the fused hop is the composed hop with the visited
    filter); ip and cos keep the host loop."""
    want = device == "cuda" and metric in ("l2", "sqeuclidean")
    assert beam.search_kernel_eligible(_store(codec), metric, hop_backend,
                                       torch.device(device)) == want
    if codec == "float32":   # a raw float tensor is the exact store
        assert beam.search_kernel_eligible(
            _store(codec).data, metric, hop_backend, device) == want


@pytest.mark.parametrize("visited", [0, 256])
def test_eligible_search_makes_one_wrapper_call(golden, monkeypatch,
                                                visited):
    """With the rule holding (forced here, on the CPU), ``beam_search``
    hands the initialised beam to the wrapper once, and its result is the
    host loop's."""
    g, graph, _, stores = golden
    qs, seeds, excl, hb, kw = _case(g, graph, 2, visited, "budget")
    t = torch.from_numpy
    args = (graph, stores["f32"][1], t(qs), t(seeds))
    extra = dict(exclude=t(excl), hop_budget=t(hb), **kw)
    want = beam.beam_search(*args, **extra)
    calls = []
    inner = bs_ops.beam_search

    def spy(*a, **k):
        calls.append(k)
        return inner(*a, **k)

    monkeypatch.setattr(beam, "search_kernel_eligible",
                        lambda *a, **shape: True)
    monkeypatch.setattr(bs_ops, "beam_search", spy)
    got = beam.beam_search(*args, **extra)
    assert len(calls) == 1 and calls[0]["max_hops"] == kw["max_hops"]
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None and b is None) or torch.equal(a, b), name


class _Asked(Exception):
    pass


@pytest.mark.parametrize("k, n_exclude, fits, codec", [
    (6, 3, True, "f32"), (6, 9_400, True, "f32"), (6, 9_800, False, "f32"),
    (6_000, 1, False, "f32"), (6, 9_600, True, "f32"),
    (6, 9_600, False, "pq"), (6, 9_400, True, "pq")])
def test_routing_rule_holds_the_kernels_shared_memory(golden, monkeypatch,
                                                      k, n_exclude, fits,
                                                      codec):
    """``range_search`` sizes L >= max(2k, k + X), so a long exploration
    session's exclude list or a k in the thousands needs more shared
    memory than a block has.  ``beam_search`` asks the rule with the
    search's own shapes; on the card the rule sends such a search to the
    host loop, exactly where the wrapper would refuse it.  Over the pq
    store the lane's table (3 subspaces here, 3,088 bytes) tips a lane of
    9,600 excluded ids over 227 KB that fits over float32 rows."""
    from repro_torch.core import search
    from repro_torch.quant.store import make_store

    g, graph, _, stores = golden
    store = stores["f32"][1]
    if codec == "pq":
        store = make_store(store, "pq", n=None)
    rule, seen = beam.search_kernel_eligible, {}

    def spy(vectors, metric, hop_backend, device, **shape):
        seen.update(shape, cuda=rule(vectors, metric, hop_backend, "cuda",
                                     **shape))
        raise _Asked

    monkeypatch.setattr(beam, "search_kernel_eligible", spy)
    rng = np.random.default_rng(k + n_exclude)
    qs = torch.from_numpy(g["vectors"][:2] + np.float32(0.1))
    seeds = torch.from_numpy(rng.integers(0, 300, (2, 2)).astype(np.int32))
    excl = torch.from_numpy(rng.integers(0, 300, (2, n_exclude)).astype(
        np.int32))
    with pytest.raises(_Asked):
        search.range_search(graph, store, qs, seeds, k=k, exclude=excl)
    L = seen["beam_width"]
    assert L >= max(2 * k, k + n_exclude)
    assert seen == dict(beam_width=L, degree=8, expand_width=1,
                        n_exclude=n_exclude, visited_size=0, cuda=fits)
    ops, kw = _operands(B=1, L=L, d=8, m=24, X=n_exclude,
                        m_sub=3 if codec == "pq" else 0)
    kw["k"] = k
    if fits:
        bs_ops.beam_search(**ops, **kw)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            bs_ops.beam_search(**ops, **kw)


def _operands(B=3, L=8, d=4, m=16, X=2, V=0, m_sub=0):
    """The wrapper's operands over float32 rows or, with ``m_sub``, over
    pq codes of m_sub subspaces of m / m_sub dims."""
    ops = dict(adjacency=torch.zeros((10, d), dtype=torch.int32),
               rows=(torch.zeros((10, m_sub), dtype=torch.uint8) if m_sub
                     else torch.zeros((10, m))),
               queries=torch.zeros((B, m)),
               exclude=torch.full((B, X), INVALID, dtype=torch.int32),
               ids=torch.full((B, L), INVALID, dtype=torch.int32),
               dists=torch.full((B, L), float("inf")),
               checked=torch.ones((B, L), dtype=torch.bool),
               excluded=torch.zeros((B, L), dtype=torch.bool),
               hops=torch.zeros((B,), dtype=torch.int32),
               evals=torch.zeros((B,), dtype=torch.int32),
               visited=(torch.full((B, V), INVALID, dtype=torch.int32)
                        if V else None))
    kw = dict(n_valid=10, k=2, eps1=1.1, expand_width=1, max_hops=4)
    if m_sub:
        kw["codebooks"] = torch.zeros((m_sub, 256, m // m_sub))
    return ops, kw


BAD = {
    "ids int64": dict(ids=torch.zeros((3, 8), dtype=torch.int64)),
    "dists float64": dict(dists=torch.zeros((3, 8), dtype=torch.float64)),
    "checked uint8": dict(checked=torch.zeros((3, 8), dtype=torch.uint8)),
    "excluded short": dict(excluded=torch.zeros((3, 7), dtype=torch.bool)),
    "hops int64": dict(hops=torch.zeros((3,), dtype=torch.int64)),
    "evals shape": dict(evals=torch.zeros((4,), dtype=torch.int32)),
    "rows int8": dict(rows=torch.zeros((10, 16), dtype=torch.int8)),
    # bfloat16 rows are taken; rows of another width than the queries' not
    "rows bf16": dict(rows=torch.zeros((10, 15), dtype=torch.bfloat16)),
    "queries width": dict(queries=torch.zeros((3, 15))),
    "queries float64": dict(queries=torch.zeros((3, 16),
                                                dtype=torch.float64)),
    "adjacency int64": dict(adjacency=torch.zeros((10, 4),
                                                  dtype=torch.int64)),
    "exclude int64": dict(exclude=torch.zeros((3, 2), dtype=torch.int64)),
    "exclude lanes": dict(exclude=torch.zeros((2, 2), dtype=torch.int32)),
    "visited not pow2": dict(visited=torch.zeros((3, 24),
                                                 dtype=torch.int32)),
    "visited int64": dict(visited=torch.zeros((3, 16), dtype=torch.int64)),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_wrapper_rejects_bad_operands(bad):
    ops, kw = _operands()
    ops.update(BAD[bad])
    with pytest.raises(ValueError):
        bs_ops.beam_search(**ops, **kw)


BAD_PQ = {
    "codes without codebooks": (dict(codebooks=None), ValueError,
                                "float32 or float16"),
    "f32 rows with codebooks": (dict(rows=torch.zeros((10, 4))), TypeError,
                                "uint8 codes"),
    "codebooks float64": (dict(codebooks=torch.zeros((4, 256, 4),
                                                     dtype=torch.float64)),
                          TypeError, "float32 codebooks"),
    "codebooks m_sub": (dict(codebooks=torch.zeros((3, 256, 4))),
                        ValueError, "disagree"),
    "codebooks centroids": (dict(codebooks=torch.zeros((4, 128, 4))),
                            ValueError, "disagree"),
    "codebooks 2-D": (dict(codebooks=torch.zeros((4, 256))), ValueError,
                      "disagree"),
    "queries width": (dict(queries=torch.zeros((3, 12))), ValueError,
                      "queries"),
}


@pytest.mark.parametrize("bad", list(BAD_PQ))
def test_wrapper_rejects_bad_pq_operands(bad):
    """The pq store's checks (``kernels/pq_adc/ops.py::check_store``, as
    ``pq_adc`` raises them), before either version runs; the good operands
    pass them."""
    ops, kw = _operands(m=16, m_sub=4)
    out = bs_ops.beam_search(**ops, **kw)
    assert torch.equal(out[0], ops["ids"])          # nothing to expand
    change, exc, match = BAD_PQ[bad]
    for name, x in change.items():
        (kw if name == "codebooks" else ops)[name] = x
    with pytest.raises(exc, match=match):
        bs_ops.beam_search(**ops, **kw)


@pytest.mark.parametrize("kw_bad", [dict(k=0), dict(expand_width=0),
                                    dict(expand_width=9), dict(max_hops=-1),
                                    dict(hop_budget=torch.zeros(
                                        (3,), dtype=torch.int64))])
def test_wrapper_rejects_bad_options(kw_bad):
    ops, kw = _operands()
    kw.update(kw_bad)
    with pytest.raises(ValueError):
        bs_ops.beam_search(**ops, **kw)


def test_wrapper_rejects_shared_memory_beyond_227_kb():
    """A 64Ki-slot visited table alone is 256 KB; 32Ki slots fit."""
    ops, kw = _operands(V=1 << 15)
    assert bs_ops.smem_bytes(16, 8, 4, 2, 1 << 15, 1) <= bs_ops.MAX_SMEM
    out = bs_ops.beam_search(**ops, **kw)
    assert torch.equal(out[0], ops["ids"])          # nothing to expand
    ops, kw = _operands(V=1 << 16)
    with pytest.raises(ValueError, match="shared memory"):
        bs_ops.beam_search(**ops, **kw)


def test_smem_bytes_at_the_main_paths_shapes():
    """classic serving (L=30, d=20, m=192), an insert wave (L=80) and a
    V=1024 table at E=2, each section rounded up to 16 bytes."""
    assert bs_ops.smem_bytes(192, 30, 20, 1, 0, 1) == (
        16 + 768 + 2 * 208 + 2 * 128 + 80 + 16 + 0 + 16 + 16
        + 4 * 32 + 32 + 16)
    assert bs_ops.smem_bytes(192, 80, 20, 1, 0, 1) < 48 * 1024
    assert bs_ops.smem_bytes(192, 30, 40, 1, 1024, 2) > 4096


def test_smem_bytes_at_pq_servings_shapes():
    """``pq-serving`` (m=192 as m_sub=24 subspaces of 8, L=120 for its
    rerank of 120): the table is 24 rows of 257 floats, under "classic"
    (C=20, no visited set) and under "multi-e4-fused" (E=4, C=80 and the
    default 4,096-slot table); the 128-subspace cap alone is 131,584."""
    lut = 24 * 257 * 4
    assert bs_ops.smem_bytes(192, 120, 20, 1, 0, 1, 24) == (
        16 + 768 + lut + 2 * 560 + 2 * 480 + 80 + 16 + 0 + 16 + 16
        + 4 * 128 + 32 + 16) == 28_224
    assert beam.default_visited_size(120, 20) == 4096
    assert bs_ops.smem_bytes(192, 120, 80, 1, 4096, 4, 24) == (
        16 + 768 + lut + 2 * 800 + 2 * 480 + 320 + 16 + 16_384 + 16 + 16
        + 4 * 128 + 80 + 16) == 45_376
    assert (bs_ops.smem_bytes(128, 8, 4, 2, 0, 1, 128)
            - bs_ops.smem_bytes(128, 8, 4, 2, 0, 1)) == 131_584


def test_unknown_impl():
    ops, kw = _operands()
    with pytest.raises(ValueError, match="impl"):
        bs_ops.beam_search(**ops, **kw, impl="cuda")
