"""The whole-search kernel's plain version (``kernels/beam_search/ref.py``)
over the sq8 store, the routing rule that sends an sq8 search to the
kernel, and the wrapper's checks of the scale.

The graph, vectors and queries come from the golden fixture
(``tests/data/range_search_golden.npz``: 300 vertices, degree 8, dim 24);
the JAX package's sq8 store of its vectors is carried across with
``interop.store_from_numpy``, so both packages search the same codes.

Against the port's lock-step host loop (which scores each hop with
``gather_dist_q_ref``): every field of the final state under
``torch.equal``, for E in {1, 2, 4}, no visited set and a 256-slot table,
and five variants (the defaults, a hop budget, an exclude list, a
max_hops that cuts lanes off, sqeuclidean).  Against the JAX engine's
final ``BeamState`` over the JAX sq8 store (its jnp hop, whose
``gather_dist_q`` runs the Pallas kernel in interpret mode): ids,
checked, excluded, hops, evals and the visited table exactly, dists at
rtol 1e-6 (the frameworks sum the squares in different orders; ROADMAP
C2).
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
from repro_torch.kernels.beam_merge import ops as bm_ops
from repro_torch.kernels.beam_search import ops as bs_ops
from repro_torch.kernels.gather_dist_q import ops as gdq_ops
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
    """The fixture's graph and its vectors' sq8 store, in both packages."""
    g = dict(np.load(_FIXTURE))
    graph = graph_from_numpy(g["adjacency"], g["weights"], g["n"], "cpu")
    jgraph = JDEGraph(adjacency=jnp.asarray(g["adjacency"]),
                      weights=jnp.asarray(g["weights"]),
                      n=jnp.asarray(g["n"]))
    jstore = j_make_store(jnp.asarray(g["vectors"]), "sq8", n=None)
    store = store_from_numpy(jstore.data, jstore.scale, "sq8", device="cpu")
    return g, graph, jgraph, jstore, store


def _case(g, graph, E, visited, variant):
    """Queries, seeds, exclude list, budget and search options of one
    case, made with numpy from a seed."""
    opts = dict(k=6, eps=0.15, metric="l2", budget=None, exclude=False,
                max_hops=0)
    opts.update(VARIANTS[variant])
    rng = np.random.default_rng(E * 11 + visited + 37 * list(VARIANTS).index(
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
    """init (which scores the seeds through ``store.decode``), then the
    plain whole search through its wrapper (a CPU tensor takes it), with
    the sq8 store's scale."""
    st = beam.init(store, qs, seeds, excl, graph.n,
                   beam_width=kw["beam_width"], metric=kw["metric"],
                   visited_size=kw["visited_size"])
    return beam.BeamState(*bs_ops.beam_search(
        graph.adjacency, store.data, qs, excl, st.ids, st.dists, st.checked,
        st.excluded, st.hops, st.evals, st.visited, n_valid=graph.n,
        k=kw["k"], eps1=beam._eps1(kw["eps"]),
        expand_width=min(kw["expand_width"], kw["beam_width"]),
        max_hops=kw["max_hops"], squared=kw["metric"] == "sqeuclidean",
        hop_budget=hb, scale=store.scale))


def _assert_states_equal(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None and b is None) or torch.equal(a, b), name


MATRIX = [(E, visited, variant) for E in (1, 2, 4) for visited in (0, 256)
          for variant in VARIANTS]


@pytest.mark.parametrize("E, visited, variant", MATRIX)
def test_plain_sq8_search_equals_host_loop(golden, E, visited, variant):
    """The plain per-lane version over the sq8 codes and the lock-step
    host loop (``gather_dist_q_ref`` and ``beam_merge_ref`` per hop), both
    on the CPU: every field equal."""
    g, graph, _, _, store = golden
    qs, seeds, excl, hb, kw = _case(g, graph, E, visited, variant)
    t = torch.from_numpy
    hb_t = None if hb is None else t(hb)
    got = _plain(graph, store, t(qs), t(seeds), t(excl), hb_t, kw)
    want = beam.beam_search(graph, store, t(qs), t(seeds), exclude=t(excl),
                            hop_budget=hb_t, **kw)
    _assert_states_equal(got, want)
    assert (got.visited is None) == (visited == 0)
    assert int(got.hops.sum()) > 0
    if variant == "max_hops":   # cut off: some lane could still expand
        assert bool(beam.alive(got, k=kw["k"], eps=kw["eps"]).any())
    if variant == "budget":     # a lane may overshoot by up to E - 1
        assert int(got.hops.max()) <= 3 + E - 1


@functools.lru_cache(maxsize=None)
def _jax_search(**kw):
    return jax.jit(functools.partial(jbeam.beam_search, **kw))


# every other case of the matrix
JAX_CASES = MATRIX[::2]


def test_jax_cases_cover_every_axis():
    for i, values in enumerate(((1, 2, 4), (0, 256), tuple(VARIANTS))):
        assert {c[i] for c in JAX_CASES} == set(values)
    assert {(c[0], c[1]) for c in JAX_CASES} == {
        (E, v) for E in (1, 2, 4) for v in (0, 256)}


@pytest.mark.parametrize("E, visited, variant", JAX_CASES)
def test_plain_sq8_search_equals_jax_engine(golden, E, visited, variant):
    """The plain sq8 whole search against JAX's ``beam_search`` over the
    JAX sq8 store the port's store was carried from."""
    g, graph, jgraph, jstore, store = golden
    qs, seeds, excl, hb, kw = _case(g, graph, E, visited, variant)
    t = torch.from_numpy
    got = beam_state_to_numpy(_plain(graph, store, t(qs), t(seeds), t(excl),
                                     None if hb is None else t(hb), kw))
    want = _jax_search(**kw)(jgraph, jstore, jnp.asarray(qs),
                             jnp.asarray(seeds), exclude=jnp.asarray(excl),
                             hop_budget=None if hb is None
                             else jnp.asarray(hb))
    for name in FIELDS:
        w = getattr(want, name)
        if name == "dists":
            np.testing.assert_allclose(got[name], np.asarray(w), rtol=1e-6)
        elif w is None:
            assert got[name] is None
        else:
            np.testing.assert_array_equal(got[name], np.asarray(w),
                                          err_msg=name)


def _refuse(name):
    def refuse(*a, **kw):
        raise AssertionError(f"{name} reached beside the whole search")
    return refuse


@pytest.mark.parametrize("hop, visited", [("composed", 0),
                                          ("composed", 256),
                                          ("fused", 256)])
def test_eligible_sq8_search_makes_one_wrapper_call(golden, monkeypatch, hop,
                                                    visited):
    """With the rule holding (forced here, on the CPU), ``beam_search``
    over the sq8 store hands the initialised beam and the store's scale to
    the wrapper once and reaches neither ``gather_dist_q`` nor
    ``beam_merge``; its state is the host loop's (over a compressed store
    the fused preset runs the composed hop)."""
    g, graph, _, _, store = golden
    qs, seeds, excl, hb, kw = _case(g, graph, 4, visited, "budget")
    t = torch.from_numpy
    args = (graph, store, t(qs), t(seeds))
    extra = dict(exclude=t(excl), hop_budget=t(hb), hop_backend=hop, **kw)
    want = beam.beam_search(*args, **extra)
    calls = []
    inner = bs_ops.beam_search

    def spy(*a, **k):
        calls.append(k)
        return inner(*a, **k)

    monkeypatch.setattr(beam, "search_kernel_eligible",
                        lambda *a, **shape: True)
    monkeypatch.setattr(bs_ops, "beam_search", spy)
    for mod, fn in ((gdq_ops, "gather_dist_q"), (bm_ops, "beam_merge")):
        monkeypatch.setattr(mod, fn, _refuse(fn))
    got = beam.beam_search(*args, **extra)
    assert len(calls) == 1 and calls[0]["max_hops"] == kw["max_hops"]
    assert calls[0]["scale"] is store.scale
    assert calls[0]["codebooks"] is None
    _assert_states_equal(got, want)


def test_routing_rule_admits_sq8_and_counts_its_scale():
    """On a CUDA device the rule sends an sq8 search under l2 or
    sqeuclidean to the kernel, not under ip or cos; the scale's 4 m bytes
    (rounded up to 16) join the lane's shared memory, so an exclude list
    that just fits over float32 rows tips an sq8 lane over 227 KB, and the
    rule and the wrapper agree on it."""
    m, L, d = 24, 40, 8
    rows = torch.zeros((10, m), dtype=torch.int8)
    store = VectorStore(data=rows, scale=torch.ones(m), codec="sq8")
    for metric, want in (("l2", True), ("sqeuclidean", True), ("ip", False),
                         ("cos", False)):
        for hop in beam.HOP_BACKENDS:
            assert beam.search_kernel_eligible(store, metric, hop,
                                               "cuda") == want
            assert not beam.search_kernel_eligible(store, metric, hop, "cpu")
    base = bs_ops.smem_bytes(m, L, d, 1, 0, 1)
    assert bs_ops.smem_bytes(m, L, d, 1, 0, 1, sq8=True) == base + 4 * m
    # the largest exclude list that fits over float32 rows
    X = (bs_ops.MAX_SMEM - base) // 4
    while bs_ops.smem_bytes(m, L, d, X, 0, 1) > bs_ops.MAX_SMEM:
        X -= 1
    assert bs_ops.smem_bytes(m, L, d, X, 0, 1, sq8=True) > bs_ops.MAX_SMEM
    f32 = VectorStore(data=torch.zeros((10, m)))
    shape = dict(beam_width=L, degree=d, n_exclude=X)
    assert beam.search_kernel_eligible(f32, "l2", "composed", "cuda", **shape)
    assert not beam.search_kernel_eligible(store, "l2", "composed", "cuda",
                                           **shape)
    ops, kw = _operands(L=L, d=d, m=m, X=X)
    kw["scale"] = torch.ones(m)
    with pytest.raises(ValueError, match="shared memory"):
        bs_ops.beam_search(**ops, **kw)
    ops, kw = _operands(L=L, d=d, m=m, X=X - 24)
    kw["scale"] = torch.ones(m)
    out = bs_ops.beam_search(**ops, **kw)
    assert torch.equal(out[0], ops["ids"])          # nothing to expand


def _operands(B=3, L=8, d=4, m=16, X=2):
    """The wrapper's operands over (10, m) int8 codes; the scale goes in
    ``kw`` by each test."""
    ops = dict(adjacency=torch.zeros((10, d), dtype=torch.int32),
               rows=torch.zeros((10, m), dtype=torch.int8),
               queries=torch.zeros((B, m)),
               exclude=torch.full((B, X), INVALID, dtype=torch.int32),
               ids=torch.full((B, L), INVALID, dtype=torch.int32),
               dists=torch.full((B, L), float("inf")),
               checked=torch.ones((B, L), dtype=torch.bool),
               excluded=torch.zeros((B, L), dtype=torch.bool),
               hops=torch.zeros((B,), dtype=torch.int32),
               evals=torch.zeros((B,), dtype=torch.int32))
    return ops, dict(n_valid=10, k=2, eps1=1.1, expand_width=1, max_hops=4)


BAD_SQ8 = {
    "codes without a scale": (dict(), "need their scale"),
    "a scale with float32 rows": (dict(scale=torch.ones(16),
                                       rows=torch.zeros((10, 16))),
                                  "only they take one"),
    "a scale with fp16 rows": (dict(scale=torch.ones(16),
                                    rows=torch.zeros((10, 16),
                                                     dtype=torch.float16)),
                               "only they take one"),
    "a scale and codebooks": (dict(scale=torch.ones(16),
                                   codebooks=torch.zeros((4, 256, 4)),
                                   rows=torch.zeros((10, 4),
                                                    dtype=torch.uint8)),
                              "exclude each other"),
    "a scale of the wrong width": (dict(scale=torch.ones(15)), "scale"),
    "a float64 scale": (dict(scale=torch.ones(16, dtype=torch.float64)),
                        "scale"),
    "a 2-D scale": (dict(scale=torch.ones((1, 16))), "scale"),
}


@pytest.mark.parametrize("bad", list(BAD_SQ8))
def test_wrapper_rejects_bad_sq8_operands(bad):
    """The scale is required for int8 rows, refused for any other rows and
    beside codebooks, and must be (m,) float32; each is a ValueError
    before either version runs, and the good operands pass."""
    ops, kw = _operands()
    out = bs_ops.beam_search(**ops, **kw, scale=torch.ones(16))
    assert torch.equal(out[0], ops["ids"])          # nothing to expand
    change, match = BAD_SQ8[bad]
    for name, x in change.items():
        (ops if name == "rows" else kw)[name] = x
    with pytest.raises(ValueError, match=match):
        bs_ops.beam_search(**ops, **kw)
