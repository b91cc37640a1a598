"""The whole-search kernel's plain version (``kernels/beam_search/ref.py``)
over the pq store and under the fused preset.

Two pq corpora:

* dim 8, one 8-dim subspace: the differential corpus of
  ``tests/test_torch_quant_search.py`` (200 points, built by the JAX
  package at degree 8), the JAX pq store carried across with
  ``interop.store_from_numpy``;
* dim 32, four 8-dim subspaces: 300 seeded points built by the port at
  degree 8, its pq store fit by the port.

The plain whole search over the pq store against the port's host loop
(which scores each hop with ``pq_adc_ref``): every field of the final
state under ``torch.equal``, for E in {1, 2, 4}, no visited set and a
256-slot table, and five variants (the defaults, a hop budget, an exclude
list, a max_hops that cuts lanes off, sqeuclidean).  Against the JAX
package's final ``BeamState`` over the same codes (its jnp hop: decode,
then the metric) at dim 8: ids, checked, excluded, hops, evals and the
visited table exactly, dists at rtol 1e-6 (one subspace, so both add the
same 8 squares, in orders of their own).

The fused preset: the kernel runs the composed hop with the visited
filter, so through the wrapper's route a fused search over a float32
store must end in the host loop's fused state (``fused_hop_ref``) and
its composed one, every field under ``torch.equal``; the one kept
difference (a kept candidate at +inf behind a NaN beam entry) is pinned
last.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam as jbeam
from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro_torch.core import beam
from repro_torch.core.build import DEGParams, build_deg
from repro_torch.core.graph import DEGraph
from repro_torch.interop import (beam_state_to_numpy, graph_from_numpy,
                                  store_from_numpy)
from repro_torch.kernels.beam_merge import ops as bm_ops
from repro_torch.kernels.beam_search import ops as bs_ops
from repro_torch.kernels.fused_hop import ops as fh_ops
from repro_torch.kernels.gather_dist import ops as gd_ops
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.quant.store import VectorStore, make_store
from _torch_threads import _one_torch_thread  # noqa: F401

INVALID = -1
B = 12
VARIANTS = {
    "defaults": {},
    "budget": dict(budget=3),
    "exclude": dict(exclude=True),
    "max_hops": dict(max_hops=5, k=10, eps=0.3),
    "sqeuclidean": dict(metric="sqeuclidean"),
}
FIELDS = ("ids", "dists", "checked", "excluded", "hops", "evals", "visited")


@pytest.fixture(scope="module")
def corpora():
    """name -> (graph, pq store, float32 rows, JAX graph, JAX pq store)."""
    rng = np.random.default_rng(42)
    base = rng.normal(size=(200, 8)).astype(np.float32)
    jidx = j_build_deg(base, JDEGParams(degree=8, k_ext=16), wave_size=8,
                       refine_iterations=50)
    b, js = jidx.builder, jidx.store_for("pq")
    d8 = (graph_from_numpy(b.adjacency, b.weights, b.n, "cpu"),
          store_from_numpy(js.data, js.scale, "pq", js.codebooks,
                           device="cpu"),
          torch.from_numpy(np.array(jidx.vectors)), jidx.frozen(), js)
    rows = np.random.default_rng(7).normal(size=(300, 32)).astype(np.float32)
    idx = build_deg(rows, DEGParams(degree=8, k_ext=16), wave_size=8,
                    device="cpu")
    v = torch.from_numpy(rows)
    d32 = (idx.frozen(), make_store(v, "pq", n=None), v, None, None)
    return {"dim8": d8, "dim32": d32}


def _case(graph, n_rows, dim, E, visited, variant, vectors):
    """Queries near the corpus rows, seeds, exclude list, budget and search
    options of one case, made with numpy from a seed."""
    opts = dict(k=6, eps=0.15, metric="l2", budget=None, exclude=False,
                max_hops=0)
    opts.update(VARIANTS[variant])
    rng = np.random.default_rng(E * 7 + visited + 31 * list(VARIANTS).index(
        variant) + dim)
    qs = (vectors[rng.integers(0, n_rows, B)].numpy()
          + 0.1 * rng.normal(size=(B, dim))).astype(np.float32)
    seeds = rng.integers(0, n_rows, size=(B, 2)).astype(np.int32)
    seeds[0, -1] = INVALID
    excl = np.full((B, 1), INVALID, np.int32)
    if opts["exclude"]:
        excl = rng.integers(0, n_rows, size=(B, 4)).astype(np.int32)
        excl[:, -1] = INVALID
    hb = (None if opts["budget"] is None
          else np.full((B,), opts["budget"], np.int32))
    L = beam.default_beam_width(opts["k"], graph.degree, seeds.shape[1],
                                excl.shape[1] if opts["exclude"] else 0)
    max_hops = opts["max_hops"] or beam.default_max_hops(L)
    return qs, seeds, excl, hb, dict(
        k=opts["k"], eps=opts["eps"], beam_width=L, max_hops=max_hops,
        metric=opts["metric"], expand_width=E, visited_size=visited)


def _inputs(corpora, name, E, visited, variant):
    graph, store, vectors, _, _ = corpora[name]
    dim = vectors.shape[1]
    qs, seeds, excl, hb, kw = _case(graph, graph.n, dim, E, visited, variant,
                                    vectors)
    t = torch.from_numpy
    return (graph, store, t(qs), t(seeds), t(excl),
            None if hb is None else t(hb), kw, (qs, seeds, excl, hb))


def _plain(graph, store, qs, seeds, excl, hb, kw):
    """init, then the plain whole search through its wrapper (a CPU tensor
    takes it), with the pq store's codebooks."""
    st = beam.init(store, qs, seeds, excl, graph.n,
                   beam_width=kw["beam_width"], metric=kw["metric"],
                   visited_size=kw["visited_size"])
    return beam.BeamState(*bs_ops.beam_search(
        graph.adjacency, store.data, qs, excl, st.ids, st.dists, st.checked,
        st.excluded, st.hops, st.evals, st.visited, n_valid=graph.n,
        k=kw["k"], eps1=beam._eps1(kw["eps"]),
        expand_width=min(kw["expand_width"], kw["beam_width"]),
        max_hops=kw["max_hops"], squared=kw["metric"] == "sqeuclidean",
        hop_budget=hb, codebooks=store.codebooks))


def _assert_states_equal(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None and b is None) or torch.equal(a, b), name


MATRIX = [(name, E, visited, variant) for name in ("dim8", "dim32")
          for E in (1, 2, 4) for visited in (0, 256) for variant in VARIANTS]


@pytest.mark.parametrize("name, E, visited, variant", MATRIX)
def test_plain_pq_search_equals_host_loop(corpora, name, E, visited,
                                          variant):
    """The plain per-lane version over the pq codes and the lock-step host
    loop (``pq_adc_ref`` per hop), both on the CPU: every field equal."""
    graph, store, qs, seeds, excl, hb, kw, _ = _inputs(corpora, name, E,
                                                       visited, variant)
    assert store.codebooks.shape[0] == {"dim8": 1, "dim32": 4}[name]
    got = _plain(graph, store, qs, seeds, excl, hb, kw)
    want = beam.beam_search(graph, store, qs, seeds, exclude=excl,
                            hop_budget=hb, **kw)
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


@pytest.mark.parametrize("E, visited, variant", [
    (E, visited, variant) for E in (1, 2, 4) for visited in (0, 256)
    for variant in VARIANTS][::2])
def test_plain_pq_search_equals_jax_engine(corpora, E, visited, variant):
    """At dim 8 the plain pq whole search against JAX's ``beam_search``
    over the JAX pq store the port's store was carried from."""
    graph, store, qs, seeds, excl, hb, kw, raw = _inputs(corpora, "dim8", E,
                                                         visited, variant)
    _, _, _, jgraph, jstore = corpora["dim8"]
    got = beam_state_to_numpy(_plain(graph, store, qs, seeds, excl, hb, kw))
    jq, jseeds, jexcl, jhb = raw
    want = _jax_search(**kw)(jgraph, jstore, jnp.asarray(jq),
                             jnp.asarray(jseeds), exclude=jnp.asarray(jexcl),
                             hop_budget=None if jhb is None
                             else jnp.asarray(jhb))
    for f in FIELDS:
        w = getattr(want, f)
        if f == "dists":
            np.testing.assert_allclose(got[f], np.asarray(w), rtol=1e-6)
        elif w is None:
            assert got[f] is None
        else:
            np.testing.assert_array_equal(got[f], np.asarray(w), err_msg=f)


def _refuse(name):
    def refuse(*a, **kw):
        raise AssertionError(f"{name} reached beside the whole search")
    return refuse


def _forced_kernel_route(monkeypatch):
    """Hold the routing rule true (as on the card, here on the CPU) and
    record the wrapper's calls; the per-hop kernels must not be reached."""
    calls = []
    inner = bs_ops.beam_search

    def spy(*a, **k):
        calls.append(k)
        return inner(*a, **k)

    monkeypatch.setattr(beam, "search_kernel_eligible",
                        lambda *a, **shape: True)
    monkeypatch.setattr(bs_ops, "beam_search", spy)
    for mod, fn in ((adc_ops, "pq_adc"), (fh_ops, "fused_hop"),
                    (bm_ops, "beam_merge"), (gd_ops, "gather_dist")):
        monkeypatch.setattr(mod, fn, _refuse(fn))
    return calls


@pytest.mark.parametrize("name, hop, visited", [
    ("dim8", "composed", 0), ("dim32", "composed", 256),
    ("dim8", "fused", 256), ("dim32", "fused", 256),
    ("dim32 f32", "fused", 256), ("dim32 f32", "fused", 16)])
def test_eligible_pq_or_fused_search_makes_one_wrapper_call(
        corpora, monkeypatch, name, hop, visited):
    """With the rule holding, ``beam_search`` over the pq store or under
    the fused preset hands the initialised beam to the wrapper once (with
    the codebooks over the pq store) and reaches neither ``pq_adc`` nor
    ``fused_hop`` nor ``beam_merge``; its state is the host loop's."""
    graph, store, qs, seeds, excl, hb, kw, _ = _inputs(
        corpora, name.split()[0], 4, visited, "budget")
    if name.endswith("f32"):
        store = VectorStore(data=corpora["dim32"][2])
    args = (graph, store, qs, seeds)
    extra = dict(exclude=excl, hop_budget=hb, hop_backend=hop, **kw)
    want = beam.beam_search(*args, **extra)
    calls = _forced_kernel_route(monkeypatch)
    got = beam.beam_search(*args, **extra)
    assert len(calls) == 1 and calls[0]["max_hops"] == kw["max_hops"]
    assert calls[0]["codebooks"] is store.codebooks
    _assert_states_equal(got, want)


@pytest.mark.parametrize("E, visited, variant", [
    (E, visited, variant) for E in (1, 2, 4) for visited in (256, 16)
    for variant in VARIANTS])
def test_fused_preset_through_the_wrapper_equals_the_host_loop(
        corpora, monkeypatch, E, visited, variant):
    """A fused search over a float32 store through the wrapper's route (the
    plain whole search, which runs the composed hop) ends in the state of
    the host loop with ``fused_hop_ref`` and of the composed host loop,
    every field equal; the 16-slot table saturates."""
    graph, _, qs, seeds, excl, hb, kw, _ = _inputs(corpora, "dim32", E,
                                                   visited, variant)
    v = corpora["dim32"][2]
    args = (graph, v, qs, seeds)
    extra = dict(exclude=excl, hop_budget=hb, **kw)
    fused = beam.beam_search(*args, hop_backend="fused", **extra)
    composed = beam.beam_search(*args, hop_backend="composed", **extra)
    _assert_states_equal(fused, composed)
    _forced_kernel_route(monkeypatch)
    got = beam.beam_search(*args, hop_backend="fused", **extra)
    _assert_states_equal(got, fused)
    if visited == 16:
        assert bool((got.visited != INVALID).all(dim=1).any())


def test_fused_host_loop_keeps_an_inf_candidate_the_composed_hop_drops(
        monkeypatch):
    """The kept difference.  A kept candidate whose distance is +inf
    (kept because fewer than k beam entries count, so the radius is inf)
    enters the beam only where a NaN entry leaves it room.  The fused hop
    compacts its kept candidates to the front, the composed hop leaves
    them in place behind an invalid neighbour's +inf slot, and the merge
    is stable: so the fused host loop takes vertex 2 (and goes on to find
    5) where the composed hop, the kernel and its plain version take the
    invalid slot and stop."""
    v = np.full((6, 8), 0.5, np.float32)
    v[0] = np.nan             # seed 0 scores NaN
    v[2] = 1e30               # its distance overflows to +inf
    v[5] = 0.2
    adj = np.full((6, 3), INVALID, np.int32)
    adj[1] = [INVALID, 2, INVALID]
    adj[2] = [5, 4, INVALID]
    graph = DEGraph(adjacency=torch.from_numpy(adj),
                    weights=torch.zeros(adj.shape), n=6)
    args = (graph, torch.from_numpy(v), torch.zeros((1, 8)),
            torch.tensor([[1, 0]], dtype=torch.int32))
    kw = dict(k=3, eps=0.1, beam_width=2, max_hops=20, visited_size=16)
    fused = beam.beam_search(*args, hop_backend="fused", **kw)
    composed = beam.beam_search(*args, hop_backend="composed", **kw)
    assert fused.ids.tolist() == [[5, 1]] and int(fused.hops[0]) == 3
    assert composed.ids.tolist() == [[1, INVALID]]
    assert int(composed.hops[0]) == 1
    _forced_kernel_route(monkeypatch)
    got = beam.beam_search(*args, hop_backend="fused", **kw)
    _assert_states_equal(got, composed)


def test_wrapper_refuses_a_pq_table_beyond_its_subspaces():
    """At most 128 subspaces, as pq_adc: beyond, the wrapper raises and the
    rule sends the search to the host loop (whose pq_adc raises too)."""
    codes = torch.zeros((10, 129), dtype=torch.uint8)
    books = torch.zeros((129, 256, 1))
    store = VectorStore(data=codes, codec="pq", codebooks=books)
    assert not beam.search_kernel_eligible(store, "l2", "composed", "cuda")
    ops = dict(adjacency=torch.zeros((10, 4), dtype=torch.int32), rows=codes,
               queries=torch.zeros((1, 129)),
               exclude=torch.full((1, 1), INVALID, dtype=torch.int32),
               ids=torch.full((1, 8), INVALID, dtype=torch.int32),
               dists=torch.full((1, 8), float("inf")),
               checked=torch.ones((1, 8), dtype=torch.bool),
               excluded=torch.zeros((1, 8), dtype=torch.bool),
               hops=torch.zeros((1,), dtype=torch.int32),
               evals=torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="128 subspaces"):
        bs_ops.beam_search(**ops, n_valid=10, k=2, eps1=1.1, expand_width=1,
                           max_hops=4, codebooks=books)
    smaller = dataclasses.replace(store, data=codes[:, :128],
                                  codebooks=books[:128])
    assert beam.search_kernel_eligible(smaller, "l2", "composed", "cuda")
