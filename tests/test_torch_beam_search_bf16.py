"""The whole-search kernel over bfloat16 rows (the ``bf16vecs`` cells'
store): its plain version (``kernels/beam_search/ref.py``) against the
port's host loop and against the JAX engine over the same bfloat16 rows,
the routing rule, and the wrapper's checks.

The graph, vectors and queries come from the golden fixture
(``tests/data/range_search_golden.npz``: 300 vertices, degree 8, dim 24),
the vectors rounded to bfloat16 once, and the queries too (as the
``bf16vecs`` cells hand the search bfloat16 queries; the wrapper rounds
float32 queries to bfloat16 over bfloat16 rows, as ``gather_dist`` does).
Against the host loop: every field ``torch.equal``.  Against JAX's final
``BeamState`` (jnp hop, a raw bfloat16 array, which JAX decodes to
float32): ids, checked, excluded, hops, evals and the visited table
exactly, dists at rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_beam_search import (FIELDS, VARIANTS, _case, _jax_search,
                                    _operands, _plain, golden)  # noqa: F401
from repro_torch.core import beam
from repro_torch.interop import beam_state_to_numpy
from repro_torch.kernels.beam_search import ops as bs_ops
from repro_torch.quant.store import VectorStore
from _torch_threads import _one_torch_thread  # noqa: F401

MATRIX = [(E, visited, variant) for E in (1, 4) for visited in (0, 256, 16)
          for variant in VARIANTS]


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


def _inputs(g, graph, E, visited, variant):
    qs, seeds, excl, hb, kw = _case(g, graph, E, visited, variant)
    qs = _bf16(qs).to(torch.float32)
    t = torch.from_numpy
    return qs, t(seeds), t(excl), None if hb is None else t(hb), kw


@pytest.mark.parametrize("E, visited, variant", MATRIX)
def test_plain_equals_host_loop(golden, E, visited, variant):
    g, graph, _, _ = golden
    rows = _bf16(g["vectors"])
    qs, seeds, excl, hb, kw = _inputs(g, graph, E, visited, variant)
    got = _plain(graph, rows, qs, seeds, excl, hb, kw)
    want = beam.beam_search(graph, rows, qs, seeds, exclude=excl,
                            hop_budget=hb, **kw)
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None and b is None) or torch.equal(a, b), name


@pytest.mark.parametrize("E, visited, variant", MATRIX[::3])
def test_plain_equals_jax_engine(golden, E, visited, variant):
    g, graph, jgraph, _ = golden
    rows = _bf16(g["vectors"])
    qs, seeds, excl, hb, kw = _inputs(g, graph, E, visited, variant)
    got = beam_state_to_numpy(_plain(graph, rows, qs, seeds, excl, hb, kw))
    jrows = jnp.asarray(rows.to(torch.float32).numpy()).astype(jnp.bfloat16)
    want = _jax_search(**kw)(
        jgraph, jrows, jnp.asarray(qs.numpy()), jnp.asarray(seeds.numpy()),
        exclude=jnp.asarray(excl.numpy()),
        hop_budget=None if hb is None else jnp.asarray(hb.numpy()))
    for name in FIELDS:
        w = getattr(want, name)
        if name == "dists":
            np.testing.assert_allclose(got[name], np.asarray(w), rtol=1e-6)
        elif w is None:
            assert got[name] is None
        else:
            np.testing.assert_array_equal(got[name], np.asarray(w),
                                          err_msg=name)


def test_bf16_rows_differ_from_their_float32_source(golden):
    """The rounding is not a no-op on these rows: the bfloat16 search
    scores other distances than the float32 one."""
    g, graph, _, _ = golden
    qs, seeds, excl, hb, kw = _inputs(g, graph, 1, 0, "defaults")
    a = _plain(graph, _bf16(g["vectors"]), qs, seeds, excl, hb, kw)
    b = _plain(graph, torch.from_numpy(g["vectors"]), qs, seeds, excl, hb,
               kw)
    assert not torch.equal(a.dists, b.dists)


def test_wrapper_rounds_float32_queries_over_bf16_rows(golden):
    """Float32 queries over bfloat16 rows are first rounded to bfloat16,
    as ``gather_dist`` rounds them: from one initial beam, the search of
    the raw queries ends as that of the rounded ones, and as the host
    loop's (whose hops score through ``gather_dist``)."""
    g, graph, _, _ = golden
    rows = _bf16(g["vectors"])
    qs, seeds, excl, hb, kw = _case(g, graph, 2, 256, "exclude")
    t = torch.from_numpy
    assert not torch.equal(_bf16(qs).to(torch.float32), t(qs))
    st = beam.init(rows, t(qs), t(seeds), t(excl), graph.n,
                   beam_width=kw["beam_width"], metric=kw["metric"],
                   visited_size=kw["visited_size"])

    def run(q):
        return bs_ops.beam_search(
            graph.adjacency, rows, q, t(excl), st.ids, st.dists, st.checked,
            st.excluded, st.hops, st.evals, st.visited, n_valid=graph.n,
            k=kw["k"], eps1=beam._eps1(kw["eps"]), expand_width=2,
            max_hops=kw["max_hops"])

    raw, rounded = run(t(qs)), run(_bf16(qs).to(torch.float32))
    host = beam.beam_search(graph, rows, t(qs), t(seeds), exclude=t(excl),
                            **kw)
    for name, a, b in zip(FIELDS, raw, rounded):
        c = getattr(host, name)
        assert torch.equal(a, b) and torch.equal(a, c), name


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("metric", ["l2", "sqeuclidean", "ip", "cos"])
def test_routing_rule(device, metric):
    """A bfloat16 store (a raw tensor or the exact store over half rows)
    under l2 or sqeuclidean on a CUDA device runs as one kernel launch; ip
    and cos keep the host loop."""
    want = device == "cuda" and metric in ("l2", "sqeuclidean")
    rows = torch.zeros((4, 8), dtype=torch.bfloat16)
    for vecs in (rows, VectorStore(data=rows)):
        assert beam.search_kernel_eligible(vecs, metric, "composed",
                                           device) == want
    assert "beam_search_bf16" in bs_ops._SYMBOL.values()


def test_routing_rule_counts_the_same_shared_memory():
    """The row type does not enter a lane's shared memory: the query and
    the beam are float32 whatever the rows."""
    kw = dict(beam_width=64, degree=30, n_exclude=16)
    assert beam.search_kernel_eligible(
        torch.zeros((4, 128), dtype=torch.bfloat16), "l2", "composed",
        "cuda", **kw)
    assert bs_ops.smem_bytes(128, 64, 30, 16, 0, 1) < bs_ops.MAX_SMEM


@pytest.mark.parametrize("change, exc, match", [
    (dict(scale=torch.ones(16)), ValueError, "int8 rows"),
    (dict(codebooks=torch.zeros((4, 256, 4))), TypeError, "uint8 codes"),
    (dict(queries=torch.zeros((3, 15))), ValueError, "queries"),
    (dict(queries=torch.zeros((3, 16), dtype=torch.bfloat16)), ValueError,
     "queries"),
])
def test_wrapper_checks_bf16_rows(change, exc, match):
    """bfloat16 rows pass the checks; a scale or codebooks beside them,
    queries of another width or type, do not."""
    ops, kw = _operands()
    ops["rows"] = torch.zeros((10, 16), dtype=torch.bfloat16)
    out = bs_ops.beam_search(**ops, **kw)
    assert torch.equal(out[0], ops["ids"])          # nothing to expand
    for name, x in change.items():
        (ops if name == "queries" else kw)[name] = x
    with pytest.raises(exc, match=match):
        bs_ops.beam_search(**ops, **kw)
