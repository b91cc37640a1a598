"""The port's Table-1 invariants (``core/invariants.py``) against the JAX
package's on the same host rows: healthy, corrupted and split graphs.

Every verdict, component label, unreachable set, audit mask and
``assert_valid_deg`` message is compared exactly, and the port's
vectorized checks are held against its own loop references."""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import invariants as jinv
from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro.core.graph import GraphBuilder as JGraphBuilder
from repro_torch.core import invariants as tinv
from repro_torch.core.graph import GraphBuilder, INVALID
from _torch_threads import _one_torch_thread  # noqa: F401

N, DIM, DEGREE = 400, 8, 8


@pytest.fixture(scope="module")
def healthy():
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(N, DIM)).astype(np.float32)
    jidx = j_build_deg(vecs, JDEGParams(degree=DEGREE, k_ext=2 * DEGREE),
                       wave_size=8)
    b = jidx.builder
    return b.adjacency[: b.n].copy(), b.weights[: b.n].copy()


def _builders(adj, w, n=None):
    """The same rows in a JAX and a port builder."""
    n = adj.shape[0] if n is None else n
    jb = JGraphBuilder(adj.shape[0] + 4, DEGREE)
    jb.load(adj, w, n)
    tb = GraphBuilder(adj.shape[0] + 4, DEGREE, device="cpu")
    tb.load(adj, w, n)
    return jb, tb


def _self_loop(adj, w, rng):
    u = int(rng.integers(0, len(adj)))
    adj[u, 0] = u


def _weight_drift(adj, w, rng):
    u = int(rng.integers(0, len(adj)))
    w[u, 1] = w[u, 1] * 3.0 + 1.0


def _duplicate(adj, w, rng):
    u = int(rng.integers(0, len(adj)))
    adj[u, 2] = adj[u, 3]


def _hole(adj, w, rng):
    u = int(rng.integers(0, len(adj)))
    adj[u, 4] = INVALID
    w[u, 4] = 0.0


def _out_of_range(adj, w, rng):
    u = int(rng.integers(0, len(adj)))
    adj[u, 5] = len(adj) + 7


def _flips(adj, w, rng):
    # the scrubber's damage class: in-range wrong ids, scribbled weights
    for _ in range(12):
        r, s = int(rng.integers(0, len(adj))), int(rng.integers(0, DEGREE))
        adj[r, s] = int(rng.integers(0, len(adj)))
        w[r, s] = abs(w[r, s]) * 2.0 + 1.0


def _detach(adj, w, rng):
    # a vertex cut loose on both ends: two components
    v = int(rng.integers(0, len(adj)))
    for s in range(DEGREE):
        nb = int(adj[v, s])
        if nb >= 0:
            adj[nb][adj[nb] == v] = INVALID
        adj[v, s] = INVALID


def _split(adj, w, rng):
    # drop every edge between the two halves of the ids: the halves (and
    # possibly some stragglers) fall apart
    half = len(adj) // 2
    lo = np.arange(len(adj))[:, None] < half
    cross = (adj >= 0) & ((adj < half) != lo)
    adj[cross] = INVALID
    w[cross] = 0.0


DAMAGE = {"healthy": None, "self_loop": _self_loop,
          "weight_drift": _weight_drift, "duplicate": _duplicate,
          "hole": _hole, "out_of_range": _out_of_range, "flips": _flips,
          "detach": _detach, "split": _split}


def _damaged(healthy, name, seed):
    adj, w = healthy[0].copy(), healthy[1].copy()
    if DAMAGE[name] is not None:
        DAMAGE[name](adj, w, np.random.default_rng(seed))
    return adj, w


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(DAMAGE))
def test_verdicts_match_jax(healthy, name, seed):
    jb, tb = _builders(*_damaged(healthy, name, seed))
    for fn in ("check_undirected", "check_no_self_loops",
               "check_no_duplicate_edges", "check_connected",
               "connected_components"):
        assert getattr(tinv, fn)(tb) == getattr(jinv, fn)(jb), fn
    for partial in (False, True):
        assert (tinv.check_regular(tb, allow_partial=partial)
                == jinv.check_regular(jb, allow_partial=partial))
    np.testing.assert_array_equal(tinv.component_labels(tb),
                                  jinv.component_labels(jb))
    for entry in (0, N // 2, N - 1):
        np.testing.assert_array_equal(tinv.unreachable_vertices(tb, entry),
                                      jinv.unreachable_vertices(jb, entry))
    rows = np.arange(tb.n)
    mask = tinv.audit_rows(tb, rows)
    np.testing.assert_array_equal(mask, jinv.audit_rows(jb, rows))
    assert mask.dtype == np.uint8
    # a chunk of rows audits as the same rows of the whole sweep
    np.testing.assert_array_equal(tinv.audit_rows(tb, rows[37:101]),
                                  mask[37:101])
    assert tinv.check_invariants(tb) == jinv.check_invariants(jb)
    assert (name == "healthy") == (not mask.any())


@pytest.mark.parametrize("name", list(DAMAGE))
def test_assert_valid_deg_matches_jax(healthy, name):
    jb, tb = _builders(*_damaged(healthy, name, 0))
    try:
        jinv.assert_valid_deg(jb, context="(case)")
        want = None
    except AssertionError as e:
        want = str(e)
    try:
        tinv.assert_valid_deg(tb, context="(case)")
        got = None
    except AssertionError as e:
        got = str(e)
    assert got == want
    assert (got is None) == (name == "healthy")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["healthy", "self_loop", "weight_drift",
                                  "duplicate", "hole", "flips", "detach",
                                  "split"])
def test_vectorized_matches_loop_reference(healthy, name, seed):
    """The vectorized checks against the port's loop references (in-range
    damage only: the loops assume in-range ids), and the labels' count."""
    _, tb = _builders(*_damaged(healthy, name, seed))
    assert tinv.check_undirected(tb) == tinv.check_undirected_loop(tb)
    got = tinv.connected_components(tb)
    assert got == tinv.connected_components_loop(tb)
    assert len(set(tinv.component_labels(tb).tolist())) == got
    jb, _ = _builders(*_damaged(healthy, name, seed))
    assert tinv.check_undirected_loop(tb) == jinv.check_undirected_loop(jb)
    assert (tinv.connected_components_loop(tb)
            == jinv.connected_components_loop(jb))


def test_audit_bits_name_each_damage(healthy):
    for name, bit in (("self_loop", tinv.BAD_SELF),
                      ("duplicate", tinv.BAD_DUP),
                      ("hole", tinv.BAD_DEGREE),
                      ("out_of_range", tinv.BAD_RANGE),
                      ("weight_drift", tinv.BAD_WEIGHT),
                      ("flips", tinv.BAD_ASYM)):
        _, tb = _builders(*_damaged(healthy, name, 0))
        mask = tinv.audit_rows(tb, np.arange(tb.n))
        assert (mask & bit).any(), name
        assert int(bit) == int(getattr(jinv, "BAD_" + {
            "self_loop": "SELF", "duplicate": "DUP", "hole": "DEGREE",
            "out_of_range": "RANGE", "weight_drift": "WEIGHT",
            "flips": "ASYM"}[name]))


def test_partial_and_empty_graphs(healthy):
    adj, w = _damaged(healthy, "hole", 0)
    jb, tb = _builders(adj, w)
    assert not tinv.check_regular(tb)
    assert tinv.check_regular(tb, allow_partial=True)
    # an empty builder: every check holds, no components, empty audit
    e = GraphBuilder(16, DEGREE, device="cpu")
    je = JGraphBuilder(16, DEGREE)
    for fn in ("check_undirected", "check_connected",
               "connected_components", "connected_components_loop"):
        assert getattr(tinv, fn)(e) == getattr(jinv, fn)(je), fn
    assert tinv.unreachable_vertices(e).size == 0
    assert tinv.audit_rows(e, np.arange(4)).tolist() == [0, 0, 0, 0]
