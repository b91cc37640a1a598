"""The port's graph data (``repro_torch.data.graphs``) against the JAX
package's ``repro.data.graphs`` on the CPU:

* the two generators byte-equal at three seeds;
* ``expand_hops`` fed ``jax.random``'s own per-hop draws gives the nodes
  and edges of JAX's ``sample_neighbors`` exactly, isolated nodes (the
  last one among them) included;
* the port's own draws: in range, every child inside its parent's row,
  the self-loop fallback, and the same subgraph twice from one seed;
* ``subgraph_batch`` equal to JAX's on the same draws, with and without
  coordinates; ``partition_edges_by_dst`` equal to JAX's and its contract
  (the twin of ``tests/test_cells_debug_mesh.py::
  test_partition_edges_by_dst_contract``); ``subgraph_shapes``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graphs as JG
from repro_torch.data import graphs as TG
from _torch_threads import _one_torch_thread  # noqa: F401

SEEDS = (0, 1, 7)
FANOUTS = (4, 3)


def _jax_draws(key, n_seeds, fanouts):
    """The draws JAX's ``sample_neighbors`` makes from ``key``, hop by hop."""
    out, nf = [], n_seeds
    for f in fanouts:
        k, key = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(k, (nf, f), 0, 1 << 30)))
        nf *= f
    return out


def _with_isolated(n=120, seed=3):
    """A power-law graph whose nodes 5 and n-1 (the last row, which starts
    past the last edge) have no out-edge."""
    g = JG.random_power_law_graph(n, 6, seed=seed)
    src = np.repeat(np.arange(n), np.diff(g.row_ptr))
    keep = (src != 5) & (src != n - 1)
    src, dst = src[keep], g.col_idx[keep]
    row_ptr = np.zeros(n + 1, np.int64)
    np.add.at(row_ptr[1:], src, 1)
    return JG.CSRGraph(np.cumsum(row_ptr), dst, n)


def _port(g):
    return TG.CSRGraph(g.row_ptr, g.col_idx, g.n_nodes)


@pytest.mark.parametrize("seed", SEEDS)
def test_power_law_graph_equals_jax(seed):
    a = TG.random_power_law_graph(700, 9, seed=seed)
    b = JG.random_power_law_graph(700, 9, seed=seed)
    assert a.n_nodes == b.n_nodes and a.n_edges == b.n_edges
    for k in ("row_ptr", "col_idx"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
    np.testing.assert_array_equal(a.degrees(), b.degrees())


@pytest.mark.parametrize("seed", SEEDS)
def test_geometric_graph_equals_jax(seed):
    a, ca = TG.random_geometric_graph(500, 6, seed=seed, device="cpu")
    b, cb = JG.random_geometric_graph(500, 6, seed=seed)
    assert ca.tobytes() == cb.tobytes()
    for k in ("row_ptr", "col_idx"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k


def _tensors(g):
    gt = TG.graph_tensors(_port(g), "cpu")
    assert gt.row_ptr.dtype == torch.int64 and gt.deg.dtype == torch.int64
    assert gt.col_idx.dtype == torch.int32 and gt.n_edges == g.n_edges
    return gt


@pytest.mark.parametrize("key", [0, 5])
@pytest.mark.parametrize("graph", ["power_law", "isolated"])
def test_expand_hops_on_jax_draws_equals_jax(key, graph):
    g = JG.random_power_law_graph(300, 5, seed=key) if graph == "power_law" \
        else _with_isolated()
    n = g.n_nodes
    seeds = np.array([5, n - 1, 0, 17, 5, 33, 8, 2], np.int32)
    k = jax.random.PRNGKey(key)
    jn, je = JG.sample_neighbors(
        jnp.asarray(g.row_ptr), jnp.asarray(g.col_idx),
        jnp.asarray(g.degrees().astype(np.int32)), jnp.asarray(seeds), k,
        FANOUTS)
    draws = [torch.tensor(d, dtype=torch.int64)
             for d in _jax_draws(k, len(seeds), FANOUTS)]
    gt = _tensors(g)
    tn, te = TG.expand_hops(gt.row_ptr, gt.col_idx, gt.deg,
                            torch.tensor(seeds), draws)
    assert tn.dtype == te.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_torch_draws_stay_in_their_rows():
    g = _with_isolated()
    gt = _tensors(g)
    seeds = torch.tensor([5, g.n_nodes - 1, 0, 3, 9], dtype=torch.int32)
    gen = torch.Generator().manual_seed(11)
    draws = TG.draw_hops(len(seeds), FANOUTS, gen, "cpu")
    assert [tuple(d.shape) for d in draws] == [(5, 4), (20, 3)]
    for d in draws:
        assert d.dtype == torch.int64
        assert int(d.min()) >= 0 and int(d.max()) < 1 << 30
    nodes, edges = TG.expand_hops(gt.row_ptr, gt.col_idx, gt.deg, seeds,
                                  draws)
    assert (nodes.shape[0], edges.shape[1]) == TG.subgraph_shapes(
        len(seeds), FANOUTS)
    nodes, edges = nodes.numpy(), edges.numpy()
    np.testing.assert_array_equal(nodes[:5], seeds.numpy())
    for child, parent in edges.T:
        c, p = nodes[child], nodes[parent]
        row = g.col_idx[g.row_ptr[p]: g.row_ptr[p + 1]]
        if row.size:
            assert c in row
        else:
            assert c == p                      # isolated: a self-loop
    # child -> parent: children are the positions past the seeds in order
    np.testing.assert_array_equal(edges[0], np.arange(5, len(nodes)))
    assert (np.diff(edges[1]) >= 0).all()      # sorted by dst
    again = TG.sample_neighbors(gt.row_ptr, gt.col_idx, gt.deg, seeds,
                                torch.Generator().manual_seed(11), FANOUTS)
    np.testing.assert_array_equal(again[0].numpy(), nodes)
    np.testing.assert_array_equal(again[1].numpy(), edges)


def test_a_graph_with_no_edge_samples_self_loops():
    g = TG.CSRGraph(np.zeros(5, np.int64), np.zeros(0, np.int32), 4)
    gt = TG.graph_tensors(g, "cpu")
    nodes, edges = TG.sample_neighbors(
        gt.row_ptr, gt.col_idx, gt.deg, torch.tensor([1, 3]),
        torch.Generator().manual_seed(0), (2,))
    np.testing.assert_array_equal(nodes.numpy(), [1, 3, 1, 1, 3, 3])
    np.testing.assert_array_equal(edges.numpy(), [[2, 3, 4, 5],
                                                  [0, 0, 1, 1]])


@pytest.mark.parametrize("coords", [False, True])
def test_subgraph_batch_equals_jax(coords):
    g = _with_isolated()
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(g.n_nodes, 7)).astype(np.float32)
    labels = rng.integers(0, 5, size=g.n_nodes).astype(np.int32)
    xyz = rng.normal(size=(g.n_nodes, 3)).astype(np.float32) \
        if coords else None
    seeds = np.array([5, 1, 119, 40], np.int32)
    k = jax.random.PRNGKey(2)
    want = JG.subgraph_batch(g, feats, labels, seeds, k, FANOUTS,
                             coords=xyz)
    draws = [torch.tensor(d, dtype=torch.int64)
             for d in _jax_draws(k, len(seeds), FANOUTS)]
    got = TG.subgraph_batch(_port(g), torch.tensor(feats),
                            torch.tensor(labels), seeds, None, FANOUTS,
                            coords=None if xyz is None else torch.tensor(xyz),
                            draws=draws)
    assert set(got) == set(want)
    for name in want:
        a, b = got[name].numpy(), np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert (got["labels"][len(seeds):] == -1).all()
    # the same on GraphTensors, and from a torch generator twice alike
    gt = TG.graph_tensors(_port(g), "cpu")
    again = TG.subgraph_batch(gt, torch.tensor(feats), torch.tensor(labels),
                              seeds, None, FANOUTS, draws=draws,
                              coords=None if xyz is None else
                              torch.tensor(xyz))
    assert all(torch.equal(again[n], got[n]) for n in got)
    one, two = (TG.subgraph_batch(gt, torch.tensor(feats),
                                  torch.tensor(labels), seeds,
                                  torch.Generator().manual_seed(9), FANOUTS)
                for _ in range(2))
    assert all(torch.equal(one[n], two[n]) for n in one)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("with_valid", [False, True])
def test_partition_edges_by_dst_equals_jax(shards, with_valid):
    rng = np.random.default_rng(shards)
    edges = rng.integers(0, 64, size=(2, 100)).astype(np.int32)
    ev = rng.random(100) > 0.25 if with_valid else None
    a = TG.partition_edges_by_dst(edges, 64, shards, ev)
    b = JG.partition_edges_by_dst(edges, 64, shards, ev)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_partition_edges_by_dst_contract():
    rng = np.random.default_rng(0)
    n_pad, shards = 64, 4
    edges = rng.integers(0, n_pad, size=(2, 100)).astype(np.int32)
    pe, pv = TG.partition_edges_by_dst(edges, n_pad, shards)
    assert pe.shape[1] % shards == 0
    blk = pe.shape[1] // shards
    nl = n_pad // shards
    for s in range(shards):
        dst = pe[1, s * blk: (s + 1) * blk]
        valid = pv[s * blk: (s + 1) * blk]
        assert ((dst[valid] // nl) == s).all()       # ownership contract
        assert (pe[:, s * blk: (s + 1) * blk][:, ~valid] == s * nl).all()
    got = sorted(map(tuple, pe[:, pv].T.tolist()))
    want = sorted(map(tuple, edges.T.tolist()))
    assert got == want


@pytest.mark.parametrize("batch,fanouts", [(1024, (15, 10)), (16, (5, 5)),
                                           (3, (2,)), (7, ())])
def test_subgraph_shapes_equal_jax(batch, fanouts):
    assert TG.subgraph_shapes(batch, fanouts) == \
        JG.subgraph_shapes(batch, fanouts)


def test_minibatch_lg_subgraph_size():
    assert TG.subgraph_shapes(1024, (15, 10)) == (169_984, 168_960)
