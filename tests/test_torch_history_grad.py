"""DIN's history gradient in the port against the JAX package, on the CPU.

The JAX model gathers the history once (``hist = lookup(table, ids) *
valid``) and pools it (``interest = sum(w * hist)``); its autodiff
transposes the one lookup.  The port takes the same gradient through two
autograd nodes, ``models/embedding_bag.py::HistoryRows`` and
``HistoryBag`` (``history_lookup``), whose table gradient on a card is one
``bag_lookup_bwd`` launch on the order that ``bag_bwd_order`` makes.
Here, on the CPU, every wrapper takes its plain version:

* ``bag_lookup_bwd``'s plain version with G, and ``history_lookup``'s
  autograd, against ``jax.vjp`` of JAX's history block on Zipf ids with -1
  tails, weighted and not: rtol 1e-5 of the value plus 1e-6 of the sum of
  the magnitudes each entry adds (both packages add the same float32
  products, in other orders);
* the rows alone and the bag alone through the two nodes, a float64
  ``gradcheck`` of their plumbing, no kernel launch on the CPU, and the
  step's graph freed after its backward;
* a numpy model of ``bag_bwd_order.cu``'s counting sort (tiles, digit
  histograms, the scan, the stable scatter) against ``bwd_order``'s plain
  stable ``torch.sort``, at one, two and three passes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recsys as JR
from repro_torch.kernels.bag_lookup import ops as bag_ops
from repro_torch.models import embedding_bag as teb
from _torch_threads import _one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
OFFSET = 5            # the item field's first row of the stacked table
T = torch.from_numpy


def _inputs(V, E, B, S, seed, zipf=True):
    """A stacked table of V rows whose item field starts at OFFSET, a
    history (B, S) of item ids with -1 tails (one row all -1), weights,
    and cotangents G (B, S, E) of the rows and g (B, E) of the pool."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, E)).astype(np.float32)
    n_items = V - OFFSET
    hist = ((rng.zipf(1.3, size=(B, S)) - 1) % n_items if zipf else
            rng.integers(0, n_items, size=(B, S))).astype(np.int32)
    lens = rng.integers(0, S + 1, size=B)
    hist[np.arange(S)[None, :] >= lens[:, None]] = -1
    hist[1, :] = -1
    w = rng.uniform(0.0, 1.0, size=(B, S)).astype(np.float32)
    G = rng.normal(size=(B, S, E)).astype(np.float32)
    g = rng.normal(size=(B, E)).astype(np.float32)
    ids = np.where(hist >= 0, hist + OFFSET, -1).astype(np.int32)
    return table, hist, ids, w, G, g


def _jax_block(table, hist, w, weighted=True):
    """JAX's history block as ``repro.models.recsys._din_forward`` has it
    (``hist + offset`` through ``default_lookup``, masked by ``valid``,
    pooled by ``w``): (rows, interest) as a function of (table, w)."""
    valid = jnp.asarray(hist >= 0)[..., None].astype(jnp.float32)
    jids = jnp.asarray(hist) + OFFSET

    def f(t, ww):
        rows = JR.default_lookup(t, jids) * valid
        pool_w = ww if weighted else jnp.ones_like(ww)
        return rows, jnp.sum(pool_w[..., None] * rows, axis=1)
    return f


def _jax_vjp(table, hist, w, G, g, weighted=True):
    (rows, interest), vjp = jax.vjp(_jax_block(table, hist, w, weighted),
                                    jnp.asarray(table), jnp.asarray(w))
    gt, gw = vjp((jnp.asarray(G), jnp.asarray(g)))
    return (np.asarray(rows), np.asarray(interest), np.asarray(gt),
            np.asarray(gw))


def _magnitudes(table, ids, w, G, g):
    """sum |terms| of grad_table (V, E) and grad_w (B, S)."""
    V, E = table.shape
    valid = ids >= 0
    safe = np.clip(ids, 0, V - 1)
    terms = np.abs(G) + np.abs(w)[..., None] * np.abs(g)[:, None, :]
    mag_t = np.zeros((V, E))
    np.add.at(mag_t, safe[valid], terms[valid])
    mag_w = np.where(valid, np.abs(table[safe] * g[:, None, :]).sum(-1), 0)
    return mag_t, mag_w


def _close(got, want, mag, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    bound = RTOL * np.abs(want) + ATOL * mag + ATOL
    assert (err <= bound).all(), (
        f"{what}: {int((err > bound).sum())} entries off, worst "
        f"{float((err - bound).max()):.3g} past the bound")


CASES = [pytest.param(40, 6, 7, 12, id="40-6-7-12"),
         pytest.param(300, 18, 16, 100, id="din-width")]


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("V,E,B,S", CASES)
def test_history_grad_plain_matches_jax_vjp(V, E, B, S, weighted):
    """``bag_lookup_bwd(..., G=G)``'s plain version: the whole table
    gradient of the rows and the pool, and grad_w."""
    table, hist, ids, w, G, g = _inputs(V, E, B, S, seed=V + S)
    _, _, want_t, want_w = _jax_vjp(table, hist, w, G, g, weighted)
    gw, gt = bag_ops.bag_lookup_bwd(T(table), T(ids),
                                    T(w) if weighted else None, T(g),
                                    G=T(G))
    mag_t, mag_w = _magnitudes(table, ids, w if weighted else
                               np.ones_like(w), G, g)
    assert gt.dtype == torch.float32 and gt.shape == (V, E)
    _close(gt, want_t, mag_t, "grad_table")
    if weighted:
        _close(gw, want_w, mag_w, "grad_w")
    assert not gw.numpy()[ids < 0].any()
    untouched = np.setdiff1d(np.arange(V), ids[ids >= 0])
    assert not gt.numpy()[untouched].any()      # row OFFSET - 1 among them


@pytest.mark.parametrize("V,E,B,S", CASES)
def test_history_lookup_autograd_matches_jax_vjp(V, E, B, S):
    """``history_lookup``: the rows equal to JAX's masked lookup, the pool
    to its sum, and the gradients of both nodes together (the table's,
    the weights') to ``jax.vjp``."""
    table, hist, ids, w, G, g = _inputs(V, E, B, S, seed=7 * V + S)
    want_rows, want_pool, want_t, want_w = _jax_vjp(table, hist, w, G, g)
    t = T(table).requires_grad_()
    tw = T(w).requires_grad_()
    rows, bag = teb.history_lookup(t, T(ids))
    pool = bag(tw)
    np.testing.assert_array_equal(rows.detach().numpy(), want_rows)
    np.testing.assert_allclose(pool.detach().numpy(), want_pool, rtol=RTOL,
                               atol=ATOL)
    torch.autograd.backward((rows, pool), (T(G), T(g)))
    mag_t, mag_w = _magnitudes(table, ids, w, G, g)
    _close(t.grad, want_t, mag_t, "grad_table")
    _close(tw.grad, want_w, mag_w, "grad_w")


def test_history_rows_alone_and_bag_alone():
    """Either node without the other's cotangent: the rows' gradient is
    the scatter of G, the bag's the scatter of w g (jax.vjp with the other
    cotangent zero)."""
    table, hist, ids, w, G, g = _inputs(40, 6, 7, 12, seed=3)
    mag_t, _ = _magnitudes(table, ids, w, G, g)
    for use_rows in (True, False):
        t = T(table).requires_grad_()
        rows, bag = teb.history_lookup(t, T(ids))
        pool = bag(T(w))
        if use_rows:
            rows.backward(T(G))
            cot = (G, np.zeros_like(g))
        else:
            pool.backward(T(g))
            cot = (np.zeros_like(G), g)
        _, _, want_t, _ = _jax_vjp(table, hist, w, *cot)
        _close(t.grad, want_t, mag_t, f"use_rows={use_rows}")


def test_history_nodes_gradcheck_in_float64(monkeypatch):
    """``torch.autograd.gradcheck`` of the two nodes in float64 on a tiny
    shape, the wrappers routed to float64 plain versions: the Functions'
    plumbing (the token that carries g, the order and weights in the link,
    the masks) against finite differences."""
    def fwd(table, ids, weights):
        V = table.shape[0]
        w = torch.where(ids < 0, 0.0, weights)
        return (table[ids.clamp(0, V - 1).long()] * w[..., None]).sum(1)

    def order(table, ids, weights=None, g=None, need_w=False):
        gw = bag_ops.grad_w_ref(table, ids, g) if need_w else None
        return "order", gw

    def grad(order, table, ids, weights, g, G):
        V, E = table.shape
        terms = torch.zeros(ids.shape + (E,), dtype=table.dtype) \
            if G is None else G.clone()
        if g is not None:
            ww = torch.ones(ids.shape, dtype=table.dtype) \
                if weights is None else weights
            terms = terms + ww[..., None] * g[:, None, :]
        valid = (ids >= 0).reshape(-1)
        return torch.zeros_like(table).index_add_(
            0, ids.clamp(0, V - 1).reshape(-1).long()[valid],
            terms.reshape(-1, E)[valid])

    monkeypatch.setattr(bag_ops, "bag_lookup", fwd)
    monkeypatch.setattr(bag_ops, "bwd_order", order)
    monkeypatch.setattr(bag_ops, "table_grad", grad)
    rng = np.random.default_rng(5)
    table = torch.tensor(rng.normal(size=(6, 3)), requires_grad=True)
    ids = torch.tensor([[0, 5, -1, 2], [5, 5, 9, -1], [1, 3, 3, 0]],
                       dtype=torch.int32)
    w = torch.tensor(rng.uniform(0.5, 1.5, size=(3, 4)), requires_grad=True)
    proj = torch.tensor(rng.normal(size=(3, 4, 3)))

    def f(t, ww):
        rows, bag = teb.history_lookup(t, ids)
        return (rows * proj).sum(-1), bag(ww)

    assert torch.autograd.gradcheck(f, (table, w))


def test_history_lookup_on_the_cpu_launches_nothing():
    table, _, ids, w, G, g = _inputs(30, 4, 5, 6, seed=11)
    before = (bag_ops.launches, bag_ops.launches_order,
              bag_ops.launches_bwd)
    t = T(table).requires_grad_()
    rows, bag = teb.history_lookup(t, T(ids))
    torch.autograd.backward((rows, bag(T(w))), (T(G), T(g)))
    assert (bag_ops.launches, bag_ops.launches_order,
            bag_ops.launches_bwd) == before


@pytest.mark.parametrize("use_rows", [True, False])
def test_history_lookup_frees_its_graph_after_backward(use_rows):
    """After a step's backward the graph goes with its last reference: the
    link between the two nodes holds no tensor with autograd history (the
    weights' history reaches the gather's node, and a cycle through
    autograd nodes is never collected)."""
    import gc
    import weakref

    table, _, ids, w, _, _ = _inputs(30, 4, 5, 6, seed=13)
    t = T(table).requires_grad_()
    s = T(w).requires_grad_()

    def step():
        rows, bag = teb.history_lookup(t, T(ids))
        weights = torch.softmax(s * rows.sum(-1), dim=1)
        kept = weakref.ref(weights)
        loss = bag(weights).sum() + (rows.sum() if use_rows else 0.0)
        loss.backward()
        return kept

    kept = step()
    gc.collect()
    assert kept() is None


def _counting_sort_model(ids, V, w, tile, bits):
    """``bag_bwd_order.cu``'s sort in numpy: per pass, the tiles' digit
    histograms (pass 0 over every entry, later passes over the valid
    count), their exclusive scan digit-major, and each tile's valid
    entries scattered in their order to their digit's place plus their
    rank among the tile's earlier entries of that digit."""
    flat = ids.reshape(-1)
    n = flat.size
    key = np.where(flat >= 0, np.minimum(flat, V - 1), -1)
    pos = np.arange(n)
    ww = None if w is None else w.reshape(-1)
    count = int((key >= 0).sum())
    n_bits = max(1, int(V - 1).bit_length())
    passes = -(-n_bits // bits)
    bins = 1 << bits
    n_tiles = -(-n // tile)
    for p in range(passes):
        m = n if p == 0 else count
        digit = np.where(key[:m] >= 0, (key[:m] >> (p * bits)) & (bins - 1),
                         -1)
        counts = np.zeros((bins, n_tiles), np.int64)
        for i in range(m):
            if digit[i] >= 0:
                counts[digit[i], i // tile] += 1
        before_digit = np.concatenate([[0], np.cumsum(counts.sum(1))[:-1]])
        before_tile = np.cumsum(counts, axis=1) - counts
        out_k, out_p = np.full(n, -7), np.full(n, -7)
        out_w = None if ww is None else np.full(n, np.nan, np.float32)
        for t in range(n_tiles):
            seen = np.zeros(bins, np.int64)
            for i in range(t * tile, min(t * tile + tile, m)):
                d = digit[i]
                if d < 0:
                    continue
                dst = before_digit[d] + before_tile[d, t] + seen[d]
                seen[d] += 1
                out_k[dst], out_p[dst] = key[i], pos[i]
                if ww is not None:
                    out_w[dst] = ww[i]
        key, pos, ww = out_k, out_p, out_w
    return key[:count], pos[:count], None if ww is None else ww[:count]


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("V,bits,tile", [
    pytest.param(50, 9, 4096, id="one-pass"),
    pytest.param(256_205, 9, 64, id="din-two-passes"),
    pytest.param(300, 4, 7, id="three-passes"),
])
def test_counting_sort_model_gives_bwd_orders_stable_sort(V, bits, tile,
                                                          weighted):
    rng = np.random.default_rng(V)
    ids = ((rng.zipf(1.3, size=(9, 40)) - 1) % V).astype(np.int32)
    ids[rng.random(ids.shape) < 0.4] = -1
    ids[0, :2] = [V, V + 3]                              # clipped to V - 1
    w = rng.random(ids.shape).astype(np.float32) if weighted else None
    keys, pos, ws = _counting_sort_model(ids, V, w, tile, bits)
    order, _ = bag_ops.bwd_order(torch.zeros((V, 1)), T(ids),
                                 None if w is None else T(w))
    assert int(order.count) == keys.size == int((ids >= 0).sum())
    np.testing.assert_array_equal(order.keys.numpy(), keys)
    np.testing.assert_array_equal(order.pos.numpy(), pos)
    if weighted:
        np.testing.assert_array_equal(order.w.numpy(), ws)
    else:
        assert order.w is None


@pytest.mark.parametrize("V,passes", [(1, 1), (2, 1), (512, 1), (513, 2),
                                      (256_205, 2), (262_145, 3)])
def test_order_passes_cover_the_keys_bits(V, passes):
    assert bag_ops.order_passes(V) == passes
    assert (1 << (bag_ops.ORDER_BITS * passes)) >= V
